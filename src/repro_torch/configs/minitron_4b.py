"""minitron-4b — pruned Nemotron [arXiv:2407.14679; hf].

32L, d_model=3072, 24H (GQA kv=8), d_ff=9216 (squared-ReLU 2-matrix MLP,
Nemotron family), vocab=256000, head_dim=128.

The port's copy of ``repro.configs.minitron_4b``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    ffn_type="relu2",
    rope_theta=10000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        ffn_type="relu2", loss_chunk=64)
