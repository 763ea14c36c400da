"""yi-9b — llama-architecture GQA [arXiv:2403.04652; hf].

48L, d_model=4096, 32H (GQA kv=4), d_ff=11008, vocab=64000, head_dim=128.

The port's copy of ``repro.configs.yi_9b``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=10000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b-smoke", family="dense", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=512,
        loss_chunk=64)
