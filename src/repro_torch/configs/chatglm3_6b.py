"""chatglm3-6b — RoPE 2d (half-rotary), GQA kv=2 [arXiv:2406.12793; hf].

28L, d_model=4096, 32H (GQA kv=2), d_ff=13696, vocab=65024, head_dim=128.
ChatGLM applies rotary embedding to half of each head's dims
(``rotary_fraction=0.5``).

The port's copy of ``repro.configs.chatglm3_6b``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rotary_fraction=0.5,
    rope_theta=10000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        rotary_fraction=0.5, loss_chunk=64)
