"""llama-3.2-vision-11b — cross-attn image layers [hf:meta-llama/...-Vision].

40L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=128256.  Every 5th
layer carries an additional cross-attention sublayer over image patch
embeddings.  The vision tower is a stub: the caller passes precomputed,
projected patch embeddings (B, 1601, d_model).

The port's copy of ``repro.configs.llama32_vision_11b``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    cross_attn_period=5,
    num_image_tokens=1601,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b-smoke", family="vlm", num_layers=5,
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=512, cross_attn_period=5, num_image_tokens=17,
        loss_chunk=64)
