"""whisper-medium — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].

24 encoder + 24 decoder layers, d_model=1024, 16H (MHA), d_ff=4096, GELU
MLPs, LayerNorm, vocab=51865 (padded +7 → 51872).  The conv1d/mel frontend
is a stub: the caller passes precomputed frame embeddings (B, S_enc,
d_model).  Every decoder layer cross-attends to the encoder output.

The port's copy of ``repro.configs.whisper_medium``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    dense_d_ff=4096,
    vocab_size=51865,
    vocab_padding=7,
    ffn_type="gelu",
    norm="layernorm",
    cross_attn_period=1,
    decoder_prefill_len=1024,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio", num_layers=2, encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        dense_d_ff=128, vocab_size=509, vocab_padding=3, ffn_type="gelu",
        norm="layernorm", cross_attn_period=1, decoder_prefill_len=32,
        loss_chunk=64)
