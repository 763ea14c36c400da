"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517].

48 blocks, d_model=2048, 4 heads, no separate FFN (d_ff=0; blocks carry their
own up/down projections).  Ratio 7:1 mLSTM:sLSTM — every 8th block is sLSTM.
Attention-free: the flash-attention kernels are not on its path; every
chunk-parallel mLSTM prefill runs the single-launch carry scan (K4).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    ssm_expand=2,
    ssm_conv_dim=4,
    mlstm_chunk=256,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm", num_layers=8, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=512,
        block_pattern=("mlstm",) * 7 + ("slstm",), ssm_expand=2,
        mlstm_chunk=16, tie_embeddings=True, loss_chunk=64)
