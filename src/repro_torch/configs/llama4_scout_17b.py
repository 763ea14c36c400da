"""llama4-scout-17b-a16e — MoE 16e top-1, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E].

48L, d_model=5120, 40H (GQA kv=8), expert d_ff=8192, vocab=202048, MoE with
16 routed experts (top-1) + 1 shared expert on every layer (Scout's
interleave step is 1).  head_dim=128.  The port's copy of
``repro.configs.llama4_scout_17b``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=500000.0,
    num_experts=16,
    num_shared_experts=1,
    top_k=1,
    moe_d_ff=8192,
    moe_layer_period=1,
    moe_2d_shard=True,   # the reference's sharding flag; one card ignores it
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=512,
        num_experts=4, num_shared_experts=1, top_k=1, moe_d_ff=96,
        moe_layer_period=1, loss_chunk=64)
