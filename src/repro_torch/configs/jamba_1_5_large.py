"""jamba-1.5-large-398b — Mamba + attention 1:7, MoE 16e top-2
[arXiv:2403.19887; hf].

72L, d_model=8192, 64H (GQA kv=8), d_ff=24576, vocab=65536.  Period-8
block: attention at position 4, Mamba elsewhere; MoE (16 experts, top-2)
on every other layer.

The port's copy of ``repro.configs.jamba_1_5_large``.  The registry serves
its smoke config only: one full-width period holds 4 MoE layers of 19.3 GB
each in bf16, more than one card.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    rope_theta=10000.0,
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    ssm_state_dim=16,
    ssm_expand=2,
    ssm_conv_dim=4,
    mlstm_chunk=256,
    num_experts=16,
    num_shared_experts=0,
    top_k=2,
    moe_d_ff=24576,
    moe_layer_period=2,
    moe_layer_offset=1,
    moment_dtype="bfloat16",
    fsdp=True,
    moe_2d_shard=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid", num_layers=8, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=512,
        block_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        ssm_state_dim=8, ssm_expand=2, mlstm_chunk=16, num_experts=4,
        top_k=2, moe_d_ff=96, moe_layer_period=2, moe_layer_offset=1,
        loss_chunk=64)
