"""deepseek-v2-lite-16b — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434; hf].

27L, d_model=2048, 16H MLA (kv_lora_rank=512, qk_nope=128, qk_rope=64,
v_head=128), per-expert d_ff=1408, vocab=102400.  First layer is dense
(d_ff=10944); the remaining 26 are MoE.

The port's copy of ``repro.configs.deepseek_v2_lite``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,            # MLA is MHA at compute time
    d_ff=1408,
    vocab_size=102400,
    attn_type="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    moe_layer_period=1,
    first_dense_layers=1,
    dense_d_ff=10944,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke", family="moe", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=96, vocab_size=512,
        attn_type="mla", kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, num_experts=8,
        num_shared_experts=2, top_k=2, moe_d_ff=64, moe_layer_period=1,
        first_dense_layers=1, dense_d_ff=128, loss_chunk=64)
