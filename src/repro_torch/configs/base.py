"""Model/architecture configuration schema — the port's own copy.

Same fields and defaults as the JAX package's ``ModelConfig`` so a config
can be described once and compared field by field; the only change is that
``dtype()``/``pdtype()`` return ``torch`` dtypes.  ``param_dtype`` and
``compute_dtype`` stay strings so ``dataclasses.replace(cfg,
param_dtype="float32", compute_dtype="float32")`` works as it does there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None    # default d_model // num_heads

    # --- attention ---------------------------------------------------------
    attn_type: str = "gqa"            # gqa | mla
    rope_theta: float = 1e4
    rotary_fraction: float = 1.0      # ChatGLM3: 0.5 ("2d" half-rotary)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1
    moe_layer_offset: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25

    # --- SSM / hybrid --------------------------------------------------------
    block_pattern: Tuple[str, ...] = ()
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    mlstm_chunk: int = 256

    # --- VLM / enc-dec -------------------------------------------------------
    cross_attn_period: int = 0
    num_image_tokens: int = 0
    encoder_layers: int = 0
    max_source_positions: int = 0
    decoder_prefill_len: int = 1024

    # --- numerics ------------------------------------------------------------
    ffn_type: str = "swiglu"          # swiglu | gelu | relu2
    vocab_padding: int = 0
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"

    loss_chunk: int = 2048
    remat: str = "block"
    fsdp: bool = False
    moe_2d_shard: bool = False

    # ------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def padded_vocab(self) -> int:
        return self.vocab_size + self.vocab_padding

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.block_pattern or ("attn",)

    def layer_kind(self, i: int) -> str:
        return self.pattern[i % len(self.pattern)]

    def layer_is_moe(self, i: int) -> bool:
        if not self.is_moe or i < self.first_dense_layers:
            return False
        return (i % self.moe_layer_period) == self.moe_layer_offset

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def dense_ffn_dim(self) -> int:
        return self.dense_d_ff or self.d_ff

    def dtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def param_count(self, *, active_only: bool = False) -> int:
        """Analytic parameter count, the reference's formula: embeddings,
        each decoder layer's mixer (GQA or MLA attention, Mamba, mLSTM,
        sLSTM), its cross-attention, its dense (SwiGLU or 2-matrix) or MoE
        FFN, the encoder stack, the final norm; ``active_only`` counts the
        top-k experts only (MoE activated parameters)."""
        d = self.d_model
        di = self.ssm_expand * d
        mats = 3 if self.ffn_type == "swiglu" else 2
        dt_rank = max(1, d // 16)
        attn = self._attn_params()
        per_kind = {
            "attn": attn,
            "mamba": (d * 2 * di + di * self.ssm_conv_dim
                      + di * (dt_rank + 2 * self.ssm_state_dim)
                      + dt_rank * di + di + di * self.ssm_state_dim
                      + di * 2 + di * d),
            "mlstm": (d * 2 * di + 3 * self.num_heads * (di // self.num_heads)
                      ** 2 + 2 * di * self.num_heads + di * d),
            "slstm": 4 * d * d + 4 * d * d + int(4 / 3 * d * d) * 2,
        }
        p = self.cross_attn_period
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i in range(self.num_layers):
            n += per_kind[self.layer_kind(i)]
            if p and i % p == p - 1:
                n += attn
            if self.d_ff > 0 or self.is_moe:
                if self.layer_is_moe(i):
                    k = self.top_k if active_only else self.num_experts
                    n += (k + self.num_shared_experts) * mats * d \
                        * self.expert_d_ff
                elif self.dense_ffn_dim > 0:
                    n += mats * d * self.dense_ffn_dim
        return n + self.encoder_param_count() + d

    def encoder_param_count(self) -> int:
        """Encoder-stack share of ``param_count``: one attention block and
        the dense FFN a layer (0 without an encoder)."""
        mats = 3 if self.ffn_type == "swiglu" else 2
        return self.encoder_layers * (
            self._attn_params() + mats * self.d_model * self.dense_ffn_dim)

    def _attn_params(self) -> int:
        """One attention block's matrices: MLA's five, or GQA's q, k, v, o
        (cross-attention and the encoder count the same, as in the
        reference)."""
        d, hd = self.d_model, self.resolved_head_dim
        if self.attn_type == "mla":
            r, rd = self.kv_lora_rank, self.qk_rope_head_dim
            nd, vd, H = self.qk_nope_head_dim, self.v_head_dim, self.num_heads
            return (d * H * (nd + rd) + d * (r + rd) + r * H * (nd + vd)
                    + H * vd * d)
        qd, kvd = self.num_heads * hd, self.num_kv_heads * hd
        return d * (qd + 2 * kvd) + qd * d


__all__ = ["ModelConfig", "torch_dtype"]
