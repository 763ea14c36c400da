"""GQA attention — the dense subset of ``repro.models.attention``.

On a CUDA tensor the prefill slots (``plain_attention`` and
``blockwise_attention``) run the K1 kernel and ``decode_attention`` runs
K2 (partials + combine); there is no fallback.  On a CPU tensor they run
plain PyTorch versions that follow the JAX functions step by step — q
scaled in the compute dtype, products accumulated in fp32 (JAX's
``preferred_element_type``), probabilities cast to the value dtype before
the PV product, blockwise running softmax over ``kv_chunk`` tiles — so the
CPU tests can hold the port to the reference at fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core import SeqWork, bound_depth, build_plan
from ..kernels.flash_attention import flash_attention
from ..kernels.flash_decode import flash_decode
from .layers import Params, apply_rope, dense_init, rope_table

NEG_INF = -1e30


def attn_chunk_sizes(seq_q: int, seq_kv: int, *, target_chunk: int = 2048
                     ) -> Tuple[int, int]:
    """Pick (q_chunk, kv_chunk) via a bound_depth plan over the sequence,
    leaves ≈ ``target_chunk``."""
    def leaf(seq: int) -> int:
        depth = max(0, math.ceil(math.log2(max(1, seq / target_chunk))))
        plan = build_plan(bound_depth(SeqWork(0, seq), depth))
        return max(plan.leaf_sizes())
    return leaf(seq_q), leaf(seq_kv)


# ---------------------------------------------------------------------------
# prefill slot
# ---------------------------------------------------------------------------

def _chunk_attn_update(carry, qc, kc, vc, mask):
    """One (q-chunk, kv-chunk) tile with running-softmax state.
    qc: (B,KV,G,Cq,hd)  kc, vc: (B,Ck,KV,hd)  mask: (Cq,Ck) additive."""
    m, l, acc = carry
    logits = torch.einsum("bkgqd,bskd->bkgqs", qc.float(), kc.float())
    if mask is not None:
        logits = logits + mask
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskv->bkgqv", p.to(vc.dtype).float(),
                      vc.float())
    acc = acc * alpha[..., None] + pv
    return m_new, l, acc


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, scale: Optional[float] = None,
                        q_chunk: int = 1024, kv_chunk: int = 1024,
                        q_offset=0) -> torch.Tensor:
    """q: (B,Sq,H,hd)  k,v: (B,Sk,KV,hd) → (B,Sq,H,hd).  ``q_offset`` is an
    int, or a 0-d tensor (JAX's traced offset: no tile pruning, the causal
    mask alone does the windowing — the same values)."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset)
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    hv = v.shape[-1]
    G = H // KV
    scale = scale if scale is not None else (1.0 / math.sqrt(hd))
    q = (q * scale).reshape(B, Sq, KV, G, hd)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    n_q = (Sq + q_chunk - 1) // q_chunk
    Skp = ((Sk + kv_chunk - 1) // kv_chunk) * kv_chunk
    if Skp != Sk:
        pad = Skp - Sk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    static_offset = isinstance(q_offset, int)
    outs = []
    for iq in range(n_q):
        q0 = iq * q_chunk
        cq = min(q_chunk, Sq - q0)
        qc = q[:, q0:q0 + cq].permute(0, 2, 3, 1, 4)      # (B,KV,G,Cq,hd)
        k_hi = min(Sk, q_offset + q0 + cq) if (causal and static_offset) \
            else Sk
        n_k = (k_hi + kv_chunk - 1) // kv_chunk
        q_pos = q_offset + q0 + torch.arange(cq)
        m = torch.full((B, KV, G, cq), NEG_INF)
        l = torch.zeros((B, KV, G, cq))
        acc = torch.zeros((B, KV, G, cq, hv))
        carry = (m, l, acc)
        for ik in range(n_k):
            kc = k[:, ik * kv_chunk:(ik + 1) * kv_chunk]
            vc = v[:, ik * kv_chunk:(ik + 1) * kv_chunk]
            k_pos = ik * kv_chunk + torch.arange(kv_chunk)
            valid = k_pos[None, :] < k_hi
            if causal:
                valid = valid & (q_pos[:, None] >= k_pos[None, :])
            mask = torch.where(valid, 0.0, NEG_INF).float()
            carry = _chunk_attn_update(carry, qc, kc, vc, mask)
        m, l, acc = carry
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, cq, H, hv)
                    .to(v.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def plain_attention(q, k, v, *, causal: bool, scale=None, q_offset=0):
    """Reference O(S²)-memory attention (the JAX package's small-shape
    branch); K1 on CUDA."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset)
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else (1.0 / math.sqrt(hd))
    qg = (q * scale).reshape(B, Sq, KV, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    if causal:
        q_pos = q_offset + torch.arange(Sq)
        k_pos = torch.arange(Sk)
        mask = torch.where(q_pos[:, None] >= k_pos[None, :], 0.0, NEG_INF)
        logits = logits + mask
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bskv->bkgqv", p.to(v.dtype).float(), v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[-1]) \
        .to(v.dtype)


# ---------------------------------------------------------------------------
# decode slot
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a cache.  q: (B,H,hd)  caches:
    (B,S,KV,·)  lengths: (B,) valid prefix lengths; a row with none
    averages V over all S positions, as the reference does.  K2 on CUDA."""
    if q.is_cuda:
        return flash_decode(q, k_cache, v_cache, lengths.to(torch.int32),
                            scale=scale)
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    scale = scale if scale is not None else (1.0 / math.sqrt(hd))
    qg = (q * scale).reshape(B, KV, G, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    mask = torch.arange(S)[None, :] < lengths[:, None]          # (B,S)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.tensor(NEG_INF))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bskv->bkgv", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, H, v_cache.shape[-1]).to(v_cache.dtype)


# ---------------------------------------------------------------------------
# GQA self-attention layer
# ---------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg: ModelConfig, *,
             lead: Tuple[int, ...] = ()) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    dt = cfg.pdtype()
    return {
        "wq": dense_init(gen, d, H * hd, dt, lead=lead),
        "wk": dense_init(gen, d, KV * hd, dt, lead=lead),
        "wv": dense_init(gen, d, KV * hd, dt, lead=lead),
        "wo": dense_init(gen, H * hd, d, dt, lead=lead),
    }


def _rope_dims(cfg: ModelConfig) -> int:
    rd = int(cfg.resolved_head_dim * cfg.rotary_fraction)
    return rd - rd % 2


def gqa_project_qkv(params: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: Optional[torch.Tensor], *, rope: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,D) → q (B,S,H,hd), k,v (B,S,KV,hd) with RoPE applied."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (x @ params["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    if rope and positions is not None:
        rd = _rope_dims(cfg)
        cos, sin = rope_table(positions, rd, cfg.rope_theta)
        q = apply_rope(q, cos, sin, rotary_dims=rd)
        k = apply_rope(k, cos, sin, rotary_dims=rd)
    return q, k, v


def gqa_project_kv(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-only projection (cache payloads during prefill)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    k = (x @ params["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    if positions is not None:
        rd = _rope_dims(cfg)
        cos, sin = rope_table(positions, rd, cfg.rope_theta)
        k = apply_rope(k, cos, sin, rotary_dims=rd)
    return k, v


def gqa_self_attention(params: Params, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor, *, causal: bool = True,
                       q_offset: int = 0,
                       target_chunk: int = 2048) -> torch.Tensor:
    """Full-sequence self attention (prefill)."""
    B, S, D = x.shape
    q, k, v = gqa_project_qkv(params, cfg, x, positions)
    qc, kc = attn_chunk_sizes(S, S, target_chunk=target_chunk)
    if S <= 256:
        o = plain_attention(q, k, v, causal=causal, q_offset=q_offset)
    else:
        o = blockwise_attention(q, k, v, causal=causal, q_chunk=qc,
                                kv_chunk=kc, q_offset=q_offset)
    return o.reshape(B, S, -1) @ params["wo"]


def gqa_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
               k_cache: torch.Tensor, v_cache: torch.Tensor,
               positions: torch.Tensor, lengths: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against caches that do not yet hold this token.
    x: (B,1,D); returns (y (B,1,D), k_new (B,1,KV,hd), v_new); the caller
    writes the new kv into the cache."""
    B = x.shape[0]
    q, k, v = gqa_project_qkv(params, cfg, x, positions[:, None])
    o = decode_attention(q[:, 0], k_cache, v_cache, lengths)
    y = (o.reshape(B, -1) @ params["wo"])[:, None, :]
    return y, k, v


__all__ = [
    "NEG_INF", "attn_chunk_sizes", "blockwise_attention", "plain_attention",
    "decode_attention", "gqa_init", "gqa_project_qkv", "gqa_project_kv",
    "gqa_self_attention", "gqa_decode",
]
