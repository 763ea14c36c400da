"""GQA, MLA and cross-attention — ``repro.models.attention`` but for its
mesh-sharded layout (``sharded_mha``, which comes with the ``dist`` port).

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
             lead: Tuple[int, ...] = (), cross: bool = False) -> Params:
    """q, k, v, o projections; a cross-attention block (``cross``) has the
    same four, k and v projecting the encoder output / image embeddings."""
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


def cross_attention(params: Params, cfg: ModelConfig, x: torch.Tensor,
                    kv_states: torch.Tensor, *,
                    target_chunk: int = 2048) -> torch.Tensor:
    """Queries from x (B,S,D), keys and values from kv_states (B,Skv,D):
    no RoPE, no mask.  The reference's two routes, ``plain_attention`` for
    S <= 256 and Skv <= 1024, else ``blockwise_attention``; both are K1
    (non-causal) on CUDA."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    Skv = kv_states.shape[1]
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (kv_states @ params["wk"]).reshape(B, Skv, cfg.num_kv_heads, hd)
    v = (kv_states @ params["wv"]).reshape(B, Skv, cfg.num_kv_heads, hd)
    if S <= 256 and Skv <= 1024:
        o = plain_attention(q, k, v, causal=False)
    else:
        qc, kc = attn_chunk_sizes(S, Skv, target_chunk=target_chunk)
        o = blockwise_attention(q, k, v, causal=False, q_chunk=qc,
                                kv_chunk=kc)
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg: ModelConfig, *,
             lead: Tuple[int, ...] = ()) -> Params:
    d, H, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = cfg.pdtype()
    return {
        "wq": dense_init(gen, d, H * (nd + rd), dt, lead=lead),   # queries
        "wkv_down": dense_init(gen, d, r, dt, lead=lead),         # latent
        "wk_rope": dense_init(gen, d, rd, dt, lead=lead),    # shared rope k
        "wkv_up": dense_init(gen, r, H * (nd + vd), dt, lead=lead),
        "wo": dense_init(gen, H * vd, d, dt, lead=lead),
    }


def mla_queries(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) → q_nope (B,S,H,nd), q_rope (B,S,H,rd) with RoPE."""
    B, S, _ = x.shape
    nd, rd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, nd + rd)
    return q[..., :nd], apply_rope(q[..., nd:], cos, sin)


def _mla_payload(params: Params, cfg: ModelConfig, x: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """(B,S,r+rd) latent payload c_kv ++ RoPE'd k_rope."""
    c_kv = x @ params["wkv_down"]
    k_rope = apply_rope((x @ params["wk_rope"])[:, :, None, :], cos, sin)
    return torch.cat([c_kv, k_rope[:, :, 0, :]], dim=-1)


def _mla_up(params: Params, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """W_uk (r,H,nd) and W_uv (r,H,vd), views of ``wkv_up``."""
    nd, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    w = params["wkv_up"].reshape(cfg.kv_lora_rank, cfg.num_heads, nd + vd)
    return w[..., :nd], w[..., nd:]


def mla_project(params: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """Returns q (B,S,H,nd+rd), k (B,S,H,nd+rd), v (B,S,H,vd) and the cache
    payload (c_kv ++ k_rope, r+rd a token); q, k and v contiguous (K1's
    operands)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    cos, sin = rope_table(positions, rd, cfg.rope_theta)
    q_nope, q_rope = mla_queries(params, cfg, x, cos, sin)
    payload = _mla_payload(params, cfg, x, cos, sin)
    kv = (payload[..., :r] @ params["wkv_up"]).reshape(B, S, H, nd + vd)
    k = torch.cat([kv[..., :nd],
                   payload[:, :, None, r:].expand(B, S, H, rd)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, kv[..., nd:].contiguous(), payload


def mla_cache_payload(params: Params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """(B,S,r+rd) latent cache payload: no head expansion."""
    cos, sin = rope_table(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    return _mla_payload(params, cfg, x, cos, sin)


def mla_self_attention(params: Params, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor, *, causal: bool = True,
                       q_offset: int = 0,
                       target_chunk: int = 2048) -> torch.Tensor:
    """Full-sequence MLA (prefill): MHA at q/k head dim nd + rd and v head
    dim vd, scale 1/sqrt(nd + rd); K1 at (192, 128) on CUDA."""
    B, S, D = x.shape
    q, k, v, _ = mla_project(params, cfg, x, positions)
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    if S <= 256:
        o = plain_attention(q, k, v, causal=causal, scale=scale,
                            q_offset=q_offset)
    else:
        qc, kc = attn_chunk_sizes(S, S, target_chunk=target_chunk)
        o = blockwise_attention(q, k, v, causal=causal, scale=scale,
                                q_chunk=qc, kv_chunk=kc, q_offset=q_offset)
    return o.reshape(B, S, -1) @ params["wo"]


def mla_absorbed(params: Params, cfg: ModelConfig, q_nope: torch.Tensor,
                 q_rope: torch.Tensor, latent: torch.Tensor,
                 valid: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Absorbed MLA scoring against the latent cache: W_uk folds into the
    queries, W_uv into the output.  q_nope (B,c,H,nd), q_rope (B,c,H,rd),
    latent (B,S,r+rd), valid (B or 1, c, S) bool → (B,c,H·vd).  Products
    accumulate in fp32 (the reference's ``preferred_element_type``);
    probabilities are cast to the latent's dtype before P·c_kv."""
    B, c = q_nope.shape[:2]
    r = cfg.kv_lora_rank
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    w_uk, w_uv = _mla_up(params, cfg)
    q_abs = torch.einsum("bchn,rhn->bchr", q_nope, w_uk)
    c_hist, rope_hist = latent[..., :r].float(), latent[..., r:].float()
    logits = (torch.einsum("bchr,bsr->bhcs", q_abs.float(), c_hist)
              + torch.einsum("bchr,bsr->bhcs", q_rope.float(), rope_hist)
              ) * scale
    logits = torch.where(valid[:, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bhcs,bsr->bchr", p.to(latent.dtype).float(),
                         c_hist)
    o = torch.einsum("bchr,rhv->bchv", o_lat.to(dtype), w_uv)
    return o.reshape(B, c, -1)


def mla_decode(params: Params, cfg: ModelConfig, x: torch.Tensor,
               latent_cache: torch.Tensor, positions: torch.Tensor,
               lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absorbed MLA decode: score directly against the latent cache
    (B,S,r+rd).  The token's payload is written into the cache in place at
    each row's length *before* attention (it attends to itself; a row at
    the cache width writes nothing, the reference's mask-select), then
    positions < lengths + 1 are attended.  Returns (y (B,1,D), the
    cache)."""
    B = x.shape[0]
    S = latent_cache.shape[1]
    cos, sin = rope_table(positions[:, None], cfg.qk_rope_head_dim,
                          cfg.rope_theta)
    q_nope, q_rope = mla_queries(params, cfg, x, cos, sin)
    payload = _mla_payload(params, cfg, x, cos, sin)[:, 0]
    rows = torch.arange(B, device=x.device)
    at = lengths.clamp(max=S - 1).long()
    keep = (lengths < S)[:, None]
    latent_cache[rows, at] = torch.where(keep, payload,
                                         latent_cache[rows, at])
    valid = (torch.arange(S, device=x.device)[None, :]
             < (lengths + 1)[:, None])[:, None]                  # (B,1,S)
    o = mla_absorbed(params, cfg, q_nope, q_rope, latent_cache, valid,
                     x.dtype)
    return o @ params["wo"], latent_cache


__all__ = [
    "NEG_INF", "attn_chunk_sizes", "blockwise_attention", "plain_attention",
    "decode_attention", "gqa_init", "gqa_project_qkv", "gqa_project_kv",
    "gqa_self_attention", "cross_attention", "gqa_decode", "mla_init",
    "mla_project", "mla_queries", "mla_cache_payload", "mla_self_attention",
    "mla_absorbed", "mla_decode",
]
