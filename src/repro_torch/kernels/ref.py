"""Plain PyTorch oracles, the counterpart of ``repro.kernels.ref``: exact
softmax attention in fp32, and the stable argsort.  The tests use them;
nothing on the port's paths calls them."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd)  k,v: (B,Sk,KV,hd).  The causal mask is aligned to
    the bottom-right corner (query i sees keys ≤ i + Sk − Sq)."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    k = k.repeat_interleave(G, dim=2).float()
    v = v.repeat_interleave(G, dim=2).float()
    logits = torch.einsum("bqhd,bshd->bhqs", q.float(), k) * scale
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=Sk - Sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, v).to(q.dtype)


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, lengths: torch.Tensor,
                               *, scale: Optional[float] = None
                               ) -> torch.Tensor:
    """q: (B,H,hd)  caches: (B,S,KV,hd)  lengths: (B,)."""
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    k = k_cache.repeat_interleave(G, dim=2).float()
    v = v_cache.repeat_interleave(G, dim=2).float()
    logits = torch.einsum("bhd,bshd->bhs", q.float(), k) * scale
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])
    logits = logits.masked_fill(~mask[:, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v).to(q.dtype)


def stable_argsort_reference(keys: torch.Tensor) -> torch.Tensor:
    return torch.argsort(keys, stable=True).to(torch.int32)


__all__ = ["attention_reference", "decode_attention_reference",
           "stable_argsort_reference", "NEG_INF"]
