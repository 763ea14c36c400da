"""K1: GQA flash attention forward — the hand-written Hopper kernel
(``csrc/flash_attention.cu``) and its plain PyTorch twin.

Replaces ``repro/kernels/flash_attention.py::flash_attention``.  Beyond the
TPU kernel it takes a ``q_offset`` (query row i sits at position
q_offset + i and attends to keys ≤ that position — chunked prefill over a
cache), ragged ``Sq``/``Sk`` and causal pruning of the kv loop.

:func:`flash_attention` launches the kernel for CUDA tensors and raises on
what the kernel does not take; it runs :func:`flash_attention_plain` only
for tensors on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
KERNEL = _build.KERNELS["flash_attention_fwd"]
MAX_HEAD_DIM = 128


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: q cast to fp32 then scaled,
    fp32 logits and softmax, masked logits -1e30, output in q.dtype.

    q: (B,Sq,H,hd)  k,v: (B,Sk,KV,hd) → (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = (q.float() * scale).reshape(B, Sq, KV, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        k_pos = torch.arange(Sk, device=q.device)
        logits = logits.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or fp32 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2] != 0:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not "
                         f"match k{tuple(k.shape)}")
    if hd > MAX_HEAD_DIM or hd % 4 != 0:
        raise ValueError(f"flash_attention: head_dim {hd} must be a "
                         f"multiple of 4 and <= {MAX_HEAD_DIM}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned (vector loads)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset=0) -> torch.Tensor:
    """q: (B,Sq,H,hd)  k,v: (B,Sk,KV,hd) → (B,Sq,H,hd).

    ``q_offset`` may be an int or a 0-d tensor (read on the host)."""
    q_offset = int(q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset)
    _check(q, k, v, q_offset)
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           B, Sq, Sk, H, KV, hd, int(causal), float(scale), q_offset,
           int(q.dtype == torch.bfloat16),
           torch.cuda.current_stream(q.device).cuda_stream)
    return out


__all__ = ["flash_attention", "flash_attention_plain", "KERNEL"]
