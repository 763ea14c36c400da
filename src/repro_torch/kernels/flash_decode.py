"""K2: split-KV flash decode — the hand-written Hopper kernels
(``csrc/flash_decode.cu``) and their plain PyTorch twins.

Two kernels compute the partials, routed by :func:`uses_tensor_cores`: v2
(bf16 with a head dim that is a multiple of 16: one pass a split, K/V
through a ``cp.async`` ring of warp sub-tiles, both products on the bf16
tensor cores, P rounded to bf16 before P·V) and v1 (fp32, which the exact
fp32 goldens run, and other bf16 head dims: FMAs).
``decode_partials(tensor_cores=)`` forces either on the card;
:func:`decode_partials_model` is v2's decomposition in
plain fp32.

On the v2 route :func:`flash_decode` is ONE launch: of the splits of a
(batch row, kv head) that hold a position below lengths[b], the CTA that
finishes last merges them and writes the output (an arrival counter a
(row, kv head), :func:`_arrivals`; a split wholly past the length does
not arrive, and adds exactly +0 to the merge).  On the v1 route it is
two, the partials then :func:`combine`.  Both merge with one routine
(``merge_quad``), in split order (:func:`combine_model`), so the fused
output equals v2 partials + :func:`combine` bit for bit.

Replaces ``repro/kernels/flash_decode.py::decode_partials`` +
``combine_partials`` and the reduce in ``flash_decode``.  The KV range
[0, S) is cut into ``num_splits(S)`` blocks of ``block_k`` positions — a
``demand_split``-free fixed grid, a function of S alone so batched and
one-at-a-time decoding sum in the same order.  Each block yields a partial
softmax (m, l, acc) in fp32; the combine is the associative LSE merge.

Positions >= lengths[b] are masked.  A block wholly past lengths[b] yields
(m, l, acc) = (-1e30, 0, 0), which merges with weight 0.  A row with no
valid position (lengths[b] <= 0) gives what the reference's dense softmax
over all-masked logits gives, the mean of V over all S positions: every
position of it is scored with the one logit -1e30 and none is masked.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

NEG_INF = -1e30
BLOCK_K = 128
PARTIALS = _build.KERNELS["flash_decode_partials"]
COMBINE = _build.KERNELS["flash_decode_combine"]
MAX_HEAD_DIM = 128
GROUPS = (1, 2, 3, 4, 5, 8, 16)  # H / KV values the kernels take (3:
                                 # minitron-4b's 24 / 8, 5: llama4-scout's
                                 # 40 / 8)
MAX_BLOCK_K = 256
SUB = 32                         # v2: cache rows a warp sub-tile
WARPS = 4                        # v2: warps a CTA (one CTA a split)
LOG2E = 1.4426950408889634
ARRIVALS = 1 << 16               # fused K2 v2 and K1 v3: counters a device
_arrival_counters: Dict[int, torch.Tensor] = {}

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def num_splits(S: int, block_k: int = BLOCK_K) -> int:
    return -(-S // block_k)


def uses_tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """The route: v2 (tensor cores) for bf16 with a head dim that is a
    multiple of the MMA depth 16; v1 (FMAs) for fp32 and the rest."""
    return dtype == torch.bfloat16 and head_dim % 16 == 0


def decode_partials_plain(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, lengths: torch.Tensor, *,
                          block_k: int = BLOCK_K,
                          scale: Optional[float] = None) -> Partials:
    """The partials kernel's function in plain PyTorch.  q: (B,H,hd);
    caches (B,S,KV,hd); lengths (B,) → m, l (B,H,nk), acc (B,H,nk,hd)."""
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    nk = num_splits(S, block_k)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    pad = nk * block_k - S
    kf = torch.nn.functional.pad(k_cache.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, 0, 0, pad))
    kf = kf.reshape(B, nk, block_k, KV, hd)
    vf = vf.reshape(B, nk, block_k, KV, hd)
    qf = (q.float() * scale).reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bnjkd->bkgnj", qf, kf)
    pos = torch.arange(nk * block_k, device=q.device).reshape(nk, block_k)
    lens = lengths.to(q.device).reshape(B, 1, 1)
    none = lens <= 0                       # no valid position: attend all S
    valid = pos[None] < torch.where(none, S, lens)               # (B,nk,bk)
    valid = valid[:, None, None]                                 # bcast k,g
    s = s.masked_fill(~valid | none[:, None, None], NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgnj,bnjkd->bkgnd", p, vf)
    return (m.reshape(B, H, nk), l.reshape(B, H, nk),
            acc.reshape(B, H, nk, hd))


def decode_partials_model(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, lengths: torch.Tensor, *,
                          block_k: int = BLOCK_K,
                          scale: Optional[float] = None) -> Partials:
    """v2's decomposition in plain fp32, step for step: in each split, warp
    w takes the sub-tiles of :data:`SUB` rows starting at SUB·(w + WARPS·i)
    below the split's valid count n (rows past n zero-filled and masked);
    the G query heads of a kv head are the rows of one tile; logits are
    scaled in log2 units (scale·log2 e, for exp2) and the warp keeps an
    online softmax over its sub-tiles (a row with no valid key yet
    subtracts 0, so a masked p is exactly 0); the warps' (m, l, acc) merge
    in warp order with weights 2^(m_w - m).  m is reported in natural-log
    units.  A split past lengths[b] gives (-1e30, 0, 0); a row with
    lengths[b] <= 0 scores all S positions 0 and reports m = -1e30.  The
    kernel rounds P to bf16 before P·V; this model keeps it in fp32.
    Returns what :func:`decode_partials_plain` returns."""
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    nk = num_splits(S, block_k)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    dev = q.device
    kf = torch.zeros(B, nk * block_k + SUB, KV, hd, device=dev)
    vf = torch.zeros_like(kf)
    kf[:, :S] = k_cache.float()
    vf[:, :S] = v_cache.float()
    qf = q.float().reshape(B, KV, G, hd)
    lens = lengths.to(dev).long()
    none = lens <= 0                                         # (B,)
    length = torch.where(none, S, lens.clamp(max=S))
    s0 = torch.arange(nk, device=dev) * block_k              # (nk,)
    n = (torch.minimum(s0[None] + block_k, length[:, None])
         - s0[None])                                         # (B, nk)
    m_w, l_w, a_w = [], [], []
    for w in range(WARPS):
        m_r = torch.full((B, KV, G, nk), NEG_INF, device=dev)
        l_r = torch.zeros(B, KV, G, nk, device=dev)
        acc = torch.zeros(B, KV, G, nk, hd, device=dev)
        j0 = w * SUB
        while j0 < block_k:
            pos = s0[:, None] + j0 + torch.arange(SUB, device=dev)  # (nk,SUB)
            kt = kf[:, pos]                              # (B,nk,SUB,KV,hd)
            vt = vf[:, pos]
            x = torch.einsum("bkgd,bnjkd->bkgnj", qf, kt) * (scale * LOG2E)
            key = j0 + torch.arange(SUB, device=dev)
            valid = (key[None, None] < n[:, :, None])[:, None, None]
            x = torch.where(none[:, None, None, None, None], 0.0, x)
            x = x.masked_fill(~valid, NEG_INF)
            mx = torch.maximum(m_r, x.amax(-1))
            mu = torch.where(mx == NEG_INF, 0.0, mx)
            alpha = torch.exp2(m_r - mu)
            p = torch.exp2(x - mu[..., None])
            l_r = l_r * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgnj,bnjkd->bkgnd", p, vt)
            m_r = mx
            j0 += WARPS * SUB
        m_w.append(m_r)
        l_w.append(l_r)
        a_w.append(acc)
    mx = torch.stack(m_w).amax(0)
    mu = torch.where(mx == NEG_INF, 0.0, mx)
    m = torch.full_like(mx, NEG_INF)
    l = torch.zeros_like(mx)
    a = torch.zeros_like(a_w[0])
    for w in range(WARPS):                      # in warp order, as v2 does
        wt = torch.exp2(m_w[w] - mu)
        a = a + wt[..., None] * a_w[w]
        l = l + wt * l_w[w]
    live = (n > 0)[:, None, None, :]                         # (B,1,1,nk)
    m = torch.where(live & ~none[:, None, None, None] & (mx != NEG_INF),
                    mx / LOG2E, m)
    l = torch.where(live, l, 0.0)
    a = torch.where(live[..., None], a, 0.0)
    return (m.reshape(B, H, nk), l.reshape(B, H, nk),
            a.reshape(B, H, nk, hd))


def combine_plain(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The combine kernel's function: LSE merge over the split axis, then
    acc / max(l, 1e-30) in ``dtype``.  → (B,H,hd)."""
    mx = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - mx)
    lsum = (l * w).sum(dim=-1)
    a = (acc * w[..., None]).sum(dim=-2)
    return (a / torch.clamp(lsum, min=1e-30)[..., None]).to(dtype)


def combine_model(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """The merge routine both routes run on the card (``merge_quad``), in
    plain fp32: the max over the splits, then a fold in split order, w =
    exp(m_s - max), l and acc accumulated split by split, and
    acc / max(l, 1e-30) in ``dtype``.  (The kernel fuses each multiply-add;
    this model rounds the product and the sum apart.)"""
    mx = m.amax(dim=-1)
    lsum = torch.zeros_like(mx)
    a = torch.zeros_like(acc[..., 0, :])
    for s in range(m.shape[-1]):
        w = torch.exp(m[..., s] - mx)
        lsum = lsum + l[..., s] * w
        a = a + acc[..., s, :] * w[..., None]
    return (a / torch.clamp(lsum, min=1e-30)[..., None]).to(dtype)


def flash_decode_plain(q, k_cache, v_cache, lengths, *,
                       block_k: int = BLOCK_K,
                       scale: Optional[float] = None) -> torch.Tensor:
    m, l, acc = decode_partials_plain(q, k_cache, v_cache, lengths,
                                      block_k=block_k, scale=scale)
    return combine_plain(m, l, acc, v_cache.dtype)


def _check(q, k_cache, v_cache, lengths, block_k: int) -> None:
    dev = q.device
    if not (q.is_cuda and k_cache.device == dev and v_cache.device == dev
            and lengths.device == dev):
        raise ValueError("flash_decode: q, caches and lengths must be on one "
                         "CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"flash_decode takes bf16 or fp32 q/caches of one "
                        f"dtype, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if lengths.dtype != torch.int32 or lengths.dim() != 1:
        raise TypeError(f"flash_decode: lengths must be (B,) int32, got "
                        f"{lengths.dtype} {tuple(lengths.shape)}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_decode: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    if k_cache.shape[0] != B or lengths.shape[0] != B or \
            k_cache.shape[3] != hd or H % KV != 0:
        raise ValueError(f"flash_decode: q{tuple(q.shape)}, "
                         f"k{tuple(k_cache.shape)}, lengths"
                         f"{tuple(lengths.shape)} do not match")
    if hd > MAX_HEAD_DIM or hd % 4 or H // KV not in GROUPS:
        raise ValueError(f"flash_decode: head_dim {hd} must be a multiple "
                         f"of 4 and <= {MAX_HEAD_DIM}, H/KV {H // KV} one "
                         f"of {GROUPS}")
    if not 1 <= block_k <= MAX_BLOCK_K:
        raise ValueError(f"flash_decode: block_k {block_k} outside "
                         f"[1, {MAX_BLOCK_K}]")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")
        if name != "lengths" and t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be 16-byte "
                             f"aligned (vector loads)")


def _partials(q, k_cache, v_cache, lengths, block_k: int,
              scale: Optional[float], tc: bool,
              out: Optional[torch.Tensor] = None) -> Partials:
    """One launch of the partials kernel on checked CUDA inputs; with
    ``out`` (v2 only) the merge is fused and written there."""
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    nk = num_splits(S, block_k)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    m = torch.empty((B, H, nk), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((B, H, nk, hd), dtype=torch.float32, device=q.device)
    arrive = None if out is None else _arrivals(q.device, B * KV)
    PARTIALS(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
             None if out is None else out.data_ptr(),
             None if arrive is None else arrive.data_ptr(),
             B, S, H, KV, hd, block_k, nk, float(scale),
             int(q.dtype == torch.bfloat16), int(tc),
             torch.cuda.current_stream(q.device).cuda_stream,
             tag=f"group {H // KV}")
    return m, l, acc


def _arrivals(device: torch.device, need: int,
              who: str = "flash_decode") -> torch.Tensor:
    """The fused routes' arrival counters on ``device``: K2's one a (batch
    row, kv head) counting its live splits, and K1's split merge
    (``flash_attention``) one a (batch row, kv head, row tile), each
    counting modulo its number of live splits.  One buffer a device,
    allocated zeroed at the first fused call and never freed; every
    complete launch leaves its counters at 0, so the two kernels share it
    launch after launch.  It serves one stream at a time: two fused
    launches in flight at once on two streams would share counters.  The
    first call must come before any CUDA graph capture (a warm-up call),
    so the allocation is never captured."""
    if need > ARRIVALS:
        raise ValueError(f"{who}: {need} arrival counters needed, at most "
                         f"{ARRIVALS}")
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    buf = _arrival_counters.get(idx)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{who}: the fused route's counters are "
                               "allocated at its first call, which must "
                               "come before a CUDA graph capture")
        buf = torch.zeros(ARRIVALS, dtype=torch.int32,
                          device=torch.device("cuda", idx))
        _arrival_counters[idx] = buf
    return buf


def decode_partials(q, k_cache, v_cache, lengths, *, block_k: int = BLOCK_K,
                    scale: Optional[float] = None,
                    tensor_cores: Optional[bool] = None) -> Partials:
    """Partials kernel alone (one launch); plain twin for CPU tensors.
    ``tensor_cores`` overrides :func:`uses_tensor_cores` (the card check
    times v1 beside v2); a forced v2 raises on what it does not take."""
    if q.device.type == "cpu":
        return decode_partials_plain(q, k_cache, v_cache, lengths,
                                     block_k=block_k, scale=scale)
    _check(q, k_cache, v_cache, lengths, block_k)
    hd = q.shape[-1]
    tc = uses_tensor_cores(q.dtype, hd) if tensor_cores is None \
        else tensor_cores
    if tc and not uses_tensor_cores(q.dtype, hd):
        raise ValueError(f"flash_decode: the tensor-core kernel takes bf16 "
                         f"with head_dim % 16 == 0, got {q.dtype}, {hd}")
    return _partials(q, k_cache, v_cache, lengths, block_k, scale, tc)


def combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """Combine kernel (one launch); plain twin for CPU tensors."""
    if m.device.type == "cpu":
        return combine_plain(m, l, acc, dtype)
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_decode combine: output dtype {dtype}")
    for t in (m, l, acc):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                not t.is_cuda or t.device != m.device:
            raise ValueError("flash_decode combine: partials must be "
                             "contiguous fp32 on one CUDA device")
    B, H, nk = m.shape
    hd = acc.shape[-1]
    if l.shape != m.shape or acc.shape != (B, H, nk, hd):
        raise ValueError("flash_decode combine: partial shapes differ")
    if hd % 4 or acc.data_ptr() % 16:
        raise ValueError("flash_decode combine: acc rows must be 16-byte "
                         "vectors (head_dim % 4 == 0, aligned)")
    out = torch.empty((B, H, hd), dtype=dtype, device=m.device)
    COMBINE(m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(),
            B, H, hd, nk, int(dtype == torch.bfloat16),
            torch.cuda.current_stream(m.device).cuda_stream)
    return out


def flash_decode(q, k_cache, v_cache, lengths, *, block_k: int = BLOCK_K,
                 scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention: q (B,H,hd), caches (B,S,KV,hd), lengths (B,)
    int32 → (B,H,hd) in the cache dtype.  On CUDA: one launch on the v2
    route (the merge fused into the partials kernel), two on v1 (partials,
    then :func:`combine`).  The fused route's arrival counters serve one
    stream at a time (:func:`_arrivals`)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths,
                                  block_k=block_k, scale=scale)
    _check(q, k_cache, v_cache, lengths, block_k)
    if not uses_tensor_cores(q.dtype, q.shape[-1]):
        m, l, acc = _partials(q, k_cache, v_cache, lengths, block_k, scale,
                              False)
        return combine(m, l, acc, v_cache.dtype)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _partials(q, k_cache, v_cache, lengths, block_k, scale, True, out=out)
    return out


def kernel_attributes() -> Dict[str, Dict[str, int]]:
    """Registers, spills, shared memory and CTAs an SM of K2's kernels, as
    the compiled library and the occupancy calculator report them."""
    names = ("v2 decode_partials_tc_kernel<128>",
             "v1 decode_partials_kernel<bf16, 4>",
             "v1 decode_partials_kernel<float, 4>",
             "decode_combine_kernel<bf16>",
             "v2 decode_partials_tc_kernel<64>")
    return {name: _build.attributes("flash_decode", "flash_decode_attrs",
                                    which)
            for which, name in enumerate(names)}


__all__ = ["flash_decode", "flash_decode_plain", "decode_partials",
           "decode_partials_plain", "decode_partials_model", "combine",
           "combine_plain", "combine_model", "num_splits",
           "uses_tensor_cores", "kernel_attributes", "BLOCK_K", "GROUPS",
           "PARTIALS", "COMBINE"]
