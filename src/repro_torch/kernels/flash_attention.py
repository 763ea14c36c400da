"""K1: GQA flash attention forward — the hand-written Hopper kernels
(``csrc/flash_attention.cu``) and their plain PyTorch twins.

Replaces ``repro/kernels/flash_attention.py::flash_attention``.  Beyond the
TPU kernel it takes a ``q_offset`` (query row i sits at position
q_offset + i and attends to keys ≤ that position — chunked prefill over a
cache), ragged ``Sq``/``Sk`` and causal pruning of the kv loop.

The v head dim may be narrower than q/k's (MLA: 192 and 128).  Two
kernels compute it, chosen by :func:`uses_tensor_cores` from the dtype and
the head dims alone: v3 (bf16, one head dim a multiple of 16 up to 128,
or MLA's (192, 128)) on the tensor cores, with GQA row packing and, for
short chunks, the key range split over CTAs (:func:`num_splits`); v2
(fp32, and other bf16 head dims: q/k up to 192, v up to 128) with fp32
FMAs.  A split v3 call with few splits (:func:`fused_merge`) is ONE
launch: the live splits of a row tile (:func:`live_splits`, those with a
kv tile) write fp32 partials, and the CTA that arrives last on the tile's
counter merges them into the output (arrival counters shared with K2,
``flash_decode._arrivals``); with more splits it is two, the partials
then the standalone merge, which spreads the merge over the card.  The split
decomposition, in plain PyTorch: the per-split partials
(:func:`split_partials_plain`) over the packed rows (:func:`packed_rows`,
:func:`split_key_ranges`), their fixed-order merge (:func:`merge_plain`),
and the fused merge as one tile's last CTA runs it
(:func:`fused_merge_model`).

:func:`flash_attention` (and :func:`split_partials` + :func:`merge`, the
two launches the fused route replaces, kept as the route the card check
times it against) launches a kernel for CUDA tensors and raises on what
the kernels do not take (a launch is counted under the counter's ``tags``
as ``"noncausal"`` when it is, ``"fused"`` when it merges its splits);
each runs its plain twin only for tensors on the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .flash_decode import _arrivals

NEG_INF = -1e30
KERNEL = _build.KERNELS["flash_attention_fwd"]
MERGE = _build.KERNELS["flash_attention_merge"]
MAX_HEAD_DIM = 128    # v head dim (and q/k but for MLA's 192)
MAX_QK_HEAD_DIM = 192
TC_HEAD_DIMS = {(d, d) for d in range(16, 129, 16)} | {(192, 128)}  # v3's
BLOCK_M = 64          # v3: packed (query, q head) rows a CTA
BLOCK_N = 64          # v3: keys a shared-memory tile
NUM_SMS = 132         # H100 SXM
CTAS_PER_SM = 2       # v3's occupancy (registers: 200 a thread)
MIN_TILES_PER_SPLIT = 3
MAX_SPLITS = 16
MAX_FUSED_SPLITS = 40    # fused merge: its m, l, weights in shared memory
FUSED_UP_TO = 2          # the rule's route: fused up to this many splits


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: q cast to fp32 then scaled,
    fp32 logits and softmax, masked logits -1e30, output in q.dtype.

    q: (B,Sq,H,hd)  k: (B,Sk,KV,hd)  v: (B,Sk,KV,hv) → (B,Sq,H,hv)."""
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
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


# ----------------------------------------------- the v3 decomposition, plain

def uses_tensor_cores(dtype: torch.dtype, head_dim: int,
                      v_head_dim: Optional[int] = None) -> bool:
    """The route: v3 (tensor cores) for bf16 at the head dims it is built
    for (:data:`TC_HEAD_DIMS`: one dim, a multiple of the MMA depth 16 up
    to 128, or MLA's (192, 128)); v2 (fp32 FMAs) for the rest."""
    hv = head_dim if v_head_dim is None else v_head_dim
    return dtype == torch.bfloat16 and (head_dim, hv) in TC_HEAD_DIMS


def num_splits(B: int, Sq: int, H: int, KV: int, Sk: int, *,
               causal: bool = True, q_offset: int = 0) -> int:
    """Key-range splits of v3, from shapes alone: as many as keep every
    CTA (row tiles × kv heads × rows × splits) in one wave of
    :data:`CTAS_PER_SM` CTAs on each SM, with at least
    :data:`MIN_TILES_PER_SPLIT` kv tiles of the chunk's window a split (a
    split costs a partials round trip and a share of the merge), and at
    most :data:`MAX_SPLITS`."""
    G = H // KV
    ctas = B * KV * -(-Sq * G // BLOCK_M)
    kv_len = min(Sk, q_offset + Sq) if causal else Sk
    kv_tiles = -(-kv_len // BLOCK_N)
    return max(1, min(MAX_SPLITS, kv_tiles // MIN_TILES_PER_SPLIT,
                      CTAS_PER_SM * NUM_SMS // ctas))


def fused_merge(nsplit: int) -> bool:
    """The route of a split v3 call: one launch whose last CTA a row tile
    merges (up to :data:`FUSED_UP_TO` splits), or split partials then the
    standalone merge.  Measured on an H100 (``PERF.md`` §6): the
    fused launch ties or beats the two at 2 splits, and loses at 4 to 9,
    where one SM a tile merges what the standalone merge spreads over the
    card."""
    return 1 < nsplit <= FUSED_UP_TO


def packed_rows(Sq: int, G: int) -> torch.Tensor:
    """(Sq·G, 2) int64: packed row R of a kv head's CTAs holds query
    R // G and q head R % G of the group (query-major, so a 64-row tile
    covers 64 / G consecutive queries and G need not divide 64)."""
    R = torch.arange(Sq * G)
    return torch.stack([R // G, R % G], dim=1)


def _tile_kv_tiles(Sq: int, G: int, Sk: int, causal: bool,
                   q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k_hi, n_t), each (row tiles,): the keys a v3 row tile reads (below
    its last query + 1 if causal, at most Sk) and their kv tiles."""
    M = Sq * G
    first = torch.arange(0, M, BLOCK_M)
    q_last = (torch.clamp(first + BLOCK_M, max=M) - 1) // G
    k_hi = (torch.clamp(q_offset + q_last + 1, max=Sk) if causal
            else torch.full_like(q_last, Sk))
    return k_hi, -(-k_hi // BLOCK_N)


def split_key_ranges(Sq: int, G: int, Sk: int, nsplit: int, *,
                     causal: bool = True,
                     q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), each (nsplit, Sq·G): the keys [lo, hi) that split s reads
    for packed row R, as v3 cuts them.  Its tile of BLOCK_M rows reads keys
    below k_hi (the tile's last query + 1 if causal, at most Sk) in n_t
    tiles of BLOCK_N; split s takes tiles [s·per, (s+1)·per) of them, per =
    ceil(n_t / nsplit).  A split may be empty (lo = hi = k_hi) or lie past
    a row's causal window."""
    k_hi, n_t = _tile_kv_tiles(Sq, G, Sk, causal, q_offset)
    per = -(-n_t // nsplit)
    s = torch.arange(nsplit)[:, None]
    lo = torch.minimum(torch.minimum(s * per, n_t) * BLOCK_N, k_hi)
    hi = torch.minimum(torch.minimum((s + 1) * per, n_t) * BLOCK_N, k_hi)
    tile = torch.arange(Sq * G) // BLOCK_M
    return lo[:, tile], hi[:, tile]


def live_splits(Sq: int, G: int, Sk: int, nsplit: int, *,
                causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """(row tiles,) int64: each v3 row tile's live splits, those that hold
    a kv tile: ceil(n_t / per), per = ceil(n_t / nsplit), a prefix of the
    split order.  The kernel computes the same count; the fused route's
    splits past it exit at once and do not arrive."""
    _, n_t = _tile_kv_tiles(Sq, G, Sk, causal, q_offset)
    per = -(-n_t // nsplit)
    return -(-n_t // per)


def split_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         nsplit: int, *, causal: bool = True,
                         scale: Optional[float] = None, q_offset: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each split's fp32 partials over its keys: m (nsplit,B,Sq,H) the max
    scaled logit, l the sum of exp(logit − m), acc (nsplit,B,Sq,H,hv) the
    exp-weighted sum of V.  A row with no valid key in a split gets
    m = -1e30, l = 0, acc = 0 (weight 0 in the merge)."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = (q.float() * scale).reshape(B, Sq, KV, G, hd)
    logits = torch.einsum("bqkgd,bskd->bqkgs", qf, k.float()
                          ).reshape(B, Sq, H, Sk)
    lo, hi = split_key_ranges(Sq, G, Sk, nsplit, causal=causal,
                              q_offset=q_offset)
    # packed row R = i·G + g is the same for every kv head: (nsplit, Sq, H)
    lo = lo.reshape(nsplit, Sq, 1, G).expand(-1, -1, KV, -1
                                             ).reshape(nsplit, Sq, H)
    hi = hi.reshape(nsplit, Sq, 1, G).expand(-1, -1, KV, -1
                                             ).reshape(nsplit, Sq, H)
    kpos = torch.arange(Sk)
    valid = (kpos >= lo[..., None]) & (kpos < hi[..., None])
    if causal:
        qpos = q_offset + torch.arange(Sq)
        valid = valid & (kpos <= qpos[:, None, None])
    valid = valid.to(q.device)[:, None]                # (n, 1, Sq, H, Sk)
    x = torch.where(valid, logits[None], NEG_INF)
    seen = valid.any(-1)
    m = torch.where(seen, x.amax(-1), NEG_INF)
    p = torch.exp(x - torch.where(seen, m, 0.0)[..., None])
    acc = torch.einsum("nbqhs,bshd->nbqhd", p,
                       v.float().repeat_interleave(G, dim=2))
    return m, p.sum(-1), acc


def merge_plain(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The merge of the splits: o = Σ_s e^(m_s − M) acc_s /
    max(Σ_s e^(m_s − M) l_s, 1e-30), M = max_s m_s, summed in split
    order."""
    M = m.amax(0)
    L = torch.zeros_like(l[0])
    o = torch.zeros_like(acc[0])
    for s in range(m.shape[0]):
        w = torch.exp(m[s] - M)
        L = L + w * l[s]
        o = o + w[..., None] * acc[s]
    return (o / torch.clamp(L, min=1e-30)[..., None]).to(dtype)


def fused_merge_model(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                      live: int, dtype: torch.dtype, *,
                      arrivals: Optional[Tuple[int, ...]] = None
                      ) -> Tuple[torch.Tensor, int, int]:
    """The fused route's merge of one row tile, in plain form.  m, l
    (nsplit, rows) and acc (nsplit, rows, hd): the tile's rows' partials,
    of which only the first ``live`` splits were written (the rest are
    never read).  The live splits' CTAs count their arrival in the order
    ``arrivals`` (default: split order) on a counter that counts modulo
    live (``atom.inc``); the one that reads live − 1 merges: the max over
    the live splits, then in split order w_s = e^(m_s − max), l and acc
    folded split by split, +0 once where live < nsplit (what the empty
    splits add to :func:`merge_plain`), and acc / max(l, 1e-30) in
    ``dtype``.  Returns (output, the merging split, the counter after):
    the output does not depend on which split merges."""
    n = m.shape[0]
    order = tuple(range(live)) if arrivals is None else tuple(arrivals)
    if sorted(order) != list(range(live)):
        raise ValueError(f"arrivals {order} are not the {live} live splits")
    counter, merger = 0, None
    for s in order:
        old = counter
        counter = 0 if old >= live - 1 else old + 1
        if old == live - 1:
            merger = s
    mx = m[:live].amax(0)
    L = torch.zeros_like(l[0])
    o = torch.zeros_like(acc[0])
    for s in range(live):
        w = torch.exp(m[s] - mx)
        L = L + w * l[s]
        o = o + w[..., None] * acc[s]
    if live < n:
        L, o = L + 0.0, o + 0.0
    return ((o / torch.clamp(L, min=1e-30)[..., None]).to(dtype), merger,
            counter)


# ------------------------------------------------------------- the kernels

def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or fp32 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    hv = v.shape[3]
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2] != 0:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not "
                         f"match k{tuple(k.shape)}")
    if hd > MAX_QK_HEAD_DIM or hv > MAX_HEAD_DIM or hd % 4 or hv % 4:
        raise ValueError(f"flash_attention: head dims q/k {hd}, v {hv} must "
                         f"be multiples of 4, <= {MAX_QK_HEAD_DIM} and "
                         f"<= {MAX_HEAD_DIM}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned (vector loads)")


def split_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   nsplit: int, *, causal: bool = True,
                   scale: Optional[float] = None, q_offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The v3 launch into fp32 partials m, l (nsplit,B,Sq,H) and acc
    (…, hv) of :func:`split_partials_plain`; P is rounded to bf16 before
    the P·V product, so acc differs from the twin's by that rounding."""
    q_offset = int(q_offset)
    if q.device.type == "cpu":
        return split_partials_plain(q, k, v, nsplit, causal=causal,
                                    scale=scale, q_offset=q_offset)
    _check(q, k, v, q_offset)
    B, Sq, H, hd = q.shape
    _, Sk, KV, hv = v.shape
    if not uses_tensor_cores(q.dtype, hd, hv) or nsplit < 2:
        raise ValueError(f"flash_attention: split partials need bf16, "
                         f"head dims in {sorted(TC_HEAD_DIMS)} and >= 2 "
                         f"splits, got {q.dtype}, ({hd}, {hv}), {nsplit}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    m, l, acc = _partials(nsplit, B, Sq, H, hv, q.device)
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, m.data_ptr(),
           l.data_ptr(), acc.data_ptr(), None, B, Sq, Sk, H, KV, hd, hv,
           int(causal), float(scale), q_offset, 1, 1, nsplit,
           torch.cuda.current_stream(q.device).cuda_stream,
           tag=() if causal else ("noncausal",))
    return m, l, acc


def _scratch(rows: int, hd: int, device: torch.device
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """m, l (rows,) and acc (rows, hd), fp32 views of one allocation (acc
    first, so its rows are 16-byte aligned)."""
    buf = torch.empty(rows * (hd + 2), dtype=torch.float32, device=device)
    return (buf[rows * hd:rows * (hd + 1)], buf[rows * (hd + 1):],
            buf[:rows * hd].view(rows, hd))


def _partials(nsplit: int, B: int, Sq: int, H: int, hd: int,
              device: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`split_partials`' m, l (nsplit,B,Sq,H) and acc (…, hd)."""
    m, l, acc = _scratch(nsplit * B * Sq * H, hd, device)
    return (m.view(nsplit, B, Sq, H), l.view(nsplit, B, Sq, H),
            acc.view(nsplit, B, Sq, H, hd))


def merge(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
          ) -> torch.Tensor:
    """The merge launch: (nsplit,B,Sq,H) fp32 m, l and (…, hd) acc → bf16
    (B,Sq,H,hd), splits summed in order (bit-identical across runs)."""
    if m.device.type == "cpu":
        return merge_plain(m, l, acc, torch.bfloat16)
    if not (m.is_cuda and l.device == m.device and acc.device == m.device):
        raise ValueError("flash_attention merge: partials must be on one "
                         "CUDA device")
    if m.dtype != torch.float32 or l.dtype != torch.float32 or \
            acc.dtype != torch.float32:
        raise TypeError("flash_attention merge: partials must be fp32")
    nsplit, B, Sq, H = m.shape
    hd = acc.shape[-1]
    if l.shape != m.shape or acc.shape != (nsplit, B, Sq, H, hd) or \
            hd % 4 or not (m.is_contiguous() and l.is_contiguous()
                           and acc.is_contiguous()):
        raise ValueError(f"flash_attention merge: bad partials m"
                         f"{tuple(m.shape)} l{tuple(l.shape)} "
                         f"acc{tuple(acc.shape)}")
    out = torch.empty((B, Sq, H, hd), dtype=torch.bfloat16, device=m.device)
    MERGE(m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(),
          B * Sq * H, hd, nsplit,
          torch.cuda.current_stream(m.device).cuda_stream)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset=0, tensor_cores: Optional[bool] = None,
                    splits: Optional[int] = None,
                    fused: Optional[bool] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd)  k: (B,Sk,KV,hd)  v: (B,Sk,KV,hv) → (B,Sq,H,hv).

    ``q_offset`` may be an int or a 0-d tensor (read on the host).
    ``tensor_cores`` and ``splits`` override :func:`uses_tensor_cores` and
    :func:`num_splits` (the card check compares v2 with v3 and forces
    split counts); v2 takes no split, and a forced v3 raises on what it
    does not take.  A split call takes :func:`fused_merge`'s route, or
    the one ``fused`` forces: one launch with the merge fused (counted
    under ``KERNEL.tags["fused"]`` too; its counters serve one stream at a
    time, ``flash_decode._arrivals``), or :func:`split_partials` then
    :func:`merge`."""
    q_offset = int(q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset)
    _check(q, k, v, q_offset)
    B, Sq, H, hd = q.shape
    _, Sk, KV, hv = v.shape
    tc = uses_tensor_cores(q.dtype, hd, hv) if tensor_cores is None \
        else tensor_cores
    if tc and not uses_tensor_cores(q.dtype, hd, hv):
        raise ValueError(f"flash_attention: the tensor-core kernel takes "
                         f"bf16 at head dims {sorted(TC_HEAD_DIMS)}, got "
                         f"{q.dtype}, ({hd}, {hv})")
    nsplit = 1 if not tc else splits if splits is not None else num_splits(
        B, Sq, H, KV, Sk, causal=causal, q_offset=q_offset)
    if nsplit < 1 or (nsplit > 1 and not tc):
        raise ValueError(f"flash_attention: {nsplit} splits need the "
                         f"tensor-core kernel and >= 1")
    fuse = fused_merge(nsplit) if fused is None else fused and nsplit > 1
    if nsplit > 1 and not fuse:
        return merge(*split_partials(q, k, v, nsplit, causal=causal,
                                     scale=scale, q_offset=q_offset))
    if nsplit > MAX_FUSED_SPLITS:
        raise ValueError(f"flash_attention: {nsplit} splits, the fused "
                         f"merge takes at most {MAX_FUSED_SPLITS}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = q.new_empty((B, Sq, H, hv))
    m = l = acc = arrive = None
    if nsplit > 1:                   # one launch: the last CTA merges
        tiles = B * KV * -(-Sq * (H // KV) // BLOCK_M)
        # scratch of the live splits, tile-major: each CTA's rows together
        m, l, acc = _scratch(tiles * nsplit * BLOCK_M, hv, q.device)
        arrive = _arrivals(q.device, tiles, "flash_attention")
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           *(None if t is None else t.data_ptr() for t in (m, l, acc, arrive)),
           B, Sq, Sk, H, KV, hd, hv, int(causal), float(scale), q_offset,
           int(q.dtype == torch.bfloat16), int(tc), nsplit,
           torch.cuda.current_stream(q.device).cuda_stream,
           tag=("fused",) * (nsplit > 1) + ("noncausal",) * (not causal))
    return out


def kernel_attributes() -> Dict[str, Dict[str, int]]:
    """Registers, spills, shared memory and CTAs an SM of K1's kernels, as
    the compiled library and the occupancy calculator report them."""
    return {name: _build.attributes("flash_attention",
                                    "flash_attention_attrs", which)
            for which, name in enumerate((
                "v3 flash_fwd_tc_kernel<128, 128>",
                "v2 flash_fwd_kernel<bf16, 128>",
                "v2 flash_fwd_kernel<float, 128>",
                "flash_fwd_merge_kernel",
                "v3 flash_fwd_tc_kernel<192, 128>",
                "v2 flash_fwd_kernel<float, 192>",
                "v3 flash_fwd_tc_kernel<64, 64>"))}


__all__ = ["flash_attention", "flash_attention_plain", "uses_tensor_cores",
           "TC_HEAD_DIMS",
           "num_splits", "fused_merge", "packed_rows", "split_key_ranges",
           "live_splits",
           "split_partials_plain", "merge_plain", "fused_merge_model",
           "split_partials", "merge",
           "kernel_attributes", "KERNEL", "MERGE"]
