"""The stable sort's radix kernels — the counterpart of
``repro.kernels.radix_sort``, with the hand-written Hopper kernels
(``csrc/radix_sort.cu``) and their plain PyTorch twins.

* K7a ``radix_tile_sort``: every tile of a (n,) uint32 array sorted stably
  by the bits ``[key_shift, key_shift + total_bits)``; all digit passes in
  one launch.  The kernel ranks 8 bits a pass whatever ``digit_bits`` says
  (a stable LSD sort by the same bits has one result whatever its digit
  width); ``digit_bits`` is checked as the reference checks it.
* K7b ``radix_tile_sort_packed``: raw int32 keys in, per-tile-sorted packed
  words ``key << idx_bits | global_index`` out (pad slots the sentinel), or
  with ``unpack`` the int32 order itself.  Only the key digits are ranked:
  in-tile the index bits are the (ordered) positions, carried by stability.
  The kernel ranks ``ceil(bits / 8)`` passes of one width
  (:func:`k7b_digits`) whatever ``digit_bits`` or the plan's passes say,
  on a CTA shaped by the tile count (:func:`k7b_shape`);
  ``packed_tile_sort_model`` is its decomposition in plain PyTorch, and
  ``v1=True`` launches the first design, which the card check times v2
  against.
* K6a ``_mt_local`` and K6b ``_mt_scatter``: the two halves of one
  multi-tile LSD digit pass (per-tile stable sort plus histogram; every
  (tile, digit) segment to its global base), with K5
  (``tile_scan.histogram_offsets``) between them;
  ``multi_tile_argsort_packed`` runs ``3 · num_passes`` launches,
  independent of n.  ``mt_local_model`` and ``mt_scatter_model`` are
  their kernels' decompositions in plain PyTorch.

Packed words are ``torch.uint32``, orders ``torch.int32``, as the
reference's dtypes.  Each wrapper runs its plain twin for a CPU tensor (a
per-row ``torch.sort(stable=True)`` by the digit or key field, in int64)
and launches its kernel for a CUDA tensor, or raises; nothing falls back.
``group`` (tiles per TPU grid cell) is kept for the reference's signature
and changes nothing here.

* K3 ``moe_dispatch_sort``: the MoE dispatch — the stable sort of the
  (T·K,) expert ids with the activation rows moved into that order, plus
  the per-expert counts (``csrc/moe_dispatch.cu``); its twin is
  ``moe_dispatch_sort_plain`` (a stable argsort and gathers).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core.plan import DigitPass, digit_passes
from . import _build
from .tile_scan import histogram_offsets

# the single definition — merge_sort imports it: pad words must compare
# above every real packed key in both the tile and the merge phases
SENTINEL = 0xFFFFFFFF
M32 = 0xFFFFFFFF

# the reference's int16 rank arithmetic bound, kept: a CUDA tile lives in
# shared memory (two buffers of 2^13 words)
_MAX_RADIX_TILE = 1 << 13

K7A = _build.KERNELS["radix_tile_sort"]
K7B = _build.KERNELS["radix_tile_sort_packed"]
K6A = _build.KERNELS["radix_mt_local"]
K6B = _build.KERNELS["radix_mt_scatter"]
K3 = _build.KERNELS["moe_dispatch"]

_MAX_DISPATCH_EXPERTS = 256     # one digit of at most 9 bits (sentinel E)
_MAX_DISPATCH_TILE = 2048       # K3's tile of composites in shared memory
K3_THREADS = 128                # K3's one-tile kernel: threads a CTA
K3_MAX_PER = 8                  # and words a thread at most
NUM_SMS = 132                   # H100 SXM
_ROW_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def _check_tile(tile: int, digit_bits: int) -> None:
    if tile & (tile - 1):
        raise ValueError(f"radix tile must be a power of two, got {tile}")
    if tile > _MAX_RADIX_TILE:
        raise ValueError(f"radix tile sort supports tile ≤ {_MAX_RADIX_TILE} "
                         f"(int16 rank arithmetic), got {tile}")
    if not 1 <= digit_bits <= 8:
        raise ValueError(f"digit_bits must be in [1, 8], got {digit_bits}")


def _pick_group(num_tiles: int, group: int) -> int:
    return math.gcd(num_tiles, max(1, group))


# ---------------------------------------------------------------------------
# u32 words as int64 in the twins (torch's uint32 has no shifts on the CPU)
# ---------------------------------------------------------------------------

def _u64(x: torch.Tensor) -> torch.Tensor:
    """uint32 words, or int32 keys reinterpreted as their uint32 bits, as
    int64 values in [0, 2^32)."""
    return x.to(torch.int64) & M32


def _u32(v: torch.Tensor) -> torch.Tensor:
    return (v & M32).to(torch.uint32)


def _i32(v: torch.Tensor) -> torch.Tensor:
    return (v & M32).to(torch.int32)        # wraps as the reference's astype


def _shr(v: torch.Tensor, s: int) -> torch.Tensor:
    return v >> s if s < 32 else torch.zeros_like(v)


def _shl(v: torch.Tensor, s: int) -> torch.Tensor:
    return (v << s) & M32 if s < 32 else torch.zeros_like(v)


def _sort_rows(words: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    """Each row of ``words`` stably sorted by ``field`` (both (rows, m))."""
    order = torch.sort(field, dim=1, stable=True).indices
    return torch.gather(words, 1, order)


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def radix_tile_sort_plain(x: torch.Tensor, *, tile: int, total_bits: int,
                          key_shift: int) -> torch.Tensor:
    """Twin of K7a: per tile, a stable sort by the ``total_bits`` bits at
    ``key_shift`` (what the LSD passes compute together)."""
    n = x.shape[0]
    w = _u64(x).reshape(n // tile, tile)
    field = _shr(w, key_shift) & ((1 << min(total_bits, 32)) - 1)
    return _u32(_sort_rows(w, field)).reshape(n)


def k7a_threads(tile: int) -> int:
    """K7a's CTA size for a tile: 128 threads up to 1024 words, else 256
    (``K7A_SMALL_THREADS`` and ``K7A_SMALL_TILE`` in csrc/radix_sort.cu)."""
    return 128 if tile <= 1024 else 256


def _warp_ranks(digit: torch.Tensor, tile: int, radix: int,
                threads: Optional[int] = None) -> torch.Tensor:
    """The rank K7a, K6a and K7b v2 give each word of the (nt, tile) rows
    by its digit in [0, radix) (``rank_place`` in csrc/radix_rank.cuh):
    with T threads a CTA (``k7a_threads(tile)`` unless given) and K =
    max(1, tile // T), warp w owns the words ``[w * 32K, (w + 1) * 32K)``;
    a word's rank is ``base[digit, w]`` (the digit-major exclusive scan of
    the (digit, warp) counts) plus its offset among the equal digits
    before it in its warp's chunk."""
    nt = digit.shape[0]
    dev = digit.device
    threads = threads or k7a_threads(tile)
    warps = threads // 32
    chunk = 32 * max(1, tile // threads)
    warp = (torch.arange(tile, device=dev) // chunk).expand(nt, tile)
    rows = torch.arange(nt, device=dev)[:, None]
    seg = digit * warps + warp                          # digit-major
    counts = torch.zeros(nt, radix * warps, dtype=torch.int64, device=dev)
    counts.scatter_add_(1, seg, torch.ones_like(seg))
    base = torch.cumsum(counts, 1) - counts
    # offset among equal (digit, warp) before it: its place in the stable
    # order of seg, less the segment's first place
    order = torch.sort(seg, dim=1, stable=True).indices
    offset = torch.empty_like(seg)
    offset[rows, order] = torch.arange(tile, device=dev) - \
        torch.gather(base, 1, torch.gather(seg, 1, order))
    return torch.gather(base, 1, seg) + offset


def _place(w: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    placed = torch.empty_like(w)
    placed[torch.arange(w.shape[0], device=w.device)[:, None], rank] = w
    return placed


def radix_tile_sort_model(x: torch.Tensor, *, tile: int, total_bits: int,
                          key_shift: int) -> torch.Tensor:
    """K7a's decomposition in plain PyTorch, pass by pass: 8-bit digits (the
    last pass narrower; none at bit 32 or above), each word placed at its
    :func:`_warp_ranks` rank.  Equals :func:`radix_tile_sort_plain`."""
    n = x.shape[0]
    w = _u64(x).reshape(n // tile, tile)
    lo = 0
    while lo < total_bits and key_shift + lo < 32:
        digit = (w >> (key_shift + lo)) & ((1 << min(8, total_bits - lo)) - 1)
        w = _place(w, _warp_ranks(digit, tile, 256))
        lo += 8
    return _u32(w).reshape(n)


def _composite(keys: torch.Tensor, nt: int, tile: int) -> torch.Tensor:
    lb = tile.bit_length() - 1
    pos = torch.arange(tile, dtype=torch.int64, device=keys.device)
    return _shl(_u64(keys).reshape(nt, tile), lb) | pos


def _packed_out(c: torch.Tensor, *, n: int, tile: int, idx_bits: int,
                unpack: bool) -> torch.Tensor:
    """K7b's output of the (nt, tile) sorted composites: packed words
    (sentinel past n) or the int32 order (idx_mask past n), flat."""
    nt, lb = c.shape[0], tile.bit_length() - 1
    gidx = torch.arange(nt, dtype=torch.int64, device=c.device)[:, None] \
        * tile + (c & (tile - 1))
    real = gidx < n
    if unpack:
        out = _i32(torch.where(real, gidx, (1 << idx_bits) - 1))
    else:
        packed = _shl(_shr(c, lb), idx_bits) | gidx
        out = _u32(torch.where(real, packed, SENTINEL))
    return out.reshape(-1)


def radix_tile_sort_packed_plain(keys: torch.Tensor, *, n: int, tile: int,
                                 idx_bits: int, sort_bits: int,
                                 unpack: bool = False) -> torch.Tensor:
    """Twin of K7b: the composite ``key << log2(tile) | pos`` per tile,
    stably sorted by its ``sort_bits`` key bits, then emitted as packed
    words (sentinel past n) or the int32 order (idx_mask past n)."""
    nt, lb = keys.shape[0] // tile, tile.bit_length() - 1
    c = _composite(keys, nt, tile)
    c = _sort_rows(c, _shr(c, lb) & ((1 << min(sort_bits, 32)) - 1))
    return _packed_out(c, n=n, tile=tile, idx_bits=idx_bits, unpack=unpack)


def k7b_shape(tile: int, nt: int) -> Tuple[int, int]:
    """K7b v2's CTA for nt tiles: ``(keys a thread K, threads NT)``.  With
    at least one tile an SM (132), K7a's (:func:`k7a_threads`); below
    that, 256 threads from tile 256 up (``k7b_threads`` in
    csrc/radix_sort.cu).  K = max(1, tile // NT)."""
    threads = k7a_threads(tile) if nt >= NUM_SMS or tile < 256 else 256
    return max(1, tile // threads), threads


def k7b_digits(sort_bits: int, tile: int) -> Tuple[int, int]:
    """K7b v2's ``(digit width, passes)``: the key bits below bit 32 of the
    composite, ``bits = min(sort_bits, 32 - log2(tile))``, ranked in
    ``ceil(bits / 8)`` passes of one width, ``ceil(bits / passes)``
    rounded up to an even one, the last pass masked to what is left
    (``k7b_digits`` in csrc/radix_sort.cu)."""
    bits = min(sort_bits, 32 - (tile.bit_length() - 1))
    if bits <= 0:
        return 2, 0
    p = -(-bits // 8)
    width = (-(-bits // p) + 1) & ~1
    return width, -(-bits // width)


def packed_tile_sort_model(keys: torch.Tensor, *, n: int, tile: int,
                           idx_bits: int, sort_bits: int,
                           unpack: bool = False,
                           threads: Optional[int] = None) -> torch.Tensor:
    """K7b v2's decomposition in plain PyTorch, pass by pass: the composite
    ``key << lb | pos`` as the kernel packs it after its load, the
    :func:`k7b_digits` passes (the last masked), each word placed at its
    :func:`_warp_ranks` rank on the :func:`k7b_shape` CTA (``threads``
    forces another width, as the kernel's entry point takes it), then the
    output transform.  Equals :func:`radix_tile_sort_packed_plain`."""
    nt, lb = keys.shape[0] // tile, tile.bit_length() - 1
    threads = threads or k7b_shape(tile, nt)[1]
    width, passes = k7b_digits(sort_bits, tile)
    bits = min(sort_bits, 32 - lb)
    c = _composite(keys, nt, tile)
    for p in range(passes):
        lo = p * width
        digit = (c >> (lb + lo)) & ((1 << min(width, bits - lo)) - 1)
        c = _place(c, _warp_ranks(digit, tile, 1 << width, threads))
    return _packed_out(c, n=n, tile=tile, idx_bits=idx_bits, unpack=unpack)


def mt_local_plain(x: torch.Tensor, *, nt: int, tile: int, shift: int,
                   bits: int, pack: bool, idx_bits: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of K6a: each tile stably sorted by the ``bits``-wide digit at
    ``shift``, plus the (nt, 2^bits) int32 digit histogram; with ``pack``
    the input is raw keys, packed as ``key << idx_bits | global_index``."""
    radix = 1 << bits
    w = _u64(x).reshape(nt, tile)
    if pack:
        gidx = torch.arange(nt * tile, dtype=torch.int64,
                            device=x.device).reshape(nt, tile)
        w = _shl(w, idx_bits) | gidx
    digit = _shr(w, shift) & (radix - 1)
    hist = torch.zeros(nt, radix, dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, digit, torch.ones_like(digit))
    return _u32(_sort_rows(w, digit)), hist.to(torch.int32)


def mt_scatter_plain(local: torch.Tensor, hist: torch.Tensor,
                     base: torch.Tensor, *, tile: int,
                     unpack_mask: Optional[int] = None) -> torch.Tensor:
    """Twin of K6b: element j of tile t, in segment d (the last digit whose
    local start is <= j), goes to ``base[t, d] + j - lstart[t, d]``."""
    nt = local.shape[0]
    h = hist.to(torch.int64)
    lstart = torch.cumsum(h, 1) - h
    j = torch.arange(tile, dtype=torch.int64, device=local.device)
    d = torch.searchsorted(lstart, j.expand(nt, tile).contiguous(),
                           right=True) - 1
    dest = torch.gather(base.to(torch.int64), 1, d) + j - \
        torch.gather(lstart, 1, d)
    out = torch.zeros(nt * tile, dtype=torch.int64, device=local.device)
    out[dest.reshape(-1)] = _u64(local).reshape(-1)
    if unpack_mask is not None:
        return _i32(out & unpack_mask)
    return _u32(out)


def mt_local_model(x: torch.Tensor, *, nt: int, tile: int, shift: int,
                   bits: int, pack: bool, idx_bits: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a v2's decomposition in plain PyTorch: the words packed as the
    kernel packs them after its load, each placed at its
    :func:`_warp_ranks` rank by the pass digit, and ``hist`` the sums over
    the warps of the (digit, warp) counts.  Equals :func:`mt_local_plain`."""
    radix = 1 << bits
    w = _u64(x).reshape(nt, tile)
    if pack:
        w = _shl(w, idx_bits) | torch.arange(
            nt * tile, dtype=torch.int64, device=x.device).reshape(nt, tile)
    digit = _shr(w, shift) & (radix - 1)
    warps = k7a_threads(tile) // 32
    chunk = 32 * max(1, tile // k7a_threads(tile))
    warp = torch.arange(tile, device=x.device) // chunk
    counts = torch.zeros(nt, radix, warps, dtype=torch.int64, device=x.device)
    counts.view(nt, -1).scatter_add_(1, digit * warps + warp,
                                     torch.ones_like(digit))
    return (_u32(_place(w, _warp_ranks(digit, tile, radix))),
            counts.sum(2).to(torch.int32))


def k6b_shape(tile: int) -> Tuple[int, int]:
    """K6b v2's CTA for a tile: ``(words a thread W, threads NT)``, 256
    threads and ``W = ceil(tile / 256)`` rounded up to a power of two
    (``mt_scatter_v2_dispatch`` in csrc/radix_sort.cu)."""
    w = max(1, -(-tile // 256))
    return 1 << (w - 1).bit_length(), 256


def mt_scatter_model(local: torch.Tensor, hist: torch.Tensor,
                     base: torch.Tensor, *, tile: int,
                     unpack_mask: Optional[int] = None) -> torch.Tensor:
    """K6b v2 in plain PyTorch, thread by thread: with (W, NT) =
    :func:`k6b_shape`, lane l of warp w holds the words ``j0 + 32 k`` (k <
    W, ``j0 = 32 W w + l``); one search gives the segment of j0 (the last
    digit whose local start is <= j0), then the thread walks forward word
    by word; word j goes to ``base[t, d] + j - lstart[t, d]``.  Equals
    :func:`mt_scatter_plain`."""
    nt = hist.shape[0]
    dev = local.device
    h = hist.to(torch.int64)
    lstart = torch.cumsum(h, 1) - h
    past = torch.cat([lstart, torch.full((nt, 1), 1 << 62, device=dev,
                                         dtype=torch.int64)], 1)
    delta = base.to(torch.int64) - lstart
    W, NT = k6b_shape(tile)
    t = torch.arange(NT, device=dev)
    j0 = (32 * W * (t // 32) + t % 32).expand(nt, NT)
    d = torch.searchsorted(lstart, j0.contiguous(), right=True) - 1
    out = torch.zeros(nt * tile, dtype=torch.int64, device=dev)
    words = _u64(local)
    rows = torch.arange(nt, device=dev)[:, None].expand(nt, NT)
    for k in range(W):
        j = j0 + 32 * k
        live = j < tile
        while True:                                     # the forward walk
            adv = live & (torch.gather(past, 1, d + 1) <= j)
            if not bool(adv.any()):
                break
            d = d + adv.to(d.dtype)
        dest = torch.gather(delta, 1, d) + j
        out[dest[live]] = words[rows[live], j[live]]
    if unpack_mask is not None:
        return _i32(out & unpack_mask)
    return _u32(out)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} takes {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the input must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def radix_tile_sort(x: torch.Tensor, *, tile: int = 1024,
                    total_bits: int = 32, digit_bits: int = 4,
                    key_shift: int = 0, group: int = 8) -> torch.Tensor:
    """Sort each tile of a (n,) uint32 tensor by the ``total_bits`` bits at
    ``key_shift`` — stable, so tie order (bits outside the range) is
    preserved; one launch.  The reference runs ``ceil(total_bits /
    digit_bits)`` passes; the kernel runs ``ceil(total_bits / 8)`` 8-bit
    passes (none at bit 32 or above) whatever ``digit_bits`` is, which
    gives the same words, since a stable sort by the same bits has one
    result.  ``digit_bits`` is checked as the reference checks it."""
    n = x.shape[0]
    tile = min(tile, n)
    _check_tile(tile, digit_bits)
    if n % tile:
        raise ValueError(f"n={n} is not a multiple of the tile {tile}")
    passes = digit_passes(total_bits, digit_bits, key_shift=key_shift)
    if x.device.type == "cpu":
        return radix_tile_sort_plain(x, tile=tile, total_bits=total_bits,
                                     key_shift=key_shift)
    _check_cuda("radix_tile_sort", x, torch.uint32)
    out = torch.empty_like(x)
    K7A(x.data_ptr(), out.data_ptr(), n // tile, tile, key_shift,
        sum(p.bits for p in passes), digit_bits, _stream(x))
    return out


def radix_tile_sort_packed(keys: torch.Tensor, *, n: int, tile: int,
                           num_key_bits: int, idx_bits: int,
                           digit_bits: int = 4, group: int = 8,
                           unpack: bool = False,
                           passes: Optional[Sequence[DigitPass]] = None,
                           v1: bool = False,
                           threads: Optional[int] = None) -> torch.Tensor:
    """Fused pack + tile sort: raw int32 keys (padded to a multiple of
    ``tile``; pad rows must carry the max key) → per-tile-sorted packed
    uint32 words ``key << idx_bits | global_index``, pad slots as the
    sentinel; with ``unpack=True`` the int32 order.  ``passes`` takes the
    plan's ``sort_schedule`` digit passes (derived locally when absent);
    malformed schedules raise, as the reference's do.  Their key bits are
    what the kernel sorts by: it ranks them in the :func:`k7b_digits`
    passes, which give the same words, since a stable sort by the same
    bits has one result.  On the card ``threads`` forces the CTA width
    (default :func:`k7b_shape`'s) and ``v1=True`` launches the first
    design (``digit_bits``-wide passes on ``rank_pass``); the card check
    times both against v2."""
    n_pad = keys.shape[0]
    tile = min(tile, n_pad)
    if n_pad % tile:
        raise ValueError(f"n_pad={n_pad} is not a multiple of the tile {tile}")
    lb = tile.bit_length() - 1
    if passes is None:
        passes = digit_passes(num_key_bits, digit_bits, key_shift=lb)
    passes = tuple(passes)
    _check_tile(tile, passes[0].bits if passes else digit_bits)
    if passes and passes[0].shift != lb:
        # layout invariant, not arithmetic: the composite places the key
        # at bit log2(tile), so the schedule's key_shift must agree
        raise ValueError(f"schedule key_shift {passes[0].shift} != "
                         f"log2(tile) = {lb}")
    # the kernel strides uniformly by passes[0].bits (only the final pass
    # may narrow) — reject any other shape instead of silently mis-sorting
    for i, p in enumerate(passes):
        if p.shift != passes[0].shift + i * passes[0].bits or \
                (p.bits != passes[0].bits and i != len(passes) - 1) or \
                p.bits > passes[0].bits:
            raise ValueError(
                f"passes must be contiguous with uniform stride (last may "
                f"narrow), got {passes}")
    stride = passes[0].bits if passes else digit_bits
    sort_bits = sum(p.bits for p in passes)
    if keys.device.type == "cpu":
        return radix_tile_sort_packed_plain(
            keys, n=n, tile=tile, idx_bits=idx_bits, sort_bits=sort_bits,
            unpack=unpack)
    _check_cuda("radix_tile_sort_packed", keys, torch.int32)
    out = torch.empty(n_pad, dtype=torch.int32 if unpack else torch.uint32,
                      device=keys.device)
    K7B(keys.data_ptr(), out.data_ptr(), n_pad // tile, tile, n, idx_bits,
        sort_bits, stride, int(unpack), int(not v1), threads or 0,
        _stream(keys))
    return out


def _mt_local(x: torch.Tensor, *, nt: int, tile: int, shift: int, bits: int,
              pack: bool, idx_bits: int, group: int = 8
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6a: one digit pass, tile-local half → ((nt, tile) uint32 words,
    (nt, 2^bits) int32 histogram).  ``x`` is (nt·tile,) raw int32 keys with
    ``pack`` (pass 0), else uint32 words."""
    if x.numel() != nt * tile:
        raise ValueError(f"_mt_local: {x.numel()} elements != {nt} x {tile}")
    if x.device.type == "cpu":
        return mt_local_plain(x, nt=nt, tile=tile, shift=shift, bits=bits,
                              pack=pack, idx_bits=idx_bits)
    _check_tile(tile, bits)
    _check_cuda("_mt_local", x, torch.int32 if pack else torch.uint32)
    local = torch.empty(nt, tile, dtype=torch.uint32, device=x.device)
    hist = torch.empty(nt, 1 << bits, dtype=torch.int32, device=x.device)
    K6A(x.data_ptr(), local.data_ptr(), hist.data_ptr(), nt, tile, shift,
        bits, int(pack), idx_bits, _stream(x))
    return local, hist


def _mt_scatter(local: torch.Tensor, hist: torch.Tensor, base: torch.Tensor,
                *, tile: int, radix: int, group: int = 8,
                unpack_mask: Optional[int] = None) -> torch.Tensor:
    """K6b: one digit pass, global half → the (nt·tile,) words in global
    digit order (uint32), or with ``unpack_mask`` (last pass) ``word &
    unpack_mask`` as int32."""
    nt = local.shape[0]
    if tuple(local.shape) != (nt, tile) or \
            tuple(hist.shape) != (nt, radix) or base.shape != hist.shape:
        raise ValueError(f"_mt_scatter: shapes {tuple(local.shape)}, "
                         f"{tuple(hist.shape)}, {tuple(base.shape)} are not "
                         f"({nt}, {tile}), ({nt}, {radix}) x2")
    if local.device.type == "cpu":
        return mt_scatter_plain(local, hist, base, tile=tile,
                                unpack_mask=unpack_mask)
    _check_cuda("_mt_scatter", local, torch.uint32)
    _check_cuda("_mt_scatter", hist, torch.int32)
    _check_cuda("_mt_scatter", base, torch.int32)
    out = torch.empty(nt * tile, dtype=torch.uint32 if unpack_mask is None
                      else torch.int32, device=local.device)
    K6B(local.data_ptr(), hist.data_ptr(), base.data_ptr(), out.data_ptr(),
        nt, tile, radix, 0 if unpack_mask is None else unpack_mask & M32,
        int(unpack_mask is not None), _stream(local))
    return out


def multi_tile_argsort_packed(keys: torch.Tensor, *, n: int, tile: int,
                              num_key_bits: int, idx_bits: int,
                              digit_bits: int = 4, group: int = 8,
                              scan_block: int = 256,
                              passes: Optional[Sequence[DigitPass]] = None
                              ) -> torch.Tensor:
    """Global stable argsort via multi-tile LSD radix — no merge tree.

    keys: raw int32, padded to a multiple of ``tile`` with the max key (pad
    slots sort to the global tail).  Returns the full padded int32 order;
    callers slice ``[:n]``.  Launches: ``3 · num_passes`` (local + carry
    scan + scatter per digit pass), independent of ``n``; a single-tile
    input degenerates to the fused one-launch tile sort.  ``passes`` takes
    the plan's ``sort_schedule(mode="multi_tile")`` digit passes
    (``key_shift`` must equal ``idx_bits``)."""
    n_pad = keys.shape[0]
    tile = min(tile, n_pad)
    if n_pad % tile:
        raise ValueError(f"n_pad={n_pad} is not a multiple of the tile {tile}")
    nt = n_pad // tile
    if nt == 1:
        return radix_tile_sort_packed(
            keys, n=n, tile=tile, num_key_bits=num_key_bits,
            idx_bits=idx_bits, digit_bits=digit_bits, group=group,
            unpack=True)
    if passes is None:
        passes = digit_passes(num_key_bits, digit_bits, key_shift=idx_bits)
    passes = tuple(passes)
    if not passes:
        raise ValueError("multi-tile argsort needs at least one digit pass")
    if passes[0].shift != idx_bits:
        raise ValueError(f"schedule key_shift {passes[0].shift} != "
                         f"idx_bits = {idx_bits}")
    _check_tile(tile, max(p.bits for p in passes))
    idx_mask = (1 << idx_bits) - 1
    x = keys
    for i, p in enumerate(passes):
        local, hist = _mt_local(
            x, nt=nt, tile=tile, shift=p.shift, bits=p.bits, pack=(i == 0),
            idx_bits=idx_bits, group=group)
        base = histogram_offsets(hist, block=scan_block)
        x = _mt_scatter(
            local, hist, base, tile=tile, radix=1 << p.bits, group=group,
            unpack_mask=idx_mask if i == len(passes) - 1 else None)
    return x


# ---------------------------------------------------------------------------
# K3: the MoE dispatch
# ---------------------------------------------------------------------------

def moe_dispatch_sort_plain(x: torch.Tensor, experts: torch.Tensor,
                            probs: torch.Tensor, *, num_experts: int
                            ) -> Tuple[torch.Tensor, ...]:
    """Twin of K3: ``torch.argsort(stable=True)`` of the flat expert ids,
    then gathers.  Returns ``(xd, sorted_e, sorted_tok, sorted_p, counts)``
    as :func:`moe_dispatch_sort`."""
    T, D = x.shape
    K = experts.shape[-1]
    flat_e = experts.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    sorted_tok = torch.div(order, K, rounding_mode="floor")
    # integer adds are exact in any order; no host sync (bincount has one)
    counts = torch.zeros(num_experts, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, flat_e.long(), torch.ones_like(flat_e,
                                                          dtype=torch.int32))
    return (x[sorted_tok], flat_e[order].to(torch.int32),
            sorted_tok.to(torch.int32), probs.reshape(T * K)[order], counts)


def k3_grid(n: int, row_bytes: int, vec: int,
            sm_count: int = NUM_SMS) -> Tuple[int, int]:
    """K3's one-tile launch, as ``csrc/moe_dispatch.cu::onetile_grid``
    sizes it: ``(copying CTAs, words a thread)`` for n assignment rows of
    ``row_bytes`` bytes copied in ``vec``-byte words.  The words a thread
    fill about two CTAs an SM, at most :data:`K3_MAX_PER`; one more CTA
    writes the counts."""
    total = n * (row_bytes // vec)
    want = 2 * sm_count * K3_THREADS
    per = min(K3_MAX_PER, max(1, -(-total // want)))
    return -(-total // (K3_THREADS * per)), per


def k3_cta_words(cta: int, n: int, nv: int, per: int) -> torch.Tensor:
    """The flat word indices (row · nv + word) that copying CTA ``cta`` of
    K3's one-tile launch moves, in load order: thread t takes the words
    ``cta · 128 · per + t + 128 u``, u < per, below n · nv."""
    v = (cta * K3_THREADS * per + torch.arange(K3_THREADS)[None]
         + K3_THREADS * torch.arange(per)[:, None]).reshape(-1)
    return v[v < n * nv]


def moe_dispatch_model(x: torch.Tensor, experts: torch.Tensor,
                       probs: torch.Tensor, *, num_experts: int,
                       sm_count: int = NUM_SMS) -> Tuple[torch.Tensor, ...]:
    """K3's one-tile kernel (rank by counting) in plain PyTorch, CTA by
    CTA: each copying CTA of :func:`k3_grid` ranks every row its words
    touch as ``#{i : e_i < e_j} + #{i < j : e_i == e_j}`` (ids masked to
    the digit, as the kernel ranks them), copies its words of x's row
    ``j // K`` to xd's row rank(j), and writes sorted_e, sorted_tok and
    sorted_p for the rows whose word 0 it holds; the last CTA counts the
    ids.  Returns what :func:`moe_dispatch_sort` returns."""
    T, D = x.shape
    K = experts.shape[-1]
    n = T * K
    bits = max(1, math.ceil(math.log2(num_experts + 1)))
    ids = experts.reshape(n).to(torch.int64) & ((1 << bits) - 1)
    row_bytes = D * x.element_size()
    vec = next(v for v in (16, 4, 2) if row_bytes % v == 0)
    nv = row_bytes // vec
    src = x.contiguous().view(torch.uint8).reshape(T, nv, vec)
    out = torch.zeros(n, nv, vec, dtype=torch.uint8)
    sorted_e = torch.zeros(n, dtype=torch.int32)
    sorted_tok = torch.zeros(n, dtype=torch.int32)
    sorted_p = torch.zeros(n, dtype=probs.dtype)
    flat_e, flat_p = experts.reshape(n), probs.reshape(n)
    pos = torch.arange(n)
    ctas, per = k3_grid(n, row_bytes, vec, sm_count)
    for cta in range(ctas):
        words = k3_cta_words(cta, n, nv, per)
        v0 = cta * K3_THREADS * per
        rows = torch.arange(int(words[0]) // nv, int(words[-1]) // nv + 1)
        ej = ids[rows, None]
        dest = ((ids[None] < ej) | ((ids[None] == ej)
                                    & (pos[None] < rows[:, None]))).sum(1)
        j, c = words // nv, words % nv
        out[dest[j - rows[0]], c] = src[j // K, c]
        own = rows * nv >= v0
        sorted_e[dest[own]] = flat_e[rows[own]].to(torch.int32)
        sorted_tok[dest[own]] = (rows[own] // K).to(torch.int32)
        sorted_p[dest[own]] = flat_p[rows[own]]
    counts = torch.bincount(ids[ids < num_experts],
                            minlength=num_experts).to(torch.int32)
    xd = out.reshape(n, row_bytes).view(x.dtype).reshape(n, D)
    return xd, sorted_e, sorted_tok, sorted_p, counts


def moe_dispatch_sort(x: torch.Tensor, experts: torch.Tensor,
                      probs: torch.Tensor, *, num_experts: int,
                      tile: int = 512, counting: bool = True
                      ) -> Tuple[torch.Tensor, ...]:
    """MoE routing in one kernel entry (K3): the stable sort of the (T·K,)
    expert assignments, with the activation rows carried along.

    x: (T, D) activations; experts/probs: (T, K) from ``route_topk``
    (expert ids in [0, num_experts)).  Returns ``(xd (T·K, D), sorted_e,
    sorted_tok, sorted_p, counts)``: the reference's four outputs,
    bit-identical to the argsort + gather path (rows are copied in their
    own dtype), and the (E,) int32 count of every expert, which bounds the
    grouped expert matmuls.  Requires ``num_experts <= 256`` (one digit of
    ``ceil(log2(E + 1))`` bits, as the reference's).  On the card one tile
    (T·K <= tile: every decode step and prefill chunk) is one launch that
    ranks by counting (:func:`moe_dispatch_model`), more tiles a histogram
    launch then the scatter (``csrc/moe_dispatch.cu``).  ``counting=False``
    sends one tile through the scatter kernel instead (PR 15's design, which
    the card check times in turns); the outputs are the same."""
    T, D = x.shape
    K = experts.shape[-1]
    E = num_experts
    if E > _MAX_DISPATCH_EXPERTS:
        raise ValueError(f"one-launch dispatch needs num_experts ≤ 256, "
                         f"got {E} (fall back to argsort + gather)")
    n = T * K
    bits = max(1, math.ceil(math.log2(E + 1)))
    tile = min(tile, 1 << max(1, math.ceil(math.log2(max(2, n)))))
    if x.device.type == "cpu":
        return moe_dispatch_sort_plain(x, experts, probs, num_experts=E)
    if not x.is_cuda or x.dim() != 2 or x.dtype not in _ROW_DTYPES or \
            not x.is_contiguous():
        raise TypeError(f"moe_dispatch_sort takes contiguous (T, D) CUDA "
                        f"rows of {_ROW_DTYPES}, got {x.dtype} "
                        f"{tuple(x.shape)} on {x.device}")
    _check_cuda("moe_dispatch_sort experts", experts, torch.int32)
    if probs.dtype not in _ROW_DTYPES or not probs.is_cuda or \
            not probs.is_contiguous():
        raise TypeError(f"moe_dispatch_sort: probs must be contiguous CUDA "
                        f"floats, got {probs.dtype} on {probs.device}")
    if tuple(experts.shape) != (T, K) or tuple(probs.shape) != (T, K):
        raise ValueError(f"moe_dispatch_sort: experts {tuple(experts.shape)}"
                         f" and probs {tuple(probs.shape)} are not ({T}, K)")
    if tile & (tile - 1) or tile > _MAX_DISPATCH_TILE:
        raise ValueError(f"moe_dispatch_sort tile must be a power of two "
                         f"<= {_MAX_DISPATCH_TILE}, got {tile}")
    dev = x.device
    xd = torch.empty(n, D, dtype=x.dtype, device=dev)
    sorted_e = torch.empty(n, dtype=torch.int32, device=dev)
    sorted_tok = torch.empty(n, dtype=torch.int32, device=dev)
    sorted_p = torch.empty(n, dtype=probs.dtype, device=dev)
    if n == 0 or D == 0:
        return (xd, sorted_e, sorted_tok, sorted_p,
                torch.zeros(E, dtype=torch.int32, device=dev))
    counts = torch.empty(E, dtype=torch.int32, device=dev)  # all E written
    nt = -(-n // tile)
    hist = torch.empty(nt << bits if nt > 1 else 0, dtype=torch.int32,
                       device=dev)
    row_bytes = D * x.element_size()
    vec = next(v for v in (16, 4, 2)
               if row_bytes % v == 0 and x.data_ptr() % v == 0)
    K3(x.data_ptr(), experts.data_ptr(), probs.data_ptr(),
       hist.data_ptr() if nt > 1 else None, xd.data_ptr(),
       sorted_e.data_ptr(), sorted_tok.data_ptr(), sorted_p.data_ptr(),
       counts.data_ptr(), T, K, E, tile, bits, row_bytes, vec,
       probs.element_size(), int(counting), _stream(x))
    return xd, sorted_e, sorted_tok, sorted_p, counts


def moe_dispatch_attributes(n: int, row_bytes: int,
                            vec: int = 16) -> Dict[str, Dict[str, int]]:
    """Registers, spills, shared memory and CTAs an SM of K3's kernels, as
    the compiled library and the occupancy calculator report them, with
    the one-tile launch's grid for n rows of ``row_bytes`` bytes (copying
    CTAs and words a thread, which :func:`k3_grid` mirrors)."""
    return {name: _build.attributes("moe_dispatch", "moe_dispatch_attrs",
                                    which, n, row_bytes, vec,
                                    extra=("copy_ctas", "words_per_thread"))
            for which, name in enumerate(("moe_onetile_kernel<uint4>",
                                          "moe_scatter_kernel (tile 512)",
                                          "moe_hist_kernel"))}


def mt_local_attributes(tile: int, bits: int) -> Dict[str, int]:
    """Registers, spills, shared memory, CTAs an SM and threads a CTA of
    K6a's kernel instance for ``tile`` and ``bits``, as the compiled
    library and the occupancy calculator report them."""
    return _build.attributes("radix_sort", "radix_mt_local_attrs", tile,
                             bits, extra=("threads",))


def mt_scatter_attributes(tile: int, radix: int) -> Dict[str, int]:
    """The same for K6b at ``tile`` (one CTA a tile)."""
    return _build.attributes("radix_sort", "radix_mt_scatter_attrs", tile,
                             radix, extra=("threads",))


def radix_tile_sort_packed_attributes(tile: int, nt: int, sort_bits: int,
                                      threads: Optional[int] = None
                                      ) -> Dict[str, int]:
    """The same for K7b v2's instance for nt tiles of ``tile`` and
    ``sort_bits`` key bits (``threads`` a CTA, default the rule), with its
    digit width and passes (:func:`k7b_shape`, :func:`k7b_digits`)."""
    return _build.attributes("radix_sort", "radix_tile_sort_packed_attrs",
                             tile, nt, sort_bits, threads or 0,
                             extra=("threads", "digit_bits", "passes"))


def kernel_attributes(tile: int) -> Dict[str, int]:
    """Registers, spills, shared memory, CTAs an SM and threads a CTA of
    K7a's kernel instance for ``tile`` (one a keys-per-thread count and CTA
    size), as the compiled library and the occupancy calculator report
    them."""
    return _build.attributes("radix_sort", "radix_tile_sort_attrs", tile,
                             extra=("threads",))


__all__ = ["radix_tile_sort", "radix_tile_sort_packed",
           "multi_tile_argsort_packed", "radix_tile_sort_plain",
           "radix_tile_sort_model", "k7a_threads", "kernel_attributes",
           "radix_tile_sort_packed_plain", "packed_tile_sort_model",
           "k7b_shape", "k7b_digits", "radix_tile_sort_packed_attributes",
           "mt_local_plain", "mt_scatter_plain", "mt_local_model",
           "mt_scatter_model", "k6b_shape", "mt_local_attributes",
           "mt_scatter_attributes", "moe_dispatch_sort",
           "moe_dispatch_sort_plain",
           "moe_dispatch_model", "moe_dispatch_attributes", "k3_grid",
           "k3_cta_words", "SENTINEL", "K3", "K6A", "K6B", "K7A", "K7B"]
