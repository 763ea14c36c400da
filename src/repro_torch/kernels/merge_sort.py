"""The paper's stable sort (§3.7) — the counterpart of
``repro.kernels.merge_sort``: ``argsort`` under both global strategies,
``sort_u32``, ``merge_pair``, with K8 (one merge level, ``_merge_level``)
as a hand-written Hopper kernel (``csrc/merge_sort.cu``) beside its plain
PyTorch twin.

Structure, as in the reference:

  1. a Kvik plan (``even_levels(bound_depth(...))``) divides the input into
     tiles; its :meth:`~repro_torch.core.plan.Plan.sort_schedule` carries
     the radix digit passes of the tile phase and the merge levels;
  2. each tile is sorted by the in-kernel LSD radix sort
     (``radix_sort.py``, K7);
  3. sorted runs are merged pairwise, one launch per merge level (K8), the
     co-rank search inside the kernel.  K8 v2 cuts each level into blocks
     of its own (:func:`k8_block`), finds a block's co-ranks by a 32-ary
     search, a warp a diagonal (:func:`kary_coranks`) and merges W words a thread in
     registers; :func:`merge_level_model` is that partition in plain
     PyTorch.

``strategy="multi_tile"`` (the default for keys of at most 16 bits)
replaces 2–3 by global digit passes (K6a, K5, K6b) whose launch count is
independent of n.

Stability: keys are packed as ``key << idx_bits | index`` into uint32, so
equal keys order by original index; ``idx_bits = ceil(log2(n))`` is
derived per call.  The pack and the final ``& idx_mask`` unpack live
inside the first and last kernels.  The reference's comparison pipelines —
``method="bitonic"`` (K9a ``tile_sort``, a bitonic network) and
``fused=False`` (K9b/K9c ``_pack``/``_unpack``, standalone launches) —
are hand-written kernels too (``csrc/merge_sort.cu``), kept as the
baseline beside radix.  Entry points run on the device of the keys: a CUDA
tensor launches the kernels or raises, a CPU tensor runs the twins.
``group`` is kept for the reference's signature and changes no result; the
JAX-only ``interpret`` and ``jit`` are gone.

Unlike the reference, ``argsort`` checks both ends of the key range (one
``torch.aminmax``, one host sync): a negative key raises ``ValueError``
where the reference returns a non-permutation.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch

from ..core import SeqWork, bound_depth, build_plan, even_levels
from . import _build
from .radix_sort import (SENTINEL, NUM_SMS,  # noqa: F401 — SENTINEL
                         _u32, _u64, _i32, _check_cuda, _stream,
                         multi_tile_argsort_packed,   # re-export
                         radix_tile_sort, radix_tile_sort_packed)

IDX_BITS = 20                 # documented default cap: tiles up to 2^20
IDX_MASK = (1 << IDX_BITS) - 1
MAX_BLOCK = 4096              # K8 v1's output block (shared memory: 2 x 16 KB)
K8_THREADS = 256              # K8 v2: threads a CTA
K8_PROBES = 32                # K8 v2: probes a search round (a warp)
K8_MAX_WORDS = 16             # K8 v2: words a thread merges, at most

MAX_BITONIC_TILE = 1 << 13   # K9a's largest tile (16 words x 512 threads)

K8 = _build.KERNELS["merge_level"]
K9A = _build.KERNELS["bitonic_tile_sort"]
K9B = _build.KERNELS["pack_keys"]
K9C = _build.KERNELS["unpack_order"]


# ---------------------------------------------------------------------------
# K9: the comparison pipeline's building blocks
# ---------------------------------------------------------------------------

def tile_sort_plain(x: torch.Tensor, *, tile: int) -> torch.Tensor:
    """Twin of K9a: each tile sorted ascending."""
    n = x.shape[0]
    return _u32(torch.sort(_u64(x).reshape(n // tile, tile), dim=1).values
                ).reshape(n)


def k9a_shape(tile: int) -> Tuple[int, int]:
    """K9a's (W, NT) for a tile: W words a thread, NT threads a CTA, a
    block of W·NT words (csrc/merge_sort.cu ``bitonic_dispatch``).  32·W >=
    NT, so every stage with j >= 32·W is a multiple of NT."""
    if tile <= 1024:
        return 8, 128
    return {2048: (8, 256), 4096: (16, 256)}.get(tile, (16, 512))


def tile_sort_model(x: torch.Tensor, *, tile: int) -> torch.Tensor:
    """K9a's stage schedule in plain PyTorch, stage by stage: the block of
    W·NT words held W consecutive words a thread (word t·W + e); stages
    with j < W exchange slots e, e ^ j of one thread, W <= j < 32·W lanes
    t, t ^ (j / W) of one warp, and j >= 32·W slots e, e ^ (j / NT) of
    one thread in the strided layout (word t + NT·e) the block takes
    through shared memory.  Pair (i, i ^ j): the lower index keeps the min
    where the block is ascending (i & k == 0, or k the whole tile).  Pad
    words past n are the sentinel.  Equals :func:`tile_sort_plain`."""
    n = x.shape[0]
    W, NT = k9a_shape(tile)
    block = W * NT
    nb = -(-n // block)
    w = torch.full((nb * block,), SENTINEL, dtype=torch.int64,
                   device=x.device)
    w[:n] = _u64(x)
    dev = x.device
    t = torch.arange(NT, device=dev)[:, None]
    e = torch.arange(W, device=dev)[None, :]

    def exchange(v, partner, lower, i, k):
        up = (i & k) == 0 if k < tile else torch.ones_like(lower)
        return torch.where(lower == up, torch.minimum(v, partner),
                           torch.maximum(v, partner))

    v = w.reshape(nb, NT, W)                          # blocked: t·W + e
    k = 2
    while k <= tile:
        if k > 32 * W:                                # via shared memory
            s = v.reshape(nb, W, NT).transpose(1, 2)  # strided: t + NT·e
            jj = W // 2
            while jj >= 1:
                if 32 * W <= jj * NT < k:
                    s = exchange(s, s[:, :, e[0] ^ jj], (e & jj) == 0,
                                 t + NT * e, k)
                jj //= 2
            v = s.transpose(1, 2).reshape(nb, NT, W)
        j = min(k // 2, 16 * W)
        while j >= W:                                 # warp shuffles
            d = j // W
            v = exchange(v, v[:, t[:, 0] ^ d, :], (t % 32 & d) == 0,
                         t * W + e, k)
            j //= 2
        j = W // 2
        while j >= 1:                                 # inside a thread
            if j < k:
                v = exchange(v, v[:, :, e[0] ^ j], (e & j) == 0, t * W + e,
                             k)
            j //= 2
        k *= 2
    return _u32(v.reshape(-1)[:n])


def tile_sort(x: torch.Tensor, *, tile: int = 1024) -> torch.Tensor:
    """Sort each tile of a (n,) uint32 tensor locally with the bitonic
    network (K9a, the radix baseline).  n % tile == 0."""
    n = x.shape[0]
    tile = min(tile, n)
    if n % tile or tile & (tile - 1):
        raise ValueError(f"tile_sort needs a power-of-two tile dividing n, "
                         f"got n={n}, tile={tile}")
    if x.device.type == "cpu":
        return tile_sort_plain(x, tile=tile)
    _check_cuda("tile_sort", x, torch.uint32)
    if tile > MAX_BITONIC_TILE:
        raise ValueError(f"tile_sort on the card holds a tile in registers "
                         f"and shared memory: tile <= {MAX_BITONIC_TILE}, "
                         f"got {tile}")
    out = torch.empty_like(x)
    K9A(x.data_ptr(), out.data_ptr(), n, tile, _stream(x))
    return out


def kernel_attributes(tile: int) -> Dict[str, int]:
    """Registers, spills, shared memory, CTAs an SM and threads a CTA of
    K9a's kernel instance for ``tile``, as the compiled library and the
    occupancy calculator report them."""
    return _build.attributes("merge_sort", "bitonic_tile_sort_attrs", tile,
                             extra=("threads",))


def merge_level_attributes(block: int) -> Dict[str, int]:
    """The same for K8 v2's kernel instance for an output ``block``."""
    return _build.attributes("merge_sort", "merge_level_attrs", block,
                             extra=("threads",))


def pack_plain(keys: torch.Tensor, *, n: int, idx_bits: int) -> torch.Tensor:
    """Twin of K9b: ``key << idx_bits | index``, pad slots (index ≥ n) to
    the sentinel."""
    idx = torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device)
    packed = ((_u64(keys) << idx_bits) & 0xFFFFFFFF) | idx
    return _u32(torch.where(idx < n, packed, SENTINEL))


def _pack(keys: torch.Tensor, *, n: int, idx_bits: int) -> torch.Tensor:
    """K9b: the standalone pack launch of the ``fused=False`` pipeline;
    int32 keys in, uint32 words out."""
    if keys.device.type == "cpu":
        return pack_plain(keys, n=n, idx_bits=idx_bits)
    _check_cuda("_pack", keys, torch.int32)
    out = torch.empty(keys.shape[0], dtype=torch.uint32, device=keys.device)
    if keys.numel():
        K9B(keys.data_ptr(), out.data_ptr(), keys.numel(), n, idx_bits,
            _stream(keys))
    return out


def unpack_plain(x: torch.Tensor, *, idx_mask: int) -> torch.Tensor:
    """Twin of K9c: ``x & idx_mask`` as int32."""
    return _i32(_u64(x) & idx_mask)


def _unpack(x: torch.Tensor, *, idx_mask: int) -> torch.Tensor:
    """K9c: the standalone unpack launch of the ``fused=False`` pipeline."""
    if x.device.type == "cpu":
        return unpack_plain(x, idx_mask=idx_mask)
    _check_cuda("_unpack", x, torch.uint32)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    if x.numel():
        K9C(x.data_ptr(), out.data_ptr(), x.numel(), idx_mask & 0xFFFFFFFF,
            _stream(x))
    return out


# ---------------------------------------------------------------------------
# K8: one merge level
# ---------------------------------------------------------------------------

def _merge_path_starts(ab: torch.Tensor, run: int, tile: int):
    """Co-rank split of every output diagonal of every run pair.

    ab: (num_pairs, 2, run) sorted runs.  For each pair and each diagonal
    ``d = b*tile`` (b = 0..2·run/tile), binary-search the smallest ``ia``
    with ``A[ia] > B[d-1-ia]`` — the count of A elements among the first
    ``d`` elements of the stable merge (ties go to A).  Returns
    ``(a_start, b_start, la)``, each (num_pairs, blocks_per_pair) int32.
    K8 runs the same search inside each CTA and nothing on the path calls
    this host-side form; the tests hold it to the reference's.
    """
    num_pairs = ab.shape[0]
    nb = (2 * run) // tile
    w = _u64(ab)
    a_run, b_run = w[:, 0, :], w[:, 1, :]
    d = torch.arange(nb + 1, dtype=torch.int64, device=ab.device) * tile
    lo = torch.clamp(d - run, min=0).expand(num_pairs, nb + 1).clone()
    hi = torch.clamp(d, max=run).expand(num_pairs, nb + 1).clone()
    for _ in range(max(1, run).bit_length() + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        a_mid = torch.gather(a_run, 1, mid.clamp(0, run - 1))
        b_val = torch.gather(b_run, 1, (d[None, :] - 1 - mid).clamp(
            0, run - 1))
        go_right = a_mid <= b_val          # A[mid] within the first d merged
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    a_start = lo[:, :-1]
    la = lo[:, 1:] - lo[:, :-1]
    b_start = d[None, :-1] - a_start
    return (a_start.to(torch.int32), b_start.to(torch.int32),
            la.to(torch.int32))


def k8_block(n: int, run: int) -> int:
    """K8 v2's output block (words a CTA) for a level of ``n`` words in
    sorted runs of ``run``: :data:`K8_THREADS` × W words, W the largest
    power of two up to :data:`K8_MAX_WORDS` that leaves at least two CTAs
    an SM (W = 1 below that), and never more than the pair, 2·run.  2^20
    words: 2048 (8 words a thread, 512 CTAs); 8192 words: 256 (32
    CTAs)."""
    w = K8_MAX_WORDS
    while w > 1 and n // (K8_THREADS * w) < 2 * NUM_SMS:
        w //= 2
    return min(K8_THREADS * w, 2 * run)


def kary_coranks(ab: torch.Tensor, run: int, block: int, *,
                 probes: int = K8_PROBES):
    """K8 v2's co-rank search, round by round: the answer of each block
    diagonal ``d = b·block`` lies in [lo, hi] (lo = max(0, d − run), hi =
    min(d, run)); each round probes p = lo + j·step (j < probes, step =
    ceil((hi − lo) / probes), p < hi), counts the probes with A[p] <=
    B[d−1−p] (ties to A: all of them lie before the answer) and narrows
    [lo, hi] to the gap after the last true probe.  ab: (num_pairs, 2,
    run) sorted runs.  Returns ``(a_start, b_start, la, rounds)``: the
    first three as :func:`_merge_path_starts` gives them for tile =
    ``block``, and the rounds the search took (ceil(log_{probes+1}(run
    + 1)) at most; 0 when the block is the pair)."""
    num_pairs = ab.shape[0]
    nb = (2 * run) // block
    w = _u64(ab)
    a_run, b_run = w[:, 0, :], w[:, 1, :]
    d = torch.arange(nb + 1, dtype=torch.int64, device=ab.device) * block
    lo = torch.clamp(d - run, min=0).expand(num_pairs, nb + 1).clone()
    hi = torch.clamp(d, max=run).expand(num_pairs, nb + 1).clone()
    j = torch.arange(probes, dtype=torch.int64, device=ab.device)
    rounds = 0
    while bool((lo < hi).any()):
        L = hi - lo
        step = torch.clamp(-(-L // probes), min=1)
        p = lo[..., None] + j * step[..., None]        # (pairs, nb+1, P)
        valid = p < hi[..., None]
        pa = torch.gather(a_run, 1, p.clamp(0, run - 1).reshape(
            num_pairs, -1)).reshape(p.shape)
        pb = torch.gather(b_run, 1, (d[None, :, None] - 1 - p).clamp(
            0, run - 1).reshape(num_pairs, -1)).reshape(p.shape)
        c = (valid & (pa <= pb)).sum(-1)
        np_ = -(-L // step)
        live = L > 0
        lo, hi = (torch.where(live & (c > 0), lo + (c - 1) * step + 1, lo),
                  torch.where(live & (c < np_), lo + c * step, hi))
        rounds += 1
    a_start = lo[:, :-1]
    return (a_start.to(torch.int32), (d[None, :-1] - a_start).to(torch.int32),
            (lo[:, 1:] - a_start).to(torch.int32), rounds)


def _windows_corank(A, a0, la, B, b0, lb, dd, steps: int):
    """Binary search of each thread's sub-diagonal ``dd`` in its CTA's
    windows A[a0, a0+la) and B[b0, b0+lb) (ties to A), vectorized: all
    index tensors broadcast to (pairs, nb, threads)."""
    lo = torch.clamp(dd - lb, min=0)
    hi = torch.minimum(dd, la)
    run = A.shape[-1]
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) // 2
        am = _gather_runs(A, (a0 + mid).clamp(0, run - 1))
        bm = _gather_runs(B, (b0 + dd - 1 - mid).clamp(0, run - 1))
        right = am <= bm
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def _gather_runs(runs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """runs: (pairs, run); idx: (pairs, ...) → runs[pair, idx]."""
    flat = idx.reshape(idx.shape[0], -1)
    return torch.gather(runs, 1, flat).reshape(idx.shape)


def merge_level_model(x: torch.Tensor, *, run: int,
                      block: Optional[int] = None,
                      unpack_mask: Optional[int] = None) -> torch.Tensor:
    """K8 v2's partition in plain PyTorch, step by step: blocks of
    ``block`` words (default :func:`k8_block`), their co-ranks by the
    k-ary search (:func:`kary_coranks`), each of the CTA's
    :data:`K8_THREADS` threads its sub-diagonal t·per (per =
    ceil(block / K8_THREADS)) by binary search in the windows, then its
    per words merged in order, ties to A.  Equals
    :func:`merge_level_plain`."""
    n = x.shape[0]
    block = k8_block(n, run) if block is None else block
    if n % (2 * run) or (2 * run) % block:
        raise ValueError(f"merge_level_model: n={n}, run={run}, "
                         f"block={block}")
    pairs, nb = n // (2 * run), (2 * run) // block
    ab = x.reshape(pairs, 2, run)
    w = _u64(ab)
    A, B = w[:, 0, :].contiguous(), w[:, 1, :].contiguous()
    a0, b0, la, _ = kary_coranks(ab, run, block)
    a0, b0, la = (v.to(torch.int64)[..., None] for v in (a0, b0, la))
    lb = block - la
    per = -(-block // K8_THREADS)
    t = torch.arange(K8_THREADS, dtype=torch.int64, device=x.device)
    dd = torch.clamp(t * per, max=block).expand(pairs, nb, -1)
    de = torch.clamp(dd + per, max=block)
    ia = _windows_corank(A, a0, la, B, b0, lb, dd, block.bit_length() + 1)
    ib = dd - ia
    out = torch.zeros(pairs, 2 * run + 1, dtype=torch.int64, device=x.device)
    first = torch.arange(nb, device=x.device)[None, :, None] * block
    for e in range(per):
        act = dd + e < de
        av = _gather_runs(A, (a0 + ia).clamp(0, run - 1))
        bv = _gather_runs(B, (b0 + ib).clamp(0, run - 1))
        take_a = (ia < la) & ((ib >= lb) | (av <= bv))
        dest = torch.where(act, first + dd + e, 2 * run)   # idle: a spare
        out.scatter_(1, dest.reshape(pairs, -1),
                     torch.where(take_a, av, bv).reshape(pairs, -1))
        ia = ia + (act & take_a)
        ib = ib + (act & ~take_a)
    out = out[:, :2 * run].reshape(n)
    if unpack_mask is not None:
        return _i32(out & unpack_mask)
    return _u32(out)


def merge_level_plain(x: torch.Tensor, *, run: int,
                      unpack_mask: Optional[int] = None) -> torch.Tensor:
    """Twin of K8: each adjacent pair of sorted runs merged stably (ties to
    A): A[i] lands at i + #(B < A[i]), B[j] at j + #(A <= B[j])."""
    n = x.shape[0]
    w = _u64(x).reshape(n // (2 * run), 2, run)
    a, b = w[:, 0].contiguous(), w[:, 1].contiguous()
    pos = torch.arange(run, dtype=torch.int64, device=x.device)
    dest_a = pos + torch.searchsorted(b, a, right=False)
    dest_b = pos + torch.searchsorted(a, b, right=True)
    out = torch.empty_like(w.reshape(-1, 2 * run))
    out.scatter_(1, dest_a, a)
    out.scatter_(1, dest_b, b)
    out = out.reshape(n)
    if unpack_mask is not None:
        return _i32(out & unpack_mask)
    return _u32(out)


def _merge_level(x: torch.Tensor, *, run: int, tile: int,
                 unpack_mask: Optional[int] = None,
                 v1: bool = False) -> torch.Tensor:
    """Merge all adjacent (2·run)-pairs of sorted runs in one launch (K8);
    ``unpack_mask`` fuses the final ``& idx_mask`` unpack of ``argsort``
    (int32 output).  On the card v2 runs blocks of :func:`k8_block`
    words; ``v1=True`` launches the first design instead (blocks of the
    tile), which the card check times v2 against."""
    n = x.shape[0]
    if n % (2 * run) or run % tile:
        raise ValueError(f"_merge_level needs n % (2*run) == 0 and run % "
                         f"tile == 0, got n={n}, run={run}, tile={tile}")
    if x.device.type == "cpu":
        return merge_level_plain(x, run=run, unpack_mask=unpack_mask)
    if not x.is_cuda or x.dtype != torch.uint32 or not x.is_contiguous():
        raise TypeError(f"_merge_level takes a contiguous CUDA uint32 "
                        f"tensor, got {x.dtype} on {x.device}")
    out = torch.empty(n, dtype=torch.uint32 if unpack_mask is None
                      else torch.int32, device=x.device)
    block = min(tile, MAX_BLOCK) if v1 else k8_block(n, run)
    K8(x.data_ptr(), out.data_ptr(), n, run, block,
       0 if unpack_mask is None else unpack_mask & 0xFFFFFFFF,
       int(unpack_mask is not None), int(not v1),
       torch.cuda.current_stream(x.device).cuda_stream)
    return out


def merge_pair(a: torch.Tensor, b: torch.Tensor, *,
               tile: int = 1024) -> torch.Tensor:
    """Merge two sorted uint32 tensors of equal length: one num_pairs=1
    level of the merge kernel."""
    n = a.shape[0]
    return _merge_level(torch.cat([a, b]), run=n, tile=min(tile, n))


# ---------------------------------------------------------------------------
# composed sort (tile plan + level-batched merge schedule)
# ---------------------------------------------------------------------------

def _tile_plan(n: int, tile: int):
    """The Kvik plan driving the sort: ``even_levels(bound_depth(...))``
    over the index range.  even_levels parity is realized on the tile count
    (halve the tile once so the level count is even).  Returns
    ``(plan, depth, tile)``; plan is None when depth == 0."""
    tile = min(tile, n)
    depth = int(math.log2(n // tile))
    parity_ok = depth % 2 == 0
    if not parity_ok and tile >= 2:
        depth += 1          # even merge parity — the paper's even_levels
        tile = n >> depth   # concern, realized on the tile count
        parity_ok = True
    if depth == 0:
        return None, 0, tile
    # tile == 1 with odd depth cannot be re-tiled; run the odd schedule
    # rather than let even_levels force division below one element
    work = bound_depth(SeqWork(0, n, align=tile, min_size=tile), depth)
    plan = build_plan(even_levels(work) if parity_ok else work)
    return plan, depth, tile


@functools.lru_cache(maxsize=256)
def _merge_schedule(n: int, tile: int, sort_bits: int, digit_bits: int
                    ) -> Tuple[int, int, Optional[tuple], Tuple[int, ...]]:
    """``(depth, tile, tile digit passes, merge run lengths)`` of the plan's
    ``sort_schedule`` for ``n`` words in tiles of ``tile``.  Built once per
    shape: a plan of 2^k tiles is 2^k Python leaves (tens of ms at 2^20
    words), which the reference pays once when ``jit`` traces it."""
    plan, depth, tile = _tile_plan(n, tile)
    if plan is None:
        return 0, tile, None, ()
    sched = plan.sort_schedule(sort_bits=sort_bits, digit_bits=digit_bits,
                               key_shift=int(math.log2(tile)))
    assert len(sched.levels) == depth
    for level in sched.levels:
        assert level.uniform, "sort plan must divide into uniform runs"
    return depth, tile, sched.tile_passes, tuple(
        level.run_length for level in sched.levels)


@functools.lru_cache(maxsize=256)
def _multi_tile_passes(n_pad: int, tile: int, sort_bits: int,
                       digit_bits: int, idx_bits: int) -> tuple:
    """The plan's ``sort_schedule(mode="multi_tile")`` digit passes for a
    power-of-two number of tiles, built once per shape."""
    depth = int(math.log2(n_pad // tile))
    work = bound_depth(SeqWork(0, n_pad, align=tile, min_size=tile), depth)
    return build_plan(work).sort_schedule(
        sort_bits=sort_bits, digit_bits=digit_bits, key_shift=idx_bits,
        mode="multi_tile").tile_passes


def sort_u32(x: torch.Tensor, *, tile: int = 1024, method: str = "radix",
             total_bits: int = 32, digit_bits: int = 4,
             group: int = 8) -> torch.Tensor:
    """Sort of packed uint32 words: tile sort, then one launch per merge
    level of the plan's schedule.  The tile phase is the in-kernel LSD
    radix sort (``ceil(total_bits / digit_bits)`` digit passes);
    ``method="bitonic"`` is the reference's baseline network (K9a)."""
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError(f"sort_u32 needs a power-of-two input, got n={n} "
                         "(pad first)")
    if method not in ("radix", "bitonic"):
        raise ValueError(f"unknown tile-sort method {method!r}")
    _, tile, _, runs = _merge_schedule(n, tile, total_bits, digit_bits)
    if method == "radix":
        x = radix_tile_sort(x, tile=tile, total_bits=total_bits,
                            digit_bits=digit_bits, group=group)
    else:
        x = tile_sort(x, tile=tile)
    for run in runs:
        x = _merge_level(x, run=run, tile=tile)
    return x


def _argsort_impl(keys: torch.Tensor, *, n: int, n_pad: int, tile: int,
                  num_key_bits: int, idx_bits: int, method: str, fused: bool,
                  digit_bits: int, group: int, strategy: str) -> torch.Tensor:
    idx_mask = (1 << idx_bits) - 1
    max_key = (1 << num_key_bits) - 1

    def padded(fill: int) -> torch.Tensor:
        if n_pad == n:
            return keys
        return torch.cat([keys, torch.full((n_pad - n,), fill,
                                           dtype=keys.dtype,
                                           device=keys.device)])

    if strategy == "multi_tile":
        # merge-tree-free path: 3 launches per digit pass, independent of n;
        # n_pad is any multiple of the tile
        tile_mt = min(tile, n_pad)
        nt = n_pad // tile_mt
        passes = None
        if nt > 1 and (nt & (nt - 1)) == 0:
            # power-of-two tile counts route through the plan so the
            # schedule metadata (mode, num_tiles, num_launches) is exercised
            passes = _multi_tile_passes(n_pad, tile_mt, num_key_bits,
                                        digit_bits, idx_bits)
        return multi_tile_argsort_packed(
            padded(max_key), n=n, tile=tile_mt, num_key_bits=num_key_bits,
            idx_bits=idx_bits, digit_bits=digit_bits, group=group,
            passes=passes)[:n]
    if fused:
        # pack lives in the tile-sort kernel; pad keys carry the max key so
        # they sort to the tile end (the kernel emits sentinels for them)
        depth, tile, passes, runs = _merge_schedule(n_pad, tile, num_key_bits,
                                                    digit_bits)
        x = radix_tile_sort_packed(
            padded(max_key), n=n, tile=tile, num_key_bits=num_key_bits,
            idx_bits=idx_bits, digit_bits=digit_bits, group=group,
            unpack=depth == 0, passes=passes)
        for i, run in enumerate(runs):
            x = _merge_level(
                x, run=run, tile=tile,
                unpack_mask=idx_mask if i == len(runs) - 1 else None)
        return x[:n]
    # unfused: standalone pack (K9b) and unpack (K9c) around the u32 sort
    packed = _pack(padded(0), n=n, idx_bits=idx_bits)
    out = sort_u32(packed, tile=tile, method=method,
                   total_bits=num_key_bits + idx_bits, digit_bits=digit_bits,
                   group=group)
    return _unpack(out, idx_mask=idx_mask)[:n]


def argsort(keys: torch.Tensor, *, num_key_bits: int = 12, tile: int = 1024,
            method: str = "radix", fused: Optional[bool] = None,
            digit_bits: int = 4, group: int = 8,
            strategy: Optional[str] = None) -> torch.Tensor:
    """Stable argsort of small non-negative integer keys — the MoE dispatch
    entry.  keys: (n,) integers in [0, 2^num_key_bits); returns the (n,)
    int32 order, on the keys' device.

    ``idx_bits = ceil(log2(n))`` is derived per call, so the hard error
    fires only when ``num_key_bits + idx_bits > 32``.  ``strategy``:
    ``"multi_tile"`` (default for ``num_key_bits <= 16`` on the fused radix
    pipeline) runs 3 launches per digit pass, independent of n, padding to
    a multiple of the tile; ``"merge"`` runs the fused radix tile sort then
    one launch per merge level, padding to a power of two (auto-selected
    above 16 bits, and the only strategy of the ``fused=False`` /
    ``method="bitonic"`` comparison pipelines).  Both strategies give the
    same order.
    """
    n = keys.shape[0]
    if keys.dim() != 1 or keys.dtype.is_floating_point or \
            keys.dtype.is_complex or keys.dtype == torch.bool:
        raise TypeError(f"argsort takes a 1-D integer tensor, got "
                        f"{keys.dtype} of shape {tuple(keys.shape)}")
    if fused is None:
        fused = method == "radix"
    if fused and method != "radix":
        raise ValueError("fused pack/unpack requires method='radix' "
                         "(the bitonic network kernel is the unfused "
                         "baseline)")
    if strategy is None:
        strategy = ("multi_tile" if fused and method == "radix"
                    and num_key_bits <= 16 else "merge")
    if strategy not in ("merge", "multi_tile"):
        raise ValueError(f"unknown argsort strategy {strategy!r}")
    if strategy == "multi_tile" and (not fused or method != "radix"):
        raise ValueError("strategy='multi_tile' requires the fused radix "
                         "pipeline (method='radix', fused=True)")
    idx_bits = max(1, (n - 1).bit_length()) if n else 1
    if num_key_bits + idx_bits > 32:
        raise ValueError(
            f"cannot pack: num_key_bits={num_key_bits} + idx_bits="
            f"{idx_bits} (= ceil(log2(n)) for n={n}) exceeds 32 — packed "
            "keys and indices would collide.  Shrink the batch or the key "
            f"range (n={n} admits keys up to 2^{32 - idx_bits})")
    if n:
        # both ends in one host sync: the reference checks only the max,
        # and a negative key then corrupts the order silently
        kmin, kmax = torch.stack(torch.aminmax(keys)).tolist()
        if kmin < 0:
            raise ValueError(
                f"keys must be >= 0, got min key {kmin}: a negative key "
                "sets the high bits of its packed word and corrupts the "
                "order")
        if kmax >= 1 << num_key_bits:
            raise ValueError(
                f"keys must be < 2^num_key_bits = {1 << num_key_bits}, got "
                f"max key {kmax}: packed keys would collide with the index "
                "bits and silently corrupt the order (raise num_key_bits)")
    if strategy == "multi_tile":
        # any whole number of tiles works — no power-of-two padding
        t_eff = min(tile, 1 << math.ceil(math.log2(max(2, n))))
        n_pad = -(-max(2, n) // t_eff) * t_eff
    else:
        n_pad = 1 << math.ceil(math.log2(max(2, n)))
    return _argsort_impl(
        keys.to(torch.int32).contiguous(), n=n, n_pad=n_pad, tile=tile,
        num_key_bits=num_key_bits, idx_bits=idx_bits, method=method,
        fused=fused, digit_bits=digit_bits, group=group, strategy=strategy)


__all__ = ["argsort", "sort_u32", "tile_sort", "merge_pair",
           "merge_level_plain", "merge_level_model", "kary_coranks",
           "k8_block", "tile_sort_plain", "pack_plain", "unpack_plain",
           "tile_sort_model", "k9a_shape", "kernel_attributes",
           "merge_level_attributes", "IDX_BITS", "IDX_MASK",
           "MAX_BITONIC_TILE", "K8", "K9A", "K9B", "K9C"]
