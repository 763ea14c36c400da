"""Single-launch scans with a carry, the counterpart of
``repro.kernels.tile_scan``, with the hand-written Hopper kernels
(``csrc/tile_scan.cu``) and their plain PyTorch twins.

K5 — ``tile_scan`` (a 1-D scan under a scalar monoid) and
``histogram_offsets`` (the digit-major exclusive scan of a (nt, R) digit
histogram: the multi-tile radix sort's global base offsets).  On the CPU
the twin takes any monoid ``combine``/``unit``, as the reference does; on
a CUDA tensor only the int32 sum (``combine`` None or ``torch.add``, unit
0; for the histogram a power-of-two radix up to 256) launches
``tile_scan_add``, and anything else raises.  The reference
pads the last block with the unit and carries a sum across sequential
grid steps; the kernel is one launch of a thread-block cluster: each CTA
sums its block of rows, writes the sums into every CTA's shared memory
(distributed shared memory), then scans its block from its carry
(:func:`cluster_scan_plain` models the split), so ``block`` changes no
value and is checked only.

K4 — ``tree_scan`` and ``batched_scan``, the pytree scans.

Semantics are the reference's.  Elements are tuples of tensors (the SSM
monoids' pytrees); ``combine`` is associative with identity ``units`` (one
scalar per leaf); ``carry0`` optionally seeds the scan, so the inclusive
output at t is ``carry0 ∘ e_0 ∘ … ∘ e_t`` and the exclusive output is the
state *entering* element t.  ``tree_scan`` scans axis 0 of (L, *feat_i)
leaves whose feature shapes may differ (matrix monoids); ``batched_scan``
scans axis 1 of identically shaped (B, L, *feat) leaves under an
elementwise combine, with (B, *feat) ``carry0`` leaves.

The plain twin (:func:`fold`) is a sequential left fold with the given
``combine``: the carry takes one element at a time, which equals the
reference's blockwise associative scan up to fp32 reassociation.  It runs
for CPU tensors.  For CUDA tensors the scans dispatch by monoid:

* ``tree_scan`` with ``ssm_scan.logspace_affine_combine`` →
  ``tile_scan_logspace`` (the mLSTM carry);
* ``tree_scan`` or ``batched_scan`` with ``ssm_scan.affine_combine`` →
  ``tile_scan_affine`` (Mamba's recurrence);

and any other combine raises: nothing folds in Python on the card.  Neither
the fold nor the kernels tile the scan axis, so the reference's identity
padding of its last block changes no value here; ``block``/``fblock`` are
checked for the reference's signature and change nothing else.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from . import _build

Leaves = Tuple[torch.Tensor, ...]
LOGSPACE = _build.KERNELS["tile_scan_logspace"]
AFFINE = _build.KERNELS["tile_scan_affine"]
SCAN_ADD = _build.KERNELS["tile_scan_add"]
MAX_L = 2048          # logspace scan length the kernel stages in shared memory
MAX_CLUSTER = 16      # K5's CTAs: one cluster (above 8 is non-portable)


# ---------------------------------------------------------------------------
# K5: the 1-D scan and the histogram offsets
# ---------------------------------------------------------------------------

def scan_plain(x: torch.Tensor, *, combine: Optional[Callable] = None,
               unit=0, inclusive: bool = False) -> torch.Tensor:
    """The plain twin of K5 on any device: the int sum is ``torch.cumsum``
    in the input's dtype; any other monoid is a Hillis–Steele scan, log2(n)
    elementwise ``combine`` steps (exact for integer monoids, equal to the
    reference up to reassociation for floats).  Exclusive output is the
    inclusive one shifted right behind the unit."""
    if combine is None or combine is torch.add:
        incl = torch.cumsum(x, 0, dtype=x.dtype)
    else:
        incl, step = x.clone(), 1
        while step < x.shape[0]:
            incl = torch.cat([incl[:step], combine(incl[:-step],
                                                   incl[step:])])
            step *= 2
    if inclusive:
        return incl
    return torch.cat([torch.full((1,), unit, dtype=x.dtype,
                                 device=x.device), incl[:-1]])


def _scan_add(x: torch.Tensor, nt: int, r: int, inclusive: bool, *,
              cluster: int = 0) -> torch.Tensor:
    """``tile_scan_add``: r = 1, a 1-D scan of nt elements; r = R (a power
    of two up to 256), the digit-major offsets of an (nt, R) histogram,
    written in (nt, R) layout.  ``cluster`` forces the cluster's CTAs (1 to
    16; 0 takes the kernel's rule)."""
    if not x.is_cuda:
        raise ValueError("tile_scan: expected a CUDA tensor")
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise NotImplementedError(
            f"tile_scan on the card takes a contiguous int32 sum, got "
            f"{x.dtype}; other monoids and dtypes run only on the CPU twin")
    if r > 256 or r & (r - 1):
        raise NotImplementedError(
            f"histogram_offsets on the card takes a power-of-two radix up "
            f"to 256, got radix {r}")
    if not 0 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"tile_scan: cluster must be 0 (the rule) to "
                         f"{MAX_CLUSTER}, got {cluster}")
    out = torch.empty_like(x)
    SCAN_ADD(x.data_ptr(), out.data_ptr(), nt * r, nt, r, int(inclusive),
             cluster, _stream(x))
    return out


def cluster_scan_plain(hist: torch.Tensor, clusters: int, *,
                       inclusive: bool = False) -> torch.Tensor:
    """K5's decomposition in plain PyTorch: ``clusters`` blocks of whole
    rows, split as the kernel splits them (a multiple of 4 words each, the
    last ragged or empty); per block its column sums, then each block's
    carry (every column of smaller digit, plus its own digit's column over
    earlier blocks), then the block's rows scanned from that carry.  Equals
    :func:`histogram_offsets_plain` (r > 1) and :func:`scan_plain` (r = 1,
    ``hist`` of shape (n, 1)) exactly, wrapping as int32 does."""
    nt, r = hist.shape
    unit = 1 if r >= 4 else 4 // r
    units = -(-nt // unit)
    block_rows = -(-units // clusters) * unit
    h = hist.to(torch.int64)
    blocks = [h[min(nt, c * block_rows):min(nt, (c + 1) * block_rows)]
              for c in range(clusters)]
    colsums = torch.stack([b.sum(0) for b in blocks])        # (C, r)
    total = colsums.sum(0)
    dbase = torch.cumsum(total, 0) - total
    before = torch.cumsum(colsums, 0) - colsums               # (C, r)
    outs = []
    for c, b in enumerate(blocks):
        incl = torch.cumsum(b, 0)
        rows = incl if inclusive else incl - b
        outs.append(rows + dbase + before[c])
    out = torch.cat(outs)
    return ((out + 2 ** 31) % 2 ** 32 - 2 ** 31).to(hist.dtype)


def tile_scan(x: torch.Tensor, *, block: int = 256,
              combine: Optional[Callable] = None, unit=0,
              inclusive: bool = False) -> torch.Tensor:
    """Exclusive (default) or inclusive scan of a 1-D tensor in one launch.
    ``combine``/``unit`` default to ``(+, 0)``; on a CUDA tensor only that
    monoid on int32 runs (the kernel), on the CPU any monoid (the twin)."""
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    n = x.shape[0]
    if n == 0:
        return x
    if x.device.type == "cpu":
        return scan_plain(x, combine=combine, unit=unit, inclusive=inclusive)
    if combine not in (None, torch.add) or unit != 0:
        raise NotImplementedError(
            "tile_scan on the card implements the sum (unit 0) only; CUDA "
            "tensors are never scanned in Python")
    return _scan_add(x, n, 1, inclusive)


def histogram_offsets_plain(hist: torch.Tensor) -> torch.Tensor:
    """The twin of :func:`histogram_offsets`: transpose, cumsum,
    transpose back."""
    nt, r = hist.shape
    flat = hist.t().reshape(nt * r)
    return scan_plain(flat).reshape(r, nt).t()


def histogram_offsets(hist: torch.Tensor, *, block: int = 256
                      ) -> torch.Tensor:
    """Global base offsets from a ``(num_tiles, R)`` digit histogram:
    ``offsets[t, d]`` = #(elements with digit < d anywhere) + #(elements
    with digit d in tiles before ``t``), the exclusive scan of the
    histogram flattened digit-major.  The kernel reads the (nt, R) matrix
    as it lies (each CTA of a cluster its block of rows: column sums, then
    the rows' scan from registers) and writes the offsets in (nt, R)
    layout: one launch, no transposes."""
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    nt, r = hist.shape
    if hist.device.type == "cpu":
        return histogram_offsets_plain(hist)
    if nt * r == 0:
        return hist.clone()
    return _scan_add(hist, nt, r, False)


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------

def fold(xs: Sequence[torch.Tensor], combine: Callable, carry: Sequence[
        torch.Tensor], *, inclusive: bool, axis: int) -> Leaves:
    """Sequential left fold of ``combine`` along ``axis``, seeded with
    ``carry`` (leaves shaped like one element).  Runs on any device."""
    L = xs[0].shape[axis]
    if L == 0:
        return tuple(x.clone() for x in xs)
    outs: list = [[] for _ in xs]
    carry = tuple(carry)
    for t in range(L):
        e = tuple(x.select(axis, t) for x in xs)
        if not inclusive:
            for o, c in zip(outs, carry):
                o.append(c)
        carry = tuple(combine(carry, e))
        if inclusive:
            for o, c in zip(outs, carry):
                o.append(c)
    return tuple(torch.stack(o, dim=axis) for o in outs)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name: str, tensors: Sequence[torch.Tensor]) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes fp32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned "
                             f"(float4 loads)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def logspace_scan(la: torch.Tensor, m: torch.Tensor, C: torch.Tensor,
                  n: torch.Tensor, carry: Sequence[torch.Tensor], *,
                  inclusive: bool) -> Leaves:
    """``tile_scan_logspace``: the log-space affine monoid over axis 0, one
    launch.  la, m (L, *s); C (L, *s, d1, d2); n (L, *s, d1); ``carry``
    (la0, m0, C0, n0) shaped like one element.  All fp32, contiguous,
    16-byte aligned, d1*d2 and d1 multiples of 4."""
    la0, m0, C0, n0 = carry
    _check_cuda("tile_scan_logspace", (la, m, C, n, la0, m0, C0, n0))
    L, s = la.shape[0], tuple(la.shape[1:])
    G = math.prod(s)
    if m.shape != la.shape or C.dim() != la.dim() + 2 or \
            n.dim() != la.dim() + 1 or tuple(C.shape[:la.dim()]) != \
            tuple(la.shape) or tuple(n.shape[:la.dim()]) != tuple(la.shape) \
            or C.shape[-2] != n.shape[-1]:
        raise ValueError(f"tile_scan_logspace: leaf shapes {tuple(la.shape)}"
                         f", {tuple(m.shape)}, {tuple(C.shape)}, "
                         f"{tuple(n.shape)} are not (L,*s), (L,*s), "
                         f"(L,*s,d,e), (L,*s,d)")
    FC, FN = C.shape[-2] * C.shape[-1], n.shape[-1]
    for c, leaf in zip(carry, (la, m, C, n)):
        if c.shape != leaf.shape[1:]:
            raise ValueError(f"tile_scan_logspace: carry leaf "
                             f"{tuple(c.shape)} != element "
                             f"{tuple(leaf.shape[1:])}")
    if FC % 4 or FN % 4 or not 1 <= L <= MAX_L or G > 65535:
        raise ValueError(f"tile_scan_logspace takes 1 <= L <= {MAX_L}, "
                         f"G <= 65535 and feature sizes that are multiples "
                         f"of 4; got L={L}, G={G}, FC={FC}, FN={FN}")
    outs = tuple(torch.empty_like(t) for t in (la, m, C, n))
    LOGSPACE(*(t.data_ptr() for t in (la, m, C, n, la0, m0, C0, n0)),
             *(t.data_ptr() for t in outs), L, G, FC, FN, int(inclusive),
             _stream(la))
    return outs


def affine_scan(a: torch.Tensor, b: torch.Tensor, a0: torch.Tensor,
                h0: torch.Tensor, *, inclusive: bool, gains: bool = True
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """``tile_scan_affine``: the affine monoid over axis 1, one launch.
    a, b (B, L, *feat); a0, h0 (B, *feat); fp32, contiguous, 16-byte
    aligned, prod(feat) a multiple of 4.  Returns (gains or None, states);
    with ``gains=False`` the gain leaf is neither written nor allocated."""
    _check_cuda("tile_scan_affine", (a, b, a0, h0))
    if b.shape != a.shape or a.dim() < 2 or a0.shape != h0.shape or \
            tuple(a0.shape) != (a.shape[0],) + tuple(a.shape[2:]):
        raise ValueError(f"tile_scan_affine: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, carry {tuple(a0.shape)}, "
                         f"{tuple(h0.shape)} are not (B,L,*f) x2, (B,*f) x2")
    B, L = a.shape[:2]
    F = math.prod(a.shape[2:])
    if F % 4 or L < 1 or B > 65535:
        raise ValueError(f"tile_scan_affine takes L >= 1, B <= 65535 and a "
                         f"feature size that is a multiple of 4; got B={B}, "
                         f"L={L}, F={F}")
    h = torch.empty_like(b)
    g = torch.empty_like(a) if gains else None
    AFFINE(a.data_ptr(), b.data_ptr(), a0.data_ptr(), h0.data_ptr(),
           None if g is None else g.data_ptr(), h.data_ptr(), B, L, F,
           int(inclusive), _stream(a))
    return g, h


# ---------------------------------------------------------------------------
# the public scans
# ---------------------------------------------------------------------------

def _leaves(xs: Any, units: Any) -> Tuple[Leaves, Tuple[float, ...]]:
    if not isinstance(xs, (tuple, list)) or not xs or \
            not all(isinstance(x, torch.Tensor) for x in xs):
        raise TypeError("elements must be a non-empty tuple of tensors")
    if not isinstance(units, (tuple, list)) or len(units) != len(xs):
        raise ValueError(f"units {units!r} do not match {len(xs)} leaves")
    return tuple(xs), tuple(units)


def _seed(leaves: Leaves, units, carry0, shapes) -> Leaves:
    """The carry entering element 0: ``carry0`` cast to the leaves' dtypes,
    or the units, materialized to one element's shape."""
    if carry0 is None:
        return tuple(torch.full(s, u, dtype=l.dtype, device=l.device)
                     for l, u, s in zip(leaves, units, shapes))
    if not isinstance(carry0, (tuple, list)) or len(carry0) != len(leaves):
        raise ValueError(f"carry0 does not match {len(leaves)} leaves")
    return tuple(torch.as_tensor(c, device=l.device).to(l.dtype)
                 .expand(s).contiguous()
                 for c, l, s in zip(carry0, leaves, shapes))


def _check_sizes(block: int, fblock: int = 1) -> None:
    if block < 1 or fblock < 1:
        raise ValueError(f"block {block} and fblock {fblock} must be >= 1")


def _on_card(combine: Callable, leaves: Leaves, carry: Leaves, *,
             inclusive: bool, batched: bool) -> Leaves:
    from .ssm_scan import affine_combine, logspace_affine_combine
    leaves = tuple(l.contiguous() for l in leaves)
    if combine is logspace_affine_combine and not batched:
        return logspace_scan(*leaves, carry, inclusive=inclusive)
    if combine is affine_combine:
        if batched:
            return affine_scan(*leaves, *carry, inclusive=inclusive)
        g, h = affine_scan(*(l[None] for l in leaves),
                           *(c[None] for c in carry), inclusive=inclusive)
        return g[0], h[0]
    raise NotImplementedError(
        f"no K4 kernel implements combine {getattr(combine, '__name__', combine)!r}"
        f" in the {'batched' if batched else 'tree'} layout; CUDA tensors "
        f"are never folded in Python")


def tree_scan(xs: Any, *, combine: Callable[[Any, Any], Any], units: Any,
              carry0: Optional[Any] = None, inclusive: bool = True,
              block: int = 128) -> Leaves:
    """Scan over axis 0 of a tuple of (L, *feat_i) tensors; ``combine``
    sees leaves shaped (*feat_i) and may rescale or contract trailing dims.
    One kernel launch on CUDA, the plain fold on the CPU."""
    leaves, units = _leaves(xs, units)
    _check_sizes(block)
    L = leaves[0].shape[0]
    if any(l.shape[0] != L for l in leaves):
        raise ValueError("tree_scan leaves differ in length")
    carry = _seed(leaves, units, carry0, [l.shape[1:] for l in leaves])
    if leaves[0].device.type == "cpu":
        return fold(leaves, combine, carry, inclusive=inclusive, axis=0)
    if L == 0:
        return tuple(l.clone() for l in leaves)
    return _on_card(combine, leaves, carry, inclusive=inclusive,
                    batched=False)


def batched_scan(xs: Any, *, combine: Callable[[Any, Any], Any], units: Any,
                 carry0: Optional[Any] = None, inclusive: bool = True,
                 block: int = 128, fblock: int = 2048) -> Leaves:
    """Elementwise-monoid scan over axis 1 of a tuple of identically shaped
    (B, L, *feat) tensors; ``carry0`` leaves are (B, *feat).  One kernel
    launch on CUDA, the plain fold on the CPU."""
    leaves, units = _leaves(xs, units)
    _check_sizes(block, fblock)
    shape = leaves[0].shape
    if any(l.shape != shape for l in leaves):
        raise ValueError("batched_scan needs identically-shaped leaves; "
                         "use tree_scan for matrix monoids")
    carry = _seed(leaves, units, carry0,
                  [(shape[0],) + tuple(shape[2:])] * len(leaves))
    if leaves[0].device.type == "cpu":
        return fold(leaves, combine, carry, inclusive=inclusive, axis=1)
    if shape[1] == 0:
        return tuple(l.clone() for l in leaves)
    return _on_card(combine, leaves, carry, inclusive=inclusive,
                    batched=True)


def kernel_attributes(words: int, radix: int) -> Dict[str, int]:
    """Registers, spills, shared memory and CTAs an SM of K5's kernel for
    ``radix`` (1 for the 1-D scan), the largest cluster the card places and
    how many of those fit at once, and the cluster the rule takes for a
    call of ``words`` words."""
    return _build.attributes("tile_scan", "tile_scan_add_attrs", words,
                             radix, extra=("max_cluster", "active_clusters",
                                           "rule_cluster"))


__all__ = ["tile_scan", "histogram_offsets", "scan_plain",
           "histogram_offsets_plain", "cluster_scan_plain",
           "kernel_attributes", "tree_scan", "batched_scan", "fold",
           "logspace_scan", "affine_scan", "LOGSPACE", "AFFINE", "SCAN_ADD",
           "MAX_L", "MAX_CLUSTER"]
