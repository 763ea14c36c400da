"""The ``Divisible`` abstraction — Kvik's most fundamental trait (paper §3.1).

Kvik defines::

    fn should_be_divided(&self) -> bool;
    fn divide(self) -> (Self, Self);
    fn divide_at(self, index: usize) -> (Self, Self);

We reproduce the trait verbatim as a Python protocol.  In this framework a
``Divisible`` is a *work descriptor* — it never holds tensors, only the
coordinates of work (batch ranges, sequence ranges, KV-block grids, expert
buckets, permutation ranges).  Division happens in Python on the host at
*plan time* ("user space" in the paper's sense: outside the kernels), and the
resulting :class:`~repro_torch.core.plan.Plan` parameterizes kernel launches.
Kept line for line equal to ``repro.core.divisible``.

Concrete divisibles provided here:

* :class:`WorkRange`     — half-open integer range (the paper's slice).
* :class:`BatchWork`     — a range over a batch dimension (microbatching).
* :class:`SeqWork`       — a range over a sequence dimension (chunked prefill,
                           KV-block splitting).
* :class:`TileGrid2D`    — a 2-D tile grid (kernel grid decomposition); divides
                           along its longest axis, exactly like TBB's
                           ``blocked_range2d``.
* :class:`ZipDivisible`  — a tuple of divisibles dividing in lock-step (the
                           paper's ``(input_slice, buffer_slice)`` tuple used by
                           the merge sort, §3.7).
* :class:`PermRange`     — a range over the permutation set of (1..n) where
                           ``divide_at`` is *expensive* (must generate the first
                           permutation from its rank) but sequential iteration
                           is cheap — the fannkuch-redux structure (paper §4.3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Protocol, Sequence, Tuple, runtime_checkable


@runtime_checkable
class Divisible(Protocol):
    """Protocol mirroring Kvik's ``Divisible`` trait."""

    def should_be_divided(self) -> bool:
        """Ask the work whether it wants to be divided further."""
        ...

    def divide(self) -> Tuple["Divisible", "Divisible"]:
        """Split into two approximately balanced halves."""
        ...

    def divide_at(self, index: int) -> Tuple["Divisible", "Divisible"]:
        """Split so the left part has approximately ``index`` elements."""
        ...

    def size(self) -> int:
        """Number of remaining work items (``len`` in Kvik's producers)."""
        ...


class Producer(Divisible, Protocol):
    """Kvik ``Producer`` = ``Divisible`` + sequential iteration (paper §2.3.2).

    ``partial_fold`` is the nano-loop primitive of the adaptive scheduler
    (paper §3.6): fold at most ``limit`` items into ``state`` and return the
    new state; the producer advances in place.
    """

    def partial_fold(self, state: Any, fold_op: Callable[[Any, Any], Any],
                     limit: int) -> Any:
        ...


def _check_fraction(index: int, n: int) -> int:
    return max(0, min(int(index), n))


@dataclasses.dataclass
class WorkRange:
    """Half-open integer range ``[start, stop)`` — the basic divisible.

    ``min_size`` plays the role of the producer's intrinsic division floor
    (basic Kvik producers divide down to size 1 by default).
    """

    start: int
    stop: int
    min_size: int = 1

    def size(self) -> int:
        return max(0, self.stop - self.start)

    def should_be_divided(self) -> bool:
        return self.size() > self.min_size

    def divide(self) -> Tuple["WorkRange", "WorkRange"]:
        return self.divide_at(self.size() // 2)

    def divide_at(self, index: int) -> Tuple["WorkRange", "WorkRange"]:
        index = _check_fraction(index, self.size())
        mid = self.start + index
        left = dataclasses.replace(self, start=self.start, stop=mid)
        right = dataclasses.replace(self, start=mid, stop=self.stop)
        return left, right

    # --- Producer interface -------------------------------------------------
    def partial_fold(self, state, fold_op, limit):
        take = min(limit, self.size())
        for i in range(self.start, self.start + take):
            state = fold_op(state, i)
        self.start += take
        return state

    def indices(self) -> range:
        return range(self.start, self.stop)

    def __repr__(self) -> str:  # compact for plan dumps
        return f"[{self.start},{self.stop})"


@dataclasses.dataclass
class BatchWork(WorkRange):
    """A range over a global-batch dimension.  ``axis`` documents intent."""

    axis: str = "batch"


@dataclasses.dataclass
class SeqWork(WorkRange):
    """A range over a sequence dimension (prefill chunks / KV blocks).

    ``align`` forces division points onto multiples (kernel tile sizes,
    page sizes): divide_at rounds the cut to the alignment grid.
    """

    align: int = 1

    def divide_at(self, index: int) -> Tuple["SeqWork", "SeqWork"]:
        index = _check_fraction(index, self.size())
        if self.align > 1:
            index = (index // self.align) * self.align
            if index == 0 and self.size() > self.align:
                index = self.align
        mid = self.start + index
        left = dataclasses.replace(self, start=self.start, stop=mid)
        right = dataclasses.replace(self, start=mid, stop=self.stop)
        return left, right

    def should_be_divided(self) -> bool:
        return self.size() > max(self.min_size, self.align)


@dataclasses.dataclass
class TileGrid2D:
    """A 2-D tile grid dividing along its longest axis (TBB blocked_range2d)."""

    rows: WorkRange
    cols: WorkRange

    def size(self) -> int:
        return self.rows.size() * self.cols.size()

    def should_be_divided(self) -> bool:
        return self.rows.should_be_divided() or self.cols.should_be_divided()

    def _divide_axis(self, index_rows: int | None, index_cols: int | None):
        if index_rows is not None:
            rl, rr = self.rows.divide_at(index_rows)
            return (TileGrid2D(rl, self.cols), TileGrid2D(rr, self.cols))
        cl, cr = self.cols.divide_at(index_cols)
        return (TileGrid2D(self.rows, cl), TileGrid2D(self.rows, cr))

    def divide(self):
        if self.rows.size() >= self.cols.size():
            return self._divide_axis(self.rows.size() // 2, None)
        return self._divide_axis(None, self.cols.size() // 2)

    def divide_at(self, index: int):
        # index counts items; translate to a cut on the longest axis.
        if self.rows.size() >= self.cols.size():
            per_row = max(1, self.cols.size())
            return self._divide_axis(index // per_row, None)
        per_col = max(1, self.rows.size())
        return self._divide_axis(None, index // per_col)

    def __repr__(self) -> str:
        return f"Tile({self.rows!r}x{self.cols!r})"


@dataclasses.dataclass
class ZipDivisible:
    """Tuple of divisibles dividing in lock-step (paper §3.7: the merge sort
    divides ``(input_slice, buffer_slice)`` together)."""

    parts: Tuple[Divisible, ...]

    def size(self) -> int:
        return min(p.size() for p in self.parts)

    def should_be_divided(self) -> bool:
        return all(p.should_be_divided() for p in self.parts)

    def divide(self):
        return self.divide_at(self.size() // 2)

    def divide_at(self, index: int):
        lefts, rights = [], []
        for p in self.parts:
            l, r = p.divide_at(index)
            lefts.append(l)
            rights.append(r)
        return (ZipDivisible(tuple(lefts)), ZipDivisible(tuple(rights)))


@dataclasses.dataclass
class WorkSet:
    """An ordered bag of independent work items — the multi-tenant analogue
    of a single range.  ``size`` is the total item count; ``divide_at`` cuts
    the *list* at the part boundary nearest the requested item count, so a
    ``by_blocks`` outer loop over a WorkSet sequences whole submissions.

    The SLO policies (:class:`~repro_torch.core.policies.PriorityPolicy`,
    :class:`~repro_torch.core.policies.DeadlinePolicy`) treat each part as one
    pool entry ordered by its :class:`~repro_torch.core.adaptors.Tagged` metadata;
    every other policy sees an ordinary Divisible.
    """

    parts: Tuple[Divisible, ...]

    def size(self) -> int:
        return sum(p.size() for p in self.parts)

    def should_be_divided(self) -> bool:
        return len(self.parts) > 1

    def divide(self) -> Tuple["WorkSet", "WorkSet"]:
        return self.divide_at(self.size() // 2)

    def divide_at(self, index: int) -> Tuple["WorkSet", "WorkSet"]:
        index = _check_fraction(index, self.size())
        cut, acc = 0, 0
        for p in self.parts:       # smallest non-empty prefix >= index items
            acc += p.size()
            cut += 1
            if acc >= index:
                break
        return (WorkSet(self.parts[:cut]), WorkSet(self.parts[cut:]))

    def __repr__(self) -> str:
        return f"WorkSet({len(self.parts)} parts, {self.size()} items)"


# ---------------------------------------------------------------------------
# Fannkuch-style permutation ranges (paper §4.3)
# ---------------------------------------------------------------------------

def _perm_from_rank(n: int, rank: int) -> list[int]:
    """Generate the rank-th permutation of (1..n) in the benchmark's factorial
    number system.  This is the *expensive* first-permutation generation the
    paper highlights: cost O(n^2)-ish vs O(1) amortized for next-permutation."""
    items = list(range(1, n + 1))
    out = []
    # standard factoradic decode
    fact = [1] * n
    for i in range(1, n):
        fact[i] = fact[i - 1] * i
    r = rank
    for i in range(n - 1, -1, -1):
        d, r = divmod(r, fact[i])
        out.append(items.pop(d))
    return out


@dataclasses.dataclass
class PermRange:
    """Range [start, stop) over ranks of permutations of (1..n).

    ``divide_at`` is charged an extra ``split_cost`` (first-permutation
    generation) by cost models; sequential iteration via ``partial_fold`` walks
    permutations with the O(1)-amortized next-permutation step.  This is the
    structure that makes the paper's adaptive scheduler win on fannkuch: fewer
    divisions ⇒ fewer expensive from-rank generations.
    """

    n: int
    start: int
    stop: int
    min_size: int = 1
    _current: list[int] | None = dataclasses.field(default=None, repr=False)

    def size(self) -> int:
        return max(0, self.stop - self.start)

    def should_be_divided(self) -> bool:
        return self.size() > self.min_size

    def divide(self):
        return self.divide_at(self.size() // 2)

    def divide_at(self, index: int):
        index = _check_fraction(index, self.size())
        mid = self.start + index
        left = PermRange(self.n, self.start, mid, self.min_size,
                         self._current.copy() if self._current else None)
        right = PermRange(self.n, mid, self.stop, self.min_size, None)
        return left, right

    @property
    def split_cost(self) -> float:
        """Virtual cost of materializing the first permutation from a rank."""
        return float(self.n * self.n)

    def current_permutation(self) -> list[int]:
        if self._current is None:
            self._current = _perm_from_rank(self.n, self.start)
        return self._current

    @staticmethod
    def _next_permutation(p: list[int]) -> None:
        """In-place lexicographic next permutation (amortized O(1))."""
        i = len(p) - 2
        while i >= 0 and p[i] >= p[i + 1]:
            i -= 1
        if i < 0:
            return
        j = len(p) - 1
        while p[j] <= p[i]:
            j -= 1
        p[i], p[j] = p[j], p[i]
        p[i + 1:] = reversed(p[i + 1:])

    def partial_fold(self, state, fold_op, limit):
        take = min(limit, self.size())
        perm = self.current_permutation()
        for _ in range(take):
            state = fold_op(state, perm)
            self._next_permutation(perm)
        self.start += take
        return state


def total_permutations(n: int) -> int:
    return math.factorial(n)


__all__ = [
    "Divisible", "Producer", "WorkRange", "BatchWork", "SeqWork",
    "TileGrid2D", "ZipDivisible", "WorkSet", "PermRange",
    "total_permutations",
]
