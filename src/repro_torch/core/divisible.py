"""The ``Divisible`` abstraction (paper §3.1) — the port's own copy of the
part the serving path uses: ``WorkRange`` and ``SeqWork``.

A ``Divisible`` is a *work descriptor*: it holds only the coordinates of
work (sequence ranges, KV-block grids), never tensors.  Division happens in
Python on the host; the resulting plans parameterize the kernel launches.
Kept line-for-line equal to ``repro.core.divisible`` where the two overlap.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Tuple, runtime_checkable


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

    def indices(self) -> range:
        return range(self.start, self.stop)

    def __repr__(self) -> str:  # compact for plan dumps
        return f"[{self.start},{self.stop})"


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


__all__ = ["Divisible", "WorkRange", "SeqWork"]
