"""The by_blocks scheduler (paper §3.5) — the port's own copy of the static
face of ``ByBlocks`` and its ``BlockStats``.

A sequential outer loop over parallel blocks of geometrically growing size:
the scheduler for interruptible computations (chunked prefill, early-exit
decode).  Wasted work is bounded by growth/(1+growth) of useful work.  The
``simulate`` face runs on the virtual-time Runtime and comes with it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Tuple

from .divisible import Divisible
from .plan import geometric_blocks


@dataclasses.dataclass
class BlockStats:
    """Accounting for interruptible executions (validates the paper's bound)."""

    blocks_run: int = 0
    items_run: int = 0
    items_total: int = 0
    stopped_early: bool = False
    stop_index: Optional[int] = None

    @property
    def wasted_items(self) -> int:
        if self.stop_index is None:
            return 0
        return max(0, self.items_run - (self.stop_index + 1))

    @property
    def wasted_fraction(self) -> float:
        if self.items_run == 0:
            return 0.0
        return self.wasted_items / self.items_run


@dataclasses.dataclass
class ByBlocks:
    """Sequential outer loop over geometrically growing parallel blocks;
    ``should_stop(carry)`` between blocks is the interruption point."""

    first: int
    growth: float = 2.0
    align: int = 1
    cap: Optional[int] = None

    def blocks(self, work: Divisible) -> Iterator[Divisible]:
        total = work.size()
        rest = work
        for (start, stop) in geometric_blocks(total, first=self.first,
                                              growth=self.growth,
                                              align=self.align, cap=self.cap):
            blk, rest = rest.divide_at(stop - start)
            yield blk

    def block_bounds(self, total: int) -> List[Tuple[int, int]]:
        return geometric_blocks(total, first=self.first, growth=self.growth,
                                align=self.align, cap=self.cap)

    def run(self, work: Divisible,
            block_fn: Callable[[Divisible, Any], Any],
            carry: Any,
            should_stop: Callable[[Any], bool] = lambda c: False,
            ) -> Tuple[Any, BlockStats]:
        """Run blocks sequentially until exhausted or ``should_stop``."""
        stats = BlockStats(items_total=work.size())
        for blk in self.blocks(work):
            carry = block_fn(blk, carry)
            stats.blocks_run += 1
            stats.items_run += blk.size()
            if should_stop(carry):
                stats.stopped_early = True
                break
        return carry, stats


__all__ = ["ByBlocks", "BlockStats"]
