"""Schedulers (paper §3.2, §3.5, §3.6).

Four schedulers, mirroring Kvik:

* :class:`JoinScheduler`   — fork-join divide/map/tree-reduce (paper §3.2).
  Statically: builds a :class:`~repro_torch.core.plan.Plan` and runs a
  symmetric reduction tree over its leaves.
* ``depjoin``              — same division tree; the "reduce by last finisher"
  optimization only exists dynamically, so it is a policy of the unified
  virtual-time runtime (``repro_torch.core.runtime`` + ``repro_torch.core.policies``),
  where its benefit is measured — reachable via ``simulate(depjoin=True)``.

Each scheduler has two faces: the *static* ``plan``/``schedule`` face
(division recorded at plan time, parameterizing kernel launches) and a
*dynamic* ``simulate(work, p, cost)`` face running the same policy on the
unified discrete-event runtime.
* :class:`ByBlocks`        — a *sequential* outer loop over *parallel* blocks
  of geometrically growing size (paper §3.5).  This is the scheduler for
  interruptible computations: chunked prefill, early-exit decode, all-finite
  audits.  Wasted work is bounded by growth/(1+growth) of useful work.
* :class:`AdaptiveScheduler` — split only on demand (paper §3.6).  Statically
  the demand is the target's width (``demand_split``); dynamically the
  simruntime reproduces the steal-driven nano/micro-loop behaviour.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Tuple

from .adaptors import Adaptor, StealContext
from .divisible import Divisible
from .plan import Plan, build_plan, demand_split, geometric_blocks
from .policies import (AdaptivePolicy, ByBlocksPolicy, DepJoinPolicy,
                       JoinPolicy, SchedulingPolicy)
from .runtime import CostModel, Runtime, SimResult


# ---------------------------------------------------------------------------
# Join scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JoinScheduler:
    """Static fork-join scheduling: divide per policy, map leaves, tree-reduce.

    ``ctx`` feeds dynamic policies a synthetic steal context (default: no
    steals — the all-threads-busy baseline).
    """

    ctx: Optional[StealContext] = None

    def plan(self, work: Divisible) -> Plan:
        return build_plan(work, ctx=self.ctx)

    def schedule(self, work: Divisible, map_fn: Callable[[Divisible], Any],
                 reduce_fn: Callable[[Any, Any], Any]) -> Any:
        return self.plan(work).map_reduce(map_fn, reduce_fn)

    def simulate(self, work: Divisible, p: int, cost: CostModel, *,
                 depjoin: bool = False, seed: int = 0, speeds=None,
                 stop_predicate=None) -> SimResult:
        """Dynamic face: run this schedule on the unified virtual-time
        runtime (``depjoin=True`` → reduce-by-last-finisher, paper §3.2)."""
        policy = DepJoinPolicy() if depjoin else JoinPolicy()
        return Runtime(p, cost, policy, seed=seed, speeds=speeds,
                       stop_predicate=stop_predicate).run(work)


def schedule_join(work: Divisible, map_fn, reduce_fn, *,
                  ctx: Optional[StealContext] = None) -> Any:
    return JoinScheduler(ctx=ctx).schedule(work, map_fn, reduce_fn)


# ---------------------------------------------------------------------------
# by_blocks
# ---------------------------------------------------------------------------

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
        """Items processed beyond the stop index (0 when not stopped)."""
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
    """Sequential outer loop over geometrically growing parallel blocks.

    ``first`` defaults to the parallelism width p (the paper: "we take the
    number of threads P for the initial size"), ``growth`` = 2.  Each block is
    handed to ``block_fn`` (typically a jitted parallel computation over that
    chunk); between blocks ``should_stop(carry)`` is consulted — that is the
    interruption point.
    """

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

    def simulate(self, work: Divisible, p: int, cost: CostModel, *,
                 inner: Optional[SchedulingPolicy] = None, seed: int = 0,
                 speeds=None, stop_predicate=None) -> SimResult:
        """Dynamic face: sequential outer loop of geometric blocks on the
        unified runtime, each block a parallel region under ``inner``
        (default join).  Composition the old engines could not express:
        pass ``inner=AdaptivePolicy()`` for interruptible adaptive blocks."""
        policy = ByBlocksPolicy(inner=inner or JoinPolicy(), first=self.first,
                                growth=self.growth, align=self.align,
                                cap=self.cap)
        return Runtime(p, cost, policy, seed=seed, speeds=speeds,
                       stop_predicate=stop_predicate).run(work)


def by_blocks(first: int, growth: float = 2.0, **kw) -> ByBlocks:
    return ByBlocks(first=first, growth=growth, **kw)


# ---------------------------------------------------------------------------
# Adaptive scheduler (static face)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdaptiveScheduler:
    """Static face of the adaptive schedule: division only on demand.

    ``demand`` is the parallelism the hardware asks for (SMs, idle data-
    parallel replicas, grid slots).  The plan has exactly min(demand, size)
    leaves from demand−1 divisions — "tasks created = successful steals + 1".

    The *dynamic* adaptive scheduler — geometric nano-loops, interruption
    checks, steal-driven splits — is :class:`~repro_torch.core.policies.
    AdaptivePolicy` on the unified runtime (see :meth:`simulate`) and the
    train layer's between-steps rebalancer where real dynamism exists at
    cluster scale.
    """

    demand: int

    def plan(self, work: Divisible) -> Plan:
        return demand_split(work, self.demand)

    def schedule(self, work: Divisible, map_fn, reduce_fn) -> Any:
        return self.plan(work).map_reduce(map_fn, reduce_fn)

    def simulate(self, work: Divisible, p: Optional[int], cost: CostModel, *,
                 nano0: int = 1, seed: int = 0, speeds=None,
                 stop_predicate=None) -> SimResult:
        """Dynamic face: the steal-driven nano/micro-loop behaviour on the
        unified runtime (``p`` defaults to this scheduler's demand)."""
        return Runtime(p or self.demand, cost, AdaptivePolicy(nano0=nano0),
                       seed=seed, speeds=speeds,
                       stop_predicate=stop_predicate).run(work)


def adaptive(demand: int) -> AdaptiveScheduler:
    return AdaptiveScheduler(demand=demand)


__all__ = [
    "JoinScheduler", "schedule_join", "ByBlocks", "by_blocks", "BlockStats",
    "AdaptiveScheduler", "adaptive",
]
