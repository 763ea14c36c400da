"""Divide-and-conquer abstractions: ``wrap_iter`` and ``work`` (paper §3.4, §3.6.1).

``wrap_iter`` turns any :class:`Divisible` into a plan-time "parallel iterator
over sub-pieces": the middleware owns every splitting decision, the user maps
a sequential function over the leaves and fuses results back in a symmetric
reduction tree — the paper's maximum-subarray-sum shape.

``work_loop`` is the stateful nano-loop (paper §3.6.1 ``work()``): given a
carried state and an ``advance(state, n)`` step, it executes geometrically
growing iteration grants as a host loop, so the host regains control between
grants (the analogue of "check for steal requests / cancellation between
nano-loops").  ``should_stop`` may return a 0-d device tensor: its ``bool()``
is the one synchronisation per grant, O(log total) of them in all.  This is
the primitive under early-exit decode and the fannkuch benchmark.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from .adaptors import StealContext
from .divisible import Divisible
from .plan import Plan, build_plan


@dataclasses.dataclass
class WrappedIter:
    """Plan-time parallel iterator over the leaves of a division tree."""

    work: Divisible
    ctx: Optional[StealContext] = None

    def plan(self) -> Plan:
        return build_plan(self.work, ctx=self.ctx)

    def map_reduce(self, map_fn: Callable[[Divisible], Any],
                   reduce_fn: Callable[[Any, Any], Any]) -> Any:
        """The paper's ``wrap_iter().map(...).reduce(...)`` in one call."""
        return self.plan().map_reduce(map_fn, reduce_fn)

    def leaves(self):
        return self.plan().leaves()


def wrap_iter(work: Divisible, *, ctx: Optional[StealContext] = None
              ) -> WrappedIter:
    return WrappedIter(work, ctx)


def work_loop(state: Any,
              advance: Callable[[Any, int], Any],
              total: int,
              *,
              should_stop: Optional[Callable[[Any], Any]] = None,
              first_grant: int = 1,
              growth: int = 2,
              max_grant: Optional[int] = None) -> Any:
    """Stateful geometric nano-loop driven from the host.

    ``advance(state, n)`` performs ``n`` iterations on ``state`` (``n`` is a
    Python int).  ``should_stop(state)`` is evaluated between grants; a true
    value (a bool or a 0-d tensor) aborts the remaining grants.  The grant
    sequence is ``first_grant * growth**k`` capped at ``max_grant`` — at most
    O(log total) interruption checks, the paper's amortization argument.
    """
    max_grant = max_grant or total
    done, grant = 0, first_grant
    while done < total:
        n = min(grant, total - done)
        state = advance(state, n)
        done += n
        if should_stop is not None and bool(should_stop(state)):
            break
        grant = min(grant * growth, max_grant)
    return state


__all__ = ["wrap_iter", "WrappedIter", "work_loop"]
