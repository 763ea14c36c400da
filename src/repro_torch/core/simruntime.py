"""Deprecation shims over the unified scheduling runtime.

The three engines that used to live here — ``WorkStealingSim`` (join /
depjoin), ``AdaptiveSim``, and ``static_partition_sim`` — are now ~50-line
policies (:mod:`repro_torch.core.policies`) over one shared discrete-event engine
(:mod:`repro_torch.core.runtime`).  These shims keep the historical constructor
signatures and produce **bit-identical** :class:`~repro_torch.core.runtime.
SimResult` values under fixed seeds (pinned by ``tests/test_runtime.py``'s
golden table), so existing callers and the paper-claim tests keep passing.

New code should use :class:`~repro_torch.core.runtime.Runtime` with an explicit
policy (or the schedulers' ``simulate`` faces), which additionally allows
compositions these shims never could: ``by_blocks`` outer loops over
adaptive inner blocks, adaptor-wrapped adaptive tasks, depjoin under
by_blocks, and so on.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

from .divisible import Divisible
from .policies import (AdaptivePolicy, DepJoinPolicy, JoinPolicy,
                       StaticPartitionPolicy)
from .runtime import CostModel, Runtime, SimResult


class WorkStealingSim:
    """Deprecated shim: join/depjoin work stealing on the unified Runtime."""

    def __init__(self, p: int, cost: CostModel, *, depjoin: bool = False,
                 seed: int = 0, speeds: Optional[List[float]] = None,
                 stop_predicate: Optional[Callable[[Divisible], Optional[int]]] = None):
        self.p = p
        self.cost = cost
        self.depjoin = depjoin
        policy = DepJoinPolicy() if depjoin else JoinPolicy()
        self._rt = Runtime(p, cost, policy, seed=seed, speeds=speeds,
                           stop_predicate=stop_predicate)

    def run(self, work: Divisible) -> SimResult:
        return self._rt.run(work)


class AdaptiveSim:
    """Deprecated shim: steal-driven adaptive splitting on the unified
    Runtime.  The old per-victim ``mailbox`` (which nothing ever posted to)
    is gone — steal requests live in the engine's single request queue."""

    def __init__(self, p: int, cost: CostModel, *, seed: int = 0,
                 speeds: Optional[List[float]] = None, nano0: int = 1,
                 stop_predicate: Optional[Callable[[Any], Optional[int]]] = None):
        self.p = p
        self.cost = cost
        self._rt = Runtime(p, cost, AdaptivePolicy(nano0=nano0), seed=seed,
                           speeds=speeds, stop_predicate=stop_predicate)

    def run(self, work: Divisible) -> SimResult:
        return self._rt.run(work)


def static_partition_sim(work: Divisible, p: int, cost: CostModel, *,
                         speeds: Optional[List[float]] = None,
                         num_blocks: Optional[int] = None) -> SimResult:
    """Deprecated shim: OpenMP-static baseline on the unified Runtime."""
    rt = Runtime(p, cost, StaticPartitionPolicy(num_blocks=num_blocks),
                 speeds=speeds)
    return rt.run(work)


__all__ = ["CostModel", "SimResult", "WorkStealingSim", "AdaptiveSim",
           "static_partition_sim"]
