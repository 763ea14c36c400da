"""Deterministic fault injection — failures as first-class discrete events.

The robustness claims this framework inherits from the paper (by_blocks
exists "for interruptible computations", adaptive recovers imbalance via
steal-linked splitting) are scheduling claims, so faults are modelled where
scheduling lives: as events in the unified virtual-time Runtime
(:mod:`repro_torch.core.runtime`) and as injection points in the production wiring
(:mod:`repro_torch.chaos`).  One :class:`FaultPlan` describes both layers:

* **virtual-time events**, consumed by the Runtime —
  :class:`WorkerDeath` (a worker stops at virtual time ``at``; its queued
  tasks and in-flight residual re-enter the steal pool, the partially
  executed grant is *lost*) and :class:`Slowdown` (a worker's speed is
  scaled by ``factor`` over ``[start, stop)``);
* **wall-clock / step-indexed events**, consumed by the chaos harness —
  :class:`CheckpointWriteFault` (the k-th checkpoint leaf/manifest write
  raises), :class:`CorruptionFault` (bytes of a saved leaf or the manifest
  are flipped), :class:`PreemptionFault` (SIGTERM delivered at train step
  k), :class:`HostDeath` (a host's devices vanish at step k — the mesh8
  kill-a-host scenario).

Determinism: a FaultPlan is pure data.  The Runtime consumes it with the
same seeded RNG discipline as victim selection, so (work, policy, p, cost,
seed, plan) → bit-identical :class:`~repro_torch.core.runtime.SimResult`,
including death times, lost-item counts and recovery steals.
:meth:`FaultPlan.random` derives event times from its own
``random.Random(seed)`` stream so randomized chaos sweeps are replayable
from a single integer.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# virtual-time events (Runtime)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkerDeath:
    """Worker ``worker`` dies at virtual time ``at`` (absolute — measured
    from the start of :meth:`Runtime.run`, across by_blocks regions).

    Semantics (see chaos/DESIGN.md): the death takes effect at the worker's
    next event at or after ``at``; a leaf/grant in flight across ``at`` is
    truncated there — items executed before the cut are **lost** (their fold
    state died with the worker) and the task's full remaining extent
    re-enters the steal pool as an orphan."""

    worker: int
    at: float


@dataclasses.dataclass(frozen=True)
class Slowdown:
    """Worker ``worker`` runs at ``factor`` × its base speed over virtual
    time ``[start, stop)``.  Applied at event granularity: a grant charged
    entirely inside the window sees the factor; one spanning a boundary is
    charged at the speed in force when it started."""

    worker: int
    start: float
    stop: float
    factor: float


# ---------------------------------------------------------------------------
# step-indexed / IO events (chaos harness, train + serve layers)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CheckpointWriteFault:
    """The ``on_write``-th checkpoint write *attempt* (1-based, counted
    across the manager's lifetime) raises ``OSError`` — exercising the
    retry-with-backoff path of the train layer's checkpoint manager."""

    on_write: int


@dataclasses.dataclass(frozen=True)
class CorruptionFault:
    """Corrupt the saved checkpoint of ``step``: ``target="leaf"`` flips
    bytes of ``arr_<leaf_index>.npy``; ``target="manifest"`` truncates
    manifest.json.  Restore must fail loudly (per-leaf sha256)."""

    step: int
    target: str = "leaf"          # "leaf" | "manifest"
    leaf_index: int = 0


@dataclasses.dataclass(frozen=True)
class PreemptionFault:
    """Deliver SIGTERM to the training process at step ``at_step`` — the
    trainer's signal flag fires at the step boundary (the by_blocks
    interruption point) and the loop exits through a final checkpoint."""

    at_step: int


@dataclasses.dataclass(frozen=True)
class SlotDeath:
    """Decode slot ``slot`` of a :class:`~repro_torch.serve.engine.ContinuousEngine`
    dies at engine step ``at_step`` — its lane state (tokens emitted so far,
    KV pages, length counters) is discarded and the in-flight request is
    requeued at the *front* of the waiting queue, to be re-served from
    scratch exactly once."""

    at_step: int
    slot: int


@dataclasses.dataclass(frozen=True)
class HostDeath:
    """Host ``host`` (a contiguous block of ``devices_per_host`` devices)
    dies at train step ``at_step`` — the in-flight step is lost, survivors
    re-mesh and resume from the last checkpoint."""

    host: int
    at_step: int
    devices_per_host: int = 4


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of faults for one run (both layers)."""

    seed: int = 0
    deaths: Tuple[WorkerDeath, ...] = ()
    slowdowns: Tuple[Slowdown, ...] = ()
    checkpoint_faults: Tuple[CheckpointWriteFault, ...] = ()
    corruptions: Tuple[CorruptionFault, ...] = ()
    preemptions: Tuple[PreemptionFault, ...] = ()
    host_deaths: Tuple[HostDeath, ...] = ()
    slot_deaths: Tuple[SlotDeath, ...] = ()

    # ---- Runtime-facing queries -------------------------------------------
    def death_time(self, worker: int) -> Optional[float]:
        """Earliest scheduled death of ``worker`` (None if it survives)."""
        times = [d.at for d in self.deaths if d.worker == worker]
        return min(times) if times else None

    def speed_factor(self, worker: int, t: float) -> float:
        """Product of slowdown factors in force for ``worker`` at time t."""
        f = 1.0
        for s in self.slowdowns:
            if s.worker == worker and s.start <= t < s.stop:
                f *= s.factor
        return f

    def has_runtime_events(self) -> bool:
        return bool(self.deaths or self.slowdowns)

    # ---- chaos-harness queries --------------------------------------------
    def checkpoint_write_fails(self, write_index: int) -> bool:
        return any(f.on_write == write_index for f in self.checkpoint_faults)

    def preempt_at(self, step: int) -> bool:
        return any(p.at_step == step for p in self.preemptions)

    def host_death_at(self, step: int) -> Optional[HostDeath]:
        for h in self.host_deaths:
            if h.at_step == step:
                return h
        return None

    def slot_deaths_at(self, step: int) -> Tuple[SlotDeath, ...]:
        return tuple(s for s in self.slot_deaths if s.at_step == step)

    # ---- constructors ------------------------------------------------------
    @classmethod
    def random(cls, seed: int, *, p: int, horizon: float,
               n_deaths: int = 1, n_slowdowns: int = 0,
               slow_factor: float = 0.5) -> "FaultPlan":
        """Seeded random plan: ``n_deaths`` distinct workers die at uniform
        times in (0.1, 0.9)·horizon; ``n_slowdowns`` further workers slow to
        ``slow_factor`` over a random sub-interval.  Same seed ⇒ same plan."""
        rng = random.Random(seed)
        victims = rng.sample(range(p), min(p - 1, n_deaths + n_slowdowns))
        deaths = tuple(
            WorkerDeath(w, rng.uniform(0.1, 0.9) * horizon)
            for w in victims[:n_deaths])
        slows = []
        for w in victims[n_deaths:]:
            a = rng.uniform(0.0, 0.5) * horizon
            b = a + rng.uniform(0.2, 0.5) * horizon
            slows.append(Slowdown(w, a, b, slow_factor))
        return cls(seed=seed, deaths=deaths, slowdowns=tuple(slows))


__all__ = [
    "FaultPlan", "WorkerDeath", "Slowdown", "CheckpointWriteFault",
    "CorruptionFault", "PreemptionFault", "HostDeath", "SlotDeath",
]
