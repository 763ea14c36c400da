"""Serving chaos: overload bursts, deadline storms and slot death — the
port's copy of ``repro.chaos.serving``, line for line.

Serving chaos keys off *engine*-step indices and wall-clock arrivals (the
train-side injectors, which key off train-step indices, come with the
train layer).  Three pieces:

* :class:`SlotDeathInjector` — ``on_step`` hook for :func:`replay`: kills
  the planned decode lanes (:class:`~repro_torch.core.faults.SlotDeath`) via the
  engine's ``kill_slot`` chaos hook.  The killed request is requeued at the
  queue front and re-served from scratch; greedy decode is deterministic,
  so in fp32 its final tokens match the undisturbed run exactly (pinned
  by tests/test_torch_chaos.py).
* trace generators — :func:`slo_mix_trace` builds a deterministic
  multi-tenant arrival trace (per-class counts, deadlines, priorities;
  arrival offsets from a seeded RNG).  Scaling ``span_s`` down is the
  overload knob: the same work in a third of the span is a 3× burst.
* :func:`replay` — wall-clock replay of a trace against a live engine:
  submit when due, step while pending, account every request exactly once
  (served / shed / rejected).  ``on_step(step, engine)`` is the chaos
  injection point — the same shape as the trainer's ``on_step`` hook.

Determinism caveat: arrivals and prompts are seed-deterministic, but the
interleaving of admissions with decode ticks is wall-clock dependent — so
serving invariants are *conservation* and *class* properties (every rid
accounted once, shed work 100% batch/background, exact per-request tokens),
never step-exact schedules.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.faults import FaultPlan
from ..serve.engine import QueueFull, Request

# chaos traces avoid token ids colliding with pad (0) / the bench EOS
_PROMPT_LO = 8


@dataclasses.dataclass(frozen=True)
class TraceItem:
    """One planned arrival (pure data; the Request is built at replay)."""

    rid: int
    arrival: float                # seconds from trace start
    prompt_len: int
    max_new: int
    slo: str = "batch"
    priority: int = 0
    deadline_s: Optional[float] = None
    tenant: str = "default"


def make_request(item: TraceItem, vocab: int, seed: int = 0) -> Request:
    """Deterministic request for a trace item (prompt from rid+seed)."""
    rng = np.random.default_rng(1_000_003 * item.rid + seed)
    prompt = rng.integers(_PROMPT_LO, vocab,
                          size=item.prompt_len).astype(np.int32)
    return Request(rid=item.rid, prompt=prompt, max_new=item.max_new,
                   slo=item.slo, priority=item.priority,
                   deadline_s=item.deadline_s, tenant=item.tenant)


def slo_mix_trace(seed: int, *, span_s: float,
                  classes: Dict[str, Dict], start_rid: int = 0
                  ) -> Tuple[TraceItem, ...]:
    """A deterministic multi-tenant trace: ``classes`` maps an SLO class to
    ``dict(n=..., prompt_len=..., max_new=..., deadline_s=..., priority=...,
    tenants=(...))``; each class's ``n`` arrivals land uniformly at random
    (seeded) in ``[0, span_s)`` and tenants round-robin.  Returned sorted
    by arrival — shrink ``span_s`` to turn the same offered work into an
    overload burst."""
    rng = np.random.default_rng(seed)
    items: List[TraceItem] = []
    rid = start_rid
    for slo in sorted(classes):
        spec = classes[slo]
        tenants = spec.get("tenants", ("default",))
        for k in range(spec["n"]):
            items.append(TraceItem(
                rid=rid, arrival=float(rng.uniform(0.0, span_s)),
                prompt_len=spec["prompt_len"], max_new=spec["max_new"],
                slo=slo, priority=spec.get("priority", 0),
                deadline_s=spec.get("deadline_s"),
                tenant=tenants[k % len(tenants)]))
            rid += 1
    return tuple(sorted(items, key=lambda it: (it.arrival, it.rid)))


@dataclasses.dataclass
class ReplayResult:
    served: List[Request]
    shed: List[Request]
    rejected: List[Request]

    @property
    def all_requests(self) -> List[Request]:
        return self.served + self.shed + self.rejected

    def conserved(self, trace: Sequence[TraceItem]) -> bool:
        """Every trace rid accounted for exactly once, nothing invented."""
        seen = [r.rid for r in self.all_requests]
        return sorted(seen) == sorted(it.rid for it in trace) \
            and len(set(seen)) == len(seen)

    def latencies(self, slo: Optional[str] = None) -> List[float]:
        """Submit→done wall seconds (served + shed; a shed request's
        latency is its time-to-drop — the user-visible wait)."""
        return [r.t_done - r.t_submit for r in self.served + self.shed
                if (slo is None or r.slo == slo) and r.t_done is not None]


def replay(engine, trace: Sequence[TraceItem], *, vocab: int,
           seed: int = 0,
           on_step: Optional[Callable[[int, object], None]] = None,
           max_wall_s: float = 300.0) -> ReplayResult:
    """Replay a trace against a live engine in wall-clock time: submit each
    item once its arrival passes, step while the engine has work, inject
    chaos via ``on_step``.  Every submission ends up in exactly one of
    served / shed / rejected."""
    items = sorted(trace, key=lambda it: (it.arrival, it.rid))
    served: List[Request] = []
    shed: List[Request] = []
    rejected: List[Request] = []
    i, step = 0, 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        while i < len(items) and items[i].arrival <= now:
            r = make_request(items[i], vocab, seed)
            i += 1
            try:
                engine.submit(r)
            except QueueFull:
                rejected.append(r)
        if engine.pending:
            for r in engine.step():
                (shed if r.shed else served).append(r)
            if on_step is not None:
                on_step(step, engine)
            step += 1
        elif i < len(items):
            time.sleep(min(0.0005, max(0.0, items[i].arrival - now)))
        else:
            break
        if now > max_wall_s:
            raise TimeoutError(
                f"replay exceeded {max_wall_s}s with {len(items) - i} "
                f"arrivals outstanding")
    return ReplayResult(served=served, shed=shed, rejected=rejected)


class SlotDeathInjector:
    """``on_step`` hook for :func:`replay`: kill the planned decode lanes.

    A planned death whose lane is empty at the step fires as a no-op (the
    plan is index-driven, the lane assignment is wall-clock dependent);
    ``killed`` records the (step, slot) pairs that actually hit."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.killed: List[Tuple[int, int]] = []

    def __call__(self, step: int, engine) -> None:
        for sd in self.plan.slot_deaths_at(step):
            if engine.kill_slot(sd.slot):
                self.killed.append((step, sd.slot))


__all__ = [
    "TraceItem", "ReplayResult", "SlotDeathInjector", "make_request",
    "slo_mix_trace", "replay",
]
