"""SLO classes and serve-side scheduling policies — the port's own copy of
``repro.serve.slo`` (plain Python).

Serving maps the core policy layer onto wall-clock traffic: an SLO *class*
(``interactive`` / ``batch`` / ``background``) is the serving analogue of a
``Tagged`` priority band, and a serve policy is the queue-ordering half of
the ``PriorityPolicy`` / ``DeadlinePolicy`` schedulers — it decides which
waiting request the engine's admission path considers first.  The
*mechanism* (per-class ``cap`` adaptors, page accounting, the single
in-flight prefill) stays in :class:`~repro_torch.serve.engine.
ContinuousEngine`; a policy is pure decision, so it can be hot-swapped on a
live engine (:meth:`ContinuousEngine.set_policy`): in-flight slots drain
under the old ordering, new admissions follow the new one, and per-request
token streams are untouched either way.

``preempt_classes`` additionally arms the engine's batch-prefill preemption:
when an interactive request is waiting and the in-flight chunked prefill
belongs to a lower class, the job is parked at the next by_blocks block
boundary (its cache and position are already consistent — the residual is
exactly the unprocessed suffix) and resumed after the interactive admission.
"""

from __future__ import annotations

import math
from typing import List, Sequence

SLO_CLASSES = ("interactive", "batch", "background")
CLASS_RANK = {c: i for i, c in enumerate(SLO_CLASSES)}


def request_deadline(req, default: float = math.inf) -> float:
    """Absolute wall-clock deadline of a request (inf if undated)."""
    if req.deadline_s is None or req.t_submit is None:
        return default
    return req.t_submit + req.deadline_s


class ServePolicy:
    """Queue-ordering policy: ``order`` returns candidate queue indices in
    the order the engine should try to admit them.  FIFO base class."""

    name = "fifo"
    preempt_classes = False       # park batch-class prefill for interactive?

    def order(self, queue: Sequence, now: float) -> List[int]:
        return list(range(len(queue)))


class FifoServePolicy(ServePolicy):
    """Strict arrival order, and the shedding baseline:
    every class waits behind every other class."""


class PriorityServePolicy(ServePolicy):
    """Class-ranked admission: interactive before batch before background;
    within a class higher ``priority`` first, then earliest deadline, then
    arrival order.  Arms batch-prefill preemption."""

    name = "priority"
    preempt_classes = True

    def order(self, queue: Sequence, now: float) -> List[int]:
        def key(i):
            r = queue[i]
            return (CLASS_RANK.get(r.slo, len(SLO_CLASSES)), -r.priority,
                    request_deadline(r), i)
        return sorted(range(len(queue)), key=key)


class DeadlineServePolicy(ServePolicy):
    """Pure EDF across classes: earliest absolute deadline first, undated
    work last, arrival order as the tiebreak."""

    name = "deadline"

    def order(self, queue: Sequence, now: float) -> List[int]:
        return sorted(range(len(queue)),
                      key=lambda i: (request_deadline(queue[i]), i))


__all__ = [
    "SLO_CLASSES", "CLASS_RANK", "request_deadline", "ServePolicy",
    "FifoServePolicy", "PriorityServePolicy", "DeadlineServePolicy",
]
