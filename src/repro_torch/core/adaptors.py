"""Adaptors controlling task splitting (paper §3.3).

Every adaptor *wraps* a :class:`~repro_torch.core.divisible.Divisible` and overrides
the division decision while delegating everything else.  Adaptors nest, giving
the composability that is Kvik's central claim::

    work = thief_splitting(bound_depth(BatchWork(0, 256), 5), p=16)

The seven adaptors from the paper are reproduced with their exact semantics:

* :func:`bound_depth`       — stop dividing past a depth limit.
* :func:`even_levels`       — force all leaves onto an even depth (the merge
                              sort uses this so data lands in the right buffer).
* :func:`force_depth`       — the division tree is complete to at least depth d.
* :func:`size_limit`        — stop dividing below a size threshold (the classic
                              "sequential fallback" knob the paper's policies
                              make unnecessary — provided for comparison).
* :func:`cap`               — refuse division while ≥ threshold tasks are live
                              (dynamic: exact under the simruntime; at plan time
                              the live-leaf count is used).
* :func:`join_context`      — divide to a depth; left children always divide,
                              right children only when stolen.
* :func:`thief_splitting`   — the TBB/Rayon counter policy (paper §2.1): halve
                              a counter on division, stop at zero, reset when
                              stolen.

Dynamic policies (``cap``, ``join_context``, ``thief_splitting``, and the
adaptive schedule) consult a :class:`StealContext`.  Under the simulated
work-stealing runtime the context reports *real* (virtual-time) steal events;
under the static plan builder it reports "demand" — how much parallelism the
target still wants — which is the plan-time analogue of a steal request
(division happens only when the hardware demands it).  Kept line for line
equal to ``repro.core.adaptors``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

from .divisible import Divisible


# ---------------------------------------------------------------------------
# Steal context: runtime signals threaded through dynamic policies
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StealContext:
    """Signals a dynamic policy may consult when deciding to divide.

    ``stolen``      — True when this task has been migrated to another worker
                      since its creation (resets thief_splitting's counter).
    ``demand``      — outstanding parallelism demand (idle workers / unfilled
                      device slots).  The static plan builder sets this from
                      the target's width; the simruntime sets it from actually
                      idle workers.
    ``live_tasks``  — currently live (created, unfinished) task count, for cap.
    ``worker``      — executing worker id (thief_splitting compares the task's
                      creator against it).
    """

    stolen: bool = False
    demand: int = 0
    live_tasks: int = 0
    worker: int = 0


NULL_CONTEXT = StealContext()


class Adaptor:
    """Base class: a Divisible wrapping a Divisible."""

    base: Divisible

    def size(self) -> int:
        return self.base.size()

    # Division decisions may consult the StealContext.  ``should_be_divided``
    # keeps Kvik's exact signature; context-aware callers use
    # ``should_divide(ctx)``.
    def should_divide(self, ctx: StealContext) -> bool:
        return self.should_be_divided()

    def should_be_divided(self) -> bool:
        return self.base.should_be_divided()

    def divide(self):
        raise NotImplementedError

    def divide_at(self, index: int):
        raise NotImplementedError

    # Producer pass-through (present iff the base has it)
    def partial_fold(self, state, fold_op, limit):
        return self.base.partial_fold(state, fold_op, limit)  # type: ignore

    def unwrap(self) -> Divisible:
        """Peel all adaptors off, returning the underlying work descriptor."""
        b = self.base
        while isinstance(b, Adaptor):
            b = b.base
        return b

    def on_steal(self) -> None:
        """Notify the policy that this task was stolen (simruntime hook)."""
        if isinstance(self.base, Adaptor):
            self.base.on_steal()

    def on_finish(self) -> None:
        """Notify the policy that this task completed (cap decrements)."""
        if isinstance(self.base, Adaptor):
            self.base.on_finish()


def _rewrap(adaptor: Adaptor, new_base: Divisible, **updates) -> Adaptor:
    child = dataclasses.replace(adaptor, base=new_base, **updates)
    return child


# ---------------------------------------------------------------------------
# bound_depth
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BoundDepth(Adaptor):
    """Stop dividing once ``depth`` divisions have happened above us."""

    base: Divisible
    limit: int
    depth: int = 0

    def should_be_divided(self) -> bool:
        return self.depth < self.limit and self.base.should_be_divided()

    def should_divide(self, ctx: StealContext) -> bool:
        if self.depth >= self.limit:
            return False
        if isinstance(self.base, Adaptor):
            return self.base.should_divide(ctx)
        return self.base.should_be_divided()

    def _split(self, parts):
        l, r = parts
        return (_rewrap(self, l, depth=self.depth + 1),
                _rewrap(self, r, depth=self.depth + 1))

    def divide(self):
        return self._split(self.base.divide())

    def divide_at(self, index):
        return self._split(self.base.divide_at(index))


def bound_depth(base: Divisible, limit: int) -> BoundDepth:
    return BoundDepth(base, limit)


# ---------------------------------------------------------------------------
# even_levels
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EvenLevels(Adaptor):
    """All leaves end on an even depth level (flip a boolean per division)."""

    base: Divisible
    even: bool = True

    def should_be_divided(self) -> bool:
        # If we are on an odd level we *must* divide once more to get back to
        # an even level, whatever the base says.
        return (not self.even) or self.base.should_be_divided()

    def should_divide(self, ctx: StealContext) -> bool:
        if not self.even:
            return True
        if isinstance(self.base, Adaptor):
            return self.base.should_divide(ctx)
        return self.base.should_be_divided()

    def _split(self, parts):
        l, r = parts
        return (_rewrap(self, l, even=not self.even),
                _rewrap(self, r, even=not self.even))

    def divide(self):
        return self._split(self.base.divide())

    def divide_at(self, index):
        return self._split(self.base.divide_at(index))


def even_levels(base: Divisible) -> EvenLevels:
    return EvenLevels(base)


# ---------------------------------------------------------------------------
# force_depth
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ForceDepth(Adaptor):
    """Complete division tree for at least ``limit`` levels."""

    base: Divisible
    limit: int
    depth: int = 0

    def should_be_divided(self) -> bool:
        return self.depth < self.limit or self.base.should_be_divided()

    def should_divide(self, ctx: StealContext) -> bool:
        if self.depth < self.limit:
            return True
        if isinstance(self.base, Adaptor):
            return self.base.should_divide(ctx)
        return self.base.should_be_divided()

    def _split(self, parts):
        l, r = parts
        return (_rewrap(self, l, depth=self.depth + 1),
                _rewrap(self, r, depth=self.depth + 1))

    def divide(self):
        return self._split(self.base.divide())

    def divide_at(self, index):
        return self._split(self.base.divide_at(index))


def force_depth(base: Divisible, limit: int) -> ForceDepth:
    return ForceDepth(base, limit)


# ---------------------------------------------------------------------------
# size_limit
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SizeLimit(Adaptor):
    """Stop dividing when the underlying producer is ≤ ``limit`` items."""

    base: Divisible
    limit: int

    def should_be_divided(self) -> bool:
        return self.base.size() > self.limit and self.base.should_be_divided()

    def should_divide(self, ctx: StealContext) -> bool:
        if self.base.size() <= self.limit:
            return False
        if isinstance(self.base, Adaptor):
            return self.base.should_divide(ctx)
        return self.base.should_be_divided()

    def _split(self, parts):
        l, r = parts
        return (_rewrap(self, l), _rewrap(self, r))

    def divide(self):
        return self._split(self.base.divide())

    def divide_at(self, index):
        return self._split(self.base.divide_at(index))


def size_limit(base: Divisible, limit: int) -> SizeLimit:
    return SizeLimit(base, limit)


# ---------------------------------------------------------------------------
# cap — live-task counter shared across the whole tree
# ---------------------------------------------------------------------------

class _SharedCounter:
    __slots__ = ("value",)

    def __init__(self, value: int = 1):
        self.value = value


@dataclasses.dataclass
class Cap(Adaptor):
    """Refuse division when the number of live tasks reaches ``threshold``.

    The counter is shared by every clone produced through division and is
    decremented by :meth:`on_finish` — matching the paper: "counts the active
    number of tasks and refuses division when the number reaches a threshold.
    This also decrements the counter as the tasks finish."

    Two optional hooks make the cap *live* (the serving engine's admission
    control drives both; defaults keep the paper semantics bit-identical):

    * ``threshold_fn`` — a zero-arg callable consulted on every division
      decision; the effective threshold is ``min(threshold, threshold_fn())``,
      so external telemetry (cache headroom, measured decode cost) can shrink
      the cap below its static ceiling without rebuilding the adaptor stack.
    * ``on_event`` — called as ``on_event(kind, live)`` with kind in
      {"divide", "finish"} and the post-event live-task count, every time the
      shared counter changes.  Clones share the hook, so one observer sees
      the whole tree.
    """

    base: Divisible
    threshold: int
    counter: _SharedCounter = dataclasses.field(default_factory=_SharedCounter)
    threshold_fn: Optional[Any] = None
    on_event: Optional[Any] = None

    def live_threshold(self) -> int:
        if self.threshold_fn is None:
            return self.threshold
        return min(self.threshold, max(1, int(self.threshold_fn())))

    def _notify(self, kind: str) -> None:
        if self.on_event is not None:
            self.on_event(kind, self.counter.value)

    def should_be_divided(self) -> bool:
        return (self.counter.value < self.live_threshold()
                and self.base.should_be_divided())

    def should_divide(self, ctx: StealContext) -> bool:
        if self.counter.value >= self.live_threshold():
            return False
        if isinstance(self.base, Adaptor):
            return self.base.should_divide(ctx)
        return self.base.should_be_divided()

    def _split(self, parts):
        self.counter.value += 1  # one task became two
        self._notify("divide")
        l, r = parts
        return (_rewrap(self, l, counter=self.counter),
                _rewrap(self, r, counter=self.counter))

    def divide(self):
        return self._split(self.base.divide())

    def divide_at(self, index):
        return self._split(self.base.divide_at(index))

    def on_finish(self) -> None:
        self.counter.value = max(0, self.counter.value - 1)
        self._notify("finish")
        super().on_finish()


def cap(base: Divisible, threshold: int) -> Cap:
    return Cap(base, threshold)


# ---------------------------------------------------------------------------
# tagged — SLO metadata riding the adaptor stack (priority / deadline / tenant)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Tagged(Adaptor):
    """Attach scheduling metadata to a work descriptor without changing any
    division decision: ``priority`` (higher = more urgent), an absolute
    virtual-time ``deadline``, and a ``tenant`` label for accounting.

    Both children of a division inherit the tag, so an adaptor stack like
    ``cap(tagged(WorkRange(0, n), priority=2), 3)`` keeps its SLO identity
    through arbitrary splitting.  :class:`~repro_torch.core.policies.PriorityPolicy`
    and :class:`~repro_torch.core.policies.DeadlinePolicy` order their shared pool
    by these fields; every other policy ignores them (the tag delegates all
    Divisible decisions to its base), so tagging work is always safe.
    """

    base: Divisible
    priority: int = 0
    deadline: Optional[float] = None
    tenant: str = "default"

    def should_divide(self, ctx: StealContext) -> bool:
        if isinstance(self.base, Adaptor):
            return self.base.should_divide(ctx)
        return self.base.should_be_divided()

    def _split(self, parts):
        l, r = parts
        return (_rewrap(self, l), _rewrap(self, r))

    def divide(self):
        return self._split(self.base.divide())

    def divide_at(self, index):
        return self._split(self.base.divide_at(index))


def tagged(base: Divisible, *, priority: int = 0,
           deadline: Optional[float] = None,
           tenant: str = "default") -> Tagged:
    return Tagged(base, priority=priority, deadline=deadline, tenant=tenant)


def find_tag(w: Divisible) -> Optional[Tagged]:
    """First :class:`Tagged` in an adaptor stack (None if the work carries
    no tag) — how the SLO policies read priority/deadline through any
    wrapping, e.g. ``cap(tagged(...), k)`` or ``tagged(size_limit(...))``."""
    while isinstance(w, Adaptor):
        if isinstance(w, Tagged):
            return w
        w = w.base
    return None


# ---------------------------------------------------------------------------
# join_context_policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JoinContext(Adaptor):
    """Divide to ``limit`` depth; left children always divide, right children
    only when stolen (paper §3.3 ``join_context_policy``)."""

    base: Divisible
    limit: int
    depth: int = 0
    is_right: bool = False
    stolen: bool = False

    def should_be_divided(self) -> bool:
        return self.should_divide(NULL_CONTEXT)

    def should_divide(self, ctx: StealContext) -> bool:
        if self.depth >= self.limit:
            return False
        if not self.base.should_be_divided():
            return False
        if self.is_right and not (self.stolen or ctx.stolen):
            return False
        return True

    def _split(self, parts):
        l, r = parts
        return (_rewrap(self, l, depth=self.depth + 1, is_right=False,
                        stolen=False),
                _rewrap(self, r, depth=self.depth + 1, is_right=True,
                        stolen=False))

    def divide(self):
        return self._split(self.base.divide())

    def divide_at(self, index):
        return self._split(self.base.divide_at(index))

    def on_steal(self) -> None:
        self.stolen = True
        super().on_steal()


def join_context(base: Divisible, limit: int) -> JoinContext:
    return JoinContext(base, limit)


# ---------------------------------------------------------------------------
# thief_splitting — the TBB / Rayon policy (paper §2.1, §3.3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ThiefSplitting(Adaptor):
    """TBB/Rayon counter policy:

    1. start with a counter and the creator's worker id;
    2. on division the counter decreases by one, children copy the creator id;
    3. at zero, refuse division **unless** the executing worker differs from
       the creator (i.e. the task was stolen);
    4. on steal, reset the counter to its initial value.

    With ``counter = log2(p)+1`` and balanced work this creates O(p) tasks
    (validated by tests/test_simruntime.py against the simulated runtime).
    """

    base: Divisible
    init: int
    counter: Optional[int] = None
    creator: int = 0

    def __post_init__(self):
        if self.counter is None:
            self.counter = self.init

    def should_be_divided(self) -> bool:
        return self.counter > 0 and self.base.should_be_divided()

    def should_divide(self, ctx: StealContext) -> bool:
        if not self.base.should_be_divided():
            return False
        if self.counter > 0:
            return True
        # counter exhausted: divide anyway if we've been migrated
        return ctx.stolen or (ctx.worker != self.creator)

    def _split(self, parts, ctx: StealContext):
        new_counter = self.init if (ctx.stolen or ctx.worker != self.creator) \
            else self.counter - 1
        l, r = parts
        return (_rewrap(self, l, counter=new_counter, creator=ctx.worker),
                _rewrap(self, r, counter=new_counter, creator=ctx.worker))

    def divide(self):
        return self._split(self.base.divide(), NULL_CONTEXT)

    def divide_at(self, index):
        return self._split(self.base.divide_at(index), NULL_CONTEXT)

    def divide_ctx(self, ctx: StealContext):
        return self._split(self.base.divide(), ctx)

    def on_steal(self) -> None:
        self.counter = self.init
        super().on_steal()


def thief_splitting(base: Divisible, p: int, init: Optional[int] = None
                    ) -> ThiefSplitting:
    """Rayon's default counter is ``log2(p) + 1`` (forces ~2p tasks); Kvik lets
    the programmer pick — so do we."""
    if init is None:
        init = int(math.log2(max(2, p))) + 1
    return ThiefSplitting(base, init)


__all__ = [
    "Adaptor", "StealContext", "NULL_CONTEXT",
    "BoundDepth", "bound_depth", "EvenLevels", "even_levels",
    "ForceDepth", "force_depth", "SizeLimit", "size_limit",
    "Cap", "cap", "JoinContext", "join_context",
    "ThiefSplitting", "thief_splitting",
    "Tagged", "tagged", "find_tag",
]
