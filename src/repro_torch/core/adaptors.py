"""Adaptors controlling task splitting (paper §3.3) — the port's own copy of
``bound_depth`` and ``cap``, the two the serving path uses.

Every adaptor *wraps* a Divisible and overrides the division decision while
delegating everything else; adaptors nest.  Kept line-for-line equal to
``repro.core.adaptors`` where the two overlap.  ``even_levels`` came with
the stable sort, whose plan it shapes.  The other adaptors
(``force_depth``, ``size_limit``, ``join_context``, ``thief_splitting``,
``tagged``) come with the Runtime port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .divisible import Divisible


@dataclasses.dataclass
class StealContext:
    """Signals a dynamic policy may consult when deciding to divide.

    ``stolen``      — True when this task has been migrated to another worker.
    ``demand``      — outstanding parallelism demand (idle workers).
    ``live_tasks``  — currently live (created, unfinished) task count, for cap.
    ``worker``      — executing worker id.
    """

    stolen: bool = False
    demand: int = 0
    live_tasks: int = 0
    worker: int = 0


class Adaptor:
    """Base class: a Divisible wrapping a Divisible."""

    base: Divisible

    def size(self) -> int:
        return self.base.size()

    def should_divide(self, ctx: StealContext) -> bool:
        return self.should_be_divided()

    def should_be_divided(self) -> bool:
        return self.base.should_be_divided()

    def divide(self):
        raise NotImplementedError

    def divide_at(self, index: int):
        raise NotImplementedError

    def unwrap(self) -> Divisible:
        """Peel all adaptors off, returning the underlying work descriptor."""
        b = self.base
        while isinstance(b, Adaptor):
            b = b.base
        return b

    def on_steal(self) -> None:
        """Notify the policy that this task was stolen."""
        if isinstance(self.base, Adaptor):
            self.base.on_steal()

    def on_finish(self) -> None:
        """Notify the policy that this task completed (cap decrements)."""
        if isinstance(self.base, Adaptor):
            self.base.on_finish()


def _rewrap(adaptor: Adaptor, new_base: Divisible, **updates) -> Adaptor:
    return dataclasses.replace(adaptor, base=new_base, **updates)


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


class _SharedCounter:
    __slots__ = ("value",)

    def __init__(self, value: int = 1):
        self.value = value


@dataclasses.dataclass
class Cap(Adaptor):
    """Refuse division when the number of live tasks reaches ``threshold``.

    The counter is shared by every clone produced through division and is
    decremented by :meth:`on_finish`.  ``threshold_fn`` (a zero-arg
    callable) makes the cap live: the effective threshold is
    ``min(threshold, threshold_fn())``.  ``on_event(kind, live)`` is called
    with kind in {"divide", "finish"} and the post-event live count every
    time the shared counter changes.
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


__all__ = ["Adaptor", "StealContext", "BoundDepth",
           "bound_depth", "EvenLevels", "even_levels", "Cap", "cap"]
