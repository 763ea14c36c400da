"""Plans: the static artifact a scheduling policy produces — the port's own
copy of ``PlanNode``, ``Plan``, ``build_plan``, ``demand_split`` and
``geometric_blocks``.  The sort schedules (``SortSchedule``, merge levels,
digit passes) come with the stable-sort port.

``build_plan`` is the static analogue of the join scheduler's divide phase;
``demand_split`` that of the adaptive scheduler (split only while demand
remains); ``geometric_blocks`` is the by_blocks size sequence.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

from .adaptors import Adaptor, StealContext
from .divisible import Divisible


@dataclasses.dataclass
class PlanNode:
    """A node of the division tree.  Leaves carry the work descriptor."""

    work: Optional[Divisible]
    left: Optional["PlanNode"] = None
    right: Optional["PlanNode"] = None
    depth: int = 0

    @property
    def is_leaf(self) -> bool:
        return self.left is None and self.right is None

    def leaves(self) -> Iterator["PlanNode"]:
        if self.is_leaf:
            yield self
        else:
            yield from self.left.leaves()
            yield from self.right.leaves()


def _underlying(work: Divisible) -> Divisible:
    return work.unwrap() if isinstance(work, Adaptor) else work


@dataclasses.dataclass
class Plan:
    """A completed division tree plus bookkeeping counters."""

    root: PlanNode
    divisions: int = 0

    def leaves(self) -> List[Divisible]:
        return [_underlying(n.work) for n in self.root.leaves()]

    def leaf_nodes(self) -> List[PlanNode]:
        return list(self.root.leaves())

    def num_tasks(self) -> int:
        return len(self.leaf_nodes())

    def depth(self) -> int:
        return max((n.depth for n in self.root.leaves()), default=0)

    def leaf_sizes(self) -> List[int]:
        return [w.size() for w in self.leaves()]

    def map_reduce(self, map_fn: Callable[[Divisible], Any],
                   reduce_fn: Callable[[Any, Any], Any]) -> Any:
        """The plan's symmetric map/tree-reduce (paper §2.3.2)."""
        def go(node: PlanNode) -> Any:
            if node.is_leaf:
                return map_fn(_underlying(node.work))
            return reduce_fn(go(node.left), go(node.right))
        return go(self.root)


def build_plan(work: Divisible, *, ctx: Optional[StealContext] = None,
               max_tasks: int = 1 << 16) -> Plan:
    """Divide while the policy agrees — the static join-scheduler divide
    phase (left eagerly, right deferred)."""
    ctx = ctx or StealContext()
    divisions = 0

    def should(w: Divisible) -> bool:
        if isinstance(w, Adaptor):
            return w.should_divide(ctx)
        return w.should_be_divided()

    def go(w: Divisible, depth: int) -> PlanNode:
        nonlocal divisions
        if divisions + 1 >= max_tasks or not should(w):
            return PlanNode(work=w, depth=depth)
        l, r = w.divide()
        divisions += 1
        node = PlanNode(work=None, depth=depth)
        node.left = go(l, depth + 1)
        node.right = go(r, depth + 1)
        return node

    root = go(work, 0)
    return Plan(root=root, divisions=divisions)


def demand_split(work: Divisible, demand: int) -> Plan:
    """Adaptive-schedule analogue: exactly ``min(demand, size)`` leaves with
    the minimal number of divisions, splitting the largest part first."""
    demand = max(1, min(demand, max(1, work.size())))
    counter = 0
    heap: list[tuple[int, int, Divisible]] = [(-work.size(), counter, work)]
    divisions = 0
    while len(heap) < demand:
        size, _, biggest = heapq.heappop(heap)
        if -size <= 1 or not biggest.size() > 1:
            heapq.heappush(heap, (size, counter, biggest))
            break
        l, r = biggest.divide()
        divisions += 1
        counter += 1
        heapq.heappush(heap, (-l.size(), counter, l))
        counter += 1
        heapq.heappush(heap, (-r.size(), counter, r))
    parts = [w for _, _, w in sorted(heap, key=lambda t: _sort_key(t[2]))]
    nodes = [PlanNode(work=p, depth=1) for p in parts]
    root = nodes[0] if len(nodes) == 1 else _balanced_tree(nodes)
    return Plan(root=root, divisions=divisions)


def _sort_key(w: Divisible):
    return getattr(_underlying(w), "start", 0)


def _balanced_tree(nodes: Sequence[PlanNode]) -> PlanNode:
    if len(nodes) == 1:
        return nodes[0]
    mid = len(nodes) // 2
    n = PlanNode(work=None)
    n.left = _balanced_tree(nodes[:mid])
    n.right = _balanced_tree(nodes[mid:])
    return n


def geometric_blocks(total: int, *, first: int, growth: float = 2.0,
                     align: int = 1, cap: Optional[int] = None
                     ) -> List[Tuple[int, int]]:
    """The by_blocks size sequence (paper §3.5): geometric block sizes, so
    #blocks is O(log n) and wasted work ≤ growth/(1+growth).  Returns
    [start, stop) pairs covering [0, total); ``align`` snaps block
    boundaries, ``cap`` bounds block size."""
    out: List[Tuple[int, int]] = []
    pos = 0
    size = max(1, first)
    while pos < total:
        step = min(size, total - pos)
        if align > 1 and pos + step < total:
            step = max(align, (step // align) * align)
        stop = min(total, pos + step)
        out.append((pos, stop))
        pos = stop
        size = int(size * growth)
        if cap is not None:
            size = min(size, cap)
    return out


__all__ = ["Plan", "PlanNode", "build_plan", "demand_split",
           "geometric_blocks"]
