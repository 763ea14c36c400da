"""Plans: the static artifact a scheduling policy produces — the port's own
copy of ``PlanNode``, ``Plan``, ``build_plan``, ``demand_split`` and
``geometric_blocks``, and of the stable sort's schedule metadata
(``DigitPass``, ``digit_passes``, ``SortSchedule``, ``MergeLevel``,
``Plan.levels`` / ``merge_schedule`` / ``sort_schedule``), line for line
with ``repro.core.plan``.  The sort (``kernels/merge_sort.py``) is driven by
this schedule; the kernels do not re-derive it.

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

    def span(self) -> Tuple[int, int]:
        """[start, stop) covered by this subtree, from the leaves' work
        descriptors (requires range-like work: ``start``/``stop``)."""
        if self.is_leaf:
            w = _underlying(self.work)
            return (w.start, w.stop)
        ls, _ = self.left.span()
        _, rs = self.right.span()
        return (ls, rs)


def _underlying(work: Divisible) -> Divisible:
    return work.unwrap() if isinstance(work, Adaptor) else work


@dataclasses.dataclass(frozen=True)
class DigitPass:
    """One LSD radix digit pass of a tile-sort phase: rank (and stably
    permute) by the ``bits``-wide digit at ``shift``.  Pure metadata — the
    kernel layer turns a tuple of these into one in-kernel pass loop."""

    shift: int
    bits: int

    @property
    def radix(self) -> int:
        return 1 << self.bits


#: launches one multi-tile digit pass costs: local rank/sort, the
#: cross-tile carry scan of the histogram matrix, and the global scatter.
MULTI_TILE_LAUNCHES_PER_PASS = 3


@dataclasses.dataclass(frozen=True)
class SortSchedule:
    """A complete sort schedule: the tile-sort phase as LSD digit passes
    plus either the level-synchronous merge schedule (``mode="merge"``) or
    the multi-tile pass structure (``mode="multi_tile"``).

    ``key_shift`` is the bit position of the sort key inside the packed
    word (bits below it are tie-order-free: for the fused pack path they
    hold the in-tile position — and for the multi-tile path the global
    index — which LSD stability preserves without ranking; that is why
    ``tile_passes`` covers only ``sort_bits`` key bits rather than the
    full packed width).

    In ``multi_tile`` mode there are no merge levels: every digit pass is
    *global* (per-tile histogram + stable local rank, an exclusive scan
    across the ``(num_tiles × radix)`` histogram matrix, a scatter to
    global rank), so the launch count is
    ``MULTI_TILE_LAUNCHES_PER_PASS · num_passes`` — independent of ``n``,
    versus the merge tree's ``1 + log2(n/tile)``."""

    tile_passes: Tuple[DigitPass, ...]
    levels: Tuple["MergeLevel", ...]
    key_shift: int = 0
    mode: str = "merge"          # "merge" | "multi_tile"
    num_tiles: int = 1

    def __post_init__(self):
        if self.mode not in ("merge", "multi_tile"):
            raise ValueError(f"unknown sort schedule mode {self.mode!r}")
        if self.mode == "multi_tile" and self.levels:
            raise ValueError("multi_tile schedules have no merge levels — "
                             "every digit pass is already global")

    @property
    def num_passes(self) -> int:
        return len(self.tile_passes)

    @property
    def num_launches(self) -> int:
        """Kernel launches when executed fused.  ``merge``: one tile-sort
        launch (all digit passes run in-kernel) plus one per merge level.
        ``multi_tile``: rank + carry-scan + scatter per digit pass, with a
        single-tile input degenerating to the one-launch fused tile sort."""
        if self.mode == "multi_tile":
            if self.num_tiles <= 1:
                return 1
            return MULTI_TILE_LAUNCHES_PER_PASS * self.num_passes
        return 1 + len(self.levels)


def digit_passes(sort_bits: int, digit_bits: int, *,
                 key_shift: int = 0) -> Tuple[DigitPass, ...]:
    """The LSD pass list covering ``sort_bits`` key bits in ``digit_bits``
    chunks: ``ceil(sort_bits / digit_bits)`` passes, the last one narrower
    when ``digit_bits`` does not divide ``sort_bits``."""
    if sort_bits <= 0:
        return ()
    if digit_bits <= 0:
        raise ValueError(f"digit_bits must be positive, got {digit_bits}")
    out = []
    for lo in range(0, sort_bits, digit_bits):
        out.append(DigitPass(shift=key_shift + lo,
                             bits=min(digit_bits, sort_bits - lo)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MergeLevel:
    """One level of a level-synchronous reduction schedule.

    ``pairs`` lists, for every merge happening at this level, the half-open
    spans of its left and right operands: ``((a_start, a_stop),
    (b_start, b_stop))``.  A *uniform* level (equal-length, adjacent,
    contiguous pairs — what a balanced power-of-two sort plan produces) can
    drive a single fixed-block kernel launch over every pair.
    """

    pairs: Tuple[Tuple[Tuple[int, int], Tuple[int, int]], ...]

    @property
    def num_pairs(self) -> int:
        return len(self.pairs)

    @property
    def uniform(self) -> bool:
        """True iff every pair merges two adjacent equal-length runs and the
        pairs tile a contiguous region in order."""
        if not self.pairs:
            return False
        run = self.pairs[0][0][1] - self.pairs[0][0][0]
        pos = self.pairs[0][0][0]
        for (a0, a1), (b0, b1) in self.pairs:
            if a1 - a0 != run or b1 - b0 != run or a1 != b0 or a0 != pos:
                return False
            pos = b1
        return True

    @property
    def run_length(self) -> int:
        """Uniform operand length (left == right) — only valid if uniform."""
        return self.pairs[0][0][1] - self.pairs[0][0][0]


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

    def levels(self) -> List[List[PlanNode]]:
        """Nodes grouped by depth, root (depth 0) first, left-to-right within
        a level — the level-order view of the division tree."""
        out: List[List[PlanNode]] = []

        def go(node: PlanNode, d: int) -> None:
            if d == len(out):
                out.append([])
            out[d].append(node)
            if not node.is_leaf:
                go(node.left, d + 1)
                go(node.right, d + 1)

        go(self.root, 0)
        return out

    def merge_schedule(self) -> List[MergeLevel]:
        """Bottom-up level-synchronous reduction schedule.

        Level ``i`` merges the children of every internal node at the
        ``i``-th deepest internal depth; running the levels in order performs
        the same tree reduction as :meth:`map_reduce`, but batched so one
        kernel launch can cover a whole level.  A plan built over
        ``even_levels(...)`` work yields an even number of levels (every leaf
        sits at even depth), which is how the paper's merge sort keeps
        results landing in the right buffer.
        """
        out: List[MergeLevel] = []
        for nodes in reversed(self.levels()):
            internal = [n for n in nodes if not n.is_leaf]
            if internal:
                out.append(MergeLevel(pairs=tuple(
                    (n.left.span(), n.right.span()) for n in internal)))
        return out

    def sort_schedule(self, *, sort_bits: int, digit_bits: int = 4,
                      key_shift: int = 0,
                      mode: str = "merge") -> SortSchedule:
        """:meth:`merge_schedule` extended with the tile-sort phase's radix
        digit-pass metadata (the plan's leaves are the tiles; each digit
        pass ranks by ``digit_bits`` key bits starting at ``key_shift``).
        ``sort_bits`` is the key width that actually needs ranking — for
        the fused pack path that is ``num_key_bits`` alone, because the
        packed in-tile position bits below ``key_shift`` ride along
        tie-order-free under a stable LSD pass.

        ``mode="multi_tile"`` describes the merge-tree-free execution: the
        same digit passes, but each one global (histogram / carry scan /
        scatter) over the plan's ``num_tasks()`` tiles, no merge levels."""
        if mode == "multi_tile":
            return SortSchedule(
                tile_passes=digit_passes(sort_bits, digit_bits,
                                         key_shift=key_shift),
                levels=(), key_shift=key_shift, mode="multi_tile",
                num_tiles=self.num_tasks())
        return SortSchedule(
            tile_passes=digit_passes(sort_bits, digit_bits,
                                     key_shift=key_shift),
            levels=tuple(self.merge_schedule()),
            key_shift=key_shift)

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


__all__ = ["Plan", "PlanNode", "MergeLevel", "DigitPass", "SortSchedule",
           "MULTI_TILE_LAUNCHES_PER_PASS", "digit_passes", "build_plan",
           "demand_split", "geometric_blocks"]
