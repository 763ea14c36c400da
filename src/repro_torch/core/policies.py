"""Scheduling policies — the decision half of Kvik's engine/policy split.

Each policy is a small object driving the shared discrete-event engine
(:class:`~repro_torch.core.runtime.Runtime`) through a fixed set of hooks:

========================  ===================================================
hook                      decision it owns
========================  ===================================================
``drive``                 how regions are sequenced (by_blocks overrides)
``on_region_start``       where the initial work is seeded
``select_worker``         which worker's clock advances next
``quantum``               one event-loop step for that worker
``on_task_start``         eager division before running a leaf (join family)
``on_microloop_boundary`` what happens between nano-loops (adaptive family)
``on_steal_request``      how an idle worker acquires work
``on_join_complete``      who runs a reduction (join defers to the owner;
                          depjoin runs it on the last finisher)
``on_region_end``         the region's makespan and final accounting
========================  ===================================================

The five concrete policies map to the paper as:

* :class:`JoinPolicy`        — fork-join divide/run/tree-reduce (§3.2):
  division happens eagerly up front per the (adaptor-wrapped) divisible; the
  reduction is owned by the worker that divided and runs when it next idles.
* :class:`DepJoinPolicy`     — §3.2's ``depjoin``: identical division tree,
  but the worker completing the *second* child runs the reduction
  immediately (no wait on the owner) — one overridden hook.
* :class:`AdaptivePolicy`    — §2.2/§3.6: a single initial task; the worker
  folds geometrically growing nano-loops (1, 2, 4, ...) and serves steal
  *requests* at micro-loop boundaries by dividing the remaining work in
  half; nano size resets on split.  "tasks created = successful steals + 1".
* :class:`StaticPartitionPolicy` — the OpenMP-static / "rust static"
  baseline (§4.3): pre-split into equal chunks round-robin, no stealing.
* :class:`ByBlocksPolicy`    — §3.5 as a *dynamic* policy: a sequential
  outer loop over geometrically growing blocks, each block executed by an
  arbitrary *inner* policy on the same worker pool (barrier between
  blocks); the interruption flag is checked between blocks.  This is the
  composition the four pre-refactor engines could not express — e.g.
  ``ByBlocksPolicy(inner=AdaptivePolicy(), first=p)``.

All policies compose with the :mod:`repro_torch.core.adaptors` stack: the engine
consults ``should_divide(ctx)`` on adaptor-wrapped work, so e.g.
``cap``/``size_limit``-wrapped work under :class:`AdaptivePolicy` refuses
splits exactly as it would under :class:`JoinPolicy`.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Any, Optional

from .adaptors import Adaptor, StealContext, find_tag
from .divisible import Divisible, WorkSet
from .plan import geometric_blocks
from .runtime import CostModel, Runtime, SimResult, Task


class SchedulingPolicy:
    """Base policy: hook defaults shared by the concrete policies."""

    name = "policy"

    # -- region sequencing ---------------------------------------------------
    def drive(self, rt: Runtime, work: Divisible) -> float:
        return rt.run_region(work, self)

    def on_region_start(self, rt: Runtime, work: Divisible) -> None:
        raise NotImplementedError

    def on_region_end(self, rt: Runtime) -> float:
        return max(rt.time)

    # -- event loop ----------------------------------------------------------
    def select_worker(self, rt: Runtime) -> Optional[int]:
        raise NotImplementedError

    def quantum(self, rt: Runtime, wid: int) -> None:
        raise NotImplementedError

    # -- fine-grained decisions ----------------------------------------------
    def on_task_start(self, rt: Runtime, wid: int, task: Task) -> Task:
        return task

    def on_microloop_boundary(self, rt: Runtime, wid: int, task: Task) -> None:
        pass

    def on_steal_request(self, rt: Runtime, wid: int) -> bool:
        return rt.steal_from_random_victim(wid)

    def on_join_complete(self, rt: Runtime, node: Any, wid: int) -> bool:
        """True → the finishing worker reduces immediately (depjoin)."""
        return False

    def preempt_grant(self, rt: Runtime, wid: int, task: Task,
                      grant: int) -> int:
        """Mid-region preemption hook: a policy may shrink the next grant so
        a micro-loop boundary (the only steal-service point) arrives sooner.
        The default keeps the grant unchanged — faultless runs are
        bit-identical."""
        return grant


# ---------------------------------------------------------------------------
# join / depjoin
# ---------------------------------------------------------------------------

class JoinPolicy(SchedulingPolicy):
    """Fork-join work stealing (paper §3.2, Rayon/Kvik semantics)."""

    name = "join"

    def on_region_start(self, rt: Runtime, work: Divisible) -> None:
        w0 = rt.seed_worker()            # 0 unless the fault plan killed it
        rt.current[w0] = Task(work=work, creator=w0)
        rt.outstanding = 1

    def select_worker(self, rt: Runtime) -> Optional[int]:
        cand = [i for i in range(rt.p) if rt.alive(i)]
        if not cand:
            return None
        return min(cand, key=lambda i: rt.time[i])

    def quantum(self, rt: Runtime, wid: int) -> None:
        task = rt.current[wid]
        if task is not None:
            task = self.on_task_start(rt, wid, task)
            rt.run_leaf(wid, task)
            return
        if rt.pending_reductions[wid]:       # plain-join: owner reduces
            rt.run_deferred_reduction(wid)
            return
        if rt.deques[wid]:                   # own work first
            rt.current[wid] = rt.deques[wid].pop()
            return
        if self.on_steal_request(rt, wid):   # then steal
            return
        rt.idle_or_finish(wid)

    def on_task_start(self, rt: Runtime, wid: int, task: Task) -> Task:
        """Divide until the (adaptor-wrapped) work declines: right children
        go to the worker's own deque (stealable), continue with the left."""
        ctx = StealContext(stolen=task.stolen, worker=wid,
                           demand=rt.idle_count())
        w = task.work
        while rt.wants_division(w, ctx):
            rt.charge(wid, rt.cost.split_cost(w))
            l, r = rt.divide(w, ctx)
            node = rt.new_join_node(owner=wid, parent=task.parent)
            rt.push_task(wid, Task(work=r, parent=node, creator=wid))
            task = Task(work=l, parent=node, creator=wid, stolen=False)
            w = task.work
            ctx = StealContext(stolen=False, worker=wid,
                               demand=rt.idle_count())
        return task


class DepJoinPolicy(JoinPolicy):
    """§3.2 ``depjoin``: the worker that completes the *second* child runs
    the reduction immediately — the tree never waits on the dividing owner."""

    name = "depjoin"

    def on_join_complete(self, rt: Runtime, node: Any, wid: int) -> bool:
        return True


# ---------------------------------------------------------------------------
# adaptive (steal-driven splits + geometric nano-loops)
# ---------------------------------------------------------------------------

class AdaptivePolicy(SchedulingPolicy):
    """§2.2/§3.6: split only on demand, amortize request checks.

    One initial task; the executing worker folds in geometrically growing
    nano-loops, checking the shared steal-request queue between loops; a
    pending request splits the *remaining* work in half and hands it to the
    thief directly; nano size resets.  Reductions form a chain of
    (tasks − 1) merges charged at region end.

    ``preempt=True`` arms the mid-region preemption hook: while another
    alive worker is idle (a pending steal request, or a fault-plan death
    freed its work), the next grant is clipped to ``nano0`` so the
    steal-service boundary arrives after ~nano0 items instead of after the
    geometrically grown nano-loop.  This is what lets adaptive re-spread an
    orphaned task across survivors *inside* a region — without it, late in
    a region there are no micro-loop boundaries left and recovery never
    happens (the pinned zero-recovery roofline result).  Faultless,
    demand-free runs are unchanged: the clip only fires when demand exists.
    """

    name = "adaptive"

    def __init__(self, nano0: int = 1, nano_cap: int = 1 << 20,
                 preempt: bool = False):
        self.nano0 = nano0
        self.nano_cap = nano_cap
        self.preempt = preempt

    def on_region_start(self, rt: Runtime, work: Divisible) -> None:
        self._region_tasks = 1
        rt.stats["tasks"] += 1
        w0 = rt.seed_worker()            # 0 unless the fault plan killed it
        rt.current[w0] = Task(work=work, creator=w0, nano=self.nano0)

    def select_worker(self, rt: Runtime) -> Optional[int]:
        active = [i for i in range(rt.p) if rt.current[i] is not None]
        if not active:
            return None
        return min(active, key=lambda i: rt.time[i])

    def quantum(self, rt: Runtime, wid: int) -> None:
        task = rt.current[wid]
        w = task.work
        remaining = w.size()
        if remaining == 0 or rt.stop_flag:
            rt.retire(wid)
            return
        grant = min(task.nano, remaining)
        grant = self.preempt_grant(rt, wid, task, grant)
        hit = rt.run_grant(wid, w, grant)
        if rt.worker_died(wid):               # grant truncated by a death
            return
        if hit is not None:                   # nano-loop interruption (§4.1)
            rt.raise_stop(hit)
            rt.retire(wid)
            return
        if w.size() == 0:
            rt.retire(wid)
            return
        self.on_microloop_boundary(rt, wid, task)

    def on_microloop_boundary(self, rt: Runtime, wid: int, task: Task) -> None:
        rt.post_steal_requests()
        thief = rt.next_steal_request()
        if thief is not None and self._may_split(rt, task.work, wid, thief):
            rt.grant_steal(wid, thief, task, self.nano0)
            self._region_tasks += 1
        else:                                 # un-stolen micro-loop: grow
            task.nano = min(task.nano * 2, self.nano_cap)

    def preempt_grant(self, rt: Runtime, wid: int, task: Task,
                      grant: int) -> int:
        if self.preempt and grant > self.nano0 and rt.has_demand(wid):
            return self.nano0
        return grant

    def _may_split(self, rt: Runtime, w: Divisible, wid: int,
                   thief: int) -> bool:
        if w.size() <= 1:
            return False
        if isinstance(w, Adaptor):            # adaptor-composed adaptive
            ctx = StealContext(stolen=True, worker=wid,
                               demand=rt.idle_count())
            return w.should_divide(ctx)
        return True

    def on_region_end(self, rt: Runtime) -> float:
        red = max(0, self._region_tasks - 1)
        rt.stats["reductions"] += red
        return max(rt.time) + red * rt.cost.reduce_cost / max(rt.speeds)


# ---------------------------------------------------------------------------
# static partition (OpenMP-static / "rust static" baseline)
# ---------------------------------------------------------------------------

class StaticPartitionPolicy(SchedulingPolicy):
    """§4.3 baseline: pre-split into ``num_blocks`` equal chunks assigned
    round-robin; no stealing; all split cost paid up front."""

    name = "static"

    def __init__(self, num_blocks: Optional[int] = None):
        self.num_blocks = num_blocks

    def on_region_start(self, rt: Runtime, work: Divisible) -> None:
        nb = self.num_blocks or rt.p
        self._split_cost = sum(rt.cost.split_cost(work)
                               for _ in range(nb - 1))
        self._nb = nb
        rest = work
        chunks = []
        for i in range(nb - 1):
            sz = rest.size() // (nb - i)
            l, rest = rest.divide_at(sz)
            chunks.append(l)
        chunks.append(rest)
        rt.stats["divisions"] += nb - 1
        # round-robin over *alive* workers: with no fault plan this is the
        # identity assignment i % p (bit-identical to the pre-fault engine)
        targets = [i for i in range(rt.p) if rt.alive(i)]
        for i, ch in enumerate(chunks):
            t = targets[i % len(targets)]
            rt.push_task(t, Task(work=ch, creator=t))

    def select_worker(self, rt: Runtime) -> Optional[int]:
        cand = [i for i in range(rt.p)
                if rt.current[i] is not None or rt.deques[i]]
        if not cand:
            return None
        return min(cand, key=lambda i: rt.time[i])

    def quantum(self, rt: Runtime, wid: int) -> None:
        if rt.current[wid] is None:
            rt.current[wid] = rt.deques[wid].popleft()
            return
        rt.run_leaf(wid, rt.current[wid])

    def on_region_end(self, rt: Runtime) -> float:
        rt.stats["reductions"] += self._nb - 1
        return max(rt.time) + self._split_cost / max(rt.speeds)


# ---------------------------------------------------------------------------
# priority / deadline (multi-tenant SLO scheduling)
# ---------------------------------------------------------------------------

class PriorityPolicy(SchedulingPolicy):
    """Priority-ordered task selection over a shared relaxed k-priority pool.

    The pool holds whole submissions (a :class:`~repro_torch.core.divisible.WorkSet`
    seeds one entry per part; any other divisible seeds a single entry),
    ordered by the :class:`~repro_torch.core.adaptors.Tagged` metadata found in each
    part's adaptor stack — untagged work runs at priority 0.  An idle worker
    pops from the pool (charged one ``steal_latency``, the shared-structure
    access cost), eagerly divides the entry exactly like :class:`JoinPolicy`
    — right children re-enter the *pool* with the inherited tag, so high
    priority work spreads across workers — and runs the left leaf.

    ``k`` is the relaxation knob from "Data Structures for Task-based
    Priority Scheduling": a pop draws uniformly among the top ``k`` entries
    instead of the strict maximum, trading ordering fidelity for contention.
    ``k=1`` is strict and consumes **no** rng, so faultless strict runs are
    bit-identical regardless of relaxed runs interleaved on the same seed.

    Composes with ``by_blocks`` (each block's WorkSet slice becomes a fresh
    pool) and with the full adaptor stack (``cap``/``size_limit`` gate the
    eager division through the standard ``should_divide`` path).
    """

    name = "priority"

    def __init__(self, k: int = 1):
        if k < 1:
            raise ValueError(f"relaxation k must be >= 1, got {k}")
        self.k = k

    # -- pool ordering --------------------------------------------------------
    def order_key(self, w: Divisible) -> tuple:
        tag = find_tag(w)
        return (-(tag.priority if tag is not None else 0),)

    def expired(self, rt: Runtime, wid: int, w: Divisible) -> bool:
        """Deadline hook: priority scheduling never expires work."""
        return False

    def _push(self, w: Divisible) -> None:
        bisect.insort(self._pool, (self.order_key(w), self._seq, w))
        self._seq += 1

    def _pop_index(self, rt: Runtime) -> int:
        if self.k == 1 or len(self._pool) == 1:
            return 0          # strict: no rng consumed
        return rt.rng.randrange(min(self.k, len(self._pool)))

    # -- hooks ----------------------------------------------------------------
    def on_region_start(self, rt: Runtime, work: Divisible) -> None:
        self._pool: list = []
        self._seq = 0
        parts = work.parts if isinstance(work, WorkSet) else (work,)
        for part in parts:
            self._push(part)
        rt.outstanding = len(self._pool)

    def select_worker(self, rt: Runtime) -> Optional[int]:
        cand = [i for i in range(rt.p)
                if rt.current[i] is not None
                or (rt.alive(i) and self._pool)]
        if not cand:
            return None
        return min(cand, key=lambda i: rt.time[i])

    def quantum(self, rt: Runtime, wid: int) -> None:
        task = rt.current[wid]
        if task is None:
            while self._pool:
                _, _, w = self._pool.pop(self._pop_index(rt))
                rt.charge(wid, rt.cost.steal_latency)
                if self.expired(rt, wid, w):
                    rt.stats["expired"] += w.size()
                    rt.outstanding -= 1
                    if isinstance(w, Adaptor):
                        w.on_finish()
                    continue
                task = Task(work=w, creator=wid)
                break
            if task is None:
                return
            rt.current[wid] = task
        task = self.on_task_start(rt, wid, task)
        rt.run_leaf(wid, task)

    def on_task_start(self, rt: Runtime, wid: int, task: Task) -> Task:
        """Divide until the work declines; right children re-enter the shared
        pool with the inherited tag (division preserves the Tagged wrapper)."""
        ctx = StealContext(stolen=task.stolen, worker=wid,
                           demand=rt.idle_count())
        w = task.work
        while rt.wants_division(w, ctx):
            rt.charge(wid, rt.cost.split_cost(w))
            l, r = rt.divide(w, ctx)
            self._push(r)
            rt.outstanding += 1
            task = Task(work=l, creator=wid, stolen=False)
            w = task.work
            ctx = StealContext(stolen=False, worker=wid,
                               demand=rt.idle_count())
        return task


class DeadlinePolicy(PriorityPolicy):
    """Earliest-deadline-first with expiry: the pool orders by the Tagged
    absolute virtual-time ``deadline`` (untagged / undated work sorts last),
    and a pop whose deadline already passed on the popping worker's clock is
    *dropped and counted* (``SimResult.expired_items``), never run — late
    work wastes no capacity.  Conservation invariant (faultless, no early
    stop): ``items_processed + expired_items == items_total``.
    """

    name = "deadline"

    def order_key(self, w: Divisible) -> tuple:
        tag = find_tag(w)
        d = (tag.deadline if tag is not None and tag.deadline is not None
             else math.inf)
        return (d,)

    def expired(self, rt: Runtime, wid: int, w: Divisible) -> bool:
        tag = find_tag(w)
        return (tag is not None and tag.deadline is not None
                and rt.time[wid] > tag.deadline)


# ---------------------------------------------------------------------------
# by_blocks as a *dynamic* policy: sequential outer loop, any inner policy
# ---------------------------------------------------------------------------

class ByBlocksPolicy(SchedulingPolicy):
    """§3.5 dynamically: geometrically growing blocks run one after another,
    each as a parallel region under ``inner``; the interruption flag is
    checked between blocks, bounding wasted work by growth/(1+growth).

    This composes policies that previously lived in separate engines:
    ``ByBlocksPolicy(inner=AdaptivePolicy(), first=p)`` simulates an
    interruptible adaptive computation — impossible before the unification.
    """

    name = "by_blocks"

    def __init__(self, inner: SchedulingPolicy, first: int,
                 growth: float = 2.0, align: int = 1,
                 cap: Optional[int] = None,
                 wrap: Optional[Any] = None):
        self.inner = inner
        self.first = first
        self.growth = growth
        self.align = align
        self.cap = cap
        self.wrap = wrap       # per-block adaptor stack, e.g. thief_splitting
        self.blocks_run = 0

    def drive(self, rt: Runtime, work: Divisible) -> float:
        self.blocks_run = 0
        total = 0.0
        rest = work
        for (lo, hi) in geometric_blocks(work.size(), first=self.first,
                                         growth=self.growth,
                                         align=self.align, cap=self.cap):
            blk, rest = rest.divide_at(hi - lo)
            if self.wrap is not None:     # fresh adaptor state per block
                blk = self.wrap(blk)
            total += rt.run_region(blk, self.inner)
            self.blocks_run += 1
            if rt.stop_flag:
                break
        return total

    def on_join_complete(self, rt: Runtime, node: Any, wid: int) -> bool:
        return self.inner.on_join_complete(rt, node, wid)


# ---------------------------------------------------------------------------
# convenience face
# ---------------------------------------------------------------------------

def simulate(work: Divisible, policy: SchedulingPolicy, p: int,
             cost: Optional[CostModel] = None, *, seed: int = 0,
             speeds=None, stop_predicate=None, faults=None) -> SimResult:
    """One-call face: run ``work`` under ``policy`` on ``p`` virtual workers."""
    return Runtime(p, cost or CostModel(), policy, seed=seed, speeds=speeds,
                   stop_predicate=stop_predicate, faults=faults).run(work)


__all__ = [
    "SchedulingPolicy", "JoinPolicy", "DepJoinPolicy", "AdaptivePolicy",
    "StaticPartitionPolicy", "ByBlocksPolicy", "PriorityPolicy",
    "DeadlinePolicy", "simulate",
]
