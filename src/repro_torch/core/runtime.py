"""The unified discrete-event scheduling runtime (engine half of Kvik's split).

Kvik's contribution is *composable scheduling policies*; composability only
exists if there is exactly one execution engine for policies to compose over.
This module is that engine.  It owns everything that is *mechanism*:

* p virtual workers with per-worker clocks, speed factors and busy accounting
  (heterogeneous pods, straggler studies);
* per-worker deques, a steal-request queue, and seeded victim selection
  (a single ``random.Random`` stream per run — fixed seed ⇒ bit-identical
  :class:`SimResult`);
* the join-tree bookkeeping (:class:`_JoinNode`) shared by join and depjoin;
* leaf execution, nano-loop grants (``partial_fold``), interruption flags and
  wasted-work accounting;
* the :class:`CostModel` charging rules (split / reduce / check / steal).

Everything that is *decision* lives in a :class:`~repro_torch.core.policies.
SchedulingPolicy` object (see ``policies.py``): when to divide, what an idle
worker does, how a steal request is served, who runs a reduction.  The paper's
four schedulers — join (§3.2), depjoin (§3.2), by_blocks (§3.5), adaptive
(§2.2/§3.6) — plus the OpenMP-static baseline (§4.3) are each ~50-line
policies over this one engine, so they can be mixed (a ``by_blocks`` outer
loop over adaptive inner blocks, an adaptor-wrapped adaptive task), which the
four disjoint pre-refactor engines could not do.

Why a simulator at all: the paper's dynamic claims (task counts under
thief_splitting, "tasks = successful steals + 1", depjoin's no-wait
reductions, fannkuch's split-cost sensitivity) are about a work-stealing
execution engine.  A stream of kernel launches on one card has no such
engine, and one host process could not exhibit real parallelism anyway.  So
we validate those claims bit-exactly in virtual time, then carry the
*validated policies* into the static/replan world of the rest of the
framework.  Kept line for line equal to ``repro.core.runtime``: the same
(work, policy, p, cost, seed, plan) gives a field-for-field equal
:class:`SimResult` in both packages.

The legacy entry points ``WorkStealingSim`` / ``AdaptiveSim`` /
``static_partition_sim`` survive as thin deprecation shims in
:mod:`repro_torch.core.simruntime`; their results are bit-identical to the
pre-refactor engines under fixed seeds (pinned by tests/test_runtime.py).
"""

from __future__ import annotations

import dataclasses
import random
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .adaptors import Adaptor, StealContext
from .divisible import Divisible
from .faults import FaultPlan


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CostModel:
    """Virtual-time costs.

    ``per_item``      — sequential cost per work item.
    ``split_overhead``— fixed cost of one division (task creation).
    ``split_cost_fn`` — extra, work-dependent division cost (e.g. fannkuch's
                        first-permutation generation, merge sort's binary
                        search); receives the divided work.
    ``reduce_cost``   — cost of one reduction.
    ``check_overhead``— cost of one steal-request check (the reason nano-loops
                        exist at all).
    ``steal_latency`` — time for a steal attempt (success or failure).
    """

    per_item: float = 1.0
    split_overhead: float = 1.0
    split_cost_fn: Optional[Callable[[Divisible], float]] = None
    reduce_cost: float = 0.0
    check_overhead: float = 0.05
    steal_latency: float = 0.5

    def split_cost(self, work: Divisible) -> float:
        extra = 0.0
        if self.split_cost_fn is not None:
            extra = self.split_cost_fn(work)
        else:
            u = work.unwrap() if isinstance(work, Adaptor) else work
            extra = float(getattr(u, "split_cost", 0.0))
        return self.split_overhead + extra


@dataclasses.dataclass
class SimResult:
    makespan: float
    tasks_created: int           # leaves actually executed as separate tasks
    divisions: int
    steals_attempted: int
    steals_successful: int
    reductions: int
    items_processed: int
    items_total: int
    per_worker_busy: List[float]
    stopped_early: bool = False
    wasted_items: int = 0        # items beyond the stop index (0 if not stopped)
    deaths: int = 0              # workers killed by the fault plan
    lost_items: int = 0          # items whose fold state died with a worker
    recoveries: int = 0          # orphaned tasks adopted by survivors
    expired_items: int = 0       # items dropped past their deadline (EDF)

    @property
    def lost_work_fraction(self) -> float:
        return self.lost_items / self.items_total if self.items_total else 0.0

    @property
    def speedup_vs_serial(self) -> float:
        serial = self.items_total  # with per_item=1
        return serial / self.makespan if self.makespan > 0 else 0.0

    @property
    def load_balance(self) -> float:
        b = self.per_worker_busy
        return (min(b) / max(b)) if max(b) > 0 else 1.0


# ---------------------------------------------------------------------------
# Tasks and join-tree nodes (shared mechanism)
# ---------------------------------------------------------------------------

class _JoinNode:
    __slots__ = ("pending", "owner", "parent", "reduce_ready")

    def __init__(self, owner: int, parent: Optional["_JoinNode"]):
        self.pending = 2
        self.owner = owner
        self.parent = parent
        self.reduce_ready = False


@dataclasses.dataclass
class Task:
    """A schedulable unit: a work descriptor plus runtime bookkeeping.

    ``nano`` is only meaningful under nano-loop policies (adaptive): the
    current micro-loop grant size.
    """

    work: Divisible
    parent: Optional[_JoinNode] = None
    creator: int = 0
    stolen: bool = False
    nano: int = 1
    orphan_t: float = 0.0        # region time its previous owner died


def _unwrap(w: Divisible) -> Divisible:
    return w.unwrap() if isinstance(w, Adaptor) else w


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class Runtime:
    """Discrete-event virtual-time engine, parameterized by a policy.

    One instance = one (p, cost, policy, seed, speeds, stop_predicate)
    configuration; ``run(work)`` executes the policy over the work and returns
    a :class:`SimResult`.  Runs are independent: all mutable state is reset at
    the top of :meth:`run`, so the same Runtime re-run with the same work is
    deterministic.
    """

    def __init__(self, p: int, cost: CostModel, policy: "Any", *,
                 seed: int = 0, speeds: Optional[List[float]] = None,
                 stop_predicate: Optional[Callable[[Any], Optional[int]]] = None,
                 faults: Optional[FaultPlan] = None):
        self.p = p
        self.cost = cost
        self.policy = policy
        self.seed = seed
        self.speeds = speeds or [1.0] * p
        assert len(self.speeds) == p
        self.stop_predicate = stop_predicate
        # only runtime-facing events matter here; a plan with none is inert
        self.faults = faults if (faults is not None
                                 and faults.has_runtime_events()) else None
        self._base_speeds = list(self.speeds)

    # -- top level -----------------------------------------------------------

    def run(self, work: Divisible) -> SimResult:
        self.rng = random.Random(self.seed)
        self.busy = [0.0] * self.p
        self.stats: Dict[str, int] = dict(
            tasks=0, divisions=0, steal_try=0, steal_ok=0, reductions=0,
            items=0, deaths=0, lost=0, recoveries=0, expired=0)
        self.stop_flag = False
        self.stop_hit: Any = None
        self.items_total = work.size()
        # fault state spans regions: dead stays dead across by_blocks blocks,
        # and event times are absolute (abs_offset accumulates region spans)
        self.dead = [False] * self.p
        self.orphans: deque = deque()
        self.abs_offset = 0.0
        if self.faults is not None:      # slowdowns mutate speeds in place
            self.speeds = list(self._base_speeds)
        # processed index ranges, for exact wasted-work accounting on
        # integer-indexed work (WorkRange family)
        self._segments: List[Tuple[int, int]] = []
        makespan = self.policy.drive(self, work)
        return self._build_result(makespan)

    def run_region(self, work: Divisible, policy: "Any") -> float:
        """Run one parallel region (all workers synchronize at entry and
        exit) under ``policy``; returns the region's makespan.  Policies that
        sequence regions (by_blocks) call this once per block; everything
        else is a single region."""
        p = self.p
        self.time = [0.0] * p
        self.deques: List[deque] = [deque() for _ in range(p)]
        self.pending_reductions: List[List[_JoinNode]] = [[] for _ in range(p)]
        self.current: List[Optional[Task]] = [None] * p
        self.waiting: Dict[int, float] = {}   # thief id -> request time
        self.outstanding = 0
        self.idle_spin = 0
        self.region_done = False
        policy.on_region_start(self, work)
        while not self.region_done:
            if self.faults is not None:
                self.fault_service()
            wid = policy.select_worker(self)
            if wid is None:
                if self.faults is not None and self.orphans:
                    continue      # next fault_service adopts the orphans
                break
            policy.quantum(self, wid)
        span = policy.on_region_end(self)
        if self.faults is not None:
            self.abs_offset += span
        return span

    def _build_result(self, makespan: float) -> SimResult:
        # wasted work = processed items strictly beyond the stop index (the
        # items a perfectly-informed sequential scan would never touch)
        wasted = 0
        if (self.stop_flag and isinstance(self.stop_hit, int)
                and not isinstance(self.stop_hit, bool)):
            cut = self.stop_hit + 1
            wasted = sum(max(0, hi - max(lo, cut))
                         for (lo, hi) in self._segments)
        return SimResult(
            makespan=makespan, tasks_created=self.stats["tasks"],
            divisions=self.stats["divisions"],
            steals_attempted=self.stats["steal_try"],
            steals_successful=self.stats["steal_ok"],
            reductions=self.stats["reductions"],
            items_processed=self.stats["items"],
            items_total=self.items_total,
            per_worker_busy=self.busy, stopped_early=self.stop_flag,
            wasted_items=wasted, deaths=self.stats["deaths"],
            lost_items=self.stats["lost"],
            recoveries=self.stats["recoveries"],
            expired_items=self.stats["expired"])

    # -- time & cost charging ------------------------------------------------

    def charge(self, wid: int, cost: float) -> None:
        t = cost / self.speeds[wid]
        self.time[wid] += t
        self.busy[wid] += t

    def idle_count(self) -> int:
        if self.faults is not None:
            return sum(1 for i, c in enumerate(self.current)
                       if c is None and not self.dead[i])
        return sum(1 for c in self.current if c is None)

    # -- fault injection (all paths gated on a live FaultPlan) ---------------

    def alive(self, wid: int) -> bool:
        return self.faults is None or not self.dead[wid]

    def worker_died(self, wid: int) -> bool:
        """Policy-facing: did the current quantum end in this worker's
        death (mid-grant truncation)?"""
        return self.faults is not None and self.dead[wid]

    def has_demand(self, wid: int) -> bool:
        """Is any *other* alive worker idle right now?  The mid-region
        preemption hook consults this to keep steal-service boundaries
        frequent while demand exists."""
        return any(self.current[i] is None and self.alive(i)
                   for i in range(self.p) if i != wid)

    def seed_worker(self) -> int:
        """Worker that seeds a region's initial task (0 unless dead)."""
        if self.faults is None:
            return 0
        for i in range(self.p):
            if not self.dead[i]:
                return i
        raise RuntimeError("fault plan killed every worker")

    def _abs_time(self, wid: int) -> float:
        return self.abs_offset + self.time[wid]

    def fault_service(self) -> None:
        """One discrete-event service pass: fire due deaths and slowdowns,
        then let idle survivors adopt orphaned tasks (the recovery steal)."""
        f = self.faults
        for i in range(self.p):
            if self.dead[i]:
                continue
            self.speeds[i] = self._base_speeds[i] * f.speed_factor(
                i, self._abs_time(i))
            td = f.death_time(i)
            if td is not None and self._abs_time(i) >= td:
                self.kill_worker(i)
        if not self.orphans:
            return
        survivors = [i for i in range(self.p) if not self.dead[i]]
        if not survivors:
            raise RuntimeError(
                "fault plan killed every worker with work outstanding")
        for i in survivors:
            if not self.orphans:
                break
            if self.current[i] is not None:
                continue
            task = self.orphans.popleft()
            task.stolen = True
            task.nano = 1            # fresh micro-loop: re-splittable at once
            lat = self.cost.steal_latency / self.speeds[i]
            self.time[i] = max(self.time[i], task.orphan_t) + lat
            if isinstance(task.work, Adaptor):
                task.work.on_steal()
            self.current[i] = task
            self.waiting.pop(i, None)
            self.stats["recoveries"] += 1

    def kill_worker(self, wid: int) -> None:
        """Process a worker death: its in-flight task and queued tasks
        re-enter the steal pool; deferred reductions move to a survivor."""
        self.dead[wid] = True
        self.stats["deaths"] += 1
        t = self.time[wid]
        task = self.current[wid]
        self.current[wid] = None
        if task is not None:
            task.orphan_t = t
            self.orphans.append(task)
        while self.deques[wid]:
            q = self.deques[wid].popleft()
            q.orphan_t = t
            self.orphans.append(q)
        if self.pending_reductions[wid]:
            succ = self._successor(wid)
            if succ is not None:
                self.pending_reductions[succ].extend(
                    self.pending_reductions[wid])
            self.pending_reductions[wid] = []
        self.waiting.pop(wid, None)

    def _successor(self, wid: int) -> Optional[int]:
        for i in range(self.p):
            if i != wid and not self.dead[i]:
                return i
        return None

    def _death_cut(self, wid: int, dur: float) -> Optional[float]:
        """If a charge of worker-time ``dur`` starting now spans this
        worker's death, return the surviving fraction in [0, 1)."""
        if self.faults is None or self.dead[wid]:
            return None
        td = self.faults.death_time(wid)
        if td is None:
            return None
        t0 = self._abs_time(wid)
        if dur <= 0 or td >= t0 + dur:
            return None
        return max(0.0, (td - t0) / dur)

    # -- division ------------------------------------------------------------

    def wants_division(self, w: Divisible, ctx: StealContext) -> bool:
        if isinstance(w, Adaptor):
            return w.should_divide(ctx)
        return w.should_be_divided()

    def divide(self, w: Divisible, ctx: StealContext
               ) -> Tuple[Divisible, Divisible]:
        l, r = (w.divide_ctx(ctx) if hasattr(w, "divide_ctx")
                else w.divide())
        self.stats["divisions"] += 1
        return l, r

    def new_join_node(self, owner: int, parent: Optional[_JoinNode]
                      ) -> _JoinNode:
        return _JoinNode(owner=owner, parent=parent)

    def push_task(self, wid: int, task: Task) -> None:
        self.deques[wid].append(task)
        self.outstanding += 1

    # -- leaf / grant execution ---------------------------------------------

    def run_leaf(self, wid: int, task: Task) -> None:
        """Run a whole leaf sequentially (join-family semantics): tasks only
        check the interruption flag *before* starting — classical schedulers
        can only cancel non-started tasks (paper §4.1)."""
        w = task.work
        n_items = w.size()
        if self.stop_flag:
            n_items = 0  # cancelled before start
        if self.faults is not None:
            dur = n_items * self.cost.per_item / self.speeds[wid]
            frac = self._death_cut(wid, dur)
            if frac is not None:
                # the leaf is truncated at the death point: items executed
                # before the cut are lost (their fold state died with the
                # worker) and the WHOLE leaf re-enters the steal pool — the
                # producer was never advanced, so re-execution is exact
                done = int(n_items * frac)
                self.time[wid] += frac * dur
                self.busy[wid] += frac * dur
                self.stats["lost"] += done
                self.current[wid] = task  # the object kill_worker orphans
                self.kill_worker(wid)
                return
        self.stats["tasks"] += 1
        self.charge(wid, n_items * self.cost.per_item)
        self.stats["items"] += n_items
        self._record_segment(w, n_items)
        if self.stop_predicate is not None and n_items > 0:
            hit = self.stop_predicate(_unwrap(w))
            if hit is not None:
                self.raise_stop(hit)
        if isinstance(w, Adaptor):
            w.on_finish()
        self.current[wid] = None
        self.outstanding -= 1
        self.finish_join(task.parent, wid)

    def run_grant(self, wid: int, w: Divisible, grant: int) -> Any:
        """Run ``grant`` items of a producer via ``partial_fold`` (nano-loop
        semantics): the interruption predicate sees every item, and one
        check_overhead is charged for the micro-loop boundary.  Returns the
        predicate's hit value (or None)."""
        run_t = ((grant * self.cost.per_item + self.cost.check_overhead)
                 / self.speeds[wid])
        if self.faults is not None:
            frac = self._death_cut(wid, run_t)
            if frac is not None:
                # grant truncated at the death point: the partial fold is
                # lost, the producer does NOT advance, and the worker's
                # current task (holding the full remaining extent) is
                # orphaned into the steal pool by kill_worker
                done = min(grant, int(grant * frac))
                self.time[wid] += frac * run_t
                self.busy[wid] += frac * run_t
                self.stats["lost"] += done
                self.kill_worker(wid)
                return None
        hit = [None]
        pred = self.stop_predicate

        def fold(st, item):
            if pred is not None:
                r = pred(item)
                if r is not None:
                    hit[0] = r
            return st

        self._record_segment(w, grant)   # before partial_fold advances it
        w.partial_fold(None, fold, grant)
        self.time[wid] += run_t
        self.busy[wid] += run_t
        self.stats["items"] += grant
        return hit[0]

    def _record_segment(self, w: Divisible, n: int) -> None:
        if n <= 0 or self.stop_predicate is None:
            return
        start = getattr(_unwrap(w), "start", None)
        if isinstance(start, int):
            self._segments.append((start, start + n))

    def retire(self, wid: int) -> None:
        """Drop a worker's current task (adaptive: exhausted / cancelled)."""
        task = self.current[wid]
        self.current[wid] = None
        if task is not None and isinstance(task.work, Adaptor):
            task.work.on_finish()

    def raise_stop(self, hit: Any) -> None:
        if not self.stop_flag:
            self.stop_flag = True
            self.stop_hit = hit

    # -- join-tree bookkeeping ----------------------------------------------

    def finish_join(self, node: Optional[_JoinNode], wid: int) -> None:
        """Walk up the join tree after a child completes.  When both children
        of a node are done the policy's ``on_join_complete`` decides who runs
        the reduction: True = the finishing worker runs it now and we ascend
        (depjoin, paper §3.2); False = it is deferred to the dividing owner's
        reduction queue (plain join)."""
        while node is not None:
            node.pending -= 1
            if node.pending > 0:
                return
            if self.policy.on_join_complete(self, node, wid):
                self.charge(wid, self.cost.reduce_cost)
                self.stats["reductions"] += 1
                node = node.parent
            else:
                node.reduce_ready = True
                owner = node.owner
                if self.faults is not None and self.dead[owner]:
                    owner = self._successor(owner)
                    if owner is None:
                        owner = wid   # last survivor reduces its own tree
                self.pending_reductions[owner].append(node)
                return

    def run_deferred_reduction(self, wid: int) -> None:
        node = self.pending_reductions[wid].pop()
        self.charge(wid, self.cost.reduce_cost)
        self.stats["reductions"] += 1
        self.finish_join(node.parent, wid)

    # -- stealing (join family: thief-initiated deque steal) -----------------

    def steal_from_random_victim(self, wid: int) -> bool:
        """Attempt one steal from the top of a random non-empty deque.
        Returns True if an attempt was made (charging steal_latency)."""
        victims = [i for i in range(self.p) if i != wid and self.deques[i]]
        if not victims:
            return False
        self.stats["steal_try"] += 1
        v = self.rng.choice(victims)
        self.time[wid] += self.cost.steal_latency / self.speeds[wid]
        if self.deques[v]:
            stolen = self.deques[v].popleft()
            stolen.stolen = True
            if isinstance(stolen.work, Adaptor):
                stolen.work.on_steal()
            self.stats["steal_ok"] += 1
            self.current[wid] = stolen
        return True

    # -- stealing (adaptive family: victim-served request queue) -------------

    def post_steal_requests(self) -> None:
        """Register every idle worker in the single request queue (lazily:
        any idle worker has, by construction, nothing else to do).  Each idle
        spell counts as one steal attempt."""
        for thief in range(self.p):
            if self.current[thief] is None and self.alive(thief):
                if thief not in self.waiting:
                    self.waiting[thief] = self.time[thief]
                    self.stats["steal_try"] += 1

    def next_steal_request(self) -> Optional[int]:
        """Pick one pending request (seeded-random among requesters)."""
        idle = [i for i in self.waiting if self.current[i] is None]
        return self.rng.choice(idle) if idle else None

    def grant_steal(self, wid: int, thief: int, task: Task, nano0: int
                    ) -> None:
        """Serve a steal request: divide the victim's remaining work in half,
        hand the right part to the thief, reset both nano sizes."""
        w = task.work
        ctx = StealContext(stolen=True, worker=thief,
                           demand=self.idle_count())
        l, r = self.divide(w, ctx)
        self.stats["steal_ok"] += 1
        self.stats["tasks"] += 1
        del self.waiting[thief]
        lat = self.cost.steal_latency / self.speeds[thief]
        self.time[thief] = max(self.time[thief], self.time[wid]) + lat
        if isinstance(r, Adaptor):
            r.on_steal()
        self.current[thief] = Task(work=r, creator=thief, stolen=True,
                                   nano=nano0)
        task.work = l
        task.nano = nano0

    # -- idle / termination (join family) ------------------------------------

    def idle_or_finish(self, wid: int) -> None:
        """Nothing to run, pop, or steal: either the region is over, or this
        worker's clock jumps to the next busy worker's time."""
        if self.faults is not None and self.orphans:
            return   # the next fault_service pass adopts into this worker
        p = self.p
        if self.outstanding <= 0 and not any(
                self.pending_reductions[i] for i in range(p)):
            self.region_done = True
            return
        others = [self.time[i] for i in range(p) if i != wid and
                  (self.current[i] is not None or self.deques[i]
                   or self.pending_reductions[i])]
        if not others:
            self.idle_spin += 1
            if self.idle_spin > 10 * p:
                self.region_done = True
                return
            self.time[wid] += self.cost.steal_latency
            return
        self.idle_spin = 0
        self.time[wid] = max(self.time[wid], min(others)) + 1e-9


__all__ = ["CostModel", "SimResult", "Task", "Runtime"]
