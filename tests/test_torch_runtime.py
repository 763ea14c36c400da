"""The port's virtual-time Runtime, policies, faults and schedulers
(``repro_torch.core``) against ``repro.core``: the same (work, policy, p,
cost, seed, fault plan) must give a ``SimResult`` equal field for field,
floats bit for bit.  Seeded parametrize only."""

import dataclasses
import math

import pytest

import repro.core as jcore
import repro_torch.core as tcore

N = 3000
COST = dict(per_item=1.0, split_overhead=1.0, reduce_cost=0.5,
            check_overhead=0.05, steal_latency=0.5)


def _cost(core, **kw):
    return core.CostModel(**{**COST, **kw})


# each builds its work from one package's core: divisibles under adaptors
WORKS = {
    "range": lambda c, p: c.WorkRange(0, N),
    "thief_batch": lambda c, p: c.thief_splitting(c.BatchWork(0, N), p=p),
    "join_context": lambda c, p: c.join_context(c.WorkRange(0, N), 5),
    "force_size": lambda c, p: c.force_depth(
        c.size_limit(c.SeqWork(0, N, align=16), 64), 3),
    "cap_bound": lambda c, p: c.cap(c.bound_depth(c.WorkRange(0, N), 4), 6),
    "tagged_set": lambda c, p: c.WorkSet(tuple(
        c.tagged(c.WorkRange(400 * i, 400 * (i + 1)), priority=i % 3,
                 deadline=250.0 * (i + 1), tenant=f"t{i % 2}")
        for i in range(7))),
    "tagged": lambda c, p: c.cap(c.tagged(c.SeqWork(0, N), priority=1,
                                          deadline=1500.0), 8),
    "perm": lambda c, p: c.thief_splitting(c.PermRange(6, 0, 720), p=p),
}

POLICIES = {
    "join": lambda c: c.JoinPolicy(),
    "depjoin": lambda c: c.DepJoinPolicy(),
    "adaptive": lambda c: c.AdaptivePolicy(),
    "adaptive_preempt": lambda c: c.AdaptivePolicy(nano0=2, preempt=True),
    "static": lambda c: c.StaticPartitionPolicy(),
    "priority": lambda c: c.PriorityPolicy(),
    "priority_k2": lambda c: c.PriorityPolicy(k=2),
    "deadline": lambda c: c.DeadlinePolicy(),
    "by_blocks": lambda c: c.ByBlocksPolicy(inner=c.AdaptivePolicy(),
                                            first=64),
}
# nano-loop policies fold a Producer; a WorkSet is none (both raise alike)
NEEDS_PRODUCER = {"adaptive", "adaptive_preempt", "by_blocks"}


def _faults(c, kind, p):
    if kind == "none":
        return None
    if kind == "death":
        # at p = 1 the death names no worker: the fault paths run inert
        return c.FaultPlan(deaths=(c.WorkerDeath(max(p - 1, 1), 300.0),))
    if kind == "slowdown":
        return c.FaultPlan(slowdowns=(c.Slowdown(0, 50.0, 900.0, 0.25),))
    return c.FaultPlan.random(11 + p, p=p, horizon=N / p, n_deaths=1,
                              n_slowdowns=1)


def _outcome(fn):
    """A run's SimResult as a dict, or the error it raised."""
    try:
        return ("ok", dataclasses.asdict(fn()))
    except Exception as e:                     # noqa: BLE001
        return ("err", type(e).__name__, str(e))


def _stop_at(target):
    def pred(x):
        if isinstance(x, int):
            return target if x == target else None
        if hasattr(x, "start"):
            return target if x.start <= target < x.stop else None
        return None
    return pred


def _both(fn):
    t, j = _outcome(lambda: fn(tcore)), _outcome(lambda: fn(jcore))
    assert t == j
    return t


@pytest.mark.parametrize("work", sorted(WORKS))
@pytest.mark.parametrize("p", [1, 2, 7, 16])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_simresult_equals_reference(policy, p, work):
    """Every fault plan (none, a death, a slowdown, FaultPlan.random) on
    this (policy, p, work), and a find-first stop: equal outcomes."""
    ok = 0
    for kind in ("none", "death", "slowdown", "random"):
        def run(c, kind=kind):
            return c.simulate(WORKS[work](c, p), POLICIES[policy](c), p,
                              _cost(c), seed=3, faults=_faults(c, kind, p))
        ok += _both(run)[0] == "ok"
    assert ok == 4 or (policy in NEEDS_PRODUCER and work == "tagged_set")

    def stopped(c):
        return c.simulate(WORKS[work](c, p), POLICIES[policy](c), p,
                          _cost(c), seed=5, stop_predicate=_stop_at(700))
    _both(stopped)


@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_runtime_run_twice_and_speeds(p, seed):
    """The same Runtime run twice gives the same result (the RNG is per
    run), with heterogeneous speeds and a split cost function."""
    def run(c):
        speeds = [1.0 + 0.25 * (i % 3) for i in range(p)]
        cost = _cost(c, split_cost_fn=lambda w: 0.01 * w.size())
        rt = c.Runtime(p, cost, c.AdaptivePolicy(), seed=seed,
                       speeds=speeds)
        a = rt.run(c.WorkRange(0, N))
        b = rt.run(c.WorkRange(0, N))
        assert a == b
        return a
    _both(run)


@pytest.mark.parametrize("p", [1, 4, 16])
@pytest.mark.parametrize("depjoin", [False, True])
def test_legacy_shims_equal(p, depjoin):
    def shims(c):
        cost = _cost(c)
        w = c.WorkStealingSim(p, cost, depjoin=depjoin, seed=2).run(
            c.thief_splitting(c.WorkRange(0, N), p=p))
        a = c.AdaptiveSim(p, cost, seed=2, nano0=2).run(c.WorkRange(0, N))
        s = c.static_partition_sim(c.WorkRange(0, N), p, cost,
                                   num_blocks=2 * p)
        return w, a, s

    t, j = shims(tcore), shims(jcore)
    assert [dataclasses.asdict(r) for r in t] == \
        [dataclasses.asdict(r) for r in j]


@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("inner", ["join", "adaptive"])
def test_scheduler_simulate_faces_equal(p, inner):
    def faces(c):
        cost = _cost(c)
        w = c.thief_splitting(c.WorkRange(0, N), p=p)
        return [c.JoinScheduler().simulate(w, p, cost, depjoin=True, seed=1),
                c.by_blocks(first=32).simulate(
                    c.WorkRange(0, N), p, cost, seed=1,
                    inner=POLICIES[inner](c),
                    stop_predicate=_stop_at(900)),
                c.adaptive(p).simulate(c.WorkRange(0, N), None, cost,
                                       nano0=4, seed=1)]

    assert [dataclasses.asdict(r) for r in faces(tcore)] == \
        [dataclasses.asdict(r) for r in faces(jcore)]


@pytest.mark.parametrize("seed", range(6))
def test_fault_plan_random_equal(seed):
    kw = dict(p=9, horizon=1000.0, n_deaths=2, n_slowdowns=3,
              slow_factor=0.3)
    t, j = tcore.FaultPlan.random(seed, **kw), jcore.FaultPlan.random(seed,
                                                                      **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [t.death_time(w) for w in range(9)] == \
        [j.death_time(w) for w in range(9)]
    assert [t.speed_factor(w, 400.0) for w in range(9)] == \
        [j.speed_factor(w, 400.0) for w in range(9)]


def test_fault_plan_step_queries_equal():
    def plan(c):
        return c.FaultPlan(
            checkpoint_faults=(c.CheckpointWriteFault(2),),
            corruptions=(c.CorruptionFault(3, "manifest"),),
            preemptions=(c.PreemptionFault(4),),
            host_deaths=(c.HostDeath(1, 5),),
            slot_deaths=(c.SlotDeath(2, 0), c.SlotDeath(2, 3)))

    t, j = plan(tcore), plan(jcore)
    assert not t.has_runtime_events()
    for k in range(7):
        assert t.checkpoint_write_fails(k) == j.checkpoint_write_fails(k)
        assert t.preempt_at(k) == j.preempt_at(k)
        assert (dataclasses.asdict(t.host_death_at(k))
                if t.host_death_at(k) else None) == \
            (dataclasses.asdict(j.host_death_at(k))
             if j.host_death_at(k) else None)
        assert [dataclasses.astuple(s) for s in t.slot_deaths_at(k)] == \
            [dataclasses.astuple(s) for s in j.slot_deaths_at(k)]


@pytest.mark.parametrize("n", [1, 3, 5, 7])
def test_perm_range_ranks_and_total(n):
    total = tcore.total_permutations(n)
    assert total == jcore.total_permutations(n) == math.factorial(n)
    for rank in range(0, total, max(1, total // 17)):
        assert tcore.divisible._perm_from_rank(n, rank) == \
            jcore.divisible._perm_from_rank(n, rank)
    t, j = tcore.PermRange(n, 0, total), jcore.PermRange(n, 0, total)
    tl, tr = t.divide_at(total // 3)
    jl, jr = j.divide_at(total // 3)
    assert tr.current_permutation() == jr.current_permutation()
    seen_t = tl.partial_fold([], lambda s, p: s + [tuple(p)], total)
    seen_j = jl.partial_fold([], lambda s, p: s + [tuple(p)], total)
    assert seen_t == seen_j and tl.start == jl.start
    assert t.split_cost == j.split_cost


@pytest.mark.parametrize("n,demand", [(1000, 132), (97, 7), (5, 16)])
def test_schedule_join_and_adaptive_equal(n, demand):
    def run(c):
        w = c.thief_splitting(c.WorkRange(0, n), p=8)
        plan = c.JoinScheduler().plan(w)
        joined = c.schedule_join(w, lambda leaf: sum(leaf.indices()),
                                 lambda a, b: a + b)
        aplan = c.adaptive(demand).plan(c.WorkRange(0, n))
        adapt = c.adaptive(demand).schedule(
            c.WorkRange(0, n), lambda leaf: [leaf.start, leaf.stop],
            lambda a, b: a + b)
        wrapped = c.wrap_iter(c.join_context(c.WorkRange(0, n), 3))
        return (plan.leaf_sizes(), plan.divisions, joined,
                aplan.leaf_sizes(), aplan.divisions, adapt,
                [(x.start, x.stop) for x in wrapped.leaves()])

    t = run(tcore)
    assert t == run(jcore)
    assert t[2] == sum(range(n))


@pytest.mark.parametrize("kind", ["tile", "zip"])
def test_tile_grid_and_zip_plans_equal(kind):
    def plan(c):
        if kind == "tile":
            w = c.TileGrid2D(c.WorkRange(0, 12), c.WorkRange(0, 40))
        else:
            w = c.ZipDivisible((c.WorkRange(0, 100), c.SeqWork(0, 100,
                                                                align=4)))
        p = c.build_plan(c.bound_depth(w, 4))
        return p.leaf_sizes(), p.divisions, repr(p.leaves()[0])

    assert plan(tcore) == plan(jcore)


@pytest.mark.parametrize("first_grant,growth", [(1, 2), (3, 2), (1, 3)])
def test_work_loop_geometric_grants(first_grant, growth):
    """The reference's cases (test_schedulers.py): all iterations run,
    in ceil(log_growth(total)) + 1 grants or fewer."""
    grants = []

    def advance(s, n):
        grants.append(n)
        return s + n

    out = tcore.work_loop(0, advance, total=1000, first_grant=first_grant,
                          growth=growth)
    assert out == 1000 and sum(grants) == 1000
    assert len(grants) <= math.ceil(math.log(1000, growth)) + 1
    assert grants[:2] == [first_grant, first_grant * growth]


def test_work_loop_early_stop_matches_reference():
    import jax
    import jax.numpy as jnp

    def jadvance(state, n):
        return jax.lax.fori_loop(0, n, lambda i, s: s + 1, state)

    ref = int(jcore.work_loop(jnp.int32(0), jadvance, total=1 << 20,
                              should_stop=lambda s: s >= 100,
                              first_grant=1))
    checks = []

    def stop(s):
        checks.append(s)
        return s >= 100

    out = tcore.work_loop(0, lambda s, n: s + n, total=1 << 20,
                          should_stop=stop, first_grant=1)
    assert out == ref and 100 <= out <= 256
    assert len(checks) == 7          # grants 1, 2, ..., 64: one check each
    capped = tcore.work_loop(0, lambda s, n: s + n, total=100,
                             first_grant=8, max_grant=16)
    assert capped == 100


def test_core_all_equal():
    assert set(tcore.__all__) == set(jcore.__all__)
    for name in tcore.__all__:
        assert hasattr(tcore, name)
