"""The port's serving chaos (``repro_torch.chaos``), simulated admission and
drain hooks against the JAX engines on the same weights (llama3-8b smoke
config, fp32): greedy tokens must be exactly equal, request by request."""

import dataclasses
import os
import signal

import jax
import numpy as np
import pytest

from repro.chaos import serving as jchaos
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.core import FaultPlan as JFaultPlan
from repro.core import SlotDeath as JSlotDeath
from repro.models.model import Model as JaxModel
from repro.serve import engine as je
from repro_torch.chaos import (ReplayResult, SlotDeathInjector, TraceItem,
                               make_request, replay, slo_mix_trace)
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import FaultPlan, SlotDeath
from repro_torch.models.model import Model
from repro_torch.serve import engine as te
from repro_torch.weights import from_numpy_params


def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(fp32(jax_smoke("llama3-8b")))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = fp32(get_smoke_config("llama3-8b"))
    tm = Model(cfg, device="cpu")
    return jm, jp, tm, from_numpy_params(jax.tree.map(np.asarray, jp), cfg,
                                         "cpu")


def _continuous(mod, model, params, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("eos_id", 7)
    kw.setdefault("max_seq", 224)
    return mod.ContinuousEngine(model, params, mod.EngineConfig(**kw))


def _tokens(res):
    return {r.rid: np.asarray(r.result).tolist() for r in res.served}


def _drained(eng):
    """Every slot, page and admission lease returned."""
    return (all(s is None for s in eng.slots) and eng._job is None
            and eng._parked is None
            and len(eng.pages.free) == eng.pages.num_pages
            and eng._admission.counter.value == 1)


TRACE = tuple(TraceItem(rid=i, arrival=0.0, prompt_len=16 + 7 * i,
                        max_new=12) for i in range(4))


def test_make_request_and_trace_match_reference():
    classes = dict(interactive=dict(n=3, prompt_len=12, max_new=4,
                                    deadline_s=0.5, priority=2,
                                    tenants=("a", "b")),
                   batch=dict(n=4, prompt_len=40, max_new=9))
    t = slo_mix_trace(5, span_s=2.0, classes=classes, start_rid=3)
    j = jchaos.slo_mix_trace(5, span_s=2.0, classes=classes, start_rid=3)
    assert [dataclasses.astuple(x) for x in t] == \
        [dataclasses.astuple(x) for x in j]
    for item in t:
        a = make_request(item, 512, seed=4)
        b = jchaos.make_request(jchaos.TraceItem(*dataclasses.astuple(item)),
                                512, seed=4)
        assert np.array_equal(a.prompt, b.prompt)
        assert (a.rid, a.max_new, a.slo, a.priority, a.deadline_s,
                a.tenant) == (b.rid, b.max_new, b.slo, b.priority,
                              b.deadline_s, b.tenant)


def test_slot_death_replay_matches_jax(pair):
    """Calm replays give the JAX engine's tokens; a slot-death storm (one
    death naming a lane that does not exist) conserves every rid, requeues
    each killed request once and re-serves it to the same tokens."""
    jm, jp, tm, tp = pair
    vocab = tm.cfg.vocab_size
    jcalm = jchaos.replay(_continuous(je, jm, jp),
                          tuple(jchaos.TraceItem(*dataclasses.astuple(x))
                                for x in TRACE), vocab=vocab)
    calm = replay(_continuous(te, tm, tp), TRACE, vocab=vocab)
    assert isinstance(calm, ReplayResult) and calm.conserved(TRACE)
    refs = _tokens(calm)
    assert refs == _tokens(jcalm)

    deaths = (SlotDeath(at_step=2, slot=0), SlotDeath(at_step=4, slot=1),
              SlotDeath(at_step=6, slot=9))
    inj = SlotDeathInjector(FaultPlan(slot_deaths=deaths))
    eng = _continuous(te, tm, tp)
    stormy = replay(eng, TRACE, vocab=vocab, on_step=inj)
    assert stormy.conserved(TRACE) and not stormy.shed
    assert 1 <= len(inj.killed) <= 2 and all(s != 9 for _, s in inj.killed)
    assert eng.telemetry.slot_deaths == len(inj.killed)
    assert eng.telemetry.snapshot()["slot_deaths"] == len(inj.killed)
    assert sum(r.requeues for r in stormy.served) == len(inj.killed)
    assert _tokens(stormy) == refs
    assert _drained(eng)

    # the JAX engine under the same plan re-serves to the same tokens too
    jinj = jchaos.SlotDeathInjector(JFaultPlan(slot_deaths=tuple(
        JSlotDeath(d.at_step, d.slot) for d in deaths)))
    jstormy = jchaos.replay(_continuous(je, jm, jp),
                            tuple(jchaos.TraceItem(*dataclasses.astuple(x))
                                  for x in TRACE), vocab=vocab,
                            on_step=jinj)
    assert _tokens(jstormy) == refs


def _slo_reqs(cls, vocab, n=4):
    rng = np.random.RandomState(7)
    return [cls(rid=i, prompt=rng.randint(8, vocab, size=24 + 9 * i)
                .astype(np.int32), max_new=10) for i in range(n)]


def _serve(eng, reqs, max_steps=200):
    for r in reqs:
        eng.submit(r)
    done = []
    for _ in range(max_steps):
        if not eng.pending:
            break
        done.extend(eng.step())
    return done


def test_sigterm_drain_and_handoff_match_jax(pair):
    """A real SIGTERM after the first step: in-flight slots drain, the
    queue freezes for handoff, a fresh engine serves it; every rid once,
    tokens == the JAX engine's undisturbed run."""
    jm, jp, tm, tp = pair
    vocab = tm.cfg.vocab_size
    refs = {r.rid: np.asarray(r.result).tolist() for r in
            _serve(_continuous(je, jm, jp), _slo_reqs(je.Request, vocab))}
    assert sorted(refs) == [0, 1, 2, 3]

    eng = _continuous(te, tm, tp, prefill_block_budget=1)
    prev = signal.getsignal(signal.SIGTERM)
    done = []
    try:
        old = eng.install_signal_handlers()
        assert old == {signal.SIGTERM: prev}
        for r in _slo_reqs(te.Request, vocab):
            eng.submit(r)
        done.extend(eng.step())           # some work in flight
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(200):              # drain mode: no new admissions
            if not eng.pending:
                break
            done.extend(eng.step())
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert eng.preempted
    waiting = eng.handoff()
    assert waiting and eng.queue == []
    assert _drained(eng)
    done.extend(_serve(_continuous(te, tm, tp), waiting))
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    for r in done:
        assert np.asarray(r.result).tolist() == refs[r.rid]


def _simulated(mod, model, params, lanes, prompts, news):
    eng = mod.Engine(model, params, mod.EngineConfig(
        max_batch=4, eos_id=7, max_seq=1040, admission="simulate"))
    if lanes is not None:
        eng.admission_sim = mod.AdmissionSimulator(lanes=lanes)
    for i, (p, m) in enumerate(zip(prompts, news)):
        eng.submit(mod.Request(rid=i, prompt=p, max_new=m))
    sizes, toks = [], {}
    while eng.queue or eng._residual is not None:
        batch = eng.step()
        sizes.append(len(batch))
        toks.update({r.rid: np.asarray(r.result).tolist() for r in batch})
    return sizes, toks


def _replayed_sizes(lens, lanes, max_batch):
    """``choose`` replayed on the host over the shrinking queue."""
    sim, q, out = te.AdmissionSimulator(lanes=lanes), list(lens), []
    while q:
        k = sim.choose(q, max_batch)
        out.append(k)
        q = q[k:]
    return out


@pytest.mark.parametrize("lanes", [None, 2])
def test_simulated_admission_matches_jax(pair, lanes):
    """``admission="simulate"``: batch sizes and tokens equal the JAX
    engine's, at the engine's own simulator (lanes = max_batch) and at 2
    lanes, and the sizes equal ``choose`` replayed on the host."""
    jm, jp, tm, tp = pair
    rng = np.random.RandomState(3)
    lens = (300, 290, 280, 1000, 900, 64, 64, 64)
    prompts = [rng.randint(3, 512, size=n).astype(np.int32) for n in lens]
    news = [int(x) for x in rng.randint(2, 9, size=len(lens))]
    t = _simulated(te, tm, tp, lanes, prompts, news)
    assert t == _simulated(je, jm, jp, lanes, prompts, news)
    sizes, toks = t
    assert sorted(toks) == list(range(len(lens)))
    assert sizes == _replayed_sizes(lens, lanes or 4, 4)
    # at 4 lanes the 1000-token prompt would stretch a batch of 4 past
    # the useful rate of 3; at 2 lanes two at a time
    assert sizes == ([3, 4, 1] if lanes is None else [2, 2, 2, 2])


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("lanes,max_batch", [(2, 8), (4, 4), (8, 8),
                                             (3, 16)])
def test_admission_simulator_choose_matches_reference(seed, lanes,
                                                      max_batch):
    rng = np.random.RandomState(seed)
    sim, ref = te.AdmissionSimulator(lanes=lanes), \
        je.AdmissionSimulator(lanes=lanes)
    for n in (1, 3, 10):
        lengths = [int(x) for x in rng.choice(
            [64, 100, 280, 300, 900, 1024], size=n)]
        assert sim.choose(lengths, max_batch) == \
            ref.choose(lengths, max_batch)
        # non-increasing prompts within the lanes: every extra request
        # raises the useful rate, so all are admitted
        desc = sorted(lengths, reverse=True)
        if min(n, max_batch) <= lanes:
            assert sim.choose(desc, max_batch) == min(n, max_batch) == \
                ref.choose(desc, max_batch)


def test_admission_simulator_reference_cases():
    """The reference's behaviour at 2 lanes and max_batch 8."""
    sim = te.AdmissionSimulator(lanes=2)
    assert sim.choose([300, 290, 280, 1000, 900, 64, 64, 64], 8) == 2
    assert sim.choose([1024] + [64] * 7, 8) == 2
    assert sim.choose([64, 1024, 64, 1024, 64, 64, 64, 64], 8) == 4
