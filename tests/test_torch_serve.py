"""The port's serving stack (``repro_torch.serve``) against the JAX engines
on the same weights (llama3-8b smoke config, fp32): greedy tokens must be
exactly equal, request by request."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models.model import Model as JaxModel
from repro.serve import engine as je
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.serve.early_exit import decode_until_eos
from repro_torch.serve.engine import (ContinuousEngine, Engine, EngineConfig,
                                      Request)
from repro_torch.serve.prefill import ChunkedPrefill
from repro_torch.weights import from_numpy_params

ROOT = Path(__file__).resolve().parents[1]


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


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, 512, size=n).astype(np.int32) for n in lens]


def _reqs(cls, prompts, max_news):
    return [cls(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_news))]


def _drain(engine, max_steps=500):
    out, order, steps = {}, [], 0
    while engine.pending:
        for r in engine.step():
            out[r.rid] = r
            order.append(r.rid)
        steps += 1
        assert steps < max_steps, "engine made no progress"
    return out, order


def _one_at_a_time(model, params, prompts, max_news, **kw):
    out = []
    for p, m in zip(prompts, max_news):
        eng = Engine(model, params, EngineConfig(max_batch=1, **kw))
        eng.submit(Request(rid=0, prompt=p, max_new=m))
        (done,) = eng.step()
        out.append(done.result.tolist())
    return out


def test_engine_mixed_lengths_match_jax(pair):
    jm, jp, tm, tp = pair
    prompts, news = _prompts((9, 33, 17, 26)), (6, 9, 7, 8)
    kw = dict(max_batch=4, eos_id=7, max_seq=256)
    jeng = je.Engine(jm, jp, je.EngineConfig(**kw))
    teng = Engine(tm, tp, EngineConfig(**kw))
    for r in _reqs(je.Request, prompts, news):
        jeng.submit(r)
    for r in _reqs(Request, prompts, news):
        teng.submit(r)
    jdone = {r.rid: r for r in jeng.step()}
    tdone = {r.rid: r for r in teng.step()}
    got = [tdone[i].result.tolist() for i in range(4)]
    assert got == [np.asarray(jdone[i].result).tolist() for i in range(4)]
    assert got == _one_at_a_time(tm, tp, prompts, news, eos_id=7,
                                 max_seq=256)
    for i, m in enumerate(news):
        st = tdone[i].stats
        assert 1 <= len(got[i]) <= m and st.useful_tokens == len(got[i])
        assert st.wasted_tokens == st.steps_run - (st.useful_tokens - 1)


def test_continuous_engine_matches_jax(pair):
    """6 mixed-length requests through 3 slots, decode_tick=4: the port's
    tokens equal the JAX ContinuousEngine's and serving each alone; after
    the drain every page is free and the cap counter is back to 1."""
    jm, jp, tm, tp = pair
    prompts = _prompts((9, 33, 17, 51, 12, 40))
    news = (10, 6, 14, 8, 12, 5)
    kw = dict(max_batch=3, eos_id=7, max_seq=256, decode_tick=4)
    jeng = je.ContinuousEngine(jm, jp, je.EngineConfig(**kw))
    teng = ContinuousEngine(tm, tp, EngineConfig(**kw))
    for r in _reqs(je.Request, prompts, news):
        jeng.submit(r)
    for r in _reqs(Request, prompts, news):
        teng.submit(r)
    jdone, _ = _drain(jeng)
    tdone, _ = _drain(teng)
    got = [tdone[i].result.tolist() for i in range(6)]
    assert got == [np.asarray(jdone[i].result).tolist() for i in range(6)]
    assert got == _one_at_a_time(tm, tp, prompts, news, eos_id=7,
                                 max_seq=256)
    assert teng.telemetry.retired == len(prompts)
    assert len(teng.pages.free) == teng.pages.num_pages
    assert teng._admission.counter.value == 1
    assert all(s is None for s in teng.slots)
    assert teng.telemetry.admissions == jeng.telemetry.admissions == 6


def test_continuous_preempt_resume_matches_jax(pair):
    """prefill_block_budget=1: the long prompt's chunked prefill is
    preempted every step while decode keeps ticking; the short requests
    behind it finish first and every token equals the JAX engine's."""
    jm, jp, tm, tp = pair
    rng = np.random.RandomState(1)
    prompts = [rng.randint(3, 512, size=130).astype(np.int32)] + \
        [rng.randint(3, 512, size=10 + i).astype(np.int32) for i in (1, 2)]
    news = (12, 4, 4)
    kw = dict(max_batch=2, eos_id=7, max_seq=192, decode_tick=2,
              prefill_block_budget=1)
    jeng = je.ContinuousEngine(jm, jp, je.EngineConfig(**kw))
    teng = ContinuousEngine(tm, tp, EngineConfig(**kw))
    for r in _reqs(je.Request, prompts, news):
        jeng.submit(r)
    for r in _reqs(Request, prompts, news):
        teng.submit(r)
    jdone, _ = _drain(jeng)
    tdone, order = _drain(teng)
    assert teng.telemetry.prefill_preemptions >= 2
    assert order[-1] == 0
    for i in range(3):
        assert tdone[i].result.tolist() == np.asarray(jdone[i].result
                                                      ).tolist()


def test_sync_engine_preempt_resume(pair):
    """The sync engine's residual: a budget of one prefill block per step
    yields empty steps, then the same tokens as an unbudgeted run."""
    _, _, tm, tp = pair
    prompts, news = _prompts((70, 12), seed=5), (5, 7)
    base = _one_at_a_time(tm, tp, prompts, news, eos_id=7, max_seq=256)
    eng = Engine(tm, tp, EngineConfig(max_batch=2, eos_id=7, max_seq=256,
                                      prefill_block_budget=1))
    for r in _reqs(Request, prompts, news):
        eng.submit(r)
    steps, done = 0, []
    while not done:
        done = eng.step()
        steps += 1
    # padded to 128; each resume restarts the geometric sizes at 32
    assert steps == 4
    assert [r.result.tolist() for r in sorted(done, key=lambda r: r.rid)] \
        == base


def test_cache_bytes_matches_jax(pair):
    from repro.serve.kvcache import cache_bytes as jax_cache_bytes
    from repro_torch.serve.kvcache import cache_bytes
    jm, _, tm, _ = pair
    for batch, seq in ((1, 64), (3, 200)):
        assert cache_bytes(tm, batch, seq) == jax_cache_bytes(jm, batch, seq)


def test_page_exhaustion_defers_admission(pair):
    _, _, tm, tp = pair
    prompts, news = _prompts((9, 70), seed=2), (20, 20)
    eng = ContinuousEngine(tm, tp, EngineConfig(
        max_batch=2, eos_id=7, max_seq=128, decode_tick=4, page_size=32,
        num_pages=3))
    for r in _reqs(Request, prompts, news):
        eng.submit(r)
    done, _ = _drain(eng)
    assert eng.telemetry.deferred_pages > 0
    assert len(eng.pages.free) == 3
    assert [done[i].result.tolist() for i in range(2)] == _one_at_a_time(
        tm, tp, prompts, news, eos_id=7, max_seq=192)


def test_chunked_prefill_matches_full_and_cancels(pair):
    _, _, tm, tp = pair
    toks = torch.from_numpy(np.stack(_prompts((96, 96), seed=3)))
    full, _ = tm.prefill(tp, toks, max_seq=96)
    cp = ChunkedPrefill(tm, first_block=16, align=16, max_block=64)
    logits, _, st = cp.run(tp, toks, tm.init_cache(2, 96))
    assert st.tokens == 96 and st.blocks == 3
    np.testing.assert_allclose(logits.numpy(), full.numpy(), atol=1e-4,
                               rtol=1e-4)
    # preempt after one block, resume from the returned cache
    part, cache, st = cp.run(tp, toks, tm.init_cache(2, 96), max_blocks=1,
                             row_lengths=[96, 50])
    assert st.preempted and st.next_start == 16
    rest, _, _ = cp.run(tp, toks, cache, start=16, row_lengths=[96, 50],
                        gathered=part)
    whole, _, _ = cp.run(tp, toks, tm.init_cache(2, 96),
                         row_lengths=[96, 50])
    np.testing.assert_allclose(rest.numpy(), whole.numpy(), atol=1e-5,
                               rtol=1e-5)
    calls = [0]

    def cancel():
        calls[0] += 1
        return calls[0] >= 2

    out, _, st = cp.run(tp, toks, tm.init_cache(2, 96), should_cancel=cancel)
    assert out is None and st.cancelled and st.tokens < 96


def test_decode_until_eos_waste_matches_jax(pair):
    jm, jp, tm, tp = pair
    toks = np.stack(_prompts((16,) * 4, seed=4))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=80)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_seq=80)
    first = torch.argmax(tl, -1).to(torch.int32)
    eos = int(first[0])                   # row 0 finishes at once
    from repro.serve.early_exit import decode_until_eos as jax_until
    jgen, _, jst = jax_until(jm, jp, jnp.asarray(first.numpy()), jc,
                             jnp.full((4,), 16, jnp.int32), eos_id=eos,
                             max_new=20, first_block=4)
    tgen, _, tst = decode_until_eos(tm, tp, first, tc,
                                    torch.full((4,), 16, dtype=torch.int32),
                                    eos_id=eos, max_new=20, first_block=4)
    assert tgen.tolist() == np.asarray(jgen).tolist()
    assert dataclasses.asdict(tst) == dataclasses.asdict(jst)
    assert tst.wasted_tokens > 0


def test_simulate_admission_and_chaos_hooks_run(pair):
    """``admission="simulate"`` and the chaos / drain hooks are served
    (they raised before the Runtime was ported); bad configurations still
    raise ``ValueError``."""
    _, _, tm, tp = pair
    eng = Engine(tm, tp, EngineConfig(admission="simulate", max_batch=4,
                                      eos_id=7, max_seq=128))
    assert eng.admission_sim.lanes == 4
    for r in _reqs(Request, _prompts((9, 20, 5)), (3, 3, 3)):
        eng.submit(r)
    assert sorted(r.rid for r in eng.step()) == [0, 1, 2]
    # the gated tick is ported: only its configuration is checked
    with pytest.raises(ValueError, match="exit_entropy"):
        EngineConfig(exit_entropy=0.0)
    eng = ContinuousEngine(tm, tp, EngineConfig(max_batch=1, max_seq=64,
                                                admission="simulate"))
    assert eng.kill_slot(0) is False and eng.kill_slot(5) is False
    assert eng.handoff() == []
    import signal
    old = eng.install_signal_handlers()
    try:
        assert signal.getsignal(signal.SIGTERM) == eng._on_signal
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(rid=0, prompt=np.arange(50, dtype=np.int32) + 3,
                           max_new=32))


def test_launcher_runs_on_cpu_and_refuses_a_missing_card(capsys):
    from repro_torch.launch import serve
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = ["--smoke", "--requests", "3", "--max-new", "6"]
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *args, "--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "served 3/3 with the continuous engine" in res.stdout
    serve.main(args + ["--device", "cpu", "--engine", "sync"])
    assert "served 3/3 with the sync engine" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(args)
