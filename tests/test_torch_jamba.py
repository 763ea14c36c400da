"""The jamba smoke model served whole on the CPU: one period of 8 layers
(Mamba at positions 0-3 and 5-7, GQA attention at 4; a top-2 MoE FFN on
every other layer), with the attention layer's KV cache and the Mamba
layers' SSM and conv state in one cache tree, against the JAX package:
``Model.prefill``, chunked prefill, decode steps and ``ContinuousEngine``
tokens, on weights from the reference's ``Model.init`` carried over with
``from_numpy_params``, in fp32, where the kernel wrappers run their plain
twins.  The full config stays refused (more than one card).

Tolerances: logits and the KV cache within 1e-5 of the largest reference
value (normwise relative; fp32 summation order), the Mamba state (``ssm``,
``conv``) within 1e-4, the SSM mixers' tolerance in
``tests/test_torch_ssm.py`` (a recurrence carried over 64 positions and
8 layers); token ids exactly.
Inputs come from seeded numpy generators and ``pytest.mark.parametrize``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models.model import Model as JaxModel
from repro.serve import engine as je
from repro.serve.prefill import ChunkedPrefill as JaxChunkedPrefill
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models.model import Model
from repro_torch.serve.engine import ContinuousEngine, EngineConfig, Request
from repro_torch.serve.prefill import ChunkedPrefill
from repro_torch.weights import from_numpy_params

ARCH = "jamba-1.5-large-398b"
REL = 1e-5
STATE_REL = 1e-4         # Mamba ssm / conv state


def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(t, j, rel=REL):
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape
    err = float(np.abs(t - j).max()) / max(float(np.abs(j).max()), 1e-30)
    assert err <= rel, err


@functools.lru_cache(maxsize=None)
def _pair(strategy):
    jm = JaxModel(fp32(jax_smoke(ARCH)), moe_strategy=strategy)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = fp32(get_smoke_config(ARCH))
    return jm, jp, cfg, from_numpy_params(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(3, 512, (B, S)).astype(
        np.int32)


def _cache_close(tc, jc):
    for tlayer, jlayer in zip(tc["stage"], jc["stage"]):
        assert sorted(tlayer) == sorted(jlayer)
        for name, arr in jlayer.items():
            _rel(tlayer[name], arr, REL if name in ("k", "v") else STATE_REL)


def test_registry_serves_the_smoke_config_only():
    cfg = get_smoke_config(ARCH)
    assert cfg.name == jax_smoke(ARCH).name
    with pytest.raises(NotImplementedError, match="item 15"):
        get_config(ARCH)
    tm = Model(fp32(cfg), device="cpu")
    assert [s.kind for s in tm.period_specs] == \
        ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [s.is_moe for s in tm.period_specs] == [False, True] * 4
    assert not tm.recurrent_only
    cache = tm.init_cache(2, 32)
    assert sorted(cache["stage"][4]) == ["k", "v"]
    assert sorted(cache["stage"][0]) == ["conv", "ssm"]


@pytest.mark.parametrize("scan_impl", ["lax", "pallas"])
@pytest.mark.parametrize("strategy", ["einsum", "sort"])
@pytest.mark.parametrize("S", [24, 40])
def test_prefill_matches(S, strategy, scan_impl):
    """Both MoE dispatches, both SSM backends (the reference's "lax");
    logits and the one cache tree (KV and SSM state)."""
    jm, jp, cfg, tp = _pair(strategy)
    toks = _tokens(2, S, seed=S)
    jl_, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=S + 8)
    tm = Model(cfg, device="cpu", moe_strategy=strategy, scan_impl=scan_impl)
    tl_, tc = tm.prefill(tp, _t(toks), max_seq=S + 8)
    _rel(tl_, jl_)
    _cache_close(tc, jc)


@pytest.mark.parametrize("strategy", ["einsum", "sort"])
def test_chunked_prefill_and_decode_match(strategy):
    """Chunked prefill (blocks 16, 32, 16) then 8 greedy decode steps:
    logits within REL, tokens identical, the cache tree the reference's."""
    jm, jp, cfg, tp = _pair(strategy)
    tm = Model(cfg, device="cpu", moe_strategy=strategy)
    B, S = 2, 64
    toks = _tokens(B, S, seed=3)
    want, jc, _ = JaxChunkedPrefill(jm, first_block=16, align=16,
                                    max_block=32).run(
        jp, jnp.asarray(toks), jm.init_cache(B, S + 8))
    got, tc, stats = ChunkedPrefill(tm, first_block=16, align=16,
                                    max_block=32).run(
        tp, _t(toks), tm.init_cache(B, S + 8))
    assert stats.blocks == 3
    _rel(got, want)
    _cache_close(tc, jc)
    jdecode = jax.jit(jm.decode_step)
    lens = np.full((B,), S, np.int32)
    jl_, tl_ = want, got
    for _ in range(8):
        nxt = np.asarray(jnp.argmax(jl_, -1)).astype(np.int32)
        assert torch.argmax(tl_, -1).tolist() == nxt.tolist()
        jl_, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.asarray(lens))
        tl_, tc = tm.decode_step(tp, _t(nxt), tc, _t(lens))
        _rel(tl_, jl_)
        lens = lens + 1
    _cache_close(tc, jc)


def _drain(engine, max_steps=500):
    out, steps = {}, 0
    while engine.pending:
        for r in engine.step():
            out[r.rid] = r
        steps += 1
        assert steps < max_steps, "engine made no progress"
    return out


@pytest.mark.parametrize("sort_fn", [None, "pallas"])
def test_continuous_engine_matches_reference_tokens(sort_fn):
    """Six mixed-length requests through 3 continuous slots: the port's
    tokens equal the JAX engine's exactly (fp32, the sort dispatch; K3's
    twin and ``torch.argsort`` route alike)."""
    jm, jp, cfg, tp = _pair("sort")
    prompts = [np.random.RandomState(11 + i).randint(3, 512, size=n)
               .astype(np.int32) for i, n in enumerate((9, 33, 17, 51, 12,
                                                        40))]
    news = (10, 6, 14, 8, 12, 5)
    kw = dict(max_batch=3, eos_id=7, max_seq=256, decode_tick=4)
    jeng = je.ContinuousEngine(jm, jp, je.EngineConfig(**kw))
    teng = ContinuousEngine(Model(cfg, device="cpu", moe_strategy="sort",
                                  moe_sort_fn=sort_fn), tp,
                            EngineConfig(**kw))
    for i, (pr, mn) in enumerate(zip(prompts, news)):
        jeng.submit(je.Request(rid=i, prompt=pr, max_new=mn))
        teng.submit(Request(rid=i, prompt=pr, max_new=mn))
    want = {rid: np.asarray(r.result).tolist()
            for rid, r in _drain(jeng).items()}
    assert {rid: r.result.tolist() for rid, r in _drain(teng).items()} \
        == want
    assert len(teng.pages.free) == teng.pages.num_pages
