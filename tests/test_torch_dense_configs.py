"""The dense configs served beside llama3-8b — yi-9b (GQA 32/4), chatglm3-6b
(32/2, half-rotary) and minitron-4b (24/8, the relu² FFN with biases) —
against the JAX package: their smoke models on the reference's
``Model.init`` weights carried over with ``from_numpy_params``, in fp32 on
the CPU, where K1's and K2's wrappers run their plain twins.

Tolerances: logits and layer outputs atol 1e-5 (fp32 summation order; the
logits are O(0.5)); token ids, cache rows and parameter counts exactly.
Inputs come from seeded numpy generators and ``pytest.mark.parametrize``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import attention as ja
from repro.models import transformer as jtr
from repro.models.model import Model as JaxModel
from repro.serve import engine as je
from repro.serve import kvcache as jkv
from repro_torch.configs.registry import (NOT_PORTED, get_config,
                                          get_smoke_config)
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr
from repro_torch.models.model import Model
from repro_torch.serve import kvcache as tkv
from repro_torch.serve.engine import (ContinuousEngine, Engine, EngineConfig,
                                      Request)
from repro_torch.weights import from_numpy_params

ARCHS = ("yi-9b", "chatglm3-6b", "minitron-4b")
TOL = dict(atol=1e-5, rtol=0)


def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(3, 512, (B, S)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """The smoke model of ``arch`` in fp32 in both packages, one set of
    weights (the reference's)."""
    jm = JaxModel(fp32(jax_smoke(arch)))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = fp32(get_smoke_config(arch))
    return jm, jp, cfg, from_numpy_params(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")


def test_registry_serves_the_new_configs():
    """``get_config`` and ``get_smoke_config`` return the served configs
    (these four, whisper-medium and llama-3.2-vision-11b); the one left
    unported, jamba's full config, names its ROADMAP item, and its smoke
    config is served."""
    for arch in ARCHS + ("deepseek-v2-lite-16b", "whisper-medium",
                         "llama-3.2-vision-11b"):
        assert arch not in NOT_PORTED
        assert get_config(arch).name == jax_config(arch).name
        assert get_smoke_config(arch).name == jax_smoke(arch).name
    assert sorted(NOT_PORTED) == ["jamba-1.5-large-398b"]
    for arch in NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)
        assert get_smoke_config(arch).name == jax_smoke(arch).name


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch):
    """Field for field the reference's config (dtypes aside: torch's)."""
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))):
        for f in dataclasses.fields(ref):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch, active_only):
    assert get_config(arch).param_count(active_only=active_only) == \
        jax_config(arch).param_count(active_only=active_only)
    assert get_smoke_config(arch).param_count(active_only=active_only) == \
        jax_smoke(arch).param_count(active_only=active_only)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_layout_matches_reference(arch):
    """``Model.init`` builds the reference's tree leaf for leaf in shape
    (minitron's FFN: ``up``, ``up_b``, ``down``, ``down_b``, the biases
    zero), and the carried weights are the reference's bit for bit."""
    jm, jp, cfg, tp = _pair(arch)
    mine = Model(cfg, device="cpu").init(0)
    shape = {jax.tree_util.keystr(p): tuple(np.shape(a))
             for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    assert {jax.tree_util.keystr(p): tuple(t.shape)
            for p, t in jax.tree_util.tree_leaves_with_path(mine)} == shape
    assert {jax.tree_util.keystr(p): tuple(t.shape)
            for p, t in jax.tree_util.tree_leaves_with_path(tp)} == shape
    ffn = mine["stage"][0]["ffn"]
    if cfg.ffn_type == "relu2":
        assert sorted(ffn) == ["down", "down_b", "up", "up_b"]
        assert not ffn["up_b"].any() and not ffn["down_b"].any()
    else:
        assert sorted(ffn) == ["down", "gate", "up"]
    for p, a in jax.tree_util.tree_leaves_with_path(jp):
        t = functools.reduce(lambda n, k: n[getattr(k, "key", getattr(
            k, "idx", None))], p, tp)
        assert np.array_equal(t.numpy(), np.asarray(a)), p


@pytest.mark.parametrize("seed", [0, 1])
def test_relu2_ffn_matches_reference(seed):
    """minitron's FFN, relu(x·up + up_b)²·down + down_b, with non-zero
    biases."""
    cfg = fp32(jax_smoke("minitron-4b"))
    r = np.random.RandomState(seed)
    p = {"up": r.randn(64, 128), "up_b": r.randn(128),
         "down": r.randn(128, 64) / 8, "down_b": r.randn(64)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.randn(2, 5, 64).astype(np.float32)
    want = jtr._ffn_apply(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x))
    got = ttr._ffn_apply(fp32(get_smoke_config("minitron-4b")),
                         {k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_gelu_mlp_init_is_the_reference_layout():
    gen = torch.Generator().manual_seed(0)
    p = tl.gelu_mlp_init(gen, 64, 96, torch.bfloat16, lead=(3,))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "up": (3, 64, 96), "up_b": (3, 96), "down": (3, 96, 64),
        "down_b": (3, 64)}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    assert not p["up_b"].any() and not p["down_b"].any()


@pytest.mark.parametrize("S", [24, 300])    # plain and blockwise branches
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match(arch, S):
    jm, jp, cfg, tp = _pair(arch)
    toks = _tokens(2, S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=S + 8)
    tl_, tc = Model(cfg, device="cpu").prefill(tp, _t(toks), max_seq=S + 8)
    _close(tl_, jl)
    for name in ("k", "v"):
        _close(tc["stage"][0][name], jc["stage"][0][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_at_offset_matches(arch):
    jm, jp, cfg, tp = _pair(arch)
    tm = Model(cfg, device="cpu")
    toks = _tokens(2, 40, seed=1)
    jc, tc = jm.init_cache(2, 48), tm.init_cache(2, 48)
    _, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, :16]), jc, 0)
    tm.prefill_chunk(tp, _t(toks[:, :16]), tc, 0)
    jl, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, 16:]), jc,
                              jnp.int32(16), all_logits=True)
    tl_, tc = tm.prefill_chunk(tp, _t(toks[:, 16:]), tc, 16,
                               all_logits=True)
    assert tuple(tl_.shape) == (2, 24, 512)
    _close(tl_, jl)
    for name in ("k", "v"):
        _close(tc["stage"][0][name], jc["stage"][0][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_eight_decode_steps_match(arch):
    jm, jp, cfg, tp = _pair(arch)
    tm = Model(cfg, device="cpu")
    toks = _tokens(3, 20, seed=2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=32)
    tl_, tc = tm.prefill(tp, _t(toks), max_seq=32)
    jdecode = jax.jit(jm.decode_step)
    lens = np.full((3,), 20, np.int32)
    for _ in range(8):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert torch.argmax(tl_, -1).tolist() == nxt.tolist()
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.asarray(lens))
        tl_, tc = tm.decode_step(tp, _t(nxt), tc, _t(lens))
        _close(tl_, jl)
        lens = lens + 1
    _close(tc["stage"][0]["v"], jc["stage"][0]["v"])


def _drain(engine, max_steps=500):
    out, steps = {}, 0
    while engine.pending:
        for r in engine.step():
            out[r.rid] = r
        steps += 1
        assert steps < max_steps, "engine made no progress"
    return out


PROMPTS = [np.random.RandomState(7 + i).randint(3, 512, size=n)
           .astype(np.int32) for i, n in enumerate((9, 33, 17, 51, 12, 40))]
NEWS = (10, 6, 14, 8, 12, 5)


@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_reference_tokens(arch):
    """Six mixed-length requests through 3 continuous slots, and three
    through the sync Engine: the port's tokens equal the JAX engines',
    exactly (fp32)."""
    jm, jp, cfg, tp = _pair(arch)
    kw = dict(max_batch=3, eos_id=7, max_seq=256, decode_tick=4)
    jeng = je.ContinuousEngine(jm, jp, je.EngineConfig(**kw))
    teng = ContinuousEngine(Model(cfg, device="cpu"), tp, EngineConfig(**kw))
    for i, (pr, mn) in enumerate(zip(PROMPTS, NEWS)):
        jeng.submit(je.Request(rid=i, prompt=pr, max_new=mn))
        teng.submit(Request(rid=i, prompt=pr, max_new=mn))
    want = {rid: np.asarray(r.result).tolist()
            for rid, r in _drain(jeng).items()}
    assert {rid: r.result.tolist() for rid, r in _drain(teng).items()} \
        == want
    assert len(teng.pages.free) == teng.pages.num_pages
    sync_kw = dict(max_batch=3, eos_id=7, max_seq=256)
    jsync = je.Engine(jm, jp, je.EngineConfig(**sync_kw))
    tsync = Engine(Model(cfg, device="cpu"), tp, EngineConfig(**sync_kw))
    for i, (pr, mn) in enumerate(zip(PROMPTS[:3], NEWS[:3])):
        jsync.submit(je.Request(rid=i, prompt=pr, max_new=mn))
        tsync.submit(Request(rid=i, prompt=pr, max_new=mn))
    assert {r.rid: r.result.tolist() for r in tsync.step()} == \
        {r.rid: np.asarray(r.result).tolist() for r in jsync.step()}


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_slot_insert_matches_reference(arch):
    """A batch=1 cache into slot 2 of a batched cache that holds other
    requests: the slot's K/V rows become the request's, the others stay,
    as the reference's insert leaves them; ``cache_bytes`` agrees too."""
    jm, jp, cfg, tp = _pair(arch)
    tm = Model(cfg, device="cpu")
    _, small = tm.prefill(tp, _t(_tokens(1, 10, seed=3)), max_seq=16)
    _, big = tm.prefill(tp, _t(_tokens(3, 16, seed=4)), max_seq=16)
    as_jax = functools.partial(jax.tree.map,
                               lambda t: jnp.asarray(t.numpy()))
    want = jkv.cache_slot_insert(as_jax(big), as_jax(small), 2)
    before = jax.tree.map(torch.clone, big)
    tkv.cache_slot_insert(big, small, 2)
    for name in ("k", "v"):
        got = big["stage"][0][name]
        assert torch.equal(got[:, 2], small["stage"][0][name][:, 0])
        assert torch.equal(got[:, :2], before["stage"][0][name][:, :2])
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want["stage"][0][name]))
    assert tkv.cache_bytes(tm, 4, 64) == jkv.cache_bytes(jm, 4, 64)


@pytest.mark.parametrize("G,KV", [(3, 2), (8, 1), (16, 1)])
@pytest.mark.parametrize("Sq,Sk,q_offset", [(8, 40, 24), (1, 33, 32)])
def test_k1_k2_twins_at_the_new_groups(G, KV, Sq, Sk, q_offset):
    """The GQA groups these configs bring to K1 and K2 (minitron 3, yi 8,
    chatglm 16): each kernel's plain twin against the reference's jnp
    attention."""
    r = np.random.RandomState(G * 10 + Sq)
    q = r.randn(2, Sq, G * KV, 16).astype(np.float32)
    k = r.randn(2, Sk, KV, 16).astype(np.float32)
    v = r.randn(2, Sk, KV, 16).astype(np.float32)
    want = jax.jit(functools.partial(ja.plain_attention, causal=True,
                                     q_offset=q_offset))(
        *map(jnp.asarray, (q, k, v)))
    _close(tfa.flash_attention(_t(q), _t(k), _t(v), q_offset=q_offset),
           want)
    assert G in tfd.GROUPS
    lens = np.array([Sk, 5], np.int32)
    want = jax.jit(ja.decode_attention)(*map(jnp.asarray, (
        q[:, 0], k, v, lens)))
    _close(tfd.flash_decode(_t(q[:, 0]), _t(k), _t(v), _t(lens)), want)


@pytest.mark.parametrize("arch", ARCHS + ("deepseek-v2-lite-16b",))
def test_launcher_serves_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                "3", "--max-new", "6"])
    out = capsys.readouterr().out
    assert "served 3/3 with the continuous engine" in out
    assert ("(MoE: sort dispatch, K3 routing)" in out) == \
        get_smoke_config(arch).is_moe
