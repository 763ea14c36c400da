"""The port's MLA (``repro_torch.models.attention`` ``mla_*``,
``transformer._mla_chunk_absorbed``), the unrolled dense prefix layer and
the deepseek-v2-lite smoke model against the JAX package, on the same
numpy inputs and on weights from the reference's ``Model.init`` carried
over with ``from_numpy_params``, in fp32 on the CPU, where K1's wrapper
runs its plain twin.

Tolerances: layer functions, attention twins and model logits atol 1e-5
(fp32 summation order; the logits are O(0.5)); token ids, cache-slot rows
and parameter counts exactly.  Inputs come from seeded numpy generators
and ``pytest.mark.parametrize``, never from hypothesis draws.
"""

import dataclasses
import functools
import math

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
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as ta
from repro_torch.models import transformer as ttr
from repro_torch.models.model import Model
from repro_torch.serve import kvcache as tkv
from repro_torch.serve.engine import (ContinuousEngine, Engine, EngineConfig,
                                      Request)
from repro_torch.weights import from_numpy_params

ARCH = "deepseek-v2-lite-16b"
TOL = dict(atol=1e-5, rtol=0)


def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _jit(fn, *args, **static):
    """A JAX reference compiled once; keyword arguments are baked in."""
    return jax.jit(functools.partial(fn, **static))(*args)


@pytest.fixture(scope="module")
def pair():
    """The deepseek smoke model in fp32: the reference's weights in both
    packages (sort dispatch, the serving path's)."""
    jm = JaxModel(fp32(jax_smoke(ARCH)), moe_strategy="sort")
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = fp32(get_smoke_config(ARCH))
    return jm, jp, cfg, from_numpy_params(_np_tree(jp), cfg, "cpu")


@pytest.fixture(scope="module")
def mixer(pair):
    """The prefix layer's MLA mixer in both packages."""
    jm, jp, cfg, tp = pair
    return jm.cfg, jp["prefix"][0]["mixer"], cfg, tp["prefix"][0]["mixer"]


def _x(B, S, D, seed):
    return np.random.RandomState(seed).randn(B, S, D).astype(np.float32)


def _pos(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S), (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the MLA layer functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,start", [(2, 9, 0), (1, 40, 0), (3, 5, 17)])
def test_mla_project_matches_reference(mixer, B, S, start):
    jcfg, jp, cfg, tp = mixer
    x, pos = _x(B, S, cfg.d_model, S), _pos(B, S, start)
    want = _jit(lambda p, x, pos: ja.mla_project(p, jcfg, x, pos), jp,
                jnp.asarray(x), jnp.asarray(pos))
    got = ta.mla_project(tp, cfg, _t(x), _t(pos))
    nd, rd, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                  cfg.v_head_dim)
    assert [tuple(g.shape) for g in got] == [
        (B, S, cfg.num_heads, nd + rd), (B, S, cfg.num_heads, nd + rd),
        (B, S, cfg.num_heads, vd), (B, S, cfg.kv_lora_rank + rd)]
    assert all(g.is_contiguous() for g in got[:3])     # K1's operands
    for g, w in zip(got, want):
        _close(g, w)
    _close(ta.mla_cache_payload(tp, cfg, _t(x), _t(pos)),
           _jit(lambda p, x, pos: ja.mla_cache_payload(p, jcfg, x, pos), jp,
                jnp.asarray(x), jnp.asarray(pos)))


@pytest.mark.parametrize("S", [24, 256, 300])   # plain (<= 256), blockwise
def test_mla_self_attention_matches_reference(mixer, S):
    jcfg, jp, cfg, tp = mixer
    x, pos = _x(2, S, cfg.d_model, 3), _pos(2, S)
    _close(ta.mla_self_attention(tp, cfg, _t(x), _t(pos)),
           _jit(lambda p, x, pos: ja.mla_self_attention(p, jcfg, x, pos),
                jp, jnp.asarray(x), jnp.asarray(pos)))


@pytest.mark.parametrize("lengths", [(0, 7, 24), (23, 1, 12), (24, 24, 3)])
def test_mla_decode_matches_reference(mixer, lengths):
    """One absorbed decode step: the token's payload goes into the cache
    at its length (nowhere at the cache width), then attends positions
    < length + 1; the port writes the cache in place."""
    jcfg, jp, cfg, tp = mixer
    B, S = len(lengths), 24
    r = np.random.RandomState(sum(lengths))
    x = r.randn(B, 1, cfg.d_model).astype(np.float32)
    lat = r.randn(B, S, cfg.kv_lora_rank + cfg.qk_rope_head_dim).astype(
        np.float32)
    lens = np.asarray(lengths, np.int32)
    jy, jlat = _jit(lambda p, *a: ja.mla_decode(p, jcfg, *a), jp,
                    jnp.asarray(x), jnp.asarray(lat), jnp.asarray(lens),
                    jnp.asarray(lens))
    tlat = _t(lat)
    ty, out = ta.mla_decode(tp, cfg, _t(x), tlat, _t(lens), _t(lens))
    assert out is tlat
    _close(ty, jy)
    _close(tlat, jlat)
    full = lens >= S
    np.testing.assert_array_equal(tlat.numpy()[full], lat[full])


@pytest.mark.parametrize("pos0,c", [(0, 8), (16, 8), (5, 19), (31, 1)])
def test_mla_chunk_absorbed_matches_reference(mixer, pos0, c):
    """A prefill chunk's absorbed attention against a latent buffer that
    already holds it, the causal mask windowing the history."""
    jcfg, jp, cfg, tp = mixer
    B, S = 2, 32
    r = np.random.RandomState(pos0 * 31 + c)
    h = r.randn(B, c, cfg.d_model).astype(np.float32)
    lat = r.randn(B, S, cfg.kv_lora_rank + cfg.qk_rope_head_dim).astype(
        np.float32)
    pos = _pos(B, c, pos0)
    want = _jit(lambda p, h, lat, pos, p0: jtr._mla_chunk_absorbed(
        p, jcfg, h, lat, pos, p0, c), jp, jnp.asarray(h), jnp.asarray(lat),
        jnp.asarray(pos), jnp.int32(pos0))
    _close(ttr._mla_chunk_absorbed(tp, cfg, _t(h), _t(lat), _t(pos), pos0,
                                   c), want)


# ---------------------------------------------------------------------------
# K1's slot at a v head dim narrower than q/k's
# ---------------------------------------------------------------------------

def _qkv(B, Sq, Sk, H, KV, dk, dv, seed):
    r = np.random.RandomState(seed)
    return (r.randn(B, Sq, H, dk).astype(np.float32),
            r.randn(B, Sk, KV, dk).astype(np.float32),
            r.randn(B, Sk, KV, dv).astype(np.float32))


@pytest.mark.parametrize("dk,dv", [(24, 16), (192, 128)])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)])
@pytest.mark.parametrize("Sq,Sk,q_offset", [(16, 16, 0), (8, 40, 24),
                                            (12, 33, 5)])
def test_attention_twins_at_unequal_head_dims(dk, dv, H, KV, Sq, Sk,
                                              q_offset):
    """The prefill slot's CPU paths (``plain_attention``,
    ``blockwise_attention``) and K1's own twins (``flash_attention_plain``;
    split partials + merge) at (d_qk, d_v) = (24, 16), the smoke config's,
    and (192, 128), deepseek's, against the reference's jnp
    ``blockwise_attention`` (MLA's call: scale 1/sqrt(d_qk))."""
    q, k, v = _qkv(2, Sq, Sk, H, KV, dk, dv, dk + Sq)
    scale = 1.0 / math.sqrt(dk)
    kw = dict(causal=True, scale=scale, q_offset=q_offset)
    want = _jit(ja.blockwise_attention, *map(jnp.asarray, (q, k, v)),
                q_chunk=8, kv_chunk=16, **kw)
    args = [_t(a) for a in (q, k, v)]
    assert tuple(want.shape) == (2, Sq, H, dv)
    _close(ta.blockwise_attention(*args, q_chunk=8, kv_chunk=16, **kw), want)
    _close(ta.plain_attention(*args, **kw), want)
    np.testing.assert_allclose(
        np.asarray(_jit(ja.plain_attention, *map(jnp.asarray, (q, k, v)),
                        **kw)), np.asarray(want), **TOL)
    _close(tfa.flash_attention(*args, **kw), want)
    _close(tfa.flash_attention_plain(*args, **kw), want)
    m, l, acc = tfa.split_partials_plain(*args, 3, **kw)
    assert tuple(acc.shape) == (3, 2, Sq, H, dv)
    _close(tfa.merge_plain(m, l, acc, torch.float32), want)


def test_k1_routes_mla_to_the_tensor_core_kernel():
    """v3 is built for one head dim (multiples of 16 up to 128) and for
    MLA's (192, 128); fp32 and every other pair take v2."""
    bf = torch.bfloat16
    assert tfa.uses_tensor_cores(bf, 192, 128)
    assert tfa.uses_tensor_cores(bf, 128) and tfa.uses_tensor_cores(bf, 64,
                                                                     64)
    for dk, dv in ((192, 192), (192, 64), (128, 64), (24, 16), (176, 128)):
        assert not tfa.uses_tensor_cores(bf, dk, dv)
    assert not tfa.uses_tensor_cores(torch.float32, 192, 128)
    assert (192, 128) in tfa.TC_HEAD_DIMS


def test_k1_refuses_what_it_cannot_take():
    """Off the CPU the wrapper checks before any launch: v wider than 128,
    q/k wider than 192, or v rows that do not match k's."""
    def meta(*shapes):
        return [torch.zeros(s, device="meta") for s in shapes]
    for shapes in (((1, 4, 2, 192), (1, 4, 2, 192), (1, 4, 2, 192)),
                   ((1, 4, 2, 256), (1, 4, 2, 256), (1, 4, 2, 128)),
                   ((1, 4, 2, 192), (1, 4, 2, 192), (1, 5, 2, 128))):
        with pytest.raises(ValueError):
            tfa.flash_attention(*meta(*shapes))


# ---------------------------------------------------------------------------
# the deepseek smoke model: prefix layer, MLA stage, MoE
# ---------------------------------------------------------------------------

def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(3, 512, (B, S)).astype(
        np.int32)


def test_model_layout_matches_reference(pair):
    """``Model.init`` builds the reference's tree (a 'prefix' list of one
    dense layer, a 'stage' of MLA + MoE layers), leaf for leaf in shape;
    the carried weights are the reference's bit for bit."""
    jm, jp, cfg, tp = pair
    tm = Model(cfg, device="cpu", moe_strategy="sort")
    assert [s.kind for s in tm.prefix_specs] == ["mla"]
    assert not tm.prefix_specs[0].is_moe and tm.period_specs[0].is_moe
    mine = tm.init(0)
    want = {jax.tree_util.keystr(p): tuple(np.shape(a))
            for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    got = {jax.tree_util.keystr(p): tuple(t.shape)
           for p, t in jax.tree_util.tree_leaves_with_path(mine)}
    assert got == want
    assert sorted(mine["prefix"][0]["mixer"]) == [
        "wk_rope", "wkv_down", "wkv_up", "wo", "wq"]
    for p, a in jax.tree_util.tree_leaves_with_path(jp):
        t = functools.reduce(lambda n, k: n[getattr(k, "key", getattr(
            k, "idx", None))], p, tp)
        assert np.array_equal(t.numpy(), np.asarray(a)), p


@pytest.mark.parametrize("S", [24, 300])    # plain and blockwise branches
def test_prefill_logits_and_caches_match(pair, S):
    jm, jp, cfg, tp = pair
    tm = Model(cfg, device="cpu", moe_strategy="sort", moe_sort_fn="pallas")
    toks = _tokens(2, S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=S + 8)
    tl, tc = tm.prefill(tp, _t(toks), max_seq=S + 8)
    _close(tl, jl)
    _close(tc["prefix"][0]["latent"], jc["prefix"][0]["latent"])
    _close(tc["stage"][0]["latent"], jc["stage"][0]["latent"])
    assert tuple(tc["prefix"][0]["latent"].shape) == (
        2, S + 8, cfg.kv_lora_rank + cfg.qk_rope_head_dim)


@pytest.mark.parametrize("sort_fn", [None, "pallas"])
def test_prefill_chunk_at_offset_matches(pair, sort_fn):
    jm, jp, cfg, tp = pair
    tm = Model(cfg, device="cpu", moe_strategy="sort", moe_sort_fn=sort_fn)
    toks = _tokens(2, 40, seed=1)
    jc, tc = jm.init_cache(2, 48), tm.init_cache(2, 48)
    _, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, :16]), jc, 0)
    tm.prefill_chunk(tp, _t(toks[:, :16]), tc, 0)
    jl, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, 16:]), jc,
                              jnp.int32(16), all_logits=True)
    tl, tc = tm.prefill_chunk(tp, _t(toks[:, 16:]), tc, 16,
                              all_logits=True)
    assert tuple(tl.shape) == (2, 24, 512)
    _close(tl, jl)
    _close(tc["prefix"][0]["latent"], jc["prefix"][0]["latent"])
    _close(tc["stage"][0]["latent"], jc["stage"][0]["latent"])


def test_eight_decode_steps_match(pair):
    jm, jp, cfg, tp = pair
    tm = Model(cfg, device="cpu", moe_strategy="sort", moe_sort_fn="pallas")
    toks = _tokens(3, 20, seed=2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=32)
    tl, tc = tm.prefill(tp, _t(toks), max_seq=32)
    jdecode = jax.jit(jm.decode_step)
    lens = np.full((3,), 20, np.int32)
    for _ in range(8):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert torch.argmax(tl, -1).tolist() == nxt.tolist()
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.asarray(lens))
        tl, tc = tm.decode_step(tp, _t(nxt), tc, _t(lens))
        _close(tl, jl)
        lens = lens + 1
    _close(tc["prefix"][0]["latent"], jc["prefix"][0]["latent"])
    assert tm.calls == {"prefill": 1, "prefill_chunk": 0, "decode_step": 8}


def _drain(engine, max_steps=500):
    out, steps = {}, 0
    while engine.pending:
        for r in engine.step():
            out[r.rid] = r
        steps += 1
        assert steps < max_steps, "engine made no progress"
    return out


PROMPTS = [np.random.RandomState(3 + i).randint(3, 512, size=n)
           .astype(np.int32) for i, n in enumerate((9, 33, 17, 51, 12, 40))]
NEWS = (10, 6, 14, 8, 12, 5)


@pytest.fixture(scope="module")
def jax_tokens(pair):
    """The reference's ContinuousEngine (3 slots) and sync Engine (one
    batch of 3) tokens for the six requests."""
    jm, jp, _, _ = pair
    kw = dict(max_batch=3, eos_id=7, max_seq=256, decode_tick=4)
    jeng = je.ContinuousEngine(jm, jp, je.EngineConfig(**kw))
    for i, (pr, mn) in enumerate(zip(PROMPTS, NEWS)):
        jeng.submit(je.Request(rid=i, prompt=pr, max_new=mn))
    cont = {rid: np.asarray(r.result).tolist()
            for rid, r in _drain(jeng).items()}
    jsync = je.Engine(jm, jp, je.EngineConfig(max_batch=3, eos_id=7,
                                              max_seq=256))
    for i, (pr, mn) in enumerate(zip(PROMPTS[:3], NEWS[:3])):
        jsync.submit(je.Request(rid=i, prompt=pr, max_new=mn))
    sync = {r.rid: np.asarray(r.result).tolist() for r in jsync.step()}
    return cont, sync


@pytest.mark.parametrize("sort_fn", ["pallas", None])
def test_engines_match_reference_tokens(pair, jax_tokens, sort_fn):
    """The port's ContinuousEngine (prefix-layer caches inserted into the
    batched slots) and sync Engine give the JAX engines' tokens exactly,
    K3 routing every MoE layer (or ``torch.argsort``)."""
    _, _, cfg, tp = pair
    cont, sync = jax_tokens
    tm = Model(cfg, device="cpu", moe_strategy="sort", moe_sort_fn=sort_fn)
    teng = ContinuousEngine(tm, tp, EngineConfig(
        max_batch=3, eos_id=7, max_seq=256, decode_tick=4))
    for i, (pr, mn) in enumerate(zip(PROMPTS, NEWS)):
        teng.submit(Request(rid=i, prompt=pr, max_new=mn))
    assert {rid: r.result.tolist()
            for rid, r in _drain(teng).items()} == cont
    assert len(teng.pages.free) == teng.pages.num_pages
    tsync = Engine(tm, tp, EngineConfig(max_batch=3, eos_id=7, max_seq=256))
    for i, (pr, mn) in enumerate(zip(PROMPTS[:3], NEWS[:3])):
        tsync.submit(Request(rid=i, prompt=pr, max_new=mn))
    assert {r.rid: r.result.tolist() for r in tsync.step()} == sync


def test_cache_slot_insert_covers_the_prefix_layer(pair):
    """A request's batch=1 cache goes into slot 1 of a batched cache whose
    rows hold a previous occupant's history: afterwards slot 1 of the
    prefix layer's latent (and of the stage's) equals the batch=1 cache
    row, the other slots are untouched, and the reference's insert gives
    the same tree."""
    jm, jp, cfg, tp = pair
    tm = Model(cfg, device="cpu", moe_strategy="sort")
    _, small = tm.prefill(tp, _t(_tokens(1, 12, seed=4)), max_seq=20)
    _, big = tm.prefill(tp, _t(_tokens(3, 20, seed=5)), max_seq=20)
    before = jax.tree.map(lambda t: t.clone(), big)
    want = jkv.cache_slot_insert(jax.tree.map(lambda t: jnp.asarray(
        t.numpy()), big), jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                       small), 1)
    out = tkv.cache_slot_insert(big, small, 1)
    assert out is big
    for name in ("prefix", "stage"):
        got, old, one = big[name][0]["latent"], before[name][0]["latent"], \
            small[name][0]["latent"]
        ax = 0 if name == "prefix" else 1
        row = got.select(ax, 1)
        assert torch.equal(row, one.select(ax, 0))
        assert not torch.equal(row, old.select(ax, 1))
        for keep in (0, 2):
            assert torch.equal(got.select(ax, keep), old.select(ax, keep))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want[name][0]["latent"]))


@pytest.mark.parametrize("B,S", [(1, 16), (4, 2048)])
def test_cache_bytes_counts_the_prefix_layer(pair, B, S):
    jm, _, cfg, _ = pair
    tm = Model(cfg, device="cpu", moe_strategy="sort")
    lat = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    assert tkv.cache_bytes(tm, B, S) == jkv.cache_bytes(jm, B, S) == \
        cfg.num_layers * B * S * lat * 4


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("layers", [None, 2, 1])
def test_param_count_matches_reference(active_only, layers):
    """The full config (15.7 B, 2.66 B active) and depth cuts: MLA's
    projections, the dense prefix layer and 64 experts top-6 + 2 shared."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    assert cfg.param_count(active_only=active_only) == \
        jcfg.param_count(active_only=active_only)
    assert get_smoke_config(ARCH).param_count(active_only=active_only) == \
        jax_smoke(ARCH).param_count(active_only=active_only)
    if layers is None:
        assert round(cfg.param_count() / 1e9, 1) == 15.7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_carry_prefix_and_mla_leaves(dtype):
    """``from_numpy_params`` carries the 'prefix' list and the MLA mixer
    leaf by leaf (bf16 through 16-bit views)."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), param_dtype=dtype,
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype=dtype,
                               compute_dtype=dtype)
    jp = _np_tree(JaxModel(jcfg).init(jax.random.PRNGKey(1)))
    tp = from_numpy_params(jp, tcfg, "cpu")
    assert isinstance(tp["prefix"], list) and len(tp["prefix"]) == 1
    for part in (tp["prefix"][0], tp["stage"][0]):
        for leaf in jax.tree.leaves(part):
            assert leaf.dtype == getattr(torch, dtype)
    for path in (("prefix", 0, "mixer", "wkv_up"),
                 ("stage", 0, "mixer", "wk_rope"),
                 ("prefix", 0, "ffn", "down")):
        t = functools.reduce(lambda n, k: n[k], path, tp)
        a = functools.reduce(lambda n, k: n[k], path, jp)
        assert np.array_equal(t.float().numpy(), a.astype(np.float32))
