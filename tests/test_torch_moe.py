"""The port's MoE (``repro_torch.models.moe``, K3 ``moe_dispatch_sort``, the
llama4-scout model and engines) against the JAX package on the same numpy
inputs and converted weights, in fp32 on the CPU, where every kernel
wrapper runs its plain twin.  The JAX side runs its Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` does.

Tolerances: routing decisions, orders, token ids and moved rows are
bit-equal (integers and copies); probabilities and the aux loss differ
only by the two softmax implementations (atol 1e-6); layer outputs by
fp32 summation order (atol 1e-5); model logits over two layers atol = rtol
= 1e-4, as ``tests/test_torch_model.py``.  Inputs come from seeded numpy
generators and ``pytest.mark.parametrize``, never from hypothesis draws.
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
from repro.kernels import merge_sort as jms
from repro.kernels.radix_sort import moe_dispatch_sort as jax_dispatch
from repro.models import moe as jmoe
from repro.models.model import Model as JaxModel
from repro.serve import engine as je
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels import merge_sort as ms
from repro_torch.kernels import radix_sort as rs
from repro_torch.kernels.radix_sort import (moe_dispatch_sort,
                                            moe_dispatch_sort_plain)
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.serve.engine import (ContinuousEngine, Engine, EngineConfig,
                                      Request)
from repro_torch.weights import from_numpy_params

ARCH = "llama4-scout-17b-a16e"
P_TOL = dict(atol=1e-6, rtol=0)
OUT_TOL = dict(atol=1e-5, rtol=0)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
BITONIC = functools.partial(ms.argsort, method="bitonic", fused=False)
JAX_BITONIC = functools.partial(jms.argsort, method="bitonic", fused=False,
                                interpret=True)


def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(t, j):
    got, want = t.numpy(), np.asarray(j)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


@pytest.fixture(scope="module")
def layer():
    """fp32 llama4-scout smoke MoE weights of one layer in both packages."""
    cfg = fp32(jax_smoke(ARCH))
    jp = _np_tree(jmoe.moe_init(jax.random.PRNGKey(0), cfg))
    tcfg = fp32(get_smoke_config(ARCH))
    return cfg, jp, tcfg, from_numpy_params(jp, tcfg, "cpu")


def _x(B, S, D, seed):
    return np.random.RandomState(seed).randn(B, S, D).astype(np.float32)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,K,T,seed", [(4, 1, 16, 0), (16, 1, 64, 1),
                                        (16, 2, 33, 2), (64, 6, 128, 3),
                                        (2, 1, 1, 4)])
def test_route_topk_matches_reference(E, K, T, seed):
    r = np.random.RandomState(seed)
    w = r.randn(8, E).astype(np.float32)
    x = r.randn(T, 8).astype(np.float32)
    jp_, je_, jaux = jmoe.route_topk(jnp.asarray(w), jnp.asarray(x), K)
    tp_, te_, taux = moe.route_topk(_t(w), _t(x), K)
    _eq(te_, je_)
    _close(tp_, jp_, P_TOL)
    _close(taux, jaux, P_TOL)
    assert tp_.dtype == torch.float32 and te_.dtype == torch.int32


def test_route_topk_ties_go_to_the_lower_expert():
    """Experts 1 and 2 (and 3 and 5) have identical router columns, so
    their probabilities tie exactly; like ``jax.lax.top_k`` the port picks
    the lower index first."""
    r = np.random.RandomState(5)
    w = r.randn(8, 6).astype(np.float32)
    w[:, 2] = w[:, 1]
    w[:, 5] = w[:, 3]
    w[:, 1] += 3.0          # make the tied pair the likely winners
    w[:, 2] = w[:, 1]
    x = np.abs(r.randn(40, 8)).astype(np.float32)
    for k in (1, 2, 3):
        jp_, je_, jaux = jmoe.route_topk(jnp.asarray(w), jnp.asarray(x), k)
        tp_, te_, taux = moe.route_topk(_t(w), _t(x), k)
        _eq(te_, je_)
        _close(tp_, jp_, P_TOL)
        _close(taux, jaux, P_TOL)
    assert (te_[:, 0] == 1).any() and not (te_[:, 0] == 2).any()
    assert (te_[te_[:, 0] == 1][:, 1] == 2).all()


@pytest.mark.parametrize("g,e,k,cf", [(64, 4, 1, 1.25), (256, 16, 2, 1.0),
                                      (8, 64, 6, 0.1)])
def test_capacity_per_group_matches_reference(g, e, k, cf):
    assert moe.capacity_per_group(g, e, k, cf) == \
        jmoe.capacity_per_group(g, e, k, cf)


# ---------------------------------------------------------------------------
# einsum (GShard) dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf,group", [(1.25, 64), (0.1, 64), (8.0, 32)])
def test_moe_einsum_matches_reference(layer, cf, group):
    """Capacity drops included: at capacity factor 0.1 most tokens are
    dropped in both packages alike."""
    cfg, jp, tcfg, tp = layer
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    x = _x(2, 64, cfg.d_model, 11)
    jo, jaux = jmoe.moe_einsum(jp, cfg, jnp.asarray(x), group_size=group)
    to, taux = moe.moe_einsum(tp, tcfg, _t(x), group_size=group)
    _close(to, jo, OUT_TOL)
    _close(taux, jaux, P_TOL)


def test_moe_einsum_drops_where_sort_does_not(layer):
    cfg, jp, tcfg, tp = layer
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.1)
    x = _t(_x(2, 64, cfg.d_model, 12))
    drop, _ = moe.moe_einsum(tp, tcfg, x, group_size=64)
    full, _ = moe.moe_sort_dispatch(tp, tcfg, x)
    assert float((drop - full).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# sort dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["argsort", "pallas", "bitonic"])
@pytest.mark.parametrize("B,S", [(2, 64), (3, 1), (1, 37)])
def test_sort_route_matches_reference(layer, route, B, S):
    """``sort_fn`` None, ``"pallas"`` (K3; the JAX kernel in interpret
    mode) and the bitonic unfused argsort: every route gives the same
    routing, bit for bit, in both packages."""
    cfg, jp, tcfg, tp = layer
    x = _x(B, S, cfg.d_model, B * 100 + S)
    jfn = {"argsort": None, "pallas": "pallas", "bitonic": JAX_BITONIC}
    tfn = {"argsort": None, "pallas": "pallas", "bitonic": BITONIC}
    j = jmoe.sort_route(jp, cfg, jnp.asarray(x), jfn[route])
    t = moe.sort_route(tp, tcfg, _t(x), tfn[route])
    for k in (0, 1, 2):                       # xd, sorted_e, sorted_tok
        _eq(t[k], j[k])
    _close(t[3], j[3], P_TOL)                 # sorted_p
    _close(t[4], j[4], P_TOL)                 # aux
    base = moe.sort_route(tp, tcfg, _t(x))
    for a, b in zip(t, base):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T,K,E,D,tile", [(100, 2, 16, 32, 64),
                                          (8, 1, 16, 24, 512),
                                          (37, 1, 4, 16, 16),
                                          (64, 3, 256, 8, 128),
                                          (1, 1, 2, 8, 512)])
def test_moe_dispatch_sort_matches_reference(T, K, E, D, tile):
    """K3's wrapper against the JAX kernel (interpret mode, ``jit=False``,
    small tiles, ragged T·K included) and against stable argsort plus
    gathers; the counts are the per-expert bincount."""
    r = np.random.RandomState(T * K + E)
    x = r.randn(T, D).astype(np.float32)
    e = r.randint(0, E, (T, K)).astype(np.int32)
    p = r.rand(T, K).astype(np.float32)
    got = moe_dispatch_sort(_t(x), _t(e), _t(p), num_experts=E, tile=tile)
    want = jax_dispatch(jnp.asarray(x), jnp.asarray(e), jnp.asarray(p),
                        num_experts=E, tile=tile, jit=False)
    for g, w in zip(got[:4], want):
        _eq(g, w)
    fe = e.reshape(-1)
    order = np.argsort(fe, kind="stable")
    _eq(got[1], fe[order])
    _eq(got[2], (np.arange(T * K) // K)[order].astype(np.int32))
    _eq(got[4], np.bincount(fe, minlength=E).astype(np.int32))
    twin = moe_dispatch_sort_plain(_t(x), _t(e), _t(p), num_experts=E)
    for a, b in zip(got, twin):
        assert torch.equal(a, b)


def test_moe_dispatch_sort_refuses_over_256_experts_and_meta_tensors():
    x = torch.zeros(4, 8)
    e = torch.zeros(4, 1, dtype=torch.int32)
    p = torch.ones(4, 1)
    with pytest.raises(ValueError, match="256"):
        moe_dispatch_sort(x, e, p, num_experts=300)
    with pytest.raises(ValueError, match="256"):
        jax_dispatch(jnp.zeros((4, 8)), jnp.zeros((4, 1), jnp.int32),
                     jnp.ones((4, 1)), num_experts=300)
    # a meta tensor stands in for a CUDA one: no twin, no launch
    _build.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        moe_dispatch_sort(x.to("meta"), e.to("meta"), p.to("meta"),
                          num_experts=16)
    assert _build.launches()["moe_dispatch"] == 0


# ---------------------------------------------------------------------------
# K3 on the card ranks a one-tile input by counting: the rank of row j is
# #{i : e_i < e_j} + #{i < j : e_i == e_j}, and each CTA of k3_grid copies
# a run of 16-byte words (4 or 2 where the row allows no 16).  Its plain
# model (``moe_dispatch_model``, CTA by CTA) is held here bit for bit
# against the twin and the JAX kernel in interpret mode.

def _k3_ids(kind, T, K, E, r):
    if kind == "all-equal":
        return np.full((T, K), E - 1, np.int32)
    if kind == "ties":                  # three ids, long runs of each
        return r.choice(np.array([0, E // 2, E - 1]), (T, K)).astype(np.int32)
    return r.randint(0, E, (T, K)).astype(np.int32)


@pytest.mark.parametrize("T,K,E", [(1, 1, 16), (8, 1, 16), (31, 1, 16),
                                   (32, 1, 16), (33, 1, 16), (8, 6, 64),
                                   (256, 1, 16), (512, 1, 16)])
@pytest.mark.parametrize("kind", ["random", "all-equal", "ties"])
def test_k3_counting_model_matches_twin_and_reference(T, K, E, kind):
    """n = T·K of 1 to 512 (T=8, K=6, E=64 is deepseek-v2-lite's decode
    step): the CTA-by-CTA model at the card's 132 SMs and at 1 (more words
    a thread, runs that straddle rows), at 16-, 4- and 2-byte words, equals
    argsort + gathers and the JAX kernel bit for bit."""
    r = np.random.RandomState(T * K + E + len(kind))
    e = _k3_ids(kind, T, K, E, r)
    p = r.rand(T, K).astype(np.float32)
    for D, dtype in ((24, torch.float32), (6, torch.float32),
                     (40, torch.bfloat16), (5, torch.bfloat16)):
        x = torch.from_numpy(r.randn(T, D).astype(np.float32)).to(dtype)
        twin = moe_dispatch_sort_plain(x, _t(e), _t(p), num_experts=E)
        for sms in (rs.NUM_SMS, 1):
            got = rs.moe_dispatch_model(x, _t(e), _t(p), num_experts=E,
                                        sm_count=sms)
            for a, b in zip(got, twin):
                assert a.dtype == b.dtype and torch.equal(a, b), (D, sms)
    x = r.randn(T, 24).astype(np.float32)
    want = jax_dispatch(jnp.asarray(x), jnp.asarray(e), jnp.asarray(p),
                        num_experts=E, jit=False)
    got = rs.moe_dispatch_model(_t(x), _t(e), _t(p), num_experts=E)
    for g, w in zip(got[:4], want):
        _eq(g, w)
    _eq(got[4], np.bincount(e.reshape(-1), minlength=E).astype(np.int32))


@pytest.mark.parametrize("n,row_bytes,vec,sms", [
    (1, 10240, 16, 132), (8, 10240, 16, 132), (256, 10240, 16, 132),
    (512, 10240, 16, 132), (2048, 10240, 16, 132), (48, 4096, 16, 132),
    (33, 96, 16, 132), (512, 16, 16, 132), (31, 10, 2, 132),
    (100, 24, 4, 1), (2048, 2, 2, 132), (7, 10240, 16, 1)])
def test_k3_grid_covers_every_word_once(n, row_bytes, vec, sms):
    """The CTAs of K3's one-tile grid copy every word of every row exactly
    once, at most K3_MAX_PER words a thread, no CTA idle, and no CTA's run
    touches more rows than the kernel's shared table holds; at the MoE
    path's shapes (D 5120 bf16) a decode step is 40 CTAs of one 16-byte
    word a thread and a 256-token chunk 256 CTAs of five."""
    nv = row_bytes // vec
    ctas, per = rs.k3_grid(n, row_bytes, vec, sms)
    assert 1 <= per <= rs.K3_MAX_PER
    words = [rs.k3_cta_words(c, n, nv, per) for c in range(ctas)]
    assert all(w.numel() > 0 for w in words)
    flat = torch.cat(words)
    assert flat.numel() == n * nv
    assert torch.equal(flat.sort().values, torch.arange(n * nv))
    rows = max(int(w[-1]) // nv - int(w[0]) // nv + 1 for w in words)
    assert rows <= rs.K3_THREADS * rs.K3_MAX_PER + 2
    if (row_bytes, sms) == (10240, 132):
        assert (ctas, per) == {1: (5, 1), 8: (40, 1), 256: (256, 5),
                               512: (320, 8), 2048: (1280, 8)}[n]


@pytest.mark.parametrize("strategy,route", [("sort", "argsort"),
                                            ("sort", "pallas"),
                                            ("sort", "bitonic"),
                                            ("einsum", None)])
@pytest.mark.parametrize("B,S", [(2, 64), (4, 1)])
def test_moe_apply_matches_reference(layer, strategy, route, B, S):
    cfg, jp, tcfg, tp = layer
    x = _x(B, S, cfg.d_model, 7 + S)
    jfn = {"argsort": None, "pallas": "pallas", "bitonic": JAX_BITONIC,
           None: None}[route]
    tfn = {"argsort": None, "pallas": "pallas", "bitonic": BITONIC,
           None: None}[route]
    group = min(256, S)
    jo, jaux = jmoe.moe_apply(jp, cfg, jnp.asarray(x), strategy=strategy,
                              group_size=group, sort_fn=jfn)
    to, taux = moe.moe_apply(tp, tcfg, _t(x), strategy=strategy,
                             group_size=group, sort_fn=tfn)
    _close(to, jo, OUT_TOL)
    _close(taux, jaux, P_TOL)


def test_moe_sort_dispatch_top2_matches_reference():
    """top-k 2 (deepseek-style routing on the llama4 smoke widths): the
    combine sums each token's two expert outputs in sorted order."""
    cfg = dataclasses.replace(fp32(jax_smoke(ARCH)), top_k=2)
    jp = _np_tree(jmoe.moe_init(jax.random.PRNGKey(3), cfg))
    tcfg = dataclasses.replace(fp32(get_smoke_config(ARCH)), top_k=2)
    tp = from_numpy_params(jp, tcfg, "cpu")
    x = _x(2, 40, cfg.d_model, 21)
    for jfn, tfn in ((None, None), ("pallas", "pallas")):
        jo, _ = jmoe.moe_sort_dispatch(jp, cfg, jnp.asarray(x), sort_fn=jfn)
        to, _ = moe.moe_sort_dispatch(tp, tcfg, _t(x), sort_fn=tfn)
        _close(to, jo, OUT_TOL)


def test_moe_strategy_is_checked():
    with pytest.raises(ValueError, match="strategy"):
        Model(get_smoke_config(ARCH), device="cpu", moe_strategy="scatter")
    with pytest.raises(ValueError, match="strategy"):
        moe.moe_apply({}, get_smoke_config(ARCH), torch.zeros(1, 1, 64),
                      strategy="scatter")


# ---------------------------------------------------------------------------
# the model, the engines and the weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(fp32(jax_smoke(ARCH)), moe_strategy="sort")
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = fp32(get_smoke_config(ARCH))
    return jm, jp, cfg, from_numpy_params(_np_tree(jp), cfg, "cpu")


def _tokens(B, S, seed):
    return np.random.RandomState(seed).randint(3, 512, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("sort_fn", [None, "pallas", "bitonic"])
def test_model_prefill_and_decode_match_reference(pair, sort_fn):
    """llama4-scout smoke, ``moe_strategy="sort"``: prefill of 2 x 40 and
    3 decode steps; the port's logits with every ``moe_sort_fn`` equal
    the reference's (which routes with ``jnp.argsort``)."""
    jm, jp, cfg, tp = pair
    tm = Model(cfg, device="cpu", moe_strategy="sort",
               moe_sort_fn=BITONIC if sort_fn == "bitonic" else sort_fn)
    toks = _tokens(2, 40, 1)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=48)
    tl, tc = tm.prefill(tp, _t(toks), max_seq=48)
    _close(tl, jl, LOGIT_TOL)
    lengths = np.full((2,), 40, np.int32)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc,
                                jnp.asarray(lengths))
        tl, tc = tm.decode_step(tp, _t(nxt), tc, _t(lengths))
        _close(tl, jl, LOGIT_TOL)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        lengths = lengths + 1
    assert tm.calls == {"prefill": 1, "prefill_chunk": 0, "decode_step": 3}


def test_model_einsum_default_matches_reference(pair):
    """The default ``moe_strategy="einsum"`` of both packages (capacity
    drops and all) over a prefill chunk at an offset."""
    _, jp, cfg, tp = pair
    jm = JaxModel(fp32(jax_smoke(ARCH)))
    tm = Model(cfg, device="cpu")
    toks = _tokens(2, 32, 2)
    jc, tc = jm.init_cache(2, 48), tm.init_cache(2, 48)
    _, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, :16]), jc, 0)
    tm.prefill_chunk(tp, _t(toks[:, :16]), tc, 0)
    jl, _ = jm.prefill_chunk(jp, jnp.asarray(toks[:, 16:]), jc, 16)
    tl, _ = tm.prefill_chunk(tp, _t(toks[:, 16:]), tc, 16)
    _close(tl, jl, LOGIT_TOL)


def _prompts(lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, 512, size=n).astype(np.int32) for n in lens]


def _drain(engine, max_steps=500):
    out, steps = {}, 0
    while engine.pending:
        for r in engine.step():
            out[r.rid] = r
        steps += 1
        assert steps < max_steps, "engine made no progress"
    return out


def test_continuous_engine_matches_reference(pair):
    """6 mixed-length requests through 3 slots, K3 routing every chunk and
    decode step: the port's tokens equal the JAX ContinuousEngine's, the
    sync engine's one at a time, and the ``torch.argsort`` route's."""
    jm, jp, cfg, tp = pair
    prompts = _prompts((9, 33, 17, 51, 12, 40), seed=3)
    news = (10, 6, 14, 8, 12, 5)
    kw = dict(max_batch=3, eos_id=7, max_seq=256, decode_tick=4)
    jeng = je.ContinuousEngine(jm, jp, je.EngineConfig(**kw))
    for i, (pr, mn) in enumerate(zip(prompts, news)):
        jeng.submit(je.Request(rid=i, prompt=pr, max_new=mn))
    want = {rid: np.asarray(r.result).tolist()
            for rid, r in _drain(jeng).items()}
    for sort_fn in ("pallas", None):
        tm = Model(cfg, device="cpu", moe_strategy="sort",
                   moe_sort_fn=sort_fn)
        teng = ContinuousEngine(tm, tp, EngineConfig(**kw))
        for i, (pr, mn) in enumerate(zip(prompts, news)):
            teng.submit(Request(rid=i, prompt=pr, max_new=mn))
        got = {rid: r.result.tolist() for rid, r in _drain(teng).items()}
        assert got == want
        assert len(teng.pages.free) == teng.pages.num_pages
    alone = []
    for pr, mn in zip(prompts[:3], news[:3]):
        eng = Engine(tm, tp, EngineConfig(max_batch=1, eos_id=7,
                                          max_seq=256))
        eng.submit(Request(rid=0, prompt=pr, max_new=mn))
        (done,) = eng.step()
        alone.append(done.result.tolist())
    assert alone == [want[i] for i in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_carry_moe_leaves_by_name(dtype):
    """``from_numpy_params`` carries moe/{router,gate,up,down,shared} leaf
    by leaf (bf16 through 16-bit views) and refuses an off-dtype leaf."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), param_dtype=dtype,
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype=dtype,
                               compute_dtype=dtype)
    jm = JaxModel(jcfg, moe_strategy="sort")
    jp = _np_tree(jm.init(jax.random.PRNGKey(1)))
    tp = from_numpy_params(jp, tcfg, "cpu")
    jmo, tmo = jp["stage"][0]["moe"], tp["stage"][0]["moe"]
    assert sorted(tmo) == ["down", "gate", "router", "shared", "up"]
    assert tuple(tmo["gate"].shape) == (2, 4, 64, 96)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jmo):
        t = functools.reduce(lambda n, k: n[k.key], path, tmo)
        assert t.dtype == getattr(torch, dtype)
        assert np.array_equal(t.float().numpy(),
                              np.asarray(leaf).astype(np.float32)), path
    tm = Model(tcfg, device="cpu", moe_strategy="sort", moe_sort_fn="pallas")
    mine = tm.init(0)["stage"][0]["moe"]
    assert {k: tuple(v.shape) for k, v in mine.items() if k != "shared"} \
        == {k: tuple(v.shape) for k, v in tmo.items() if k != "shared"}
    bad = jax.tree.map(lambda a: a, jp)
    bad["stage"][0]["moe"]["router"] = np.zeros((2, 64, 4), np.float64)
    with pytest.raises(TypeError, match="router"):
        from_numpy_params(bad, tcfg, "cpu")


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("layers", [None, 12, 2])
def test_param_count_matches_reference(active_only, layers):
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    assert cfg.param_count(active_only=active_only) == \
        jcfg.param_count(active_only=active_only)
    assert get_smoke_config(ARCH).param_count(active_only=active_only) == \
        jax_smoke(ARCH).param_count(active_only=active_only)


def test_launcher_serves_moe_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                "3", "--max-new", "6"])
    out = capsys.readouterr().out
    assert "(MoE: sort dispatch, K3 routing)" in out
    assert "served 3/3 with the continuous engine" in out
