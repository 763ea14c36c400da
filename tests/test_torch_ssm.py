"""The port's recurrent (SSM) path against the JAX package on the same numpy
inputs: the K4 monoid scans (``repro_torch.kernels.tile_scan`` /
``ssm_scan``; on the CPU their plain fold, against the Pallas kernel in
interpret mode), the Mamba / mLSTM / sLSTM mixers under both
``scan_impl`` values, the xlstm smoke model, and its serving path
(``ContinuousEngine`` with state slots and the entropy-gated tick).

Tolerances: scans 1e-5 (fp32 reassociation of one fold), mixers and
logits 1e-4 (as ``tests/test_ssm_scan.py``), fp32 tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.kernels import ssm_scan as jss
from repro.kernels import tile_scan as jts
from repro.models import ssm as jssm
from repro.models.attention import decode_attention as jax_decode_attention
from repro.models.model import Model as JaxModel
from repro.serve import engine as je
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ssm_scan as tss
from repro_torch.kernels import tile_scan as tts
from repro_torch.models import ssm as tssm
from repro_torch.models.attention import decode_attention
from repro_torch.models.model import Model
from repro_torch.models.transformer import LayerSpec, layer_apply
from repro_torch.serve.engine import ContinuousEngine, EngineConfig, Request
from repro_torch.weights import from_numpy_params

SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
EOS = 2


def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t.float().numpy()),
                               np.asarray(j, np.float32), **tol)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def xlstm():
    """fp32 xlstm smoke weights in both packages."""
    jm = JaxModel(fp32(jax_smoke("xlstm-1.3b")))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    cfg = fp32(get_smoke_config("xlstm-1.3b"))
    return jm, jp, cfg, from_numpy_params(_np_tree(jp), cfg, "cpu")


def _port_cfg(jcfg):
    """The port's ModelConfig with a JAX config's values (jamba is not in
    the port's registry: its full-width MoE layers need more than one
    card; its Mamba and MoE layers are ported)."""
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


@pytest.fixture(scope="module")
def jamba():
    """fp32 jamba smoke weights: JAX model and tree, and the first layer
    (Mamba + dense FFN) of both packages."""
    jm = JaxModel(fp32(jax_smoke("jamba-1.5-large-398b")))
    jp = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    jl = jax.tree.map(lambda a: a[0], jp["stage"][0])
    cfg = _port_cfg(jm.cfg)
    return jm, jp, cfg, jl, from_numpy_params(jl, cfg, "cpu")


def _layer(params, pos):
    """Repeat 0 of period position ``pos`` of a port tree."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[0]
    return take(params["stage"][pos])


# ---------------------------------------------------------------------------
# K4: the monoid scans (plain fold on the CPU) against the Pallas kernel
# ---------------------------------------------------------------------------

def _logspace_elems(r, L, extreme=False):
    la, ms = r.randn(L, 2, 3), r.randn(L, 2, 3)
    if extreme:   # gate log-sums far past exp's range (~88)
        la = r.uniform(-1e3, 1e3, (L, 2, 3))
        ms = r.uniform(-1e3, 1e3, (L, 2, 3))
    return tuple(a.astype(np.float32) for a in (
        la, ms, r.randn(L, 2, 3, 4, 4), r.randn(L, 2, 3, 4)))


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("seeded", [True, False])
@pytest.mark.parametrize("extreme", [False, True])
def test_tree_scan_logspace_matches_jax(inclusive, seeded, extreme):
    """Extreme gates run the reference with block=1, a fold in the same
    order: at |la| ~ 1e3 a reassociated sum of cancelling terms is off by
    more than 1e-5 relative, whatever the implementation."""
    r = np.random.RandomState(int(inclusive) + 2 * seeded + 4 * extreme)
    xs = _logspace_elems(r, 11, extreme)
    block = 1 if extreme else 4
    c0 = tuple(a[0] * 0.5 for a in xs) if seeded else None
    got = tts.tree_scan(tuple(map(torch.from_numpy, xs)),
                        combine=tss.logspace_affine_combine,
                        units=tss.LOGSPACE_UNITS, inclusive=inclusive,
                        carry0=None if c0 is None else
                        tuple(map(torch.from_numpy, c0)), block=block)
    want = jts.tree_scan(tuple(map(jnp.asarray, xs)),
                         combine=jss.logspace_affine_combine,
                         units=jss.LOGSPACE_UNITS, inclusive=inclusive,
                         carry0=c0, block=block, kind="ssm_scan")
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w, SCAN_TOL)


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("seeded", [True, False])
@pytest.mark.parametrize("layout", ["batched", "tree"])
def test_affine_scan_matches_jax(inclusive, seeded, layout):
    r = np.random.RandomState(10 + int(inclusive) + 2 * seeded)
    shape = (2, 37, 3, 4) if layout == "batched" else (37, 3, 4)
    dA = np.exp(-np.logaddexp(0, r.randn(*shape))).astype(np.float32)
    dBx = (0.1 * r.randn(*shape)).astype(np.float32)
    cshape = (shape[0],) + shape[2:] if layout == "batched" else shape[1:]
    c0 = (np.ones(cshape, np.float32),
          r.randn(*cshape).astype(np.float32)) if seeded else None
    kw = dict(units=(1.0, 0.0), inclusive=inclusive, block=8)
    tfn, jfn = ((tts.batched_scan, jts.batched_scan) if layout == "batched"
                else (tts.tree_scan, jts.tree_scan))
    got = tfn((torch.from_numpy(dA), torch.from_numpy(dBx)),
              combine=tss.affine_combine,
              carry0=None if c0 is None else tuple(map(torch.from_numpy, c0)),
              **kw)
    want = jfn((jnp.asarray(dA), jnp.asarray(dBx)),
               combine=jss.affine_combine, carry0=c0, **kw)
    for g, w in zip(got, want):
        _close(g, w, SCAN_TOL)


def test_ssm_scan_entry_points_match_jax():
    """mamba_assoc_scan (+ both oracles) and mlstm_carry_scan (+ oracle),
    the latter with the extreme gate magnitudes of tests/test_ssm_scan.py."""
    r = np.random.RandomState(3)
    dA = np.exp(-np.logaddexp(0, r.randn(2, 40, 4, 4))).astype(np.float32)
    dBx = (0.1 * r.randn(2, 40, 4, 4)).astype(np.float32)
    h0 = r.randn(2, 4, 4).astype(np.float32)
    want = jss.mamba_assoc_scan_ref(*map(jnp.asarray, (dA, dBx, h0)))
    targs = tuple(map(torch.from_numpy, (dA, dBx, h0)))
    for fn in (tss.mamba_assoc_scan, tss.mamba_assoc_scan_ref,
               tss.mamba_seq_scan_ref):
        _close(fn(*targs), want, SCAN_TOL)

    la = np.array([1e3, -1e3, 500.0, 0.0, -700.0, 300.0, 88.0], np.float32)
    ms = np.array([-1e3, 1e3, -500.0, 700.0, 0.0, -88.0, 2.0], np.float32)
    la, ms = la.reshape(-1, 1, 1), ms.reshape(-1, 1, 1)
    C, n = r.randn(7, 1, 1, 4, 4), r.randn(7, 1, 1, 4)
    c0 = (r.randn(1, 1), r.randn(1, 1, 4, 4), np.zeros((1, 1, 4)))
    C, n = C.astype(np.float32), n.astype(np.float32)
    c0 = tuple(a.astype(np.float32) for a in c0)
    want = jss.mlstm_carry_scan(*map(jnp.asarray, (la, ms, C, n)),
                                tuple(map(jnp.asarray, c0)), block=4)
    args = tuple(map(torch.from_numpy, (la, ms, C, n)))
    c0t = tuple(map(torch.from_numpy, c0))
    for got in (tss.mlstm_carry_scan(*args, c0t),
                tss.mlstm_carry_scan_ref(*args, c0t)):
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            _close(g, w, SCAN_TOL)


def test_tensors_off_the_cpu_never_fold():
    """A tensor that is not on the CPU goes to a kernel or raises: an
    unsupported combine raises before any launch, a supported one refuses
    a non-CUDA device.  No launch counts."""
    xs = tuple(torch.zeros((4, 2), device="meta") for _ in range(2))
    before = (tts.LOGSPACE.launches, tts.AFFINE.launches)
    with pytest.raises(NotImplementedError, match="no K4 kernel"):
        tts.tree_scan(xs, combine=lambda a, b: (a[0] + b[0], a[1] + b[1]),
                      units=(0, 0))
    with pytest.raises(ValueError, match="CUDA"):
        tts.tree_scan(xs, combine=tss.affine_combine, units=(1.0, 0.0))
    assert (tts.LOGSPACE.launches, tts.AFFINE.launches) == before
    with pytest.raises(ValueError, match="units"):
        tts.tree_scan(xs, combine=tss.affine_combine, units=(1.0,))


# ---------------------------------------------------------------------------
# mixers: forward under both scan_impl values, and decode steps
# ---------------------------------------------------------------------------

def _x(r, B, S, D):
    return r.randn(B, S, D).astype(np.float32)


@pytest.mark.parametrize("scan_impl", ["lax", "pallas"])
@pytest.mark.parametrize("kind,S,with_state", [
    ("mlstm", 64, False),      # 4 chunks of 16: the chunk-parallel K4 path
    ("mlstm", 48, True),       # continuing from a state, K4 path
    ("mlstm", 10, True),       # one short chunk
    ("slstm", 20, True),
    ("mamba", 48, False),      # 3 chunks of 16
    ("mamba", 20, True),
])
def test_mixer_forward_matches_jax(xlstm, jamba, kind, S, with_state,
                                   scan_impl):
    r = np.random.RandomState(S)
    if kind == "mamba":
        _, _, cfg, jl, tl = jamba
        jp, tp = jl["mixer"], tl["mixer"]
    else:
        jm, jparams, cfg, tparams = xlstm
        pos = 0 if kind == "mlstm" else 7
        jp = jax.tree.map(lambda a: a[0], jparams["stage"][pos])["mixer"]
        tp = _layer(tparams, pos)["mixer"]
    x = _x(r, 2, S, cfg.d_model)
    tx = torch.from_numpy(x)
    if kind == "mamba":
        st = dict(h0=r.randn(2, 128, 8).astype(np.float32),
                  conv_buf=r.randn(2, 3, 128).astype(np.float32)) \
            if with_state else {}
        jy, jst = jax.jit(lambda p, x, st: jssm.mamba_forward(
            p, cfg, x, scan_impl=scan_impl, **st))(jp, jnp.asarray(x), st)
        ty, tst = tssm.mamba_forward(
            tp, cfg, tx, scan_impl=scan_impl,
            **{k: torch.from_numpy(v) for k, v in st.items()})
    else:
        state = None
        if with_state:
            fwd = jssm.mlstm_forward if kind == "mlstm" else \
                jssm.slstm_forward
            _, state = jax.jit(lambda p, x: fwd(p, cfg, x))(
                jp, jnp.asarray(_x(r, 2, 7, cfg.d_model)))
            state = _np_tree(state)
        if kind == "mlstm":
            jy, jst = jax.jit(lambda p, x, st: jssm.mlstm_forward(
                p, cfg, x, state=st, scan_impl=scan_impl))(
                    jp, jnp.asarray(x), state)
            ty, tst = tssm.mlstm_forward(
                tp, cfg, tx, scan_impl=scan_impl,
                state=None if state is None else
                {k: torch.from_numpy(np.array(v)) for k, v in state.items()})
        else:
            jy, jst = jax.jit(lambda p, x, st: jssm.slstm_forward(
                p, cfg, x, state=st))(jp, jnp.asarray(x), state)
            ty, tst = tssm.slstm_forward(
                tp, cfg, tx, state=None if state is None else
                {k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    _close(ty, jy)
    assert set(tst) == set(jst)
    for k in jst:
        _close(tst[k], jst[k])


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "mamba"])
def test_mixer_decode_steps_match_jax(xlstm, jamba, kind):
    """Three decode steps from a prefilled state; the port updates the
    state in place, the reference returns a new one."""
    r = np.random.RandomState(5)
    if kind == "mamba":
        _, _, cfg, jl, tl = jamba
        jp, tp = jl["mixer"], tl["mixer"]
        fwd, jstep, tstep = (jssm.mamba_forward, jssm.mamba_step,
                             tssm.mamba_step)
    else:
        _, jparams, cfg, tparams = xlstm
        pos = 0 if kind == "mlstm" else 7
        jp = jax.tree.map(lambda a: a[0], jparams["stage"][pos])["mixer"]
        tp = _layer(tparams, pos)["mixer"]
        fwd, jstep, tstep = {
            "mlstm": (jssm.mlstm_forward, jssm.mlstm_step, tssm.mlstm_step),
            "slstm": (jssm.slstm_forward, jssm.slstm_step, tssm.slstm_step),
        }[kind]
    _, jst = jax.jit(lambda p, x: fwd(p, cfg, x))(
        jp, jnp.asarray(_x(r, 3, 9, cfg.d_model)))
    tst = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    jstep_fn = jax.jit(lambda p, x, st: jstep(p, cfg, x, st))
    for _ in range(3):
        x = _x(r, 3, 1, cfg.d_model)
        jy, jst = jstep_fn(jp, jnp.asarray(x), jst)
        ty, tst2 = tstep(tp, cfg, torch.from_numpy(x), tst)
        assert tst2 is tst
        _close(ty, jy)
        for k in jst:
            _close(tst[k], jst[k])


# ---------------------------------------------------------------------------
# the xlstm smoke model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan_impl", ["lax", "pallas"])
def test_xlstm_prefill_and_decode_match_jax(xlstm, scan_impl):
    jm, jp, cfg, tp = xlstm
    jm = JaxModel(jm.cfg, scan_impl="lax")
    tm = Model(cfg, device="cpu", scan_impl=scan_impl)
    assert tm.recurrent_only
    toks = np.random.RandomState(1).randint(3, 512, (2, 64)).astype(np.int32)
    jlog, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tlog, tc = tm.prefill(tp, torch.from_numpy(toks))
    _close(tlog, jlog)
    # chunked prefill continues the state: 32 + 32 tokens from a zero cache
    cc = tm.init_cache(2, 64)
    for p0 in (0, 32):
        clog, cc = tm.prefill_chunk(tp, torch.from_numpy(toks[:, p0:p0 + 32]),
                                    cc, p0)
    jcc = jm.init_cache(2, 64)
    jchunk = jax.jit(jm.prefill_chunk)
    for p0 in (0, 32):
        jclog, jcc = jchunk(jp, jnp.asarray(toks[:, p0:p0 + 32]), jcc,
                            jnp.int32(p0))
    _close(clog, jclog)
    lens = np.full((2,), 64, np.int32)
    jt = jnp.argmax(jlog, -1).astype(jnp.int32)
    tt = torch.argmax(tlog, -1).to(torch.int32)
    jdecode = jax.jit(jm.decode_step)
    for _ in range(4):
        assert tt.tolist() == np.asarray(jt).tolist()
        jlog, jc = jdecode(jp, jt, jc, jnp.asarray(lens))
        tlog, tc = tm.decode_step(tp, tt, tc, torch.from_numpy(lens))
        _close(tlog, jlog)
        jt = jnp.argmax(jlog, -1).astype(jnp.int32)
        tt = torch.argmax(tlog, -1).to(torch.int32)
    for pos in (0, 7):
        for k in jc["stage"][pos]:
            _close(tc["stage"][pos][k], jc["stage"][pos][k])


def _serve(model, params, prompts, *, exit_entropy=None, jax_pkg=False):
    cfg_cls, req_cls, eng_cls = (
        (je.EngineConfig, je.Request, je.ContinuousEngine) if jax_pkg else
        (EngineConfig, Request, ContinuousEngine))
    eng = eng_cls(model, params, cfg_cls(
        max_batch=2, max_seq=96, eos_id=EOS, decode_tick=4, page_size=16,
        exit_entropy=exit_entropy))
    for i, p in enumerate(prompts):
        eng.submit(req_cls(rid=i, prompt=p, max_new=12))
    done, steps = [], 0
    while eng.pending:
        done += eng.step()
        steps += 1
        assert steps < 500, "engine made no progress"
    return {r.rid: np.asarray(r.result).tolist() for r in done}, eng


def test_continuous_engine_matches_jax_with_state_slots_and_gate(xlstm):
    """fp32 xlstm smoke served by ContinuousEngine: the port's tokens equal
    the JAX engine's exactly under both scan_impl values; each admission
    spans one page (a state slot); the gated stream is an exact prefix of
    the ungated one and the gate fires; after the drain every page is
    free."""
    jm, jp, cfg, tp = xlstm
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, cfg.vocab_size, size=rng.randint(5, 40))
               .astype(np.int32) for _ in range(5)]
    want, jeng = _serve(JaxModel(jm.cfg, scan_impl="lax"), jp, prompts,
                        jax_pkg=True)
    for impl in ("pallas", "lax"):
        got, eng = _serve(Model(cfg, device="cpu", scan_impl=impl), tp,
                          prompts)
        assert got == want, impl
    assert eng.telemetry.pages_per_request == 1.0
    assert all(eng._slot_span(Request(rid=0, prompt=p, max_new=12)) == 16
               for p in prompts)
    assert len(eng.pages.free) == eng.pages.num_pages
    assert eng.telemetry.admissions == jeng.telemetry.admissions == 5

    gated, geng = _serve(Model(cfg, device="cpu", scan_impl="pallas"), tp,
                         prompts, exit_entropy=8.0)
    jgated, jgeng = _serve(JaxModel(jm.cfg, scan_impl="lax"), jp, prompts,
                           exit_entropy=8.0, jax_pkg=True)
    assert gated == jgated
    assert geng.telemetry.early_exits == jgeng.telemetry.early_exits > 0
    assert geng.telemetry.decode_steps < eng.telemetry.decode_steps
    for k in want:
        assert gated[k] == want[k][:len(gated[k])]


def test_recurrent_model_surface():
    assert get_config("xlstm-1.3b").num_layers == 48
    with pytest.raises(ValueError, match="scan_impl"):
        Model(get_smoke_config("xlstm-1.3b"), device="cpu", scan_impl="nope")
    assert not Model(get_smoke_config("llama3-8b"), device="cpu"
                     ).recurrent_only
    for arch in ("xlstm-1.3b", "llama3-8b"):
        assert get_config(arch).param_count() == \
            jax_config(arch).param_count()
    assert 1.2e9 < get_config("xlstm-1.3b").param_count() < 2e9


# ---------------------------------------------------------------------------
# weight carry-over of bf16 SSM trees
# ---------------------------------------------------------------------------

def _bf16_tree(tree, path=()):
    """A JAX tree as the reference holds it at param_dtype bf16: every float
    leaf bf16 except Mamba's A_log and D, which mamba_init keeps fp32."""
    if isinstance(tree, dict):
        return {k: _bf16_tree(v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16_tree(v, path + (i,)) for i, v in enumerate(tree)]
    if path[-1] in ("A_log", "D"):
        return tree
    return np.asarray(jnp.asarray(tree).astype(jnp.bfloat16))


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_bf16_ssm_trees_convert_and_run_one_layer(xlstm, jamba, arch):
    """Mamba's A_log and D stay fp32 in a bf16 tree; the converter takes
    exactly those and still refuses any other off-dtype leaf.  One layer
    runs in bf16 on the converted weights and agrees with the JAX layer
    within bf16 rounding."""
    from repro.models import transformer as jt
    jm, jp = (xlstm if arch == "xlstm-1.3b" else jamba)[:2]
    cfg = dataclasses.replace(jm.cfg, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    jp = _bf16_tree(_np_tree(jp))
    tp = from_numpy_params(jp, _port_cfg(cfg), "cpu")
    spec = jm.period_specs[0]
    lp = _layer(tp, 0)
    assert lp["mixer"]["wq" if spec.kind == "mlstm" else "A_log"].dtype == \
        (torch.bfloat16 if spec.kind == "mlstm" else torch.float32)
    x = np.random.RandomState(2).randn(1, 24, cfg.d_model).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jy, _, _ = jax.jit(lambda p, x: jt.layer_apply(
        cfg, spec, p, x, jnp.zeros((1, 24), jnp.int32)))(
            jax.tree.map(lambda a: a[0], jp["stage"][0]), xb)
    ty, _ = layer_apply(_port_cfg(cfg), LayerSpec(spec.kind, spec.is_moe,
                                       spec.has_cross, spec.has_ffn), lp,
                        torch.from_numpy(x).to(torch.bfloat16), None)
    _close(ty, np.asarray(jy.astype(jnp.float32)),
           dict(atol=0.1, rtol=0.05))
    bad = jax.tree.map(lambda a: a, jp)
    bad["stage"][0]["ln1"]["scale"] = bad["stage"][0]["ln1"]["scale"] \
        .astype(np.float32)
    with pytest.raises(TypeError, match="ln1"):
        from_numpy_params(bad, cfg, "cpu")


# ---------------------------------------------------------------------------
# K2 repair: a row with no valid position
# ---------------------------------------------------------------------------

def test_zero_length_decode_row_matches_jax():
    """lengths[b] == 0: the reference's softmax over all-masked logits is
    uniform, the mean of V over every cache position; the port's CPU
    decode_attention and K2's plain twin (partials + combine) give it."""
    r = np.random.RandomState(4)
    q = r.randn(3, 4, 16).astype(np.float32)
    kc = r.randn(3, 300, 2, 16).astype(np.float32)
    vc = r.randn(3, 300, 2, 16).astype(np.float32)
    lens = np.array([0, 7, 300], np.int32)
    want = jax_decode_attention(*map(jnp.asarray, (q, kc, vc, lens)))
    np.testing.assert_allclose(np.asarray(want)[0, 0], vc[0, :, 0].mean(0),
                               atol=1e-5)
    args = tuple(map(torch.from_numpy, (q, kc, vc, lens)))
    _close(decode_attention(*args), want, dict(atol=1e-5, rtol=1e-5))
    _close(tfd.flash_decode(*args), want, dict(atol=1e-5, rtol=1e-5))
