"""The port's model (``repro_torch.models.model``) against the JAX package on
the same weights: the llama3-8b smoke config in fp32, weights carried over
with ``repro_torch.weights``.  Logits agree to atol = rtol = 1e-4 (two
layers of fp32 summation-order differences); greedy tokens exactly."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models.model import Model as JaxModel
from repro.optim.adamw import AdamWConfig, init_state
from repro.train.checkpoint import CheckpointManager
from repro.train.step import TrainState
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.weights import from_numpy_params, load_checkpoint

TOL = dict(atol=1e-4, rtol=1e-4)
CKPT = Path(__file__).resolve().parents[1] / "checkpoints" / \
    "llama3-8b-smoke"


def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(fp32(jax_smoke("llama3-8b")))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = fp32(get_smoke_config("llama3-8b"))
    tm = Model(cfg, device="cpu")
    tp = from_numpy_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, tm, tp


def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(3, 512, (B, S)).astype(
        np.int32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_weights_carry_over_by_name(pair):
    jm, jp, tm, tp = pair
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = dict(jax.tree_util.tree_leaves_with_path(tp))
    assert len(jl) == len(tl) == 12
    for path, leaf in jl:
        assert np.array_equal(tl[path].numpy(), np.asarray(leaf)), path
    assert tp["stage"][0]["mixer"]["wq"].shape == (tm.repeats, 64, 64)
    with pytest.raises(TypeError, match="param_dtype"):
        from_numpy_params(jax.tree.map(np.asarray, jp),
                          get_smoke_config("llama3-8b"), "cpu")


@pytest.mark.parametrize("S", [24, 300])    # plain and blockwise branches
def test_prefill_logits_match(pair, S):
    jm, jp, tm, tp = pair
    toks = _tokens(2, S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=S + 8)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_seq=S + 8)
    _close(tl, jl)
    _close(tc["stage"][0]["k"], jc["stage"][0]["k"])


def test_prefill_chunk_at_offset_matches(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(2, 40, seed=1)
    jc, tc = jm.init_cache(2, 48), tm.init_cache(2, 48)
    _, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, :16]), jc, 0)
    _, tc = tm.prefill_chunk(tp, torch.from_numpy(toks[:, :16]), tc, 0)
    jl, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, 16:]), jc,
                              jnp.int32(16), all_logits=True)
    tl, tc = tm.prefill_chunk(tp, torch.from_numpy(toks[:, 16:]), tc, 16,
                              all_logits=True)
    assert tl.shape == (2, 24, 512)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["stage"][0][name], jc["stage"][0][name])


def test_eight_decode_steps_match(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(3, 20, seed=2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=32)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_seq=32)
    jdecode = jax.jit(jm.decode_step)
    jlen = jnp.full((3,), 20, jnp.int32)
    tlen = torch.full((3,), 20, dtype=torch.int32)
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    tt = torch.argmax(tl, -1).to(torch.int32)
    for _ in range(8):
        assert tt.tolist() == np.asarray(jt).tolist()
        jl, jc = jdecode(jp, jt, jc, jlen)
        tl, tc = tm.decode_step(tp, tt, tc, tlen)
        _close(tl, jl)
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = torch.argmax(tl, -1).to(torch.int32)
        jlen, tlen = jlen + 1, tlen + 1
    _close(tc["stage"][0]["v"], jc["stage"][0]["v"])


def test_decode_at_cache_width_writes_nothing(pair):
    """A row whose length equals the cache width: the JAX mask-select
    writes nothing there and attends the whole width; so does the port's
    in-place write."""
    jm, jp, tm, tp = pair
    toks = _tokens(2, 24, seed=3)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=24)
    _, tc = tm.prefill(tp, torch.from_numpy(toks), max_seq=24)
    lens = np.array([24, 11], np.int32)
    nxt = np.array([5, 9], np.int32)
    jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(lens))
    tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                            torch.from_numpy(lens))
    _close(tl, jl)
    _close(tc["stage"][0]["k"], jc["stage"][0]["k"])


def test_checkpoint_loads_without_jax_same_leaves_and_logits():
    step_dir = CKPT / "step_00000004"
    ported = load_checkpoint(step_dir, device="cpu")
    jm = JaxModel(jax_smoke("llama3-8b"))
    params = jm.abstract_params()
    abstract = TrainState(params=params, opt=jax.eval_shape(
        lambda p: init_state(AdamWConfig(), p), params))
    restored, extra = CheckpointManager(str(CKPT)).restore(abstract, step=4)
    assert extra == {"data_step": 4}

    ref = jax.tree_util.tree_leaves_with_path(restored.params)
    got = dict(jax.tree_util.tree_leaves_with_path(ported[0]))
    assert len(ref) == len(got) == 12
    for path, leaf in ref:
        t = got[path]
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(leaf).view(np.int16)), path
    assert len(jax.tree_util.tree_leaves(ported[1])) == 25   # step, m, v

    # same logits from the restored weights, in fp32 on both sides
    jm32 = JaxModel(fp32(jax_smoke("llama3-8b")))
    jp32 = jax.tree.map(lambda x: x.astype(jnp.float32), restored.params)
    cfg = fp32(get_smoke_config("llama3-8b"))
    tp32 = jax.tree.map(lambda t: t.float(), ported[0])
    toks = _tokens(2, 16, seed=4)
    jl, _ = jm32.prefill(jp32, {"tokens": jnp.asarray(toks)})
    tl, _ = Model(cfg, device="cpu").prefill(tp32, torch.from_numpy(toks))
    _close(tl, jl)


def test_checkpoint_corruption_is_loud(tmp_path):
    import shutil
    src = CKPT / "step_00000004"
    dst = tmp_path / "step"
    shutil.copytree(src, dst)
    a = np.load(dst / "arr_00000.npy")
    a.flat[0] ^= 1
    np.save(dst / "arr_00000.npy", a)
    with pytest.raises(ValueError, match="sha256"):
        load_checkpoint(dst, device="cpu")


def test_gqa_layer_functions_match(pair):
    """The attention layer functions the model composes: full-sequence
    self attention and one decode step against a cache."""
    from repro.models import attention as ja
    from repro_torch.models import attention as ta
    jm, jp, tm, tp = pair
    jl = jax.tree.map(lambda a: a[0], jp["stage"][0]["mixer"])
    tl = {k: v[0] for k, v in tp["stage"][0]["mixer"].items()}
    r = np.random.RandomState(8)
    x = r.randn(2, 20, 64).astype(np.float32)
    pos = np.arange(20)[None].repeat(2, 0)
    _close(ta.gqa_self_attention(tl, tm.cfg, torch.from_numpy(x),
                                 torch.from_numpy(pos)),
           jax.jit(lambda p, x, pos: ja.gqa_self_attention(
               p, jm.cfg, x, pos))(jl, jnp.asarray(x), jnp.asarray(pos)))
    kc = r.randn(2, 24, 2, 16).astype(np.float32)
    vc = r.randn(2, 24, 2, 16).astype(np.float32)
    lens = np.array([24, 7], np.int32)
    t_out = ta.gqa_decode(tl, tm.cfg, torch.from_numpy(x[:, :1]),
                          torch.from_numpy(kc), torch.from_numpy(vc),
                          torch.from_numpy(lens), torch.from_numpy(lens))
    j_out = jax.jit(lambda p, *a: ja.gqa_decode(p, jm.cfg, *a))(
        jl, jnp.asarray(x[:, :1]), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lens), jnp.asarray(lens))
    for t, j in zip(t_out, j_out):
        _close(t, j)
