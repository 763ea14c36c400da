"""The port's encoder-decoder (whisper-medium's smoke config) against the
JAX package: ``layernorm``, ``gelu_mlp``, ``sinusoidal_positions``,
``cross_attention`` on both of the reference's routes, the encoder,
``Model.prefill`` with ``frames``, ``encode_to_cache`` +
``ChunkedPrefill.run(batch=...)``, decode steps and the padded-vocab mask,
on weights from the reference's ``Model.init`` carried over with
``from_numpy_params``, in fp32 on the CPU, where K1's and K2's wrappers
run their plain twins.  Also: every arch's ``param_count`` against the
reference's, bf16 whisper and vision trees converted and run one step, and
what the port refuses (the engines and the launcher for cross-attention
models; a decoder position past the ``dec_pos`` table).

Tolerances: layer functions and attention atol 1e-5; model logits and
cache rows within 1e-5 of the largest reference value (normwise relative;
fp32 summation order); token ids and parameter counts exactly.  Inputs
come from seeded numpy generators and ``pytest.mark.parametrize``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import attention as ja
from repro.models import layers as jl
from repro.models import model as jmod
from repro.models.model import Model as JaxModel
from repro.serve.prefill import ChunkedPrefill as JaxChunkedPrefill
from repro_torch.configs import jamba_1_5_large
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import model as tmod
from repro_torch.models.model import Model
from repro_torch.serve.engine import (ContinuousEngine, Engine, EngineConfig,
                                      check_servable)
from repro_torch.serve.prefill import ChunkedPrefill
from repro_torch.weights import from_numpy_params

ARCH = "whisper-medium"
TOL = dict(atol=1e-5, rtol=0)
REL = 1e-5             # model logits and caches: normwise relative
NPOS = 512             # the smoke models' dec_pos rows


def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _rel(t, j):
    """max |port - reference| within REL of max |reference|."""
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape
    err = float(np.abs(t - j).max()) / max(float(np.abs(j).max()), 1e-30)
    assert err <= REL, err


@functools.lru_cache(maxsize=None)
def _pair(arch, npos=NPOS):
    """The smoke model of ``arch`` in fp32 in both packages, one set of
    weights (the reference's)."""
    jm = JaxModel(fp32(jax_smoke(arch)), max_decoder_positions=npos)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = fp32(get_smoke_config(arch))
    tp = from_numpy_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, Model(cfg, device="cpu", max_decoder_positions=npos), tp


def _batch(cfg, B, S, S_enc, seed=0):
    """Tokens and ``frames`` (encoder-decoder) or ``image_embeds``
    (vision) as numpy arrays."""
    r = np.random.RandomState(seed)
    out = {"tokens": r.randint(3, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.is_encdec:
        out["frames"] = r.randn(B, S_enc, cfg.d_model).astype(np.float32)
    else:
        out["image_embeds"] = r.randn(B, cfg.num_image_tokens,
                                      cfg.d_model).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _cache_close(tc, jc):
    for tlayer, jlayer in zip(tc["stage"], jc["stage"]):
        assert sorted(tlayer) == sorted(jlayer)
        for name, arr in jlayer.items():
            _rel(tlayer[name], arr)


# ------------------------------------------------------------- layers


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 1024)])
@pytest.mark.parametrize("seed", [0, 1])
def test_layernorm_matches(shape, seed):
    """fp32 mean and population variance, scale and bias (non-trivial
    here), against ``jax`` on the same inputs; a shifted input keeps the
    variance's correction visible."""
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * 3 + 5).astype(np.float32)
    p = {"scale": r.randn(shape[-1]).astype(np.float32),
         "bias": r.randn(shape[-1]).astype(np.float32)}
    want = jl.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), 1e-5)
    got = tl.layernorm({k: _t(v) for k, v in p.items()}, _t(x), 1e-5)
    _close(got, want)
    init = tl.layernorm_init(shape[-1], torch.bfloat16, "cpu", lead=(2,))
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        "scale": (2, shape[-1]), "bias": (2, shape[-1])}
    assert init["scale"].eq(1).all() and not init["bias"].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_gelu_mlp_matches(seed):
    r = np.random.RandomState(seed)
    p = {"up": r.randn(64, 128) / 8, "up_b": r.randn(128),
         "down": r.randn(128, 64) / 8, "down_b": r.randn(64)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.randn(2, 7, 64).astype(np.float32)
    want = jl.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    _close(tl.gelu_mlp({k: _t(v) for k, v in p.items()}, _t(x)), want)


@pytest.mark.parametrize("seq,d", [(1, 16), (24, 64), (1500, 1024)])
def test_sinusoidal_positions_match(seq, d):
    """[sin | cos] in fp32 within the fp32 rounding of an angle of up to
    ``seq`` radians (2 ulps of seq: the two packages round pos / 10000^x
    differently), then cast: the bf16 table is the fp32 one rounded."""
    want = jmod.sinusoidal_positions(seq, d, jnp.float32)
    got = tmod.sinusoidal_positions(seq, d, torch.float32)
    _close(got, want, dict(atol=2 * np.finfo(np.float32).eps * seq, rtol=0))
    assert tuple(got.shape) == (seq, d)
    assert torch.equal(tmod.sinusoidal_positions(seq, d, torch.bfloat16),
                       got.to(torch.bfloat16))


# S <= 256 and Skv <= 1024: plain; else blockwise (S or Skv over the line)
@pytest.mark.parametrize("S,Skv", [(8, 40), (256, 1024), (300, 40),
                                   (8, 1100)])
@pytest.mark.parametrize("arch", [ARCH, "llama-3.2-vision-11b"])
def test_cross_attention_matches_on_both_routes(arch, S, Skv):
    cfg = fp32(get_smoke_config(arch))
    r = np.random.RandomState(S + Skv)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {"wq": r.randn(d, cfg.num_heads * hd) / 8,
         "wk": r.randn(d, cfg.num_kv_heads * hd) / 8,
         "wv": r.randn(d, cfg.num_kv_heads * hd) / 8,
         "wo": r.randn(cfg.num_heads * hd, d) / 8}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.randn(2, S, d).astype(np.float32)
    kv = r.randn(2, Skv, d).astype(np.float32)
    want = jax.jit(functools.partial(ja.cross_attention,
                                     cfg=fp32(jax_smoke(arch))))(
        {k: jnp.asarray(v) for k, v in p.items()}, x=jnp.asarray(x),
        kv_states=jnp.asarray(kv))
    got = ta.cross_attention({k: _t(v) for k, v in p.items()}, cfg, _t(x),
                             _t(kv))
    _close(got, want)


# ------------------------------------------------------------- the model


def test_param_tree_is_the_reference_layout():
    """``Model.init`` builds the reference's tree leaf for leaf in shape
    (``enc_stage`` one dict stacked over the encoder layers, LayerNorm
    ``scale`` / ``bias``, ``ln_cross`` / ``cross``, ``dec_pos``), and the
    carried weights are the reference's bit for bit."""
    jm, jp, tm, tp = _pair(ARCH)
    mine = tm.init(0)
    shape = {jax.tree_util.keystr(p): tuple(np.shape(a))
             for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    for tree in (mine, tp):
        assert {jax.tree_util.keystr(p): tuple(t.shape) for p, t in
                jax.tree_util.tree_leaves_with_path(tree)} == shape
    assert sorted(mine["enc_stage"]) == ["ffn", "ln1", "ln2", "mixer"]
    assert sorted(mine["stage"][0]) == ["cross", "ffn", "ln1", "ln2",
                                        "ln_cross", "mixer"]
    assert sorted(mine["final_norm"]) == ["bias", "scale"]
    assert tuple(mine["dec_pos"].shape) == (NPOS, 64)
    for p, a in jax.tree_util.tree_leaves_with_path(jp):
        t = functools.reduce(lambda n, k: n[getattr(k, "key", getattr(
            k, "idx", None))], p, tp)
        assert np.array_equal(t.numpy(), np.asarray(a)), p


@pytest.mark.parametrize("S_enc", [24, 300])    # plain and blockwise
def test_encoder_matches(S_enc):
    jm, jp, tm, tp = _pair(ARCH)
    frames = _batch(tm.cfg, 2, 4, S_enc)["frames"]
    want = jax.jit(jm._encode)(jp, jnp.asarray(frames))
    _rel(tm._encode(tp, _t(frames)), want)


@pytest.mark.parametrize("S,S_enc", [(24, 40), (300, 300)])
def test_prefill_with_frames_matches(S, S_enc):
    """Logits and every cache leaf (self K/V by position, the cross K/V
    whole, as long as the frames) within REL of the reference's."""
    jm, jp, tm, tp = _pair(ARCH)
    batch = _batch(tm.cfg, 2, S, S_enc, seed=1)
    jl_, jc = jm.prefill(jp, _jax(batch), max_seq=S + 8)
    tl_, tc = tm.prefill(tp, _torch(batch), max_seq=S + 8)
    _rel(tl_, jl_)
    _cache_close(tc, jc)
    assert tuple(tc["stage"][0]["ck"].shape) == (2, 2, S_enc, 4, 16)


def test_chunked_prefill_with_encode_to_cache_matches():
    """``ChunkedPrefill.run(batch=...)`` fills the cross K/V once
    (``encode_to_cache``) and equals the reference's chunked run and its
    own full ``Model.prefill``."""
    jm, jp, tm, tp = _pair(ARCH)
    B, S, S_enc = 2, 64, 40
    batch = _batch(tm.cfg, B, S, S_enc, seed=2)
    full, fcache = tm.prefill(tp, _torch(batch), max_seq=S)
    jcp = JaxChunkedPrefill(jm, first_block=16, align=16, max_block=32)
    want, jc, _ = jcp.run(jp, jnp.asarray(batch["tokens"]),
                          jm.init_cache(B, S, cross_len=S_enc),
                          batch=_jax(batch))
    calls = tm.calls["prefill_chunk"]
    tcp = ChunkedPrefill(tm, first_block=16, align=16, max_block=32)
    got, tc, stats = tcp.run(tp, _t(batch["tokens"]),
                             tm.init_cache(B, S, cross_len=S_enc),
                             batch=_torch(batch))
    assert stats.blocks == tm.calls["prefill_chunk"] - calls == 3
    _rel(got, want)
    _rel(got, full.numpy())
    _cache_close(tc, jc)
    _cache_close(tc, jax.tree.map(lambda t: t.numpy(), fcache))


def test_three_decode_steps_match():
    """The reference's ``test_encdec_decode_runs`` scenario: prefill with
    frames, then 3 greedy decode steps; logits within REL, tokens
    identical."""
    jm, jp, tm, tp = _pair(ARCH)
    cfg = tm.cfg
    B, S = 2, 16
    batch = _batch(cfg, B, S, S, seed=3)
    jl_, jc = jm.prefill(jp, _jax(batch), max_seq=S + 4)
    tl_, tc = tm.prefill(tp, _torch(batch), max_seq=S + 4)
    lens = np.full((B,), S, np.int32)
    jdecode = jax.jit(jm.decode_step)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl_[:, :cfg.vocab_size], -1)).astype(
            np.int32)
        assert torch.argmax(tl_[:, :cfg.vocab_size], -1).tolist() == \
            nxt.tolist()
        jl_, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.asarray(lens))
        tl_, tc = tm.decode_step(tp, _t(nxt), tc, _t(lens))
        _rel(tl_, jl_)
        lens = lens + 1
    assert bool(torch.isfinite(tl_[:, :cfg.vocab_size]).all())
    _cache_close(tc, jc)


def test_vocab_padding_masked():
    """The reference's ``test_vocab_padding_masked``: the padded vocab
    rows' logits are -1e30."""
    jm, jp, tm, tp = _pair(ARCH)
    cfg = tm.cfg
    assert cfg.vocab_padding > 0
    batch = {"tokens": torch.ones((1, 8), dtype=torch.int32),
             "frames": torch.zeros((1, 8, cfg.d_model))}
    logits, _ = tm.prefill(tp, batch, max_seq=8)
    assert tuple(logits.shape) == (1, cfg.padded_vocab)
    assert bool((logits[:, cfg.vocab_size:] < -1e20).all())
    want, _ = jm.prefill(jp, _jax({k: v.numpy() for k, v in batch.items()}),
                         max_seq=8)
    _rel(logits, want)


def test_decoder_position_past_the_table_raises():
    """The reference's gather clamps a position past ``dec_pos``; the port
    raises, in prefill, a chunk and a decode step."""
    _, _, _, tp = _pair(ARCH)
    tm = Model(fp32(get_smoke_config(ARCH)), device="cpu",
               max_decoder_positions=16)
    small = tm.init(0)
    batch = _torch(_batch(tm.cfg, 1, 17, 8))
    with pytest.raises(ValueError, match="dec_pos"):
        tm.prefill(small, batch)
    _, cache = tm.prefill(small, {k: v[:, :16] if k == "tokens" else v
                                  for k, v in batch.items()}, max_seq=20)
    with pytest.raises(ValueError, match="dec_pos"):
        tm.decode_step(small, torch.tensor([5], dtype=torch.int32), cache,
                       torch.tensor([16], dtype=torch.int32))
    with pytest.raises(ValueError, match="dec_pos"):
        tm.prefill_chunk(small, batch["tokens"][:, :4], cache, 14)


@pytest.mark.parametrize("engine", [Engine, ContinuousEngine])
@pytest.mark.parametrize("arch", [ARCH, "llama-3.2-vision-11b"])
def test_engines_and_launcher_refuse_cross_attention(arch, engine):
    """The reference's engines never fill the cross K/V; the port's raise
    ``ValueError`` naming the path that does, and so does the launcher,
    before it draws weights."""
    tm = Model(fp32(get_smoke_config(arch)), device="cpu")
    with pytest.raises(ValueError, match="ChunkedPrefill.run"):
        engine(tm, tm.init(0), EngineConfig(max_batch=2, max_seq=64))
    with pytest.raises(ValueError, match="decode_step"):
        check_servable(tm)
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="decoder-only"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


# ------------------------------------------------ configs and bf16 trees


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_param_count_matches_reference_for_every_arch(arch):
    """``param_count`` (full and active-only) and ``encoder_param_count``
    equal the reference's for every arch id, full and smoke configs
    (jamba's full config from its module: ``get_config`` refuses it)."""
    full = jamba_1_5_large.CONFIG if arch == "jamba-1.5-large-398b" \
        else get_config(arch)
    for mine, ref in ((full, jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))):
        for f in dataclasses.fields(ref):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        for active in (False, True):
            assert mine.param_count(active_only=active) == \
                ref.param_count(active_only=active)
        assert mine.encoder_param_count() == ref.encoder_param_count()


@pytest.mark.parametrize("arch", [ARCH, "llama-3.2-vision-11b"])
def test_bf16_tree_converts_and_runs_one_step(arch):
    """The reference's bf16 smoke weights (as 16-bit ints through numpy)
    carry over; a prefill with the stub and one decode step give finite
    logits within the bf16 tolerance (2e-2, the card check's) of the
    reference's."""
    jm = JaxModel(jax_smoke(arch), max_decoder_positions=64)
    jp = jm.init(jax.random.PRNGKey(1))
    cfg = get_smoke_config(arch)
    tp = from_numpy_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert tp["stage"][-1]["cross"]["wq"].dtype == torch.bfloat16
    tm = Model(cfg, device="cpu", max_decoder_positions=64)
    batch = _batch(cfg, 2, 12, 20, seed=4)
    jbatch = _jax(batch)
    tbatch = _torch(batch)
    for key in ("frames", "image_embeds"):
        if key in batch:
            jbatch[key] = jbatch[key].astype(jnp.bfloat16)
            tbatch[key] = tbatch[key].to(torch.bfloat16)
    jl_, jc = jm.prefill(jp, jbatch, max_seq=16)
    tl_, tc = tm.prefill(tp, tbatch, max_seq=16)
    lens = np.full((2,), 12, np.int32)
    nxt = np.asarray(jnp.argmax(jl_[:, :cfg.vocab_size], -1)).astype(np.int32)
    jl_, _ = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(lens))
    tl_, _ = tm.decode_step(tp, _t(nxt), tc, _t(lens))
    assert bool(torch.isfinite(tl_[:, :cfg.vocab_size]).all())
    # bf16: each product rounded once, in either package's order
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), atol=2e-2,
                               rtol=0)
