"""The port's image cross-attention (llama-3.2-vision-11b's smoke config:
5 layers, the 5th with a cross-attention sublayer over 17 image
embeddings) against the JAX package: ``Model.prefill`` with
``image_embeds``, a prefill chunk at an offset, ``encode_to_cache`` +
``ChunkedPrefill.run(batch=...)`` (the reference's
``test_chunked_prefill_vlm_cross_attention`` scenario), decode steps and
``cache_bytes``, on weights from the reference's ``Model.init`` carried
over with ``from_numpy_params``, in fp32 on the CPU, where K1's and K2's
wrappers run their plain twins.

Tolerances: model logits and cache rows within 1e-5 of the largest
reference value (normwise relative; fp32 summation order); token ids,
cache shapes and byte counts exactly.  Inputs come from seeded numpy
generators and ``pytest.mark.parametrize``.
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
from repro.serve import kvcache as jkv
from repro.serve.prefill import ChunkedPrefill as JaxChunkedPrefill
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.serve import kvcache as tkv
from repro_torch.serve.prefill import ChunkedPrefill
from repro_torch.weights import from_numpy_params

ARCH = "llama-3.2-vision-11b"
REL = 1e-5             # normwise relative


def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(t, j):
    """max |port - reference| within REL of max |reference|."""
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape
    err = float(np.abs(t - j).max()) / max(float(np.abs(j).max()), 1e-30)
    assert err <= REL, err


@functools.lru_cache(maxsize=None)
def _pair():
    jm = JaxModel(fp32(jax_smoke(ARCH)))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = fp32(get_smoke_config(ARCH))
    tp = from_numpy_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, Model(cfg, device="cpu"), tp


def _batch(cfg, B, S, seed=0):
    r = np.random.RandomState(seed)
    return {"tokens": r.randint(3, cfg.vocab_size, (B, S)).astype(np.int32),
            "image_embeds": r.randn(B, cfg.num_image_tokens,
                                    cfg.d_model).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _cache_close(tc, jc):
    for tlayer, jlayer in zip(tc["stage"], jc["stage"]):
        assert sorted(tlayer) == sorted(jlayer)
        for name, arr in jlayer.items():
            _rel(tlayer[name], arr)


def test_layout_puts_cross_attention_on_the_fifth_layer():
    """One period of 5 layers, the 5th with ``ln_cross`` / ``cross`` and a
    cache with ``ck`` / ``cv`` of ``num_image_tokens`` positions; the tree
    is the reference's in shape."""
    jm, jp, tm, tp = _pair()
    assert [s.has_cross for s in tm.period_specs] == [False] * 4 + [True]
    assert tm.repeats == 1 and not tm.prefix_specs
    mine = tm.init(0)
    shape = {jax.tree_util.keystr(p): tuple(np.shape(a))
             for p, a in jax.tree_util.tree_leaves_with_path(jp)}
    for tree in (mine, tp):
        assert {jax.tree_util.keystr(p): tuple(t.shape) for p, t in
                jax.tree_util.tree_leaves_with_path(tree)} == shape
    cache = tm.init_cache(2, 32, cross_len=17)
    assert "ck" not in cache["stage"][0]
    assert tuple(cache["stage"][4]["ck"].shape) == (1, 2, 17, 2, 16)
    assert tuple(cache["stage"][4]["k"].shape) == (1, 2, 32, 2, 16)


@pytest.mark.parametrize("S", [24, 300])      # plain and blockwise
def test_prefill_with_image_embeds_matches(S):
    jm, jp, tm, tp = _pair()
    batch = _batch(tm.cfg, 2, S, seed=S)
    jl_, jc = jm.prefill(jp, _jax(batch), max_seq=S + 8)
    tl_, tc = tm.prefill(tp, _torch(batch), max_seq=S + 8)
    _rel(tl_, jl_)
    _cache_close(tc, jc)


def test_prefill_without_image_embeds_raises():
    _, _, tm, tp = _pair()
    with pytest.raises(ValueError, match="image_embeds"):
        tm.prefill(tp, torch.ones((1, 4), dtype=torch.int32))


def test_chunked_prefill_vlm_cross_attention_matches():
    """The reference's scenario (B 2, S 64, blocks 16 / 32): the port's
    ``ChunkedPrefill.run(batch=...)`` equals the reference's chunked run,
    cache and all, and its own full ``Model.prefill``."""
    jm, jp, tm, tp = _pair()
    cfg = tm.cfg
    B, S = 2, 64
    batch = _batch(cfg, B, S, seed=5)
    full, fcache = tm.prefill(tp, _torch(batch), max_seq=S)
    jcp = JaxChunkedPrefill(jm, first_block=16, align=16, max_block=32)
    want, jc, _ = jcp.run(jp, jnp.asarray(batch["tokens"]),
                          jm.init_cache(B, S,
                                        cross_len=cfg.num_image_tokens),
                          batch=_jax(batch))
    tcp = ChunkedPrefill(tm, first_block=16, align=16, max_block=32)
    got, tc, stats = tcp.run(tp, _t(batch["tokens"]),
                             tm.init_cache(B, S,
                                           cross_len=cfg.num_image_tokens),
                             batch=_torch(batch))
    assert stats.blocks == 3 and stats.tokens == S
    _rel(got, want)
    _rel(got, full.numpy())
    _cache_close(tc, jc)
    _cache_close(tc, jax.tree.map(lambda t: t.numpy(), fcache))


def test_resumed_chunked_prefill_does_not_refill_the_cross_cache():
    """``start > 0`` resumes a preempted prefill: the cross K/V already in
    the cache are kept (no second ``encode_to_cache``), and the result is
    the one-go run's."""
    _, _, tm, tp = _pair()
    cfg = tm.cfg
    batch = _torch(_batch(cfg, 2, 64, seed=6))
    tcp = ChunkedPrefill(tm, first_block=16, align=16, max_block=32)
    whole, wcache, _ = tcp.run(tp, batch["tokens"], tm.init_cache(
        2, 64, cross_len=17), batch=batch)
    part, cache, stats = tcp.run(tp, batch["tokens"], tm.init_cache(
        2, 64, cross_len=17), batch=batch, max_blocks=1)
    assert stats.preempted and stats.next_start == 16
    other = dict(batch, image_embeds=torch.zeros_like(batch["image_embeds"]))
    got, cache, _ = tcp.run(tp, batch["tokens"], cache, batch=other,
                            start=stats.next_start)
    assert torch.equal(got, whole)
    assert torch.equal(cache["stage"][4]["ck"], wcache["stage"][4]["ck"])


def test_prefill_chunk_at_an_offset_matches():
    jm, jp, tm, tp = _pair()
    cfg = tm.cfg
    batch = _batch(cfg, 2, 40, seed=7)
    jc = jm.encode_to_cache(jp, _jax(batch), jm.init_cache(
        2, 48, cross_len=cfg.num_image_tokens))
    tc = tm.encode_to_cache(tp, _torch(batch), tm.init_cache(
        2, 48, cross_len=cfg.num_image_tokens))
    _cache_close(tc, jc)
    toks = batch["tokens"]
    _, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, :16]), jc, 0)
    tm.prefill_chunk(tp, _t(toks[:, :16]), tc, 0)
    jl_, jc = jm.prefill_chunk(jp, jnp.asarray(toks[:, 16:]), jc,
                               jnp.int32(16), all_logits=True)
    tl_, tc = tm.prefill_chunk(tp, _t(toks[:, 16:]), tc, 16, all_logits=True)
    assert tuple(tl_.shape) == (2, 24, cfg.vocab_size)
    _rel(tl_, jl_)
    _cache_close(tc, jc)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_steps_match(seed):
    """Prefill with image embeddings, then 3 greedy decode steps (the
    cross sublayer through K2's twin at the full 17 positions): logits
    within REL, tokens identical."""
    jm, jp, tm, tp = _pair()
    B, S = 3, 20
    batch = _batch(tm.cfg, B, S, seed=10 + seed)
    jl_, jc = jm.prefill(jp, _jax(batch), max_seq=32)
    tl_, tc = tm.prefill(tp, _torch(batch), max_seq=32)
    lens = np.full((B,), S, np.int32)
    jdecode = jax.jit(jm.decode_step)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl_, -1)).astype(np.int32)
        assert torch.argmax(tl_, -1).tolist() == nxt.tolist()
        jl_, jc = jdecode(jp, jnp.asarray(nxt), jc, jnp.asarray(lens))
        tl_, tc = tm.decode_step(tp, _t(nxt), tc, _t(lens))
        _rel(tl_, jl_)
        lens = lens + 1
    _cache_close(tc, jc)


@pytest.mark.parametrize("cross_len", [0, 17, 1601])
def test_cache_bytes_match(cross_len):
    jm, _, tm, _ = _pair()
    assert tkv.cache_bytes(tm, 4, 64, cross_len=cross_len) == \
        jkv.cache_bytes(jm, 4, 64, cross_len=cross_len)
    want = sum(t.numel() * t.element_size() for layer in tm.init_cache(
        4, 64, cross_len=cross_len)["stage"] for t in layer.values())
    assert tkv.cache_bytes(tm, 4, 64, cross_len=cross_len) == want
