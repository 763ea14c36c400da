"""The port's attention (``repro_torch.models.attention`` and the plain twins
of its kernels) against the JAX package: the jnp functions the model runs
and the Pallas kernels K1/K2 in interpret mode, on the same numpy inputs in
fp32.  Tolerance atol = rtol = 1e-5 (summation order only).

On the CPU the kernel wrappers run their plain twins; on a tensor that is
neither on the CPU nor on a CUDA device they raise, and no launch counts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.flash_decode import (combine_partials, decode_partials,
                                        flash_decode as pallas_decode)
from repro.models import attention as ja
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.models import attention as ta

TOL = dict(atol=1e-5, rtol=1e-5)
H, KV, hd = 4, 2, 16


def _qkv(B, Sq, Sk, seed=0):
    r = np.random.RandomState(seed)
    f = lambda *s: r.randn(*s).astype(np.float32)   # noqa: E731
    return f(B, Sq, H, hd), f(B, Sk, KV, hd), f(B, Sk, KV, hd)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _jit(fn, *args, **static):
    """Run a JAX reference compiled once (far cheaper on the CPU than op by
    op); keyword arguments are baked in."""
    return jax.jit(functools.partial(fn, **static))(*args)


@pytest.mark.parametrize("causal,q_offset,Sq,Sk", [
    (True, 0, 16, 16), (True, 24, 8, 40), (True, 5, 12, 33),
    (False, 0, 8, 40)])
def test_plain_attention_matches_jnp(causal, q_offset, Sq, Sk):
    q, k, v = _qkv(2, Sq, Sk)
    kw = dict(causal=causal, q_offset=q_offset)
    _close(ta.plain_attention(*_t(q, k, v), **kw),
           _jit(ja.plain_attention, *_j(q, k, v), **kw))


@pytest.mark.parametrize("q_offset,Sq,Sk,q_chunk,kv_chunk", [
    (0, 48, 48, 16, 16),          # square, tiles pruned above the diagonal
    (20, 12, 50, 12, 16),         # chunked prefill: offset, Sk % kv_chunk
    (0, 40, 40, 16, 12),          # ragged q and kv chunks
])
@pytest.mark.parametrize("traced", [False, True])
def test_blockwise_attention_matches_jnp(q_offset, Sq, Sk, q_chunk, kv_chunk,
                                         traced):
    """Static int offsets prune causal tiles; a tensor offset (JAX's traced
    offset) masks over the full width instead — both give the same
    values."""
    q, k, v = _qkv(2, Sq, Sk, seed=1)
    t_off = torch.tensor(q_offset) if traced else q_offset
    j_off = jnp.int32(q_offset) if traced else q_offset
    kw = dict(causal=True, q_chunk=q_chunk, kv_chunk=kv_chunk)
    _close(ta.blockwise_attention(*_t(q, k, v), q_offset=t_off, **kw),
           _jit(ja.blockwise_attention, *_j(q, k, v), q_offset=j_off, **kw))


def test_blockwise_equals_plain_across_chunkings():
    q, k, v = _qkv(1, 24, 64, seed=2)
    ref = ta.plain_attention(*_t(q, k, v), causal=True, q_offset=40)
    for qc, kc in ((8, 16), (24, 64), (5, 7)):
        out = ta.blockwise_attention(*_t(q, k, v), causal=True, q_chunk=qc,
                                     kv_chunk=kc, q_offset=40)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def _lengths(B, S):
    r = np.random.RandomState(4)
    lens = r.randint(1, S + 1, size=B).astype(np.int32)
    lens[0], lens[1] = 1, S
    return lens


@pytest.mark.parametrize("S", [64, 50])
def test_decode_attention_matches_jnp(S):
    B = 4
    r = np.random.RandomState(3)
    q = r.randn(B, H, hd).astype(np.float32)
    kc = r.randn(B, S, KV, hd).astype(np.float32)
    vc = r.randn(B, S, KV, hd).astype(np.float32)
    lens = _lengths(B, S)
    ref = _jit(ja.decode_attention, *_j(q, kc, vc, lens))
    _close(ta.decode_attention(*_t(q, kc, vc, lens)), ref)
    # the kernel twin computes the same function (any S, any block_k)
    for bk in (16, tfd.BLOCK_K):
        _close(tfd.flash_decode_plain(*_t(q, kc, vc, lens), block_k=bk), ref)


@pytest.mark.parametrize("causal", [True, False])
def test_prefill_slot_matches_pallas_interpret(causal):
    """K1's slot: the port's attention functions and the kernel's plain
    twin against the Pallas kernel run the way tests/test_kernels.py runs
    it (interpret mode)."""
    q, k, v = _qkv(1, 64, 64, seed=5)
    ref = _jit(pallas_flash, *_j(q, k, v), causal=causal, block_q=32,
               block_k=32, interpret=True)
    _close(tfa.flash_attention(*_t(q, k, v), causal=causal), ref)
    _close(ta.plain_attention(*_t(q, k, v), causal=causal), ref)
    _close(ta.blockwise_attention(*_t(q, k, v), causal=causal, q_chunk=16,
                                  kv_chunk=32), ref)


def test_kernel_twin_handles_offsets_and_ragged_edges():
    """What the Pallas kernel asserts away (Sq % bq, Sk % bk) and lacks
    (q_offset): the K1 twin against the jnp chunked-prefill path."""
    for off, Sq, Sk in ((0, 33, 33), (17, 9, 70), (60, 5, 65)):
        q, k, v = _qkv(2, Sq, Sk, seed=off)
        _close(tfa.flash_attention(*_t(q, k, v), causal=True, q_offset=off),
               _jit(ja.plain_attention, *_j(q, k, v), causal=True,
                    q_offset=off))


def test_decode_slot_matches_pallas_interpret():
    B, S, bk = 4, 64, 32
    r = np.random.RandomState(6)
    q = r.randn(B, H, hd).astype(np.float32)
    kc = r.randn(B, S, KV, hd).astype(np.float32)
    vc = r.randn(B, S, KV, hd).astype(np.float32)
    lens = _lengths(B, S)
    ref = _jit(pallas_decode, *_j(q, kc, vc, lens), block_k=bk,
               interpret=True)
    _close(tfd.flash_decode(*_t(q, kc, vc, lens), block_k=bk), ref)
    _close(ta.decode_attention(*_t(q, kc, vc, lens)), ref)

    # partials: equal wherever a block holds a valid position; a block
    # wholly past the length merges with weight 0 in both packages
    jm, jl, jacc = _jit(decode_partials, *_j(q, kc, vc, lens), block_k=bk,
                        interpret=True)
    tm, tl, tacc = tfd.decode_partials(*_t(q, kc, vc, lens), block_k=bk)
    live = (np.arange(S // bk) * bk)[None, None, :] < lens[:, None, None]
    live = np.broadcast_to(live, tm.shape)
    for t, j in ((tm, jm), (tl, jl)):
        np.testing.assert_allclose(t.numpy()[live], np.asarray(j)[live],
                                   **TOL)
    np.testing.assert_allclose(tacc.numpy()[live], np.asarray(jacc)[live],
                               **TOL)
    assert (tl.numpy()[~live] == 0).all() and (tm.numpy()[~live] == -1e30
                                               ).all()
    # combine: the port's LSE merge == JAX's combine_partials tree
    parts = [(jm[:, :, i], jl[:, :, i], jacc[:, :, i])
             for i in range(S // bk)]
    mF, lF, aF = parts[0]
    for p in parts[1:]:
        mF, lF, aF = combine_partials((mF, lF, aF), p)
    _close(tfd.combine(tm, tl, tacc, torch.float32),
           aF / jnp.maximum(lF, 1e-30)[..., None])


def test_chunk_sizes_match_reference():
    for sq, skv in ((96, 96), (5000, 300), (256, 2048), (1, 1)):
        assert ta.attn_chunk_sizes(sq, skv) == ja.attn_chunk_sizes(sq, skv)


def test_wrappers_use_plain_twin_only_on_cpu_and_raise_elsewhere():
    """No fallback: a tensor that is not on the CPU is launched or refused;
    refusals and CPU runs leave the launch counters alone."""
    _build.reset_launches()
    q, k, v = _t(*_qkv(1, 8, 8))
    tfa.flash_attention(q, k, v)
    lens = torch.tensor([8], dtype=torch.int32)
    tfd.flash_decode(q[:, 0], k, v, lens)
    meta = lambda t: t.to("meta")                    # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(meta(q), meta(k), meta(v))
    with pytest.raises(ValueError, match="CUDA"):
        tfd.decode_partials(meta(q[:, 0]), meta(k), meta(v), meta(lens))
    m = torch.zeros((1, H, 1), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfd.combine(m, m, torch.zeros((1, H, 1, hd), device="meta"),
                    torch.float32)
    assert set(_build.launches().values()) == {0}


@pytest.mark.parametrize("causal", [True, False])
def test_reference_oracles_match_jax(causal):
    """``kernels/ref.py``: exact fp32 oracles, the causal mask aligned to
    the bottom-right corner — a chunk of the last Sq positions, which is
    K1 with q_offset = Sk - Sq."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    q, k, v = _qkv(2, 12, 40, seed=7)
    out = tref.attention_reference(*_t(q, k, v), causal=causal)
    _close(out, _jit(jref.attention_reference, *_j(q, k, v), causal=causal))
    _close(tfa.flash_attention(*_t(q, k, v), causal=causal,
                               q_offset=40 - 12 if causal else 0), out)
    lens = _lengths(2, 40)
    _close(tref.decode_attention_reference(*_t(q[:, 0], k, v, lens)),
           _jit(jref.decode_attention_reference, *_j(q[:, 0], k, v, lens)))
