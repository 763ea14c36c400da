"""The port's layers (``repro_torch.models.layers``) against the JAX
package's on the same numpy inputs, in fp32.  Tolerance atol = rtol = 1e-5:
the two differ only in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("shape", [(2, 7, 64), (3, 128)])
def test_rmsnorm(shape):
    x, scale = _rand(*shape), 1.0 + 0.1 * _rand(shape[-1], seed=1)
    _close(tl.rmsnorm({"scale": torch.from_numpy(scale)},
                      torch.from_numpy(x), 1e-5),
           jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5))


@pytest.mark.parametrize("rotary_dims", [None, 8])   # full, and half of 16
def test_rope(rotary_dims):
    B, S, H, hd = 2, 9, 4, 16
    x = _rand(B, S, H, hd)
    pos = np.arange(S)[None].repeat(B, 0) + np.array([[0], [37]])
    rd = rotary_dims or hd
    tc, ts = tl.rope_table(torch.from_numpy(pos), rd, 500000.0)
    jc, js = jl.rope_table(jnp.asarray(pos), rd, 500000.0)
    _close(tc, jc)
    _close(ts, js)
    _close(tl.apply_rope(torch.from_numpy(x), tc, ts,
                         rotary_dims=rotary_dims),
           jl.apply_rope(jnp.asarray(x), jc, js, rotary_dims=rotary_dims))


def test_swiglu():
    d, f = 64, 128
    x = _rand(2, 5, d)
    shapes = (("gate", (d, f)), ("up", (d, f)), ("down", (f, d)))
    p = {k: _rand(*s, seed=i) / np.float32(np.sqrt(s[0]))
         for i, (k, s) in enumerate(shapes, start=1)}
    _close(tl.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x)),
           jl.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x)))


def test_embed():
    table = _rand(512, 64)
    toks = np.random.RandomState(3).randint(0, 512, (3, 11)).astype(np.int32)
    _close(tl.embed({"table": torch.from_numpy(table)},
                    torch.from_numpy(toks)),
           jl.embed({"table": jnp.asarray(table)}, jnp.asarray(toks)))


def test_init_distributions_follow_reference():
    """Seeded inits draw the JAX package's distributions: N(0, 1/d_in)
    dense weights stacked over a leading dim, N(0, 0.02²) embeddings."""
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, 256, 512, torch.float32, lead=(3,))
    assert w.shape == (3, 256, 512)
    assert abs(float(w.std()) - 1 / 16) < 2e-3
    assert not torch.equal(w[0], w[1])
    e = tl.embed_init(torch.Generator().manual_seed(1), 1000, 64,
                      torch.bfloat16)
    assert e.dtype == torch.bfloat16
    assert abs(float(e.float().std()) - 0.02) < 1e-3
    again = tl.dense_init(torch.Generator().manual_seed(0), 256, 512,
                          torch.float32, lead=(3,))
    assert torch.equal(w, again)
