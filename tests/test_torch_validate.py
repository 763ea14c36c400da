"""The port's tensor audits (``repro_torch.data.validate``) against
``repro.data.validate`` on the same values: ``ok``, ``first_bad_block``
and the by_blocks ``BlockStats`` must be equal.  Seeded parametrize only."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import validate as jv
from repro_torch.data import validate as tv


def _same(t, j):
    assert t.ok == j.ok
    assert t.first_bad_block == j.first_bad_block
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)


def _values(n, seed, bad, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(n).astype(dtype)
    pos = int(rng.randint(0, n)) if n else 0
    if bad is not None and n:
        x[pos] = bad
    return x, pos


@pytest.mark.parametrize("n", [1, 1000, 1 << 14, (1 << 14) + 1, 300_001])
@pytest.mark.parametrize("bad", [None, np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("seed", [0, 1])
def test_all_finite_matches_reference(n, bad, seed):
    x, pos = _values(n, seed, bad)
    t = tv.all_finite(torch.from_numpy(x))
    _same(t, jv.all_finite(x))
    if bad is not None:
        lo, hi = t.first_bad_block
        assert lo <= pos < hi and not t.ok


@pytest.mark.parametrize("dtype", ["float64", "float16", "bfloat16"])
@pytest.mark.parametrize("seed", [2, 3])
def test_all_finite_dtypes_match_reference(dtype, seed):
    """bf16 / fp16 count as finite exactly where their fp32 cast is; fp64
    values past fp32's range are not finite, as the reference casts them."""
    x, pos = _values(70_000, seed, np.nan, np.float64)
    x[(pos + 7) % x.size] = 1e300           # finite in fp64 only
    if dtype == "bfloat16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        j = jnp.asarray(x, jnp.bfloat16)
    else:
        t = torch.from_numpy(x.astype(dtype))
        j = x.astype(dtype)
    _same(tv.all_finite(t), jv.all_finite(np.asarray(j)))


@pytest.mark.parametrize("n", [5, 40_000])
@pytest.mark.parametrize("bad", [None, -2, 512, 10_000])
@pytest.mark.parametrize("seed", [0, 4])
def test_tokens_in_range_matches_reference(n, bad, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(-1, 512, size=n).astype(np.int32)
    if bad is not None:
        toks[rng.randint(0, n)] = bad
    _same(tv.tokens_in_range(torch.from_numpy(toks), 512),
          jv.tokens_in_range(toks, 512))


def test_audit_array_custom_predicate_and_block():
    x = np.arange(100_000, dtype=np.int64)
    t = tv.audit_array(torch.from_numpy(x), lambda s: (s < 77_777).all(),
                       first_block=1000)
    j = jv.audit_array(x, lambda s: bool((s < 77_777).all()),
                       first_block=1000)
    _same(t, j)
    assert t.stats.blocks_run < 10          # geometric: O(log n) checks


@pytest.mark.parametrize("where", [None, "embed", "layer"])
def test_audit_pytree_bf16_matches_reference(where):
    rng = np.random.RandomState(9)

    def tree(arr, ints):
        return {"embed": arr(rng.standard_normal((64, 32))),
                "layers": [{"wq": arr(rng.standard_normal((32, 32))),
                            "ids": ints(np.arange(6, dtype=np.int32))}
                           for _ in range(2)],
                "final_norm": arr(np.ones(32))}

    base = tree(lambda a: a.astype(np.float32), lambda a: a)
    if where == "embed":
        base["embed"][3, 5] = np.nan
    elif where == "layer":
        base["layers"][1]["wq"][0, 0] = np.inf
    jt = {"embed": jnp.asarray(base["embed"], jnp.bfloat16),
          "layers": [{"wq": jnp.asarray(l["wq"], jnp.bfloat16),
                      "ids": jnp.asarray(l["ids"])} for l in base["layers"]],
          "final_norm": jnp.asarray(base["final_norm"], jnp.bfloat16)}
    tt = {"embed": torch.from_numpy(base["embed"]).to(torch.bfloat16),
          "layers": [{"wq": torch.from_numpy(l["wq"]).to(torch.bfloat16),
                      "ids": torch.from_numpy(l["ids"])}
                     for l in base["layers"]],
          "final_norm": torch.from_numpy(base["final_norm"]).to(
              torch.bfloat16)}
    t, j = tv.audit_pytree(tt), jv.audit_pytree(jt)
    assert t == j
    assert t[0] == (where is None)
