"""The port's stable sort against the JAX package on the same numpy inputs,
bit for bit: K5 (``tile_scan``, ``histogram_offsets``, and the cluster
split of its kernel), K6 (``_mt_local``, ``_mt_scatter``), K7
(``radix_tile_sort`` and its kernel's 8-bit warp rank order,
``radix_tile_sort_packed`` and its v2 kernel's passes, CTA shapes and
output transform), K8 (``_merge_path_starts``, ``_merge_level``),
``sort_u32``, ``merge_pair`` and ``argsort`` under both strategies.  On the
CPU every wrapper runs its plain twin; the JAX side runs its Pallas kernels
in interpret mode, as ``tests/test_kernels.py`` does, so sizes stay small
(n <= 16384, tile <= 8192).  Integer data: the tolerance is 0 mismatches.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from repro.core import DigitPass as JDigitPass
from repro.kernels import merge_sort as jms
from repro.kernels import radix_sort as jrs
from repro.kernels import tile_scan as jts
from repro.kernels.ops import stable_argsort as jax_stable_argsort
from repro_torch.core import DigitPass, digit_passes
from repro_torch.kernels import _build
from repro_torch.kernels import merge_sort as ms
from repro_torch.kernels import radix_sort as rs
from repro_torch.kernels import tile_scan as ts
from repro_torch.kernels.ops import stable_argsort
from repro_torch.kernels.ref import stable_argsort_reference

RNG_SEED = 20240613


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


def _same(t, j):
    """Bit-equal, dtype included (uint32 words, int32 orders)."""
    got, want = t.numpy(), np.asarray(j)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _keys(n, bits, seed, kind="random"):
    rng = np.random.default_rng(seed)
    hi = 1 << bits
    if kind == "random":
        return rng.integers(0, hi, n).astype(np.int32)
    if kind == "equal":
        return np.full(n, hi // 2, np.int32)
    if kind == "sorted":
        return np.sort(rng.integers(0, hi, n)).astype(np.int32)
    if kind == "reversed":
        return np.sort(rng.integers(0, hi, n))[::-1].astype(np.int32)
    if kind == "few":
        return rng.choice(rng.integers(0, hi, 7), n).astype(np.int32)
    raise ValueError(kind)


def _words(n, seed, bits=32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,block,inclusive", [
    (1, 256, False), (777, 64, False), (777, 64, True), (4096, 256, False),
    (1000, 7, True)])
def test_tile_scan_add_matches_reference(n, block, inclusive):
    vals = np.random.default_rng(n).integers(0, 1000, n).astype(np.int32)
    _same(ts.tile_scan(_t(vals), block=block, inclusive=inclusive),
          jts.tile_scan(jnp.asarray(vals), block=block, inclusive=inclusive))


@pytest.mark.parametrize("inclusive", [True, False])
def test_tile_scan_max_monoid_matches_reference(inclusive):
    vals = np.random.default_rng(0).integers(-1000, 1000, 777).astype(
        np.int32)
    unit = -(2 ** 31)
    _same(ts.tile_scan(_t(vals), block=64, combine=torch.maximum, unit=unit,
                       inclusive=inclusive),
          jts.tile_scan(jnp.asarray(vals), block=64, combine=jnp.maximum,
                        unit=unit, inclusive=inclusive))


@pytest.mark.parametrize("nt,r", [(1, 16), (6, 8), (48, 16), (5, 256),
                                  (16, 2)])
def test_histogram_offsets_matches_reference(nt, r):
    hist = np.random.default_rng(nt * r).integers(0, 50, (nt, r)).astype(
        np.int32)
    hist[nt // 2] = 0                                   # an empty tile row
    _same(ts.histogram_offsets(_t(hist), block=64),
          jts.histogram_offsets(jnp.asarray(hist), block=64))


@functools.lru_cache(maxsize=None)
def _k5_case(nt, r, inclusive):
    """One seeded histogram (r > 1) or 1-D array (r = 1, shaped (nt, 1))
    and the JAX package's offsets or scan of it, computed once for every
    cluster size."""
    hist = np.random.default_rng(nt * 1000 + r).integers(
        0, 1 << 20, (nt, r)).astype(np.int32)
    hist[nt // 2] = 0                                   # an empty row
    if r == 1:
        want = jts.tile_scan(jnp.asarray(hist[:, 0]), block=4096,
                             inclusive=inclusive)
    else:
        want = jts.histogram_offsets(jnp.asarray(hist), block=4096)
    return hist, np.asarray(want).reshape(nt, r)


@pytest.mark.parametrize("r,inclusive", [(1, False), (1, True), (4, False),
                                         (16, False), (256, False)])
@pytest.mark.parametrize("nt", [1, 5, 192, 1024])
@pytest.mark.parametrize("clusters", [1, 3, 16])
def test_cluster_scan_split_matches_reference(clusters, nt, r, inclusive):
    """K5 v2's decomposition (blocks of rows, column sums per block, each
    block's carry from the others' sums, then the block's own scan) equals
    the twin and the Pallas kernel bit for bit, ragged and empty blocks
    included; r = 1 is ``tile_scan`` both ways."""
    hist, want = _k5_case(nt, r, inclusive)
    got = ts.cluster_scan_plain(_t(hist), clusters, inclusive=inclusive)
    _same(got, want)
    if r == 1:
        _same(ts.tile_scan(_t(hist[:, 0]), inclusive=inclusive),
              want[:, 0])
    else:
        _same(ts.histogram_offsets(_t(hist)), want)


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,tile,total_bits,digit_bits,key_shift", [
    (1024, 256, 32, 4, 0), (512, 64, 32, 3, 0), (256, 256, 12, 8, 4),
    (128, 16, 7, 2, 20), (64, 64, 0, 4, 0), (4, 4, 4, 3, 4)])
def test_radix_tile_sort_matches_reference(n, tile, total_bits, digit_bits,
                                           key_shift):
    x = _words(n, n + tile)
    x[1::2] = x[::2]                                 # ties of whole words
    kw = dict(tile=tile, total_bits=total_bits, digit_bits=digit_bits,
              key_shift=key_shift)
    _same(rs.radix_tile_sort(_t(x), **kw),
          jrs.radix_tile_sort(jnp.asarray(x), interpret=True, **kw))


@pytest.mark.parametrize("tile", [4, 64, 256, 1024])
@pytest.mark.parametrize("key_shift", [0, 4, 20])
@pytest.mark.parametrize("total_bits", [0, 7, 12, 32])
def test_radix_tile_sort_8bit_warp_model_matches_reference(total_bits,
                                                           key_shift, tile):
    """K7a v2's rank order (8-bit passes, ranks = base[digit, warp] + the
    offset among equal digits before it in the warp's chunk) equals the
    Pallas kernel, which runs 4-bit passes, bit for bit; every word twice,
    so ties are held."""
    n = 2 * max(tile, 32)
    x = _words(n, tile * 100 + total_bits + key_shift)
    x[1::2] = x[::2]                                 # ties of whole words
    want = jrs.radix_tile_sort(jnp.asarray(x), tile=tile,
                               total_bits=total_bits, key_shift=key_shift,
                               interpret=True)
    _same(rs.radix_tile_sort_model(_t(x), tile=tile, total_bits=total_bits,
                                   key_shift=key_shift), want)
    _same(rs.radix_tile_sort(_t(x), tile=tile, total_bits=total_bits,
                             key_shift=key_shift), want)


@pytest.mark.parametrize("unpack", [False, True])
@pytest.mark.parametrize("n,n_pad,tile,num_key_bits,digit_bits", [
    (1024, 1024, 256, 12, 4), (1000, 1024, 256, 12, 4),
    (200, 256, 256, 5, 3), (4000, 4096, 256, 17, 4), (16, 16, 16, 6, 4)])
def test_radix_tile_sort_packed_matches_reference(n, n_pad, tile,
                                                  num_key_bits, digit_bits,
                                                  unpack):
    keys = _keys(n_pad, num_key_bits, n)
    keys[n:] = (1 << num_key_bits) - 1                # pad rows: the max key
    idx_bits = max(1, (n - 1).bit_length())
    kw = dict(n=n, tile=tile, num_key_bits=num_key_bits, idx_bits=idx_bits,
              digit_bits=digit_bits, unpack=unpack)
    _same(rs.radix_tile_sort_packed(_t(keys), **kw),
          jrs.radix_tile_sort_packed(jnp.asarray(keys), interpret=True,
                                     **kw))


def test_radix_tile_sort_packed_takes_the_plans_passes():
    keys = _keys(512, 12, 1)
    passes = digit_passes(12, 5, key_shift=7)        # 5 + 5 + 2 bits
    jpasses = tuple(JDigitPass(p.shift, p.bits) for p in passes)
    kw = dict(n=512, tile=128, num_key_bits=12, idx_bits=9)
    _same(rs.radix_tile_sort_packed(_t(keys), passes=passes, **kw),
          jrs.radix_tile_sort_packed(jnp.asarray(keys), passes=jpasses,
                                     interpret=True, **kw))


def _k7b_input(tile, sort_bits, kind, seed):
    """Two tiles (one at tile 8192) of raw keys below 2^sort_bits, the last
    sixth past n carrying the max key (the pad rows of a ragged input), of
    ``kind``: random, equal, sorted, reversed or 7-valued ("few").
    Returns (keys, n, idx_bits)."""
    n_pad = tile * (1 if tile >= 8192 else 2)
    keys = _keys(n_pad, min(sort_bits, 31), seed, kind).copy()
    n = n_pad - n_pad // 6
    keys[n:] = (1 << min(sort_bits, 31)) - 1
    return keys, n, max(1, (n - 1).bit_length())


_K7B_TILES = (2, 16, 32, 128, 1024, 8192)


@pytest.mark.parametrize("unpack", [False, True])
@pytest.mark.parametrize("sort_bits", [1, 4, 8, 12, 17, 24])
@pytest.mark.parametrize("tile", _K7B_TILES)
def test_packed_tile_sort_model_matches_plain_and_reference(tile, sort_bits,
                                                            unpack):
    """K7b v2's decomposition (the composite packed after the load,
    ``k7b_digits`` passes of one width, the last masked, warp ranks on the
    ``k7b_shape`` CTA and on every CTA width the kernel is built for, the
    fused output transform) equals the twin and the Pallas kernel in
    interpret mode bit for bit, ragged n included; at tile 1024 and 8192,
    24 key bits reach past bit 32 of the composite."""
    keys, n, idx_bits = _k7b_input(tile, sort_bits, "random",
                                   tile * 100 + sort_bits)
    kw = dict(n=n, tile=tile, idx_bits=idx_bits, sort_bits=sort_bits,
              unpack=unpack)
    want = jrs.radix_tile_sort_packed(
        jnp.asarray(keys), n=n, tile=tile, num_key_bits=sort_bits,
        idx_bits=idx_bits, unpack=unpack, interpret=True)
    _same(rs.radix_tile_sort_packed_plain(_t(keys), **kw), want)
    for threads in (None, 128, 256, 512, 1024):
        _same(rs.packed_tile_sort_model(_t(keys), threads=threads, **kw),
              want)
    _same(rs.radix_tile_sort_packed(_t(keys), n=n, tile=tile,
                                    num_key_bits=sort_bits,
                                    idx_bits=idx_bits, unpack=unpack), want)


@pytest.mark.parametrize("unpack", [False, True])
@pytest.mark.parametrize("kind", ["equal", "sorted", "reversed", "few"])
@pytest.mark.parametrize("tile", [32, 1024])
def test_packed_tile_sort_model_on_skewed_keys(tile, kind, unpack):
    keys, n, idx_bits = _k7b_input(tile, 12, kind, tile)
    want = jrs.radix_tile_sort_packed(
        jnp.asarray(keys), n=n, tile=tile, num_key_bits=12,
        idx_bits=idx_bits, unpack=unpack, interpret=True)
    _same(rs.packed_tile_sort_model(_t(keys), n=n, tile=tile,
                                    idx_bits=idx_bits, sort_bits=12,
                                    unpack=unpack), want)


@pytest.mark.parametrize("nt", [1, 32, 131, 132, 1024])
@pytest.mark.parametrize("tile", [1 << i for i in range(14)])
def test_k7b_shape_covers_the_tile(tile, nt):
    """K7b v2's CTA holds every word of a tile exactly once, warp-striped
    (lane l of warp w: words 32 K w + l + 32 s, s < K): K7a's CTA from one
    tile an SM up, else 256 threads from tile 256 up."""
    K, NT = rs.k7b_shape(tile, nt)
    want = rs.k7a_threads(tile) if nt >= rs.NUM_SMS or tile < 256 else 256
    assert NT == want and K == max(1, tile // NT)
    t = np.arange(NT)[:, None]
    j = 32 * K * (t // 32) + t % 32 + 32 * np.arange(K)[None]
    assert sorted(j[j < tile].tolist()) == list(range(tile))


@pytest.mark.parametrize("sort_bits", list(range(0, 33)))
def test_k7b_digits_rank_every_key_bit_in_the_fewest_passes(sort_bits):
    """ceil(bits / 8) passes of one even width <= 8 cover exactly the key
    bits below bit 32 of the composite, whatever the tile."""
    for tile in (2, 1024, 8192):
        bits = min(sort_bits, 32 - (tile.bit_length() - 1))
        width, passes = rs.k7b_digits(sort_bits, tile)
        assert width in (2, 4, 6, 8)
        assert passes == -(-bits // 8)
        assert (passes - 1) * width < bits <= passes * width or \
            bits == passes == 0


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("nt,tile,bits,shift", [(8, 64, 4, 12), (4, 256, 3, 14),
                                                (3, 128, 8, 10)])
def test_mt_local_matches_reference(nt, tile, bits, shift, pack):
    idx_bits = 10
    if pack:
        x = _keys(nt * tile, 8, nt + tile)
    else:
        x = _words(nt * tile, nt + tile)
    kw = dict(nt=nt, tile=tile, shift=shift, bits=bits, pack=pack,
              idx_bits=idx_bits)
    local, hist = rs._mt_local(_t(x), **kw)
    jlocal, jhist = jrs._mt_local(jnp.asarray(x), group=8, interpret=True,
                                  **kw)
    _same(local, jlocal)
    _same(hist, jhist)


@pytest.mark.parametrize("unpack_mask", [None, (1 << 10) - 1])
@pytest.mark.parametrize("nt,tile,bits", [(8, 64, 4), (5, 128, 2),
                                          (3, 256, 8)])
def test_mt_scatter_matches_reference(nt, tile, bits, unpack_mask):
    x = _keys(nt * tile, 8, nt)
    x[: tile // 2] = 3                                  # a one-digit segment
    kw = dict(nt=nt, tile=tile, shift=10, bits=bits, pack=True, idx_bits=10)
    local, hist = jrs._mt_local(jnp.asarray(x), group=8, interpret=True, **kw)
    base = jts.histogram_offsets(hist, interpret=True)
    local, hist, base = (np.asarray(a) for a in (local, hist, base))
    got = rs._mt_scatter(_t(local), _t(hist), _t(base), tile=tile,
                         radix=1 << bits, unpack_mask=unpack_mask)
    want = jrs._mt_scatter(jnp.asarray(local), jnp.asarray(hist),
                           jnp.asarray(base), tile=tile, radix=1 << bits,
                           group=8, interpret=True, unpack_mask=unpack_mask)
    _same(got, want)


def _k6_input(tile, bits, pack, kind, seed):
    """One multi-tile pass's input at a small size: raw 12-bit keys (pack,
    pass 0) or u32 words (a later pass), of ``kind``: random (words twice:
    ties), all-equal, one digit (every pass digit the same), sorted,
    reversed, or sentinel-padded (the last third the pad key: the max key
    or the sentinel word).  Returns (x, nt, shift, idx_bits)."""
    nt = max(2, min(64, 2048 // tile)) if tile < 4096 else 2
    n = nt * tile
    idx_bits = max(1, (n - 1).bit_length())
    shift = idx_bits if pack else 5
    rng = np.random.default_rng(seed)
    if pack:
        x = rng.integers(0, 1 << 12, n).astype(np.int64)
        pad, field = (1 << 12) - 1, (1 << bits) - 1
    else:
        x = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.int64)
        x[1::2] = x[::2]
        pad, field = rs.SENTINEL, ((1 << bits) - 1) << shift
    if kind == "all-equal":
        x[:] = x[0]
    elif kind == "one-digit":
        x = (x & ~field) | (field & 0x5A5A5A5A)
    elif kind == "sorted":
        x = np.sort(x)
    elif kind == "reversed":
        x = np.sort(x)[::-1].copy()
    elif kind == "sentinel-padded":
        x[n - n // 3:] = pad
    x = x.astype(np.int32) if pack else x.astype(np.uint32)
    return x, nt, shift, idx_bits


_K6_TILES = (1, 2, 4, 32, 64, 256, 1024, 8192)
_K6_KINDS = ("random", "all-equal", "one-digit", "sorted", "reversed",
             "sentinel-padded")


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("bits", [1, 3, 4, 8])
@pytest.mark.parametrize("tile", _K6_TILES)
def test_mt_local_model_matches_plain_and_reference(tile, bits, pack):
    """K6a v2's decomposition (warp chunks, (digit, warp) bases plus the
    in-warp offset, ``hist`` as the digit sums) equals the twin and the
    Pallas kernel in interpret mode bit for bit."""
    x, nt, shift, idx_bits = _k6_input(tile, bits, pack, "random",
                                       tile * 10 + bits)
    kw = dict(nt=nt, tile=tile, shift=shift, bits=bits, pack=pack,
              idx_bits=idx_bits)
    local, hist = rs.mt_local_model(_t(x), **kw)
    plocal, phist = rs.mt_local_plain(_t(x), **kw)
    _same(local, plocal.numpy())
    _same(hist, phist.numpy())
    jlocal, jhist = jrs._mt_local(jnp.asarray(x), group=8, interpret=True,
                                  **kw)
    _same(local, jlocal)
    _same(hist, jhist)


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("kind", _K6_KINDS[1:])
@pytest.mark.parametrize("tile", [32, 1024])
def test_mt_local_model_on_skewed_tiles(tile, kind, pack):
    x, nt, shift, idx_bits = _k6_input(tile, 4, pack, kind, tile)
    kw = dict(nt=nt, tile=tile, shift=shift, bits=4, pack=pack,
              idx_bits=idx_bits)
    local, hist = rs.mt_local_model(_t(x), **kw)
    jlocal, jhist = jrs._mt_local(jnp.asarray(x), group=8, interpret=True,
                                  **kw)
    _same(local, jlocal)
    _same(hist, jhist)
    _same(rs._mt_local(_t(x), **kw)[0], jlocal)


def _k6b_input(tile, bits, kind, seed):
    x, nt, shift, idx_bits = _k6_input(tile, bits, True, kind, seed)
    kw = dict(nt=nt, tile=tile, shift=shift, bits=bits, pack=True,
              idx_bits=idx_bits)
    local, hist = rs.mt_local_plain(_t(x), **kw)
    return local, hist, ts.histogram_offsets(hist), (1 << idx_bits) - 1


@pytest.mark.parametrize("unpack", [False, True])
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("tile", _K6_TILES)
def test_mt_scatter_model_matches_plain_and_reference(tile, bits, unpack):
    """K6b v2 thread by thread (each thread's words, one search for the
    first one's segment, then a forward walk) equals the twin and the
    Pallas kernel in interpret mode bit for bit."""
    local, hist, base, mask = _k6b_input(tile, bits, "random", tile + bits)
    um = mask if unpack else None
    got = rs.mt_scatter_model(local, hist, base, tile=tile, unpack_mask=um)
    _same(got, rs.mt_scatter_plain(local, hist, base, tile=tile,
                                   unpack_mask=um).numpy())
    _same(got, jrs._mt_scatter(
        jnp.asarray(local.numpy()), jnp.asarray(hist.numpy()),
        jnp.asarray(base.numpy()), tile=tile, radix=1 << bits, group=8,
        interpret=True, unpack_mask=um))


@pytest.mark.parametrize("kind", _K6_KINDS[1:])
@pytest.mark.parametrize("tile", [32, 1024, 8192])
def test_mt_scatter_model_on_skewed_tiles(tile, kind):
    local, hist, base, mask = _k6b_input(tile, 4, kind, tile)
    got = rs.mt_scatter_model(local, hist, base, tile=tile, unpack_mask=mask)
    _same(got, jrs._mt_scatter(
        jnp.asarray(local.numpy()), jnp.asarray(hist.numpy()),
        jnp.asarray(base.numpy()), tile=tile, radix=16, group=8,
        interpret=True, unpack_mask=mask))
    _same(rs._mt_scatter(local, hist, base, tile=tile, radix=16,
                         unpack_mask=mask), np.asarray(got))


@pytest.mark.parametrize("tile,shape", [(1, (1, 256)), (64, (1, 256)),
                                        (256, (1, 256)), (512, (2, 256)),
                                        (1024, (4, 256)), (2048, (8, 256)),
                                        (4096, (16, 256)), (8192, (32, 256))])
def test_k6b_shape_covers_the_tile(tile, shape):
    """K6b v2's threads, lane l of warp w holding the words 32 W w + l +
    32 k (k < W), hold every word of a tile exactly once, and at most one
    CTA's worth of threads more than the tile (idle at small tiles)."""
    assert rs.k6b_shape(tile) == shape
    W, NT = shape
    t = np.arange(NT)[:, None]
    j = 32 * W * (t // 32) + t % 32 + 32 * np.arange(W)[None]
    assert sorted(j[j < tile].tolist()) == list(range(tile))
    assert W == 1 or W * NT < 2 * tile


@pytest.mark.parametrize("n,tile,num_key_bits", [(2048, 256, 12),
                                                 (1000, 256, 8),
                                                 (3000, 128, 16),
                                                 (1000, 1024, 12)])
def test_multi_tile_argsort_packed_matches_reference(n, tile, num_key_bits):
    n_pad = -(-n // tile) * tile
    keys = _keys(n_pad, num_key_bits, n)
    keys[n:] = (1 << num_key_bits) - 1
    idx_bits = max(1, (n - 1).bit_length())
    kw = dict(n=n, tile=tile, num_key_bits=num_key_bits, idx_bits=idx_bits)
    _same(rs.multi_tile_argsort_packed(_t(keys), **kw),
          jrs.multi_tile_argsort_packed(jnp.asarray(keys), interpret=True,
                                        **kw))


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run,tile,pairs,hi", [(128, 32, 1, 16),
                                               (256, 64, 4, 1 << 30),
                                               (64, 64, 2, 4)])
def test_merge_path_starts_matches_reference(run, tile, pairs, hi):
    rng = np.random.default_rng(run + hi)
    ab = np.sort(rng.integers(0, hi, (pairs, 2, run)), axis=-1).astype(
        np.uint32)
    for got, want in zip(ms._merge_path_starts(_t(ab), run, tile),
                         jms._merge_path_starts(jnp.asarray(ab), run, tile)):
        _same(got, want)


@pytest.mark.parametrize("unpack_mask", [None, (1 << 12) - 1])
@pytest.mark.parametrize("run,tile,pairs,hi", [(256, 64, 4, 1 << 30),
                                               (128, 128, 2, 16),
                                               (64, 16, 8, 1 << 32)])
def test_merge_level_matches_reference(run, tile, pairs, hi, unpack_mask):
    rng = np.random.default_rng(run * pairs)
    runs = np.sort(rng.integers(0, hi, (pairs, 2, run), dtype=np.uint64),
                   axis=-1).astype(np.uint32)
    runs[0, 1, -3:] = rs.SENTINEL                    # pad sentinels
    runs[0, 0, -2:] = rs.SENTINEL
    x = runs.reshape(-1)
    _same(ms._merge_level(_t(x), run=run, tile=tile, unpack_mask=unpack_mask),
          jms._merge_level(jnp.asarray(x), run=run, tile=tile,
                           interpret=True, unpack_mask=unpack_mask))


def _sorted_runs(n, run, kind, seed):
    """(n,) uint32 words in sorted runs of ``run``: random with ties (every
    word twice), all equal, the whole input sorted (each pair's A below its
    B), reversed (each A above its B: the most skewed split), or random
    with sentinel-padded tails."""
    rng = np.random.default_rng(seed)
    if kind == "equal":
        return np.full(n, 0x9E3779B9, np.uint32)
    w = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    if kind == "ties":
        w[1::2] = w[::2]
    if kind == "sorted":
        return np.sort(w).astype(np.uint32)
    if kind == "reversed":
        return np.sort(w).astype(np.uint32).reshape(-1, run)[::-1].reshape(
            -1).copy()
    runs = np.sort(w.reshape(-1, run), axis=1).astype(np.uint32)
    if kind == "padded":
        runs[:, -(run // 3 + 1):] = rs.SENTINEL
    return runs.reshape(-1)


@pytest.mark.parametrize("kind", ["ties", "equal", "sorted", "reversed",
                                  "padded"])
@pytest.mark.parametrize("n,tile,runs,unpack_mask", [
    (2048, 64, "one", None), (2048, 64, "four", None),
    (2048, 64, "half", (1 << 11) - 1), (8192, 512, "moe", None),
    (8192, 512, "moe", (1 << 13) - 1)])
def test_merge_level_model_matches_plain_and_reference(n, tile, runs,
                                                       unpack_mask, kind):
    """K8 v2's partition (``merge_level_model``: blocks of ``k8_block``,
    k-ary co-ranks, per-thread sub-diagonals, the merge order) bit for bit
    against the twin ``merge_level_plain`` and the Pallas
    ``_merge_level`` in interpret mode: runs of one tile, four tiles and
    n/2, the unpack mask, and the four levels of an 8192-word MoE argsort
    (runs 512 to 4096) at v2's own block and at blocks of 1 to 16 words a
    thread."""
    lengths = {"one": [tile], "four": [4 * tile], "half": [n // 2],
               "moe": [512, 1024, 2048, 4096]}[runs]
    for run in lengths:
        x = _sorted_runs(n, run, kind, run + n)
        want = jax.jit(functools.partial(
            jms._merge_level, run=run, tile=tile, interpret=True,
            unpack_mask=unpack_mask))(jnp.asarray(x))
        _same(ms.merge_level_plain(_t(x), run=run, unpack_mask=unpack_mask),
              want)
        blocks = {ms.k8_block(n, run)} | ({256 * w for w in (2, 4, 8, 16)
                                           if 256 * w <= 2 * run}
                                          if runs == "moe" else set())
        for block in sorted(blocks):
            _same(ms.merge_level_model(_t(x), run=run, block=block,
                                       unpack_mask=unpack_mask), want)


@pytest.mark.parametrize("run,block,pairs,hi", [
    (128, 32, 2, 16), (256, 512, 3, 1 << 30), (1024, 256, 1, 1 << 32),
    (4096, 256, 1, 7), (1 << 14, 2048, 1, 1 << 32), (512, 1024, 4, 2),
    (64, 16, 8, 1)])
def test_kary_coranks_match_merge_path_starts(run, block, pairs, hi):
    """K8 v2's 32-ary co-rank search (``kary_coranks``) at every block
    diagonal equals the binary search of ``_merge_path_starts`` and the
    JAX package's, for blocks that are not the tile and blocks that hold
    the whole pair (no round), on random, few-valued and all-equal runs;
    it takes ceil(log_129(run + 1)) rounds at most."""
    rng = np.random.default_rng(run + block + hi)
    ab = np.sort(rng.integers(0, hi, (pairs, 2, run), dtype=np.uint64),
                 axis=-1).astype(np.uint32)
    a0, b0, la, rounds = ms.kary_coranks(_t(ab), run, block)
    for got, mine, want in zip(
            (a0, b0, la), ms._merge_path_starts(_t(ab), run, block),
            jms._merge_path_starts(jnp.asarray(ab), run, block)):
        _same(got, want)
        _same(mine, want)
    assert rounds <= int(np.ceil(np.log(run + 1) / np.log(ms.K8_PROBES + 1)))
    assert (rounds == 0) == (block == 2 * run)


def test_k8_block_rule():
    """v2's block: 8 words a thread in 512 CTAs at 2^20 words, 1 word a
    thread in 32 CTAs at 8192 (the MoE levels), never past the pair, and a
    power of two that divides it."""
    assert ms.k8_block(1 << 20, 1024) == 2048
    assert ms.k8_block(1 << 20, 1 << 19) == 2048
    assert ms.k8_block(1 << 24, 1 << 12) == 4096
    for run in (512, 1024, 2048, 4096):
        assert ms.k8_block(8192, run) == 256
    for n in (2, 64, 8192, 1 << 20, 1 << 24):
        for run in (1 << i for i in range(n.bit_length() - 1)):
            block = ms.k8_block(n, run)
            assert block <= 2 * run and (2 * run) % block == 0
            assert block <= ms.K8_THREADS * ms.K8_MAX_WORDS


@pytest.mark.parametrize("n,tile", [(256, 64), (512, 512), (128, 16)])
def test_merge_pair_matches_reference(n, tile):
    rng = np.random.default_rng(n)
    a = np.sort(rng.integers(0, 64, n)).astype(np.uint32)
    b = np.sort(rng.integers(0, 64, n)).astype(np.uint32)
    _same(ms.merge_pair(_t(a), _t(b), tile=tile),
          jms.merge_pair(jnp.asarray(a), jnp.asarray(b), tile=tile,
                         interpret=True))


@pytest.mark.parametrize("n,tile,total_bits", [(2048, 256, 32),
                                               (1024, 128, 20), (16, 2, 32),
                                               (8, 1, 32), (256, 512, 32)])
def test_sort_u32_matches_reference(n, tile, total_bits):
    x = _words(n, n * 3 + tile, bits=total_bits)
    _same(ms.sort_u32(_t(x), tile=tile, total_bits=total_bits),
          jms.sort_u32(jnp.asarray(x), tile=tile, total_bits=total_bits,
                       interpret=True))


def test_sort_u32_bitonic_matches_reference():
    x = _words(1024, 5)
    _same(ms.sort_u32(_t(x), tile=128, method="bitonic"),
          jms.sort_u32(jnp.asarray(x), tile=128, method="bitonic",
                       interpret=True))


# ---------------------------------------------------------------------------
# argsort, end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["multi_tile", "merge"])
@pytest.mark.parametrize("n,num_key_bits,kind", [
    (4096, 12, "random"), (4000, 12, "few"), (3000, 6, "equal"),
    (1000, 12, "random"),           # n <= tile: one fused launch
    (2048, 8, "sorted"),            # 8 tiles of 256: odd merge depth 3
    (1537, 4, "reversed"), (5, 3, "random"), (1, 12, "random")])
def test_argsort_matches_reference(n, num_key_bits, kind, strategy):
    keys = _keys(n, num_key_bits, n, kind)
    got = ms.argsort(_t(keys), num_key_bits=num_key_bits, tile=256,
                     strategy=strategy)
    _same(got, jms.argsort(jnp.asarray(keys), num_key_bits=num_key_bits,
                           tile=256, strategy=strategy, interpret=True))
    _same(got, np.argsort(keys, kind="stable").astype(np.int32))


def test_argsort_17_bit_keys_pick_merge_and_match_reference():
    keys = _keys(4096, 17, 17)
    got = ms.argsort(_t(keys), num_key_bits=17, tile=256)
    _same(got, jms.argsort(jnp.asarray(keys), num_key_bits=17, tile=256,
                           interpret=True))
    _same(got, ms.argsort(_t(keys), num_key_bits=17, tile=256,
                          strategy="merge"))
    with pytest.raises(ValueError, match="multi_tile"):
        ms.argsort(_t(keys), num_key_bits=17, method="bitonic",
                   strategy="multi_tile")


# ---------------------------------------------------------------------------
# K9: the comparison pipeline's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,tile", [(1024, 128), (2048, 2048), (256, 16),
                                    (64, 1)])
def test_tile_sort_matches_reference(n, tile):
    x = _words(n, n + tile)
    x[1::3] = x[::3][:len(x[1::3])]              # repeated words
    _same(ms.tile_sort(_t(x), tile=tile),
          jms.tile_sort(jnp.asarray(x), tile=tile, interpret=True))


@pytest.mark.parametrize("tile", [1 << i for i in range(14)])
def test_tile_sort_register_schedule_matches_reference(tile):
    """K9a v2's stage schedule (``tile_sort_model``: W words a thread,
    in-thread, warp-shuffle and strided shared-memory stages) bit for bit
    against the Pallas ``tile_sort`` in interpret mode, on random words with
    ties, sorted and reverse-sorted words; three tiles (one at 8192), so
    blocks of several small tiles and a padded last block occur."""
    n = tile * (3 if tile < 8192 else 1)
    ref = jax.jit(functools.partial(jms.tile_sort, tile=tile, interpret=True))
    ties = _words(n, tile)
    ties[1::2] = ties[::2][:len(ties[1::2])]
    srt = np.sort(_words(n, tile + 1))
    for x in (ties, srt, srt[::-1].copy()):
        want = ref(jnp.asarray(x))
        _same(ms.tile_sort_model(_t(x), tile=tile), want)
        _same(ms.tile_sort(_t(x), tile=tile), want)


def test_tile_sort_blocks_keep_wide_stages_in_thread():
    """K9a's (W, NT) rule: a block of W·NT words holds whole tiles, W words
    load as 16-byte vectors, and 32·W >= NT, so every stage with j >= 32·W
    is a multiple of NT (in-thread in the strided layout)."""
    for tile in (1 << i for i in range(14)):
        W, NT = ms.k9a_shape(tile)
        assert W % 4 == 0 and NT % 32 == 0 and 32 * W >= NT
        assert W * NT >= tile and (W * NT) % tile == 0
    assert ms.k9a_shape(1024) == (8, 128)
    assert ms.k9a_shape(ms.MAX_BITONIC_TILE) == (16, 512)


@pytest.mark.parametrize("m,n,idx_bits,key_bits", [
    (4096, 4096, 12, 12), (2048, 1537, 11, 8), (8, 5, 3, 29), (1024, 0, 10, 4)])
def test_pack_and_unpack_match_reference(m, n, idx_bits, key_bits):
    keys = _keys(m, key_bits, m + n)
    packed = ms._pack(_t(keys), n=n, idx_bits=idx_bits)
    _same(packed, jms._pack(jnp.asarray(keys), n=n, idx_bits=idx_bits,
                            interpret=True))
    mask = (1 << idx_bits) - 1
    _same(ms._unpack(packed, idx_mask=mask),
          jms._unpack(jnp.asarray(packed.numpy()), idx_mask=mask,
                      interpret=True))


@pytest.mark.parametrize("n,num_key_bits", [(4096, 4), (1000, 9), (3, 2)])
def test_argsort_bitonic_unfused_matches_reference(n, num_key_bits):
    """The MoE layer's comparison route: ``method="bitonic", fused=False``
    (K9b, K9a, K8 levels, K9c), ragged n padded to a power of two."""
    keys = _keys(n, num_key_bits, 7 * n)
    kw = dict(num_key_bits=num_key_bits, tile=256, method="bitonic",
              fused=False)
    got = ms.argsort(_t(keys), **kw)
    _same(got, jms.argsort(jnp.asarray(keys), interpret=True, **kw))
    _same(got, np.argsort(keys, kind="stable").astype(np.int32))


@pytest.mark.parametrize("kw", [dict(fused=False),
                                dict(method="bitonic", fused=False)])
def test_argsort_comparison_pipelines_on_the_cpu(kw):
    """``test_argsort_methods_agree``'s counterpart: the unfused and the
    bitonic pipelines run on the CPU twins and give the reference's order."""
    keys = _keys(3000, 8, 9)
    got = ms.argsort(_t(keys), tile=256, **kw)
    _same(got, jms.argsort(jnp.asarray(keys), tile=256, interpret=True, **kw))
    _same(got, ms.argsort(_t(keys), tile=256))


def test_stable_argsort_entry_point_matches_reference():
    keys = _keys(3000, 10, 3)
    got = stable_argsort(_t(keys), num_key_bits=10, tile=256)
    _same(got, jax_stable_argsort(jnp.asarray(keys), num_key_bits=10,
                                  tile=256))
    _same(got, stable_argsort_reference(_t(keys)).numpy())


@settings(max_examples=60, deadline=None, database=None)
@given(st.integers(1, 5000), st.integers(1, 16), st.sampled_from(
    [16, 64, 256, 1024]), st.sampled_from(["multi_tile", "merge"]),
    st.integers(0, 2 ** 31 - 1))
def test_argsort_sweep_vs_torch_stable_argsort(n, bits, tile, strategy,
                                               seed):
    keys = torch.from_numpy(_keys(n, bits, seed))
    got = ms.argsort(keys, num_key_bits=bits, tile=tile, strategy=strategy)
    assert torch.equal(got, torch.argsort(keys, stable=True).to(torch.int32))


# ---------------------------------------------------------------------------
# loud errors
# ---------------------------------------------------------------------------

def test_argsort_negative_keys_raise_where_the_reference_corrupts():
    """The reference checks only the largest key: a negative key passes and
    its output is not a permutation.  The port checks both ends."""
    keys = np.asarray([3, -1, 2, 0], np.int32)
    ref = np.asarray(jms.argsort(jnp.asarray(keys), num_key_bits=4, tile=256,
                                 interpret=True))
    np.testing.assert_array_equal(ref, [3, 2, 0, 3])     # not a permutation
    assert sorted(ref.tolist()) != list(range(4))
    with pytest.raises(ValueError, match=">= 0"):
        ms.argsort(_t(keys), num_key_bits=4, tile=256)
    with pytest.raises(ValueError, match=">= 0"):
        stable_argsort(_t(keys), num_key_bits=4)


def test_argsort_key_overflow_raises_like_the_reference():
    keys = np.asarray([1, 1 << 4, 3], np.int32)
    with pytest.raises(ValueError, match="num_key_bits"):
        jms.argsort(jnp.asarray(keys), num_key_bits=4)
    with pytest.raises(ValueError, match="num_key_bits"):
        ms.argsort(_t(keys), num_key_bits=4)


@pytest.mark.parametrize("n,bits", [(1025, 22), (3, 31), (1 << 20, 13)])
def test_argsort_packing_overflow_raises_like_the_reference(n, bits):
    for argsort, z in ((jms.argsort, jnp.zeros(n, jnp.int32)),
                       (ms.argsort, torch.zeros(n, dtype=torch.int32))):
        with pytest.raises(ValueError, match="cannot pack"):
            argsort(z, num_key_bits=bits)


def test_argsort_wide_keys_at_small_n_match_the_reference():
    keys = np.random.default_rng(1).integers(0, 1 << 22, 1000).astype(
        np.int32)
    _same(ms.argsort(_t(keys), num_key_bits=22, tile=256),
          jms.argsort(jnp.asarray(keys), num_key_bits=22, tile=256,
                      interpret=True))


@pytest.mark.parametrize("passes,match", [
    ((DigitPass(0, 4),), "key_shift"),
    ((DigitPass(4, 2), DigitPass(6, 4)), "uniform stride"),
    ((DigitPass(4, 4), DigitPass(12, 2)), "uniform stride")])
def test_radix_tile_sort_packed_rejects_malformed_schedules(passes, match):
    kw = dict(n=16, tile=16, num_key_bits=6, idx_bits=4)
    jpasses = tuple(JDigitPass(p.shift, p.bits) for p in passes)
    with pytest.raises(ValueError, match=match):
        jrs.radix_tile_sort_packed(jnp.zeros(16, jnp.int32), passes=jpasses,
                                   interpret=True, **kw)
    with pytest.raises(ValueError, match=match):
        rs.radix_tile_sort_packed(torch.zeros(16, dtype=torch.int32),
                                  passes=passes, **kw)
    out = rs.radix_tile_sort_packed(torch.zeros(16, dtype=torch.int32),
                                    passes=(DigitPass(4, 4),
                                            DigitPass(8, 2)), **kw)
    assert out.shape == (16,) and out.dtype == torch.uint32


@pytest.mark.parametrize("tile,digit_bits,match", [
    (1 << 14, 4, "tile ≤"), (96, 4, "power of two"), (256, 9, "digit_bits")])
def test_tile_checks_raise_like_the_reference(tile, digit_bits, match):
    x = np.zeros(1 << 14, np.uint32)
    with pytest.raises(ValueError, match=match):
        jrs.radix_tile_sort(jnp.asarray(x), tile=tile, digit_bits=digit_bits)
    with pytest.raises(ValueError, match=match):
        rs.radix_tile_sort(_t(x), tile=tile, digit_bits=digit_bits)


def test_multi_tile_schedule_key_shift_must_be_idx_bits():
    keys = torch.zeros(512, dtype=torch.int32)
    with pytest.raises(ValueError, match="idx_bits"):
        rs.multi_tile_argsort_packed(keys, n=512, tile=128, num_key_bits=8,
                                     idx_bits=9, passes=digit_passes(8, 4))


# ---------------------------------------------------------------------------
# no fallback: a tensor off the CPU never reaches a twin
# ---------------------------------------------------------------------------

def test_wrappers_on_a_non_cpu_tensor_launch_or_raise():
    """A meta tensor stands in for a CUDA one here: every wrapper, the K9
    comparison pipeline's included, refuses it instead of running its
    twin, and no launch counter moves."""
    _build.reset_launches()
    u = torch.empty(1024, dtype=torch.uint32, device="meta")
    k = torch.empty(1024, dtype=torch.int32, device="meta")
    h = torch.empty(4, 16, dtype=torch.int32, device="meta")
    for call in (
            lambda: rs.radix_tile_sort(u, tile=256),
            lambda: rs.radix_tile_sort_packed(k, n=1024, tile=256,
                                              num_key_bits=8, idx_bits=10),
            lambda: rs.radix_tile_sort_packed(
                k, n=1024, tile=256, num_key_bits=8, idx_bits=10,
                threads=rs.k7b_shape(256, 4)[1]),
            lambda: rs.radix_tile_sort_packed(k, n=1024, tile=256,
                                              num_key_bits=8, idx_bits=10,
                                              unpack=True, v1=True),
            lambda: rs._mt_local(k, nt=4, tile=256, shift=10, bits=4,
                                 pack=True, idx_bits=10),
            lambda: rs._mt_scatter(u.reshape(4, 256), h, h, tile=256,
                                   radix=16),
            lambda: rs._mt_scatter(u.reshape(4, 256), h, h, tile=256,
                                   radix=16, unpack_mask=1023),
            lambda: ms._merge_level(u, run=256, tile=256),
            lambda: ts.tile_scan(k),
            lambda: ms.tile_sort(u, tile=256),
            lambda: ms._pack(k, n=1024, idx_bits=10),
            lambda: ms._unpack(u, idx_mask=1023)):
        with pytest.raises((ValueError, TypeError)):
            call()
    with pytest.raises(NotImplementedError, match="tile_scan on the card"):
        ts.tile_scan(k, combine=torch.maximum)
    assert all(v == 0 for v in _build.launches().values())
