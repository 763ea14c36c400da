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


# --------------------------------------------------------------------------
# K1 v3 on the card splits each 64-row tile of GQA-packed (query, q head)
# rows over key ranges and merges the fp32 partials in split order.  Its
# plain decomposition (``split_partials_plain`` + ``merge_plain``) is held
# here against the fp32 twin and the Pallas kernel in interpret mode, on
# the same numpy inputs, fp32, atol = rtol = 1e-5 (summation order only).

SPLIT_KV = 2
SPLIT_SK = 181            # ragged: not a multiple of the 64-key tile


@functools.lru_cache(maxsize=None)
def _causal_square(G):
    """SPLIT_SK queries over SPLIT_SK keys, causal, through the Pallas
    kernel (interpret mode, one block).  A chunk of c queries at offset P
    is rows P..P+c-1 of it: the reference kernel has no q_offset."""
    r = np.random.RandomState(40 + G)
    H = G * SPLIT_KV
    q = r.randn(1, SPLIT_SK, H, hd).astype(np.float32)
    k = r.randn(1, SPLIT_SK, SPLIT_KV, hd).astype(np.float32)
    v = r.randn(1, SPLIT_SK, SPLIT_KV, hd).astype(np.float32)
    ref = _jit(pallas_flash, *_j(q, k, v), causal=True, block_q=SPLIT_SK,
               block_k=SPLIT_SK, interpret=True)
    return q, k, v, np.asarray(ref)


@pytest.mark.parametrize("G", [1, 4, 5])
@pytest.mark.parametrize("c", [1, 17, 32, 64])
@pytest.mark.parametrize("where", ["start", "96", "end"])
def test_split_decomposition_matches_twin_and_pallas(G, c, where):
    """Every split count, the rule's among them (empty splits past the
    tiles' windows included), gives the twin's and the Pallas kernel's
    output; every (row, split) without a valid key is m = -1e30, l = 0,
    acc = 0."""
    q, k, v, ref = _causal_square(G)
    off = {"start": 0, "96": 96, "end": SPLIT_SK - c}[where]
    qc = q[:, off:off + c]
    plain = tfa.flash_attention_plain(*_t(qc, k, v), causal=True,
                                      q_offset=off)
    np.testing.assert_allclose(plain.numpy(), ref[:, off:off + c], **TOL)
    rule = tfa.num_splits(1, c, G * SPLIT_KV, SPLIT_KV, SPLIT_SK,
                          q_offset=off)
    for nsplit in sorted({rule, 1, 2, 3, 5}):
        m, l, acc = tfa.split_partials_plain(*_t(qc, k, v), nsplit,
                                             causal=True, q_offset=off)
        out = tfa.merge_plain(m, l, acc, torch.float32)
        np.testing.assert_allclose(out.numpy(), plain.numpy(), **TOL)
        np.testing.assert_allclose(out.numpy(), ref[:, off:off + c], **TOL)
        lo, hi = tfa.split_key_ranges(c, G, SPLIT_SK, nsplit, q_offset=off)
        qpos = off + tfa.packed_rows(c, G)[:, 0]
        empty = torch.minimum(hi, qpos + 1) <= lo          # (nsplit, c·G)
        empty = empty.reshape(nsplit, 1, c, 1, G).expand(
            -1, 1, -1, SPLIT_KV, -1).reshape(nsplit, 1, c, G * SPLIT_KV)
        assert (m[empty] == tfa.NEG_INF).all()
        assert (l[empty] == 0).all() and (acc[empty] == 0).all()
        assert (l[~empty] > 0).all()


def test_split_wholly_past_the_causal_window():
    """G = 1, 64 queries at 96: the tile's keys stop at 160, 3 kv tiles;
    split 2 (keys 128..159) lies past the window of the rows at 96..127,
    which get weight 0 from it, and the merge is still the twin's."""
    q, k, v, ref = _causal_square(1)
    qc = q[:, 96:160]
    lo, hi = tfa.split_key_ranges(64, 1, SPLIT_SK, 3, q_offset=96)
    assert lo[:, 0].tolist() == [0, 64, 128] and hi[:, 0].tolist() == \
        [64, 128, 160]
    m, l, acc = tfa.split_partials_plain(*_t(qc, k, v), 3, causal=True,
                                         q_offset=96)
    assert (m[2, :, :32] == tfa.NEG_INF).all()
    assert (l[2, :, :32] == 0).all() and (acc[2, :, :32] == 0).all()
    assert (m[2, :, 32:] > tfa.NEG_INF).all()
    out = tfa.merge_plain(m, l, acc, torch.float32)
    np.testing.assert_allclose(out.numpy(), ref[:, 96:160], **TOL)


@pytest.mark.parametrize("G,c,off,Sk", [
    (4, 256, 736, 2048), (5, 256, 736, 2048), (4, 32, 1792, 2048),
    (4, 1, 1792, 2048), (4, 128, 1024, 2048), (5, 64, 736, 2048),
    (1, 17, 96, 181), (4, 64, 0, 2048), (1, 1, 2047, 2048)])
@pytest.mark.parametrize("nsplit", ["rule", 2, 5, 9, 16])
def test_live_splits_count_the_nonempty_splits(G, c, off, Sk, nsplit):
    """Each row tile's live split count (``live_splits``, which the fused
    kernel mirrors) is the number of splits ``split_key_ranges`` gives a
    key, and they come first: at the rule's split count for the main
    paths' chunks (32/8 and 40/8 heads) and at forced counts."""
    if nsplit == "rule":
        nsplit = tfa.num_splits(1, c, G * 8, 8, Sk, q_offset=off)
    live = tfa.live_splits(c, G, Sk, nsplit, q_offset=off)
    lo, hi = tfa.split_key_ranges(c, G, Sk, nsplit, q_offset=off)
    first = torch.arange(0, c * G, tfa.BLOCK_M)
    nonempty = lo[:, first] < hi[:, first]             # (nsplit, tiles)
    assert live.shape == first.shape
    assert (nonempty.sum(0) == live).all()
    assert (nonempty == (torch.arange(nsplit)[:, None] < live)).all()
    assert (live >= 1).all() and (live <= nsplit).all()


@pytest.mark.parametrize("G", [1, 4, 5])
@pytest.mark.parametrize("c,off,nsplit", [(64, 117, 2), (64, 96, 3),
                                          (48, 0, 5), (17, 164, 16)])
def test_fused_merge_gives_the_same_bits_whichever_split_arrives_last(
        G, c, off, nsplit):
    """The fused route's claim in plain form: for every row tile and kv
    head, the CTA that arrives last (in split order, reversed, or a seeded
    order) merges the live splits' partials in split order and gets
    ``merge_plain``'s bits over all the splits (the empty ones never read:
    they hold NaN here), leaving the counter at 0; the output is the
    Pallas kernel's within the fp32 tolerance."""
    q, k, v, ref = _causal_square(G)
    qc = q[:, off:off + c]
    m, l, acc = tfa.split_partials_plain(*_t(qc, k, v), nsplit, causal=True,
                                         q_offset=off)
    whole = tfa.merge_plain(m, l, acc, torch.float32)
    np.testing.assert_allclose(whole.numpy(), ref[:, off:off + c], **TOL)
    live = tfa.live_splits(c, G, SPLIT_SK, nsplit, q_offset=off)
    rows = tfa.packed_rows(c, G)
    rng = np.random.RandomState(c + nsplit)
    for t, n_live in enumerate(live.tolist()):
        R = rows[t * tfa.BLOCK_M:(t + 1) * tfa.BLOCK_M]
        for kvh in range(SPLIT_KV):
            i, head = R[:, 0], kvh * G + R[:, 1]
            tm, tl, ta = m[:, 0, i, head], l[:, 0, i, head], acc[:, 0, i, head]
            tm[n_live:], tl[n_live:], ta[n_live:] = (float("nan"),) * 3
            for order in (None, tuple(range(n_live))[::-1],
                          tuple(rng.permutation(n_live).tolist())):
                got, merger, counter = tfa.fused_merge_model(
                    tm, tl, ta, n_live, torch.float32, arrivals=order)
                assert torch.equal(got, whole[0, i, head])
                assert merger == (n_live - 1 if order is None else order[-1])
                assert counter == 0


@pytest.mark.parametrize("G", [1, 4, 5])
def test_merge_plain_matches_jax_combine(G):
    """The fixed-order merge == the JAX package's pairwise LSE combine
    (``combine_partials``) folded over the same partials."""
    q, k, v, _ = _causal_square(G)
    m, l, acc = tfa.split_partials_plain(*_t(q[:, 96:128], k, v), 3,
                                         causal=True, q_offset=96)
    mF, lF, aF = _j(m[0].numpy(), l[0].numpy(), acc[0].numpy())
    for s in range(1, 3):
        mF, lF, aF = combine_partials((mF, lF, aF), tuple(_j(
            m[s].numpy(), l[s].numpy(), acc[s].numpy())))
    _close(tfa.merge_plain(m, l, acc, torch.float32),
           aF / jnp.maximum(lF, 1e-30)[..., None])


@pytest.mark.parametrize("G", [1, 4, 5])
@pytest.mark.parametrize("Sq", [1, 17, 64, 77, 256])
def test_packed_rows_cover_every_pair_once(G, Sq):
    """Packed rows map onto (query, q head of the group) one to one,
    query-major: a 64-row tile holds consecutive queries, the last tile is
    ragged when G does not divide 64 or Sq·G is not a multiple of 64."""
    rows = tfa.packed_rows(Sq, G)
    assert rows.shape == (Sq * G, 2)
    pairs = {(int(i), int(g)) for i, g in rows}
    assert pairs == {(i, g) for i in range(Sq) for g in range(G)}
    assert (rows[:, 0] == torch.arange(Sq * G) // G).all()
    for t0 in range(0, Sq * G, tfa.BLOCK_M):
        qs = rows[t0:t0 + tfa.BLOCK_M, 0]
        assert (qs.diff() >= 0).all() and (qs.diff() <= 1).all()


@pytest.mark.parametrize("G,c,off,Sk", [
    (4, 256, 736, 2048), (5, 256, 736, 2048), (4, 32, 1792, 2048),
    (1, 17, 96, 181), (5, 64, 0, 1100), (4, 1, 2047, 2048)])
@pytest.mark.parametrize("nsplit", [1, 2, 9, 16])
def test_split_key_ranges_tile_each_window(G, c, off, Sk, nsplit):
    """For every packed row, the splits' key ranges are disjoint, in split
    order, and cover exactly the keys below its tile's bound (the tile's
    last query + 1, at most Sk), which holds the row's own window."""
    lo, hi = tfa.split_key_ranges(c, G, Sk, nsplit, q_offset=off)
    assert lo.shape == hi.shape == (nsplit, c * G)
    assert (lo[0] == 0).all() and (lo <= hi).all()
    assert (lo[1:] == hi[:-1]).all()
    qpos = off + tfa.packed_rows(c, G)[:, 0]
    tile_last = torch.tensor([
        int(qpos[min(r // tfa.BLOCK_M * tfa.BLOCK_M + tfa.BLOCK_M,
                     c * G) - 1]) for r in range(c * G)])
    assert (hi[-1] == torch.clamp(tile_last + 1, max=Sk)).all()
    assert (hi[-1] >= torch.clamp(qpos + 1, max=Sk)).all()


def test_split_rule_at_the_main_paths_shapes():
    """``num_splits`` from shapes alone: the engines' 256-token chunks of
    llama3-8b (32/8 heads) split in 2 (128 CTAs, two fit an SM), of
    llama4-scout (40/8) not at all (160 CTAs); a 32-token or 1-token chunk
    late in a 2048 cache splits 9 ways (29 kv tiles, 3 a split); a short
    window is never split."""
    cases = {(1, 256, 32, 8, 2048, 736): 2, (1, 256, 32, 8, 2048, 1792): 2,
             (1, 256, 40, 8, 2048, 736): 1, (1, 32, 32, 8, 2048, 1792): 9,
             (1, 1, 32, 8, 2048, 1792): 9, (1, 128, 32, 8, 2048, 1024): 4,
             (1, 64, 40, 8, 2048, 736): 4, (1, 256, 32, 8, 2048, 0): 1,
             (1, 64, 32, 8, 2048, 224): 1, (1, 32, 32, 8, 2048, 0): 1,
             (4, 2048, 32, 8, 2048, 0): 1, (1, 1, 8, 8, 2048, 2047): 10}
    for (B, Sq, H, KV, Sk, off), want in cases.items():
        got = tfa.num_splits(B, Sq, H, KV, Sk, q_offset=off)
        assert got == want, ((B, Sq, H, KV, Sk, off), got, want)
        ctas = B * KV * -(-Sq * (H // KV) // tfa.BLOCK_M)
        assert 1 <= got <= tfa.MAX_SPLITS
        assert got == 1 or ctas * got <= tfa.CTAS_PER_SM * tfa.NUM_SMS
    assert tfa.num_splits(1, 32, 32, 8, 2048, causal=False) == 10


def test_fused_merge_route_at_the_main_paths_shapes():
    """A split call merges in its own launch up to FUSED_UP_TO splits (the
    engines' 256-token llama3-8b chunks, 2 splits) and in a second launch
    above (short chunks late in the cache, 4 to 9 splits); an unsplit call
    has no merge."""
    assert not tfa.fused_merge(1)
    assert tfa.fused_merge(2) and tfa.FUSED_UP_TO == 2
    assert not tfa.fused_merge(4) and not tfa.fused_merge(9)
    for off in (224, 736, 1792):
        assert tfa.fused_merge(tfa.num_splits(1, 256, 32, 8, 2048,
                                              q_offset=off))
    for c, off in ((32, 1792), (64, 736), (128, 1024)):
        assert not tfa.fused_merge(tfa.num_splits(1, c, 32, 8, 2048,
                                                  q_offset=off))
    assert tfa.MAX_SPLITS <= tfa.MAX_FUSED_SPLITS


def test_route_by_dtype_and_head_dim():
    """v3 takes bf16 with head dims that are multiples of 16; fp32 (exact
    goldens) and other bf16 head dims stay on v2."""
    assert tfa.uses_tensor_cores(torch.bfloat16, 128)
    assert tfa.uses_tensor_cores(torch.bfloat16, 48)
    assert not tfa.uses_tensor_cores(torch.bfloat16, 72)
    assert not tfa.uses_tensor_cores(torch.float32, 128)


def test_merge_and_forced_routes_raise_off_the_card():
    """The merge launch and the forced routes refuse what is not on a CUDA
    device; no launch counts."""
    _build.reset_launches()
    m = torch.zeros((2, 1, 4, H), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.merge(m, m, torch.zeros((2, 1, 4, H, hd), device="meta"))
    q, k, v = (t.to("meta") for t in _t(*_qkv(1, 8, 8)))
    for kw in ({"tensor_cores": True}, {"tensor_cores": False},
               {"splits": 4}, {"splits": 4, "fused": True},
               {"splits": 2, "fused": False}):
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_attention(q, k, v, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.split_partials(q, k, v, 2)
    # on the CPU the two launches of a split are their plain twins
    q, k, v = _t(*_qkv(1, 8, 70, seed=9))
    parts = tfa.split_partials(q, k, v, 2, q_offset=62)
    for got, want in zip(parts, tfa.split_partials_plain(q, k, v, 2,
                                                         q_offset=62)):
        assert torch.equal(got, want)
    out = tfa.merge(*parts)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tfa.merge_plain(*parts, torch.bfloat16))
    for fused in (None, True, False):       # every route: the fp32 twin
        assert torch.equal(tfa.flash_attention(q, k, v, q_offset=62,
                                               splits=2, fused=fused),
                           tfa.flash_attention_plain(q, k, v, q_offset=62))
    assert set(_build.launches().values()) == {0}


# --------------------------------------------------------------------------
# K2 v2 on the card (bf16) reads each split once: warp w takes the 32-row
# sub-tiles SUB·(w + 4i) of the split, keeps an online softmax over them
# with the G query heads of a kv head as the rows of one tensor-core tile,
# and the 4 warps merge in order.  Its fp32 decomposition
# (``decode_partials_model``) is held here against the twin, the jnp
# decode path and the Pallas kernel in interpret mode, on the same numpy
# inputs, fp32, atol = rtol = 1e-5 (summation order only).

DECODE_KV = 2


@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("S,block_k", [(256, 128), (200, 128), (256, 256),
                                       (192, 48)])
def test_decode_partials_model_matches_twin_and_pallas(G, S, block_k):
    """Lengths 0 (the mean of V), 1, 127, 128, 129, S and one at random;
    S ragged against block_k (200), one split of two sub-tiles a warp
    (256), splits below a sub-tile a warp (48); splits past a length give
    (-1e30, 0, 0)."""
    r = np.random.RandomState(70 + G)
    H = G * DECODE_KV
    lens = np.array([0, 1, 127, 128, 129, S, r.randint(1, S + 1)], np.int32)
    B = lens.size
    q = r.randn(B, H, hd).astype(np.float32)
    kc = r.randn(B, S, DECODE_KV, hd).astype(np.float32)
    vc = r.randn(B, S, DECODE_KV, hd).astype(np.float32)
    got = tfd.decode_partials_model(*_t(q, kc, vc, lens), block_k=block_k)
    for g, w in zip(got, tfd.decode_partials_plain(*_t(q, kc, vc, lens),
                                                   block_k=block_k)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    _close(tfd.combine_plain(*got, torch.float32),
           _jit(ja.decode_attention, *_j(q, kc, vc, lens)))
    nk = tfd.num_splits(S, block_k)
    start = np.arange(nk) * block_k
    dead = (start[None, :] >= lens[:, None]) & (lens[:, None] > 0)
    dead = np.broadcast_to(dead[:, None, :], got[0].shape)
    assert (got[0].numpy()[dead] == -1e30).all()
    assert (got[1].numpy()[dead] == 0).all() and (got[2].numpy()[dead] == 0
                                                  ).all()
    if S % block_k:
        return                         # the Pallas kernel asserts S % bk
    jm, jl, jacc = _jit(decode_partials, *_j(q, kc, vc, lens),
                        block_k=block_k, interpret=True)
    for t, j in ((got[0], jm), (got[1], jl)):
        np.testing.assert_allclose(t.numpy()[~dead], np.asarray(j)[~dead],
                                   **TOL)
    np.testing.assert_allclose(got[2].numpy()[~dead],
                               np.asarray(jacc)[~dead], **TOL)


def test_decode_route_by_dtype_and_head_dim():
    """v2 takes bf16 with head dims that are multiples of 16; fp32 (exact
    goldens) and other bf16 head dims stay on v1.  Both take every group
    of GROUPS, 3 (minitron-4b's 24 / 8) included.  Off the card every route
    is refused, forced or not; on the CPU the twin runs whatever is
    forced; no launch counts."""
    assert tfd.uses_tensor_cores(torch.bfloat16, 128)
    assert tfd.uses_tensor_cores(torch.bfloat16, 48)
    assert not tfd.uses_tensor_cores(torch.bfloat16, 72)
    assert not tfd.uses_tensor_cores(torch.float32, 128)
    assert 3 in tfd.GROUPS and max(tfd.GROUPS) <= 16
    _build.reset_launches()
    q, k, v = _t(*_qkv(1, 8, 40, seed=11))
    lens = torch.tensor([29], dtype=torch.int32)
    meta = lambda t: t.to("meta")                    # noqa: E731
    for tc in (None, True, False):
        with pytest.raises(ValueError, match="CUDA"):
            tfd.decode_partials(meta(q[:, 0]), meta(k), meta(v), meta(lens),
                                tensor_cores=tc)
        for got, want in zip(
                tfd.decode_partials(q[:, 0], k, v, lens, tensor_cores=tc),
                tfd.decode_partials_plain(q[:, 0], k, v, lens)):
            assert torch.equal(got, want)
    assert set(_build.launches().values()) == {0}


# --------------------------------------------------------------------------
# On the card, bf16 decode is one launch: the CTA that finishes last for a
# (batch row, kv head) merges the splits with the routine the standalone
# combine runs (max, then a fold in split order: ``combine_model``).

def test_fused_decode_takes_the_twin_on_cpu_and_raises_elsewhere():
    """flash_decode on the fused route (bf16, head dim 16) and on v1
    (fp32): the plain twin for CPU tensors, bit for bit; refused on a meta
    tensor; no launch counts either way."""
    _build.reset_launches()
    q, k, v = _t(*_qkv(2, 1, 40, seed=13))
    lens = torch.tensor([29, 0], dtype=torch.int32)
    for dtype in (torch.bfloat16, torch.float32):
        qd, kd, vd = (t.to(dtype) for t in (q[:, 0], k, v))
        got = tfd.flash_decode(qd, kd, vd, lens)
        assert got.dtype == dtype
        assert torch.equal(got, tfd.flash_decode_plain(qd, kd, vd, lens))
        meta = lambda t: t.to("meta")                # noqa: E731
        with pytest.raises(ValueError, match="CUDA"):
            tfd.flash_decode(meta(qd), meta(kd), meta(vd), meta(lens))
    assert tfd.uses_tensor_cores(torch.bfloat16, hd)
    assert set(_build.launches().values()) == {0}


@pytest.mark.parametrize("G", [4, 5])
@pytest.mark.parametrize("S,block_k", [(256, 32), (200, 16)])
def test_split_order_merge_matches_jax_combine(G, S, block_k):
    """The merge of both routes (max, then the splits folded in order)
    equals the JAX package's ``combine_partials`` folded over the same
    partials, and the twin's ``combine_plain``, with lengths 0, 1, 127,
    128, 129 and S (splits past a length merge with weight 0); 8 and 13
    splits."""
    r = np.random.RandomState(90 + G)
    H = G * DECODE_KV
    lens = np.array([0, 1, 127, 128, 129, S], np.int32)
    q = r.randn(lens.size, H, hd).astype(np.float32)
    kc = r.randn(lens.size, S, DECODE_KV, hd).astype(np.float32)
    vc = r.randn(lens.size, S, DECODE_KV, hd).astype(np.float32)
    m, l, acc = tfd.decode_partials_plain(*_t(q, kc, vc, lens),
                                          block_k=block_k)
    nk = tfd.num_splits(S, block_k)
    mF, lF, aF = _j(m[..., 0].numpy(), l[..., 0].numpy(),
                    acc[..., 0, :].numpy())
    for s in range(1, nk):
        mF, lF, aF = combine_partials((mF, lF, aF), tuple(_j(
            m[..., s].numpy(), l[..., s].numpy(), acc[..., s, :].numpy())))
    got = tfd.combine_model(m, l, acc, torch.float32)
    _close(got, aF / jnp.maximum(lF, 1e-30)[..., None])
    np.testing.assert_allclose(
        got.numpy(), tfd.combine_plain(m, l, acc, torch.float32).numpy(),
        **TOL)
    _close(got, _jit(ja.decode_attention, *_j(q, kc, vc, lens)))
