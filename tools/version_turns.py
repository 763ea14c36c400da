#!/usr/bin/env python3
"""Time, in turns on the card, each kernel of the PyTorch/CUDA port
against the earlier version or route it keeps beside it, at the paths'
shapes.

    python3 tools/version_turns.py [--out FILE]

Each comparison runs a b a b (K7b: a b three times), every call timed
with ``chip_smoke.py``'s harness (a CUDA graph of back-to-back calls after
an L2 flush, the median of three readings); a pair's number is the mean of
its readings (K7b: the median).  Cases:

* K1 (flash attention forward, bf16): v3 (tensor cores) against v2 (FMA)
  at the dense path's chunks (32/8 heads of 128, c=256 at 0 and 736, c=32
  and c=1 at 1792, Sk 2048) and llama4-scout's (40/8, c=256 at 736); v3
  unsplit; where the split rule splits, the fused launch against split
  partials + the standalone merge; v3 over forced split counts 1-16;
* K2 (flash decode, bf16, 32/8 heads of 128, B 8): v2 partials against
  v1's, and the fused launch against v2 partials + the combine, at S 2048
  (mean length 643 and every row full) and S 1100;
* K7b (``radix_tile_sort_packed``, tile 1024): v2 against v1 at 2^20
  12-bit keys, 2^15 17-bit keys and one tile, and v2 over CTA widths
  128-1024 at 1, 32 and 1024 tiles;
* K8 (``merge_level``): v2 against v1 at run 1024 over 2^20 words, run
  2^14, run 2^19 with the unpack, and the MoE argsort's four 8192-word
  levels;
* K5 (``histogram_offsets``): one thread-block cluster of 1-16 CTAs at the
  (1024 x 16) and (16384 x 16) histograms.

It prints the card (name, power limit) and one JSON line of every reading
(``--out`` writes it to a file too).  These were phases of
``chip_smoke.py``, which now times only each kernel's route.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this needs a card")
    from chip_smoke import _flip, device_timer
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import merge_sort as ms
    from repro_torch.kernels import radix_sort as rs
    from repro_torch.kernels import tile_scan as ts

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    device_ms = device_timer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.RandomState(0)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def turns(a, b, reps=2):
        """a b a b ... : each side's readings."""
        got = [device_ms(f, cold=True) for _ in range(reps) for f in (a, b)]
        return got[0::2], got[1::2]

    def mean(x):
        return sum(x) / len(x)

    out = {"card": card, "k1": {}, "k1_splits": {}, "k2": {}, "k7b": {},
           "k7b_threads": {}, "k8": {}, "k5_cluster": {}}

    # K1 -------------------------------------------------------------
    for Hq, c, off in ((32, 256, 736), (32, 256, 0), (32, 32, 1792),
                       (32, 1, 1792), (40, 256, 736)):
        q, k, v = randn(1, c, Hq, 128), randn(1, 2048, 8, 128), \
            randn(1, 2048, 8, 128)
        kw = dict(causal=True, q_offset=off)
        v3, v2 = turns(lambda: fa.flash_attention(q, k, v, **kw),
                       lambda: fa.flash_attention(q, k, v, tensor_cores=False,
                                                  **kw))
        row = dict(v3_ms=mean(v3), v2_ms=mean(v2), turns=[v3, v2],
                   unsplit_ms=device_ms(lambda: fa.flash_attention(
                       q, k, v, splits=1, **kw), cold=True))
        ns = fa.num_splits(1, c, Hq, 8, 2048, q_offset=off)
        if ns > 1:
            one, two = turns(
                lambda: fa.flash_attention(q, k, v, fused=True, **kw),
                lambda: fa.flash_attention(q, k, v, fused=False, **kw))
            row.update(splits=ns, fused_ms=mean(one), pair_ms=mean(two))
        out["k1"][f"{Hq}/8 c={c} off={off}"] = row
        out["k1_splits"][f"{Hq}/8 c={c} off={off}"] = {
            sp: device_ms(lambda: fa.flash_attention(q, k, v, splits=sp,
                                                     **kw), cold=True)
            for sp in (1, 2, 3, 4, 6, 9, 12, 16)}

    # K2 -------------------------------------------------------------
    main_lens = np.random.RandomState(0).randint(64, 1089, size=8)
    for S, lens in ((2048, main_lens), (2048, [2048] * 8),
                    (1100, np.minimum(main_lens, 1100))):
        q, kc, vc = randn(8, 32, 128), randn(8, S, 8, 128), \
            randn(8, S, 8, 128)
        lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        p2, p1 = turns(
            lambda: fd.decode_partials(q, kc, vc, lens),
            lambda: fd.decode_partials(q, kc, vc, lens, tensor_cores=False))
        fused, pair = turns(
            lambda: fd.flash_decode(q, kc, vc, lens),
            lambda: fd.combine(*fd.decode_partials(q, kc, vc, lens), bf))
        out["k2"][f"B=8 S={S} mean={float(lens.float().mean()):.0f}"] = dict(
            v2_partials_ms=mean(p2), v1_partials_ms=mean(p1),
            fused_ms=mean(fused), partials_combine_ms=mean(pair))

    # K7b ------------------------------------------------------------
    tile = 1024

    def ints(n, bits):
        return torch.as_tensor(rng.randint(0, 1 << bits, n).astype(np.int32),
                               device=dev)

    keys, keys17 = ints(1 << 20, 12), ints(1 << 15, 17)
    for what, k, bits in (("2^20 12-bit", keys, 12),
                          ("2^15 17-bit", keys17, 17),
                          ("one tile 12-bit", keys[:tile], 12)):
        n = k.numel()
        kw = dict(n=n, tile=tile, num_key_bits=bits,
                  idx_bits=max(1, (n - 1).bit_length()))
        a, b = turns(lambda: rs.radix_tile_sort_packed(k, **kw),
                     lambda: rs.radix_tile_sort_packed(k, v1=True, **kw),
                     reps=3)
        out["k7b"][what] = dict(v2_ms=sorted(a)[1], v1_ms=sorted(b)[1])
    for nt in (1, 32, 1024):
        n = nt * tile
        out["k7b_threads"][f"{nt} tiles"] = {
            th: sorted(device_ms(lambda: rs.radix_tile_sort_packed(
                keys[:n], n=n, tile=tile, num_key_bits=12,
                idx_bits=max(1, (n - 1).bit_length()), threads=th),
                cold=True) for _ in range(3))[1]
            for th in (128, 256, 512, 1024)}

    # K8 -------------------------------------------------------------
    def runs_of(words, run):
        srt = torch.sort(_flip(torch, words).reshape(-1, run), dim=1).values
        return _flip(torch, srt).view(torch.uint32).reshape(-1)

    words = torch.as_tensor(rng.randint(0, 1 << 32, 1 << 20, dtype=np.uint64)
                            .astype(np.uint32), device=dev)
    moe = ((torch.as_tensor(rng.randint(0, 16, 8192), device=dev) << 13)
           | torch.arange(8192, device=dev)).to(torch.int32).view(
               torch.uint32)
    for what, x, run, um, t8 in (
            ("2^20 run 1024", runs_of(words, 1024), 1024, None, tile),
            ("2^20 run 2^14", runs_of(words, 1 << 14), 1 << 14, None, tile),
            ("2^20 run 2^19 unpack", runs_of(words, 1 << 19), 1 << 19,
             (1 << 20) - 1, tile),
            *((f"MoE 8192 run {r}", runs_of(moe, r), r, None, 512)
              for r in (512, 1024, 2048, 4096))):
        a, b = turns(lambda: ms._merge_level(x, run=run, tile=t8,
                                             unpack_mask=um),
                     lambda: ms._merge_level(x, run=run, tile=t8,
                                             unpack_mask=um, v1=True))
        out["k8"][what] = dict(v2_ms=mean(a), v1_ms=mean(b))

    # K5 -------------------------------------------------------------
    for nt in (1024, 16384):
        hist = ints(nt * 16, 10).reshape(nt, 16)
        out["k5_cluster"][f"{nt} x 16"] = {
            cl: device_ms(lambda: ts._scan_add(hist, nt, 16, False,
                                               cluster=cl), cold=True)
            for cl in (1, 2, 4, 8, 16)}

    print(json.dumps(out), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
