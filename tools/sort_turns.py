#!/usr/bin/env python3
"""Time the stable sort's register-rank kernels of one checkout of the
PyTorch/CUDA port on the card, so that two commits can be compared in
turns on the same card.

    python3 tools/sort_turns.py [--src DIR] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` runs (default
this checkout's); its kernels build into that checkout's ``build/``.  The
script times, with ``chip_smoke.py``'s harness (a CUDA graph of
back-to-back calls after an L2 flush, the median of three readings), at
tile 1024: K6a ``_mt_local`` (a 4-bit pass with the pack, at 2^20 and
2^24 keys), K7a ``radix_tile_sort`` (2^20 32-bit words) and K7b
``radix_tile_sort_packed`` (12-bit keys at 2^20 and at one tile, 17-bit
keys at 2^15), called with only the arguments every version of the port
takes.  It prints the card (name, power limit) and one JSON line.  Run
it on both trees on one card, a b b a, and compare each kernel's times.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this needs a card")
    from chip_smoke import device_timer
    from repro_torch.kernels import radix_sort as rs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    device_ms = device_timer(torch, dev)
    rng = np.random.RandomState(0)
    n, tile = 1 << 20, 1024
    keys = torch.as_tensor(rng.randint(0, 1 << 12, n).astype(np.int32),
                           device=dev)
    big = torch.as_tensor(rng.randint(0, 1 << 8, 1 << 24).astype(np.int32),
                          device=dev)
    keys17 = torch.as_tensor(rng.randint(0, 1 << 17, 1 << 15)
                             .astype(np.int32), device=dev)
    words = torch.as_tensor(rng.randint(0, 1 << 32, n, dtype=np.uint64)
                            .astype(np.uint32), device=dev)
    calls = {
        "K6a _mt_local 2^20, 4-bit pass 0 (pack)": lambda: rs._mt_local(
            keys, nt=n // tile, tile=tile, shift=20, bits=4, pack=True,
            idx_bits=20),
        "K6a _mt_local 2^24, 4-bit pass 0 (pack)": lambda: rs._mt_local(
            big, nt=(1 << 24) // tile, tile=tile, shift=24, bits=4,
            pack=True, idx_bits=24),
        "K7a radix_tile_sort 2^20 u32": lambda: rs.radix_tile_sort(
            words, tile=tile),
        "K7b radix_tile_sort_packed 2^20 12-bit": lambda:
            rs.radix_tile_sort_packed(keys, n=n, tile=tile, num_key_bits=12,
                                      idx_bits=20),
        "K7b radix_tile_sort_packed 1 tile, 12-bit": lambda:
            rs.radix_tile_sort_packed(keys[:tile], n=tile, tile=tile,
                                      num_key_bits=12, idx_bits=10),
        "K7b radix_tile_sort_packed 2^15 17-bit": lambda:
            rs.radix_tile_sort_packed(keys17, n=1 << 15, tile=tile,
                                      num_key_bits=17, idx_bits=15)}
    times = {name: sorted(device_ms(fn, cold=True) for _ in range(3))[1]
             for name, fn in calls.items()}
    out = {"label": args.label, "src": str(args.src), "card": card,
           "ms": times}
    print(card)
    print(json.dumps(out))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
