#!/usr/bin/env python3
"""Time K1 (flash attention forward) of one checkout of the PyTorch/CUDA
port on the card and hash its outputs, so that two commits can be compared
in turns on the same card.

    python3 tools/k1_turns.py [--src DIR] [--label NAME] [--out FILE]

``--src`` is the ``src`` directory whose ``repro_torch`` runs (default
this checkout's); its kernels build into that checkout's ``build/``.  At
the shapes every version of the port takes (one head dim for q, k and v)
the script runs ``flash_attention`` through its wrapper on seeded inputs:
bf16 (the tensor-core kernel, under its split rule) at the dense path's
chunks (32/8 heads: c=256 at 736, c=32 at 1792, c=1 at 1792, c=256 at 0),
llama4-scout's (40/8, c=256 at 736) and head dim 64, and fp32 (the FMA
kernel) at c=256 at 736.  It times each with ``chip_smoke.py``'s harness
(a CUDA graph of back-to-back calls after an L2 flush, the median of
three readings) and prints the card (name, power limit) and one JSON line
with each case's ms and the sha256 of its output bytes.  Run it on both
trees on one card, a b b a: equal hashes are bit-identical outputs.
"""

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, dtype name, B, c, q_offset, Sk, H, KV, head dim)
CASES = (
    ("c=256 off=736 32/8 hd 128", "bfloat16", 1, 256, 736, 2048, 32, 8, 128),
    ("c=32 off=1792 32/8 hd 128", "bfloat16", 1, 32, 1792, 2048, 32, 8, 128),
    ("c=1 off=1792 32/8 hd 128", "bfloat16", 1, 1, 1792, 2048, 32, 8, 128),
    ("c=256 off=0 32/8 hd 128", "bfloat16", 1, 256, 0, 2048, 32, 8, 128),
    ("c=256 off=736 40/8 hd 128", "bfloat16", 1, 256, 736, 2048, 40, 8, 128),
    ("c=256 off=736 32/8 hd 64", "bfloat16", 1, 256, 736, 2048, 32, 8, 64),
    ("c=256 off=736 32/8 hd 128 fp32", "float32", 1, 256, 736, 2048, 32, 8,
     128),
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this needs a card")
    from chip_smoke import device_timer
    from repro_torch.kernels import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    device_ms = device_timer(torch, dev)
    times, hashes = {}, {}
    for label, dt, B, c, off, Sk, H, KV, hd in CASES:
        gen = torch.Generator(device=dev).manual_seed(len(times))
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((B, c, H, hd), (B, Sk, KV, hd),
                                 (B, Sk, KV, hd)))

        def call():
            return fa.flash_attention(q, k, v, causal=True, q_offset=off)
        out = call()
        torch.cuda.synchronize()
        hashes[label] = hashlib.sha256(
            out.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]
        times[label] = sorted(device_ms(call, cold=True)
                              for _ in range(3))[1]
    out = {"label": args.label, "src": str(args.src), "card": card,
           "ms": times, "sha256": hashes}
    print(card)
    print(json.dumps(out))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
