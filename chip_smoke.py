#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out FILE]

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda``), torch built for CUDA and numpy.  Phases:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   TF32 off for matmuls and convolutions;
1. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once);
2. the stable sort's kernels against their plain twins at the sort path's
   shapes, bit for bit (K5 ``tile_scan_add``, K6a ``radix_mt_local``, K6b
   ``radix_mt_scatter``, K7a ``radix_tile_sort``, K7b
   ``radix_tile_sort_packed``, K8 ``merge_level``), each timed beside its
   twin and a per-row ``torch.sort`` / ``torch.cumsum``; K5 (one cluster
   launch) also at seven histogram shapes under its rule and forced
   clusters, and as a 1-D scan both ways (misaligned too); K7a (8-bit
   digits in registers) at tiles 1 to 8192 over every bit range and digit
   width and on equal, sorted and reverse-sorted words; both bit-identical
   across two launches, their registers, spills, shared memory and CTAs an
   SM printed; K8 (v2: blocks of its own size, a co-rank search a warp a
   diagonal, W words a thread merged in registers) also at run 2^14, on
   all-equal, sorted, reversed and sentinel-padded runs and the four
   8192-word levels of the MoE argsort, v1 (the first design) on the same
   words, two launches bit-identical, v2's registers, spills and CTAs an
   SM printed, and v2 timed at runs 1024, 2^14, 2^19 (with the unpack) and
   the four MoE levels; K6a and K6b (the keys ranked in registers;
   warp-striped words placed by one search and a forward walk) pass by
   pass through case (a) (3 passes, the last with the unpack), the same on
   all-equal, one-digit, sorted, reversed and sentinel-padded keys, case
   (c)'s 2^24 keys (2 passes) and tile 8192 at radix 256, each equal to
   its twin and to a second launch, the passes' order to
   ``torch.argsort(stable=True)``; their registers, spills and CTAs an SM
   printed; each timed at the first and last pass of cases (a) and (c),
   beside a copy of the same input; K7b (v2: the composite ranked in
   registers, ceil(bits / 8) passes of one compile-time width) at cases
   (d), (e) and (g) and at every tile 2-8192 by 1-24 key bits, packed and
   unpacked, ragged, at 2 and 132 tiles, and on equal, sorted, reversed
   and 7-valued keys, equal to its twin, to v1 and to a second launch, at
   tile 1024 under every CTA width built too; its registers, spills and
   CTA width checked against ``k7b_shape`` and ``k7b_digits`` (the path's
   instances within 64 registers, no spills); v2 timed at cases (d), (e)
   and (g) (the turns against the versions and routes each kernel keeps
   are ``tools/version_turns.py``'s);
   2b.
   the same for
   the MoE dispatch K3 ``moe_dispatch`` (a decode step's 8 rows, a
   256-token chunk, ``Model.prefill``'s 8192 rows at d_model 5120; ragged,
   top-k 2, 256 experts; T·K of 1, 32, 33 and 512, deepseek-v2-lite's
   decode step (T 8, K 6, E 64), all-equal and tied ids, rows of 4- and
   2-byte words; one-tile inputs also through the PR 15 design; two
   launches bit-identical; 300 experts raise; its kernels' registers,
   spills, shared memory, CTAs an SM and one-tile grid, the grid equal to
   ``k3_grid``; the one-tile path timed in turns with the PR 15 design,
   beside the smallest launch the harness times) and the comparison
   sort's K9a
   ``bitonic_tile_sort``, K9b ``pack_keys`` and K9c ``unpack_order`` at
   2^20 keys, timed beside ``torch.argsort`` + ``index_select``, the
   per-row ``torch.sort`` and ``torch.bitwise_and`` (K9c); K9a (v2, the
   network in registers and warp shuffles) at every tile from 1 to 8192,
   on equal, sorted and
   reverse-sorted words and a misaligned input, two launches
   bit-identical, its registers, spills, shared memory and CTAs an SM
   printed;
3. the sort path: ``ops.stable_argsort`` / ``argsort`` / ``sort_u32`` on
   the card at users' sizes (12-bit ids at 2^20, deepseek-v2-lite's
   routing of 8 x 4096 tokens top-6 and its ragged twin, 8-bit keys at
   2^24, the merge strategy at 2^20 and at 17 bits, random u32 words, one
   tile, and adversarial 2^20 inputs; case (d) again with ``fused=False``
   and with ``method="bitonic"``, case (f) with ``method="bitonic"``):
   every order equals ``torch.argsort(stable=True)`` and the CPU twins',
   every case launches the expected kernels as often as the reference's
   ``SortSchedule`` says (plus K9b and K9c unfused); then each case timed
   against ``torch.argsort(stable=True)``, and cases (a)-(g) profiled
   (device time by kernel beside wall time);
4. hold K1, K2 and K4 against their plain versions at their paths' shapes
   and time kernel, plain version and, where one PyTorch call computes the
   same function, that call (``F.scaled_dot_product_attention`` for K1/K2;
   none exists for the K4 scans): K1 (bf16 through v3, the tensor-core
   kernel, with its split-KV merge: GQA groups 1, 3, 4, 5, 8 and 16, chunks
   of 1 to 256 at offsets 0 to 1792, forced split counts, two launches
   bit-identical; MLA's q/k head dim 192 with v head dim 128 in bf16 (v3)
   and fp32 (v2) at B 1 and 4, S 256 to 2048 and chunks of 32 and 256 at
   offsets 736 and 1792, through both merges;
   the fused merge (one launch whose last CTA a row tile merges, the
   route up to 2 splits) equal bit for bit to split partials + the
   standalone merge and to a second fused launch in every split case,
   forced ones included, the arrival counters back at 0; fp32 through v2;
   v3 (its route) timed at the dense chunks, groups 3, 8
   and 16 at c=256 / 736 and MLA's ``Model.prefill`` of 4 x 2048 at
   (192, 128) beside SDPA and the bound), K2 (bf16
   through v2, the tensor-core kernel, with the merge
   fused into its launch, at every GQA group of ``GROUPS`` and lengths 0,
   1, 127, 128, 129, S and ragged: the fused launch equal to v2 partials +
   the standalone combine, each row equal to a B = 1 call and two launches
   bit-identical, bit for bit, all within 2e-2 of the fp32 twin; fp32 and
   forced bf16 through v1, with a zero-length row; the fused launch and
   the combine timed; both kernels' registers, spills, shared memory and
   CTAs an SM printed), the cross-attention paths' instances (K1
   non-causal at whisper's encoder, Sq = Sk = 1500 at 16/16 heads of 64,
   and at the cross chunks against 1500 and vision's 1601 keys, 32/8 of
   128, under the rule and forced splits, the fused merge equal to
   partials + merge bit for bit; K2 v2 at group 1 over 1500 and 32/8 over
   1601 with every row full and ragged; each within 2e-2 of its fp32
   twin, bit-identical across launches, timed beside its twin, SDPA and
   the bound), K4 ``logspace`` (mLSTM carry, with extreme gates) and K4
   ``affine`` (Mamba);
5. the dense path: llama3-8b at full width and full depth (32 layers,
   bf16, seeded random weights) serves 16 requests through
   ``ContinuousEngine`` and 4 through the sync ``Engine``; every attention
   call must have launched a kernel (launch counters = layers x chunks /
   decode steps; bf16 decode is one launch, so the standalone combine 0;
   a split prefill chunk is one launch up to 2 splits, the merge fused,
   else two, and both kinds occur); then the policy layer on the same
   model, each run's K1 and K2 launches held to layers x chunks / steps:
   (a) the sync ``Engine`` with ``admission="simulate"`` at 2 lanes over
   prompts of 300, 290, 280, 1000, 900, 64, 64, 64 (its batch sizes equal
   ``AdmissionSimulator.choose`` replayed on the host: 2 first; host ms a
   choose), (b) a ``replay`` of 8 requests through ``ContinuousEngine``
   under a ``SlotDeathInjector`` of 3 deaths (one naming no lane): every
   rid once, requeues == lanes killed, pages, cap and slots freed (bf16
   re-served tokens against the calm run's printed, not gated), (c)
   SIGTERM after the first step: the engine drains its slots, ``handoff``
   moves the queue to a fresh engine, every rid served once, (d)
   ``audit_pytree`` over the 16 GB of bf16 weights on the card (ms,
   blocks), then a NaN planted at a seeded position: ``all_finite`` names
   its block with ``BlockStats`` equal to the host's ``by_blocks``;
6. fp32 checks at full width, 2 layers: the card's logits against the CPU
   plain path on the same weights, and continuous-batching tokens against
   one-at-a-time tokens; the fp32 engine's decode launches K2 v1's
   partials and the standalone combine once each a layer a step; the
   simulated admission at 2 lanes, a slot-death ``replay`` and a drain +
   ``handoff`` of the same requests each give the one-at-a-time tokens
   exactly; then ``schedule_join`` and ``adaptive(132).schedule`` of an
   int64 ``torch.sum`` over the leaves of a 2^24-element CUDA tensor equal
   the whole sum, and ``work_loop`` with a CUDA state and a device
   ``should_stop`` stops at the CPU's grant;
7. the SSM path: xlstm-1.3b at full width and depth (48 blocks, bf16,
   ``scan_impl="pallas"``): ``Model.prefill`` of 4 x 2048 tokens (K4 once
   per mLSTM layer) and 32 decode steps, then 8 requests through
   ``ContinuousEngine`` with O(1) state slots; profiles of one decode step
   and of a 1 x 512 prefill;
8. fp32 checks at xlstm's full width, one period (8 blocks): card logits
   against the CPU plain path, pallas == lax tokens, batched ==
   one-at-a-time tokens, and the entropy-gated stream an exact prefix;
9. the Mamba layer path: one Mamba mixer at jamba-1.5-large's width
   (d_model 8192) over 512 tokens, ``scan_impl="pallas"`` (K4 affine once
   per chunk) against ``"lax"``;
10. the MoE path: llama4-scout-17b-a16e at full width and 12 of its 48
   layers (bf16, seeded random weights, ``moe_strategy="sort"``,
   ``moe_sort_fn="pallas"``): 16 requests through ``ContinuousEngine``
   and 4 through ``Engine``, K3 launched by every MoE layer of every
   prefill chunk and decode step (one launch each), K2 one launch a layer
   a decode step; the sync Engine's requests routed by
   ``torch.argsort`` give identical tokens, and a second continuous run
   holds every K3 call bit for bit against argsort + gathers on the same
   inputs (the continuous schedule follows wall-clock telemetry, so two
   runs need not batch alike); ``Model.prefill`` of 4 x 2048
   routed by the bitonic unfused ``argsort`` (K9b, K9a, K8, K9c) gives
   K3's logits bit for bit; profiles of a decode step and a prefill chunk;
11. fp32 checks at the MoE path's full width, 1 layer: card logits
   against the CPU plain path, batched == one-at-a-time tokens;
12. the MLA path: deepseek-v2-lite-16b at full width and depth (27
   layers: one dense prefix layer, 26 MoE layers of 64 experts top-6 + 2
   shared; bf16, seeded random weights, ``moe_strategy="sort"``, K3
   routing): 16 requests through ``ContinuousEngine`` and 4 through
   ``Engine`` (MLA absorbed against the latent cache: K3 once a MoE layer
   a chunk and a decode step, K1 and K2 never), ``Model.prefill`` of 4 x
   2048 (K1 at (192, 128) once a layer, K3 once a MoE layer), profiles
   of a decode step and a 256-token chunk;
13. fp32 checks at deepseek's full width, 2 layers (the prefix layer and
   one MoE layer), as phase 11;
14. the dense configs: yi-9b, chatglm3-6b and minitron-4b at full width
   and depth in bf16, 8 requests each through ``ContinuousEngine`` (K1
   once a layer a chunk, K2 once a layer a step), then minitron's fp32
   checks at 2 layers;
15. the encoder-decoder path: whisper-medium at full width and depth
   (24 encoder + 24 decoder layers, 16/16 heads of 64, LayerNorm, GELU;
   bf16, seeded random weights): ``Model.prefill`` of 4 x 1024 decoder
   tokens over frames of 4 x 1500 x 1024 (K1 once an encoder, self and
   cross layer), the same through ``ChunkedPrefill.run(batch=...)`` (48 K1
   a chunk after the encoder's 24), its logits against the full
   prefill's within 2e-2 (relative), 32 decode steps (48 K2 a step, the
   cross rows at 1500), the profile of one decode step; then fp32 at 2 +
   2 layers: card logits against the CPU plain path within 1e-3, chunked
   == full prefill;
16. the image cross-attention path: llama-3.2-vision-11b at full width
   and depth (40 layers, 8 with cross-attention over 1601 image
   embeddings, 32/8 heads of 128) the same way with image embeddings of 4
   x 1601 x 4096 (48 K1 a chunk, 48 K2 a step), the profile of one
   256-token chunk; fp32 at one period of 5 layers;
17. the kernels line (K1's MLA and non-causal instances and K2's group-1
   instance in entries of their own), then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failed phase exits non-zero before the last line is printed.  Details
of every case go to ``--out`` (default ``build/chip_smoke.json``).
"""

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# bf16 outputs are rounded once: half an ulp is <= 1/64 for |o| < 8, and
# unit-normal V keeps attention outputs far below 8; fp32 differs only in
# summation order
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
LOGIT_TOL = 1e-3          # fp32 card logits vs the CPU plain path
NEAR_TIE = 1e-3           # top-2 logit gap below which a token flip is a tie
# K4 vs its plain twin, fp32: max |kernel - twin| / max |twin| per leaf.
# Both run the same sequential fold with each product and sum rounded on
# its own; only expf may differ from torch.exp
K4_TOL = 1e-5
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12


T_START = time.perf_counter()


def say(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - T_START:.0f}s] {msg}",
          flush=True)


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def free_card(torch) -> None:
    """Return a phase's device memory before the next phase allocates: an
    engine holds its model's parameters in a reference cycle (its cap's
    threshold callback is a bound method), which only the cycle collector
    frees."""
    gc.collect()
    torch.cuda.empty_cache()


def device_timer(torch, dev):
    """``device_ms(fn, cold)``: the device ms of one call of ``fn`` from a
    CUDA graph of back-to-back calls, so host launch overhead is not in the
    number (the median of three replays).  ``cold``: each call after an L2
    flush, whose own graph's time is subtracted (K/V-reading kernels: the
    serving path reads the cache cold); else warm (the combine: its
    partials were just written)."""
    flush_buf = torch.empty(64 << 20, dtype=torch.float32, device=dev)

    def graph_ms(body, iters):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            for _ in range(iters):
                body()
        g.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            g.replay()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        del g
        return sorted(times)[1]

    def device_ms(fn, cold):
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        iters = int(min(200, max(5, 20.0 / max(s.elapsed_time(e), 1e-3))))
        if not cold:
            return graph_ms(fn, iters) / iters
        flush = flush_buf.zero_
        both = graph_ms(lambda: (flush(), fn()), iters)
        alone = graph_ms(flush, iters)
        return max(both - alone, 0.0) / iters

    return device_ms


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "chip_smoke.json")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} is missing: run from a checkout")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------- 0. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0 = {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels import tile_scan as ts

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    say(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {src}: {line.strip()}")
    k1_attrs = fa.kernel_attributes()
    for kname, a in k1_attrs.items():
        say(f"  K1 {kname}: {a['registers']} registers, {a['spill_bytes']} "
            f"spill bytes, {a['static_smem'] + a['dynamic_smem']} bytes of "
            f"shared memory, {a['ctas_per_sm']} CTAs an SM")

    k2_attrs = fd.kernel_attributes()
    for kname, a in k2_attrs.items():
        say(f"  K2 {kname}: {a['registers']} registers, {a['spill_bytes']} "
            f"spill bytes, {a['static_smem'] + a['dynamic_smem']} bytes of "
            f"shared memory, {a['ctas_per_sm']} CTAs an SM")

    report = {"card": card, "cases": [], "timings": {},
              "k1_kernel_attributes": k1_attrs,
              "k2_kernel_attributes": k2_attrs}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    H, KV, hd = 32, 8, 128

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    device_ms = device_timer(torch, dev)

    # ------------------------------------ 2. the sort's kernels vs their twins
    sort_rows, sort_errs = sort_kernel_rows(np, torch, dev, args.seed,
                                            device_ms, card, report)

    # ------------------------------- 2b. K3 and K9a/b/c vs their plain twins
    moe_rows, moe_errs = moe_kernel_rows(np, torch, dev, args.seed,
                                         device_ms, card, report)

    # ------------------------------------------------------ 3. the sort path
    sort_launches = sort_path(np, torch, dev, args.seed, card, report)

    # ------------------------------------ 4. K1, K2, K4 vs their plain twins

    worst = {}               # kernel → {dtype: max abs err}

    fused_same = []          # K1 split cases: fused == two launches

    def k1_fused_check(q, k, v, off, ns, out, causal=True, **case):
        """At every split count the fused launch (the tile's last CTA
        merges) equals the two launches (split partials + the standalone
        merge), a second fused launch and the wrapper's own route, bit for
        bit."""
        if ns < 2:
            return
        pair = fa.merge(*fa.split_partials(q, k, v, ns, causal=causal,
                                           q_offset=off))
        fused = [fa.flash_attention(q, k, v, causal=causal, q_offset=off,
                                    splits=ns, fused=True) for _ in range(2)]
        torch.cuda.synchronize()
        fused_same.append(bool(torch.equal(out, pair) and all(
            torch.equal(f, pair) for f in fused)))
        check(fused_same[-1], f"K1 fused split merge {case} splits={ns}: "
              f"not merge(split_partials) or not repeatable bit for bit")

    def k1_bf16_checks():
        """v3 beyond llama3-8b's head layout: GQA group 1 (8/8 heads) and
        5 (40/8, llama4-scout's) at every chunk, offset and Sk of the
        group-4 cases, forced split counts (1 to past the kv tiles, so
        empty splits and splits past a row's window), the merge launch
        against its twin on the same partials, and two launches
        bit-identical."""
        bf = torch.bfloat16
        for Hq in (8, 40):
            for Sk in (2048, 1100):
                k = randn(1, Sk, KV, hd, dtype=bf)
                v = randn(1, Sk, KV, hd, dtype=bf)
                for c in (1, 17, 32, 64, 256):
                    q = randn(1, c, Hq, hd, dtype=bf)
                    for off in (0, 96, 736, 1792):
                        out = fa.flash_attention(q, k, v, causal=True,
                                                 q_offset=off)
                        ref = fa.flash_attention_plain(
                            q.float(), k.float(), v.float(), causal=True,
                            q_offset=off)
                        torch.cuda.synchronize()
                        ns = fa.num_splits(1, c, Hq, KV, Sk, q_offset=off)
                        record("flash_attention_fwd", bf, err(out, ref),
                               c=c, q_offset=off, Sk=Sk, H=Hq, splits=ns)
                        k1_fused_check(q, k, v, off, ns, out, c=c, H=Hq,
                                       q_offset=off, Sk=Sk)
        for Hq, c, off, Sk in ((8, 1, 1792, 2048), (8, 17, 96, 2048),
                               (8, 64, 736, 2048), (8, 256, 0, 1100),
                               (40, 1, 96, 1100), (40, 17, 1792, 2048),
                               (40, 64, 96, 1100), (40, 256, 1792, 2048)):
            q = randn(1, c, Hq, hd, dtype=bf)
            k = randn(1, Sk, KV, hd, dtype=bf)
            v = randn(1, Sk, KV, hd, dtype=bf)
            ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                           causal=True, q_offset=off)
            for sp in (None, 1, 2, 5, 16, 40):
                out = fa.flash_attention(q, k, v, causal=True, q_offset=off,
                                         splits=sp)
                torch.cuda.synchronize()
                record("flash_attention_fwd", bf, err(out, ref), c=c,
                       q_offset=off, Sk=Sk, H=Hq, splits=sp or "rule")
                k1_fused_check(q, k, v, off, sp or fa.num_splits(
                    1, c, Hq, KV, Sk, q_offset=off), out, c=c, H=Hq,
                    q_offset=off, Sk=Sk)
        k1_same = []
        for Hq, c, off in ((32, 256, 736), (32, 32, 1792), (40, 256, 736),
                           (40, 64, 1792), (32, 1, 1792)):
            q = randn(1, c, Hq, hd, dtype=bf)
            k = randn(1, 2048, KV, hd, dtype=bf)
            v = randn(1, 2048, KV, hd, dtype=bf)
            ns = fa.num_splits(1, c, Hq, KV, 2048, q_offset=off)
            a = fa.flash_attention(q, k, v, causal=True, q_offset=off)
            b = fa.flash_attention(q, k, v, causal=True, q_offset=off)
            k1_same.append(bool(torch.equal(a, b)))
            check(k1_same[-1], f"K1 v3 H={Hq} c={c} q_offset={off}: two "
                  f"launches on the same inputs differ")
            if ns > 1:
                parts = fa.split_partials(q, k, v, ns, causal=True,
                                          q_offset=off)
                got = fa.merge(*parts)
                torch.cuda.synchronize()
                record("flash_attention_merge", bf, err(
                    got, fa.merge_plain(*parts, torch.float32)), c=c,
                    q_offset=off, Sk=2048, H=Hq, splits=ns)
                check(torch.equal(got, a), "K1: merge(split_partials) is "
                      "not the wrapper's output")
        say(f"K1 v3: two launches bit-identical in {sum(k1_same)} of "
            f"{len(k1_same)} cases (split and unsplit, G 4 and 5)")
        report["k1_bit_identical"] = k1_same
        counters = fd._arrival_counters[torch.cuda.current_device()]
        check(int(counters.count_nonzero()) == 0, "K1 fused: arrival "
              "counters left non-zero after the split checks")
        say(f"K1 v3 fused split merge: one launch equal to split partials "
            f"+ the standalone merge, to a second launch and to the rule's "
            f"route, bit for bit, in {sum(fused_same)} of {len(fused_same)} "
            f"split cases (G 1, 4, 5; rule and forced 2, 5, 16, 40 splits); "
            f"arrival counters back at 0")
        report["k1_fused_bit_identical"] = fused_same

    def record(kernel, dtype, e, **case):
        tol = TOL[str(dtype).split(".")[-1]]
        name = str(dtype).split(".")[-1]
        report["cases"].append(dict(kernel=kernel, dtype=name,
                                    max_abs_err=e, tol=tol, **case))
        w = worst.setdefault(kernel, {})
        w[name] = max(w.get(name, 0.0), e)
        check(math.isfinite(e) and e <= tol,
              f"{kernel} {name} {case}: max abs err {e:.3g} > tol {tol}")

    def k2_v2_record(got, want, **case):
        """K2 v2's partials against the fp32 twin's.  m and l are fp32
        arithmetic, as in v1: m (absolute) and l (relative) at the fp32
        tolerance.  v2 rounds P to bf16 before P·V (as K1 v3 does), and
        only acc sees it: acc is held normalized, as the split's own output
        acc / l, at the bf16 tolerance.  A split with l = 0 must be
        (-1e30, 0, 0) exactly."""
        (m, l, acc), (rm, rl, racc) = got, want
        live = rl > 0
        e_ml = max(err(m, rm), float(((l - rl).abs() / rl.clamp(min=1.0)
                                      ).max()))
        e_acc = err(acc[live] / l[live, None], racc[live] / rl[live, None])
        dead = ~live
        if bool(dead.any()):
            exact = bool((m[dead] == rm[dead]).all() and (l[dead] == 0).all()
                         and (acc[dead] == 0).all())
            e_ml = e_ml if exact else float("inf")
        record("flash_decode_partials", torch.float32, e_ml, version="v2",
               measure="m absolute, l relative", **case)
        record("flash_decode_partials", torch.bfloat16, e_acc, version="v2",
               measure="normalized acc / l", **case)

    def k2_v2_checks():
        """v2 (bf16, tensor cores) at every GQA group of GROUPS (KV = 8),
        lengths 0, 1, 127, 128, 129, S and ragged, S a multiple of block_k
        and not; the zero-length row is the mean of V; each row's output
        equals a B = 1 call's bit for bit; two launches of each kernel are
        bit-identical."""
        bf = torch.bfloat16
        same = []
        for G in fd.GROUPS:
            Hq = KV * G
            for S in (2048, 1100):
                lens = torch.tensor([0, 1, 127, 128, 129, S] + torch.randint(
                    1, S + 1, (2,), generator=gen, device=dev).tolist(),
                    dtype=torch.int32, device=dev)
                B = lens.numel()
                q = randn(B, Hq, hd, dtype=bf)
                kc = randn(B, S, KV, hd, dtype=bf)
                vc = randn(B, S, KV, hd, dtype=bf)
                parts = fd.decode_partials(q, kc, vc, lens)
                out = fd.combine(*parts, bf)
                fused = fd.flash_decode(q, kc, vc, lens)
                ref = fd.flash_decode_plain(q.float(), kc.float(),
                                            vc.float(), lens)
                torch.cuda.synchronize()
                k2_v2_record(parts, fd.decode_partials_plain(q, kc, vc, lens),
                             B=B, S=S, H=Hq, lengths=lens.tolist())
                record("flash_decode (partials+combine)", bf, err(out, ref),
                       B=B, S=S, H=Hq, version="v2", lengths=lens.tolist())
                record("flash_decode (fused)", bf, err(fused, ref), B=B, S=S,
                       H=Hq, version="v2", lengths=lens.tolist())
                mean_v = vc[0].float().mean(0).repeat_interleave(G, 0)
                record("flash_decode zero-length row", bf,
                       err(fused[0], mean_v), B=B, S=S, H=Hq, version="v2")
                # the fused launch is v2 partials + the standalone combine
                fused_ok = torch.equal(fused, out)
                rows_ok = all(torch.equal(fused[i:i + 1], fd.flash_decode(
                    q[i:i + 1], kc[i:i + 1], vc[i:i + 1], lens[i:i + 1]))
                    for i in range(B))
                again = fd.decode_partials(q, kc, vc, lens)
                twice = all(torch.equal(a, b) for a, b in zip(parts, again))
                twice = twice and torch.equal(out, fd.combine(*again, bf))
                twice = twice and torch.equal(
                    fused, fd.flash_decode(q, kc, vc, lens))
                same.append(fused_ok and rows_ok and twice)
                check(fused_ok, f"K2 v2 G={G} S={S}: the fused launch "
                      f"differs from partials + combine")
                check(rows_ok, f"K2 v2 G={G} S={S}: a row's output differs "
                      f"between the B={B} call and a B=1 call")
                check(twice, f"K2 v2 G={G} S={S}: two launches differ")
        # v1 at G = 3 (fp32 and bf16 forced), the group this PR adds
        for dtype in (torch.float32, bf):
            q = randn(4, 3 * KV, hd, dtype=dtype)
            kc = randn(4, 1100, KV, hd, dtype=dtype)
            vc = randn(4, 1100, KV, hd, dtype=dtype)
            lens = torch.tensor([0, 1, 129, 1100], dtype=torch.int32,
                                device=dev)
            m, l, acc = fd.decode_partials(q, kc, vc, lens,
                                           tensor_cores=False)
            rm, rl, racc = fd.decode_partials_plain(q, kc, vc, lens)
            torch.cuda.synchronize()
            record("flash_decode_partials", torch.float32,
                   max(err(m, rm), err(l, rl), err(acc, racc)), B=4, S=1100,
                   H=3 * KV, input_dtype=str(dtype), version="v1")
        say(f"K2 v2: the fused launch equal to partials + combine, every "
            f"row equal to its B=1 call and two launches bit-identical in "
            f"{sum(same)} of {len(same)} cases (G "
            f"{', '.join(map(str, fd.GROUPS))}; S 2048 and 1100)")
        report["k2_bit_identical"] = same

    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        for Sk in (2048, 1100):
            k = randn(1, Sk, KV, hd, dtype=dtype)
            v = randn(1, Sk, KV, hd, dtype=dtype)
            for c in (1, 17, 32, 64, 256) if bf16 else (32, 64, 256):
                q = randn(1, c, H, hd, dtype=dtype)
                for off in (0, 96, 736, 1792) if bf16 else (0, 96, 1792):
                    out = fa.flash_attention(q, k, v, causal=True,
                                             q_offset=off)
                    ref = fa.flash_attention_plain(q.float(), k.float(),
                                                   v.float(), causal=True,
                                                   q_offset=off)
                    torch.cuda.synchronize()
                    ns = fa.num_splits(1, c, H, KV, Sk, q_offset=off) \
                        if bf16 else 1
                    record("flash_attention_fwd", dtype, err(out, ref),
                           c=c, q_offset=off, Sk=Sk, splits=ns)
                    k1_fused_check(q, k, v, off, ns, out, c=c, H=H,
                                   q_offset=off, Sk=Sk)
        for S in (2048, 1100):
            B = 8
            q = randn(B, H, hd, dtype=dtype)
            kc = randn(B, S, KV, hd, dtype=dtype)
            vc = randn(B, S, KV, hd, dtype=dtype)
            lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
            lens[0], lens[1] = 1, S
            lens = lens.to(torch.int32)
            # v1 (forced for bf16, the route for fp32): its partials are
            # fp32 whatever the input dtype, fp32 tolerance
            m, l, acc = fd.decode_partials(q, kc, vc, lens,
                                           tensor_cores=False)
            rm, rl, racc = fd.decode_partials_plain(q, kc, vc, lens)
            out = fd.combine(m, l, acc, dtype)
            ref = fd.combine_plain(m, l, acc, torch.float32)
            torch.cuda.synchronize()
            e_part = max(err(m, rm), err(l, rl), err(acc, racc))
            record("flash_decode_partials", torch.float32, e_part, B=B, S=S,
                   input_dtype=str(dtype), version="v1")
            if bf16:
                k2_v2_record(fd.decode_partials(q, kc, vc, lens),
                             (rm, rl, racc), B=B, S=S)
            record("flash_decode_combine", dtype, err(out, ref), B=B, S=S)
            e2e = err(fd.flash_decode(q, kc, vc, lens),
                      fd.flash_decode_plain(q.float(), kc.float(),
                                            vc.float(), lens))
            record("flash_decode (fused)" if bf16 else
                   "flash_decode (partials+combine)", dtype, e2e, B=B, S=S)
        # a row with no valid position: the reference's all-masked softmax
        # is uniform, the mean of V over the whole cache
        q = randn(4, H, hd, dtype=dtype)
        kc = randn(4, 2048, KV, hd, dtype=dtype)
        vc = randn(4, 2048, KV, hd, dtype=dtype)
        lens = torch.tensor([0, 1, 700, 2048], dtype=torch.int32, device=dev)
        out = fd.flash_decode(q, kc, vc, lens)
        ref = fd.flash_decode_plain(q.float(), kc.float(), vc.float(), lens)
        torch.cuda.synchronize()
        record("flash_decode zero-length row", dtype, err(out, ref), B=4,
               S=2048, lengths=lens.tolist())
        mean_v = vc[0].float().mean(0).repeat_interleave(H // KV, 0)
        check(err(ref[0], mean_v) <= 1e-4, "K2's twin: a zero-length row "
              "is not the mean of V")

    def k1_new_shapes_checks():
        """K1 at the slice's shapes.  MLA's (192, 128), 16/16 heads, scale
        1/sqrt(192): v3 (bf16) and v2 (fp32) at B 1 and 4, S 256, 512 and
        2048 from offset 0, and chunks of 32 and 256 at offsets 736 and
        1792 against Sk 2048, under the rule and forced splits through
        both merges (fused, and partials + the standalone merge); two
        launches bit-identical.  Then v3 at head dim 128 at the dense
        configs' GQA groups 3 (minitron 24/8), 8 (yi 32/4) and 16
        (chatglm 32/2: 4 queries a 64-row tile)."""
        bf = torch.bfloat16
        name = "flash_attention_fwd (192, 128)"
        same = []
        for dtype in (torch.bfloat16, torch.float32):
            for B, S in ((1, 256), (4, 256), (1, 512), (4, 512), (1, 2048),
                         (4, 2048)):
                q = randn(B, S, 16, 192, dtype=dtype)
                k = randn(B, S, 16, 192, dtype=dtype)
                v = randn(B, S, 16, 128, dtype=dtype)
                out = fa.flash_attention(q, k, v, causal=True)
                again = fa.flash_attention(q, k, v, causal=True)
                ref = fa.flash_attention_plain(q.float(), k.float(),
                                               v.float(), causal=True)
                torch.cuda.synchronize()
                record(name, dtype, err(out, ref), B=B, S=S, q_offset=0)
                same.append(bool(torch.equal(out, again)))
                del q, k, v, out, again, ref
            k = randn(1, 2048, 16, 192, dtype=dtype)
            v = randn(1, 2048, 16, 128, dtype=dtype)
            for c in (32, 256):
                q = randn(1, c, 16, 192, dtype=dtype)
                for off in (736, 1792):
                    ref = fa.flash_attention_plain(q.float(), k.float(),
                                                   v.float(), causal=True,
                                                   q_offset=off)
                    bf16 = dtype == torch.bfloat16
                    for sp in (None, 1, 2, 5, 16) if bf16 else (None,):
                        out = fa.flash_attention(q, k, v, causal=True,
                                                 q_offset=off, splits=sp)
                        again = fa.flash_attention(q, k, v, causal=True,
                                                   q_offset=off, splits=sp)
                        torch.cuda.synchronize()
                        ns = sp or (fa.num_splits(1, c, 16, 16, 2048,
                                                  q_offset=off) if bf16
                                    else 1)
                        record(name, dtype, err(out, ref), c=c,
                               q_offset=off, Sk=2048, splits=ns)
                        same.append(bool(torch.equal(out, again)))
                        if bf16:
                            k1_fused_check(q, k, v, off, ns, out, c=c,
                                           H=16, q_offset=off, Sk=2048,
                                           hd=(192, 128))
        check(all(same), "K1 (192, 128): two launches on the same inputs "
              "differ")
        report["k1_mla_bit_identical"] = same
        say(f"K1 (192, 128): two launches bit-identical in {sum(same)} of "
            f"{len(same)} cases (bf16 v3 and fp32 v2)")
        for Hq, kv in ((24, 8), (32, 4), (32, 2)):
            k = randn(1, 2048, kv, hd, dtype=bf)
            v = randn(1, 2048, kv, hd, dtype=bf)
            for c in (1, 32, 256):
                q = randn(1, c, Hq, hd, dtype=bf)
                for off in (0, 736, 1792):
                    out = fa.flash_attention(q, k, v, causal=True,
                                             q_offset=off)
                    ref = fa.flash_attention_plain(q.float(), k.float(),
                                                   v.float(), causal=True,
                                                   q_offset=off)
                    torch.cuda.synchronize()
                    ns = fa.num_splits(1, c, Hq, kv, 2048, q_offset=off)
                    record("flash_attention_fwd", bf, err(out, ref), c=c,
                           q_offset=off, Sk=2048, H=Hq, KV=kv, splits=ns)
                    k1_fused_check(q, k, v, off, ns, out, c=c, H=Hq, KV=kv,
                                   q_offset=off, Sk=2048)
        say("K1 v3 at GQA groups 3, 8 and 16 (head dim 128): within "
            f"{TOL['bfloat16']} of the fp32 twin, the fused split merge "
            f"equal to partials + merge bit for bit")

    def cross_checks():
        """K1 and K2 at the cross-attention paths' instances.  K1 non-causal
        at whisper's encoder (Sq = Sk = 1500, 16/16 heads of 64: a last kv
        tile of 28 keys), whisper's cross chunks (c 128 and 256 against
        1500) and vision's (c 1 and 256 against 1601, 32/8 heads of 128: a
        last tile of one key), B 1 and 4, under the split rule and forced
        2, 3 and 5 splits: bf16 (v3) within 2e-2 of the fp32 twin, two
        launches bit-identical, the fused launch equal to split partials +
        the standalone merge bit for bit; fp32 (v2) at two of them.  K2 v2
        at group 1 (16/16 of 64) over S 1500 and at 32/8 over S 1601, every
        row full (the cross decode) and ragged with a zero-length row: the
        fused launch within 2e-2 of the twin and equal to v2 partials + the
        combine, to a second launch and, row by row, to B = 1 calls; fp32
        (v1) at group 1."""
        bf = torch.bfloat16
        same = []
        name = "flash_attention_fwd (non-causal)"
        for B, Sq, Sk, Hq, kv, d in (
                (4, 1500, 1500, 16, 16, 64), (1, 1500, 1500, 16, 16, 64),
                (4, 128, 1500, 16, 16, 64), (1, 256, 1500, 16, 16, 64),
                (4, 256, 1601, 32, 8, 128), (1, 256, 1601, 32, 8, 128),
                (4, 1, 1601, 32, 8, 128)):
            q = randn(B, Sq, Hq, d, dtype=bf)
            k = randn(B, Sk, kv, d, dtype=bf)
            v = randn(B, Sk, kv, d, dtype=bf)
            ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                           causal=False)
            rule = fa.num_splits(B, Sq, Hq, kv, Sk, causal=False)
            for sp in (None, 2, 3, 5):
                out = fa.flash_attention(q, k, v, causal=False, splits=sp)
                again = fa.flash_attention(q, k, v, causal=False, splits=sp)
                torch.cuda.synchronize()
                ns = sp or rule
                record(name, bf, err(out, ref), B=B, Sq=Sq, Sk=Sk, H=Hq,
                       KV=kv, hd=d, splits=ns, rule=rule)
                same.append(bool(torch.equal(out, again)))
                k1_fused_check(q, k, v, 0, ns, out, causal=False, B=B,
                               Sq=Sq, Sk=Sk, H=Hq, KV=kv, hd=d)
            if B == 1 and Sq == 256:        # fp32: v2
                out = fa.flash_attention(q.float(), k.float(), v.float(),
                                         causal=False)
                torch.cuda.synchronize()
                record(name, torch.float32, err(out, ref), B=B, Sq=Sq,
                       Sk=Sk, H=Hq, KV=kv, hd=d)
            del q, k, v, ref
        check(all(same), "K1 non-causal: two launches on the same inputs "
              "differ")
        say(f"K1 non-causal (Sk 1500 and 1601): within {TOL['bfloat16']} of "
            f"the fp32 twin, two launches bit-identical in {sum(same)} of "
            f"{len(same)} cases, the fused split merge equal to partials + "
            f"merge bit for bit")
        report["k1_noncausal_bit_identical"] = same
        # whisper's decoder self-attention: causal at group 1, head dim 64,
        # Model.prefill's 4 x 1024 and chunks at offsets in a 1056-wide cache
        same = []
        name = "flash_attention_fwd"
        for B, c, off, Sk in ((4, 1024, 0, 1024), (1, 1024, 0, 1024)) + tuple(
                (B, c, off, 1056) for B in (1, 4) for c in (128, 256)
                for off in (0, 128, 768)):
            q = randn(B, c, 16, 64, dtype=bf)
            k = randn(B, Sk, 16, 64, dtype=bf)
            v = randn(B, Sk, 16, 64, dtype=bf)
            ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                           causal=True, q_offset=off)
            rule = fa.num_splits(B, c, 16, 16, Sk, q_offset=off)
            for sp in (None, 2, 3):
                out = fa.flash_attention(q, k, v, causal=True, q_offset=off,
                                         splits=sp)
                again = fa.flash_attention(q, k, v, causal=True,
                                           q_offset=off, splits=sp)
                torch.cuda.synchronize()
                ns = sp or rule
                record(name, bf, err(out, ref), B=B, c=c, q_offset=off,
                       Sk=Sk, H=16, KV=16, hd=64, splits=ns, rule=rule)
                same.append(bool(torch.equal(out, again)))
                k1_fused_check(q, k, v, off, ns, out, B=B, c=c, Sk=Sk, H=16,
                               KV=16, hd=64, q_offset=off)
            del q, k, v, ref
        check(all(same), "K1 causal (64, 64): two launches on the same "
              "inputs differ")
        say(f"K1 causal at group 1, head dim 64 (whisper's decoder: 4 x 1024, "
            f"chunks of 128 and 256 at 0, 128 and 768 against 1056): within "
            f"{TOL['bfloat16']} of the fp32 twin, two launches bit-identical "
            f"in {sum(same)} of {len(same)} cases, the fused split merge "
            f"equal to partials + merge bit for bit")
        report["k1_causal_64_bit_identical"] = same
        same = []
        for B, S, Hq, kv, d in ((4, 1500, 16, 16, 64), (4, 1601, 32, 8, 128)):
            G = Hq // kv
            kname = "flash_decode (fused, group 1)" if G == 1 else \
                "flash_decode (fused)"
            for lens in ([S] * B, [S, 1, 777, 0]):
                lens = torch.tensor(lens, dtype=torch.int32, device=dev)
                q = randn(B, Hq, d, dtype=bf)
                kc = randn(B, S, kv, d, dtype=bf)
                vc = randn(B, S, kv, d, dtype=bf)
                fused = fd.flash_decode(q, kc, vc, lens)
                parts = fd.decode_partials(q, kc, vc, lens)
                pair = fd.combine(*parts, bf)
                ref = fd.flash_decode_plain(q.float(), kc.float(),
                                            vc.float(), lens)
                torch.cuda.synchronize()
                record(kname, bf, err(fused, ref), B=B, S=S, H=Hq, KV=kv,
                       hd=d, lengths=lens.tolist())
                k2_v2_record(parts, fd.decode_partials_plain(q, kc, vc, lens),
                             B=B, S=S, H=Hq, KV=kv, hd=d,
                             lengths=lens.tolist())
                ok = torch.equal(fused, pair) and torch.equal(
                    fused, fd.flash_decode(q, kc, vc, lens)) and all(
                    torch.equal(fused[i:i + 1], fd.flash_decode(
                        q[i:i + 1], kc[i:i + 1], vc[i:i + 1], lens[i:i + 1]))
                    for i in range(B))
                same.append(bool(ok))
                check(ok, f"K2 v2 G={G} S={S} lengths {lens.tolist()}: the "
                      f"fused launch differs from partials + combine, a "
                      f"second launch or a B=1 call")
                if G == 1:                  # fp32: v1
                    out = fd.flash_decode(q.float(), kc.float(), vc.float(),
                                          lens)
                    torch.cuda.synchronize()
                    record(kname, torch.float32, err(out, ref), B=B, S=S,
                           H=Hq, KV=kv, hd=d, lengths=lens.tolist())
        say(f"K2 v2 at group 1 over 1500 and 32/8 over 1601, rows full and "
            f"ragged: fused == partials + combine == a second launch == B=1 "
            f"calls, bit for bit, in {sum(same)} of {len(same)} cases")
        report["k2_cross_bit_identical"] = same

    k1_bf16_checks()
    k1_new_shapes_checks()
    k2_v2_checks()
    cross_checks()

    # K1 and K2 at llama4-scout's head layout, the MoE path's: 40 q heads
    # on 8 kv heads (G = 5)
    for dtype in (torch.bfloat16, torch.float32):
        k = randn(1, 2048, KV, hd, dtype=dtype)
        v = randn(1, 2048, KV, hd, dtype=dtype)
        q = randn(1, 256, 40, hd, dtype=dtype)
        out = fa.flash_attention(q, k, v, causal=True, q_offset=736)
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                       causal=True, q_offset=736)
        torch.cuda.synchronize()
        record("flash_attention_fwd", dtype, err(out, ref), c=256,
               q_offset=736, Sk=2048, H=40)
        q = randn(8, 40, hd, dtype=dtype)
        kc = randn(8, 2048, KV, hd, dtype=dtype)
        vc = randn(8, 2048, KV, hd, dtype=dtype)
        lens = torch.randint(1, 2049, (8,), generator=gen, device=dev,
                             dtype=torch.int32)
        out = fd.flash_decode(q, kc, vc, lens)
        ref = fd.flash_decode_plain(q.float(), kc.float(), vc.float(), lens)
        torch.cuda.synchronize()
        record("flash_decode (fused)" if dtype == torch.bfloat16 else
               "flash_decode (partials+combine)", dtype, err(out, ref), B=8,
               S=2048, H=40)
        del k, v, q, kc, vc

    # K4: both scans against their plain fold, fp32 (normwise relative)
    k4_worst = {}

    def k4_record(kernel, got, want, **case):
        e_rel = max(float((g - w).abs().max() / w.abs().max().clamp_min(
            1e-30)) for g, w in zip(got, want))
        e_abs = max(err(g, w) for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        report["cases"].append(dict(kernel=kernel, dtype="float32",
                                    max_rel_err=e_rel, max_abs_err=e_abs,
                                    tol=K4_TOL, **case))
        w = k4_worst.setdefault(kernel, {"rel": 0.0, "abs": 0.0})
        w["rel"], w["abs"] = max(w["rel"], e_rel), max(w["abs"], e_abs)
        check(finite and e_rel <= K4_TOL, f"{kernel} {case}: relative err "
              f"{e_rel:.3g} > tol {K4_TOL} (or not finite)")

    def logspace_inputs(nc, B, Hh, dh, extreme=False):
        la, mS = randn(nc, B, Hh, dtype=torch.float32), \
            randn(nc, B, Hh, dtype=torch.float32)
        if extreme:     # tests/test_ssm_scan.py's gate log-sums, past exp
            la = torch.tensor([1e3, -1e3, 500.0, 0.0, -700.0, 300.0, 88.0],
                              device=dev).reshape(7, 1, 1)
            mS = torch.tensor([-1e3, 1e3, -500.0, 700.0, 0.0, -88.0, 2.0],
                              device=dev).reshape(7, 1, 1)
        C = randn(nc, B, Hh, dh, dh, dtype=torch.float32)
        nn_ = randn(nc, B, Hh, dh, dtype=torch.float32)
        m0 = randn(B, Hh, dtype=torch.float32)
        carry = (torch.zeros_like(m0), m0,
                 randn(B, Hh, dh, dh, dtype=torch.float32),
                 randn(B, Hh, dh, dtype=torch.float32))
        return (la, mS, C, nn_), carry

    for shape, extreme in (((8, 4, 4, 1024), False), ((7, 1, 1, 1024), True)):
        xs, carry = logspace_inputs(*shape, extreme=extreme)
        for inclusive in (False, True):
            got = ts.logspace_scan(*xs, carry, inclusive=inclusive)
            want = ts.fold(xs, ss.logspace_affine_combine, carry,
                           inclusive=inclusive, axis=0)
            torch.cuda.synchronize()
            k4_record("tile_scan_logspace", got, want, shape=shape,
                      inclusive=inclusive, extreme_gates=extreme)
        del xs, carry, got, want

    def affine_inputs(B, L, Di, N):
        dA = torch.exp(-F.softplus(randn(B, L, Di, N, dtype=torch.float32)))
        dBx = 0.1 * randn(B, L, Di, N, dtype=torch.float32)
        return dA, dBx, randn(B, Di, N, dtype=torch.float32)

    for shape in ((1, 256, 16384, 16), (2, 100, 96, 8)):
        dA, dBx, h0 = affine_inputs(*shape)
        seed = (torch.ones_like(h0), h0)
        for inclusive in (True, False):
            got = ts.affine_scan(dA, dBx, *seed, inclusive=inclusive)
            want = ts.fold((dA, dBx), ss.affine_combine, seed,
                           inclusive=inclusive, axis=1)
            torch.cuda.synchronize()
            k4_record("tile_scan_affine", got, want, shape=shape,
                      inclusive=inclusive, gains=True)
        got = ss.mamba_assoc_scan(dA, dBx, h0)       # states only
        want = ts.fold((dA, dBx), ss.affine_combine, seed, inclusive=True,
                       axis=1)
        torch.cuda.synchronize()
        k4_record("tile_scan_affine", (got,), want[1:], shape=shape,
                  inclusive=True, gains=False)
        del dA, dBx, h0, seed, got, want
    for kname, w in k4_worst.items():
        say(f"{kname}: max relative err {w['rel']:.3g}, max abs err "
            f"{w['abs']:.3g} (tol {K4_TOL} relative, fp32)")
    for kname, w in worst.items():
        say(f"{kname}: max abs err " + ", ".join(
            f"{d} {e:.3g} (tol {TOL[d]})" for d, e in w.items()))

    bf = torch.bfloat16

    def k1_case(c, off, Sk, B=1, Hq=H, kv=KV, dk=hd, dv=hd, causal=True):
        """v3 (the wrapper's route and split rule), the plain twin and
        SDPA, all on the same inputs after an L2 flush; q/k head dim
        ``dk``, v head dim ``dv`` (MLA: 192, 128); ``causal=False``: no
        mask and no offset.  v3 against v2, the fused launch against the
        two and the split counts are timed in turns by
        ``tools/version_turns.py``."""
        q = randn(B, c, Hq, dk, dtype=bf)
        k = randn(B, Sk, kv, dk, dtype=bf)
        v = randn(B, Sk, kv, dv, dtype=bf)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if causal:
            mask = (off + torch.arange(c, device=dev)[:, None]
                    >= torch.arange(Sk, device=dev)[None, :])
            pairs = sum(min(Sk, off + i + 1) for i in range(c))
            kv_len = min(Sk, off + c)
        else:
            mask, pairs, kv_len, off = None, c * Sk, Sk, 0
        flops = 2.0 * B * Hq * (dk + dv) * pairs
        nbytes = 2.0 * (B * c * Hq * (dk + dv) + B * kv_len * kv * (dk + dv))
        bound = max(flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES)

        ns = fa.num_splits(B, c, Hq, kv, Sk, causal=causal, q_offset=off)
        try:        # SDPA's backends may refuse a v head dim != q/k's
            library = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), cold=True)
        except RuntimeError as e:
            say(f"SDPA refuses q/k {dk}, v {dv}: {e}")
            library = None
        return dict(
            ms=device_ms(lambda: fa.flash_attention(
                q, k, v, causal=causal, q_offset=off), cold=True),
            route="unsplit" if ns == 1 else "fused" if fa.fused_merge(ns)
            else "two launches",
            plain_ms=device_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=causal, q_offset=off), cold=True),
            library_ms=library,
            library_computes="the same attention (offset causal mask)"
            if causal else "the same attention (no mask)",
            bound_ms=bound * 1e3,
            bound_by="operations" if flops / PEAK_FLOPS["bfloat16"]
            > nbytes / PEAK_BYTES else "bytes",
            shape=dict(B=B, c=c, q_offset=off, Sk=Sk, H=Hq, KV=kv, hd=dk,
                       hdv=dv, dtype="bfloat16", splits=ns,
                       **({} if causal else {"causal": False})))

    def merge_case(c, off, Sk, Hq=H):
        """The merge launch alone, on partials v3 just wrote (warm)."""
        q = randn(1, c, Hq, hd, dtype=bf)
        k = randn(1, Sk, KV, hd, dtype=bf)
        v = randn(1, Sk, KV, hd, dtype=bf)
        ns = fa.num_splits(1, c, Hq, KV, Sk, q_offset=off)
        m, l, acc = fa.split_partials(q, k, v, ns, causal=True, q_offset=off)
        rows_ = c * Hq
        nbytes = 4.0 * ns * rows_ * (hd + 2) + 2.0 * rows_ * hd
        return dict(
            ms=device_ms(lambda: fa.merge(m, l, acc), cold=False),
            plain_ms=device_ms(lambda: fa.merge_plain(m, l, acc, bf),
                               cold=False),
            library_ms=None, bound_ms=nbytes / PEAK_BYTES * 1e3,
            bound_by="bytes",
            shape=dict(B=1, c=c, q_offset=off, Sk=Sk, H=Hq, KV=KV, hd=hd,
                       splits=ns, dtype="float32 partials, bfloat16 out"))

    def k2_case(B, S, lens, Hq=H, kv=KV, d=hd):
        """K2's fused bf16 launch (v2 partials with the merge), its plain
        twin and SDPA's decode on the same inputs after an L2 flush, and
        the standalone combine on v2's partials (warm).  v2 against v1
        and the fused launch against partials + combine are timed in turns
        by ``tools/version_turns.py``."""
        q = randn(B, Hq, d, dtype=bf)
        kc = randn(B, S, kv, d, dtype=bf)
        vc = randn(B, S, kv, d, dtype=bf)
        lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        qt = q[:, :, None].contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        mask = (torch.arange(S, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        nk = fd.num_splits(S)
        m, l, acc = fd.decode_partials(q, kc, vc, lens)
        tot = int(lens.clamp(max=S).sum())
        p_flops = 4.0 * Hq * d * tot
        c_bytes = 4.0 * B * Hq * nk * (2 + d) + 2.0 * B * Hq * d
        shape = dict(B=B, S=S, H=Hq, KV=kv, hd=d, dtype="bfloat16",
                     block_k=fd.BLOCK_K, splits=nk, mean_length=tot / B)
        # the whole decode: q, the valid K/V rows and the output, once
        f_bytes = 2.0 * (2 * B * Hq * d + 2 * tot * kv * d)
        part = dict(
            ms=device_ms(lambda: fd.flash_decode(q, kc, vc, lens),
                         cold=True),
            plain_ms=device_ms(lambda: fd.flash_decode_plain(
                q, kc, vc, lens), cold=True),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), cold=True),
            library_computes="the same decode attention",
            bound_ms=max(p_flops / PEAK_FLOPS["bfloat16"],
                         f_bytes / PEAK_BYTES) * 1e3,
            bound_by="bytes" if f_bytes / PEAK_BYTES
            > p_flops / PEAK_FLOPS["bfloat16"] else "operations",
            shape=shape)
        comb = dict(
            ms=device_ms(lambda: fd.combine(m, l, acc, bf), cold=False),
            plain_ms=device_ms(lambda: fd.combine_plain(m, l, acc, bf),
                               cold=False),
            library_ms=None,
            bound_ms=c_bytes / PEAK_BYTES * 1e3, bound_by="bytes",
            shape=shape)
        return part, comb

    t0 = time.perf_counter()
    # llama3-8b's chunks (32/8 heads), llama4-scout's (40/8), the dense
    # configs' groups (minitron 24/8, yi 32/4, chatglm 32/2), and MLA's
    # Model.prefill of 4 x 2048 at 16 heads, (192, 128)
    for Hq, c, off, kw in [(H, c, off, {}) for c in (32, 64, 256)
                           for off in (0, 224, 736, 1792)
                           if off + c <= 2048] + [
            (40, 256, 736, {}), (H, 1, 1792, {}),
            (24, 256, 736, dict(kv=8)), (32, 256, 736, dict(kv=4)),
            (32, 256, 736, dict(kv=2)),
            (16, 2048, 0, dict(B=4, kv=16, dk=192, dv=128))]:
        r = k1_case(c, off, 2048, Hq=Hq, **kw)
        tag = f"c={c} off={off}" + ("" if Hq == H and not kw else
                                    f" H={Hq}") + (
            f" KV={kw['kv']}" if "kv" in kw else "") + (
            f" B={kw['B']} hd=({kw['dk']}, {kw['dv']})" if "dk" in kw
            else "")
        report["timings"][f"flash_attention_fwd {tag}"] = r
        lib = "refused" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        say(f"K1 {tag} Sk=2048 bf16: v3 {r['ms']:.4f} ms "
            f"({r['shape']['splits']} splits, {r['route']}), plain "
            f"{r['plain_ms']:.4f} ms, sdpa {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
    merge_row = merge_case(32, 1792, 2048)
    report["timings"]["flash_attention_merge c=32 off=1792"] = merge_row
    say(f"K1 merge c=32 off=1792 ({merge_row['shape']['splits']} splits): "
        f"{merge_row['ms']:.4f} ms, plain {merge_row['plain_ms']:.4f} ms, "
        f"bound {merge_row['bound_ms']:.4f} ms (bytes) [{card}]")
    lens_rng = np.random.RandomState(args.seed)
    main_lens = lens_rng.randint(64, 1089, size=8)
    for S, lens in ((2048, main_lens), (2048, [2048] * 8),
                    (1100, np.minimum(main_lens, 1100))):
        part, comb = k2_case(8, S, lens)
        tag = f"B=8 S={S} mean_len={part['shape']['mean_length']:.0f}"
        report["timings"][f"flash_decode_partials {tag}"] = part
        report["timings"][f"flash_decode_combine {tag}"] = comb
        say(f"K2 {tag} bf16: fused {part['ms']:.4f} ms (bound "
            f"{part['bound_ms']:.4f} {part['bound_by']}, plain "
            f"{part['plain_ms']:.4f}), combine {comb['ms']:.4f} ms (plain "
            f"{comb['plain_ms']:.4f}, bound {comb['bound_ms']:.4f}), sdpa "
            f"decode {part['library_ms']:.4f} ms [{card}]")

    # the cross-attention paths' instances: K1 non-causal at whisper's
    # encoder (the row) and cross chunk, vision's cross chunks; K2 at
    # group 1 over whisper's 1500 positions (the row), and vision's cross
    # decode over 1601, every row full
    k1_rows = [k1_case(c, 0, Sk, B=B, Hq=Hq, kv=kv, dk=d, dv=d, causal=False)
               for B, c, Sk, Hq, kv, d in (
                   (4, 1500, 1500, 16, 16, 64), (4, 256, 1500, 16, 16, 64),
                   (4, 256, 1601, 32, 8, 128), (1, 256, 1601, 32, 8, 128))]
    for r_ in k1_rows:
        sh = r_["shape"]
        say(f"K1 non-causal B={sh['B']} Sq={sh['c']} Sk={sh['Sk']} "
            f"{sh['H']}/{sh['KV']} heads of {sh['hd']} bf16: v3 "
            f"{r_['ms']:.4f} ms ({sh['splits']} splits, {r_['route']}), "
            f"plain {r_['plain_ms']:.4f} ms, sdpa {r_['library_ms']:.4f} "
            f"ms, bound {r_['bound_ms']:.4f} ms ({r_['bound_by']}) [{card}]")
    cross_rows = {"flash_attention_fwd (non-causal)": dict(
        k1_rows[0], other_shapes={str(r_["shape"]): r_
                                  for r_ in k1_rows[1:]})}
    g1, _ = k2_case(4, 1500, [1500] * 4, Hq=16, kv=16, d=64)
    v4, _ = k2_case(4, 1601, [1601] * 4, Hq=32, kv=8, d=128)
    cross_rows["flash_decode_partials (group 1)"] = g1
    for r_ in (g1, v4):
        sh = r_["shape"]
        say(f"K2 B={sh['B']} S={sh['S']} every row full, {sh['H']}/"
            f"{sh['KV']} heads of {sh['hd']} bf16: fused {r_['ms']:.4f} ms, "
            f"plain {r_['plain_ms']:.4f} ms, sdpa {r_['library_ms']:.4f} ms, "
            f"bound {r_['bound_ms']:.4f} ms ({r_['bound_by']}) [{card}]")
    report["timings"]["flash_attention_fwd (non-causal)"] = cross_rows[
        "flash_attention_fwd (non-causal)"]
    report["timings"]["flash_decode_partials (group 1) B=4 S=1500"] = g1
    report["timings"]["flash_decode_partials B=4 S=1601 32/8 full"] = v4

    # every complete fused launch leaves its arrival counters at 0
    arrivals = fd._arrival_counters[torch.cuda.current_device()]
    check(int(arrivals.count_nonzero()) == 0, "K2 fused: arrival counters "
          "left non-zero after the checks and timings")

    def k4_row(kernel_fn, plain_fn, nbytes, ops, shape):
        bb, bo = nbytes / PEAK_BYTES, ops / PEAK_FLOPS["float32"]
        return dict(ms=device_ms(kernel_fn, cold=True),
                    plain_ms=device_ms(plain_fn, cold=True),
                    library_ms=None, bound_ms=max(bb, bo) * 1e3,
                    bound_by="bytes" if bb >= bo else "operations",
                    shape=shape)

    # K4 logspace at the slice's shape: Model.prefill of 4 x 2048 tokens,
    # 256-token chunks, 4 heads of 1024 (exclusive, seeded by the carry)
    nc, Bx, Hx, dhx = 8, 4, 4, 1024
    xs, carry = logspace_inputs(nc, Bx, Hx, dhx)
    G, FCN = Bx * Hx, dhx * dhx + dhx
    elems = nc * G * (2 + FCN)                 # la, m, C, n of all chunks
    r = k4_row(lambda: ts.logspace_scan(*xs, carry, inclusive=False),
               lambda: ts.fold(xs, ss.logspace_affine_combine, carry,
                               inclusive=False, axis=0),
               nbytes=4.0 * (2 * elems + G * (2 + FCN)),
               ops=3.0 * nc * G * FCN,
               shape=dict(nc=nc, B=Bx, H=Hx, dh=dhx, dtype="float32",
                          inclusive=False))
    report["timings"]["tile_scan_logspace nc=8 B=4 H=4 dh=1024"] = r
    say(f"K4 logspace nc={nc} B={Bx} H={Hx} dh={dhx} fp32: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), no library call [{card}]")
    k4_rows = {"tile_scan_logspace": r}
    del xs, carry
    # K4 affine at jamba-1.5-large's Mamba width: one 256-token chunk of
    # Di=16384, N=16, the states only (mamba_assoc_scan)
    Bm, Lm, Di, Nm = 1, 256, 16384, 16
    dA, dBx, h0 = affine_inputs(Bm, Lm, Di, Nm)
    seed = (torch.ones_like(h0), h0)
    Fm = Di * Nm
    r = k4_row(lambda: ss.mamba_assoc_scan(dA, dBx, h0),
               lambda: ts.fold((dA, dBx), ss.affine_combine, seed,
                               inclusive=True, axis=1),
               nbytes=4.0 * (3 * Bm * Lm * Fm + 2 * Bm * Fm),
               ops=3.0 * Bm * Lm * Fm,
               shape=dict(B=Bm, c=Lm, Di=Di, N=Nm, dtype="float32",
                          inclusive=True, gains_written=False))
    report["timings"]["tile_scan_affine B=1 c=256 Di=16384 N=16"] = r
    say(f"K4 affine B={Bm} c={Lm} Di={Di} N={Nm} fp32: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), no library call [{card}]")
    k4_rows["tile_scan_affine"] = r
    del dA, dBx, h0, seed
    say(f"timing took {time.perf_counter() - t0:.1f} s")
    rows = {
        "flash_attention_fwd": report["timings"][
            "flash_attention_fwd c=256 off=736"],
        "flash_attention_merge": merge_row,
        "flash_decode_partials": report["timings"][
            f"flash_decode_partials B=8 S=2048 mean_len="
            f"{main_lens.mean():.0f}"],
        "flash_decode_combine": report["timings"][
            f"flash_decode_combine B=8 S=2048 mean_len="
            f"{main_lens.mean():.0f}"],
        **k4_rows,
    }

    # ---------------------------------------------------------- 5. main path
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.chaos import TraceItem, make_request
    from repro_torch.serve.engine import (ContinuousEngine, Engine,
                                          EngineConfig, Request)

    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(args.seed)
    torch.cuda.synchronize()
    say(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f}B params in {cfg.param_dtype}, "
        f"init {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(args.seed)

    def requests(n, rid0):
        out = []
        for i in range(n):
            plen = int(rng.randint(64, 1025))
            out.append(Request(rid=rid0 + i, prompt=rng.randint(
                3, cfg.vocab_size, size=plen).astype(np.int32),
                max_new=int(rng.randint(16, 65))))
        return out

    cont_reqs, sync_reqs = requests(16, 0), requests(4, 100)
    L = cfg.num_layers

    def drain(eng, max_steps=5000):
        done, steps = {}, 0
        while eng.pending:
            for r in eng.step():
                done[r.rid] = r
            steps += 1
            check(steps < max_steps, "ContinuousEngine made no progress")
        return done

    _build.reset_launches()
    model.calls = dict.fromkeys(model.calls, 0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ce = ContinuousEngine(model, params, EngineConfig(
        max_batch=8, max_seq=2048, decode_tick=8, page_size=32, eos_id=7))
    for r in cont_reqs:
        ce.submit(r)
    done = drain(ce)
    torch.cuda.synchronize()
    t_cont = time.perf_counter() - t0
    calls_cont = dict(model.calls)
    dense_kernels = ("flash_attention_fwd", "flash_attention_merge",
                     "flash_decode_partials", "flash_decode_combine")

    def path_launches():
        return {k: v for k, v in _build.launches().items()
                if k in dense_kernels}

    launches_cont = path_launches()
    t0 = time.perf_counter()
    se = Engine(model, params, EngineConfig(max_batch=4, max_seq=2048,
                                            eos_id=7))
    for r in sync_reqs:
        se.submit(r)
    sync_done = {r.rid: r for r in se.step()}
    torch.cuda.synchronize()
    t_sync = time.perf_counter() - t0
    launches = path_launches()
    check(_build.launches()["tile_scan_logspace"] == 0
          and _build.launches()["tile_scan_affine"] == 0,
          "the dense path launched a scan kernel")
    calls = dict(model.calls)
    peak = torch.cuda.max_memory_allocated()

    check(len(done) == 16 and len(sync_done) == 4,
          f"served {len(done)}/16 continuous, {len(sync_done)}/4 sync")
    for r in list(done.values()) + list(sync_done.values()):
        res = np.asarray(r.result)
        check(1 <= len(res) <= r.max_new,
              f"request {r.rid}: {len(res)} tokens for max_new {r.max_new}")
        check(bool(((res >= 0) & (res < cfg.vocab_size)).all()),
              f"request {r.rid}: token out of range")
    check(len(ce.pages.free) == ce.pages.num_pages,
          "pages not all free after the drain")
    check(ce._admission.counter.value == 1,
          f"admission cap counter {ce._admission.counter.value} != 1")
    check(ce.telemetry.retired == 16 and all(s is None for s in ce.slots),
          "slots not all retired")
    # bf16 decode is one launch: the merge is fused into the partials, and
    # the standalone combine (v1's) never runs on this path
    expect = {"flash_attention_fwd": L * calls["prefill_chunk"],
              "flash_decode_partials": L * calls["decode_step"],
              "flash_decode_combine": 0}
    check(calls["prefill"] == 0, "the engines ran a non-chunked prefill")
    got = {k: n for k, n in launches.items() if k in expect}
    check(got == expect, f"launch counts {got} != layers x "
          f"(prefill chunks, decode steps), no combine {expect}")
    # a split K1 call is one launch whose last CTA a row tile merges
    # (tagged "fused" by the wrapper) up to fa.FUSED_UP_TO splits, else
    # two (the partials, then the standalone merge): each a whole number
    # of layers, together at most one per K1 launch; the 256-token chunks
    # split in 2, so the path has fused ones
    n_merge = launches["flash_attention_merge"]
    n_fused = _build.KERNELS["flash_attention_fwd"].tags.get("fused", 0)
    n_split = n_fused + n_merge
    check(n_fused > 0 and n_fused % L == 0 and n_merge % L == 0 and
          n_split <= launches["flash_attention_fwd"],
          f"K1 split chunks: {n_fused} fused launches and {n_merge} merge "
          f"launches are not layers x split chunks")
    check(all(n > 0 for k, n in launches.items()
              if k != "flash_decode_combine"),
          f"a kernel of the path never launched: {launches}")
    check(launches_cont["flash_attention_fwd"]
          == L * calls_cont["prefill_chunk"]
          and launches_cont["flash_decode_partials"]
          == L * calls_cont["decode_step"], "continuous-engine launches")
    gen_cont = sum(len(r.result) for r in done.values())
    gen_sync = sum(len(r.result) for r in sync_done.values())
    say(f"dense path: launches {launches} = {L} layers x "
        f"{calls['prefill_chunk']} prefill chunks ({n_split // L} of them "
        f"split: {n_fused // L} in one launch, the merge fused, "
        f"{n_merge // L} in two) / {calls['decode_step']} decode steps")
    say(f"ContinuousEngine: 16 requests, {gen_cont} tokens in {t_cont:.2f} s"
        f" = {gen_cont / t_cont:.1f} tok/s; Engine: 4 requests, {gen_sync} "
        f"tokens in {t_sync:.2f} s = {gen_sync / t_sync:.1f} tok/s; peak "
        f"memory {peak / 2**30:.2f} GiB [{card}]")
    report["main_path"] = dict(
        launches=launches, fused_split_launches=n_fused, calls=calls,
        continuous_s=t_cont,
        continuous_tokens=gen_cont, sync_s=t_sync, sync_tokens=gen_sync,
        peak_bytes=peak, telemetry=ce.telemetry.snapshot())
    del ce, se

    # where one decode step and one prefill chunk of the main path spend
    # device time (torch.profiler), beside their wall time without it
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType

    def breakdown(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        groups = {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            name = ev.key
            # K1: v3 (flash_fwd_tc_kernel), its merge and v2 all land here
            g = ("flash_attention_fwd" if "flash_fwd" in name else
                 "flash_decode_partials" if "decode_partials" in name
                 else "flash_decode_combine" if "decode_combine_kernel" in name
                 else "tile_scan_logspace" if "logspace_scan_kernel" in name
                 else "tile_scan_affine" if "affine_scan_kernel" in name
                 else "moe_dispatch" if "moe_hist_kernel" in name
                 or "moe_scatter_kernel" in name
                 or "moe_onetile_kernel" in name
                 else "matmul" if any(s in name.lower() for s in (
                     "gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk"))
                 else "other")
            groups[g] = groups.get(g, 0.0) + \
                ev.self_device_time_total / 1e3 / reps
        return wall, groups

    lens8 = torch.as_tensor(main_lens, dtype=torch.int32, device=dev)
    toks8 = torch.randint(3, cfg.vocab_size, (8,), generator=gen,
                          device=dev, dtype=torch.int32)
    dcache = model.init_cache(8, 2048)
    pcache = model.init_cache(1, 2048)
    ptoks = torch.randint(3, cfg.vocab_size, (1, 992), generator=gen,
                          device=dev, dtype=torch.int32)
    model.prefill_chunk(params, ptoks[:, :736], pcache, 0)
    for what, fn, reps in (
            ("decode step B=8 S=2048", lambda: model.decode_step(
                params, toks8, dcache, lens8), 5),
            ("prefill chunk c=256 at 736, B=1 S=2048", lambda:
             model.prefill_chunk(params, ptoks[:, 736:], pcache, 736,
                                 all_logits=True), 3)):
        wall, groups = breakdown(fn, reps)
        dev_ms = sum(groups.values())
        report.setdefault("breakdown", {})[what] = dict(
            wall_ms=wall, device_ms=dev_ms, groups=groups)
        say(f"{what}, {L} layers: wall {wall:.2f} ms, device {dev_ms:.2f} "
            f"ms (" + ", ".join(f"{g} {t:.2f}" for g, t in sorted(
                groups.items(), key=lambda kv: -kv[1])) + f") [{card}]")
    del dcache, pcache

    # --------- 5a-d. simulated admission, slot deaths, drain, weight audit
    policy_path_bf16(np, torch, model, params, cfg, args.seed, card, report,
                     drain, path_launches)
    del params, model
    free_card(torch)

    # ------------------------------------------------- 6. fp32 at full width
    cfg32 = dataclasses.replace(cfg, num_layers=2, param_dtype="float32",
                                compute_dtype="float32")
    model = Model(cfg32, device="cuda")
    params = model.init(args.seed + 1)
    cpu_model = Model(cfg32, device="cpu")
    cpu_params = _tree_to(params, "cpu")
    toks = torch.as_tensor(rng.randint(3, cfg.vocab_size, size=(2, 300)),
                           dtype=torch.int32)
    gl, gcache = model.prefill(params, toks.cuda(), max_seq=320)
    cl, ccache = cpu_model.prefill(cpu_params, toks, max_seq=320)
    worst_logit = err(gl.cpu(), cl)
    lengths = torch.full((2,), 300, dtype=torch.int32)
    nxt = torch.argmax(cl, -1).to(torch.int32)
    for _ in range(4):
        gl, gcache = model.decode_step(params, nxt.cuda(), gcache,
                                       lengths.cuda())
        cl, ccache = cpu_model.decode_step(cpu_params, nxt, ccache, lengths)
        worst_logit = max(worst_logit, err(gl.cpu(), cl))
        nxt, lengths = torch.argmax(cl, -1).to(torch.int32), lengths + 1
    say(f"fp32 logits, card vs CPU plain path (2 layers, prefill 300 + 4 "
        f"decode steps): max abs err {worst_logit:.3g} (tol {LOGIT_TOL})")
    # which side rounds: one fp32 matmul of the logit head's size on each,
    # against float64
    a = torch.randn(8, 4096, dtype=torch.float64)
    b = torch.randn(4096, 4096, dtype=torch.float64)
    exact = a @ b
    say("fp32 matmul (8x4096 @ 4096x4096) max abs err vs float64: CPU "
        f"{float((a.float() @ b.float() - exact).abs().max()):.3g}, card "
        f"{float((a.float().cuda() @ b.float().cuda()).cpu().double().sub(exact).abs().max()):.3g}"
        f" (fp32 precision {torch.get_float32_matmul_precision()!r})")
    check(worst_logit <= LOGIT_TOL, "card logits disagree with the CPU")
    del cpu_model, cpu_params, ccache, gcache

    lens6, news6 = (40, 300, 77, 520, 129, 260), (10, 6, 14, 8, 12, 5)
    trace6 = tuple(TraceItem(rid=i, arrival=0.0, prompt_len=n, max_new=mn)
                   for i, (n, mn) in enumerate(zip(lens6, news6)))
    reqs6 = [make_request(it, cfg.vocab_size, seed=args.seed)
             for it in trace6]
    ref = {}
    for r in reqs6:
        eng = Engine(model, params, EngineConfig(max_batch=1, eos_id=7,
                                                 max_seq=2048))
        eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new))
        (d,) = eng.step()
        ref[r.rid] = np.asarray(d.result)
    _build.reset_launches()
    model.calls = dict.fromkeys(model.calls, 0)
    ce = ContinuousEngine(model, params, EngineConfig(
        max_batch=3, eos_id=7, max_seq=1024, decode_tick=4))
    for r in reqs6:
        ce.submit(Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new))
    got = {rid: np.asarray(r.result) for rid, r in drain(ce).items()}
    # fp32 decode takes v1: two launches a layer a step, partials then the
    # standalone combine
    fp32_launches = path_launches()
    n_dec = cfg32.num_layers * model.calls["decode_step"]
    check(fp32_launches["flash_decode_partials"] == n_dec
          == fp32_launches["flash_decode_combine"] > 0,
          f"fp32 ContinuousEngine: K2 launches {fp32_launches} != layers x "
          f"{model.calls['decode_step']} decode steps, each partials and "
          f"combine")
    say(f"fp32 ContinuousEngine (v1 route): K2 partials and combine "
        f"{n_dec} launches each = {cfg32.num_layers} layers x "
        f"{model.calls['decode_step']} decode steps")
    ties = 0
    for r in reqs6:
        a, b = got[r.rid], ref[r.rid]
        if np.array_equal(a, b):
            continue
        t = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                 min(len(a), len(b)))
        ctx = np.concatenate([r.prompt, b[:t]]).astype(np.int32)
        logits, _ = model.prefill(params, torch.as_tensor(
            ctx[None], device="cuda"))
        top2 = torch.topk(logits[0, :cfg.vocab_size], 2).values
        gap = float(top2[0] - top2[1])
        say(f"request {r.rid}: batched and one-at-a-time tokens differ at "
            f"step {t}; top-2 logit gap there {gap:.3g}")
        check(gap < NEAR_TIE, f"request {r.rid}: divergence is not a "
              f"near-tie (gap {gap:.3g} >= {NEAR_TIE})")
        ties += 1
    say(f"fp32 ContinuousEngine == one-at-a-time Engine tokens for "
        f"{len(reqs6) - ties}/{len(reqs6)} requests ({ties} near-ties)")
    report["fp32"] = dict(max_logit_err=worst_logit, near_ties=ties,
                          launches=fp32_launches)
    # 6a-c. the policy runs, each == ref exactly
    policy_path_fp32(np, torch, model, params, trace6, reqs6, ref,
                     cfg.vocab_size, args.seed, report, drain)
    del ce, params, model
    free_card(torch)

    # ------------------- 6d. the schedulers and work_loop over CUDA tensors
    policy_host_phase(torch, dev, card, report)

    # ------------------------------------------ 7. the SSM path: xlstm-1.3b
    xcfg = get_config("xlstm-1.3b")
    t0 = time.perf_counter()
    xmodel = Model(xcfg, device="cuda", scan_impl="pallas")
    xparams = xmodel.init(args.seed)
    torch.cuda.synchronize()
    n_mlstm = xmodel.repeats * sum(s.kind == "mlstm"
                                   for s in xmodel.period_specs)
    say(f"{xcfg.name}: {xcfg.num_layers} blocks ({n_mlstm} mLSTM), d_model "
        f"{xcfg.d_model}, {xcfg.param_count() / 1e9:.2f}B params in "
        f"{xcfg.param_dtype}, init {time.perf_counter() - t0:.1f} s")
    V = xcfg.vocab_size
    xrng = np.random.RandomState(args.seed)
    prompts = torch.as_tensor(xrng.randint(3, V, size=(4, 2048)),
                              dtype=torch.int32, device=dev)
    _build.reset_launches()
    xmodel.calls = dict.fromkeys(xmodel.calls, 0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, xcache = xmodel.prefill(xparams, prompts)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    ssm_launches = _build.launches()
    check(ssm_launches["tile_scan_logspace"]
          == n_mlstm * xmodel.calls["prefill"] == n_mlstm,
          f"K4 launches {ssm_launches['tile_scan_logspace']} != {n_mlstm} "
          f"mLSTM layers x {xmodel.calls['prefill']} prefill calls")
    check(tuple(logits.shape) == (4, V) and bool(torch.isfinite(
        logits).all()), f"prefill logits {tuple(logits.shape)} not finite "
        f"(4, {V})")
    tok = torch.argmax(logits, -1).to(torch.int32)
    lengths = torch.full((4,), 2048, dtype=torch.int32, device=dev)
    gen_ssm = [tok]
    t0 = time.perf_counter()
    for _ in range(32):
        logits, xcache = xmodel.decode_step(xparams, tok, xcache, lengths)
        tok = torch.argmax(logits, -1).to(torch.int32)
        lengths += 1
        gen_ssm.append(tok)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    gen_ssm = torch.stack(gen_ssm, 1)
    check(bool(torch.isfinite(logits).all())
          and bool(((gen_ssm >= 0) & (gen_ssm < V)).all()),
          "xlstm decode gave non-finite logits or tokens out of range")
    peak_prefill = torch.cuda.max_memory_allocated()
    say(f"SSM path: Model.prefill 4 x 2048 tokens in {t_prefill:.2f} s "
        f"({4 * 2048 / t_prefill:.0f} tok/s), K4 logspace launches "
        f"{ssm_launches['tile_scan_logspace']} = {n_mlstm} mLSTM layers x "
        f"1 prefill; 32 decode steps x 4 rows in {t_decode:.2f} s "
        f"({4 * 32 / t_decode:.1f} tok/s); peak memory "
        f"{peak_prefill / 2**30:.2f} GiB [{card}]")

    xreqs = []
    for i in range(16):
        plen = int(xrng.randint(64, 2049))
        xreqs.append(Request(rid=i, prompt=xrng.randint(
            3, V, size=plen).astype(np.int32),
            max_new=int(xrng.randint(16, 65))))
    # the first XLSTM_REQUESTS of the 16 drawn (the rest keep the later
    # phases' inputs as they were): the engine's host time bounds the run
    xreqs = xreqs[:XLSTM_REQUESTS]
    del xcache
    free_card(torch)
    _build.reset_launches()
    xmodel.calls = dict.fromkeys(xmodel.calls, 0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xce = ContinuousEngine(xmodel, xparams, EngineConfig(
        max_batch=8, max_seq=2048, decode_tick=8, page_size=32, eos_id=7))
    check(xce._state_slots and all(xce._slot_span(r) == 32 for r in xreqs),
          "xlstm requests do not span one state slot (page_size)")
    for r in xreqs:
        xce.submit(r)
    xdone = drain(xce)
    torch.cuda.synchronize()
    t_xce = time.perf_counter() - t0
    peak_xce = torch.cuda.max_memory_allocated()
    eng_launches = _build.launches()
    check(len(xdone) == len(xreqs), f"served {len(xdone)}/{len(xreqs)} "
          f"xlstm requests")
    for r in xdone.values():
        res = np.asarray(r.result)
        check(1 <= len(res) <= r.max_new and bool(
            ((res >= 0) & (res < V)).all()), f"xlstm request {r.rid}: "
            f"{len(res)} tokens for max_new {r.max_new}, or out of range")
    check(xce.telemetry.pages_per_request == 1.0
          and len(xce.pages.free) == xce.pages.num_pages
          and xce._admission.counter.value == 1
          and xce.telemetry.retired == len(xreqs),
          "state slots: pages per request != 1, or not all freed/retired")
    gen_x = sum(len(r.result) for r in xdone.values())
    say(f"SSM path: ContinuousEngine served {len(xreqs)} requests (prompts "
        f"{min(len(r.prompt) for r in xreqs)}-"
        f"{max(len(r.prompt) for r in xreqs)}), {gen_x} tokens in "
        f"{t_xce:.2f} s = {gen_x / t_xce:.1f} tok/s, "
        f"{xmodel.calls['prefill_chunk']} prefill chunks, "
        f"{xmodel.calls['decode_step']} decode steps, one page per request; "
        f"peak memory {peak_xce / 2**30:.2f} GiB [{card}]")
    say(f"SSM path: the engine launched K4 "
        f"{eng_launches['tile_scan_logspace']} times, as the reference "
        f"would: its prefill blocks are at most 256 tokens and mlstm_chunk "
        f"is 256, so every block takes the one-chunk form (the chunk-"
        f"parallel K4 form needs S > chunk); Model.prefill above runs K4")
    check(eng_launches["tile_scan_logspace"] == 0,
          "the engine's 256-token blocks reached K4 (they should not)")
    report["ssm_path"] = dict(
        prefill_s=t_prefill, decode_s=t_decode, launches=ssm_launches,
        peak_bytes_prefill=peak_prefill, engine_s=t_xce,
        engine_tokens=gen_x, engine_calls=dict(xmodel.calls),
        engine_launches=eng_launches, peak_bytes_engine=peak_xce,
        telemetry=xce.telemetry.snapshot())
    del xce

    pcache = None
    ptoks = prompts

    def ssm_prefill():
        nonlocal pcache
        pcache = None               # free the last one before the next
        _, pcache = xmodel.prefill(xparams, ptoks)

    ssm_prefill()
    dtok = torch.argmax(logits, -1).to(torch.int32)
    # the prefill profile runs one row of 512 tokens (2 chunks, K4 once per
    # mLSTM layer): its cost is the profiler's per-event work, and the
    # sLSTM loop's events grow with the sequence, not the batch
    short = prompts[:1, :512].contiguous()
    for what, fn, reps in (
            ("xlstm decode step B=4 after 2048", lambda: xmodel.decode_step(
                xparams, dtok, pcache, lengths), 5),
            ("xlstm Model.prefill B=1 S=512", lambda: xmodel.prefill(
                xparams, short), 1)):
        wall, groups = breakdown(fn, reps)
        dev_ms = sum(groups.values())
        report.setdefault("breakdown", {})[what] = dict(
            wall_ms=wall, device_ms=dev_ms, groups=groups)
        say(f"{what}, {xcfg.num_layers} blocks: wall {wall:.2f} ms, device "
            f"{dev_ms:.2f} ms (" + ", ".join(f"{g} {t:.2f}" for g, t in sorted(
                groups.items(), key=lambda kv: -kv[1])) + f") [{card}]")
    del pcache, xparams, xmodel, prompts, ptoks, short
    free_card(torch)

    # ----------------------------- 8. fp32 at xlstm's full width, one period
    x32 = dataclasses.replace(xcfg, num_layers=8, param_dtype="float32",
                              compute_dtype="float32")
    m_pal = Model(x32, device="cuda", scan_impl="pallas")
    m_lax = Model(x32, device="cuda", scan_impl="lax")
    p32 = m_pal.init(args.seed + 1)
    cpu_model = Model(x32, device="cpu", scan_impl="pallas")
    cpu_params = _tree_to(p32, "cpu")
    toks = torch.as_tensor(xrng.randint(3, V, size=(2, 512)),
                           dtype=torch.int32)
    _build.reset_launches()
    gl, gcache = m_pal.prefill(p32, toks.cuda())
    torch.cuda.synchronize()
    check(_build.launches()["tile_scan_logspace"] == 7,
          "fp32 period: K4 did not run once per mLSTM layer")
    cl, ccache = cpu_model.prefill(cpu_params, toks)
    ll, lcache = m_lax.prefill(p32, toks.cuda())
    worst_logit = err(gl.cpu(), cl)
    lengths = torch.full((2,), 512, dtype=torch.int32)
    nxt = torch.argmax(cl, -1).to(torch.int32)
    pal_toks, lax_toks = [torch.argmax(gl, -1)], [torch.argmax(ll, -1)]
    pal_logits = [gl]
    for _ in range(8):
        gl, gcache = m_pal.decode_step(p32, nxt.cuda(), gcache,
                                       lengths.cuda())
        ll, lcache = m_lax.decode_step(p32, nxt.cuda(), lcache,
                                       lengths.cuda())
        cl, ccache = cpu_model.decode_step(cpu_params, nxt, ccache, lengths)
        worst_logit = max(worst_logit, err(gl.cpu(), cl))
        nxt, lengths = torch.argmax(cl, -1).to(torch.int32), lengths + 1
        pal_toks.append(torch.argmax(gl, -1))
        lax_toks.append(torch.argmax(ll, -1))
        pal_logits.append(gl)
    say(f"fp32 xlstm logits, card (K4) vs CPU plain path (8 blocks, prefill "
        f"2 x 512 + 8 decode steps): max abs err {worst_logit:.3g} (tol "
        f"{LOGIT_TOL})")
    check(worst_logit <= LOGIT_TOL, "card xlstm logits disagree with the CPU")
    pal_toks, lax_toks = torch.stack(pal_toks, 1), torch.stack(lax_toks, 1)
    ssm_ties = 0
    for row in range(2):
        diff = (pal_toks[row] != lax_toks[row]).nonzero()
        if len(diff):
            t = int(diff[0])
            top2 = torch.topk(pal_logits[t][row, :V], 2).values
            gap = float(top2[0] - top2[1])
            say(f"row {row}: pallas and lax tokens differ at step {t}; "
                f"top-2 logit gap there {gap:.3g}")
            check(gap < NEAR_TIE, f"row {row}: pallas/lax divergence is not "
                  f"a near-tie (gap {gap:.3g} >= {NEAR_TIE})")
            ssm_ties += 1
    say(f"fp32 scan_impl='pallas' == 'lax' tokens for {2 - ssm_ties}/2 rows "
        f"x 9 tokens ({ssm_ties} near-ties)")
    del cpu_model, cpu_params, ccache, gcache, lcache, m_lax

    # one request per engine (max_batch=1) against all through 3 lanes: the
    # continuous engine pads each prompt alone, so a request's recurrent
    # state does not depend on its neighbours
    lens6, news6 = (40, 300, 77, 520, 129, 260), (10, 6, 14, 8, 12, 5)
    reqs6 = [(xrng.randint(3, V, size=n).astype(np.int32), mn)
             for n, mn in zip(lens6, news6)]

    def serve6(max_batch, **kw):
        eng = ContinuousEngine(m_pal, p32, EngineConfig(
            max_batch=max_batch, eos_id=7, max_seq=1024, decode_tick=4,
            page_size=32, **kw))
        for i, (pr, mn) in enumerate(reqs6):
            eng.submit(Request(rid=i, prompt=pr, max_new=mn))
        return {rid: np.asarray(r.result)
                for rid, r in drain(eng).items()}, eng

    alone, _ = serve6(1)
    batched, _ = serve6(3)
    gated, geng = serve6(3, exit_entropy=math.log(V) + 0.5, exit_patience=3)
    ties = 0
    for rid, (pr, _) in enumerate(reqs6):
        a, b = batched[rid], alone[rid]
        if np.array_equal(a, b):
            continue
        t = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                 min(len(a), len(b)))
        # the engine's state at step t: the prompt (whose last real
        # position gives token 0), its pad tokens, then tokens 0..t-1
        padded = np.pad(pr, (0, -(-len(pr) // 32) * 32 - len(pr)))
        ctx = pr if t == 0 else np.concatenate([padded, b[:t]])
        logits, _ = m_pal.prefill(p32, torch.as_tensor(
            ctx.astype(np.int32)[None], device="cuda"))
        top2 = torch.topk(logits[0, :V], 2).values
        gap = float(top2[0] - top2[1])
        say(f"xlstm request {rid}: batched and one-at-a-time tokens differ "
            f"at step {t}; top-2 logit gap there {gap:.3g}")
        check(gap < NEAR_TIE, f"xlstm request {rid}: divergence is not a "
              f"near-tie (gap {gap:.3g} >= {NEAR_TIE})")
        ties += 1
    check(geng.telemetry.early_exits > 0, "the entropy gate never fired")
    for rid in batched:
        g = gated[rid]
        check(np.array_equal(g, batched[rid][:len(g)]),
              f"xlstm request {rid}: gated stream {g.tolist()} is not a "
              f"prefix of {batched[rid].tolist()}")
    say(f"fp32 xlstm ContinuousEngine (3 lanes) == one-at-a-time tokens for "
        f"{len(reqs6) - ties}/{len(reqs6)} requests ({ties} near-ties); "
        f"gated (tau ln V + 0.5, patience 3): {geng.telemetry.early_exits} "
        f"early exits, every gated stream an exact prefix")
    report["fp32_ssm"] = dict(max_logit_err=worst_logit,
                              pallas_lax_ties=ssm_ties, near_ties=ties,
                              early_exits=geng.telemetry.early_exits)
    del m_pal, p32
    free_card(torch)

    # --------------------- 9. the Mamba layer path at jamba-1.5-large width
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.ssm import mamba_forward, mamba_init
    mcfg = ModelConfig(
        name="jamba-1.5-large-398b Mamba layer", family="hybrid",
        num_layers=1, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=24576, vocab_size=65536, block_pattern=("mamba",),
        ssm_state_dim=16, ssm_expand=2, ssm_conv_dim=4, mlstm_chunk=256)
    mparams = mamba_init(torch.Generator(device=dev).manual_seed(
        args.seed + 2), mcfg)
    xm = randn(1, 512, mcfg.d_model, dtype=bf)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ym, stm = mamba_forward(mparams, mcfg, xm, scan_impl="pallas")
    torch.cuda.synchronize()
    t_mamba = time.perf_counter() - t0
    mamba_launches = _build.launches()
    yl, stl = mamba_forward(mparams, mcfg, xm, scan_impl="lax")
    torch.cuda.synchronize()
    e_y = err(ym, yl) / float(yl.float().abs().max())
    e_h = err(stm["ssm"], stl["ssm"]) / float(stl["ssm"].abs().max())
    check(mamba_launches["tile_scan_affine"] == 2,
          f"Mamba layer: K4 affine launches "
          f"{mamba_launches['tile_scan_affine']} != 2 chunks")
    check(e_y <= TOL["bfloat16"] and e_h <= 1e-4,
          f"Mamba layer pallas vs lax: output {e_y:.3g} (tol "
          f"{TOL['bfloat16']}), state {e_h:.3g} (tol 1e-4), relative")
    say(f"Mamba layer path (d_model 8192, Di 16384, N 16, 512 tokens, "
        f"bf16): K4 affine launches {mamba_launches['tile_scan_affine']} = "
        f"2 chunks, {t_mamba * 1e3:.1f} ms; pallas vs lax relative err: "
        f"output {e_y:.3g}, final state {e_h:.3g} [{card}]")
    report["mamba_layer"] = dict(launches=mamba_launches, wall_s=t_mamba,
                                 rel_err_output=e_y, rel_err_state=e_h)
    del mparams, xm, ym, yl, stm, stl
    free_card(torch)

    # -------------------- 10. the MoE path: llama4-scout, 12 layers, bf16
    moe_launches = moe_path(np, torch, dev, args.seed, card, report,
                            breakdown, drain)

    # ----------------------------- 11. fp32 at the MoE path's width, 1 layer
    moe_fp32(np, torch, args.seed, report, drain)

    # ------------------ 12. the MLA path: deepseek-v2-lite-16b, 27 layers
    mla_launches = mla_path(np, torch, dev, args.seed, card, report,
                            breakdown, drain)

    # ------------------------------ 13. fp32 at deepseek's width, 2 layers
    mla_fp32(np, torch, args.seed, report, drain)

    # ------ 14. the dense configs: yi-9b, chatglm3-6b, minitron-4b, full
    dense_configs_path(np, torch, args.seed, card, report, drain)

    # ----- 15-16. the encoder-decoder and image cross-attention paths, and
    # their fp32 checks
    cross_launches = {}
    for arch in (WHISPER_ARCH, VISION_ARCH):
        cross_launches[arch] = cross_path(np, torch, dev, args.seed, card,
                                          report, breakdown, arch)
        cross_fp32(np, torch, args.seed, report, arch)

    # --------------------------------------------------------- 17. report
    # the standalone combine serves v1 only: its launches are the fp32
    # dense engine's (phase 6)
    path_launches_by_kernel = {
        **launches, "tile_scan_logspace": ssm_launches["tile_scan_logspace"],
        "tile_scan_affine": mamba_launches["tile_scan_affine"],
        "flash_decode_combine": fp32_launches["flash_decode_combine"],
        "flash_attention_fwd (192, 128)": mla_launches["k1"],
        "flash_attention_fwd (non-causal)": sum(
            c["noncausal"] for c in cross_launches.values()),
        "flash_decode_partials (group 1)": sum(
            c["group1"] for c in cross_launches.values())}
    rows["flash_attention_fwd (192, 128)"] = report["timings"][
        "flash_attention_fwd c=2048 off=0 H=16 KV=16 B=4 hd=(192, 128)"]
    rows.update(cross_rows)
    rows["flash_decode_partials"] = dict(
        rows["flash_decode_partials"], other_shapes={
            "B=4 S=1601 32/8, every row full (vision's cross decode)": v4})
    kernels = []
    meta = {
        "flash_attention_fwd": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:72"),
        "flash_attention_fwd (192, 128)": K1_MLA,
        "flash_attention_fwd (non-causal)": K1_MLA,
        "flash_attention_merge": ("src/repro_torch/csrc/flash_attention.cu",
                                  "src/repro/kernels/flash_attention.py:72"),
        "flash_decode_partials": ("src/repro_torch/csrc/flash_decode.cu",
                                  "src/repro/kernels/flash_decode.py:53"),
        "flash_decode_combine": ("src/repro_torch/csrc/flash_decode.cu",
                                 "src/repro/kernels/flash_decode.py:94"),
        "flash_decode_partials (group 1)": (
            "src/repro_torch/csrc/flash_decode.cu",
            "src/repro/kernels/flash_decode.py:53"),
        "tile_scan_logspace": ("src/repro_torch/csrc/tile_scan.cu",
                               "src/repro/kernels/tile_scan.py:181"),
        "tile_scan_affine": ("src/repro_torch/csrc/tile_scan.cu",
                             "src/repro/kernels/tile_scan.py:181"),
    }
    for name, (source, replaces) in meta.items():
        row = rows[name]
        if name in k4_worst:
            w = k4_worst[name]
            errs = {"max_abs_err": w["abs"], "max_err": w["abs"],
                    "max_rel_err": w["rel"], "tol": K4_TOL,
                    "tol_kind": "relative", "max_abs_err_fp32": w["abs"]}
        else:
            w = dict(worst[{"flash_decode_partials (group 1)":
                            "flash_decode (fused, group 1)"}.get(name, name)])
            if name == "flash_decode_partials":   # its launch is the fused one
                w["bfloat16"] = max(w["bfloat16"],
                                    worst["flash_decode (fused)"]["bfloat16"])
            main_dtype = "bfloat16"
            errs = {"max_abs_err": w[main_dtype], "max_err": w[main_dtype],
                    "tol": TOL[main_dtype],
                    "max_abs_err_fp32": w.get("float32")}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": path_launches_by_kernel[name], **errs,
            "ms": row["ms"], "kernel_ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_computes": row.get("library_computes"),
            "shape": row["shape"],
            **({"route_at_shape": row["route"]} if "route" in row else {}),
            **({"launches_from": "fp32 dense ContinuousEngine (v1 route)"}
               if name == "flash_decode_combine" else {}),
            **({"launches_from": f"{MLA_ARCH} Model.prefill 4 x 2048"}
               if name == "flash_attention_fwd (192, 128)" else {}),
            **({"launches_from": f"{WHISPER_ARCH} and {VISION_ARCH}: "
                                 f"Model.prefill, chunked prefill, decode"}
               if name in cross_rows else {}),
            **({"other_shapes": row["other_shapes"]}
               if "other_shapes" in row else {}),
            **({"fused_split_launches": n_fused}
               if name == "flash_attention_fwd" else {})})
    kernels += sort_kernel_entries(sort_rows, sort_errs, sort_launches)
    kernels += moe_kernel_entries(moe_rows, moe_errs, moe_launches)
    report["kernels"] = kernels
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# the stable sort: K5, K6a, K6b, K7a, K7b, K8
# ---------------------------------------------------------------------------

# kernel → (source, the TPU kernel it replaces)
SORT_META = {
    "tile_scan_add": ("src/repro_torch/csrc/tile_scan.cu",
                      "src/repro/kernels/tile_scan.py:59"),
    "radix_mt_local": ("src/repro_torch/csrc/radix_sort.cu",
                       "src/repro/kernels/radix_sort.py:391"),
    "radix_mt_scatter": ("src/repro_torch/csrc/radix_sort.cu",
                         "src/repro/kernels/radix_sort.py:409"),
    "radix_tile_sort": ("src/repro_torch/csrc/radix_sort.cu",
                        "src/repro/kernels/radix_sort.py:224"),
    "radix_tile_sort_packed": ("src/repro_torch/csrc/radix_sort.cu",
                               "src/repro/kernels/radix_sort.py:253"),
    "merge_level": ("src/repro_torch/csrc/merge_sort.cu",
                    "src/repro/kernels/merge_sort.py:270"),
}


# K7b v2's instances whose attributes phase 2 reads: (tile, tiles, key
# bits, threads a CTA or None for the rule); tile 1024 at 1, 32 and 1024
# tiles is the path's (cases (g), (e), (d))
K7B_ATTR_CASES = (
    (1024, 1024, 12, None), (1024, 32, 17, None), (1024, 1, 12, None),
    (1024, 1, 12, 128), (1024, 1, 12, 512), (1024, 1, 12, 1024),
    (1024, 1024, 8, None), (1024, 1, 24, None), (2, 1, 12, None),
    (128, 1, 12, None), (256, 1, 12, None), (512, 1, 12, None),
    (256, 1024, 12, None), (8192, 1, 17, None), (8192, 1024, 17, None))


def k7b_label(tile, nt, bits, threads):
    return f"tile {tile}, {nt} tiles, {bits} bits" + (
        f", {threads} threads" if threads else "")


def _flip(torch, words):
    """uint32 words as int32 with the top bit flipped: signed order of the
    result is the unsigned order of the words (for the library sorts)."""
    return words.view(torch.int32) ^ torch.iinfo(torch.int32).min


def _mismatch(torch, got, want):
    """Largest |got - want| over the values as int64; -1 if shape or dtype
    differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return -1
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def sort_kernel_rows(np, torch, dev, seed, device_ms, card, report):
    """Phase 2, the sort's kernels: each against its plain twin at the sort
    path's shapes (bit for bit: integer data, tolerance 0 mismatches), then
    kernel, twin and library call timed after an L2 flush."""
    from repro_torch.kernels import merge_sort as ms
    from repro_torch.kernels import radix_sort as rs
    from repro_torch.kernels import tile_scan as ts
    rng = np.random.RandomState(seed + 13)
    errs = dict.fromkeys(SORT_META, 0)

    def same(kernel, got, want, **case):
        torch.cuda.synchronize()
        e = _mismatch(torch, got, want)
        report["cases"].append(dict(kernel=kernel, max_abs_err=e, tol=0,
                                    dtype=str(got.dtype).split(".")[-1],
                                    **case))
        errs[kernel] = max(errs[kernel], abs(e))
        check(e == 0, f"{kernel} {case}: kernel and twin differ (max abs "
              f"err {e}; -1 = shape or dtype)")

    def ints(n, bits):
        return torch.as_tensor(rng.randint(0, 1 << bits, n).astype(np.int32),
                               device=dev)

    def words(n):
        w = rng.randint(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        w[1::2] = w[::2]                    # every word twice: ties
        return torch.as_tensor(w, device=dev)

    n, tile = 1 << 20, 1024
    nt, ib = n // tile, 20
    keys = ints(n, 12)                      # case (a) / (d): 12-bit keys
    # K6a, K5, K6b: every pass held to its twin and to a second launch,
    # bit for bit
    def k6_pass(x, *, nt, tile, shift, bits, pack, idx_bits, um=None,
                **case):
        kw = dict(nt=nt, tile=tile, shift=shift, bits=bits, pack=pack,
                  idx_bits=idx_bits)
        case = dict(n=nt * tile, tile=tile, shift=shift, bits=bits, **case)
        local, hist = rs._mt_local(x, **kw)
        plocal, phist = rs.mt_local_plain(x, **kw)
        same("radix_mt_local", local, plocal, pack=pack, **case)
        same("radix_mt_local", hist, phist, what="histogram", **case)
        again = rs._mt_local(x, **kw)
        check(torch.equal(again[0], local) and torch.equal(again[1], hist),
              f"K6a {case}: two launches on one input differ")
        base = ts.histogram_offsets(hist)
        same("tile_scan_add", base, ts.histogram_offsets_plain(hist),
             what="histogram_offsets", nt=nt, radix=1 << bits)
        skw = dict(tile=tile, radix=1 << bits, unpack_mask=um)
        out = rs._mt_scatter(local, hist, base, **skw)
        pout = rs.mt_scatter_plain(local, hist, base, tile=tile,
                                   unpack_mask=um)
        same("radix_mt_scatter", out, pout, unpack=um is not None, **case)
        check(torch.equal(rs._mt_scatter(local, hist, base, **skw), out),
              f"K6b {case}: two launches on one input differ")
        return local, hist, base, out

    def k6_sort(k, idx_bits, num_key_bits, **case):
        """The multi-tile passes of ``k`` (4-bit digits, tile 1024), each
        pass held as above; the order against torch.argsort(stable=True).
        Returns each pass's input, arguments and outputs."""
        passes, x = [], k
        shifts = range(idx_bits, idx_bits + num_key_bits, 4)
        for p, shift in enumerate(shifts):
            um = (1 << idx_bits) - 1 if p == len(shifts) - 1 else None
            kw = dict(nt=k.numel() // 1024, tile=1024, shift=shift, bits=4,
                      pack=p == 0, idx_bits=idx_bits)
            local, hist, base, out = k6_pass(x, um=um, **kw, **case)
            passes.append(dict(x=x, kw=kw, um=um, local=local, hist=hist,
                               base=base))
            x = out
        check(torch.equal(x.to(torch.int64), torch.argsort(k, stable=True)),
              f"the K6a/K5/K6b passes of {case} are not the stable argsort")
        return passes

    n, tile = 1 << 20, 1024
    nt, ib = n // tile, 20
    mask = (1 << ib) - 1
    keys = ints(n, 12)                      # case (a) / (d): 12-bit keys
    passes_a = k6_sort(keys, ib, 12, input="case (a)")
    hist0 = passes_a[0]["hist"]
    # the skewed inputs of case (a)'s size, the sort path's pad included
    skewed = {"all-equal": torch.full_like(keys, 1234),
              "one-digit": (keys & ~15) | 5,
              "sorted": torch.sort(keys).values,
              "reversed": torch.sort(keys).values.flip(0),
              "sentinel-padded": torch.where(
                  torch.arange(n, device=dev) >= n - n // 3, 4095, keys)}
    for kind, k in skewed.items():
        k6_sort(k.contiguous(), ib, 12, input=kind)
    # case (c)'s shape: 2^24 8-bit keys, two passes
    nc = 1 << 24
    keys_c = ints(nc, 8)
    passes_c = k6_sort(keys_c, 24, 8, input="case (c)")
    # K5 (v2, one cluster) beyond the path's histograms: ragged row blocks,
    # blocks empty under a forced cluster, radix 4 to 256, and the 1-D scan
    # both ways (misaligned too: scalar loads); two launches bit-identical
    for nt_, r_ in ((1, 16), (7, 16), (192, 4), (192, 16), (1024, 16),
                    (16384, 16), (128, 256)):
        h = ints(nt_ * r_, 10).reshape(nt_, r_)
        want = ts.histogram_offsets_plain(h)
        got = ts.histogram_offsets(h)
        same("tile_scan_add", got, want, what="histogram_offsets", nt=nt_,
             radix=r_)
        for cl in (1, 3, ts.MAX_CLUSTER):
            same("tile_scan_add", ts._scan_add(h, nt_, r_, False, cluster=cl),
                 want, what="histogram_offsets", nt=nt_, radix=r_,
                 cluster=cl)
        check(torch.equal(got, ts.histogram_offsets(h)), f"K5 ({nt_} x "
              f"{r_}): two launches on the same input differ")
    hist_c = ints(16384 * 16, 10).reshape(16384, 16)   # case (c)'s shape
    for n1 in (1, 4097, 1_000_003):
        flat = ints(n1, 8)
        for inclusive in (False, True):
            same("tile_scan_add", ts.tile_scan(flat, inclusive=inclusive),
                 ts.scan_plain(flat, inclusive=inclusive), what="tile_scan",
                 n=n1, inclusive=inclusive)
        odd = ints(n1 + 1, 8)[1:]                      # 4 bytes off 16
        same("tile_scan_add", ts.tile_scan(odd), ts.scan_plain(odd),
             what="tile_scan misaligned", n=n1)
    # K7b (v2, the route): case (d)'s tile phase, case (e)'s (2^15 17-bit
    # keys) and case (g)'s single tile with unpack, then the CPU tests'
    # shapes at 2 tiles (fewer than the SMs: 256-thread CTAs from tile 256
    # up) and at 132 (K7a's CTAs): every tile 2-8192, 1-24 key bits (24 reach past bit 32 of the
    # composite at tile 1024), packed and unpacked, ragged n; skewed keys;
    # each v2 launch == the twin == v1 (`v1=True`, kept as the design v2
    # is timed against), every CTA width built at tile 1024 too, and two
    # launches bit-identical
    def k7b_case(k, n_, t_, bits, unpack=False, **case):
        kw_ = dict(n=n_, tile=t_, num_key_bits=bits,
                   idx_bits=max(1, (n_ - 1).bit_length()), unpack=unpack)
        want = rs.radix_tile_sort_packed_plain(
            k, n=n_, tile=t_, idx_bits=kw_["idx_bits"], sort_bits=bits,
            unpack=unpack)
        case = dict(n=n_, n_pad=k.numel(), tile=t_, num_key_bits=bits,
                    unpack=unpack, **case)
        got = rs.radix_tile_sort_packed(k, **kw_)
        same("radix_tile_sort_packed", got, want, **case)
        same("radix_tile_sort_packed", rs.radix_tile_sort_packed(
            k, v1=True, **kw_), want, v1=True, **case)
        if t_ == 1024:
            for th in (128, 256, 512, 1024):
                same("radix_tile_sort_packed", rs.radix_tile_sort_packed(
                    k, threads=th, **kw_), want, threads=th, **case)
        check(torch.equal(rs.radix_tile_sort_packed(k, **kw_), got),
              f"K7b {case}: two launches on the same input differ")
        return got

    kw = dict(n=n, tile=tile, num_key_bits=12, idx_bits=ib)
    packed = k7b_case(keys, n, tile, 12, input="case (d)")
    keys_e = ints(1 << 15, 17)
    k7b_case(keys_e, 1 << 15, tile, 17, input="case (e)")
    keys_g = torch.cat([keys[:1000], torch.full((24,), 4095,
                                                dtype=torch.int32,
                                                device=dev)])
    k7b_case(keys_g, 1000, tile, 12, unpack=True, input="case (g)")
    for t_ in (2, 16, 32, 128, 1024, 8192):
        for nt_ in (2, 132):
            n_pad = t_ * nt_
            for bits in (1, 4, 8, 12, 17, 24):
                k = ints(n_pad, bits)
                n_ = n_pad - n_pad // 6
                k[n_:] = (1 << bits) - 1            # pad rows: the max key
                for unpack in (False, True):
                    k7b_case(k, n_, t_, bits, unpack)
    for t_ in (32, 1024):
        k = ints(2 * t_, 12)
        for kind, k_ in (("equal", torch.full_like(k, 2048)),
                         ("sorted", torch.sort(k).values),
                         ("reversed", torch.sort(k).values.flip(0)),
                         ("7-valued", k[torch.as_tensor(
                             rng.randint(0, 7, 2 * t_), device=dev)])):
            k7b_case(k_.contiguous(), 2 * t_, t_, 12, kind=kind)
    # K7a: case (f)'s tile phase, random u32 with ties (every word twice),
    # then every tile size, bit range and digit width (v2 ranks 8 bits a
    # pass whatever digit_bits says), adversarial inputs, and two launches
    # bit-identical
    w = words(n)
    tiles = rs.radix_tile_sort(w, tile=tile)
    same("radix_tile_sort", tiles, rs.radix_tile_sort_plain(
        w, tile=tile, total_bits=32, key_shift=0), n=n, tile=tile)
    check(torch.equal(tiles, rs.radix_tile_sort(w, tile=tile)),
          "K7a: two launches on the same input differ")
    for t7 in (1, 4, 64, 256, 1024, 8192):
        wt7 = w[:max(64 * t7, 1 << 16)]
        for tb in (0, 7, 12, 32):
            for ks in (0, 4, 20):
                want = rs.radix_tile_sort_plain(wt7, tile=t7, total_bits=tb,
                                                key_shift=ks)
                for db in (2, 4, 8):
                    same("radix_tile_sort", rs.radix_tile_sort(
                        wt7, tile=t7, total_bits=tb, key_shift=ks,
                        digit_bits=db), want, tile=t7, total_bits=tb,
                        key_shift=ks, digit_bits=db)
    srt = torch.sort(_flip(torch, w)).values
    srt = _flip(torch, srt).view(torch.uint32)
    for kind, x7 in (("all-equal", torch.full_like(w, 0x9e3779b9)),
                     ("sorted", srt), ("reverse-sorted", srt.flip(0))):
        for t7 in (1024, 8192):
            same("radix_tile_sort", rs.radix_tile_sort(x7, tile=t7),
                 rs.radix_tile_sort_plain(x7, tile=t7, total_bits=32,
                                          key_shift=0), tile=t7, kind=kind)
    # K8: the first level after each tile phase, and a last level (two
    # sorted halves of 2^19) with the fused unpack
    for src, what in ((packed, "argsort words"), (tiles, "u32 with ties")):
        same("merge_level", ms._merge_level(src, run=tile, tile=tile),
             ms.merge_level_plain(src, run=tile), what=what, run=tile)
    # the largest tile (8192 words: above 48 KB of shared memory) with
    # 8-bit digits (radix 256), off the path's defaults but accepted
    big_tile, nt8 = 1 << 13, n >> 13
    local8, hist8, base8, _ = k6_pass(keys, nt=nt8, tile=big_tile, shift=ib,
                                      bits=8, pack=True, idx_bits=ib,
                                      input="tile 8192, radix 256")
    tiles8 = rs.radix_tile_sort(w, tile=big_tile, digit_bits=8)
    same("radix_tile_sort", tiles8, rs.radix_tile_sort_plain(
        w, tile=big_tile, total_bits=32, key_shift=0), tile=big_tile,
         digit_bits=8)
    same("merge_level", ms._merge_level(tiles8, run=big_tile,
                                        tile=big_tile),
         ms.merge_level_plain(tiles8, run=big_tile), run=big_tile,
         block=ms.MAX_BLOCK)
    halves = torch.sort(_flip(torch, packed).reshape(2, n // 2),
                        dim=1).values
    halves = _flip(torch, halves).view(torch.uint32).reshape(n)
    same("merge_level", ms._merge_level(halves, run=n // 2, tile=tile,
                                        unpack_mask=mask),
         ms.merge_level_plain(halves, run=n // 2, unpack_mask=mask),
         what="last level", run=n // 2, unpack=True)

    # K8 v2 (the route above) beyond those: v1 (kept as the route v2 is
    # timed against) on the same words, run 2^14, all-equal, sorted and
    # reversed pairs, sentinel-padded runs, the four 8192-word levels of
    # the MoE path's argsort, and two launches bit-identical
    def runs_of(words, run):
        srt = torch.sort(_flip(torch, words).reshape(-1, run), dim=1).values
        return _flip(torch, srt).view(torch.uint32).reshape(-1)

    same("merge_level", ms._merge_level(packed, run=tile, tile=tile,
                                        v1=True),
         ms.merge_level_plain(packed, run=tile), what="v1", run=tile)
    runs14 = runs_of(w, 1 << 14)
    same("merge_level", ms._merge_level(runs14, run=1 << 14, tile=tile),
         ms.merge_level_plain(runs14, run=1 << 14), run=1 << 14)
    moe_keys = (torch.as_tensor(rng.randint(0, 16, 8192), device=dev)
                << 13) | torch.arange(8192, device=dev)
    moe_words = moe_keys.to(torch.int32).view(torch.uint32)

    def k8_case(kind, words, r_):
        """Words in sorted runs of r_: all equal, the whole input sorted,
        each run above the next (the most skewed split), or a third of the
        words the pad sentinel (sorted to each run's tail)."""
        if kind == "all-equal":
            return torch.full_like(words, 0x9E3779B9)
        if kind == "sorted":
            return runs_of(words, words.numel())
        if kind == "reversed":
            return runs_of(words, words.numel()).reshape(-1, r_).flip(
                0).reshape(-1)
        third = torch.arange(words.numel(), device=dev) % 3 == 0
        signed = torch.where(third, -1, words.view(torch.int32))
        return runs_of(signed.view(torch.uint32), r_)

    kinds = ("all-equal", "sorted", "reversed", "sentinel-padded")
    k8_inputs = [(kind, k8_case(kind, w, tile), tile) for kind in kinds]
    k8_inputs += [(f"MoE level run {r_}", runs_of(moe_words, r_), r_)
                  for r_ in (512, 1024, 2048, 4096)]
    k8_inputs += [(f"MoE level run {r_}, {kind}", k8_case(kind, moe_words,
                                                          r_), r_)
                  for r_ in (512, 4096) for kind in kinds]
    for what, x8, r_ in k8_inputs:
        for v1 in (False, True):
            same("merge_level", ms._merge_level(x8, run=r_, tile=min(r_, 512),
                                                v1=v1),
                 ms.merge_level_plain(x8, run=r_), what=what, run=r_,
                 n=x8.numel(), v1=v1)
    check(torch.equal(ms._merge_level(runs14, run=1 << 14, tile=tile),
                      ms._merge_level(runs14, run=1 << 14, tile=tile)),
          "K8 v2: two launches on the same input differ")

    # timing (CUDA graphs, inputs read after an L2 flush) at the path's
    # shapes; bound = each input read once, each output written once
    def row(kernel_fn, plain_fn, library_fn, nbytes, shape, computes=None):
        r = dict(ms=device_ms(kernel_fn, cold=True),
                 plain_ms=device_ms(plain_fn, cold=True),
                 library_ms=None if library_fn is None
                 else device_ms(library_fn, cold=True),
                 library_computes=computes,
                 bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                 shape=shape)
        return r

    def median3(fn):
        """The median of three readings: one reading of the
        flush-subtracting harness can come out far off."""
        return sorted(device_ms(fn, cold=True) for _ in range(3))[1]

    def k6_rows():
        """K6a and K6b: the kernel (the median of three), the twin, the
        library call where one computes the same, and a copy of the
        kernel's input (what this harness gets from the card's memory for
        the same bytes in and out), at case (a)'s first and last pass (the
        first is the row) and case (c)'s."""
        out = {"radix_mt_local": {}, "radix_mt_scatter": {}}
        for label, pas in (("2^20 pass 0 (pack)", passes_a[0]),
                           ("2^20 last pass (unpack)", passes_a[-1]),
                           ("2^24 pass 0 (pack)", passes_c[0]),
                           ("2^24 last pass (unpack)", passes_c[-1])):
            x, kw, um = pas["x"], pas["kw"], pas["um"]
            local, hist, base = pas["local"], pas["hist"], pas["base"]
            n_, R_ = local.numel(), hist.numel()
            wd = rs._u64(x)
            if kw["pack"]:
                wd = rs._shl(wd, kw["idx_bits"]) | torch.arange(n_,
                                                                device=dev)
            digits = (rs._shr(wd, kw["shift"]) & 15).to(torch.int32)
            digits = digits.reshape(kw["nt"], kw["tile"])
            shape = dict(n=n_, tile=kw["tile"], bits=kw["bits"],
                         pack=kw["pack"], unpack=um is not None, what=label)
            skw = dict(tile=kw["tile"], radix=16, unpack_mask=um)
            fns = {
                "radix_mt_local": (
                    lambda: rs._mt_local(x, **kw),
                    lambda: rs.mt_local_plain(x, **kw),
                    lambda: torch.sort(digits, dim=1, stable=True), x,
                    4.0 * (2 * n_ + R_),
                    "per-tile stable sort of the pass digit (digits "
                    "precomputed)"),
                "radix_mt_scatter": (
                    lambda: rs._mt_scatter(local, hist, base, **skw),
                    lambda: rs.mt_scatter_plain(local, hist, base,
                                                tile=kw["tile"],
                                                unpack_mask=um),
                    None, local, 4.0 * (2 * n_ + 2 * R_), None)}
            for name, (fn, plain, lib, src, nbytes, computes) in fns.items():
                out[name][label] = dict(
                    ms=median3(fn), plain_ms=device_ms(plain, cold=True),
                    library_ms=None if lib is None
                    else device_ms(lib, cold=True),
                    library_computes=computes,
                    copy_ms=device_ms(lambda: src.clone(), cold=True),
                    bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                    shape=shape)
        return out

    k6 = k6_rows()

    def k7b_row(k, bits, n_):
        """K7b v2 (the median of three), the twin and the per-row library
        sort; v2 against v1 and over CTA widths in turns:
        ``tools/version_turns.py``."""
        kw_ = dict(n=n_, tile=tile, num_key_bits=bits,
                   idx_bits=max(1, (n_ - 1).bit_length()))
        width, passes = rs.k7b_digits(bits, tile)
        return dict(
            ms=median3(lambda: rs.radix_tile_sort_packed(k, **kw_)),
            plain_ms=device_ms(
                lambda: rs.radix_tile_sort_packed_plain(
                    k, n=n_, tile=tile, idx_bits=kw_["idx_bits"],
                    sort_bits=bits), cold=True),
            library_ms=device_ms(lambda: torch.sort(
                k.reshape(-1, tile), dim=1, stable=True), cold=True),
            library_computes="per-tile stable sort of the keys, with "
            "indices",
            bound_ms=4.0 * 2 * k.numel() / PEAK_BYTES * 1e3,
            bound_by="bytes",
            shape=dict(n=k.numel(), tile=tile, num_key_bits=bits,
                       passes=passes, digit_bits=width,
                       threads=rs.k7b_shape(tile, k.numel() // tile)[1]))

    hist_dm = hist0.t().contiguous().reshape(-1)
    fw, fp = _flip(torch, w).reshape(nt, tile), _flip(torch, packed)
    R = nt * 16
    rows = {
        "tile_scan_add": row(
            lambda: ts.histogram_offsets(hist0),
            lambda: ts.histogram_offsets_plain(hist0),
            lambda: torch.cumsum(hist_dm, 0),
            4.0 * 2 * R, dict(nt=nt, radix=16, what="histogram_offsets"),
            "cumsum of the histogram already laid out digit-major"),
        "radix_tile_sort": row(
            lambda: rs.radix_tile_sort(w, tile=tile),
            lambda: rs.radix_tile_sort_plain(w, tile=tile, total_bits=32,
                                             key_shift=0),
            lambda: torch.sort(fw, dim=1, stable=True),
            4.0 * 2 * n, dict(n=n, tile=tile, total_bits=32, passes=4,
                              digit_bits=8),
            "per-tile stable sort of the words (top bit flipped, int32)"),
    }

    def k8_row(x8, run, um, computes=None, library_fn=None, t8=tile):
        """K8 v2, the twin and, where given, the library call; v2 against
        v1 in turns: ``tools/version_turns.py``."""
        return dict(
            ms=device_ms(lambda: ms._merge_level(
                x8, run=run, tile=t8, unpack_mask=um), cold=True),
            plain_ms=device_ms(lambda: ms.merge_level_plain(
                x8, run=run, unpack_mask=um), cold=True),
            library_ms=None if library_fn is None
            else device_ms(library_fn, cold=True),
            library_computes=computes,
            bound_ms=4.0 * 2 * x8.numel() / PEAK_BYTES * 1e3,
            bound_by="bytes",
            shape=dict(n=x8.numel(), run=run, unpack=um is not None,
                       block=ms.k8_block(x8.numel(), run)))

    for name, per in k6.items():
        first, *rest = per
        rows[name] = dict(per[first], other_shapes={k: per[k] for k in rest})
    rows["radix_tile_sort_packed"] = dict(k7b_row(keys, 12, n), other_shapes={
        "2^15 17-bit keys (case (e))": k7b_row(keys_e, 17, 1 << 15),
        "one tile of 1024 12-bit keys": k7b_row(keys[:tile], 12, tile)})
    rows["merge_level"] = k8_row(
        packed, tile, None, "sort of each 2-run row (top bit flipped, int32)",
        lambda: torch.sort(fp.reshape(n // (2 * tile), 2 * tile), dim=1))
    last = k8_row(halves, n // 2, mask)
    report["timings"]["merge_level last level run=2^19"] = last
    rows["merge_level"]["other_shapes"] = other = {
        "run 2^19, unpack (the last level)": last,
        "run 2^14": k8_row(runs14, 1 << 14, None)}
    for r_ in (512, 1024, 2048, 4096):
        other[f"MoE level, 8192 words, run {r_}"] = k8_row(
            runs_of(moe_words, r_), r_, None, t8=512)
    hist_c_dm = hist_c.t().contiguous().reshape(-1)
    hc = row(lambda: ts.histogram_offsets(hist_c),
             lambda: ts.histogram_offsets_plain(hist_c),
             lambda: torch.cumsum(hist_c_dm, 0),
             4.0 * 2 * hist_c.numel(), dict(nt=16384, radix=16),
             "cumsum of the histogram already laid out digit-major")
    report["timings"]["tile_scan_add histogram 16384 x 16"] = hc
    flat_m = ints(1_000_003, 8)                   # the 1-D scan, off the path
    h1 = row(lambda: ts.tile_scan(flat_m), lambda: ts.scan_plain(flat_m),
             lambda: torch.cumsum(flat_m, 0), 4.0 * 2 * flat_m.numel(),
             dict(n=flat_m.numel(), what="tile_scan"), "cumsum")
    report["timings"]["tile_scan_add 1-D n=1000003"] = h1
    say(f"tile_scan (1-D, n=1000003): kernel {h1['ms']:.4f} ms, plain "
        f"{h1['plain_ms']:.4f} ms, library {h1['library_ms']:.4f} ms, bound "
        f"{h1['bound_ms']:.4f} ms [{card}]")
    # the kernels' attributes
    attrs = {"tile_scan_add": {f"radix {r_}, {words} words":
                               ts.kernel_attributes(words, r_)
                               for r_, words in ((16, R), (16, hist_c.numel()),
                                                 (256, hist8.numel()),
                                                 (1, 1_000_003))},
        "radix_tile_sort": {f"tile {t7}": rs.kernel_attributes(t7)
                            for t7 in (1, 256, 1024, 8192)},
        "radix_mt_local": {
            f"tile {t6}, {b6} bits": rs.mt_local_attributes(t6, b6)
            for t6, b6 in ((1024, 4), (1024, 8), (8192, 8))},
        "radix_mt_scatter": {
            f"tile {t6}, radix {r6}": rs.mt_scatter_attributes(t6, r6)
            for t6, r6 in ((1024, 16), (8192, 256))},
        "radix_tile_sort_packed": {
            k7b_label(*c): rs.radix_tile_sort_packed_attributes(*c)
            for c in K7B_ATTR_CASES},
        "merge_level": {f"v2 block {b_}": ms.merge_level_attributes(b_)
                        for b_ in (256, 512, 1024, 2048, 4096)}}
    for kname, per in attrs.items():
        for what, a in per.items():
            extra = (f", largest cluster {a['max_cluster']} "
                     f"({a['active_clusters']} at once), the rule's "
                     f"{a['rule_cluster']} for this call"
                     if "max_cluster" in a else f", {a['threads']} threads")
            if "passes" in a:
                extra += f", {a['passes']} passes of {a['digit_bits']} bits"
            say(f"  {kname} {what}: {a['registers']} registers, "
                f"{a['spill_bytes']} spill bytes, "
                f"{a['static_smem'] + a['dynamic_smem']} bytes of shared "
                f"memory, {a['ctas_per_sm']} CTAs an SM{extra}")
    report["sort_kernel_attributes"] = attrs
    # K7b: the CPU model runs k7b_shape's and k7b_digits' tables, so they
    # must be the kernel's; the path's instances (tile 1024 at 1, 32 and
    # 1024 tiles, the rule's width) within 64 registers and no spills
    for (t7, nt7, b7, th), a in zip(K7B_ATTR_CASES,
                                    attrs["radix_tile_sort_packed"].values()):
        what = k7b_label(t7, nt7, b7, th)
        want = th or rs.k7b_shape(t7, nt7)[1]
        check(a["threads"] == want, f"K7b {what}: {a['threads']} threads a "
              f"CTA, k7b_shape says {want}")
        check((a["digit_bits"], a["passes"]) == rs.k7b_digits(b7, t7),
              f"K7b {what}: {a['passes']} passes of {a['digit_bits']} bits,"
              f" k7b_digits says {rs.k7b_digits(b7, t7)}")
        if t7 == 1024 and b7 in (12, 17) and th is None:
            check(a["registers"] <= 64 and a["spill_bytes"] == 0,
                  f"K7b {what}: {a['registers']} registers, "
                  f"{a['spill_bytes']} spill bytes (target <= 64, 0)")
    for name, r in rows.items():
        report["timings"][f"{name} {r['shape']}"] = r
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        say(f"{name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms (bytes) [{card}]")
    for name, per in k6.items():
        for what, r in per.items():
            lib = "" if r["library_ms"] is None else \
                f", library {r['library_ms']:.4f} ms"
            say(f"{name} {what} (n {r['shape']['n']}): {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms{lib}, a copy of its input "
                f"{r['copy_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"(bytes) [{card}]")
    k7b = rows["radix_tile_sort_packed"]
    for what, r in [("2^20 12-bit keys (case (d))", k7b),
                    *k7b["other_shapes"].items()]:
        say(f"radix_tile_sort_packed v2 {what}, tile {tile}: {r['ms']:.4f} "
            f"ms ({r['shape']['passes']} passes of "
            f"{r['shape']['digit_bits']} bits, {r['shape']['threads']} "
            f"threads), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms (bytes) [{card}]")
    for what, r in [("run 1024", rows["merge_level"]), *other.items()]:
        say(f"merge_level v2 {what} (n {r['shape']['n']}, block "
            f"{r['shape']['block']}): {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms (bytes) [{card}]")
    say(f"merge_level last level (run 2^19, unpack): kernel "
        f"{last['ms']:.4f} ms, plain {last['plain_ms']:.4f} ms, bound "
        f"{last['bound_ms']:.4f} ms; histogram_offsets at 16384 x 16: kernel "
        f"{hc['ms']:.4f} ms, plain {hc['plain_ms']:.4f} ms, library "
        f"{hc['library_ms']:.4f} ms, bound {hc['bound_ms']:.4f} ms [{card}]")
    say("sort kernels equal their twins bit for bit: " + ", ".join(
        f"{k} {v}" for k, v in errs.items()) + " (max abs err, tol 0)")
    return rows, errs


def sort_path(np, torch, dev, seed, card, report):
    """The sort path: ``ops.stable_argsort`` / ``argsort`` / ``sort_u32``
    on the card at sizes users run, each order against
    ``torch.argsort(stable=True)`` and the CPU twins', each case's launches
    against the expected counts.  Returns the launches of the whole run."""
    from repro_torch.core import SortSchedule, digit_passes
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import merge_sort as ms
    rng = np.random.RandomState(seed)

    def mt(p):
        return {"radix_mt_local": p, "tile_scan_add": p,
                "radix_mt_scatter": p}

    def routing():
        # deepseek-v2-lite: 64 experts, top-6, over a 8 x 4096-token
        # prefill; each token's experts are the top-6 of log p + Gumbel
        # noise, p ∝ 1 / (e + 1)
        T, E, K = 8 * 4096, 64, 6
        logp = -np.log(np.arange(1, E + 1, dtype=np.float64))
        score = logp + rng.gumbel(size=(T, E))
        return np.argsort(-score, axis=1, kind="stable")[:, :K].reshape(
            -1).astype(np.int32)

    def keys_of(n, bits, kind="random"):
        hi = 1 << bits
        if kind == "random":
            return rng.randint(0, hi, n).astype(np.int32)
        if kind == "all-equal":
            return np.full(n, 1234, np.int32)
        if kind == "sorted":
            return np.sort(rng.randint(0, hi, n)).astype(np.int32)
        if kind == "reverse-sorted":
            return np.sort(rng.randint(0, hi, n))[::-1].astype(np.int32).copy()
        return rng.choice(rng.randint(0, hi, 7), n).astype(np.int32)

    route = routing()
    big = 1 << 20
    # (label, keys, num_key_bits, strategy (None: ops.stable_argsort's
    # choice), expected launches, the reference schedule's num_launches)
    cases = [
        ("(a) 12-bit ids, 2^20", keys_of(big, 12), 12, None, mt(3)),
        ("(b) deepseek-v2-lite routing 8 x 4096 x top-6", route, 6, None,
         mt(2)),
        ("(b') the same, ragged", route[:-3], 6, None, mt(2)),
        ("(c) 8-bit keys, 2^24", keys_of(1 << 24, 8), 8, None, mt(2)),
        ("(d) 12-bit, merge", keys_of(big, 12), 12, "merge",
         {"radix_tile_sort_packed": 1, "merge_level": 10}),
        ("(e) 17-bit, auto -> merge", keys_of(1 << 15, 17), 17, None,
         {"radix_tile_sort_packed": 1, "merge_level": 6}),
        ("(g) one tile", keys_of(1000, 12), 12, None,
         {"radix_tile_sort_packed": 1}),
    ] + [(f"(a) 12-bit, 2^20, {kind}", keys_of(big, 12, kind), 12, None,
          mt(3)) for kind in ("all-equal", "sorted", "reverse-sorted",
                              "7 distinct keys")]
    # (d) under the comparison pipelines: fused=False (K9b, K7a, K8 levels,
    # K9c) and method="bitonic" (K9b, K9a, K8 levels, K9c); the reference's
    # schedule counts the tile phase and the levels, not K9b and K9c
    keys_d = keys_of(big, 12)
    unfused = {"pack_keys": 1, "merge_level": 10, "unpack_order": 1}
    cases += [
        ("(d) 12-bit, merge, fused=False", keys_d, 12, "merge",
         {**unfused, "radix_tile_sort": 1}, dict(fused=False)),
        ("(d) 12-bit, merge, bitonic", keys_d, 12, "merge",
         {**unfused, "bitonic_tile_sort": 1},
         dict(method="bitonic", fused=False))]
    cases = [c if len(c) == 6 else c + ({},) for c in cases]

    def schedule_launches(n, bits, strategy):
        idx_bits = max(1, (n - 1).bit_length())
        if strategy == "multi_tile":
            t = min(1024, 1 << math.ceil(math.log2(max(2, n))))
            nt = -(-n // t)
            return SortSchedule(tile_passes=digit_passes(
                bits, 4, key_shift=idx_bits), levels=(), mode="multi_tile",
                num_tiles=nt).num_launches
        plan, _, t = ms._tile_plan(1 << math.ceil(math.log2(max(2, n))),
                                   1024)
        return plan.sort_schedule(sort_bits=bits, key_shift=int(
            math.log2(t))).num_launches

    def snapshot():
        return {k: v for k, v in _build.launches().items()
                if k in SORT_META or k in MOE_META}

    results, inputs = [], []
    _build.reset_launches()
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    for label, k_np, bits, strategy, expect, kw in cases:
        keys = torch.as_tensor(k_np, device=dev)
        before = snapshot()
        t0 = time.perf_counter()
        if strategy is None:
            order = ops.stable_argsort(keys, num_key_bits=bits)
        else:
            order = ms.argsort(keys, num_key_bits=bits, strategy=strategy,
                               **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v - before[k] for k, v in snapshot().items()
               if v != before[k]}
        strat = strategy or ("multi_tile" if bits <= 16 else "merge")
        ref_launches = schedule_launches(len(k_np), bits, strat)
        standalone = got.get("pack_keys", 0) + got.get("unpack_order", 0)
        check(got == expect, f"sort {label}: launches {got} != {expect}")
        check(sum(got.values()) - standalone == ref_launches, f"sort "
              f"{label}: {sum(got.values())} launches ({standalone} pack / "
              f"unpack), the reference's SortSchedule says {ref_launches}")
        check(order.dtype == torch.int32 and order.shape == keys.shape,
              f"sort {label}: order {order.dtype} {tuple(order.shape)}")
        lib = torch.argsort(keys, stable=True)
        check(torch.equal(order.to(torch.int64), lib),
              f"sort {label}: order != torch.argsort(stable=True)")
        cpu = ms.argsort(torch.from_numpy(k_np), num_key_bits=bits,
                         strategy=strat)
        check(torch.equal(order.cpu(), cpu),
              f"sort {label}: order != the CPU twins' order")
        results.append(dict(case=label, n=len(k_np), num_key_bits=bits,
                            strategy=strat, launches=got,
                            reference_num_launches=ref_launches,
                            first_call_wall_s=wall, **kw))
        inputs.append((keys, bits, strategy, kw))
        say(f"sort {label}: n={len(k_np)}, {strat}, launches {got} "
            f"(reference SortSchedule.num_launches {ref_launches}); order "
            f"== torch.argsort(stable=True) == CPU twins")
    # (f) sort_u32 on random u32
    w_np = rng.randint(0, 1 << 32, big, dtype=np.uint64).astype(np.uint32)
    w = torch.as_tensor(w_np, device=dev)
    before = snapshot()
    out = ms.sort_u32(w)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in snapshot().items() if v != before[k]}
    expect = {"radix_tile_sort": 1, "merge_level": 10}
    plan, _, _ = ms._tile_plan(big, 1024)
    ref_launches = plan.sort_schedule(sort_bits=32).num_launches
    check(got == expect and sum(got.values()) == ref_launches,
          f"sort_u32: launches {got} != {expect} (reference {ref_launches})")
    lib = _flip(torch, torch.sort(_flip(torch, w)).values).view(torch.uint32)
    check(_mismatch(torch, out, lib) == 0, "sort_u32 != torch.sort")
    check(_mismatch(torch, out.cpu(), ms.sort_u32(torch.from_numpy(w_np)))
          == 0, "sort_u32 != the CPU twins")
    say(f"sort (f) sort_u32 on random u32: n={big}, launches {got} "
        f"(reference SortSchedule.num_launches {ref_launches}); words == "
        f"torch.sort == CPU twins")
    results.append(dict(case="(f) sort_u32, random u32", n=big,
                        num_key_bits=32, strategy="merge", launches=got,
                        reference_num_launches=ref_launches))
    # (f) under method="bitonic": K9a tiles, then the same merge levels
    before = snapshot()
    out_b = ms.sort_u32(w, method="bitonic")
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in snapshot().items() if v != before[k]}
    expect = {"bitonic_tile_sort": 1, "merge_level": 10}
    check(got == expect and sum(got.values()) == ref_launches,
          f"sort_u32 bitonic: launches {got} != {expect} (reference "
          f"{ref_launches})")
    check(_mismatch(torch, out_b, lib) == 0, "sort_u32 bitonic != torch.sort")
    say(f"sort (f) sort_u32, method='bitonic': n={big}, launches {got}; "
        f"words == torch.sort")
    results.append(dict(case="(f) sort_u32, random u32, bitonic", n=big,
                        num_key_bits=32, strategy="merge", launches=got,
                        reference_num_launches=ref_launches,
                        method="bitonic"))
    launches = snapshot()
    t_path = time.perf_counter() - t_path
    check(all(launches[k] > 0 for k in SORT_META)
          and all(launches[k] > 0 for k in MOE_META if k != "moe_dispatch"),
          f"a sort kernel never launched on the sort path: {launches}")
    say(f"sort path: {len(results)} cases in {t_path:.1f} s (CPU twins "
        f"included), launches {launches} [{card}]")

    # time each case end to end (after the counts are read): the port's
    # call against torch.argsort(stable=True), CUDA events around 5 calls
    # after a warm-up; the port's time includes the key-range check's host
    # sync, as a caller pays it
    def events_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    for res, (keys, bits, strategy, kw) in zip(results, inputs):
        if strategy is None:
            res["ms"] = events_ms(lambda: ops.stable_argsort(
                keys, num_key_bits=bits))
        else:
            res["ms"] = events_ms(lambda: ms.argsort(
                keys, num_key_bits=bits, strategy=strategy, **kw))
        res["library_ms"] = events_ms(lambda: torch.argsort(keys,
                                                            stable=True))
        say(f"sort {res['case']}: n={res['n']}, port {res['ms']:.4f} ms, "
            f"torch.argsort(stable=True) {res['library_ms']:.4f} ms [{card}]")
    fw = _flip(torch, w)
    for res, method in ((results[-2], "radix"), (results[-1], "bitonic")):
        res["ms"] = events_ms(lambda: ms.sort_u32(w, method=method))
        res["library_ms"] = events_ms(lambda: torch.sort(fw))
        say(f"sort {res['case']}: n={big}, port {res['ms']:.4f} ms, "
            f"torch.sort {res['library_ms']:.4f} ms [{card}]")

    # where a call's time goes: device time by kernel (torch.profiler) over
    # 5 calls, beside the wall time of 5 calls without the profiler
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    names = (("packed_tile_sort", "radix_tile_sort_packed"),
             ("tile_sort_kernel", "radix_tile_sort"),
             ("mt_local", "radix_mt_local"),
             ("mt_scatter", "radix_mt_scatter"),
             ("cluster_scan_kernel", "tile_scan_add"),
             ("merge_level", "merge_level"))     # v1 and v2
    breakdown = {}

    def argsort_call(keys, bits, strategy):
        if strategy is None:
            return lambda: ops.stable_argsort(keys, num_key_bits=bits)
        return lambda: ms.argsort(keys, num_key_bits=bits, strategy=strategy)

    profiled = [(res, argsort_call(*inp[:3]))          # cases (a)-(g)
                for res, inp in zip(results[:7], inputs[:7])]
    profiled.append((results[-2], lambda: ms.sort_u32(w)))   # case (f)
    for res, call in profiled:
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 5 * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        groups = {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            g = next((k for sub, k in names if sub in ev.key), "other")
            groups[g] = groups.get(g, 0.0) + \
                ev.self_device_time_total / 1e3 / 5
        dev_ms = sum(groups.values())
        breakdown[res["case"]] = dict(wall_ms=wall, device_ms=dev_ms,
                                      groups=groups)
        say(f"sort {res['case']}: wall {wall:.4f} ms a call, device "
            f"{dev_ms:.4f} ms ({100 * dev_ms / wall:.0f}% busy: " + ", ".join(
                f"{g} {t:.4f}" for g, t in sorted(
                    groups.items(), key=lambda kv: -kv[1])) + f") [{card}]")
    report["sort_path"] = dict(cases=results, launches=launches,
                               seconds=t_path, breakdown=breakdown)
    return launches


def sort_kernel_entries(rows, errs, launches):
    """The sort's kernels for the kernels line."""
    out = []
    for name, (source, replaces) in SORT_META.items():
        r = rows[name]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "max_err": errs[name], "tol": 0,
            "tol_kind": "exact (integer)", "ms": r["ms"],
            "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_computes": r["library_computes"], "shape": r["shape"],
            **({"copy_ms": r["copy_ms"]} if "copy_ms" in r else {}),
            **({"other_shapes": r["other_shapes"]} if "other_shapes" in r
               else {})})
    return out


# ---------------------------------------------------------------------------
# MoE: K3 (the dispatch) and K9a/b/c (the comparison sort's kernels)
# ---------------------------------------------------------------------------

# kernel → (source, the TPU kernel it replaces)
MOE_META = {
    "moe_dispatch": ("src/repro_torch/csrc/moe_dispatch.cu",
                     "src/repro/kernels/radix_sort.py:544"),
    "bitonic_tile_sort": ("src/repro_torch/csrc/merge_sort.cu",
                          "src/repro/kernels/merge_sort.py:187"),
    "pack_keys": ("src/repro_torch/csrc/merge_sort.cu",
                  "src/repro/kernels/merge_sort.py:138"),
    "unpack_order": ("src/repro_torch/csrc/merge_sort.cu",
                     "src/repro/kernels/merge_sort.py:150"),
}
# the SSM path's ContinuousEngine serves 8 of its 16 drawn requests: the
# engine is host-bound (124-169 s for all 16 on an H100 host)
XLSTM_REQUESTS = 8
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_LAYERS = 12           # of 48: the bf16 weights of 12 layers are 57 GB


def _bit_mismatch(torch, got, want):
    """0.0 when the two tensors are equal bit for bit (floats compared as
    their bit patterns), else the largest |got - want| (inf for a NaN);
    -1.0 if shape or dtype differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return -1.0
    if got.numel() == 0:
        return 0.0
    if got.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        bits = ints[got.element_size()]
        if torch.equal(got.view(bits), want.view(bits)):
            return 0.0
        d = float((got.double() - want.double()).abs().max())
        return d if d > 0 else float("inf")
    return float(_mismatch(torch, got, want))


def moe_kernel_rows(np, torch, dev, seed, device_ms, card, report):
    """K3 and K9a/b/c against their plain twins, bit for bit, at the MoE
    path's shapes (K3: a decode step of 8 rows, a 256-token prefill chunk,
    ``Model.prefill`` of 4 x 2048; ragged, top-k 2 and 256 experts too;
    K9 at 2^20 keys), then kernel, twin and library call timed after an L2
    flush (CUDA graphs)."""
    from repro_torch.kernels import merge_sort as ms
    from repro_torch.kernels import radix_sort as rs
    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    errs = dict.fromkeys(MOE_META, 0.0)
    bf = torch.bfloat16

    def same(kernel, got, want, **case):
        torch.cuda.synchronize()
        e = max(_bit_mismatch(torch, g, w) for g, w in zip(got, want))
        report["cases"].append(dict(kernel=kernel, max_abs_err=e, tol=0,
                                    tol_kind="bit for bit", **case))
        errs[kernel] = max(errs[kernel], abs(e))
        check(e == 0, f"{kernel} {case}: kernel and twin differ (max abs "
              f"err {e}; -1 = shape or dtype)")

    def routed(T, K, E, D, dtype=bf):
        x = torch.randn(T, D, generator=gen, device=dev).to(dtype)
        e = torch.randint(0, E, (T, K), generator=gen, device=dev,
                          dtype=torch.int32)
        if K > 1:     # distinct experts per token, as top-k gives them
            e = torch.argsort(torch.rand(T, E, generator=gen, device=dev),
                              dim=1)[:, :K].to(torch.int32)
        p = torch.rand(T, K, generator=gen, device=dev).to(dtype)
        return x, e, p

    D = 5120
    k3_cases = [(8, 1, 16, "decode step"), (256, 1, 16, "prefill chunk"),
                (8192, 1, 16, "Model.prefill 4 x 2048"),
                (1001, 1, 16, "ragged"), (1001, 2, 16, "top-k 2"),
                (4096, 1, 256, "256 experts, 9-bit digit"),
                (1, 1, 16, "one row"), (32, 1, 16, "a warp of rows"),
                (33, 1, 16, "a warp and one"), (512, 1, 16, "a full tile"),
                (8, 6, 64, "deepseek-v2-lite decode step")]
    inputs = {}
    k3_same = []
    for T, K, E, what in k3_cases:
        x, e, p = routed(T, K, E, D)
        got = rs.moe_dispatch_sort(x, e, p, num_experts=E)
        want = rs.moe_dispatch_sort_plain(x, e, p, num_experts=E)
        same("moe_dispatch", got, want, T=T, K=K, E=E, D=D, what=what)
        if T * K <= 512:      # one tile: the PR 15 design on the same input
            same("moe_dispatch", rs.moe_dispatch_sort(
                x, e, p, num_experts=E, counting=False), want, T=T, K=K,
                E=E, D=D, what=what, design="rank_pass scatter")
        again = rs.moe_dispatch_sort(x, e, p, num_experts=E)
        k3_same.append(all(torch.equal(a, b) for a, b in zip(got, again)))
        check(k3_same[-1], f"K3 {what}: two launches differ")
        inputs[(T, K, E)] = (x, e, p)
    # one tile, all ids equal and three tied ids; rows of 4- and 2-byte
    # words (no 16-byte vector)
    x, _, p = routed(512, 1, 16, D)
    for kind, e in (("all-equal", torch.full((512, 1), 15, device=dev,
                                             dtype=torch.int32)),
                    ("ties", torch.tensor([0, 8, 15], device=dev,
                                          dtype=torch.int32)[torch.randint(
                        0, 3, (512, 1), generator=gen, device=dev)])):
        same("moe_dispatch", rs.moe_dispatch_sort(x, e, p, num_experts=16),
             rs.moe_dispatch_sort_plain(x, e, p, num_experts=16), T=512,
             K=1, E=16, D=D, what=kind)
    for Dw, what in ((2562, "4-byte words"), (2561, "2-byte words")):
        x, e, p = routed(33, 2, 16, Dw)
        same("moe_dispatch", rs.moe_dispatch_sort(x, e, p, num_experts=16),
             rs.moe_dispatch_sort_plain(x, e, p, num_experts=16), T=33, K=2,
             E=16, D=Dw, what=what)
    say(f"K3: two launches bit-identical in {sum(k3_same)} of "
        f"{len(k3_same)} cases; one-tile inputs equal under both designs")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k3_attrs = {}
    for T in (8, 256):
        a = rs.moe_dispatch_attributes(T, D * 2)
        k3_attrs[f"T={T}"] = a
        grid = rs.k3_grid(T, D * 2, 16, sms)
        one = a["moe_onetile_kernel<uint4>"]
        check((one["copy_ctas"], one["words_per_thread"]) == grid,
              f"K3 T={T}: the kernel's grid {one['copy_ctas']} CTAs x "
              f"{one['words_per_thread']} words != k3_grid {grid}")
        for kname, a1 in a.items():
            say(f"  K3 {kname} (T={T}): {a1['registers']} registers, "
                f"{a1['spill_bytes']} spill bytes, "
                f"{a1['static_smem'] + a1['dynamic_smem']} bytes of shared "
                f"memory, {a1['ctas_per_sm']} CTAs an SM; one-tile grid "
                f"{a1['copy_ctas']} + 1 CTAs x {a1['words_per_thread']} "
                f"words a thread")
    report["k3_kernel_attributes"] = k3_attrs
    x, e, p = inputs[(8, 1, 16)]
    try:
        rs.moe_dispatch_sort(x, e, p, num_experts=300)
        fail("moe_dispatch_sort took 300 experts")
    except ValueError:
        pass
    n, tile = 1 << 20, 1024
    w = torch.randint(0, 1 << 32, (n,), generator=gen, device=dev,
                      dtype=torch.int64)
    w[1::2] = w[::2]                              # every word twice: ties
    w = w.to(torch.uint32)
    # K9a v2 (the network in registers and shuffles): every tile 1 to 8192
    # on 2^20 words with ties, equal / sorted / reverse-sorted words, a
    # misaligned input (scalar loads and stores), two launches identical
    for t in (1 << i for i in range(14)):
        same("bitonic_tile_sort", (ms.tile_sort(w, tile=t),),
             (ms.tile_sort_plain(w, tile=t),), n=n, tile=t)
    srt = _flip(torch, torch.sort(_flip(torch, w)).values).view(torch.uint32)
    for kind, x9 in (("all-equal", torch.full_like(w, 0x9e3779b9)),
                     ("sorted", srt), ("reverse-sorted", srt.flip(0))):
        for t in (2, 64, 1024, 2048, 4096, 8192):
            same("bitonic_tile_sort", (ms.tile_sort(x9, tile=t),),
                 (ms.tile_sort_plain(x9, tile=t),), n=n, tile=t, kind=kind)
    odd = w[1:1 + 3 * 1024]
    for t in (1, 1024):
        same("bitonic_tile_sort", (ms.tile_sort(odd, tile=t),),
             (ms.tile_sort_plain(odd, tile=t),), n=odd.numel(), tile=t,
             what="misaligned")
    check(torch.equal(ms.tile_sort(w, tile=tile), ms.tile_sort(w, tile=tile)),
          "K9a: two launches on the same input differ")
    k9a_attrs = {}
    for t in (1 << i for i in range(ms.MAX_BITONIC_TILE.bit_length())):
        a = k9a_attrs[f"tile {t}"] = ms.kernel_attributes(t)
        say(f"  bitonic_tile_sort tile {t}: {a['registers']} registers, "
            f"{a['spill_bytes']} spill bytes, "
            f"{a['static_smem'] + a['dynamic_smem']} bytes of shared memory,"
            f" {a['ctas_per_sm']} CTAs an SM, {a['threads']} threads")
        # the CPU model runs k9a_shape's table: it must be the kernel's
        check(a["threads"] == ms.k9a_shape(t)[1],
              f"K9a tile {t}: the kernel has {a['threads']} threads a CTA, "
              f"k9a_shape says {ms.k9a_shape(t)[1]}")
    report["k9a_kernel_attributes"] = k9a_attrs
    keys = torch.randint(0, 1 << 12, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    for nn in (n, n - 3):
        same("pack_keys", (ms._pack(keys, n=nn, idx_bits=20),),
             (ms.pack_plain(keys, n=nn, idx_bits=20),), m=n, n=nn,
             idx_bits=20)
    same("pack_keys", (ms._pack(keys[1:], n=n - 1, idx_bits=20),),
         (ms.pack_plain(keys[1:], n=n - 1, idx_bits=20),), m=n - 1,
         what="unaligned")
    packed = ms._pack(keys, n=n, idx_bits=20)
    sorted_words = ms.sort_u32(packed, method="bitonic")
    mask = (1 << 20) - 1
    for src, what in ((sorted_words, "sorted words"), (packed[1:], "odd")):
        same("unpack_order", (ms._unpack(src, idx_mask=mask),),
             (ms.unpack_plain(src, idx_mask=mask),), m=src.numel(),
             what=what)
    check(torch.equal(ms._unpack(sorted_words, idx_mask=mask).long(),
                      torch.argsort(keys, stable=True)),
          "K9b, K9a, K8, K9c are not the stable argsort")

    def bound(nbytes):
        return nbytes / PEAK_BYTES * 1e3

    rows, k3_times = {}, {}
    # the smallest launch this harness times: a one-element fill
    tiny = torch.zeros(1, dtype=torch.int32, device=dev)
    launch_ms = device_ms(lambda: tiny.fill_(1), cold=True)
    report["timings"]["smallest launch (one-element fill)"] = launch_ms
    for T, K, E, what in k3_cases[:3]:
        x, e, p = inputs[(T, K, E)]
        flat = e.reshape(-1)
        es = x.element_size()

        def new():
            return rs.moe_dispatch_sort(x, e, p, num_experts=E)

        def old():
            return rs.moe_dispatch_sort(x, e, p, num_experts=E,
                                        counting=False)
        # one tile: counting (new) and the rank_pass scatter (PR 15) in
        # turns; several tiles take one path whatever counting says
        turns = [device_ms(f, cold=True) for f in (
            (new, old, new, old) if T * K <= 512 else (new,))]
        r = dict(
            ms=(turns[0] + turns[2]) / 2 if len(turns) > 1 else turns[0],
            old_design_ms=(turns[1] + turns[3]) / 2 if len(turns) > 1
            else None, turns_ms=turns, launch_floor_ms=launch_ms,
            plain_ms=device_ms(lambda: rs.moe_dispatch_sort_plain(
                x, e, p, num_experts=E), cold=True),
            library_ms=device_ms(lambda: x.index_select(
                0, torch.argsort(flat, stable=True)), cold=True),
            library_computes="two calls: torch.argsort(stable=True) of the "
            "ids, then index_select of the rows (no counts, ids or probs)",
            bound_ms=bound((T + T * K) * D * es + T * K * (12 + 2 * es)
                           + 4 * E),
            bound_by="bytes",
            shape=dict(T=T, K=K, E=E, D=D, dtype="bfloat16", what=what))
        k3_times[what] = r
        report["timings"][f"moe_dispatch T={T} K={K} E={E} D={D}"] = r
        old_txt = "" if r["old_design_ms"] is None else \
            f" (rank_pass scatter {r['old_design_ms']:.4f} in turns)"
        say(f"K3 moe_dispatch {what} (T={T}, K={K}, E={E}, D={D}, bf16): "
            f"kernel {r['ms']:.4f} ms{old_txt}, plain {r['plain_ms']:.4f} "
            f"ms, argsort + index_select {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms (bytes), smallest launch "
            f"{launch_ms:.4f} ms [{card}]")
    # the kernels line keeps the 8192-row shape; the one-tile shapes ride
    # along beside it
    rows["moe_dispatch"] = dict(
        k3_times["Model.prefill 4 x 2048"], other_shapes={
            what: {k: k3_times[what][k] for k in (
                "ms", "old_design_ms", "plain_ms", "bound_ms", "library_ms",
                "launch_floor_ms", "shape")}
            for what in ("decode step", "prefill chunk")})
    fw = _flip(torch, w).reshape(n // tile, tile)
    rows["bitonic_tile_sort"] = dict(
        ms=device_ms(lambda: ms.tile_sort(w, tile=tile), cold=True),
        plain_ms=device_ms(lambda: ms.tile_sort_plain(w, tile=tile),
                           cold=True),
        library_ms=device_ms(lambda: torch.sort(fw, dim=1), cold=True),
        library_computes="per-tile torch.sort of the words (top bit "
        "flipped, int32)",
        bound_ms=bound(4.0 * 2 * n), bound_by="bytes",
        shape=dict(n=n, tile=tile))
    rows["pack_keys"] = dict(
        ms=device_ms(lambda: ms._pack(keys, n=n, idx_bits=20), cold=True),
        plain_ms=device_ms(lambda: ms.pack_plain(keys, n=n, idx_bits=20),
                           cold=True),
        library_ms=None, library_computes=None,
        bound_ms=bound(4.0 * 2 * n), bound_by="bytes",
        shape=dict(n=n, idx_bits=20))
    words32 = sorted_words.view(torch.int32)
    rows["unpack_order"] = dict(
        ms=device_ms(lambda: ms._unpack(sorted_words, idx_mask=mask),
                     cold=True),
        plain_ms=device_ms(lambda: ms.unpack_plain(sorted_words,
                                                   idx_mask=mask), cold=True),
        library_ms=device_ms(lambda: torch.bitwise_and(words32, mask),
                             cold=True),
        library_computes="torch.bitwise_and of the words viewed as int32",
        bound_ms=bound(4.0 * 2 * n), bound_by="bytes",
        shape=dict(n=n, idx_bits=20))
    for name in ("bitonic_tile_sort", "pack_keys", "unpack_order"):
        r = rows[name]
        report["timings"][f"{name} {r['shape']}"] = r
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        say(f"{name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms (bytes) [{card}]")
    say("K3 and K9 equal their twins bit for bit: " + ", ".join(
        f"{k} {v}" for k, v in errs.items()) + " (max abs err, tol 0); "
        "num_experts=300 raises ValueError")
    return rows, errs


def moe_path(np, torch, dev, seed, card, report, breakdown, drain):
    """The MoE path: llama4-scout at full width and 12 of 48 layers, bf16,
    seeded random weights, ``moe_strategy="sort"``, K3 routing.  Returns
    the launches of the main path's run: K3 from the engines, K9 from the
    bitonic unfused ``Model.prefill``."""
    import functools
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import merge_sort as ms
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import (ContinuousEngine, Engine,
                                          EngineConfig, Request)
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    V = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", moe_strategy="sort",
                  moe_sort_fn="pallas")
    params = model.init(seed)
    torch.cuda.synchronize()
    L = cfg.num_layers
    n_moe = model.repeats * sum(s.is_moe for s in model.period_specs)
    say(f"{cfg.name}: {L} of 48 layers ({n_moe} MoE: {cfg.num_experts} "
        f"experts top-{cfg.top_k} + {cfg.num_shared_experts} shared), "
        f"d_model {cfg.d_model}, {cfg.param_count() / 1e9:.2f}B params in "
        f"{cfg.param_dtype}, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed + 5)

    def requests(n):
        out = []
        for _ in range(n):
            plen = int(rng.randint(64, 1025))
            out.append((rng.randint(3, V, size=plen).astype(np.int32),
                        int(rng.randint(16, 65))))
        return out

    cont_reqs, sync_reqs = requests(16), requests(4)
    path = ("moe_dispatch", "flash_attention_fwd", "flash_decode_partials",
            "flash_decode_combine")
    others = tuple(MOE_META) + tuple(SORT_META)

    def sync_serve(m):
        se = Engine(m, params, EngineConfig(max_batch=4, max_seq=2048,
                                            eos_id=7))
        for i, (pr, mn) in enumerate(sync_reqs):
            se.submit(Request(rid=100 + i, prompt=pr, max_new=mn))
        done = {r.rid: np.asarray(r.result) for r in se.step()}
        torch.cuda.synchronize()
        return done

    def continuous_serve(m):
        ce = ContinuousEngine(m, params, EngineConfig(
            max_batch=8, max_seq=2048, decode_tick=8, page_size=32,
            eos_id=7))
        for i, (pr, mn) in enumerate(cont_reqs):
            ce.submit(Request(rid=i, prompt=pr, max_new=mn))
        done = {rid: np.asarray(r.result) for rid, r in drain(ce).items()}
        torch.cuda.synchronize()
        check(len(ce.pages.free) == ce.pages.num_pages
              and ce._admission.counter.value == 1
              and ce.telemetry.retired == 16
              and all(s is None for s in ce.slots),
              "MoE engine: pages, cap counter or slots not all freed")
        return done, ce.telemetry.snapshot()

    def serve(m):
        _build.reset_launches()
        m.calls = dict.fromkeys(m.calls, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done, telemetry = continuous_serve(m)
        t_cont = time.perf_counter() - t0
        calls_cont = dict(m.calls)
        launches_cont = _build.launches()
        t0 = time.perf_counter()
        sync_done = sync_serve(m)
        t_sync = time.perf_counter() - t0
        toks = {**done, **sync_done}
        check(len(done) == 16 and len(sync_done) == 4,
              f"MoE path served {len(done)}/16 continuous, "
              f"{len(sync_done)}/4 sync")
        for rid, res in toks.items():
            mn = (cont_reqs[rid] if rid < 100 else sync_reqs[rid - 100])[1]
            check(1 <= len(res) <= mn and bool(((res >= 0) & (res < V))
                                              .all()),
                  f"MoE request {rid}: {len(res)} tokens for max_new {mn}, "
                  f"or out of range")
        return dict(tokens=toks, calls=dict(m.calls), calls_cont=calls_cont,
                    launches=_build.launches(), launches_cont=launches_cont,
                    fused=_build.KERNELS["flash_attention_fwd"].tags.get(
                        "fused", 0),
                    continuous_s=t_cont, sync_s=t_sync, telemetry=telemetry)

    k3 = serve(model)
    calls, launches = k3["calls"], k3["launches"]
    expect = {"moe_dispatch": n_moe * (calls["prefill_chunk"]
                                       + calls["decode_step"]),
              "flash_attention_fwd": L * calls["prefill_chunk"],
              "flash_decode_partials": L * calls["decode_step"],
              "flash_decode_combine": 0}          # fused into the partials
    got = {k: launches[k] for k in path}
    check(calls["prefill"] == 0, "the engines ran a non-chunked prefill")
    check(got == expect, f"MoE path launches {got} != MoE layers x "
          f"(prefill chunks + decode steps), no combine {expect}")
    check(all(v > 0 for k, v in got.items() if k != "flash_decode_combine"),
          f"a kernel of the MoE path never launched: {got}")
    n_merge = launches["flash_attention_merge"]
    n_fused = k3["fused"]
    check(n_fused % L == 0 and n_merge % L == 0 and
          n_fused + n_merge <= launches["flash_attention_fwd"],
          f"MoE path: K1 {n_fused} fused split launches and {n_merge} merge "
          f"launches are not layers x split chunks")
    check(k3["launches_cont"]["moe_dispatch"] == n_moe * (
        k3["calls_cont"]["prefill_chunk"] + k3["calls_cont"]["decode_step"]),
        "continuous-engine K3 launches")
    check(all(launches[k] == 0 for k in others if k != "moe_dispatch")
          and launches["tile_scan_logspace"] == 0,
          f"the K3 route launched another sort or scan kernel: {launches}")
    gen_cont = sum(len(v) for k, v in k3["tokens"].items() if k < 100)
    gen_sync = sum(len(v) for k, v in k3["tokens"].items() if k >= 100)
    say(f"MoE path: launches {got} = {n_moe} MoE layers x "
        f"({calls['prefill_chunk']} prefill chunks + {calls['decode_step']} "
        f"decode steps); K1 split chunks {L} layers x "
        f"{(n_fused + n_merge) // L} ({n_fused // L} fused, "
        f"{n_merge // L} with the standalone merge)")
    say(f"MoE ContinuousEngine: 16 requests, {gen_cont} tokens in "
        f"{k3['continuous_s']:.2f} s = {gen_cont / k3['continuous_s']:.1f} "
        f"tok/s; Engine: 4 requests, {gen_sync} tokens in "
        f"{k3['sync_s']:.2f} s = {gen_sync / k3['sync_s']:.1f} tok/s [{card}]")

    # the same requests routed by torch.argsort(stable=True) plus a gather.
    # The sync Engine's schedule is fixed, so its tokens must be identical.
    # ContinuousEngine sizes prefill from wall-clock telemetry: two runs
    # need not batch alike, and in bf16 the batching (not the route)
    # changes the numerics; so a second continuous run holds every K3 call
    # bit for bit against argsort + gathers on the same inputs instead
    ref_model = Model(cfg, device="cuda", moe_strategy="sort",
                      moe_sort_fn=None)
    _build.reset_launches()
    t0 = time.perf_counter()
    ref_sync = sync_serve(ref_model)
    t_ref = time.perf_counter() - t0
    check(_build.launches()["moe_dispatch"] == 0,
          "the argsort route launched K3")
    diff = [rid for rid in ref_sync
            if not np.array_equal(k3["tokens"][rid], ref_sync[rid])]
    check(not diff, f"K3 and torch.argsort routes gave different tokens "
          f"for requests {diff}")
    del ref_model
    from repro_torch.kernels import radix_sort as rs
    from repro_torch.models import moe as moe_module
    real = moe_module.moe_dispatch_sort
    shadow = {"calls": 0, "differ": 0}

    def held(x, experts, probs, **kw):
        out = real(x, experts, probs, **kw)
        want = rs.moe_dispatch_sort_plain(x, experts, probs,
                                          num_experts=kw["num_experts"])
        shadow["calls"] += 1
        shadow["differ"] += any(_bit_mismatch(torch, a, b) != 0
                                for a, b in zip(out, want))
        return out

    moe_module.moe_dispatch_sort = held
    try:
        _build.reset_launches()
        continuous_serve(model)
    finally:
        moe_module.moe_dispatch_sort = real
    check(shadow["calls"] == _build.launches()["moe_dispatch"] > 0
          and shadow["differ"] == 0, f"continuous run: {shadow['differ']} "
          f"of {shadow['calls']} K3 calls differ from argsort + gathers")
    say(f"MoE path: sync Engine tokens identical under the K3 and the "
        f"torch.argsort routes (4 requests; argsort route {t_ref:.2f} s); "
        f"a second ContinuousEngine run: all {shadow['calls']} K3 calls "
        f"equal argsort + gathers bit for bit [{card}]")

    # Model.prefill of 4 x 2048: K3 route against the bitonic, unfused
    # argsort route (K9b, K9a, K8 levels, K9c), logits bit for bit
    prompts = torch.as_tensor(rng.randint(3, V, size=(4, 2048)),
                              dtype=torch.int32, device=dev)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lk, cache = model.prefill(params, prompts)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    check(_build.launches()["moe_dispatch"] == n_moe,
          f"Model.prefill: K3 launches {_build.launches()['moe_dispatch']} "
          f"!= {n_moe} MoE layers")
    del cache
    bitonic = functools.partial(ms.argsort, method="bitonic", fused=False)
    bmodel = Model(cfg, device="cuda", moe_strategy="sort",
                   moe_sort_fn=bitonic)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lb, cache = bmodel.prefill(params, prompts)
    torch.cuda.synchronize()
    t_bitonic = time.perf_counter() - t0
    k9_launches = _build.launches()
    del cache, bmodel
    n_keys = 4 * 2048 * cfg.top_k
    idx_bits = (n_keys - 1).bit_length()
    _, _, _, runs = ms._merge_schedule(n_keys, 1024, 12 + idx_bits, 4)
    k9_expect = {"pack_keys": n_moe, "bitonic_tile_sort": n_moe,
                 "merge_level": n_moe * len(runs), "unpack_order": n_moe,
                 "moe_dispatch": 0}
    k9_got = {k: k9_launches[k] for k in k9_expect}
    check(k9_got == k9_expect, f"bitonic unfused prefill launches {k9_got}"
          f" != {k9_expect}")
    check(tuple(lk.shape) == (4, V) and bool(torch.isfinite(lk).all()),
          f"MoE prefill logits {tuple(lk.shape)} not finite (4, {V})")
    e = _bit_mismatch(torch, lb, lk)
    check(e == 0, f"bitonic unfused route logits != K3 route logits (max "
          f"abs err {e})")
    say(f"MoE Model.prefill 4 x 2048: K3 route {t_prefill:.2f} s, bitonic "
        f"unfused route {t_bitonic:.2f} s with launches {k9_got}; logits "
        f"equal bit for bit [{card}]")

    # where one decode step and one prefill chunk spend device time
    lens8 = torch.as_tensor(np.random.RandomState(seed).randint(
        64, 1089, size=8), dtype=torch.int32, device=dev)
    toks8 = torch.randint(3, V, (8,), device=dev, dtype=torch.int32)
    dcache = model.init_cache(8, 2048)
    pcache = model.init_cache(1, 2048)
    model.prefill_chunk(params, prompts[:1, :736], pcache, 0)
    breakdowns = {}
    for what, fn, reps in (
            ("decode step B=8 S=2048", lambda: model.decode_step(
                params, toks8, dcache, lens8), 5),
            ("prefill chunk c=256 at 736, B=1 S=2048", lambda:
             model.prefill_chunk(params, prompts[:1, 736:992], pcache, 736,
                                 all_logits=True), 3)):
        wall, groups = breakdown(fn, reps)
        dev_ms = sum(groups.values())
        breakdowns[what] = dict(wall_ms=wall, device_ms=dev_ms,
                                busy=dev_ms / wall, groups=groups)
        say(f"MoE {what}, {L} layers: wall {wall:.2f} ms, device "
            f"{dev_ms:.2f} ms ({100 * dev_ms / wall:.0f}% busy: " + ", ".join(
                f"{g} {t:.2f}" for g, t in sorted(
                    groups.items(), key=lambda kv: -kv[1])) + f") [{card}]")
    peak = torch.cuda.max_memory_allocated()
    say(f"MoE path: peak memory {peak / 2**30:.2f} GiB [{card}]")
    report["moe_path"] = dict(
        layers=L, launches=got, merge_launches=n_merge,
        fused_split_launches=n_fused, calls=calls,
        continuous_s=k3["continuous_s"],
        continuous_tokens=gen_cont, sync_s=k3["sync_s"], sync_tokens=gen_sync,
        argsort_route_sync_s=t_ref, shadow_k3_calls=shadow["calls"],
        prefill_s=t_prefill, bitonic_prefill_s=t_bitonic,
        bitonic_launches=k9_got, peak_bytes=peak, breakdown=breakdowns,
        telemetry=k3["telemetry"])
    del dcache, pcache, params, model, prompts, lk, lb
    free_card(torch)
    say(f"MoE path done: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"still allocated")
    return {"moe_dispatch": got["moe_dispatch"],
            **{k: k9_got[k] for k in ("bitonic_tile_sort", "pack_keys",
                                      "unpack_order")}}


def moe_fp32(np, torch, seed, report, drain):
    """fp32 at the MoE path's full width, one layer (``fp32_check``)."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=1,
                              param_dtype="float32", compute_dtype="float32")
    fp32_check(np, torch, seed, report, drain, cfg, "MoE", "fp32_moe",
               rng_seed=seed + 6, moe_strategy="sort", moe_sort_fn="pallas")


def fp32_check(np, torch, seed, report, drain, cfg, what, key, *, rng_seed,
               **model_kw):
    """fp32 at full width and the depth of ``cfg``: card logits against
    the CPU plain path on the same weights (prefill 2 x 300, then 4 decode
    steps), and continuous-batching tokens against one-at-a-time tokens (a
    divergence must be a near-tie); the results go to ``report[key]``."""
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import (ContinuousEngine, Engine,
                                          EngineConfig, Request)
    V = cfg.vocab_size
    model = Model(cfg, device="cuda", **model_kw)
    params = model.init(seed + 1)
    cpu_model = Model(cfg, device="cpu", **model_kw)
    cpu_params = _tree_to(params, "cpu")
    rng = np.random.RandomState(rng_seed)
    toks = torch.as_tensor(rng.randint(3, V, size=(2, 300)),
                           dtype=torch.int32)
    gl, gcache = model.prefill(params, toks.cuda(), max_seq=320)
    cl, ccache = cpu_model.prefill(cpu_params, toks, max_seq=320)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    worst = err(gl.cpu(), cl)
    lengths = torch.full((2,), 300, dtype=torch.int32)
    nxt = torch.argmax(cl, -1).to(torch.int32)
    for _ in range(4):
        gl, gcache = model.decode_step(params, nxt.cuda(), gcache,
                                       lengths.cuda())
        cl, ccache = cpu_model.decode_step(cpu_params, nxt, ccache, lengths)
        worst = max(worst, err(gl.cpu(), cl))
        nxt, lengths = torch.argmax(cl, -1).to(torch.int32), lengths + 1
    say(f"fp32 {what} logits, card vs CPU plain path ({cfg.num_layers} "
        f"layer{'s' if cfg.num_layers > 1 else ''} at full width, prefill "
        f"2 x 300 + 4 decode steps): max abs err {worst:.3g} (tol "
        f"{LOGIT_TOL})")
    check(worst <= LOGIT_TOL, f"card {what} logits disagree with the CPU")
    del cpu_model, cpu_params, ccache, gcache

    lens6, news6 = (40, 300, 77, 520, 129, 260), (10, 6, 14, 8, 12, 5)
    reqs6 = [(rng.randint(3, V, size=n).astype(np.int32), mn)
             for n, mn in zip(lens6, news6)]
    alone = {}
    for i, (pr, mn) in enumerate(reqs6):
        eng = Engine(model, params, EngineConfig(max_batch=1, eos_id=7,
                                                 max_seq=2048))
        eng.submit(Request(rid=i, prompt=pr, max_new=mn))
        (d,) = eng.step()
        alone[i] = np.asarray(d.result)
    ce = ContinuousEngine(model, params, EngineConfig(
        max_batch=3, eos_id=7, max_seq=1024, decode_tick=4))
    for i, (pr, mn) in enumerate(reqs6):
        ce.submit(Request(rid=i, prompt=pr, max_new=mn))
    got = {rid: np.asarray(r.result) for rid, r in drain(ce).items()}
    ties = 0
    for i, (pr, _) in enumerate(reqs6):
        a, b = got[i], alone[i]
        if np.array_equal(a, b):
            continue
        t = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]),
                 min(len(a), len(b)))
        ctx = np.concatenate([pr, b[:t]]).astype(np.int32)
        logits, _ = model.prefill(params, torch.as_tensor(
            ctx[None], device="cuda"))
        top2 = torch.topk(logits[0, :V], 2).values
        gap = float(top2[0] - top2[1])
        say(f"{what} request {i}: batched and one-at-a-time tokens differ "
            f"at step {t}; top-2 logit gap there {gap:.3g}")
        check(gap < NEAR_TIE, f"{what} request {i}: divergence is not a "
              f"near-tie (gap {gap:.3g} >= {NEAR_TIE})")
        ties += 1
    say(f"fp32 {what} ContinuousEngine == one-at-a-time Engine tokens for "
        f"{len(reqs6) - ties}/{len(reqs6)} requests ({ties} near-ties)")
    report[key] = dict(max_logit_err=worst, near_ties=ties)
    del ce, params, model
    free_card(torch)


# ---------------------------------------------------------------------------
# MLA (deepseek-v2-lite-16b) and the dense configs beside llama3-8b
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v2-lite-16b"
DENSE_ARCHS = ("yi-9b", "chatglm3-6b", "minitron-4b")
# K1's MLA instance for the kernels line: (source, the TPU kernel)
K1_MLA = ("src/repro_torch/csrc/flash_attention.cu",
          "src/repro/kernels/flash_attention.py:72")


def _requests(np, rng, n, vocab, max_new):
    """n (prompt, max_new) pairs: prompts of 64 to 1024 tokens, the dense
    path's mix, max_new in [max_new[0], max_new[1]]."""
    return [(rng.randint(3, vocab, size=int(rng.randint(64, 1025)))
             .astype(np.int32), int(rng.randint(max_new[0], max_new[1] + 1)))
            for _ in range(n)]


def _serve(torch, model, params, reqs, drain, *, continuous, rid0=0):
    """Serve ``reqs`` through ContinuousEngine (8 slots, pages of 32) or
    the sync Engine (one batch of 4); returns ({rid: tokens}, seconds,
    the continuous engine's telemetry or None).  Every token must be in
    the vocabulary and at most its request's max_new."""
    import numpy as np
    from repro_torch.serve.engine import (ContinuousEngine, Engine,
                                          EngineConfig, Request)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if continuous:
        eng = ContinuousEngine(model, params, EngineConfig(
            max_batch=8, max_seq=2048, decode_tick=8, page_size=32,
            eos_id=7))
        for i, (pr, mn) in enumerate(reqs):
            eng.submit(Request(rid=rid0 + i, prompt=pr, max_new=mn))
        done = {rid: np.asarray(r.result) for rid, r in drain(eng).items()}
        check(len(eng.pages.free) == eng.pages.num_pages
              and eng._admission.counter.value == 1
              and eng.telemetry.retired == len(reqs)
              and all(s is None for s in eng.slots),
              f"{model.cfg.name}: pages, cap counter or slots not all "
              f"freed")
        telemetry = eng.telemetry.snapshot()
    else:
        eng = Engine(model, params, EngineConfig(max_batch=4, max_seq=2048,
                                                 eos_id=7))
        for i, (pr, mn) in enumerate(reqs):
            eng.submit(Request(rid=rid0 + i, prompt=pr, max_new=mn))
        done = {r.rid: np.asarray(r.result) for r in eng.step()}
        telemetry = None
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(len(done) == len(reqs), f"{model.cfg.name}: served {len(done)}/"
          f"{len(reqs)}")
    V = model.cfg.vocab_size
    for rid, res in done.items():
        mn = reqs[rid - rid0][1]
        check(1 <= len(res) <= mn and bool(((res >= 0) & (res < V)).all()),
              f"{model.cfg.name} request {rid}: {len(res)} tokens for "
              f"max_new {mn}, or out of range")
    return done, secs, telemetry


def mla_path(np, torch, dev, seed, card, report, breakdown, drain):
    """The MLA path: deepseek-v2-lite-16b at full width and depth (27
    layers: the dense prefix layer + 26 MoE layers of 64 experts top-6 and
    2 shared), bf16, seeded random weights, ``moe_strategy="sort"``, K3
    routing.  16 requests through ContinuousEngine and 4 through Engine
    (chunks and decode steps score MLA in absorbed form against the latent
    cache: no K1, no K2; K3 once per MoE layer per chunk and step), then
    ``Model.prefill`` of 4 x 2048 (K1 at (192, 128) once per layer, K3 once
    per MoE layer).  Returns the launches of those runs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import Model
    cfg = get_config(MLA_ARCH)
    V, L = cfg.vocab_size, cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", moe_strategy="sort",
                  moe_sort_fn="pallas")
    params = model.init(seed)
    torch.cuda.synchronize()
    specs = model.prefix_specs + model.period_specs * model.repeats
    n_moe = sum(s.is_moe for s in specs)
    check(len(specs) == L and [s.kind for s in specs] == ["mla"] * L
          and n_moe == L - 1 and not specs[0].is_moe,
          f"{cfg.name}: layers {[(s.kind, s.is_moe) for s in specs]}")
    say(f"{cfg.name}: {L} layers (1 dense prefix + {n_moe} MoE: "
        f"{cfg.num_experts} experts top-{cfg.top_k} + "
        f"{cfg.num_shared_experts} shared), MLA kv_lora {cfg.kv_lora_rank}, "
        f"d_model {cfg.d_model}, {cfg.param_count() / 1e9:.2f}B params in "
        f"{cfg.param_dtype}, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed + 7)
    cont_reqs = _requests(np, rng, 16, V, (16, 64))
    sync_reqs = _requests(np, rng, 4, V, (16, 64))
    attn = ("flash_attention_fwd", "flash_attention_merge",
            "flash_decode_partials", "flash_decode_combine")

    _build.reset_launches()
    model.calls = dict.fromkeys(model.calls, 0)
    done, t_cont, telemetry = _serve(torch, model, params, cont_reqs, drain,
                                     continuous=True)
    calls_cont = dict(model.calls)
    sync_done, t_sync, _ = _serve(torch, model, params, sync_reqs, drain,
                                  continuous=False, rid0=100)
    eng_launches, calls = _build.launches(), dict(model.calls)
    check(calls["prefill"] == 0, "the engines ran a non-chunked prefill")
    n_k3 = n_moe * (calls["prefill_chunk"] + calls["decode_step"])
    check(eng_launches["moe_dispatch"] == n_k3 > 0,
          f"MLA engines: K3 launches {eng_launches['moe_dispatch']} != "
          f"{n_moe} MoE layers x ({calls['prefill_chunk']} chunks + "
          f"{calls['decode_step']} decode steps)")
    check(all(eng_launches[k] == 0 for k in attn),
          f"MLA engines launched K1 or K2 (absorbed MLA runs neither): "
          f"{ {k: eng_launches[k] for k in attn} }")
    others = [k for k, n in eng_launches.items() if n and k != "moe_dispatch"]
    check(not others, f"MLA engines launched {others}")
    gen_cont = sum(len(v) for v in done.values())
    gen_sync = sum(len(v) for v in sync_done.values())
    say(f"MLA path: K3 launches {n_k3} = {n_moe} MoE layers x "
        f"({calls['prefill_chunk']} prefill chunks + {calls['decode_step']} "
        f"decode steps), K1 and K2 0 (absorbed chunks and decode; "
        f"continuous engine alone: {calls_cont})")
    say(f"MLA ContinuousEngine: 16 requests, {gen_cont} tokens in "
        f"{t_cont:.2f} s = {gen_cont / t_cont:.1f} tok/s; Engine: 4 "
        f"requests, {gen_sync} tokens in {t_sync:.2f} s = "
        f"{gen_sync / t_sync:.1f} tok/s [{card}]")

    prompts = torch.as_tensor(rng.randint(3, V, size=(4, 2048)),
                              dtype=torch.int32, device=dev)
    _build.reset_launches()
    model.calls = dict.fromkeys(model.calls, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    pre_launches = _build.launches()
    want = {"flash_attention_fwd": L, "flash_attention_merge": 0,
            "moe_dispatch": n_moe, "flash_decode_partials": 0}
    got = {k: pre_launches[k] for k in want}
    check(got == want, f"MLA Model.prefill 4 x 2048: launches {got} != K1 "
          f"once a layer, K3 once a MoE layer {want}")
    check(tuple(logits.shape) == (4, V) and bool(torch.isfinite(
        logits).all()), f"MLA prefill logits {tuple(logits.shape)} not "
        f"finite (4, {V})")
    check(tuple(cache["prefix"][0]["latent"].shape) == (
        4, 2048, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
        "MLA prefill: the prefix layer's latent cache has the wrong shape")
    say(f"MLA Model.prefill 4 x 2048: {t_prefill:.2f} s, launches {got} "
        f"(K1 at q/k 192, v 128: one a layer) [{card}]")
    del cache, logits

    lens8 = torch.as_tensor(np.random.RandomState(seed).randint(
        64, 1089, size=8), dtype=torch.int32, device=dev)
    toks8 = torch.randint(3, V, (8,), device=dev, dtype=torch.int32)
    dcache = model.init_cache(8, 2048)
    pcache = model.init_cache(1, 2048)
    model.prefill_chunk(params, prompts[:1, :736], pcache, 0)
    breakdowns = {}
    for what, fn, reps in (
            ("decode step B=8 S=2048", lambda: model.decode_step(
                params, toks8, dcache, lens8), 5),
            ("prefill chunk c=256 at 736, B=1 S=2048", lambda:
             model.prefill_chunk(params, prompts[:1, 736:992], pcache, 736,
                                 all_logits=True), 3)):
        wall, groups = breakdown(fn, reps)
        dev_ms = sum(groups.values())
        breakdowns[what] = dict(wall_ms=wall, device_ms=dev_ms,
                                busy=dev_ms / wall, groups=groups)
        say(f"MLA {what}, {L} layers: wall {wall:.2f} ms, device "
            f"{dev_ms:.2f} ms ({100 * dev_ms / wall:.0f}% busy: " + ", ".join(
                f"{g} {t:.2f}" for g, t in sorted(
                    groups.items(), key=lambda kv: -kv[1])) + f") [{card}]")
    peak = torch.cuda.max_memory_allocated()
    say(f"MLA path: peak memory {peak / 2**30:.2f} GiB [{card}]")
    report["mla_path"] = dict(
        layers=L, engine_launches={k: v for k, v in eng_launches.items()
                                   if v}, prefill_launches=got,
        calls=calls, continuous_s=t_cont, continuous_tokens=gen_cont,
        sync_s=t_sync, sync_tokens=gen_sync, prefill_s=t_prefill,
        peak_bytes=peak, breakdown=breakdowns, telemetry=telemetry)
    del dcache, pcache, params, model, prompts
    free_card(torch)
    return dict(k1=got["flash_attention_fwd"],
                k3=eng_launches["moe_dispatch"] + got["moe_dispatch"])


def mla_fp32(np, torch, seed, report, drain):
    """fp32 at deepseek's full width, 2 layers (the dense prefix layer and
    one MoE layer): ``Model.prefill`` runs K1's fp32 kernel at (192,
    128)."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(MLA_ARCH), num_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    fp32_check(np, torch, seed, report, drain, cfg, "MLA", "fp32_mla",
               rng_seed=seed + 8, moe_strategy="sort", moe_sort_fn="pallas")

# ---------------------------------------------------------------------------
# the policy layer on the card: simulated admission, chaos and drain hooks,
# the on-device audit, the schedulers over CUDA tensors
# ---------------------------------------------------------------------------

# phase 5a's queue: two long prompts behind three of ~300 and three short
ADMIT_LENS = (300, 290, 280, 1000, 900, 64, 64, 64)
# (engine step, lane): lane 11 does not exist, so that death is a no-op;
# phase 6's first request (10 tokens, ticks of 4) is still in lane 0 at
# step 1
SLOT_DEATHS = ((2, 0), (4, 1), (6, 11))
SLOT_DEATHS_FP32 = ((1, 0), (3, 1), (5, 11))


def _replayed_sizes(sim, lens, max_batch):
    """``AdmissionSimulator.choose`` replayed on the host over the queue."""
    q, out = list(lens), []
    while q:
        k = sim.choose(q, max_batch)
        out.append(k)
        q = q[k:]
    return out


def _counted(torch, model, L, path_launches, what, fn):
    """Run ``fn`` with the launch counts and the model's call counts set
    to 0, then hold K1 to layers x prefill chunks and K2 to layers x
    decode steps."""
    from repro_torch.kernels import _build
    _build.reset_launches()
    model.calls = dict.fromkeys(model.calls, 0)
    out = fn()
    torch.cuda.synchronize()
    got, calls = path_launches(), dict(model.calls)
    check(calls["prefill_chunk"] > 0 and calls["decode_step"] > 0
          and got["flash_attention_fwd"] == L * calls["prefill_chunk"]
          and got["flash_decode_partials"] == L * calls["decode_step"],
          f"{what}: launches {got} != {L} layers x (prefill chunks, decode "
          f"steps) {calls}")
    return out, got, calls


def _drain_hooks(eng, reqs, drain):
    """Submit, take one step (a decode tick), deliver SIGTERM to this
    process; the engine drains its slots, ``handoff`` moves the frozen
    queue.  Returns (served before or during the drain, the queue, the
    drained engine)."""
    import os
    import signal
    prev = signal.getsignal(signal.SIGTERM)
    done = {}
    try:
        old = eng.install_signal_handlers()
        check(old == {signal.SIGTERM: prev}, "install_signal_handlers "
              "did not return the previous handler")
        for r in reqs:
            eng.submit(r)
        done.update({r.rid: r for r in eng.step()})
        os.kill(os.getpid(), signal.SIGTERM)
        done.update(drain(eng))
    finally:
        signal.signal(signal.SIGTERM, prev)
    check(eng.preempted, "SIGTERM did not reach the engine's handler")
    return done, eng.handoff(), eng


def _check_freed(eng, what):
    check(all(s is None for s in eng.slots) and eng._job is None
          and eng._parked is None, f"{what}: slots not all freed")
    check(len(eng.pages.free) == eng.pages.num_pages,
          f"{what}: pages not all free")
    check(eng._admission.counter.value == 1,
          f"{what}: admission cap counter {eng._admission.counter.value}")


def policy_path_bf16(np, torch, model, params, cfg, seed, card, report,
                     drain, path_launches):
    """Phase 5's policy runs on llama3-8b at full width and depth, bf16:
    (a) the sync Engine with ``admission="simulate"`` at 2 lanes, (b) a
    slot-death storm under ``replay``, (c) a SIGTERM drain + ``handoff``,
    (d) ``audit_pytree`` over the weights and one planted NaN."""
    from repro_torch.chaos import SlotDeathInjector, TraceItem, replay
    from repro_torch.core import FaultPlan, SlotDeath, WorkRange, by_blocks
    from repro_torch.data import all_finite, audit_pytree
    from repro_torch.data.validate import _leaves
    from repro_torch.serve.engine import (AdmissionSimulator,
                                          ContinuousEngine, Engine,
                                          EngineConfig, Request)
    L, V = cfg.num_layers, cfg.vocab_size
    rng = np.random.RandomState(seed + 50)
    out = {}

    # (a) simulated admission: the batch sizes are choose's, replayed
    sim = AdmissionSimulator(lanes=2)
    reqs = [Request(rid=i, prompt=rng.randint(3, V, size=n).astype(np.int32),
                    max_new=int(rng.randint(16, 65)))
            for i, n in enumerate(ADMIT_LENS)]
    se = Engine(model, params, EngineConfig(max_batch=8, max_seq=2048,
                                            eos_id=7, admission="simulate"))
    se.admission_sim = sim
    for r in reqs:
        se.submit(r)

    def serve_sync():
        sizes, done = [], {}
        while se.queue:
            batch = se.step()
            sizes.append(len(batch))
            done.update({r.rid: r for r in batch})
        return sizes, done

    t0 = time.perf_counter()
    (sizes, done), got, calls = _counted(
        torch, model, L, path_launches, "simulated admission", serve_sync)
    t_sync = time.perf_counter() - t0
    want = _replayed_sizes(sim, ADMIT_LENS, 8)
    check(sizes == want and sizes[0] == 2,
          f"simulated admission took batches {sizes}, choose replayed on "
          f"the host says {want}")
    check(sorted(done) == list(range(len(reqs))) and all(
        1 <= len(r.result) <= r.max_new for r in done.values()),
        "simulated admission: not every request served")
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        sim.choose(list(ADMIT_LENS), 8)
    choose_ms = (time.perf_counter() - t0) / reps * 1e3
    say(f"5a simulated admission (2 lanes): batches {sizes} == choose "
        f"replayed; launches {got} = {L} x ({calls['prefill_chunk']} "
        f"chunks, {calls['decode_step']} steps); {t_sync:.2f} s; host "
        f"{choose_ms:.3f} ms a choose over {len(ADMIT_LENS)} queued "
        f"[{card}]")
    out["simulated_admission"] = dict(batches=sizes, launches=got,
                                      calls=calls, seconds=t_sync,
                                      choose_host_ms=choose_ms)

    # (b) slot-death storm: calm replay, then the same trace with deaths
    trace = tuple(TraceItem(rid=i, arrival=0.0,
                            prompt_len=int(rng.randint(64, 1025)),
                            max_new=int(rng.randint(48, 65)))
                  for i in range(8))
    econf = dict(max_batch=8, max_seq=2048, decode_tick=8, page_size=32,
                 eos_id=7)
    calm = replay(ContinuousEngine(model, params, EngineConfig(**econf)),
                  trace, vocab=V, seed=seed)
    check(calm.conserved(trace) and not calm.shed and not calm.rejected,
          "calm replay not conserved")
    inj = SlotDeathInjector(FaultPlan(slot_deaths=tuple(
        SlotDeath(at_step=s, slot=k) for s, k in SLOT_DEATHS)))
    eng = ContinuousEngine(model, params, EngineConfig(**econf))
    stormy, got, calls = _counted(
        torch, model, L, path_launches, "slot-death replay",
        lambda: replay(eng, trace, vocab=V, seed=seed, on_step=inj))
    killed = len(inj.killed)
    check(stormy.conserved(trace) and not stormy.shed
          and not stormy.rejected, "slot-death replay not conserved")
    check(1 <= killed <= 2 and all(k < 8 for _, k in inj.killed),
          f"slot deaths hit {inj.killed}")
    check(sum(r.requeues for r in stormy.served) == killed
          == eng.telemetry.slot_deaths, "requeues != lanes killed")
    _check_freed(eng, "slot-death replay")
    ref = {r.rid: np.asarray(r.result) for r in calm.served}
    requeued = [r for r in stormy.served if r.requeues]
    same = sum(np.array_equal(ref[r.rid], np.asarray(r.result))
               for r in requeued)
    say(f"5b slot-death replay: 8 conserved, killed {inj.killed}, requeues "
        f"{killed}, pages / cap / slots freed; launches {got}; bf16 "
        f"re-served == calm tokens for {same}/{len(requeued)} (not gated)")
    out["slot_death"] = dict(killed=inj.killed, launches=got, calls=calls,
                             reserved_equal_calm=same,
                             reserved=len(requeued))

    # (c) SIGTERM drain, then handoff to a fresh engine
    reqs = [Request(rid=i, prompt=rng.randint(3, V, size=int(
        rng.randint(64, 1025))).astype(np.int32),
        max_new=int(rng.randint(16, 65))) for i in range(8)]
    (done, waiting, eng), got, calls = _counted(
        torch, model, L, path_launches, "SIGTERM drain",
        lambda: _drain_hooks(ContinuousEngine(
            model, params, EngineConfig(**econf)), reqs, drain))
    check(len(waiting) > 0 and not eng.queue, "drain: no queue handed off")
    _check_freed(eng, "SIGTERM drain")
    fresh = ContinuousEngine(model, params, EngineConfig(**econf))
    for r in waiting:
        fresh.submit(r)
    after = drain(fresh)
    rids = sorted(list(done) + list(after))
    check(rids == list(range(8)), f"drain + handoff served {rids}")
    say(f"5c SIGTERM drain: {len(done)} drained in flight, {len(waiting)} "
        f"handed off and served by a fresh engine, every rid once; "
        f"launches {got}")
    out["drain"] = dict(drained=len(done), handed_off=len(waiting),
                        launches=got, calls=calls)

    # (d) the weight audit on the card, then one planted NaN; timed twice:
    # the first call allocates its block-sized temporaries
    audit_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok, bad = audit_pytree(params)
        torch.cuda.synchronize()
        audit_ms.append((time.perf_counter() - t0) * 1e3)
    leaves = list(_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    blocks = sum(len(list(by_blocks(first=1 << 14).blocks(
        WorkRange(0, t.numel())))) for _, t in leaves)
    check(ok and bad == [], f"audit_pytree: non-finite leaves {bad}")
    path, leaf = max(leaves, key=lambda kv: kv[1].numel())
    flat = leaf.view(-1)
    pos = int(rng.randint(0, flat.numel()))
    old = flat[pos].clone()
    flat[pos] = float("nan")
    res = all_finite(leaf)
    flat[pos] = old

    def host_block(blk, carry):
        return carry or blk.start <= pos < blk.stop

    _, want = by_blocks(first=1 << 14).run(
        WorkRange(0, flat.numel()), host_block, False,
        should_stop=lambda c: c)
    lo, hi = res.first_bad_block or (0, 0)
    check(not res.ok and lo <= pos < hi and res.stats == want,
          f"planted NaN at {pos} of {path}: audit {res}, host by_blocks "
          f"{want}")
    check(all_finite(leaf).ok, "the weight was not restored")
    say(f"5d audit_pytree: {len(leaves)} leaves, {n_bytes / 1e9:.2f} GB "
        f"bf16, {blocks} blocks, all finite in {audit_ms[0]:.1f} ms, then "
        f"{audit_ms[1]:.1f} ms ({n_bytes / audit_ms[1] / 1e6:.0f} GB/s); "
        f"NaN at {pos} of {path} "
        f"found in block [{lo}, {hi}), {res.stats.blocks_run} blocks == "
        f"host by_blocks [{card}]")
    out["audit"] = dict(ms=audit_ms[0], ms_second=audit_ms[1],
                        bytes=n_bytes, leaves=len(leaves),
                        blocks=blocks, nan_leaf=path, nan_pos=pos,
                        nan_block=[lo, hi],
                        nan_blocks_run=res.stats.blocks_run)
    report["policy_bf16"] = out


def policy_path_fp32(np, torch, model, params, trace6, reqs6, ref, vocab,
                     seed, report, drain):
    """Phase 6's policy runs at fp32, 2 layers, against the one-at-a-time
    tokens ``ref`` of ``reqs6``: (a) ``admission="simulate"`` at 2 lanes,
    (b) a slot-death ``replay`` of the same requests, (c) a SIGTERM drain
    + ``handoff``.  Each gives ``ref``'s tokens exactly."""
    from repro_torch.chaos import SlotDeathInjector, replay
    from repro_torch.core import FaultPlan, SlotDeath
    from repro_torch.serve.engine import (AdmissionSimulator,
                                          ContinuousEngine, Engine,
                                          EngineConfig, Request)

    def copies():
        return [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                for r in reqs6]

    def exact(done, what):
        bad = [rid for rid, r in done.items()
               if not np.array_equal(np.asarray(r.result), ref[rid])]
        check(sorted(done) == sorted(ref) and not bad,
              f"fp32 {what}: tokens differ from one-at-a-time for {bad}")

    se = Engine(model, params, EngineConfig(max_batch=4, max_seq=2048,
                                            eos_id=7, admission="simulate"))
    se.admission_sim = AdmissionSimulator(lanes=2)
    for r in copies():
        se.submit(r)
    sizes, done = [], {}
    while se.queue:
        batch = se.step()
        sizes.append(len(batch))
        done.update({r.rid: r for r in batch})
    exact(done, "simulated admission")
    check(sizes == _replayed_sizes(se.admission_sim,
                                   [len(r.prompt) for r in reqs6], 4),
          f"fp32 simulated admission batches {sizes}")

    econf = dict(max_batch=3, eos_id=7, max_seq=1024, decode_tick=4)
    inj = SlotDeathInjector(FaultPlan(slot_deaths=tuple(
        SlotDeath(at_step=s, slot=k) for s, k in SLOT_DEATHS_FP32)))
    eng = ContinuousEngine(model, params, EngineConfig(**econf))
    stormy = replay(eng, trace6, vocab=vocab, seed=seed, on_step=inj)
    check(stormy.conserved(trace6) and not stormy.shed,
          "fp32 slot-death replay not conserved")
    check(len(inj.killed) >= 1 and sum(r.requeues for r in stormy.served)
          == len(inj.killed), f"fp32 slot deaths {inj.killed}")
    exact({r.rid: r for r in stormy.served}, "slot-death replay")
    _check_freed(eng, "fp32 slot-death replay")

    done, waiting, eng = _drain_hooks(ContinuousEngine(
        model, params, EngineConfig(**econf)), copies(), drain)
    _check_freed(eng, "fp32 drain")
    fresh = ContinuousEngine(model, params, EngineConfig(**econf))
    for r in waiting:
        fresh.submit(r)
    done.update(drain(fresh))
    exact(done, "drain + handoff")
    say(f"fp32 policy runs == one-at-a-time tokens exactly: simulated "
        f"admission (2 lanes, batches {sizes}), slot-death replay (killed "
        f"{inj.killed}), drain + handoff ({len(waiting)} handed off)")
    report["policy_fp32"] = dict(batches=sizes, killed=inj.killed,
                                 handed_off=len(waiting))


def policy_host_phase(torch, dev, card, report):
    """The schedulers mapping device work: ``schedule_join`` and
    ``adaptive(132).schedule`` of an int64 ``torch.sum`` over the leaves of
    a 2^24-element CUDA tensor equal the whole ``torch.sum`` exactly;
    ``work_loop`` with a CUDA state and a device ``should_stop`` stops at
    the grant the CPU run stops at, within ceil(log2(total)) + 1 grants."""
    from repro_torch.core import (WorkRange, adaptive, schedule_join,
                                  thief_splitting, work_loop)
    n = 1 << 24
    x = torch.randint(0, 1 << 20, (n,), dtype=torch.int64, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(3))
    whole = int(x.sum())

    def leaf_sum(w):
        return x[w.start:w.stop].sum()

    t0 = time.perf_counter()
    joined = schedule_join(thief_splitting(WorkRange(0, n), p=132),
                           leaf_sum, lambda a, b: a + b)
    adapt = adaptive(132).schedule(WorkRange(0, n), leaf_sum,
                                   lambda a, b: a + b)
    check(int(joined) == whole == int(adapt),
          f"schedule_join {int(joined)} / adaptive {int(adapt)} != "
          f"torch.sum {whole}")
    t_sched = (time.perf_counter() - t0) * 1e3

    def loop(device, stop_at, total):
        grants = []

        def advance(s, k):
            grants.append(k)
            return s + torch.ones(k, dtype=torch.int64, device=device).sum()

        state = work_loop(torch.zeros((), dtype=torch.int64, device=device),
                          advance, total, first_grant=1,
                          should_stop=lambda s: s >= stop_at)
        return int(state), grants

    for stop_at, total in ((1000, 1 << 20), (1 << 30, 1000)):
        got, want = loop(dev, stop_at, total), loop("cpu", stop_at, total)
        check(got == want and len(got[1]) <= math.ceil(math.log2(total))
              + 1, f"work_loop on the card {got[0]} after {len(got[1])} "
              f"grants, on the CPU {want[0]} after {len(want[1])}")
    say(f"schedulers over a 2^24 int64 CUDA tensor: schedule_join and "
        f"adaptive(132) == torch.sum exactly ({t_sched:.1f} ms both); "
        f"work_loop stops at the CPU's grant [{card}]")
    report["policy_host"] = dict(schedule_ms=t_sched)


def dense_configs_path(np, torch, seed, card, report, drain):
    """yi-9b (32/4 heads), chatglm3-6b (32/2, half-rotary) and
    minitron-4b (24/8, relu² FFN) at full width and depth in bf16, seeded
    random weights: 8 requests each through ContinuousEngine (prompts 64
    to 1024, max_new 16 to 32); K1 once per layer per prefill chunk, K2
    once per layer per decode step, no standalone combine.  Then
    minitron's fp32 check at full width, 2 layers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import Model
    out = {}
    for i, arch in enumerate(DENSE_ARCHS):
        cfg = get_config(arch)
        L, G = cfg.num_layers, cfg.num_heads // cfg.num_kv_heads
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg, device="cuda")
        params = model.init(seed)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        reqs = _requests(np, np.random.RandomState(seed + 20 + i), 8,
                         cfg.vocab_size, (16, 32))
        _build.reset_launches()
        model.calls = dict.fromkeys(model.calls, 0)
        done, secs, telemetry = _serve(torch, model, params, reqs, drain,
                                       continuous=True)
        launches, calls = _build.launches(), dict(model.calls)
        expect = {"flash_attention_fwd": L * calls["prefill_chunk"],
                  "flash_decode_partials": L * calls["decode_step"],
                  "flash_decode_combine": 0}
        got = {k: launches[k] for k in expect}
        check(calls["prefill"] == 0 and got == expect and all(
            got[k] > 0 for k in ("flash_attention_fwd",
                                 "flash_decode_partials")),
              f"{arch}: launches {got} != layers x (prefill chunks, decode "
              f"steps), no combine {expect}")
        n_merge = launches["flash_attention_merge"]
        n_fused = _build.KERNELS["flash_attention_fwd"].tags.get("fused", 0)
        check(n_merge % L == 0 and n_fused % L == 0
              and n_merge + n_fused <= launches["flash_attention_fwd"],
              f"{arch}: K1 split launches ({n_fused} fused, {n_merge} "
              f"merges) are not layers x split chunks")
        gen = sum(len(v) for v in done.values())
        peak = torch.cuda.max_memory_allocated()
        say(f"{arch}: {L} layers, {cfg.num_heads}/{cfg.num_kv_heads} heads "
            f"(G {G}), {cfg.ffn_type}, {cfg.param_count() / 1e9:.2f}B "
            f"params in {cfg.param_dtype} (init {t_init:.1f} s); "
            f"ContinuousEngine: 8 requests, {gen} tokens in {secs:.2f} s = "
            f"{gen / secs:.1f} tok/s; launches {got} = {L} layers x "
            f"({calls['prefill_chunk']} chunks, {calls['decode_step']} "
            f"decode steps), K1 split chunks {(n_fused + n_merge) // L} "
            f"({n_fused // L} fused); peak memory {peak / 2**30:.2f} GiB "
            f"[{card}]")
        out[arch] = dict(layers=L, launches=got, merge_launches=n_merge,
                         fused_split_launches=n_fused, calls=calls,
                         continuous_s=secs, tokens=gen, peak_bytes=peak,
                         telemetry=telemetry)
        del model, params, done
        free_card(torch)
    report["dense_configs"] = out
    cfg = dataclasses.replace(get_config("minitron-4b"), num_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    fp32_check(np, torch, seed, report, drain, cfg, "minitron-4b",
               "fp32_minitron", rng_seed=seed + 9)


# ---------------------------------------------------------------------------
# cross-attention: whisper-medium (encoder-decoder) and llama-3.2-vision-11b
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper-medium"
VISION_ARCH = "llama-3.2-vision-11b"
CROSS_BATCH = 4
CROSS_DECODE_STEPS = 32
WHISPER_FRAMES = 1500       # the encoder's positions (30 s of audio)


def _cross_stub(cfg):
    """(batch key, length) of a cross-attention model's modality stub."""
    return ("frames", WHISPER_FRAMES) if cfg.is_encdec else \
        ("image_embeds", cfg.num_image_tokens)


def _attn_counts():
    """K1 and K2 launches since the last reset, with K1's non-causal and
    fused launches and K2's group-1 launches (the wrappers' tags)."""
    from repro_torch.kernels import _build
    got = {k: n for k, n in _build.launches().items() if k in (
        "flash_attention_fwd", "flash_attention_merge",
        "flash_decode_partials", "flash_decode_combine")}
    k1 = _build.KERNELS["flash_attention_fwd"].tags
    got.update(noncausal=k1.get("noncausal", 0), fused=k1.get("fused", 0),
               group1=_build.KERNELS["flash_decode_partials"].tags.get(
                   "group 1", 0))
    return got


def cross_path(np, torch, dev, seed, card, report, breakdown, arch):
    """A cross-attention model at full width and depth in bf16, seeded
    random weights: ``Model.prefill`` of 4 prompts of
    ``decoder_prefill_len`` (1024) tokens with the modality stub (whisper:
    frames of 4 x 1500 x 1024; vision: image embeddings of 4 x 1601 x
    4096), the same prompts through ``ChunkedPrefill.run(batch=...)``
    (the cross K/V filled once by ``encode_to_cache``), compared with the
    full prefill's logits, then 32 ``decode_step``s.  Launches, exactly:
    prefill K1 once a self-attention layer (causal), once an encoder layer
    and once a cross layer (non-causal); a chunk K1 once a layer and once a
    cross layer; a decode step K2 once a layer and once a cross layer (the
    cross rows at their full length), no standalone combine.  Then the
    profile of one decode step (whisper) or one 256-token chunk at 736
    (vision).  Returns the launches by tag."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import Model
    from repro_torch.serve.prefill import ChunkedPrefill
    cfg = get_config(arch)
    V, L, D = cfg.vocab_size, cfg.num_layers, cfg.d_model
    B, S = CROSS_BATCH, cfg.decoder_prefill_len
    key, S_kv = _cross_stub(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda")
    params = model.init(seed)
    torch.cuda.synchronize()
    specs = model.prefix_specs + model.period_specs * model.repeats
    n_cross, n_enc = sum(s.has_cross for s in specs), cfg.encoder_layers
    per_chunk = L + n_cross
    say(f"{cfg.name}: {n_enc} encoder + {L} decoder layers, {n_cross} with "
        f"cross-attention over {S_kv} {key}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, d_model {D}, "
        f"{cfg.param_count() / 1e9:.2f}B params in {cfg.param_dtype}, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed + 40)
    tokens = torch.as_tensor(rng.randint(3, V, size=(B, S)),
                             dtype=torch.int32, device=dev)
    stub = torch.randn((B, S_kv, D), generator=torch.Generator(
        device=dev).manual_seed(seed + 41), device=dev).to(cfg.dtype())
    batch = {"tokens": tokens, key: stub}
    max_seq = S + CROSS_DECODE_STEPS

    def run(fn):
        _build.reset_launches()
        model.calls = dict.fromkeys(model.calls, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, _attn_counts(), \
            dict(model.calls)

    (logits, cache), t_prefill, pre, _ = run(
        lambda: model.prefill(params, batch, max_seq=max_seq))
    want = dict(flash_attention_fwd=n_enc + L + n_cross,
                noncausal=n_enc + n_cross, flash_decode_partials=0,
                flash_decode_combine=0)
    check({k: pre[k] for k in want} == want, f"{cfg.name} Model.prefill "
          f"{B} x {S}: launches {pre} != {want} (K1 once an encoder, self "
          f"and cross layer)")
    check(tuple(logits.shape) == (B, cfg.padded_vocab) and bool(
        torch.isfinite(logits[:, :V]).all()) and bool(
        (logits[:, V:] < -1e20).all()), f"{cfg.name} prefill logits "
        f"{tuple(logits.shape)}: not finite, or the padded vocab unmasked")
    check(tuple(cache["stage"][-1]["ck"].shape)[-4:-2] == (B, S_kv),
          f"{cfg.name}: the cross K/V cache is not {S_kv} positions long")
    say(f"{cfg.name} Model.prefill {B} x {S} with {key} {B} x {S_kv}: "
        f"{t_prefill:.2f} s, launches {pre} [{card}]")
    del cache

    cp = ChunkedPrefill(model)
    (clogits, ccache, stats), t_chunk, chu, calls = run(lambda: cp.run(
        params, tokens, model.init_cache(B, max_seq, cross_len=S_kv),
        batch=batch))
    n_chunks = calls["prefill_chunk"]
    want = dict(flash_attention_fwd=n_enc + per_chunk * n_chunks,
                noncausal=n_enc + n_cross * n_chunks,
                flash_decode_partials=0, flash_decode_combine=0)
    check(stats.tokens == S and n_chunks == stats.blocks > 1
          and {k: chu[k] for k in want} == want,
          f"{cfg.name} ChunkedPrefill.run(batch=...): launches {chu} != "
          f"{want} ({per_chunk} K1 a chunk, the encoder's {n_enc} once)")
    rel = float((clogits[:, :V].float() - logits[:, :V].float()).abs().max()
                / logits[:, :V].float().abs().max())
    check(rel <= TOL["bfloat16"], f"{cfg.name}: chunked prefill logits "
          f"{rel:.3g} (relative) from the full prefill's, tol "
          f"{TOL['bfloat16']}")
    say(f"{cfg.name} ChunkedPrefill.run(batch=...): {n_chunks} chunks in "
        f"{t_chunk:.2f} s, launches {chu} = {n_enc} encoder + {per_chunk} x "
        f"{n_chunks} chunks ({chu['fused']} fused split launches); logits "
        f"within {rel:.3g} of the full prefill's (max abs over max, tol "
        f"{TOL['bfloat16']}) [{card}]")

    def decode():
        tok = torch.argmax(clogits[:, :V], -1).to(torch.int32)
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        toks = []
        for _ in range(CROSS_DECODE_STEPS):
            out, _ = model.decode_step(params, tok, ccache, lengths)
            tok = torch.argmax(out[:, :V], -1).to(torch.int32)
            lengths += 1
            toks.append(tok)
        return out, torch.stack(toks, 1)

    (dlogits, dtoks), t_decode, dec, calls = run(decode)
    n_steps = calls["decode_step"]
    G = cfg.num_heads // cfg.num_kv_heads
    want = dict(flash_attention_fwd=0, flash_decode_partials=per_chunk
                * n_steps, flash_decode_combine=0,
                group1=per_chunk * n_steps if G == 1 else 0)
    check(n_steps == CROSS_DECODE_STEPS and {k: dec[k] for k in want}
          == want, f"{cfg.name} decode: launches {dec} != {want} (K2 once a "
          f"layer and once a cross layer a step, fused)")
    check(bool(torch.isfinite(dlogits[:, :V]).all()) and bool(
        ((dtoks >= 0) & (dtoks < V)).all()), f"{cfg.name} decode: logits "
        f"not finite or tokens out of range")
    say(f"{cfg.name}: {n_steps} decode steps x {B} rows in {t_decode:.2f} s "
        f"({B * n_steps / t_decode:.1f} tok/s), K2 launches "
        f"{dec['flash_decode_partials']} = {per_chunk} x {n_steps} (the "
        f"cross rows at {S_kv}) [{card}]")

    if cfg.is_encdec:
        lens = torch.full((B,), S + CROSS_DECODE_STEPS - 1,
                          dtype=torch.int32, device=dev)
        tok = dtoks[:, -1].contiguous()
        what, fn, reps = (f"decode step B={B} at {S + CROSS_DECODE_STEPS - 1}"
                          f" + cross {S_kv}", lambda: model.decode_step(
                              params, tok, ccache, lens), 5)
    else:
        pcache = model.init_cache(1, 2048, cross_len=S_kv)
        model.encode_to_cache(params, {key: stub[:1]}, pcache)
        model.prefill_chunk(params, tokens[:1, :736], pcache, 0)
        what, fn, reps = ("prefill chunk c=256 at 736, B=1 S=2048 + cross "
                          f"{S_kv}", lambda: model.prefill_chunk(
                              params, tokens[:1, 736:992], pcache, 736,
                              all_logits=True), 3)
    wall, groups = breakdown(fn, reps)
    dev_ms = sum(groups.values())
    peak = torch.cuda.max_memory_allocated()
    say(f"{cfg.name} {what}: wall {wall:.2f} ms, device {dev_ms:.2f} ms "
        f"({100 * dev_ms / wall:.0f}% busy: " + ", ".join(
            f"{g} {t:.2f}" for g, t in sorted(
                groups.items(), key=lambda kv: -kv[1]))
        + f"); peak memory {peak / 2**30:.2f} GiB [{card}]")
    report[f"cross_path {cfg.name}"] = dict(
        prefill_launches=pre, chunk_launches=chu, decode_launches=dec,
        chunks=n_chunks, prefill_s=t_prefill, chunked_s=t_chunk,
        decode_s=t_decode, chunked_vs_full_rel=rel, peak_bytes=peak,
        breakdown={what: dict(wall_ms=wall, device_ms=dev_ms,
                              busy=dev_ms / wall, groups=groups)})
    del params, model, ccache, logits, clogits, stub
    free_card(torch)
    return {k: pre[k] + chu[k] + dec[k] for k in pre}


def cross_fp32(np, torch, seed, report, arch):
    """fp32 at the model's full width: whisper with 2 encoder + 2 decoder
    layers, vision with one period of 5 layers (the 5th with cross).  The
    card's logits against the CPU plain path on the same weights
    (``Model.prefill`` of 2 x 300 with the stub, then 4 decode steps), and
    the card's ``ChunkedPrefill.run(batch=...)`` against its full prefill,
    each within ``LOGIT_TOL``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.prefill import ChunkedPrefill
    cfg = get_config(arch)
    cfg = dataclasses.replace(
        cfg, num_layers=2 if cfg.is_encdec else cfg.cross_attn_period,
        encoder_layers=2 if cfg.is_encdec else 0, param_dtype="float32",
        compute_dtype="float32")
    V = cfg.vocab_size
    key, S_kv = _cross_stub(cfg)
    model = Model(cfg, device="cuda")
    params = model.init(seed + 1)
    cpu_model = Model(cfg, device="cpu")
    cpu_params = _tree_to(params, "cpu")
    rng = np.random.RandomState(seed + 42)
    batch = {"tokens": torch.as_tensor(rng.randint(3, V, size=(2, 300)),
                                       dtype=torch.int32),
             key: torch.as_tensor(rng.randn(2, S_kv, cfg.d_model)
                                  .astype(np.float32))}
    gbatch = {k: v.cuda() for k, v in batch.items()}
    gl, gcache = model.prefill(params, gbatch, max_seq=320)
    cl, ccache = cpu_model.prefill(cpu_params, batch, max_seq=320)

    def err(a, b):
        return float((a[:, :V].float().cpu() - b[:, :V].float().cpu())
                     .abs().max())

    worst = err(gl, cl)
    chunked, _, _ = ChunkedPrefill(model).run(
        params, gbatch["tokens"], model.init_cache(2, 320, cross_len=S_kv),
        batch=gbatch)
    e_chunk = err(chunked, gl)
    lengths = torch.full((2,), 300, dtype=torch.int32)
    nxt = torch.argmax(cl[:, :V], -1).to(torch.int32)
    for _ in range(4):
        gl, gcache = model.decode_step(params, nxt.cuda(), gcache,
                                       lengths.cuda())
        cl, ccache = cpu_model.decode_step(cpu_params, nxt, ccache, lengths)
        worst = max(worst, err(gl, cl))
        nxt, lengths = torch.argmax(cl[:, :V], -1).to(torch.int32), \
            lengths + 1
    say(f"fp32 {cfg.name} logits ({cfg.encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers at full width, {key} {S_kv}), "
        f"card vs CPU plain path (prefill 2 x 300 + 4 decode steps): max abs "
        f"err {worst:.3g}; the card's chunked prefill vs its full prefill: "
        f"{e_chunk:.3g} (tol {LOGIT_TOL})")
    check(worst <= LOGIT_TOL, f"card {cfg.name} logits disagree with the "
          f"CPU")
    check(e_chunk <= LOGIT_TOL, f"card {cfg.name}: chunked prefill logits "
          f"disagree with the full prefill's")
    report[f"fp32 {cfg.name}"] = dict(max_logit_err=worst,
                                      chunked_vs_full=e_chunk)
    del model, params, cpu_model, cpu_params, gcache, ccache
    free_card(torch)


def moe_kernel_entries(rows, errs, launches):
    """K3 and K9a/b/c for the kernels line."""
    out = []
    for name, (source, replaces) in MOE_META.items():
        r = rows[name]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "max_err": errs[name], "tol": 0,
            "tol_kind": "bit for bit", "ms": r["ms"], "kernel_ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_computes": r["library_computes"], "shape": r["shape"],
            **({"other_shapes": r["other_shapes"]} if "other_shapes" in r
               else {})})
    return out


if __name__ == "__main__":
    main()
