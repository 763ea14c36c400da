#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out FILE]

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda``), torch built for CUDA and numpy.  Phases:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
   TF32 off for matmuls and convolutions;
1. build every kernel of the serving path from ``src/repro_torch/csrc``;
2. hold each kernel against its plain PyTorch version at the serving
   path's shapes (bf16 and fp32) and time kernel, plain version and the
   library yardstick ``F.scaled_dot_product_attention(enable_gqa=True)``;
3. the main path: llama3-8b at full width and full depth (32 layers, bf16,
   seeded random weights) serves 16 requests through ``ContinuousEngine``
   and 4 through the sync ``Engine``; every attention call must have
   launched a kernel (launch counters = layers x chunks / decode steps);
4. fp32 checks at full width, 2 layers: the card's logits against the CPU
   plain path on the same weights, and continuous-batching tokens against
   one-at-a-time tokens;
5. the kernels line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failed phase exits non-zero before the last line is printed.  Details
of every case go to ``--out`` (default ``build/chip_smoke.json``).
"""

import argparse
import dataclasses
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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    say(f"FAIL: {msg}")
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


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

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    say(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {src}: {line.strip()}")

    # ---------------------------------------------------------- 2. kernels
    report = {"card": card, "cases": [], "timings": {}}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    H, KV, hd = 32, 8, 128

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    worst = {}               # kernel → {dtype: max abs err}

    def record(kernel, dtype, e, **case):
        tol = TOL[str(dtype).split(".")[-1]]
        name = str(dtype).split(".")[-1]
        report["cases"].append(dict(kernel=kernel, dtype=name,
                                    max_abs_err=e, tol=tol, **case))
        w = worst.setdefault(kernel, {})
        w[name] = max(w.get(name, 0.0), e)
        check(math.isfinite(e) and e <= tol,
              f"{kernel} {name} {case}: max abs err {e:.3g} > tol {tol}")

    for dtype in (torch.bfloat16, torch.float32):
        for Sk in (2048, 1100):
            k = randn(1, Sk, KV, hd, dtype=dtype)
            v = randn(1, Sk, KV, hd, dtype=dtype)
            for c in (32, 64, 256):
                q = randn(1, c, H, hd, dtype=dtype)
                for off in (0, 96, 1792):
                    out = fa.flash_attention(q, k, v, causal=True,
                                             q_offset=off)
                    ref = fa.flash_attention_plain(q.float(), k.float(),
                                                   v.float(), causal=True,
                                                   q_offset=off)
                    torch.cuda.synchronize()
                    record("flash_attention_fwd", dtype, err(out, ref),
                           c=c, q_offset=off, Sk=Sk)
        for S in (2048, 1100):
            B = 8
            q = randn(B, H, hd, dtype=dtype)
            kc = randn(B, S, KV, hd, dtype=dtype)
            vc = randn(B, S, KV, hd, dtype=dtype)
            lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
            lens[0], lens[1] = 1, S
            lens = lens.to(torch.int32)
            m, l, acc = fd.decode_partials(q, kc, vc, lens)
            rm, rl, racc = fd.decode_partials_plain(q, kc, vc, lens)
            out = fd.combine(m, l, acc, dtype)
            ref = fd.combine_plain(m, l, acc, torch.float32)
            torch.cuda.synchronize()
            # partials are fp32 whatever the input dtype: fp32 tolerance
            e_part = max(err(m, rm), err(l, rl), err(acc, racc))
            record("flash_decode_partials", torch.float32, e_part, B=B, S=S,
                   input_dtype=str(dtype))
            record("flash_decode_combine", dtype, err(out, ref), B=B, S=S)
            e2e = err(fd.flash_decode(q, kc, vc, lens),
                      fd.flash_decode_plain(q.float(), kc.float(),
                                            vc.float(), lens))
            record("flash_decode (partials+combine)", dtype, e2e, B=B, S=S)
    for kname, w in worst.items():
        say(f"{kname}: max abs err " + ", ".join(
            f"{d} {e:.3g} (tol {TOL[d]})" for d, e in w.items()))

    # timing: CUDA graphs of back-to-back calls, so host launch overhead is
    # not in the number; K/V-reading kernels run after an L2 flush (the
    # serving path reads the cache cold), combine warm (its partials were
    # just written)
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

    import torch.nn.functional as F
    bf = torch.bfloat16

    def k1_case(c, off, Sk, B=1):
        q = randn(B, c, H, hd, dtype=bf)
        k = randn(B, Sk, KV, hd, dtype=bf)
        v = randn(B, Sk, KV, hd, dtype=bf)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = (off + torch.arange(c, device=dev)[:, None]
                >= torch.arange(Sk, device=dev)[None, :])
        pairs = sum(min(Sk, off + i + 1) for i in range(c))
        kv_len = min(Sk, off + c)
        flops = 4.0 * B * H * hd * pairs
        nbytes = 2.0 * (2 * B * c * H * hd + 2 * B * kv_len * KV * hd)
        bound = max(flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES)
        return dict(
            ms=device_ms(lambda: fa.flash_attention(
                q, k, v, causal=True, q_offset=off), cold=True),
            plain_ms=device_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=True, q_offset=off), cold=True),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), cold=True),
            library_computes="the same attention (offset causal mask)",
            bound_ms=bound * 1e3,
            bound_by="operations" if flops / PEAK_FLOPS["bfloat16"]
            > nbytes / PEAK_BYTES else "bytes",
            shape=dict(B=B, c=c, q_offset=off, Sk=Sk, H=H, KV=KV, hd=hd,
                       dtype="bfloat16"))

    def k2_case(B, S, lens):
        q = randn(B, H, hd, dtype=bf)
        kc = randn(B, S, KV, hd, dtype=bf)
        vc = randn(B, S, KV, hd, dtype=bf)
        lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        qt = q[:, :, None].contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        mask = (torch.arange(S, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        nk = fd.num_splits(S)
        m, l, acc = fd.decode_partials(q, kc, vc, lens)
        tot = int(lens.clamp(max=S).sum())
        p_flops = 4.0 * H * hd * tot
        p_bytes = (2.0 * B * H * hd + 2.0 * 2 * tot * KV * hd
                   + 4.0 * B * H * nk * (2 + hd))
        c_bytes = 4.0 * B * H * nk * (2 + hd) + 2.0 * B * H * hd
        shape = dict(B=B, S=S, H=H, KV=KV, hd=hd, dtype="bfloat16",
                     block_k=fd.BLOCK_K, splits=nk,
                     mean_length=tot / B)
        library = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), cold=True)
        part = dict(
            ms=device_ms(lambda: fd.decode_partials(q, kc, vc, lens),
                         cold=True),
            plain_ms=device_ms(lambda: fd.decode_partials_plain(
                q, kc, vc, lens), cold=True),
            library_ms=library,
            library_computes="the whole decode attention (partials+combine)",
            bound_ms=max(p_flops / PEAK_FLOPS["bfloat16"],
                         p_bytes / PEAK_BYTES) * 1e3,
            bound_by="bytes" if p_bytes / PEAK_BYTES
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
    for c in (32, 64, 256):
        for off in (0, 224, 736, 1792):
            if off + c <= 2048:
                r = k1_case(c, off, 2048)
                report["timings"][f"flash_attention_fwd c={c} off={off}"] = r
                say(f"K1 c={c} q_offset={off} Sk=2048 bf16: kernel "
                    f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
                    f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}) [{card}]")
    lens_rng = np.random.RandomState(args.seed)
    main_lens = lens_rng.randint(64, 1089, size=8)
    for S, lens in ((2048, main_lens), (2048, [2048] * 8),
                    (1100, np.minimum(main_lens, 1100))):
        part, comb = k2_case(8, S, lens)
        tag = f"B=8 S={S} mean_len={part['shape']['mean_length']:.0f}"
        report["timings"][f"flash_decode_partials {tag}"] = part
        report["timings"][f"flash_decode_combine {tag}"] = comb
        say(f"K2 {tag} bf16: partials {part['ms']:.4f} ms (plain "
            f"{part['plain_ms']:.4f}, bound {part['bound_ms']:.4f} "
            f"{part['bound_by']}), combine {comb['ms']:.4f} ms (plain "
            f"{comb['plain_ms']:.4f}, bound {comb['bound_ms']:.4f}), "
            f"sdpa decode {part['library_ms']:.4f} ms [{card}]")
    say(f"timing took {time.perf_counter() - t0:.1f} s")
    rows = {
        "flash_attention_fwd": report["timings"][
            "flash_attention_fwd c=256 off=736"],
        "flash_decode_partials": report["timings"][
            f"flash_decode_partials B=8 S=2048 mean_len="
            f"{main_lens.mean():.0f}"],
        "flash_decode_combine": report["timings"][
            f"flash_decode_combine B=8 S=2048 mean_len="
            f"{main_lens.mean():.0f}"],
    }
    del flush_buf

    # ---------------------------------------------------------- 3. main path
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
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
    launches_cont = _build.launches()
    t0 = time.perf_counter()
    se = Engine(model, params, EngineConfig(max_batch=4, max_seq=2048,
                                            eos_id=7))
    for r in sync_reqs:
        se.submit(r)
    sync_done = {r.rid: r for r in se.step()}
    torch.cuda.synchronize()
    t_sync = time.perf_counter() - t0
    launches = _build.launches()
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
    expect = {"flash_attention_fwd": L * calls["prefill_chunk"],
              "flash_decode_partials": L * calls["decode_step"],
              "flash_decode_combine": L * calls["decode_step"]}
    check(calls["prefill"] == 0, "the engines ran a non-chunked prefill")
    check(launches == expect, f"launch counts {launches} != layers x "
          f"(prefill chunks, decode steps) {expect}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    check(launches_cont["flash_attention_fwd"]
          == L * calls_cont["prefill_chunk"]
          and launches_cont["flash_decode_partials"]
          == L * calls_cont["decode_step"], "continuous-engine launches")
    gen_cont = sum(len(r.result) for r in done.values())
    gen_sync = sum(len(r.result) for r in sync_done.values())
    say(f"main path: launches {launches} = {L} layers x "
        f"{calls['prefill_chunk']} prefill chunks / "
        f"{calls['decode_step']} decode steps")
    say(f"ContinuousEngine: 16 requests, {gen_cont} tokens in {t_cont:.2f} s"
        f" = {gen_cont / t_cont:.1f} tok/s; Engine: 4 requests, {gen_sync} "
        f"tokens in {t_sync:.2f} s = {gen_sync / t_sync:.1f} tok/s; peak "
        f"memory {peak / 2**30:.2f} GiB [{card}]")
    report["main_path"] = dict(
        launches=launches, calls=calls, continuous_s=t_cont,
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
            g = ("flash_attention_fwd" if "flash_fwd_kernel" in name else
                 "flash_decode_partials" if "decode_partials_kernel" in name
                 else "flash_decode_combine" if "decode_combine_kernel" in name
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
    del dcache, pcache, params, model
    torch.cuda.empty_cache()

    # ------------------------------------------------- 4. fp32 at full width
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
    check(worst_logit <= LOGIT_TOL, "card logits disagree with the CPU")
    del cpu_model, cpu_params, ccache, gcache

    lens6, news6 = (40, 300, 77, 520, 129, 260), (10, 6, 14, 8, 12, 5)
    reqs6 = [Request(rid=i, prompt=rng.randint(3, cfg.vocab_size, size=n)
                     .astype(np.int32), max_new=mn)
             for i, (n, mn) in enumerate(zip(lens6, news6))]
    ref = {}
    for r in reqs6:
        eng = Engine(model, params, EngineConfig(max_batch=1, eos_id=7,
                                                 max_seq=2048))
        eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new))
        (d,) = eng.step()
        ref[r.rid] = np.asarray(d.result)
    ce = ContinuousEngine(model, params, EngineConfig(
        max_batch=3, eos_id=7, max_seq=1024, decode_tick=4))
    for r in reqs6:
        ce.submit(Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new))
    got = {rid: np.asarray(r.result) for rid, r in drain(ce).items()}
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
    report["fp32"] = dict(max_logit_err=worst_logit, near_ties=ties)

    # ---------------------------------------------------------- 5. report
    kernels = []
    meta = {
        "flash_attention_fwd": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:72"),
        "flash_decode_partials": ("src/repro_torch/csrc/flash_decode.cu",
                                  "src/repro/kernels/flash_decode.py:53"),
        "flash_decode_combine": ("src/repro_torch/csrc/flash_decode.cu",
                                 "src/repro/kernels/flash_decode.py:94"),
    }
    for name, (source, replaces) in meta.items():
        row, w = rows[name], worst[name]
        main_dtype = "float32" if name == "flash_decode_partials" \
            else "bfloat16"
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": w[main_dtype], "max_err": w[main_dtype],
            "tol": TOL[main_dtype],
            "max_abs_err_fp32": w.get("float32"),
            "ms": row["ms"], "kernel_ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_computes": row.get("library_computes"),
            "shape": row["shape"]})
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


if __name__ == "__main__":
    main()
