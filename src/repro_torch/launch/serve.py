"""Serving launcher: batched requests through the Kvik-policy engine, on the
card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --requests 8 --max-new 32 [--engine continuous|sync] [--layers N] \
        [--smoke] [--device cuda|cpu]

Chunked (by_blocks) prefill + find_first early-exit decode; per-request
wasted-work stats are printed.  ``--layers`` cuts the depth for a quick run
(``--arch llama4-scout-17b-a16e --layers 12`` fits one 80 GB card); the
width is always the config's.  MoE configs serve with the dropless sort
dispatch routed by K3 (``moe_strategy="sort"``, ``moe_sort_fn="pallas"``).
Weights are random, drawn from ``--seed``.  Like the reference's
launcher, it serves decoder-only models: whisper-medium and
llama-3.2-vision-11b raise ``ValueError`` before their weights are drawn
(their path is ``ChunkedPrefill.run(batch=...)`` and
``Model.decode_step``).  jamba-1.5-large-398b runs with ``--smoke`` only.
"""

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs.registry import (ARCH_IDS, NOT_PORTED, get_config,
                                          get_smoke_config)
from repro_torch.models.model import Model
from repro_torch.serve.engine import (ContinuousEngine, Engine, EngineConfig,
                                      Request, check_servable)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b",
                    choices=ARCH_IDS + sorted(NOT_PORTED))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--eos-id", type=int, default=7)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", choices=("continuous", "sync"),
                    default="continuous")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth override (width never changes)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    moe = dict(moe_strategy="sort", moe_sort_fn="pallas") if cfg.is_moe \
        else {}
    model = Model(cfg, device=args.device, **moe)
    check_servable(model)
    params = model.init(args.seed)
    print(f"[launch.serve] {cfg.name}: {cfg.param_count() / 1e6:.1f}M "
          f"params, {cfg.num_layers} layers on {model.device}"
          + (" (MoE: sort dispatch, K3 routing)" if cfg.is_moe else ""))

    ecfg = EngineConfig(max_batch=args.max_batch, eos_id=args.eos_id)
    engine = (ContinuousEngine if args.engine == "continuous" else Engine)(
        model, params, ecfg)
    rng = np.random.RandomState(args.seed)
    for rid in range(args.requests):
        plen = int(rng.randint(8, 48))
        engine.submit(Request(
            rid=rid, prompt=rng.randint(3, cfg.vocab_size,
                                        plen).astype(np.int32),
            max_new=args.max_new))
    served = 0
    t0 = time.perf_counter()
    while True:
        batch = engine.step()
        for r in batch:
            served += 1
            print(f"[launch.serve] req {r.rid}: {len(r.result)} tokens, "
                  f"decode-blocks={r.stats.blocks}, "
                  f"wasted={r.stats.wasted_fraction:.1%}")
        if not (engine.pending if args.engine == "continuous" else batch):
            break
    print(f"[launch.serve] served {served}/{args.requests} with the "
          f"{args.engine} engine in {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
