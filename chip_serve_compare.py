#!/usr/bin/env python3
"""The server cell of ``chip_smoke.py`` phases 3 and 4 for several
checkouts of this repo, run alternately in one session on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_serve_compare.py [--repeats N] DIR [DIR ...]
    python3 chip_serve_compare.py --prefix

Each ``DIR`` is the root of a checkout (``.`` for this one; an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  Each run is a fresh process that imports ``DIR``'s package and
``DIR``'s ``chip_smoke.py`` and drives that checkout's server through its
own ``serve()`` and ``report()``: GPT-2-small from ``SEED``, 4 rank-16
tenants plus the base, the 10 greedy requests, in f32 and then in bf16.
With two checkouts the runs go A B B A A B ..., so that a drift of the
card or of the shared host over the session falls on both.  Prints each
run's TTFT p50, inter-token p50 and output tokens/s with the card's name
and power limit, whether every checkout's token streams are the same, and
last a JSON summary with each checkout's readings and their min, median
and max.  Exits 1 without a card, or if a run fails.

``--prefix`` instead takes ``chip_smoke.py`` phase 12 (e) apart in this
checkout: the second wave of the shared-prefix requests admitted with
and without the prefix cache, every step timed (synchronised), then the
same again under ``torch.profiler``: each step's wall and admissions,
the second wave's TTFTs, the device-busy time, the kernels and the CUDA
runtime calls by count.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

METRICS = ("ttft_p50_ms", "itl_p50_ms", "tokens_per_s")


def run_one(root: str) -> int:
    """Child: one f32 and one bf16 server run of the checkout at
    ``root``; prints ``RESULT {json}``."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from ray_lightning_tpu_torch.models.gpt import (
        GPT, GPTConfig, synthetic_lora_adapter,
    )
    from ray_lightning_tpu_torch.serve.engine import ServeConfig, ServeEngine

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cfg = GPTConfig.gpt2_small()
    module = GPT(cfg, precision="f32", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    params = module.init_params(gen)
    lora_cfg = dataclasses.replace(cfg, lora_rank=16)
    tenants = {}
    for i in range(cs.N_TENANTS):
        tenants[f"tenant{i}"], _ = synthetic_lora_adapter(
            params, lora_cfg, gen, scale=0.3)
    serve_cfg = ServeConfig(num_slots=cs.DECODE_W, block_size=16,
                            max_adapters=cs.N_TENANTS, adapter_rank=16)
    reqs = cs.make_requests(np, tenants)
    out = {"card": card}
    for precision in ("f32", "bf16"):
        m = module if precision == "f32" else GPT(cfg, precision="bf16",
                                                  device="cuda")
        engine, tokens, wall, launches, peak = cs.serve(
            torch, ServeEngine, m, params, serve_cfg, tenants, reqs)
        rec = cs.report(f"{root} {precision}", engine, tokens, wall,
                        launches, peak, cfg, card)
        rec["streams"] = hashlib.sha256(
            json.dumps(tokens).encode()).hexdigest()[:16]
        out[precision] = rec
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def prefix_wave(torch, np, cs, world, on, prof=None):
    """Phase 12 (e)'s requests on a fresh engine: the first wave until
    its first tokens land, then the second wave submitted and stepped
    until every one of its first tokens has landed.  Returns each step's
    (wall ms, prefills) and the second wave's TTFTs in ms."""
    from ray_lightning_tpu_torch.serve.engine import ServeEngine

    rng = np.random.default_rng(cs.SEED + 5)
    system = rng.integers(0, 50257, size=(cs.SYSTEM_PREFIX,)).tolist()
    keys = (None, "tenant0", "tenant1")
    reqs = [(system + rng.integers(0, 50257, size=(int(n),)).tolist(), 32,
             keys[i % 3])
            for i, n in enumerate(rng.integers(16, 129, size=10))]
    cfg = dataclasses.replace(world["serve_cfg"], prefix_cache=on)
    engine = ServeEngine(world["module"], world["params"], cfg,
                         adapters=world["tenants"], device="cuda")
    first = [engine.submit(p, n, adapter=a) for p, n, a in reqs[:3]]
    while not all(h.request.generated for h in first):
        engine.step()
    torch.cuda.synchronize()
    if prof is not None:
        prof.start()
    rest = [engine.submit(p, n, adapter=a) for p, n, a in reqs[3:]]
    steps = []
    while not all(h.request.generated for h in rest):
        before = engine.snapshot()["counters"]["prefills"]
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        steps.append(((time.perf_counter() - t0) * 1e3,
                      engine.snapshot()["counters"]["prefills"] - before))
    if prof is not None:
        prof.stop()
    ttft = [(h.request.first_token_t - h.request.arrival_t) * 1e3
            for h in rest]
    engine.run_until_idle()
    return steps, ttft


def run_prefix() -> int:
    """``--prefix``: phase 12 (e)'s second wave, cache on and off, timed
    and then profiled."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    world = cs.server_world(torch, np)
    prefix_wave(torch, np, cs, world, True)  # warm-up: builds, allocator
    out = {}
    for on in (True, False, True, False):
        steps, ttft = prefix_wave(torch, np, cs, world, on)
        label = "cache on" if on else "cache off"
        print(f"prefix {label}: steps (ms, prefills) "
              f"{[(round(w, 2), n) for w, n in steps]}; second-wave TTFT "
              f"{sorted(round(t, 1) for t in ttft)} ms; {card}", flush=True)
        out.setdefault(label, []).append({"steps": steps, "ttft": ttft})
    for on in (True, False):
        label = "cache on" if on else "cache off"
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        steps, ttft = prefix_wave(torch, np, cs, world, on, prof)
        events = prof.events()
        device = {}
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device[e.name] = (device.get(e.name, 0.0)
                                  + e.time_range.elapsed_us())
        api = {}
        for e in events:
            if e.name.startswith("cuda") and \
                    e.device_type != torch.autograd.DeviceType.CUDA:
                n, us = api.get(e.name, (0, 0.0))
                api[e.name] = (n + 1, us + e.time_range.elapsed_us())
        busy = sum(device.values())
        wall = sum(w for w, _ in steps)
        print(f"prefix {label} profiled: {len(steps)} steps, wall "
              f"{wall:.1f} ms (profiler on), device busy {busy / 1e3:.1f} "
              f"ms; {card}")
        for name, us in sorted(device.items(), key=lambda kv: -kv[1])[:10]:
            print(f"prefix {label}:   {us / 1e3:8.2f} ms  {name[:90]}")
        for name, (n, us) in sorted(api.items(),
                                    key=lambda kv: -kv[1][1])[:8]:
            print(f"prefix {label}:   {n:6d} calls {us / 1e3:8.2f} ms  "
                  f"{name}")
        out[label + " profiled"] = {
            "steps": steps, "ttft": ttft, "device_busy_ms": busy / 1e3,
            "api": {k: list(v) for k, v in api.items()}}
    print(json.dumps({"card": card, "prefix": out}))
    return 0


def order(dirs, repeats):
    """A B B A A B ... for two checkouts; rotations for more."""
    seq = []
    for r in range(repeats):
        seq.extend(dirs if r % 2 == 0 else dirs[::-1])
    return seq


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--prefix", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return run_one(args.one)
    import torch

    if not torch.cuda.is_available():
        print("chip_serve_compare: no CUDA device is available",
              file=sys.stderr)
        return 1
    if args.prefix:
        return run_prefix()
    if not args.dirs:
        ap.error("name at least one checkout")
    for d in args.dirs:
        if not os.path.isfile(os.path.join(d, "chip_smoke.py")):
            print(f"chip_serve_compare: {d} is not a checkout",
                  file=sys.stderr)
            return 1
    runs = {d: [] for d in args.dirs}
    for d in order(args.dirs, args.repeats):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", d], capture_output=True, text=True,
                           timeout=900)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if p.returncode or not lines:
            print(p.stdout[-4000:])
            print(p.stderr[-4000:], file=sys.stderr)
            print(f"chip_serve_compare: the run of {d} failed",
                  file=sys.stderr)
            return 1
        rec = json.loads(lines[-1][len("RESULT "):])
        runs[d].append(rec)
        print(f"{d}: " + "; ".join(
            f"{pr} TTFT p50 {rec[pr]['ttft_p50_ms']} ms, ITL p50 "
            f"{rec[pr]['itl_p50_ms']} ms, {rec[pr]['tokens_per_s']:.1f} "
            f"tokens/s" for pr in ("f32", "bf16")) + f"; {rec['card']}",
            flush=True)
    summary = {}
    for d, recs in runs.items():
        summary[d] = {}
        for pr in ("f32", "bf16"):
            row = {"streams": sorted({r[pr]["streams"] for r in recs})}
            for m in METRICS:
                xs = [r[pr][m] for r in recs]
                row[m] = {"runs": xs, "min": min(xs),
                          "median": statistics.median(xs), "max": max(xs)}
            summary[d][pr] = row
    for pr in ("f32", "bf16"):
        same = len({s for d in summary for s in summary[d][pr]["streams"]})
        print(f"{pr}: every run of every checkout emits the same streams: "
              f"{same == 1}")
    print(json.dumps({"card": runs[args.dirs[0]][0]["card"],
                      "serve": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
