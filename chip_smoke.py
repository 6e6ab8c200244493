#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It builds every CUDA kernel of the port from ``ray_lightning_tpu_torch/
ops/csrc``, holds each against its plain PyTorch version on the card,
times it, then drives the port's main path — multi-tenant LoRA serving of
GPT-2-small through ``ServeEngine`` — and checks that the path went
through the kernels and that its greedy tokens equal the port's static
``generate()`` on each tenant's merged weights.  Phases:

0. device and build: the card's name and power limit, TF32 off, each
   kernel built (one nvcc per source, all at once) with its registers and
   shared memory;
1. kernel vs plain at the main path's shapes, f32 and bf16, plus a batch
   of null-adapter rows whose delta must be exactly 0.0;
2. kernel timing (CUDA graphs of back-to-back launches over rotating
   inputs larger than L2, as the main path finds them) beside the plain
   version and the least time the card could take;
3. the server in f32: GPT-2-small with random weights from a seed, 4
   synthetic rank-16 tenants plus the base model, 10 greedy requests;
4. the same requests at bf16 (tokens not compared).

Any failure raises: the script exits non-zero and prints no result.  The
line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 0
# NVIDIA H100 SXM data sheet: HBM3 bytes/s; dense f32 (CUDA cores) and
# bf16 (tensor cores) operations/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
BGMV_SOURCE = "ray_lightning_tpu_torch/ops/csrc/bgmv.cu"
BGMV_REPLACES = "ray_lightning_tpu/ops/lora.py:101"
D_MODEL = 768          # GPT-2-small width
RANKS = (8, 16, 64)
N_TENANTS = 4
DECODE_W = 8           # ServeConfig.num_slots
PREFILL_W = 512        # the longest prompt's prefill bucket


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# -- phase 1 and 2: the kernel --------------------------------------------

def bgmv_inputs(torch, W, k, r, dtype, mixed, gen, copies=1):
    """``copies`` independent (h, a, b, ids) sets at one shape.  Slot 0
    is the null adapter; ``mixed`` rows cycle through all N slots (a
    decode batch of every tenant and the base model), otherwise every row
    has tenant 1 (one prefill)."""
    n = N_TENANTS + 1
    if mixed:
        ids = (torch.arange(W, device="cuda") % n).to(torch.int32)
    else:
        ids = torch.ones(W, dtype=torch.int32, device="cuda")
    sets = []
    for _ in range(copies):
        h = torch.randn(W, D_MODEL, generator=gen, device="cuda")
        a = torch.randn(n, D_MODEL, r, generator=gen, device="cuda") * 0.05
        b = torch.randn(n, r, k, generator=gen, device="cuda") * 0.3
        a[0] = 0.0
        b[0] = 0.0
        sets.append((h.to(dtype), a.to(dtype), b.to(dtype), ids))
    return sets


def bound(W, k, r, dtype_name, distinct):
    """(least ms, what bounds it) for one BGMV call: each input byte read
    once (h, ids and the ``distinct`` adapters' factors), the output
    written once, and 2·W·r·(d + k) operations at the dtype's peak."""
    es = 2 if dtype_name == "bfloat16" else 4
    nbytes = (W * D_MODEL * es + W * 4 + distinct * r * (D_MODEL + k) * es
              + W * k * es)
    ops = 2 * W * r * (D_MODEL + k)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(torch, fn, arg_sets, reps=20):
    """Device ms per call: one CUDA graph holding a call on each input
    set, replayed ``reps`` times between two events (no host launch cost
    inside the timed window)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for args in arg_sets[:2]:
            fn(*args)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def eager_ms(torch, fn, arg_sets, reps=20):
    """Wall ms per call issued from Python one by one (host launch cost
    included), the way the engine issues it."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for args in arg_sets:
            fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def phase_kernel(torch, lora, card):
    """Phases 1 and 2.  Returns the JSON record fields measured at the
    main path's most frequent call: decode qkv, f32, rank 16."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shapes = [(W, k) for W in (DECODE_W, PREFILL_W) for k in (3 * D_MODEL,
                                                               D_MODEL)]
    for dtype in (torch.float32, torch.bfloat16):
        for W, k in shapes:
            for r in RANKS:
                ((h, a, b, ids),) = bgmv_inputs(torch, W, k, r, dtype,
                                                W == DECODE_W, gen)
                got = lora.bgmv(h, a, b, ids)
                ref = lora.bgmv_plain(h, a, b, ids)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                tol = (1e-5 * scale + 1e-6 if dtype == torch.float32
                       else 2e-2 * scale)
                print(f"phase 1: bgmv {str(dtype)[6:]} W={W} d={D_MODEL} "
                      f"r={r} k={k}: max_abs_err={err:.3e} "
                      f"max|ref|={scale:.3e} tol={tol:.3e}")
                check(err <= tol, f"bgmv W={W} k={k} r={r} {dtype}")
                zero = lora.bgmv(h, a, b, torch.zeros_like(ids))
                torch.cuda.synchronize()
                check(bool((zero == 0).all()),
                      f"null-slot delta not exactly 0.0 at W={W} k={k}")
    print("phase 1: null-adapter rows gave exactly 0.0 at every shape")
    # Ragged edges: a rank that does not divide the block, a width that is
    # no multiple of the column tile.
    for dtype in (torch.float32, torch.bfloat16):
        ((h, a, b, ids),) = bgmv_inputs(torch, 3, 1000, 100, dtype, True,
                                        gen)
        got, ref = lora.bgmv(h, a, b, ids), lora.bgmv_plain(h, a, b, ids)
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = 1e-5 * scale + 1e-6 if dtype == torch.float32 else 2e-2 * scale
        print(f"phase 1: bgmv {str(dtype)[6:]} ragged W=3 r=100 k=1000: "
              f"max_abs_err={err:.3e} tol={tol:.3e}")
        check(err <= tol, f"bgmv ragged {dtype}")

    record = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for W, k in shapes:
            r = 16
            probe = bgmv_inputs(torch, W, k, r, dtype, W == DECODE_W, gen)
            per_call = sum(t.numel() * t.element_size() for t in probe[0])
            # Rotate over inputs adding up to more than the 50 MB L2, as
            # the engine finds them: between two calls of one site a
            # whole model's weights stream through the cache.
            copies = max(2, min(64, -(-64 * 2**20 // per_call)))
            sets = bgmv_inputs(torch, W, k, r, dtype, W == DECODE_W, gen,
                               copies)
            ms = graph_ms(torch, lora.bgmv, sets)
            plain_ms = graph_ms(torch, lora.bgmv_plain, sets)
            eager = eager_ms(torch, lora.bgmv, sets)
            distinct = len(set(sets[0][3].tolist()))
            bound_ms, bound_by = bound(W, k, r, name, distinct)
            print(f"phase 2: bgmv {name} W={W} r={r} k={k} U={distinct}: "
                  f"kernel {ms * 1e3:.2f} us (graph), {eager * 1e3:.2f} us "
                  f"(eager, host issue included); plain {plain_ms * 1e3:.2f}"
                  f" us; bound {bound_ms * 1e3:.3f} us ({bound_by}); "
                  f"library none; {card}")
            if dtype == torch.float32 and W == DECODE_W and k == 3 * D_MODEL:
                h, a, b, ids = sets[0]
                err = (lora.bgmv(h, a, b, ids)
                       - lora.bgmv_plain(h, a, b, ids)).abs().max().item()
                record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
    return record


# -- phases 3 and 4: the server --------------------------------------------

def make_requests(np, tenants):
    """10 greedy requests mixing the tenants and the base model: prompts
    of 32-512 tokens, 32-64 new tokens each."""
    rng = np.random.default_rng(SEED)
    names = [None] + sorted(tenants)
    reqs = []
    for i in range(10):
        n_prompt = 512 if i == 0 else int(rng.integers(32, 513))
        prompt = rng.integers(0, 50257, size=(n_prompt,)).tolist()
        reqs.append((prompt, int(rng.integers(32, 65)),
                     names[i % len(names)]))
    return reqs


def serve(torch, engine_cls, module, params, serve_cfg, adapters, reqs):
    """Drive one engine over ``reqs``; returns (engine, tokens, wall s,
    BGMV launches during the run, peak bytes)."""
    from ray_lightning_tpu_torch.ops import lora

    warm = engine_cls(module, params, serve_cfg, adapters=adapters,
                      device="cuda")
    warm.generate(reqs[1][0][:32], 4, adapter=reqs[1][2])
    del warm
    engine = engine_cls(module, params, serve_cfg, adapters=adapters,
                        device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lora.bgmv.launches = 0
    t0 = time.perf_counter()
    handles = [engine.submit(p, n, adapter=a) for p, n, a in reqs]
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lora.bgmv.launches
    peak = torch.cuda.max_memory_allocated()
    tokens = [h.result(0) for h in handles]
    return engine, tokens, wall, launches, peak


def report(label, engine, tokens, wall, launches, peak, cfg, card):
    snap = engine.snapshot()
    c = snap["counters"]
    steps = c["prefills"] + c["decode_steps"]
    print(f"{label}: {c['completed']}/{len(tokens)} requests finished, "
          f"{c['prefills']} prefills + {c['decode_steps']} decode ticks, "
          f"bgmv launches {launches} (= {2 * cfg.n_layer} x {steps}: "
          f"{launches == 2 * cfg.n_layer * steps}), preempted "
          f"{c['preempted']}")
    check(c["completed"] == len(tokens), f"{label}: every request finishes")
    check(launches > 0 and launches == 2 * cfg.n_layer * steps,
          f"{label}: bgmv launched twice per layer per prefill and tick")
    out_tokens = sum(len(t) for t in tokens)
    lat = snap["latency"]
    print(f"{label}: TTFT p50 {lat['ttft']['p50_ms']} ms, inter-token p50 "
          f"{lat['token']['p50_ms']} ms, {out_tokens / wall:.1f} output "
          f"tokens/s ({out_tokens} tokens in {wall:.3f} s), peak memory "
          f"{peak / 2**30:.3f} GiB; {card}")
    return {"requests": len(tokens), "launches": launches,
            "prefills": c["prefills"], "decode_ticks": c["decode_steps"],
            "ttft_p50_ms": lat["ttft"]["p50_ms"],
            "itl_p50_ms": lat["token"]["p50_ms"],
            "tokens_per_s": out_tokens / wall, "peak_gib": peak / 2**30}


def profile_run(torch, engine_cls, module, params, serve_cfg, adapters,
                reqs, card):
    """Where a run's time goes: the same requests on a fresh engine under
    torch.profiler (CPU + CUDA activity).  Prints the device-busy share
    of the wall time and the kernels by device time; the profiler's own
    host cost inflates the wall, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    engine = engine_cls(module, params, serve_cfg, adapters=adapters,
                        device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p, n, a in reqs:
            engine.submit(p, n, adapter=a)
        engine.run_until_idle()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        print("phase 3 profile: device time not measured (the profiler "
              "recorded no CUDA events)")
        return None
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    bgmv_us = sum(v for k, v in by_name.items() if "bgmv" in k)
    print(f"phase 3 profile: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%), bgmv "
          f"{bgmv_us / 1e3:.2f} ms ({100 * bgmv_us / busy:.1f}% of device "
          f"time), {len(device)} device events; {card}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"phase 3 profile:   {100 * us / busy:5.1f}%  {us / 1e3:8.2f}"
              f" ms  {name[:100]}")
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us, "bgmv_ms": bgmv_us / 1e3,
            "bgmv_share_of_device": bgmv_us / busy}


def top2_gap(torch, gen_mod, module, params, seq):
    """The static reference's top-2 logit gap for the token after
    ``seq``."""
    cfg = module.config
    cache = gen_mod.init_kv_cache(cfg, 1, len(seq), device="cuda")
    logits, _ = gen_mod.prefill(
        cfg, params, cache, torch.tensor([seq], device="cuda"),
        compute_dtype=module._compute_dtype(),
    )
    top = torch.topk(logits[0], 2).values
    return (top[0] - top[1]).item()


def phase_server(torch, np, card):
    from ray_lightning_tpu_torch.models import generate as gen_mod
    from ray_lightning_tpu_torch.models.gpt import (
        GPT, GPTConfig, synthetic_lora_adapter,
    )
    from ray_lightning_tpu_torch.serve.engine import ServeConfig, ServeEngine

    cfg = GPTConfig.gpt2_small()
    module = GPT(cfg, precision="f32", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = module.init_params(gen)
    lora_cfg = dataclasses.replace(cfg, lora_rank=16)
    tenants, merged = {}, {None: params}
    for i in range(N_TENANTS):
        adapter, merged_i = synthetic_lora_adapter(params, lora_cfg, gen,
                                                   scale=0.3)
        tenants[f"tenant{i}"] = adapter
        merged[f"tenant{i}"] = merged_i
    serve_cfg = ServeConfig(num_slots=DECODE_W, block_size=16,
                            max_adapters=N_TENANTS, adapter_rank=16)
    reqs = make_requests(np, tenants)
    print(f"phase 3: GPT-2-small (L={cfg.n_layer}, d={cfg.d_model}, "
          f"V={cfg.vocab_size}) f32, {N_TENANTS} tenants rank 16 + base, "
          f"{len(reqs)} greedy requests, prompts "
          f"{min(len(p) for p, _, _ in reqs)}-"
          f"{max(len(p) for p, _, _ in reqs)} tokens, "
          f"{sum(n for _, n, _ in reqs)} new tokens in all")
    engine, tokens, wall, launches, peak = serve(
        torch, ServeEngine, module, params, serve_cfg, tenants, reqs)
    f32 = report("phase 3", engine, tokens, wall, launches, peak, cfg, card)

    exact = 0
    for (prompt, n, name), got in zip(reqs, tokens):
        ref = gen_mod.generate(module, merged[name], [prompt], n,
                               device="cuda")[0, len(prompt):].tolist()
        if got == ref:
            exact += 1
            continue
        i = next(j for j, (x, y) in enumerate(zip(got, ref)) if x != y)
        gap = top2_gap(torch, gen_mod, module, merged[name],
                       prompt + ref[:i])
        print(f"phase 3: {name or 'base'} stream diverges from generate() "
              f"at token {i}; reference top-2 logit gap {gap:.3e}")
        check(gap < 1e-4, f"divergence at a top-2 gap {gap} >= 1e-4")
    print(f"phase 3: {exact}/{len(reqs)} streams equal generate() on the "
          f"merged weights token for token; the rest diverge only at a "
          f"near tie")
    f32["exact_streams"] = exact
    f32["profile"] = profile_run(torch, ServeEngine, module, params,
                                 serve_cfg, tenants, reqs, card)

    module_bf16 = GPT(cfg, precision="bf16", device="cuda")
    engine, tokens, wall, launches, peak = serve(
        torch, ServeEngine, module_bf16, params, serve_cfg, tenants, reqs)
    bf16 = report("phase 4 (bf16)", engine, tokens, wall, launches, peak,
                  cfg, card)
    return f32, bf16


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np

    from ray_lightning_tpu_torch.ops import _build, lora

    card = card_line()
    print(card)
    print(f"phase 0: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__}"
          f", CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 0: TF32 off for matmul and cuDNN (f32 products in full "
          "f32)")
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        builds = list(pool.map(_build.build, sources))
    print(f"phase 0: built {len(builds)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s wall")
    for b in builds:
        print(f"phase 0: {b.name}: nvcc {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"phase 0:   {line.strip()}")

    record = phase_kernel(torch, lora, card)
    f32, bf16 = phase_server(torch, np, card)

    print('kernels: ["bgmv"]')
    print("server: " + json.dumps({"f32": f32, "bf16": bf16,
                                   "card": card}))
    print(json.dumps({"kernels": [{
        "name": "bgmv", "route": "cuda", "source": BGMV_SOURCE,
        "replaces": BGMV_REPLACES, "launches": f32["launches"],
        **record, "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
