#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It builds every CUDA kernel of the port from ``ray_lightning_tpu_torch/
ops/csrc``, holds each against its plain PyTorch version on the card,
times it, then drives the port's two main paths: multi-tenant LoRA
serving of GPT-2-small through ``ServeEngine`` (its greedy tokens equal
the port's static ``generate()`` on each tenant's merged weights), and
``Trainer.fit`` of GPT-2-small in its headline configuration (the JAX
package's one-chip ``bench.py`` program: the LayerNorm, flash-attention and
fused LM-head cross-entropy kernels at every site, blocks rematerialised
under ``remat_policy="dots+flash"``), counted per step.  Phases:

0. device and build: the card's name and power limit, TF32 off, each
   kernel built (one nvcc per source, all at once) with its registers,
   shared memory and spills;
1. BGMV vs plain at the serving path's shapes, f32 and bf16, plus a batch
   of null-adapter rows whose delta must be exactly 0.0;
2. BGMV timing (CUDA graphs of back-to-back launches over rotating inputs
   larger than L2, as the main path finds them) beside the plain version
   and the least time the card could take;
3. the server in f32: GPT-2-small with random weights from a seed, 4
   synthetic rank-16 tenants plus the base model, 10 greedy requests;
4. the same requests at bf16 (tokens not compared);
5. LayerNorm, flash-attention and CE kernels vs plain, forward and
   backward (each backward pair on the same saved statistics), at the
   training path's shapes (and ragged, D=128 or d=1536 or 1600 ones): f32
   within 1e-5·max|ref| + 1e-6 (CE also by the measures below at f32
   limits), bf16 by its worst row, relative Frobenius error and worst
   tile's bias (``bf16_measures``); at the CE main shape in both dtypes,
   kernels and plain versions each against one f64 evaluation;
6. their timing beside the plain version, the PyTorch library call
   (``F.layer_norm``, ``F.scaled_dot_product_attention``; for CE, which no
   single call computes, the cuBLAS time of the same products and the
   vocab-chunk scan it replaces; yardsticks only, never on the path) and
   the bound; the flash forward must take at most 2x the SDPA call and
   the backward at most 1.5x SDPA's flash backward, the bf16 LN backward
   at most 0.75x ``native_layer_norm_backward`` and the bf16 CE forward at
   most 2x cuBLAS x·Wᵀ; the LN backward's kernels each timed by the
   profiler; the registers, shared memory and resident blocks (LN
   backward, flash) or clusters (the bf16 CE backward, launched as
   thread-block clusters, one block per slice of d) of each kernel that
   keeps its work in registers;
7. the trainer: GPT-2-small, batch 16 x 1024 tokens, bf16, three arms —
   (a) the headline, (b) CE kernels without remat, (c) the CE scan
   (``GPT(ce_kernel=False)``) without remat — each warmed up, then a
   measured fit whose kernel launches per step must be exact (a: 49 / 25 /
   12 / 12 / 1 / 1 / 1 for LN fwd, LN bwd, flash fwd, flash bwd, CE fwd,
   dx, dW), with tokens/s, MFU and peak memory ((a) below (b)); a
   torch.profiler window over (a); then a depth-2 step per remat policy
   with its launch gates;
8. end-to-end checks on the headline configuration: one bf16 training
   step of the full-width model, its gradients on the card (kernels)
   against the CPU's (plain versions, same roundings); a 3-step f32 fit on
   the card against the same fit on the CPU; and a bf16 card fit against
   the f32 one.

Any failure raises: the script exits non-zero and prints no result.  The
line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
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
SOURCES = {
    "ln": "ray_lightning_tpu_torch/ops/csrc/layer_norm.cu",
    "flash": "ray_lightning_tpu_torch/ops/csrc/flash_attention.cu",
    "ce": "ray_lightning_tpu_torch/ops/csrc/cross_entropy.cu",
}
REPLACES = {
    "ln_fwd": "ray_lightning_tpu/ops/layer_norm.py:111",
    "ln_bwd": "ray_lightning_tpu/ops/layer_norm.py:144",
    "flash_fwd": "ray_lightning_tpu/ops/flash_attention.py:152",
    "flash_bwd": "ray_lightning_tpu/ops/flash_attention.py:271",
    "ce_fwd": "ray_lightning_tpu/ops/cross_entropy.py:248",
    "ce_bwd_dx": "ray_lightning_tpu/ops/cross_entropy.py:424",
    "ce_bwd_dw": "ray_lightning_tpu/ops/cross_entropy.py:441",
}
TRAIN_KERNELS = tuple(REPLACES)
VOCAB = 50304          # GPT-2-small's padded vocabulary
# The headline training configuration: the JAX package's bench.py
# _bench_fit program on one chip (every kernel on, remat "dots+flash").
HEADLINE = {"remat": True, "remat_policy": "dots+flash"}
TRAIN_B, TRAIN_T = 16, 1024  # the training cell: batch 16 x 1024 tokens
TRAIN_STEPS = 24             # measured optimizer steps
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


# -- phases 5 and 6: the training path's kernels ---------------------------

def bf16_measures(torch, got, ref):
    """How far a bf16 result lies from its plain version on the same
    inputs, each measure relative to the reference itself (max|ref| is
    ~50x a typical element of attention at S=1024, so a tolerance scaled
    by it would let a wrong tile through):
      row  — the worst row's ‖got − ref‖ / (‖ref‖ + 1e-2·rms row norm);
             a row is the last axis (one head's vector at one position, one
             LN row), and the floor keeps a row that is ~0 by cancellation
             (dq at position 0) from reading as a 100% error;
      frob — ‖got − ref‖ / ‖ref‖ over the whole tensor;
      bias — the worst tile of 64 positions' Σ(got − ref)·ref / Σ ref²:
             a share of a sum left out, or a rounding that leans one way,
             shows here, where round-to-nearest noise cancels.
    Positions are the sequence axis of a (B, S, H, D) tensor and the rows
    of an (N, d) one."""
    g, r = got.float(), ref.float()
    if r.ndim == 4:
        g, r = (t.transpose(0, 1).reshape(t.shape[1], -1, t.shape[-1])
                for t in (g, r))
    else:
        g, r = (t.reshape(t.shape[0], 1, -1) for t in (g, r))
    d = g - r
    rn = r.norm(dim=-1)
    floor = 1e-2 * rn.square().mean().sqrt()
    row = (d.norm(dim=-1) / (rn + floor)).max().item()
    frob = (d.norm() / r.norm()).item()
    dr, rr = (d * r).sum(dim=(1, 2)), r.square().sum(dim=(1, 2))
    pad = -len(dr) % 64
    dr, rr = (torch.nn.functional.pad(t, (0, pad)).reshape(-1, 64).sum(1)
              for t in (dr, rr))
    bias = (dr / rr.clamp_min(1e-30)).abs().max().item()
    return {"row": row, "frob": frob, "bias": bias}


# Limits of the bf16 measures, set between the readings of the correct
# kernels and of kernels with a planted fault on the card at the training
# path's shapes (``chip_faults.py``; PERF.md): correct row <= 6.0e-3,
# frob <= 1.3e-3, bias <= 6.4e-5; every fault over at least one limit.
BF16_LIMITS = {"row": 2e-2, "frob": 5e-3, "bias": 5e-4}
# The same measures' limits for the CE kernels' f32 results, held beside
# the max-abs check: at the main shape the cotangent is the mean loss's
# (~1/N), dx and dW elements lie near or under that check's absolute 1e-6,
# and only these relative measures see a scaled softmax term.  Set between
# the correct kernels' readings (row <= 6.7e-6, frob <= 4.1e-6, bias <=
# 1.5e-7) and ``chip_faults.py``'s softmax term against lse + 1 at the f32
# main shape (dx row 1.5e-2, frob 1.3e-2; dW row 0.35, frob 6.7e-3), which
# the max-abs check passes (err/tol 0.08 and 0.77); PERF.md.
F32_LIMITS = {"row": 1e-4, "frob": 5e-5, "bias": 5e-5}


def held(torch, label, pairs, f32_limits=None):
    """Check each (name, got, ref, dtype of the result); returns the
    largest abs error.  f32: max abs error <= 1e-5·max|ref| + 1e-6 (sums in
    another order), and every measure of ``bf16_measures`` within
    ``f32_limits`` where given.  bf16: every measure within
    ``BF16_LIMITS``."""
    torch.cuda.synchronize()
    worst = 0.0
    for name, got, ref, dtype in pairs:
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        limits = f32_limits if dtype == torch.float32 else BF16_LIMITS
        line = (f"phase 5: {label} {name}: max_abs_err={err:.3e} "
                f"max|ref|={scale:.3e}")
        if dtype == torch.float32:
            tol = 1e-5 * scale + 1e-6
            line += f" tol={tol:.3e}"
            check(err <= tol, f"{label} {name} within tolerance")
        m = bf16_measures(torch, got, ref) if limits else {}
        print(line + "".join(f"; {k} {v:.3e} (limit {limits[k]:.0e})"
                             for k, v in m.items()))
        for k, v in m.items():
            check(v <= limits[k], f"{label} {name} {k} {v:.3e} within "
                  f"{limits[k]}")
        worst = max(worst, err)
    return worst


def ln_case(torch, gen, n, d, dtype):
    x = (torch.randn(n, d, generator=gen, device="cuda") * 2 + 0.3).to(dtype)
    g = torch.randn(d, generator=gen, device="cuda")
    b = torch.randn(d, generator=gen, device="cuda")
    dy = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    return x, g, b, dy


def flash_case(torch, gen, B, S, H, D, dtype):
    """q, k, v as the per-head views of one fused projection (the main
    path's layout), and an output gradient."""
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device="cuda").to(dtype)
    q, k, v = (t.view(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def phase_train_kernels(torch):
    """Phase 5.  Returns the largest error of each kernel at the training
    path's own shapes in bf16 (the JSON record's max_abs_err)."""
    from ray_lightning_tpu_torch.ops import flash_attention as fa
    from ray_lightning_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    n_main = TRAIN_B * TRAIN_T
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for n, d in ((n_main, D_MODEL), (1001, D_MODEL), (37, 100),
                     (1001, 1600), (n_main, 2 * D_MODEL)):
            x, g, b, dy = ln_case(torch, gen, n, d, dtype)
            y, mu, rs = ln.ln_fwd(x, g, b)
            yp, mup, rsp = ln.ln_fwd_plain(x, g, b)
            dx, dg, db = ln.ln_bwd(x, g, dy, mup, rsp)
            dxp, dgp, dbp = ln.ln_bwd_plain(x, g, dy, mup, rsp)
            label = f"ln {name} n={n} d={d}"
            f32 = torch.float32
            e_fwd = held(torch, label, [("y", y, yp, dtype),
                                        ("mu", mu, mup, f32),
                                        ("rstd", rs, rsp, f32)])
            e_bwd = held(torch, label, [("dx", dx, dxp, dtype),
                                        ("dg", dg, dgp, f32),
                                        ("db", db, dbp, f32)])
            if dtype == torch.bfloat16 and n == n_main:
                errs["ln_fwd"], errs["ln_bwd"] = e_fwd, e_bwd
        for B, S, H, D in ((TRAIN_B, TRAIN_T, 12, 64),
                           (TRAIN_B, TRAIN_T, 6, 128)):
            q, k, v, do = flash_case(torch, gen, B, S, H, D, dtype)
            scale = D ** -0.5
            out, lse = fa.flash_fwd(q, k, v, scale)
            outp, lsep = fa.flash_fwd_plain(q, k, v, scale)
            # Both backward versions take the same out and lse, so their
            # comparison sees the backward alone.
            dq, dk, dv = fa.flash_bwd(q, k, v, outp, lsep, do, scale)
            dqp, dkp, dvp = fa.flash_bwd_plain(q, k, v, outp, lsep, do,
                                               scale)
            label = f"flash {name} B={B} S={S} H={H} D={D}"
            e_fwd = held(torch, label, [("out", out, outp, dtype),
                                        ("lse", lse, lsep, torch.float32)])
            e_bwd = held(torch, label, [("dq", dq, dqp, dtype),
                                        ("dk", dk, dkp, dtype),
                                        ("dv", dv, dvp, dtype)])
            if dtype == torch.bfloat16 and D == 64:
                errs["flash_fwd"], errs["flash_bwd"] = e_fwd, e_bwd
            del dqp, dkp, dvp, outp
    from ray_lightning_tpu_torch.ops import cross_entropy as ce

    shapes = ce_shapes(torch)
    for n, v, d, dtype in shapes:
        case = ce_case(torch, gen, n, v, d, dtype)
        label = f"ce {str(dtype)[6:]} N={n} V={v} d={d}"
        pairs = ce_pairs(torch, ce, case)
        e_fwd = held(torch, label, pairs[:2], F32_LIMITS)
        e_dx = held(torch, label, pairs[2:3], F32_LIMITS)
        e_dw = held(torch, label, pairs[3:], F32_LIMITS)
        if (n, v, d, dtype) == shapes[0]:
            errs["ce_fwd"], errs["ce_bwd_dx"], errs["ce_bwd_dw"] = (
                e_fwd, e_dx, e_dw)
        if (n, v, d, dtype) in shapes[:2]:
            ce_f64_errors(torch, case, pairs, label)
        del case, pairs
    return errs


def ce_f64_reference(torch, case):
    """loss, lse, dx and dW of one f64 evaluation of the CE math on the
    case's inputs (widened exactly from bf16 or f32).  As in the kernels,
    a bf16 case rounds dlogits to bf16 before the two products; an f32
    case keeps them in f64."""
    x, w, t, g = case
    x64, w64 = x.double(), w.double()
    rows = torch.arange(len(t), device=x.device)
    logits = x64 @ w64.t()
    lse = torch.logsumexp(logits, 1)
    loss = lse - logits[rows, t.long()]
    p = logits.sub_(lse[:, None]).exp_()
    p[rows, t.long()] -= 1.0
    dl = p.mul_(g.double()[:, None])
    if x.dtype != torch.float32:
        dl = dl.to(x.dtype).double()
    return {"loss": loss, "lse": lse, "dx": dl @ w64, "dW": dl.t() @ x64}


def f64_distance(got, ref):
    """(max abs error, relative Frobenius error) of a result against its
    f64 reference."""
    d = got.double() - ref
    return d.abs().max().item(), (d.norm() / ref.norm()).item()


# The CE gradients' relative Frobenius distance from one f64 evaluation
# (``ce_f64_reference``) at the main shape, held for the kernels: set
# between the correct kernels' readings (bf16 dx 6.5e-7, dW 4.4e-7; f32
# 4.1e-7, 2.8e-7) and ``chip_faults.py``'s absorption fault (bf16 dx
# 6.0e-5, dW 1.9e-5), which reads within the limits against the plain
# version; PERF.md.
F64_FROB_LIMIT = 5e-6


def ce_f64_errors(torch, case, pairs, label):
    """How far the kernels and the plain versions each lie from one f64
    evaluation of the same inputs: a yardstick that shares no rounding with
    either (the plain versions' cuBLAS products accumulate over V in f32 as
    a kernel may, so a fault of that kind reads close to them).  The
    kernels' dx and dW must lie within ``F64_FROB_LIMIT`` of it."""
    ref = ce_f64_reference(torch, case)
    for name, k, pl, _ in pairs:
        (ka, kf), (pa, pf) = f64_distance(k, ref[name]), f64_distance(
            pl, ref[name])
        held = name in ("dx", "dW")
        print(f"phase 5: {label} {name} against f64: kernel max abs "
              f"{ka:.3e} frob {kf:.3e}"
              + (f" (limit {F64_FROB_LIMIT:.0e})" if held else "")
              + f"; plain max abs {pa:.3e} frob {pf:.3e}; max|ref| "
              f"{ref[name].abs().max().item():.3e}")
        if held:
            check(kf <= F64_FROB_LIMIT, f"{label} {name} within "
                  f"{F64_FROB_LIMIT} of f64")


def ce_shapes(torch):
    """Phase 5's CE shapes: the main path's (bf16 first: its errors are
    the record's), its f32 twin, a ragged case on both axes in both
    dtypes, a d whose last slice of the bf16 backward's cluster is ragged,
    and the widest d the JAX gate lets bf16 take."""
    n = TRAIN_B * TRAIN_T
    return ((n, VOCAB, D_MODEL, torch.bfloat16),
            (n, VOCAB, D_MODEL, torch.float32),
            (1000, 515, D_MODEL, torch.bfloat16),
            (1000, 515, D_MODEL, torch.float32),
            (1000, 515, 640, torch.bfloat16),
            (4096, VOCAB, 2 * D_MODEL, torch.bfloat16))


def ce_case(torch, gen, n, v, d, dtype):
    """x, w (the compute dtype), int32 targets with a gold label in the
    last, partial vocab tile, and a cotangent g with some zeros.  w is
    scaled as GPT-2's embedding (std 0.02) and x as a LayerNorm output,
    so the logits have the trainer's spread."""
    x = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(v, d, generator=gen, device="cuda") * 0.02).to(dtype)
    t = torch.randint(0, v, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    t[0] = v - 1
    g = torch.rand(n, generator=gen, device="cuda") / n
    g[::7] = 0.0
    return x, w, t, g


def ce_pairs(torch, ce, case):
    """(name, kernel result, plain result, dtype to hold it in) for loss,
    lse, dx and dW; both backward versions take the plain forward's lse.
    loss and lse are f32 sums of exact products on either route."""
    x, w, t, g = case
    loss, lse = ce.ce_fwd(x, w, t)
    lossp, lsep = ce.ce_fwd_plain(x, w, t)
    dx = ce.ce_bwd_dx(x, w, t, lsep, g)
    dxp = ce.ce_bwd_dx_plain(x, w, t, lsep, g)
    dw = ce.ce_bwd_dw(x, w, t, lsep, g)
    dwp = ce.ce_bwd_dw_plain(x, w, t, lsep, g)
    f32 = torch.float32
    return [("loss", loss, lossp, f32), ("lse", lse, lsep, f32),
            ("dx", dx, dxp, x.dtype), ("dW", dw, dwp, x.dtype)]


def least_ms(nbytes, ops, dtype_name):
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the peak rate of the inputs' type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ln_bounds(n, d, es):
    """LN forward and backward: each input read once, each output written
    once; ~8 f32 operations an element forward, ~12 backward."""
    fwd = least_ms(2 * n * d * es + 2 * d * 4 + 2 * n * 4, 8 * n * d,
                   "float32")
    bwd = least_ms(3 * n * d * es + d * 4 + 2 * n * 4 + 2 * d * 4,
                   12 * n * d, "float32")
    return fwd, bwd


def flash_bounds(B, S, H, D, es, dtype_name):
    """Causal attention: the S(S+1)/2 visible (query, key) pairs of each
    head; the forward does 4·D operations a pair (Q·Kᵀ, P·V), the backward
    10·D (Q·Kᵀ again, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q, dS·K).  Bytes: q, k, v (+ out,
    dout) read once, outputs written once, lse f32."""
    pairs = B * H * S * (S + 1) // 2
    elems = B * S * H * D
    fwd = least_ms(4 * elems * es + B * H * S * 4, 4 * D * pairs, dtype_name)
    bwd = least_ms(8 * elems * es + B * H * S * 4, 10 * D * pairs,
                   dtype_name)
    return fwd, bwd


def library(label, fn):
    """A yardstick's time, or None with the reason printed (the library
    call is timed only to compare; the port never calls it)."""
    try:
        return fn()
    except (RuntimeError, TypeError) as err:
        print(f"phase 6: {label}: library call not timed ({err})"[:300])
        return None


def phase_train_timing(torch, card):
    """Phase 6: each kernel at the main path's bf16 shapes in a CUDA
    graph over rotating inputs larger than L2, beside the plain version,
    the library call and the bound.  Returns the JSON record fields."""
    import torch.nn.functional as F

    from ray_lightning_tpu_torch.ops import flash_attention as fa
    from ray_lightning_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    dt, es = torch.bfloat16, 2
    n, d = TRAIN_B * TRAIN_T, D_MODEL
    rec = {}
    # LayerNorm: 4 sets of x and dy of 25 MB each.
    sets = [ln_case(torch, gen, n, d, dt) for _ in range(4)]
    fwd_sets = [(x, g, b) for x, g, b, _ in sets]
    lib_fwd_sets = [(x, g.to(dt), b.to(dt)) for x, g, b, _ in sets]
    bwd_sets, lib_bwd_sets = [], []
    for x, g, b, dy in sets:
        _, mu, rs = ln.ln_fwd(x, g, b)
        bwd_sets.append((x, g, dy, mu, rs))
        gd, bd = g.to(dt), b.to(dt)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [d], gd, bd,
                                                         1e-5)
        lib_bwd_sets.append((dy, x, mean, rstd, gd, bd))
    bwd_ln_sets = bwd_sets
    (fb, fby), (bb, bby) = ln_bounds(n, d, es)
    rec["ln_fwd"] = {
        "ms": graph_ms(torch, lambda *a: ln.ln_fwd(*a), fwd_sets),
        "plain_ms": graph_ms(torch, ln.ln_fwd_plain, fwd_sets),
        "library_ms": library("F.layer_norm", lambda: graph_ms(
            torch, lambda x, g, b: F.layer_norm(x, (d,), g, b, 1e-5),
            lib_fwd_sets)),
        "bound_ms": fb, "bound_by": fby}
    rec["ln_bwd"] = {
        "ms": graph_ms(torch, ln.ln_bwd, bwd_sets),
        "plain_ms": graph_ms(torch, ln.ln_bwd_plain, bwd_sets),
        "library_ms": library("native_layer_norm_backward", lambda: graph_ms(
            torch, lambda dy, x, m, r, g, b:
            torch.ops.aten.native_layer_norm_backward(
                dy, x, [d], m, r, g, b, [True, True, True]), lib_bwd_sets)),
        "bound_ms": bb, "bound_by": bby}

    def ln_fwd_bwd(x, g, b, dy):
        xr = x.detach().requires_grad_(True)
        F.layer_norm(xr, (d,), g, b, 1e-5).backward(dy)

    both = library("F.layer_norm fwd+bwd", lambda: eager_ms(
        torch, ln_fwd_bwd, [(x, g.to(dt), b.to(dt), dy)
                            for x, g, b, dy in sets]))
    print(f"phase 6: F.layer_norm fwd+bwd (eager, autograd): {both} ms")

    # Flash attention: 2 sets of q, k, v (75 MB each).
    B, S, H, D = TRAIN_B, TRAIN_T, 12, 64
    scale = D ** -0.5
    fsets = [flash_case(torch, gen, B, S, H, D, dt) for _ in range(2)]
    fwd_sets = [(q, k, v) for q, k, v, _ in fsets]
    bwd_sets, lib_bwd_sets = [], []
    for q, k, v, do in fsets:
        out, lse = fa.flash_fwd(q, k, v, scale)
        bwd_sets.append((q, k, v, out, lse, do))
    heads = [tuple(t.transpose(1, 2) for t in (q, k, v, do))
             for q, k, v, do in fsets]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def sdpa_bwd_sets():
        out = []
        for q, k, v, do in heads:
            r = torch.ops.aten._scaled_dot_product_flash_attention(
                q, k, v, 0.0, True)
            out.append((do, q, k, v, r[0], r[1], r[2], r[3], r[4], r[5],
                        r[6], r[7]))
        return out

    def sdpa_bwd(do, q, k, v, o, lse, cq, ck, mq, mk, seed, offset):
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, True, seed, offset)

    (fb, fby), (bb, bby) = flash_bounds(B, S, H, D, es, "bfloat16")
    rec["flash_fwd"] = {
        "ms": graph_ms(torch, lambda q, k, v: fa.flash_fwd(q, k, v, scale),
                       fwd_sets, reps=5),
        "plain_ms": graph_ms(torch, lambda q, k, v: fa.flash_fwd_plain(
            q, k, v, scale), fwd_sets, reps=5),
        "library_ms": library("F.scaled_dot_product_attention", lambda:
                              graph_ms(torch, sdpa,
                                       [h[:3] for h in heads], reps=5)),
        "bound_ms": fb, "bound_by": fby}
    rec["flash_bwd"] = {
        "ms": graph_ms(torch, lambda *a: fa.flash_bwd(*a, scale),
                       bwd_sets, reps=5),
        "plain_ms": graph_ms(torch, lambda *a: fa.flash_bwd_plain(
            *a, scale), bwd_sets, reps=5),
        "library_ms": library("_scaled_dot_product_flash_attention_backward",
                              lambda: graph_ms(torch, sdpa_bwd,
                                               sdpa_bwd_sets(), reps=5)),
        "bound_ms": bb, "bound_by": bby}

    # The default SDPA call dispatches to cuDNN's attention on this card;
    # PyTorch's FlashAttention-2 kernel, printed beside it, is the
    # mma.sync design the kernels here follow.
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def fa2_ms():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return graph_ms(torch, sdpa, [h[:3] for h in heads], reps=5)

    fa2 = library("SDPA flash backend", fa2_ms)
    fwd, bwd = rec["flash_fwd"], rec["flash_bwd"]
    check(fwd["library_ms"] is not None and bwd["library_ms"] is not None,
          "the SDPA yardsticks of the flash kernels timed")
    print(f"phase 6: flash fwd {fwd['ms'] * 1e3:.1f} us = "
          f"{fwd['ms'] / fwd['library_ms']:.2f} x "
          f"F.scaled_dot_product_attention ({fwd['library_ms'] * 1e3:.1f} "
          f"us; its flash backend "
          f"{'not timed' if fa2 is None else f'{fa2 * 1e3:.1f} us'}), "
          f"limit 2; flash bwd {bwd['ms'] * 1e3:.1f} us = "
          f"{bwd['ms'] / bwd['library_ms']:.2f} x "
          f"_scaled_dot_product_flash_attention_backward "
          f"({bwd['library_ms'] * 1e3:.1f} us), limit 1.5; {card}")
    check(fwd["ms"] <= 2 * fwd["library_ms"],
          "flash fwd within 2 x F.scaled_dot_product_attention")
    check(bwd["ms"] <= 1.5 * bwd["library_ms"],
          "flash bwd within 1.5 x the SDPA flash backward")

    def sdpa_fwd_bwd(q, k, v, do):
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        sdpa(q, k, v).backward(do)

    both = library("SDPA fwd+bwd", lambda: eager_ms(torch, sdpa_fwd_bwd,
                                                    heads, reps=5))
    print(f"phase 6: F.scaled_dot_product_attention fwd+bwd (eager, "
          f"autograd): {both} ms")
    lb = rec["ln_bwd"]
    check(lb["library_ms"] is not None,
          "the native_layer_norm_backward yardstick timed")
    print(f"phase 6: ln bwd {lb['ms'] * 1e3:.1f} us = "
          f"{lb['ms'] / lb['library_ms']:.2f} x native_layer_norm_backward "
          f"({lb['library_ms'] * 1e3:.1f} us), limit 0.75; {card}")
    check(lb["ms"] <= 0.75 * lb["library_ms"],
          "ln bwd within 0.75 x native_layer_norm_backward")
    ln_bwd_kernels(torch, ln, bwd_ln_sets, card)
    ln_occupancy(card)
    flash_occupancy(card)
    ce_occupancy(torch, card)
    rec.update(ce_timing(torch, card))
    for name, r in rec.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.1f} us")
        print(f"phase 6: {name} bf16 at the main path's shape: kernel "
              f"{r['ms'] * 1e3:.1f} us (graph); plain "
              f"{r['plain_ms'] * 1e3:.1f} us; library {lib}; bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}); {card}")
    # f32 bounds, for the record (the ops bound governs flash there).
    (ff, _), (fbw, _) = flash_bounds(B, S, H, D, 4, "float32")
    print(f"phase 6: flash f32 bounds: fwd {ff * 1e3:.1f} us, bwd "
          f"{fbw * 1e3:.1f} us (operations at 67 TF/s)")
    return rec


def ce_bounds(n, v, d, es):
    """CE: 2·N·V·d operations a logits product (the forward one, each
    backward kernel two: the logits again and its own product); bytes: x,
    w, targets, lse, g read once, the outputs written once."""
    prod = 2 * n * v * d
    fwd = least_ms((n + v) * d * es + n * 4 + 2 * n * 4, prod, "bfloat16")
    dx = least_ms((n + v) * d * es + 3 * n * 4 + n * d * 4, 2 * prod,
                  "bfloat16")
    dw = least_ms((n + v) * d * es + 3 * n * 4 + v * d * 4, 2 * prod,
                  "bfloat16")
    return fwd, dx, dw


def ce_timing(torch, card):
    """Phase 6 for the CE kernels at the main path's bf16 shape: each
    kernel, its plain version, the vocab-chunk scan it replaces (forward,
    and its backward, which makes dx and dW at once) and the cuBLAS time
    of the same products (``torch.mm(..., out_dtype=f32)``).  No single
    PyTorch call computes fused CE, so ``library_ms`` is None and cuBLAS
    is printed as the yardstick."""
    from ray_lightning_tpu_torch.ops import cross_entropy as ce

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    n, v, d = TRAIN_B * TRAIN_T, VOCAB, D_MODEL
    # Two sets of x, w (100 MB each, twice L2), with the f32 wte of the
    # trainer for the scan, which casts its chunks itself.
    sets = [ce_case(torch, gen, n, v, d, torch.bfloat16) for _ in range(2)]
    fwd_sets = [(x, w, t) for x, w, t, _ in sets]
    bwd_sets = [(x, w, t, ce.ce_fwd_plain(x, w, t)[1], g)
                for x, w, t, g in sets]
    scan_fwd = [(x, w.float(), t.long()) for x, w, t, _ in sets]
    scan_bwd = [(x, wf, t, lse, g) for (x, wf, t), (*_, lse, g)
                in zip(scan_fwd, bwd_sets)]
    dls = [ce._dlogits_plain(*a) for a in bwd_sets]

    def scan_f(x, w, t):
        return ce._ce_fwd(x, w, t, 7, torch.bfloat16)

    def scan_b(x, w, t, lse, g):
        return ce._ce_bwd(x, w, t, lse, g, 7, torch.bfloat16)

    def mm(a, b):
        return torch.mm(a, b, out_dtype=torch.float32)

    (fb, fby), (xb, xby), (wb, wby) = ce_bounds(n, v, d, 2)
    reps = 3
    rec = {
        "ce_fwd": {
            "ms": graph_ms(torch, ce.ce_fwd, fwd_sets, reps),
            "plain_ms": graph_ms(torch, ce.ce_fwd_plain, fwd_sets, reps),
            "library_ms": None, "bound_ms": fb, "bound_by": fby},
        "ce_bwd_dx": {
            "ms": graph_ms(torch, ce.ce_bwd_dx, bwd_sets, reps),
            "plain_ms": graph_ms(torch, ce.ce_bwd_dx_plain, bwd_sets, reps),
            "library_ms": None, "bound_ms": xb, "bound_by": xby},
        "ce_bwd_dw": {
            "ms": graph_ms(torch, ce.ce_bwd_dw, bwd_sets, reps),
            "plain_ms": graph_ms(torch, ce.ce_bwd_dw_plain, bwd_sets, reps),
            "library_ms": None, "bound_ms": wb, "bound_by": wby},
    }
    yard = {
        "scan_fwd_ms": graph_ms(torch, scan_f, scan_fwd, reps),
        "scan_bwd_ms": graph_ms(torch, scan_b, scan_bwd, reps),
        "cublas_logits_ms": graph_ms(
            torch, lambda x, w, t: mm(x, w.t()), fwd_sets, reps),
        "cublas_dx_product_ms": graph_ms(
            torch, lambda dl, w: mm(dl, w),
            [(dl, w) for dl, (_, w, *_r) in zip(dls, bwd_sets)], reps),
        "cublas_dw_product_ms": graph_ms(
            torch, lambda dl, x: mm(dl.t(), x),
            [(dl, x) for dl, (x, *_r) in zip(dls, bwd_sets)], reps),
    }
    y = yard
    print(f"phase 6: ce yardsticks (no single PyTorch call computes fused "
          f"CE): cuBLAS x·Wᵀ {y['cublas_logits_ms']:.3f} ms, dlogits·W "
          f"{y['cublas_dx_product_ms']:.3f} ms, dlogitsᵀ·x "
          f"{y['cublas_dw_product_ms']:.3f} ms (so the same products: fwd "
          f"{y['cublas_logits_ms']:.3f}, dx "
          f"{y['cublas_logits_ms'] + y['cublas_dx_product_ms']:.3f}, dW "
          f"{y['cublas_logits_ms'] + y['cublas_dw_product_ms']:.3f} ms); "
          f"the vocab-chunk scan it replaces: fwd {y['scan_fwd_ms']:.3f} ms,"
          f" bwd (dx and dW) {y['scan_bwd_ms']:.3f} ms; {card}")
    print("ce_yardsticks: " + json.dumps(yard))
    fwd = rec["ce_fwd"]["ms"]
    print(f"phase 6: ce fwd {fwd * 1e3:.1f} us = "
          f"{fwd / y['cublas_logits_ms']:.2f} x cuBLAS x·Wᵀ (f32 out, "
          f"{y['cublas_logits_ms'] * 1e3:.1f} us), limit 2; {card}")
    check(fwd <= 2 * y["cublas_logits_ms"],
          "ce fwd within 2 x cuBLAS x·Wᵀ")
    return rec


# -- phases 7 and 8: the trainer -------------------------------------------

def make_clock(torch, Callback):
    class StepClock(Callback):
        """A CUDA event after each step and the step's loss tensor: no
        host sync inside the run."""

        def __init__(self):
            self.events, self.losses = [], []

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            self.losses.append(logs["train_loss"])

    return StepClock()


def launch_counters():
    """Each training-path kernel's wrapper, whose ``launches`` it counts."""
    from ray_lightning_tpu_torch.ops import cross_entropy as ce
    from ray_lightning_tpu_torch.ops import flash_attention as fa
    from ray_lightning_tpu_torch.ops import layer_norm as ln

    return {"ln_fwd": ln.ln_fwd, "ln_bwd": ln.ln_bwd,
            "flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd,
            "ce_fwd": ce.ce_fwd, "ce_bwd_dx": ce.ce_bwd_dx,
            "ce_bwd_dw": ce.ce_bwd_dw}


def per_step_launches(n_layer, remat, policy="dots+flash", ce=True):
    """Kernel launches a training step must make: LN at 2L+1 sites, flash
    at L, CE once each; remat re-runs the blocks' 2L LN forwards, and the
    flash forward too under "dots"."""
    L = n_layer
    return {"ln_fwd": 2 * L + 1 + (2 * L if remat else 0),
            "ln_bwd": 2 * L + 1,
            "flash_fwd": L * (2 if remat and policy == "dots" else 1),
            "flash_bwd": L,
            "ce_fwd": int(ce), "ce_bwd_dx": int(ce), "ce_bwd_dw": int(ce)}


# Phase 7's arms: (label, GPT kwargs).
ARMS = (("a_headline", HEADLINE),
        ("b_ce_kernels_no_remat", {}),
        ("c_ce_scan_no_remat", {"ce_kernel": False}))


def train_arm(torch, cfg, gpt_kw, steps, callbacks=()):
    """One bf16 fit of ``GPT(cfg, **gpt_kw)`` at batch TRAIN_B; returns
    (global_step, callback_metrics)."""
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import GPT, SyntheticLMDataModule

    tr = Trainer(max_steps=steps, limit_val_batches=0, precision="bf16",
                 seed=SEED, callbacks=list(callbacks))
    tr.fit(GPT(cfg, **gpt_kw),
           SyntheticLMDataModule(cfg, batch_size=TRAIN_B, num_batches=steps,
                                 seed=SEED))
    return tr.global_step, dict(tr.callback_metrics)


def phase_trainer(torch, card):
    """Phase 7: the three arms, each with its exact launches per step,
    ms/step, tokens/s, MFU and peak memory; a profile of the headline arm;
    then the remat policies' launch gates at depth 2."""
    import gc

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ray_lightning_tpu_torch.core.callbacks import Callback
    from ray_lightning_tpu_torch.models.gpt import REMAT_POLICIES, GPTConfig
    from ray_lightning_tpu_torch.telemetry.step_stats import (
        model_flops_per_token,
    )

    cfg = GPTConfig.gpt2_small()
    counters = launch_counters()
    print(f"phase 7: Trainer.fit of GPT-2-small (L={cfg.n_layer}, "
          f"d={cfg.d_model}, V={cfg.vocab_size}), batch {TRAIN_B} x "
          f"{TRAIN_T} tokens, bf16, {TRAIN_STEPS} measured steps per arm")
    for label, kw in ARMS:  # warm-up: libraries, cuBLAS, allocator
        train_arm(torch, cfg, kw, 2)
    flops = model_flops_per_token(cfg, "full")
    result = {}
    for label, kw in ARMS:
        clock = make_clock(torch, Callback)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        steps, _ = train_arm(torch, cfg, kw, TRAIN_STEPS, [clock])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        want = per_step_launches(cfg.n_layer, kw.get("remat", False),
                                 ce=kw.get("ce_kernel", True))
        losses = [float(x) for x in clock.losses]
        print(f"phase 7 {label}: {steps} steps, launches {launches}; per "
              f"step {want}")
        check(steps == TRAIN_STEPS, f"{label}: every step ran")
        for k, n in launches.items():
            check(n == want[k] * TRAIN_STEPS,
                  f"{label} {k}: {n} launches = {want[k]} x {TRAIN_STEPS}")
        check(all(np.isfinite(losses)), f"{label}: finite losses")
        check(abs(losses[0] - np.log(cfg.vocab_size)) < 0.5,
              f"{label}: first loss {losses[0]} near ln(V)")
        step_ms = [clock.events[i].elapsed_time(clock.events[i + 1])
                   for i in range(len(clock.events) - 1)]
        windows = [float(np.mean(step_ms[i:i + 4]))
                   for i in range(0, len(step_ms) - 3, 4)]
        ms = float(np.median(windows))
        tokens_s = TRAIN_B * TRAIN_T / (ms / 1e3)
        mfu = tokens_s * flops / 989e12
        print(f"phase 7 {label}: losses {losses[0]:.4f} -> {losses[-1]:.4f};"
              f" step {ms:.2f} ms (median of {len(windows)} windows of 4 "
              f"steps, CUDA events; all steps {min(step_ms):.2f}-"
              f"{max(step_ms):.2f} ms); {tokens_s:.0f} tokens/s; MFU "
              f"{100 * mfu:.2f}% ({flops / 1e6:.1f} MFLOP/token against 989 "
              f"TF/s); peak memory {peak / 2**30:.2f} GiB; wall {wall:.2f} s;"
              f" {card}")
        result[label] = {"steps": steps, "step_ms": ms,
                         "tokens_per_s": tokens_s, "mfu": mfu,
                         "peak_gib": peak / 2**30, "first_loss": losses[0],
                         "last_loss": losses[-1], "launches": launches}
        del clock
    a, b = result["a_headline"], result["b_ce_kernels_no_remat"]
    check(a["peak_gib"] < b["peak_gib"],
          f"remat's peak {a['peak_gib']:.2f} GiB below no remat's "
          f"{b['peak_gib']:.2f} GiB")

    label, kw = ARMS[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_arm(torch, cfg, kw, 3)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        print("phase 7 profile: device time not measured (the profiler "
              "recorded no CUDA events)")
    else:
        by_name, count = {}, {}
        for e in device:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
            count[e.name] = count.get(e.name, 0) + 1
        busy = sum(by_name.values())
        keys = ("ln_fwd_kernel", "ln_bwd_rows_kernel",
                "ln_col_sum_groups_kernel", "flash_fwd_kernel",
                "flash_bwd_kernel", "tc_delta_kernel", "round_to_bf16_kernel",
                "ce_fwd_wgmma_kernel", "ce_grad_cluster_kernel")
        kernel_us = {k: sum(v for name, v in by_name.items() if k in name)
                     for k in keys}
        calls = {k: sum(c for name, c in count.items() if k in name)
                 for k in keys}
        share = {k: kernel_us[k] / busy for k in keys}
        print(f"phase 7 profile (headline arm): 3-step fit (model build and "
              f"init included): wall {wall_us / 1e3:.1f} ms, device busy "
              f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%), "
              f"{len(device)} device events; kernel shares of device time "
              + ", ".join(f"{k} {100 * share[k]:.1f}% ({calls[k]} launches,"
                          f" {kernel_us[k] / max(calls[k], 1):.1f} us each)"
                          for k in keys)
              + f"; {card}")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]:
            print(f"phase 7 profile:   {100 * us / busy:5.1f}%  "
                  f"{us / 1e3:8.2f} ms  {name[:100]}")
        result["profile"] = {"wall_ms": wall_us / 1e3,
                             "device_busy_ms": busy / 1e3,
                             "device_busy_share": busy / wall_us,
                             "kernel_share_of_device": share}

    # The policies' gates: one step at full width, depth 2.
    shallow = dataclasses.replace(cfg, n_layer=2)
    gates = {}
    for policy in REMAT_POLICIES:
        for c in counters.values():
            c.launches = 0
        train_arm(torch, shallow, {"remat": True, "remat_policy": policy}, 1)
        got = {k: c.launches for k, c in counters.items()}
        want = per_step_launches(2, True, policy)
        print(f"phase 7 policy {policy}: depth-2 step launches {got}")
        check(got == want, f"remat_policy {policy}: launches {got} = {want}")
        gates[policy] = got
    result["policy_gates"] = gates
    return result


def named_leaves(tree, prefix=""):
    """(name, tensor) for each leaf of nested dicts, in tree order; a
    stacked ``blocks`` leaf gives one entry per layer."""
    if isinstance(tree, dict):
        return [nl for k, v in tree.items()
                for nl in named_leaves(v, f"{prefix}{k}/")]
    if prefix.startswith("blocks/"):
        return [(f"{prefix[:-1]}[{i}]", t) for i, t in enumerate(tree)]
    return [(prefix[:-1], tree)]


def step_grads(torch, cfg, init, tokens, device, precision):
    """One training step of the full-width model in the headline
    configuration through the loop's own ``loss_and_grads``: (loss,
    [(leaf name, f32 CPU gradient)])."""
    from ray_lightning_tpu_torch.models.gpt import GPT
    from ray_lightning_tpu_torch.models.optim import tree_map
    from ray_lightning_tpu_torch.parallel.step_fns import loss_and_grads

    module = GPT(cfg, precision=precision, device=device, **HEADLINE)
    params = tree_map(lambda t: t.to(device), init)
    grads, logs = loss_and_grads(module, params,
                                 {"tokens": tokens.to(device)}, None)
    return float(logs["train_loss"]), [
        (n, g.float().cpu()) for n, g in named_leaves(grads)]


def worst_leaf(a, b):
    """(largest ‖a − b‖ / ‖b‖ over the leaves, that leaf's name)."""
    return max(((float((x - y).norm() / y.norm().clamp_min(1e-30)), n)
                for (n, x), (_, y) in zip(a, b)))


# Worst leaf's relative gradient difference, bf16 step on the card
# (kernels) vs the CPU (plain versions), set between the correct kernels'
# reading (1.4e-2, as far as bf16 moves the gradients from f32) and those
# of a skipped tile or a dropped dQ (>= 5.2e-2; ``chip_faults.py``).
GRAD_BF16_LIMIT = 3e-2


def bf16_step_check(torch, cfg, init, card):
    """One bf16 training step of the full-width model (headline
    configuration) at batch 1 on the card and on the CPU, whose plain
    versions make the same bf16 roundings: the gradients of every leaf
    (each layer of a stacked one) must agree within ``GRAD_BF16_LIMIT`` in
    relative norm.  The f32 step on the card shows how far bf16 itself
    moves them."""
    import numpy as np

    counters = launch_counters()
    rng = np.random.default_rng(SEED + 2)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=(1, cfg.seq_len + 1)))
    before = {k: c.launches for k, c in counters.items()}
    card_loss, card_g = step_grads(torch, cfg, init, tokens, "cuda", "bf16")
    launched = {k: c.launches - before[k] for k, c in counters.items()}
    t0 = time.perf_counter()
    cpu_loss, cpu_g = step_grads(torch, cfg, init, tokens, "cpu", "bf16")
    cpu_s = time.perf_counter() - t0
    _, f32_g = step_grads(torch, cfg, init, tokens, "cuda", "f32")
    rel, leaf = worst_leaf(card_g, cpu_g)
    rel_f32, leaf_f32 = worst_leaf(card_g, f32_g)
    print(f"phase 8: bf16 step, card vs CPU: loss {card_loss:.6f} vs "
          f"{cpu_loss:.6f}; worst gradient leaf {leaf} rel norm diff "
          f"{rel:.3e} (limit {GRAD_BF16_LIMIT:.0e}); card bf16 vs card "
          f"f32: worst {leaf_f32} {rel_f32:.3e}; launches on the card "
          f"{launched}; CPU step {cpu_s:.1f} s; {card}")
    check(launched == per_step_launches(cfg.n_layer, True),
          "the card step ran every kernel of the headline step")
    check(rel <= GRAD_BF16_LIMIT, f"bf16 gradients card vs CPU {rel:.3e}")
    return {"grad_rel_bf16_card_vs_cpu": rel, "grad_worst_leaf": leaf,
            "grad_rel_bf16_vs_f32": rel_f32}


def phase_end_to_end(torch, card):
    """Phase 8, on the headline configuration (remat "dots+flash", every
    kernel): the full-width model from one set of initial params: one
    bf16 step's gradients, card against CPU (``bf16_step_check``); then 3
    optimizer steps at batch 1 (warmup 2, so steps 2 and 3 have lr > 0):
    f32 on the card (kernels) against f32 on the CPU (plain versions);
    bf16 on the card against f32 on the card."""
    from ray_lightning_tpu_torch.core.callbacks import Callback
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import (
        GPT, GPTConfig, SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.models.optim import tree_leaves
    from ray_lightning_tpu_torch.ops import cross_entropy as ce
    from ray_lightning_tpu_torch.ops import flash_attention as fa
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    cfg = dataclasses.replace(GPTConfig.gpt2_small(), warmup_steps=2)
    init = GPT(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(SEED))

    def run(device, precision):
        module = GPT(cfg, device=device, **HEADLINE)
        module.initial_params = init
        losses = []

        class Losses(Callback):
            def on_train_batch_end(self, trainer, module, logs, batch_idx):
                losses.append(float(logs["train_loss"]))

        before = (fa.flash_fwd.launches, ce.ce_bwd_dw.launches)
        t0 = time.perf_counter()
        tr = Trainer(LocalStrategy(device=device), max_steps=3,
                     limit_val_batches=0, precision=precision,
                     callbacks=[Losses()])
        tr.fit(module, SyntheticLMDataModule(cfg, batch_size=1,
                                             num_batches=3, seed=SEED + 1))
        launched = (fa.flash_fwd.launches - before[0],
                    ce.ce_bwd_dw.launches - before[1])
        print(f"phase 8: {precision} fit on {device}: losses "
              + ", ".join(f"{x:.6f}" for x in losses)
              + f"; {time.perf_counter() - t0:.1f} s; flash_fwd / ce_bwd_dw "
              f"launches {launched}")
        check(launched == ((3 * cfg.n_layer, 3) if device == "cuda"
                           else (0, 0)),
              f"the {device} fit ran the kernels on the card only")
        return losses, tree_leaves(tr.state.params)

    grads = bf16_step_check(torch, cfg, init, card)
    card_l, card_p = run("cuda", "f32")
    cpu_l, cpu_p = run("cpu", "f32")
    bf_l, _ = run("cuda", "bf16")
    init_p = tree_leaves(init)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    upd_rel = 0.0
    for p_card, p_cpu, p0 in zip(card_p, cpu_p, init_p):
        d_card = p_card.cpu() - p0
        d_cpu = p_cpu - p0
        upd_rel = max(upd_rel, float((d_card - d_cpu).norm()
                                     / d_cpu.norm().clamp_min(1e-30)))
    bf_rel = max(abs(a - b) / abs(b) for a, b in zip(bf_l, card_l))
    print(f"phase 8: card f32 vs CPU f32: per-step loss rel err "
          f"{loss_rel:.3e} (tol 1e-5); parameter updates after step 3, "
          f"largest relative norm of the difference over the leaves "
          f"{upd_rel:.3e} (tol 1e-2: Adam divides each gradient by its own "
          f"root mean square, so f32 noise in a near-zero gradient moves "
          f"its element by up to lr); {card}")
    print(f"phase 8: card bf16 vs card f32: per-step loss rel err "
          f"{bf_rel:.3e} (tol 1e-2, bf16 activations)")
    check(loss_rel <= 1e-5, "card f32 losses match the CPU's")
    check(upd_rel <= 1e-2, "card f32 updates match the CPU's")
    check(bf_rel <= 1e-2, "card bf16 losses match f32")
    return {"loss_rel_card_vs_cpu": loss_rel,
            "update_rel_card_vs_cpu": upd_rel,
            "loss_rel_bf16_vs_f32": bf_rel, **grads}


def kernel_name(mangled):
    """``name<args>`` of a kernel: of a demangled name (the profiler's),
    the identifier ending in ``_kernel`` and its template arguments; of a
    mangled one (ptxas's), the length-prefixed identifier ending in
    ``_kernel`` and its integer or bool template arguments.  A digit run
    may hold the end of an anonymous namespace's hash before the length,
    so each of its suffixes is tried as the length."""
    m = re.search(r"(\w+_kernel)(<[^()]*>)?\(", mangled)
    if m:
        return m.group(1) + (m.group(2) or "")
    for run in re.finditer(r"\d+", mangled):
        digits = run.group()
        for k in range(len(digits)):
            word = mangled[run.end():run.end() + int(digits[k:])]
            if word.endswith("_kernel") and word.isidentifier():
                t = re.match(r"I((?:\w*?L[ib]\d+E)+)E",
                             mangled[run.end() + len(word):])
                args = re.findall(r"L[ib](\d+)E", t.group(1)) if t else []
                return word + (f"<{', '.join(args)}>" if args else "")
    return mangled


def ptxas_kernels(log):
    """(kernel, registers, bytes spilled) of each entry function in the
    ``-Xptxas -v`` report of a build (names as ``kernel_name`` gives
    them)."""
    out, name, spilled = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spilled = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), spilled))
            name, spilled = None, 0
    return out


def device_us_by_kernel(torch, fn, arg_sets, reps=5):
    """Device µs per call of each kernel that ``fn`` launches, from a
    torch.profiler window over ``reps`` rounds of eager calls (None when
    the profiler records no CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for args in arg_sets:
                fn(*args)
        torch.cuda.synchronize()
    calls = reps * len(arg_sets)
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
    return {k: v / calls for k, v in out.items()} or None


def ln_bwd_kernels(torch, ln, bwd_sets, card):
    """Phase 6: the LN backward's kernels each on its own (profiler),
    at the main path's shape."""
    per = device_us_by_kernel(torch, ln.ln_bwd, bwd_sets)
    if per is None:
        print("phase 6: ln bwd kernels: device time not measured (the "
              "profiler recorded no CUDA events)")
        return
    print("phase 6: ln bwd bf16 kernels, device us a call (profiler, eager): "
          + ", ".join(f"{kernel_name(k)} {v:.1f}"
                      for k, v in sorted(per.items(), key=lambda kv: -kv[1]))
          + f"; {card}")


def ln_occupancy(card):
    """Phase 6: registers, threads and shared bytes of the bf16 LN
    backward's row kernel and the blocks the card keeps resident per SM,
    at the main path's d, the ragged d = 100, the widest d the narrow
    (register) form holds and GPT-2 XL's d = 1600, which takes the wide
    form."""
    from ray_lightning_tpu_torch.ops import _build

    fn = _build.load_function("layer_norm", "rlt_ln_bwd_occupancy",
                              [ctypes.c_int]
                              + [ctypes.POINTER(ctypes.c_int)] * 4)
    for d in (D_MODEL, 100, 2 * D_MODEL, 1600):
        vals = [ctypes.c_int() for _ in range(4)]
        err = fn(d, *[ctypes.byref(v) for v in vals])
        check(err == 0, f"occupancy query of ln bwd d={d}")
        regs, threads, smem, blocks = (v.value for v in vals)
        print(f"phase 6: ln bwd bf16 d={d}: {regs} registers a thread, "
              f"{threads} threads and {smem} B of shared memory a block, "
              f"{blocks} blocks ({blocks * threads // 32} warps) resident "
              f"per SM; {card}")
        check(blocks >= 1, f"ln bwd d={d}: a block fits")


def flash_occupancy(card):
    """Phase 6: registers, threads and shared bytes of each bf16 flash
    kernel and the blocks the card keeps resident per SM (at least 8
    warps)."""
    from ray_lightning_tpu_torch.ops import _build

    fn = _build.load_function("flash_attention", "rlt_flash_tc_occupancy",
                              [ctypes.c_int] * 2
                              + [ctypes.POINTER(ctypes.c_int)] * 4)
    for which, name in ((0, "fwd"), (1, "bwd")):
        for d in (64, 128):
            vals = [ctypes.c_int() for _ in range(4)]
            err = fn(which, d, *[ctypes.byref(v) for v in vals])
            check(err == 0, f"occupancy query of flash {name} D={d}")
            regs, threads, smem, blocks = (v.value for v in vals)
            warps = blocks * threads // 32
            print(f"phase 6: flash {name} bf16 D={d}: {regs} registers a "
                  f"thread, {threads} threads and {smem} B of shared memory "
                  f"a block, {blocks} blocks ({warps} warps) resident per "
                  f"SM; {card}")
            check(warps >= 8, f"flash {name} D={d}: {warps} warps per SM")


CE_OCCUPANCY_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 5


def ce_occupancy(torch, card):
    """Phase 6: registers, threads and shared bytes of the bf16 CE
    backward kernels (a cluster per 64 rows, one block per slice of d) and
    the clusters the card keeps resident at once, at the main path's d and
    the widest d the JAX gate lets bf16 take."""
    from ray_lightning_tpu_torch.ops import _build

    fn = _build.load_function("cross_entropy", "rlt_ce_bwd_occupancy",
                              CE_OCCUPANCY_ARGTYPES)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for which, name in ((0, "dx"), (1, "dW")):
        for d in (D_MODEL, 2 * D_MODEL):
            vals = [ctypes.c_int() for _ in range(5)]
            err = fn(which, d, *[ctypes.byref(v) for v in vals])
            check(err == 0, f"occupancy query of ce {name} d={d}")
            regs, threads, smem, size, clusters = (v.value for v in vals)
            print(f"phase 6: ce {name} bf16 d={d}: {regs} registers a "
                  f"thread, {threads} threads and {smem} B of shared memory "
                  f"a block, clusters of {size} blocks: {clusters} resident "
                  f"({clusters * size} of {sms} SMs); {card}")
            check(clusters >= 1, f"ce {name} d={d}: a cluster fits")


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
        for kernel, regs, spilled in ptxas_kernels(b.log):
            print(f"phase 0:   {kernel}: {regs} registers, {spilled} bytes "
                  "spilled")
            if kernel.startswith(("tc_flash", "ce_fwd_wgmma",
                                  "ln_bwd_rows_kernel<3, 1, 0>")):
                check(spilled == 0, f"{kernel} builds with no spills")

    record = phase_kernel(torch, lora, card)
    f32, bf16 = phase_server(torch, np, card)
    errs = phase_train_kernels(torch)
    timing = phase_train_timing(torch, card)
    train = phase_trainer(torch, card)
    e2e = phase_end_to_end(torch, card)

    kernels = [{
        "name": "bgmv", "route": "cuda", "source": BGMV_SOURCE,
        "replaces": BGMV_REPLACES, "launches": f32["launches"],
        **record, "library_ms": None,
    }]
    # Launches: the headline arm's run of the training path.
    for name in TRAIN_KERNELS:
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES[name.split("_")[0]],
            "replaces": REPLACES[name],
            "launches": train["a_headline"]["launches"][name],
            "max_abs_err": errs[name], **timing[name],
        })
    print("kernels: " + json.dumps([k["name"] for k in kernels]))
    print("server: " + json.dumps({"f32": f32, "bf16": bf16,
                                   "card": card}))
    print("trainer: " + json.dumps({**train, "end_to_end": e2e,
                                    "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
