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
1. BGMV vs plain at the serving path's shapes, f32 and bf16, each also
   as a batch of null-adapter rows whose delta must be exactly 0.0; at
   prefill rows in runs of 100 ids (tiles that straddle two ids), one row,
   64 mixed rows, rank 128, ragged r, d and k; and a decode batch with an
   out-of-range id, whose row must be NaN (``bgmv_checks``);
2. BGMV timing (CUDA graphs of back-to-back launches over rotating inputs
   larger than L2, as the main path finds them) beside the plain version,
   the least time the card could take and the graph floor (a one-element
   ``add_`` captured the same way), with each shape's launch plan;
3. the server in f32: GPT-2-small with random weights from a seed, 4
   synthetic rank-16 tenants plus the base model, 10 greedy requests;
4. the same requests at bf16 (tokens not compared);
5. LayerNorm, flash-attention and CE kernels vs plain, forward and
   backward (each backward pair on the same saved statistics), at the
   training path's shapes (and ragged, D=128 or 256 or d=1536 or 1600
   ones; flash at head_dim 256 is ``FLASH_256``): f32
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
   most 2x cuBLAS x·Wᵀ; flash at head_dim 256 beside its plain version,
   SDPA and its bound (printed, no gate); the LN backward's kernels each
   timed by the profiler; the registers, shared memory and resident
   blocks (LN backward, flash) or clusters (the bf16 CE backward,
   launched as thread-block clusters, one block per slice of d) of each
   kernel that keeps its work in registers;
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
   the f32 one;
9. megastep: arms (a) and (b), each eager (``megastep="off"``) and
   captured (``megastep=8``: the first stride eager, then one CUDA graph
   of 8 steps captured at the second and replayed), 56 steps: ms/step from
   CUDA events with every 8-step window, tokens/s, MFU, the telemetry's
   ``dispatch_ms`` and ``step_time_ms`` (within 10% of the events), the
   device's idle share over two strides of a profiled fit (whose kernel
   launches must be 8 x the per-step counts a stride: by the captured
   graph's kernel nodes, each seen by the profiler in the replays, and by
   the wrappers' counters in the eager steps),
   peak memory (captured <= 1.10x
   eager), one capture per captured fit, the capture's wall time, the
   state write-back's cost, bf16 losses within 1e-4 of eager; then a
   depth-2 f32 fit captured against eager (``megastep_parity``: losses
   within 1e-5; params within 1e-5, or with the flash kernels within 5x
   the eager-vs-eager difference of the same run);
10. checkpoints, resume and the eval surface (``phase_checkpoint``): the
   headline arm at full width under megastep "auto", one epoch of 16
   steps with the default ``ModelCheckpoint`` (the file read back equals
   the live state bitwise), resumed for a second epoch (fresh batches,
   ``fresh_epochs``) against a straight two-epoch fit (stride-end losses
   within 1e-4, one capture, the
   optimizer count restored, the captured stride's kernels by profiler
   name 8 x phase 9's per-step counts); the same at depth 2 in f32
   (``checkpoint_parity``: params bitwise with the plain attention,
   within 5x the straight-vs-straight spread with flash); ``validate``
   and ``test`` from the checkpoint, card vs CPU (f32 within 1e-5
   relative, bf16 within 1e-2) with LN fwd 25, flash fwd 12, CE fwd 1
   and no backward launch a batch; ``predict`` card vs CPU (argmax equal
   except at a top-2 logit gap < 1e-4); the checkpoint's host copy,
   encode, write and read + restore times and validate/predict ms a
   batch;
11. the rest of the Trainer surface (``phase_lora_and_opt_state``): (a) a
   LoRA fine-tune of GPT-2-small (rank 16, lr 1e-3, warmup 0, random base
   from seed 0, ``add_lora_adapters``) at 16 x 1024 bf16 in the headline
   configuration, ``megastep="auto"``, 48 steps (``lora_check``): the base
   bitwise the starting tree, every adapter B moved, one capture, each
   kernel's launches a step (the counters over the eager stride and the
   capture ÷ 16, the captured graph's nodes ÷ 8) equal to the CPU's count
   for the same step with CE dW at 0, stride-end losses within 1e-4 of an
   eager fit's, ms/step over the replays, tokens/s, MFU, peak memory, the
   moments' bytes; the clip with forged gradients (``lora_clip_check``);
   f32 at depth 2 captured vs eager by phase 9's rules and card vs CPU by
   phase 8's (``lora_parity``); (b) the tuned adapter (``extract_lora``)
   served in f32 beside two synthetic tenants over phase 3's requests,
   every stream equal to ``generate()`` on ``merge_lora`` (divergence only
   at a top-2 gap < 1e-4), the BGMV launching (``serve_tuned``); (c) the
   headline arm, captured, 48 steps under ``opt_state_dtype`` None,
   "bfloat16" and "int8" (``opt_state_arms``): the moments' bytes equal
   ``opt_state_bytes`` exactly, bf16 and int8 final losses within 1% of
   the default's, ms/step and peak memory; an int8 checkpoint resumed
   bitwise and a default-policy checkpoint resumed by an int8 fit,
   requantized bitwise (``int8_resume_check``); at depth 2 in f32 the int8
   fit captured vs eager and one optimizer step card vs CPU, moments
   within one quantization step (``int8_step_check``); the policy's store
   keeping nu in the sqrt domain (``int8_codec_check``); (d) a depth-2 fit
   with ``CSVLogger``, ``DeviceStatsCallback``, ``ProfilerCallback``,
   SWA and EMA under megastep 8 and 1 (``callbacks_check``): rows on the
   log grid, the peak equal to ``torch.cuda.max_memory_allocated``, the
   Chrome trace naming ``tc_flash_fwd_kernel``, SWA bitwise its running
   mean of the epoch-end params, EMA against the stride-boundary params
   blended with ``decay**K``, no shadow aliasing the live params.

Any failure raises: the script exits non-zero and prints no result.  The
line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
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
# Flash at head_dim 256: GPT-2-small's width over 3 heads, batch 16 x 1024.
FLASH_256 = (16, 1024, 3, 256)
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

def bgmv_inputs(torch, W, k, r, dtype, mixed, gen, copies=1, d=D_MODEL,
                run=None):
    """``copies`` independent (h, a, b, ids) sets at one shape.  Slot 0
    is the null adapter; ``mixed`` rows cycle through all N slots (a
    decode batch of every tenant and the base model); ``run`` gives runs
    of that many rows one id, cycling through the tenants (the prefill
    rows of consecutive sequences); otherwise every row has tenant 1 (one
    prefill)."""
    n = N_TENANTS + 1
    rows = torch.arange(W, device="cuda")
    if run is not None:
        ids = (rows // run % N_TENANTS + 1).to(torch.int32)
    elif mixed:
        ids = (rows % n).to(torch.int32)
    else:
        ids = torch.ones(W, dtype=torch.int32, device="cuda")
    sets = []
    for _ in range(copies):
        h = torch.randn(W, d, generator=gen, device="cuda")
        a = torch.randn(n, d, r, generator=gen, device="cuda") * 0.05
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


def graph_floor_ms(torch):
    """The per-call floor of ``graph_ms``: a one-element ``add_`` (one tiny
    kernel) captured and replayed the same way, 64 calls a graph."""
    x = torch.zeros(1, device="cuda")
    return graph_ms(torch, lambda t: t.add_(1.0), [(x,)] * 64)


def bgmv_plan(lora, W, k, r, dtype):
    """The BGMV kernel's launch plan at one shape (``rlt_bgmv_plan``), as
    text."""
    from ray_lightning_tpu_torch.ops import _build

    fn = _build.load_function("bgmv", "rlt_bgmv_plan",
                              [ctypes.c_int] * 7 + [ctypes.c_void_p])
    vals = (ctypes.c_int * 6)()
    code = lora._DTYPE_CODES[dtype]
    err = fn(W, D_MODEL, r, k, N_TENANTS + 1, code, 0,
             ctypes.cast(vals, ctypes.c_void_p))
    check(err == 0, f"bgmv plan query at W={W} k={k}")
    dsplit, kblocks, tiles, smem1, smem2, aligned = vals
    if dsplit == 0:
        return f"plan: row kernel {kblocks} x {tiles} blocks"
    return (f"plan: t kernel {dsplit} slices of d ({smem1} B shared), out "
            f"kernel {kblocks} x {tiles} blocks ({smem2} B shared), "
            f"{'16-byte' if aligned else 'element-wise'} copies")


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


def bgmv_tolerance(torch, dtype, ref):
    """Phase 1's tolerance of a BGMV result: f32 1e-5·max|ref| + 1e-6 (f32
    sums in another order), bf16 2e-2·max|ref| (one rounding of the
    output, which may land on the other side)."""
    scale = ref.float().abs().max().item()
    return 1e-5 * scale + 1e-6 if dtype == torch.float32 else 2e-2 * scale


# Phase 1's extra shapes beyond the serving path's (W, k) x ranks grid:
# (label, W, d, r, k, mixed, run).  Runs of 100 rows are five sequences'
# prefill rows, so 64-row tiles straddle two ids; d = 100 and k = 1001 are
# no multiple of 16 bytes (the element-wise path, with a d tail in bf16).
BGMV_EXTRA = (("prefill runs of 100", PREFILL_W, D_MODEL, 16, 3 * D_MODEL,
               False, 100),
              ("one row", 1, D_MODEL, 16, 3 * D_MODEL, True, None),
              ("64 rows mixed", 64, D_MODEL, 16, D_MODEL, True, None),
              ("rank 128", DECODE_W, D_MODEL, 128, 3 * D_MODEL, True, None),
              ("ragged r", 3, D_MODEL, 100, 1000, True, None),
              ("ragged d and k", 5, 100, 16, 1001, True, None))


def bgmv_checks(torch, lora, gen):
    """Phase 1: every check of the BGMV kernel against its plain version,
    as (label, passed, detail) — the serving path's shapes in f32 and bf16
    at ranks 8, 16 and 64 (each also with every row on the null slot,
    which must give exactly 0.0), ``BGMV_EXTRA``, and a decode batch with
    an out-of-range id (its row NaN, the others right)."""
    out = []

    def held(label, dtype, h, a, b, ids):
        got = lora.bgmv(h, a, b, ids)
        ref = lora.bgmv_plain(h, a, b, ids)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = bgmv_tolerance(torch, dtype, ref)
        out.append((f"bgmv {str(dtype)[6:]} {label}", err <= tol,
                    f"max_abs_err={err:.3e} tol={tol:.3e}"))

    shapes = [(W, k) for W in (DECODE_W, PREFILL_W) for k in (3 * D_MODEL,
                                                               D_MODEL)]
    for dtype in (torch.float32, torch.bfloat16):
        for W, k in shapes:
            for r in RANKS:
                ((h, a, b, ids),) = bgmv_inputs(torch, W, k, r, dtype,
                                                W == DECODE_W, gen)
                held(f"W={W} d={D_MODEL} r={r} k={k}", dtype, h, a, b, ids)
                zero = lora.bgmv(h, a, b, torch.zeros_like(ids))
                torch.cuda.synchronize()
                out.append((f"bgmv {str(dtype)[6:]} W={W} r={r} k={k} null "
                            f"slot", bool((zero == 0).all()),
                            "every element exactly 0.0"))
        for label, W, d, r, k, mixed, run in BGMV_EXTRA:
            ((h, a, b, ids),) = bgmv_inputs(torch, W, k, r, dtype, mixed,
                                            gen, d=d, run=run)
            held(f"{label} W={W} d={d} r={r} k={k}", dtype, h, a, b, ids)
        ((h, a, b, ids),) = bgmv_inputs(torch, DECODE_W, 3 * D_MODEL, 16,
                                        dtype, True, gen)
        ids[2] = N_TENANTS + 3
        got = lora.bgmv(h, a, b, ids)
        ref = lora.bgmv_plain(h, a, b, torch.where(ids < N_TENANTS + 1,
                                                   ids, 0))
        torch.cuda.synchronize()
        keep = torch.arange(DECODE_W, device="cuda") != 2
        err = (got[keep].float() - ref[keep].float()).abs().max().item()
        tol = bgmv_tolerance(torch, dtype, ref[keep])
        out.append((f"bgmv {str(dtype)[6:]} out-of-range id",
                    bool(torch.isnan(got[2].float()).all()) and err <= tol,
                    f"row 2 all NaN; the rest max_abs_err={err:.3e} "
                    f"tol={tol:.3e}"))
    return out


def phase_kernel(torch, lora, card):
    """Phases 1 and 2.  Returns the JSON record fields measured at the
    main path's most frequent call: decode qkv, f32, rank 16."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = bgmv_checks(torch, lora, gen)
    for label, ok, detail in checks:
        print(f"phase 1: {label}: {detail}")
    for label, ok, _ in checks:
        check(ok, label)
    print(f"phase 1: {len(checks)} checks passed; null-slot rows gave "
          f"exactly 0.0 at every shape")
    shapes = [(W, k) for W in (DECODE_W, PREFILL_W) for k in (3 * D_MODEL,
                                                               D_MODEL)]
    floor = graph_floor_ms(torch)
    print(f"phase 2: graph floor (a one-element add_ captured and replayed "
          f"as each kernel below): {floor * 1e3:.2f} us a call; {card}")
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
                  f" us; bound {bound_ms * 1e3:.3f} us ({bound_by}); floor "
                  f"{floor * 1e3:.2f} us; library none; "
                  f"{bgmv_plan(lora, W, k, r, dtype)}; {card}")
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
                           (TRAIN_B, TRAIN_T, 6, 128), FLASH_256):
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
    flash_256_timing(torch, gen, card)
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


def flash_256_timing(torch, gen, card):
    """Phase 6: the bf16 flash pair at head_dim 256 (``FLASH_256``) beside
    its plain version, the SDPA yardsticks at the same shape and its
    bound; printed, with no gate (no model of the main path has this
    head_dim: 0 launches on the headline arm)."""
    import torch.nn.functional as F

    from ray_lightning_tpu_torch.ops import flash_attention as fa

    B, S, H, D = FLASH_256
    scale = D ** -0.5
    sets = [flash_case(torch, gen, B, S, H, D, torch.bfloat16)
            for _ in range(2)]
    bwd_sets = [(q, k, v, *fa.flash_fwd(q, k, v, scale), do)
                for q, k, v, do in sets]
    heads = [tuple(t.transpose(1, 2) for t in (q, k, v, do))
             for q, k, v, do in sets]

    def sdpa_bwd_sets():
        out = []
        for q, k, v, do in heads:
            r = torch.ops.aten._scaled_dot_product_flash_attention(
                q, k, v, 0.0, True)
            out.append((do, q, k, v, *r[:6], r[6], r[7]))
        return out

    def sdpa_bwd(do, q, k, v, o, lse, cq, ck, mq, mk, seed, offset):
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, True, seed, offset)

    (fb, fby), (bb, bby) = flash_bounds(B, S, H, D, 2, "bfloat16")
    fwd = graph_ms(torch, lambda q, k, v, _: fa.flash_fwd(q, k, v, scale),
                   sets, reps=5)
    fwd_plain = graph_ms(torch, lambda q, k, v, _: fa.flash_fwd_plain(
        q, k, v, scale), sets, reps=5)
    bwd = graph_ms(torch, lambda *a: fa.flash_bwd(*a, scale), bwd_sets,
                   reps=5)
    bwd_plain = graph_ms(torch, lambda *a: fa.flash_bwd_plain(*a, scale),
                         bwd_sets, reps=5)
    lib_fwd = library("F.scaled_dot_product_attention at D=256", lambda:
                      graph_ms(torch, lambda q, k, v, _: F
                               .scaled_dot_product_attention(
                                   q, k, v, is_causal=True), heads, reps=5))
    lib_bwd = library("SDPA flash backward at D=256", lambda: graph_ms(
        torch, sdpa_bwd, sdpa_bwd_sets(), reps=5))

    def us(x):
        return "not timed" if x is None else f"{x * 1e3:.1f} us"

    print(f"phase 6: flash bf16 at (B, S, H, D) = {FLASH_256}: fwd "
          f"{us(fwd)} (plain {us(fwd_plain)}; F.scaled_dot_product_attention"
          f" {us(lib_fwd)}; bound {fb * 1e3:.1f} us, {fby}); bwd {us(bwd)} "
          f"(plain {us(bwd_plain)}; SDPA flash backward {us(lib_bwd)}; "
          f"bound {bb * 1e3:.1f} us, {bby}); {card}")
    print("flash_256: " + json.dumps({
        "fwd_ms": fwd, "fwd_plain_ms": fwd_plain, "fwd_library_ms": lib_fwd,
        "fwd_bound_ms": fb, "bwd_ms": bwd, "bwd_plain_ms": bwd_plain,
        "bwd_library_ms": lib_bwd, "bwd_bound_ms": bb}))


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
    """One bf16 fit of ``GPT(cfg, **gpt_kw)`` at batch TRAIN_B, every step
    eager (``megastep="off"``: phase 7 is the eager yardstick, and its
    launch counters count Python calls, which a captured graph's replays
    do not make); returns (global_step, callback_metrics)."""
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import GPT, SyntheticLMDataModule

    tr = Trainer(max_steps=steps, limit_val_batches=0, precision="bf16",
                 seed=SEED, callbacks=list(callbacks), megastep="off",
                 enable_checkpointing=False)
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
                     callbacks=[Losses()], enable_checkpointing=False)
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


# -- phase 9: megastep ------------------------------------------------------

MEGASTEP_K = 8
# 7 strides: the eager warm-up, the capture and its replay, then 5 more
# replays, whose windows the step time is read from.  Not a multiple of
# the telemetry's sampling cadence (32 steps): the last stride is not a
# sampled one, and step_time_ms covers its device time only through the
# loop's wait at the epoch's end.
MEGASTEP_STEPS = 56
PROFILE_STEPS = 32         # the profiled fits: strides 3 and 4
# The f32 parity: megastep 4 over 12 steps, so 2 strides are replays (a
# graph that froze its capture-time step count would still get the first
# replay right).
PARITY_K, PARITY_STEPS = 4, 12
# With the flash kernels the eager fit does not repeat itself (the f32
# dQ atomics): the captured fit's params are held to this multiple of the
# eager-vs-eager difference of the same run (1.40e-5 on an H100; the
# learning rate frozen at capture reads 1.12e-3), or to 1e-5.
PARITY_FLOOR_X = 5
# The bf16 captured-vs-eager losses: sound runs read <= 8.4e-6 on an
# H100, the state not written back 1.6e-3.
BF16_LOSS_TOL = 1e-4
# Each training kernel's main launch by its name in a profile (bf16).
PROFILE_NAMES = {"ln_fwd": "ln_fwd_kernel", "ln_bwd": "ln_bwd_rows_kernel",
                 "flash_fwd": "tc_flash_fwd_kernel",
                 "flash_bwd": "tc_flash_bwd_kernel",
                 "ce_fwd": "ce_fwd_wgmma_kernel",
                 "ce_bwd_dx": "ce_grad_cluster_kernel<false>",
                 "ce_bwd_dw": "ce_grad_cluster_kernel<true>"}


def megastep_fit(torch, cfg, gpt_kw, steps, megastep, precision="bf16",
                 init=None, callbacks=(), batch=TRAIN_B):
    """One fit of ``GPT(cfg, **gpt_kw)`` on the card through
    ``LocalStrategy(megastep=...)``; returns the trainer."""
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import GPT, SyntheticLMDataModule
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    module = GPT(cfg, **gpt_kw)
    if init is not None:
        module.initial_params = init
    tr = Trainer(LocalStrategy(megastep=megastep), max_steps=steps,
                 limit_val_batches=0, precision=precision, seed=SEED,
                 callbacks=list(callbacks), enable_checkpointing=False)
    tr.fit(module, SyntheticLMDataModule(cfg, batch_size=batch,
                                         num_batches=steps, seed=SEED))
    return tr


def hook_clock(torch, Callback):
    class HookClock(Callback):
        """A CUDA event, the loss tensor and the batch index at each hook:
        each step of an eager fit, each stride's end of a captured one."""

        def __init__(self):
            self.events, self.losses, self.index = [], [], []

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            self.losses.append(logs["train_loss"])
            self.index.append(batch_idx)

    return HookClock()


def stride_ms(clock, k):
    """Device ms of each k-step window after the first, between the CUDA
    events at the windows' ends (the first is the 2nd stride, which a
    captured fit spends capturing first)."""
    ends = [e for e, i in zip(clock.events, clock.index) if (i + 1) % k == 0]
    return [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]


def booked_ms(clock, first):
    """Device ms a step over the steps a fit's ``StepStats`` books as
    steady state, from the CUDA events at the hook of batch index
    ``first`` (the last step it books as compile) to the last hook."""
    at = dict(zip(clock.index, clock.events))
    last = clock.index[-1]
    return at[first].elapsed_time(at[last]) / (last - first)


# Each training kernel's main launch by its name in a captured graph's
# kernel nodes (``kernel_name`` of the mangled name).
GRAPH_NAMES = {"ln_fwd": "ln_fwd_kernel", "ln_bwd": "ln_bwd_rows_kernel",
               "flash_fwd": "tc_flash_fwd_kernel",
               "flash_bwd": "tc_flash_bwd_kernel",
               "ce_fwd": "ce_fwd_wgmma_kernel",
               "ce_bwd_dx": "ce_grad_cluster_kernel<0>",
               "ce_bwd_dw": "ce_grad_cluster_kernel<1>"}


@contextlib.contextmanager
def kept_graphs(torch):
    """CUDA graphs made inside the block keep their ``cudaGraph_t``
    (``keep_graph``, debug mode) so that :func:`graph_kernels` can read
    their nodes; yields the list of them."""
    graphs, base = [], torch.cuda.CUDAGraph

    class Kept(base):
        def __init__(self, *args, **kwargs):
            super().__init__(keep_graph=True)
            self.enable_debug_mode()
            graphs.append(self)

    torch.cuda.CUDAGraph = Kept
    try:
        yield graphs
    finally:
        torch.cuda.CUDAGraph = base


def graph_kernels(graph):
    """Each training kernel's nodes in a captured graph (its DOT dump):
    the launches each replay makes, which the profiler, losing records
    now and then, cannot count exactly."""
    import collections
    import os
    import tempfile
    import warnings

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            graph.debug_dump(path)
        with open(path) as f:
            names = collections.Counter(
                kernel_name(m) for m in re.findall(r"\b(_Z\w+)", f.read()))
    return {k: sum(n for name, n in names.items() if name.startswith(want))
            for k, want in GRAPH_NAMES.items()}


def profiled_strides(torch, cfg, gpt_kw, megastep):
    """A fit profiled over its 3rd and 4th strides of MEGASTEP_K steps
    (two replays when captured): each training kernel's launches
    by name, and the device's idle share over the span from the first
    kernel's start to the last one's end; the launches the wrappers'
    counters saw over the same strides (``counted``; none in a replay);
    and, captured, each kernel's nodes in the graph (``graph``, the
    launches of a replay).  None when the profiler records no CUDA
    events."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from ray_lightning_tpu_torch.core.callbacks import Callback

    per = 1 if megastep == "off" else MEGASTEP_K
    hooks = MEGASTEP_K // per  # hook calls a stride

    counters = launch_counters()

    class Stepper(Callback):
        def __init__(self, prof):
            self.prof, self.calls, self.counted = prof, 0, None

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            self.calls += 1
            if self.calls in (2 * hooks, 4 * hooks):
                # The window opens on an idle card (nothing of the strides
                # before it lands in it) and closes on one (all of its
                # kernels have run).
                torch.cuda.synchronize()
            if self.calls == 2 * hooks:
                for c in counters.values():
                    c.launches = 0
            if self.calls == 4 * hooks:
                self.counted = {k: c.launches for k, c in counters.items()}
            self.prof.step()

    # The 2nd stride's last hook call is the profiler's warm-up step: the
    # tracer runs before the window opens.
    with kept_graphs(torch) as graphs, profile(
            activities=[ProfilerActivity.CUDA],
            schedule=schedule(wait=2 * hooks - 1, warmup=1,
                              active=2 * hooks, repeat=1)) as prof:
        stepper = Stepper(prof)
        megastep_fit(torch, cfg, gpt_kw, PROFILE_STEPS, megastep,
                     callbacks=[stepper])
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        return None
    start = min(e.time_range.start for e in device)
    end = max(e.time_range.end for e in device)
    busy = sum(e.time_range.elapsed_us() for e in device)
    counts = {k: sum(1 for e in device if name in e.name)
              for k, name in PROFILE_NAMES.items()}
    return {"launches": counts, "counted": stepper.counted,
            "graph": graph_kernels(graphs[0]) if len(graphs) == 1 else None,
            "span_ms": (end - start) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / (end - start), "events": len(device)}


def write_back_ms(torch, state, reps=20):
    """Device ms of one write-back of the whole training state
    (``step_fns.copy_state``, what each captured step does once) and the
    bytes it moves (each leaf read once and written once)."""
    from ray_lightning_tpu_torch.core.module import TrainState
    from ray_lightning_tpu_torch.models.optim import tree_leaves, tree_map
    from ray_lightning_tpu_torch.parallel.step_fns import copy_state

    src = TrainState(tree_map(torch.clone, state.params),
                     tree_map(torch.clone, state.opt_state))
    copy_state(state, src)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        copy_state(state, src)
    stop.record()
    stop.synchronize()
    nbytes = 2 * sum(t.nbytes for t in tree_leaves(
        (state.params, state.opt_state)))
    return start.elapsed_time(stop) / reps, nbytes


def megastep_parity(torch, card):
    """Depth-2 GPT-2-small (full width) in f32, warmup 2 (so the learning
    rate and bias corrections move step to step): ``megastep=PARITY_K``
    against ``"off"`` over PARITY_STEPS steps from one init, in the
    headline configuration and with the plain attention
    (``attn_impl="xla"``).  The losses the captured fit reports (each
    stride's last step, and the epoch mean) within 1e-5 relative of the
    eager fit's in both; the params within 1e-5 absolute with the plain
    attention, where the eager fit repeats itself.  With the flash
    kernels it does not: the f32 flash backward adds dQ with atomics in
    an order that changes from run to run, and Adam divides each
    gradient by its own scale, so a second eager fit reads that spread
    (the floor) and the captured fit's params are held within
    PARITY_FLOOR_X times it (or 1e-5).  Returns the readings and
    ``ok``."""
    import numpy as np

    from ray_lightning_tpu_torch.core.callbacks import Callback
    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
    from ray_lightning_tpu_torch.models.optim import tree_leaves

    cfg = dataclasses.replace(GPTConfig.gpt2_small(), n_layer=2,
                              warmup_steps=2)
    init = GPT(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(SEED + 3))
    ends = [PARITY_K * j - 1 for j in range(1, PARITY_STEPS // PARITY_K + 1)]

    def param_diff(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(
            tree_leaves(a.state.params), tree_leaves(b.state.params)))

    out, ok = {}, True
    for label, kw, repeat in (("headline", HEADLINE, True),
                              ("xla_attention", {**HEADLINE,
                                                 "attn_impl": "xla"}, False)):
        runs = {}
        for name, mode in (("eager", "off"), ("captured", PARITY_K),
                           *((("eager_again", "off"),) if repeat else ())):
            clock = hook_clock(torch, Callback)
            tr = megastep_fit(torch, cfg, kw, PARITY_STEPS, mode,
                              precision="f32", init=init, callbacks=[clock],
                              batch=2)
            runs[name] = (tr, {i: float(x) for i, x in
                               zip(clock.index, clock.losses)})
        (eager, e_loss), (cap, c_loss) = runs["eager"], runs["captured"]
        loss_rel = max(abs(c_loss[i] - e_loss[i]) / abs(e_loss[i])
                       for i in ends if i in c_loss)
        mean_rel = abs(cap.callback_metrics["train_loss"]
                       - eager.callback_metrics["train_loss"]) / abs(
            eager.callback_metrics["train_loss"])
        diff = param_diff(cap, eager)
        floor = param_diff(runs["eager_again"][0], eager) if repeat else None
        param_tol = max(PARITY_FLOOR_X * floor, 1e-5) if repeat else 1e-5
        good = (sorted(c_loss) == ends
                and cap.callback_metrics["recompiles"] == 1
                and np.isfinite(loss_rel) and loss_rel <= 1e-5
                and mean_rel <= 1e-5 and diff <= param_tol)
        ok = ok and good
        print(f"phase 9 parity {label}: depth 2, f32, megastep {PARITY_K} vs "
              f"off over {PARITY_STEPS} steps: stride-end losses "
              + ", ".join(f"{i}: {c_loss.get(i, float('nan')):.7f} / "
                          f"{e_loss[i]:.7f}" for i in ends)
              + f"; worst rel {loss_rel:.3e}, epoch mean rel {mean_rel:.3e} "
              f"(tol 1e-5); params max abs diff {diff:.3e} (tol "
              f"{param_tol:.3e}"
              + (f" = max({PARITY_FLOOR_X} x eager vs eager on the card "
                 f"{floor:.3e}, 1e-5))" if repeat else ")")
              + f"; captures {cap.callback_metrics['recompiles']:.0f}; "
              f"{'ok' if good else 'FAILED'}; {card}")
        out[label] = {"loss_rel": loss_rel, "mean_rel": mean_rel,
                      "param_diff": diff, "eager_floor": floor,
                      "param_tol": param_tol, "ok": good}
    out["ok"] = ok
    return out


def phase_megastep(torch, card):
    """Phase 9: arms (a) and (b) of phase 7, each eager (``megastep="off"``)
    and captured (``megastep=8``), 56 steps: ms/step (median of the 3rd to
    7th 8-step windows ÷ 8, CUDA events) with every window, tokens/s, MFU,
    ``dispatch_ms`` and a stride's host issue time, the device's idle share
    over two strides (profiled fit), peak memory, the capture's wall time
    and the state write-back's cost; gates on the kernel launches (the
    captured graph's nodes, the eager steps' counters), one capture per
    captured fit, peak memory, the bf16 losses
    and ``step_time_ms`` against the events.  Then the f32 parity."""
    import gc

    import numpy as np

    from ray_lightning_tpu_torch.core.callbacks import Callback
    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.telemetry.step_stats import (
        model_flops_per_token,
    )

    cfg = GPTConfig.gpt2_small()
    flops = model_flops_per_token(cfg, "full")
    k = MEGASTEP_K
    print(f"phase 9: megastep: GPT-2-small, batch {TRAIN_B} x {TRAIN_T}, "
          f"bf16, {MEGASTEP_STEPS} steps a fit, eager (megastep='off') and "
          f"captured (megastep={k}: one CUDA graph of {k} steps, captured "
          f"at the 2nd stride and replayed from there on)")
    result, failed = {}, []

    def gate(cond, what):
        # Every reading of the phase prints before a failed gate stops it.
        if not cond:
            print(f"phase 9: FAILED: {what}")
            failed.append(what)

    for label, kw in ARMS[:2]:
        arm = {}
        for mode in ("off", k):
            name = "eager" if mode == "off" else "captured"
            clock = hook_clock(torch, Callback)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tr = megastep_fit(torch, cfg, kw, MEGASTEP_STEPS, mode,
                              callbacks=[clock])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            reserved = torch.cuda.max_memory_reserved()
            windows = stride_ms(clock, k)
            ms = float(np.median(windows[1:])) / k
            tokens_s = TRAIN_B * TRAIN_T / (ms / 1e3)
            m = tr.callback_metrics
            stats = tr.telemetry_report["step_stats"]
            losses = {i: float(x) for i, x in zip(clock.index, clock.losses)}
            wb_ms, wb_bytes = write_back_ms(torch, tr.state)
            prof = profiled_strides(torch, cfg, kw, mode)
            check(prof is not None, f"{label} {name}: the profiler recorded "
                  "the card's kernels")
            # StepStats books step 0 (eager) or the first two strides (the
            # warm-up and the capture) as compile.
            booked = booked_ms(clock, 0 if mode == "off" else 2 * k - 1)
            tel_rel = abs(m["step_time_ms"] - booked) / booked
            # The host waits inside a dispatch for room to queue more
            # work (or, captured, for the pinned batch buffer), which keeps
            # it at most about a stride ahead of the card.  The smallest
            # dispatch is that of a stride that starts on an idle card
            # (after a sampled one).
            issue_ms = stats["dispatch_min_ms"] * k
            arm[name] = {
                "step_ms": ms, "stride_ms": windows,
                "tokens_per_s": tokens_s, "mfu": tokens_s * flops / 989e12,
                "step_time_ms": m["step_time_ms"], "booked_ms": booked,
                "dispatch_ms": m["dispatch_ms"],
                "stride_dispatch_ms": m["dispatch_ms"] * k,
                "stride_dispatch_min_ms": issue_ms,
                "device_step_ms": m.get("device_step_ms"),
                "telemetry_mfu": m.get("mfu"),
                "idle_share": prof["idle_share"],
                "profile_span_ms": prof["span_ms"],
                "profile_launches": prof["launches"],
                "peak_gib": peak / 2**30, "reserved_gib": reserved / 2**30,
                "capture_s": stats.get("capture_total_s", 0.0),
                "write_back_ms": wb_ms, "write_back_gb": wb_bytes / 1e9,
                "losses": losses, "train_loss": m["train_loss"],
                "wall_s": wall,
            }
            print(f"phase 9 {label} {name}: step {ms:.2f} ms (median of "
                  f"strides 3-{len(windows) + 1} / {k}, CUDA events; "
                  f"strides 2-{len(windows) + 1} "
                  + ", ".join(f"{w:.1f}" for w in windows)
                  + f" ms); {tokens_s:.0f} tokens/s; MFU "
                  f"{100 * tokens_s * flops / 989e12:.2f}% (989 TF/s); "
                  f"telemetry step_time_ms {m['step_time_ms']:.2f} against "
                  f"the events' {booked:.2f} over the steps it books "
                  f"({100 * tel_rel:.1f}% off), dispatch_ms "
                  f"{m['dispatch_ms']:.3f} ({m['dispatch_ms'] * k:.2f} ms "
                  f"a stride; the smallest, on an idle card, "
                  f"{issue_ms:.2f} ms), mfu "
                  f"{100 * m.get('mfu', float('nan')):.2f}%; device idle "
                  f"{100 * prof['idle_share']:.1f}% of two strides' span "
                  f"({prof['span_ms']:.1f} ms, {prof['events']} device "
                  f"events); peak allocated {peak / 2**30:.2f} GiB, reserved "
                  f"{reserved / 2**30:.2f} GiB; captures "
                  f"{m['recompiles']:.0f}, capture wall "
                  f"{arm[name]['capture_s']:.2f} s; state write-back "
                  f"{wb_ms:.3f} ms ({wb_bytes / 1e9:.2f} GB moved, "
                  f"{wb_bytes / wb_ms / 1e6:.0f} GB/s); fit wall {wall:.1f} s;"
                  f" {card}")
            gate(tr.global_step == MEGASTEP_STEPS,
                  f"{label} {name}: every step ran")
            gate(all(np.isfinite(list(losses.values()))),
                  f"{label} {name}: finite losses")
            want = per_step_launches(cfg.n_layer, kw.get("remat", False))
            # The profiler loses records now and then (64 or ~1000 of
            # ~23,000 in a window of two eager strides, and up to 15 of a
            # gated kernel's 784 in two replays, on an H100), so neither
            # arm is gated by its count: the eager arm by the wrappers'
            # counters, which count every launch, the captured one by the
            # graph's kernel nodes (a replay launches each once) and by
            # the profiler seeing each kernel in the replays.
            print(f"phase 9 {label} {name}: launches in two strides "
                  f"(profiler / counters"
                  + (" / 2 x graph nodes" if prof["graph"] else "") + "): "
                  + ", ".join(
                      f"{kn} {prof['launches'][kn]} / {prof['counted'][kn]}"
                      + (f" / {2 * prof['graph'][kn]}" if prof["graph"]
                         else "") for kn in want))
            if mode == "off":
                for kn, n in prof["counted"].items():
                    gate(n == 2 * k * want[kn],
                         f"{label} {name}: {kn} {n} launches in two strides"
                         f" = 2 x {k} x {want[kn]}")
            else:
                gate(prof["graph"] is not None, f"{label} {name}: one graph")
                for kn, n in (prof["graph"] or {}).items():
                    gate(n == k * want[kn],
                         f"{label} {name}: {kn} {n} kernel nodes in the "
                         f"graph = {k} x {want[kn]}")
                    gate(prof["launches"][kn] > 0,
                         f"{label} {name}: the profiler saw {kn} in the "
                         f"replays")
            gate(m["recompiles"] == (0 if mode == "off" else 1),
                  f"{label} {name}: captures {m['recompiles']}")
            gate(tel_rel <= 0.10, f"{label} {name}: step_time_ms "
                 f"{m['step_time_ms']:.2f} within 10% of the events' "
                 f"{booked:.2f}")
            # The next fit's peak must not count this one's state.
            del tr, clock
        eager, cap = arm["eager"], arm["captured"]
        gate(cap["peak_gib"] <= 1.10 * eager["peak_gib"],
              f"{label}: captured peak {cap['peak_gib']:.2f} GiB <= 1.10 x "
              f"eager {eager['peak_gib']:.2f} GiB")
        rel = max(abs(cap["losses"][i] - eager["losses"][i])
                  / abs(eager["losses"][i]) for i in cap["losses"])
        mean_rel = abs(cap["train_loss"] - eager["train_loss"]) / abs(
            eager["train_loss"])
        print(f"phase 9 {label}: captured vs eager: stride-end losses worst "
              f"rel {rel:.3e}, epoch mean rel {mean_rel:.3e} (tol "
              f"{BF16_LOSS_TOL:g}, bf16); step {cap['step_ms']:.2f} vs {eager['step_ms']:.2f} "
              f"ms; idle {100 * cap['idle_share']:.1f}% vs "
              f"{100 * eager['idle_share']:.1f}%; peak "
              f"{cap['peak_gib']:.2f} vs {eager['peak_gib']:.2f} GiB")
        gate(rel <= BF16_LOSS_TOL and mean_rel <= BF16_LOSS_TOL,
             f"{label}: captured bf16 losses within {BF16_LOSS_TOL:g} of "
             f"eager")
        arm["loss_rel"], arm["mean_rel"] = rel, mean_rel
        result[label] = arm
    parity = megastep_parity(torch, card)
    gate(parity["ok"], "f32 parity of the captured fit")
    result["f32_parity"] = parity
    check(not failed, "phase 9: " + "; ".join(failed))
    return result


# -- phase 10: checkpoints, resume and the eval surface ----------------------

# An epoch of the checkpoint fits: megastep "auto" (8 on the card) makes
# it one eager stride and one captured, so the epoch's last stride is a
# replay whose write-back the checkpoint must see.
CKPT_STEPS = 16
EVAL_BATCHES = 4      # timed validate/test batches at 16 x 1024
PREDICT_BATCHES = 2   # timed predict batches at 16 x 1024
# Card vs CPU at full width: the CPU runs the plain versions, so its
# batches are small (a few seconds each).
CPU_EVAL_B, CPU_PREDICT_B = 2, 1
TOP2_GAP = 1e-4       # the serving gate's top-2 logit gap
BF16_EVAL_TOL = 1e-2  # bf16 activations, as phase 8's bf16 vs f32 losses


class EpochSlices:
    """A loader that yields the ``epoch``-th run of ``n`` batches of
    ``loader`` (``set_epoch``, as the fit loop calls it): each epoch
    trains on batches of its own."""

    def __init__(self, loader, n):
        self.loader, self.n, self.epoch = loader, n, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __iter__(self):
        import itertools

        return itertools.islice(iter(self.loader), self.epoch * self.n,
                                (self.epoch + 1) * self.n)


def fresh_epochs(cfg, batch, epochs):
    """The synthetic stream with a fresh CKPT_STEPS batches each epoch.
    On the card a bf16 fit that sees the same 16 batches again in its
    second epoch does not repeat itself: the flash backward's dQ atomics
    (1e-6 in the losses) grow to 1e-2 by the epoch's 10th step, while a
    fit over distinct batches stays within 1e-5 (and with the plain
    attention both are bitwise)."""
    from ray_lightning_tpu_torch.models.gpt import SyntheticLMDataModule

    class FreshEpochs(SyntheticLMDataModule):
        def train_dataloader(self):
            return EpochSlices(self._loader(), CKPT_STEPS)

    return FreshEpochs(cfg, batch_size=batch,
                       num_batches=epochs * CKPT_STEPS, seed=SEED)


def ckpt_fit(torch, cfg, gpt_kw, root, epochs, precision="bf16", init=None,
             resume=None, checkpoint=True, callbacks=(), batch=TRAIN_B,
             data=None):
    """A fit of ``GPT(cfg, **gpt_kw)`` on the card through the Trainer a
    user calls: ``megastep="auto"``, CKPT_STEPS steps an epoch (of
    ``data``, else the synthetic stream, the same batches each epoch),
    the default ``ModelCheckpoint`` under ``root`` when ``checkpoint``,
    resumed from ``resume`` when given."""
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import GPT, SyntheticLMDataModule
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    module = GPT(cfg, **gpt_kw)
    if init is not None:
        module.initial_params = init
    tr = Trainer(LocalStrategy(megastep="auto"), max_epochs=epochs,
                 limit_val_batches=0, precision=precision, seed=SEED,
                 callbacks=list(callbacks), default_root_dir=str(root),
                 enable_checkpointing=checkpoint,
                 resume_from_checkpoint=resume)
    tr.fit(module, data or SyntheticLMDataModule(
        cfg, batch_size=batch, num_batches=CKPT_STEPS, seed=SEED))
    return tr


def by_path(tree, path=""):
    """Leaves by key path (a resumed fit keeps its own dict order)."""
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items()
                for k2, v in by_path(sub, f"{path}['{k}']").items()}
    if isinstance(tree, (tuple, list)):
        return {k2: v for i, sub in enumerate(tree)
                for k2, v in by_path(sub, f"{path}[{i}]").items()}
    return {path: tree}


def file_vs_live(torch, path, state):
    """Leaves of the checkpoint at ``path`` that differ bitwise from the
    live ``state`` (dtype, shape or any bit; or its step), and the count
    of leaves and step."""
    from ray_lightning_tpu_torch.models.convert import train_state_from_jax
    from ray_lightning_tpu_torch.utils import state_stream as ss

    back = train_state_from_jax(
        ss.load_state_stream(ss.state_stream_from_file(path))["state"])
    live = by_path((state.params, state.opt_state))
    read = by_path((back.params, back.opt_state))
    bad = [k for k in live if k not in read
           or live[k].dtype != read[k].dtype
           or not torch.equal(live[k].cpu(), read[k])]
    # The step counts as one more leaf.
    return bad + ([] if back.step == state.step else ["step"]), len(live) + 1


def opt_count(state) -> int:
    """The optimizer's (Adam's) step count of a state."""
    opt = state.opt_state
    if isinstance(opt, dict):
        opt = opt["inner_opt_state"]
    return int(opt[1]["count"])


def stride_losses(clock):
    return {i: float(x) for i, x in zip(clock.index, clock.losses)}


def checkpoint_parity(torch, card):
    """Phase 10 (2): depth-2 GPT-2-small (full width) in f32, warmup 2, two
    epochs of CKPT_STEPS steps at batch 2 under megastep "auto": a
    straight fit against one epoch, its checkpoint, and a resumed second
    epoch, with the plain attention (``attn_impl="xla"``; the card repeats
    itself there: params bitwise) and in the headline configuration (the
    flash backward's dQ atomics: params within PARITY_FLOOR_X times a
    second straight fit's spread, or 1e-5).  Gates in each: the file
    equals the one-epoch fit's live state bitwise; the resumed fit's
    optimizer count is 2 x CKPT_STEPS (restored, not restarted) and its
    step counters the straight fit's; one capture in the resumed epoch;
    its stride-end losses within 1e-5 relative of the straight fit's.
    Returns the readings and ``ok``."""
    import tempfile

    from ray_lightning_tpu_torch.core.callbacks import Callback
    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = dataclasses.replace(GPTConfig.gpt2_small(), n_layer=2,
                              warmup_steps=2)
    init = GPT(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(SEED + 5))
    out, ok = {}, True
    with tempfile.TemporaryDirectory() as root:
        for label, kw, repeat in (
                ("xla_attention", {**HEADLINE, "attn_impl": "xla"}, False),
                ("headline", HEADLINE, True)):
            def fit(name, epochs, **more):
                clock = hook_clock(torch, Callback)
                tr = ckpt_fit(torch, cfg, kw, f"{root}/{label}-{name}",
                              epochs, precision="f32", init=init,
                              callbacks=[clock], batch=2, **more)
                return tr, stride_losses(clock)

            straight, s_loss = fit("straight", 2, checkpoint=False)
            one, _ = fit("one", 1)
            bad, n = file_vs_live(torch, one.best_model_path, one.state)
            split, p_loss = fit("split", 2, checkpoint=False,
                                resume=one.best_model_path)
            diff = max_diff(split.state.params, straight.state.params)
            floor = None
            if repeat:
                again, _ = fit("again", 2, checkpoint=False)
                floor = max_diff(again.state.params, straight.state.params)
            tol = max(PARITY_FLOOR_X * floor, 1e-5) if repeat else 0.0
            loss_rel = max(abs(p_loss[i] - s_loss[i]) / abs(s_loss[i])
                           for i in p_loss)
            count = opt_count(split.state)
            good = (not bad and count == 2 * CKPT_STEPS
                    and (split.global_step, split.micro_step)
                    == (straight.global_step, straight.micro_step)
                    and split.callback_metrics["recompiles"] == 1
                    and sorted(p_loss) == sorted(s_loss)
                    and math.isfinite(loss_rel) and loss_rel <= 1e-5
                    and diff <= tol)
            ok = ok and good
            print(f"phase 10 parity {label}: depth 2, f32, {CKPT_STEPS} + "
                  f"{CKPT_STEPS} steps (megastep auto): file vs live "
                  f"{n - len(bad)}/{n} leaves bitwise"
                  + (f" (differ: {bad[:3]})" if bad else "")
                  + f"; resumed optimizer count {count} (want "
                  f"{2 * CKPT_STEPS}); captures in the resumed epoch "
                  f"{split.callback_metrics['recompiles']:.0f}; stride-end "
                  f"losses worst rel {loss_rel:.3e} (tol 1e-5); params max "
                  f"abs diff {diff:.3e} (tol {tol:.3e}"
                  + (f" = max({PARITY_FLOOR_X} x straight vs straight "
                     f"{floor:.3e}, 1e-5))" if repeat else ", bitwise)")
                  + f"; {'ok' if good else 'FAILED'}; {card}")
            out[label] = {"file_leaves_differ": len(bad), "leaves": n,
                          "opt_count": count, "loss_rel": loss_rel,
                          "param_diff": diff, "floor": floor,
                          "param_tol": tol, "ok": good}
            del straight, one, split
    out["ok"] = ok
    return out


def max_diff(a, b) -> float:
    """Largest absolute difference between two parameter trees, leaf by
    key path."""
    a, b = by_path(a), by_path(b)
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def checkpoint_timing(torch, state, root):
    """(5): the state's host copy (a ``.cpu()`` of every leaf, the
    yardstick), the stream's encode (each leaf copied from the card into
    the stream's buffer), the file write (crc + write), and the read +
    restore into a template state on the card, in ms, with the file's
    bytes."""
    import os

    from ray_lightning_tpu_torch.core.loop import _restore_state
    from ray_lightning_tpu_torch.core.module import TrainState
    from ray_lightning_tpu_torch.models.convert import (
        train_state_from_jax, train_state_to_jax,
    )
    from ray_lightning_tpu_torch.models.optim import tree_map
    from ray_lightning_tpu_torch.utils import state_stream as ss

    def ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    path = os.path.join(str(root), "timed.ckpt")
    payload = {"state": train_state_to_jax(state), "epoch": 0,
               "global_step": state.step, "micro_step": state.step,
               "callback_metrics": {}}
    copy_ms, host = ms(lambda: tree_map(lambda t: t.cpu(),
                                        (state.params, state.opt_state)))
    del host
    encode_ms, stream = ms(lambda: ss.to_state_stream(payload))
    write_ms, _ = ms(lambda: ss.state_stream_to_file(stream, path))
    nbytes = os.path.getsize(path)
    del stream
    template = TrainState(tree_map(torch.empty_like, state.params),
                          tree_map(torch.empty_like, state.opt_state))

    def read():
        tree = ss.load_state_stream(ss.state_stream_from_file(path),
                                    device=state.params["wte"].device)
        return _restore_state(template, train_state_from_jax(tree["state"]))

    read_ms, back = ms(read)
    same = all(torch.equal(a, b) for a, b in zip(
        by_path((state.params, state.opt_state)).values(),
        by_path((back.params, back.opt_state)).values()))
    os.remove(path)
    return {"host_copy_ms": copy_ms, "encode_ms": encode_ms,
            "write_ms": write_ms, "file_bytes": nbytes,
            "write_gb_s": nbytes / write_ms / 1e6,
            "encode_gb_s": nbytes / encode_ms / 1e6,
            "read_restore_ms": read_ms, "read_gb_s": nbytes / read_ms / 1e6,
            "restored_bitwise": same}


def eval_data(cfg, batch, batches, seed=SEED + 7):
    """The synthetic stream with test and predict loaders too."""
    from ray_lightning_tpu_torch.models.gpt import SyntheticLMDataModule

    class EvalData(SyntheticLMDataModule):
        def test_dataloader(self):
            return self._loader()

        def predict_dataloader(self):
            return self._loader()

    return EvalData(cfg, batch_size=batch, num_batches=batches, seed=seed)


def eval_trainer(device, precision, batches=-1):
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    return Trainer(LocalStrategy(device=device), precision=precision,
                   limit_val_batches=batches, enable_checkpointing=False,
                   seed=SEED)


def phase_checkpoint(torch, card):
    """Phase 10: checkpoints, resume and the eval surface.  (1) the headline
    arm at full width (bf16, remat "dots+flash", megastep "auto"): one
    epoch of CKPT_STEPS steps with the default ModelCheckpoint, the file
    read back against the live state bitwise, a resumed second epoch (of
    batches of its own, ``fresh_epochs``) against a straight two-epoch
    fit (stride-end losses within
    BF16_LOSS_TOL, one capture, the optimizer count restored) whose
    captured stride's kernels the profiler counts by name (8 x phase 9's
    per-step counts); (2) ``checkpoint_parity``; (3) ``validate`` and
    ``test`` from the checkpoint: f32 card vs CPU within 1e-5 relative,
    bf16 card vs f32 CPU within BF16_EVAL_TOL, and per bf16 batch LN fwd
    2L+1, flash fwd L, CE fwd 1 and no backward kernel by the wrappers'
    counters; (4) ``predict``: f32 card vs CPU argmax equal except at a
    top-2 logit gap < TOP2_GAP, on PREDICT_BATCHES batches; (5) timings:
    ``checkpoint_timing``, validate/test/predict ms a batch and tokens/s
    (bf16, 16 x 1024)."""
    import gc
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile, schedule

    from ray_lightning_tpu_torch.core.callbacks import Callback
    from ray_lightning_tpu_torch.core.loop import (
        FitConfig, run_eval, run_predict,
    )
    from ray_lightning_tpu_torch.models.convert import (
        jax_train_state_fields, params_from_jax,
    )
    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
    from ray_lightning_tpu_torch.utils import state_stream as ss

    cfg = GPTConfig.gpt2_small()
    counters = launch_counters()
    result, failed = {}, []

    def gate(cond, what):
        if not cond:
            print(f"phase 10: FAILED: {what}")
            failed.append(what)

    with tempfile.TemporaryDirectory() as root:
        # (1) the headline arm: fit, checkpoint, resume.
        for c in counters.values():
            c.launches = 0
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = ckpt_fit(torch, cfg, HEADLINE, f"{root}/one", 1,
                       data=fresh_epochs(cfg, TRAIN_B, 2))
        one_wall = time.perf_counter() - t0
        path = one.best_model_path
        bad, n = file_vs_live(torch, path, one.state)
        k = one.telemetry_report["meta"]["megastep"]
        print(f"phase 10: GPT-2-small headline arm, batch {TRAIN_B} x "
              f"{TRAIN_T}, bf16, megastep auto ({k}): one epoch of "
              f"{CKPT_STEPS} steps with the default ModelCheckpoint in "
              f"{one_wall:.1f} s -> {path.rsplit('/', 1)[-1]}; file vs live "
              f"state {n - len(bad)}/{n} leaves and step bitwise")
        gate(not bad, f"the checkpoint holds the live state ({bad[:3]})")
        timing = checkpoint_timing(torch, one.state, root)
        gate(timing["restored_bitwise"], "read + restore gives the state")
        del one
        gc.collect()
        s_clock = hook_clock(torch, Callback)
        straight = ckpt_fit(torch, cfg, HEADLINE, f"{root}/s", 2,
                            checkpoint=False, callbacks=[s_clock],
                            data=fresh_epochs(cfg, TRAIN_B, 2))
        s_loss = stride_losses(s_clock)
        straight_steps = (straight.global_step, straight.micro_step)
        del straight
        gc.collect()

        class Window(Callback):
            """Profiles the resumed epoch's second (captured) stride."""

            def __init__(self, prof):
                self.prof = prof

            def on_train_batch_end(self, trainer, module, logs, batch_idx):
                torch.cuda.synchronize()
                self.prof.step()

        r_clock = hook_clock(torch, Callback)
        with kept_graphs(torch) as graphs, profile(
                activities=[ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1,
                                  repeat=1)) as prof:
            split = ckpt_fit(torch, cfg, HEADLINE, f"{root}/r", 2,
                             checkpoint=False, resume=path,
                             callbacks=[r_clock, Window(prof)],
                             data=fresh_epochs(cfg, TRAIN_B, 2))
            torch.cuda.synchronize()
        p_loss = stride_losses(r_clock)
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = {k: sum(1 for e in device if name in e.name)
                for k, name in PROFILE_NAMES.items()}
        nodes = graph_kernels(graphs[0]) if len(graphs) == 1 else {}
        fit_launches = {k: c.launches for k, c in counters.items()}
        want = per_step_launches(cfg.n_layer, True)
        loss_rel = max(abs(p_loss[i] - s_loss[i]) / abs(s_loss[i])
                       for i in p_loss)
        count = opt_count(split.state)
        print(f"phase 10: resumed for a second epoch: stride-end losses "
              + ", ".join(f"{i}: {p_loss[i]:.6f} / {s_loss[i]:.6f}"
                          for i in sorted(p_loss))
              + f" (resumed / straight); worst rel {loss_rel:.3e} (tol "
              f"{BF16_LOSS_TOL:g}); captures "
              f"{split.callback_metrics['recompiles']:.0f}; optimizer count "
              f"{count} (want {2 * CKPT_STEPS}); the captured stride's "
              f"launches by profiler name / graph nodes "
              + ", ".join(f"{k} {v} / {nodes.get(k)}" for k, v in seen.items())
              + f" (want {MEGASTEP_K} x {list(want.values())}); {card}")
        print("phase 10: launches over the checkpoint path (fit, "
              "checkpoint, straight and resumed fits; counters): "
              + json.dumps(fit_launches))
        gate(all(v > 0 for v in fit_launches.values()),
             "every training kernel ran on the checkpoint path")
        gate(sorted(p_loss) == sorted(s_loss)
             and math.isfinite(loss_rel) and loss_rel <= BF16_LOSS_TOL,
             f"resumed losses within {BF16_LOSS_TOL:g} of straight")
        gate(split.callback_metrics["recompiles"] == 1,
             "one capture in the resumed epoch")
        gate(count == 2 * CKPT_STEPS, f"optimizer count {count} restored")
        gate((split.global_step, split.micro_step) == straight_steps,
             "resumed counters equal straight")
        # As in phase 9: the graph's nodes count a replay's launches, the
        # profiler shows the replay ran them.
        gate(len(graphs) == 1, "one graph in the resumed fit")
        for k, v in nodes.items():
            gate(v == MEGASTEP_K * want[k],
                 f"{k} {v} kernel nodes in the resumed fit's graph = "
                 f"{MEGASTEP_K} x {want[k]}")
            gate(seen[k] > 0, f"the profiler saw {k} in the replay")
        result["headline"] = {"file_leaves_differ": len(bad), "leaves": n,
                              "loss_rel": loss_rel, "opt_count": count,
                              "profile_launches": seen, "graph_nodes": nodes,
                              "launches": fit_launches, **timing}
        fitted = split.state.params
        del split
        gc.collect()

        # (2) f32 parity at depth 2.
        parity = checkpoint_parity(torch, card)
        gate(parity["ok"], "phase 10 f32 split-vs-straight parity")
        result["f32_parity"] = parity

        # (3) validate and test from the checkpoint.
        def validate(kind, device, precision, batch, batches):
            dm = eval_data(cfg, batch, batches)
            tr = eval_trainer(device, precision)
            run = tr.validate if kind == "validate" else tr.test
            return run(GPT(cfg, device=device, **HEADLINE), dm,
                       ckpt_path=path)

        cmp = {}
        for precision in ("f32", "bf16"):
            card_m = validate("validate", "cuda", precision, CPU_EVAL_B, 1)
            cmp[precision] = card_m["val_loss"]
        cpu_m = validate("validate", "cpu", "f32", CPU_EVAL_B, 1)
        f32_rel = abs(cmp["f32"] - cpu_m["val_loss"]) / cpu_m["val_loss"]
        bf_rel = abs(cmp["bf16"] - cpu_m["val_loss"]) / cpu_m["val_loss"]
        print(f"phase 10: validate from the checkpoint, batch {CPU_EVAL_B} x"
              f" {TRAIN_T}: val_loss card f32 {cmp['f32']:.7f}, card bf16 "
              f"{cmp['bf16']:.7f}, CPU f32 {cpu_m['val_loss']:.7f}; rel "
              f"{f32_rel:.3e} (tol 1e-5), bf16 {bf_rel:.3e} (tol "
              f"{BF16_EVAL_TOL:g})")
        gate(f32_rel <= 1e-5, "f32 validate card vs CPU")
        gate(bf_rel <= BF16_EVAL_TOL, "bf16 validate card vs f32 CPU")

        timed = {}
        for kind in ("validate", "test"):
            validate(kind, "cuda", "bf16", TRAIN_B, 1)  # warm-up
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = validate(kind, "cuda", "bf16", TRAIN_B, EVAL_BATCHES)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            per = {k: c.launches / EVAL_BATCHES for k, c in counters.items()}
            timed[kind] = {"launches_per_batch": per,
                           "val_loss": m["val_loss"]}
            print(f"phase 10: {kind} bf16, {EVAL_BATCHES} batches of "
                  f"{TRAIN_B} x {TRAIN_T} from the checkpoint: {wall:.2f} s "
                  f"(checkpoint read included); launches a batch "
                  + json.dumps(per))
            want_eval = {"ln_fwd": 2 * cfg.n_layer + 1,
                         "flash_fwd": cfg.n_layer, "ce_fwd": 1}
            for k, v in per.items():
                gate(v == want_eval.get(k, 0),
                     f"{kind}: {k} {v} launches a batch, want "
                     f"{want_eval.get(k, 0)}")

        # (4) predict, f32 card vs CPU.
        preds = {}
        for device in ("cuda", "cpu"):
            dm = eval_data(cfg, CPU_PREDICT_B, PREDICT_BATCHES)
            preds[device] = eval_trainer(device, "f32").predict(
                GPT(cfg, device=device, **HEADLINE), dm, ckpt_path=path)
        dm = eval_data(cfg, CPU_PREDICT_B, PREDICT_BATCHES)
        dm.setup("predict")
        gpt32 = GPT(cfg)
        tokens = torch.cat([torch.from_numpy(b["tokens"]) for b in
                            dm.predict_dataloader()]).to(gpt32.device)
        ckpt_params = params_from_jax(jax_train_state_fields(
            ss.load_state_stream(ss.state_stream_from_file(path))["state"])[0])
        with torch.no_grad():
            top2 = torch.topk(gpt32.forward(ckpt_params, tokens[:, :-1]),
                              2).values
        close = ((top2[..., 0] - top2[..., 1]) < TOP2_GAP).cpu().numpy()
        agree = bool(np.array_equal(preds["cuda"][~close],
                                    preds["cpu"][~close]))
        print(f"phase 10: predict f32, {PREDICT_BATCHES} batches of "
              f"{CPU_PREDICT_B} x {TRAIN_T}: card vs CPU argmax "
              f"{'equal' if agree else 'DIFFER'} at the "
              f"{int((~close).sum())} of {close.size} positions whose "
              f"top-2 gap is >= {TOP2_GAP:g}; dtype {preds['cuda'].dtype}")
        gate(agree and preds["cuda"].dtype == np.int32
             and preds["cuda"].shape == (PREDICT_BATCHES * CPU_PREDICT_B,
                                         TRAIN_T),
             "predict card vs CPU")
        del gpt32, top2, ckpt_params

        # (5) eval timings on the fitted state, handed over as it is (no
        # file read), bf16.
        def timed_eval(run, batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(batches)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        module = GPT(cfg, **HEADLINE)
        dev = module.device

        def val(b):
            run_eval(module, eval_data(cfg, TRAIN_B, b),
                     FitConfig(precision="bf16"), [], dev, params=fitted)

        def pred(b):
            run_predict(module, eval_data(cfg, TRAIN_B, b),
                        FitConfig(precision="bf16"), dev, params=fitted)

        tokens_batch = TRAIN_B * TRAIN_T
        for name, run, nb in (("validate", val, EVAL_BATCHES),
                              ("predict", pred, PREDICT_BATCHES)):
            run(1)
            one_ms = timed_eval(run, 1)
            many_ms = timed_eval(run, 1 + nb)
            ms_b = (many_ms - one_ms) / nb
            timed[name + "_ms_per_batch"] = ms_b
            timed[name + "_tokens_per_s"] = tokens_batch / (ms_b / 1e3)
            print(f"phase 10: {name} bf16 at {TRAIN_B} x {TRAIN_T}: "
                  f"{ms_b:.2f} ms a batch ((wall of {1 + nb} batches "
                  f"{many_ms:.1f} ms - of 1 batch {one_ms:.1f} ms) / {nb}), "
                  f"{tokens_batch / (ms_b / 1e3):.0f} tokens/s; {card}")
        print(f"phase 10: checkpoint of the headline state "
              f"({timing['file_bytes'] / 1e9:.3f} GB file): host copy "
              f"(.cpu() of every leaf) {timing['host_copy_ms']:.1f} ms; "
              f"stream encode (each leaf from the card into the stream) "
              f"{timing['encode_ms']:.1f} ms ({timing['encode_gb_s']:.2f} "
              f"GB/s); write (crc + file) {timing['write_ms']:.1f} ms "
              f"({timing['write_gb_s']:.2f} GB/s); read + restore onto the "
              f"card {timing['read_restore_ms']:.1f} ms "
              f"({timing['read_gb_s']:.2f} GB/s); {card}")
        result["eval"] = {"f32_rel": f32_rel, "bf16_rel": bf_rel,
                          "predict_agree": agree, **timed}
    check(not failed, "phase 10: " + "; ".join(failed))
    return result


# -- phase 11: LoRA fine-tuning, optimizer-state precision, callbacks -------

LORA_RANK = 16               # the server cell's tenant rank
LORA_KW = {"lora_rank": LORA_RANK, "lr": 1e-3, "warmup_steps": 0}
# 6 strides of MEGASTEP_K: the eager one, the capture, 4 replays (timed).
LORA_STEPS = 48
OPT_DTYPES = (None, "bfloat16", "int8")
# The int8 and bf16 arms' final losses against the default policy's
# (JAX tests/test_opt_state.py::test_int8_fit_loss_parity_vs_f32).
OPT_LOSS_REL = 1e-2
CB_EPOCHS, CB_BATCHES, CB_LOG_EVERY, CB_DECAY = 2, 16, 4, 0.9


def lora_init(torch, cfg):
    """GPT-2-small's base from seed 0 with fresh rank-``cfg.lora_rank``
    adapters (B = 0) from seed 1, f32 on the CPU."""
    from ray_lightning_tpu_torch.models.gpt import (
        GPT, add_lora_adapters,
    )

    base_cfg = dataclasses.replace(cfg, lora_rank=0)
    base = GPT(base_cfg, device="cpu").init_params(
        torch.Generator().manual_seed(SEED))
    return add_lora_adapters(base, cfg, torch.Generator().manual_seed(1))


def fit_memory_start(torch):
    """Before a fit whose peak is read: the allocator's peaks reset, and
    the bytes already allocated and reserved (what earlier phases keep
    resident), which :func:`fit_memory_peak` subtracts."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def fit_memory_peak(torch, resident):
    """The fit's own peak allocated and reserved bytes: the peaks since
    :func:`fit_memory_start` above what was resident then."""
    return (torch.cuda.max_memory_allocated() - resident[0],
            torch.cuda.max_memory_reserved() - resident[1])


def cpu_step_launches(torch, cfg, gpt_kw):
    """Each training kernel's calls in one step on the CPU (batch 1,
    f32), counted at its plain version, which the wrapper runs there: the
    launches the same step makes on the card."""
    from ray_lightning_tpu_torch.models.gpt import GPT
    from ray_lightning_tpu_torch.ops import cross_entropy as ce
    from ray_lightning_tpu_torch.ops import flash_attention as fa
    from ray_lightning_tpu_torch.ops import layer_norm as ln
    from ray_lightning_tpu_torch.parallel.step_fns import loss_and_grads

    plain = {"ln_fwd": (ln, "ln_fwd_plain"), "ln_bwd": (ln, "ln_bwd_plain"),
             "flash_fwd": (fa, "flash_fwd_plain"),
             "flash_bwd": (fa, "flash_bwd_plain"),
             "ce_fwd": (ce, "ce_fwd_plain"),
             "ce_bwd_dx": (ce, "ce_bwd_dx_plain"),
             "ce_bwd_dw": (ce, "ce_bwd_dw_plain")}
    calls = dict.fromkeys(plain, 0)
    saved = {k: getattr(m, a) for k, (m, a) in plain.items()}

    def counted(name):
        def run(*args):
            calls[name] += 1
            return saved[name](*args)
        return run

    for k, (m, a) in plain.items():
        setattr(m, a, counted(k))
    try:
        module = GPT(cfg, device="cpu", **gpt_kw)
        tokens = torch.randint(0, cfg.vocab_size, (1, cfg.seq_len + 1),
                               generator=torch.Generator().manual_seed(SEED))
        loss_and_grads(module, lora_init(torch, cfg) if cfg.lora_rank
                       else module.init_params(), {"tokens": tokens}, None)
    finally:
        for k, (m, a) in plain.items():
            setattr(m, a, saved[k])
    return calls


def lora_check(torch, card, n_layer=12, steps=LORA_STEPS, eager=True):
    """Phase 11 (a): a LoRA fine-tune of GPT-2-small (depth ``n_layer``) at
    16 x 1024, bf16, the headline kernels and remat, ``megastep="auto"``:
    the base bitwise the starting tree, every adapter B moved, one
    capture, each kernel's launches a step (the eager stride's and the
    capture's counted calls ÷ 16, and the captured graph's nodes ÷ 8)
    equal to the CPU's count for the same step with CE dW at 0; with
    ``eager``, the captured stride-end losses within BF16_LOSS_TOL of an
    eager fit's.  Returns the readings, the trainer and ``ok``."""
    import numpy as np

    from ray_lightning_tpu_torch.core.callbacks import Callback
    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.models.optim import moment_bytes

    cfg = dataclasses.replace(GPTConfig.gpt2_small(), n_layer=n_layer,
                              **LORA_KW)
    init = lora_init(torch, cfg)
    cpu = cpu_step_launches(torch, cfg, HEADLINE)
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    clock = hook_clock(torch, Callback)
    resident = fit_memory_start(torch)
    with kept_graphs(torch) as graphs:
        tr = megastep_fit(torch, cfg, HEADLINE, steps, "auto", init=init,
                          callbacks=[clock])
        torch.cuda.synchronize()
    peak = fit_memory_peak(torch, resident)
    counted = {k: c.launches for k, c in counters.items()}
    graph = graph_kernels(graphs[0]) if len(graphs) == 1 else None
    k = MEGASTEP_K
    per_step = {name: n / (2 * k) for name, n in counted.items()}
    per_node = ({name: n / k for name, n in graph.items()} if graph
                else None)
    params = by_path(tr.state.params)
    start = by_path(init)
    frozen_moved = [p for p in start if "lora_" not in p
                    and not torch.equal(params[p].cpu(), start[p])]
    unmoved_b = [p for p in start if p.endswith(("lora_qkv_b']",
                                                 "lora_proj_b']"))
                 and float(params[p].abs().max()) == 0.0]
    windows = stride_ms(clock, k)
    ms = float(np.median(windows[1:])) / k
    out = {"cpu_launches_per_step": cpu, "launches_per_step": per_step,
           "graph_nodes_per_step": per_node,
           "captures": tr.callback_metrics["recompiles"],
           "frozen_moved": frozen_moved, "adapters_b_unmoved": unmoved_b,
           "stride_ms": windows, "ms_per_step": ms,
           "peak_alloc_gib": peak[0] / 2**30,
           "peak_reserved_gib": peak[1] / 2**30,
           "opt_state_bytes": moment_bytes(tr.state.opt_state)}
    ok = (not frozen_moved and not unmoved_b and per_step == cpu
          and per_node == cpu and cpu["ce_bwd_dw"] == 0
          and out["captures"] == 1)
    if eager:
        ref = hook_clock(torch, Callback)
        megastep_fit(torch, cfg, HEADLINE, steps, "off", init=init,
                     callbacks=[ref])
        want = stride_losses(ref)
        got = stride_losses(clock)
        rel = max(abs(got[i] - want[i]) / abs(want[i]) for i in got)
        out["loss_rel_vs_eager"] = rel
        ok = ok and bool(np.isfinite(rel)) and rel <= BF16_LOSS_TOL
    out["ok"] = bool(ok)
    return out, tr, cfg


def lora_clip_check(torch, card):
    """The LoRA optimizer on the card (depth 2, lr 1e-2) with forged
    gradients, the base's 1e6 and the adapters' 1e-4: the base's updates
    are zero and the adapters' a full first step (~lr, > 1e-3): the clip
    saw the adapters' norm alone.  Over the full model's it would scale
    their gradients to ~1e-14, under Adam's eps, and the step to ~1e-8."""
    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
    from ray_lightning_tpu_torch.models.optim import tree_map

    cfg = dataclasses.replace(GPTConfig.gpt2_small(), n_layer=2,
                              **{**LORA_KW, "lr": 1e-2})
    module = GPT(cfg, device="cuda")
    params = tree_map(lambda t: t.cuda(), lora_init(torch, cfg))
    tx = module.configure_optimizers()
    grads = {"blocks": {k: torch.full_like(
        t, 1e-4 if k.startswith("lora_") else 1e6)
        for k, t in params["blocks"].items()},
        **{k: torch.full_like(t, 1e6) for k, t in params.items()
           if k != "blocks"}}
    updates, _ = tx.update(grads, tx.init(params), params)
    base = max(float(u.abs().max()) for k, u in by_path(updates).items()
               if "lora_" not in k)
    adapter = min(float(updates["blocks"][k].abs().max())
                  for k in ("lora_qkv_a", "lora_proj_a"))
    ok = base == 0.0 and adapter > 1e-3
    print(f"phase 11a clip: forged grads (base 1e6, adapters 1e-4) on the "
          f"card: base updates max {base:.3e} (must be 0), adapter A "
          f"updates max {adapter:.3e} (> 1e-3: the clip saw the adapters' "
          f"norm alone); {'ok' if ok else 'FAILED'}; {card}")
    return {"base_update_max": base, "adapter_update_max": adapter,
            "ok": ok}


def lora_parity(torch, card):
    """Phase 11 (a), f32 at depth 2 (full width, batch 2, 12 steps, the
    LoRA config): captured (megastep 4) against eager on the card by
    phase 9's rules, in the headline configuration (params within 5x the
    eager-vs-eager spread or 1e-5) and with the plain attention (1e-5);
    and the card against the CPU by phase 8's (per-step losses within
    1e-5 relative, each leaf's update within 1e-2 relative norm)."""
    import numpy as np

    from ray_lightning_tpu_torch.core.callbacks import Callback
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import (
        GPT, GPTConfig, SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.models.optim import tree_leaves
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    cfg = dataclasses.replace(GPTConfig.gpt2_small(), n_layer=2, **LORA_KW)
    init = lora_init(torch, cfg)

    def fit(kw, device, mode):
        clock = []

        class Losses(Callback):
            def on_train_batch_end(self, trainer, module, logs, batch_idx):
                clock.append((batch_idx, logs["train_loss"]))

        module = GPT(cfg, device=device, **kw)
        module.initial_params = init
        tr = Trainer(LocalStrategy(device=device, megastep=mode),
                     max_steps=PARITY_STEPS, limit_val_batches=0,
                     precision="f32", seed=SEED, callbacks=[Losses()],
                     enable_checkpointing=False)
        tr.fit(module, SyntheticLMDataModule(cfg, batch_size=2,
                                             num_batches=PARITY_STEPS,
                                             seed=SEED + 2))
        return tr, {i: float(x) for i, x in clock}

    def diff(a, b):
        return max(float((x.cpu() - y.cpu()).abs().max()) for x, y in zip(
            tree_leaves(a.state.params), tree_leaves(b.state.params)))

    out, ok = {}, True
    for label, kw, repeat in (("headline", HEADLINE, True),
                              ("xla_attention", {**HEADLINE,
                                                 "attn_impl": "xla"}, False)):
        eager, e_loss = fit(kw, "cuda", "off")
        cap, c_loss = fit(kw, "cuda", PARITY_K)
        d = diff(cap, eager)
        floor = diff(fit(kw, "cuda", "off")[0], eager) if repeat else None
        tol = max(PARITY_FLOOR_X * floor, 1e-5) if repeat else 1e-5
        loss_rel = max(abs(c_loss[i] - e_loss[i]) / abs(e_loss[i])
                       for i in c_loss)
        good = (cap.callback_metrics["recompiles"] == 1 and d <= tol
                and loss_rel <= 1e-5)
        print(f"phase 11a parity {label}: LoRA depth 2, f32, megastep "
              f"{PARITY_K} vs off over {PARITY_STEPS} steps: stride-end "
              f"losses worst rel {loss_rel:.3e} (tol 1e-5); params max abs "
              f"diff {d:.3e} (tol {tol:.3e}"
              + (f" = max({PARITY_FLOOR_X} x eager vs eager {floor:.3e}, "
                 f"1e-5)" if repeat else "") + f"); "
              f"{'ok' if good else 'FAILED'}; {card}")
        out[label] = {"loss_rel": loss_rel, "param_diff": d,
                      "eager_floor": floor, "param_tol": tol, "ok": good}
        ok = ok and good
        if not repeat:
            continue
        cpu, cpu_loss = fit(kw, "cpu", "off")
        loss_rel = max(abs(e_loss[i] - cpu_loss[i]) / abs(cpu_loss[i])
                       for i in cpu_loss)
        upd_rel = 0.0
        for p_card, p_cpu, p0 in zip(tree_leaves(eager.state.params),
                                     tree_leaves(cpu.state.params),
                                     tree_leaves(init)):
            d_cpu = p_cpu - p0
            if float(d_cpu.norm()) == 0.0:
                continue  # a frozen leaf (held bitwise in phase 11a)
            upd_rel = max(upd_rel, float((p_card.cpu() - p0 - d_cpu).norm()
                                         / d_cpu.norm()))
        good = loss_rel <= 1e-5 and upd_rel <= 1e-2
        print(f"phase 11a card vs CPU: LoRA depth 2, f32, eager, "
              f"{PARITY_STEPS} steps: per-step losses worst rel "
              f"{loss_rel:.3e} (tol 1e-5); adapter updates, largest "
              f"relative norm of the difference {upd_rel:.3e} (tol 1e-2, "
              f"phase 8's rule); {'ok' if good else 'FAILED'}; {card}")
        out["card_vs_cpu"] = {"loss_rel": loss_rel, "update_rel": upd_rel,
                              "ok": good}
        ok = ok and good
    out["ok"] = bool(ok)
    return out


def serve_tuned(torch, np, card, tuned, cfg):
    """Phase 11 (b): the tuned tree's adapter (``extract_lora``) served in
    f32 beside two of phase 3's synthetic tenants over phase 3's request
    set: every stream on it equals ``generate()`` on ``merge_lora``
    (tuned), divergence only at a top-2 logit gap < 1e-4; the BGMV
    launches."""
    from ray_lightning_tpu_torch.models import generate as gen_mod
    from ray_lightning_tpu_torch.models.gpt import (
        GPT, extract_lora, merge_lora, synthetic_lora_adapter,
    )
    from ray_lightning_tpu_torch.serve.engine import ServeConfig, ServeEngine

    base_cfg = dataclasses.replace(cfg, lora_rank=0)
    module = GPT(base_cfg, precision="f32", device="cuda")
    adapter, base = extract_lora(tuned, cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tenants = {"tuned": adapter}
    merged = {None: base, "tuned": merge_lora(tuned, cfg)}
    for i in range(2):
        tenants[f"tenant{i}"], merged[f"tenant{i}"] = synthetic_lora_adapter(
            base, dataclasses.replace(cfg, lora_rank=LORA_RANK), gen,
            scale=0.3)
    serve_cfg = ServeConfig(num_slots=DECODE_W, block_size=16,
                            max_adapters=len(tenants),
                            adapter_rank=LORA_RANK)
    reqs = make_requests(np, tenants)
    engine, tokens, wall, launches, peak = serve(
        torch, ServeEngine, module, base, serve_cfg, tenants, reqs)
    res = report("phase 11b", engine, tokens, wall, launches, peak,
                 base_cfg, card)
    exact, tuned_reqs = 0, 0
    for (prompt, n, name), got in zip(reqs, tokens):
        tuned_reqs += name == "tuned"
        ref = gen_mod.generate(module, merged[name], [prompt], n,
                               device="cuda")[0, len(prompt):].tolist()
        if got == ref:
            exact += 1
            continue
        i = next(j for j, (x, y) in enumerate(zip(got, ref)) if x != y)
        gap = top2_gap(torch, gen_mod, module, merged[name],
                       prompt + ref[:i])
        print(f"phase 11b: {name or 'base'} stream diverges from generate() "
              f"at token {i}; reference top-2 logit gap {gap:.3e}")
        check(gap < 1e-4, f"divergence at a top-2 gap {gap} >= 1e-4")
    check(tuned_reqs > 0, "requests on the tuned adapter were served")
    delta = max(float((merged["tuned"]["blocks"][k] - base["blocks"][k])
                      .abs().max()) for k in ("qkv_w", "proj_w"))
    print(f"phase 11b: {exact}/{len(reqs)} streams ({tuned_reqs} on the "
          f"tuned adapter, whose merged delta reaches {delta:.3e}) equal "
          f"generate() on the merged weights token for token; the rest "
          f"diverge only at a near tie; {card}")
    res.update(exact_streams=exact, tuned_requests=tuned_reqs,
               tuned_delta_max=delta)
    return res


def state_leaves(state):
    from ray_lightning_tpu_torch.models.optim import tree_leaves

    return tree_leaves((state.params, state.opt_state))


def opt_fit(torch, cfg, steps, root=None, resume=None, callbacks=(),
            checkpoint=False):
    """The headline arm under ``cfg``'s ``opt_state_dtype``, captured
    (``megastep="auto"``), bf16."""
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import GPT, SyntheticLMDataModule

    tr = Trainer(max_steps=steps, limit_val_batches=0, precision="bf16",
                 seed=SEED, callbacks=list(callbacks), megastep="auto",
                 enable_checkpointing=checkpoint, resume_from_checkpoint=resume,
                 default_root_dir=str(root) if root else "rlt_logs")
    tr.fit(GPT(cfg, **HEADLINE), SyntheticLMDataModule(
        cfg, batch_size=TRAIN_B, num_batches=steps, seed=SEED))
    return tr


def opt_state_arms(torch, card, n_layer=12, steps=LORA_STEPS):
    """Phase 11 (c): the headline arm, captured, under each of OPT_DTYPES:
    the moments' bytes on the card equal ``opt_state_bytes`` exactly, the
    bf16 and int8 final losses within OPT_LOSS_REL of the default
    policy's; ms/step, peak memory.  Returns the readings, the final
    states and ``ok``."""
    import numpy as np

    from ray_lightning_tpu_torch.core.callbacks import Callback
    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.models.optim import (
        moment_bytes, opt_state_bytes,
    )

    out, states, ok = {}, {}, True
    for dtype in OPT_DTYPES:
        cfg = dataclasses.replace(GPTConfig.gpt2_small(), n_layer=n_layer,
                                  opt_state_dtype=dtype)
        clock = hook_clock(torch, Callback)
        resident = fit_memory_start(torch)
        tr = opt_fit(torch, cfg, steps, callbacks=[clock])
        torch.cuda.synchronize()
        peak = fit_memory_peak(torch, resident)
        windows = stride_ms(clock, MEGASTEP_K)
        got = moment_bytes(tr.state.opt_state)
        want = opt_state_bytes(tr.state.params, dtype)
        label = dtype or "default"
        out[label] = {
            "ms_per_step": float(np.median(windows[1:])) / MEGASTEP_K,
            "stride_ms": windows, "moment_bytes": got,
            "opt_state_bytes": want,
            "final_loss": float(clock.losses[-1]),
            "peak_alloc_gib": peak[0] / 2**30,
            "peak_reserved_gib": peak[1] / 2**30,
            "captures": tr.callback_metrics["recompiles"]}
        ok = ok and got == want and out[label]["captures"] == 1
        states[label] = tr
        del tr
    ref = out["default"]["final_loss"]
    for label in ("bfloat16", "int8"):
        rel = abs(out[label]["final_loss"] - ref) / abs(ref)
        out[label]["loss_rel_vs_default"] = rel
        ok = ok and bool(np.isfinite(rel)) and rel <= OPT_LOSS_REL
    out["ok"] = bool(ok)
    return out, states


def int8_resume_check(torch, card, states, n_layer=12, steps=LORA_STEPS):
    """Phase 11 (c): the int8 arm's state written (``save_checkpoint``) and
    resumed by a fresh int8 fit whose steps are done: bitwise every leaf
    (payloads and scales included); the default arm's state resumed by an
    int8 fit: each moment converted, bitwise ``quantize_moment`` of the
    file's (the cross-policy reconcile)."""
    import os
    import tempfile
    import warnings

    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.ops.optim_quant import (
        BlockQuantized, quantize_moment,
    )

    out = {}
    cfg = dataclasses.replace(GPTConfig.gpt2_small(), n_layer=n_layer,
                              opt_state_dtype="int8")
    with tempfile.TemporaryDirectory() as tmp:
        path8, path0 = (os.path.join(tmp, n) for n in ("int8.ckpt",
                                                       "default.ckpt"))
        states["int8"].save_checkpoint(path8)
        states["default"].save_checkpoint(path0)
        back = opt_fit(torch, cfg, steps, root=tmp, resume=path8)
        a, b = state_leaves(states["int8"].state), state_leaves(back.state)
        same = len(a) == len(b) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
        out["int8_resume_bitwise"] = same
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                cross = opt_fit(torch, cfg, steps, root=tmp, resume=path0)
            warned = any("opt_state_dtype change" in str(w.message)
                         for w in caught)
            src = states["default"].state.opt_state[1]
            dst = cross.state.opt_state[1]
            match = warned
            for name, sqrt in (("mu", False), ("nu", True)):
                for p, leaf in by_path(src[name]).items():
                    got = by_path_q(dst[name])[p]
                    if isinstance(got, BlockQuantized):
                        want = quantize_moment(leaf.float(), sqrt_domain=sqrt)
                        match = match and torch.equal(got.q, want.q) and \
                            torch.equal(got.scale, want.scale)
                    else:
                        match = match and torch.equal(got, leaf.to(got.dtype))
            out["cross_policy_resume"] = match
        except Exception as e:  # noqa: BLE001 - a failed resume is the reading
            print(f"phase 11c: cross-policy resume raised {type(e).__name__}:"
                  f" {e}")
            out["cross_policy_resume"] = False
    print(f"phase 11c: int8 checkpoint written and resumed: every leaf "
          f"bitwise {out['int8_resume_bitwise']}; default-policy checkpoint "
          f"resumed by an int8 fit (warned, each moment requantized "
          f"bitwise): {out['cross_policy_resume']}; {card}")
    out["ok"] = out["int8_resume_bitwise"] and out["cross_policy_resume"]
    return out


def int8_codec_check(torch, card):
    """Phase 11 (c): the int8 policy's own store on the card keeps the
    second moment in the sqrt domain.  A moment of 2^20 elements whose
    values span eight orders of magnitude within each block goes through
    one AdamW step with zero gradients (nu ← b2·nu, no update): the
    stored nu, decoded, lies within half a quantization step of b2·nu in
    the sqrt domain (the step of the JAX codec applied to b2·nu), so an
    element 1e-8 of its block's max is kept; a linear code rounds every
    element under 1/254 of its block's max to 0."""
    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.models.optim import gpt_adamw
    from ray_lightning_tpu_torch.ops.optim_quant import (
        dequantize_block_scaled, dequantize_moment, quantize_moment,
    )

    n = 1 << 20
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    nu = 10.0 ** (-8 * torch.rand(n, generator=gen, device="cuda"))
    tx = gpt_adamw(dataclasses.replace(GPTConfig.gpt2_small(),
                                       opt_state_dtype="int8"))
    params = {"x": torch.zeros(n, device="cuda")}
    state = tx.init(params)
    state["nu"]["x"] = quantize_moment(nu, sqrt_domain=True)
    _, new = tx.update({"x": torch.zeros(n, device="cuda")}, state, params)
    ref = quantize_moment(0.95 * dequantize_moment(state["nu"]["x"]),
                          sqrt_domain=True)
    want = dequantize_block_scaled(ref.q, ref.scale, ref.block_size)
    got = torch.sqrt(dequantize_moment(new["nu"]["x"]))
    steps = float(((got - want).abs() / ref.scale.repeat_interleave(
        ref.block_size)).max())
    ok = new["nu"]["x"].sqrt_domain and steps <= 0.5 + 1e-3
    print(f"phase 11c int8 codec: nu of 2^20 elements over 8 orders of "
          f"magnitude through the policy's store: within {steps:.4f} "
          f"quantization steps of the JAX codec in the sqrt domain (tol "
          f"0.5); {'ok' if ok else 'FAILED'}; {card}")
    return {"sqrt_domain_steps": steps, "ok": bool(ok)}


def by_path_q(tree, path=""):
    """:func:`by_path` with quantized moments as leaves."""
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items()
                for k2, v in by_path_q(sub, f"{path}['{k}']").items()}
    return {path: tree}


def int8_step_check(torch, card):
    """Phase 11 (c), f32 at depth 2: the int8 state after a short card fit,
    copied to the CPU, takes one optimizer step on each side with the
    same gradients: every dequantized moment within one quantization step
    (its block's scale, in the stored domain) of the CPU's, params within
    1e-6 of their scale; then the int8 fit captured against eager on the
    card by phase 9's rules (plain attention: params 1e-5)."""
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import (
        GPT, GPTConfig, SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.models.optim import (
        apply_updates, tree_leaves, tree_map,
    )
    from ray_lightning_tpu_torch.ops.optim_quant import (
        BlockQuantized, dequantize_block_scaled,
    )
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    cfg = dataclasses.replace(GPTConfig.gpt2_small(), n_layer=2,
                              opt_state_dtype="int8", warmup_steps=2)
    init = GPT(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(SEED + 3))

    def fit(mode, kw):
        module = GPT(cfg, **kw)
        module.initial_params = init
        tr = Trainer(LocalStrategy(megastep=mode), max_steps=PARITY_STEPS,
                     limit_val_batches=0, precision="f32", seed=SEED,
                     enable_checkpointing=False)
        tr.fit(module, SyntheticLMDataModule(cfg, batch_size=2,
                                             num_batches=PARITY_STEPS,
                                             seed=SEED + 2))
        return tr

    xla = {**HEADLINE, "attn_impl": "xla"}
    eager, cap = fit("off", xla), fit(PARITY_K, xla)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(cap.state.params), tree_leaves(eager.state.params)))
    tx = GPT(cfg).configure_optimizers()
    gen = torch.Generator().manual_seed(SEED + 4)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen) * 1e-3,
                     init)
    sides = {}
    for device in ("cuda", "cpu"):
        st = eager.state
        params = tree_map(lambda t: t.to(device), st.params)
        opt = tree_map(lambda t: t.to(device), st.opt_state)
        upd, new = tx.update(tree_map(lambda t: t.to(device), grads), opt,
                             params)
        sides[device] = (apply_updates(params, upd), new)
    worst_steps, worst_param = 0.0, 0.0
    for name in ("mu", "nu"):
        card_m = by_path_q(sides["cuda"][1][1][name])
        cpu_m = by_path_q(sides["cpu"][1][1][name])
        for p, c in cpu_m.items():
            g = card_m[p]
            if isinstance(c, BlockQuantized):
                a = dequantize_block_scaled(g.q.cpu(), g.scale.cpu(),
                                            g.block_size)
                b = dequantize_block_scaled(c.q, c.scale, c.block_size)
                sa = g.scale.cpu().repeat_interleave(g.block_size)
                sb = c.scale.repeat_interleave(c.block_size)
                step = (torch.maximum(sa, sb) + 127 * (sa - sb).abs()) * (
                    1 + 1e-5)
            else:
                a, b = g.cpu(), c
                step = b.abs().max() * 1e-5 + 1e-30
            worst_steps = max(worst_steps, float(((a - b).abs() / step)
                                                 .max()))
    for a, b in zip(tree_leaves(sides["cuda"][0]),
                    tree_leaves(sides["cpu"][0])):
        worst_param = max(worst_param, float((a.cpu() - b).abs().max()
                                             / b.abs().max()))
    ok = (diff <= 1e-5 and worst_steps <= 1.0 and worst_param <= 1e-6
          and cap.callback_metrics["recompiles"] == 1)
    print(f"phase 11c int8 f32 depth 2: captured vs eager (plain attention) "
          f"params max abs diff {diff:.3e} (tol 1e-5); one step card vs CPU "
          f"from the same state and gradients: moments within "
          f"{worst_steps:.3f} quantization steps (tol 1), params within "
          f"{worst_param:.3e} of their scale (tol 1e-6); "
          f"{'ok' if ok else 'FAILED'}; {card}")
    return {"captured_vs_eager": diff, "moment_steps": worst_steps,
            "param_rel": worst_param, "ok": ok}


def callbacks_check(torch, card, megastep, n_layer=2):
    """Phase 11 (d): a fit at full width and depth ``n_layer`` (bf16, 16 x
    1024, CB_EPOCHS epochs of CB_BATCHES) with CSVLogger,
    DeviceStatsCallback, ProfilerCallback (steps 8 to 24: the capture
    stride and a replay), SWA and EMA, under ``megastep``: CSV rows on the
    ``log_every_n_steps`` grid, DeviceStatsCallback's peak equal to
    ``torch.cuda.max_memory_allocated`` at each epoch's end, the Chrome
    trace names ``tc_flash_fwd_kernel``, SWA's mean bitwise the running
    mean of the same fit's epoch-end snapshots, EMA within rtol 1e-5 /
    atol 1e-6 of the stride-boundary snapshots blended with
    ``decay**K``, neither shadow sharing memory with the live params."""
    import json as json_mod
    import os
    import tempfile

    from ray_lightning_tpu_torch import core
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import (
        GPT, GPTConfig, SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.models.optim import tree_leaves, tree_map
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    k = megastep
    cfg = dataclasses.replace(GPTConfig.gpt2_small(), n_layer=n_layer)
    swa = core.StochasticWeightAveraging(0)
    ema = core.ExponentialMovingAverage(CB_DECAY, swap_at_end=False)
    dev = core.DeviceStatsCallback(log=False)

    class Probe(core.Callback):
        """Right after DeviceStatsCallback: the params' snapshots, the
        peak it must have read, and whether a shadow shares memory with
        the live params."""

        def __init__(self):
            self.epoch_params, self.stride_params = [], {}
            self.peaks, self.shared = [], []

        def _alias(self, trainer):
            live = {t.data_ptr() for t in tree_leaves(trainer.state.params)}
            for shadow in (swa._mean, ema.ema_params):
                if shadow is not None and not live.isdisjoint(
                        t.data_ptr() for t in tree_leaves(shadow)):
                    self.shared.append(trainer.global_step)

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            if trainer.global_step % k == 0:
                self.stride_params[trainer.global_step] = tree_map(
                    torch.clone, trainer.state.params)
            self._alias(trainer)

        def on_train_epoch_end(self, trainer, module):
            self.epoch_params.append(tree_map(torch.clone,
                                              trainer.state.params))
            self.peaks.append(torch.cuda.max_memory_allocated())
            self._alias(trainer)

    probe = Probe()
    with tempfile.TemporaryDirectory() as tmp:
        csv_cb = core.CSVLogger()
        prof = core.ProfilerCallback(start_step=8, num_steps=16)
        tr = Trainer(LocalStrategy(megastep=k if k > 1 else "off"),
                     max_epochs=CB_EPOCHS, limit_val_batches=0,
                     log_every_n_steps=CB_LOG_EVERY, precision="bf16",
                     seed=SEED, enable_checkpointing=False,
                     default_root_dir=tmp,
                     callbacks=[csv_cb, dev, probe, prof, swa, ema])
        tr.fit(GPT(cfg, **HEADLINE), SyntheticLMDataModule(
            cfg, batch_size=TRAIN_B, num_batches=CB_BATCHES, seed=SEED))
        # A row at each log boundary a step or stride crosses, then one at
        # the validation epoch's end (no batches: limit_val_batches=0) and
        # one at the epoch's end.
        rows = [(r["epoch"], r["step"]) for r in csv_cb.rows]
        every = max(k, CB_LOG_EVERY)
        grid = [(e, e * CB_BATCHES + j) for e in range(CB_EPOCHS)
                for j in [*range(every, CB_BATCHES + 1, every),
                          CB_BATCHES, CB_BATCHES]]
        csv_ok = rows == grid
        names = set()
        for path in prof.trace_paths:
            with open(path) as f:
                names |= {str(e.get("name", "")) for e in
                          json_mod.load(f).get("traceEvents", [])}
        flash_seen = any("tc_flash_fwd_kernel" in n for n in names)
        trace_ok = (len(prof.trace_paths) == 1 and flash_seen
                    and os.path.dirname(prof.trace_paths[0]).endswith(
                        os.path.join("profiler", "rank0")))
    peak_ok = dev.peak_memories == probe.peaks and len(dev.peak_memories) \
        == CB_EPOCHS
    mean = None
    for n, snap in enumerate(probe.epoch_params, start=1):
        mean = (tree_map(torch.clone, snap) if mean is None else tree_map(
            lambda m, p, n=float(n): m + (p - m) / n, mean, snap))
    swa_ok = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(mean), tree_leaves(tr.state.params)))
    steps = sorted(probe.stride_params)
    want = probe.stride_params[steps[0]]
    d = CB_DECAY ** k
    for gs in steps[1:]:
        want = tree_map(lambda e, p: e * d + p * (1.0 - d), want,
                        probe.stride_params[gs])
    ema_err = max(float(((a - b).abs() / (1e-6 + 1e-5 * b.abs())).max())
                  for a, b in zip(tree_leaves(ema.ema_params),
                                  tree_leaves(want)))
    ema_ok = ema_err <= 1.0
    ok = (csv_ok and peak_ok and trace_ok and swa_ok and ema_ok
          and not probe.shared)
    print(f"phase 11d callbacks, megastep {k}, depth {n_layer}: CSV rows "
          f"{len(rows)} on the grid {csv_ok}; DeviceStats peaks "
          f"{[round(p / 2**30, 3) for p in dev.peak_memories]} GiB = "
          f"max_memory_allocated {peak_ok}; trace {len(prof.trace_paths)} "
          f"file(s), tc_flash_fwd_kernel named {flash_seen}; SWA bitwise "
          f"{swa_ok}; EMA worst |err| / (1e-6 + 1e-5|ref|) {ema_err:.3f} "
          f"(tol 1); shadows alias the params {probe.shared or 'never'}; "
          f"{'ok' if ok else 'FAILED'}; {card}")
    return {"csv_rows": len(rows), "csv_ok": csv_ok, "peak_ok": peak_ok,
            "trace_ok": trace_ok, "swa_bitwise": swa_ok,
            "ema_err": ema_err, "ema_ok": ema_ok,
            "aliased": probe.shared, "ok": ok}


def phase_lora_and_opt_state(torch, np, card):
    """Phase 11: (a) the LoRA fine-tune, its clip and f32 parity; (b) its
    adapter served; (c) the optimizer-state policies; (d) the callbacks."""
    import gc

    from ray_lightning_tpu_torch.telemetry.step_stats import (
        model_flops_per_token,
    )

    result = {}
    print(f"phase 11a: LoRA fine-tune of GPT-2-small (rank {LORA_RANK}, "
          f"alpha 16, lr 1e-3, warmup 0), base random from seed {SEED}, "
          f"batch {TRAIN_B} x {TRAIN_T}, bf16, remat 'dots+flash', "
          f"megastep 'auto' ({MEGASTEP_K}), {LORA_STEPS} steps")
    a, tr, cfg = lora_check(torch, card)
    flops = model_flops_per_token(cfg, "full")
    tokens_s = TRAIN_B * TRAIN_T / (a["ms_per_step"] / 1e3)
    a.update(tokens_per_s=tokens_s, mfu=tokens_s * flops / 989.4e12)
    print(f"phase 11a: launches a step (eager stride + capture counters "
          f"/ 16) {a['launches_per_step']}; graph nodes / 8 "
          f"{a['graph_nodes_per_step']}; the CPU's for the same step "
          f"{a['cpu_launches_per_step']}; captures {a['captures']:.0f}; "
          f"frozen leaves moved {a['frozen_moved'] or 'none'}; adapter B "
          f"unmoved {a['adapters_b_unmoved'] or 'none'}; captured vs eager "
          f"bf16 stride-end losses worst rel {a['loss_rel_vs_eager']:.3e} "
          f"(tol {BF16_LOSS_TOL})")
    print(f"phase 11a: {a['ms_per_step']:.2f} ms/step (median of strides "
          f"3-6 / {MEGASTEP_K}, CUDA events; windows "
          + ", ".join(f"{w:.1f}" for w in a["stride_ms"])
          + f" ms), {tokens_s:.0f} tokens/s, MFU {100 * a['mfu']:.2f}% "
          f"({flops / 1e6:.1f} MFLOP/token, the full fit's yardstick, "
          f"against 989.4 TF/s), peak allocated "
          f"{a['peak_alloc_gib']:.3f} GiB, reserved "
          f"{a['peak_reserved_gib']:.3f} GiB (above what earlier phases "
          f"keep resident), optimizer moments "
          f"{a['opt_state_bytes']} bytes; {card}")
    check(a["ok"], "phase 11a: the LoRA fit's gates")
    result["a_lora"] = a
    result["a_clip"] = lora_clip_check(torch, card)
    check(result["a_clip"]["ok"], "phase 11a: the clip sees the adapters")
    tuned = tr.state.params
    del tr
    gc.collect()
    result["b_serve"] = serve_tuned(torch, np, card, tuned, cfg)
    del tuned
    gc.collect()
    torch.cuda.empty_cache()
    result["a_parity"] = lora_parity(torch, card)
    check(result["a_parity"]["ok"], "phase 11a: the f32 LoRA parity")

    print(f"phase 11c: the headline arm under opt_state_dtype in "
          f"{OPT_DTYPES}, captured, {LORA_STEPS} steps")
    c, states = opt_state_arms(torch, card)
    for label in ("default", "bfloat16", "int8"):
        r = c[label]
        print(f"phase 11c {label}: {r['ms_per_step']:.2f} ms/step (windows "
              + ", ".join(f"{w:.1f}" for w in r["stride_ms"])
              + f" ms), peak allocated {r['peak_alloc_gib']:.3f} GiB, "
              f"reserved {r['peak_reserved_gib']:.3f} GiB (above the "
              f"resident), moments "
              f"{r['moment_bytes']} bytes (opt_state_bytes "
              f"{r['opt_state_bytes']}), final loss {r['final_loss']:.6f}"
              + (f" ({r['loss_rel_vs_default']:.3e} rel of the default's, "
                 f"tol {OPT_LOSS_REL})" if label != "default" else "")
              + f"; {card}")
    check(c["ok"], "phase 11c: the optimizer-state policies' gates")
    c["resume"] = int8_resume_check(torch, card, states)
    del states
    gc.collect()
    torch.cuda.empty_cache()
    check(c["resume"]["ok"], "phase 11c: int8 checkpoints")
    c["f32"] = int8_step_check(torch, card)
    check(c["f32"]["ok"], "phase 11c: int8 f32 checks")
    c["codec"] = int8_codec_check(torch, card)
    check(c["codec"]["ok"], "phase 11c: the int8 codec's sqrt domain")
    result["c_opt_state"] = c

    result["d_callbacks"] = {}
    for k in (MEGASTEP_K, 1):
        r = callbacks_check(torch, card, k)
        check(r["ok"], f"phase 11d: callbacks under megastep {k}")
        result["d_callbacks"][f"megastep_{k}"] = r
    return result


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
        for d in (64, 128, 256):
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
    mega = phase_megastep(torch, card)
    ckpt = phase_checkpoint(torch, card)
    lora_opt = phase_lora_and_opt_state(torch, np, card)

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
    print("megastep: " + json.dumps({**mega, "card": card}))
    print("checkpoint: " + json.dumps({**ckpt, "card": card}))
    print("lora_opt_state: " + json.dumps({**lora_opt, "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
