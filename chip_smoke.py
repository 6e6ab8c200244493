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
   64 mixed rows, rank 128, ragged r, d and k, phase 12's verify window
   (``VERIFY_W`` rows) and prefill chunk (``CHUNK_W`` rows); and a decode
   batch with an out-of-range id, whose row must be NaN (``bgmv_checks``);
2. BGMV timing (CUDA graphs of back-to-back launches over rotating inputs
   larger than L2, as the main path finds them) beside the plain version,
   the least time the card could take and the graph floor (a one-element
   ``add_`` captured the same way), with each shape's launch plan, at the
   decode, verify, chunk and prefill widths (``TIMED_WIDTHS``);
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
   name 8 x phase 9's per-step counts); two captured fits over the same
   16 batches twice, their losses and final params bitwise equal
   (``repeat_fit_check``: the flash backward's fixed dQ order); the same
   at depth 2 in f32
   (``checkpoint_parity``: params bitwise with the plain attention,
   within 5x the straight-vs-straight spread with flash); ``validate``
   and ``test`` from the checkpoint, card vs CPU (f32 within 1e-5
   relative, bf16 within 1e-2) with LN fwd 25, flash fwd 12, CE fwd 1
   and no backward launch a batch; ``predict`` card vs CPU (argmax equal
   except at a top-2 logit gap < 1e-4); the checkpoint's host copy,
   encode, write and read + restore times and validate/predict ms a
   batch;
11. the rest of the Trainer surface (``phase_lora_and_opt_state``; its
   fits at ``P11_LAYERS`` layers of GPT-2-small's width): (a) a
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
   blended with ``decay**K``, no shadow aliasing the live params;
12. the server's features (``phase_server_features``) at GPT-2-small with
   phase 3's tenants and requests, each arm's TTFT p50, ITL p50 and
   tokens/s over FEATURE_REPEATS runs with the spread: (a) an int8 tree
   (``quantize_decode_params``; every dequantized element within half its
   output channel's step) served in f32, its streams equal to
   ``generate()`` on the same tree, and in bf16, beside the float tree;
   (b) speculative decoding (``spec_k=SPEC_K``) on the pad-identity pair,
   acceptance >= 0.99 on the base model, the tenant mix's streams exact
   and the BGMV launched 2L times a verify step at ``VERIFY_W`` rows; (c)
   the early-exit draft of the server's model, greedy streams exact and
   sampled ones equal to the plain engine's; (d) ``prefill_chunk=CHUNK_W``
   with a LONG_PROMPT-token prompt admitted over 7 decoding slots, no
   resident missing a step, against ``prefill_chunk=None``; (e) the
   prefix cache over 10 requests sharing a SYSTEM_PREFIX-token prefix,
   streams equal to the cache-off engine's, blocks claimed for every
   key, a removed adapter's chains dropped;
13. the serving control plane (``phase_serve_plane``) at the server
   cell's width: the engine started on its serve thread with
   ``capacity=True, slo=True, export_every_s=0.25``, ``telemetry_dir``,
   ``prom_file``, ``prom_port`` and ``trace_dir``, reached through
   ``ServeClient``: (a) the cell's 10 requests from a client process
   (``chip_smoke.py --serve-client HOST PORT``), every stream equal to
   phase 3's, the BGMV 2L launches a serve step (counts set to 0 just
   before each run), TTFT, ITL and tokens/s as the client measures them
   over PLANE_REPEATS runs alternating with the in-process engine, the
   device-busy share of a profiled run, the cost of a reply frame on the
   serve thread, of one export and of the SLO and capacity tick; (b) a
   tenant (scale 2.0) hot-loaded by a ``serve_adapter_load`` frame in
   the ``data`` and the ``shm`` form, its stream equal to ``generate()``
   on its merged weights, 2L launches a step; (c) a burst of BURST
   requests whose deadlined ones queue and expire (replies = counter =
   the OpenMetrics line), and deadlined requests admitted, preempted in
   a PREEMPT_BLOCKS pool and requeued past their deadline, none expired,
   each stream exact with every index once; (d) a stream cancelled by a
   ``serve_cancel`` frame, its blocks freed; (e) after ``stop()``:
   ``serve-live.json`` rendered by ``tools/rlt_top.py --once``, the
   textfile and an HTTP scrape of ``/metrics``, a span per phase of each
   request, the capacity block and the SLO snapshot;
14. disaggregated serving (``phase_serve_fleet``) at the server cell's
   width: ``launch_inproc_fleet(n_replicas=2, n_prefill=1)`` on this card
   (phase 13's engine configuration, the tenants registered with the
   router), reached through ``ServeClient``: (a) the cell's 10 requests
   from a client process, every stream equal to phase 3's, every
   admission a KV import, the BGMV 2L launches a prefill on the worker and
   a tick on the replicas (counts set to 0 just before), the handoff's
   export, encode, read and import timed with its bytes and form, then
   FLEET_REPEATS timed runs alternating with phase 13's engine over the
   queue (TTFT, ITL, tokens/s as the client measures them); (b) an
   imported admission equal to the engine's own prefill, blocks and first
   tokens, bitwise; (c) the replica under a sampled and a greedy stream
   killed abruptly after KILL_AFTER tokens: a failover booked, both
   streams equal an undisturbed engine's with the same seeds, re-emitted
   tokens deduped, the time to recovery; then a replica whose beats are
   lost while its handle reads alive is declared lost; (d) as (c) with a
   planned drain: the streams migrate, nothing re-emitted; (e)
   ``router-live.json`` with ``validate_router_snapshot``'s keys
   (``ROUTER_LIVE_KEYS``), the OpenMetrics router and fleet-capacity
   sections, ``rlt_top``'s router pane; (f) a bf16 fleet's streams equal
   the bf16 monolith's (or leave them where the top-2 logit gap is below
   one bf16 step of the top logit, ``bf16_ulp``).

Phases 15-19 run in one process of their own (``phase_multi``,
``chip_smoke.py --multi``; each alone as ``chip_smoke.py --phaseN``): the
workers they need spawned and warmed up once, all at once, and kept
across their fits (``run_staged``); every phase's remote fits first, the
driver never touching the card, then each phase's references and checks.

15. multi-GPU training (``phase15_steps``): the trainer cell (warmup cut
   to one step, GPT-2-small's width at ``P15_LAYERS`` layers) under
   ``RayStrategy``, ``HorovodRayStrategy`` and ``RayShardedStrategy``
   ZeRO-1 and ZeRO-3: (a) one rank over NCCL, 8
   steps, bitwise against ``LocalStrategy``; (b) two ranks sharing the
   card over gloo, 3 steps, against ``LocalStrategy`` on the same global
   batch (the ray flavor's "auto" keeps the replicated update over gloo,
   and says so); (c) each rank's memory; (d) its launches a step; (e) the
   clip under ZeRO on two CPU workers; (f) two raw NCCL ranks on one card,
   which NCCL refuses;
16. the data-parallel gradient wire (``phase16_steps``): two ranks
   sharing the card over gloo, GPT-2-small's width at ``P15_LAYERS``
   layers, bf16, 3 steps on one global batch:
   (a) full width (the reference), (b) ``grad_comm="int8"``, (c)
   ``"int8_ef"``, (d) ``"int8_ef"`` with ``grad_overlap_segments=2``, (e)
   ``RayShardedStrategy(zero_stage=1, grad_comm="int8_ef")``, (f)
   ``update_sharding="on"`` at full width; each arm's per-step losses
   against (a) (``int8_ef`` 1%, ``int8`` 10% relative, (f)
   ``P15_LOSS_TOL``), the ranks' final params bitwise equal, the wire
   in each int8 fit bitwise against its plain version on every call with
   its residual threaded (``torch_dist_helpers.WireProbe``), the wire's
   bytes (ratio >= 3.5; (d) within 2% of (c)) and ms/step; (g) the taps'
   sync at one rank over NCCL on its side stream, at GPT-2-small's
   overlap plan, bitwise against ``int8_all_reduce_reference``; (h) the
   CPU wire checks of ``tests/test_torch_grad_comm.py`` on three CPU
   ranks, then two (``torch_dist_helpers.wire_rank``);
17. restarts (``phase17_steps``, the crash fit on workers of its own):
   GPT-2-small's width at ``P15_LAYERS`` layers, bf16: (a) a ZeRO-3 fit on
   two
   gloo ranks sharing the card with ``max_restarts=1``, rank 1 killed at
   epoch 1, bitwise an uninterrupted fit from the same call (losses,
   params, moments), one restart, the seconds to recover; (b) each rank's
   restart file under 0.75 of the two, each resumed rank's selective read
   about half the checkpoint, the full reassembly bitwise the gathered
   state; (c) the uninterrupted fit's oldest kept checkpoint resumed on
   one NCCL rank (accum 1 -> 2, the resize warned and counted), and an
   ``int8_ef`` two-rank checkpoint resumed at one rank dropping its
   residual loudly;
18. the rest of multi-GPU training (``phase18_steps``): (a) megastep
   K = 8 captured with its collectives on a one-rank NCCL world,
   GPT-2-small at 12 layers, bf16, 24 steps: ``RayStrategy`` and
   ``RayShardedStrategy(zero_stage=3)`` each bitwise its eager fit, the
   ``RayStrategy`` arm bitwise ``LocalStrategy`` captured, every step's
   collectives issued into the graph, its training kernels 8 x a step's,
   ms/step captured against eager, peak memory; (b) int8 moments under
   ZeRO-1 and ZeRO-3 on two gloo ranks sharing the card (``P15_LAYERS``),
   losses and dequantized moments against the replicated update, the
   moments' bytes a rank against f32's; (c) ZeRO-3 over ``{"data": 2,
   "fsdp": 2}`` on four gloo ranks sharing the card, losses against
   ``LocalStrategy`` on the global batch, memory a rank, each slice held
   alike by its data replicas; (d) the CE island on two gloo ranks
   against the one-rank fused CE (f32 kernels).  ``--phase16 p_full
   p_update_sharding`` (not run by default) traces one step of phase 16
   (a) and (f) on both ranks into its parts (PERF.md §5);
19. long context and model parallelism (``phase19_steps``), GPT-2-small's
   width at ``P15_LAYERS`` layers, bf16, 3 steps, each arm's losses
   against ``LocalStrategy`` on the same global batch: (a) ring attention
   at ``seq_len`` 4096 over ``{"data": 2, "sp": 2}`` on four gloo ranks
   sharing the card, both layouts, with each rank's peak memory beside
   the fold's predicted bytes and ms/step; one layer's ring forward and
   input gradients on two ranks against ``ring_attention_local``, the
   hop's route, what gloo's ``isend`` does with a card tensor and the
   ms of a hop; (b) Megatron tensor parallelism at seq 1024 over
   ``{"data": 2, "tensor": 2}`` and ZeRO-3 over ``{"fsdp": 2, "tensor":
   2}``: the gathered final params against ``LocalStrategy``'s, each
   rank's param bytes, the flash kernels' launches at 6 heads; (c) MoE
   (4 experts, capacity factor 4) on one NCCL rank bitwise
   ``LocalStrategy``, over ``{"data": 2, "expert": 2}`` with
   ``moe_aux_loss``, and greedy MoE decode equal to the argmax rollout of
   full forwards; (d) the clip under ``{"data": 2, "tensor": 2}`` on four
   CPU workers with forged loss scales against one CPU rank.  In (a)-(c)
   each leaf is bitwise alike on every rank that holds the same slice.

Any failure raises: the script exits non-zero and prints no result.  The
line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1.
``chip_smoke.py --serve-client HOST PORT`` is phases 13 and 14's client
process.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import os
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
SPEC_K = 4             # phase 12's drafted tokens a tick
VERIFY_W = DECODE_W * (SPEC_K + 1)  # the verify window's BGMV rows
CHUNK_W = 128          # phase 12's prefill chunk


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
              ("ragged d and k", 5, 100, 16, 1001, True, None),
              ("verify window qkv", VERIFY_W, D_MODEL, 16, 3 * D_MODEL,
               False, SPEC_K + 1),
              ("verify window proj", VERIFY_W, D_MODEL, 16, D_MODEL, False,
               SPEC_K + 1),
              ("prefill chunk qkv", CHUNK_W, D_MODEL, 16, 3 * D_MODEL,
               False, None),
              ("prefill chunk proj", CHUNK_W, D_MODEL, 16, D_MODEL, False,
               None))
# Phase 2's timed widths: (W, id pattern as bgmv_inputs' (mixed, run)):
# decode (every slot its own adapter), the verify window (each slot's
# SPEC_K + 1 rows one adapter), a prefill chunk and a prefill bucket (one
# adapter).
TIMED_WIDTHS = ((DECODE_W, True, None), (VERIFY_W, False, SPEC_K + 1),
                (CHUNK_W, False, None), (PREFILL_W, False, None))


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
    main path's most frequent call (decode qkv, f32, rank 16) and every
    timed width's (``TIMED_WIDTHS``) times and bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = bgmv_checks(torch, lora, gen)
    for label, ok, detail in checks:
        print(f"phase 1: {label}: {detail}")
    for label, ok, _ in checks:
        check(ok, label)
    print(f"phase 1: {len(checks)} checks passed; null-slot rows gave "
          f"exactly 0.0 at every shape")
    floor = graph_floor_ms(torch)
    print(f"phase 2: graph floor (a one-element add_ captured and replayed "
          f"as each kernel below): {floor * 1e3:.2f} us a call; {card}")
    record, widths = None, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for (W, mixed, run), k in [(w, k) for w in TIMED_WIDTHS
                                   for k in (3 * D_MODEL, D_MODEL)]:
            r = 16
            probe = bgmv_inputs(torch, W, k, r, dtype, mixed, gen, run=run)
            per_call = sum(t.numel() * t.element_size() for t in probe[0])
            # Rotate over inputs adding up to more than the 50 MB L2, as
            # the engine finds them: between two calls of one site a
            # whole model's weights stream through the cache.
            copies = max(2, min(64, -(-64 * 2**20 // per_call)))
            sets = bgmv_inputs(torch, W, k, r, dtype, mixed, gen, copies,
                               run=run)
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
            widths[f"{name} W={W} k={k}"] = {
                "ms": ms, "eager_ms": eager, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
            if dtype == torch.float32 and W == DECODE_W and k == 3 * D_MODEL:
                h, a, b, ids = sets[0]
                err = (lora.bgmv(h, a, b, ids)
                       - lora.bgmv_plain(h, a, b, ids)).abs().max().item()
                record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
    return record, widths


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


def top2_logits(torch, gen_mod, module, params, seq, device="cuda"):
    """The static reference's two largest logits for the token after
    ``seq``."""
    cfg = module.config
    cache = gen_mod.init_kv_cache(cfg, 1, len(seq), device=device)
    logits, _ = gen_mod.prefill(
        cfg, params, cache, torch.tensor([seq], device=device),
        compute_dtype=module._compute_dtype(),
    )
    return torch.topk(logits[0], 2).values


def top2_gap(torch, gen_mod, module, params, seq, device="cuda"):
    """The static reference's top-2 logit gap for the token after
    ``seq``."""
    top = top2_logits(torch, gen_mod, module, params, seq, device)
    return (top[0] - top[1]).item()


def bf16_ulp(x):
    """The spacing of bfloat16 values at ``|x|`` (8 significand bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


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
    f32["streams"] = tokens

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
# With the flash kernels the captured fit's params are held to this
# multiple of the eager-vs-eager difference of the same run, or to 1e-5
# (the difference read 1.40e-5 on an H100 while the f32 flash backward
# added dQ in a run-dependent order, 0 once the order is fixed; the
# learning rate frozen at capture reads 1.12e-3).
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
    attention.  With the flash kernels a second eager fit reads the
    eager fit's run-to-run spread (the floor; 0 since the flash backward
    adds dQ in a fixed order) and the captured fit's params are held
    within PARITY_FLOOR_X times it (or 1e-5).  Returns the readings and
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
    The resume arm has trained on it since the flash backward added dQ
    in a run-dependent order (two bf16 fits over the same 16 batches
    twice then drifted 1e-2 apart by the second epoch's 10th step); the
    repeated batches are ``repeat_fit_check``'s, which holds two fits
    over them bitwise equal."""
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


def repeat_fit_check(torch, cfg, root, card):
    """Phase 10 (1b): two captured bf16 fits of the headline arm over the
    same CKPT_STEPS batches twice (two epochs of the synthetic stream):
    their losses at every hook and their final params are bitwise equal
    (the flash backward adds each query tile's dQ in a fixed order)."""
    from ray_lightning_tpu_torch.core.callbacks import Callback

    runs = []
    for i in range(2):
        clock = hook_clock(torch, Callback)
        tr = ckpt_fit(torch, cfg, HEADLINE, f"{root}/rep{i}", 2,
                      checkpoint=False, callbacks=[clock])
        torch.cuda.synchronize()
        runs.append(([float(x) for x in clock.losses],
                     by_path(tr.state.params), tr.callback_metrics))
        del tr
    (la, pa, ma), (lb, pb, _) = runs
    differ = [k for k in pa if not torch.equal(pa[k], pb[k])]
    worst = max(abs(a - b) for a, b in zip(la, lb))
    print(f"phase 10: two captured bf16 fits over the same {CKPT_STEPS} "
          f"batches twice: {len(la)} hook losses ({la[0]:.6f} -> "
          f"{la[-1]:.6f}), worst difference {worst:.3e}; final params "
          f"{len(pa) - len(differ)}/{len(pa)} leaves bitwise equal; "
          f"captures {ma['recompiles']:.0f}; {card}")
    return {"bitwise": la == lb and not differ, "losses": len(la),
            "worst_loss_diff": worst, "leaves_differ": len(differ)}


def checkpoint_parity(torch, card):
    """Phase 10 (2): depth-2 GPT-2-small (full width) in f32, warmup 2, two
    epochs of CKPT_STEPS steps at batch 2 under megastep "auto": a
    straight fit against one epoch, its checkpoint, and a resumed second
    epoch, with the plain attention (``attn_impl="xla"``; the card repeats
    itself there: params bitwise) and in the headline configuration
    (params within PARITY_FLOOR_X times a second straight fit's spread,
    or 1e-5).  Gates in each: the file
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

        # (1b) the same batches twice: two captured fits repeat bitwise.
        repeat = repeat_fit_check(torch, cfg, root, card)
        gate(repeat["bitwise"], "two bf16 fits over repeated batches are "
             "bitwise equal")
        result["repeat"] = repeat
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
# Phase 11's fits (the LoRA fine-tune, the optimizer-state arms and the
# int8 resume) at GPT-2-small's width and this depth: the script's time
# limit is shared by every phase.
P11_LAYERS = 6
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
    print(f"phase 11a: LoRA fine-tune of GPT-2-small's width at "
          f"{P11_LAYERS} layers (rank {LORA_RANK}, "
          f"alpha 16, lr 1e-3, warmup 0), base random from seed {SEED}, "
          f"batch {TRAIN_B} x {TRAIN_T}, bf16, remat 'dots+flash', "
          f"megastep 'auto' ({MEGASTEP_K}), {LORA_STEPS} steps")
    a, tr, cfg = lora_check(torch, card, n_layer=P11_LAYERS)
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

    print(f"phase 11c: the headline arm at {P11_LAYERS} layers under "
          f"opt_state_dtype in "
          f"{OPT_DTYPES}, captured, {LORA_STEPS} steps")
    c, states = opt_state_arms(torch, card, n_layer=P11_LAYERS)
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
    c["resume"] = int8_resume_check(torch, card, states,
                                    n_layer=P11_LAYERS)
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



# -- phase 12: the server's features ---------------------------------------

FEATURE_REPEATS = 1      # timed runs of each arm
LONG_PROMPT = 900        # phase 12 (d): the prompt chunked in
SYSTEM_PREFIX = 256      # phase 12 (e): the shared system prompt
EARLY_EXIT_LAYERS = 2    # phase 12 (c): the early-exit draft's depth
PAD_DRAFT_LAYERS = 4     # phase 12 (b): the pad-identity pair's draft
# Phase 12 (d): the served prompt's k/v against a static prefill's, f32
# (relative to max |k/v|; the chunk and the bucket attend in another
# order of f32 sums).
KV_REL = 1e-4


def with_adapter(params, adapter, lora_cfg):
    """``merge_lora`` of ``params`` carrying ``adapter``'s factors: the
    tenant's reference tree for ``generate()``."""
    from ray_lightning_tpu_torch.models.gpt import merge_lora

    if adapter is None:
        return params
    return merge_lora({**params, "blocks": {
        **params["blocks"], **{f"lora_{k}": adapter[k] for k in
                               ("qkv_a", "qkv_b", "proj_a", "proj_b")}}},
        lora_cfg)


def streams_equal(torch, module, trees, reqs, tokens, label):
    """Every stream against ``generate()`` on its tenant's tree
    (``trees[name]``); a divergence is allowed only at a reference top-2
    logit gap < TOP2_GAP.  Returns the count of exact streams."""
    from ray_lightning_tpu_torch.models import generate as gen_mod

    exact = 0
    for (prompt, n, name), got in zip(reqs, tokens):
        ref = gen_mod.generate(module, trees[name], [prompt], n,
                               device="cuda")[0, len(prompt):].tolist()
        if got == ref:
            exact += 1
            continue
        i = next(j for j, (x, y) in enumerate(zip(got, ref)) if x != y)
        gap = top2_gap(torch, gen_mod, module, trees[name], prompt + ref[:i])
        print(f"phase 12 {label}: {name or 'base'} stream diverges from "
              f"generate() at token {i}; reference top-2 gap {gap:.3e}")
        check(gap < TOP2_GAP, f"phase 12 {label}: divergence at a top-2 "
              f"gap {gap} >= {TOP2_GAP}")
    return exact


def timed_runs(torch, make_engine, reqs, label, card,
               repeats=FEATURE_REPEATS, **submit_kw):
    """``repeats`` fresh engines over ``reqs`` (all submitted at once);
    prints and returns each run's TTFT p50, ITL p50 and tokens/s with the
    spread, the last run's tokens and snapshot."""
    runs, tokens, snap = [], None, None
    for _ in range(repeats):
        engine = make_engine()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = [engine.submit(p, n, adapter=a, **submit_kw)
                   for p, n, a in reqs]
        engine.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = [h.result(0) for h in handles]
        snap = engine.snapshot()
        lat = snap["latency"]
        runs.append({"ttft_p50_ms": lat["ttft"]["p50_ms"],
                     "itl_p50_ms": lat["token"]["p50_ms"],
                     "tokens_per_s": sum(map(len, tokens)) / wall})
        del engine
    out = {"runs": runs}
    for key in ("ttft_p50_ms", "itl_p50_ms", "tokens_per_s"):
        vals = [r[key] for r in runs]
        out[key] = sorted(vals)[len(vals) // 2]
        out[key + "_spread"] = [min(vals), max(vals)]
    print(f"phase 12 {label}: TTFT p50 {out['ttft_p50_ms']:.1f} ms "
          f"({out['ttft_p50_ms_spread'][0]:.1f}-"
          f"{out['ttft_p50_ms_spread'][1]:.1f}), ITL p50 "
          f"{out['itl_p50_ms']:.2f} ms ({out['itl_p50_ms_spread'][0]:.2f}-"
          f"{out['itl_p50_ms_spread'][1]:.2f}), {out['tokens_per_s']:.1f} "
          f"tokens/s ({out['tokens_per_s_spread'][0]:.1f}-"
          f"{out['tokens_per_s_spread'][1]:.1f}) over {repeats} runs; "
          f"{card}")
    return out, tokens, snap


def acceptance(snap):
    c = snap["counters"]
    return c.get("spec_accepted", 0) / max(c.get("spec_drafted", 0), 1)


def feature_int8(torch, np, card, world, repeats=FEATURE_REPEATS):
    """(a) int8: ``quantize_decode_params`` of the server's f32 weights
    served in f32 (streams equal ``generate()`` on the same int8 tree,
    each tenant's factors merged into its dequantized weights) and bf16;
    beside them the float tree in f32 and bf16."""
    from ray_lightning_tpu_torch.models.gpt import GPT
    from ray_lightning_tpu_torch.models.quant import (
        dequantize_decode_params, quantize_decode_params,
    )
    from ray_lightning_tpu_torch.serve.engine import ServeEngine

    cfg, params, tenants, reqs = (world[k] for k in
                                  ("cfg", "params", "tenants", "reqs"))
    q8 = quantize_decode_params(params)
    # Per-output-channel rounding: each dequantized element within half a
    # step (its channel's amax / 254) of the float weight; wte per row.
    deq = dequantize_decode_params(q8)
    worst = 0.0
    for name, w, got, axis in (
            [(k, params["blocks"][k], deq["blocks"][k], -2)
             for k in ("qkv_w", "proj_w", "mlp_in_w", "mlp_out_w")]
            + [("wte", params["wte"], deq["wte"], -1)]):
        half = w.abs().amax(dim=axis, keepdim=True) / 254 + 1e-7
        excess = ((got - w).abs() - half).max().item()
        worst = max(worst, excess)
        check(excess <= 0, f"phase 12 (a): {name} dequantized within half "
              f"a per-channel step of the float weights")
    n8 = sum(t.numel() for t in [*q8["blocks"].values(), q8["wte_q8"]]
             if t.dtype == torch.int8)
    print(f"phase 12 (a): {n8} int8 weights; every dequantized element "
          f"within its output channel's amax / 254 (worst margin "
          f"{worst:.3e})")
    m32 = GPT(cfg, precision="f32", device="cuda")
    m16 = GPT(cfg, precision="bf16", device="cuda")
    out = {}
    for label, module, tree in (("f32", m32, params), ("bf16", m16, params),
                                ("int8 f32", m32, q8),
                                ("int8 bf16", m16, q8)):
        def make(module=module, tree=tree):
            return ServeEngine(module, tree, world["serve_cfg"],
                               adapters=tenants, device="cuda")

        out[label], tokens, _ = timed_runs(torch, make, reqs,
                                           f"(a) {label}", card,
                                           repeats=repeats)
        if label == "int8 f32":
            trees = {None: deq, **{n: with_adapter(deq, a, world["lora_cfg"])
                                   for n, a in tenants.items()}}
            exact = streams_equal(torch, m32, trees, reqs, tokens,
                                  "(a) int8")
            print(f"phase 12 (a): int8 f32 streams: {exact}/{len(reqs)} "
                  f"equal generate() on the same int8 tree token for "
                  f"token; the rest diverge only at a near tie")
            out["int8_exact_streams"] = exact
    return out


def feature_pad(torch, np, card, world, repeats=FEATURE_REPEATS):
    """(b) the pad-identity pair: target = a PAD_DRAFT_LAYERS-layer
    GPT-2-width draft + 12 - PAD_DRAFT_LAYERS identity layers,
    ``spec_k=SPEC_K``; acceptance >= 0.99 over the requests on the base
    model; over the tenant mix (adapters on the target) the streams equal
    ``generate()`` on each tenant's merged target and the BGMV launches
    2L times a verify step at the verify width."""
    from ray_lightning_tpu_torch.models.gpt import (
        GPT, synthetic_lora_adapter,
    )
    from ray_lightning_tpu_torch.ops import lora
    from ray_lightning_tpu_torch.serve.draft import pad_identity_layers
    from ray_lightning_tpu_torch.serve.engine import ServeEngine

    cfg, reqs = world["cfg"], world["reqs"]
    out = {}
    dcfg = dataclasses.replace(cfg, n_layer=PAD_DRAFT_LAYERS)
    dmod = GPT(dcfg, precision="f32", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    dparams = dmod.init_params(gen)
    tmod, tparams = pad_identity_layers(dmod, dparams,
                                        cfg.n_layer - PAD_DRAFT_LAYERS,
                                        seed=SEED + 13)
    tl_cfg = dataclasses.replace(tmod.config, lora_rank=16)
    tenants, trees = {}, {None: tparams}
    for i in range(N_TENANTS):
        adapter, merged = synthetic_lora_adapter(tparams, tl_cfg, gen,
                                                 scale=0.3)
        tenants[f"tenant{i}"], trees[f"tenant{i}"] = adapter, merged
    spec_cfg = dataclasses.replace(world["serve_cfg"], spec_k=SPEC_K)

    def pair():
        return ServeEngine(tmod, tparams, spec_cfg, adapters=tenants,
                           device="cuda", draft_module=dmod,
                           draft_params=dparams)

    base_reqs = [(p, n, None) for p, n, _ in reqs]
    _, tokens, snap = timed_runs(torch, pair, base_reqs,
                                 "(b) pad-identity pair, base model", card,
                                 repeats=1)
    acc_base = acceptance(snap)
    print(f"phase 12 (b): acceptance over the base-model requests "
          f"{acc_base:.4f} (gate >= 0.99), spec counters "
          + json.dumps({k: v for k, v in snap["counters"].items()
                        if k.startswith(("spec", "verify", "draft"))}))
    check(acc_base >= 0.99, f"phase 12 (b): acceptance {acc_base} >= 0.99")
    lora.bgmv.launches_by_rows.clear()
    out["pad_identity"], tokens, snap = timed_runs(
        torch, pair, reqs, "(b) pad-identity pair, tenant mix", card,
        repeats=repeats)
    rows = dict(lora.bgmv.launches_by_rows)
    c = snap["counters"]
    want = 2 * cfg.n_layer * c["verify_steps"] * repeats
    print(f"phase 12 (b): acceptance over the tenant mix "
          f"{acceptance(snap):.4f}; bgmv launches by rows over the "
          f"{repeats} runs {json.dumps(rows)} (verify width "
          f"{VERIFY_W}: {rows.get(VERIFY_W, 0)}, 2 x {cfg.n_layer} x "
          f"verify steps {c['verify_steps']} a run x {repeats} = "
          f"{want})")
    check(c["verify_steps"] > 0 and rows.get(VERIFY_W, 0) == want,
          "phase 12 (b): the BGMV launched at the verify width, 2L a "
          "verify step")
    exact = streams_equal(torch, tmod, trees, reqs, tokens, "(b)")
    print(f"phase 12 (b): {exact}/{len(reqs)} streams equal generate() on "
          f"each tenant's merged target token for token")
    out["pad_identity"].update(acceptance_base=acc_base,
                               acceptance_mix=acceptance(snap),
                               exact_streams=exact,
                               bgmv_verify_launches=rows.get(VERIFY_W, 0))
    return out


def feature_early(torch, np, card, world, repeats=FEATURE_REPEATS):
    """(c) the early-exit draft of EARLY_EXIT_LAYERS layers of the
    server's 12-layer model, ``spec_k=SPEC_K``: greedy streams exact,
    sampled (temperature 0.8) equal to the same requests without
    speculation; the acceptance."""
    from ray_lightning_tpu_torch.serve.draft import early_exit_draft
    from ray_lightning_tpu_torch.serve.engine import ServeEngine

    reqs = world["reqs"]
    spec_cfg = dataclasses.replace(world["serve_cfg"], spec_k=SPEC_K)
    out = {}
    module, params, tenants = world["module"], world["params"], \
        world["tenants"]
    dmod, dparams = early_exit_draft(module, params, EARLY_EXIT_LAYERS)

    def early(spec=True):
        extra = dict(draft_module=dmod, draft_params=dparams) if spec \
            else {}
        return ServeEngine(module, params,
                           spec_cfg if spec else world["serve_cfg"],
                           adapters=tenants, device="cuda", **extra)

    out["early_exit"], tokens, snap = timed_runs(
        torch, early, reqs, "(c) early-exit draft, greedy", card,
        repeats=repeats)
    exact = streams_equal(torch, module, world["trees"], reqs, tokens,
                          "(c)")
    acc = acceptance(snap)
    _, sampled, ssnap = timed_runs(torch, early, reqs,
                                   "(c) early-exit draft, temperature 0.8",
                                   card, repeats=1, temperature=0.8)
    _, plain, _ = timed_runs(torch, lambda: early(False), reqs,
                             "(c) no speculation, temperature 0.8", card,
                             repeats=1, temperature=0.8)
    same = sum(a == b for a, b in zip(sampled, plain))
    print(f"phase 12 (c): greedy {exact}/{len(reqs)} streams exact, "
          f"acceptance {acc:.4f} (sampled {acceptance(ssnap):.4f}); "
          f"sampled streams equal to the same requests without "
          f"speculation: {same}/{len(reqs)}")
    check(same == len(reqs), "phase 12 (c): sampled streams under "
          "speculation equal the plain engine's")
    out["early_exit"].update(acceptance=acc, exact_streams=exact,
                             sampled_equal=same,
                             acceptance_sampled=acceptance(ssnap))
    return out


def feature_chunked(torch, np, card, world, repeats=FEATURE_REPEATS):
    """(d) one LONG_PROMPT-token prompt admitted while 7 slots decode,
    ``prefill_chunk=CHUNK_W`` against ``None``: every stream exact, the
    prompt's k/v in the pool (read through its block table once its
    first token lands) within KV_REL of a whole-prompt static prefill's,
    no resident slot missing a step while the prompt is chunked; the
    residents' step intervals (p50, max) while it is admitted.  (With
    random weights a token rarely depends on far context, so the k/v are
    what show a chunk landing in the wrong blocks.)"""
    from ray_lightning_tpu_torch.models import generate as gen_mod
    from ray_lightning_tpu_torch.serve.engine import ServeEngine

    rng = np.random.default_rng(SEED + 4)
    residents = [(p[:128], 48, a) for p, _, a in world["reqs"][1:8]]
    long_req = (rng.integers(0, 50257, size=(LONG_PROMPT,)).tolist(), 32,
                None)
    mcfg = world["cfg"]
    ref = gen_mod.init_kv_cache(mcfg, 1, LONG_PROMPT, device="cuda")
    with torch.no_grad():
        _, ref = gen_mod.prefill(mcfg, world["params"], ref,
                                 torch.tensor([long_req[0]], device="cuda"))

    def kv_rel(engine, slot):
        ids = engine.scheduler._blocks[slot]
        worst = 0.0
        for key in ("k", "v"):
            got = engine._pool[key][:, ids].reshape(
                mcfg.n_layer, -1, mcfg.n_head, mcfg.head_dim)[:, :LONG_PROMPT]
            want = ref[key][:, 0]
            worst = max(worst, ((got - want).abs().max()
                                / want.abs().max()).item())
        return worst

    out, all_runs, all_tokens = {}, {}, {}
    # The arms alternate, so that a drift of the shared host over the
    # phase falls on both.
    for chunk in [CHUNK_W, None] * repeats:
        cfg = dataclasses.replace(world["serve_cfg"], prefill_chunk=chunk)
        runs = all_runs.setdefault(chunk, [])
        engine = ServeEngine(world["module"], world["params"], cfg,
                             adapters=world["tenants"], device="cuda")
        hs = [engine.submit(p, n, adapter=a) for p, n, a in residents]
        while not all(h.request.generated for h in hs):
            engine.step()
        h_long = engine.submit(*long_req[:2])
        gaps, missed = [], 0
        while not h_long.request.generated:
            before = [len(h.request.generated) for h in hs]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.step()
            gaps.append((time.perf_counter() - t0) * 1e3)
            missed += sum(len(h.request.generated) == b and not h.done()
                          for h, b in zip(hs, before))
        rel = kv_rel(engine, h_long.request.slot)
        engine.run_until_idle()
        snap = engine.snapshot()
        runs.append({"steps": len(gaps), "missed": missed,
                     "itl_p50_ms": sorted(gaps)[len(gaps) // 2],
                     "itl_max_ms": max(gaps),
                     "itl_p50_all_ms": snap["latency"]["token"]["p50_ms"],
                     "ttft_long_ms": (h_long.request.first_token_t
                                      - h_long.request.arrival_t) * 1e3,
                     "kv_rel": rel})
        all_tokens[chunk] = [h.result(0) for h in hs] + [
            h_long.result(0)]
        del engine
    for chunk in (CHUNK_W, None):
        label = f"prefill_chunk={chunk}"
        runs, tokens = all_runs[chunk], all_tokens[chunk]
        reqs = residents + [long_req]
        exact = streams_equal(torch, world["module"], world["trees"], reqs,
                              tokens, f"(d) {label}")
        missed = sum(r["missed"] for r in runs)
        print(f"phase 12 (d) {label}: the {LONG_PROMPT}-token prompt took "
              f"{[r['steps'] for r in runs]} steps; residents' step "
              f"interval meanwhile p50 "
              f"{[round(r['itl_p50_ms'], 2) for r in runs]} ms, max "
              f"{[round(r['itl_max_ms'], 2) for r in runs]} ms; the long "
              f"prompt's TTFT {[round(r['ttft_long_ms'], 1) for r in runs]}"
              f" ms; missed resident ticks {missed}; {exact}/{len(reqs)} "
              f"streams exact; its k/v against a whole-prompt prefill's: "
              f"{max(r['kv_rel'] for r in runs):.2e} of max|k/v| (limit "
              f"{KV_REL:g}); {card}")
        check(max(r["kv_rel"] for r in runs) <= KV_REL,
              f"phase 12 (d) {label}: the prompt's k/v in the pool")
        if chunk is not None:
            check(missed == 0, "phase 12 (d): no resident misses a step "
                  "while the prompt is chunked")
        out[label] = {"runs": runs, "exact_streams": exact}
    return out


def feature_prefix(torch, np, card, world, repeats=FEATURE_REPEATS):
    """(e) 10 requests sharing a SYSTEM_PREFIX-token prefix across two
    tenants and the base model, ``prefix_cache=True`` against off: one
    request per key first, the other 7 after it lands; streams equal the
    cache-off engine's, blocks claimed > 0 for every key; TTFT p50 of
    the second wave with and without the cache.  Then tenant1 removed
    (its chains dropped at the next step) and loaded again with other
    factors: its next request claims nothing and its stream equals
    ``generate()`` on the new merged weights."""
    from ray_lightning_tpu_torch.serve.engine import ServeEngine

    rng = np.random.default_rng(SEED + 5)
    system = rng.integers(0, 50257, size=(SYSTEM_PREFIX,)).tolist()
    keys = (None, "tenant0", "tenant1")
    reqs = [(system + rng.integers(0, 50257, size=(int(n),)).tolist(), 32,
             keys[i % 3])
            for i, n in enumerate(rng.integers(16, 129, size=10))]
    out, streams, all_runs = {}, {}, {True: [], False: []}
    # The arms alternate, so that a drift of the shared host over the
    # phase falls on both; the last cache-on engine is kept for the drop
    # check below.
    for on in [True, False] * repeats:
        cfg = dataclasses.replace(world["serve_cfg"], prefix_cache=on)
        engine = ServeEngine(world["module"], world["params"], cfg,
                             adapters=world["tenants"], device="cuda")
        first = [engine.submit(p, n, adapter=a) for p, n, a in reqs[:3]]
        while not all(h.request.generated for h in first):
            engine.step()
        t0 = time.perf_counter()
        rest = [engine.submit(p, n, adapter=a) for p, n, a in reqs[3:]]
        engine.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hs = first + rest
        ttft = sorted((h.request.first_token_t - h.request.arrival_t)
                      * 1e3 for h in rest)
        claimed = {}
        for h in hs:
            key = h.request.adapter
            claimed[key] = claimed.get(key, 0) + \
                h.request.claimed_tokens // cfg.block_size
        snap = engine.snapshot()
        all_runs[on].append({"ttft_p50_ms": ttft[len(ttft) // 2],
                             "itl_p50_ms": snap["latency"]["token"]["p50_ms"],
                             "tokens_per_s": sum(len(h.result(0))
                                                 for h in rest) / wall,
                             "blocks_claimed": {str(k): v
                                                for k, v in claimed.items()},
                             "prefix": snap.get("prefix")})
        streams[on] = [h.result(0) for h in hs]
        if on:
            kept = engine
        del engine
    engine = kept
    del kept
    # The drop of a removed adapter's chains: gone at the next step, and
    # after a reload under the same name none claimed.
    fresh = world["tenants"]["tenant2"]
    engine.remove_adapter("tenant1")
    engine.generate(reqs[0][0][:32], 2)
    left = "tenant1" in engine.prefix_cache._roots
    print(f"phase 12 (e): tenant1 removed: its chains "
          f"{'LEFT in the cache' if left else 'dropped'}")
    check(not left, "phase 12 (e): a removed adapter's chains are dropped")
    engine.add_adapter("tenant1", fresh)
    h = engine.submit(reqs[2][0], reqs[2][1], adapter="tenant1")
    engine.run_until_idle()
    got = h.result(0)
    claimed = h.request.claimed_tokens
    merged = with_adapter(world["params"], fresh, world["lora_cfg"])
    exact = streams_equal(torch, world["module"], {"new": merged},
                          [(reqs[2][0], reqs[2][1], "new")], [got],
                          "(e) after the adapter's reload")
    print(f"phase 12 (e): tenant1 removed and loaded again with other "
          f"factors: its request claimed {claimed} tokens (want 0), stream "
          f"{'exact' if exact else 'near tie'}")
    check(claimed == 0, "phase 12 (e): a removed adapter's chains are not "
          "claimed")
    del engine
    for on in (True, False):
        label = "prefix_cache" if on else "cache off"
        runs = all_runs[on]
        print(f"phase 12 (e) {label}: the second wave's TTFT p50 "
              f"{[round(r['ttft_p50_ms'], 1) for r in runs]} ms, ITL p50 "
              f"{[r['itl_p50_ms'] for r in runs]} ms, "
              f"{[round(r['tokens_per_s'], 1) for r in runs]} tokens/s; "
              f"blocks claimed per key {runs[-1]['blocks_claimed']}; "
              f"{card}")
        if on:
            check(all(v > 0 for v in runs[-1]["blocks_claimed"].values())
                  and len(runs[-1]["blocks_claimed"]) == 3,
                  "phase 12 (e): blocks claimed for every key")
        out[label] = runs
    same = sum(a == b for a, b in zip(streams[True], streams[False]))
    print(f"phase 12 (e): {same}/{len(reqs)} streams equal the cache-off "
          f"engine's")
    check(same == len(reqs), "phase 12 (e): prefix-cache streams equal "
          "the cache-off engine's")
    out["equal_streams"] = same
    return out


def server_world(torch, np):
    """The server cell: GPT-2-small in f32 from SEED, N_TENANTS rank-16
    tenants and their merged trees, its 10 requests and ServeConfig."""
    from ray_lightning_tpu_torch.models.gpt import (
        GPT, GPTConfig, synthetic_lora_adapter,
    )
    from ray_lightning_tpu_torch.serve.engine import ServeConfig

    cfg = GPTConfig.gpt2_small()
    module = GPT(cfg, precision="f32", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = module.init_params(gen)
    lora_cfg = dataclasses.replace(cfg, lora_rank=16)
    tenants, trees = {}, {None: params}
    for i in range(N_TENANTS):
        adapter, merged = synthetic_lora_adapter(params, lora_cfg, gen,
                                                 scale=0.3)
        tenants[f"tenant{i}"], trees[f"tenant{i}"] = adapter, merged
    world = {"cfg": cfg, "module": module, "params": params,
             "lora_cfg": lora_cfg, "tenants": tenants, "trees": trees,
             "reqs": make_requests(np, tenants),
             "serve_cfg": ServeConfig(num_slots=DECODE_W, block_size=16,
                                      max_adapters=N_TENANTS,
                                      adapter_rank=16)}
    return world


def phase_server_features(torch, np, card):
    """Phase 12: the server's features at GPT-2-small, 4 rank-16 tenants
    plus the base, the server cell's 10 requests unless stated: (a) int8,
    (b) and (c) speculative decoding, (d) chunked prefill, (e) the prefix
    cache (each arm's docstring has its gates)."""
    t0 = time.perf_counter()
    world = server_world(torch, np)
    out = {"int8": feature_int8(torch, np, card, world)}
    out.update(feature_pad(torch, np, card, world))
    out.update(feature_early(torch, np, card, world))
    out["chunked"] = feature_chunked(torch, np, card, world)
    out["prefix"] = feature_prefix(torch, np, card, world)
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 12: {out['wall_s']:.1f} s; {card}")
    return out


# -- phase 13: the serving control plane ------------------------------------

PLANE_REPEATS = 1        # (a): queue runs, alternating with in-process runs
PLANE_TIMEOUT_S = 120    # any one request over the queue
WIRE_ALPHA = 32.0        # (b): the wire tenant's alpha, scale 2.0 at rank 16
BURST = 24               # (c): requests at t=0, the first DECODE_W without
BURST_NEW = 32           # a deadline, the rest with BURST_DEADLINE_S
BURST_DEADLINE_S = 0.001
# (c): DECODE_W deadlined requests of two blocks each admitted at once into
# a pool of PREEMPT_BLOCKS (max_model_len PREEMPT_PROMPT + PREEMPT_NEW),
# where growth runs dry and preempts; their requeues come long after
# PREEMPT_DEADLINE_S.
PREEMPT_PROMPT = 32
PREEMPT_NEW = 64
PREEMPT_BLOCKS = 23
PREEMPT_DEADLINE_S = 0.05
CANCEL_AFTER = 6         # (d): tokens streamed before the serve_cancel frame
TRACE_PHASES = ("queue_wait", "prefill_compute", "first_token", "request")
ROOT = os.path.dirname(os.path.abspath(__file__))


def stream_metrics(starts, times, lengths):
    """TTFT p50, ITL p50 (ms) and tokens/s of one round as its client
    sees them: ``starts[i]`` request i's submit time, ``times[i]`` its
    tokens' arrival times (``time.perf_counter`` seconds)."""
    ttft = sorted(t[0] - s for s, t in zip(starts, times) if t)
    gaps = sorted(b - a for t in times for a, b in zip(t, t[1:]))
    last = max(t[-1] for t in times if t)
    return {"ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
            "itl_p50_ms": 1e3 * gaps[len(gaps) // 2],
            "tokens_per_s": sum(lengths) / (last - min(starts))}


def client_round(client, reqs, timeout=PLANE_TIMEOUT_S, **submit_kw):
    """Stream every ``(prompt, new, adapter)`` of ``reqs`` through
    ``client`` at once, one thread each.  Returns the streams, submit
    times, token arrival times and each request's error (None if it
    finished)."""
    import threading

    n = len(reqs)
    streams, starts = [[] for _ in range(n)], [0.0] * n
    times, errors = [[] for _ in range(n)], [None] * n

    def one(i):
        prompt, new, adapter = reqs[i]
        starts[i] = time.perf_counter()
        try:
            for tok in client.stream(prompt, new, adapter=adapter,
                                     timeout=timeout, **submit_kw):
                times[i].append(time.perf_counter())
                streams[i].append(tok)
        except Exception as e:  # noqa: BLE001 - reported per request
            errors[i] = f"{type(e).__name__}: {e}"

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30)
    check(not any(t.is_alive() for t in threads),
          "every client stream ended")
    return streams, starts, times, errors


def serve_client_main(argv) -> int:
    """Phase 13 (a)'s client process: a ``ServeClient`` on the engine's
    inbox at ``argv = [host, port]``.  Each line on stdin is a JSON list
    of ``[prompt, new, adapter]``; it streams them all at once and prints
    one JSON line: the streams, errors, and its TTFT, ITL and tokens/s.
    Touches no device; ends at the end of stdin."""
    from ray_lightning_tpu_torch.cluster.queue import QueueHandle
    from ray_lightning_tpu_torch.serve.client import RetryPolicy, ServeClient

    client = ServeClient(QueueHandle(argv[0], int(argv[1])),
                         retry=RetryPolicy(max_attempts=1))
    try:
        for line in sys.stdin:
            reqs = [tuple(r) for r in json.loads(line)]
            streams, starts, times, errors = client_round(client, reqs)
            out = {"streams": streams, "errors": errors}
            if not any(errors):
                out.update(stream_metrics(starts, times,
                                          [len(s) for s in streams]))
            print(json.dumps(out), flush=True)
    finally:
        client.close()
    return 0


def inprocess_round(torch, engine, reqs, device):
    """``reqs`` submitted at once to an engine driven in this thread;
    tokens timed as they are emitted.  Returns (streams, metrics)."""
    n = len(reqs)
    starts, times, handles = [0.0] * n, [[] for _ in range(n)], []
    for i, (prompt, new, adapter) in enumerate(reqs):
        starts[i] = time.perf_counter()
        handles.append(engine.submit(
            prompt, new, adapter=adapter,
            on_token=lambda j, tok, i=i: times[i].append(
                time.perf_counter())))
    engine.run_until_idle()
    if device != "cpu":
        torch.cuda.synchronize()
    streams = [h.result(0) for h in handles]
    return streams, stream_metrics(starts, times, [len(s) for s in streams])


def same_or_near_tie(torch, module, tree, prompt, got, ref, label, device):
    """``got`` equals ``ref``, or diverges first where the reference's
    top-2 logit gap is below TOP2_GAP (same length either way)."""
    from ray_lightning_tpu_torch.models import generate as gen_mod

    if got == ref:
        return True
    if len(got) != len(ref):
        print(f"phase 13 {label}: {len(got)} tokens, the reference "
              f"{len(ref)}")
        return False
    i = next(j for j, (x, y) in enumerate(zip(got, ref)) if x != y)
    gap = top2_gap(torch, gen_mod, module, tree, prompt + ref[:i], device)
    print(f"phase 13 {label}: diverges at token {i}; reference top-2 gap "
          f"{gap:.3e}")
    return gap < TOP2_GAP


def summarize(runs, label, card, phase=13):
    out = {"runs": runs}
    for key in ("ttft_p50_ms", "itl_p50_ms", "tokens_per_s"):
        vals = [r[key] for r in runs]
        out[key] = sorted(vals)[len(vals) // 2]
        out[key + "_spread"] = [min(vals), max(vals)]
    print(f"phase {phase} (a) {label}: TTFT p50 {out['ttft_p50_ms']:.1f} ms "
          f"({out['ttft_p50_ms_spread'][0]:.1f}-"
          f"{out['ttft_p50_ms_spread'][1]:.1f}), ITL p50 "
          f"{out['itl_p50_ms']:.2f} ms ({out['itl_p50_ms_spread'][0]:.2f}-"
          f"{out['itl_p50_ms_spread'][1]:.2f}), {out['tokens_per_s']:.1f} "
          f"tokens/s ({out['tokens_per_s_spread'][0]:.1f}-"
          f"{out['tokens_per_s_spread'][1]:.1f}) over {len(runs)} runs; "
          f"{card}")
    return out


def _counted(engine, lora, run):
    """``run()`` with the BGMV's launch count set to 0 just before and
    read just after; returns (result, launches, serve steps run)."""
    c0 = dict(engine.stats.counters)
    lora.bgmv.launches = 0
    result = run()
    launches = lora.bgmv.launches
    c1 = dict(engine.stats.counters)
    steps = sum(c1.get(k, 0) - c0.get(k, 0)
                for k in ("prefills", "decode_steps"))
    return result, launches, steps


def phase_serve_plane(torch, np, card, world, phase3=None,
                      repeats=PLANE_REPEATS, device="cuda"):
    """Phase 13: the serving control plane at the server cell's width —
    an engine started on its serve thread with every export on, reached
    over the queue plane: (a) the cell's requests from a client process,
    each stream equal to the in-process engine's (and phase 3's), timed
    against it in alternating runs; (b) a tenant hot-loaded over the wire
    in the ``data`` and the ``shm`` form, served through the BGMV exactly;
    (c) deadlines: a burst whose deadlined requests queue and expire, and
    deadlined requests admitted, preempted and requeued past their
    deadline, none expired, every stream exact with each index once;
    (d) a stream cancelled by a ``serve_cancel`` frame, its blocks freed;
    (e) the exports after ``stop()``.  ``phase3`` carries phase 3's
    streams and profile."""
    import shutil
    import tempfile
    import threading
    import urllib.request

    from ray_lightning_tpu_torch.cluster.rpc import find_free_port
    from ray_lightning_tpu_torch.cluster.shm import SegmentStore
    from ray_lightning_tpu_torch.models import generate as gen_mod
    from ray_lightning_tpu_torch.models.gpt import synthetic_lora_adapter
    from ray_lightning_tpu_torch.ops import lora
    from ray_lightning_tpu_torch.serve import (
        RetryPolicy, ServeClient, ServeEngine, ServeRejected, encode_adapter,
    )

    t_phase = time.perf_counter()
    cfg, module, params = world["cfg"], world["module"], world["params"]
    reqs, trees = world["reqs"], world["trees"]
    per_step = 2 * cfg.n_layer
    failed = []

    def gate(ok, what):
        if not ok:
            print(f"phase 13: FAILED: {what}")
            failed.append(what)

    tdir = tempfile.mkdtemp(prefix="rlt-serve-plane-")
    prom_port = find_free_port("127.0.0.1")
    engine = ServeEngine(
        module, params,
        dataclasses.replace(world["serve_cfg"], capacity=True, slo=True,
                            export_every_s=0.25),
        adapters=world["tenants"], device=device, telemetry_dir=tdir,
        prom_file=os.path.join(tdir, "serve.prom"), prom_port=prom_port,
        trace_dir=tdir, trace_name="phase13")
    reply_cost = [0.0, 0]
    send = engine._reply

    def timed_reply(addr, item):
        t0 = time.perf_counter()
        send(addr, item)
        reply_cost[0] += time.perf_counter() - t0
        reply_cost[1] += 1

    engine._reply = timed_reply
    ref = ServeEngine(module, params, world["serve_cfg"],
                      adapters=world["tenants"], device=device)
    ref.generate(reqs[1][0][:32], 4, adapter=reqs[1][2])
    engine.start()
    client = ServeClient(engine.queue_handle(),
                         retry=RetryPolicy(max_attempts=1))
    child = errf = None
    out = {}
    try:
        client.generate(reqs[1][0][:32], 4, adapter=reqs[1][2],
                        timeout=PLANE_TIMEOUT_S)

        # (a) the cell's requests from a client process, alternating
        h = engine.queue_handle()
        errf = open(os.path.join(tdir, "client.err"), "w")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-client",
             h.host, str(h.port)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=errf, text=True, cwd=ROOT,
            env=env)
        wire_reqs = json.dumps([[p, n, a] for p, n, a in reqs])

        def queue_round():
            child.stdin.write(wire_reqs + "\n")
            child.stdin.flush()
            line = child.stdout.readline()
            if not line:
                errf.flush()
                tail = open(errf.name).read()[-2000:]
                raise RuntimeError(f"the client process ended: {tail}")
            return json.loads(line)

        want = phase3["streams"] if phase3 else None
        runs = {"queue": [], "inprocess": []}
        launches_total = 0
        reply_cost[:] = [0.0, 0]
        order = []
        for i in range(repeats):
            order += ["inprocess", "queue"] if i % 2 == 0 \
                else ["queue", "inprocess"]
        for kind in order:
            if kind == "inprocess":
                # The serve thread's idle polls would share the GIL with
                # the in-process engine: halted for its runs.
                engine.halt_loop()
                streams, metrics = inprocess_round(torch, ref, reqs, device)
                engine.start()
            else:
                res, launches, steps = _counted(engine, lora, queue_round)
                gate(not any(res["errors"]),
                     f"(a) queue run errors {res['errors']}")
                streams = res["streams"]
                metrics = {k: res.get(k, float("nan")) for k in
                           ("ttft_p50_ms", "itl_p50_ms", "tokens_per_s")}
                print(f"phase 13 (a) queue run: bgmv launches {launches} "
                      f"= {per_step} x {steps} serve steps: "
                      f"{launches == per_step * steps}")
                # The counters count kernel launches: none on the CPU.
                gate(device == "cpu"
                     or 0 < launches == per_step * steps,
                     "(a) the BGMV launched 2L times a prefill and tick")
                launches_total += launches
            if want is None:
                want = streams
            exact = sum(a == b for a, b in zip(streams, want))
            print(f"phase 13 (a) {kind} run: {exact}/{len(reqs)} streams "
                  f"equal phase 3's; TTFT p50 "
                  f"{metrics['ttft_p50_ms']:.1f} ms, ITL p50 "
                  f"{metrics['itl_p50_ms']:.2f} ms, "
                  f"{metrics['tokens_per_s']:.1f} tokens/s")
            gate(exact == len(reqs), f"(a) {kind} streams equal phase 3's")
            runs[kind].append(metrics)
        frames = reply_cost[1]
        out["reply_frame_us"] = 1e6 * reply_cost[0] / max(frames, 1)
        out["reply_frames"] = frames
        out["bgmv_launches"] = launches_total
        out["queue"] = summarize(runs["queue"], "over the queue", card)
        out["inprocess"] = summarize(runs["inprocess"], "in-process", card)
        print(f"phase 13 (a): {frames} reply frames sent from the serve "
              f"thread, {out['reply_frame_us']:.1f} us each; {card}")
        out["profile"] = None
        if device != "cpu":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                queue_round()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy = sum(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
            base = (phase3 or {}).get("profile") or {}
            out["profile"] = {"wall_ms": wall_us / 1e3,
                              "device_busy_ms": busy / 1e3,
                              "device_busy_share": busy / wall_us,
                              "phase3_device_busy_share":
                              base.get("device_busy_share")}
            print(f"phase 13 (a) profile: over the queue, wall "
                  f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
                  f"({100 * busy / wall_us:.1f}%; phase 3 in-process "
                  f"{100 * (base.get('device_busy_share') or 0):.1f}%); "
                  f"{card}")

        engine.halt_loop()
        t0 = time.perf_counter()
        for _ in range(10):
            engine._maybe_export(force=True)
        out["export_ms"] = (time.perf_counter() - t0) * 1e2
        cap, slo = engine.capacity_oracle, engine.slo_evaluator
        t0 = time.perf_counter()
        for _ in range(10):
            cap.observe(engine.stats.capacity_view(), recompiles=0)
            cap.snapshot()
            slo.evaluate()
        out["plane_tick_ms"] = (time.perf_counter() - t0) * 1e2
        engine.start()
        print(f"phase 13 (a): one export (SLO and capacity tick, "
              f"OpenMetrics text and file, serve-live.json) "
              f"{out['export_ms']:.2f} ms; the SLO and capacity tick alone "
              f"{out['plane_tick_ms']:.2f} ms; {card}")

        # (b) a tenant hot-loaded over the wire, both payload forms
        gen = torch.Generator(device=device).manual_seed(SEED + 13)
        wire_cfg = dataclasses.replace(cfg, lora_rank=16,
                                       lora_alpha=WIRE_ALPHA)
        wire, merged = synthetic_lora_adapter(params, wire_cfg, gen,
                                              scale=0.3)
        check(wire["scale"] == 2.0, "the wire tenant's scale is 2.0")
        blob = encode_adapter(wire)
        store = SegmentStore("rlt-seg")
        prompt, n, _ = reqs[1]
        ref_stream = gen_mod.generate(module, merged, [prompt], n,
                                      device=device)[0, len(prompt):].tolist()
        engine.remove_adapter("tenant3")  # room in the pool
        out["wire"] = {}
        for form in ("data", "shm"):
            name = f"wire_{form}"
            item = {"type": "serve_adapter_load", "name": name, "rank": 16}
            item[form] = blob if form == "data" else store.put(blob)
            t0 = time.perf_counter()
            client._inbox.put(item)
            while name not in engine.adapter_names():
                check(time.perf_counter() - t0 < 60, f"(b) {name} loads")
                time.sleep(0.001)
            load_ms = (time.perf_counter() - t0) * 1e3
            toks, launches, steps = _counted(
                engine, lora, lambda: client.generate(
                    prompt, n, adapter=name, timeout=PLANE_TIMEOUT_S))
            ok = same_or_near_tie(torch, module, merged, prompt, toks,
                                  ref_stream, f"(b) {form}", device)
            print(f"phase 13 (b) {form}: {len(blob)} bytes loaded in "
                  f"{load_ms:.1f} ms; stream = generate() on the merged "
                  f"weights: {toks == ref_stream} (gate passed: {ok}); "
                  f"bgmv launches {launches} = {per_step} x {steps} steps")
            gate(ok, f"(b) the {form}-loaded tenant's stream")
            gate(steps >= n and (device == "cpu"
                                 or launches == per_step * steps),
                 f"(b) {form}: 2L BGMV launches a step over {n} tokens")
            if form == "shm":
                gate(not os.path.exists(item["shm"]),
                     "(b) the segment is unlinked once read")
            engine.remove_adapter(name)
            out["wire"][form] = {"bytes": len(blob), "load_ms": load_ms,
                                 "exact": toks == ref_stream,
                                 "launches": launches, "steps": steps}

        # (c) deadlines: a burst at t=0 ...
        e0 = engine.stats.counters["expired"]
        burst = [(reqs[i % len(reqs)][0][:64], BURST_NEW,
                  None if i < DECODE_W else BURST_DEADLINE_S)
                 for i in range(BURST)]
        rids = [client.submit(p, k, deadline_s=d) for p, k, d in burst]
        pends = [client._pending[r] for r in rids]
        status = {}
        for rid, pend, (_, k, d) in zip(rids, pends, burst):
            try:
                toks = client.result(rid, PLANE_TIMEOUT_S)
                status[rid] = "finished" if len(toks) == k else "short"
            except ServeRejected as e:
                status[rid] = "expired" if "expired" in str(e) else str(e)
                gate(not pend.tokens, f"(c) expired {rid} streamed nothing")
        deadlined = rids[DECODE_W:]
        expired = sum(status[r] == "expired" for r in rids)
        counted = engine.stats.counters["expired"] - e0
        print(f"phase 13 (c) burst: {BURST} requests, {DECODE_W} without a "
              f"deadline: {sum(status[r] == 'finished' for r in rids)} "
              f"finished, {expired} expired replies, the engine's counter "
              f"+{counted}")
        gate(all(status[r] == "finished" for r in rids[:DECODE_W]),
             "(c) the undeadlined requests finish")
        gate(expired == len(deadlined) == counted,
             "(c) every queued deadlined request expired, replies = counter")
        out["burst"] = {"expired": expired, "counter": counted}

        # ... and deadlined requests admitted, preempted, requeued late
        peng = ServeEngine(module, params, dataclasses.replace(
            world["serve_cfg"], num_blocks=PREEMPT_BLOCKS,
            max_model_len=PREEMPT_PROMPT + PREEMPT_NEW),
            adapters=world["tenants"], device=device)
        pclient = ServeClient(peng.queue_handle(),
                              retry=RetryPolicy(max_attempts=1))
        try:
            preqs = [(p[:PREEMPT_PROMPT], PREEMPT_NEW, a)
                     for p, _, a in reqs[:DECODE_W]]
            pwant, _ = inprocess_round(torch, ref, preqs, device)
            holder = {}

            def drive():
                holder["r"] = client_round(pclient, preqs,
                                           deadline_s=PREEMPT_DEADLINE_S)

            th = threading.Thread(target=drive)
            th.start()
            t0 = time.perf_counter()
            while peng._inbox._items.qsize() < len(preqs):
                check(time.perf_counter() - t0 < 60, "(c) requests queued")
                time.sleep(0.001)
            while th.is_alive():
                if not peng.step():
                    time.sleep(0.0005)
            th.join()
            streams, _, _, errors = holder["r"]
            pc = peng.stats.counters
            good = sum(same_or_near_tie(
                torch, module, trees[a], p, s, w, "(c) preempted", device)
                for (p, _, a), s, w in zip(preqs, streams, pwant))
            print(f"phase 13 (c) preemption: {pc['preempted']} preemptions,"
                  f" {pc['expired']} expired, {good}/{len(preqs)} streams "
                  f"equal the full pool's with each index once, "
                  f"{pclient.re_emitted_tokens} re-emitted tokens deduped; "
                  f"errors {[e for e in errors if e]}")
            gate(not any(errors) and pc["expired"] == 0,
                 "(c) no preempted request expires")
            gate(pc["preempted"] >= 1 and pclient.re_emitted_tokens > 0,
                 "(c) requests were preempted and re-emitted")
            gate(good == len(preqs), "(c) preempted streams exact")
            out["preempt"] = {"preempted": pc["preempted"],
                              "re_emitted": pclient.re_emitted_tokens,
                              "exact": good}
        finally:
            peng.stop()
            pclient.close()

        # (d) a stream cancelled by a serve_cancel frame
        prompt, n, adapter = reqs[2]
        free0 = engine.cache.allocator.free_blocks
        engine.drain_done()
        re0 = client.re_emitted_tokens
        stream = client.stream(prompt, n, adapter=adapter,
                               timeout=PLANE_TIMEOUT_S)
        got = [next(stream) for _ in range(CANCEL_AFTER)]
        rid = next(r for r, pend in client._pending.items()
                   if not pend.done.is_set())
        client._inbox.put({"type": "serve_cancel", "rid": rid})
        cancelled = False
        try:
            got.extend(stream)
        except ServeRejected as e:
            cancelled = "cancelled" in str(e)
        t0 = time.perf_counter()
        while engine.cache.allocator.free_blocks != free0 \
                and time.perf_counter() - t0 < 10:
            time.sleep(0.001)
        freed = engine.cache.allocator.free_blocks == free0
        print(f"phase 13 (d): {len(got)} of {n} tokens streamed, then "
              f"cancelled: {cancelled}; each index once and equal to the "
              f"in-process stream: {got == want[2][:len(got)]}; blocks "
              f"freed: {freed}")
        gate(cancelled and len(got) < n, "(d) the stream ends cancelled")
        gate(got == want[2][:len(got)] and client.re_emitted_tokens == re0,
             "(d) each index once, the in-process tokens")
        gate(freed and (rid, "cancelled") in engine.drain_done(),
             "(d) the slot's blocks are freed")

        # (e) the exports
        with urllib.request.urlopen(
                f"http://127.0.0.1:{prom_port}/metrics", timeout=10) as r:
            scraped = r.read().decode()
        engine.stop()
        text = open(os.path.join(tdir, "serve.prom")).read()
        live = json.load(open(os.path.join(tdir, "serve-live.json")))
        m = re.search(r'rlt_serve_requests_total\{kind="expired"\} (\d+)',
                      text)
        for label, body in (("textfile", text), ("scrape", scraped)):
            gate('rlt_serve_requests_total{kind="completed"}' in body
                 and 'rlt_serve_requests_total{kind="expired"}' in body
                 and "rlt_serve_token_latency_ms" in body,
                 f"(e) the {label} holds completed, expired and token "
                 f"latency")
        gate(m is not None and int(m.group(1)) == expired
             == live["serve"]["counters"]["expired"],
             "(e) the OpenMetrics expired line = the replies = the counter")
        spans = [json.loads(line) for line in open(
            os.path.join(tdir, "trace-serve-phase13.jsonl"))]
        by_rid = {}
        for s in spans:
            rid_ = (s.get("args") or {}).get("rid")
            by_rid.setdefault(rid_, set()).add(s["name"])
        finished = [r for r in rids if status[r] == "finished"]
        gate(all(set(TRACE_PHASES) <= by_rid.get(r, set())
                 for r in finished), "(e) a span per phase of each request")
        gate(all(("queue_wait" in by_rid.get(r, set()))
                 == (status[r] == "finished") for r in deadlined),
             "(c) a deadlined request expired iff it was never admitted")
        top = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "rlt_top.py"),
             "--once", tdir], capture_output=True, text=True, timeout=60)
        gate(top.returncode == 0 and "serve:" in top.stdout,
             "(e) rlt_top renders the serve pane")
        gate(live["serve"].get("capacity", {}).get("type")
             == "capacity_snapshot", "(e) the capacity block")
        gate(set(live.get("slo", {})) == {"serve_availability",
                                          "serve_queue_wait"},
             "(e) the SLO snapshot")
        print(f"phase 13 (e): serve-live.json keys {sorted(live)}, "
              f"{len(text.splitlines())} OpenMetrics lines (expired "
              f"{m.group(1) if m else None}), {len(spans)} spans "
              f"({sorted({s['name'] for s in spans})}); rlt_top:")
        for line in top.stdout.splitlines()[:8]:
            print(f"phase 13 (e):   {line}")
        out["spans"] = len(spans)
        out["capacity"] = live["serve"].get("capacity")
        out["slo"] = live.get("slo")
    finally:
        if child is not None:
            try:
                child.stdin.close()
                child.wait(timeout=30)
            except Exception:  # noqa: BLE001 - never leave it running
                child.kill()
                child.wait()
        if errf is not None:
            errf.close()
        client.close()
        engine.stop()
        shutil.rmtree(tdir, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 13: {out['wall_s']:.1f} s; {card}")
    check(not failed, "phase 13: " + "; ".join(failed))
    return out


# -- phase 14: disaggregated serving ------------------------------------------

FLEET_REPEATS = 1        # timed runs an arm, fleet and monolith alternating
FLEET_TIMEOUT_S = 180    # any one request through the fleet
FLEET_LOST_AFTER_S = 2.0  # the router's beat-loss threshold
KILL_AFTER = 32          # (c), (d): tokens streamed before the kill
KILL_NEW = 96            # (c), (d): new tokens a stream
KILL_TEMPS = (0.7, 0.0)  # (c), (d): one sampled stream, one greedy
# (f): a bf16 stream may leave the monolith's only where the bf16
# reference's top-2 logit gap is below one bf16 step (``bf16_ulp``) of its
# top logit, read at the divergence: two logits that close are a tie the
# bf16 trunk does not order.
# (e): the keys the JAX package's validate_router_snapshot requires of
# router-live.json's snapshot and of each member entry.
ROUTER_LIVE_KEYS = ("ts", "counters", "replicas", "workers")
ROUTER_MEMBER_KEYS = {"replicas": ("id", "alive", "inflight"),
                      "workers": ("id", "alive", "pending")}


class ClientProcess:
    """A ``chip_smoke.py --serve-client`` child on a queue handle: one
    JSON line of ``[prompt, new, adapter]`` in, the streams and the
    client's TTFT, ITL and tokens/s out."""

    def __init__(self, handle, errpath):
        self.errf = open(errpath, "w")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-client",
             handle.host, str(handle.port)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.errf, text=True, cwd=ROOT,
            env=env)

    def round(self, reqs):
        self.proc.stdin.write(json.dumps([[p, n, a] for p, n, a in reqs])
                              + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            self.errf.flush()
            tail = open(self.errf.name).read()[-2000:]
            raise RuntimeError(f"the client process ended: {tail}")
        res = json.loads(line)
        check(not any(res["errors"]), f"client errors {res['errors']}")
        return res

    def close(self):
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=30)
        except Exception:  # noqa: BLE001 - never leave it running
            self.proc.kill()
            self.proc.wait()
        self.errf.close()


def plane_config(world):
    """Phase 13's engine configuration: the server cell's with the
    capacity and SLO planes on, exported every 0.25 s."""
    return dataclasses.replace(world["serve_cfg"], capacity=True, slo=True,
                               export_every_s=0.25)


def start_fleet(world, module, device, tdir=None):
    """Two decode replicas and a prefill worker on this card behind a
    started router, the server cell's tenants registered with it."""
    from ray_lightning_tpu_torch.serve.dist import launch_inproc_fleet

    kw = {}
    if tdir is not None:
        kw = {"telemetry_dir": tdir, "export_every_s": 0.25,
              "prom_file": os.path.join(tdir, "router.prom")}
    return launch_inproc_fleet(
        module, world["params"], plane_config(world), n_replicas=2,
        n_prefill=1, adapters=world["tenants"], device=device,
        lost_after_s=FLEET_LOST_AFTER_S, **kw)


def fleet_counts(fleet):
    reps = [dict(r.engine.stats.counters) for r in fleet.replicas]
    return {"kv_imports": sum(c.get("kv_imports", 0) for c in reps),
            "prefills": sum(c.get("prefills", 0) for c in reps),
            "decode_steps": sum(c.get("decode_steps", 0) for c in reps),
            "migrations_in": sum(c.get("migrations_in", 0) for c in reps),
            "worker_prefills": sum(w.runner.prefills for w in fleet.workers)}


def release_memory(torch, device):
    import gc

    gc.collect()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def handoff_clock(torch, fleet, device, costs):
    """Time the handoff's legs over the block: the worker's prefill and
    export (each ends in a host copy), encode, the payload's bytes and
    form; a replica's read and decode of the frame, and its import
    (synchronised)."""
    from ray_lightning_tpu_torch.serve import engine as engine_mod
    from ray_lightning_tpu_torch.serve.dist import prefill as prefill_mod

    def timed(key, fn, sync=False):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync and device != "cpu":
                torch.cuda.synchronize()
            costs.setdefault(key, []).append(
                1e3 * (time.perf_counter() - t0))
            return out
        return wrapper

    encode = prefill_mod.encode_kv_payload
    make_item = prefill_mod.make_handoff_item
    imp = engine_mod.import_blocks

    def encode_counted(kv, logits):
        payload = encode(kv, logits)
        costs.setdefault("bytes", []).append(len(payload))
        return payload

    def item_counted(req, bucket, **kw):
        costs.setdefault("forms", []).append("shm" if kw.get("shm")
                                             else "data")
        return make_item(req, bucket, **kw)

    runner = fleet.workers[0].runner
    saved = [(runner.cache, "export_blocks"), (runner, "_prefill")]
    runner.cache.export_blocks = timed("export_ms",
                                       runner.cache.export_blocks)
    # The worker's prefill ends in the logits' host copy: synced.
    runner._prefill = timed("prefill_ms", runner._prefill)
    for r in fleet.replicas:
        saved.append((r.engine, "_decode_handoff"))
        r.engine._decode_handoff = timed("read_ms", r.engine._decode_handoff)
    prefill_mod.encode_kv_payload = timed("encode_ms", encode_counted)
    prefill_mod.make_handoff_item = item_counted
    engine_mod.import_blocks = timed("import_ms", imp, sync=True)
    try:
        yield
    finally:
        prefill_mod.encode_kv_payload = encode
        prefill_mod.make_handoff_item = make_item
        engine_mod.import_blocks = imp
        for owner, attr in saved:
            owner.__dict__.pop(attr, None)


def kill_round(torch, fleet, client, prompt, adapter, hard):
    """Stream KILL_TEMPS' two requests of ``prompt`` through ``fleet``
    (prefix affinity seats both on one replica), kill that replica
    (``hard``: abruptly; else a planned drain) once both have streamed
    KILL_AFTER tokens, and time the recovery as the JAX package's bench
    does: from the kill to the first fresh token after the router booked
    the failover or the migration (fresh: past what the stream held once
    every frame the victim sent had been read)."""
    import threading

    counter = "failovers" if hard else "migrations"
    streams, errors = [[], []], [None, None]

    def one(i):
        try:
            for tok in client.stream(prompt, KILL_NEW,
                                     temperature=KILL_TEMPS[i],
                                     adapter=adapter,
                                     timeout=FLEET_TIMEOUT_S):
                streams[i].append(tok)
        except Exception as e:  # noqa: BLE001 - reported per stream
            errors[i] = f"{type(e).__name__}: {e}"

    threads = []
    for i in range(2):
        threads.append(threading.Thread(target=one, args=(i,)))
        threads[-1].start()
        t0 = time.perf_counter()
        while len(client._pending) < i + 1:
            check(time.perf_counter() - t0 < 60, "the streams submit")
            time.sleep(0.001)
    rids = list(client._pending)[-2:]
    router = fleet.router
    t0 = time.perf_counter()
    while True:
        tracks = [router._inflight.get(r) for r in rids]
        pends = [client._pending.get(r) for r in rids]
        if all(t is not None and t.replica is not None for t in tracks) \
                and all(p is not None and len(p.tokens) >= KILL_AFTER
                        for p in pends):
            break
        check(time.perf_counter() - t0 < FLEET_TIMEOUT_S,
              f"both streams reach {KILL_AFTER} tokens")
        time.sleep(0.001)
    seeds = [t.req["sample_seed"] for t in tracks]
    placed = {t.replica for t in tracks}
    check(len(placed) == 1, f"both streams on one replica ({placed})")
    victim = next(r for r in fleet.replicas if r.id in placed)
    base = router.counters[counter]
    at_kill = [len(p.tokens) for p in pends]
    t_kill = time.perf_counter()
    victim.kill(hard=hard)
    while router.counters[counter] <= base:
        check(time.perf_counter() - t_kill < 60,
              f"the router books a {counter[:-1]}")
        time.sleep(0.0005)
    t_book = time.perf_counter()
    # The victim's last step still sends its tokens: the fresh tokens
    # counted below come after every frame it sent was read.
    victim._thread.join(60)
    while not client._replies.empty():
        check(time.perf_counter() - t_kill < 60, "the client reads")
        time.sleep(0.0005)
    time.sleep(0.005)
    n_base = len(pends[0].tokens)
    while len(pends[0].tokens) <= n_base and not pends[0].done.is_set():
        check(time.perf_counter() - t_kill < FLEET_TIMEOUT_S,
              "the stream resumes after the recovery")
        time.sleep(0.0005)
    ttr = time.perf_counter() - t_kill
    for th in threads:
        th.join(FLEET_TIMEOUT_S + 30)
    check(not any(th.is_alive() for th in threads), "the streams end")
    return {"streams": streams, "errors": errors, "seeds": seeds,
            "victim": victim.id, "tokens_at_kill": at_kill,
            "book_ms": 1e3 * (t_book - t_kill), "ttr_ms": 1e3 * ttr}


def reference_streams(torch, world, module, reqs, seeds, device):
    """``reqs`` = [(prompt, new, temperature, adapter)] through one engine
    driven in this thread, each with its sample seed."""
    from ray_lightning_tpu_torch.serve import ServeEngine

    eng = ServeEngine(module, world["params"], world["serve_cfg"],
                      adapters=world["tenants"], device=device)
    try:
        handles = [eng.submit(p, n, temperature=t, adapter=a,
                              sample_seed=s)
                   for (p, n, t, a), s in zip(reqs, seeds)]
        eng.run_until_idle()
        return [h.result(0) for h in handles]
    finally:
        eng.stop()


def phase_serve_fleet(torch, np, card, world, phase3=None,
                      repeats=FLEET_REPEATS, device="cuda"):
    """Phase 14: disaggregated serving on this card — two decode replicas
    and a prefill worker (``launch_inproc_fleet``) behind the router, the
    server cell's model and tenants, reached through a ``ServeClient``:
    (a) the cell's requests through the fleet from a client process, each
    stream equal to phase 3's, every admission a KV import, the BGMV run
    by the worker (2L a prefill) and the replicas (2L a tick), the
    handoff's legs timed, then FLEET_REPEATS timed runs alternating with
    phase 13's engine over the queue; (b) an imported admission equal to
    the engine's own prefill, blocks and first tokens, bitwise; (c) a
    replica killed abruptly under a sampled and a greedy stream: the
    router books a failover, both streams equal an undisturbed engine's
    with the re-emitted tokens deduped, and a replica whose beats are lost
    while its handle reads alive is declared lost; (d) as (c) with a
    planned drain: the streams migrate, nothing re-emitted; (e) the
    router's ``router-live.json`` and OpenMetrics text; (f) a bf16 fleet's
    streams equal the bf16 monolith's."""
    import shutil
    import tempfile

    from ray_lightning_tpu_torch.cluster.queue import DriverQueue
    from ray_lightning_tpu_torch.models.gpt import GPT
    from ray_lightning_tpu_torch.ops import lora
    from ray_lightning_tpu_torch.serve import (
        RetryPolicy, ServeClient, ServeEngine,
    )
    from ray_lightning_tpu_torch.serve.dist import (
        PrefillRunner, make_dispatch_item, request_fields,
    )

    t_phase = time.perf_counter()
    cfg, module, params = world["cfg"], world["module"], world["params"]
    reqs, trees, tenants = world["reqs"], world["trees"], world["tenants"]
    per_step = 2 * cfg.n_layer
    on_card = device != "cpu"
    failed = []
    out = {}

    def gate(ok, what):
        if not ok:
            print(f"phase 14: FAILED: {what}")
            failed.append(what)

    def exact_or_tie(streams, want, label, tree_module=module,
                     bf16=False):
        """Streams equal to ``want``, or leaving it first where the static
        reference's top-2 logit gap is below TOP2_GAP (``bf16``: below one
        bf16 step of the top logit)."""
        from ray_lightning_tpu_torch.models import generate as gen_mod

        good = 0
        for (p, _, a), got, ref in zip(reqs, streams, want):
            if got == ref:
                good += 1
            elif len(got) == len(ref):
                i = next(j for j, (x, y) in enumerate(zip(got, ref))
                         if x != y)
                top = top2_logits(torch, gen_mod, tree_module, trees[a],
                                  p + ref[:i], device)
                g = (top[0] - top[1]).item()
                bound = bf16_ulp(top[0].item()) if bf16 else TOP2_GAP
                print(f"phase 14 {label}: {a or 'base'} diverges at token "
                      f"{i}; the reference's top-2 gap {g:.3e}, top logit "
                      f"{top[0].item():.4f}, tie bound {bound:.3e}")
                good += g < bound
            else:
                print(f"phase 14 {label}: {len(got)} tokens, the reference "
                      f"{len(ref)}")
        return good

    def resume(engines):
        for e in engines:
            if e._thread is None:
                e.start()

    tdir = tempfile.mkdtemp(prefix="rlt-serve-fleet-")
    rdir = os.path.join(tdir, "router")
    mono = ServeEngine(module, params, plane_config(world),
                       adapters=tenants, device=device,
                       telemetry_dir=os.path.join(tdir, "mono"),
                       prom_file=os.path.join(tdir, "mono.prom"))
    fleet = client = None
    children = []
    try:
        warm = [(reqs[i][0][:32], 4, reqs[i][2]) for i in range(2)]
        for p, n, a in warm:
            mono.generate(p, n, adapter=a)
        mono.start()
        fleet = start_fleet(world, module, device, rdir)
        client = ServeClient(fleet.queue_handle(),
                             retry=RetryPolicy(max_attempts=1))
        streams, _, _, errors = client_round(client, warm)
        check(not any(errors), f"the fleet warms: {errors}")
        cf = ClientProcess(fleet.queue_handle(),
                           os.path.join(tdir, "fleet.err"))
        children.append(cf)
        cm = ClientProcess(mono.queue_handle(),
                           os.path.join(tdir, "mono.err"))
        children.append(cm)
        want = phase3["streams"] if phase3 else None

        # (a) the cell's requests through the fleet, counted and timed
        c0, r0 = fleet_counts(fleet), dict(fleet.router.counters)
        costs = {}
        lora.bgmv.launches = 0
        lora.bgmv.launches_by_rows = {}
        with handoff_clock(torch, fleet, device, costs):
            res = cf.round(reqs)
        by_rows = dict(lora.bgmv.launches_by_rows)
        total = lora.bgmv.launches
        c1, r1 = fleet_counts(fleet), dict(fleet.router.counters)
        d = {k: c1[k] - c0[k] for k in c1}
        if want is None:
            want = cm.round(reqs)["streams"]
        good = exact_or_tie(res["streams"], want, "(a)")
        exact = sum(a == b for a, b in zip(res["streams"], want))
        decode_launches = by_rows.get(DECODE_W, 0)
        worker_launches = total - decode_launches
        print(f"phase 14 (a): {exact}/{len(reqs)} fleet streams equal "
              f"phase 3's ({good} exact or at a near tie); replicas: "
              f"{d['kv_imports']} KV imports, {d['prefills']} local "
              f"prefills, {d['decode_steps']} decode ticks; worker: "
              f"{d['worker_prefills']} prefills; router: "
              f"{r1['prefill_dispatches'] - r0['prefill_dispatches']} "
              f"dispatches; bgmv launches {total} = worker {worker_launches}"
              f" (rows {sorted(k for k in by_rows if k != DECODE_W)}) + "
              f"replicas {decode_launches}")
        gate(good == len(reqs), "(a) the fleet's streams equal phase 3's")
        gate(d["kv_imports"] == len(reqs) and d["prefills"] == 0,
             "(a) every admission is a KV import")
        gate(d["worker_prefills"] == len(reqs),
             "(a) the worker prefilled every request")
        gate(not on_card or (worker_launches == per_step * len(reqs)
                             and decode_launches
                             == per_step * d["decode_steps"] > 0),
             "(a) the BGMV launched 2L times a worker prefill and a tick")
        n = len(costs.get("bytes", []))
        handoff = {k: (sum(v) / len(v) if v else None)
                   for k, v in costs.items() if k != "forms"}
        handoff["forms"] = {f: costs.get("forms", []).count(f)
                            for f in ("shm", "data")}
        handoff["handoffs"] = n
        handoff["bytes_total"] = sum(costs.get("bytes", []))
        out["handoff"] = handoff
        out["a"] = {"exact": exact, "good": good, **d,
                    "bgmv_launches": total,
                    "worker_launches": worker_launches,
                    "decode_launches": decode_launches}
        print(f"phase 14 (a) handoff: {n} handoffs, {handoff['forms']}, "
              f"{handoff['bytes_total'] / max(n, 1) / 1e6:.2f} MB each; "
              f"means: worker prefill {handoff.get('prefill_ms') or 0:.2f}"
              f" ms, export {handoff.get('export_ms') or 0:.2f} ms, "
              f"encode {handoff.get('encode_ms') or 0:.2f} ms, read "
              f"{handoff.get('read_ms') or 0:.2f} ms, import "
              f"{handoff.get('import_ms') or 0:.2f} ms; {card}")

        runs = {"fleet": [], "monolith": []}
        order = []
        for i in range(repeats):
            order += ["fleet", "monolith"] if i % 2 == 0 \
                else ["monolith", "fleet"]
        for kind in order:
            # The idle serve loops of the other arm share the GIL: halted
            # for this arm's run.
            if kind == "fleet":
                mono.halt_loop()
                resume(r.engine for r in fleet.replicas)
                res = cf.round(reqs)
            else:
                for r in fleet.replicas:
                    r.engine.halt_loop()
                resume([mono])
                res = cm.round(reqs)
            metrics = {k: res[k] for k in
                       ("ttft_p50_ms", "itl_p50_ms", "tokens_per_s")}
            exact = sum(a == b for a, b in zip(res["streams"], want))
            print(f"phase 14 (a) {kind} run: {exact}/{len(reqs)} streams "
                  f"equal phase 3's; TTFT p50 {metrics['ttft_p50_ms']:.1f}"
                  f" ms, ITL p50 {metrics['itl_p50_ms']:.2f} ms, "
                  f"{metrics['tokens_per_s']:.1f} tokens/s")
            gate(exact_or_tie(res["streams"], want, f"(a) {kind}")
                 == len(reqs), f"(a) {kind} streams equal phase 3's")
            runs[kind].append(metrics)
        mono.halt_loop()
        resume(r.engine for r in fleet.replicas)
        for kind in runs:
            if runs[kind]:
                out[kind] = summarize(runs[kind], kind, card, phase=14)
        out["profile"] = None
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            # The profiler's teardown holds the GIL for seconds, which
            # stalls every member's beats: the router must not read that
            # as deaths.
            lost_after = fleet.router.lost_after_s
            fleet.router.lost_after_s = 3600.0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                cf.round(reqs)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy = sum(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
            time.sleep(1.0)  # fresh beats from every member
            fleet.router.lost_after_s = lost_after
            out["profile"] = {"wall_ms": wall_us / 1e3,
                              "device_busy_ms": busy / 1e3,
                              "device_busy_share": busy / wall_us}
            print(f"phase 14 (a) profile: through the fleet, wall "
                  f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms"
                  f" ({100 * busy / wall_us:.1f}%); {card}")

        # (e) the router's exports (its last refresh, then the files)
        fleet.router.poll()
        fleet.router._last_export = 0.0
        fleet.router._maybe_export()
        live = json.load(open(os.path.join(rdir, "router-live.json")))
        snap = live.get("router", {})
        text = open(os.path.join(rdir, "router.prom")).read()
        missing = [k for k in ROUTER_LIVE_KEYS if k not in snap]
        for part, keys in ROUTER_MEMBER_KEYS.items():
            missing += [f"{part}.{k}" for e in snap.get(part, [])
                        for k in keys if k not in e]
        bad = [k for k, v in snap.get("counters", {}).items()
               if not isinstance(v, int) or v < 0]
        top = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "rlt_top.py"),
             "--once", rdir], capture_output=True, text=True, timeout=60)
        print(f"phase 14 (e): router-live.json keys {sorted(snap)}, missing "
              f"{missing}; {len(text.splitlines())} OpenMetrics lines; "
              f"rlt_top exit {top.returncode}")
        for line in top.stdout.splitlines()[:6]:
            print(f"phase 14 (e):   {line}")
        gate(not missing and not bad and len(snap.get("replicas", [])) == 2
             and len(snap.get("workers", [])) == 1,
             "(e) router-live.json carries validate_router_snapshot's keys")
        gate('rlt_serve_router_total{kind="routed"}' in text
             and 'rlt_serve_replica_inflight{replica="r0"}' in text
             and 'rlt_serve_prefill_alive{worker="p0"}' in text,
             "(e) the OpenMetrics router section")
        gate("rlt_capacity_fleet_replicas_reporting 2" in text,
             "(e) the OpenMetrics fleet-capacity section")
        gate(top.returncode == 0 and "router" in top.stdout,
             "(e) rlt_top renders the router pane")
        out["e"] = {"counters": snap.get("counters"),
                    "capacity": snap.get("capacity"),
                    "prom_lines": len(text.splitlines())}

        # (c) an abrupt death under two streams, then lost beats
        prompt, _, adapter = next(r for r in reqs if r[2] is not None)
        re0 = client.re_emitted_tokens
        kc = kill_round(torch, fleet, client, prompt, adapter, hard=True)
        ref = reference_streams(
            torch, world, module,
            [(prompt, KILL_NEW, t, adapter) for t in KILL_TEMPS],
            kc["seeds"], device)
        rc = dict(fleet.router.counters)
        re_c = client.re_emitted_tokens - re0
        print(f"phase 14 (c): killed {kc['victim']} at "
              f"{kc['tokens_at_kill']} tokens; failovers "
              f"{rc['failovers']}, failed over {rc['failed_over_requests']}"
              f"; streams equal the undisturbed engine's: "
              f"{[s == r for s, r in zip(kc['streams'], ref)]}; "
              f"{re_c} re-emitted tokens deduped; errors {kc['errors']}; "
              f"booked {kc['book_ms']:.1f} ms, time to recovery "
              f"{kc['ttr_ms']:.1f} ms; {card}")
        gate(rc["failovers"] >= 1 and rc["replica_deaths"] >= 1,
             "(c) the router books a failover")
        gate(not any(kc["errors"]) and kc["streams"] == ref,
             "(c) both streams equal the undisturbed engine's")
        gate(re_c > 0, "(c) the re-emitted tokens were deduped")
        survivor = next(r for r in fleet.replicas if r.is_alive())

        class _LostBeats:
            def put(self, item):
                raise ConnectionError("beats lost")

        deaths = rc["replica_deaths"]
        survivor._runner._beat_handle = _LostBeats()
        t0 = time.perf_counter()
        while fleet.router.counters["replica_deaths"] <= deaths \
                and time.perf_counter() - t0 < 5 * FLEET_LOST_AFTER_S:
            time.sleep(0.005)
        detect = time.perf_counter() - t0
        lost = fleet.router.counters["replica_deaths"] > deaths
        print(f"phase 14 (c): {survivor.id}'s beats lost, its handle alive:"
              f" declared lost {lost} after {detect:.2f} s "
              f"(lost_after_s {FLEET_LOST_AFTER_S})")
        gate(lost, "(c) beat loss declares a live-looking replica lost")
        out["c"] = {**{k: kc[k] for k in ("book_ms", "ttr_ms",
                                          "tokens_at_kill")},
                    "re_emitted": re_c, "failovers": rc["failovers"],
                    "beat_loss_detect_s": detect}
        client.close()
        client = None
        fleet.close()
        fleet = None
        release_memory(torch, device)

        # (b) an imported admission equals the engine's own prefill
        prompt, n, adapter = next(r for r in reqs if r[2] is not None)
        beats, replies = DriverQueue(), DriverQueue()
        worker = PrefillRunner("pb", module, params, world["serve_cfg"],
                               beats.handle, beat_s=3600.0, device=device)
        local = ServeEngine(module, params, world["serve_cfg"],
                            adapters=tenants, device=device)
        imp = ServeEngine(module, params, world["serve_cfg"],
                          adapters=tenants, device=device)
        try:
            worker.adapters.add(adapter, tenants[adapter])
            local.submit(prompt, n, adapter=adapter, sample_seed=0)
            local.step()
            h = imp.queue_handle()
            lora.bgmv.launches = 0
            lora.bgmv.launches_by_rows = {}
            worker._inbox.handle.put(make_dispatch_item(request_fields(
                "b", prompt, n, reply=(replies.handle.host,
                                       replies.handle.port),
                sample_seed=0, adapter=adapter), (h.host, h.port)))
            check(worker.step(timeout=60), "(b) the worker prefills")
            b_launches = lora.bgmv.launches
            t0 = time.perf_counter()
            while imp._inbox._items.qsize() < 1:
                check(time.perf_counter() - t0 < 60, "(b) the handoff lands")
                time.sleep(0.001)
            imp.step()
            nb = imp.scheduler.bucket_for(len(prompt)) \
                // world["serve_cfg"].block_size
            ids_l = local.scheduler._blocks[0][:nb]
            ids_i = imp.scheduler._blocks[0][:nb]
            diffs = [float((local._pool[k][:, ids_l].float()
                            - imp._pool[k][:, ids_i].float()).abs().max())
                     for k in ("k", "v")]
            same = all(torch.equal(local._pool[k][:, ids_l],
                                   imp._pool[k][:, ids_i])
                       for k in ("k", "v"))
            toks_l = local.scheduler.slots[0].generated
            toks_i = imp.scheduler.slots[0].generated
            print(f"phase 14 (b): {adapter} prompt of {len(prompt)} tokens "
                  f"({nb} blocks): imported blocks = the local prefill's "
                  f"bitwise: {same} (max abs diff k {diffs[0]:.3e}, v "
                  f"{diffs[1]:.3e}); first tokens {toks_i} = {toks_l}; "
                  f"worker bgmv launches {b_launches}")
            gate(same and toks_i == toks_l,
                 "(b) an import equals the local prefill, bitwise")
            gate(not on_card or b_launches == per_step,
                 "(b) the worker's prefill launched the BGMV 2L times")
            out["b"] = {"bitwise": same, "max_abs_diff": diffs,
                        "worker_launches": b_launches}
        finally:
            worker.close()
            for e in (local, imp):
                e.stop()
            beats.shutdown()
            replies.shutdown()
        del worker, local, imp
        release_memory(torch, device)

        # (d) a planned drain under two streams
        fleet = start_fleet(world, module, device)
        client = ServeClient(fleet.queue_handle(),
                             retry=RetryPolicy(max_attempts=1))
        prompt, _, adapter = next(r for r in reqs if r[2] is not None)
        kd = kill_round(torch, fleet, client, prompt, adapter, hard=False)
        ref = reference_streams(
            torch, world, module,
            [(prompt, KILL_NEW, t, adapter) for t in KILL_TEMPS],
            kd["seeds"], device)
        rd = dict(fleet.router.counters)
        mig_in = fleet_counts(fleet)["migrations_in"]
        print(f"phase 14 (d): drained {kd['victim']} at "
              f"{kd['tokens_at_kill']} tokens; router migrations "
              f"{rd['migrations']}, survivor migrations_in {mig_in}, "
              f"failovers {rd['failovers']}; streams equal the undisturbed "
              f"engine's: {[s == r for s, r in zip(kd['streams'], ref)]}; "
              f"{client.re_emitted_tokens} re-emitted; errors "
              f"{kd['errors']}; booked {kd['book_ms']:.1f} ms, time to "
              f"recovery {kd['ttr_ms']:.1f} ms; {card}")
        gate(mig_in >= 1 and rd["migrations"] >= 1,
             "(d) the survivor adopted the migrated streams")
        gate(client.re_emitted_tokens == 0 and rd["failovers"] == 0,
             "(d) nothing re-emitted, no failover")
        gate(not any(kd["errors"]) and kd["streams"] == ref,
             "(d) both streams equal the undisturbed engine's")
        out["d"] = {**{k: kd[k] for k in ("book_ms", "ttr_ms",
                                          "tokens_at_kill")},
                    "migrations": rd["migrations"], "migrations_in": mig_in}
        client.close()
        client = None
        fleet.close()
        fleet = None
        release_memory(torch, device)

        # (f) bf16: the fleet's streams against the bf16 monolith's
        module16 = GPT(cfg, precision="bf16", device=device)
        fleet = start_fleet(world, module16, device)
        client = ServeClient(fleet.queue_handle(),
                             retry=RetryPolicy(max_attempts=1))
        streams16, _, _, errors = client_round(
            client, reqs, timeout=FLEET_TIMEOUT_S)
        client.close()
        client = None
        fleet.close()
        fleet = None
        want16 = reference_streams(
            torch, world, module16, [(p, n, 0.0, a) for p, n, a in reqs],
            list(range(len(reqs))), device)
        exact16 = sum(a == b for a, b in zip(streams16, want16))
        good16 = exact_or_tie(streams16, want16, "(f) bf16",
                              tree_module=module16, bf16=True)
        print(f"phase 14 (f): bf16 fleet: {exact16}/{len(reqs)} streams "
              f"equal the bf16 monolith's ({good16} exact or at a bf16 "
              f"tie, gap < one bf16 step of the top logit); errors "
              f"{[e for e in errors if e]}")
        gate(not any(errors) and good16 == len(reqs),
             "(f) the bf16 fleet's streams equal the bf16 monolith's")
        from ray_lightning_tpu_torch.models import generate as gen_mod

        tops = [top2_logits(torch, gen_mod, module16, trees[a], p,
                            device)[0].item() for p, _, a in reqs]
        print(f"phase 14 (f): bf16 top logit at the first token "
              f"{min(tops):.4f}-{max(tops):.4f} (one bf16 step "
              f"{bf16_ulp(min(tops)):.3e}-{bf16_ulp(max(tops)):.3e})")
        out["f"] = {"exact": exact16, "good": good16,
                    "first_top_logit": [min(tops), max(tops)]}
    finally:
        for c in children:
            c.close()
        if client is not None:
            client.close()
        if fleet is not None:
            fleet.close()
        mono.stop()
        shutil.rmtree(tdir, ignore_errors=True)
        release_memory(torch, device)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 14: {out['wall_s']:.1f} s; {card}")
    check(not failed, "phase 14: " + "; ".join(failed))
    return out



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


# -- phases 15-19: one driver process, one set of workers --------------------
#
# Each of phases 15-19 is a generator of three stages (``run_staged``):
# before the spawn it yields what it needs, ``({pool: workers}, [its own
# strategies])``; sent the spawned pools, it runs its remote arms and
# yields; then, the workers gone, it runs its references and checks in
# the driver (CUDA from there on) and returns its result.  So the remote
# arms of every phase run before the driver touches the card, and every
# worker is spawned and warmed up once, all at once.

MULTI_PHASES = (15, 16, 17, 18, 19)


def kept_strategy(strategy_cls, pool, n, **kw):
    """``strategy_cls`` over the first ``n`` workers of ``pool`` (their
    warm-up paid once for the run), on the pool's device; a fit's
    teardown leaves them to the pool."""
    s = strategy_cls(num_workers=n, timeout_s=300.0, device=pool.device,
                     **kw)
    s._backend, s._workers = pool._backend, pool._workers[:n]
    s.teardown = lambda: None
    return s


def multi_pools(need, device="cuda"):
    """The shared workers, unspawned: ``need`` maps a pool to its worker
    count.  "nccl": one rank on the card for the one-rank worlds; "gloo":
    ranks on ``device`` for the gloo worlds; "cpu": CPU ranks."""
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.parallel.strategies import RayStrategy

    one = {"OMP_NUM_THREADS": "1"}
    pools = {}
    if need.get("nccl"):
        pools["nccl"] = RayStrategy(
            num_workers=need["nccl"], timeout_s=300.0,
            init_hook=functools.partial(helpers.warm_up, "cuda"))
    if need.get("gloo"):
        pools["gloo"] = RayStrategy(
            num_workers=need["gloo"], backend="gloo", device=device,
            timeout_s=300.0, env_per_worker=one,
            init_hook=functools.partial(helpers.warm_up, device))
    if need.get("cpu"):
        pools["cpu"] = RayStrategy(
            num_workers=need["cpu"], backend="gloo", device="cpu",
            timeout_s=300.0, env_per_worker=one,
            init_hook=functools.partial(helpers.warm_up, "cpu"))
    return pools


def run_staged(gens, device="cuda"):
    """Run the staged phases ``gens`` ({phase: generator}): their needs
    spawned at once, every remote stage, the workers torn down, the
    driver checked off the card, then every check stage.  Returns
    {phase: result, "spawn_s": seconds}; each result's ``wall_s`` is its
    two stages' seconds."""
    import torch

    asks = {n: next(g) for n, g in gens.items()}
    card = card_line()
    need = {}
    for want, _ in asks.values():
        for pool, n in want.items():
            need[pool] = max(need.get(pool, 0), n)
    pools = multi_pools(need, device)
    spawn = [*pools.values(), *(s for _, own in asks.values() for s in own)]
    walls = dict.fromkeys(gens, 0.0)
    out = {}
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max(len(spawn), 1)) as spawner:
            for f in [spawner.submit(s.setup) for s in spawn]:
                f.result()
        out["spawn_s"] = time.perf_counter() - t0
        print(f"phases {', '.join(map(str, gens))}: "
              f"{sum(s.num_workers for s in spawn)} workers "
              f"({json.dumps({k: p.num_workers for k, p in pools.items()})}"
              f" shared, {sum(len(own) for _, own in asks.values())} "
              f"strategies of their own) spawned and warmed up at once in "
              f"{out['spawn_s']:.1f} s")
        for n, g in gens.items():
            t = time.perf_counter()
            g.send(pools)
            walls[n] += time.perf_counter() - t
    finally:
        for s in spawn:
            s.teardown()
    check(not torch.cuda.is_initialized(), f"the driver ran the remote "
          f"fits of phases {tuple(gens)} with CUDA never initialised")
    torch.backends.cuda.matmul.allow_tf32 = False
    for n, g in gens.items():
        t = time.perf_counter()
        try:
            next(g)
        except StopIteration as stop:
            out[n] = stop.value
        else:
            raise RuntimeError(f"chip_smoke: phase {n} has a fourth stage")
        walls[n] += time.perf_counter() - t
        out[n]["wall_s"] = walls[n]
        print(f"phase {n}: wall {walls[n]:.1f} s (remote arms and checks, "
              f"the shared spawn apart); {card}")
    return out


def staged_main(n, gen, device="cuda") -> int:
    """One staged phase alone (``chip_smoke.py --phaseN``): its lines,
    then its result with the spawn's seconds as one JSON line."""
    out = run_staged({n: gen}, device)
    print(json.dumps({**out[n], "spawn_s": out["spawn_s"]}, default=str))
    return 0


# -- phase 15: multi-GPU training --------------------------------------------

P15_FLAVORS = ("ray", "horovod", "zero1", "zero3")
# Phases 15-19 (but phase 18 (a), the captured megastep, at GPT-2-small's
# 12 layers) train GPT-2-small's width at this depth: the script's time
# limit is shared by every phase, and a rank's collectives, memory and
# launches scale with the layers they hold against one rank at the same
# depth (4 layers until phase 19 took the script's wall near the limit).
P15_LAYERS = 2
P15_STEPS_A, P15_STEPS_B = 8, 3
# Per-step losses of a two-rank gloo arm against the one-device fit on the
# same global batch: the first step's forward sees the same params, and
# the ranks' mean over their halves is the mean over the whole batch up to
# f32 rounding; the later steps' params differ by the bf16-rounded
# gradients' sum order (each rank rounds its half's gradient to bf16
# before the f32 all-reduce), 1.2e-5 at step 3 in the first run on the
# card.  The final params are held by the bf16 measures leaf by leaf
# where a leaf starts away from zero (the matrices and the LN gains), and
# over the whole model by its relative Frobenius distance: a bias starts
# at zero, so it is its updates, and AdamW's first steps move each of its
# elements by ~lr whichever way the gradient's sign goes, a sign that the
# bf16 rounding flips where the gradient is near zero.  So every vector
# leaf (each bias and each LN gain, whose updates the bf16 measures of
# its value, ~1, cannot see) is held by its update instead: the worst
# leaf's ‖Δgot − Δref‖ / ‖Δref‖, Δ the final params less the initial
# ones.  Its limit lies between the sound arms' reading, 8.9e-2 (on
# ``qkv_b``, whose key third has no gradient but rounding noise, a
# query's scores being blind to a shift of every key; the other leaves
# <= 3.8e-3), and that of a planted fault that leaves the replicated
# leaves unsynced, 0.506 on ``ln_f_b`` (``chip_faults.py`` step 13,
# ``zero_replicated_unsynced``, which every other check passes; PERF.md).
P15_LOSS_TOL = (1e-5, 2e-4, 2e-4)
P15_UPDATE_LIMIT = 0.2
# The clip check (phase 15 (e)): the CPU test's narrow GPT in f32 on two
# CPU workers against one rank, the only difference the ranks' halves
# summed by gloo (its tolerances, tests/test_torch_strategies.py).
P15_CLIP_TOL = {"loss": 1e-6, "param": 5e-7}


def p15_strategy(flavor, pool, workers, **kw):
    """The strategy of ``flavor`` over the first ``workers`` of ``pool``
    (``kept_strategy``)."""
    from ray_lightning_tpu_torch.parallel import strategies as st

    cls, extra = {"ray": (st.RayStrategy, {}),
                  "horovod": (st.HorovodRayStrategy, {}),
                  "zero1": (st.RayShardedStrategy, {"zero_stage": 1}),
                  "zero3": (st.RayShardedStrategy, {"zero_stage": 3})}[flavor]
    return kept_strategy(cls, pool, workers, **extra, **kw)


def p15_fit(strategy, cfg, steps, label, root, precision="bf16",
            gpt_kw=HEADLINE, module_cls=None, data=None, batch=TRAIN_B,
            callbacks=()):
    """A Trainer fit of ``steps`` eager steps through ``strategy`` with
    the probe of ``label`` (``torch_dist_helpers.StepProbe``) and
    ``callbacks``."""
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import GPT, SyntheticLMDataModule

    tr = Trainer(strategy, max_steps=steps, limit_val_batches=0,
                 precision=precision, seed=SEED, megastep="off",
                 log_every_n_steps=1, enable_checkpointing=False,
                 default_root_dir=str(root),
                 callbacks=[helpers.StepProbe(label), *callbacks])
    module = (module_cls or GPT)(cfg, **gpt_kw)
    tr.fit(module, data or SyntheticLMDataModule(
        cfg, batch_size=batch, num_batches=steps, seed=SEED))
    return tr


def p15_state_bytes(cfg, flavor, world, update_sharding=False):
    """The state a rank holds once set up, by the ZeRO leaf rule: f32
    params, bf16 mu and f32 nu (the family's default), each sharded leaf
    cut to 1/world under ZeRO (the moments under stage 1 and under the
    sharded weight update, the params too under stage 3)."""
    from ray_lightning_tpu_torch.parallel.sharding import shard_leaf_spec

    L, d, V, T = cfg.n_layer, cfg.d_model, cfg.vocab_size, cfg.seq_len
    h = cfg.mlp_ratio * d
    shapes = [(V, d), (T, d), (d,), (d,)] + [
        (L, d), (L, d), (L, d, 3 * d), (L, 3 * d), (L, d, d), (L, d),
        (L, d), (L, d), (L, d, h), (L, h), (L, h, d), (L, d)]
    total = 0
    for shape in shapes:
        n = math.prod(shape)
        sharded = ((flavor.startswith("zero") or update_sharding)
                   and shard_leaf_spec(shape, world) is not None)
        part = n // world if sharded else n
        total += (part if flavor == "zero3" else n) * 4 + part * (2 + 4)
    return total


def p15_host_params(tr):
    return {k: v.detach().cpu() for k, v in by_path(tr.state.params).items()}


def p15_ms(rec):
    """The median step wall time past the first step, ms."""
    steps = sorted(rec["step_s"][1:] or rec["step_s"])
    return 1e3 * steps[len(steps) // 2]


P15_ARMS = tuple(f"{arm}_{f}" for arm in "ab" for f in P15_FLAVORS) + (
    "e_zero1", "e_zero3")


def nccl_probe_main(argv) -> int:
    """``chip_smoke.py --nccl-probe RANK PORT``: one of two ranks joining an
    NCCL group on card 0 and trying one ``all_reduce``; prints one JSON
    line of what happened (phase 15 (f): why ``backend="nccl"`` refuses
    more ranks than cards)."""
    import datetime

    import torch
    import torch.distributed as dist

    rank, port = int(argv[0]), int(argv[1])
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    x = torch.ones(8, device="cuda")
    try:
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out = {"rank": rank, "ok": True, "sum": float(x[0])}
    except Exception as e:  # noqa: BLE001 - the refusal is the reading
        out = {"rank": rank, "ok": False, "error": str(e)}
    out["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))
    print(json.dumps(out), flush=True)
    os._exit(0)


def nccl_probe_start():
    from ray_lightning_tpu_torch.cluster.rpc import find_free_port

    port = find_free_port("127.0.0.1")
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--nccl-probe", str(rank), str(port)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, cwd=ROOT) for rank in (0, 1)]


def nccl_probe_read(procs, card):
    """Phase 15 (f): what NCCL says of two ranks on one card."""
    readings = []
    for proc in procs:
        try:
            stdout, _ = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, _ = proc.communicate()
        lines = stdout.strip().splitlines()
        readings.append(json.loads(lines[-1]) if lines else
                        {"ok": None, "error": f"exit {proc.returncode}"})
    refused = [r for r in readings if r.get("ok") is False]
    why = refused[0]["error"] if refused else "accepted"
    last = [ln for ln in why.splitlines() if ln.strip()][-1:] or [why]
    print(f"phase 15 (f): NCCL {readings[0].get('nccl')} with two ranks "
          f"on one card: {'refused' if refused else 'NOT refused'} at the "
          f"first all_reduce: {last[0][:200]}; gloo took all_reduce and "
          f"broadcast (b ray, horovod), reduce_scatter_tensor and "
          f"all_gather_into_tensor (b zero1, zero3) on CUDA tensors; {card}")
    check(len(refused) == 2, "NCCL refuses two ranks on one card (the "
          "reason backend='nccl' refuses more ranks than cards)")
    return {"nccl_two_ranks_one_card": last[0][:300]}


def phase15_main(arms=P15_ARMS) -> int:
    """Phase 15 alone (``chip_smoke.py --phase15 [arm ...]``, every arm of
    ``P15_ARMS`` by default): its lines, then one JSON object as its last
    line."""
    return staged_main(15, phase15_steps(arms))


def phase15_steps(arms=P15_ARMS):
    """Phase 15's stages (``run_staged``): (a) one rank over NCCL a
    flavor, 8 steps, bitwise against ``LocalStrategy``; (b) two ranks
    sharing the card over gloo a flavor, 3 steps, against
    ``LocalStrategy`` on the same global batch; (c) each rank's memory;
    (d) each rank's kernel launches a step; (e) the clip under ZeRO with
    forged gradient scales (``torch_dist_helpers.SCALES``), on two CPU
    workers at the CPU test's size; (f) with every arm, two raw NCCL ranks
    on card 0 (``--nccl-probe``), which NCCL must refuse."""
    import tempfile

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    unknown = set(arms) - set(P15_ARMS)
    check(not unknown, f"phase 15 arms {sorted(unknown)} in {P15_ARMS}")
    card = card_line()
    root = tempfile.mkdtemp(prefix="rlt-p15-")
    # The trainer cell at P15_LAYERS, its warmup cut to one step so that
    # steps 2 and 3 train at the full learning rate.
    cfg = dataclasses.replace(GPTConfig.gpt2_small(), warmup_steps=1,
                              n_layer=P15_LAYERS)
    clip_cfg = GPTConfig(vocab_size=256, n_layer=2, n_head=4, d_model=64,
                         seq_len=32, warmup_steps=2, mu_dtype="float32")
    clip_data = helpers.scaled_batches(256, 32, 8, 3, seed=5)
    setups = {
        "a": dict(cfg=cfg, steps=P15_STEPS_A, workers=1, pool="nccl",
                  kw={}),
        "b": dict(cfg=cfg, steps=P15_STEPS_B, workers=2, pool="gloo",
                  kw={"backend": "gloo"}),
        "e": dict(cfg=clip_cfg, steps=3, workers=2, pool="cpu",
                  kw={"backend": "gloo"}, local={"device": "cpu"},
                  fit={"precision": "f32", "gpt_kw": {"device": "cpu"},
                       "module_cls": helpers.ScaledGPT,
                       "data": helpers.ArraysDataModule(clip_data, 8)}),
    }
    want = per_step_launches(cfg.n_layer, remat=True)
    out = {"card": card, "a": {}, "b": {}, "e": {}}
    params = {}
    # The arms' fits run one after another on the shared workers, whose
    # init_hook (``torch_dist_helpers.warm_up``) imported the port's model
    # and, on the card, ran one small step through the kernels; each fit
    # is left the rendezvous and the state's build.  Two raw NCCL ranks
    # probe the card during the spawn (f).
    need = {}
    for label in arms:
        st = setups[label.split("_")[0]]
        need[st["pool"]] = max(need.get(st["pool"], 0), st["workers"])
    probes = nccl_probe_start() if arms == P15_ARMS else None
    pools = yield need, []
    if probes is not None:
        out["f"] = nccl_probe_read(probes, card)
    for label in arms:
        arm, flavor = label.split("_")
        st = setups[arm]
        strategy = p15_strategy(flavor, pools[st["pool"]], st["workers"],
                                **st["kw"])
        t0, w0 = time.perf_counter(), time.time()
        tr = p15_fit(strategy, st["cfg"], st["steps"], label, root,
                     **st.get("fit", {}))
        w1 = time.time()
        check(tr.strategy.backend == ("nccl" if arm == "a" else "gloo"),
              f"{label}: the backend asked for")
        params[label] = p15_host_params(tr)
        r0 = helpers.RECORDS[label][0]
        # The wall split: the task shipped, rendezvous and the state's
        # build before the fit's first hook; the steps; the gather, the
        # state stream and its adoption after its last.
        # Which update ran: "auto" keeps the ray flavor's replicated over
        # gloo (core/loop.py::_resolve_update_sharding).
        shard = tr.telemetry_report.get("meta", {}).get("update_sharding")
        out[arm][flavor] = {"wall_s": time.perf_counter() - t0,
                            "before_fit_s": r0["fit_start"] - w0,
                            "fit_s": r0["fit_end"] - r0["fit_start"],
                            "after_fit_s": w1 - r0["fit_end"],
                            "update_sharding": shard}
        del tr
    yield

    # The references, in this process (CUDA from here on).
    rec = helpers.RECORDS
    for arm in sorted({label[0] for label in arms}):
        st = setups[arm]
        tr = p15_fit(LocalStrategy(**st.get("local", {})), st["cfg"],
                     st["steps"], f"{arm}_local", root, **st.get("fit", {}))
        params[f"{arm}_local"] = p15_host_params(tr)
        del tr
        local = rec[f"{arm}_local"][0]
        print(f"phase 15 ({arm}): LocalStrategy {st['steps']} steps: "
              f"{p15_ms(local):.2f} ms/step, setup "
              f"{local['setup_bytes'] / 2**30:.3f} GiB, peak "
              f"{local['peak_bytes'] / 2**30:.3f} GiB, losses "
              f"{local['losses']}; {card}")
    for label in arms:
        arm, flavor = label.split("_")
        st = setups[arm]
        ranks, local = rec[label], rec[f"{arm}_local"][0]
        check(sorted(ranks) == list(range(st["workers"])),
              f"{label}: every rank reports ({sorted(ranks)})")
        got, ref = params[label], params[f"{arm}_local"]
        r0 = ranks[0]
        res = out[arm][flavor]
        res.update({"ms": p15_ms(r0), "local_ms": p15_ms(local),
                    "losses": r0["losses"], "local_losses": local["losses"]})
        if arm == "e":
            dl = max(abs(a - b) for a, b in zip(r0["losses"],
                                                local["losses"]))
            dp = max(float((got[k] - ref[k]).abs().max()) for k in ref)
            res.update({"loss_diff": dl, "param_diff": dp})
            print(f"phase 15 (e) {flavor}: the clip under ZeRO, forged loss "
                  f"scales {helpers.SCALES}, the CPU test's GPT in f32 on "
                  f"two CPU workers vs one rank: "
                  f"losses {r0['losses']}, worst loss diff {dl:.3e}, params "
                  f"{dp:.3e} (limits {P15_CLIP_TOL}); {card}")
            check(dl <= P15_CLIP_TOL["loss"]
                  and dp <= P15_CLIP_TOL["param"],
                  f"(e) {flavor}: the clipped updates equal the one-device "
                  f"fit's")
            continue
        for rank, v in sorted(ranks.items()):
            per_step = {k: n / st["steps"] for k, n in v["launches"].items()}
            pred = p15_state_bytes(cfg, flavor, st["workers"],
                                   res["update_sharding"] == "on")
            res.setdefault("ranks", {})[rank] = {
                "setup_bytes": v["setup_bytes"], "predicted_bytes": pred,
                "peak_bytes": v["peak_bytes"],
                "launches_per_step": per_step}
            print(f"phase 15 (c, d) {label} rank {rank} on {v['device']}: "
                  f"setup {v['setup_bytes'] / 2**30:.3f} GiB (predicted "
                  f"state {pred / 2**30:.3f} GiB, ratio "
                  f"{v['setup_bytes'] / pred:.3f}), peak "
                  f"{v['peak_bytes'] / 2**30:.3f} GiB (LocalStrategy "
                  f"{local['peak_bytes'] / 2**30:.3f}); launches a step "
                  f"{per_step}")
            check(per_step == want, f"(d) {label} rank {rank}: launches a "
                  f"step {per_step} == {want}")
        if arm == "a":
            differ = [k for k in ref if not torch.equal(ref[k], got[k])]
            same = r0["losses"] == local["losses"]
            res["bitwise"] = same and not differ
            print(f"phase 15 (a) {flavor}: 1 rank over NCCL, "
                  f"{cfg.n_layer} layers, "
                  f"{st['steps']} steps: params {len(ref) - len(differ)}/"
                  f"{len(ref)} leaves bitwise equal to LocalStrategy's, "
                  f"losses {'bitwise equal' if same else 'differ'}; "
                  f"{p15_ms(r0):.2f} ms/step (LocalStrategy "
                  f"{p15_ms(local):.2f}); wall {res['wall_s']:.1f} s; "
                  f"{card}")
            check(not differ, f"(a) {flavor}: params bitwise {differ[:3]}")
            check(same, f"(a) {flavor}: losses bitwise {r0['losses']} vs "
                  f"{local['losses']}")
            continue
        diffs = [abs(a - b) for a, b in zip(r0["losses"], local["losses"])]
        worst = {"row": 0.0, "frob": 0.0, "bias": 0.0}
        for k in ref:
            if k.endswith("_b']"):
                continue  # zero-init: held by its update below
            m = bf16_measures(torch, got[k], ref[k])
            worst = {n: max(worst[n], m[n]) for n in worst}
        sq = sum(float((got[k] - ref[k]).double().square().sum())
                 for k in ref)
        model_frob = math.sqrt(sq / sum(float(ref[k].double().square().sum())
                                        for k in ref))
        init = local["init_vectors"]
        check(bool(init) and set(init) <= set(ref),
              f"(b) {flavor}: the initial vector leaves {sorted(init)[:3]}")
        updates = {k: float((got[k].double() - ref[k].double()).norm()
                            / (ref[k].double() - v.double()).norm())
                   for k, v in init.items()}
        upd_key = max(updates, key=updates.get)
        res.update({"loss_diffs": diffs, "param_measures": worst,
                    "model_frob": model_frob, "vector_updates": updates})
        print(f"phase 15 (b) {flavor}: 2 ranks sharing the card over gloo "
              f"(through host memory, not NCCL), {cfg.n_layer} layers, "
              f"update sharding "
              f"{res['update_sharding']}, 8 x 1024 rows a rank, "
              f"{st['steps']} steps: losses {r0['losses']} (diffs "
              f"{', '.join(f'{d:.2e}' for d in diffs)}; tolerances "
              f"{P15_LOSS_TOL}); final params: worst bf16 measures of a "
              f"matrix or gain {({k: f'{v:.2e}' for k, v in worst.items()})}"
              f", the whole model's relative Frobenius distance "
              f"{model_frob:.2e}, the worst vector leaf's update distance "
              f"{updates[upd_key]:.3e} ({upd_key}; limit "
              f"{P15_UPDATE_LIMIT}); "
              f"{p15_ms(r0):.1f} ms/step (LocalStrategy "
              f"{p15_ms(local):.2f}); wall {res['wall_s']:.1f} s; {card}")
        check(all(d <= t for d, t in zip(diffs, P15_LOSS_TOL)),
              f"(b) {flavor}: losses within {P15_LOSS_TOL}: {diffs}")
        check(all(worst[k] <= BF16_LIMITS[k] for k in worst)
              and model_frob <= BF16_LIMITS["frob"],
              f"(b) {flavor}: params within {BF16_LIMITS}: {worst}, "
              f"{model_frob}")
        check(updates[upd_key] <= P15_UPDATE_LIMIT,
              f"(b) {flavor}: vector leaves' updates within "
              f"{P15_UPDATE_LIMIT}: {upd_key} {updates[upd_key]}")
    for label in arms:
        arm, flavor = label.split("_")
        w = out[arm][flavor]
        print(f"phase 15 {label}: wall {w['wall_s']:.1f} s = "
              f"{w['before_fit_s']:.1f} s to the first hook (the task "
              f"shipped, rendezvous, the state) + "
              f"{w['fit_s']:.1f} s of fit "
              f"+ {w['after_fit_s']:.1f} s after (gather, state stream, "
              f"adoption)")
    return out


# -- phase 16: the data-parallel gradient wire --------------------------------

P16_STEPS = 3
P16_SEGMENTS = 2
# Per-step losses against arm (a), relative: the JAX tests' bounds for the
# int8 wire with error feedback and without (tests/test_grad_sync.py,
# tests/test_grad_overlap.py); the sharded update (f) within phase 15's
# absolute P15_LOSS_TOL.
P16_EF_REL, P16_INT8_REL = 0.01, 0.10
P16_MIN_RATIO = 3.5           # full-width bytes over the int8 wire's
P16_OVERLAP_BYTES = 0.02      # (d)'s bytes against (c)'s
# (g): the side stream held back before the taps' chain (~200 ms at the
# H100's 1.98 GHz, far longer than the host takes to issue the backward),
# so a read that does not wait for it finds the plane's buffers unwritten.
# A first, unheld run sets up NCCL's communicator (~1 s that blocks the
# host inside the first tap: a hold taken then would have run out before
# the read; with a 10 ms hold in that run a step that skipped the wait
# passed once on the card).
P16_HOLD_CYCLES = 400_000_000
# arm -> (strategy, its keyword arguments, relative loss bound or None for
# P15_LOSS_TOL); (a)-(d) keep the replicated update, which "auto" would
# shard on the card, so that each isolates its wire.
P16_FITS = {
    "a_full": ("ray", {"update_sharding": "off"}, 0.0),
    "b_int8": ("ray", {"grad_comm": "int8", "update_sharding": "off"},
               P16_INT8_REL),
    "c_int8_ef": ("ray", {"grad_comm": "int8_ef",
                          "update_sharding": "off"}, P16_EF_REL),
    "d_int8_ef_overlap": ("ray", {"grad_comm": "int8_ef",
                                  "update_sharding": "off",
                                  "grad_overlap_segments": P16_SEGMENTS},
                          P16_EF_REL),
    "e_zero1_int8_ef": ("zero1", {"grad_comm": "int8_ef"}, P16_EF_REL),
    "f_update_sharding": ("ray", {"update_sharding": "on"}, None),
}
P16_ARMS = tuple(P16_FITS) + ("g_nccl", "h_cpu_wire")
# The sharded update's cost traced (``--phase16 p_full p_update_sharding``,
# not run by default): the fit of (a) and of (f), PROFILE_STEP profiled on
# both ranks and cut into its parts (``torch_dist_helpers.StepSplit``).
P16_PROFILES = {"p_full": "a_full", "p_update_sharding": "f_update_sharding"}
P16_PROFILE_STEP = 2
# (h): the CPU tests' narrow GPT on three CPU ranks over gloo.
P16_WIRE_CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64,
                    seq_len=32, warmup_steps=2, mu_dtype="float32")


def p16_wire_payload():
    """(h)'s payload for ``torch_dist_helpers.wire_rank``: the narrow
    GPT's params from the port's seeded init (numpy), three batches of 6
    rows, random partials at n = 2 and 3."""
    import numpy as np
    import torch

    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
    from ray_lightning_tpu_torch.models.optim import tree_map

    params = GPT(GPTConfig(**P16_WIRE_CFG), device="cpu").init_params(
        torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    return {
        "block_size": 256, "bucket_bytes": 4 * 2 ** 20,
        "cfg": P16_WIRE_CFG, "tree": tree_map(lambda t: t.numpy(), params),
        "modes": ["int8", "int8_ef"], "segments": P16_SEGMENTS,
        "partials": {n: (rng.standard_normal((n, n * 256 * 6))
                         * np.logspace(-3, 2, n * 256 * 6)).astype(
                             np.float32) for n in (2, 3)},
        "batches": [rng.integers(0, 256, size=(6, 33)).astype(np.int32)
                    for _ in range(3)],
    }


def p16_nccl_side_stream(card):
    """(g): the taps' sync at one rank over NCCL on the side stream, at
    GPT-2-small's overlap plan (G = 2, the default 4 MiB buckets): random
    cotangents through the ``TapPlane`` of a real backward, the side
    stream held back first, then the plane's buffers read after
    ``finish()`` as a step reads them, and the gradient tree put
    together; every bucket bitwise against ``int8_all_reduce_reference``
    (reduced and error, the residual row added), the residual row
    likewise.  A run before it sets up NCCL; one after it, unheld, times
    the backward's sync."""
    import torch
    import torch.distributed as dist

    from ray_lightning_tpu_torch.cluster.rpc import find_free_port
    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
    from ray_lightning_tpu_torch.models.optim import tree_leaves, tree_map
    from ray_lightning_tpu_torch.ops.collective_quant import (
        int8_all_reduce_reference,
    )
    from ray_lightning_tpu_torch.parallel import overlap as ovl
    from ray_lightning_tpu_torch.parallel.grad_sync import GradCommConfig
    from ray_lightning_tpu_torch.parallel.pipeline import layer_splits

    port = find_free_port("127.0.0.1")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    out = {}
    try:
        cfg = GPTConfig.gpt2_small()
        module = GPT(cfg)
        gen = torch.Generator("cuda").manual_seed(SEED)
        params = module.init_params(gen)
        wire = GradCommConfig("int8_ef")
        oplan = ovl.build_overlap_plan(
            module.grad_overlap_groups(params, P16_SEGMENTS), 1,
            wire.bucket_bytes, wire.block_size)
        cot = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                             device="cuda"), params)
        resid = 1e-3 * torch.randn(oplan.total_padded, generator=gen,
                                   device="cuda")
        # The plain version: each group's buckets, packed as the wire
        # packs them, the residual's slice added.
        want = torch.zeros(oplan.total_padded, device="cuda")
        want_resid = torch.zeros_like(want)
        for grp, leaves in zip(oplan.groups,
                               ovl.split_groups(cot, oplan).values()):
            for b in grp.plan.buckets:
                flat = torch.cat([leaves[i].reshape(-1) for i in b.indices])
                flat = torch.nn.functional.pad(flat, (0, b.padded - b.size))
                at = grp.resid_offset + b.offset
                red, err = int8_all_reduce_reference(
                    [flat + resid[at:at + b.padded]], wire.block_size)[0]
                want[at:at + b.padded] = red
                want_resid[at:at + b.padded] = err
        # The same buffer as the tree a step reads: entry leaves its views,
        # trunk leaves their segments' rows put together.
        want_tree = ovl.join_groups(cot, oplan, {
            grp.name: ovl._leaf_views(
                want[grp.resid_offset:
                     grp.resid_offset + grp.plan.total_padded],
                grp.plan, [t.shape for t in leaves],
                [t.dtype for t in leaves])
            for grp, leaves in zip(oplan.groups, ovl.split_groups(
                cot, oplan).values())})
        side = torch.cuda.Stream()

        def run(hold):
            plane = ovl.TapPlane(oplan, 1, True, torch.device("cuda"),
                                 resid_row=resid, side_stream=side)
            leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
            tapped = plane.apply_entry_taps(leaves)
            bounds = layer_splits(cfg.n_layer, P16_SEGMENTS)
            loss = sum((tapped[k] * cot[k]).sum() for k in tapped
                       if k != "blocks")
            for g in range(P16_SEGMENTS):
                b, e = bounds[g], bounds[g + 1]
                sub = plane.tap(f"seg{g}", {k: v[b:e] for k, v in
                                            leaves["blocks"].items()})
                loss = loss + sum((sub[k] * cot["blocks"][k][b:e]).sum()
                                  for k in sub)
            plane.check_consumed()
            if hold:
                with torch.cuda.stream(side):
                    torch.cuda._sleep(P16_HOLD_CYCLES)
            start, end = torch.cuda.Event(True), torch.cuda.Event(True)
            start.record()
            torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
            parts, new_resid = plane.finish()
            # Read as a step reads: the buffers, then the tree.
            same = (torch.equal(plane.synced, want)
                    and torch.equal(new_resid, want_resid))
            grads = ovl.join_groups(leaves, oplan, parts)
            end.record()
            same = same and all(torch.equal(g, w) for g, w in zip(
                tree_leaves(grads), tree_leaves(want_tree)))
            torch.cuda.synchronize()
            return same, start.elapsed_time(end)

        warm, _ = run(False)
        held, held_ms = run(True)
        free, free_ms = run(False)
        buckets = [b.padded for g in oplan.groups for b in g.plan.buckets]
        out = {"bitwise_held": held, "bitwise": free, "ms": free_ms,
               "held_ms": held_ms, "buckets": len(buckets),
               "elements": oplan.total_padded,
               "bucket_elements": sorted(set(buckets))}
        print(f"phase 16 (g): 1 rank over NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, "
              f"the taps' sync on a side stream at GPT-2-small's overlap "
              f"plan (G = {P16_SEGMENTS}: {len(oplan.groups)} groups, "
              f"{len(buckets)} buckets of {sorted(set(buckets))} elements, "
              f"{oplan.total_padded} in all): synced gradients and the "
              f"residual row bitwise the plain version's: held side stream "
              f"{held}, unheld {free}; the backward with its sync "
              f"{free_ms:.2f} ms ({held_ms:.2f} held); {card}")
        check(warm and held and free, "(g) the NCCL side-stream sync "
              "equals int8_all_reduce_reference bitwise")
    finally:
        dist.destroy_process_group()
    return out


def p16_cpu_wire(strategy, card):
    """(h): ``torch_dist_helpers.wire_rank`` on three CPU ranks over gloo,
    then on two of them, each a world of its own: the collective and each
    ``GradSync`` step (int8, int8_ef) bitwise against the plain version
    applied to the ranks' own partials of ``loss / n``, and the taps
    (G = 2) bitwise against the step-end sync over the same plan."""
    import torch_dist_helpers as helpers

    ranks = helpers.wire_worlds(strategy._workers, p16_wire_payload(), 300)
    out = {}
    for n in (3, 2):
        res = ranks[n]
        out[n] = {
            "collective": all(x["collective_equal"] for x in res),
            "sync": {m: all(s["ref_equal"] for x in res for s in x[m])
                     for m in ("int8", "int8_ef")},
            "overlap": all(x["overlap_equal"] for x in res)}
        print(f"phase 16 (h): {n} CPU ranks over gloo, the narrow GPT: "
              f"collective = plain {out[n]['collective']}, GradSync = "
              f"plain on the ranks' partials {out[n]['sync']}, taps = "
              f"step-end {out[n]['overlap']}; {card}")
        check(out[n]["collective"] and all(out[n]["sync"].values())
              and out[n]["overlap"], f"(h) the CPU wire at n = {n}")
    return out


def phase16_main(arms=P16_ARMS) -> int:
    """Phase 16 alone (``chip_smoke.py --phase16 [arm ...]``): its lines,
    then one JSON object as its last line."""
    return staged_main(16, phase16_steps(arms))


def phase16_steps(arms=P16_ARMS):
    """Phase 16's stages (``run_staged``): the fits (a)-(f) of
    ``P16_FITS``, each two ranks sharing the card over gloo, GPT-2-small's
    width, P16_STEPS steps on the same global batch, their losses against
    (a), the ranks' final params bitwise equal, the wire's accounting and
    each arm's ms/step; (h) the CPU wire checks; then (g) in the driver
    over NCCL."""
    import tempfile

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.models.gpt import GPTConfig

    unknown = set(arms) - set(P16_ARMS) - set(P16_PROFILES)
    check(not unknown, f"phase 16 arms {sorted(unknown)} in {P16_ARMS} "
          f"or {tuple(P16_PROFILES)}")
    fits = [a for a in arms if a in P16_FITS]
    profiles = [a for a in arms if a in P16_PROFILES]
    check(not fits or "a_full" in fits, "phase 16's fits need arm a_full")
    card = card_line()
    root = tempfile.mkdtemp(prefix="rlt-p16-")
    cfg = dataclasses.replace(GPTConfig.gpt2_small(), warmup_steps=1,
                              n_layer=P15_LAYERS)
    out = {"card": card, "fits": {}}
    need = {"gloo": 2} if fits or profiles else {}
    if "h_cpu_wire" in arms:
        need["cpu"] = 3
    pools = yield need, []
    for label in fits:
        t0 = time.perf_counter()
        flavor, kw, _ = P16_FITS[label]
        probes = ([helpers.WireProbe(label + "_wire")]
                  if "grad_comm" in kw else [])
        tr = p15_fit(p15_strategy(flavor, pools["gloo"], 2, backend="gloo",
                                  **kw), cfg, P16_STEPS, label, root,
                     callbacks=[helpers.FinalDigest(label + "_digest"),
                                *probes])
        meta = tr.telemetry_report.get("meta", {})
        out["fits"][label] = {
            "wall_s": time.perf_counter() - t0,
            "comm_stats": dict(tr.comm_stats),
            "update_sharding": meta.get("update_sharding"),
            "grad_overlap_segments": meta.get("grad_overlap_segments")}
        del tr
    for label in profiles:
        flavor, kw, _ = P16_FITS[P16_PROFILES[label]]
        tr = p15_fit(p15_strategy(flavor, pools["gloo"], 2, backend="gloo",
                                  **kw), cfg, P16_PROFILE_STEP + 2,
                     label, root, callbacks=[helpers.StepSplit(
                         label + "_split", P16_PROFILE_STEP)])
        out.setdefault("profiles", {})[label] = {
            "update_sharding": tr.telemetry_report.get(
                "meta", {}).get("update_sharding")}
        del tr
    if "h_cpu_wire" in arms:
        out["h"] = p16_cpu_wire(pools["cpu"], card)
    yield

    rec = helpers.RECORDS
    ref = rec["a_full"][0]["losses"] if fits else None
    for label in fits:
        _, kw, bound = P16_FITS[label]
        res = out["fits"][label]
        digests = {r["digest"] for r in rec[label + "_digest"].values()}
        ranks = rec[label]
        losses = ranks[0]["losses"]
        ms = p15_ms(ranks[0])
        if bound is None:
            diffs = [abs(a - b) for a, b in zip(losses, ref)]
            ok = all(d <= t for d, t in zip(diffs, P15_LOSS_TOL))
            limit = f"absolute {P15_LOSS_TOL}"
        else:
            diffs = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
            ok = all(d <= bound for d in diffs)
            limit = f"relative {bound}"
        stats = res["comm_stats"]
        res.update({"losses": losses, "loss_diffs": diffs, "ms": ms,
                    "ranks_bitwise": len(digests) == 1,
                    "rank_ms": {r: p15_ms(v) for r, v in ranks.items()}})
        wire = stats.get("grad_sync_mode", "full")
        ratio = stats.get("grad_sync_compression_ratio")
        print(f"phase 16 ({label[0]}) {label}: 2 ranks sharing the card "
              f"over gloo, GPT-2-small's width at {cfg.n_layer} layers, "
              f"bf16, 8 x 1024 rows a rank, "
              f"{P16_STEPS} steps: wire {wire}, update sharding "
              f"{res['update_sharding']}, overlap segments "
              f"{res['grad_overlap_segments']}; losses {losses} (diffs "
              f"against (a) {', '.join(f'{d:.2e}' for d in diffs)}, "
              f"{limit}); ranks' final params bitwise equal "
              f"{len(digests) == 1}; bytes a step "
              f"{stats.get('grad_sync_bytes')} of "
              f"{stats.get('grad_sync_bytes_full_width')} (ratio {ratio}, "
              f"{stats.get('grad_sync_buckets')} buckets); {ms:.1f} ms/step"
              f" (ranks {', '.join(f'{v:.1f}' for v in res['rank_ms'].values())}); wall "
              f"{res['wall_s']:.1f} s; {card}")
        check(len(ranks) == 2 and len(digests) == 1,
              f"({label}) the two ranks' final params bitwise equal")
        check(ok, f"({label}) losses within {limit} of (a): {diffs}")
        want_us = "on" if kw.get("update_sharding") == "on" else "off"
        check(res["update_sharding"] == want_us,
              f"({label}) update sharding {res['update_sharding']}")
        if "grad_comm" in kw:
            check(wire == kw["grad_comm"] and ratio >= P16_MIN_RATIO,
                  f"({label}) the {kw['grad_comm']} wire at ratio >= "
                  f"{P16_MIN_RATIO}: {stats}")
            # The wire inside the fit (torch_dist_helpers.WireProbe): on
            # every call each rank's probed bucket bitwise the plain
            # version on the ranks' gathered inputs, and under EF each
            # residual slice handed in the one the previous step wrote.
            probe = rec[label + "_wire"]
            ef = kw["grad_comm"] == "int8_ef"
            res["wire_probe"] = probe
            print(f"phase 16 ({label[0]}) {label}: the wire in the fit, "
                  f"each rank's smallest bucket a call against "
                  f"int8_all_reduce_reference: "
                  + "; ".join(f"rank {r}: {c['equal']}/{c['calls']} calls "
                              f"bitwise, residual threaded "
                              f"{c['threaded']}/{c['thread_checks']}"
                              for r, c in sorted(probe.items())))
            check(len(probe) == 2 and all(
                c["calls"] >= P16_STEPS and c["equal"] == c["calls"]
                and c["threaded"] == c["thread_checks"]
                and (c["thread_checks"] > 0) == ef
                for c in probe.values()),
                f"({label}) the wire in the fit equals its plain version "
                f"and threads its residual: {probe}")
    if "d_int8_ef_overlap" in out["fits"] and "c_int8_ef" in out["fits"]:
        c = out["fits"]["c_int8_ef"]["comm_stats"]["grad_sync_bytes"]
        d = out["fits"]["d_int8_ef_overlap"]["comm_stats"][
            "grad_sync_bytes"]
        print(f"phase 16 (d): the taps' bytes a step {d} against the "
              f"step-end sync's {c} ({(d - c) / c:+.3%}; limit "
              f"{P16_OVERLAP_BYTES:.0%}); {card}")
        check(abs(d - c) <= P16_OVERLAP_BYTES * c, "(d) bytes within 2% "
              "of (c)")
    for label in profiles:
        res = out["profiles"][label]
        res["ranks"] = helpers.RECORDS[label + "_split"]
        for r, rec in sorted(res["ranks"].items()):
            sp = rec["split"]
            print(f"phase 16 ({label}) step {P16_PROFILE_STEP} of "
                  f"{P16_PROFILES[label]} traced on rank {r} (update "
                  f"sharding {res['update_sharding']}; each part "
                  f"synchronised at its edges): wall {rec['wall_ms']:.1f} "
                  f"ms = forward+backward {sp['grads']:.1f} + collectives "
                  f"{sp['collectives']:.1f} + update {sp['update']:.1f} + "
                  f"bucket copies {sp['copies']:.1f} + logs' mean "
                  f"{sp['mean_logs']:.1f} + host gaps {sp['gaps']:.1f}; "
                  f"ranges {json.dumps({k: round(v, 2) for k, v in rec['ms'].items()})}"
                  f", calls {json.dumps(rec['calls'])}; profiler device "
                  f"kernels {rec['device_kernel_ms']:.1f} ms, host-device "
                  f"copies {rec['device_copy_ms']:.1f} ms; {card}")
        check(len(res["ranks"]) == 2 and all(
            rec["device_kernel_ms"] > 0 for rec in res["ranks"].values()),
            f"({label}) both ranks traced, with device time")
    if "g_nccl" in arms:
        out["g"] = p16_nccl_side_stream(card)
    return out


# -- phase 17: restarts on the card -------------------------------------------

P17_EPOCHS, P17_PER_EPOCH = 3, 2
# (b): each rank's shard file against the two together (the JAX
# multi-worker test's bound), and each rank's selective read of the
# checkpoint it resumed against that checkpoint's shard files.
P17_FILE_SHARE = 0.75
P17_READ_SHARE = (0.4, 0.6)


def p17_fit(strategy, cfg, root, label, epochs=P17_EPOCHS,
            per_epoch=P17_PER_EPOCH, callbacks=(), device="cuda",
            **trainer_kw):
    """A Trainer fit of GPT-2-small (the headline kernels, bf16) through
    ``strategy``, ``per_epoch`` batches of TRAIN_B x TRAIN_T an epoch, its
    per-step losses (``LossLog``, whose state rides a restart
    checkpoint), the epochs trained (``EpochRecorder``, likewise), and
    each rank's checkpoint reads and first step (``LoadStatsProbe``)."""
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import GPT, SyntheticLMDataModule

    log, rec = helpers.LossLog(), helpers.EpochRecorder()
    tr = Trainer(strategy, max_epochs=epochs, limit_train_batches=per_epoch,
                 limit_val_batches=0, precision="bf16", seed=SEED,
                 megastep="off", log_every_n_steps=1,
                 enable_checkpointing=False, default_root_dir=str(root),
                 callbacks=[log, rec, helpers.LoadStatsProbe(label),
                            *callbacks], **trainer_kw)
    t0 = time.perf_counter()
    tr.fit(GPT(cfg, device=device, **HEADLINE), SyntheticLMDataModule(
        cfg, batch_size=TRAIN_B, num_batches=per_epoch, seed=SEED))
    return {"trainer": tr, "losses": log.losses, "epochs": rec.epochs,
            "wall_s": time.perf_counter() - t0}


def p17_shard_bytes(tag):
    """Each rank's shard-file bytes of a checkpoint directory."""
    names = sorted(n for n in os.listdir(tag)
                   if n.startswith("shard-") and n.endswith(".ckpt"))
    return [os.path.getsize(os.path.join(tag, n)) for n in names]


def p17_counter(tr, name):
    """A counter of the fit's telemetry, summed over its ranks."""
    return sum(r.get("counters", {}).get(name, 0)
               for r in tr.telemetry_report.get("per_rank", []))


def phase17_main(device="cuda", cfg=None) -> int:
    """Phase 17 alone (``chip_smoke.py --phase17``): its lines, then one
    JSON object as its last line.  ``device="cpu"`` and a small ``cfg``
    rehearse it on the CPU (its one-rank fits then over gloo)."""
    return staged_main(17, phase17_steps(device, cfg), device)


def phase17_steps(device="cuda", cfg=None):
    """Phase 17's stages (``run_staged``), the crash fit on workers of its
    own (its restart kills and respawns them): GPT-2-small's width at
    ``P15_LAYERS`` layers, bf16, the kernels on, TRAIN_B x TRAIN_T rows a
    step.  (a) ``RayShardedStrategy(num_workers=2, zero_stage=3,
    max_restarts=1)`` over gloo (two ranks sharing the card), 3 epochs of
    2 steps, rank 1 killed at the start of epoch 1
    (``torch_dist_helpers.CrashOnce``), beside the same fit uninterrupted
    with an explicit ``restart_dir`` that is kept: one restart, the epochs
    [0, 1, 2], every per-step loss and the final params and moments
    bitwise, the scratch directory gone; the seconds from the death to the
    resumed first step, each rank's shard bytes, the write time an epoch,
    each resumed rank's reads.  (b) each rank's file under 0.75 of the
    two, each resumed rank's selective read about half the checkpoint's
    bytes, the full reassembly of the newest kept checkpoint bitwise the
    gathered state.  (c) the oldest kept checkpoint resumed on one NCCL
    rank (accum 1 -> 2, the resize warned and counted, finite losses); a
    two-rank ``grad_comm="int8_ef"`` checkpoint (two layers at full width)
    resumed at one rank drops its residual loudly."""
    import tempfile

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.models.convert import train_state_from_jax
    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.parallel import strategies as st
    from ray_lightning_tpu_torch.utils import sharded_ckpt

    card = card_line()
    root = tempfile.mkdtemp(prefix="rlt-p17-")
    cfg = cfg or dataclasses.replace(GPTConfig.gpt2_small(), warmup_steps=1,
                                     n_layer=P15_LAYERS)
    warned = os.path.join(root, "worker-warnings.txt")
    one_rank = "nccl" if device == "cuda" else "gloo"
    # The crash fit kills and respawns its workers, so they are its own;
    # the other fits run on the shared workers, which tee their warnings
    # to ``warned`` from this phase on, as the crash fit's do.
    crash = st.RayShardedStrategy(
        num_workers=2, zero_stage=3, backend="gloo", max_restarts=1,
        restart_backoff_s=0.5, device=device, timeout_s=300.0,
        init_hook=functools.partial(helpers.warm_up, device, warned),
        env_per_worker=({} if device == "cuda"
                        else {"OMP_NUM_THREADS": "1"}))
    need = {"gloo": 2, **({"nccl": 1} if one_rank == "nccl" else {})}
    out = {"card": card}
    kept = os.path.join(root, "kept")
    ef_dir = os.path.join(root, "ef")
    marker = os.path.join(root, "crash-marker")
    pools = yield need, [crash]
    for pool in {pools["gloo"], pools[one_rank]}:
        for w in pool._workers:
            w.execute(functools.partial(helpers.tee_warnings, warned))
    gloo, one = pools["gloo"], pools[one_rank]
    crash = p17_fit(crash, cfg, root, "p17_crash",
                    callbacks=[helpers.CrashOnce(marker)],
                    device=device)
    straight = p17_fit(
        kept_strategy(st.RayShardedStrategy, gloo, 2, zero_stage=3,
                      backend="gloo", max_restarts=1),
        cfg, root, "p17_straight", restart_dir=kept, device=device)
    tags = sorted(os.listdir(kept))
    oldest = os.path.join(kept, tags[0])
    nm = p17_fit(kept_strategy(st.RayStrategy, one, 1, backend=one_rank),
                 cfg, root, "p17_nm", resume_from_checkpoint=oldest,
                 device=device)
    # The residual's drop needs no depth: two layers at full width.
    ef_cfg = dataclasses.replace(cfg, n_layer=min(cfg.n_layer, 2))
    p17_fit(kept_strategy(st.RayStrategy, gloo, 2, backend="gloo",
                          grad_comm="int8_ef", update_sharding="off"),
            ef_cfg, root, "p17_ef", epochs=1, per_epoch=1,
            restart_dir=ef_dir, device=device)
    ef_tag = os.path.join(ef_dir, "restart-epoch-000000.ckpt")
    ef_one = p17_fit(kept_strategy(st.RayStrategy, one, 1, backend=one_rank,
                                   grad_comm="int8_ef"),
                     ef_cfg, root, "p17_ef_one", epochs=2, per_epoch=1,
                     resume_from_checkpoint=ef_tag, device=device)
    yield

    # (a) the restart.
    tc, ts = crash["trainer"], straight["trainer"]
    with open(marker) as f:
        died = float(f.read())
    resumed = helpers.RECORDS["p17_crash"]
    recover_s = min(r["first_step"] for r in resumed.values()) - died
    check(all(r["resumed"] for r in resumed.values()),
          "(a) the crash fit's last attempt resumed on every rank")
    differ = [k for k, v in by_path(ts.state.params).items()
              if not torch.equal(v, by_path(tc.state.params)[k])]
    differ_opt = [k for k, v in by_path(ts.state.opt_state).items()
                  if not torch.equal(v, by_path(tc.state.opt_state)[k])]
    sizes = p17_shard_bytes(os.path.join(kept, tags[-1]))
    state_bytes = sum(t.numel() * t.element_size() for t in
                      by_path((ts.state.params, ts.state.opt_state)).values())
    writes = p17_counter(ts, "restart_checkpoint_writes")
    write_s = p17_counter(ts, "restart_checkpoint_write_s")
    reads = {r: v["load_stats"] for r, v in sorted(resumed.items())}
    leftovers = [d for d in os.listdir(root) if d.startswith(".rlt-restart-")]
    kinds = [e["kind"] for e in tc.recovery_events]
    out["a"] = {"restarts_used": tc.strategy.restarts_used,
                "epochs": crash["epochs"], "losses": crash["losses"],
                "straight_losses": straight["losses"],
                "params_differ": differ, "opt_differ": differ_opt,
                "recover_s": recover_s, "shard_bytes": sizes,
                "state_bytes": state_bytes,
                "write_s_per_epoch_per_rank": write_s / max(writes, 1),
                "reads": reads, "events": kinds,
                "wall_s": crash["wall_s"], "straight_wall_s":
                straight["wall_s"]}
    verdict = ("bitwise" if crash["losses"] == straight["losses"]
               else "DIFFER")
    print(f"phase 17 (a): ZeRO-3 on 2 gloo ranks sharing the card, "
          f"GPT (d {cfg.d_model}, {cfg.n_layer} layers, vocab "
          f"{cfg.vocab_size}) bf16, {TRAIN_B} x {cfg.seq_len} rows a step, "
          f"{P17_EPOCHS} epochs of {P17_PER_EPOCH} steps, rank 1 killed at "
          f"epoch 1: restarts_used {tc.strategy.restarts_used}, events "
          f"{kinds}, epochs {crash['epochs']}; losses {crash['losses']} vs "
          f"uninterrupted {straight['losses']} "
          f"({verdict}"
          f"); params {len(differ)} leaves differ, moments "
          f"{len(differ_opt)}; from the death to the resumed first step "
          f"{recover_s:.2f} s; wall {crash['wall_s']:.1f} s (uninterrupted "
          f"{straight['wall_s']:.1f} s); {card}")
    print(f"phase 17 (a): each rank's shard file {sizes} bytes of a state of "
          f"{state_bytes} bytes ({sum(sizes) / state_bytes:.4f}x); "
          f"{writes:.0f} restart writes, {1e3 * write_s / max(writes, 1):.1f}"
          f" ms a write a rank; the resumed ranks read {reads}; {card}")
    check(tc.strategy.restarts_used == 1, "(a) restarts_used == 1")
    check(crash["epochs"] == straight["epochs"] == [0, 1, 2],
          f"(a) the epochs {crash['epochs']}, {straight['epochs']}")
    check(len(crash["losses"]) == P17_EPOCHS * P17_PER_EPOCH
          and crash["losses"] == straight["losses"],
          "(a) the per-step losses bitwise the uninterrupted fit's")
    check(not differ and not differ_opt,
          f"(a) final params and moments bitwise: {differ[:3]} "
          f"{differ_opt[:3]}")
    check(not leftovers, f"(a) the scratch directory is gone: {leftovers}")

    # (b) the layout.
    newest = os.path.join(kept, tags[-1])
    ckpt_bytes = sum(p17_shard_bytes(oldest))
    shares = {r: v["bytes_read"] / ckpt_bytes for r, v in reads.items()}
    t0 = time.perf_counter()
    full = train_state_from_jax(sharded_ckpt.load_sharded(newest)["state"])
    load_s = time.perf_counter() - t0
    same = (all(torch.equal(v, by_path(full.params)[k])
                for k, v in by_path(ts.state.params).items())
            and all(torch.equal(v, by_path(full.opt_state)[k])
                    for k, v in by_path(ts.state.opt_state).items()))
    out["b"] = {"file_shares": [b / sum(sizes) for b in sizes],
                "read_shares": shares, "full_equal": same,
                "full_read_s": load_s}
    shares_txt = [f"{b / sum(sizes):.4f}" for b in sizes]
    print(f"phase 17 (b): each rank's file {shares_txt} "
          f"of the two (limit {P17_FILE_SHARE}); each resumed rank read "
          f"{ {r: f'{v:.4f}' for r, v in shares.items()} } of the "
          f"checkpoint's shard bytes (limits {P17_READ_SHARE}), selectively "
          f"{ {r: v['selective'] for r, v in reads.items()} }; the full "
          f"reassembly of {tags[-1]} ({load_s:.2f} s on the host) bitwise "
          f"the gathered state: {same}; {card}")
    check(all(b < P17_FILE_SHARE * sum(sizes) for b in sizes),
          f"(b) each rank's file under {P17_FILE_SHARE} of the two")
    check(all(v["selective"] for v in reads.values())
          and all(P17_READ_SHARE[0] < v < P17_READ_SHARE[1]
                  for v in shares.values()),
          f"(b) each rank read about half the checkpoint: {shares}")
    check(same, "(b) the full reassembly equals the gathered state")

    # (c) N -> M.
    tn = nm["trainer"]
    with open(warned) as f:
        lines = f.read().splitlines()
    resize_lines = [ln for ln in lines if "elastic resume: checkpoint from "
                    "world size 2 (accum 1) resuming on 1 with accum 2" in ln]
    resize_events = [(e["kind"], e["old_world"], e["new_world"])
                     for e in tn.recovery_events]
    finite = all(math.isfinite(x) for x in nm["losses"])
    nm_read = helpers.RECORDS["p17_nm"][0]["load_stats"]
    out["c"] = {"losses": nm["losses"], "global_step": tn.global_step,
                "micro_step": tn.micro_step,
                "elastic_resizes": p17_counter(tn, "elastic_resizes"),
                "events": resize_events, "backend": tn.strategy.backend,
                "read": nm_read}
    print(f"phase 17 (c): {tags[0]} (2 ZeRO-3 ranks) resumed on 1 "
          f"{one_rank} rank: "
          f"the warning {len(resize_lines)} time(s), elastic_resizes "
          f"{out['c']['elastic_resizes']}, events {resize_events}; "
          f"global_step {tn.global_step}, micro_step {tn.micro_step} (epoch "
          f"2 at accum 2); losses {nm['losses'][-P17_PER_EPOCH:]}; read "
          f"{nm_read}; {card}")
    check(tn.strategy.backend == one_rank, f"(c) one {one_rank} rank")
    check(nm_read["selective"], "(c) the resize's resume read selectively "
          "(its accum crossed 1)")
    check(len(resize_lines) >= 1 and out["c"]["elastic_resizes"] == 1
          and resize_events == [("resize", 2, 1)],
          "(c) the resize warned, counted and booked")
    check((tn.global_step, tn.micro_step) == (
        straight["trainer"].global_step - P17_PER_EPOCH + 1,
        P17_EPOCHS * P17_PER_EPOCH),
        f"(c) counters at accum 2: {tn.global_step}, {tn.micro_step}")
    check(finite, f"(c) finite losses {nm['losses']}")
    header, _ = sharded_ckpt._read_shard_header(os.path.join(
        ef_tag, "shard-00001-of-00002.ckpt"))
    resid = header["leaves"][-1]
    dropped = p17_counter(ef_one["trainer"], "grad_residual_dropped")
    ef_read = helpers.RECORDS["p17_ef_one"][0]["load_stats"]
    drop_lines = [ln for ln in lines if "error-feedback residual has shape"
                  in ln]
    out["c"]["ef"] = {"residual_shape": resid["s"],
                      "residual_index": resid["e"][0]["i"],
                      "grad_residual_dropped": dropped,
                      "losses": ef_one["losses"], "read": ef_read}
    print(f"phase 17 (c): an int8_ef checkpoint of 2 ranks (rank 1's "
          f"residual row at {resid['e'][0]['i']} of {resid['s']}) resumed "
          f"at 1 rank: grad_residual_dropped {dropped}, the warning "
          f"{len(drop_lines)} time(s) ({drop_lines[:1]}); losses "
          f"{ef_one['losses']}; read {ef_read}; {card}")
    print(f"phase 17 (c): the int8_ef pair at {ef_cfg.n_layer} layers of "
          f"width {ef_cfg.d_model}")
    check(resid["s"][0] == 2 and resid["e"][0]["i"][0] == [1, 2],
          "(c) the residual rows written at their index")
    check(dropped == 1 and drop_lines, "(c) the residual dropped loudly")
    check(ef_read["selective"], "(c) the int8_ef resume read selectively "
          "(a residual on one side only)")
    check(all(math.isfinite(x) for x in ef_one["losses"]),
          "(c) the int8_ef resume's losses are finite")
    return out


# -- phase 18: the rest of multi-GPU training ---------------------------------

P18_K = 8
# (a): an eager stride, the captured one (replayed at once), one replay.
P18_STEPS = 3 * P18_K
P18_ARMS = ("a_megastep", "b_int8_zero", "c_hybrid", "d_island")
P18_HYBRID = {"data": 2, "fsdp": 2}
# (b): each dequantized moment leaf against the replicated-update fit's,
# relative Frobenius: the two fits differ only by the clip's norm, summed a
# slice at a time under ZeRO (a payload element on a rounding boundary may
# take the neighbouring step), where a leaf whose replicated scale went
# unsynced reads ~1 (half its blocks scaled by 1.0).
P18_MOMENT_REL = 1e-2
# (d): the island's tokens a rank (its share of TRAIN_B x TRAIN_T) at
# GPT-2-small's width and padded vocabulary, f32 (the kernels' f32 route);
# loss and dwte relative to the one-rank CE's, dx absolute against its
# largest element.
P18_ISLAND = {"B": TRAIN_B // 2, "T": TRAIN_T, "d": D_MODEL, "V": VOCAB}
P18_ISLAND_TOL = 1e-5


def p18_fit(strategy, cfg, steps, label, root, megastep="off",
            callbacks=(), batch=TRAIN_B, device="cuda"):
    """A bf16 fit of GPT-2-small's kernels (HEADLINE) through ``strategy``
    (a ``kept_strategy``'s workers outlive the fit), with ``StepProbe(label)`` and
    ``FinalDigest(label + "_digest")``."""
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import GPT, SyntheticLMDataModule

    tr = Trainer(strategy, max_steps=steps, limit_val_batches=0,
                 precision="bf16", seed=SEED, megastep=megastep,
                 log_every_n_steps=1, enable_checkpointing=False,
                 default_root_dir=str(root),
                 callbacks=[helpers.StepProbe(label),
                            helpers.FinalDigest(label + "_digest"),
                            *callbacks])
    tr.fit(GPT(cfg, device=device, **HEADLINE), SyntheticLMDataModule(
        cfg, batch_size=batch, num_batches=steps, seed=SEED))
    return tr


def p18_graph_counts(nodes):
    """A captured graph's training kernels (``GRAPH_NAMES``) and NCCL
    kernels among its nodes (``GraphProbe``'s mangled names)."""
    counts = {k: 0 for k in GRAPH_NAMES}
    nccl = 0
    for mangled, n in nodes.items():
        if "nccl" in mangled.lower():
            nccl += n
            continue
        name = kernel_name(mangled)
        for k, want in GRAPH_NAMES.items():
            if name.startswith(want):
                counts[k] += n
    return counts, nccl


def p18_megastep(pools, cfg, root, card, out):
    """(a): K = P18_K on a one-rank NCCL world, GPT-2-small at 12 layers,
    bf16: ``RayStrategy`` and ``RayShardedStrategy(zero_stage=3)`` each
    captured against its eager fit (losses at the strides' ends and the
    final params bitwise); the graph's collectives, kernel nodes and
    memory.  The captured ``RayStrategy`` against ``LocalStrategy``
    captured comes after the remote arms (:func:`p18_megastep_local`)."""
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.parallel.strategies import (
        RayShardedStrategy, RayStrategy,
    )

    for flavor, cls, kw in (("ray", RayStrategy, {}),
                            ("zero3", RayShardedStrategy,
                             {"zero_stage": 3})):
        for mode, k in (("eager", "off"), ("captured", P18_K)):
            label = f"p18_{flavor}_{mode}"
            t0 = time.perf_counter()
            tr = p18_fit(kept_strategy(cls, pools["nccl"], 1, **kw), cfg,
                         P18_STEPS, label, root, megastep=k,
                         callbacks=[helpers.GraphProbe(label + "_graph")])
            out[label] = {"wall_s": time.perf_counter() - t0,
                          "megastep": tr.telemetry_report.get(
                              "meta", {}).get("megastep"),
                          "backend": tr.strategy.backend}
            del tr


def p18_megastep_check(cfg, card, out):
    import torch_dist_helpers as helpers

    rec = helpers.RECORDS
    want = {k: P18_K * v for k, v in per_step_launches(
        cfg.n_layer, True).items()}
    res = {}
    for flavor in ("ray", "zero3"):
        eager, cap = (f"p18_{flavor}_eager", f"p18_{flavor}_captured")
        e, c = rec[eager][0], rec[cap][0]
        ge, gc = rec[eager + "_graph"][0], rec[cap + "_graph"][0]
        same = (rec[eager + "_digest"][0]["digest"]
                == rec[cap + "_digest"][0]["digest"])
        losses_same = c["losses"] == e["losses"][P18_K - 1::P18_K]
        # Collectives a step: between the eager fit's first and last step
        # ends; the captured fit's first stride eager, its second issued
        # into the graph, its third a replay (none issued).
        m = ge["marks"]
        per_step = (m[-1]["eager"] - m[0]["eager"]) / (len(m) - 1)
        mc = gc["marks"]
        captured_calls = mc[1]["captured"] - mc[0]["captured"]
        replay_calls = (mc[2]["eager"] + mc[2]["captured"]
                        - mc[1]["eager"] - mc[1]["captured"])
        counts, nccl = (p18_graph_counts(gc["graphs"][0]) if gc["graphs"]
                        else ({}, 0))
        eager_ms = 1e3 * sorted(e["step_s"][1:])[len(e["step_s"][1:]) // 2]
        cap_ms = 1e3 * c["step_s"][-1] / P18_K
        res[flavor] = {
            "bitwise_params": same, "bitwise_losses": losses_same,
            "captures": len(gc["graphs"]), "eager_ms_per_step": eager_ms,
            "captured_ms_per_step": cap_ms,
            "collectives_per_step_eager": per_step,
            "collectives_captured": captured_calls,
            "graph_kernels": counts, "graph_nccl_nodes": nccl,
            "peak_bytes": {"eager": ge["peak_bytes"],
                           "captured": gc["peak_bytes"]},
            "reserved_bytes": {"eager": ge["reserved_bytes"],
                               "captured": gc["reserved_bytes"]},
            "megastep": out[cap]["megastep"], "backend": out[cap]["backend"]}
        print(f"phase 18 (a) {flavor}: one NCCL rank, GPT-2-small "
              f"{cfg.n_layer} layers bf16, {P18_STEPS} steps, K {P18_K}: "
              f"captures {len(gc['graphs'])}; captured vs eager params "
              f"bitwise {same}, stride-end losses bitwise {losses_same} "
              f"({c['losses']}); {cap_ms:.2f} ms/step captured (the "
              f"replay stride) vs {eager_ms:.2f} eager; collectives a step "
              f"{per_step:g} eager, {captured_calls} captured into the "
              f"stride's graph; graph kernel nodes {counts} (want "
              f"{want}), NCCL nodes {nccl}; peak "
              f"{gc['peak_bytes'] / 2**30:.3f} GiB captured vs "
              f"{ge['peak_bytes'] / 2**30:.3f} eager, reserved "
              f"{gc['reserved_bytes'] / 2**30:.3f} vs "
              f"{ge['reserved_bytes'] / 2**30:.3f} GiB; {card}")
        check(out[cap]["backend"] == "nccl" and out[cap]["megastep"] == P18_K,
              f"(a) {flavor}: megastep {P18_K} over NCCL")
        check(len(gc["graphs"]) == 1 and not ge["graphs"],
              f"(a) {flavor}: one capture, none eager")
        check(same and losses_same, f"(a) {flavor}: captured bitwise eager")
        check(len(m) == P18_STEPS and len(mc) == P18_STEPS // P18_K,
              f"(a) {flavor}: a step end a step, a stride end a stride")
        check(per_step == int(per_step) and per_step > 0
              and captured_calls == P18_K * per_step
              and mc[0]["eager"] == P18_K * per_step and replay_calls == 0,
              f"(a) {flavor}: every step's collectives in the graph "
              f"({captured_calls} vs {P18_K} x {per_step}; the replay "
              f"issued {replay_calls})")
        check(counts == want, f"(a) {flavor}: graph kernels {counts} == "
              f"{want}")
    return res


def p18_megastep_local(cfg, root, card, res):
    """(a), in this process after the remote arms: ``LocalStrategy``
    captured, against the captured one-rank ``RayStrategy``."""
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    p18_fit(LocalStrategy(), cfg, P18_STEPS, "p18_local_captured", root,
            megastep=P18_K)
    rec = helpers.RECORDS
    same = (rec["p18_local_captured_digest"][0]["digest"]
            == rec["p18_ray_captured_digest"][0]["digest"])
    losses = (rec["p18_local_captured"][0]["losses"]
              == rec["p18_ray_captured"][0]["losses"])
    res["ray"]["bitwise_local_captured"] = same and losses
    print(f"phase 18 (a) ray: captured one-rank RayStrategy against "
          f"LocalStrategy captured: params bitwise {same}, losses bitwise "
          f"{losses}; {card}")
    check(same and losses, "(a) captured RayStrategy bitwise LocalStrategy "
          "captured")


def p18_int8(pools, cfg, root, out, device="cuda"):
    """(b): int8 moments under ZeRO-1 and ZeRO-3 and the replicated update
    (the reference), two gloo ranks sharing the card."""
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.parallel.strategies import (
        RayShardedStrategy, RayStrategy,
    )

    icfg = dataclasses.replace(cfg, opt_state_dtype="int8")
    for label, cls, kw in (
            ("p18_int8_rep", RayStrategy, {"update_sharding": "off"}),
            ("p18_int8_zero1", RayShardedStrategy, {"zero_stage": 1}),
            ("p18_int8_zero3", RayShardedStrategy, {"zero_stage": 3})):
        probes = ([helpers.PlanProbe(label + "_plan")]
                  if "zero" in label else [])
        tr = p18_fit(kept_strategy(cls, pools["gloo"], 2, backend="gloo",
                                   **kw),
                     icfg, P16_STEPS, label, root, callbacks=probes,
                     device=device)
        out[label] = {"opt": p18_moments(tr.state.opt_state)}
        del tr


def p18_moments(opt_state):
    """An optimizer state's leaves by key path, each int8 moment
    dequantized."""
    from ray_lightning_tpu_torch.models.optim import _map_adam_moments
    from ray_lightning_tpu_torch.ops.optim_quant import (
        dequantize_moment, is_block_quantized,
    )
    from ray_lightning_tpu_torch.parallel.sharding import leaves_with_paths

    def deq(v):
        return dequantize_moment(v) if is_block_quantized(v) else v

    return {str(p): t for p, t in leaves_with_paths(
        _map_adam_moments(opt_state, deq, deq))}


def p18_int8_check(cfg, card, out):
    import torch

    import torch_dist_helpers as helpers

    rec = helpers.RECORDS
    ref = rec["p18_int8_rep"][0]["losses"]
    ref_opt = out.pop("p18_int8_rep")["opt"]
    res = {}
    for stage in (1, 3):
        label = f"p18_int8_zero{stage}"
        losses = rec[label][0]["losses"]
        diffs = [abs(a - b) for a, b in zip(losses, ref)]
        opt = out.pop(label)["opt"]
        worst, worst_k = 0.0, None
        for k, v in ref_opt.items():
            a, b = opt[k].float(), v.float()
            rel = float(torch.linalg.vector_norm(a - b)
                        / max(float(torch.linalg.vector_norm(b)), 1e-30))
            if rel > worst:
                worst, worst_k = rel, k
        plans = rec[label + "_plan"]
        bytes_rank = {r: p["moment_bytes"] for r, p in plans.items()}
        f32_rank = {r: p["f32_moment_bytes"] for r, p in plans.items()}
        res[f"zero{stage}"] = {"losses": losses, "loss_diffs": diffs,
                               "moment_rel": worst, "worst_leaf": worst_k,
                               "moment_bytes": bytes_rank,
                               "f32_moment_bytes": f32_rank}
        print(f"phase 18 (b) int8 moments under ZeRO-{stage}: 2 gloo ranks "
              f"sharing the card, GPT-2-small's width at {cfg.n_layer} "
              f"layers, {P16_STEPS} steps: losses {losses} (diffs against "
              f"the replicated update {', '.join(f'{d:.2e}' for d in diffs)}"
              f", limits {P15_LOSS_TOL}); worst moment leaf {worst_k} rel "
              f"{worst:.3e} (limit {P18_MOMENT_REL}); moments a rank "
              f"{bytes_rank} bytes against f32's {f32_rank} "
              f"(ratio {f32_rank[0] / bytes_rank[0]:.2f}); {card}")
        check(all(d <= t for d, t in zip(diffs, P15_LOSS_TOL)),
              f"(b) zero{stage}: losses within {P15_LOSS_TOL}")
        check(worst <= P18_MOMENT_REL, f"(b) zero{stage}: moments within "
              f"{P18_MOMENT_REL} ({worst_k} {worst:.3e})")
        check(sorted(plans) == [0, 1] and all(
            f32_rank[r] > 3.5 * bytes_rank[r] for r in plans),
            f"(b) zero{stage}: int8 moments under 1/3.5 of f32's a rank")
    return res


def p18_hybrid(pools, cfg, root, out, device="cuda"):
    """(c): a data x fsdp ZeRO-3 fit on four gloo ranks sharing the
    card."""
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.parallel.strategies import (
        RayShardedStrategy,
    )

    t0 = time.perf_counter()
    tr = p18_fit(kept_strategy(RayShardedStrategy, pools["gloo"], 4,
                          backend="gloo", zero_stage=3,
                          mesh_axes=P18_HYBRID),
                 cfg, P16_STEPS, "p18_hybrid", root,
                 callbacks=[helpers.PlanProbe("p18_hybrid_plan")],
                 device=device)
    out["p18_hybrid"] = {"wall_s": time.perf_counter() - t0}
    del tr


def p18_hybrid_check(cfg, root, card, out, device="cuda"):
    """(c), in this process after the remote arms: the hybrid fit's losses
    against ``LocalStrategy`` on the same global batches."""
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    p18_fit(LocalStrategy(device=device), cfg, P16_STEPS,
            "p18_hybrid_local", root, device=device)
    rec = helpers.RECORDS
    ranks, plans = rec["p18_hybrid"], rec["p18_hybrid_plan"]
    local = rec["p18_hybrid_local"][0]
    losses = ranks[0]["losses"]
    diffs = [abs(a - b) for a, b in zip(losses, local["losses"])]
    layout = [(plans[r]["rank"], plans[r]["world"], plans[r]["replicas"])
              for r in sorted(plans)]
    mem = {r: {"setup": v["setup_bytes"], "peak": v["peak_bytes"]}
           for r, v in sorted(ranks.items())}
    digests = [plans[r]["digest"] for r in sorted(plans)]
    print(f"phase 18 (c) ZeRO-3 over {P18_HYBRID}: 4 gloo ranks sharing the "
          f"card, GPT-2-small's width at {cfg.n_layer} layers, bf16, "
          f"{TRAIN_B // 4} x {TRAIN_T} rows a rank, {P16_STEPS} steps: "
          f"losses {losses} (diffs against LocalStrategy on the global "
          f"batch {', '.join(f'{d:.2e}' for d in diffs)}, limits "
          f"{P15_LOSS_TOL}); (fsdp index, fsdp size, data replicas) a rank "
          f"{layout}; memory a rank (setup, peak GiB) "
          + ", ".join(f"{r}: {m['setup'] / 2**30:.3f}/"
                      f"{m['peak'] / 2**30:.3f}" for r, m in mem.items())
          + f" (LocalStrategy peak {local['peak_bytes'] / 2**30:.3f}); "
          f"{p15_ms(ranks[0]):.1f} ms/step; {card}")
    check(sorted(ranks) == [0, 1, 2, 3], "(c) every rank reports")
    check(layout == [(0, 2, 2), (1, 2, 2), (0, 2, 2), (1, 2, 2)],
          f"(c) the fsdp groups {layout}")
    check(digests[0] == digests[2] and digests[1] == digests[3]
          and digests[0] != digests[1],
          "(c) each slice held alike by its data replicas")
    check(all(d <= t for d, t in zip(diffs, P15_LOSS_TOL)),
          f"(c) losses within {P15_LOSS_TOL} of LocalStrategy: {diffs}")
    return {"losses": losses, "loss_diffs": diffs, "layout": layout,
            "memory": mem, "ms": p15_ms(ranks[0]),
            "local_peak_bytes": local["peak_bytes"]}


def p18_island(pools, out, device="cuda", shape=P18_ISLAND):
    """(d): the island on two gloo ranks sharing the card (its inputs made
    on each rank from one seed)."""
    import torch_dist_helpers as helpers

    payload = {"seed": SEED + 18, "shape": shape, "device": device,
               "use_kernel": True, "compute_dtype": "float32"}
    out["p18_island"] = helpers.wire_worlds(
        pools["gloo"]._workers, payload, 300, worlds=(2,),
        fn=helpers.island_rank)[2]


def p18_island_check(card, out, device="cuda", shape=P18_ISLAND):
    """(d), in this process: the one-rank fused CE on the whole batch."""
    import numpy as np
    import torch

    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.ops.cross_entropy import (
        fused_lm_head_cross_entropy,
    )

    x, wte, t = helpers.island_inputs(
        {"seed": SEED + 18, "shape": shape}, device, ranks=2)
    x.requires_grad_(True)
    wte.requires_grad_(True)
    loss = fused_lm_head_cross_entropy(
        x, wte, t, compute_dtype=torch.float32, use_kernel=True).sum() \
        / t.numel()
    loss.backward()
    ref_dx, ref_dw = x.grad.cpu().numpy(), wte.grad.cpu().numpy()
    ranks = out.pop("p18_island")
    rows = ref_dx.shape[0] // 2
    ref_loss = float(loss.detach())
    loss_rel = max(abs(r["loss"] - ref_loss) / abs(ref_loss) for r in ranks)
    dx_err = max(float(np.abs(r["dx"] - ref_dx[i * rows:(i + 1) * rows])
                       .max()) for i, r in enumerate(ranks)) / float(
        np.abs(ref_dx).max())
    dw_rel = max(float(np.linalg.norm(r["dwte"] - ref_dw)
                       / np.linalg.norm(ref_dw)) for r in ranks)
    colls = [r["collectives"] for r in ranks]
    print(f"phase 18 (d) the CE island: 2 gloo ranks sharing the card, "
          f"a rank's tokens {shape['B']} x {shape['T']} at d "
          f"{shape['d']}, vocab {shape['V']}, f32 kernels, against the one-rank fused CE "
          f"on both ranks' rows: loss rel {loss_rel:.3e}, dx {dx_err:.3e} "
          f"of max|dx|, dwte rel Frobenius {dw_rel:.3e} (limit "
          f"{P18_ISLAND_TOL}); the backward's collectives {colls}; {card}")
    check(max(loss_rel, dx_err, dw_rel) <= P18_ISLAND_TOL,
          "(d) the island equals the one-rank CE")
    check(all(c == {"all_reduce": 1, "reduce_scatter": 0, "all_gather": 0}
              for c in colls), "(d) one all-reduce in the backward")
    check(all("not divisible" in r["refused"] for r in ranks),
          "(d) a batch that does not split is refused")
    return {"loss_rel": loss_rel, "dx_err": dx_err, "dwte_rel": dw_rel,
            "collectives": colls}


def phase18_main(arms=P18_ARMS, device="cuda", cfg=None, island=None
                 ) -> int:
    """Phase 18 alone (``chip_smoke.py --phase18 [arm ...]``): its lines,
    then one JSON object as its last line.  A CPU rehearsal of (b)-(d):
    ``device="cpu"``, a narrow ``cfg`` and ``island`` shape (arm (a)
    captures on the card only)."""
    return staged_main(18, phase18_steps(arms, device, cfg, island), device)


def phase18_steps(arms=P18_ARMS, device="cuda", cfg=None, island=None):
    """Phase 18's stages (``run_staged``): (a) captured megastep on a
    one-rank NCCL world, (b) int8 moments under ZeRO on two gloo ranks,
    (c) a data x fsdp ZeRO-3 fit on four gloo ranks, (d) the CE island on
    two gloo ranks; then their references in the driver."""
    import tempfile

    from ray_lightning_tpu_torch.models.gpt import GPTConfig

    island = island or P18_ISLAND
    check(device == "cuda" or "a_megastep" not in arms,
          "phase 18 (a) captures on the card")
    unknown = set(arms) - set(P18_ARMS)
    check(not unknown, f"phase 18 arms {sorted(unknown)} in {P18_ARMS}")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    card = card_line()
    root = tempfile.mkdtemp(prefix="rlt-p18-")
    full = dataclasses.replace(GPTConfig.gpt2_small(), warmup_steps=1)
    cfg = cfg or dataclasses.replace(full, n_layer=P15_LAYERS)
    need = {}
    if "a_megastep" in arms:
        need["nccl"] = 1
    if {"b_int8_zero", "c_hybrid", "d_island"} & set(arms):
        need["gloo"] = 4 if "c_hybrid" in arms else 2
    out, result = {"card": card}, {"card": card}
    pools = yield need, []
    walls = {}
    for arm, fn, args in (
            ("a_megastep", p18_megastep, (pools, full, root, card, out)),
            ("b_int8_zero", p18_int8, (pools, cfg, root, out, device)),
            ("c_hybrid", p18_hybrid, (pools, cfg, root, out, device)),
            ("d_island", p18_island, (pools, out, device, island))):
        if arm in arms:
            t0 = time.perf_counter()
            fn(*args)
            walls[arm] = time.perf_counter() - t0
    yield
    if "a_megastep" in arms:
        result["a"] = p18_megastep_check(full, card, out)
        p18_megastep_local(full, root, card, result["a"])
    if "b_int8_zero" in arms:
        result["b"] = p18_int8_check(cfg, card, out)
    if "c_hybrid" in arms:
        result["c"] = p18_hybrid_check(cfg, root, card, out, device)
    if "d_island" in arms:
        result["d"] = p18_island_check(card, out, device, island)
    result["arm_walls_s"] = walls
    print(f"phase 18: remote arms "
          f"{json.dumps({k: round(v, 1) for k, v in walls.items()})} s; "
          f"{card}")
    return result


# -- phase 19: long context and model parallelism ---------------------------

P19_ARMS = ("a_ring", "b_tensor", "c_moe", "d_clip")
P19_STEPS = 3
# (a): bench_long_context.py's length over {"data": 2, "sp": 2}, two rows
# a data shard (a rank: 2 x 2048 tokens).
P19_RING_T, P19_RING_B = 4096, 4
P19_RING_AXES = {"data": 2, "sp": 2}
# (a)'s op check: one layer's heads at the fit's length, one sequence, f32
# (shape (1, seq_len, n_head, head_dim) of the ring's config).
P19_RING_OP_SEED = SEED + 19
P19_RING_OP_TOL = {"out": 1e-5, "grad": 1e-4}
# (b): the trainer cell's length, 4 rows a data (or fsdp) shard.
P19_TP_B = 8
P19_TP_AXES = ({"data": 2, "tensor": 2}, {"fsdp": 2, "tensor": 2})
# (c): tiny_moe's expert count at GPT-2-small's width, drop-free capacity
# (factor = E, as tests/test_moe.py), one row a data shard (the dense
# one-hot dispatch is quadratic in a group's tokens).
P19_MOE = {"n_experts": 4, "moe_capacity_factor": 4.0}
P19_MOE_B = 2
P19_MOE_AXES = {"data": 2, "expert": 2}
P19_DECODE = {"prompt": (2, 8), "new": 8}
# Per-step losses of a model-parallel arm against LocalStrategy on the same
# global batch, bf16: the products' partial sums (the tensor ranks', the
# experts', the ring's f32 fold against the flash kernels) are added in
# another order before the bf16 rounding (measured on an H100: at most
# 7.5e-05 at step 1, 2.7e-04 later, a rerouted MoE token).
P19_LOSS_TOL = (5e-4, 1e-3, 1e-3)
# (c)'s moe_aux_loss against LocalStrategy's: a bf16 near-tie that routes
# one of the 2 x 2048 dispatches of a step elsewhere moves the loss by
# ~E · p̄ / 4096 ~ 2.4e-4; two such flips.
P19_AUX_TOL = 5e-4
# (d): the clip under tensor parallelism, phase 15 (e)'s fit (the CPU
# test's narrow GPT in f32, forged loss scales that make the clip bind at
# the first and third steps) on four CPU workers over {"data": 2,
# "tensor": 2} against one CPU rank, within P15_CLIP_TOL.
P19_CLIP_AXES = {"data": 2, "tensor": 2}


def p19_fit(strategy, cfg, label, root, batch, model_kw=None, callbacks=(),
            device="cuda"):
    """A bf16 fit of ``P19_STEPS`` eager steps of ``cfg`` (HEADLINE, and
    ``model_kw``) through ``strategy``, with ``StepProbe(label)`` and
    ``ShapeProbe(label + "_shapes")``."""
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import GPT, SyntheticLMDataModule

    tr = Trainer(strategy, max_steps=P19_STEPS, limit_val_batches=0,
                 precision="bf16", seed=SEED, megastep="off",
                 log_every_n_steps=1, enable_checkpointing=False,
                 default_root_dir=str(root),
                 callbacks=[helpers.StepProbe(label),
                            helpers.ShapeProbe(label + "_shapes"),
                            *callbacks])
    tr.fit(GPT(cfg, device=device, **HEADLINE, **(model_kw or {})),
           SyntheticLMDataModule(cfg, batch_size=batch,
                                 num_batches=P19_STEPS, seed=SEED))
    return tr


def p19_configs(full, ring_t=P19_RING_T):
    ring = dataclasses.replace(full, n_layer=P15_LAYERS, seq_len=ring_t)
    tp = dataclasses.replace(full, n_layer=P15_LAYERS)
    moe = dataclasses.replace(tp, **P19_MOE)
    return ring, tp, moe


def p19_remote(pools, cfgs, root, out, arms, device="cuda"):
    """The remote arms: (a) the ring fits in both layouts and the ring's op
    check on two gloo ranks; (b) the tensor fits; (c) the MoE fit on one
    NCCL rank and the expert fit on four gloo ranks."""
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.parallel.strategies import (
        RayShardedStrategy, RayStrategy,
    )

    ring, tp, moe = cfgs
    gloo = pools["gloo"]
    walls = out.setdefault("walls", {})

    def timed(label, fn):
        t0 = time.perf_counter()
        res = fn()
        walls[label] = time.perf_counter() - t0
        return res

    if "a_ring" in arms:
        for layout in ("contiguous", "zigzag"):
            label = f"p19_ring_{layout}"
            timed(label, lambda: p19_fit(
                kept_strategy(RayStrategy, gloo, 4, backend="gloo",
                              mesh_axes=P19_RING_AXES),
                ring, label, root, P19_RING_B,
                {"attn_impl": "ring", "ring_layout": layout},
                device=device))
        s_loc = ring.seq_len // 2
        hop = (2, P19_RING_B // 2, s_loc, ring.n_head, ring.head_dim)
        for layout in ("contiguous", "zigzag"):
            # The fit's ring of two, and a ring of four, where a hop sent to
            # the wrong neighbour shows.
            out[f"p19_ring_op_{layout}"] = timed(
                f"p19_ring_op_{layout}", lambda: helpers.wire_worlds(
                    gloo._workers, {**p19_ring_op(ring), "layout": layout,
                                    "hop_shape": hop, "device": device},
                    300, worlds=(2, 4), fn=helpers.ring_card_rank))
    if "b_tensor" in arms:
        for axes in P19_TP_AXES:
            label = "p19_tp_" + "_".join(axes)
            zero = "fsdp" in axes
            cls = RayShardedStrategy if zero else RayStrategy
            tr = timed(label, lambda: p19_fit(
                kept_strategy(cls, gloo, 4, backend="gloo", mesh_axes=axes,
                              **({"zero_stage": 3} if zero else {})),
                tp, label, root, P19_TP_B, device=device))
            out[label + "_params"] = p15_host_params(tr)
            del tr
    if "d_clip" in arms:
        ccfg, cdata = p19_clip_setup()
        tr = timed("p19_clip", lambda: p15_fit(
            kept_strategy(RayStrategy, pools["cpu"], 4, backend="gloo",
                          mesh_axes=P19_CLIP_AXES),
            ccfg, 3, "p19_clip", root, precision="f32",
            gpt_kw={"device": "cpu"}, module_cls=helpers.ScaledGPT,
            data=helpers.ArraysDataModule(cdata, 8)))
        out["p19_clip_params"] = p15_host_params(tr)
        del tr
    if "c_moe" in arms:
        for label, strategy in (
                ("p19_moe_nccl", lambda: kept_strategy(
                    RayStrategy, pools["nccl" if device == "cuda"
                                       else "gloo"], 1)),
                ("p19_moe_expert", lambda: kept_strategy(
                    RayStrategy, gloo, 4, backend="gloo",
                    mesh_axes=P19_MOE_AXES))):
            tr = timed(label, lambda: p19_fit(strategy(), moe, label, root,
                                              P19_MOE_B, device=device))
            out[label + "_params"] = p15_host_params(tr)
            del tr


def ring_peak_bytes(batch, heads, s_loc, n_shards, layers):
    """``(per hop and layer, whole trunk)`` bytes of the f32 (B, H, s, s)
    tensors the ring's fold keeps for the backward: the masked logits'
    exponent and the masked probabilities, for each of the ``n_shards``
    blocks a layer folds."""
    one = 2 * batch * heads * s_loc * s_loc * 4
    return one, one * n_shards * layers


def p19_clip_setup():
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.models.gpt import GPTConfig

    return (GPTConfig(vocab_size=256, n_layer=2, n_head=4, d_model=64,
                      seq_len=32, warmup_steps=2, mu_dtype="float32"),
            helpers.scaled_batches(256, 32, 8, 3, seed=5))


def p19_clip_check(root, card, out):
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    ccfg, cdata = p19_clip_setup()
    tr = p15_fit(LocalStrategy(device="cpu"), ccfg, 3, "p19_clip_local",
                 root, precision="f32", gpt_kw={"device": "cpu"},
                 module_cls=helpers.ScaledGPT,
                 data=helpers.ArraysDataModule(cdata, 8))
    ref = p15_host_params(tr)
    del tr
    got = out.pop("p19_clip_params")
    rec = helpers.RECORDS
    losses, local = rec["p19_clip"][0]["losses"], rec["p19_clip_local"][0]
    dl = max(abs(a - b) for a, b in zip(losses, local["losses"]))
    dp = max(float((got[k] - ref[k]).abs().max()) for k in ref)
    print(f"phase 19 (d) the clip under {P19_CLIP_AXES}: forged loss scales "
          f"{helpers.SCALES}, the CPU test's GPT in f32 on four CPU workers "
          f"vs one rank: losses {losses}, worst loss diff {dl:.3e}, params "
          f"{dp:.3e} (limits {P15_CLIP_TOL}); {card}")
    check(dl <= P15_CLIP_TOL["loss"] and dp <= P15_CLIP_TOL["param"],
          "(d) the clipped updates under tensor parallelism equal the "
          "one-device fit's")
    return {"losses": losses, "loss_diff": dl, "param_diff": dp}


def p19_replicas_check(label, cfg, axes, shapes, model_kw=None):
    """Every rank's final leaves: a leaf is bitwise alike on every rank
    that holds the same slice of it (the ranks whose coordinates agree on
    the model axes its spec names; all of them for a replicated leaf).
    Returns the number of leaves compared."""
    from ray_lightning_tpu_torch.models.convert import spec_of
    from ray_lightning_tpu_torch.models.gpt import GPT
    from ray_lightning_tpu_torch.parallel.mesh import RankLayout

    specs = GPT(cfg, device="cpu", **(model_kw or {})).param_partition_specs()
    layout = RankLayout(dict(axes))
    keys = sorted(shapes[0]["digests"])
    for k in keys:
        named = [a for a in spec_of(specs, tuple(k.split("/")))
                 if a in layout.sizes]
        groups = {}
        for r in sorted(shapes):
            c = layout.coords(r)
            groups.setdefault(tuple(c[a] for a in named), set()).add(
                shapes[r]["digests"][k])
        check(all(len(d) == 1 for d in groups.values()),
              f"{label}: {k} differs between the ranks that hold the same "
              f"slice of it ({len(groups)} slices)")
    return len(keys)


def p19_ring_op(cfg):
    return {"seed": P19_RING_OP_SEED,
            "shape": (1, cfg.seq_len, cfg.n_head, cfg.head_dim)}


def p19_launch_check(label, ranks, cfg, flash=True, device="cuda"):
    """Every rank's kernel launches a step: the headline's (remat
    "dots+flash"), without flash on the ring (on the card: the counters
    count kernel launches)."""
    want = per_step_launches(cfg.n_layer, True)
    if not flash:
        want.update(flash_fwd=0, flash_bwd=0)
    if device != "cuda":
        return want
    for rank, v in sorted(ranks.items()):
        per = {k: n / P19_STEPS for k, n in v["launches"].items()}
        check(per == want, f"{label} rank {rank}: launches a step {per} == "
              f"{want}")
    print(f"phase 19 {label}: launches a step on each of {len(ranks)} "
          f"rank(s) {json.dumps(want)}")
    return want


def p19_params_check(label, got, ref, init):
    """A fit's gathered params against LocalStrategy's (phase 15 (b)'s
    measures): the worst bf16 measures of a matrix or gain, the model's
    relative Frobenius distance, the worst vector leaf's update
    distance."""
    import torch

    check(set(got) == set(ref), f"{label}: the gathered params' leaves "
          f"{sorted(set(got) ^ set(ref))[:4]}")
    worst = {"row": 0.0, "frob": 0.0, "bias": 0.0}
    for k in ref:
        check(got[k].shape == ref[k].shape, f"{label}: {k} gathered to "
              f"{tuple(got[k].shape)}, LocalStrategy {tuple(ref[k].shape)}")
        if k.endswith("_b']"):
            continue
        m = bf16_measures(torch, got[k], ref[k])
        worst = {n: max(worst[n], m[n]) for n in worst}
    sq = sum(float((got[k] - ref[k]).double().square().sum()) for k in ref)
    frob = math.sqrt(sq / sum(float(ref[k].double().square().sum())
                              for k in ref))
    def moved(k, t):
        # The key bias's gradient is zero in exact arithmetic (a query's
        # softmax does not see a shift of every key), so its update is
        # AdamW's normalisation of rounding noise in any two fits: held
        # on the query and value thirds of qkv_b.
        if k.endswith("['qkv_b']"):
            third = t.shape[-1] // 3
            return torch.cat([t[..., :third], t[..., 2 * third:]], -1)
        return t

    updates = {k: float((moved(k, got[k].double() - ref[k].double())).norm()
                        / moved(k, ref[k].double() - v.double()).norm())
               for k, v in init.items()}
    key = max(updates, key=updates.get)
    check(all(worst[k] <= BF16_LIMITS[k] for k in worst)
          and frob <= BF16_LIMITS["frob"],
          f"{label}: params within {BF16_LIMITS}: {worst}, {frob}")
    check(updates[key] <= P15_UPDATE_LIMIT, f"{label}: vector leaves' "
          f"updates within {P15_UPDATE_LIMIT}: {key} {updates[key]}")
    return {"measures": worst, "model_frob": frob,
            "worst_update": [key, updates[key]]}


def p19_losses(label, ranks, local, tol=P19_LOSS_TOL):
    check(sorted(ranks) == [0, 1, 2, 3] or sorted(ranks) == [0],
          f"{label}: every rank reports ({sorted(ranks)})")
    losses = ranks[0]["losses"]
    diffs = [abs(a - b) for a, b in zip(losses, local["losses"])]
    check(len(losses) == P19_STEPS and all(
        d <= t for d, t in zip(diffs, tol)),
        f"{label}: losses {losses} within {tol} of LocalStrategy's "
        f"{local['losses']}: {diffs}")
    return losses, diffs


def p19_memory(ranks):
    return {r: {"setup": v["setup_bytes"], "peak": v["peak_bytes"]}
            for r, v in sorted(ranks.items())}


def p19_ring_check(cfg, root, card, out, device):
    import numpy as np
    import torch

    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.ops.attention import xla_causal_attention
    from ray_lightning_tpu_torch.ops.ring_attention import (
        ring_attention_local,
    )
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    rec = helpers.RECORDS
    p19_fit(LocalStrategy(device=device), cfg, "p19_ring_local", root,
            P19_RING_B, device=device)
    local = rec["p19_ring_local"][0]
    res = {"local_ms": p15_ms(local), "local_peak": local["peak_bytes"],
           "local_losses": local["losses"]}
    s_loc = cfg.seq_len // 2
    per_hop, trunk = ring_peak_bytes(P19_RING_B // 2, cfg.n_head, s_loc, 2,
                                     cfg.n_layer)
    # Under remat one layer's fold is alive at a time (its recompute).
    res["fold_bytes_predicted"] = {"per_hop_layer": per_hop,
                                   "one_layer": per_hop * 2,
                                   "no_remat_trunk": trunk}
    for layout in ("contiguous", "zigzag"):
        label = f"p19_ring_{layout}"
        ranks = rec[label]
        losses, diffs = p19_losses(label, ranks, local)
        p19_launch_check(label, ranks, cfg, flash=False, device=device)
        p19_replicas_check(label, cfg, P19_RING_AXES, rec[label + "_shapes"],
                           {"attn_impl": "ring", "ring_layout": layout})
        mem = p19_memory(ranks)
        res[layout] = {"losses": losses, "loss_diffs": diffs,
                       "ms": p15_ms(ranks[0]), "memory": mem,
                       "wall_s": out["walls"][label]}
        print(f"phase 19 (a) ring {layout}: {P19_RING_AXES} on 4 gloo ranks "
              f"sharing the card, GPT-2-small's width at {cfg.n_layer} "
              f"layers, bf16, seq {cfg.seq_len} ({P19_RING_B // 2} x {s_loc} "
              f"tokens a rank), {P19_STEPS} steps: losses {losses} (diffs "
              f"against LocalStrategy's flash fit "
              f"{', '.join(f'{d:.2e}' for d in diffs)}, limits "
              f"{P19_LOSS_TOL}); {p15_ms(ranks[0]):.1f} ms/step "
              f"(LocalStrategy {p15_ms(local):.1f}); memory a rank (setup, "
              f"peak GiB) " + ", ".join(
                  f"{r}: {m['setup'] / 2**30:.3f}/{m['peak'] / 2**30:.3f}"
                  for r, m in mem.items())
              + f" (predicted fold {per_hop * 2 / 2**30:.3f} GiB a layer "
              f"under remat, {trunk / 2**30:.3f} GiB the trunk without; "
              f"LocalStrategy peak {local['peak_bytes'] / 2**30:.3f}); "
              f"{card}")
        # The ring's op check on two and four ranks against the in-process
        # fold, and against the plain causal attention on the whole
        # sequence (whose mask does not come from the ring's positions).
        worlds = out.pop(f"p19_ring_op_{layout}")
        op = p19_ring_op(cfg)
        errs = {}
        for ref_name, n_ref in [("plain", 0), *(
                ("local", n) for n in worlds)]:
            q, k, v, cot = helpers.ring_inputs(op, device)
            for x in (q, k, v):
                x.requires_grad_(True)
            ref = (xla_causal_attention(q, k, v) if n_ref == 0
                   else ring_attention_local(q, k, v, n_ref, layout))
            ref.backward(cot)
            refs = {"out": ref.detach(), "dq": q.grad, "dk": k.grad,
                    "dv": v.grad}
            for n, ranks_n in worlds.items():
                if n_ref not in (0, n):
                    continue
                for r in ranks_n:
                    rows = torch.as_tensor(r["rows"], device=device)
                    for name, full in refs.items():
                        e = float(np.abs(r[name] - full.index_select(
                            1, rows).cpu().numpy()).max())
                        key = f"{name}_{ref_name}"
                        errs[key] = max(errs.get(key, 0.0), e)
            del q, k, v, cot, ref, refs
        ranks_op = worlds[2]
        r0 = ranks_op[0]
        res[layout].update({"op_errs": errs, "route": r0["route"],
                            "hop_ms": [r["hop_ms"] for r in ranks_op],
                            "hop_bytes": r0["hop_bytes"]})
        print(f"phase 19 (a) ring {layout} op: {op['shape']} f32 "
              f"on 2 and 4 gloo ranks against ring_attention_local and the "
              f"plain causal attention on {device}: "
              f"max abs errors {({n: f'{e:.2e}' for n, e in errs.items()})} "
              f"(limits {P19_RING_OP_TOL}); hop route {r0['route']}; a hop of "
              f"{r0['hop_bytes'] / 2**20:.1f} MiB (the fit's k and v, bf16) "
              f"at two ranks {', '.join(f'{r['hop_ms']:.2f}' for r in ranks_op)}"
              f" ms a rank; {card}")
        check(all(e <= P19_RING_OP_TOL["out" if n.startswith("out")
                                        else "grad"]
                  for n, e in errs.items()),
              f"(a) {layout}: the ring on the ranks equals the local fold "
              f"and the plain attention {errs}")
        route = "gloo-host" if device == "cuda" else "gloo"
        check(r0["route"] == route, f"(a) the gloo hop on {device} takes "
              f"the route {route} ({r0['route']})")
    return res


def p19_tensor_check(cfg, root, card, out, device):
    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    rec = helpers.RECORDS
    tr = p19_fit(LocalStrategy(device=device), cfg, "p19_tp_local", root,
                 P19_TP_B, device=device)
    ref = p15_host_params(tr)
    del tr
    local = rec["p19_tp_local"][0]
    full_bytes = rec["p19_tp_local_shapes"][0]["param_bytes"]
    res = {"local_ms": p15_ms(local), "local_losses": local["losses"],
           "full_param_bytes": full_bytes}
    for axes in P19_TP_AXES:
        label = "p19_tp_" + "_".join(axes)
        ranks = rec[label]
        losses, diffs = p19_losses(label, ranks, local)
        want = p19_launch_check(label, ranks, cfg, device=device)
        shapes = rec[label + "_shapes"]
        heads = {r: sh["model_shapes"]["blocks/qkv_w"][-1]
                 // (3 * cfg.head_dim)
                 for r, sh in shapes.items()}
        check(all(h == cfg.n_head // 2 for h in heads.values()),
              f"{label}: each rank attends over {cfg.n_head // 2} heads "
              f"({heads})")
        pbytes = {r: sh["param_bytes"] for r, sh in sorted(shapes.items())}
        if "fsdp" not in axes:  # ZeRO-3 ranks hold slices of slices
            p19_replicas_check(label, cfg, axes, shapes)
        params = p19_params_check(label, out.pop(label + "_params"), ref,
                                  local["init_vectors"])
        mem = p19_memory(ranks)
        res[label] = {"losses": losses, "loss_diffs": diffs,
                      "ms": p15_ms(ranks[0]), "param_bytes": pbytes,
                      "heads": heads, "memory": mem, **params,
                      "wall_s": out["walls"][label]}
        print(f"phase 19 (b) {axes}"
              f"{' ZeRO-3' if 'fsdp' in axes else ''}: 4 gloo ranks sharing "
              f"the card, GPT-2-small's width at {cfg.n_layer} layers, bf16, "
              f"{P19_TP_B // 2} x {cfg.seq_len} rows a rank, {P19_STEPS} "
              f"steps: losses {losses} (diffs against LocalStrategy "
              f"{', '.join(f'{d:.2e}' for d in diffs)}, limits "
              f"{P19_LOSS_TOL}); gathered params against LocalStrategy's: "
              f"{({k: f'{v:.2e}' for k, v in params['measures'].items()})},"
              f" model rel Frobenius {params['model_frob']:.2e}, worst "
              f"vector update {params['worst_update'][1]:.3e} "
              f"({params['worst_update'][0]}); param bytes a rank {pbytes} "
              f"(one device {full_bytes}); the flash kernels at {heads[0]} "
              f"heads, {want['flash_fwd']} + {want['flash_bwd']} launches a "
              f"step a rank; {p15_ms(ranks[0]):.1f} ms/step (LocalStrategy "
              f"{p15_ms(local):.1f}); peak GiB a rank " + ", ".join(
                  f"{r}: {m['peak'] / 2**30:.3f}" for r, m in mem.items())
              + f"; {card}")
        check(all(b < 0.75 * full_bytes for b in pbytes.values()),
              f"{label}: each rank holds under 3/4 of the params")
    return res


def p19_moe_check(cfg, root, card, out, device):
    import torch

    import torch_dist_helpers as helpers
    from ray_lightning_tpu_torch.models.generate import generate
    from ray_lightning_tpu_torch.models.gpt import GPT
    from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

    rec = helpers.RECORDS
    tr = p19_fit(LocalStrategy(device=device), cfg, "p19_moe_local", root,
                 P19_MOE_B, device=device)
    ref = p15_host_params(tr)
    trained = tr.state.params
    local = rec["p19_moe_local"][0]
    res = {"local_losses": local["losses"], "local_ms": p15_ms(local)}
    # One NCCL rank: bitwise LocalStrategy.
    nccl = rec["p19_moe_nccl"][0]
    got = out.pop("p19_moe_nccl_params")
    differ = [k for k in ref if not torch.equal(ref[k], got[k])]
    same = nccl["losses"] == local["losses"]
    p19_launch_check("p19_moe_nccl", rec["p19_moe_nccl"], cfg,
                     device=device)
    res["nccl"] = {"losses": nccl["losses"], "bitwise": same and not differ,
                   "ms": p15_ms(nccl)}
    print(f"phase 19 (c) MoE, {cfg.n_experts} experts at GPT-2-small's "
          f"width, {cfg.n_layer} layers, capacity factor "
          f"{cfg.moe_capacity_factor}, bf16: one NCCL rank, {P19_STEPS} "
          f"steps: params {len(ref) - len(differ)}/{len(ref)} leaves "
          f"bitwise equal to LocalStrategy's, losses "
          f"{'bitwise equal' if same else 'differ'} ({nccl['losses']}); "
          f"{p15_ms(nccl):.1f} ms/step (LocalStrategy "
          f"{p15_ms(local):.1f}); {card}")
    check(same and not differ, f"(c) one NCCL rank bitwise LocalStrategy: "
          f"losses {nccl['losses']} vs {local['losses']}, {differ[:3]}")
    # {"data": 2, "expert": 2} on four gloo ranks.
    ranks = rec["p19_moe_expert"]
    losses, diffs = p19_losses("p19_moe_expert", ranks, local)
    aux = [r["aux"] for r in (ranks[0], local)]
    aux_diff = max(abs(a - b) for a, b in zip(*aux))
    p19_launch_check("p19_moe_expert", ranks, cfg, device=device)
    shapes = rec["p19_moe_expert_shapes"]
    experts = {r: sh["model_shapes"]["blocks/moe_in_w"][1]
               for r, sh in shapes.items()}
    pbytes = {r: sh["param_bytes"] for r, sh in sorted(shapes.items())}
    p19_replicas_check("p19_moe_expert", cfg, P19_MOE_AXES, shapes)
    params = p19_params_check("p19_moe_expert",
                              out.pop("p19_moe_expert_params"), ref,
                              local["init_vectors"])
    res["expert"] = {"losses": losses, "loss_diffs": diffs, "aux": aux[0],
                     "aux_diff": aux_diff, "experts": experts,
                     "param_bytes": pbytes, "ms": p15_ms(ranks[0]),
                     **params}
    print(f"phase 19 (c) MoE {P19_MOE_AXES}: 4 gloo ranks sharing the card, "
          f"{P19_MOE_B // 2} x {cfg.seq_len} rows a rank: losses {losses} "
          f"(diffs {', '.join(f'{d:.2e}' for d in diffs)}, limits "
          f"{P19_LOSS_TOL}); moe_aux_loss {aux[0]} (LocalStrategy "
          f"{aux[1]}, worst diff {aux_diff:.2e}, limit {P19_AUX_TOL}); "
          f"experts a rank {experts}; gathered params "
          f"{({k: f'{v:.2e}' for k, v in params['measures'].items()})}, "
          f"worst vector update {params['worst_update'][1]:.3e}; param "
          f"bytes a rank {pbytes}; {p15_ms(ranks[0]):.1f} ms/step; {card}")
    check(aux_diff <= P19_AUX_TOL, f"(c) moe_aux_loss within {P19_AUX_TOL}")
    check(all(e == cfg.n_experts // 2 for e in experts.values()),
          f"(c) each rank holds {cfg.n_experts // 2} experts ({experts})")
    # Greedy decode of the trained MoE in f32 against the argmax rollout of
    # full forwards (plain attention on both sides).
    m = GPT(cfg, device=device, attn_impl="xla")
    g = torch.Generator().manual_seed(SEED + 19)
    b, t0 = P19_DECODE["prompt"]
    prompt = torch.randint(0, cfg.vocab_size, (b, t0), generator=g).to(device)
    with torch.no_grad():
        outp = generate(m, trained, prompt, P19_DECODE["new"], device=device)
        cur, gaps = prompt, []
        for _ in range(P19_DECODE["new"]):
            logits = m.forward(trained, cur)[:, -1]
            top = torch.topk(logits, 2, dim=-1).values
            gaps.append(float((top[:, 0] - top[:, 1]).min()))
            cur = torch.cat([cur, torch.argmax(logits, -1, keepdim=True
                                               ).to(cur.dtype)], dim=1)
    equal = torch.equal(outp.to(cur.dtype), cur)
    res["decode"] = {"equal": equal, "min_top2_gap": min(gaps),
                     "tokens": outp[:, t0:].tolist()}
    print(f"phase 19 (c) MoE greedy decode on the card, f32, {b} x {t0} "
          f"prompt, {P19_DECODE['new']} new tokens: "
          f"{'equal to' if equal else 'differs from'} the argmax rollout "
          f"of full forwards (smallest top-2 logit gap {min(gaps):.3e}); "
          f"{card}")
    check(equal, "(c) MoE decode equals the full-forward rollout")
    return res


def phase19_main(arms=P19_ARMS, device="cuda", cfg=None,
                 ring_t=P19_RING_T) -> int:
    """Phase 19 alone (``chip_smoke.py --phase19 [arm ...]``): its lines,
    then one JSON object as its last line.  A CPU rehearsal:
    ``device="cpu"`` with a narrow ``cfg`` and a short ``ring_t`` (the
    one-rank arm of (c) then runs on a CPU rank over gloo)."""
    return staged_main(19, phase19_steps(arms, device, cfg, ring_t), device)


def phase19_steps(arms=P19_ARMS, device="cuda", cfg=None,
                  ring_t=P19_RING_T):
    """Phase 19's stages (``run_staged``): (a) ring attention over
    ``{"data": 2, "sp": 2}`` in both layouts and the ring's op check, (b)
    tensor parallelism over ``{"data": 2, "tensor": 2}`` and ZeRO-3 over
    ``{"fsdp": 2, "tensor": 2}``, (c) MoE on one NCCL rank and over
    ``{"data": 2, "expert": 2}``; then their LocalStrategy references, the
    ring's local fold and MoE decode in this process."""
    import tempfile

    from ray_lightning_tpu_torch.models.gpt import GPTConfig

    unknown = set(arms) - set(P19_ARMS)
    check(not unknown, f"phase 19 arms {sorted(unknown)} in {P19_ARMS}")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    card = card_line()
    root = tempfile.mkdtemp(prefix="rlt-p19-")
    full = cfg or dataclasses.replace(GPTConfig.gpt2_small(), warmup_steps=1)
    cfgs = p19_configs(full, ring_t)
    need = {"gloo": 4}
    if "c_moe" in arms and device == "cuda":
        need["nccl"] = 1
    if "d_clip" in arms:
        need["cpu"] = 4
    out, result = {"card": card}, {"card": card}
    pools = yield need, []
    p19_remote(pools, cfgs, root, out, arms, device)
    yield
    ring, tp, moe = cfgs
    if "a_ring" in arms:
        result["a"] = p19_ring_check(ring, root, card, out, device)
    if "b_tensor" in arms:
        result["b"] = p19_tensor_check(tp, root, card, out, device)
    if "c_moe" in arms:
        result["c"] = p19_moe_check(moe, root, card, out, device)
    if "d_clip" in arms:
        result["d"] = p19_clip_check(root, card, out)
    result["arm_walls_s"] = out["walls"]
    print(f"phase 19: remote arms "
          f"{json.dumps({k: round(v, 1) for k, v in out['walls'].items()})}"
          f" s; {card}")
    return result


def multi_main() -> int:
    """Phases 15-19 in one process (``chip_smoke.py --multi``): every
    worker spawned once, every phase's remote arms, then every phase's
    references and checks (``run_staged``).  Prints their lines, then
    {phase: result, "spawn_s": seconds} as one JSON line."""
    steps = (phase15_steps, phase16_steps, phase17_steps, phase18_steps,
             phase19_steps)
    out = run_staged({n: f() for n, f in zip(MULTI_PHASES, steps)})
    print(json.dumps(out, default=str))
    return 0


def phase_multi(card):
    """Phases 15-19, run as ``chip_smoke.py --multi`` in a process of its
    own (the driver of remote fits must not have initialised CUDA, and
    this one has); its lines are echoed, its last line returned with the
    process's seconds as ``all_s``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--multi"], capture_output=True, text=True,
                          timeout=900, cwd=ROOT)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    if proc.returncode != 0:
        print(proc.stderr[-6000:], file=sys.stderr)
        raise RuntimeError(f"chip_smoke: phases 15-19 failed (exit "
                           f"{proc.returncode})")
    result = json.loads(lines[-1])
    result["all_s"] = time.perf_counter() - t0
    print(f"phases 15-19: {result['all_s']:.1f} s in all, the process's "
          f"start and the shared spawn ({result['spawn_s']:.1f} s) "
          f"included; {card}")
    return result


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

    walls = {}

    def timed(fn, *args):
        """``fn(*args)``, its wall seconds kept under its name (the
        script's time limit is shared by every phase)."""
        t = time.perf_counter()
        out = fn(*args)
        walls[fn.__name__] = round(time.perf_counter() - t, 1)
        print(f"{fn.__name__}: {walls[fn.__name__]} s wall")
        return out

    record, bgmv_widths = timed(phase_kernel, torch, lora, card)
    f32, bf16 = timed(phase_server, torch, np, card)
    errs = timed(phase_train_kernels, torch)
    timing = timed(phase_train_timing, torch, card)
    train = timed(phase_trainer, torch, card)
    e2e = timed(phase_end_to_end, torch, card)
    mega = timed(phase_megastep, torch, card)
    ckpt = timed(phase_checkpoint, torch, card)
    lora_opt = timed(phase_lora_and_opt_state, torch, np, card)
    features = timed(phase_server_features, torch, np, card)
    phase3 = {"streams": f32.pop("streams"), "profile": f32["profile"]}
    world = server_world(torch, np)
    plane = timed(phase_serve_plane, torch, np, card, world, phase3)
    fleet = timed(phase_serve_fleet, torch, np, card, world, phase3)
    staged = timed(phase_multi, card)
    multi, wire, restarts, rest, model_par = (staged[str(n)]
                                              for n in MULTI_PHASES)
    # Within phase_multi: the shared spawn, then each phase's remote arms
    # and checks (the process's start is the rest).
    walls["phase_multi_parts"] = {"spawn": round(staged["spawn_s"], 1), **{
        name: round(staged[str(n)]["wall_s"], 1) for n, name in zip(
            MULTI_PHASES, ("phase_multi_gpu", "phase_grad_wire",
                           "phase_restarts", "phase_multi_gpu_rest",
                           "phase_model_parallel"))}}

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
    print("server_features: " + json.dumps({**features, "bgmv_widths":
                                            bgmv_widths, "card": card}))
    print("serve_plane: " + json.dumps({**plane, "card": card}))
    print("serve_fleet: " + json.dumps({**fleet, "card": card}))
    print("multi_gpu: " + json.dumps(multi))
    print("grad_wire: " + json.dumps(wire))
    print("restarts: " + json.dumps(restarts))
    print("multi_gpu_rest: " + json.dumps(rest))
    print("model_parallel: " + json.dumps(model_par, default=str))
    print("walls: " + json.dumps({**walls, "total_s": round(
        time.perf_counter() - t0, 1)}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-client"]:
        sys.exit(serve_client_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--nccl-probe"]:
        sys.exit(nccl_probe_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--phase15"]:
        sys.exit(phase15_main(tuple(sys.argv[2:]) or P15_ARMS))
    if sys.argv[1:2] == ["--phase16"]:
        sys.exit(phase16_main(tuple(sys.argv[2:]) or P16_ARMS))
    if sys.argv[1:2] == ["--phase17"]:
        sys.exit(phase17_main())
    if sys.argv[1:2] == ["--phase18"]:
        sys.exit(phase18_main(tuple(sys.argv[2:]) or P18_ARMS))
    if sys.argv[1:2] == ["--phase19"]:
        sys.exit(phase19_main(tuple(sys.argv[2:]) or P19_ARMS))
    if sys.argv[1:2] == ["--multi"]:
        sys.exit(multi_main())
    sys.exit(main())
