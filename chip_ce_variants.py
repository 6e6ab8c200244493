#!/usr/bin/env python3
"""Variants of the bf16 CE backward kernels (dx, dW), of the bf16 CE
forward and of the bf16 LN backward, side by side on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_ce_variants.py [--parent PATH] [--phases]
    python3 chip_ce_variants.py --fwd [--parent PATH]
    python3 chip_ce_variants.py --ln [--parent PATH]
    python3 chip_ce_variants.py --bgmv [--parent PATH] [--also PATH ...]

Each entry of ``VARIANTS`` is a list of text substitutions on
``ray_lightning_tpu_torch/ops/csrc/cross_entropy.cu`` that changes one
parameter of the cluster kernels' design (the streamed tile's rows, the
cp.async ring's depth, the slice of d a block owns and so the cluster's
size, the exchange buffers) or removes one piece of their work to show
what it costs.  ``--parent`` names another ``cross_entropy.cu`` (an earlier
commit's, unpacked with ``git archive``), built and timed as one more
variant, so that a redesign is read against its predecessor on one card.
Every variant is built into a temporary directory (never the checkout),
one nvcc each, all at once, and the wrappers are routed to it as
``chip_faults.py`` routes them.  For each variant the script prints the
registers and spills that ptxas reports and the clusters the card keeps
resident, holds dx and dW against the plain versions at the bf16 shapes
of ``chip_faults.py``'s CE check (the diagnostics change the function by
design and are only timed), and times dx and dW at the main path's shape
(``chip_smoke.graph_ms``) beside the cuBLAS time of the same products, in
the order of ``VARIANTS`` and then reversed.  ``--phases`` instead builds
one copy of the kernels as built per entry of ``PHASES``, each with a
single 32-bit ``clock()`` accumulator around one phase of the loop for one
thread of block 0 (so the copy's registers stay near the real one's), and
prints that phase's cycles per tile at the main path's shape.  Exits 1 if
a variant does not build or the kernels as built fail a limit; the last
line is a JSON summary.

``--fwd`` does the same for the forward kernel with ``FWD_VARIANTS``, the
designs the kernel as built was chosen over, each kept here as
substitutions of its source (the TMA ring's depth, 128-column vocab tiles,
the second consumer warpgroup started two stages late, W multicast over a
cluster of two blocks): each variant's
loss and lse held against the plain version at the bf16 shapes of
``chip_faults.py``'s CE check, its time at the main path's shape beside
cuBLAS x·Wᵀ.  ``--ln`` times ``LN_VARIANTS`` of
``ray_lightning_tpu_torch/ops/csrc/layer_norm.cu`` (4 against 8 warps a
block; the cross-block column sum by the last block to finish, found by an
atomic ticket, against the column-sum kernel as built) beside
``native_layer_norm_backward``, at the main path's width and at
``WIDE_D`` = 1600 (the wide form), holds each at ``chip_faults.ln_shapes``
and prints the device time of each of its kernels (profiler).  With
``--parent``, the earlier source of the same file is one more variant.

``--bgmv`` times ``BGMV_VARIANTS`` of
``ray_lightning_tpu_torch/ops/csrc/bgmv.cu`` (the out kernel launched in
stream order instead of as a programmatic dependent; B copied after the
wait; half the slices of d; half and twice the blocks along k;
element-wise copies instead of 16-byte ones; and diagnostics that remove
one piece of the work) at the eight shapes of ``chip_smoke.py``'s phase 2
beside the graph floor (``chip_smoke.graph_floor_ms``), each held by
phase 1's checks (``chip_smoke.bgmv_checks``); ``--parent`` and
``--also`` name earlier ``bgmv.cu`` files (entry point without scratch),
timed in the same order.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import chip_faults as cf
import chip_smoke as cs

RING = ("constexpr int kRing = 3;", "constexpr int kRing = 2;")
TWO_BUFFERS = ("constexpr int kXBuf = 3;", "constexpr int kXBuf = 2;")
ONE_BUFFER = ("constexpr int kXBuf = 3;", "constexpr int kXBuf = 1;")
OWN = ("  if (rank == self) return", "  if (true) return")


def slice256(tile, warps_n):
    """256-wide slices (clusters of 3 at d = 768, 8 warps a block) with
    ``tile``-row streamed tiles, the partial on 2 x ``warps_n`` warps."""
    return [("constexpr int kCS = 384;", "constexpr int kCS = 256;"),
            ("constexpr int kCV = 48;", f"constexpr int kCV = {tile};"),
            ("constexpr int kCPM = 4;", "constexpr int kCPM = 2;"),
            ("constexpr int kCPN = 1;", f"constexpr int kCPN = {warps_n};")]


# name -> (substitutions, diagnostic: the function changes by design)
VARIANTS = {
    "as built": ([], False),
    "ring of 2": ([RING], False),
    "two exchange buffers": ([TWO_BUFFERS], False),
    "one exchange buffer": ([ONE_BUFFER], False),
    # the partial on more, smaller warp tiles: 4 warps of 16 x 48, 6 of
    # 32 x 16
    # the partial on 2 warps of 32 x 48 (fewer fragment reloads, more
    # registers); its k loop unrolled 2 times; the output product's k loop
    # not unrolled
    "partial on 2 warps": ([
        ("constexpr int kCPM = 4;", "constexpr int kCPM = 2;")], False),
    "partial unrolled 2 times": ([
        ("#pragma unroll 4\n  for (int kk = 0; kk < dcols; kk += 16) {",
         "#pragma unroll 2\n  for (int kk = 0; kk < dcols; kk += 16) {")],
        False),
    "output product not unrolled": ([
        ("#pragma unroll\n  for (int kk = 0; kk < kCV; kk += 16) {",
         "#pragma unroll 1\n  for (int kk = 0; kk < kCV; kk += 16) {")],
        False),
    # the next tile's copies issued by every warp
    "every warp issues the copies": ([
        ("    if (t < nt && !pw) {\n      cp_rows(Ring + (t % kRing) * kCV * "
         "Cl::LS, C, t * kCV, kCV, nC,\n              32 * kCPW, Cl::DT);",
         "    if (t < nt) {\n      cp_rows(Ring + (t % kRing) * kCV * "
         "Cl::LS, C, t * kCV, kCV, nC,\n              0, kCThreads);"),
        ("      if (kDW) {\n        cp_tokens(", "      if (kDW && !pw) {\n"
         "        cp_tokens(")], False),
    # the dlogits warps' arrive with release semantics (it then waits for
    # their loads in flight)
    "release arrive for the dlogits warps": ([
        ("          cluster_arrive_relaxed();", "          cluster_arrive();")],
        False),
    "slice 256 (cluster of 3), tile 64": (slice256(64, 1), False),
    "slice 256, tile 64, ring of 2, one exchange buffer": (
        slice256(64, 1) + [RING, ONE_BUFFER], False),
    # 128-row tiles of 256-wide slices fit only with 2 stages and one
    # exchange buffer
    "slice 256, tile 128, ring of 2, one exchange buffer": (
        slice256(128, 2) + [RING, ONE_BUFFER], False),
    # diagnostics: the peers' partials read from the block's own buffer
    # (no distributed shared memory), and without the cluster barrier in
    # the loop as well; the streamed tiles' loads after the ring's first
    # fill, the partial products after the first, the output products
    # skipped
    "own buffer for every peer": ([OWN], True),
    "own buffer, no barrier in the loop": ([
        OWN,
        ("  cluster_arrive();\n\n  float acc[2][8][4];",
         "\n  float acc[2][8][4];"),
        ("    cluster_wait();  // every block's partial of tile t is stored",
         ""),
        ("          cluster_arrive();\n        } else {\n", "        } else {\n"),
        ("          cluster_arrive_relaxed();\n", "")], True),
    "no tile loads after the ring's first": ([
        ("    if (t < nt && !pw) {\n      cp_rows(",
         "    if (t < nt && !pw && t < kRing - 1) {\n      cp_rows(")], True),
    "no partial products after the first": ([
        ("    if (pw && next) {\n      partial_logits(",
         "    if (false) {\n      partial_logits(")], True),
    "no output products": ([
        ("      tile_product(part, Ds, Ct, wm, wn, lane);\n", "")], True),
}
PARENT = "parent (--parent)"

# The forward's rejected designs (cross_entropy.cu, ce_fwd_wgmma_kernel),
# each as substitutions of the source as built.
STAGES = "constexpr int kFStages = 4;"
FWD_KERNEL = ("__global__ void __launch_bounds__(kFThreads, 1)\n"
              "ce_fwd_wgmma_kernel(")


def wgmma_n128():
    """The m64n128k16 wgmma: 64 f32 accumulators a thread."""
    regs = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    return ("__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], "
            "uint64_t a,\n    uint64_t b, int scale_d) {\n  asm volatile(\n"
            '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"\n'
            '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"\n'
            f'      "{regs}"\n'
            '      "}, %64, %65, p, 1, 1, 0, 0;\\n}\\n"\n'
            f"      : {outs}\n"
            '      : "l"(a), "l"(b), "r"(scale_d));\n}\n\n')


# 128-column vocab tiles
BN128 = [("constexpr int kFN = 256;", "constexpr int kFN = 128;"),
         (FWD_KERNEL, wgmma_n128() + FWD_KERNEL),
         ("wgmma_m64n256k16(acc, sw128_desc",
          "wgmma_m64n128k16(acc, sw128_desc")]
# the second consumer warpgroup held at a named barrier until the first
# has consumed two stages, so one warpgroup's softmax runs under the
# other's products
SKEW = [
    ("    int stage = 0;\n    unsigned phase = 0;\n    for (int v0",
     "    int stage = 0;\n    unsigned phase = 0;\n    int consumed = 0;\n"
     '    if (wg == 1) asm volatile("bar.sync 1, 256;\\n" ::: "memory");\n'
     "    for (int v0"),
    ("        prev = stage;",
     "        if (wg == 0 && ++consumed == 2) {\n"
     '          asm volatile("bar.arrive 1, 256;\\n" ::: "memory");\n'
     "        }\n        prev = stage;")]
# W tiles multicast over a cluster of two blocks along the tokens: each
# block loads half the tile's W rows into both, and a stage is free once
# the consumers of both blocks are done with it
MULTICAST_HELPERS = r"""// Arrive on the barrier at the same place in block `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::
          "r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int c0,
                                                   int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}

"""
PEER_ARRIVE = ("mbar_arrive(empty + 8 * prev);\n"
               "          mbar_arrive_cluster(empty + 8 * prev, rank ^ 1);")
MULTICAST = [
    ("// The wgmma operand descriptor",
     MULTICAST_HELPERS + "// The wgmma operand descriptor"),
    ("  const int r0 = blockIdx.x * kFM;\n",
     "  const int r0 = blockIdx.x * kFM;\n"
     "  const uint32_t rank = static_cast<uint32_t>(cluster_rank());\n"),
    ("mbar_init(empty + 8 * s, 2);", "mbar_init(empty + 8 * s, 4);"),
    ("  __syncthreads();\n\n  if (threadIdx.x >= 256) {",
     "  __syncthreads();\n  cluster_arrive();\n  cluster_wait();\n\n"
     "  if (threadIdx.x >= 256) {"),
    ("          tma_load(dst + kFXBytes, &tmw, fb, kc * kFK, v0);",
     "          tma_load_multicast(dst + kFXBytes + rank * (kFN / 2) * 128,"
     " &tmw, fb,\n                             kc * kFK, v0 + rank * (kFN / 2),"
     " 0x3);"),
    ("        if (kc > 0 && t == 0) mbar_arrive(empty + 8 * prev);",
     "        if (kc > 0 && t == 0) {\n          " + PEER_ARRIVE
     + "\n        }"),
    ("      if (t == 0) mbar_arrive(empty + 8 * prev);",
     "      if (t == 0) {\n          " + PEER_ARRIVE + "\n      }"),
    # no block of a cluster leaves while its peer may still write into it
    ("  }\n}\n\n// ------------------------------------------------------------"
     "---------------\n// Launchers",
     "  }\n  cluster_arrive();\n  cluster_wait();\n}\n\n// ----------------"
     "-----------------------------------------------------------\n"
     "// Launchers"),
    ("!tile_map(&tmw, w, V, d, kFN)", "!tile_map(&tmw, w, V, d, kFN / 2)"),
    ("  ce_fwd_wgmma_kernel<<<(N + kFM - 1) / kFM, kFThreads, kFSmem, st>>>(\n"
     "      tmx, tmw, targets, loss, lse, N, V, d);\n",
     "  cudaLaunchConfig_t cfg = {};\n"
     "  cfg.gridDim = dim3(((N + kFM - 1) / kFM + 1) / 2 * 2);\n"
     "  cfg.blockDim = dim3(kFThreads);\n"
     "  cfg.dynamicSmemBytes = kFSmem;\n"
     "  cfg.stream = st;\n"
     "  cudaLaunchAttribute attr;\n"
     "  attr.id = cudaLaunchAttributeClusterDimension;\n"
     "  attr.val.clusterDim.x = 2;\n"
     "  attr.val.clusterDim.y = 1;\n"
     "  attr.val.clusterDim.z = 1;\n"
     "  cfg.attrs = &attr;\n"
     "  cfg.numAttrs = 1;\n"
     "  const cudaError_t lerr = cudaLaunchKernelEx(\n"
     "      &cfg, ce_fwd_wgmma_kernel, tmx, tmw, targets, loss, lse, N, V, d);\n"
     "  if (lerr != cudaSuccess) return lerr;\n")]
FWD_VARIANTS = {
    "as built": ([], False),
    "ring of 3": ([(STAGES, STAGES.replace("4", "3"))], False),
    "BN 128": (BN128, False),
    "BN 128, ring of 6": (BN128 + [(STAGES, STAGES.replace("4", "6"))],
                          False),
    "second warpgroup two stages late": (SKEW, False),
    "W multicast, cluster of 2": (MULTICAST, False),
}
# The LN backward's rejected designs (layer_norm.cu, ln_bwd_rows_kernel).
# The ticket column sum: the block that takes the last ticket sums every
# partial row in block order, then resets the ticket for the next launch;
# no second kernel.
TICKET_SUM = """  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&g_ln_ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    for (int c = threadIdx.x; c < 2 * d; c += blockDim.x) {
      float t = 0.f;
      for (int blk = 0; blk < static_cast<int>(gridDim.x); ++blk) {
        t += __ldcg(part + static_cast<size_t>(blk) * 2 * d + c);
      }
      if (c < d) {
        dg[c] = t;
      } else {
        db[c - d] = t;
      }
    }
    if (threadIdx.x == 0) g_ln_ticket = 0;
  }
"""
FOLD_END = ("    for (int v = 0; v < warps; ++v) t += fold[static_cast<size_t>(v)"
            " * 2 * d + p];\n    out[c] = t;\n  }\n")
TICKET = [
    ("constexpr int kColGroups = 8;  // partial-row groups of one column-sum "
     "block\n",
     "constexpr int kColGroups = 8;  // partial-row groups of one column-sum "
     "block\n__device__ unsigned int g_ln_ticket = 0;\n"),
    ("                   float* __restrict__ part, long long n, int d) {",
     "                   float* __restrict__ part, float* __restrict__ dg,\n"
     "                   float* __restrict__ db, long long n, int d) {"),
    (FOLD_END, FOLD_END + TICKET_SUM),
    ("                            const float*, const float*, bf16*, float*,\n"
     "                            long long, int);",
     "                            const float*, const float*, bf16*, float*,\n"
     "                            float*, float*, long long, int);"),
    ("      static_cast<bf16*>(dx), part, n, d);\n  err = cudaGetLastError();\n"
     "  if (err != cudaSuccess) return err;\n",
     "      static_cast<bf16*>(dx), part, dg, db, n, d);\n"
     "  return cudaGetLastError();\n")]
# The width of the LN backward's second timing (GPT-2 XL's d), past the
# narrow form's 1543.
WIDE_D = 1600
LN_VARIANTS = {
    "as built": ([], False),
    "4 warps a block": ([("constexpr int kBwdWarps = 8;",
                          "constexpr int kBwdWarps = 4;")], False),
    "ticket column sum": (TICKET, False),
}

# The BGMV kernels' design choices (bgmv.cu), each undone by substitutions
# of the source as built.
BGMV_VARIANTS = {
    "as built": ([], False),
    # the out kernel launched in stream order, after the t kernel ends
    "no programmatic dependent launch": ([
        ("  attr.val.programmaticStreamSerializationAllowed = 1;",
         "  attr.val.programmaticStreamSerializationAllowed = 0;")], False),
    "no row kernel": ([
        ("  if (W <= kRowMaxW && r % V == 0 && r <= kRowMaxR",
         "  if (false && W <= kRowMaxW && r % V == 0 && r <= kRowMaxR")],
        False),
    "row kernel: a wave of blocks": ([
        ("    int rb = std::max(1, target_blocks / (4 * W));",
         "    int rb = std::max(1, target_blocks / W);")], False),
    "row kernel: half a wave of blocks": ([
        ("    int rb = std::max(1, target_blocks / (4 * W));",
         "    int rb = std::max(1, target_blocks / (2 * W));")], False),
    "B copied after the wait": ([
        ("  const bool b_early = U <= G;  // B lands while the t kernel runs",
         "  const bool b_early = false;")], False),
    "half the slices of d": ([
        ("  int ds = std::max(1, std::min(target_blocks / tiles, ",
         "  int ds = std::max(1, std::min(target_blocks / tiles / 2, ")],
        False),
    "slices of d of 16 columns or more": ([
        ("constexpr int kMinSlice = 32;", "constexpr int kMinSlice = 16;")],
        False),
    "16 KB of partials an out block": ([
        ("constexpr int kPartialBytes = 32 << 10;",
         "constexpr int kPartialBytes = 16 << 10;")], False),
    "t kernel tiles as the out kernel's": ([
        ("  while (p.rows1 % 2 == 0 && p.rows1 > 1 &&",
         "  while (false && p.rows1 % 2 == 0 && p.rows1 > 1 &&")], False),
    "half the blocks along k": ([
        ("  int kb = std::max(1, target_blocks / tiles);",
         "  int kb = std::max(1, target_blocks / tiles / 2);")], False),
    "twice the blocks along k": ([
        ("  int kb = std::max(1, target_blocks / tiles);",
         "  int kb = std::max(1, 2 * target_blocks / tiles);")], False),
    "element-wise copies": ([("  const bool aligned = d % V == 0",
                              "  const bool aligned = false && d % V == 0")],
                            False),
    # diagnostics: each removes one piece of the work to show its cost
    "ids not read": ([("    const int id = ids[row0 + row];",
                       "    const int id = 1;")], True),
    "no A copies or h·A products": ([
        ("      const int ndc = max(0, min(p.dch, nd - dc));",
         "      const int ndc = 0 * nd;")], True),
    "no t·B products or stores": ([
        ("  const int nch = (nk + V - 1) / V;",
         "  const int nch = 0 * nk;")], True),
}

# Points of the cluster kernel's loop (text of the source; "+": just after
# it, else just before) and the phases between them, each timed for the
# first thread of a partial warp ("partial") or of the last warp, which
# forms dlogits ("dlogits").
POINTS = {
    "loop": "    // Tile t + 1 has landed, and every warp",
    "head end": "    const bf16* Ct = Ring + (t % kRing) * kCV * Cl::LS;\n",
    "wait": "    cluster_wait();  // every block's partial of tile t is stored\n",
    "issue": "    // The next tile's loads start after the arrive: a release waits "
             "for\n",
    "issued": "    if constexpr (kRing >= 3) issue(t + kRing - 1);\n",
    "dlogits": "#pragma unroll\n      for (int u = 0; u < Cl::VEC; ++u) {\n"
               "        const int v = threadIdx.x - 32 * kCPW + u * Cl::DT;",
    "dlogits end": "    if constexpr (kXBuf == 1) cluster_arrive();  // done "
                   "reading\n",
    "output": "    if (wn * 64 < dcols) {\n      float part[2][8][4];",
    "output end": "    if constexpr (kXBuf < 3) {\n      // One buffer",
}
PHASES = (("head", "loop", "head end", "partial"),
          ("partial product", "head end", "wait", "partial"),
          ("store, release arrive", "wait+", "issue", "partial"),
          ("wait", "wait", "wait+", "dlogits"),
          ("peer loads, relaxed arrive", "wait+", "issue", "dlogits"),
          ("issue copies", "issue", "issued+", "dlogits"),
          ("sum of partials", "issued+", "dlogits", "dlogits"),
          ("dlogits", "dlogits", "dlogits end", "dlogits"),
          ("output product", "output", "output end", "partial"),
          ("output product ", "output", "output end", "dlogits"),
          ("iteration", "loop", "output end", "partial"))


def build_variant(build, source, tmp, name, subs, prefix="ce_grad"):
    label = "".join(c if c.isalnum() else "_" for c in name)
    src = os.path.join(tmp, f"{label}.cu")
    with open(src, "w") as f:
        f.write(cf.mutate(source, name, subs))
    so = os.path.join(tmp, f"lib{label}.so")
    p = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, src],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed on {name}: {p.stderr[-3000:]}")
    regs = {k: (r, s) for k, r, s in cs.ptxas_kernels(p.stderr)
            if k.startswith(prefix)}
    return name, so, regs


def phase_source(source, name, start, end, who):
    """``source`` with one thread's cycles from point ``start`` to point
    ``end`` summed over the loop and stored, with the tile count, for
    ``rlt_phase_read``."""
    def at(point, code):
        text = POINTS[point.rstrip("+")]
        return (text, text + code if point.endswith("+") else code + text)

    thread = "0" if who == "partial" else "kCThreads - 32"
    subs = [
        ("namespace {\n\nusing bf16", "__device__ unsigned g_phase[2];\n"
         "namespace {\n\nusing bf16"),
        ("  for (int t = 0; t < nt; ++t) {\n    // Tile t + 1",
         "  unsigned phase = 0, since = 0;\n"
         "  for (int t = 0; t < nt; ++t) {\n    // Tile t + 1"),
        at(start, "since = clock();\n"),
        at(end, "phase += clock() - since;\n"),
        ("  // No block leaves while a peer may still read its exchange "
         "buffer.\n",
         f"  if (blockIdx.x == 0 && threadIdx.x == {thread}) {{\n"
         "    g_phase[0] = phase;\n    g_phase[1] = nt;\n  }\n"
         "  // No block leaves while a peer may still read its exchange "
         "buffer.\n")]
    return (cf.mutate(source, name, subs) + '\nextern "C" int '
            'rlt_phase_read(unsigned* out) {\n  return static_cast<int>('
            'cudaMemcpyFromSymbol(out, g_phase, 8));\n}\n')


def run_phases(torch, build, ce, source, card):
    """Cycles per tile of each entry of ``PHASES`` at the main shape."""
    tmp = tempfile.mkdtemp(prefix="chip_ce_phases-")
    try:
        with ThreadPoolExecutor(len(PHASES)) as pool:
            built = list(pool.map(lambda p: build_variant(
                build, phase_source(source, p[0], *p[1:]), tmp,
                f"phase {p[0]} {p[3]}", []), PHASES))
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
        x, w, t, g = cs.ce_case(torch, gen, cs.TRAIN_B * cs.TRAIN_T,
                                cs.VOCAB, cs.D_MODEL, torch.bfloat16)
        args = (x, w, t, ce.ce_fwd_plain(x, w, t)[1], g)
        symbols = {"rlt_ce_bwd_dx": ce._BWD_ARGTYPES,
                   "rlt_ce_bwd_dw": ce._BWD_ARGTYPES}
        out = {}
        for (name, *_, who), (_, so, regs) in zip(PHASES, built):
            cf.use(build, "cross_entropy", symbols, so)
            read = ctypes.CDLL(so).rlt_phase_read
            row = {}
            for label, fn in (("dx", ce.ce_bwd_dx), ("dW", ce.ce_bwd_dw)):
                fn(*args)
                torch.cuda.synchronize()
                buf = (ctypes.c_uint * 2)()
                if read(buf):
                    raise RuntimeError(f"phase {name}: read failed")
                row[label] = buf[0] / max(buf[1], 1)
            out[f"{name.strip()} ({who} warp)"] = row
            print(f"phase {name.strip()} ({who} warp): dx {row['dx']:.0f}, "
                  f"dW {row['dW']:.0f} cycles a tile; ptxas "
                  + ", ".join(f"{k} {r} registers, {s} B spilled"
                              for k, (r, s) in sorted(regs.items()))
                  + f"; {card}")
        cf.use(build, "cross_entropy", {}, None)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def clusters(lib, d):
    """(blocks a cluster, clusters resident) of the dx kernel at ``d``, or
    None for a library without the query."""
    cdll = ctypes.CDLL(lib)
    if not hasattr(cdll, "rlt_ce_bwd_occupancy"):
        return None
    fn = cdll.rlt_ce_bwd_occupancy
    fn.argtypes, fn.restype = cs.CE_OCCUPANCY_ARGTYPES, ctypes.c_int
    vals = [ctypes.c_int() for _ in range(5)]
    if fn(0, d, *[ctypes.byref(v) for v in vals]):
        return None
    return vals[3].value, vals[4].value


def build_all(build, jobs, prefix):
    """Build each (source, name, subs) in a temporary directory, one nvcc
    each, all at once; returns (tmp, {name: library}, {name: ptxas})."""
    tmp = tempfile.mkdtemp(prefix="chip_ce_variants-")
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(
            lambda j: build_variant(build, j[0], tmp, j[1], j[2], prefix),
            jobs))
    return (tmp, {n: so for n, so, _ in built},
            {n: regs for n, _, regs in built})


def run_fwd(torch, build, ce, source, parent, card):
    """``--fwd``: each forward variant held and timed (see the module
    docstring).  Returns (failures, summary)."""
    jobs = [(source, n, subs) for n, (subs, _) in FWD_VARIANTS.items()]
    if parent:
        jobs.append((parent, PARENT, []))
    tmp, libs, regs = build_all(build, jobs, "ce_fwd")
    failures, summary = [], {}
    try:
        n, v, d = cs.TRAIN_B * cs.TRAIN_T, cs.VOCAB, cs.D_MODEL
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
        sets = [cs.ce_case(torch, gen, n, v, d, torch.bfloat16)[:3]
                for _ in range(2)]
        shapes = {k: s for k, s in cf.ce_fault_shapes(torch).items()
                  if s[3] == torch.bfloat16}
        symbols = {"rlt_ce_fwd": ce._FWD_ARGTYPES}
        for name in list(libs) + list(libs)[::-1]:
            cf.use(build, "cross_entropy", symbols, libs[name])
            rec = summary.setdefault(name, {"ptxas": regs[name]})
            if "over" not in rec:
                rec["over"] = {}
                for where, shape in shapes.items():
                    for out, (m, bad) in cf.ce_readings(
                            torch, ce, shape).items():
                        if out in ("loss", "lse") and bad:
                            rec["over"][f"{where} {out}"] = bad
                if rec["over"] and name == "as built":
                    failures.append(f"as built: {rec['over']}")
            ms = cs.graph_ms(torch, ce.ce_fwd, sets, reps=3)
            logits = cs.graph_ms(
                torch, lambda x, w, t: torch.mm(x, w.t(),
                                                out_dtype=torch.float32),
                sets, reps=3)
            rec.setdefault("runs", []).append(
                {"fwd_ms": ms, "cublas_logits_ms": logits})
            held = (f"over the limits at {list(rec['over'])}"
                    if rec["over"] else "within the limits")
            print(f"fwd {name}: {ms:.3f} ms; cuBLAS x·Wᵀ {logits:.3f} ms; "
                  + ", ".join(f"{k} {r} registers, {s} B spilled"
                              for k, (r, s) in sorted(regs[name].items()))
                  + f"; {held}; {card}")
        cf.use(build, "cross_entropy", {}, None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return failures, summary


def run_ln(torch, build, source, parent, card):
    """``--ln``: each LN backward variant held and timed, with its
    kernels' device time (see the module docstring)."""
    from ray_lightning_tpu_torch.ops import layer_norm as ln

    jobs = [(source, n, subs) for n, (subs, _) in LN_VARIANTS.items()]
    if parent:
        jobs.append((parent, PARENT, []))
    tmp, libs, regs = build_all(build, jobs, "ln_")
    failures, summary = [], {}
    try:
        n = cs.TRAIN_B * cs.TRAIN_T
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)

        def cases(d, count):
            sets, lib_sets = [], []
            for _ in range(count):
                x, g, b, dy = cs.ln_case(torch, gen, n, d, torch.bfloat16)
                _, mu, rs = ln.ln_fwd_plain(x, g, b)
                sets.append((x, g, dy, mu, rs))
                gd, bd = g.bfloat16(), b.bfloat16()
                _, mean, rstd = torch.ops.aten.native_layer_norm(
                    x, [d], gd, bd, 1e-5)
                lib_sets.append((dy, x, mean, rstd, gd, bd))
            return sets, lib_sets

        # the main path's width, and GPT-2 XL's, which takes the wide form
        sets, lib_sets = cases(cs.D_MODEL, 4)
        wide_sets, wide_lib_sets = cases(WIDE_D, 2)

        def native(dy, x, m, r, g, b):
            return torch.ops.aten.native_layer_norm_backward(
                dy, x, [x.shape[-1]], m, r, g, b, [True, True, True])

        symbols = {"rlt_ln_bwd": ln._BWD_ARGTYPES}
        for name in list(libs) + list(libs)[::-1]:
            cf.use(build, "layer_norm", symbols, libs[name])
            rec = summary.setdefault(name, {"ptxas": regs[name]})
            if "over" not in rec:
                rec["over"] = {}
                for where, shape in cf.ln_shapes().items():
                    for out, (m, bad) in cf.ln_readings(torch, ln,
                                                        shape).items():
                        if bad:
                            rec["over"][f"{where} {out}"] = bad
                if rec["over"] and name == "as built":
                    failures.append(f"as built: {rec['over']}")
                rec["kernels_us"] = {
                    cs.kernel_name(k): v for k, v in
                    (cs.device_us_by_kernel(torch, ln.ln_bwd, sets)
                     or {}).items()}
            us = cs.graph_ms(torch, ln.ln_bwd, sets) * 1e3
            lib = cs.graph_ms(torch, native, lib_sets) * 1e3
            wide = cs.graph_ms(torch, ln.ln_bwd, wide_sets) * 1e3
            wide_lib = cs.graph_ms(torch, native, wide_lib_sets) * 1e3
            rec.setdefault("runs", []).append(
                {"us": us, "native_us": lib, f"us_d{WIDE_D}": wide,
                 f"native_us_d{WIDE_D}": wide_lib})
            held = (f"over the limits at {list(rec['over'])}"
                    if rec["over"] else "within the limits")
            print(f"ln {name}: {us:.1f} us; native_layer_norm_backward "
                  f"{lib:.1f} us; at d={WIDE_D} {wide:.1f} us, native "
                  f"{wide_lib:.1f} us; kernels (profiler, eager) "
                  + ", ".join(f"{k} {v:.1f} us"
                              for k, v in rec["kernels_us"].items())
                  + "; " + ", ".join(
                      f"{k} {r} registers, {s} B spilled"
                      for k, (r, s) in sorted(regs[name].items())
                      if k.startswith("ln_bwd_rows_kernel<3"))
                  + f"; {held}; {card}")
        cf.use(build, "layer_norm", {}, None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return failures, summary


def old_api_bgmv(torch, lora, lib):
    """``lora.bgmv`` for a library of an earlier bgmv.cu, whose entry point
    takes no scratch (the single-kernel design, or the cluster design)."""
    fn = ctypes.CDLL(lib).rlt_bgmv
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(h, a, b, ids):
        out = torch.empty((h.shape[0], b.shape[2]), dtype=h.dtype,
                          device=h.device)
        err = fn(h.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(),
                 out.data_ptr(), h.shape[0], h.shape[1], a.shape[2],
                 b.shape[2], a.shape[0], lora._DTYPE_CODES[h.dtype], 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"bgmv launch failed: CUDA error {err}")
        return out
    return call


def run_bgmv(torch, build, source, parent, card, also=()):
    """``--bgmv``: each BGMV variant, the parent and each ``also`` source
    (earlier bgmv.cu files, whose entry point takes no scratch) held by
    phase 1's checks and timed at phase 2's eight shapes beside the graph
    floor."""
    from ray_lightning_tpu_torch.ops import lora

    jobs = [(source, n, subs) for n, (subs, _) in BGMV_VARIANTS.items()]
    earlier = ([(PARENT, parent)] if parent else []) + [
        (os.path.basename(path), open(path).read()) for path in also]
    jobs += [(text, name, []) for name, text in earlier]
    tmp, libs, regs = build_all(build, jobs, "bgmv")
    failures, summary = [], {}
    try:
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
        cases = {}
        for dtype in (torch.float32, torch.bfloat16):
            for W in (cs.DECODE_W, cs.PREFILL_W):
                for k in (3 * cs.D_MODEL, cs.D_MODEL):
                    probe = cs.bgmv_inputs(torch, W, k, 16, dtype,
                                           W == cs.DECODE_W, gen)[0]
                    per_call = sum(t.numel() * t.element_size()
                                   for t in probe)
                    copies = max(2, min(64, -(-64 * 2**20 // per_call)))
                    cases[f"{str(dtype)[6:]} W={W} k={k}"] = cs.bgmv_inputs(
                        torch, W, k, 16, dtype, W == cs.DECODE_W, gen,
                        copies)
        floor = cs.graph_floor_ms(torch)
        real = lora.bgmv
        old = {name for name, _ in earlier}
        for name in list(libs) + list(libs)[::-1]:
            if name in old:
                cf.use(build, "bgmv", {}, None)
                lora.bgmv = old_api_bgmv(torch, lora, libs[name])
            else:
                lora.bgmv = real
                cf.use(build, "bgmv", cf.bgmv_symbols(lora), libs[name])
            lora._scratch_floats.clear()
            rec = summary.setdefault(name, {"ptxas": regs[name]})
            diagnostic = BGMV_VARIANTS.get(name, ([], False))[1]
            if "failed" not in rec and not diagnostic:
                rec["failed"] = [
                    label for label, ok, _ in cs.bgmv_checks(
                        torch, lora, torch.Generator(device="cuda")
                        .manual_seed(cs.SEED)) if not ok]
                if rec["failed"] and name == "as built":
                    failures.append(f"as built: {rec['failed']}")
            us = {c: cs.graph_ms(torch, lora.bgmv, sets) * 1e3
                  for c, sets in cases.items()}
            rec.setdefault("runs", []).append(us)
            held = ("diagnostic" if diagnostic else
                    f"failed {rec['failed']}" if rec["failed"]
                    else "phase 1 passed")
            print(f"bgmv {name}: " + ", ".join(
                f"{c} {v:.2f} us" for c, v in us.items())
                + f"; graph floor {floor * 1e3:.2f} us; "
                + ", ".join(f"{k} {r} registers, {s} B spilled"
                            for k, (r, s) in sorted(regs[name].items()))
                + f"; {held}; {card}")
        lora.bgmv = real
        summary["graph_floor_us"] = floor * 1e3
        cf.use(build, "bgmv", {}, None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return failures, summary


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="an earlier cross_entropy.cu to "
                        "time beside the variants")
    parser.add_argument("--phases", action="store_true", help="time the "
                        "phases of the kernels as built instead")
    parser.add_argument("--fwd", action="store_true", help="the forward's "
                        "variants instead")
    parser.add_argument("--ln", action="store_true", help="the LN "
                        "backward's variants instead")
    parser.add_argument("--bgmv", action="store_true", help="the BGMV "
                        "kernel's variants instead")
    parser.add_argument("--also", action="append", default=[],
                        help="with --bgmv: an earlier bgmv.cu (entry point "
                        "without scratch) to time beside the variants")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_ce_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    from ray_lightning_tpu_torch.ops import _build
    from ray_lightning_tpu_torch.ops import cross_entropy as ce

    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    parent = None
    if args.parent:
        with open(args.parent) as f:
            parent = f.read()
    if args.fwd or args.ln or args.bgmv:
        if args.bgmv:
            failures, summary = run_bgmv(
                torch, _build, (_build.CSRC / "bgmv.cu").read_text(), parent,
                card, args.also)
        elif args.ln:
            failures, summary = run_ln(
                torch, _build, (_build.CSRC / "layer_norm.cu").read_text(),
                parent, card)
        else:
            failures, summary = run_fwd(
                torch, _build, ce, (_build.CSRC / "cross_entropy.cu")
                .read_text(), parent, card)
        for f in failures:
            print(f"chip_ce_variants: FAILED: {f}")
        print(card)
        print(json.dumps({"ok": not failures, "variants": summary}))
        return 1 if failures else 0
    source = (_build.CSRC / "cross_entropy.cu").read_text()
    if args.phases:
        phases = run_phases(torch, _build, ce, source, card)
        print(card)
        print(json.dumps({"ok": True, "phases": phases}))
        return 0
    jobs = [(source, name, subs) for name, (subs, _) in VARIANTS.items()]
    diagnostic = {name: diag for name, (_, diag) in VARIANTS.items()}
    if args.parent:
        with open(args.parent) as f:
            jobs.append((f.read(), PARENT, []))
        diagnostic[PARENT] = False
    tmp = tempfile.mkdtemp(prefix="chip_ce_variants-")
    failures, summary = [], {}
    try:
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(
                lambda j: build_variant(_build, j[0], tmp, j[1], j[2]),
                jobs))
        libs = {name: so for name, so, _ in built}
        for name, so, regs in built:
            occ = clusters(so, cs.D_MODEL)
            print(f"{name}: " + ", ".join(
                f"{k} {r} registers, {s} B spilled"
                for k, (r, s) in sorted(regs.items()))
                + ("" if occ is None else
                   f"; {occ[1]} clusters of {occ[0]} resident at "
                   f"d={cs.D_MODEL}"))
            summary[name] = {"ptxas": regs, "clusters": occ}

        n, v, d = cs.TRAIN_B * cs.TRAIN_T, cs.VOCAB, cs.D_MODEL
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
        sets = [cs.ce_case(torch, gen, n, v, d, torch.bfloat16)
                for _ in range(2)]
        bwd_sets = [(x, w, t, ce.ce_fwd_plain(x, w, t)[1], g)
                    for x, w, t, g in sets]
        dls = [ce._dlogits_plain(*a) for a in bwd_sets]

        def mm(a, b):
            return torch.mm(a, b, out_dtype=torch.float32)

        shapes = {k: s for k, s in cf.ce_fault_shapes(torch).items()
                  if s[3] == torch.bfloat16}
        symbols = {"rlt_ce_fwd": ce._FWD_ARGTYPES,
                   "rlt_ce_bwd_dx": ce._BWD_ARGTYPES,
                   "rlt_ce_bwd_dw": ce._BWD_ARGTYPES}
        order = list(libs) + list(libs)[::-1]
        for name in order:
            cf.use(_build, "cross_entropy", symbols, libs[name])
            rec = summary[name]
            if "over" not in rec and not diagnostic[name]:
                rec["over"] = {}
                for where, shape in shapes.items():
                    for out, (m, bad) in cf.ce_readings(
                            torch, ce, shape).items():
                        if out in ("dx", "dW") and bad:
                            rec["over"][f"{where} {out}"] = bad
                if rec["over"] and name == "as built":
                    failures.append(f"as built: {rec['over']}")
            dx = cs.graph_ms(torch, ce.ce_bwd_dx, bwd_sets, reps=3)
            dw = cs.graph_ms(torch, ce.ce_bwd_dw, bwd_sets, reps=3)
            logits = cs.graph_ms(torch, lambda x, w, *_: mm(x, w.t()),
                                 bwd_sets, reps=3)
            dx_mm = cs.graph_ms(
                torch, mm, [(dl, a[1]) for dl, a in zip(dls, bwd_sets)],
                reps=3)
            dw_mm = cs.graph_ms(
                torch, lambda dl, x: mm(dl.t(), x),
                [(dl, a[0]) for dl, a in zip(dls, bwd_sets)], reps=3)
            rec.setdefault("runs", []).append(
                {"dx_ms": dx, "dw_ms": dw, "cublas_dx_products_ms":
                 logits + dx_mm, "cublas_dw_products_ms": logits + dw_mm})
            held = ("diagnostic" if diagnostic[name] else
                     f"over the limits at {list(rec['over'])}"
                     if rec["over"] else "within the limits")
            print(f"{name}: dx {dx:.3f} ms, dW {dw:.3f} ms; cuBLAS same "
                  f"products {logits + dx_mm:.3f} / {logits + dw_mm:.3f} ms;"
                  f" {held}; {card}")
        cf.use(_build, "cross_entropy", {}, None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for f in failures:
        print(f"chip_ce_variants: FAILED: {f}")
    print(card)
    print(json.dumps({"ok": not failures, "variants": summary}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
