#!/usr/bin/env python3
"""Variants of the bf16 flash kernels side by side on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_flash_variants.py

Each entry of ``VARIANTS`` is a list of text substitutions on
``ray_lightning_tpu_torch/ops/csrc/flash_attention.cu`` that undoes one
design choice of the kernels or removes one piece of their work to show
what it costs.  Every variant is built into a temporary directory (never
the checkout), one nvcc each, all at once, and the wrappers are routed to
it as ``chip_faults.py`` routes them.  For each variant the script prints
the registers and spills that ptxas reports, holds the results against the
plain versions at ``chip_faults.SHAPES`` (the diagnostics change the
function by design and are only timed), and times the forward and the
backward at the main path's shape (``chip_smoke.graph_ms``) beside the
SDPA yardsticks, and at head_dim 256 (``chip_smoke.FLASH_256``), in the
order of ``VARIANTS`` and then reversed.  Exits 1
if a variant does not build or the kernels as built fail a limit; the last
line is a JSON summary.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import chip_faults as cf
import chip_smoke as cs

FWD_ORDER = ("  const int bh = blockIdx.x;\n  const int b = bh / H;\n"
             "  const int h = bh % H;\n  // Heaviest tiles first, across all "
             "heads: the last wave holds the\n  // lightest.\n"
             "  const int qt = gridDim.y - 1 - blockIdx.y;\n")
BWD_ORDER = ("  const int bh = blockIdx.y;\n  const int b = bh / H;\n"
             "  const int h = bh % H;\n  const int kt = blockIdx.x;  // key "
             "tile 0 walks the most query tiles\n  const int k0 = kt * "
             "kTile;\n  const int n_tiles = S / kTile;\n"
             "  const int w = threadIdx.x >> 5;\n")
BWD_GRID = ("  if constexpr (std::is_same<T, bf16>::value) {\n"
            "    const dim3 grid(S / kTile, B * H);\n"
            "    constexpr size_t smem = Tc<D>::bwd_bytes;")
# name -> (substitutions, diagnostic: the function changes by design)
VARIANTS = {
    "as built": ([], False),
    # the forward's query tiles heaviest first within each head only
    "fwd order per head": ([
        (FWD_ORDER, FWD_ORDER.replace("blockIdx.x;", "blockIdx.y;").replace(
            "gridDim.y - 1 - blockIdx.y", "gridDim.x - 1 - blockIdx.x")),
        ("const dim3 grid(B * H, (S + kFwdRows - 1) / kFwdRows);",
         "const dim3 grid((S + kFwdRows - 1) / kFwdRows, B * H);")], False),
    # the backward's key tiles heaviest first across all heads
    "bwd order across heads": ([
        (BWD_ORDER, BWD_ORDER.replace("blockIdx.y", "blockIdx.z").replace(
            "blockIdx.x", "blockIdx.y").replace("blockIdx.z", "blockIdx.x")),
        (BWD_GRID, BWD_GRID.replace("(S / kTile, B * H)",
                                    "(B * H, S / kTile)"))],
        False),
    # forward warps of one m16 tile (8 a block) at D = 64
    "fwd 16-row warps": ([
        ("static constexpr int fwd_mr = D == 64 ? 2 : 1;",
         "static constexpr int fwd_mr = 1;")], False),
    "3-stage rings at D = 64": ([
        ("static constexpr int fwd_stages = 2;",
         "static constexpr int fwd_stages = D == 64 ? 3 : 2;"),
        ("static constexpr int bwd_stages = 2;",
         "static constexpr int bwd_stages = D == 64 ? 3 : 2;")], False),
    "bwd 2 blocks a SM at D = 64": ([
        ("static constexpr int bwd_blocks = D == 64 ? 3 : D == 128 ? 2 : 1;",
         "static constexpr int bwd_blocks = D == 128 ? 2 : D == 64 ? 2 : 1;")],
        False),
    "bwd 64-query passes, unrolled": ([
        ("constexpr int QW = D == 64 ? 32 : 16;",
         "constexpr int QW = D == 64 ? 64 : 16;"),
        ("#pragma unroll 1  // passes one after another: no spills",
         "#pragma unroll")], False),
    # diagnostics: without its atomics the compiler drops the dQ products
    # too; a condition that never holds keeps the products alone
    "bwd without dQ": ([
        ("        atomicAdd(reinterpret_cast<float4*>(dst), v4);",
         "        (void)dst;\n        (void)v4;")], True),
    "bwd dQ products without their atomics": ([
        ("        atomicAdd(reinterpret_cast<float4*>(dst), v4);",
         "        if (v4.x == 1e30f) atomicAdd(reinterpret_cast<float4*>(dst),"
         " v4);")], True),
    "exp as one FMA": ([
        ('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "  y = __fmaf_rn(x, 1e-30f, 0.5f);")], True),
    "fwd K and V always tile 0 (L2-resident)": ([
        ("    cp_tile<D, kThreadsT>(dst, k, sk, b, h, t * kTile, kTile);\n"
         "    cp_tile<D, kThreadsT>(dst + L::tile, v, sv, b, h, t * kTile, "
         "kTile);",
         "    cp_tile<D, kThreadsT>(dst, k, sk, b, h, 0, kTile);\n"
         "    cp_tile<D, kThreadsT>(dst + L::tile, v, sv, b, h, 0, kTile);")],
        True),
}


def build_variant(build, source, tmp, name, subs):
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
            if k.startswith("tc_flash")}
    return name, so, regs


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not torch.cuda.is_available():
        print("chip_flash_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    from ray_lightning_tpu_torch.ops import _build
    from ray_lightning_tpu_torch.ops import flash_attention as fa

    card = cs.card_line()
    print(card)
    source = (_build.CSRC / "flash_attention.cu").read_text()
    tmp = tempfile.mkdtemp(prefix="chip_flash_variants-")
    failures, summary = [], {}
    try:
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            built = list(pool.map(
                lambda kv: build_variant(_build, source, tmp, kv[0],
                                         kv[1][0]), VARIANTS.items()))
        libs = {name: so for name, so, _ in built}
        for name, _, regs in built:
            print(f"{name}: " + ", ".join(
                f"{k} {r} registers, {s} B spilled"
                for k, (r, s) in sorted(regs.items())))
            summary[name] = {"ptxas": regs}

        B, S, H, D = cs.TRAIN_B, cs.TRAIN_T, 12, 64
        scale = D ** -0.5
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
        sets = [cs.flash_case(torch, gen, B, S, H, D, torch.bfloat16)
                for _ in range(2)]
        fwd_sets = [(q, k, v) for q, k, v, _ in sets]
        bwd_sets = []
        for q, k, v, do in sets:
            out, lse = fa.flash_fwd_plain(q, k, v, scale)
            bwd_sets.append((q, k, v, out.contiguous(), lse, do))
        heads = [tuple(t.transpose(1, 2) for t in s) for s in sets]
        sdpa_bwd_sets = []
        for q, k, v, do in heads:
            r = torch.ops.aten._scaled_dot_product_flash_attention(
                q, k, v, 0.0, True)
            sdpa_bwd_sets.append((do, q, k, v, *r[:8]))

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        def sdpa_bwd(do, q, k, v, o, lse, cq, ck, mq, mk, seed, off):
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, True, seed, off)

        # head_dim 256 (GPT-2-small's width over 3 heads)
        B2, S2, H2, D2 = cs.FLASH_256
        scale2 = D2 ** -0.5
        sets2 = [cs.flash_case(torch, gen, B2, S2, H2, D2, torch.bfloat16)
                 for _ in range(2)]
        fwd_sets2 = [(q, k, v) for q, k, v, _ in sets2]
        bwd_sets2 = []
        for q, k, v, do in sets2:
            out, lse = fa.flash_fwd_plain(q, k, v, scale2)
            bwd_sets2.append((q, k, v, out.contiguous(), lse, do))

        symbols = {"rlt_flash_fwd": fa._FWD_ARGTYPES,
                   "rlt_flash_bwd": fa._BWD_ARGTYPES}
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:
            cf.use(_build, "flash_attention", symbols, libs[name])
            rec = summary[name]
            if "over" not in rec and not VARIANTS[name][1]:
                rec["over"] = {}
                for shape in cf.SHAPES:
                    for n, m in cf.flash_readings(torch, fa, shape).items():
                        if cf.over(m):
                            rec["over"][f"{shape} {n}"] = cf.over(m)
                if rec["over"] and name == "as built":
                    failures.append(f"as built: {rec['over']}")
            f = cs.graph_ms(torch, lambda q, k, v: fa.flash_fwd(q, k, v,
                                                                scale),
                            fwd_sets, reps=5)
            b = cs.graph_ms(torch, lambda *a: fa.flash_bwd(*a, scale),
                            bwd_sets, reps=5)
            sd = cs.graph_ms(torch, sdpa, [h[:3] for h in heads], reps=5)
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                fa2 = cs.graph_ms(torch, sdpa, [h[:3] for h in heads], reps=5)
            sb = cs.graph_ms(torch, sdpa_bwd, sdpa_bwd_sets, reps=5)
            f2 = cs.graph_ms(torch, lambda q, k, v: fa.flash_fwd(q, k, v,
                                                                 scale2),
                             fwd_sets2, reps=5)
            b2 = cs.graph_ms(torch, lambda *a: fa.flash_bwd(*a, scale2),
                             bwd_sets2, reps=5)
            rec.setdefault("runs", []).append(
                {"fwd_us": f * 1e3, "bwd_us": b * 1e3, "sdpa_us": sd * 1e3,
                 "sdpa_flash_us": fa2 * 1e3, "sdpa_flash_bwd_us": sb * 1e3,
                 "fwd_us_d256": f2 * 1e3, "bwd_us_d256": b2 * 1e3})
            held = ("diagnostic" if VARIANTS[name][1] else
                     f"over the limits at {list(rec['over'])}"
                     if rec["over"] else "within the limits")
            print(f"{name}: fwd {f * 1e3:.1f} us, bwd {b * 1e3:.1f} us "
                  f"SDPA {sd * 1e3:.1f} us, its flash backend "
                  f"{fa2 * 1e3:.1f} us, flash bwd {sb * 1e3:.1f} us; at "
                  f"{cs.FLASH_256} fwd {f2 * 1e3:.1f} us, bwd "
                  f"{b2 * 1e3:.1f} us; {held}; {card}")
        cf.use(_build, "flash_attention", {}, None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for f in failures:
        print(f"chip_flash_variants: FAILED: {f}")
    print(card)
    print(json.dumps({"ok": not failures, "variants": summary}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
