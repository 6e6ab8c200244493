#!/usr/bin/env python3
"""Planted faults in the flash kernels, against ``chip_smoke.py``'s checks.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_faults.py

It builds the kernels of the checkout and, from mutated copies of
``ray_lightning_tpu_torch/ops/csrc/flash_attention.cu`` written to a
temporary directory (never to the checkout), seven faulty variants of the
bf16 (tensor-core) flash kernels: a key tile skipped, a (key tile, query
tile) pair skipped, dQ dropped, and p or ds rounded toward zero instead of
to nearest.  Then it reads, at the training path's shapes:

1. ``chip_smoke.bf16_measures`` of the correct LN and flash kernels
   against their plain versions (several shapes and seeds), which must
   stay within ``chip_smoke.BF16_LIMITS``;
2. the same measures for each faulty variant, which the check must catch
   (some measure of some output over its limit), beside the old check's
   ratio max|err| / (2e-2·max|ref|);
3. one bf16 training step of the full-width GPT-2-small at batch 1: the
   worst leaf's relative gradient difference between the card and the
   CPU (``chip_smoke.step_grads``), for the correct kernels (within
   ``chip_smoke.GRAD_BF16_LIMIT``) and each faulty variant.  A skipped
   tile or a dropped dQ must be caught there; the rounding faults stay
   inside bf16's own noise and are the kernel check's to catch.

The wrappers are routed to a faulty library by replacing the cached ctypes
functions of ``ops/_build.py``.  Exits 1 if a correct kernel fails a
limit or a fault that must be caught is not; the last line is a JSON
summary.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as cs

FWD_LOOP = ("for (int kt = 0; kt <= qt; ++kt) {\n"
            "    __syncthreads();  // the previous tile's readers are done\n"
            "    tc_load_tile<D>(Ks")
BWD_LOOP = ("    __syncthreads();  // the previous tile's readers are done\n"
            "    tc_load_tile<D>(Qs")
# name -> (text of the correct source, its replacement, caught by the
# training step's gradient check too)
FAULTS = {
    # key tile 1 left out of the sums of query tiles 8 and later
    "fwd_skip_key_tile": (FWD_LOOP, FWD_LOOP.replace(
        "{\n", "{\n    if (qt >= 8 && kt == 1) continue;\n", 1), True),
    "fwd_p_rz": ("Ps[row * kLP + c] = __float2bfloat16_rn(p);",
                 "Ps[row * kLP + c] = __float2bfloat16_rz(p);", False),
    # ... in query tiles 8 and later only
    "fwd_p_rz_late": ("Ps[row * kLP + c] = __float2bfloat16_rn(p);",
                      "Ps[row * kLP + c] = qt >= 8 ? __float2bfloat16_rz(p)"
                      " : __float2bfloat16_rn(p);", False),
    # the (key tile 0, query tile 8) pair left out of dK, dV and dQ
    "bwd_skip_pair": (BWD_LOOP, "    if (kt == 0 && qt == 8) continue;\n"
                      + BWD_LOOP, True),
    "bwd_ds_rz": ("dSTs[krow * kLP + c] = __float2bfloat16_rn(ds);",
                  "dSTs[krow * kLP + c] = __float2bfloat16_rz(ds);", False),
    "bwd_p_rz": ("PTs[krow * kLP + c] = __float2bfloat16_rn(pr);",
                 "PTs[krow * kLP + c] = __float2bfloat16_rz(pr);", False),
    # dQ never accumulated: dq = 0
    "bwd_no_dq": ("for (int c = lane; c < D; c += 32) atomicAdd(dst + c, "
                  "Xs[r * LO + c]);", "(void)dst;", True),
}
MAIN = (cs.TRAIN_B, cs.TRAIN_T, 12, 64)
SHAPES = (MAIN, (cs.TRAIN_B, cs.TRAIN_T, 6, 128), (2, 256, 4, 64),
          (1, 512, 2, 128), (3, 64, 5, 64))


def fmt(m):
    return " ".join(f"{k}={v:.3e}" for k, v in m.items())


def compile_fault(build, source, tmp, name):
    old, new, _ = FAULTS[name]
    if source.count(old) != 1:
        raise RuntimeError(f"{name}: the text to mutate occurs "
                           f"{source.count(old)} times, not once")
    src = os.path.join(tmp, f"{name}.cu")
    with open(src, "w") as f:
        f.write(source.replace(old, new))
    so = os.path.join(tmp, f"lib{name}.so")
    p = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, src],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed on {name}: {p.stderr[-3000:]}")
    return name, so


def use(build, fa, lib):
    """Route the flash wrappers to ``lib`` (None: the checkout's build)."""
    build._functions.clear()
    if lib is None:
        return
    cdll = ctypes.CDLL(lib)
    for sym, argtypes in (("rlt_flash_fwd", fa._FWD_ARGTYPES),
                          ("rlt_flash_bwd", fa._BWD_ARGTYPES)):
        fn = getattr(cdll, sym)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        build._functions[("flash_attention", sym)] = fn


def flash_readings(torch, fa, shape, seed=0):
    """bf16_measures (+ the old check's ratio) of out, dq, dk, dv; both
    backward versions take the plain forward's out and lse."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = cs.flash_case(torch, gen, *shape, torch.bfloat16)
    scale = shape[3] ** -0.5
    out, _ = fa.flash_fwd(q, k, v, scale)
    outp, lsep = fa.flash_fwd_plain(q, k, v, scale)
    got = (out,) + fa.flash_bwd(q, k, v, outp, lsep, do, scale)
    ref = (outp,) + fa.flash_bwd_plain(q, k, v, outp, lsep, do, scale)
    torch.cuda.synchronize()
    res = {}
    for n, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        m = cs.bf16_measures(torch, g, r)
        m["old_err/tol"] = ((g.float() - r.float()).abs().max()
                            / (2e-2 * r.float().abs().max())).item()
        res[n] = m
    return res


def over(m):
    return [k for k in cs.BF16_LIMITS if m[k] > cs.BF16_LIMITS[k]]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_faults: no CUDA device is available", file=sys.stderr)
        return 1
    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
    from ray_lightning_tpu_torch.ops import _build
    from ray_lightning_tpu_torch.ops import flash_attention as fa
    from ray_lightning_tpu_torch.ops import layer_norm as ln

    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    summary = {"correct": {}, "faults": {}, "step": {}}
    source = (_build.CSRC / "flash_attention.cu").read_text()
    tmp = tempfile.mkdtemp(prefix="chip_faults-")
    try:
        t0 = time.perf_counter()
        for name in ("flash_attention", "layer_norm"):
            _build.build(name)
        with ThreadPoolExecutor(len(FAULTS)) as pool:
            libs = dict(pool.map(
                lambda n: compile_fault(_build, source, tmp, n), FAULTS))
        print(f"built the kernels and {len(libs)} faulty variants in "
              f"{time.perf_counter() - t0:.1f} s")

        # 1. the correct kernels
        gen = torch.Generator(device="cuda").manual_seed(0)
        for n, d in ((cs.TRAIN_B * cs.TRAIN_T, cs.D_MODEL), (1001, 768),
                     (37, 100), (2048, 768), (5, 1600)):
            x, g, b, dy = cs.ln_case(torch, gen, n, d, torch.bfloat16)
            y, _, _ = ln.ln_fwd(x, g, b)
            yp, mup, rsp = ln.ln_fwd_plain(x, g, b)
            dx, _, _ = ln.ln_bwd(x, g, dy, mup, rsp)
            dxp, _, _ = ln.ln_bwd_plain(x, g, dy, mup, rsp)
            torch.cuda.synchronize()
            for what, m in (("y", cs.bf16_measures(torch, y, yp)),
                            ("dx", cs.bf16_measures(torch, dx, dxp))):
                print(f"correct ln n={n} d={d} {what}: {fmt(m)}")
                summary["correct"][f"ln {n}x{d} {what}"] = m
                if over(m):
                    failures.append(f"correct ln {n}x{d} {what} {over(m)}")
        use(_build, fa, None)
        for shape in SHAPES:
            for seed in ((0, 1, 2) if shape[:2] == MAIN[:2] else (0,)):
                for n, m in flash_readings(torch, fa, shape, seed).items():
                    print(f"correct flash {shape} seed {seed} {n}: {fmt(m)}")
                    summary["correct"][f"flash {shape} {seed} {n}"] = m
                    if over(m):
                        failures.append(f"correct flash {shape} {n} "
                                        f"{over(m)}")

        # 2. the faults, at the main path's shape
        for name, lib in libs.items():
            use(_build, fa, lib)
            caught = {}
            for n, m in flash_readings(torch, fa, MAIN).items():
                print(f"fault {name} {n}: {fmt(m)} over the limit: "
                      f"{over(m)}")
                if over(m):
                    caught[n] = over(m)
            summary["faults"][name] = caught
            if not caught:
                failures.append(f"fault {name} not caught")
        use(_build, fa, None)

        # 3. one bf16 training step at full width: card vs CPU gradients
        cfg = GPTConfig.gpt2_small()
        init = GPT(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(cs.SEED))
        rng = np.random.default_rng(cs.SEED + 2)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, size=(1, cfg.seq_len + 1)))
        cpu_loss, cpu_g = cs.step_grads(torch, cfg, init, tokens, "cpu",
                                        "bf16")
        _, f32_g = cs.step_grads(torch, cfg, init, tokens, "cuda", "f32")
        for name in (None, *FAULTS):
            use(_build, fa, None if name is None else libs[name])
            loss, g = cs.step_grads(torch, cfg, init, tokens, "cuda",
                                    "bf16")
            rel, leaf = cs.worst_leaf(g, cpu_g)
            rel32, leaf32 = cs.worst_leaf(g, f32_g)
            label = name or "correct"
            print(f"step {label}: loss {loss:.6f} (CPU {cpu_loss:.6f}); "
                  f"card vs CPU worst leaf {leaf} {rel:.3e} (limit "
                  f"{cs.GRAD_BF16_LIMIT:.0e}); vs card f32 {leaf32} "
                  f"{rel32:.3e}")
            summary["step"][label] = {"rel": rel, "leaf": leaf,
                                      "rel_vs_f32": rel32}
            must_catch = name is not None and FAULTS[name][2]
            if name is None and rel > cs.GRAD_BF16_LIMIT:
                failures.append(f"correct step {rel:.3e}")
            if must_catch and rel <= cs.GRAD_BF16_LIMIT:
                failures.append(f"step fault {name} not caught")
        use(_build, fa, None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for f in failures:
        print(f"chip_faults: FAILED: {f}")
    print(card)
    print(json.dumps({"ok": not failures, **summary}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
