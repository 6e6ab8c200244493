#!/usr/bin/env python3
"""Planted faults in the flash and CE kernels, against ``chip_smoke.py``'s
checks.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_faults.py

It builds the kernels of the checkout and, from mutated copies of
``ray_lightning_tpu_torch/ops/csrc/flash_attention.cu`` and
``cross_entropy.cu`` written to a temporary directory (never to the
checkout), eight faulty variants of the bf16 (tensor-core) flash kernels —
a key tile skipped, a (key tile, query tile) pair skipped, dQ dropped, p or
ds rounded toward zero instead of to nearest, and the forward's cp.async
ring read one stage ahead — and five of the CE
kernels: the last, ragged vocab tile skipped in the forward, the padded
vocab columns left unmasked in the forward, dlogits rounded toward zero
instead of to nearest (bf16), the one-hot term dropped in dW, and the
backward's softmax term taken against lse + 1.  Then it
reads, at the training path's shapes:

1. ``chip_smoke.bf16_measures`` of the correct LN and flash kernels
   against their plain versions (several shapes and seeds), which must
   stay within ``chip_smoke.BF16_LIMITS``;
2. the same measures for each faulty variant at every shape of
   ``SHAPES``, which the check must catch at the main path's shape (some
   measure of some output over its limit), beside the old check's ratio
   max|err| / (2e-2·max|ref|);
3. one bf16 training step of the full-width GPT-2-small at batch 1 in the
   headline configuration: the worst leaf's relative gradient difference
   between the card and the CPU (``chip_smoke.step_grads``), for the
   correct kernels (within ``chip_smoke.GRAD_BF16_LIMIT``) and each faulty
   flash variant.  A skipped tile or a dropped dQ must be caught there;
   the rounding faults stay inside bf16's own noise and are the kernel
   check's to catch;
4. phase 5's CE check (``chip_smoke.ce_pairs`` held as ``chip_smoke.held``
   holds them) for the correct CE kernels, which must pass at the main
   shape and the ragged one in both dtypes, and for each faulty CE
   variant, which it must catch at one of them; the shifted-lse fault
   must be caught at the f32 main shape, whose dx and dW lie under the
   max-abs check's absolute 1e-6 (the line reads that check too).

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

FWD_SKIP = "    if (!active || k0 > row0 + 16 * MR - 1) continue;"
FWD_P = "          s[mi][j][e] = p;"
BWD_TILE = "    const bf16* Qs = QdO + (i % kStages) * kStage;"
RZ = "__bfloat162float(__float2bfloat16_rz({}))"
# name -> (text of the correct source, its replacement, caught by the
# training step's gradient check too)
FAULTS = {
    # key tile 1 left out of the sums of query tiles 4 and later (rows 512+)
    "fwd_skip_key_tile": (FWD_SKIP, FWD_SKIP.replace(
        ") continue;", " || (qt >= 4 && kt == 1)) continue;"), True),
    "fwd_p_rz": (FWD_P, f"          s[mi][j][e] = {RZ.format('p')};", False),
    # ... in query tiles 4 and later only
    "fwd_p_rz_late": (FWD_P, f"          s[mi][j][e] = qt >= 4 ? "
                      f"{RZ.format('p')} : p;", False),
    # the pipeline: the forward reads K and V from the stage one ahead of
    # the tile it computes (still loading, or left from an earlier tile)
    "fwd_ring_off_by_one": (
        "    const bf16* Ks = KVs + (kt % kStages) * kStage;",
        "    const bf16* Ks = KVs + ((kt + 1) % kStages) * kStage;", True),
    # the (key tile 0, query tile 8) pair left out of dK, dV and dQ
    "bwd_skip_pair": (BWD_TILE, "    if (kt == 0 && qt == 8) continue;\n"
                      + BWD_TILE, True),
    "bwd_ds_rz": ("          dpt[j][e] = ds;",
                  f"          dpt[j][e] = {RZ.format('ds')};", False),
    "bwd_p_rz": ("          st[j][e] = p;",
                 f"          st[j][e] = {RZ.format('p')};", False),
    # dQ never accumulated: dq = 0
    "bwd_no_dq": ("        atomicAdd(reinterpret_cast<float4*>(dst), v4);",
                  "        (void)dst;\n        (void)v4;", True),
}
# name -> (text of the correct cross_entropy.cu, its replacement)
CE_FAULTS = {
    # the forward stops before the last, partial vocab tile
    "ce_fwd_skip_ragged_tile": (
        "for (int v0 = 0; v0 < V; v0 += kBN) {",
        "for (int v0 = 0; v0 + kBN <= V; v0 += kBN) {"),
    # vocab columns past V (zero rows, logit 0) counted in the sum-exp
    "ce_fwd_unmasked_pad": ("const bool in_vocab = vocab_col < V;",
                            "const bool in_vocab = true;"),
    # dlogits rounded toward zero, not to nearest, before the products
    "ce_dlogits_rz": ("return __float2bfloat16_rn(v);",
                      "return __float2bfloat16_rz(v);"),
    # dW without the -onehot·g term
    "ce_dw_no_onehot": (
        "const float hot = (vocab == tok_tgt[tk]) ? 1.f : 0.f;",
        "const float hot = (!kDW && vocab == tok_tgt[tk]) ? 1.f : 0.f;"),
    # the softmax term of dx and dW against lse + 1 (scaled by 1/e)
    "ce_bwd_lse_shift": (
        "const float p = __expf(acc[i][j][e] - tok_lse[tk]);",
        "const float p = __expf(acc[i][j][e] - tok_lse[tk] - 1.f);"),
}
MAIN = (cs.TRAIN_B, cs.TRAIN_T, 12, 64)
SHAPES = (MAIN, (cs.TRAIN_B, cs.TRAIN_T, 6, 128), (2, 256, 4, 64),
          (1, 512, 2, 128), (3, 64, 5, 64))


def fmt(m):
    return " ".join(f"{k}={v:.3e}" for k, v in m.items())


def compile_fault(build, source, tmp, name, old, new):
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


def use(build, name, symbols, lib):
    """Route the wrappers of kernel library ``name`` to ``lib`` (None: the
    checkout's build); ``symbols`` maps each C function to its argtypes."""
    build._functions.clear()
    if lib is None:
        return
    cdll = ctypes.CDLL(lib)
    for sym, argtypes in symbols.items():
        fn = getattr(cdll, sym)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        build._functions[(name, sym)] = fn


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
    """The measures over their limit; NaN counts as over, as in
    ``chip_smoke.held``."""
    return [k for k in cs.BF16_LIMITS if not m[k] <= cs.BF16_LIMITS[k]]


def ce_readings(torch, ce, shape, seed=0):
    """Phase 5's CE check at ``shape`` (N, V, d, dtype): per output, its
    measures and the limits they are over (``bf16_measures`` against
    ``BF16_LIMITS`` or ``F32_LIMITS``; f32 outputs also by max abs error
    over 1e-5·max|ref| + 1e-6, read as ``err/tol``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pairs = cs.ce_pairs(torch, ce, cs.ce_case(torch, gen, *shape))
    torch.cuda.synchronize()
    res = {}
    for n, got, ref, dtype in pairs:
        m = cs.bf16_measures(torch, got, ref)
        if dtype == torch.float32:
            bad = [k for k in cs.F32_LIMITS if not m[k] <= cs.F32_LIMITS[k]]
            err = (got.float() - ref.float()).abs().max().item()
            m["err/tol"] = err / (1e-5 * ref.float().abs().max().item()
                                  + 1e-6)
            res[n] = (m, bad + ([] if m["err/tol"] <= 1 else ["err/tol"]))
        else:
            res[n] = (m, over(m))
    return res


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_faults: no CUDA device is available", file=sys.stderr)
        return 1
    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
    from ray_lightning_tpu_torch.ops import _build
    from ray_lightning_tpu_torch.ops import cross_entropy as ce
    from ray_lightning_tpu_torch.ops import flash_attention as fa
    from ray_lightning_tpu_torch.ops import layer_norm as ln

    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    summary = {"correct": {}, "faults": {}, "step": {}, "ce_correct": {},
               "ce_faults": {}}
    flash_src = (_build.CSRC / "flash_attention.cu").read_text()
    ce_src = (_build.CSRC / "cross_entropy.cu").read_text()
    jobs = ([(flash_src, n, old, new) for n, (old, new, _) in FAULTS.items()]
            + [(ce_src, n, old, new) for n, (old, new) in CE_FAULTS.items()])
    tmp = tempfile.mkdtemp(prefix="chip_faults-")
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(jobs) + 3) as pool:
            built = [pool.submit(_build.build, n) for n in
                     ("flash_attention", "layer_norm", "cross_entropy")]
            libs = dict(pool.map(
                lambda j: compile_fault(_build, j[0], tmp, *j[1:]), jobs))
            for b in built:
                b.result()
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
        use(_build, "flash_attention", {}, None)
        for shape in SHAPES:
            for seed in ((0, 1, 2) if shape[:2] == MAIN[:2] else (0,)):
                for n, m in flash_readings(torch, fa, shape, seed).items():
                    print(f"correct flash {shape} seed {seed} {n}: {fmt(m)}")
                    summary["correct"][f"flash {shape} {seed} {n}"] = m
                    if over(m):
                        failures.append(f"correct flash {shape} {n} "
                                        f"{over(m)}")

        # 2. the flash faults, at every shape; caught at the main one
        for name in FAULTS:
            use(_build, "flash_attention", {
                "rlt_flash_fwd": fa._FWD_ARGTYPES,
                "rlt_flash_bwd": fa._BWD_ARGTYPES}, libs[name])
            caught = {}
            for shape in SHAPES:
                for n, m in flash_readings(torch, fa, shape).items():
                    print(f"fault {name} {shape} {n}: {fmt(m)} over the "
                          f"limit: {over(m)}")
                    if over(m):
                        caught[f"{shape} {n}"] = over(m)
            summary["faults"][name] = caught
            if not any(k.startswith(f"{MAIN} ") for k in caught):
                failures.append(f"fault {name} not caught at {MAIN}")
        use(_build, "flash_attention", {}, None)

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
            use(_build, "flash_attention", {
                "rlt_flash_fwd": fa._FWD_ARGTYPES,
                "rlt_flash_bwd": fa._BWD_ARGTYPES},
                None if name is None else libs[name])
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
        use(_build, "flash_attention", {}, None)

        # 4. the CE kernels, correct and faulty, by phase 5's check
        n_main = cs.TRAIN_B * cs.TRAIN_T
        f32_main = (n_main, cs.VOCAB, cs.D_MODEL, torch.float32)
        ce_shapes = ((n_main, cs.VOCAB, cs.D_MODEL, torch.bfloat16),
                     f32_main,
                     (1000, 515, cs.D_MODEL, torch.bfloat16),
                     (1000, 515, cs.D_MODEL, torch.float32))
        ce_syms = {"rlt_ce_fwd": ce._FWD_ARGTYPES,
                   "rlt_ce_bwd_dx": ce._BWD_ARGTYPES,
                   "rlt_ce_bwd_dw": ce._BWD_ARGTYPES}
        for name in (None, *CE_FAULTS):
            use(_build, "cross_entropy", ce_syms,
                None if name is None else libs[name])
            caught = {}
            for shape in ce_shapes:
                for seed in ((0, 1) if name is None else (0,)):
                    label = (f"{name or 'correct'} N={shape[0]} "
                             f"V={shape[1]} {str(shape[3])[6:]}")
                    for n, (m, bad) in ce_readings(torch, ce, shape,
                                                   seed).items():
                        print(f"ce {label} seed {seed} {n}: {fmt(m)} over "
                              f"the limit: {bad}")
                        if name is None:
                            summary["ce_correct"][f"{label} {seed} {n}"] = m
                            if bad:
                                failures.append(f"correct ce {label} {n}")
                        elif bad:
                            caught[f"{label} {n}"] = bad
            if name is not None:
                summary["ce_faults"][name] = caught
                if not caught:
                    failures.append(f"ce fault {name} not caught")
            if name == "ce_bwd_lse_shift" and not any(
                    k.startswith(f"{name} N={f32_main[0]} V={f32_main[1]} "
                                 "float32") for k in caught):
                failures.append(f"ce fault {name} not caught at the f32 "
                                "main shape")
        use(_build, "cross_entropy", {}, None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for f in failures:
        print(f"chip_faults: FAILED: {f}")
    print(card)
    print(json.dumps({"ok": not failures, **summary}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
