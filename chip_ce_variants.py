#!/usr/bin/env python3
"""Variants of the bf16 CE backward kernels (dx, dW) side by side on one
NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_ce_variants.py [--parent PATH] [--phases]

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
            if k.startswith("ce_grad")}
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="an earlier cross_entropy.cu to "
                        "time beside the variants")
    parser.add_argument("--phases", action="store_true", help="time the "
                        "phases of the kernels as built instead")
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
