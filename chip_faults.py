#!/usr/bin/env python3
"""Planted faults in the flash, CE, LN backward and BGMV kernels, against
``chip_smoke.py``'s checks.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_faults.py

It builds the kernels of the checkout and, from mutated copies of
``ray_lightning_tpu_torch/ops/csrc/flash_attention.cu``,
``cross_entropy.cu``, ``layer_norm.cu`` and ``bgmv.cu`` written to a
temporary directory (never to the checkout), nine faulty variants of the
bf16 (tensor-core) flash kernels — a key tile skipped, a (key tile, query
tile) pair skipped, dQ dropped, p or ds rounded toward zero instead of
to nearest, the forward's cp.async ring read one stage ahead, and at
head_dim 256 one of each key group's two warps adding nothing to dK and
dV (``FAULT_SHAPES``: caught at ``chip_smoke.FLASH_256``) —
eleven of the CE kernels: the last, ragged vocab tile skipped in the
forward, the padded vocab columns left unmasked in the forward (both in
the bf16 wgmma kernel and the f32 one), three of the bf16 forward's
design (a row's running sum not rescaled when its max grows, the gold
logit taken from the neighbouring column, the TMA ring's stage before
the landed one read), dlogits rounded toward zero instead of to nearest
(bf16), the one-hot term dropped in dW, the backward's softmax term
taken against lse + 1 (the last two in the bf16 cluster kernels and the
f32 ones), and three of the bf16 backward's cluster design: one peer's
partial left out of the logits sum, the exchange buffer read one tile
off, and each tile's product added straight into the running total (the
absorption the fresh per-tile registers guard against) — four of the
bf16 LN backward, and five of the BGMV kernels (``BGMV_FAULTS``: a tile's
first id applied to every row, one slice of d's partial t left out of
each row's sum, one warp's partial t left out of the row kernel's, the
last column of a ragged chunk of k dropped, the d tail past the last
16-byte chunk dropped). Then it reads, at the training path's shapes:

1. ``chip_smoke.bf16_measures`` of the correct LN and flash kernels
   against their plain versions (several shapes and seeds), which must
   stay within ``chip_smoke.BF16_LIMITS``;
2. the same measures for each faulty variant at every shape of
   ``SHAPES``, which the check must catch at the main path's shape (or
   the one ``FAULT_SHAPES`` names; some measure of some output over its
   limit), beside the old check's ratio
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
   variant, which it must catch at the shapes ``CE_FAULTS`` names (at
   one of them where it names none); the shifted-lse fault must be caught
   at the f32 main shape, whose dx and dW lie under the max-abs check's
   absolute 1e-6 (the line reads that check too).  The absorption fault
   passes that check; at the bf16 main shape the correct kernels' dx and
   dW must lie within ``chip_smoke.F64_FROB_LIMIT`` of one f64 evaluation
   (``chip_smoke.ce_f64_reference``) and the absorption fault's must not;
5. phase 5's check of the bf16 LN backward (dx by the measures, dg and db
   by max abs error) for the correct kernels, which must pass at every
   shape of ``ln_shapes``, and for four faults (``LN_FAULTS``: one warp's
   dg partial dropped, the last partial row left out of the column sum,
   the d % 8 tail columns skipped, the wide form's second pass reading a
   stale chunk of x), each caught where its entry says;
6. phase 1's BGMV checks (``chip_smoke.bgmv_checks``) for the correct
   kernel, which must pass every one, and for each of ``BGMV_FAULTS``, at
   least one of which must fail;
7. phase 9's f32 parity of a captured fit against the eager one
   (``chip_smoke.megastep_parity``) for the correct code, which must
   pass, and for two faults of the host path planted in memory
   (``MEGASTEP_FAULTS``, ``megastep_fault``): the learning rate and bias
   corrections read on the host from a Python step count, as the
   optimizer did before its count moved to the device (a capture freezes
   them, so the second replay trains at the first one's values), and
   the captured steps' new state not written back into the graph's
   static state.  Each must fail the parity in both of its
   configurations (the flash kernels, held to 5x the eager-vs-eager
   spread, and the plain attention);
8. phase 10's f32 split-vs-straight parity of checkpoints
   (``chip_smoke.checkpoint_parity``) for the correct code, which must
   pass, and for two faults planted in memory (``CHECKPOINT_FAULTS``,
   ``checkpoint_fault``): the checkpoint's state taken before the
   epoch's last (captured) stride and its write-back, and the optimizer
   count not restored on resume.  Each must fail it in both
   configurations;
9. phase 11's checks at depth 2 (``phase11_check``: the LoRA fit's gates,
   the clip with forged gradients, the optimizer-state policies' bytes
   and losses, the int8 codec's sqrt domain through the policy's store,
   the int8 and cross-policy resumes, the callbacks under
   megastep 8) for the correct code, which must pass, and for five faults
   planted in memory (``LORA_FAULTS``, ``lora_fault``): the base's wte
   labelled "train", the clip over the full model's norm, the second
   moment quantized linearly, the EMA's decay not compounded over a
   stride, and a cross-policy resume that skips the reconcile.  Each must
   fail the check its entry names;
10. the flash backward's dQ order and the server's features (``SERVE_FAULTS``,
   ``serve_fault``): phase 10's repeat arm (``chip_smoke.repeat_fit_check``)
   and phase 12's checks at one run each (``chip_smoke.feature_int8``,
   ``feature_early``, ``feature_chunked``, ``feature_prefix``) for the
   correct code, which must pass, and for six faults: dQ added in a
   run-dependent order (built from a mutated ``flash_attention.cu``), the
   int8 scales of the square ``proj_w`` taken over its input axis, the
   verify accepting one draft past the first disagreement, a prefill
   chunk written one block off, a prefix claim without its reference, and
   a removed adapter's chains left claimable (planted in memory).  Each
   must fail the check its entry names (a raise counts);
11. the serving control plane (``PLANE_FAULTS``, ``plane_fault``): phase
   13 (``chip_smoke.phase_serve_plane``, one run of each arm) for the
   correct code, which must pass, and for five faults planted in memory:
   the client's index dedup off by one (a re-emitted index one below the
   next is yielded again), a deadline that expires a request after it
   was preempted, ``decode_adapter`` dropping the scale, the ``expired``
   counter left out of the OpenMetrics text, and a reply frame dropped on
   a caught ``OSError`` while its client lives.  Phase 13 must fail on
   each;
12. disaggregated serving (``FLEET_FAULTS``, ``fleet_fault``): phase 14
   (``chip_smoke.phase_serve_fleet``, one timed run an arm) for the
   correct code, which must pass, and for five faults planted in memory:
   a KV import into block ids shifted by one, the client's token-index
   dedup removed (a failover's re-emitted tokens stream again), a drain
   migration that ships one block too few, a prefill worker that
   prefills a tenant's prompt without its adapter, and a router that
   ignores beat loss (a member counts as lost only when its handle reads
   dead).  Phase 14 must fail on each.

13. multi-GPU training (``DIST_FAULTS``, ``dist_step``): phase 15's arms
   (``chip_smoke.py --phase15 ARM...``) each fault needs, for the correct
   code, which must pass, and for five faults planted in a copy of the
   port written to a temporary directory (its driver and its worker
   processes import the copy): the ranks skipping the gradient all-reduce
   (each trains on its own rows), a ZeRO-1 rank updating the slice of the
   next rank's params with its own gradients and moments, ZeRO leaving
   the replicated leaves' gradients unsynced (at the trainer cell's width
   the final LN's gain and bias: only the vector leaves' update measure
   sees them), the clip's norm summed over the rank's own slices only,
   and the trainer adopting rank 1's package.  Phase 15 must fail on
   each.

14. the data-parallel gradient wire (``GRAD_WIRE_FAULTS``,
   ``grad_wire_step``): phase 16's arms (``chip_smoke.py --phase16
   ARM...``) each fault needs, for the correct code, which must pass, and
   for seven faults planted in a copy of the port as step 13 plants them:
   the error-feedback error without its phase-2 part, the partials
   quantized as ``g`` and the sum divided by ``n`` after (instead of ``g /
   n``; bitwise the same at n = 2, caught at n = 3), a step that reads the
   taps' buffers before the compute stream waits on the side stream, a
   trunk segment left untapped, and, for a two-rank fit to catch, the
   residual never added to the partials, the phase-2 error dropped again,
   and the state keeping its old residual row.  Phase 16 (g) (one rank
   over NCCL on the side stream), (h) (three CPU ranks) or (c) (the
   ``int8_ef`` fit, through its ``WireProbe``) must fail on each, as the
   entry names.

15. restarts (``RESTART_FAULTS``, ``restart_step``): for the correct code,
   which must pass, ``torch_dist_helpers.restart_unit_checks`` (one
   process, no card) and phase 17 (``chip_smoke.py --phase17``); then six
   faults planted in a copy of the port as step 13 plants them, each of
   which the check its entry names must fail: META written before the
   barrier (``write_order``), restart discovery that does not verify, so
   a newest checkpoint with a flipped shard byte is resumed instead of
   walked past (``walk_back``), the selective reader off by one rank's
   slice (``selective_slices``, and phase 17 (a)'s bitwise gate), accum
   not re-derived at N -> M (``accum_rederived``, and phase 17 (c)),
   failures counted outside ``restart_window_s`` (``window``), and the
   error-feedback residual kept across a world change (``ef_dropped``).

16. the rest of multi-GPU training (``MULTI_FAULTS``, ``multi_step``):
   four faults planted in a copy of the port as step 13 plants them, one
   a part, each failing the phase 18 arm its entry names
   (``chip_smoke.py --phase18 ARM``): a captured stride that skips its
   last bucket's all-reduce on replay (``a_megastep``: the collectives
   captured against the eager steps'), a straddling block requantized
   from one rank's half, the MAX all-reduce of the block maxima dropped
   (``b_int8_zero``: the moments against the replicated update's), the
   ``data``-group all-reduce of a hybrid mesh's slices dropped
   (``c_hybrid``: the losses against ``LocalStrategy``), and the island
   summing ``dwte`` twice (``d_island``).

17. long context and model parallelism (``MODEL_FAULTS``,
   ``model_step``): five faults planted in a copy of the port as step 13
   plants them, each failing the phase 19 arm its entry names
   (``chip_smoke.py --phase19 ARM``): the ring's hop sent to the wrong
   neighbour (``a_ring``: the op check's ring of four against
   ``ring_attention_local``), the zig-zag positions off by one chunk
   (``a_ring``: the zig-zag fit's losses against ``LocalStrategy``), the
   copy-in before MoE's combine dropped (``c_moe``: ``gate_w`` then
   differs between the expert ranks that hold it whole), ``qkv_w`` split
   contiguously instead of by heads (``b_tensor``: the losses), and the
   clip's norm counting each replicated leaf once per tensor rank
   (``d_clip``: the forged-scale fit against one rank).

``python3 chip_faults.py --only 12`` builds the kernels and runs step 12
alone; ``--only 13``, ``--only 14``, ``--only 15``, ``--only 16`` and
``--only 17`` run
that step alone.

The wrappers are routed to a faulty library by replacing the cached ctypes
functions of ``ops/_build.py``.  Exits 1 if a correct kernel fails a
limit or a fault that must be caught is not; the last line is a JSON
summary.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
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
DKDV = "      // dV += Pᵀ·dO and dK += dSᵀ·Q over these queries.\n"
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
    # at D = 256, the second warp of each pair (columns 128..255) never
    # adds to dK and dV (no effect at D <= 128, where no warp splits D)
    "bwd_dkdv_half_dropped": (DKDV, "      if (c0 != 0) continue;\n" + DKDV,
                              False),
}
# The shape at which step 2 must catch a fault, where not MAIN.
FAULT_SHAPES = {"bwd_dkdv_half_dropped": cs.FLASH_256}
CE_P32 = "            const float p = __expf(acc[i][j][e] - tok_lse[tk]);"
CE_P16 = "          const float prob = __expf(logit[k] - tok[tk]);"
# name -> (substitutions in cross_entropy.cu, the shapes of step 4 at which
# the check must catch the fault; empty: wherever, None: need not)
FWD_TILES = "for (int v0 = 0; v0 < V; v0 += kFN) {\n"
CE_FAULTS = {
    # the forward stops before the last, partial vocab tile (both routes:
    # the bf16 producer and consumers, the f32 kernel)
    "ce_fwd_skip_ragged_tile": ([
        ("      " + FWD_TILES + "        for (int kc",
         "      " + FWD_TILES.replace("v0 < V", "v0 + kFN <= V")
         + "        for (int kc"),
        ("    " + FWD_TILES + "      int prev",
         "    " + FWD_TILES.replace("v0 < V", "v0 + kFN <= V")
         + "      int prev"),
        ("for (int v0 = 0; v0 < V; v0 += kBN) {",
         "for (int v0 = 0; v0 + kBN <= V; v0 += kBN) {")],
        ("bf16 main", "bf16 ragged", "f32 ragged")),
    # vocab columns past V (zero rows, logit 0) counted in the sum-exp
    "ce_fwd_unmasked_pad": ([
        ("if (c0 + 8 * j + (e & 1) >= V) acc[4 * j + e] = kNegInf;",
         "(void)e;"),
        ("const bool in_vocab = vocab_col < V;",
         "const bool in_vocab = true;")],
        ("bf16 main", "bf16 ragged", "f32 ragged")),
    # the bf16 forward's running sum of one row of each thread's pair not
    # rescaled when the row's max grows
    "ce_fwd_sum_not_rescaled": ([
        ("s_a = s_a * fast_exp2((m_a - mn_a) * kLog2e) + sum_a;",
         "s_a = s_a + sum_a;")], ("bf16 main", "bf16 ragged")),
    # the gold logit taken from the next column where the target's column
    # is even
    "ce_fwd_gold_neighbour": ([
        ("if (ga == 8 * j) gold_a = acc[4 * j];",
         "if (ga == 8 * j) gold_a = acc[4 * j + 1];")],
        ("bf16 main", "bf16 ragged")),
    # the consumers read the ring's stage before the one that has landed
    "ce_fwd_ring_stage_early": ([
        ("const uint32_t xs = ring + stage * kFStageBytes",
         "const uint32_t xs = ring + ((stage + kFStages - 1) % kFStages) "
         "* kFStageBytes"),
        ("const uint32_t ws = ring + stage * kFStageBytes",
         "const uint32_t ws = ring + ((stage + kFStages - 1) % kFStages) "
         "* kFStageBytes")], ("bf16 main", "bf16 ragged")),
    # dlogits rounded toward zero, not to nearest, before the products
    "ce_dlogits_rz": ([
        ("__float2bfloat16_rn(lo)", "__float2bfloat16_rz(lo)"),
        ("__float2bfloat16_rn(hi)", "__float2bfloat16_rz(hi)")],
        ("bf16 main",)),
    # dW without the -onehot·g term
    "ce_dw_no_onehot": ([
        ("const float hot = (vocab == tok_tgt[tk]) ? 1.f : 0.f;",
         "const float hot = (!kDW && vocab == tok_tgt[tk]) ? 1.f : 0.f;"),
        ("const float onehot = vocab == tgt ? 1.f : 0.f;",
         "const float onehot = (!kDW && vocab == tgt) ? 1.f : 0.f;")],
        ("bf16 main", "f32 main")),
    # the softmax term of dx and dW against lse + 1 (scaled by 1/e)
    "ce_bwd_lse_shift": ([
        (CE_P32, CE_P32.replace("tok_lse[tk])", "tok_lse[tk] - 1.f)")),
        (CE_P16, CE_P16.replace("tok[tk])", "tok[tk] - 1.f)"))],
        ("bf16 main", "f32 main")),
    # the logits without the partial of the cluster's block 1
    "ce_cluster_peer_left_out": ([
        ("if (u < nvec && nranks > 1) p[u] = ld_peer(Xt + xoff[u], 1, rank);",
         "if (u < nvec && nranks > 1) p[u] = make_float4(0, 0, 0, 0);")],
        ("bf16 main", "bf16 ragged")),
    # the exchange buffer of the tile before (or after) read
    "ce_cluster_buffer_off_by_one": ([
        ("const float* Xt = xbuf(t);", "const float* Xt = xbuf(t + 1);")],
        ("bf16 main", "bf16 ragged")),
    # each tile's product added straight into the running total: within
    # the limits against the plain version, caught against f64 (step 4)
    "ce_cluster_absorption": ([
        ("tile_product(part, Ds, Ct, wm, wn, lane);",
         "tile_product(acc, Ds, Ct, wm, wn, lane);")], None),
}
# The faults that the f64 yardstick must catch at the bf16 main shape.
CE_F64_FAULTS = ("ce_cluster_absorption",)
# name -> (substitutions in layer_norm.cu, the shapes of LN_SHAPES at which
# the check must catch the fault)
LN_FAULTS = {
    # warp 3 of every block leaves its dg partial out of the fold
    "ln_bwd_warp_dg_dropped": ([
        ("own[u * kUnit + k] = dgr[i][k];",
         "own[u * kUnit + k] = w == 3 ? 0.f : dgr[i][k];")],
        ("main", "ragged")),
    # the column sum stops before the last block's partial row
    "ln_col_sum_last_row_left_out": ([
        ("for (int blk = grp; blk < blocks; blk += kColGroups) {",
         "for (int blk = grp; blk < blocks - 1; blk += kColGroups) {")],
        ("main", "ragged")),
    # the d % 8 columns past the last 8-wide unit never handled (the main
    # path's d = 768 has none, so only a ragged width can show it)
    "ln_bwd_tail_skipped": ([
        ("const bool tail = lane < d - c_tail;", "const bool tail = false;")],
        ("ragged",)),
    # the wide form's second pass does not read x again: every chunk takes
    # the first pass's last chunk of x (only a width past 1543 runs it)
    "ln_bwd_wide_stale_x": ([
        ("        load_units<NU, kAligned>(xv, xr, u0, nu);\n", "")],
        ("wide",)),
}
# name -> substitutions in bgmv.cu; phase 1's checks (chip_smoke.
# bgmv_checks) must catch each.
BGMV_FAULTS = {
    # every row of a tile takes the tile's first id
    "bgmv_first_id_everywhere": [
        ("  if (lane < nrows) slot[lane] = slot_a;",
         "  if (lane < nrows) slot[lane] = ka >= 0 ? 0 : -1;"),
        ("    if (lane + 32 < nrows) slot[lane + 32] = slot_b;",
         "    if (lane + 32 < nrows) slot[lane + 32] = kb >= 0 ? 0 : -1;")],
    # the last slice of d's partial t left out of each row's sum
    "bgmv_slice_partial_left_out": [
        ("      for (int sl = part; sl < p.dsplit; sl += 1 << lp) {",
         "      for (int sl = part; sl < p.dsplit - (p.dsplit > 1); "
         "sl += 1 << lp) {")],
    # the last column of a ragged chunk of k never written
    "bgmv_ragged_k_column_dropped": [
        ("    for (int i = 0; i < n; ++i) o[i] = v[i];",
         "    for (int i = 0; i < n - (n < 4); ++i) o[i] = v[i];"),
        ("    for (int i = 0; i < n; ++i) o[i] = __float2bfloat16_rn(v[i]);",
         "    for (int i = 0; i < n - (n < 8); ++i) o[i] = "
         "__float2bfloat16_rn(v[i]);")],
    # the row kernel's t without the last warp's partial
    "bgmv_row_warp_partial_left_out": [
        ("    for (int q = 0; q < kWarps; ++q) t += s_part[q][tid];",
         "    for (int q = 0; q < kWarps - 1; ++q) t += s_part[q][tid];")],
    # h·A stops at the last whole 16-byte chunk of a slice of d
    "bgmv_d_tail_dropped": [
        ("      const int ndc = max(0, min(p.dch, nd - dc));",
         "      const int ndc = max(0, min(p.dch, nd - dc)) / V * V;")],
}
MAIN = (cs.TRAIN_B, cs.TRAIN_T, 12, 64)
SHAPES = (MAIN, (cs.TRAIN_B, cs.TRAIN_T, 6, 128), (2, 256, 4, 64),
          (1, 512, 2, 128), (3, 64, 5, 64), cs.FLASH_256, (2, 192, 3, 256))


def ce_fault_shapes(torch):
    """Step 4's CE shapes (N, V, d, dtype): the main path's in both
    dtypes and a case ragged in N and V (at the main path's d, so the bf16
    backward runs the main path's clusters)."""
    n = cs.TRAIN_B * cs.TRAIN_T
    return {"bf16 main": (n, cs.VOCAB, cs.D_MODEL, torch.bfloat16),
            "f32 main": (n, cs.VOCAB, cs.D_MODEL, torch.float32),
            "bf16 ragged": (1000, 515, cs.D_MODEL, torch.bfloat16),
            "f32 ragged": (1000, 515, cs.D_MODEL, torch.float32)}


def ln_shapes():
    """The LN backward's shapes (n, d): the main path's, one ragged in n
    and d (d % 8 = 4, 5 blocks), one ragged in n only, and GPT-2 XL's
    width, past the narrow form's 1543 (the wide form)."""
    return {"main": (cs.TRAIN_B * cs.TRAIN_T, cs.D_MODEL),
            "ragged": (37, 100), "ragged rows": (1001, cs.D_MODEL),
            "wide": (1001, 1600)}


def ln_readings(torch, ln, shape, seed=0):
    """Phase 5's check of the bf16 LN backward at ``shape``: dx by
    ``bf16_measures`` against ``BF16_LIMITS``; dg and db (f32) by max abs
    error over 1e-5·max|ref| + 1e-6, read as ``err/tol``.  Both versions
    take the same statistics."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, g, b, dy = cs.ln_case(torch, gen, *shape, torch.bfloat16)
    _, mu, rs = ln.ln_fwd_plain(x, g, b)
    got = ln.ln_bwd(x, g, dy, mu, rs)
    ref = ln.ln_bwd_plain(x, g, dy, mu, rs)
    torch.cuda.synchronize()
    m = cs.bf16_measures(torch, got[0], ref[0])
    res = {"dx": (m, over(m))}
    for n, a, r in zip(("dg", "db"), got[1:], ref[1:]):
        e = {"err/tol": ((a - r).abs().max() / (1e-5 * r.abs().max()
                                                 + 1e-6)).item()}
        res[n] = (e, [] if e["err/tol"] <= 1 else ["err/tol"])
    return res


def ce_f64_readings(torch, ce, shape, seed=0):
    """Each CE result's (max abs, relative Frobenius) distance from one
    f64 evaluation of the same inputs (``chip_smoke.ce_f64_reference``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    case = cs.ce_case(torch, gen, *shape)
    pairs = cs.ce_pairs(torch, ce, case)
    ref = cs.ce_f64_reference(torch, case)
    return {n: cs.f64_distance(got, ref[n]) for n, got, _, _ in pairs}


def fmt(m):
    return " ".join(f"{k}={v:.3e}" for k, v in m.items())


def mutate(source, name, subs):
    """``source`` with each (old, new) of ``subs`` replaced; each old text
    must occur exactly once."""
    for old, new in subs:
        if source.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace occurs "
                               f"{source.count(old)} times, not once")
        source = source.replace(old, new)
    return source


def compile_fault(build, source, tmp, name, subs):
    src = os.path.join(tmp, f"{name}.cu")
    with open(src, "w") as f:
        f.write(mutate(source, name, subs))
    so = os.path.join(tmp, f"lib{name}.so")
    p = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, src],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed on {name}: {p.stderr[-3000:]}")
    return name, so


def bgmv_symbols(lora):
    """The BGMV library's C functions and their argtypes, for ``use``."""
    return {"rlt_bgmv": lora._ARGTYPES,
            "rlt_bgmv_scratch": lora._SCRATCH_ARGTYPES}


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


MEGASTEP_FAULTS = ("lr_read_on_the_host", "state_not_written_back")


def _host_count_adamw(correct_adamw, learning_rate, b1, b2, weight_decay,
                      mask, mu_dtype, eps=1e-8):
    """``models.optim.adamw`` as it was before its count moved to the
    device: the learning rate and bias corrections are host floats of a
    Python step count (the device count is kept only so the state has its
    shape)."""
    import numpy as np
    import torch

    from ray_lightning_tpu_torch.models import optim

    correct = correct_adamw(learning_rate, b1, b2, weight_decay, mask,
                            mu_dtype, eps)
    b1_mu = float(torch.tensor(b1, dtype=mu_dtype))
    calls = [0]

    def update(grads, state, params):
        calls[0] += 1
        n = calls[0]
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(n))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(n))
        lr = float(learning_rate(torch.tensor(n - 1, dtype=torch.int32)))
        decay = optim.tree_leaves(mask(params))
        ups, mus, nus = [], [], []
        for g, m, v, p, dec in zip(optim.tree_leaves(grads),
                                   optim.tree_leaves(state["mu"]),
                                   optim.tree_leaves(state["nu"]),
                                   optim.tree_leaves(params), decay):
            m = (1 - b1) * g + b1_mu * m.float()
            v = (1 - b2) * (g * g) + b2 * v
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if dec:
                u = u + weight_decay * p
            ups.append((-lr) * u)
            mus.append(m.to(mu_dtype))
            nus.append(v)
        return optim.tree_unflatten(grads, ups), {
            "count": state["count"] + 1,
            "mu": optim.tree_unflatten(grads, mus),
            "nu": optim.tree_unflatten(grads, nus)}

    return optim.GradientTransformation(correct.init, update)


@contextlib.contextmanager
def megastep_fault(name):
    """Plant one of ``MEGASTEP_FAULTS`` in the port's modules (in memory;
    the checkout is not touched) for the duration of the block."""
    import torch

    from ray_lightning_tpu_torch.models import optim
    from ray_lightning_tpu_torch.parallel import step_fns

    if name == "lr_read_on_the_host":
        module, attr = optim, "adamw"
        fault = functools.partial(_host_count_adamw, optim.adamw)
    else:
        module, attr = step_fns, "copy_state"
        correct_copy = step_fns.copy_state

        def fault(dst, src):
            # Inside a capture the new state is dropped.
            if not torch.cuda.is_current_stream_capturing():
                correct_copy(dst, src)
    saved = getattr(module, attr)
    setattr(module, attr, fault)
    try:
        yield
    finally:
        setattr(module, attr, saved)


CHECKPOINT_FAULTS = ("state_before_the_last_stride", "count_not_restored")


@contextlib.contextmanager
def checkpoint_fault(name):
    """Plant one of ``CHECKPOINT_FAULTS`` in the port's modules (in memory)
    for the duration of the block: the checkpoint's state taken before
    the epoch's last stride (and its write-back) ran, with the counters
    of after it; or the optimizer's count left at the fresh state's 0
    when a checkpoint is restored (the schedule and bias corrections
    restart)."""
    import torch

    from ray_lightning_tpu_torch.core import loop
    from ray_lightning_tpu_torch.core.module import TrainState
    from ray_lightning_tpu_torch.models.optim import tree_map
    from ray_lightning_tpu_torch.parallel import step_fns

    if name == "state_before_the_last_stride":
        call = step_fns.MultiStep.__call__
        payload = loop.LoopContext.checkpoint_payload

        def stride(self, owner, batches, start):
            s = owner.state
            owner.stale = TrainState(tree_map(torch.clone, s.params),
                                     tree_map(torch.clone, s.opt_state),
                                     s.step)
            return call(self, owner, batches, start)

        def stale_payload(self):
            live = self.state
            self.state = getattr(self, "stale", live)
            try:
                return payload(self)
            finally:
                self.state = live

        patches = [(step_fns.MultiStep, "__call__", stride),
                   (loop.LoopContext, "checkpoint_payload", stale_payload)]
    else:
        restore = loop._restore_state

        def count_left(template, loaded):
            out = restore(template, loaded)
            opt = out.opt_state
            if isinstance(opt, dict):
                opt = opt["inner_opt_state"]
            opt[1]["count"].zero_()
            return out

        patches = [(loop, "_restore_state", count_left)]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in
             patches]
    for owner, attr, fault in patches:
        setattr(owner, attr, fault)
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)


# Phase 11's faults, each with the check of phase 11 that must catch it.
# Step 10: name -> the check that must catch it.
SERVE_FAULTS = {"dq_any_order": "repeat",
                "int8_scales_wrong_axis": "int8",
                "verify_accepts_one_past": "early_exit",
                "chunk_one_block_off": "chunked",
                "prefix_claim_without_retain": "prefix",
                "removed_adapter_chains_claimable": "prefix"}
# The dQ order fault: each warp adds when its products are ready.
DQ_ORDER_FAULT = [("      if (nc == 0) dq_turn_wait_warp(turn_row() + qt, "
                   "qt - kt);\n", "")]


@contextlib.contextmanager
def serve_fault(name):
    """Plant one of the in-memory ``SERVE_FAULTS`` for the block: int8
    scales of a square block weight over its input axis (the shape still
    fits); the verify accepting one draft past the first disagreement; a
    prefill chunk's k/v written through its block row shifted by one
    block; a prefix claim that retains nothing (the claiming request's
    free then drops the index's reference); ``remove_adapter`` leaving the
    tenant's chains in the cache."""
    import numpy as np

    from ray_lightning_tpu_torch.models import quant
    from ray_lightning_tpu_torch.serve import engine, kv_cache

    if name == "int8_scales_wrong_axis":
        correct = quant._quantize

        def wrong(w, contract_axis):
            if contract_axis == -2 and w.shape[-1] == w.shape[-2]:
                contract_axis = -1
            return correct(w, contract_axis)

        patches = [(quant, "_quantize", wrong)]
    elif name == "verify_accepts_one_past":
        correct = engine.accepted_drafts

        def one_past(drafts, target):
            return min(correct(drafts, target) + 1, len(drafts))

        patches = [(engine, "accepted_drafts", one_past)]
    elif name == "chunk_one_block_off":
        correct = engine.ServeEngine._run_chunk

        def shifted(self, req, row, start, end, width):
            return correct(self, req, np.roll(row, -1), start, end, width)

        patches = [(engine.ServeEngine, "_run_chunk", shifted)]
    elif name == "prefix_claim_without_retain":
        correct = kv_cache.PrefixIndex.claim

        def claim(self, key, tokens, max_blocks):
            ids = correct(self, key, tokens, max_blocks)
            self.allocator.free(ids)
            return ids

        patches = [(kv_cache.PrefixIndex, "claim", claim)]
    else:
        correct = engine.ServeEngine.remove_adapter

        def remove(self, name):
            correct(self, name)
            with self._lock:
                self._prefix_drops = [n for n in self._prefix_drops
                                      if n != name]

        patches = [(engine.ServeEngine, "remove_adapter", remove)]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in
             patches]
    for owner, attr, fault in patches:
        setattr(owner, attr, fault)
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)


def serve_check(torch, np, card, which, world, root):
    """Step 10's check ``which``; True when it passes (a raise fails)."""
    try:
        if which == "repeat":
            return cs.repeat_fit_check(torch, world["cfg"], root,
                                       card)["bitwise"]
        run = {"int8": cs.feature_int8, "early_exit": cs.feature_early,
               "chunked": cs.feature_chunked,
               "prefix": cs.feature_prefix}[which]
        run(torch, np, card, world, repeats=1)
        return True
    except Exception as e:  # noqa: BLE001 - a raise is a catch
        print(f"step 10 {which}: raised {type(e).__name__}: "
              f"{str(e)[:300]}")
        return False


# Step 11: the serving control plane's faults, each caught by phase 13.
PLANE_FAULTS = ("client_dedup_off_by_one", "deadline_expires_preempted",
                "decode_adapter_drops_scale", "expired_left_out_of_export",
                "reply_dropped_on_oserror")
# reply_dropped_on_oserror: every REPLY_DROP_EVERY-th token frame.
REPLY_DROP_EVERY = 97


@contextlib.contextmanager
def plane_fault(name):
    """Plant one of ``PLANE_FAULTS`` for the block: ``ServeClient.stream``
    yielding an index one below the next one it expects (a re-emission
    after a preemption comes through twice); ``Scheduler.poll`` expiring
    queued requests past their deadline whether or not they were
    preempted; ``decode_adapter`` returning the factors without the
    scale; the OpenMetrics serve section rendered without the
    ``expired`` counter; ``ServeEngine._reply`` dropping every
    ``REPLY_DROP_EVERY``-th token frame as on a caught ``OSError``."""
    import queue as pyqueue

    from ray_lightning_tpu_torch.serve import client, engine, lora, scheduler
    from ray_lightning_tpu_torch.telemetry import export_prom

    if name == "client_dedup_off_by_one":
        def stream(self, prompt, max_new_tokens, timeout=60.0, **kw):
            rid = self.submit(prompt, max_new_tokens, **kw)
            pend = self._pending[rid]
            next_idx = 0
            while True:
                try:
                    kind, payload = pend.stream.get(timeout=timeout)
                except pyqueue.Empty:
                    raise TimeoutError(f"request {rid}: no stream item "
                                       f"within {timeout}s") from None
                if kind == "token":
                    idx, tok = payload
                    if idx >= next_idx - 1:
                        next_idx = idx + 1
                        yield tok
                else:
                    self._check_done(pend)
                    return

        patches = [(client.ServeClient, "stream", stream)]
    elif name == "deadline_expires_preempted":
        correct = scheduler.Scheduler.poll

        def poll(self, now=None):
            now = time.monotonic() if now is None else now
            late = [r for r in self.queue if r.deadline_s is not None
                    and now - r.arrival_t > r.deadline_s]
            for r in late:
                self.queue.remove(r)
                r.state = scheduler.RequestState.EXPIRED
                r.finished_t = now
            admissions, expired = correct(self, now)
            return admissions, late + expired

        patches = [(scheduler.Scheduler, "poll", poll)]
    elif name == "decode_adapter_drops_scale":
        correct = lora.decode_adapter

        def decode(item):
            tree = correct(item)
            tree.pop("scale")
            return tree

        patches = [(lora, "decode_adapter", decode)]
    elif name == "expired_left_out_of_export":
        correct = export_prom._render_serve

        def render(serve):
            counters = {k: v for k, v in serve.get("counters", {}).items()
                        if k != "expired"}
            return correct(dict(serve, counters=counters))

        patches = [(export_prom, "_render_serve", render)]
    else:
        correct = engine.ServeEngine._reply
        sent = [0]

        def reply(self, addr, item):
            if item.get("type") == "serve_token":
                sent[0] += 1
                if sent[0] % REPLY_DROP_EVERY == 0:
                    try:
                        raise OSError("reply send failed")
                    except OSError:
                        return  # dropped; the client is still alive
            correct(self, addr, item)

        patches = [(engine.ServeEngine, "_reply", reply)]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in
             patches]
    for owner, attr, fault in patches:
        setattr(owner, attr, fault)
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)


def plane_check(torch, np, card, world):
    """Phase 13 at one run an arm; True when it passes (a raise fails)."""
    try:
        cs.phase_serve_plane(torch, np, card, world, repeats=1)
        return True
    except Exception as e:  # noqa: BLE001 - a raise is a catch
        print(f"step 11: raised {type(e).__name__}: {str(e)[:300]}")
        return False


FLEET_FAULTS = ("import_ids_shifted_by_one", "failover_dedup_removed",
                "migration_one_block_short", "worker_prefill_without_adapter",
                "router_ignores_beat_loss")


@contextlib.contextmanager
def fleet_fault(name):
    """Plant one of ``FLEET_FAULTS`` for the block: ``import_blocks``
    (as the engine calls it) scattering into ids one above the ones it
    is given; ``ServeClient.stream`` yielding every token frame, its
    index unchecked; ``ServeEngine.export_resident`` shipping each
    sequence's blocks but the last; ``PrefillRunner._prefill`` running a
    tenant's prompt at the base model's pool slot; ``Router._is_lost``
    reading only the member's handle."""
    import queue as pyqueue

    import torch

    from ray_lightning_tpu_torch.serve import client, engine
    from ray_lightning_tpu_torch.serve.dist import prefill, router

    if name == "import_ids_shifted_by_one":
        correct = engine.import_blocks

        def imp(pool, payload, ids):
            return correct(pool, payload, torch.as_tensor(ids) + 1)

        patches = [(engine, "import_blocks", imp)]
    elif name == "failover_dedup_removed":
        def stream(self, prompt, max_new_tokens, timeout=60.0, **kw):
            rid = self.submit(prompt, max_new_tokens, **kw)
            pend = self._pending[rid]
            while True:
                try:
                    kind, payload = pend.stream.get(timeout=timeout)
                except pyqueue.Empty:
                    raise TimeoutError(f"request {rid}: no stream item "
                                       f"within {timeout}s") from None
                if kind == "token":
                    yield payload[1]
                else:
                    self._check_done(pend)
                    return

        patches = [(client.ServeClient, "stream", stream)]
    elif name == "migration_one_block_short":
        correct = engine.ServeEngine.export_resident

        def export(self):
            entries = correct(self)
            for e in entries:
                e["kv"] = {k: v[:, :-1] for k, v in e["kv"].items()}
            return entries

        patches = [(engine.ServeEngine, "export_resident", export)]
    elif name == "worker_prefill_without_adapter":
        correct = prefill.PrefillRunner._prefill

        def prefill_base(self, prompt, bucket, start, ids, ad, ad_id):
            if ad_id is not None:
                ad_id = torch.zeros_like(ad_id)
            return correct(self, prompt, bucket, start, ids, ad, ad_id)

        patches = [(prefill.PrefillRunner, "_prefill", prefill_base)]
    else:
        def is_lost(self, m, now):
            return not m.handle.is_alive()

        patches = [(router.Router, "_is_lost", is_lost)]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in
             patches]
    for owner, attr, fault in patches:
        setattr(owner, attr, fault)
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)


def fleet_check(torch, np, card, world):
    """Phase 14 at one timed run an arm; True when it passes (a raise
    fails)."""
    try:
        cs.phase_serve_fleet(torch, np, card, world, repeats=1)
        return True
    except Exception as e:  # noqa: BLE001 - a raise is a catch
        print(f"step 12: raised {type(e).__name__}: {str(e)[:400]}")
        return False


def fleet_step(torch, np, card, world, summary, failures):
    """Step 12: phase 14 correct, then under each of ``FLEET_FAULTS``."""
    summary["fleet"] = {}
    ok = fleet_check(torch, np, card, world)
    print(f"step 12 correct: {'ok' if ok else 'FAILED'}")
    summary["fleet"]["correct"] = ok
    if not ok:
        failures.append("correct step 12 failed")
    for name in FLEET_FAULTS:
        with fleet_fault(name):
            ok = fleet_check(torch, np, card, world)
        print(f"step 12 fault {name}: phase 14 "
              f"{'passed (NOT caught)' if ok else 'failed (caught)'}")
        summary["fleet"][name] = not ok
        if ok:
            failures.append(f"step 12 fault {name} not caught by phase 14")


LORA_FAULTS = {"wte_labelled_train": "lora",
               "clip_over_the_full_model": "clip",
               "nu_quantized_linearly": "codec",
               "ema_decay_not_compounded": "callbacks",
               "resume_skips_the_reconcile": "resume"}


@contextlib.contextmanager
def lora_fault(name):
    """Plant one of ``LORA_FAULTS`` in the port's modules (in memory) for
    the duration of the block: the base's ``wte`` labelled "train" (it
    trains, and its gradient, the CE dW, is computed); the LoRA clip taken
    before the frozen gradients are zeroed (over the full model's norm);
    the second moment quantized linearly instead of in the sqrt domain;
    the EMA blending ``decay`` once a stride instead of
    ``decay**advanced``; a resume across an ``opt_state_dtype`` change
    that skips the reconcile."""
    from ray_lightning_tpu_torch.core import callbacks, loop
    from ray_lightning_tpu_torch.models import gpt, optim

    if name == "wte_labelled_train":
        correct = gpt.lora_labels

        def labels(params):
            out = correct(params)
            return {**out, "wte": "train"}

        patches = [(gpt, "lora_labels", labels)]
    elif name == "clip_over_the_full_model":
        def configure(self):
            adamw = optim.gpt_adamw(self.config)
            return optim.chain(
                optim.clip_by_global_norm(1.0),
                optim.multi_transform({"train": optim.identity(),
                                       "freeze": optim.set_to_zero()},
                                      gpt.lora_labels),
                optim.multi_transform({"train": adamw,
                                       "freeze": optim.set_to_zero()},
                                      gpt.lora_labels))

        patches = [(gpt.GPT, "configure_optimizers", configure)]
    elif name == "nu_quantized_linearly":
        correct = optim.quantize_moment

        def linear(v, block_size, sqrt_domain):
            return correct(v, block_size=block_size, sqrt_domain=False)

        patches = [(optim, "quantize_moment", linear)]
    elif name == "ema_decay_not_compounded":
        ema = callbacks.ExponentialMovingAverage

        def update(self, trainer, module, logs, batch_idx):
            gs = trainer.global_step
            if gs == 0 or gs == self._last_step:
                return
            params = trainer.state.params
            if self.ema_params is None:
                self.ema_params = optim.tree_map(
                    lambda t: t.clone(), params)
                self._last_step = gs
                return
            d = self.decay
            self.ema_params = optim.tree_map(
                lambda e, p: e * d + p.to(e.dtype) * (1.0 - d),
                self.ema_params, params)
            self._last_step = gs

        patches = [(ema, "on_train_batch_end", update)]
    else:
        patches = [(loop, "_reconcile_opt_state_format",
                    lambda loaded, template: loaded)]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in
             patches]
    for owner, attr, fault in patches:
        setattr(owner, attr, fault)
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)


def phase11_check(torch, card, which, states):
    """Phase 11's check ``which`` at depth 2 (``states``: the opt-state
    arms' trainers, kept for the resume check); True when it passes."""
    if which == "lora":
        return cs.lora_check(torch, card, n_layer=2, steps=16,
                             eager=False)[0]["ok"]
    if which == "clip":
        return cs.lora_clip_check(torch, card)["ok"]
    if which == "opt_state":
        out, arms = cs.opt_state_arms(torch, card, n_layer=2, steps=24)
        states.setdefault("arms", arms)
        print(f"opt_state: int8 / bf16 final loss rel of the default's "
              f"{out['int8']['loss_rel_vs_default']:.3e} / "
              f"{out['bfloat16']['loss_rel_vs_default']:.3e}")
        return out["ok"]
    if which == "codec":
        return cs.int8_codec_check(torch, card)["ok"]
    if which == "resume":
        return cs.int8_resume_check(torch, card, states["arms"], n_layer=2,
                                    steps=24)["ok"]
    return cs.callbacks_check(torch, card, cs.MEGASTEP_K)["ok"]


# name -> (file under ray_lightning_tpu_torch/, its correct text, the
# replacement, phase 15's arms that must fail)
DIST_FAULTS = {
    "grad_sync_skipped": (
        "parallel/grad_sync.py",
        "        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)\n"
        "        flat.div_(world_size)\n",
        "", ("b_ray",)),
    "zero1_wrong_slice": (
        "parallel/sharding.py",
        "        part = t.narrow(d, self.rank * c, c)\n",
        "        part = t.narrow(d, (self.rank + 1) % self.world * c, c)\n",
        ("b_zero1",)),
    "zero_replicated_unsynced": (
        "parallel/sharding.py",
        "            synced = sync_leaf_buckets([leaves[i] for i in repl],\n"
        "                                       repl_buckets, total,\n"
        "                                       self.replica_group)\n",
        "            synced = [leaves[i] for i in repl]\n", ("b_zero1",)),
    "clip_local_norm": (
        "parallel/sharding.py",
        "            dist.all_reduce(stacked, op=dist.ReduceOp.SUM, "
        "group=self.group)\n", "",
        ("e_zero1",)),
    "result_from_rank1": (
        "core/trainer.py",
        'rank0 = next(r for r in results if r.get("rank") == 0)\n'
        "        self.state",
        'rank0 = next(r for r in results if r.get("rank") == 1)\n'
        "        self.state", ("b_ray",)),
}


def phase15_run(root, arms, phase=15):
    """``chip_smoke.py --phase15 ARMS`` (or ``--phase16``) from ``root``:
    (exit code, the failed check's line)."""
    proc = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py"),
                           f"--phase{phase}", *arms], capture_output=True,
                          text=True, timeout=900, cwd=root)
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    why = next((ln for ln in reversed(lines) if "Error" in ln
                or "check failed" in ln), lines[-1] if lines else "")
    for ln in proc.stdout.splitlines():
        if ln.startswith(f"phase {phase} ("):
            print("  " + ln[:400])
    return proc.returncode, why


@contextlib.contextmanager
def faulty_copy(root, path, subs, step):
    """A temporary copy of the port (and the test helpers and
    ``chip_smoke.py``) with each ``(old, new)`` of ``subs`` written into
    ``path`` under ``ray_lightning_tpu_torch/``; its ``build`` is a link
    to the checkout's, so the kernels are not built again."""
    tmp = tempfile.mkdtemp(prefix="chip_faults-dist-")
    try:
        shutil.copytree(os.path.join(root, "ray_lightning_tpu_torch"),
                        os.path.join(tmp, "ray_lightning_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        os.makedirs(os.path.join(tmp, "tests"))
        shutil.copy(os.path.join(root, "tests", "torch_dist_helpers.py"),
                    os.path.join(tmp, "tests"))
        shutil.copy(os.path.join(root, "chip_smoke.py"), tmp)
        os.symlink(os.path.join(root, "build"), os.path.join(tmp, "build"))
        target = os.path.join(tmp, "ray_lightning_tpu_torch", path)
        text = open(target).read()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"step {step}: the text to replace is "
                                   f"not in {path} once: {old[:60]!r}")
            text = text.replace(old, new)
        with open(target, "w") as f:
            f.write(text)
        yield tmp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dist_step(summary, failures):
    """Step 13: phase 15's arms correct, then each of ``DIST_FAULTS`` from a
    copy of the port with the fault written in (the workers import it:
    they take the driver's ``sys.path``).  The copy's ``build`` is a link
    to the checkout's, so the kernels are not built again."""
    root = os.path.dirname(os.path.abspath(cs.__file__))
    arms = sorted({a for *_, need in DIST_FAULTS.values() for a in need})
    summary["dist"] = {}
    rc, why = phase15_run(root, arms)
    print(f"step 13 correct ({' '.join(arms)}): "
          f"{'ok' if rc == 0 else 'FAILED: ' + why}")
    summary["dist"]["correct"] = rc == 0
    if rc != 0:
        failures.append("correct step 13 failed")
    for name, (path, old, new, need) in DIST_FAULTS.items():
        with faulty_copy(root, path, [(old, new)], 13) as tmp:
            rc, why = phase15_run(tmp, need)
        caught = rc != 0
        verdict = ("failed (caught): " + why[:300] if caught
                   else "passed (NOT caught)")
        print(f"step 13 fault {name}: phase 15 {' '.join(need)} {verdict}")
        summary["dist"][name] = caught
        if not caught:
            failures.append(f"step 13 fault {name} not caught by phase 15")


# name -> (file under ray_lightning_tpu_torch/, its (correct text,
# replacement) pairs, phase 16's arms that must fail)
GRAD_WIRE_FAULTS = {
    "ef_error_without_phase2": (
        "ops/collective_quant.py",
        [("    err[idx * chunk:(idx + 1) * chunk] += _fused_sub("
          "reduced_chunk, q2, s2,\n"
          "                                                     "
          "block_size)\n", "")],
        ("g_nccl",)),
    "partials_not_divided": (
        "parallel/grad_sync.py",
        [("        grads, logs = loss_and_grads(self.module, params, batch, "
          "rng,\n                                     "
          "loss_div=self.n_shards)\n"
          "        grads, new_resid = self.sync_tree(grads, residual)\n"
          "        return grads, logs, new_resid\n",
          "        grads, logs = loss_and_grads(self.module, params, batch, "
          "rng)\n"
          "        grads, new_resid = self.sync_tree(grads, residual)\n"
          "        return tree_unflatten(grads, [\n"
          "            g / self.n_shards for g in tree_leaves(grads)]), "
          "logs, new_resid\n")],
        ("h_cpu_wire",)),
    "side_stream_not_waited": (
        "parallel/overlap.py",
        [("        if self._side is not None:\n"
          "            torch.cuda.current_stream(self.synced.device)"
          ".wait_stream(\n                self._side)\n", "")],
        ("g_nccl",)),
    "segment_untapped": (
        "models/gpt.py",
        [("            subs.append(plane.tap(f\"seg{g}\", {k: v[b:e] for k, "
          "v in\n                                              "
          "blocks.items()}))\n",
          "            sub = {k: v[b:e] for k, v in blocks.items()}\n"
          "            subs.append(plane.tap(f\"seg{g}\", sub)\n"
          "                        if g + 2 < len(bounds) else sub)\n")],
        ("h_cpu_wire",)),
    # The faults a two-rank fit on the card catches (phase 16's
    # ``torch_dist_helpers.WireProbe``): the residual never added to the
    # partials (int8_ef running as int8), the phase-2 error dropped, and
    # the state keeping its old residual row.
    "ef_residual_dropped": (
        "parallel/grad_sync.py",
        [("        if resid is not None:\n"
          "            flat = flat + resid[b.offset:b.offset + b.padded]\n",
          "")],
        ("a_full", "c_int8_ef")),
    "ef_error_without_phase2_fit": (
        "ops/collective_quant.py",
        [("    err[idx * chunk:(idx + 1) * chunk] += _fused_sub("
          "reduced_chunk, q2, s2,\n"
          "                                                     "
          "block_size)\n", "")],
        ("a_full", "c_int8_ef")),
    "ef_residual_stale": (
        "parallel/step_fns.py",
        [("            new.grad_residual = resid\n"
          "            return new, logs\n",
          "            new.grad_residual = state.grad_residual\n"
          "            return new, logs\n")],
        ("a_full", "c_int8_ef")),
}


def grad_wire_step(summary, failures):
    """Step 14: phase 16's arms (g) and (h) correct, then each of
    ``GRAD_WIRE_FAULTS`` from a copy of the port with the fault written
    in (:func:`faulty_copy`)."""
    root = os.path.dirname(os.path.abspath(cs.__file__))
    arms = sorted({a for *_, need in GRAD_WIRE_FAULTS.values()
                   for a in need})
    summary["grad_wire"] = {}
    rc, why = phase15_run(root, arms, phase=16)
    print(f"step 14 correct ({' '.join(arms)}): "
          f"{'ok' if rc == 0 else 'FAILED: ' + why}")
    summary["grad_wire"]["correct"] = rc == 0
    if rc != 0:
        failures.append("correct step 14 failed")
    for name, (path, subs, need) in GRAD_WIRE_FAULTS.items():
        with faulty_copy(root, path, subs, 14) as tmp:
            rc, why = phase15_run(tmp, need, phase=16)
        caught = rc != 0
        verdict = ("failed (caught): " + why[:300] if caught
                   else "passed (NOT caught)")
        print(f"step 14 fault {name}: phase 16 {' '.join(need)} {verdict}")
        summary["grad_wire"][name] = caught
        if not caught:
            failures.append(f"step 14 fault {name} not caught by phase 16")


# name -> (file under ray_lightning_tpu_torch/, its (correct text, faulty
# text) pairs, the unit check of ``torch_dist_helpers.restart_unit_checks``
# that must turn False, whether phase 17 must fail too).
RESTART_FAULTS = {
    "meta_before_barrier": (
        "core/loop.py", [
            ("    sharded_ckpt.save_shard(tree, tag, rank, world)\n"
             "    if ctx.dist is not None:\n"
             "        ctx.dist.barrier()\n",
             "    sharded_ckpt.save_shard(tree, tag, rank, world)\n"),
            ("        _prune_restart_dir(config.restart_dir, keep=2)\n",
             "        _prune_restart_dir(config.restart_dir, keep=2)\n"
             "    if ctx.dist is not None:\n"
             "        ctx.dist.barrier()\n")],
        "write_order", False),
    "discovery_unverified": (
        "parallel/strategies.py", [
            ("        problems = verify_checkpoint(path)\n",
             "        problems = []\n")],
        "walk_back", False),
    "selective_off_by_one_rank": (
        "utils/sharded_ckpt.py", [
            ("    if isinstance(target, Shard) and target.shape == shape:\n"
             "        return target.index\n",
             "    if isinstance(target, Shard) and target.shape == shape:\n"
             "        return tuple((b % s, b % s + b - a) if b - a < s "
             "else (a, b)\n"
             "                     for (a, b), s in zip(target.index, "
             "shape))\n")],
        "selective_slices", True),
    "accum_not_rederived": (
        "core/loop.py", [
            ("    if resize_info is not None:\n"
             "        accum = resize_info[\"accum\"]\n", "")],
        "accum_rederived", True),
    "window_ignored": (
        "parallel/strategies.py", [
            ("        fail_times[:] = [t for t in fail_times\n"
             "                         if now - t <= "
             "self.restart_window_s]\n", "")],
        "window", False),
    "ef_residual_kept": (
        "core/loop.py", [
            ("        elif resid.dim() == 2 and tuple(resid.shape[:1]) == "
             "(world,) \\\n"
             "                and recorded_world == world:\n",
             "        elif resid.dim() == 2 and resid.shape[0] > "
             "ctx.global_rank:\n")],
        "ef_dropped", False),
}


def restart_unit_run(root):
    """``torch_dist_helpers.restart_unit_checks`` of the port under
    ``root``, in a process of its own: {check: passed}."""
    code = ("import json, sys, tempfile; "
            f"sys.path[:0] = [{root!r}, {os.path.join(root, 'tests')!r}]; "
            "import torch; torch.set_num_threads(4); "
            "import torch_dist_helpers as h; "
            "print(json.dumps(h.restart_unit_checks(tempfile.mkdtemp())))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=root)
    if proc.returncode != 0:
        return {"error": proc.stderr.strip().splitlines()[-1:]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def restart_step(summary, failures):
    """Step 15: the unit checks and phase 17 correct, then each of
    ``RESTART_FAULTS`` from a copy of the port with the fault written in
    (:func:`faulty_copy`): its unit check must fail, and phase 17 where
    the entry says so."""
    root = os.path.dirname(os.path.abspath(cs.__file__))
    summary["restart"] = {}
    checks = restart_unit_run(root)
    ok = bool(checks) and all(v is True for v in checks.values())
    print(f"step 15 correct unit checks: {checks}")
    rc, why = phase15_run(root, [], phase=17)
    print(f"step 15 correct phase 17: "
          f"{'ok' if rc == 0 else 'FAILED: ' + why}")
    summary["restart"]["correct"] = ok and rc == 0
    if not (ok and rc == 0):
        failures.append("correct step 15 failed")
    for name, (path, subs, check_name, phase17) in RESTART_FAULTS.items():
        with faulty_copy(root, path, subs, 15) as tmp:
            got = restart_unit_run(tmp)
            unit = got.get(check_name) is False
            caught = {"unit": unit}
            if phase17:
                rc, why = phase15_run(tmp, [], phase=17)
                caught["phase17"] = rc != 0
        verdict = ", ".join(f"{k} {'caught' if v else 'NOT caught'}"
                            for k, v in caught.items())
        print(f"step 15 fault {name}: {check_name} {got.get(check_name)} "
              f"({verdict}){'; ' + why[:300] if phase17 else ''}")
        summary["restart"][name] = all(caught.values())
        if not all(caught.values()):
            failures.append(f"step 15 fault {name} not caught: {caught}")


# name -> (file under ray_lightning_tpu_torch/, its (correct text,
# replacement) pairs, phase 18's arm that must fail)
MULTI_FAULTS = {
    "captured_bucket_skipped": (
        "parallel/grad_sync.py", [
            ("        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)\n"
             "        flat.div_(world_size)\n",
             "        if not (torch.cuda.is_current_stream_capturing()\n"
             "                and b is buckets[-1]):\n"
             "            dist.all_reduce(flat, op=dist.ReduceOp.SUM,\n"
             "                            group=group)\n"
             "        flat.div_(world_size)\n")],
        "a_megastep"),
    "straddle_from_one_half": (
        "ops/optim_quant.py", [
            ("        sh.sync_amax(full)\n", "")],
        "b_int8_zero"),
    "data_allreduce_dropped": (
        "parallel/sharding.py", [
            ("            if self.data_group is not None:\n"
             "                dist.all_reduce(part, op=dist.ReduceOp.SUM,\n"
             "                                group=self.data_group)\n", "")],
        "c_hybrid"),
    "island_dwte_twice": (
        "ops/cross_entropy.py", [
            ("        dist.all_reduce(g, op=dist.ReduceOp.SUM, "
             "group=ctx.group)\n",
             "        dist.all_reduce(g, op=dist.ReduceOp.SUM, "
             "group=ctx.group)\n"
             "        dist.all_reduce(g, op=dist.ReduceOp.SUM, "
             "group=ctx.group)\n")],
        "d_island"),
}


def multi_step(summary, failures):
    """Step 16: each of ``MULTI_FAULTS`` from a copy of the port with the
    fault written in (:func:`faulty_copy`), caught where phase 18's arm
    it names fails (the correct arms run in ``chip_smoke.py``'s own
    phase 18)."""
    root = os.path.dirname(os.path.abspath(cs.__file__))
    summary["multi"] = {}
    for name, (path, subs, arm) in MULTI_FAULTS.items():
        with faulty_copy(root, path, subs, 16) as tmp:
            rc, why = phase15_run(tmp, [arm], phase=18)
        caught = rc != 0
        verdict = ("failed (caught): " + why[:300] if caught
                   else "passed (NOT caught)")
        print(f"step 16 fault {name}: phase 18 {arm} {verdict}")
        summary["multi"][name] = caught
        if not caught:
            failures.append(f"step 16 fault {name} not caught by phase 18")


# name -> (file under ray_lightning_tpu_torch/, its (correct text,
# replacement) pairs, phase 19's arm that must fail)
MODEL_FAULTS = {
    "ring_hop_to_the_wrong_neighbour": (
        "ops/ring_attention.py", [
            ("        return _exchange(x, group, group.rank_at(group.index + 1),"
             "\n                         group.rank_at(group.index - 1))\n",
             "        return _exchange(x, group, group.rank_at(group.index - 1),"
             "\n                         group.rank_at(group.index + 1))\n"),
            ("        return _exchange(grad, g, g.rank_at(g.index - 1),\n"
             "                         g.rank_at(g.index + 1)), None\n",
             "        return _exchange(grad, g, g.rank_at(g.index + 1),\n"
             "                         g.rank_at(g.index - 1)), None\n")],
        "a_ring"),
    "zigzag_positions_off_by_one_chunk": (
        "ops/ring_attention.py", [
            ("        lo, hi = index * c, (2 * n_shards - 1 - index) * c\n",
             "        lo, hi = index * c, (2 * n_shards - 2 - index) * c\n")],
        "a_ring"),
    "moe_combine_without_copy_in": (
        "ops/moe.py", [
            ("    combine = copy_in(combine, expert_tensor)\n", "")],
        "c_moe"),
    "qkv_split_contiguously": (
        "parallel/sharding.py", [
            ("        self.head = [p[-1] in HEAD_ALIGNED for p in self.paths]\n",
             "        self.head = [False for p in self.paths]\n")],
        "b_tensor"),
    "clip_counts_replicated_leaves_t_times": (
        "parallel/sharding.py", [
            ("        return self.mp.axis(axes.pop()) if axes else None\n",
             "        return self.mp.axis(axes.pop()) if axes else "
             "self.mp.tensor\n")],
        "d_clip"),
}


def model_step(summary, failures):
    """Step 17: each of ``MODEL_FAULTS`` from a copy of the port with the
    fault written in (:func:`faulty_copy`), caught where phase 19's arm
    it names fails (the correct arms run in ``chip_smoke.py``'s own
    phase 19)."""
    root = os.path.dirname(os.path.abspath(cs.__file__))
    summary["model"] = {}
    for name, (path, subs, arm) in MODEL_FAULTS.items():
        with faulty_copy(root, path, subs, 17) as tmp:
            rc, why = phase15_run(tmp, [arm], phase=19)
        caught = rc != 0
        verdict = ("failed (caught): " + why[:300] if caught
                   else "passed (NOT caught)")
        print(f"step 17 fault {name}: phase 19 {arm} {verdict}")
        summary["model"][name] = caught
        if not caught:
            failures.append(f"step 17 fault {name} not caught by phase 19")


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
    from ray_lightning_tpu_torch.ops import lora

    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    if sys.argv[1:3] in (["--only", "13"], ["--only", "14"],
                         ["--only", "15"], ["--only", "16"],
                         ["--only", "17"]):
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(_build.build, ("flash_attention", "layer_norm",
                                         "cross_entropy", "bgmv")))
        summary = {}
        {"13": dist_step, "14": grad_wire_step, "15": restart_step,
         "16": multi_step, "17": model_step}[sys.argv[2]](summary,
                                                          failures)
        for f in failures:
            print(f"chip_faults: FAILED: {f}")
        print(card)
        print(json.dumps({"ok": not failures, **summary}))
        return 1 if failures else 0
    if sys.argv[1:3] == ["--only", "12"]:
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(_build.build, ("flash_attention", "layer_norm",
                                         "cross_entropy", "bgmv")))
        summary = {}
        fleet_step(torch, np, card, cs.server_world(torch, np), summary,
                   failures)
        for f in failures:
            print(f"chip_faults: FAILED: {f}")
        print(card)
        print(json.dumps({"ok": not failures, **summary}))
        return 1 if failures else 0
    summary = {"correct": {}, "faults": {}, "step": {}, "ce_correct": {},
               "ce_faults": {}, "ce_f64": {}, "ln_correct": {},
               "ln_faults": {}, "bgmv_faults": {}}
    flash_src = (_build.CSRC / "flash_attention.cu").read_text()
    ce_src = (_build.CSRC / "cross_entropy.cu").read_text()
    ln_src = (_build.CSRC / "layer_norm.cu").read_text()
    bgmv_src = (_build.CSRC / "bgmv.cu").read_text()
    jobs = ([(flash_src, n, [(old, new)])
             for n, (old, new, _) in FAULTS.items()]
            + [(ce_src, n, subs) for n, (subs, _) in CE_FAULTS.items()]
            + [(ln_src, n, subs) for n, (subs, _) in LN_FAULTS.items()]
            + [(bgmv_src, n, subs) for n, subs in BGMV_FAULTS.items()]
            + [(flash_src, "dq_any_order", DQ_ORDER_FAULT)])
    tmp = tempfile.mkdtemp(prefix="chip_faults-")
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(jobs) + 3) as pool:
            built = [pool.submit(_build.build, n) for n in
                     ("flash_attention", "layer_norm", "cross_entropy",
                      "bgmv")]
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
            where = FAULT_SHAPES.get(name, MAIN)
            if not any(k.startswith(f"{where} ") for k in caught):
                failures.append(f"fault {name} not caught at {where}")
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
        ce_shapes = ce_fault_shapes(torch)
        ce_syms = {"rlt_ce_fwd": ce._FWD_ARGTYPES,
                   "rlt_ce_bwd_dx": ce._BWD_ARGTYPES,
                   "rlt_ce_bwd_dw": ce._BWD_ARGTYPES}
        for name in (None, *CE_FAULTS):
            use(_build, "cross_entropy", ce_syms,
                None if name is None else libs[name])
            caught = {}
            for where, shape in ce_shapes.items():
                for seed in ((0, 1) if name is None else (0,)):
                    label = f"{name or 'correct'} {where}"
                    for n, (m, bad) in ce_readings(torch, ce, shape,
                                                   seed).items():
                        print(f"ce {label} seed {seed} {n}: {fmt(m)} over "
                              f"the limit: {bad}")
                        if name is None:
                            summary["ce_correct"][f"{where} {seed} {n}"] = m
                            if bad:
                                failures.append(f"correct ce {label} {n}")
                        else:
                            summary["ce_faults"].setdefault(name, {})[
                                f"{where} {n}"] = {**m, "over": bad}
                            if bad:
                                caught.setdefault(where, []).append(n)
            if name is None:
                continue
            must = CE_FAULTS[name][1]
            print(f"ce fault {name}: caught at {caught or 'no shape'}")
            if must is None:
                continue
            if not caught:
                failures.append(f"ce fault {name} not caught")
            for where in must:
                if where not in caught:
                    failures.append(f"ce fault {name} not caught at the "
                                    f"{where} shape")
        # The correct kernels and the f64 faults against f64: dx and dW
        # within chip_smoke.F64_FROB_LIMIT, and the faults over it.
        for name in (None, *CE_F64_FAULTS):
            use(_build, "cross_entropy", ce_syms,
                None if name is None else libs[name])
            f64 = ce_f64_readings(torch, ce, ce_shapes["bf16 main"])
            label = name or "correct"
            bad = [n for n in ("dx", "dW")
                   if not f64[n][1] <= cs.F64_FROB_LIMIT]
            print(f"ce {label} bf16 main against f64: " + ", ".join(
                f"{n} max abs {a:.3e} frob {f:.3e}"
                for n, (a, f) in f64.items())
                + f"; over the limit {cs.F64_FROB_LIMIT:.0e}: {bad}")
            summary["ce_f64"][label] = {**f64, "over": bad}
            if name is None and bad:
                failures.append(f"correct ce against f64: {bad}")
            if name is not None and not bad:
                failures.append(f"ce fault {name} not caught against f64")
        use(_build, "cross_entropy", {}, None)

        # 5. the LN backward, correct and faulty, by phase 5's check
        for name in (None, *LN_FAULTS):
            use(_build, "layer_norm", {"rlt_ln_bwd": ln._BWD_ARGTYPES},
                None if name is None else libs[name])
            caught = {}
            for where, shape in ln_shapes().items():
                for seed in ((0, 1) if name is None else (0,)):
                    label = f"{name or 'correct'} {where}"
                    for n, (m, bad) in ln_readings(torch, ln, shape,
                                                   seed).items():
                        print(f"ln {label} seed {seed} {n}: {fmt(m)} over "
                              f"the limit: {bad}")
                        key = f"{where} {seed} {n}"
                        if name is None:
                            summary["ln_correct"][key] = m
                            if bad:
                                failures.append(f"correct ln {label} {n}")
                        else:
                            summary["ln_faults"].setdefault(name, {})[
                                key] = {**m, "over": bad}
                            if bad:
                                caught.setdefault(where, []).append(n)
            if name is None:
                continue
            print(f"ln fault {name}: caught at {caught or 'no shape'}")
            for where in LN_FAULTS[name][1]:
                if where not in caught:
                    failures.append(f"ln fault {name} not caught at the "
                                    f"{where} shape")
        use(_build, "layer_norm", {}, None)

        # 6. BGMV, correct and faulty, by phase 1's checks
        for name in (None, *BGMV_FAULTS):
            use(_build, "bgmv", bgmv_symbols(lora),
                None if name is None else libs[name])
            lora._scratch_floats.clear()
            gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
            failed = [label for label, ok, _ in
                      cs.bgmv_checks(torch, lora, gen) if not ok]
            label = name or "correct"
            print(f"bgmv {label}: {len(failed)} of phase 1's checks failed"
                  + (f": {failed}" if failed else ""))
            summary["bgmv_faults"][label] = failed
            if name is None and failed:
                failures.append(f"correct bgmv: {failed}")
            if name is not None and not failed:
                failures.append(f"bgmv fault {name} not caught")
        use(_build, "bgmv", {}, None)

        # 7. the host path under megastep, correct and faulty, by phase 9's
        # f32 parity
        summary["megastep"] = {}
        for name in (None, *MEGASTEP_FAULTS):
            label = name or "correct"
            print(f"megastep {label}:")
            if name is None:
                parity = cs.megastep_parity(torch, card)
            else:
                with megastep_fault(name):
                    parity = cs.megastep_parity(torch, card)
            summary["megastep"][label] = parity
            if name is None and not parity["ok"]:
                failures.append("correct megastep: phase 9's parity failed")
            for arm in ("headline", "xla_attention"):
                if name is not None and parity[arm]["ok"]:
                    failures.append(
                        f"megastep fault {name} not caught in {arm}")

        # 8. checkpoints and resume, correct and faulty, by phase 10's f32
        # split-vs-straight parity
        summary["checkpoint"] = {}
        for name in (None, *CHECKPOINT_FAULTS):
            label = name or "correct"
            print(f"checkpoint {label}:")
            if name is None:
                parity = cs.checkpoint_parity(torch, card)
            else:
                with checkpoint_fault(name):
                    parity = cs.checkpoint_parity(torch, card)
            summary["checkpoint"][label] = parity
            if name is None and not parity["ok"]:
                failures.append("correct checkpoints: phase 10's parity "
                                "failed")
            for arm in ("headline", "xla_attention"):
                if name is not None and parity[arm]["ok"]:
                    failures.append(
                        f"checkpoint fault {name} not caught in {arm}")

        # 9. phase 11's checks at depth 2, correct and faulty
        summary["phase11"] = {}
        states = {}
        for which in ("lora", "clip", "opt_state", "codec", "resume",
                      "callbacks"):
            ok = phase11_check(torch, card, which, states)
            print(f"phase 11 {which} correct: {'ok' if ok else 'FAILED'}")
            summary["phase11"][f"correct {which}"] = ok
            if not ok:
                failures.append(f"correct phase 11 {which} failed")
        for name, which in LORA_FAULTS.items():
            with lora_fault(name):
                try:
                    ok = phase11_check(torch, card, which, states)
                except Exception as e:  # noqa: BLE001 - a raise is a catch
                    print(f"phase 11 fault {name}: raised "
                          f"{type(e).__name__}: {e}")
                    ok = False
            print(f"phase 11 fault {name}: {which} check "
                  f"{'passed (NOT caught)' if ok else 'failed (caught)'}")
            summary["phase11"][name] = not ok
            if ok:
                failures.append(f"phase 11 fault {name} not caught by the "
                                f"{which} check")

        # 10. the flash backward's dQ order and the server's features
        summary["serve"] = {}
        world = cs.server_world(torch, np)
        for which in ("repeat", "int8", "early_exit", "chunked", "prefix"):
            ok = serve_check(torch, np, card, which, world, tmp)
            print(f"step 10 {which} correct: {'ok' if ok else 'FAILED'}")
            summary["serve"][f"correct {which}"] = ok
            if not ok:
                failures.append(f"correct step 10 {which} failed")
        for name, which in SERVE_FAULTS.items():
            if name == "dq_any_order":
                use(_build, "flash_attention", {
                    "rlt_flash_fwd": fa._FWD_ARGTYPES,
                    "rlt_flash_bwd": fa._BWD_ARGTYPES}, libs[name])
                ok = serve_check(torch, np, card, which, world, tmp)
                use(_build, "flash_attention", {}, None)
            else:
                with serve_fault(name):
                    ok = serve_check(torch, np, card, which, world, tmp)
            print(f"step 10 fault {name}: {which} check "
                  f"{'passed (NOT caught)' if ok else 'failed (caught)'}")
            summary["serve"][name] = not ok
            if ok:
                failures.append(f"step 10 fault {name} not caught by the "
                                f"{which} check")

        # 11. the serving control plane
        summary["plane"] = {}
        ok = plane_check(torch, np, card, world)
        print(f"step 11 correct: {'ok' if ok else 'FAILED'}")
        summary["plane"]["correct"] = ok
        if not ok:
            failures.append("correct step 11 failed")
        for name in PLANE_FAULTS:
            with plane_fault(name):
                ok = plane_check(torch, np, card, world)
            print(f"step 11 fault {name}: phase 13 "
                  f"{'passed (NOT caught)' if ok else 'failed (caught)'}")
            summary["plane"][name] = not ok
            if ok:
                failures.append(f"step 11 fault {name} not caught by "
                                f"phase 13")

        # 12. disaggregated serving
        fleet_step(torch, np, card, world, summary, failures)

        # 13. multi-GPU training
        dist_step(summary, failures)

        # 14. the data-parallel gradient wire
        grad_wire_step(summary, failures)

        # 15. restarts
        restart_step(summary, failures)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for f in failures:
        print(f"chip_faults: FAILED: {f}")
    print(card)
    print(json.dumps({"ok": not failures, **summary}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
