"""The root scripts that run on the card, checked where they can be here.

``chip_faults.py``, ``chip_flash_variants.py`` and ``chip_ce_variants.py``
build mutated copies of the port's CUDA sources by text substitution; a
substitution whose text no longer occurs exactly once would stop the
script on the card, after its build.  Here every substitution is applied
to the checkout's sources, and every script (``chip_smoke.py`` and
``chip_serve_compare.py`` too) is run without a card, where it must exit 1
and print no result.
"""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "ray_lightning_tpu_torch" / "ops" / "csrc"


@pytest.fixture
def scripts(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_ce_variants
    import chip_faults
    import chip_flash_variants
    return chip_faults, chip_flash_variants, chip_ce_variants


def _apply_all(mutate, source, table):
    for name, subs in table.items():
        mutated = mutate(source, name, subs)
        assert mutated != source or not subs, name


def test_flash_faults_apply_once(scripts):
    cf = scripts[0]
    source = (CSRC / "flash_attention.cu").read_text()
    _apply_all(cf.mutate, source, {n: [(old, new)] for n, (old, new, _)
                                   in cf.FAULTS.items()})
    assert len(cf.FAULTS) == 9
    assert set(cf.FAULT_SHAPES) <= set(cf.FAULTS)
    assert set(cf.FAULT_SHAPES.values()) <= set(cf.SHAPES)


def test_dq_order_fault_applies_once_and_serve_faults_name_a_check(
        scripts):
    """Step 10's compiled fault (dQ added in any order) applies once; the
    in-memory ones each name one of the step's checks and restore what
    they patch."""
    cf = scripts[0]
    source = (CSRC / "flash_attention.cu").read_text()
    _apply_all(cf.mutate, source, {"dq_any_order": cf.DQ_ORDER_FAULT})
    assert set(cf.SERVE_FAULTS.values()) <= {
        "repeat", "int8", "early_exit", "chunked", "prefix"}
    from ray_lightning_tpu_torch.models import quant
    from ray_lightning_tpu_torch.serve import engine, kv_cache

    before = (quant._quantize, engine.accepted_drafts,
              engine.ServeEngine._run_chunk, kv_cache.PrefixIndex.claim,
              engine.ServeEngine.remove_adapter)
    for name in cf.SERVE_FAULTS:
        if name == "dq_any_order":
            continue
        with cf.serve_fault(name):
            during = (quant._quantize, engine.accepted_drafts,
                      engine.ServeEngine._run_chunk,
                      kv_cache.PrefixIndex.claim,
                      engine.ServeEngine.remove_adapter)
            assert sum(a is not b for a, b in zip(before, during)) == 1
    assert before == (quant._quantize, engine.accepted_drafts,
                      engine.ServeEngine._run_chunk,
                      kv_cache.PrefixIndex.claim,
                      engine.ServeEngine.remove_adapter)


def test_ce_faults_apply_once(scripts):
    cf = scripts[0]
    source = (CSRC / "cross_entropy.cu").read_text()
    _apply_all(cf.mutate, source, {n: subs for n, (subs, _)
                                   in cf.CE_FAULTS.items()})
    assert len(cf.CE_FAULTS) == 11
    shapes = {"bf16 main", "f32 main", "bf16 ragged", "f32 ragged"}
    for _, must in cf.CE_FAULTS.values():
        assert must is None or set(must) <= shapes


def test_ln_faults_apply_once(scripts):
    cf = scripts[0]
    source = (CSRC / "layer_norm.cu").read_text()
    _apply_all(cf.mutate, source, {n: subs for n, (subs, _)
                                   in cf.LN_FAULTS.items()})
    assert len(cf.LN_FAULTS) == 4
    for _, must in cf.LN_FAULTS.values():
        assert must and set(must) <= set(cf.ln_shapes())


def test_bgmv_faults_apply_once(scripts):
    cf = scripts[0]
    source = (CSRC / "bgmv.cu").read_text()
    _apply_all(cf.mutate, source, cf.BGMV_FAULTS)
    assert len(cf.BGMV_FAULTS) == 5


def test_bgmv_variants_apply_once(scripts):
    cf, cv = scripts[0], scripts[2]
    _apply_all(cf.mutate, (CSRC / "bgmv.cu").read_text(),
               {n: subs for n, (subs, _) in cv.BGMV_VARIANTS.items()})


def test_flash_variants_apply_once(scripts):
    source = (CSRC / "flash_attention.cu").read_text()
    cf, fv = scripts[0], scripts[1]
    _apply_all(cf.mutate, source, {n: subs for n, (subs, _)
                                   in fv.VARIANTS.items()})


def test_ce_variants_apply_once(scripts):
    source = (CSRC / "cross_entropy.cu").read_text()
    cf, cv = scripts[0], scripts[2]
    _apply_all(cf.mutate, source, {n: subs for n, (subs, _)
                                   in cv.VARIANTS.items()})


def test_fwd_and_ln_variants_apply_once(scripts):
    cf, cv = scripts[0], scripts[2]
    _apply_all(cf.mutate, (CSRC / "cross_entropy.cu").read_text(),
               {n: subs for n, (subs, _) in cv.FWD_VARIANTS.items()})
    _apply_all(cf.mutate, (CSRC / "layer_norm.cu").read_text(),
               {n: subs for n, (subs, _) in cv.LN_VARIANTS.items()})


def test_a_substitution_that_misses_raises(scripts):
    with pytest.raises(RuntimeError, match="occurs 0 times"):
        scripts[0].mutate("int a;", "x", [("int b;", "int c;")])
    with pytest.raises(RuntimeError, match="occurs 2 times"):
        scripts[0].mutate("a a", "x", [("a", "b")])


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_faults.py",
                                    "chip_flash_variants.py",
                                    "chip_ce_variants.py",
                                    "chip_serve_compare.py"])
def test_script_without_a_card_exits_1_and_prints_no_result(script):
    proc = subprocess.run([sys.executable, str(ROOT / script)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_serve_compare_alternates_the_checkouts():
    import chip_serve_compare as sc

    assert sc.order(["a", "b"], 3) == ["a", "b", "b", "a", "a", "b"]
    assert sc.order(["."], 2) == [".", "."]


def test_ce_phase_points_apply_once(scripts):
    source = (CSRC / "cross_entropy.cu").read_text()
    cv = scripts[2]
    for name, start, end, who in cv.PHASES:
        timed = cv.phase_source(source, name, start, end, who)
        assert "rlt_phase_read" in timed and "since = clock();" in timed


@pytest.mark.parametrize("mangled,name", [
    ("_ZN49_GLOBAL__N__271742d1_16_cross_entropy_cu_7cc12e8822ce_grad_"
     "cluster_kernelILb1EEEvPK13__nv_bfloat16S3_PKiPKfS7_Pfiii",
     "ce_grad_cluster_kernel<1>"),
    ("_ZN49_GLOBAL__N__83e6d51b_16_cross_entropy_cu_7cc12e8813ce_fwd_"
     "kernelI13__nv_bfloat16EEvPKT_S4_PKiPfS7_iii", "ce_fwd_kernel"),
    ("_ZN12_GLOBAL__N_119tc_flash_fwd_kernelILi64EEEvPK13__nv_bfloat16",
     "tc_flash_fwd_kernel<64>"),
    ("_ZN12_GLOBAL__N_118ln_bwd_rows_kernelILi3ELb1EEEvPK13__nv_bfloat16",
     "ln_bwd_rows_kernel<3, 1>"),
    ("void (anonymous namespace)::ln_bwd_rows_kernel<3, true>(__nv_bfloat16 "
     "const*, float const*, long long, int)", "ln_bwd_rows_kernel<3, true>"),
    ("bgmv_kernel", "bgmv_kernel")])
def test_ptxas_names_are_read_past_the_namespace_hash(monkeypatch, mangled,
                                                      name):
    """A digit run may end an anonymous namespace's hash and begin the
    kernel's length prefix (``...e88`` + ``22``): ``kernel_name`` still
    finds the kernel, so phase 0 reads its registers and spills."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    assert chip_smoke.kernel_name(mangled) == name


def test_plane_faults_patch_one_thing_each_and_restore(scripts):
    """Step 11's in-memory faults each replace exactly one attribute of
    the port and put it back."""
    cf = scripts[0]
    from ray_lightning_tpu_torch.serve import client, engine, lora, scheduler
    from ray_lightning_tpu_torch.telemetry import export_prom

    def targets():
        return (client.ServeClient.stream, scheduler.Scheduler.poll,
                lora.decode_adapter, export_prom._render_serve,
                engine.ServeEngine._reply)

    before = targets()
    assert len(cf.PLANE_FAULTS) == 5
    for name in cf.PLANE_FAULTS:
        with cf.plane_fault(name):
            during = targets()
            assert sum(a is not b for a, b in zip(before, during)) == 1
    assert targets() == before


def test_phase13_client_metrics_and_client_mode(scripts, tmp_path):
    """Phase 13's client-side metrics, and its client process mode,
    which answers nothing and exits 0 at the end of its input."""
    import chip_smoke as cs

    m = cs.stream_metrics([0.0, 0.5], [[0.1, 0.2, 0.4], [0.8, 1.0]],
                          [3, 2])
    assert m["ttft_p50_ms"] == pytest.approx(300.0)
    assert m["itl_p50_ms"] == pytest.approx(200.0)
    assert m["tokens_per_s"] == pytest.approx(5.0)
    from ray_lightning_tpu_torch.cluster.queue import DriverQueue

    q = DriverQueue()
    try:
        h = q.handle
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--serve-client",
             h.host, str(h.port)], cwd=ROOT, input="", capture_output=True,
            text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout == ""
    finally:
        q.shutdown()


def test_fleet_faults_patch_one_thing_each_and_restore(scripts):
    """Step 12's in-memory faults each replace exactly one attribute of
    the port and put it back."""
    cf = scripts[0]
    from ray_lightning_tpu_torch.serve import client, engine
    from ray_lightning_tpu_torch.serve.dist import prefill, router

    def targets():
        return (engine.import_blocks, client.ServeClient.stream,
                engine.ServeEngine.export_resident,
                prefill.PrefillRunner._prefill, router.Router._is_lost)

    before = targets()
    assert len(cf.FLEET_FAULTS) == 5
    for name in cf.FLEET_FAULTS:
        with cf.fleet_fault(name):
            during = targets()
            assert sum(a is not b for a, b in zip(before, during)) == 1
    assert targets() == before


def test_phase14_rehearses_on_the_cpu(scripts, monkeypatch):
    """Phase 14's control flow and gates at a tiny size on the CPU (one
    timed run an arm, shorter kill streams): every gate passes."""
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from ray_lightning_tpu_torch.models.gpt import (
        GPT, GPTConfig, synthetic_lora_adapter,
    )
    from ray_lightning_tpu_torch.serve.engine import ServeConfig

    monkeypatch.setattr(cs, "KILL_NEW", 40)
    monkeypatch.setattr(cs, "KILL_AFTER", 6)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = GPTConfig(vocab_size=512, n_layer=2, n_head=4, d_model=64,
                        seq_len=256)
        module = GPT(cfg, device="cpu")
        gen = torch.Generator().manual_seed(0)
        params = module.init_params(gen)
        for key in ("qkv_w", "proj_w", "mlp_in_w", "mlp_out_w"):
            params["blocks"][key] = params["blocks"][key] * 10.0
        lora_cfg = dataclasses.replace(cfg, lora_rank=4)
        tenants, trees = {}, {None: params}
        for i in range(2):
            adapter, merged = synthetic_lora_adapter(params, lora_cfg, gen,
                                                     scale=0.3)
            tenants[f"tenant{i}"], trees[f"tenant{i}"] = adapter, merged
        rng = np.random.default_rng(0)
        names = [None, "tenant0", "tenant1"]
        reqs = [(rng.integers(0, 512, size=(int(rng.integers(32, 61)),))
                 .tolist(), int(rng.integers(8, 16)), names[i % 3])
                for i in range(4)]
        world = {"cfg": cfg, "module": module, "params": params,
                 "tenants": tenants, "trees": trees, "reqs": reqs,
                 "serve_cfg": ServeConfig(num_slots=4, block_size=16,
                                          max_adapters=2, adapter_rank=4)}
        out = cs.phase_serve_fleet(torch, np, "cpu", world, repeats=1,
                                   device="cpu")
    finally:
        torch.set_num_threads(n)
    assert out["a"]["kv_imports"] == len(reqs) and out["a"]["prefills"] == 0
    assert out["b"]["bitwise"] and out["d"]["migrations_in"] == 2
    assert out["c"]["re_emitted"] > 0 and out["f"]["exact"] == len(reqs)


def test_dist_faults_apply_once_and_name_phase15_arms(scripts):
    """Step 13 writes each fault into a copy of the port: its text occurs
    once in the checkout's file, and the arms it runs are phase 15's."""
    cf = scripts[0]
    import chip_smoke

    assert len(cf.DIST_FAULTS) == 5
    for name, (path, old, new, arms) in cf.DIST_FAULTS.items():
        text = (ROOT / "ray_lightning_tpu_torch" / path).read_text()
        assert text.count(old) == 1 and old != new, name
        assert arms and set(arms) <= set(chip_smoke.P15_ARMS), name


def test_grad_wire_faults_apply_once_and_name_phase16_arms(scripts):
    """Step 14 writes each fault into a copy of the port: each of its
    texts occurs once in the checkout's file, and the arms it runs are
    phase 16's."""
    cf = scripts[0]
    import chip_smoke

    assert len(cf.GRAD_WIRE_FAULTS) == 7
    for name, (path, subs, arms) in cf.GRAD_WIRE_FAULTS.items():
        text = (ROOT / "ray_lightning_tpu_torch" / path).read_text()
        for old, new in subs:
            assert text.count(old) == 1 and old != new, name
        assert arms and set(arms) <= set(chip_smoke.P16_ARMS), name


def test_restart_faults_apply_once_and_name_unit_checks(scripts):
    """Step 15 writes each fault into a copy of the port: each of its
    texts occurs once in the checkout's file, and the check it names is
    one of ``torch_dist_helpers.restart_unit_checks``'s."""
    cf = scripts[0]
    import inspect

    import torch_dist_helpers as helpers

    names = set(re.findall(r"out\[\"(\w+)\"\]", inspect.getsource(
        helpers.restart_unit_checks)))
    assert len(cf.RESTART_FAULTS) == 6
    assert {c for _, _, c, _ in cf.RESTART_FAULTS.values()} == names
    for name, (path, subs, check, _) in cf.RESTART_FAULTS.items():
        text = (ROOT / "ray_lightning_tpu_torch" / path).read_text()
        for old, new in subs:
            assert text.count(old) == 1 and old != new, name


def test_multi_faults_apply_once_and_name_phase18_arms(scripts):
    """Step 16 writes each fault into a copy of the port: each of its
    texts occurs once in the checkout's file, each part's fault names the
    phase 18 arm that must catch it, one a part."""
    cf = scripts[0]
    import chip_smoke

    assert len(cf.MULTI_FAULTS) == 4
    assert sorted(arm for *_, arm in cf.MULTI_FAULTS.values()) == sorted(
        chip_smoke.P18_ARMS)
    for name, (path, subs, arm) in cf.MULTI_FAULTS.items():
        text = (ROOT / "ray_lightning_tpu_torch" / path).read_text()
        for old, new in subs:
            assert text.count(old) == 1 and old != new, name


@pytest.mark.parametrize("mangled,kernel", [
    ("_Z13ln_fwd_kernelPKfS0_S0_Pfiif", "ln_fwd"),
    ("_Z22ce_grad_cluster_kernelILi1EEvPK13__nv_bfloat16S2_PKiPKfS6_Pfiiii",
     "ce_bwd_dw"),
    ("_Z22ce_grad_cluster_kernelILi0EEvPK13__nv_bfloat16S2_PKiPKfS6_Pfiiii",
     "ce_bwd_dx"),
    ("_ZN12_GLOBAL__N_119tc_flash_fwd_kernelILi64ELb1EEEvv", "flash_fwd"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", None),
])
def test_phase18_graph_parser_counts_kernels_and_nccl(mangled, kernel):
    """Phase 18 (a) reads a captured graph's nodes by mangled name: each
    training kernel under its phase 9 key, NCCL's kernels apart."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    counts, nccl = chip_smoke.p18_graph_counts({mangled: 3, "_Z3foov": 2})
    assert nccl == (3 if kernel is None else 0)
    assert counts == {k: (3 if k == kernel else 0)
                      for k in chip_smoke.GRAPH_NAMES}


def test_phase18_refuses_unknown_arms_and_capture_off_the_card():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    with pytest.raises(RuntimeError, match="phase 18 arms"):
        chip_smoke.phase18_main(("z_nothing",), device="cpu")
    with pytest.raises(RuntimeError, match="captures on the card"):
        chip_smoke.phase18_main(("a_megastep",), device="cpu")


def test_staged_phases_run_every_remote_stage_before_any_check(
        monkeypatch):
    """Phases 15-18 in one process (``run_staged``): every phase's needs
    are asked first and merged (the largest count a pool), every remote
    stage runs before any check stage, each result carries its stages'
    wall, and a phase with a fourth stage is refused."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    order, asked = [], []
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    monkeypatch.setattr(chip_smoke, "multi_pools",
                        lambda need, device: asked.append(need) or {})

    def phase(n, need, stages=3):
        order.append((n, "ask"))
        yield need, []
        order.append((n, "remote"))
        yield
        order.append((n, "check"))
        if stages > 3:
            yield
        return {"n": n}

    out = chip_smoke.run_staged({15: phase(15, {"cpu": 2, "gloo": 2}),
                                 16: phase(16, {"cpu": 3})}, "cpu")
    assert asked == [{"cpu": 3, "gloo": 2}]
    assert order == [(15, "ask"), (16, "ask"), (15, "remote"),
                     (16, "remote"), (15, "check"), (16, "check")]
    assert out[15]["n"] == 15 and out[16]["wall_s"] >= 0
    assert out["spawn_s"] >= 0
    with pytest.raises(RuntimeError, match="fourth stage"):
        chip_smoke.run_staged({17: phase(17, {}, stages=4)}, "cpu")


def test_phase18_rehearses_on_the_cpu(monkeypatch, capsys):
    """Phase 18's arms (b)-(d) on CPU workers at a narrow width: its
    checks pass, its last line is the result the main script reads."""
    import json

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from ray_lightning_tpu_torch.models.gpt import GPTConfig

    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    cfg = GPTConfig(vocab_size=256, n_layer=2, n_head=4, d_model=128,
                    seq_len=64, warmup_steps=1)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert chip_smoke.phase18_main(
            ("b_int8_zero", "c_hybrid", "d_island"), device="cpu", cfg=cfg,
            island={"B": 2, "T": 64, "d": 128, "V": 512}) == 0
    finally:
        torch.set_num_threads(n)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) >= {"b", "c", "d", "wall_s", "spawn_s"}
    assert out["c"]["layout"] == [[0, 2, 2], [1, 2, 2], [0, 2, 2],
                                  [1, 2, 2]]
    assert out["d"]["collectives"][0]["all_reduce"] == 1
    assert all(out["b"][z]["moment_rel"] <= chip_smoke.P18_MOMENT_REL
               for z in ("zero1", "zero3"))


def test_step_split_books_each_part_once():
    """Phase 16's traced step (``torch_dist_helpers.split_step``): the
    collectives inside the sync, gather and norm ranges, the update less
    its gather and norm, the copies as the sync ranges less their
    collectives, the gaps as the rest of the wall."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_dist_helpers as helpers

    rec = {"wall_ms": 100.0, "ms": {
        "grads": 30.0, "mean_logs": 2.0, "collective@mean_logs": 1.5,
        "reduce_scatter": 20.0, "collective@reduce_scatter": 18.0,
        "update": 35.0, "all_gather": 15.0, "collective@all_gather": 14.0,
        "norm_sq": 3.0, "collective@norm_sq": 2.0}}
    assert helpers.split_step(rec) == {
        "grads": 30.0, "collectives": 34.0, "update": 17.0, "copies": 4.0,
        "gaps": 100.0 - 30.0 - 2.0 - 38.0 - 17.0, "mean_logs": 2.0}


def test_model_faults_apply_once_and_name_phase19_arms(scripts):
    """Step 17 writes each fault into a copy of the port: each of its
    texts occurs once in the checkout's file, and the arm it names is
    phase 19's."""
    cf = scripts[0]
    import chip_smoke

    assert len(cf.MODEL_FAULTS) == 5
    assert {arm for *_, arm in cf.MODEL_FAULTS.values()} == set(
        chip_smoke.P19_ARMS)
    for name, (path, subs, arm) in cf.MODEL_FAULTS.items():
        text = (ROOT / "ray_lightning_tpu_torch" / path).read_text()
        for old, new in subs:
            assert text.count(old) == 1 and old != new, name


def test_phase19_rehearses_on_the_cpu(monkeypatch, capsys):
    """Phase 19's arms on CPU workers at a narrow width and a short ring
    (the one-rank arm of (c) on a CPU rank over gloo): its checks pass,
    its last line is the result the main script reads."""
    import json

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from ray_lightning_tpu_torch.models.gpt import GPTConfig

    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    cfg = GPTConfig(vocab_size=256, n_layer=2, n_head=4, d_model=64,
                    seq_len=32, warmup_steps=1)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert chip_smoke.phase19_main(device="cpu", cfg=cfg,
                                       ring_t=64) == 0
    finally:
        torch.set_num_threads(n)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) >= {"a", "b", "c", "d", "wall_s", "spawn_s"}
    assert out["a"]["zigzag"]["route"] == "gloo"
    assert out["c"]["nccl"]["bitwise"] and out["c"]["decode"]["equal"]
    assert all(h == 2 for h in out["b"]["p19_tp_data_tensor"]["heads"]
               .values())
    with pytest.raises(RuntimeError, match="phase 19 arms"):
        chip_smoke.phase19_main(("z_nothing",), device="cpu")


def test_mpmd_faults_apply_once_and_name_phase20_arms(scripts):
    """Step 18 writes each fault into a copy of the port: each of its
    texts occurs once in the checkout's file, and the arm it names is
    phase 20's (every arm named by one fault at least)."""
    cf = scripts[0]
    import chip_smoke

    assert len(cf.MPMD_FAULTS) == 5
    assert {arm for *_, arm in cf.MPMD_FAULTS.values()} == set(
        chip_smoke.P20_ARMS)
    for name, (path, subs, arm) in cf.MPMD_FAULTS.items():
        text = (ROOT / "ray_lightning_tpu_torch" / path).read_text()
        for old, new in subs:
            assert text.count(old) == 1 and old != new, name


def test_phase20_rehearses_on_the_cpu(monkeypatch, capsys):
    """Phase 20's arms on two CPU stage workers at a narrow width: its
    checks pass (the f32 fit against the reference and the int8 wire's
    ratio, the bf16 interleaved fit's wire and its kernel counters, the
    restart bitwise), its last
    line is the result the main script reads."""
    import json

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from ray_lightning_tpu_torch.models.gpt import GPTConfig

    monkeypatch.setattr(chip_smoke, "card_line", lambda: "cpu")
    cfg = GPTConfig(vocab_size=256, n_layer=4, n_head=4, d_model=64,
                    seq_len=64, warmup_steps=1)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert chip_smoke.phase20_main(device="cpu", cfg=cfg) == 0
    finally:
        torch.set_num_threads(n)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) >= {"a", "b", "c", "wall_s", "spawn_s"}
    assert out["a"]["loss_diff"] <= chip_smoke.P20_LOSS_ATOL
    assert out["a"]["wire"]["wire_ratio"] >= chip_smoke.P20_WIRE_RATIO
    assert out["c"]["restarts"] == 1
    assert out["c"]["losses"] == out["c"]["clean_losses"][2:]
    with pytest.raises(RuntimeError, match="phase 20 arms"):
        chip_smoke.phase20_main(("z_nothing",), device="cpu")
