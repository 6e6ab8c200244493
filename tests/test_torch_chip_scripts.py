"""The root scripts that run on the card, checked where they can be here.

``chip_faults.py``, ``chip_flash_variants.py`` and ``chip_ce_variants.py``
build mutated copies of the port's CUDA sources by text substitution; a
substitution whose text no longer occurs exactly once would stop the
script on the card, after its build.  Here every substitution is applied
to the checkout's sources, and every script is run without a card, where
it must exit 1 and print no result.
"""

import pathlib
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
                                    "chip_ce_variants.py"])
def test_script_without_a_card_exits_1_and_prints_no_result(script):
    proc = subprocess.run([sys.executable, str(ROOT / script)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout


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
