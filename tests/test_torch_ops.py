"""The PyTorch port's operators held against the JAX package (CPU).

Inputs are made with numpy from a seed and fed to both packages.  The
BGMV reference is both JAX arms: the gathered einsum and the Pallas
kernel under the interpreter (as ``tests/test_serve_lora.py`` runs it).
Tolerances: f32 LayerNorm atol 1e-6 (one rsqrt and a few f32 roundings
apart), BGMV rtol/atol 1e-5 (two f32 products summed in another order).
"""

import os
import pkgutil
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.ops.layer_norm import _xla_layer_norm
from ray_lightning_tpu.ops.lora import bgmv_pallas, bgmv_xla
from ray_lightning_tpu.ops.lora import lora_delta as jax_lora_delta
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.ops import _build
from ray_lightning_tpu_torch.ops import lora as tlora
from ray_lightning_tpu_torch.ops.layer_norm import layer_norm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bgmv_case(seed=0, W=5, d=16, r=4, k=12, N=3, run=None):
    """Random ids, or with ``run`` ids in runs of that many rows (the
    prefill rows of consecutive sequences), cycling through the slots."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((W, d)).astype(np.float32)
    a = rng.standard_normal((N, d, r)).astype(np.float32)
    b = rng.standard_normal((N, r, k)).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0  # slot 0 = the null adapter
    if run is None:
        ids = rng.integers(0, N, size=(W,)).astype(np.int32)
    else:
        ids = ((np.arange(W) // run + 1) % N).astype(np.int32)
    return h, a, b, ids


def _torch(*arrays):
    return [torch.from_numpy(np.array(x)) for x in arrays]


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 128), (2, 5, 64)])
def test_layer_norm_matches_xla_reference(shape):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * 3 + 0.5).astype(np.float32)
    g = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(_xla_layer_norm(*map(jnp.asarray, (x, g, b))))
    got = layer_norm(*_torch(x, g, b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_layer_norm_keeps_input_dtype():
    x = torch.randn(3, 8, dtype=torch.bfloat16)
    y = layer_norm(x, torch.ones(8), torch.zeros(8))
    assert y.dtype == torch.bfloat16
    ref = layer_norm(x.float(), torch.ones(8), torch.zeros(8))
    torch.testing.assert_close(y.float(), ref.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# BGMV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(seed=0),
    dict(seed=1, W=9, d=32, r=8, k=40, N=5),
    dict(seed=2, W=1, d=8, r=1, k=3, N=2),
    # runs of 50 rows straddle the kernel's 64-row tiles (rows 50, 100)
    dict(seed=3, W=130, d=24, r=8, k=20, N=4, run=50),
])
def test_bgmv_plain_matches_jax_xla_and_pallas(case):
    h, a, b, ids = _bgmv_case(**case)
    got = tlora.bgmv_plain(*_torch(h, a, b, ids)).numpy()
    jargs = [jnp.asarray(x) for x in (h, a, b, ids)]
    np.testing.assert_allclose(got, np.asarray(bgmv_xla(*jargs)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(bgmv_pallas(*jargs)),
                               rtol=1e-5, atol=1e-5)


def test_bgmv_on_cpu_runs_plain_and_counts_no_launch():
    h, a, b, ids = _torch(*_bgmv_case())
    before = tlora.bgmv.launches
    got = tlora.bgmv(h, a, b, ids)
    assert torch.equal(got, tlora.bgmv_plain(h, a, b, ids))
    assert tlora.bgmv.launches == before


@pytest.mark.parametrize("impl", tlora.LORA_IMPLS)
def test_null_slot_delta_is_exactly_zero(impl):
    h, a, b, _ = _torch(*_bgmv_case())
    zero_ids = torch.zeros(h.shape[0], dtype=torch.int32)
    got = tlora.lora_delta(h, a, b, zero_ids, impl=impl)
    assert (got == 0.0).all()


@pytest.mark.parametrize("impl", tlora.LORA_IMPLS)
def test_three_dim_form_repeats_ids_per_position(impl):
    h, a, b, ids = _bgmv_case(W=6)
    B, T = 2, 3
    seq_ids = ids.reshape(B, T)[:, 0].copy()
    want = np.asarray(jax_lora_delta(
        jnp.asarray(h.reshape(B, T, -1)), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(seq_ids),
    ))
    th, ta, tb, tids = _torch(h.reshape(B, T, -1), a, b, seq_ids)
    got = tlora.lora_delta(th, ta, tb, tids, impl=impl).numpy()
    assert got.shape == (B, T, b.shape[-1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_apply_lora_without_adapters_is_identity():
    y = torch.randn(2, 4)
    assert tlora.apply_lora(y, torch.randn(2, 3), None, "qkv", None,
                            "kernel") is y


def test_lora_delta_rejects_unknown_impl():
    h, a, b, ids = _torch(*_bgmv_case())
    with pytest.raises(ValueError, match="impl"):
        tlora.lora_delta(h, a, b, ids, impl="xla")


def test_bgmv_plain_casts_factors_to_activation_dtype():
    h, a, b, ids = _torch(*_bgmv_case())
    got = tlora.bgmv_plain(h.to(torch.bfloat16), a, b, ids)
    assert got.dtype == torch.bfloat16
    ref = tlora.bgmv_plain(h.to(torch.bfloat16).float(),
                           a.to(torch.bfloat16).float(),
                           b.to(torch.bfloat16).float(), ids)
    torch.testing.assert_close(got.float(), ref.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# Build and device rules
# ---------------------------------------------------------------------------

def test_failed_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'bgmv.cu(1): error: boom' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="boom"):
        _build.build("bgmv")
    assert not list((tmp_path / "kernels").rglob("*.so*"))


def test_library_path_is_keyed_by_source_and_flags(monkeypatch):
    path = _build.library_path("bgmv")
    assert path.name == "libbgmv.so" and path.parent.name.startswith("bgmv-")
    assert _build.library_path("bgmv") == path
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("bgmv") != path


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port imports in a fresh interpreter without
    loading jax or any module of ray_lightning_tpu (this process has both
    loaded already, so the check runs in a subprocess), and checkpoints
    (the default, an int8 and a LoRA state) round-trip there with jax,
    msgpack and ml_dtypes blocked."""
    import ray_lightning_tpu_torch

    names = sorted(
        m.name for m in pkgutil.walk_packages(
            ray_lightning_tpu_torch.__path__, "ray_lightning_tpu_torch.")
    )
    assert "ray_lightning_tpu_torch.serve.engine" in names
    assert "ray_lightning_tpu_torch.utils.state_stream" in names
    code = textwrap.dedent(f"""
        import importlib, os, sys, tempfile
        for blocked in ("jax", "msgpack", "ml_dtypes"):
            sys.modules[blocked] = None  # importing it raises
        for name in {names!r}:
            importlib.import_module(name)
        bad = [m for m in sys.modules if m == "ray_lightning_tpu"
               or m.startswith("ray_lightning_tpu.")]
        assert not bad, bad
        import torch
        from ray_lightning_tpu_torch.core.module import TrainState
        from ray_lightning_tpu_torch.models import convert
        from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
        from ray_lightning_tpu_torch.utils import state_stream as ss
        from ray_lightning_tpu_torch.utils import treedef as td
        import dataclasses
        # The default state, an int8 one and a LoRA one: leaves, int8
        # payloads and the LoRA chain's masked places.
        for kw, n in (({{}}, 51), ({{"opt_state_dtype": "int8"}}, 63),
                      ({{"lora_rank": 4}}, 31)):
            m = GPT(dataclasses.replace(GPTConfig.tiny(), **kw),
                    device="cpu")
            state = TrainState.create(m.init_params(),
                                      m.configure_optimizers())
            path = os.path.join(tempfile.mkdtemp(), "a.ckpt")
            ss.state_stream_to_file(ss.to_state_stream(
                {{"state": convert.train_state_to_jax(state), "epoch": 0}}),
                path)
            back = convert.train_state_from_jax(ss.load_state_stream(
                ss.state_stream_from_file(path))["state"])
            # Leaves in JAX's order (dict keys sorted) on both sides.
            a, b = (td.flatten(convert.train_state_to_jax(s))[1]
                    for s in (state, back))
            assert len(a) == len(b) == n, (kw, len(a))
            assert all(x.dtype == y.dtype and torch.equal(x, y)
                       for x, y in zip(a, b))
        assert sys.modules["jax"] is None and sys.modules["msgpack"] is None
        print("ok", len({names!r}))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
