"""The port's fused LM-head cross-entropy held against the JAX package (CPU).

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's CE wrappers (``ce_fwd``, ``ce_bwd_dx``, ``ce_bwd_dw``) run
their plain versions; the JAX references are its Pallas CE kernels under
the interpreter (``_ce_fwd_pallas``, ``_ce_bwd_pallas`` and
``fused_lm_head_cross_entropy(use_pallas=True)``), as the JAX package's
own tests run them on the CPU.

Sizes are ragged on both axes: N tokens that fill no 64- or 512-row tile,
V columns that fill no 128- or 512-column tile, a gold label in the last,
partial vocab tile, and some zero cotangents.  Tolerances: f32 results
within ``1e-5·max|ref| + 1e-6`` (f32 sums in another order); the loss and
lse of the bf16 route are f32 sums of exact products and take the same;
the bf16 route's dx and dW (dlogits rounded to bf16 before the products,
which a 1e-7 difference may round the other way) by ``bf16_measures`` at
the limits of ``chip_smoke.py`` (worst row 2e-2, relative Frobenius 5e-3,
worst 64-row tile's bias 5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.ops import cross_entropy as jce
from ray_lightning_tpu_torch.ops import cross_entropy as tce
from test_torch_gpu import BF16_LIMITS, _bf16_measures

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _case(seed, n, v, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((v, d)) * 0.2).astype(np.float32)
    t = rng.integers(0, v, size=(n,)).astype(np.int32)
    t[0] = v - 1  # a gold label in the last, partial vocab tile
    g = rng.uniform(0.5, 1.5, size=(n,)).astype(np.float32)
    g[::7] = 0.0  # some zero cotangents
    return x, w, t, g


def _check(got, want, how):
    got = got.detach().float()
    want = torch.from_numpy(np.array(want, np.float32))
    assert got.shape == want.shape
    if how == "float32":
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= 1e-5 * scale + 1e-6, f"{err:.3e} vs {scale:.3e}"
    else:
        m = _bf16_measures(got, want)
        assert all(m[k] <= BF16_LIMITS[k] for k in m), m


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [128, 256])
def test_ce_trio_matches_interpreted_pallas(dtype, d):
    tdt, jdt = DTYPES[dtype]
    x, w, t, g = _case(d, 600, 700, d)
    loss_j, lse_j = jce._ce_fwd_pallas(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(t), jdt)
    dx_j, dw_j = jce._ce_bwd_pallas(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(t), lse_j, jnp.asarray(g),
                                    jdt)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    tt = torch.from_numpy(t)
    loss, lse = tce.ce_fwd(xt, wt, tt)
    assert loss.dtype == lse.dtype == torch.float32
    _check(loss, loss_j, "float32")
    _check(lse, lse_j, "float32")
    # Both backward versions take the same lse.
    lse_in = torch.from_numpy(np.array(lse_j))
    dx = tce.ce_bwd_dx(xt, wt, tt, lse_in, torch.from_numpy(g))
    dw = tce.ce_bwd_dw(xt, wt, tt, lse_in, torch.from_numpy(g))
    assert dx.dtype == dw.dtype == torch.float32
    _check(dx, dx_j, dtype)
    _check(dw, dw_j, dtype)
    # A row with a zero cotangent has a zero dx.
    assert float(dx[0::7].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_route_autograd_matches_jax_use_pallas(dtype):
    tdt, jdt = DTYPES[dtype]
    x, w, t, g = _case(3, 600, 700, 128)
    x3, t3, g3 = (a.reshape(2, 300, *a.shape[1:]) for a in (x, t, g))
    loss_j, vjp = jax.vjp(
        lambda a, b: jce.fused_lm_head_cross_entropy(
            a, b, jnp.asarray(t3), compute_dtype=jdt, use_pallas=True),
        jnp.asarray(x3), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g3))

    xt = torch.from_numpy(x3).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = tce.fused_lm_head_cross_entropy(xt, wt, torch.from_numpy(t3),
                                           compute_dtype=tdt,
                                           use_kernel=True)
    assert loss.shape == (2, 300) and loss.dtype == torch.float32
    dx, dw = torch.autograd.grad(loss, (xt, wt), torch.from_numpy(g3))
    _check(loss, loss_j, "float32")
    _check(dx.reshape(600, 128), np.asarray(dx_j).reshape(600, 128), dtype)
    _check(dw, dw_j, dtype)


def test_kernel_route_takes_the_jax_gate(monkeypatch):
    """The kernel route only where ``_pallas_fwd_ok`` would take it; the
    scan elsewhere and under ``use_kernel=False``."""
    for d, dt, ok in ((128, torch.float32, True), (64, torch.bfloat16, False),
                      (768, torch.float32, True), (1536, torch.float32,
                                                   False),
                      (1536, torch.bfloat16, True), (1664, torch.bfloat16,
                                                     False),
                      (200, torch.bfloat16, False)):
        assert tce.kernel_route_ok(d, dt) == ok, (d, dt)
        want = jce._pallas_fwd_ok(jnp.zeros((1, d)), None, None,
                                  jnp.float32 if dt == torch.float32
                                  else jnp.bfloat16)
        assert want == ok, (d, dt)

    calls = []
    orig = tce.ce_fwd_plain
    monkeypatch.setattr(tce, "ce_fwd_plain",
                        lambda *a: calls.append(1) or orig(*a))
    x, w, t, _ = _case(4, 10, 50, 128)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(t))
    kernel = tce.fused_lm_head_cross_entropy(*args, use_kernel=True)
    assert len(calls) == 1
    scan = tce.fused_lm_head_cross_entropy(*args, use_kernel=False)
    tce.fused_lm_head_cross_entropy(args[0][:, :64].contiguous(),
                                    args[1][:, :64].contiguous(), args[2],
                                    use_kernel=True)
    assert len(calls) == 1
    _check(kernel, scan.numpy(), "float32")


def test_kernel_wrappers_refuse_on_the_cpu_what_has_no_route():
    x = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        tce.ce_fwd(x.to("meta"), x.to("meta"), torch.zeros(4, dtype=torch.int32,
                                                          device="meta"))


def test_gpt_ce_kernel_argument_picks_the_route(monkeypatch):
    """``GPT(ce_kernel=...)`` is the caller's choice of route for the
    training loss: the kernel trio by default, the scan with ``False``;
    both give the same loss.  Nothing in the environment changes it."""
    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig

    calls = []
    orig = tce.ce_fwd_plain
    monkeypatch.setattr(tce, "ce_fwd_plain",
                        lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setenv("RLT_DISABLE_KERNELS", "ce,ln,flash")
    cfg = GPTConfig.tiny()
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 33)))
    losses = []
    for ce_kernel in (True, False):
        tm = GPT(cfg, device="cpu", ce_kernel=ce_kernel)
        assert tm.hparams["ce_kernel"] is ce_kernel
        losses.append(float(tm._loss(tm.init_params(), tokens)[0]))
    assert len(calls) == 1
    assert losses[0] == pytest.approx(losses[1], abs=1e-5)
