"""The port's training operators held against the JAX package (CPU).

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's wrappers run their plain versions; the JAX references are
the Pallas kernels under the interpreter (LayerNorm with
``use_pallas=True``, flash attention with 128-blocks, as
``tests/test_gpt.py`` runs them), the plain XLA attention, and the CE
vocab-chunk scan and naive head.

Tolerances: f32 ``1e-5·max|ref| + 1e-6`` (f32 sums in another order); bf16
``2e-2·max|ref|`` (one bf16 rounding of an output, which may land on the
other side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.ops.attention import (
    xla_causal_attention as jax_xla_attention,
)
from ray_lightning_tpu.ops.cross_entropy import (
    fused_lm_head_cross_entropy as jax_fused_ce,
    naive_lm_head_cross_entropy as jax_naive_ce,
)
from ray_lightning_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from ray_lightning_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from ray_lightning_tpu_torch.models import generate as tgen
from ray_lightning_tpu_torch.ops import cross_entropy as tce
from ray_lightning_tpu_torch.ops import flash_attention as tfa
from ray_lightning_tpu_torch.ops.attention import (
    causal_attention, xla_causal_attention,
)
from ray_lightning_tpu_torch.ops.layer_norm import layer_norm

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got, want, dtype_name):
    got = np.asarray(torch.as_tensor(got).float().detach().numpy()
                     if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    tol = 1e-5 * scale + 1e-6 if dtype_name == "float32" else 2e-2 * scale
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max abs err {err:.3e} > tol {tol:.3e}"


def _t(x, dtype, grad=False):
    t = torch.from_numpy(np.array(x, np.float32)).to(dtype)
    return t.requires_grad_(grad)


def _j(x, dtype):
    return jnp.asarray(np.array(x, np.float32)).astype(dtype)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [128, 256])
def test_layer_norm_kernel_pair_matches_interpreted_pallas(dtype, d):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(d)
    x = rng.standard_normal((3, 70, d)) * 2 + 0.5  # 210 rows: ragged tile
    g = rng.standard_normal(d).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    dy = rng.standard_normal((3, 70, d))

    y_j, vjp = jax.vjp(lambda x_, g_, b_: jax_layer_norm(
        x_, g_, b_, use_pallas=True), _j(x, jdt), jnp.asarray(g),
        jnp.asarray(b))
    dx_j, dg_j, db_j = vjp(_j(dy, jdt))

    xt, gt, bt = _t(x, tdt, True), _t(g, torch.float32, True), _t(
        b, torch.float32, True)
    y = layer_norm(xt, gt, bt, use_kernel=True)
    assert y.dtype == tdt
    dx, dg, db = torch.autograd.grad(y, (xt, gt, bt), _t(dy, tdt))
    _close(y, y_j, dtype)
    _close(dx, dx_j, dtype)
    # dg/db are f32 sums of products of the rounded activations.
    _close(dg, dg_j, "float32" if dtype == "float32" else dtype)
    _close(db, db_j, "float32" if dtype == "float32" else dtype)
    # The no-grad call (y alone) gives the same y.
    with torch.no_grad():
        assert torch.equal(layer_norm(xt, gt, bt, use_kernel=True), y)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

def _qkv(seed, shape=(1, 256, 2, 64)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(4)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 256, 2, 64), (1, 256, 2, 256)],
                         ids=["d64", "d256"])
def test_flash_pair_matches_interpreted_pallas(dtype, shape):
    tdt, jdt = DTYPES[dtype]
    q, k, v, do = _qkv(1, shape)
    out_j, vjp = jax.vjp(
        lambda a, b_, c: jax_flash(a, b_, c, block_q=128, block_k=128),
        *(_j(z, jdt) for z in (q, k, v)))
    dq_j, dk_j, dv_j = vjp(_j(do, jdt))
    qt, kt, vt = (_t(z, tdt, True) for z in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt)
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), _t(do, tdt))
    for got, want in ((out, out_j), (dq, dq_j), (dk, dk_j), (dv, dv_j)):
        _close(got, want, dtype)


def test_flash_pair_matches_xla_attention_and_lse():
    q, k, v, do = _qkv(2, (2, 192, 3, 32))  # any shape on the CPU
    out_j, vjp = jax.vjp(jax_xla_attention,
                         *(jnp.asarray(z, jnp.float32) for z in (q, k, v)))
    grads_j = vjp(jnp.asarray(do, jnp.float32))
    qt, kt, vt = (_t(z, torch.float32, True) for z in (q, k, v))
    for impl in ("auto", "flash", "xla"):
        out = causal_attention(qt, kt, vt, impl=impl)
        grads = torch.autograd.grad(out, (qt, kt, vt),
                                    _t(do, torch.float32))
        _close(out, out_j, "float32")
        for got, want in zip(grads, grads_j):
            _close(got, want, "float32")
    # lse = logsumexp of the masked, scaled scores.
    _, lse = tfa.flash_fwd_plain(qt.detach(), kt.detach(), vt.detach(),
                                 32 ** -0.5)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * 32 ** -0.5
    s = np.where(np.tril(np.ones((192, 192), bool)), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    _close(lse, want.reshape(6, 192), "float32")
    with pytest.raises(ValueError, match="auto|xla|flash"):
        causal_attention(qt, kt, vt, impl="ring")


def test_xla_attention_bf16_matches_jax():
    q, k, v, _ = _qkv(3, (1, 64, 2, 16))
    want = jax_xla_attention(*(_j(z, jnp.bfloat16) for z in (q, k, v)))
    got = xla_causal_attention(*(_t(z, torch.bfloat16) for z in (q, k, v)))
    _close(got, want, "bfloat16")


# ---------------------------------------------------------------------------
# Tied LM head + cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunked_ce_matches_jax_scan_and_naive(dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    V, d = 515, 64  # ragged: 4 chunks of 256 columns, 509 masked
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    wte = (rng.standard_normal((V, d)) * 0.3).astype(np.float32)
    targets = rng.integers(0, V, size=(2, 9)).astype(np.int32)
    targets[0, 0] = V - 1  # a gold label in the last, padded chunk
    g = rng.standard_normal((2, 9)).astype(np.float32)

    def jax_loss(fn, **kw):
        out, vjp = jax.vjp(lambda a, w: fn(a, w, jnp.asarray(targets),
                                           compute_dtype=jdt, **kw),
                           jnp.asarray(x), jnp.asarray(wte))
        return out, vjp(jnp.asarray(g))

    xt = _t(x, torch.float32, True)
    wt = _t(wte, torch.float32, True)
    tgt = torch.from_numpy(targets)
    fused = tce.fused_lm_head_cross_entropy(xt, wt, tgt, num_chunks=4,
                                            compute_dtype=tdt)
    naive = tce.naive_lm_head_cross_entropy(xt, wt, tgt, compute_dtype=tdt)
    loss_f, grads_f = jax_loss(jax_fused_ce, num_chunks=4, use_pallas=False)
    loss_n, grads_n = jax_loss(jax_naive_ce)
    # The products are exact in f32 at either dtype: the losses, and the
    # scan's f32 gradients, take f32 tolerances.  Autodiff of the naive
    # head rounds its gradients to the compute dtype, in both packages.
    for loss in (fused, naive):
        _close(loss, loss_f, "float32")
        _close(loss, loss_n, "float32")
    for got, want in zip(torch.autograd.grad(fused, (xt, wt),
                                             torch.from_numpy(g)), grads_f):
        _close(got, want, "float32")
    for got, want in zip(torch.autograd.grad(naive, (xt, wt),
                                             torch.from_numpy(g)), grads_n):
        _close(got, want, dtype)


def test_chunking_matches_the_jax_layout():
    chunks, vc = tce._chunk_wte(torch.zeros(50304, 4), 7)
    assert tce._pick_num_chunks(50304) == 7
    assert (chunks.shape, vc) == ((7, 7296, 4), 7296)
    assert 7 * 7296 - 50304 == 768


# ---------------------------------------------------------------------------
# The LM head of decode (f32 product of bf16 operands)
# ---------------------------------------------------------------------------

def test_head_logits_bf16_are_f32_products_like_jax():
    rng = np.random.default_rng(7)
    V, d = 300, 64
    h = rng.standard_normal((3, d)).astype(np.float32)
    params = {"wte": (rng.standard_normal((V, d)) * 0.5).astype(np.float32),
              "ln_f_g": rng.standard_normal(d).astype(np.float32),
              "ln_f_b": rng.standard_normal(d).astype(np.float32)}
    hb = jnp.asarray(h).astype(jnp.bfloat16)
    x = jax_layer_norm(hb, jnp.asarray(params["ln_f_g"]),
                       jnp.asarray(params["ln_f_b"]))
    want = jnp.einsum("td,vd->tv", x,
                      jnp.asarray(params["wte"]).astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    got = tgen._head_logits(tp, torch.from_numpy(h).to(torch.bfloat16),
                            torch.bfloat16)
    assert got.dtype == torch.float32
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
