"""The port's CUDA kernels, a tiny engine and tiny fits on the card.

Marked ``gpu``; each test skips (inside its fixture, never at import)
when no CUDA device is available.  Run on the card with
``pytest -m gpu tests/test_torch_gpu.py``.  Kernel vs plain tolerances as
in ``chip_smoke.py``: f32 max abs error <= 1e-5·max|ref| + 1e-6 (f32 sums
in another order); bf16 (BGMV) <= 2e-2·max|ref|; the training kernels'
bf16 results by measures relative to the reference itself
(:func:`_bf16_measures`, limits ``BF16_LIMITS``), since at attention's
shapes max|ref| is many times a typical element.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.generate import generate
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, SyntheticLMDataModule, synthetic_lora_adapter,
)
from ray_lightning_tpu_torch.ops import cross_entropy as ce
from ray_lightning_tpu_torch.ops import flash_attention as fa
from ray_lightning_tpu_torch.ops import layer_norm as ln
from ray_lightning_tpu_torch.ops import lora
from ray_lightning_tpu_torch.ops.attention import causal_attention
from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy
from ray_lightning_tpu_torch.serve.engine import ServeConfig, ServeEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _case(gen, W, d, r, k, n, dtype, run=None):
    """Random ids, or with ``run`` ids in runs of that many rows (the
    prefill rows of consecutive sequences), cycling through the slots."""
    h = torch.randn(W, d, generator=gen, device="cuda").to(dtype)
    a = (torch.randn(n, d, r, generator=gen, device="cuda") * 0.1).to(dtype)
    b = (torch.randn(n, r, k, generator=gen, device="cuda") * 0.3).to(dtype)
    if run is None:
        ids = torch.randint(0, n, (W,), generator=gen, device="cuda",
                            dtype=torch.int32)
    else:
        ids = ((torch.arange(W, device="cuda") // run + 1) % n).to(
            torch.int32)
    return h, a, b, ids


# (3, 100, 100, 1000) and (5, 100, 16, 1001) take the element-wise path
# (d, r or k not a multiple of 16 bytes); runs of 100 rows straddle the
# 64-row tiles; W = 1 and W = 64 fill one tile; r = 128 the largest rank.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W,d,r,k,run", [
    (8, 768, 16, 2304, None), (512, 768, 16, 768, None),
    (3, 100, 100, 1000, None), (1, 32, 1, 5, None), (40, 64, 128, 4096, None),
    (512, 768, 16, 2304, 100), (1, 768, 16, 2304, None),
    (64, 768, 16, 768, None), (8, 768, 128, 2304, None),
    (5, 100, 16, 1001, None), (300, 1000, 64, 3000, 37)])
def test_kernel_matches_plain(cuda, dtype, W, d, r, k, run):
    dt = getattr(torch, dtype)
    h, a, b, ids = _case(cuda, W, d, r, k, 5, dt, run)
    got = lora.bgmv(h, a, b, ids)
    ref = lora.bgmv_plain(h, a, b, ids)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (W, k)
    scale = ref.float().abs().max().item()
    tol = 1e-5 * scale + 1e-6 if dt == torch.float32 else 2e-2 * scale
    assert (got.float() - ref.float()).abs().max().item() <= tol


def test_null_slot_is_exactly_zero_and_launches_count(cuda):
    h, a, b, ids = _case(cuda, 8, 64, 8, 96, 3, torch.float32)
    a[0] = 0.0
    b[0] = 0.0
    before = lora.bgmv.launches
    out = lora.bgmv(h, a, b, torch.zeros_like(ids))
    torch.cuda.synchronize()
    assert (out == 0).all()
    assert lora.bgmv.launches == before + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W,d,r,k,run", [(8, 768, 16, 2304, None),
                                         (512, 768, 16, 768, 100),
                                         (3, 100, 100, 1000, None)])
def test_bgmv_is_bitwise_repeatable(cuda, dtype, W, d, r, k, run):
    """Two launches on the same inputs are bitwise equal: every output
    element has one writer, and the cluster's partial t are summed in rank
    order in every block (no atomics)."""
    h, a, b, ids = _case(cuda, W, d, r, k, 5, getattr(torch, dtype), run)
    first, second = lora.bgmv(h, a, b, ids), lora.bgmv(h, a, b, ids)
    torch.cuda.synchronize()
    assert torch.isfinite(first.float()).all()
    assert torch.equal(first, second)


def test_out_of_range_id_gives_nan_rows(cuda):
    h, a, b, ids = _case(cuda, 4, 64, 8, 96, 3, torch.float32)
    ids[2] = 7
    out = lora.bgmv(h, a, b, ids)
    torch.cuda.synchronize()
    assert torch.isnan(out[2]).all() and not torch.isnan(out[[0, 1, 3]]).any()


def test_kernel_rejects_what_it_does_not_take(cuda):
    h, a, b, ids = _case(cuda, 4, 64, 8, 96, 3, torch.float32)
    with pytest.raises(ValueError, match="int32"):
        lora.bgmv(h, a, b, ids.long())
    with pytest.raises(ValueError, match="dtype"):
        lora.bgmv(h.half(), a.half(), b.half(), ids)
    with pytest.raises(ValueError, match="one dtype"):
        lora.bgmv(h, a.to(torch.bfloat16), b, ids)
    with pytest.raises(ValueError, match="contiguous"):
        lora.bgmv(h.t().contiguous().t(), a, b, ids)
    with pytest.raises(ValueError, match="rank"):
        big = torch.zeros(3, 64, 129, device="cuda")
        lora.bgmv(h, big, torch.zeros(3, 129, 96, device="cuda"), ids)
    with pytest.raises(ValueError, match="is on"):
        lora.bgmv(h, a.cpu(), b, ids)


def test_tiny_engine_on_the_card_matches_merged_generate(cuda):
    cfg = GPTConfig(vocab_size=128, n_layer=2, n_head=4, d_model=64,
                    seq_len=64)
    module = GPT(cfg)  # the default device: the card
    params = module.init_params(cuda)
    for key in ("qkv_w", "proj_w", "mlp_in_w", "mlp_out_w"):
        params["blocks"][key] = params["blocks"][key] * 10.0
    lora_cfg = dataclasses.replace(cfg, lora_rank=4)
    tenants, merged = {}, {None: params}
    for name in ("a", "b"):
        tenants[name], merged[name] = synthetic_lora_adapter(
            params, lora_cfg, cuda, scale=0.3)
    engine = ServeEngine(module, params,
                         ServeConfig(num_slots=3, block_size=8,
                                     max_adapters=2, adapter_rank=4),
                         adapters=tenants)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, 128, size=(n,)).tolist(), a)
            for n, a in ((5, "a"), (11, None), (17, "b"), (9, "a"))]
    lora.bgmv.launches = 0
    handles = [engine.submit(p, 10, adapter=a) for p, a in reqs]
    engine.run_until_idle()
    c = engine.snapshot()["counters"]
    assert lora.bgmv.launches == 2 * cfg.n_layer * (c["prefills"]
                                                    + c["decode_steps"])
    for (p, a), h in zip(reqs, handles):
        ref = generate(module, merged[a], [p], 10)[0, len(p):].tolist()
        assert h.result(0) == ref


BF16_LIMITS = {"row": 2e-2, "frob": 5e-3, "bias": 5e-4}  # as chip_smoke.py


def _bf16_measures(got, ref):
    """chip_smoke.py's ``bf16_measures``: the worst row's relative error
    (floored at 1e-2 of the rms row norm), the relative Frobenius error,
    and the worst 64-position tile's bias Σ(got − ref)·ref / Σ ref²."""
    g, r = got.float(), ref.float()
    if r.ndim == 4:  # (B, S, H, D): positions on axis 1
        g, r = (t.transpose(0, 1).reshape(t.shape[1], -1, t.shape[-1])
                for t in (g, r))
    else:  # (N, d)
        g, r = (t.reshape(t.shape[0], 1, -1) for t in (g, r))
    d = g - r
    rn = r.norm(dim=-1)
    row = (d.norm(dim=-1) / (rn + 1e-2 * rn.square().mean().sqrt())).max()
    dr, rr = (d * r).sum(dim=(1, 2)), r.square().sum(dim=(1, 2))
    pad = -len(dr) % 64
    dr, rr = (torch.nn.functional.pad(t, (0, pad)).reshape(-1, 64).sum(1)
              for t in (dr, rr))
    return {"row": row.item(), "frob": (d.norm() / r.norm()).item(),
            "bias": (dr / rr.clamp_min(1e-30)).abs().max().item()}


def _assert_close(got, ref, dt):
    if dt == torch.float32:
        scale = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 1e-5 * scale + 1e-6
    else:
        m = _bf16_measures(got, ref)
        assert all(m[k] <= BF16_LIMITS[k] for k in m), m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(2048, 768), (1001, 768), (37, 100),
                                 (5, 1600), (1001, 1536), (1001, 1600)])
def test_layer_norm_kernels_match_plain(cuda, dtype, n, d):
    dt = getattr(torch, dtype)
    x = (torch.randn(n, d, generator=cuda, device="cuda") * 2 + 0.3).to(dt)
    g = torch.randn(d, generator=cuda, device="cuda")
    b = torch.randn(d, generator=cuda, device="cuda")
    dy = torch.randn(n, d, generator=cuda, device="cuda").to(dt)
    f0, b0 = ln.ln_fwd.launches, ln.ln_bwd.launches
    y, mu, rs = ln.ln_fwd(x, g, b)
    y_only, none_mu, none_rs = ln.ln_fwd(x, g, b, want_stats=False)
    yp, mup, rsp = ln.ln_fwd_plain(x, g, b)
    # Both backward versions take the same statistics.
    dx, dg, db = ln.ln_bwd(x, g, dy, mup, rsp)
    dxp, dgp, dbp = ln.ln_bwd_plain(x, g, dy, mup, rsp)
    torch.cuda.synchronize()
    assert (ln.ln_fwd.launches, ln.ln_bwd.launches) == (f0 + 2, b0 + 1)
    assert none_mu is None and none_rs is None and torch.equal(y_only, y)
    for got, ref in ((y, yp), (dx, dxp)):
        assert got.dtype == dt
        _assert_close(got, ref, dt)
    for got, ref in ((mu, mup), (rs, rsp), (dg, dgp), (db, dbp)):
        _assert_close(got, ref, torch.float32)


# The bf16 forward tiles queries by 128 and keys by 64, the backward both by
# 64: S = 64 and 192 leave a half query tile; (16, 1024, 12, 64) is the
# training path's shape (B·H = 192).  At D = 256 the bf16 forward takes 32
# keys a softmax step, its backward splits D over two warps, and the f32
# backward tiles keys by 32.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,D", [(2, 256, 4, 64), (1, 512, 2, 128),
                                     (3, 64, 5, 64), (2, 192, 3, 64),
                                     (2, 192, 3, 128), (4, 1024, 6, 128),
                                     (16, 1024, 12, 64), (2, 192, 3, 256),
                                     (1, 64, 2, 256), (4, 1024, 3, 256)])
def test_flash_kernels_match_plain_on_strided_views(cuda, dtype, B, S, H,
                                                    D):
    dt = getattr(torch, dtype)
    qkv = torch.randn(B, S, 3 * H * D, generator=cuda, device="cuda").to(dt)
    q, k, v = (t.view(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    assert q.stride() == k.stride() == (S * 3 * H * D, 3 * H * D, D, 1)
    do = torch.randn(B, S, H, D, generator=cuda, device="cuda").to(dt)
    scale = D ** -0.5
    f0, b0 = fa.flash_fwd.launches, fa.flash_bwd.launches
    out, lse = fa.flash_fwd(q, k, v, scale)
    outp, lsep = fa.flash_fwd_plain(q, k, v, scale)
    # Both backward versions take the same out and lse.
    dq, dk, dv = fa.flash_bwd(q, k, v, outp, lsep, do, scale)
    grads_p = fa.flash_bwd_plain(q, k, v, outp, lsep, do, scale)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == (f0 + 1, b0 + 1)
    _assert_close(out, outp, dt)
    _assert_close(lse, lsep, torch.float32)
    for got, ref in zip((dq, dk, dv), grads_p):
        assert got.dtype == dt and got.shape == (B, S, H, D)
        _assert_close(got, ref, dt)


def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.randn(1, 128, 2, 32, device="cuda")  # head_dim 32
    with pytest.raises(ValueError, match="impl='xla'"):
        causal_attention(q, q, q, impl="flash")
    with pytest.raises(ValueError, match="impl='xla'"):
        fa.flash_fwd(torch.randn(1, 100, 2, 64, device="cuda"),
                     *[torch.randn(1, 100, 2, 64, device="cuda")] * 2, 0.1)
    with pytest.raises(ValueError, match="dtype"):
        h = torch.randn(1, 128, 2, 64, device="cuda").half()
        fa.flash_fwd(h, h, h, 0.1)
    with pytest.raises(ValueError, match="f32 or bf16"):
        x = torch.randn(4, 64, device="cuda").half()
        ln.ln_fwd(x, torch.ones(64, device="cuda"),
                  torch.zeros(64, device="cuda"))
    out = causal_attention(q, q, q, impl="xla")  # the named way out
    assert out.shape == q.shape


def test_tiny_fit_on_the_card_counts_every_launch(cuda):
    cfg = GPTConfig(vocab_size=512, n_layer=2, n_head=2, d_model=128,
                    seq_len=128, warmup_steps=2)
    counters = (ln.ln_fwd, ln.ln_bwd, fa.flash_fwd, fa.flash_bwd)
    for c in counters:
        c.launches = 0
    tr = Trainer(max_steps=3, limit_val_batches=0,  # LocalStrategy(): card
                 enable_checkpointing=False)
    tr.fit(GPT(cfg), SyntheticLMDataModule(cfg, batch_size=4,
                                           num_batches=3))
    n_ln = 2 * cfg.n_layer + 1
    assert [c.launches for c in counters] == [3 * n_ln, 3 * n_ln,
                                              3 * cfg.n_layer,
                                              3 * cfg.n_layer]
    assert np.isfinite(tr.callback_metrics["train_loss"])
    assert isinstance(tr.strategy, LocalStrategy)
    assert tr.state.params["wte"].is_cuda


def _ce_case(gen, n, v, d, dt):
    x = torch.randn(n, d, generator=gen, device="cuda").to(dt)
    w = (torch.randn(v, d, generator=gen, device="cuda") * 0.05).to(dt)
    t = torch.randint(0, v, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    t[0] = v - 1  # a gold label in the last, partial vocab tile
    g = torch.rand(n, generator=gen, device="cuda")
    g[::7] = 0.0
    return x, w, t, g


@pytest.mark.parametrize("dtype,n,v,d", [
    ("float32", 1000, 515, 768), ("bfloat16", 1000, 515, 768),
    ("float32", 2048, 50304, 768), ("bfloat16", 2048, 50304, 768),
    ("bfloat16", 1024, 50304, 1536), ("float32", 77, 130, 128),
    ("bfloat16", 77, 130, 384), ("bfloat16", 300, 1000, 640),
    ("bfloat16", 77, 130, 1280)])
def test_ce_kernels_match_plain(cuda, dtype, n, v, d):
    dt = getattr(torch, dtype)
    x, w, t, g = _ce_case(cuda, n, v, d, dt)
    launches = (ce.ce_fwd.launches, ce.ce_bwd_dx.launches,
                ce.ce_bwd_dw.launches)
    loss, lse = ce.ce_fwd(x, w, t)
    lossp, lsep = ce.ce_fwd_plain(x, w, t)
    # Both backward versions take the same lse.
    dx = ce.ce_bwd_dx(x, w, t, lsep, g)
    dw = ce.ce_bwd_dw(x, w, t, lsep, g)
    dxp = ce.ce_bwd_dx_plain(x, w, t, lsep, g)
    dwp = ce.ce_bwd_dw_plain(x, w, t, lsep, g)
    torch.cuda.synchronize()
    assert (ce.ce_fwd.launches, ce.ce_bwd_dx.launches,
            ce.ce_bwd_dw.launches) == tuple(k + 1 for k in launches)
    for got, ref in ((loss, lossp), (lse, lsep)):
        assert got.dtype == torch.float32
        _assert_close(got, ref, torch.float32)
    for got, ref in ((dx, dxp), (dw, dwp)):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        _assert_close(got, ref, dt)
    assert (dx[::7] == 0).all()


@pytest.mark.parametrize("n,v,d", [(2048, 50304, 768), (1000, 515, 1536),
                                   (300, 1000, 640), (77, 130, 128)])
def test_ce_backward_is_bitwise_repeatable(cuda, n, v, d):
    """dx and dW of two launches on the same bf16 inputs are bitwise
    equal: every output element has one writer and a cluster's partial
    logits are summed in one fixed order of its blocks (no atomics)."""
    x, w, t, g = _ce_case(cuda, n, v, d, torch.bfloat16)
    lse = ce.ce_fwd_plain(x, w, t)[1]
    runs = [(ce.ce_bwd_dx(x, w, t, lse, g), ce.ce_bwd_dw(x, w, t, lse, g))
            for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.isfinite(first).all()
        assert torch.equal(first, second)


@pytest.mark.parametrize("n,v,d", [(2048, 50304, 768), (1000, 515, 1536),
                                   (300, 1000, 640), (77, 130, 128)])
def test_ce_forward_is_bitwise_repeatable(cuda, n, v, d):
    """loss and lse of two launches on the same bf16 inputs are bitwise
    equal: each row's sums run over the vocab tiles in one order, and its
    quad of lanes meets in one order."""
    x, w, t, _ = _ce_case(cuda, n, v, d, torch.bfloat16)
    runs = [ce.ce_fwd(x, w, t) for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.isfinite(first).all()
        assert torch.equal(first, second)


@pytest.mark.parametrize("n,d", [(2048, 768), (37, 100), (16384, 768),
                                 (1001, 1536), (5, 1600)])
def test_ln_backward_is_bitwise_repeatable(cuda, n, d):
    """dx, dg and db of two bf16 launches are bitwise equal: every partial
    row and every column sum is taken in one fixed order (no atomics)."""
    x = (torch.randn(n, d, generator=cuda, device="cuda") * 2 + 0.3).to(
        torch.bfloat16)
    g = torch.randn(d, generator=cuda, device="cuda")
    dy = torch.randn(n, d, generator=cuda, device="cuda").to(torch.bfloat16)
    _, mu, rs = ln.ln_fwd_plain(x, g, torch.zeros_like(g))
    runs = [ln.ln_bwd(x, g, dy, mu, rs) for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.isfinite(first.float()).all()
        assert torch.equal(first, second)


def test_head_dim_32_fit_on_the_card_matches_the_cpu(cuda):
    """GPTConfig.tiny() has head_dim 32, which attn_impl="auto" sends to
    the plain attention (the JAX shape gate): three f32 steps on the card
    launch no flash kernel, raise nothing, and give the CPU fit's losses
    within 1e-5 relative (f32 sums in another order)."""

    class Losses(Callback):
        def __init__(self):
            self.values = []

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            self.values.append(float(logs["train_loss"]))

    cfg = GPTConfig.tiny()
    assert cfg.head_dim == 32
    init = GPT(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    losses = {}
    for device in ("cuda", "cpu"):
        module = GPT(cfg, device=device)
        module.initial_params = init
        rec = Losses()
        fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        Trainer(LocalStrategy(device=device), max_steps=3,
                limit_val_batches=0, callbacks=[rec],
                enable_checkpointing=False).fit(
            module, SyntheticLMDataModule(cfg, batch_size=4, num_batches=3))
        assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == (0, 0)
        losses[device] = np.array(rec.values)
    assert len(losses["cuda"]) == 3 and np.isfinite(losses["cuda"]).all()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)


def test_head_dim_256_fit_on_the_card_matches_the_cpu(cuda):
    """d_model 768 over 3 heads is head_dim 256, which the JAX shape gate
    sends to flash: three f32 steps of attn_impl="auto" on the card launch
    the flash kernels every layer and step, and give the CPU fit's losses
    (the plain flash pair there) within 1e-5 relative (f32 sums in another
    order)."""

    class Losses(Callback):
        def __init__(self):
            self.values = []

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            self.values.append(float(logs["train_loss"]))

    cfg = GPTConfig(vocab_size=512, n_layer=2, n_head=3, d_model=768,
                    seq_len=256, warmup_steps=2)
    assert cfg.head_dim == 256
    init = GPT(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    losses, launched = {}, {}
    for device in ("cuda", "cpu"):
        module = GPT(cfg, device=device, attn_impl="auto")
        module.initial_params = init
        rec = Losses()
        fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        Trainer(LocalStrategy(device=device), max_steps=3,
                limit_val_batches=0, callbacks=[rec],
                enable_checkpointing=False).fit(
            module, SyntheticLMDataModule(cfg, batch_size=2, num_batches=3))
        launched[device] = (fa.flash_fwd.launches, fa.flash_bwd.launches)
        losses[device] = np.array(rec.values)
    assert launched == {"cuda": (3 * cfg.n_layer, 3 * cfg.n_layer),
                        "cpu": (0, 0)}
    assert len(losses["cuda"]) == 3 and np.isfinite(losses["cuda"]).all()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)


def test_bf16_fit_with_ce_kernels_matches_the_scan(cuda):
    """Four bf16 steps with the CE kernels and with the vocab-chunk scan
    (``ce_kernel=False``) from one seed give the same per-step losses
    within 1e-3 relative.  Both routes round the same f32 dlogits to bf16
    before the products and differ only in the order of their f32 sums; a
    bf16 rounding that flips moves one element by 2^-8 of itself, and four
    AdamW steps carry such flips into the weights (the CPU's plain versions
    and the scan differ by 1.2e-5 at this size).  1e-3 is a tenth of what
    ``chip_smoke.py`` phase 8 allows bf16 against f32.  d = 640 makes each
    cluster two blocks, the second on a ragged 256-wide slice."""

    class Losses(Callback):
        def __init__(self):
            self.values = []

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            self.values.append(float(logs["train_loss"]))

    cfg = GPTConfig(vocab_size=515, n_layer=2, n_head=10, d_model=640,
                    seq_len=128, warmup_steps=2)
    losses = []
    for ce_kernel in (True, False):
        rec = Losses()
        ce.ce_bwd_dx.launches = 0
        tr = Trainer(max_steps=4, limit_val_batches=0, precision="bf16",
                     seed=0, callbacks=[rec], enable_checkpointing=False)
        tr.fit(GPT(cfg, ce_kernel=ce_kernel),
               SyntheticLMDataModule(cfg, batch_size=4, num_batches=4,
                                     seed=0))
        assert ce.ce_bwd_dx.launches == (4 if ce_kernel else 0)
        losses.append(np.array(rec.values))
    assert len(losses[0]) == 4 and np.isfinite(losses[0]).all()
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-3)


def test_ce_kernels_reject_what_they_do_not_take(cuda):
    x = torch.randn(8, 128, device="cuda")
    w = torch.randn(50, 128, device="cuda")
    t = torch.zeros(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="f32 or bf16"):
        ce.ce_fwd(x.half(), w.half(), t)
    with pytest.raises(ValueError, match="one dtype"):
        ce.ce_fwd(x, w.to(torch.bfloat16), t)
    with pytest.raises(ValueError, match="multiple of 128"):
        ce.ce_fwd(x[:, :96].contiguous(), w[:, :96].contiguous(), t)
    with pytest.raises(ValueError, match="contiguous"):
        ce.ce_fwd(torch.randn(128, 8, device="cuda").t(), w, t)
    with pytest.raises(ValueError, match="targets"):
        ce.ce_fwd(x, w, t[:4])
    with pytest.raises(ValueError, match="is on"):
        ce.ce_fwd(x, w.cpu(), t)
    with pytest.raises(ValueError, match="lse and g"):
        ce.ce_bwd_dx(x, w, t, torch.zeros(4, device="cuda"),
                     torch.zeros(8, device="cuda"))


def test_tiny_fit_with_remat_counts_the_ce_launches(cuda):
    cfg = GPTConfig(vocab_size=515, n_layer=2, n_head=2, d_model=128,
                    seq_len=128, warmup_steps=2)
    counters = (ln.ln_fwd, ln.ln_bwd, fa.flash_fwd, fa.flash_bwd, ce.ce_fwd,
                ce.ce_bwd_dx, ce.ce_bwd_dw)
    for c in counters:
        c.launches = 0
    tr = Trainer(max_steps=3, limit_val_batches=0, precision="bf16",
                 enable_checkpointing=False)
    tr.fit(GPT(cfg, remat=True, remat_policy="dots+flash"),
           SyntheticLMDataModule(cfg, batch_size=4, num_batches=3))
    L = cfg.n_layer
    assert [c.launches for c in counters] == [
        3 * (4 * L + 1), 3 * (2 * L + 1), 3 * L, 3 * L, 3, 3, 3]
    assert np.isfinite(tr.callback_metrics["train_loss"])


# ---------------------------------------------------------------------------
# Megastep: K steps captured into one CUDA graph
# ---------------------------------------------------------------------------

class _Hooks(Callback):
    def __init__(self):
        self.logs = {}

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        self.logs[batch_idx] = {k: float(v) for k, v in logs.items()}


def _card_fit(module, megastep, steps, accum=1, epochs=1, batch=4):
    hooks = _Hooks()
    tr = Trainer(LocalStrategy(megastep=megastep), max_epochs=epochs,
                 limit_val_batches=0, accumulate_grad_batches=accum,
                 callbacks=[hooks], enable_checkpointing=False)
    tr.fit(module, SyntheticLMDataModule(module.config, batch_size=batch,
                                         num_batches=steps))
    return tr, hooks


def _max_param_diff(a, b):
    from ray_lightning_tpu_torch.models.optim import tree_leaves

    return max(float((x - y).abs().max()) for x, y in
               zip(tree_leaves(a.state.params), tree_leaves(b.state.params)))


_TINY = GPTConfig(vocab_size=512, n_layer=2, n_head=2, d_model=128,
                  seq_len=128, warmup_steps=2)


def test_captured_fit_equals_the_eager_fit(cuda):
    """12 steps at megastep 4: one eager stride, then two replays of the
    graph, against 12 eager steps from one init.  f32: the same kernels on
    the same inputs, so losses within 1e-6 relative and params within
    1e-6 absolute (the flash backward's dQ atomics sum in a varying
    order).  The launch counters count Python calls: the eager stride and
    the capture, not the replays."""
    init = GPT(_TINY, device="cpu").init_params()
    runs = {}
    for mode in ("off", 4):
        module = GPT(_TINY)
        module.initial_params = init
        for c in (ln.ln_fwd, fa.flash_fwd):
            c.launches = 0
        tr, hooks = _card_fit(module, mode, 12)
        runs[mode] = (tr, hooks, ln.ln_fwd.launches, fa.flash_fwd.launches)
    (e, eh, e_ln, e_fa), (c, ch, c_ln, c_fa) = runs["off"], runs[4]
    assert sorted(ch.logs) == [3, 7, 11]
    for i, logs in ch.logs.items():
        assert logs["train_loss"] == pytest.approx(
            eh.logs[i]["train_loss"], rel=1e-6)
    assert c.callback_metrics["train_loss"] == pytest.approx(
        e.callback_metrics["train_loss"], rel=1e-6)
    assert _max_param_diff(c, e) <= 1e-6
    assert (c.global_step, c.micro_step) == (12, 12)
    assert c.callback_metrics["recompiles"] == 1.0
    assert e.callback_metrics["recompiles"] == 0.0
    assert c.telemetry_report["meta"]["megastep"] == 4
    assert c.telemetry_report["step_stats"]["capture_total_s"] > 0
    n_ln = 2 * _TINY.n_layer + 1
    assert (e_ln, c_ln) == (12 * n_ln, 8 * n_ln)
    assert (e_fa, c_fa) == (12 * _TINY.n_layer, 8 * _TINY.n_layer)
    assert int(c.state.opt_state[1]["count"]) == 12


def test_accumulation_under_capture(cuda):
    """accumulate 2, megastep 4, 9 batches for 2 epochs: strides of 4
    (two optimizer steps inside each graph), a single at each epoch's end
    whose partial window is flushed, then the next epoch's replay from the
    flushed state; against the eager fit."""
    init = GPT(_TINY, device="cpu").init_params()
    fits = {}
    for mode in ("off", 4):
        module = GPT(_TINY)
        module.initial_params = init
        fits[mode] = _card_fit(module, mode, 9, accum=2, epochs=2)
    (e, eh), (c, ch) = fits["off"], fits[4]
    assert (c.global_step, c.micro_step) == (e.global_step, e.micro_step) \
        == (10, 18)
    for i, logs in ch.logs.items():
        assert logs["train_loss"] == pytest.approx(
            eh.logs[i]["train_loss"], rel=1e-6)
    assert _max_param_diff(c, e) <= 1e-6
    assert c.callback_metrics["recompiles"] == 1.0


class _ItemGPT(GPT):
    def training_step(self, params, batch, rng):
        loss, logs = super().training_step(params, batch, rng)
        if loss.item() > 1e9:  # a host sync: refused under capture
            raise AssertionError("unreachable")
        return loss, logs


def test_item_in_training_step_raises_naming_the_capture(cuda):
    from ray_lightning_tpu_torch.parallel.step_fns import (
        MegastepCaptureError,
    )

    with pytest.raises(MegastepCaptureError) as err:
        _card_fit(_ItemGPT(_TINY), 8, 16)
    msg = str(err.value)
    assert "capture" in msg and "megastep='off'" in msg
    assert "loss.item()" in msg and "training_step" in msg
    # The same module runs eagerly.
    tr, _ = _card_fit(_ItemGPT(_TINY), "off", 16)
    assert tr.global_step == 16


class _DrawGPT(GPT):
    """Logs one uniform draw of its rng a step from its ``first``-th call
    on (a zero before; adds nothing to the loss)."""

    def __init__(self, cfg, first=0):
        super().__init__(cfg)
        self.first, self.calls = first, 0

    def training_step(self, params, batch, rng):
        loss, logs = super().training_step(params, batch, rng)
        self.calls += 1
        draw = (torch.rand((), generator=rng, device=loss.device)
                if self.calls > self.first
                else torch.zeros((), device=loss.device))
        return loss + 0 * draw, {**logs, "draw": draw}


@pytest.mark.parametrize("first", [0, 4])
def test_rng_draws_are_the_same_with_megastep_on_and_off(cuda, first):
    """The draw at micro-step i is a function of (seed, i): the replayed
    strides draw what the eager steps draw, also when only the captured
    steps draw (first = 4: the eager warm-up stride of megastep 4 draws
    nothing; every capture registers its inner steps' generator
    states)."""
    fits = {mode: _card_fit(_DrawGPT(_TINY, first), mode, 12)
            for mode in ("off", 4)}
    (e, eh), (c, ch) = fits["off"], fits[4]
    draws = [eh.logs[i]["draw"] for i in range(first, 12)]
    assert len(set(draws)) == 12 - first
    assert sorted(ch.logs) == [3, 7, 11]
    assert c.callback_metrics["recompiles"] == 1.0
    for i, logs in ch.logs.items():
        assert logs["draw"] == eh.logs[i]["draw"]
    assert c.callback_metrics["draw"] == pytest.approx(
        e.callback_metrics["draw"], rel=1e-6)


# ---------------------------------------------------------------------------
# Checkpoints and the eval surface on the card
# ---------------------------------------------------------------------------

def _ckpt_fit(root, epochs, resume=None):
    module = GPT(_TINY)
    module.initial_params = GPT(_TINY, device="cpu").init_params(
        torch.Generator().manual_seed(5))
    hooks = _Hooks()
    tr = Trainer(LocalStrategy(megastep="auto"), max_epochs=epochs,
                 limit_val_batches=0, default_root_dir=str(root),
                 callbacks=[hooks], resume_from_checkpoint=resume)
    tr.fit(module, SyntheticLMDataModule(_TINY, batch_size=4,
                                         num_batches=16))
    return tr, hooks


def test_checkpoint_round_trip_under_megastep_auto(cuda, tmp_path):
    """megastep "auto" (8 on the card): an epoch of 16 steps is one eager
    stride and one captured.  The file written at the epoch's end holds
    the live state bitwise (taken after the captured stride's
    write-back); resumed for a second epoch (an eager stride, a capture),
    the losses and params agree with a straight 2-epoch fit (a replay
    there) within 1e-6, the flash backward's dQ atomics' spread."""
    from ray_lightning_tpu_torch.models.convert import train_state_from_jax
    from ray_lightning_tpu_torch.utils import state_stream as ss

    one, _ = _ckpt_fit(tmp_path / "one", 1)
    assert one.telemetry_report["meta"]["megastep"] == 8
    assert one.callback_metrics["recompiles"] == 1
    back = train_state_from_jax(ss.load_state_stream(
        ss.state_stream_from_file(one.best_model_path))["state"])
    assert back.step == one.state.step == 16

    def walk(a, b):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, tuple):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    walk((one.state.params, one.state.opt_state),
         (back.params, back.opt_state))
    straight, s_hooks = _ckpt_fit(tmp_path / "straight", 2)
    split, p_hooks = _ckpt_fit(tmp_path / "split", 2,
                               resume=one.best_model_path)
    assert split.global_step == straight.global_step == 32
    assert split.callback_metrics["recompiles"] == 1
    for i, logs in p_hooks.logs.items():
        assert logs["train_loss"] == pytest.approx(
            s_hooks.logs[i]["train_loss"], rel=1e-6)
    assert _max_param_diff(split, straight) < 1e-6


def test_validate_on_the_card_matches_the_cpu(cuda, tmp_path):
    """One f32 checkpoint validated on the card (kernels) and on the CPU
    (plain versions): val_loss within 1e-5 relative."""
    one, _ = _ckpt_fit(tmp_path, 1)
    dm = SyntheticLMDataModule(_TINY, batch_size=4, num_batches=2, seed=3)
    got = {}
    for device in ("cuda", "cpu"):
        tr = Trainer(LocalStrategy(device=device), enable_checkpointing=False)
        got[device] = tr.validate(GPT(_TINY, device=device), dm,
                                  ckpt_path=one.best_model_path)
    assert got["cuda"]["val_loss"] == pytest.approx(got["cpu"]["val_loss"],
                                                    rel=1e-5)
    class Predict(SyntheticLMDataModule):
        def predict_dataloader(self):
            return self._loader()

    preds = {}
    for device in ("cuda", "cpu"):
        tr = Trainer(LocalStrategy(device=device), enable_checkpointing=False)
        preds[device] = tr.predict(
            GPT(_TINY, device=device),
            Predict(_TINY, batch_size=4, num_batches=2, seed=3),
            ckpt_path=one.best_model_path)
    # Argmax equal except where the CPU's top-2 logits are within 1e-4.
    dm = Predict(_TINY, batch_size=4, num_batches=2, seed=3)
    dm.setup("predict")
    tokens = torch.cat([torch.from_numpy(b["tokens"])
                        for b in dm.predict_dataloader()])
    from ray_lightning_tpu_torch.models.optim import tree_map

    params = tree_map(lambda t: t.cpu(), one.state.params)
    with torch.no_grad():
        top2 = torch.topk(GPT(_TINY, device="cpu").forward(
            params, tokens[:, :-1]), 2).values
    close = (top2[..., 0] - top2[..., 1]).numpy() < 1e-4
    assert preds["cuda"].dtype == np.int32
    assert np.array_equal(preds["cuda"][~close], preds["cpu"][~close])


# ---------------------------------------------------------------------------
# LoRA fine-tuning and the optimizer-state policies on the card
# ---------------------------------------------------------------------------

_LORA_STEP = dict(vocab_size=512, n_layer=2, n_head=4, d_model=256,
                  seq_len=128, lora_rank=4, warmup_steps=0, lr=1e-2)


@pytest.mark.parametrize("lora_rank", [4, 0])
def test_lora_step_launches_no_ce_dw_on_the_card(cuda, lora_rank):
    """Per step at d 256 (the CE kernel route, head_dim 64): CE fwd 1,
    dx 1, dW 0 under LoRA (1 without); LN bwd 2L under LoRA, 2L+1
    without; flash fwd/bwd L; the counts
    ``test_torch_lora_train.py::test_ce_dw_never_launches_under_lora``
    reads on the CPU.  The base stays bitwise; the adapters move."""
    cfg = GPTConfig(**{**_LORA_STEP, "lora_rank": lora_rank})
    counted = {"ln_fwd": ln.ln_fwd, "ln_bwd": ln.ln_bwd,
               "flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd,
               "ce_fwd": ce.ce_fwd, "ce_bwd_dx": ce.ce_bwd_dx,
               "ce_bwd_dw": ce.ce_bwd_dw}
    module = GPT(cfg)
    init = GPT(cfg, device="cpu").init_params()
    module.initial_params = init
    for fn in counted.values():
        fn.launches = 0
    tr = Trainer(LocalStrategy(megastep="off"), max_steps=2,
                 limit_val_batches=0, enable_checkpointing=False)
    tr.fit(module, SyntheticLMDataModule(cfg, batch_size=2, num_batches=2))
    L, lora_on = cfg.n_layer, lora_rank > 0
    assert {k: fn.launches / 2 for k, fn in counted.items()} == {
        "ln_fwd": 2 * L + 1, "ln_bwd": 2 * L + (not lora_on),
        "flash_fwd": L, "flash_bwd": L, "ce_fwd": 1, "ce_bwd_dx": 1,
        "ce_bwd_dw": 0 if lora_on else 1}
    if lora_on:
        got = tr.state.params
        assert torch.equal(got["wte"].cpu(), init["wte"])
        assert torch.equal(got["blocks"]["qkv_w"].cpu(),
                           init["blocks"]["qkv_w"])
        assert float(got["blocks"]["lora_qkv_b"].abs().max()) > 0


@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8"])
def test_opt_state_bytes_on_the_card(cuda, dtype):
    """The moments' bytes on the card equal ``opt_state_bytes`` after a
    captured stride (the write-back keeps each leaf's dtype and size)."""
    from ray_lightning_tpu_torch.models.optim import (
        moment_bytes, opt_state_bytes,
    )

    cfg = dataclasses.replace(GPTConfig.tiny(), opt_state_dtype=dtype)
    tr = Trainer(LocalStrategy(megastep=2), max_steps=6, limit_val_batches=0,
                 enable_checkpointing=False)
    tr.fit(GPT(cfg), SyntheticLMDataModule(cfg, batch_size=2,
                                           num_batches=6))
    assert tr.callback_metrics["recompiles"] == 1
    assert moment_bytes(tr.state.opt_state) == opt_state_bytes(
        tr.state.params, dtype)
    assert np.isfinite(tr.callback_metrics["train_loss"])


def test_int8_fit_captured_equals_eager(cuda):
    """int8 moments under capture: every inner step dequantizes, updates
    and requantizes into the state's own tensors; the captured fit equals
    the eager one bitwise with the plain attention."""
    from ray_lightning_tpu_torch.models.optim import tree_leaves

    cfg = dataclasses.replace(GPTConfig.tiny(), opt_state_dtype="int8")
    init = GPT(cfg, device="cpu").init_params()

    def fit(megastep):
        m = GPT(cfg, attn_impl="xla")
        m.initial_params = init
        tr = Trainer(LocalStrategy(megastep=megastep), max_steps=8,
                     limit_val_batches=0, enable_checkpointing=False)
        tr.fit(m, SyntheticLMDataModule(cfg, batch_size=2, num_batches=8))
        return tree_leaves((tr.state.params, tr.state.opt_state))

    for a, b in zip(fit("off"), fit(4)):
        assert torch.equal(a, b)
