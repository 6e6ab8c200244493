"""LayerNorm with f32 statistics, and its hand-written CUDA kernels.

The math of the JAX package's ``ops/layer_norm.py``: f32 mean and biased
variance, eps 1e-5, ``rsqrt``, ``(x - mu) * rstd * g + b`` in f32, the
result cast back to the input's dtype.

``layer_norm(x, g, b)`` runs that math in plain PyTorch on any device (the
JAX package's ``use_pallas=False`` path, which decode and serving take).
``layer_norm(x, g, b, use_kernel=True)`` — the training step's LN sites —
goes through a ``torch.autograd.Function`` whose forward and backward are
:func:`ln_fwd` and :func:`ln_bwd`: on CPU tensors they run the plain pair
(:func:`ln_fwd_plain`, :func:`ln_bwd_plain`), on CUDA tensors they launch
the kernels of ``csrc/layer_norm.cu`` (which replace ``_ln_fwd_pallas`` and
``_ln_bwd_pallas``) or raise.  Each launch adds one to ``ln_fwd.launches``
or ``ln_bwd.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ray_lightning_tpu_torch.ops import _build

__all__ = ["layer_norm", "ln_fwd", "ln_bwd", "ln_fwd_plain", "ln_bwd_plain"]

_EPS = 1e-5
# Kernel dtype codes of csrc/layer_norm.cu (x, y, dy and dx share one).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def ln_fwd_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mu, rstd)`` for ``x (..., d)``: ``y`` in x's dtype and shape,
    ``mu``/``rstd`` f32 over the flattened rows — the math of the JAX
    ``_ln_fwd_kernel``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mu
    var = (centered * centered).mean(dim=-1, keepdim=True)
    rs = torch.rsqrt(var + _EPS)
    y = (centered * rs * g.float() + b.float()).to(x.dtype)
    return y, mu.reshape(-1), rs.reshape(-1)


def ln_bwd_plain(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
                 mu: torch.Tensor, rstd: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dg, db)`` from the saved row statistics — the math of the
    JAX ``_ln_bwd_kernel``: ``dx = (dy·g − mean(dy·g) − x̂·mean(dy·g·x̂))
    ·rstd`` in x's dtype, ``dg = Σ dy·x̂`` and ``db = Σ dy`` in f32."""
    d = x.shape[-1]
    x32 = x.reshape(-1, d).float()
    dy32 = dy.reshape(-1, d).float()
    rs = rstd.reshape(-1, 1)
    xhat = (x32 - mu.reshape(-1, 1)) * rs
    dyg = dy32 * g.float()
    m1 = dyg.mean(dim=1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=1, keepdim=True)
    dx = ((dyg - m1 - xhat * m2) * rs).to(x.dtype).reshape(x.shape)
    return dx, (dy32 * xhat).sum(0), dy32.sum(0)


def _check(x: torch.Tensor, where: str, *others: torch.Tensor) -> int:
    """The kernel's dtype code for ``x``; raises on what it does not take."""
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"{where} kernel takes f32 or bf16 x, got {x.dtype}")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"{where}: a tensor is on {t.device}, x on "
                             f"{x.device}")
    return code


def ln_fwd(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
           want_stats: bool = True
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                      Optional[torch.Tensor]]:
    """LayerNorm forward of ``x (..., d)`` with f32-or-castable ``g``/``b``
    ``(d,)``: ``(y, mu, rstd)``; ``mu``/``rstd`` are None unless
    ``want_stats``.  CPU tensors run :func:`ln_fwd_plain`; CUDA tensors
    launch the kernel (one launch, counted) or raise."""
    if x.device.type == "cpu":
        y, mu, rs = ln_fwd_plain(x, g, b)
        return (y, mu, rs) if want_stats else (y, None, None)
    if x.device.type != "cuda":
        raise ValueError(f"ln_fwd: unsupported device {x.device}")
    code = _check(x, "ln_fwd", g, b)
    d = x.shape[-1]
    x2 = x.contiguous()
    n = x2.numel() // d if d else 0
    g32 = g.float().contiguous()
    b32 = b.float().contiguous()
    if g32.shape != (d,) or b32.shape != (d,):
        raise ValueError(f"ln_fwd: g and b must be ({d},), got "
                         f"{tuple(g.shape)} and {tuple(b.shape)}")
    y = torch.empty_like(x2)
    mu = rs = None
    if want_stats:
        mu = torch.empty(n, dtype=torch.float32, device=x.device)
        rs = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return y, mu, rs
    fn = _build.load_function("layer_norm", "rlt_ln_fwd", _FWD_ARGTYPES)
    err = fn(x2.data_ptr(), g32.data_ptr(), b32.data_ptr(), y.data_ptr(),
             None if mu is None else mu.data_ptr(),
             None if rs is None else rs.data_ptr(), n, d, code,
             x.device.index or 0,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ln_fwd kernel launch failed: CUDA error {err}")
    ln_fwd.launches += 1
    return y, mu, rs


ln_fwd.launches = 0


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ln_bwd(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor,
           mu: torch.Tensor, rstd: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm backward: ``(dx, dg, db)`` with ``dg``/``db`` f32.  CPU
    tensors run :func:`ln_bwd_plain`; CUDA tensors launch the kernel (one
    launch, counted) or raise."""
    if x.device.type == "cpu":
        return ln_bwd_plain(x, g, dy, mu, rstd)
    if x.device.type != "cuda":
        raise ValueError(f"ln_bwd: unsupported device {x.device}")
    code = _check(x, "ln_bwd", g, dy, mu, rstd)
    d = x.shape[-1]
    n = x.numel() // d
    if (dy.shape != x.shape or mu.numel() != n or rstd.numel() != n
            or g.shape != (d,)):
        raise ValueError(
            f"ln_bwd: mismatched shapes x {tuple(x.shape)}, dy "
            f"{tuple(dy.shape)}, g {tuple(g.shape)}, mu {tuple(mu.shape)}, "
            f"rstd {tuple(rstd.shape)}")
    # Each returns the tensor itself where it already has the kernel's
    # dtype and layout, as the training step's tensors do: no copies there.
    x2, dy2 = x.contiguous(), dy.to(x.dtype).contiguous()
    g32, mu32, rs32 = (t.float().contiguous() for t in (g, mu, rstd))
    dx = torch.empty_like(x2)
    dg = torch.empty(d, dtype=torch.float32, device=x.device)
    db = torch.empty(d, dtype=torch.float32, device=x.device)
    # Per-block f32 partials of dg/db: two blocks per SM, each striding
    # over the rows.
    blocks = max(1, min(-(-n // 8), 2 * _sm_count(x.device)))
    part = torch.empty(blocks * 2 * d, dtype=torch.float32, device=x.device)
    fn = _build.load_function("layer_norm", "rlt_ln_bwd", _BWD_ARGTYPES)
    err = fn(x2.data_ptr(), g32.data_ptr(), dy2.data_ptr(), mu32.data_ptr(),
             rs32.data_ptr(), dx.data_ptr(), part.data_ptr(), dg.data_ptr(),
             db.data_ptr(), n, d, blocks, code, x.device.index or 0,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ln_bwd kernel launch failed: CUDA error {err}")
    ln_bwd.launches += 1
    return dx, dg, db


ln_bwd.launches = 0


class _LayerNorm(torch.autograd.Function):
    """``jax.custom_vjp`` ``_fused_ln`` of the JAX package: the forward
    saves ``(x, g, mu, rstd)``, the backward returns ``dx`` and ``dg``/
    ``db`` cast to ``g``'s dtype."""

    @staticmethod
    def forward(ctx, x, g, b):
        y, mu, rs = ln_fwd(x, g, b, want_stats=True)
        ctx.save_for_backward(x, g, mu, rs)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, mu, rs = ctx.saved_tensors
        dx, dg, db = ln_bwd(x, g, dy, mu, rs)
        return dx, dg.to(g.dtype), db.to(g.dtype)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               use_kernel: bool = False) -> torch.Tensor:
    """LayerNorm of ``x (..., d)`` with gain ``g (d,)`` and bias ``b (d,)``.

    ``use_kernel=False``: the plain math, differentiable by autograd, on
    any device.  ``use_kernel=True``: the forward/backward pair above —
    the kernels on CUDA tensors, their plain versions on CPU tensors.  A
    call that needs no gradient writes ``y`` alone."""
    if not use_kernel:
        return ln_fwd_plain(x, g, b)[0]
    if torch.is_grad_enabled() and (x.requires_grad or g.requires_grad
                                    or b.requires_grad):
        return _LayerNorm.apply(x, g, b)
    return ln_fwd(x, g, b, want_stats=False)[0]
