"""Causal flash attention on ``(B, S, H, D)`` tensors, and its CUDA kernels.

:func:`flash_attention` has the shape of the JAX package's
``_flash``/``_flash_vjp_fwd``/``_flash_vjp_bwd``
(``ray_lightning_tpu/ops/flash_attention.py``): the forward returns
``out`` and saves ``(q, k, v, out, lse)``; the backward recomputes the
probabilities from ``lse``.  The forward is the registered operator
``torch.ops.rlt_torch.flash_fwd`` (:func:`flash_fwd_op`), which a
selective-checkpoint policy can name, as the JAX package names the
residuals ``flash_out``/``flash_lse`` with ``checkpoint_name``.  Its two halves are :func:`flash_fwd` and
:func:`flash_bwd`: on CPU tensors they run the plain pair
(:func:`flash_fwd_plain`, :func:`flash_bwd_plain`), on CUDA tensors they
launch the kernels of ``csrc/flash_attention.cu`` (which replace
``_flash_fwd_bhsd`` and ``_flash_bwd_bhsd``) or raise.  Each launch adds one
to ``flash_fwd.launches`` or ``flash_bwd.launches``.

Roundings follow the JAX kernels: f32 scores with ``scale`` applied to them
(not folded into q), hidden keys at -1e30 (not -inf), ``p`` cast to v's
dtype before the P·V product and ``ds`` to q's dtype before the dK and dQ
products.  ``lse`` is ``(B·H, S)`` f32 (the JAX kernels' 8-lane broadcast is
a TPU tiling device).  The kernels read q, k and v through their strides,
so views of a fused QKV projection are taken as they are.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ray_lightning_tpu_torch.ops import _build
from ray_lightning_tpu_torch.ops.attention import _NEG_INF

__all__ = ["flash_attention", "flash_fwd", "flash_bwd", "flash_fwd_op",
           "flash_fwd_plain", "flash_bwd_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_TILE = 64  # S must be a multiple of it
_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 9
                 + [ctypes.c_int] * 4 + [ctypes.c_float]
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 9
                 + [ctypes.c_int] * 4 + [ctypes.c_float]
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """Causally masked f32 scores ``(B, H, S, S)``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    n = q.shape[1]
    pos = torch.arange(n, device=q.device)
    return torch.where(pos[:, None] >= pos[None, :], s, _NEG_INF)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: ``out (B, S, H, D)`` in q's dtype and ``lse
    (B·H, S)`` f32 — the math of the JAX ``_fwd_kernel`` in one pass."""
    B, S, H, _ = q.shape
    s = _scores(q, k, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (pv / l.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B * H, S)
    return out, lse


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the saved ``out``/``lse`` — the math of the
    JAX ``_bwd_kernel``: ``p = exp(s − lse)``, ``delta = rowsum(dO·O)``,
    ``ds = p·(dp − delta)·scale``."""
    B, S, H, _ = q.shape
    p = torch.exp(_scores(q, k, scale) - lse.reshape(B, H, S, 1))
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 where: str) -> Tuple[int, Tuple[int, ...]]:
    """Check what the kernel takes; ``(dtype code, strides of q, k, v)``.
    A shape the kernel rejects raises and names the plain attention."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{where}: q, k, v must share one (B, S, H, D) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{where} kernel takes f32 or bf16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}; use "
                         f"impl='xla'")
    B, S, H, D = q.shape
    if D not in KERNEL_HEAD_DIMS or S % KERNEL_TILE or B * H > 65535:
        raise ValueError(
            f"{where} kernel takes head_dim in {KERNEL_HEAD_DIMS}, seq_len "
            f"a multiple of {KERNEL_TILE} and B·H <= 65535; got B={B} S={S}"
            f" H={H} D={D}: use impl='xla' for this shape")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{where}: {name} is on {t.device}, q on "
                             f"{q.device}")
    strides = []
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError(f"{where} kernel needs the head_dim axis "
                             f"contiguous, got strides {t.stride()}")
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    if q.dtype == torch.bfloat16:
        _check_vector_aligned(where, q, k, v)
    return code, tuple(strides)


def _check_vector_aligned(where: str, *ts: torch.Tensor) -> None:
    """The bf16 (tensor-core) kernels load rows 16 bytes at a time."""
    for t in ts:
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"{where} bf16 kernel needs 16-byte aligned rows (data "
                f"pointer and strides in multiples of 8 elements), got "
                f"strides {t.stride()}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, want_lse: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Causal attention forward: ``(out, lse)``, ``lse`` None unless
    ``want_lse``.  CPU tensors run :func:`flash_fwd_plain`; CUDA tensors
    launch the kernel (one launch, counted) or raise."""
    if q.device.type == "cpu":
        out, lse = flash_fwd_plain(q, k, v, scale)
        return out, (lse if want_lse else None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    code, strides = _kernel_args(q, k, v, "flash_fwd")
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B * H, S), dtype=torch.float32, device=q.device)
           if want_lse else None)
    fn = _build.load_function("flash_attention", "rlt_flash_fwd",
                              _FWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), *strides, B, H, S, D,
             float(scale), code, q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention backward: ``(dq, dk, dv)``.  CPU tensors run
    :func:`flash_bwd_plain`; CUDA tensors launch the kernels (one wrapper
    call, counted once) or raise."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    code, strides = _kernel_args(q, k, v, "flash_bwd")
    B, S, H, D = q.shape
    out = out.contiguous()
    do = do.to(q.dtype).contiguous()
    lse = lse.contiguous()
    if q.dtype == torch.bfloat16:
        _check_vector_aligned("flash_bwd", do)
    if (out.shape != q.shape or do.shape != q.shape
            or lse.shape != (B * H, S) or lse.dtype != torch.float32):
        raise ValueError(
            f"flash_bwd: out {tuple(out.shape)}, do {tuple(do.shape)} and "
            f"lse {tuple(lse.shape)} {lse.dtype} do not match q "
            f"{tuple(q.shape)}")
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    # dQ accumulates across key tiles in f32; for f32 straight into dq.
    dq_acc = dq if q.dtype == torch.float32 else torch.empty(
        (B, S, H, D), dtype=torch.float32, device=q.device)
    delta = torch.empty(B * H * S, dtype=torch.float32, device=q.device)
    fn = _build.load_function("flash_attention", "rlt_flash_bwd",
                              _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), dq_acc.data_ptr(), delta.data_ptr(), *strides,
             B, H, S, D, float(scale), code, q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {err}")
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


# The forward is a registered operator, not a ctypes call hidden inside an
# autograd.Function, so that a selective-checkpoint policy
# (``models/gpt.py``, ``remat_policy``) can see it and keep its outputs.
@torch.library.custom_op("rlt_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of :func:`flash_fwd` as the operator
    ``torch.ops.rlt_torch.flash_fwd``, differentiable through
    :func:`flash_bwd`."""
    return flash_fwd(q, k, v, scale, want_lse=True)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.scale = scale


def _flash_backward(ctx, do, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, out, lse, do, ctx.scale)
    return dq, dk, dv, None


flash_fwd_op.register_autograd(_flash_backward,
                               setup_context=_flash_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal flash attention, ``(B, S, H, D) -> (B, S, H, D)``.  A call
    that needs no gradient computes ``out`` alone."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_fwd_op(q, k, v, scale)[0]
    return flash_fwd(q, k, v, scale, want_lse=False)[0]
