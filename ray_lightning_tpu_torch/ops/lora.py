"""Batched-gather LoRA application (BGMV): ``y += (x @ A[ids]) @ B[ids]``.

The device primitive of multi-tenant LoRA serving (``serve/lora.py``):
every hook site holds the pool's adapters stacked in one buffer per layer
— ``A (N, d, r)``, ``B (N, r, k)`` — and each row applies its own adapter
by gathering its factors with an int32 ``ids`` tensor.  Slot 0 is the
pool's null adapter (zero factors): rows without an adapter get a delta of
exactly 0.0, so base and adapter rows share one dispatch.

Two implementations, chosen by the caller (the adapter pool's ``impl``),
never probed:

* ``"kernel"`` — :func:`bgmv`: the hand-written CUDA kernel
  (``csrc/bgmv.cu``) for CUDA tensors, which replaces the JAX package's
  Pallas ``bgmv_pallas``; for CPU tensors it runs :func:`bgmv_plain`.
* ``"plain"`` — :func:`bgmv_plain`: gather plus two batched products,
  the kernel's reference.
"""

from __future__ import annotations

import ctypes

import torch

from ray_lightning_tpu_torch.ops import _build

__all__ = ["LORA_IMPLS", "apply_lora", "lora_delta", "bgmv", "bgmv_plain"]

LORA_IMPLS = ("kernel", "plain")

# Kernel dtype codes of csrc/bgmv.cu (h, A, B and out share one dtype).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_RANK = 128
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_SCRATCH_ARGTYPES = [ctypes.c_int] * 7
# f32 elements of the kernel's scratch (its partial sums over slices of d)
# by (W, d, r, k, N, dtype code, device), from rlt_bgmv_scratch.
_scratch_floats = {}


def apply_lora(y: torch.Tensor, h: torch.Tensor, ad, site: str,
               ids, impl: str) -> torch.Tensor:
    """``y`` plus hook site ``site``'s per-row adapter delta — the one
    application hook of the static trunk and the paged decode.  ``ad is
    None`` (every caller without an adapter pool) returns ``y``."""
    if ad is None:
        return y
    return y + lora_delta(h, ad[f"{site}_a"], ad[f"{site}_b"], ids,
                          impl=impl)


def bgmv_plain(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """``(h @ a[ids]) @ b[ids]`` for ``h (W, d)`` → ``(W, k)``: the
    factors are cast to ``h.dtype`` (as ``bgmv_pallas`` casts them), both
    products accumulate in f32, and the output is cast to ``h.dtype``
    once.  ``b`` carries the adapter's LoRA scale pre-folded."""
    idx = ids.long()
    t = torch.einsum("wd,wdr->wr", h.float(), a[idx].to(h.dtype).float())
    return torch.einsum(
        "wr,wrk->wk", t, b[idx].to(h.dtype).float()
    ).to(h.dtype)


def bgmv(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         ids: torch.Tensor) -> torch.Tensor:
    """BGMV for ``h (W, d)``, ``a (N, d, r)``, ``b (N, r, k)``, ``ids (W,)``.

    CPU tensors run :func:`bgmv_plain`.  CUDA tensors launch the kernel or
    raise: f32 or bf16 ``h``/``a``/``b`` of one dtype, int32 ``ids``, all
    contiguous on one device, ``r <= 128``.  Each launch adds one to
    ``bgmv.launches`` and to ``bgmv.launches_by_rows[W]``."""
    if h.device.type == "cpu":
        return bgmv_plain(h, a, b, ids)
    if h.device.type != "cuda":
        raise ValueError(f"bgmv: unsupported device {h.device}")
    for name, t in (("a", a), ("b", b), ("ids", ids)):
        if t.device != h.device:
            raise ValueError(
                f"bgmv: {name} is on {t.device}, h on {h.device}"
            )
    code = _DTYPE_CODES.get(h.dtype)
    if code is None or a.dtype != h.dtype or b.dtype != h.dtype:
        raise ValueError(
            f"bgmv kernel takes f32 or bf16 h/a/b of one dtype, got "
            f"{h.dtype}/{a.dtype}/{b.dtype}"
        )
    if ids.dtype != torch.int32:
        raise ValueError(f"bgmv kernel takes int32 ids, got {ids.dtype}")
    if h.ndim != 2 or a.ndim != 3 or b.ndim != 3 or ids.ndim != 1:
        raise ValueError(
            f"bgmv: expected h (W, d), a (N, d, r), b (N, r, k), ids (W,); "
            f"got {tuple(h.shape)}, {tuple(a.shape)}, {tuple(b.shape)}, "
            f"{tuple(ids.shape)}"
        )
    W, d = h.shape
    n, d_a, r = a.shape
    k = b.shape[2]
    if d_a != d or b.shape[0] != n or b.shape[1] != r or ids.shape[0] != W:
        raise ValueError(
            f"bgmv: mismatched shapes h {tuple(h.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}, ids {tuple(ids.shape)}"
        )
    if not 1 <= r <= _MAX_RANK:
        raise ValueError(f"bgmv kernel takes rank 1..{_MAX_RANK}, got {r}")
    if not all(t.is_contiguous() for t in (h, a, b, ids)):
        raise ValueError("bgmv kernel takes contiguous tensors")
    out = torch.empty((W, k), dtype=h.dtype, device=h.device)
    if W == 0:
        return out
    device = h.device.index or 0
    key = (W, d, r, k, n, code, device)
    floats = _scratch_floats.get(key)
    if floats is None:
        size = _build.load_function("bgmv", "rlt_bgmv_scratch",
                                    _SCRATCH_ARGTYPES)
        size.restype = ctypes.c_longlong  # (load_function declares int)
        floats = _scratch_floats[key] = size(*key)
    scratch = torch.empty(max(floats, 1), dtype=torch.float32,
                          device=h.device)
    fn = _build.load_function("bgmv", "rlt_bgmv", _ARGTYPES)
    err = fn(
        h.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), W, d, r, k, n, code, device,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bgmv kernel launch failed: CUDA error {err}")
    bgmv.launches += 1
    bgmv.launches_by_rows[W] = bgmv.launches_by_rows.get(W, 0) + 1
    return out


bgmv.launches = 0
bgmv.launches_by_rows = {}


def lora_delta(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               ids: torch.Tensor, impl: str = "kernel") -> torch.Tensor:
    """Adapter delta for ``h`` of shape ``(W, d)`` or ``(B, T, d)``.

    ``ids`` matches the leading axis (one adapter per row or sequence).
    The 3-D form (prefill buckets) flattens to rows with each sequence's
    id repeated ``T`` times, so one entry point serves both paths."""
    if h.ndim == 3:
        B, T, d = h.shape
        flat = lora_delta(h.reshape(B * T, d), a, b,
                          ids.repeat_interleave(T), impl=impl)
        return flat.reshape(B, T, -1)
    if impl == "kernel":
        return bgmv(h.contiguous(), a, b, ids)
    if impl == "plain":
        return bgmv_plain(h, a, b, ids)
    raise ValueError(f"lora impl {impl!r} not in {LORA_IMPLS}")
