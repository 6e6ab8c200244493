"""Tied LM head + cross-entropy without an ``(N, V)`` logits tensor.

Two routes, as in the JAX package (``ray_lightning_tpu/ops/
cross_entropy.py``), chosen by :func:`fused_lm_head_cross_entropy`:

* the kernels (``use_kernel=True`` on a shape the JAX gate
  ``_pallas_fwd_ok`` admits: ``d % 128 == 0`` and ``d <= 1536·2 /
  itemsize(compute dtype)``): a ``torch.autograd.Function`` whose forward
  is :func:`ce_fwd` and whose backward is :func:`ce_bwd_dx` and
  :func:`ce_bwd_dw`.  On CPU tensors they run their plain versions
  (:func:`ce_fwd_plain`, :func:`ce_bwd_dx_plain`, :func:`ce_bwd_dw_plain`);
  on CUDA tensors they launch the kernels of ``csrc/cross_entropy.cu``
  (which replace ``_ce_fwd_pallas`` and the two kernels of
  ``_ce_bwd_pallas``) or raise.  Each launch adds one to
  ``ce_fwd.launches``, ``ce_bwd_dx.launches`` or ``ce_bwd_dw.launches``;
* otherwise the vocab-chunk scan (``_fused_ce_fwd``/``_ce_bwd_core``): the
  forward walks the vocabulary in chunks, folding each chunk's logits into
  a running max, sum of exponentials and gold logit, and the backward
  recomputes each chunk's logits.

Both autograd Functions save only ``(x, wte, targets, lse)``.

:func:`fused_lm_head_cross_entropy_sharded` is the JAX package's
multi-device island (``fused_lm_head_cross_entropy_sharded``, a
``shard_map`` over the batch axes) over a ``torch.distributed`` process
group: each rank runs the fused CE above on its own rows against the
whole vocabulary, and the backward's one collective is the all-reduce
(sum) of the ranks' ``dwte`` partials.

Numerics: the products take compute-dtype operands and give f32 results
(the JAX ``preferred_element_type=f32``: a bf16·bf16 product is exact in
f32, so only the sums' order differs); statistics, the loss and both
gradients are f32; ``dlogits`` is rounded to the compute dtype before both
backward products.  Vocab columns past V (zero padding of the scan's
chunks, the ragged tail of the kernels' tiles) are masked to -1e30, whose
exponential adds exactly 0; the plain versions work on the V real columns
and so need no mask.  The scan's chunk products are ``torch.mm`` — the
JAX package also leaves them to its compiler.
"""

from __future__ import annotations

from typing import Optional, Tuple

import ctypes

import torch

from ray_lightning_tpu_torch.ops import _build
from ray_lightning_tpu_torch.ops.attention import _NEG_INF
from ray_lightning_tpu_torch.ops.matmul import mm_f32

__all__ = ["fused_lm_head_cross_entropy", "naive_lm_head_cross_entropy",
           "fused_lm_head_cross_entropy_sharded",
           "ce_fwd", "ce_bwd_dx", "ce_bwd_dw", "ce_fwd_plain",
           "ce_bwd_dx_plain", "ce_bwd_dw_plain", "kernel_route_ok"]

# The JAX gate's cap on d, in bf16 elements (``_CE_MAX_D``).
_MAX_D = 1536
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])


def _pick_num_chunks(vocab_size: int, target_chunk: int = 8192) -> int:
    return max(1, -(-vocab_size // target_chunk))


def _chunk_wte(wte: torch.Tensor, num_chunks: int
               ) -> Tuple[torch.Tensor, int]:
    """(V, d) -> (K, Vc, d), zero-padding V up to K·Vc, Vc rounded up to
    a multiple of 128 (as the JAX package rounds it)."""
    V, d = wte.shape
    Vc = -(-V // num_chunks)
    Vc = -(-Vc // 128) * 128
    pad = num_chunks * Vc - V
    if pad:
        wte = torch.cat([wte, wte.new_zeros(pad, d)], dim=0)
    return wte.reshape(num_chunks, Vc, d), Vc


def _chunk_logits(x: torch.Tensor, wte_chunk: torch.Tensor, offset: int,
                  vocab_size: int, compute_dtype: torch.dtype
                  ) -> torch.Tensor:
    """x (N, d) @ wte_chunk (Vc, d)ᵀ -> (N, Vc) f32, padded rows masked."""
    Vc = wte_chunk.shape[0]
    logits = mm_f32(x.to(compute_dtype), wte_chunk.to(compute_dtype).T)
    valid = (offset + torch.arange(Vc, device=x.device)) < vocab_size
    return torch.where(valid, logits, _NEG_INF)


def _ce_fwd(x: torch.Tensor, wte: torch.Tensor, targets: torch.Tensor,
            num_chunks: int, compute_dtype: torch.dtype
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, lse) per row of ``x (N, d)``, both f32 (N,)."""
    V = wte.shape[0]
    chunks, Vc = _chunk_wte(wte, num_chunks)
    n = x.shape[0]
    m = torch.full((n,), _NEG_INF, dtype=torch.float32, device=x.device)
    s = torch.zeros(n, dtype=torch.float32, device=x.device)
    gold = torch.zeros(n, dtype=torch.float32, device=x.device)
    for kc in range(num_chunks):
        offset = kc * Vc
        logits = _chunk_logits(x, chunks[kc], offset, V, compute_dtype)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        shifted = targets - offset
        in_chunk = (shifted >= 0) & (shifted < Vc)
        picked = logits.gather(
            1, shifted.clamp(0, Vc - 1)[:, None].long())[:, 0]
        gold = torch.where(in_chunk, picked, gold)
    lse = m + torch.log(s)
    return lse - gold, lse


def _ce_bwd(x: torch.Tensor, wte: torch.Tensor, targets: torch.Tensor,
            lse: torch.Tensor, g: torch.Tensor, num_chunks: int,
            compute_dtype: torch.dtype, want_dw: bool = True
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dx (N, d), dwte (V, d)), both f32; dwte None (its products not
    computed) unless ``want_dw``."""
    V, d = wte.shape
    chunks, Vc = _chunk_wte(wte, num_chunks)
    g32 = g.float()
    xc = x.to(compute_dtype)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dw = []
    cols = torch.arange(Vc, device=x.device)
    for kc in range(num_chunks):
        offset = kc * Vc
        wc = chunks[kc].to(compute_dtype)
        logits = _chunk_logits(x, chunks[kc], offset, V, compute_dtype)
        p = torch.exp(logits - lse[:, None])
        onehot = ((targets - offset)[:, None] == cols).float()
        dl_c = ((p - onehot) * g32[:, None]).to(compute_dtype)
        dx += mm_f32(dl_c, wc)
        if want_dw:
            dw.append(mm_f32(dl_c.T, xc))
    return dx, torch.cat(dw, dim=0)[:V] if want_dw else None


# -- the kernel route ---------------------------------------------------------

def ce_fwd_plain(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, lse)``, both f32 ``(N,)``, of ``x (N, d)`` against ``w
    (V, d)`` (one compute dtype) — the math of the JAX ``_ce_fwd_kernel``
    in one pass over the full f32 logits."""
    logits = mm_f32(x, w.t())
    m = logits.amax(dim=1)
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=1))
    gold = logits.gather(1, targets.long()[:, None])[:, 0]
    return lse - gold, lse


def _dlogits_plain(x, w, targets, lse, g):
    """``(exp(logits − lse) − onehot)·g`` rounded to the compute dtype."""
    p = torch.exp(mm_f32(x, w.t()) - lse[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    p[rows, targets.long()] -= 1.0
    return (p * g.float()[:, None]).to(x.dtype)


def ce_bwd_dx_plain(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                    lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dx = dlogits·w``, f32 ``(N, d)`` — the JAX ``_ce_bwd_dx_kernel``."""
    return mm_f32(_dlogits_plain(x, w, targets, lse, g), w)


def ce_bwd_dw_plain(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                    lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dW = dlogitsᵀ·x``, f32 ``(V, d)`` — the JAX ``_ce_bwd_dw_kernel``."""
    return mm_f32(_dlogits_plain(x, w, targets, lse, g).t(), x)


def kernel_route_ok(d: int, compute_dtype: torch.dtype) -> bool:
    """The JAX gate ``_pallas_fwd_ok``: a lane-aligned feature dim within
    the cap, counted in bytes of the compute dtype.  A rule about shape,
    the same in both packages."""
    return d % 128 == 0 and d <= _MAX_D * 2 // compute_dtype.itemsize


def _kernel_args(where: str, x: torch.Tensor, w: torch.Tensor,
                 targets: torch.Tensor, *vectors: torch.Tensor):
    """Check what the kernels take; ``(dtype code, int32 targets, f32
    contiguous vectors)``."""
    code = _DTYPE_CODES.get(x.dtype)
    if code is None or w.dtype != x.dtype:
        raise ValueError(f"{where} kernel takes f32 or bf16 x and w of one "
                         f"dtype, got {x.dtype}/{w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or w.shape[1] != x.shape[1]:
        raise ValueError(f"{where}: x (N, d) and w (V, d) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, d = x.shape
    if d % 128 or d < 128:
        raise ValueError(f"{where} kernel takes d a multiple of 128, got "
                         f"d={d}: use the vocab-chunk scan")
    if targets.shape != (n,) or targets.dtype not in (torch.int32,
                                                      torch.int64):
        raise ValueError(f"{where}: targets must be int ({n},), got "
                         f"{targets.dtype} {tuple(targets.shape)}")
    for t in (w, targets, *vectors):
        if t.device != x.device:
            raise ValueError(f"{where}: a tensor is on {t.device}, x on "
                             f"{x.device}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{where} kernel needs {name} contiguous with "
                             f"16-byte aligned rows")
    for t in vectors:
        if t.shape != (n,):
            raise ValueError(f"{where}: lse and g must be ({n},), got "
                             f"{tuple(t.shape)}")
    return (code, targets.to(torch.int32).contiguous(),
            [t.float().contiguous() for t in vectors])


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def ce_fwd(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE forward: ``(loss, lse)`` f32 ``(N,)`` for ``x (N, d)``, ``w
    (V, d)`` in one compute dtype and int ``targets (N,)``.  CPU tensors
    run :func:`ce_fwd_plain`; CUDA tensors launch the kernel (one launch,
    counted) or raise."""
    if x.device.type == "cpu":
        return ce_fwd_plain(x, w, targets)
    if x.device.type != "cuda":
        raise ValueError(f"ce_fwd: unsupported device {x.device}")
    code, t32, _ = _kernel_args("ce_fwd", x, w, targets)
    n, d = x.shape
    loss = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return loss, lse
    fn = _build.load_function("cross_entropy", "rlt_ce_fwd", _FWD_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), t32.data_ptr(), loss.data_ptr(),
             lse.data_ptr(), n, w.shape[0], d, code, x.device.index or 0,
             _stream(x))
    if err != 0:
        raise RuntimeError(f"ce_fwd kernel launch failed: CUDA error {err}")
    ce_fwd.launches += 1
    return loss, lse


ce_fwd.launches = 0


def _ce_bwd_launch(where: str, symbol: str, rows: int, x, w, targets, lse,
                   g) -> torch.Tensor:
    code, t32, (lse32, g32) = _kernel_args(where, x, w, targets, lse, g)
    n, d = x.shape
    out = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    if n == 0:
        return out.zero_()
    fn = _build.load_function("cross_entropy", symbol, _BWD_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), t32.data_ptr(), lse32.data_ptr(),
             g32.data_ptr(), out.data_ptr(), n, w.shape[0], d, code,
             x.device.index or 0, _stream(x))
    if err != 0:
        raise RuntimeError(f"{where} kernel launch failed: CUDA error {err}")
    return out


def ce_bwd_dx(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
              lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """CE backward to x: f32 ``(N, d)`` from the saved ``lse`` and the
    cotangent ``g (N,)``.  CPU tensors run :func:`ce_bwd_dx_plain`; CUDA
    tensors launch the kernel (one launch, counted) or raise."""
    if x.device.type == "cpu":
        return ce_bwd_dx_plain(x, w, targets, lse, g)
    if x.device.type != "cuda":
        raise ValueError(f"ce_bwd_dx: unsupported device {x.device}")
    dx = _ce_bwd_launch("ce_bwd_dx", "rlt_ce_bwd_dx", x.shape[0], x, w,
                        targets, lse, g)
    if x.shape[0]:
        ce_bwd_dx.launches += 1
    return dx


ce_bwd_dx.launches = 0


def ce_bwd_dw(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
              lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """CE backward to w: f32 ``(V, d)``.  CPU tensors run
    :func:`ce_bwd_dw_plain`; CUDA tensors launch the kernel (one launch,
    counted) or raise."""
    if x.device.type == "cpu":
        return ce_bwd_dw_plain(x, w, targets, lse, g)
    if x.device.type != "cuda":
        raise ValueError(f"ce_bwd_dw: unsupported device {x.device}")
    dw = _ce_bwd_launch("ce_bwd_dw", "rlt_ce_bwd_dw", w.shape[0], x, w,
                        targets, lse, g)
    if x.shape[0]:
        ce_bwd_dw.launches += 1
    return dw


ce_bwd_dw.launches = 0


class _FusedCEKernel(torch.autograd.Function):
    """The JAX ``_fused_ce`` custom VJP on its kernel branch: the forward
    saves ``(x, wte, targets, lse)``; the backward casts x and wte to the
    compute dtype again and runs :func:`ce_bwd_dx` and :func:`ce_bwd_dw`."""

    @staticmethod
    def forward(ctx, x, wte, targets, compute_dtype):
        loss, lse = ce_fwd(x.to(compute_dtype).contiguous(),
                           wte.to(compute_dtype).contiguous(), targets)
        ctx.save_for_backward(x, wte, targets, lse)
        ctx.compute_dtype = compute_dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        x, wte, targets, lse = ctx.saved_tensors
        xc = x.to(ctx.compute_dtype).contiguous()
        wc = wte.to(ctx.compute_dtype).contiguous()
        g32 = g.float().contiguous()
        dx = ce_bwd_dx(xc, wc, targets, lse, g32)
        if not ctx.needs_input_grad[1]:  # wte frozen (LoRA): no dW launch
            return dx.to(x.dtype), None, None, None
        dw = ce_bwd_dw(xc, wc, targets, lse, g32)
        return dx.to(x.dtype), dw.to(wte.dtype), None, None


class _FusedCE(torch.autograd.Function):
    """The JAX ``_fused_ce`` custom VJP on its scan path: saves ``(x, wte,
    targets, lse)`` and recomputes each chunk's logits in the backward."""

    @staticmethod
    def forward(ctx, x, wte, targets, num_chunks, compute_dtype):
        loss, lse = _ce_fwd(x, wte, targets, num_chunks, compute_dtype)
        ctx.save_for_backward(x, wte, targets, lse)
        ctx.num_chunks = num_chunks
        ctx.compute_dtype = compute_dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        x, wte, targets, lse = ctx.saved_tensors
        want_dw = ctx.needs_input_grad[1]
        dx, dwte = _ce_bwd(x, wte, targets, lse, g, ctx.num_chunks,
                           ctx.compute_dtype, want_dw)
        return (dx.to(x.dtype), dwte.to(wte.dtype) if want_dw else None,
                None, None, None)


def fused_lm_head_cross_entropy(
    x: torch.Tensor, wte: torch.Tensor, targets: torch.Tensor, *,
    num_chunks: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Per-token CE loss of the tied LM head without the ``(..., V)``
    logits: ``x (..., d)``, ``wte (V, d)``, int ``targets`` of
    ``x.shape[:-1]`` -> f32 losses of ``targets.shape``.

    ``use_kernel`` (the JAX ``use_pallas``): the kernel route where
    :func:`kernel_route_ok` admits ``d``; otherwise the vocab-chunk scan,
    ``num_chunks`` defaulting to ~8192-wide chunks."""
    lead = targets.shape
    x2 = x.reshape(-1, x.shape[-1])
    t1 = targets.reshape(-1)
    if use_kernel and kernel_route_ok(x.shape[-1], compute_dtype):
        loss = _FusedCEKernel.apply(x2, wte, t1, compute_dtype)
    else:
        if num_chunks is None:
            num_chunks = _pick_num_chunks(wte.shape[0])
        loss = _FusedCE.apply(x2, wte, t1, int(num_chunks), compute_dtype)
    return loss.reshape(lead)


class _SumOverRanks(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over ``group``'s
    ranks (one ``all_reduce``): the island's ``dwte`` psum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def fused_lm_head_cross_entropy_sharded(
    x: torch.Tensor, wte: torch.Tensor, targets: torch.Tensor,
    group=None, *, global_batch: Optional[int] = None,
    num_chunks: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    use_kernel: bool = False,
) -> torch.Tensor:
    """The multi-device fused CE island (the JAX
    ``fused_lm_head_cross_entropy_sharded``) over ``group`` (None: the
    default process group): every rank calls it at the same point with its
    own rows ``x (b, ..., d)`` and ``targets (b, ...)`` of the global
    batch, batch-sharded on dim 0, and the whole ``wte (V, d)``, which
    every rank holds alike (a replicated head: pure data parallelism or
    ZeRO-1, not ZeRO-3's param slices).  It returns this rank's per-token
    f32 losses, each through :func:`fused_lm_head_cross_entropy` (the
    kernels with ``use_kernel`` where the gate admits ``d``, else the
    scan); the backward's one collective is the all-reduce (sum) of the
    ranks' ``dwte`` partials, so every rank gets the gradient of the sum
    of every rank's loss.  Reduce the losses to the rank's share of the
    global mean (``losses.sum() / global_tokens``; ``losses.mean() /
    world`` where the shares are equal) for the global mean's gradient,
    as the JAX island's ``.mean()`` over the global array gives it.

    ``global_batch``: the global batch the rows are a share of (the JAX
    island's ``x.shape[0]``); one that does not split over the ranks
    raises with the JAX island's words, and so does a share of another
    size than this rank's rows."""
    import torch.distributed as dist

    n_shards = dist.get_world_size(group)
    if global_batch is not None:
        if global_batch % n_shards:
            raise ValueError(
                f"batch dim {global_batch} not divisible by the group's "
                f"ranks={n_shards}")
        if global_batch // n_shards != x.shape[0]:
            raise ValueError(
                f"rank rows {x.shape[0]} are not a 1/{n_shards} share of "
                f"the global batch {global_batch}")
    return fused_lm_head_cross_entropy(
        x, _SumOverRanks.apply(wte, group), targets, num_chunks=num_chunks,
        compute_dtype=compute_dtype, use_kernel=use_kernel)


def naive_lm_head_cross_entropy(
    x: torch.Tensor, wte: torch.Tensor, targets: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Reference path: the full ``(..., V)`` f32 logits, then softmax CE
    (autograd differentiates it)."""
    lead = targets.shape
    logits = mm_f32(x.reshape(-1, x.shape[-1]).to(compute_dtype),
                    wte.to(compute_dtype).T)
    loss = torch.nn.functional.cross_entropy(
        logits, targets.reshape(-1).long(), reduction="none")
    return loss.reshape(lead)
