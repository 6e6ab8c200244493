"""Tied LM head + cross-entropy, vocab-chunked: no ``(N, V)`` logits tensor.

The vocab-chunk scan of the JAX package (``ray_lightning_tpu/ops/
cross_entropy.py``: ``_fused_ce_fwd``/``_ce_bwd_core``), which that package
runs wherever its Pallas CE kernels are off (``RLT_DISABLE_KERNELS=ce``,
every multi-device mesh).  The forward walks the vocabulary in chunks,
folding each chunk's logits into a running max, sum of exponentials and
gold logit; a ``torch.autograd.Function`` saves only ``(x, wte, targets,
lse)`` and recomputes each chunk's logits in the backward, so neither the
logits nor their gradient is ever held for the whole vocabulary.

Numerics: the products take compute-dtype operands and give f32 results
(the JAX ``preferred_element_type=f32``: a bf16·bf16 product is exact in
f32, so only the sums' order differs); statistics, the loss and both
gradients are f32.  The chunk products are ``torch.mm`` — in this
configuration the JAX package also leaves them to its compiler, outside
any Pallas kernel.  Vocab rows past V (zero padding up to a multiple of
128 per chunk) are masked to -1e30.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_lightning_tpu_torch.ops.attention import _NEG_INF
from ray_lightning_tpu_torch.ops.matmul import mm_f32

__all__ = ["fused_lm_head_cross_entropy", "naive_lm_head_cross_entropy"]


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
            compute_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx (N, d), dwte (V, d)), both f32."""
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
        dw.append(mm_f32(dl_c.T, xc))
    return dx, torch.cat(dw, dim=0)[:V]


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
        dx, dwte = _ce_bwd(x, wte, targets, lse, g, ctx.num_chunks,
                           ctx.compute_dtype)
        return dx.to(x.dtype), dwte.to(wte.dtype), None, None, None


def fused_lm_head_cross_entropy(
    x: torch.Tensor, wte: torch.Tensor, targets: torch.Tensor, *,
    num_chunks: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Per-token CE loss of the tied LM head without the ``(..., V)``
    logits: ``x (..., d)``, ``wte (V, d)``, int ``targets`` of
    ``x.shape[:-1]`` -> f32 losses of ``targets.shape``.  ``num_chunks``
    defaults to ~8192-wide vocab chunks."""
    if num_chunks is None:
        num_chunks = _pick_num_chunks(wte.shape[0])
    lead = targets.shape
    loss = _FusedCE.apply(x.reshape(-1, x.shape[-1]), wte,
                          targets.reshape(-1), int(num_chunks),
                          compute_dtype)
    return loss.reshape(lead)


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
