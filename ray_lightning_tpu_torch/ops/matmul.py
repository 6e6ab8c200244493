"""Products with an f32 result from compute-dtype operands.

The JAX package takes its LM-head and cross-entropy products with
``preferred_element_type=f32``: bf16 operands, f32 accumulation and an f32
result that is never rounded to bf16.  :func:`mm_f32` is that product here,
shared by the training head (``ops/cross_entropy.py``, ``GPT.forward``) and
the serving head (``models/generate.py``).
"""

from __future__ import annotations

import torch

__all__ = ["mm_f32"]


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D operands of one dtype, with an f32 result: f32
    operands multiply as they are; bf16 operands give their exact f32
    products summed in f32 (``torch.mm``'s ``out_dtype`` on the card, the
    widened operands on the CPU)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()
