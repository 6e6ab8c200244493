"""LayerNorm with f32 statistics.

The math of the JAX package's reference path ``_xla_layer_norm``: f32
mean and biased variance, eps 1e-5, ``rsqrt``, ``y * g + b`` in f32, the
result cast back to the input's dtype.  The Pallas LayerNorm kernels serve
training and are not on the serving path; they port with the training
slice.
"""

from __future__ import annotations

import torch

__all__ = ["layer_norm"]

_EPS = 1e-5


def layer_norm(x: torch.Tensor, g: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """LayerNorm of ``x (..., d)`` with gain ``g (d,)`` and bias ``b (d,)``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mu
    var = (centered * centered).mean(dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + _EPS)
    return (y * g.float() + b.float()).to(x.dtype)
