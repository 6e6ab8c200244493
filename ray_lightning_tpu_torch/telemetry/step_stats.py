"""Model FLOP accounting for MFU: a copy of ``model_flops_per_token`` of
``ray_lightning_tpu/telemetry/step_stats.py``."""

from __future__ import annotations

from typing import Any

__all__ = ["model_flops_per_token"]


def model_flops_per_token(cfg: Any, attn: str = "full") -> float:
    """Fwd+bwd matmul FLOPs per token for the GPT family (backward = 2x
    forward, no remat-recompute credit).

    ``attn="full"`` charges the full S² attention matrix (the standard
    published-MFU convention); ``attn="causal"`` charges the causal half
    the kernels actually execute.
    """
    d, L, s, V = cfg.d_model, cfg.n_layer, cfg.seq_len, cfg.vocab_size
    mm = 24 * L * d * d          # qkv + proj + mlp weight matmuls
    attn_term = 4 * L * s * d    # QK^T and AV, full square
    if attn == "causal":
        attn_term /= 2
    head = 2 * d * V             # tied LM head
    return 3.0 * (mm + attn_term + head)
