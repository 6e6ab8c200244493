"""Draft models for speculative decoding.

The engine takes any ``(draft_module, draft_params)`` pair that shares
the target's vocabulary.  As in ``ray_lightning_tpu/serve/draft.py``,
two helpers build a pair from one model:

* :func:`early_exit_draft` — the draft is the target's first ``n_layers``
  blocks with its embeddings, final LN and tied head: no training and no
  extra weights; its acceptance shows how much of the target's prediction
  the shallow prefix already carries;
* :func:`pad_identity_layers` — the target is the draft plus blocks whose
  residual-out projections are zero, so its logits equal the draft's
  while it pays the deeper forward: acceptance ~1.0 by construction, and
  ``noise`` in the zeroed projections scans the acceptance axis.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, Tuple

import torch

__all__ = ["early_exit_draft", "pad_identity_layers"]

# The tail blocks' residual-out leaves, zeroed by pad_identity_layers.
_RESIDUAL_OUT_KEYS = ("proj_w", "proj_b", "mlp_out_w", "mlp_out_b")


def _like(module, cfg):
    from ray_lightning_tpu_torch.models.gpt import GPT

    return GPT(cfg, attn_impl=module.attn_impl, precision=module.precision,
               device=module.device)


def early_exit_draft(module, params: Dict[str, Any],
                     n_layers: int) -> Tuple[Any, Dict[str, Any]]:
    """A draft of the target's first ``n_layers`` blocks plus its shared
    embeddings, final LN and tied head.  The draft's leaves are views of
    the target's (the stacked block leaves sliced, everything else the
    same tensors): nothing is copied."""
    cfg = module.config
    if not 1 <= n_layers < cfg.n_layer:
        raise ValueError(
            f"early-exit draft needs 1 <= n_layers < {cfg.n_layer}, "
            f"got {n_layers}"
        )
    if cfg.n_experts > 0:
        raise ValueError("early_exit_draft supports dense GPTs only")
    draft = _like(module, replace(cfg, n_layer=n_layers))
    draft_params = {
        **{k: v for k, v in params.items() if k != "blocks"},
        "blocks": {k: v[:n_layers] for k, v in params["blocks"].items()},
    }
    return draft, draft_params


def pad_identity_layers(module, params: Dict[str, Any], n_extra: int,
                        noise: float = 0.0,
                        seed: int = 0) -> Tuple[Any, Dict[str, Any]]:
    """A deeper target whose ``n_extra`` tail blocks are identities.

    Each tail block gets fresh attention and MLP weights (``init_params``
    from a generator seeded ``seed``; torch's draws, not JAX's) but zeroed
    residual-out projections, so ``x + att(...) @ 0 + 0 == x``: the tail
    runs a full-cost block and the target's logits equal the draft's
    bitwise.  ``noise > 0`` fills those projections with ``N(0, noise)``
    (generator seeded ``seed + 1``) instead: the target drifts from its
    prefix and the draft's acceptance falls."""
    cfg = module.config
    if n_extra < 1:
        raise ValueError(f"n_extra must be >= 1, got {n_extra}")
    if cfg.n_experts > 0:
        raise ValueError("pad_identity_layers supports dense GPTs only")
    target = _like(module, replace(cfg, n_layer=cfg.n_layer + n_extra))
    dev = params["wte"].device
    tail_module = _like(module, replace(cfg, n_layer=n_extra))
    tail = tail_module.init_params(
        torch.Generator(device=dev).manual_seed(seed))["blocks"]
    rng = torch.Generator(device=dev).manual_seed(seed + 1)
    blocks = {}
    for key, head_leaf in params["blocks"].items():
        tail_leaf = tail[key].to(device=dev, dtype=head_leaf.dtype)
        if key in _RESIDUAL_OUT_KEYS:
            if noise > 0.0:
                tail_leaf = (torch.randn(tail_leaf.shape, generator=rng,
                                         device=dev) * noise
                             ).to(head_leaf.dtype)
            else:
                tail_leaf = torch.zeros_like(tail_leaf)
        blocks[key] = torch.cat([head_leaf, tail_leaf], dim=0)
    target_params = {
        **{k: v for k, v in params.items() if k != "blocks"},
        "blocks": blocks,
    }
    return target, target_params
