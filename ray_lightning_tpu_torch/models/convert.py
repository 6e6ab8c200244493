"""Convert the JAX package's parameter trees to the port's tensors.

The input is the JAX pytree with numpy leaves (``jax.tree.map(np.asarray,
tree)``, or a checkpoint read back as numpy); nothing of JAX is imported
here.  Keys, nesting, shapes and dtypes are kept, so the stacked
``blocks`` layout with its leading ``n_layer`` axis carries over as is.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_lightning_tpu_torch.device import resolve_device

__all__ = ["params_from_jax", "adapter_from_jax"]

_FACTOR_KEYS = ("qkv_a", "qkv_b", "proj_a", "proj_b")


def _tensor(x, device: torch.device) -> torch.Tensor:
    # np.array copies: torch.from_numpy needs a writable, owned buffer.
    return torch.from_numpy(np.array(x)).to(device)


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A GPT parameter tree with numpy leaves → the same tree of torch
    tensors on ``device`` (``None`` means ``"cuda"``)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, dev)

    return conv(tree)


def adapter_from_jax(adapter: Dict[str, Any], device=None) -> Dict[str, Any]:
    """One LoRA adapter (``extract_lora``/``synthetic_lora_adapter``
    output: four stacked factors plus ``scale``) → torch factors on
    ``device`` and a float ``scale``."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {k: _tensor(adapter[k], dev) for k in _FACTOR_KEYS}
    out["scale"] = float(adapter.get("scale", 1.0))
    return out
