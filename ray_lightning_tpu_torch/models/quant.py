"""Weight-only int8 storage for the decode path.

The JAX package's ``models/quant.py`` in PyTorch.  A quantized weight
``w`` is stored as ``w_q8`` (int8) and ``w_sc`` (f32 scales, one per
output channel), and :func:`resolve_weight` turns it back into the
compute dtype where a product consumes it.  Block matmul weights take one
scale per output channel over the contraction axis (-2); ``wte`` takes
one per vocab row, right for both the embedding lookup and the tied LM
head, which reduce over ``d_model``.  Biases, LayerNorm parameters and
the positional table stay as they are.

The JAX package streams int8 from HBM only on a TPU, where the convert
fuses into the product's operand read; on any other backend it
dequantizes once per ``generate()`` call and at engine build
(:func:`dequantize_decode_params`), never per token.  The port follows
that rule on the card: no kernel here fuses the convert, so the int8
rounding stays baked into the weights and the products run in the
compute dtype.  Trees with LoRA adapters, an already quantized tree and
a fit warm-started from an int8 tree are refused, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

__all__ = [
    "quantize_decode_params",
    "dequantize_decode_params",
    "resolve_weight",
    "is_quantized",
]

# The block matmul operands (biases, LN parameters and wpe stay float);
# MoE trees add their expert weights.
_QUANT_BLOCK_KEYS = ("qkv_w", "proj_w", "mlp_in_w", "mlp_out_w",
                     "moe_in_w", "moe_out_w")


def _quantize(w: torch.Tensor, contract_axis: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over ``contract_axis``: one f32 scale per output
    channel, ``round(w / scale)`` (half to even) clipped to ±127."""
    w = w.float()
    amax = w.abs().amax(dim=contract_axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(contract_axis)


def is_quantized(params: Dict[str, Any]) -> bool:
    """True when the tree carries int8 weight storage (``*_q8``)."""
    return "wte_q8" in params or any(
        str(k).endswith("_q8") for k in params.get("blocks", {})
    )


def resolve_weight(tree: Dict[str, Any], name: str,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """``tree[name]`` in ``compute_dtype``, dequantized from ``<name>_q8``
    and ``<name>_sc`` when the tree carries int8 storage.  A float leaf
    already in ``compute_dtype`` comes back as it is (no copy)."""
    q = tree.get(name + "_q8")
    if q is None:
        return tree[name].to(compute_dtype)
    sc = tree[name + "_sc"].to(compute_dtype)
    # Scales are per output channel: re-insert the contraction axis so
    # they broadcast against (..., d_in, d_out) storage of any rank.
    return q.to(compute_dtype) * sc[..., None, :]


def quantize_decode_params(params: Dict[str, Any], cfg=None
                           ) -> Dict[str, Any]:
    """An int8-storage copy of a GPT parameter tree for generation.

    Which weights quantize is keyed on the tree's contents, never on
    ``cfg`` (kept for the JAX signature).  LoRA trees must be merged
    first; an already quantized tree is refused."""
    from ray_lightning_tpu_torch.models.gpt import has_lora_adapters

    if has_lora_adapters(params):
        raise ValueError(
            "params contain LoRA adapters; merge_lora(params, cfg) "
            "before quantizing for decode"
        )
    if is_quantized(params):
        raise ValueError("params are already int8-quantized")
    blocks = dict(params["blocks"])
    for key in _QUANT_BLOCK_KEYS:
        if key not in blocks:
            continue
        q, sc = _quantize(blocks.pop(key), contract_axis=-2)
        blocks[key + "_q8"] = q
        blocks[key + "_sc"] = sc
    out = {**params, "blocks": blocks}
    q, sc = _quantize(out.pop("wte"), contract_axis=-1)
    out["wte_q8"] = q
    out["wte_sc"] = sc
    return out


def dequantize_decode_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fold int8 storage back into dense f32 weights: exactly the
    :func:`resolve_weight` arithmetic, applied once.  The rounding baked
    into the int8 storage stays; a float tree comes back as it is."""
    if not is_quantized(params):
        return params
    blocks = dict(params["blocks"])
    for key in [k for k in blocks if str(k).endswith("_q8")]:
        base = key[: -len("_q8")]
        q = blocks.pop(key)
        sc = blocks.pop(base + "_sc")
        blocks[base] = q.float() * sc.float()[..., None, :]
    out = {k: v for k, v in params.items()
           if k not in ("blocks", "wte_q8", "wte_sc")}
    out["blocks"] = blocks
    if "wte_q8" in params:
        out["wte"] = (params["wte_q8"].float()
                      * params["wte_sc"].float()[:, None])
    return out
