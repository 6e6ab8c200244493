"""GPT — the decoder-only LM family, in PyTorch.

Parameters are a plain dict in the JAX package's layout
(``ray_lightning_tpu/models/gpt.py::GPT.init_params``): ``wte``, ``wpe``,
``ln_f_g``, ``ln_f_b`` and a ``blocks`` dict whose tensors carry a leading
``n_layer`` axis; matrices are stored ``(in, out)`` and applied as
``h @ W``.  So a tree converted leaf for leaf from JAX
(``models/convert.py``) runs here unchanged, and the tests compare like
with like.  Activations run in the compute dtype (``precision``);
parameters, LayerNorm statistics and attention softmax stay f32.

LoRA: the adapter helpers (``add_lora_adapters``, ``extract_lora``,
``merge_lora``, ``synthetic_lora_adapter``) keep the JAX package's
``lora_*`` key names and its ``lora_alpha / lora_rank`` scale.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.ops.layer_norm import layer_norm

__all__ = ["GPTConfig", "GPT", "resolve_weight", "has_int8_weights",
           "has_lora_adapters", "add_lora_adapters", "extract_lora",
           "merge_lora", "synthetic_lora_adapter"]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The dense subset of the JAX package's ``GPTConfig`` that inference
    reads (training-only fields port with the training slice)."""

    vocab_size: int = 50304  # GPT-2 vocab padded to a multiple of 128
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    seq_len: int = 1024
    mlp_ratio: int = 4
    # LoRA (0 = off): rank of the adapters on the attention projections
    # (qkv and proj); the adapter delta is scaled by lora_alpha / rank.
    lora_rank: int = 0
    lora_alpha: float = 16.0

    @classmethod
    def tiny(cls) -> "GPTConfig":
        """Test-sized config."""
        return cls(vocab_size=512, n_layer=2, n_head=4, d_model=128,
                   seq_len=128)

    @classmethod
    def gpt2_small(cls) -> "GPTConfig":
        return cls()  # 124M params

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head


def resolve_weight(tree: Dict[str, Any], name: str,
                   compute_dtype: torch.dtype) -> torch.Tensor:
    """``tree[name]`` in ``compute_dtype``.  Float trees only: an int8
    tree (``<name>_q8`` storage) raises — int8 decode is not ported yet."""
    if name + "_q8" in tree:
        raise NotImplementedError(
            f"int8 weight storage ({name}_q8) is not supported by the "
            f"PyTorch port yet; pass a float parameter tree"
        )
    return tree[name].to(compute_dtype)


def _mlp_residual(x: torch.Tensor, p: Dict[str, Any],
                  c: torch.dtype) -> torch.Tensor:
    """LN2 + GELU MLP + residual — the dense second half of a GPT block,
    over any leading dims.  GELU is the tanh form, as ``jax.nn.gelu``'s
    default."""
    h = layer_norm(x, p["ln2_g"], p["ln2_b"])
    h = F.gelu(
        h @ resolve_weight(p, "mlp_in_w", c) + p["mlp_in_b"].to(c),
        approximate="tanh",
    )
    return (x + h @ resolve_weight(p, "mlp_out_w", c)
            + p["mlp_out_b"].to(c))


def _normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=generator.device) * std


class GPT(nn.Module):
    """Decoder-only LM: a config, a precision and a device.

    The parameters are a dict (see the module docstring), made by
    :meth:`init_params` or converted from the JAX package, and passed to
    the functions of ``models/generate.py`` and ``serve/``.

    Args:
        precision: ``"f32"`` (default) or ``"bf16"`` — the activations'
            compute dtype.
        device: where :meth:`init_params` puts the parameters; ``None``
            means ``"cuda"`` and raises without a card.
    """

    def __init__(self, config: Optional[GPTConfig] = None,
                 precision: str = "f32", device=None):
        super().__init__()
        if precision not in ("f32", "bf16", "bfloat16"):
            raise ValueError(
                f"precision {precision!r} not in ('f32', 'bf16')"
            )
        self.config = config or GPTConfig.tiny()
        self.precision = precision
        self.device = resolve_device(device)

    def _compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.precision in ("bf16", "bfloat16") \
            else torch.float32

    def init_params(
        self, generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """Random GPT-2 initialisation (normal std 0.02; residual
        projections 0.02/sqrt(2L); ``wpe`` 0.01; LN gains 1, biases 0),
        in f32 on ``self.device``.  The draws come from ``generator``
        (default: a CPU generator seeded 0); they differ from the JAX
        package's, whose keys torch cannot reproduce."""
        cfg = self.config
        g = generator or torch.Generator().manual_seed(0)
        d, h, L = cfg.d_model, cfg.mlp_ratio * cfg.d_model, cfg.n_layer
        resid_std = 0.02 / math.sqrt(2 * L)
        blocks = {
            "ln1_g": torch.ones(L, d),
            "ln1_b": torch.zeros(L, d),
            "qkv_w": _normal((L, d, 3 * d), 0.02, g),
            "qkv_b": torch.zeros(L, 3 * d),
            "proj_w": _normal((L, d, d), resid_std, g),
            "proj_b": torch.zeros(L, d),
            "ln2_g": torch.ones(L, d),
            "ln2_b": torch.zeros(L, d),
            "mlp_in_w": _normal((L, d, h), 0.02, g),
            "mlp_in_b": torch.zeros(L, h),
            "mlp_out_w": _normal((L, h, d), resid_std, g),
            "mlp_out_b": torch.zeros(L, d),
        }
        if cfg.lora_rank > 0:
            blocks.update(_init_lora_blocks(cfg, g))
        params = {
            "wte": _normal((cfg.vocab_size, d), 0.02, g),
            "wpe": _normal((cfg.seq_len, d), 0.01, g),
            "blocks": blocks,
            "ln_f_g": torch.ones(d),
            "ln_f_b": torch.zeros(d),
        }
        return _tree_to(params, self.device)


def _tree_to(tree: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {
        k: _tree_to(v, device) if isinstance(v, dict)
        else v.to(device=device, dtype=torch.float32)
        for k, v in tree.items()
    }


def has_int8_weights(params: Dict[str, Any]) -> bool:
    """True when the tree carries int8 weight storage (``*_q8``)."""
    return "wte_q8" in params or any(
        str(k).endswith("_q8") for k in params.get("blocks", {})
    )


def has_lora_adapters(params: Dict[str, Any]) -> bool:
    """True when the tree carries unmerged LoRA adapters."""
    return any(str(k).startswith("lora_") for k in params.get("blocks", {}))


def _init_lora_blocks(cfg: GPTConfig,
                      generator: torch.Generator) -> Dict[str, Any]:
    """The four stacked adapter tensors; B starts at zero, so the
    adapter delta starts at exactly 0."""
    L, d, r = cfg.n_layer, cfg.d_model, cfg.lora_rank
    dev = generator.device
    return {
        "lora_qkv_a": _normal((L, d, r), 0.02, generator),
        "lora_qkv_b": torch.zeros(L, r, 3 * d, device=dev),
        "lora_proj_a": _normal((L, d, r), 0.02, generator),
        "lora_proj_b": torch.zeros(L, r, d, device=dev),
    }


def add_lora_adapters(params: Dict[str, Any], cfg: GPTConfig,
                      generator: torch.Generator) -> Dict[str, Any]:
    """Attach fresh LoRA adapters (zero-delta) to a lora-free tree."""
    if cfg.lora_rank <= 0:
        return params
    if has_lora_adapters(params):
        raise ValueError(
            "params already contain LoRA adapters; refusing to "
            "overwrite them. merge_lora() first, or reuse the existing "
            "adapters."
        )
    device = params["wte"].device
    lora = _tree_to(_init_lora_blocks(cfg, generator), device)
    return {**params, "blocks": {**params["blocks"], **lora}}


def extract_lora(params: Dict[str, Any], cfg: GPTConfig
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(adapter, base_params)``: the four stacked LoRA factors (plus
    ``scale``) for the serving adapter pool, and the tree without them."""
    if cfg.lora_rank <= 0:
        raise ValueError("extract_lora needs a lora_rank > 0 config")
    if not has_lora_adapters(params):
        raise ValueError("params carry no LoRA adapters — nothing to extract")
    blocks = dict(params["blocks"])
    adapter = {
        "qkv_a": blocks.pop("lora_qkv_a"),
        "qkv_b": blocks.pop("lora_qkv_b"),
        "proj_a": blocks.pop("lora_proj_a"),
        "proj_b": blocks.pop("lora_proj_b"),
        "scale": cfg.lora_alpha / cfg.lora_rank,
    }
    return adapter, {**params, "blocks": blocks}


def merge_lora(params: Dict[str, Any], cfg: GPTConfig) -> Dict[str, Any]:
    """Fold LoRA adapters into ``qkv_w``/``proj_w`` and strip them: a
    lora-free tree with the same forward math."""
    if cfg.lora_rank <= 0:
        return params
    s = cfg.lora_alpha / cfg.lora_rank
    blocks = dict(params["blocks"])
    for site in ("qkv", "proj"):
        a = blocks.pop(f"lora_{site}_a")
        b = blocks.pop(f"lora_{site}_b")
        blocks[f"{site}_w"] = blocks[f"{site}_w"] + torch.einsum(
            "ldr,lrk->ldk", a, b
        ) * s
    return {**params, "blocks": blocks}


def synthetic_lora_adapter(
    params: Dict[str, Any], cfg: GPTConfig, generator: torch.Generator,
    scale: float = 0.3,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(adapter, merged_params)``: one synthetic LoRA tenant of a
    lora-free base with random non-zero A and B factors (so the tenant's
    greedy stream differs from the base), and its merged tree as the
    parity reference.  ``cfg.lora_rank`` is the adapter's rank."""
    tree = add_lora_adapters(params, cfg, generator)
    blocks = dict(tree["blocks"])
    device = blocks["lora_qkv_b"].device
    for key in ("lora_qkv_b", "lora_proj_b"):
        blocks[key] = _normal(
            tuple(blocks[key].shape), scale, generator
        ).to(device)
    tree = {**tree, "blocks": blocks}
    adapter, _ = extract_lora(tree, cfg)
    return adapter, merge_lora(tree, cfg)
