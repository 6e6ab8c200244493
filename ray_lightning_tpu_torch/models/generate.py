"""Autoregressive decoding for the GPT family: KV cache + sampling.

The static reference path (``ray_lightning_tpu/models/generate.py``) in
PyTorch: one contiguous ``(L, B, total, H, Dh)`` cache per call, one
full-sequence :func:`prefill` over the prompt, then one
:func:`decode_step` per new token.  The JAX ``lax.scan`` over layers is a
Python loop here, and the cache is written in place where JAX used
``dynamic_update_slice``.

Numerics follow the JAX package: each chunk's k/v is written before it is
attended, scores/softmax/PV run in f32 with hidden slots masked to
``_NEG_INF``, and the tied LM head takes compute-dtype operands to f32
logits.  The serving engine (``serve/engine.py``) is held
against :func:`generate`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, _mlp_residual, _moe_residual, has_lora_adapters,
)
from ray_lightning_tpu_torch.models.quant import (
    dequantize_decode_params, is_quantized, resolve_weight,
)
from ray_lightning_tpu_torch.ops.attention import _NEG_INF
from ray_lightning_tpu_torch.ops.matmul import mm_f32
from ray_lightning_tpu_torch.ops.layer_norm import layer_norm
from ray_lightning_tpu_torch.ops.lora import apply_lora

__all__ = ["init_kv_cache", "prefill", "decode_step", "generate"]


def init_kv_cache(cfg: GPTConfig, batch: int, total_len: int,
                  dtype: torch.dtype = torch.float32,
                  device=None) -> Dict[str, torch.Tensor]:
    """(L, B, total_len, H, Dh) zero-filled key/value buffers."""
    shape = (cfg.n_layer, batch, total_len, cfg.n_head, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _layer(tree: Dict[str, torch.Tensor], l: int) -> Dict[str, torch.Tensor]:
    """Layer ``l`` of a stacked tree (views, no copies)."""
    return {k: v[l] for k, v in tree.items()}


def _block_pass(
    cfg: GPTConfig,
    p: Dict[str, Any],
    x: torch.Tensor,
    k_l: torch.Tensor,
    v_l: torch.Tensor,
    off: int,
    c: torch.dtype,
    ad: Optional[Dict[str, torch.Tensor]] = None,
    ad_ids: Optional[torch.Tensor] = None,
    lora_impl: str = "kernel",
) -> torch.Tensor:
    """One GPT block over ``x (B, T, d)`` against one cache layer
    ``k_l``/``v_l (B, S, H, Dh)``.

    Writes this chunk's k/v into cache slots ``[off, off + T)`` in place,
    then attends each query ``t`` over cache slots ``<= off + t``; the
    zero-filled slots past the frontier are masked.  The same code serves
    the full prompt (``T = T0, off = 0``) and one decode token (``T = 1,
    off = pos``).  ``ad``/``ad_ids``: one layer's stacked adapter factors
    and a per-sequence int32 slot id (``ops/lora.py``)."""
    B, T = x.shape[0], x.shape[1]
    H, Dh, d = cfg.n_head, cfg.head_dim, cfg.d_model
    h = layer_norm(x, p["ln1_g"], p["ln1_b"])
    qkv = h @ resolve_weight(p, "qkv_w", c) + p["qkv_b"].to(c)
    qkv = apply_lora(qkv, h, ad, "qkv", ad_ids, lora_impl)
    q, k, v = qkv.split(d, dim=-1)
    # In place where JAX used dynamic_update_slice.
    k_l[:, off:off + T] = k.reshape(B, T, H, Dh).to(k_l.dtype)
    v_l[:, off:off + T] = v.reshape(B, T, H, Dh).to(v_l.dtype)
    S = k_l.shape[1]
    scores = torch.einsum(
        "bqhd,bshd->bhqs", q.reshape(B, T, H, Dh).float(), k_l.float()
    ) * Dh ** -0.5
    pos = torch.arange(S, device=x.device)
    visible = pos[None, :] <= (off + torch.arange(T, device=x.device))[:, None]
    scores = torch.where(visible[None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    att = torch.einsum(
        "bhqs,bshd->bqhd", probs, v_l.float()
    ).reshape(B, T, d).to(c)
    proj = att @ resolve_weight(p, "proj_w", c) + p["proj_b"].to(c)
    proj = apply_lora(proj, att, ad, "proj", ad_ids, lora_impl)
    if cfg.n_experts > 0:
        # The training trunk's routed MLP with one group (decode runs on
        # one device), as the JAX package decodes: the full forward
        # routes every prompt token together, decode the B current ones,
        # the same decisions wherever the capacity does not saturate.
        return _moe_residual(x + proj, p, cfg, groups=1)[0]
    return _mlp_residual(x + proj, p, c)


def _trunk_blocks(cfg, params, cache, x, off, c,
                  adapters=None, adapter_ids=None, lora_impl="kernel"):
    """:func:`_block_pass` over the stacked layers; returns the
    pre-``ln_f`` hidden for every position and the cache, updated in
    place.  Shared with the serving plane's bucketed prefill, which needs
    the hidden at the last valid prompt position of a padded bucket.
    ``adapters``: stacked per-layer LoRA factor buffers, leading axis L."""
    for l in range(cfg.n_layer):
        ad = None if adapters is None else _layer(adapters, l)
        x = _block_pass(cfg, _layer(params["blocks"], l), x,
                        cache["k"][l], cache["v"][l], off, c,
                        ad=ad, ad_ids=adapter_ids, lora_impl=lora_impl)
    return x, cache


def _wte(params, c: torch.dtype) -> torch.Tensor:
    """Token embedding table in the compute dtype (int8-storage aware:
    per-row scales broadcast over the feature axis)."""
    if "wte_q8" in params:
        return params["wte_q8"].to(c) * params["wte_sc"].to(c)[:, None]
    return params["wte"].to(c)


def _embed(params, tokens: torch.Tensor, c: torch.dtype) -> torch.Tensor:
    """Embedding lookup in the compute dtype (int8-storage aware): only
    the looked-up rows are converted and scaled."""
    if "wte_q8" in params:
        return (params["wte_q8"][tokens].to(c)
                * params["wte_sc"][tokens].to(c)[..., None])
    return params["wte"][tokens].to(c)


def _head_logits(params, h: torch.Tensor, c: torch.dtype) -> torch.Tensor:
    """``ln_f`` + tied LM head on hidden ``(..., d)`` → f32 logits
    ``(..., V)``: compute-dtype operands, an f32 product (the JAX einsum's
    ``preferred_element_type=f32``; bf16 logits are not rounded to bf16)."""
    h = layer_norm(h, params["ln_f_g"], params["ln_f_b"])
    d = h.shape[-1]
    logits = mm_f32(h.to(c).reshape(-1, d), _wte(params, c).T)
    return logits.reshape(*h.shape[:-1], -1)


def _reject_unmerged_lora(params: Dict[str, Any]) -> None:
    """Entry-point gate on the parameter tree.  The base-model decode
    math reads only ``qkv_w``/``proj_w``: a tree carrying LoRA adapters
    would silently generate from the frozen base (fold one tenant in with
    ``merge_lora``, or serve many through the engine's adapter pool)."""
    if has_lora_adapters(params):
        raise ValueError(
            "params contain LoRA adapters, which the base-model decode "
            "path does not apply — running them would silently generate "
            "from the frozen base weights. Either fold ONE tenant in "
            "(params = merge_lora(params, cfg)) or serve MANY tenants "
            "over the shared base through the adapter pool: "
            "adapter, base = extract_lora(params, cfg); "
            "ServeEngine(module, base, ServeConfig(max_adapters=N, "
            "adapter_rank=cfg.lora_rank), adapters={name: adapter})."
        )


def prefill(cfg: GPTConfig, params: Dict[str, Any],
            cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
            compute_dtype: torch.dtype = torch.float32,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence prompt pass: ``tokens (B, T0)`` → ``(last-position
    logits (B, V) f32, cache with slots [0, T0) filled)``."""
    _reject_unmerged_lora(params)
    c = compute_dtype
    T = tokens.shape[1]
    x = _embed(params, tokens, c) + params["wpe"][:T].to(c)
    x, cache = _trunk_blocks(cfg, params, cache, x, 0, c)
    return _head_logits(params, x[:, -1], c), cache


def decode_step(cfg: GPTConfig, params: Dict[str, Any],
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                pos: int, compute_dtype: torch.dtype = torch.float32,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token per sequence: ``tokens (B,)`` at position ``pos`` →
    ``(logits (B, V) f32, updated cache)``."""
    _reject_unmerged_lora(params)
    c = compute_dtype
    x = (_embed(params, tokens, c) + params["wpe"][pos].to(c))[:, None]
    x, cache = _trunk_blocks(cfg, params, cache, x, pos, c)
    return _head_logits(params, x[:, -1], c), cache


def _sample(logits: torch.Tensor, generator: torch.Generator,
            temperature: float, top_k: Optional[int],
            top_p: Optional[float]) -> torch.Tensor:
    """One sampling decision per row of ``logits (B, V)`` → ``(B,)``.
    Filtering masks to ``_NEG_INF`` as the JAX package does; the draw
    comes from ``generator`` (torch's bits, not JAX's)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]),
                         dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _NEG_INF, logits)
    if top_p is not None:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep tokens whose exclusive cumulative mass is < top_p: the
        # nucleus always holds the top token.
        keep = (cum - probs) < top_p
        num_keep = keep.sum(dim=-1, keepdim=True)
        thresh = torch.gather(sorted_desc, -1, num_keep - 1)
        logits = torch.where(logits < thresh, _NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(
    module: GPT,
    params: Dict[str, Any],
    prompt: Union[torch.Tensor, np.ndarray, Sequence[Sequence[int]]],
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    eos_token_id: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Greedy (``temperature=0``), temperature, top-k and/or top-p
    sampling, as the JAX package's ``generate``.

    Args:
        prompt: ``(B, T0)`` token ids, ``T0 >= 1``.
        top_k: keep only the k highest-probability tokens (``>= 1``).
        top_p: keep the smallest set of tokens whose probability mass
            reaches ``top_p`` (``0 < top_p <= 1``), after ``top_k``.
        generator: the draws' source; default a generator on ``device``
            seeded 0, so repeated calls return the same sample.
        eos_token_id: once a sequence samples it, every later position
            repeats it.
        device: where to run; ``None`` means ``"cuda"`` (raises without
            a card).  ``params`` must already be there.

    Returns:
        ``(B, T0 + max_new_tokens)`` int32 — the prompt followed by the
        generated continuation.
    """
    cfg = module.config
    dev = resolve_device(device)
    _reject_unmerged_lora(params)
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.from_numpy(np.asarray(prompt))
    prompt = prompt.to(device=dev, dtype=torch.long)
    B, t0 = prompt.shape
    if t0 < 1:
        raise ValueError("prompt must contain at least one token")
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if (top_k is not None or top_p is not None) and temperature <= 0.0:
        raise ValueError(
            "top_k/top_p require temperature > 0 (temperature=0 is "
            "greedy decoding, which would silently ignore them)"
        )
    if eos_token_id is not None and not 0 <= eos_token_id < cfg.vocab_size:
        raise ValueError(
            f"eos_token_id {eos_token_id} outside vocab "
            f"[0, {cfg.vocab_size}) — stopping would silently never "
            f"trigger"
        )
    total = t0 + max_new_tokens
    if total > cfg.seq_len:
        raise ValueError(
            f"prompt ({t0}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"the positional table ({cfg.seq_len})"
        )
    # An int8 tree is dequantized once per call, never per token: no
    # kernel of the port fuses the convert into the product, so per-token
    # dequantization would cost more than the bytes it saves (the JAX
    # package's rule off the TPU).  The int8 rounding stays baked in.
    if is_quantized(params):
        params = dequantize_decode_params(params)
    if params["wte"].device != dev:
        raise ValueError(
            f"params are on {params['wte'].device}, generate runs on {dev}"
        )
    if max_new_tokens == 0:
        return prompt.to(torch.int32)
    c = module._compute_dtype()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cache = init_kv_cache(cfg, B, total, dtype=c, device=dev)

    logits, cache = prefill(cfg, params, cache, prompt, compute_dtype=c)
    cur = _sample(logits, generator, temperature, top_k, top_p)
    done = (cur == eos_token_id) if eos_token_id is not None \
        else torch.zeros(B, dtype=torch.bool, device=dev)
    out = [cur]
    # Positions t0 .. total-2 emit tokens t0+1 .. total-1.
    for t in range(t0, total - 1):
        logits, cache = decode_step(cfg, params, cache, cur, t,
                                    compute_dtype=c)
        nxt = _sample(logits, generator, temperature, top_k, top_p)
        if eos_token_id is not None:
            # Finished rows keep emitting eos.
            nxt = torch.where(done, eos_token_id, nxt)
            done = done | (nxt == eos_token_id)
        out.append(nxt)
        cur = nxt
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1).to(torch.int32)
