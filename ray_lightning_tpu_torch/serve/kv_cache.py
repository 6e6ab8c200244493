"""Paged KV cache: one block pool shared by every sequence.

The serving cache is a pool of fixed-size token blocks (the
vLLM/PagedAttention layout, as in ``ray_lightning_tpu/serve/kv_cache.py``):

* **pool** — ``k``/``v`` each ``(L, num_blocks, block_size, H, Dh)``, one
  allocation for the whole server;
* **block tables** — per-slot rows mapping a sequence's logical block
  index to a physical pool block, kept host-side by the scheduler and
  handed to each step as an int32 tensor;
* **allocator** — a host-side free list; finished or preempted requests
  free their blocks at once.

Physical block 0 is the **trash block**: inactive slots point their
writes at it, so the fixed-width decode step needs no active-slot branch.

Device functions: :func:`paged_prefill` (one bucket-padded prompt through
the static path's layer loop, k/v then scattered into whole pool blocks),
:func:`paged_decode_step` (one token for every slot) and
:func:`sample_tokens`.  They update the pool in place (``index_put_``)
where JAX returned a new pool from ``.at[].set``.  Numerics match the
static path: a sequence's blocks are gathered back into logical order,
the mask hides exactly the slots the static causal mask hides, and
scores/softmax/PV stay f32.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models.generate import (
    _embed, _head_logits, _layer, _trunk_blocks,
)
from ray_lightning_tpu_torch.models.gpt import (
    GPTConfig, _mlp_residual, resolve_weight,
)
from ray_lightning_tpu_torch.ops.attention import _NEG_INF
from ray_lightning_tpu_torch.ops.layer_norm import layer_norm
from ray_lightning_tpu_torch.ops.lora import apply_lora

__all__ = [
    "TRASH_BLOCK",
    "BlockAllocator",
    "PagedKVCache",
    "paged_prefill",
    "paged_decode_step",
    "sample_tokens",
]

# Physical block 0 is never allocated: it is the write target of inactive
# slots and the padding entry of short block tables.
TRASH_BLOCK = 0


class BlockAllocator:
    """Host-side LIFO free list over the physical block pool.

    A double free or the free of a foreign id raises: a scheduler bug
    that re-issued a live block would corrupt another request's cache."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block {TRASH_BLOCK} is "
                f"reserved), got {num_blocks}"
            )
        self.num_blocks = num_blocks
        # Recently freed blocks are re-issued first.
        self._free: List[int] = list(range(num_blocks - 1, TRASH_BLOCK, -1))
        self._live: set = set()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return len(self._live)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` physical block ids, or ``None`` (all or nothing) when
        the pool cannot cover them."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._live.update(ids)
        return ids

    def free(self, ids) -> None:
        for b in ids:
            if b not in self._live:
                raise RuntimeError(
                    f"free of block {b} which is not live (double-free "
                    f"or foreign id) — scheduler bookkeeping bug"
                )
            self._live.remove(b)
            self._free.append(b)


class PagedKVCache:
    """The pool's geometry and its allocator; :meth:`init_pool` makes the
    device pool, which the engine owns."""

    def __init__(self, cfg: GPTConfig, num_blocks: int, block_size: int,
                 dtype: torch.dtype = torch.float32, device=None):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.cfg = cfg
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.dtype = dtype
        self.device = resolve_device(device)
        self.allocator = BlockAllocator(num_blocks)

    def init_pool(self) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        shape = (cfg.n_layer, self.num_blocks, self.block_size,
                 cfg.n_head, cfg.head_dim)
        return {key: torch.zeros(shape, dtype=self.dtype, device=self.device)
                for key in ("k", "v")}


def paged_prefill(
    cfg: GPTConfig,
    params: Dict[str, Any],
    pool: Dict[str, torch.Tensor],
    tokens: torch.Tensor,
    prompt_len: int,
    block_ids: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    adapter_id: Optional[torch.Tensor] = None,
    lora_impl: str = "kernel",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One prompt through the full-sequence causal pass, its k/v written
    into the sequence's pool blocks.

    Args:
        tokens: ``(T,)`` the prompt right-padded to a bucket length ``T``
            that is a multiple of the pool's block size.
        prompt_len: the number of valid leading tokens.
        block_ids: ``(T // block_size,)`` physical blocks that will hold
            cache positions ``[0, T)``.
        adapters/adapter_id: the adapter pool's stacked per-layer factor
            buffers and this prompt's int32 slot id, shape ``(1,)``
            (slot 0 is the zero-delta base model).

    Returns ``(next-token logits (V,) f32 at position prompt_len - 1,
    pool)``.  Padding positions write garbage into the tail of the
    sequence's own blocks; decode masks it and overwrites it slot by slot.
    """
    c = compute_dtype
    T = tokens.shape[0]
    Bs = pool["k"].shape[2]
    if T % Bs != 0:
        raise ValueError(
            f"prefill bucket length {T} is not a multiple of the "
            f"block size {Bs}"
        )
    x = _embed(params, tokens[None], c) + params["wpe"][:T].to(c)
    # A contiguous temporary cache runs the static path's layer loop
    # verbatim (one source for the block math); its per-layer k/v are
    # then cut into whole blocks and scattered into the pool.
    H, Dh = cfg.n_head, cfg.head_dim
    tmp = {key: torch.zeros((cfg.n_layer, 1, T, H, Dh),
                            dtype=pool[key].dtype, device=pool[key].device)
           for key in ("k", "v")}
    hidden, tmp = _trunk_blocks(cfg, params, tmp, x, 0, c,
                                adapters=adapters, adapter_ids=adapter_id,
                                lora_impl=lora_impl)
    logits = _head_logits(params, hidden[0, prompt_len - 1], c)
    n = T // Bs
    for key in ("k", "v"):
        # In place where JAX used pool.at[:, block_ids].set(...).
        pool[key][:, block_ids] = tmp[key][:, 0].reshape(
            cfg.n_layer, n, Bs, H, Dh
        )
    return logits, pool


def paged_decode_step(
    cfg: GPTConfig,
    params: Dict[str, Any],
    pool: Dict[str, torch.Tensor],
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    tokens: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    adapter_ids: Optional[torch.Tensor] = None,
    lora_impl: str = "kernel",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token for every slot of the fixed-width slot set.

    Args:
        block_tables: ``(W, M)`` int — each slot's physical blocks in
            logical order; unused entries and inactive rows point at the
            trash block.
        seq_lens: ``(W,)`` int — tokens already in the cache per slot; the
            current token is written at this position.
        tokens: ``(W,)`` int — the token each slot feeds this step.
        adapters/adapter_ids: the adapter pool's stacked per-layer
            factor buffers and each slot's int32 pool slot (0 = zero
            delta).

    Returns ``(logits (W, V) f32, pool)``.  The write position, the
    gather and the visibility mask are all data, so any mix of sequence
    lengths runs through the same step.
    """
    c = compute_dtype
    Bs = pool["k"].shape[2]
    W, M = block_tables.shape
    S = M * Bs
    H, Dh, d = cfg.n_head, cfg.head_dim, cfg.d_model
    tables = block_tables.long()
    pos = seq_lens.long()
    # Clamp the positional lookup: active slots are bounded below
    # seq_len by the scheduler; the clamp only keeps garbage in range.
    safe_pos = torch.clamp(pos, max=params["wpe"].shape[0] - 1)
    x = _embed(params, tokens.long(), c) + params["wpe"][safe_pos].to(c)
    write_blk = torch.gather(tables, 1, (pos // Bs)[:, None])[:, 0]
    write_off = pos % Bs
    # Visible: cache positions [0, pos] — the current token's k/v are
    # written before the gather, the static path's causal frontier.
    visible = torch.arange(S, device=pos.device)[None, :] <= pos[:, None]
    scale = Dh ** -0.5

    for l in range(cfg.n_layer):
        p = _layer(params["blocks"], l)
        ad = None if adapters is None else _layer(adapters, l)
        k_pool, v_pool = pool["k"][l], pool["v"][l]  # (N, Bs, H, Dh) views
        h = layer_norm(x, p["ln1_g"], p["ln1_b"])
        qkv = h @ resolve_weight(p, "qkv_w", c) + p["qkv_b"].to(c)
        qkv = apply_lora(qkv, h, ad, "qkv", adapter_ids, lora_impl)
        q, k, v = qkv.split(d, dim=-1)
        # In place where JAX used k_pool.at[write_blk, write_off].set(...).
        k_pool[write_blk, write_off] = k.reshape(W, H, Dh).to(k_pool.dtype)
        v_pool[write_blk, write_off] = v.reshape(W, H, Dh).to(v_pool.dtype)
        ctx_k = k_pool[tables].reshape(W, S, H, Dh)
        ctx_v = v_pool[tables].reshape(W, S, H, Dh)
        scores = torch.einsum(
            "whd,wshd->whs", q.reshape(W, H, Dh).float(), ctx_k.float()
        ) * scale
        scores = torch.where(visible[:, None, :], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        att = torch.einsum(
            "whs,wshd->whd", probs, ctx_v.float()
        ).reshape(W, d).to(c)
        proj = att @ resolve_weight(p, "proj_w", c) + p["proj_b"].to(c)
        proj = apply_lora(proj, att, ad, "proj", adapter_ids, lora_impl)
        x = _mlp_residual(x + proj, p, c)
    return _head_logits(params, x, c), pool


def _row_seed(base_seed: int, seed: int, position: int) -> int:
    """The sampling stream of one (request, position): a fixed hash of
    (engine seed, request seed, position), so a request's draws depend on
    its own history only — never on its batch neighbours or its slot."""
    digest = hashlib.blake2b(
        struct.pack("<qqq", base_seed, seed, position), digest_size=8
    ).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def sample_tokens(
    logits: torch.Tensor,
    temperatures: List[float],
    top_ks: List[int],
    seeds: List[int],
    positions: List[int],
    base_seed: int = 0,
) -> torch.Tensor:
    """Per-row sampling of ``logits (W, V)`` → ``(W,)`` int64: greedy
    where ``temperatures[w] <= 0``, else a categorical draw at
    ``logits / temperature``, truncated to the ``top_ks[w]`` best tokens
    when that is > 0.

    JAX keys these draws with threefry ``fold_in(fold_in(base, seed),
    position)``, whose bits PyTorch cannot reproduce; the port keeps the
    discipline instead: each row draws from its own generator seeded from
    (``base_seed``, ``seeds[w]``, ``positions[w]``), so a re-decoded or
    re-batched request replays the same stream.  Greedy rows draw
    nothing."""
    out = torch.argmax(logits, dim=-1)
    for w, temp in enumerate(temperatures):
        if temp <= 0.0:
            continue
        row = logits[w] / temp
        k = top_ks[w]
        if k > 0:
            kth = torch.topk(row, min(k, row.shape[-1])).values[-1]
            row = torch.where(row < kth, _NEG_INF, row)
        gen = torch.Generator(device=logits.device).manual_seed(
            _row_seed(base_seed, seeds[w], positions[w])
        )
        out[w] = torch.multinomial(torch.softmax(row, dim=-1), 1,
                                   generator=gen)[0]
    return out
