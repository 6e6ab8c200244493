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
:func:`paged_verify_step` (a window of tokens for every slot: the
speculative verify and the prefill chunk), :func:`paged_decode_step` (its
one-token window), :func:`copy_blocks` and
:func:`sample_tokens`.  They update the pool in place (``index_put_``)
where JAX returned a new pool from ``.at[].set``.  Numerics match the
static path: a sequence's blocks are gathered back into logical order,
the mask hides exactly the slots the static causal mask hides, and
scores/softmax/PV stay f32.  The weights come in the compute dtype
(:func:`prepare_params`, once at engine build): the device functions cast
no weight.

Host side: the refcounted :class:`BlockAllocator`, the multi-token
coverage and rollback of a speculative tick (:func:`extend_block_coverage`,
:func:`truncate_to`), and the prefix cache's radix tree of resident block
chains (:class:`PrefixIndex`).
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
from ray_lightning_tpu_torch.models.gpt import GPTConfig, _mlp_residual
from ray_lightning_tpu_torch.models.quant import (
    dequantize_decode_params, is_quantized,
)
from ray_lightning_tpu_torch.ops.attention import _NEG_INF
from ray_lightning_tpu_torch.ops.layer_norm import layer_norm
from ray_lightning_tpu_torch.ops.lora import apply_lora

__all__ = [
    "TRASH_BLOCK",
    "BlockAllocator",
    "PagedKVCache",
    "PrefixIndex",
    "prepare_params",
    "paged_prefill",
    "paged_decode_step",
    "paged_verify_step",
    "sample_tokens",
    "extend_block_coverage",
    "truncate_to",
    "copy_blocks",
]

# Physical block 0 is never allocated: it is the write target of inactive
# slots and the padding entry of short block tables.
TRASH_BLOCK = 0


class BlockAllocator:
    """Host-side LIFO free list over the physical block pool, with a
    reference count per live block.

    A fresh block has one holder.  :meth:`retain` hands the same block to
    another holder (a request's block table or the :class:`PrefixIndex`),
    and :meth:`free` drops one reference: the block returns to the free
    list with its last holder.  A double free or the free of a foreign id
    raises: a scheduler bug that re-issued a live block would corrupt
    another request's cache."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block {TRASH_BLOCK} is "
                f"reserved), got {num_blocks}"
            )
        self.num_blocks = num_blocks
        # Recently freed blocks are re-issued first.
        self._free: List[int] = list(range(num_blocks - 1, TRASH_BLOCK, -1))
        self._refs: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return len(self._refs)

    def refcount(self, b: int) -> int:
        """Holders of block ``b`` (0 = not live)."""
        return self._refs.get(b, 0)

    def is_shared(self, b: int) -> bool:
        """True when more than one holder references ``b``: the block is
        read-only to each of them until copy-on-write or release."""
        return self._refs.get(b, 0) > 1

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` physical block ids, or ``None`` (all or nothing) when
        the pool cannot cover them."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._refs[b] = 1
        return ids

    def retain(self, ids) -> None:
        """One more reference on each of the live blocks ``ids`` (the
        claim of a shared prefix: no device work)."""
        for b in ids:
            if b not in self._refs:
                raise RuntimeError(
                    f"retain of block {b} which is not live — a chain "
                    f"cannot share blocks nobody owns"
                )
        for b in ids:
            self._refs[b] += 1

    def free(self, ids) -> None:
        """Drop one reference on each of ``ids``."""
        for b in ids:
            if b not in self._refs:
                raise RuntimeError(
                    f"free of block {b} which is not live (double-free "
                    f"or foreign id) — scheduler bookkeeping bug"
                )
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)


def extend_block_coverage(allocator: BlockAllocator, blocks: List[int],
                          table_row, upto_pos: int, block_size: int) -> bool:
    """Grow ``blocks`` and ``table_row`` until cache position ``upto_pos``
    is writable, all or nothing (False = pool dry): a verify window writes
    several positions in one step, so its coverage is claimed before the
    step and :func:`truncate_to` returns the rejected tail's blocks."""
    need = (upto_pos // block_size) + 1 - len(blocks)
    if need <= 0:
        return True
    ids = allocator.alloc(need)
    if ids is None:
        return False
    start = len(blocks)
    blocks.extend(ids)
    table_row[start: start + len(ids)] = ids
    return True


def truncate_to(allocator: BlockAllocator, blocks: List[int], table_row,
                n_tokens: int, block_size: int) -> int:
    """Shrink a sequence's coverage to exactly ``n_tokens`` cache slots:
    the blocks past the covering prefix go back to the pool and their
    table entries to the trash block.  Returns the blocks freed."""
    keep = -(-n_tokens // block_size) if n_tokens > 0 else 0
    freed = blocks[keep:]
    if not freed:
        return 0
    del blocks[keep:]
    allocator.free(freed)
    table_row[keep: keep + len(freed)] = TRASH_BLOCK
    return len(freed)


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


def copy_blocks(pool: Dict[str, torch.Tensor], src_ids: torch.Tensor,
                dst_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Copy the k/v of blocks ``src_ids`` into ``dst_ids`` in every layer:
    the copy-on-write of a shared block a holder must write into (its
    other holders keep the original)."""
    for key in ("k", "v"):
        pool[key][:, dst_ids] = pool[key][:, src_ids]
    return pool


class _ChainNode:
    """One radix-tree edge: a run of whole blocks with no branch."""

    __slots__ = ("keys", "ids", "children", "parent", "stamp")

    def __init__(self, keys, ids, parent, stamp):
        self.keys: List[Tuple[int, ...]] = keys   # per-block token tuples
        self.ids: List[int] = ids                 # physical block ids
        self.children: Dict[Tuple[int, ...], "_ChainNode"] = {}
        self.parent: Optional["_ChainNode"] = parent
        self.stamp = stamp


class PrefixIndex:
    """Radix tree of resident KV block chains, keyed by prompt tokens.

    After a prompt is prefilled, its full blocks are inserted as a chain
    and the index retains a reference on each, so the chain outlives its
    request.  A later request claims its longest whole-block shared
    prefix with :meth:`claim` (refcount bumps, no device work) and
    prefills only the rest.  Chains are keyed per ``key`` (the adapter
    name, ``None`` for the base model): adapter-bearing prefill writes
    adapter-specific KV, so one tenant's chain never serves another's
    lookup.  :meth:`evict` releases least-recently-used leaf edges
    tail-first, and only blocks no live request holds (refcount 1);
    interior edges stay until the blocks extending them go."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self._roots: Dict[Any, _ChainNode] = {}
        self._clock = 0
        self.cached_blocks = 0
        self.lookups = 0
        self.hits = 0
        self.blocks_claimed = 0
        self.blocks_inserted = 0
        self.blocks_evicted = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _block_keys(self, tokens) -> List[Tuple[int, ...]]:
        Bs = self.block_size
        return [tuple(int(t) for t in tokens[i * Bs:(i + 1) * Bs])
                for i in range(len(tokens) // Bs)]

    def _match(self, key: Any, blocks: List[Tuple[int, ...]]) -> List[int]:
        node = self._roots.get(key)
        out: List[int] = []
        if node is None:
            return out
        i, stamp = 0, self._tick()
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                break
            j = 0
            while (j < len(child.keys) and i < len(blocks)
                   and child.keys[j] == blocks[i]):
                out.append(child.ids[j])
                i += 1
                j += 1
            child.stamp = stamp
            if j < len(child.keys):
                break
            node = child
        return out

    def claim(self, key: Any, tokens, max_blocks: int) -> List[int]:
        """The longest resident whole-block prefix of ``tokens`` under
        ``key``, at most ``max_blocks`` blocks, with one reference
        retained on each (the caller frees each id once, as after an
        alloc).  The engine caps at ``(prompt_len - 1) // block_size``,
        so the last prompt token is always recomputed and every later
        write lands past the shared blocks."""
        self.lookups += 1
        if max_blocks <= 0:
            return []
        ids = self._match(key, self._block_keys(tokens))[:max_blocks]
        if not ids:
            return []
        self.allocator.retain(ids)
        self.hits += 1
        self.blocks_claimed += len(ids)
        return ids

    def insert(self, key: Any, tokens, block_ids) -> int:
        """Register the full blocks of ``tokens`` (held in ``block_ids``,
        in logical order) as a resident chain under ``key``.  Blocks an
        existing chain covers are matched by content and skipped; new
        ones are retained by the index.  Returns the blocks added."""
        blocks = self._block_keys(tokens)
        if len(block_ids) < len(blocks):
            raise ValueError(
                f"insert: {len(blocks)} full blocks of tokens but only "
                f"{len(block_ids)} block ids"
            )
        if not blocks:
            return 0
        node = self._roots.get(key)
        if node is None:
            node = self._roots[key] = _ChainNode([], [], None, 0)
        i, stamp, added = 0, self._tick(), 0
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                keys = blocks[i:]
                ids = [int(b) for b in block_ids[i:len(blocks)]]
                self.allocator.retain(ids)
                node.children[keys[0]] = _ChainNode(keys, ids, node, stamp)
                added += len(ids)
                break
            j = 0
            while (j < len(child.keys) and i < len(blocks)
                   and child.keys[j] == blocks[i]):
                i += 1
                j += 1
            child.stamp = stamp
            if j == len(child.keys):
                node = child
                continue
            if i == len(blocks):
                break  # a strict prefix of an existing edge: covered
            # Diverged inside the edge: split it at j; the next pass hangs
            # the new suffix under the split point.
            tail = _ChainNode(child.keys[j:], child.ids[j:], child,
                              child.stamp)
            tail.children = child.children
            for grand in tail.children.values():
                grand.parent = tail
            child.keys = child.keys[:j]
            child.ids = child.ids[:j]
            child.children = {tail.keys[0]: tail}
            node = child
        self.cached_blocks += added
        self.blocks_inserted += added
        return added

    def _leaves(self) -> List[_ChainNode]:
        out = []
        for root in self._roots.values():
            stack = list(root.children.values())
            while stack:
                n = stack.pop()
                if n.children:
                    stack.extend(n.children.values())
                else:
                    out.append(n)
        return out

    def evict(self, n_blocks: int) -> int:
        """Release up to ``n_blocks`` resident blocks, least recently used
        leaves first and tail-first within a leaf, skipping any block a
        live request still holds.  Returns the blocks returned to the
        free list."""
        freed = 0
        visited: set = set()
        while freed < n_blocks:
            leaf = None
            for cand in self._leaves():
                if id(cand) in visited:
                    continue
                if leaf is None or cand.stamp < leaf.stamp:
                    leaf = cand
            if leaf is None:
                break
            visited.add(id(leaf))
            while leaf.keys and freed < n_blocks:
                b = leaf.ids[-1]
                if self.allocator.refcount(b) > 1:
                    break  # a live chain holds it
                leaf.keys.pop()
                leaf.ids.pop()
                self.allocator.free([b])
                self.cached_blocks -= 1
                self.blocks_evicted += 1
                freed += 1
            if not leaf.keys and leaf.parent is not None:
                leaf.parent.children = {
                    k: v for k, v in leaf.parent.children.items()
                    if v is not leaf
                }
        return freed

    def drop(self, key: Any) -> int:
        """Release every chain under ``key`` (its adapter was replaced or
        removed, so its KV is stale).  Blocks a live request shares stay
        live until that request drops them."""
        root = self._roots.pop(key, None)
        if root is None:
            return 0
        dropped = 0
        stack = list(root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.allocator.free(n.ids)
            dropped += len(n.ids)
        self.cached_blocks -= dropped
        return dropped

    def drop_all(self) -> int:
        """Release every resident chain."""
        return sum(self.drop(k) for k in list(self._roots))

    def stats(self) -> Dict[str, int]:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "blocks_claimed": self.blocks_claimed,
            "blocks_inserted": self.blocks_inserted,
            "blocks_evicted": self.blocks_evicted,
            "cached_blocks": self.cached_blocks,
        }


# Leaves a product or the embedding consumes in the compute dtype; the
# LayerNorm gains and biases stay as they are.
def _cast_leaf(name: str, t: torch.Tensor, c: torch.dtype) -> torch.Tensor:
    if str(name).startswith("ln") or not t.is_floating_point():
        return t
    return t.to(c)


def prepare_params(params: Dict[str, Any], compute_dtype: torch.dtype,
                   device) -> Dict[str, Any]:
    """A parameter tree as the device functions here take it, made once
    at engine build: on ``device``, an int8 tree dequantized (the JAX
    package's rule off the TPU: no kernel fuses the convert, so the int8
    rounding stays baked into dense weights), and every leaf a product or
    the embedding consumes cast to ``compute_dtype``.  The cast is the
    one the static path makes per use, so the bits are the same."""
    def put(node):
        return {k: put(v) if isinstance(v, dict) else v.to(device)
                for k, v in node.items()}

    tree = put(params)
    if is_quantized(tree):
        tree = dequantize_decode_params(tree)

    def cast(node):
        return {k: cast(v) if isinstance(v, dict)
                else _cast_leaf(k, v, compute_dtype)
                for k, v in node.items()}

    return cast(tree)


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
    _check_prepared(params, c)
    x = _embed(params, tokens[None], c) + params["wpe"][:T]
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


def _check_prepared(params: Dict[str, Any], c: torch.dtype) -> None:
    if params["wpe"].dtype != c:
        raise ValueError(
            f"params are {params['wpe'].dtype}, the step computes in {c}: "
            f"pass them through prepare_params(params, {c}, device) once"
        )


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
    """One token for every slot of the fixed-width slot set: the
    one-token window of :func:`paged_verify_step`.

    Args:
        params: the tree from :func:`prepare_params` for
            ``compute_dtype``.
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
    return paged_verify_step(
        cfg, params, pool, block_tables, seq_lens, tokens[:, None],
        seq_lens + 1, compute_dtype=compute_dtype, adapters=adapters,
        adapter_ids=adapter_ids, lora_impl=lora_impl, head_at=0,
    )


def paged_verify_step(
    cfg: GPTConfig,
    params: Dict[str, Any],
    pool: Dict[str, torch.Tensor],
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    tokens: torch.Tensor,
    write_limit: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    adapters: Optional[Dict[str, torch.Tensor]] = None,
    adapter_ids: Optional[torch.Tensor] = None,
    lora_impl: str = "kernel",
    head_at: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``T`` tokens for every slot in one step: the target's speculative
    verify (each slot's current token and its ``T - 1`` drafts) and,
    at ``W = 1``, a prefill chunk.

    The ``(W, T)`` window sits at positions ``seq_lens + [0, T)``; all
    ``T`` k/v entries are written into the slot's blocks (positions
    ``>= write_limit`` into the trash block: a slot drafting fewer
    tokens pads its window, an inactive slot carries limit 0), and query
    ``i`` sees cache positions ``<= seq_lens + i``, its own write
    included.  Each slot's adapter applies across its whole window: the
    BGMV runs on ``W·T`` rows.  The gather and the scores cover the
    ``M`` blocks of ``block_tables``, so a caller may pass only the
    leading columns that hold every position below ``write_limit``.

    Returns ``(logits (W, T, V) f32, pool)``; with ``head_at`` the LM
    head runs at that window position alone, ``(W, V)`` (a prefill chunk
    needs one row, as the bucketed prefill computes one).
    """
    c = compute_dtype
    _check_prepared(params, c)
    Bs = pool["k"].shape[2]
    W, M = block_tables.shape
    T = tokens.shape[1]
    S = M * Bs
    H, Dh, d = cfg.n_head, cfg.head_dim, cfg.d_model
    tables = block_tables.long()
    dev = tables.device
    pos = seq_lens.long()[:, None] + torch.arange(T, device=dev)[None, :]
    safe_pos = torch.clamp(pos, max=params["wpe"].shape[0] - 1)
    x = _embed(params, tokens.long(), c) + params["wpe"][safe_pos]
    write_blk = torch.gather(tables, 1, torch.clamp(pos // Bs, max=M - 1))
    write_blk = torch.where(pos < write_limit.long()[:, None], write_blk,
                            TRASH_BLOCK)
    write_off = pos % Bs
    scale = Dh ** -0.5
    visible = (torch.arange(S, device=dev)[None, None, :]
               <= pos[:, :, None])  # (W, T, S)

    for l in range(cfg.n_layer):
        p = _layer(params["blocks"], l)
        ad = None if adapters is None else _layer(adapters, l)
        k_pool, v_pool = pool["k"][l], pool["v"][l]
        h = layer_norm(x, p["ln1_g"], p["ln1_b"])
        qkv = h @ p["qkv_w"] + p["qkv_b"]
        qkv = apply_lora(qkv, h, ad, "qkv", adapter_ids, lora_impl)
        q, k, v = qkv.split(d, dim=-1)
        k_pool[write_blk, write_off] = k.reshape(W, T, H, Dh).to(
            k_pool.dtype)
        v_pool[write_blk, write_off] = v.reshape(W, T, H, Dh).to(
            v_pool.dtype)
        ctx_k = k_pool[tables].reshape(W, S, H, Dh)
        ctx_v = v_pool[tables].reshape(W, S, H, Dh)
        scores = torch.einsum(
            "wthd,wshd->whts", q.reshape(W, T, H, Dh).float(),
            ctx_k.float(),
        ) * scale
        scores = torch.where(visible[:, None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        att = torch.einsum(
            "whts,wshd->wthd", probs, ctx_v.float()
        ).reshape(W, T, d).to(c)
        proj = att @ p["proj_w"] + p["proj_b"]
        proj = apply_lora(proj, att, ad, "proj", adapter_ids, lora_impl)
        x = _mlp_residual(x + proj, p, c)
    if head_at is not None:
        x = x[:, head_at]
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
