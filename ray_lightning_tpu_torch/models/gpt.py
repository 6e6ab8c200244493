"""GPT — the decoder-only LM family, in PyTorch: model, loss and data.

Parameters are a plain dict in the JAX package's layout
(``ray_lightning_tpu/models/gpt.py::GPT.init_params``): ``wte``, ``wpe``,
``ln_f_g``, ``ln_f_b`` and a ``blocks`` dict whose tensors carry a leading
``n_layer`` axis; matrices are stored ``(in, out)`` and applied as
``h @ W``.  So a tree converted leaf for leaf from JAX
(``models/convert.py``) runs here unchanged, and the tests compare like
with like.  Activations run in the compute dtype (``precision``);
parameters, LayerNorm statistics and attention softmax stay f32.

Training (``training_step``, ``_loss``) runs the trunk of the JAX
package's ``forward_hidden`` with its single-device kernel gates on: every
LayerNorm site through ``layer_norm(..., use_kernel=True)`` and attention
through ``causal_attention`` (``attn_impl="auto"``, the default: where
the JAX shape gate admits the heads, the flash kernels on the card and
their plain versions on the CPU; elsewhere the plain attention), then the
tied LM head + cross-entropy with ``use_kernel=True`` (``ops/cross_entropy.py``:
the CE kernels where the JAX gate admits ``d``, else the vocab-chunk
scan; ``GPT(ce_kernel=False)`` takes the scan).  With ``remat=True`` each
block runs under
non-reentrant ``torch.utils.checkpoint`` with a selective policy that
mirrors the JAX package's ``remat_policy`` (:func:`remat_policy_fn`).  The
stacked ``blocks`` tensors are unbound per layer, so their gradients come
back stacked ``(L, ...)``: the optimizer and the tests see the JAX
package's tree.

LoRA (``lora_rank > 0``): each block adds ``(h @ A) @ B · lora_alpha /
lora_rank`` to qkv and ``(att @ A) @ B`` likewise to proj, in the compute
dtype, as the JAX ``forward_hidden`` does; the optimizer trains the
``lora_*`` leaves alone (``configure_optimizers``), and the fit loop asks
:meth:`GPT.trainable` which leaves need a gradient, so the frozen base's
weight-gradient products (the CE dW kernel among them) are never
computed.  The adapter helpers (``add_lora_adapters``, ``extract_lora``,
``merge_lora``, ``synthetic_lora_adapter``) keep the JAX package's
``lora_*`` key names and its scale.

MoE (``n_experts > 0``): every block's MLP is the routed expert MLP
(``ops/moe.py``, :func:`_moe_residual`), its load-balance loss averaged
over the layers, logged as ``moe_aux_loss`` and added with weight
``moe_aux_weight`` in ``training_step``; generation and serving run the
same residual with one routing group, as the JAX package does.

Model parallelism (a fit under a strategy whose mesh has ``sp``,
``tensor`` or ``expert``; ``parallel/model_parallel.py``): the parameters
a rank holds are its slices under :meth:`GPT.param_partition_specs` (the
JAX specs; ``models/convert.py::shard_params``), and the block places
Megatron's collectives where GSPMD inserts them in the JAX package:

* ``tensor``: the LayerNorm output goes through ``copy_in`` into the
  column-parallel QKV and MLP-in products, the rank attends over its own
  ``H/t`` heads (the flash kernels launch at ``H/t`` heads), and the
  row-parallel proj and MLP-out products end in ``reduce_out``.  The JAX
  spec of ``qkv_w`` splits its ``3·d`` columns contiguously, which is not
  head-aligned (GSPMD re-lays it out after the reshape to heads); here a
  rank holds the same heads of q, k and v (a departure; ``shard_params``
  and ``gather_params`` map it to and from the JAX array exactly).  The
  tied ``wte`` is feature-sharded (``P(None, "tensor")``): the embedding
  and the head's CE kernels run on the table gathered along ``d``
  (``gather_dim``, the rank's slice of the gradient going back);
* ``sp`` (``attn_impl="ring"``): the rank holds its sequence rows (cut,
  and for ``ring_layout="zigzag"`` permuted, once at the data layer by
  :meth:`GPT.shard_sequence`, with the ``wpe`` positions that go with
  them) and attends through ``ops/ring_attention.py``; its loss is the
  mean over its rows;
* ``expert``: the MoE MLP computes the rank's experts and sums the
  partial output over the ``expert`` x ``tensor`` group.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ray_lightning_tpu_torch.core.data import (
    ArrayDataset, NumpyLoader, TpuDataModule,
)
from ray_lightning_tpu_torch.core.module import TrainModule
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models.quant import (  # noqa: F401
    is_quantized, resolve_weight,
)
from ray_lightning_tpu_torch.models.optim import (
    chain, clip_by_global_norm, gpt_adamw, identity, multi_transform,
    resolve_opt_state_dtype, set_to_zero, tree_map,
)
from ray_lightning_tpu_torch.ops.attention import (
    ATTN_IMPLS, causal_attention,
)
# Imported for its side effect: it registers torch.ops.rlt_torch.flash_fwd,
# which remat_policy_fn names.
import ray_lightning_tpu_torch.ops.flash_attention  # noqa: F401
from ray_lightning_tpu_torch.ops.cross_entropy import (
    fused_lm_head_cross_entropy,
)
from ray_lightning_tpu_torch.ops.layer_norm import layer_norm
from ray_lightning_tpu_torch.ops.matmul import mm_f32
from ray_lightning_tpu_torch.ops.moe import moe_mlp
from ray_lightning_tpu_torch.ops.ring_attention import (
    RING_LAYOUTS, ring_causal_attention, zigzag_indices,
)
from ray_lightning_tpu_torch.parallel.model_parallel import (
    copy_in, data_group_of, gather_dim, model_parallel_of, reduce_out,
)
from ray_lightning_tpu_torch.parallel.pipeline import layer_splits

__all__ = ["GPTConfig", "GPT", "SyntheticLMDataModule", "REMAT_POLICIES",
           "remat_policy_fn", "resolve_weight",
           "is_quantized", "has_lora_adapters", "add_lora_adapters",
           "extract_lora", "merge_lora", "synthetic_lora_adapter",
           "lora_labels"]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The JAX package's ``GPTConfig``.  ``n_experts > 0``: every block's
    MLP is ``n_experts`` routed experts (top ``moe_top_k``, capacity
    ``moe_capacity_factor``, the load-balance loss weighted by
    ``moe_aux_weight``).  ``opt_state_dtype``: None (bf16 mu, f32 nu),
    "float32", "bfloat16" or "int8" AdamW moments (``models/optim.py``)."""

    vocab_size: int = 50304  # GPT-2 vocab padded to a multiple of 128
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    seq_len: int = 1024
    mlp_ratio: int = 4
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    # AdamW first-moment storage dtype ("bfloat16" or "float32").
    mu_dtype: str = "bfloat16"
    opt_state_dtype: Optional[str] = None
    # LoRA (0 = off): rank of the adapters on the attention projections
    # (qkv and proj); the adapter delta is scaled by lora_alpha / rank.
    lora_rank: int = 0
    lora_alpha: float = 16.0

    @classmethod
    def tiny(cls) -> "GPTConfig":
        """Test-sized config."""
        return cls(vocab_size=512, n_layer=2, n_head=4, d_model=128,
                   seq_len=128, warmup_steps=2)

    @classmethod
    def gpt2_small(cls) -> "GPTConfig":
        return cls()  # 124M params

    @classmethod
    def tiny_moe(cls, n_experts: int = 4, **kw) -> "GPTConfig":
        return cls(vocab_size=512, n_layer=2, n_head=4, d_model=128,
                   seq_len=128, warmup_steps=2, n_experts=n_experts, **kw)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head


def _mlp_residual(x: torch.Tensor, p: Dict[str, Any],
                  c: torch.dtype, ln_kernel: bool = False,
                  tensor=None) -> torch.Tensor:
    """LN2 + GELU MLP + residual — the dense second half of a GPT block,
    over any leading dims.  GELU is the tanh form, as ``jax.nn.gelu``'s
    default.  ``ln_kernel``: the LayerNorm kernel pair (training).
    ``tensor``: the rank's tensor group (``p`` holds its column slice of
    MLP-in and row slice of MLP-out)."""
    h = layer_norm(x, p["ln2_g"], p["ln2_b"], use_kernel=ln_kernel)
    h = F.gelu(
        copy_in(h, tensor) @ resolve_weight(p, "mlp_in_w", c)
        + p["mlp_in_b"].to(c),
        approximate="tanh",
    )
    return (x + reduce_out(h @ resolve_weight(p, "mlp_out_w", c), tensor)
            + p["mlp_out_b"].to(c))


def _moe_residual(x: torch.Tensor, p: Dict[str, Any], cfg: "GPTConfig",
                  groups: int, ln_kernel: bool = False, mp=None, data=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LN2 + routed expert MLP + residual — the MoE second half of a GPT
    block, for training and decode alike: ``(x, aux_loss)``.  ``mp``: the
    rank's ``ModelParallel`` (``p`` holds its experts' slices); ``data``:
    the group of the other data shards (the load-balance statistics are
    summed over it)."""
    h = layer_norm(x, p["ln2_g"], p["ln2_b"], use_kernel=ln_kernel)
    w = p["gate_w"].dtype
    y, aux = moe_mlp(
        h, p["gate_w"], resolve_weight(p, "moe_in_w", w), p["moe_in_b"],
        resolve_weight(p, "moe_out_w", w), p["moe_out_b"],
        top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
        groups=groups, data=data,
        **({} if mp is None else dict(
            expert=mp.expert, tensor=mp.tensor,
            expert_tensor=mp.expert_tensor)))
    return x + y, aux


REMAT_POLICIES = ("dots+flash", "dots+flash-out", "dots", "bf16-resid")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def remat_policy_fn(name: str) -> Callable:
    """The selective-checkpoint policy of ``remat_policy=name``: what one
    block's backward keeps, the rest being recomputed.

    * ``"dots"`` — the outputs of the weight products (``aten.mm`` and
      ``aten.addmm``, 2-D: the JAX ``dots_with_no_batch_dims_saveable``);
      the flash forward runs again in the backward.
    * ``"dots+flash-out"`` — the above plus the flash forward's ``out``
      and ``lse`` (the outputs of ``torch.ops.rlt_torch.flash_fwd``).
    * ``"dots+flash"`` — the JAX package adds the flash forward's inputs,
      its per-head q/k/v transposes.  Here the kernels read q, k and v as
      strided views of the fused projection, whose product output is
      already saved; what is left of the inputs is its bias add, one
      elementwise op a layer.  So the policy is that of
      ``"dots+flash-out"``: the two names compute the same numbers, and
      no measurement has shown the extra (B, T, 3d) save a layer to pay.
    * ``"bf16-resid"`` — the ``"dots+flash-out"`` set; the block's carry is
      stored in bf16 (``GPT.forward_hidden``).

    Elementwise ops and LayerNorm (its forward kernel too) are recomputed
    under every policy."""
    flash = name != "dots"

    def policy(ctx, func, *args, **kwargs):
        if func in _DOTS:
            return CheckpointPolicy.MUST_SAVE
        if flash and func is torch.ops.rlt_torch.flash_fwd.default:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=generator.device) * std


class GPT(TrainModule):
    """Decoder-only LM: a config, an attention implementation, a precision
    and a device.  Batch contract (training): ``{"tokens": int (B, T+1)}``
    — inputs are ``tokens[:, :-1]``, targets ``tokens[:, 1:]``.

    The parameters are a dict (see the module docstring), made by
    :meth:`init_params` or converted from the JAX package, and passed to
    the step methods, to ``models/generate.py`` and to ``serve/``.

    Args:
        attn_impl: ``"flash"`` — the flash kernels (their plain versions
            on the CPU); ``"xla"`` — the plain attention under autograd;
            ``"auto"`` (default, the JAX package's name) takes flash
            where ``ops/attention.py::flash_supported`` (the JAX shape
            gate) admits the shape, else ``"xla"``.
        precision: ``"f32"`` (default) or ``"bf16"`` — the activations'
            compute dtype; the fit loop sets it from the trainer's.
        device: where :meth:`init_params` puts the parameters; ``None``
            means ``"cuda"`` and raises without a card.
        remat: recompute each block in the backward instead of keeping
            its activations (``torch.utils.checkpoint``, non-reentrant).
        remat_policy: what the backward keeps: one of
            :data:`REMAT_POLICIES` (:func:`remat_policy_fn`), checked even
            when ``remat`` is off, as in the JAX package.
        ce_kernel: the LM head's cross-entropy on its kernel route
            (default, the JAX package's one-chip program) where the JAX
            gate admits ``d``; ``False`` takes the vocab-chunk scan.
        seq_axis: the mesh axis ring attention cuts the sequence over.
        ring_layout: ``"contiguous"`` or ``"zigzag"`` (each rank holds
            chunks ``j`` and ``2n-1-j`` of ``2n``, balancing the causal
            work; ``ops/ring_attention.py``).

    ``attn_impl="ring"`` runs ring attention over the ``seq_axis`` group
    of a strategy's mesh and raises without one, as the JAX package does.
    """

    def __init__(self, config: Optional[GPTConfig] = None,
                 attn_impl: str = "auto", precision: str = "f32",
                 device=None, remat: bool = False,
                 remat_policy: str = "dots+flash", ce_kernel: bool = True,
                 seq_axis: str = "sp", ring_layout: str = "contiguous"):
        super().__init__()
        if precision not in ("f32", "bf16", "bfloat16"):
            raise ValueError(
                f"precision {precision!r} not in ('f32', 'bf16')"
            )
        if attn_impl not in ATTN_IMPLS + ("ring",):
            raise ValueError(
                f"attn_impl {attn_impl!r} not in {ATTN_IMPLS + ('ring',)}")
        if ring_layout not in RING_LAYOUTS:
            raise ValueError(
                f"ring_layout={ring_layout!r}: expected 'contiguous' or "
                f"'zigzag'")
        if seq_axis != "sp":
            raise ValueError(
                f"seq_axis={seq_axis!r}: the port's mesh names the "
                f"sequence axis 'sp'")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy {remat_policy!r} not in {REMAT_POLICIES}")
        config = config or GPTConfig.tiny()
        if config.lora_rank > 0 and config.n_experts > 0:
            raise ValueError(
                "LoRA adapters target the dense attention projections; "
                "lora_rank > 0 with n_experts > 0 is not supported")
        # A typo'd state-precision policy fails here, not at the first step.
        resolve_opt_state_dtype(config.opt_state_dtype)
        self.config = config
        self.attn_impl = attn_impl
        self.precision = precision
        self.device = resolve_device(device)
        self.remat = remat
        self.remat_policy = remat_policy
        self.ce_kernel = ce_kernel
        self.seq_axis = seq_axis
        self.ring_layout = ring_layout
        self.save_hyperparameters(**dataclasses.asdict(self.config),
                                  attn_impl=attn_impl, remat=remat,
                                  remat_policy=remat_policy,
                                  ce_kernel=ce_kernel)

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
        }
        E = cfg.n_experts
        if E > 0:
            blocks.update({
                "gate_w": _normal((L, d, E), 0.02, g),
                "moe_in_w": _normal((L, E, d, h), 0.02, g),
                "moe_in_b": torch.zeros(L, E, h),
                "moe_out_w": _normal((L, E, h, d), resid_std, g),
                "moe_out_b": torch.zeros(L, E, d),
            })
        else:
            blocks.update({
                "mlp_in_w": _normal((L, d, h), 0.02, g),
                "mlp_in_b": torch.zeros(L, h),
                "mlp_out_w": _normal((L, h, d), resid_std, g),
                "mlp_out_b": torch.zeros(L, d),
            })
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

    def param_partition_specs(self) -> Dict[str, Any]:
        """The JAX package's tensor- and expert-parallel layout, as tuples
        (one axis name or None a dim; ``()`` replicated): QKV and MLP-in
        column-parallel, proj and MLP-out row-parallel, the tied ``wte``
        sharded on ``d``, the experts over ``expert`` with each expert's
        hidden dim over ``tensor``.  An axis the mesh lacks shards
        nothing (``models/convert.py::shard_params``)."""
        t, e = "tensor", "expert"
        blocks = {
            "ln1_g": (), "ln1_b": (),
            "qkv_w": (None, None, t), "qkv_b": (None, t),
            "proj_w": (None, t, None), "proj_b": (),
            "ln2_g": (), "ln2_b": (),
        }
        if self.config.lora_rank > 0:
            blocks.update({
                "lora_qkv_a": (), "lora_qkv_b": (None, None, t),
                "lora_proj_a": (None, t, None), "lora_proj_b": (),
            })
        if self.config.n_experts > 0:
            blocks.update({
                "gate_w": (),
                "moe_in_w": (None, e, None, t),
                "moe_in_b": (None, e, t),
                "moe_out_w": (None, e, t, None),
                "moe_out_b": (None, e, None),
            })
        else:
            blocks.update({
                "mlp_in_w": (None, None, t), "mlp_in_b": (None, t),
                "mlp_out_w": (None, t, None), "mlp_out_b": (),
            })
        return {"wte": (None, t), "wpe": (), "blocks": blocks,
                "ln_f_g": (), "ln_f_b": ()}

    def shard_sequence(self, batch: Dict[str, Any], index: int,
                       n: int) -> Dict[str, Any]:
        """Shard ``index`` of ``n`` of a host batch ``{"tokens": (B,
        T+1), ...}`` along the sequence, once at the data layer (``sp``):
        ``{"tokens": inputs, "targets": targets, "positions": their
        positions}`` over the rank's rows, contiguous or in the zig-zag
        order of ``ring_layout``; the batch's other keys as they are."""
        tokens = np.asarray(batch["tokens"])
        T = tokens.shape[1] - 1
        if T % n:
            raise ValueError(f"seq_len {T} does not divide over sp={n}")
        s = T // n
        order = (zigzag_indices(T, n).astype(np.int64)
                 if self.ring_layout == "zigzag" else np.arange(T))
        mine = order[index * s:(index + 1) * s]
        out = {k: tokens[:, mine] if k == "tokens" else v
               for k, v in batch.items()}
        return {**out, "targets": tokens[:, mine + 1], "positions": mine}

    def _moe_groups(self) -> int:
        """Routing groups of the training trunk: one.  The JAX package
        routes ``data``-shard-count groups, each a shard's rows; a rank
        here holds one shard's rows and routes them as its one group
        (one device: every row, as JAX's one device)."""
        return 1

    # -- forward ------------------------------------------------------------
    def forward(self, params: Dict[str, Any],
                tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) -> logits (B, T, vocab) f32.  Materialises the
        full logits: inference only; the loss goes through the chunked
        head."""
        wte = self._wte_full(params)
        x, _ = self.forward_hidden(params, tokens, wte=wte)
        c = self._compute_dtype()
        B, T, d = x.shape
        return mm_f32(x.reshape(B * T, d), wte.to(c).T).reshape(B, T, -1)

    def _wte_full(self, params: Dict[str, Any]) -> torch.Tensor:
        """The token table: under ``tensor`` gathered from the ranks'
        ``d``-slices (``gather_dim``)."""
        mp = model_parallel_of(self)
        return params["wte"] if mp is None else gather_dim(
            params["wte"], 1, mp.tensor)

    def forward_hidden(self, params: Dict[str, Any], tokens: torch.Tensor,
                       positions: Optional[torch.Tensor] = None,
                       wte: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Trunk: tokens (B, T) -> (final hidden (B, T, d) after ``ln_f``,
        MoE aux loss: the layers' mean, 0.0 for a dense config).
        ``positions``: the tokens' sequence positions (``sp``: the rank's
        rows), default ``0..T-1``; ``wte``: the full token table (under
        ``tensor`` the caller's gathered one)."""
        cfg = self.config
        c = self._compute_dtype()
        mp = model_parallel_of(self)
        if wte is None:
            wte = self._wte_full(params)
        pos = (params["wpe"][:tokens.shape[1]] if positions is None
               else params["wpe"][positions.long()])
        x = (wte[tokens.long()] + pos).to(c)
        # "bf16-resid": the carry between blocks — what the remat backward
        # keeps of each layer — is held in bf16 and upcast on entry; gated
        # on remat, as in the JAX package.
        bf16r = self.remat and self.remat_policy == "bf16-resid"
        if bf16r:
            x = x.to(torch.bfloat16)
        # unbind, not indexing: its backward stacks the per-layer grads in
        # one op, so they come back in the (L, ...) layout.
        names = list(params["blocks"])
        layers = [dict(zip(names, ts)) for sub in self._trunk_segments(
            params["blocks"]) for ts in zip(*(sub[k].unbind(0)
                                              for k in names))]
        block = functools.partial(self._block, c=c, bf16r=bf16r, mp=mp)
        remat = self.remat and torch.is_grad_enabled()
        context_fn = functools.partial(
            create_selective_checkpoint_contexts,
            remat_policy_fn(self.remat_policy))
        moe = cfg.n_experts > 0
        aux = torch.zeros((), device=x.device)
        for p in layers:
            if remat:
                # A block draws no random numbers, so there is no RNG state
                # to keep for its recompute (and reading the CUDA RNG state
                # would stop a CUDA-graph capture of the step).
                out = checkpoint(block, x, p, use_reentrant=False,
                                 preserve_rng_state=False,
                                 context_fn=context_fn)
            else:
                out = block(x, p)
            if moe:
                x, layer_aux = out
                aux = aux + layer_aux
            else:
                x = out
        if bf16r:
            x = x.to(c)
        x = layer_norm(x, params["ln_f_g"], params["ln_f_b"], use_kernel=True)
        # The layers' mean: balanced routing scores ~1 at any depth.
        return x, aux / max(cfg.n_layer, 1)

    def _trunk_segments(self, blocks: Dict[str, torch.Tensor]
                        ) -> List[Dict[str, torch.Tensor]]:
        """The stacked ``blocks`` as the trunk runs them: whole, or, under
        the backward-overlapped gradient sync (``trainer.grad_tap_plane``),
        cut into G row ranges at ``layer_splits`` bounds, each routed
        through the plane's tap ``seg{g}`` outside any remat wrapper.  The
        cut is bitwise neutral: the same layers run, and a slice's
        backward adds zeros outside its rows."""
        plane = getattr(getattr(self, "trainer", None), "grad_tap_plane",
                        None)
        if plane is None:
            return [blocks]
        cfg = self.config
        bounds = layer_splits(cfg.n_layer, min(plane.trunk_segments,
                                               max(cfg.n_layer, 1)))
        subs = []
        for g in range(len(bounds) - 1):
            b, e = bounds[g], bounds[g + 1]
            subs.append(plane.tap(f"seg{g}", {k: v[b:e] for k, v in
                                              blocks.items()}))
        return subs

    def grad_overlap_groups(self, params: Dict[str, Any], segments: int):
        """The param partition of the backward-overlapped gradient sync
        (the JAX ``grad_overlap_groups``), in the order the backward
        completes the groups: ``head`` (the final LN), ``seg0`` ..
        ``seg{G-1}`` (the trunk at ``layer_splits`` bounds, tapped by
        :meth:`_trunk_segments`), ``embed`` (``wte``, ``wpe``; an entry
        group, so the tied head's read of ``wte`` is tapped too).  The
        subtrees hold meta tensors of the groups' shapes."""
        if segments < 1:
            return None
        cfg = self.config
        bounds = layer_splits(cfg.n_layer,
                              min(int(segments), max(cfg.n_layer, 1)))

        def meta(t, rows=None):
            shape = tuple(t.shape) if rows is None else (
                (rows,) + tuple(t.shape[1:]))
            return torch.empty(shape, dtype=t.dtype, device="meta")

        groups = [("head", {k: meta(params[k]) for k in ("ln_f_g", "ln_f_b")},
                   True)]
        for g in range(len(bounds) - 1):
            rows = bounds[g + 1] - bounds[g]
            groups.append((f"seg{g}", {k: meta(v, rows) for k, v in
                                       params["blocks"].items()}, False))
        groups.append(("embed", {k: meta(params[k]) for k in ("wte", "wpe")},
                       True))
        return groups

    def _block(self, x: torch.Tensor, p: Dict[str, torch.Tensor], *,
               c: torch.dtype, bf16r: bool, mp=None):
        """One transformer block of the training trunk: the new residual,
        and for MoE ``(residual, aux)``.  Under ``tensor`` ``p`` holds the
        rank's heads (``H/t`` of q, k and v) and MLP columns."""
        cfg = self.config
        B, T, d = x.shape
        tensor = None if mp is None else mp.tensor
        if bf16r:
            x = x.to(c)
        h = layer_norm(x, p["ln1_g"], p["ln1_b"], use_kernel=True)
        qkv = copy_in(h, tensor) @ p["qkv_w"].to(c) + p["qkv_b"].to(c)
        if cfg.lora_rank > 0:
            qkv = qkv + self._lora(h, p, "qkv", c)
        width = qkv.shape[-1] // 3
        q, k, v = (z.reshape(B, T, width // cfg.head_dim, cfg.head_dim)
                   for z in qkv.split(width, dim=-1))
        att = self._attention(q, k, v, mp).reshape(B, T, width)
        proj = reduce_out(att @ p["proj_w"].to(c), tensor) + p["proj_b"].to(c)
        if cfg.lora_rank > 0:
            proj = proj + self._lora(att, p, "proj", c)
        x = x + proj
        aux = None
        if cfg.n_experts > 0:
            x, aux = _moe_residual(x, p, cfg, groups=self._moe_groups(),
                                   ln_kernel=True, mp=mp,
                                   data=data_group_of(self))
        else:
            x = _mlp_residual(x, p, c, ln_kernel=True, tensor=tensor)
        if bf16r:
            x = x.to(torch.bfloat16)
        return x if aux is None else (x, aux)

    def _attention(self, q, k, v, mp):
        if self.attn_impl == "ring":
            if mp is None:
                # Ring attention asked for with no sequence axis: falling
                # back would hide an O(seq^2) attention (the JAX rule).
                raise ValueError(
                    f"attn_impl='ring' needs mesh axis {self.seq_axis!r}: "
                    f"fit under a strategy with {self.seq_axis!r} in "
                    f"mesh_axes, or use attn_impl='auto'")
            return ring_causal_attention(q, k, v, mp.sp, self.ring_layout)
        return causal_attention(q, k, v, impl=self.attn_impl)

    def _lora(self, z: torch.Tensor, p: Dict[str, torch.Tensor], site: str,
              c: torch.dtype) -> torch.Tensor:
        """The adapter term of ``site``: ``(z @ A) @ B · alpha / rank`` in
        the compute dtype."""
        cfg = self.config
        return ((z @ p[f"lora_{site}_a"].to(c)) @ p[f"lora_{site}_b"].to(c)
                ) * (cfg.lora_alpha / cfg.lora_rank)

    # -- steps --------------------------------------------------------------
    def _loss(self, params: Dict[str, Any], tokens: torch.Tensor,
              targets: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean next-token CE of ``tokens (B, T+1)`` (or of ``tokens``
        against ``targets`` at ``positions``: a sequence shard,
        :meth:`shard_sequence`) through the fused tied head: on its kernel
        route unless ``ce_kernel`` is off (the JAX package's one-chip
        program; the JAX gate on ``d`` sends other widths to the scan).
        Under ``tensor`` the head runs on the ``wte`` gathered for the
        embedding (the CE kernels contract over the whole ``d``): every
        tensor rank computes the same loss over the same rows.

        Under a strategy (``parallel.step_fns.DistributedStep``) this is
        still the rank-local CE, where the JAX package dispatches a
        batch-only mesh to its multi-device island: the port's step syncs
        every gradient after the backward (``grad_sync``, or ZeRO's
        reduce-scatter), ``dwte``'s among them, so a psum inside the CE
        would sum it twice.  The island stands alone as
        ``ops.cross_entropy.fused_lm_head_cross_entropy_sharded``, for a
        loss written over a process group by hand."""
        if targets is None:
            tokens, targets = tokens[:, :-1], tokens[:, 1:]
        wte = self._wte_full(params)
        x, aux = self.forward_hidden(params, tokens, positions, wte=wte)
        loss = fused_lm_head_cross_entropy(
            x, wte, targets, compute_dtype=self._compute_dtype(),
            use_kernel=self.ce_kernel,
        ).mean()
        return loss, aux

    @staticmethod
    def _batch_parts(batch):
        return batch["tokens"], batch.get("targets"), batch.get("positions")

    def training_step(self, params, batch, rng):
        loss, aux = self._loss(params, *self._batch_parts(batch))
        logs = {"train_loss": loss}
        if self.config.n_experts > 0:
            logs["moe_aux_loss"] = aux
            loss = loss + self.config.moe_aux_weight * aux
        return loss, logs

    def validation_step(self, params, batch):
        loss, _ = self._loss(params, *self._batch_parts(batch))
        return self.derive_logs({"val_loss": loss})

    def derive_logs(self, logs):
        """``val_ppl = exp(val_loss)``, of the mean loss."""
        if "val_loss" not in logs:
            return logs
        return {**logs, "val_ppl": torch.exp(logs["val_loss"])}

    def predict_step(self, params, batch):
        """Greedy next tokens of ``batch["tokens"][:, :-1]``: the argmax
        of the full f32 logits, int32 (the JAX package's)."""
        return torch.argmax(self.forward(params, batch["tokens"][:, :-1]),
                            dim=-1).to(torch.int32)

    def configure_optimizers(self):
        """Global-norm clip 1.0, then the family's masked warmup-cosine
        AdamW (``models/optim.py``).  Under LoRA only the adapters train:
        ``chain(multi_transform(identity | set_to_zero), clip,
        multi_transform(adamw | set_to_zero))`` over :func:`lora_labels`.
        The frozen gradients are zeroed before the clip, so the clip sees
        the adapters' norm alone, and the base holds no moments."""
        adamw = gpt_adamw(self.config)
        if self.config.lora_rank > 0:
            return chain(
                multi_transform({"train": identity(),
                                 "freeze": set_to_zero()}, lora_labels),
                clip_by_global_norm(1.0),
                multi_transform({"train": adamw, "freeze": set_to_zero()},
                                lora_labels))
        return chain(clip_by_global_norm(1.0), adamw)

    def trainable(self, params: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Which leaves need a gradient: under LoRA, those
        :func:`lora_labels` labels ``"train"`` (the same labels the
        optimizer routes by); else None, every leaf."""
        if self.config.lora_rank <= 0:
            return None
        return tree_map(lambda lab: lab == "train", lora_labels(params))


class SyntheticLMDataModule(TpuDataModule):
    """Deterministic synthetic token stream: the JAX package's
    ``SyntheticLMDataModule`` with the same numpy draws, so both packages
    see the same batches."""

    def __init__(self, config: GPTConfig, batch_size: int = 8,
                 num_batches: int = 16, seed: int = 0):
        super().__init__()
        self.config = config
        self.batch_size = batch_size
        self.num_batches = num_batches
        self.seed = seed
        self._tokens: Optional[np.ndarray] = None

    def setup(self, stage: str) -> None:
        if self._tokens is None:
            rng = np.random.default_rng(self.seed)
            n = self.batch_size * self.num_batches
            self._tokens = rng.integers(
                0, self.config.vocab_size,
                size=(n, self.config.seq_len + 1),
            ).astype(np.int32)

    def _loader(self):
        return NumpyLoader(
            ArrayDataset(tokens=self._tokens), batch_size=self.batch_size,
            shard_index=self.shard_index, num_shards=self.num_shards,
        )

    def train_dataloader(self):
        return self._loader()

    def val_dataloader(self):
        return self._loader()


def _tree_to(tree: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {
        k: _tree_to(v, device) if isinstance(v, dict)
        else v.to(device=device, dtype=torch.float32)
        for k, v in tree.items()
    }


def lora_labels(params: Dict[str, Any]) -> Dict[str, Any]:
    """``"train"`` for the ``lora_*`` leaves, ``"freeze"`` for the rest
    (the labels of the JAX LoRA optimizer's ``multi_transform``)."""

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return "train" if str(name).startswith("lora_") else "freeze"

    return walk(params, "")


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
