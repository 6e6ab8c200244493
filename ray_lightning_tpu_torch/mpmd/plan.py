"""Stage planning: how a stacked-layer model splits into pipeline stages
(``ray_lightning_tpu/mpmd/plan.py``).

* :class:`StagePlan` — where the model splits: ``P`` contiguous runs of
  the stacked ``(L, ...)`` layer axis (``parallel/pipeline.py::
  layer_splits``, a remainder on the earliest stages).
* :class:`MpmdSpec` — how one stage computes: ``embed_fn`` (raw batch →
  first activations, stage 0 only), ``stage_fn`` (a run of stacked
  layers, the signature ``pipeline_apply`` takes) and ``loss_fn`` (last
  activations + batch → ``(loss, logs)``, last stage only), with the
  param split/assemble pair.  Each is a function of ``(params, ...)``
  over dicts of tensors.

Each stage applies the module's optimizer to its own params only: AdamW
is elementwise, so that equals a one-program fit; a transform that
couples leaves across stages (the global-norm clip) does not decompose,
so the GPT adapter's optimizer is ``gpt_adamw`` without the clip.

Tied embeddings: the first and last stages are different programs, so
the GPT adapter unties the LM head: the last stage holds ``head_w``, a
copy of ``wte`` (a copy, never the same tensor: an aliased head would be
updated by two stages at ``P = 1`` and in the threaded in-process fit).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_lightning_tpu_torch.parallel.pipeline import layer_splits

__all__ = ["StagePlan", "MpmdSpec", "gpt_mpmd_spec", "resolve_mpmd_spec"]


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """``P`` contiguous stages over an ``n_layers``-deep stacked model."""

    n_layers: int
    n_stages: int
    boundaries: Tuple[int, ...]

    @classmethod
    def split(cls, n_layers: int, n_stages: int) -> "StagePlan":
        return cls(
            n_layers=n_layers,
            n_stages=n_stages,
            boundaries=layer_splits(n_layers, n_stages),
        )

    def stage_bounds(self, stage: int) -> Tuple[int, int]:
        """Layer interval ``[start, stop)`` owned by ``stage``."""
        if not 0 <= stage < self.n_stages:
            raise ValueError(
                f"stage {stage} out of range for {self.n_stages} stages"
            )
        return self.boundaries[stage], self.boundaries[stage + 1]

    def stage_layers(self, stage: int) -> int:
        start, stop = self.stage_bounds(stage)
        return stop - start

    def is_first(self, stage: int) -> bool:
        return stage == 0

    def is_last(self, stage: int) -> bool:
        return stage == self.n_stages - 1

    def slice_stacked(self, stacked: Dict[str, Any], stage: int
                      ) -> Dict[str, Any]:
        """Every leaf of a stacked ``(L, ...)`` dict cut to this stage's
        layer run (views)."""
        from ray_lightning_tpu_torch.models.optim import tree_map

        start, stop = self.stage_bounds(stage)
        return tree_map(lambda a: a[start:stop], stacked)


@dataclasses.dataclass
class MpmdSpec:
    """The model's decomposition for the pipeline plane:
    ``embed_fn(stage0_params, batch) -> x0`` · ``stage_fn(blocks, x) ->
    x`` · ``loss_fn(last_params, x, batch) -> (loss, logs)``; per-stage
    param trees from ``split_params(full_params, plan, stage)``, put back
    together by ``assemble_params(stage_params_list, plan)``.
    ``tx_factory``: the per-stage optimizer (None: the module's
    ``configure_optimizers()``)."""

    n_layers: int
    embed_fn: Callable[[Any, Any], Any]
    stage_fn: Callable[[Any, Any], Any]
    loss_fn: Callable[[Any, Any, Any], Tuple[Any, Dict[str, Any]]]
    split_params: Callable[[Any, StagePlan, int], Any]
    assemble_params: Callable[[List[Any], StagePlan], Any]
    tx_factory: Optional[Callable[[], Any]] = None


def _gpt_untie(full_params: Dict[str, Any]) -> Dict[str, Any]:
    """Add the untied LM head (``head_w``, a copy of ``wte``) when
    absent."""
    if "head_w" in full_params:
        return full_params
    out = dict(full_params)
    out["head_w"] = torch.as_tensor(full_params["wte"]).clone()
    return out


def _host(t: Any) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu()


def gpt_mpmd_spec(module, compute_dtype: Optional[torch.dtype] = None
                  ) -> MpmdSpec:
    """A dense port ``GPT`` as pipeline stages: the ``wte``/``wpe``
    embedding on stage 0, :func:`~..models.gpt.make_block_stage` per
    stage, and ``ln_f`` + the untied head's f32 cross-entropy on the last
    stage.  The compute dtype is the module's precision's (the JAX stage
    reads ``module.precision``, not the Trainer's)."""
    from ray_lightning_tpu_torch.models.gpt import make_block_stage
    from ray_lightning_tpu_torch.models.optim import gpt_adamw
    from ray_lightning_tpu_torch.ops.layer_norm import layer_norm

    cfg = module.config
    if compute_dtype is None:
        compute_dtype = (torch.bfloat16
                         if module.precision in ("bf16", "bfloat16")
                         else torch.float32)
    c = compute_dtype
    stage_fn = make_block_stage(cfg, compute_dtype=c)

    def embed_fn(params, batch):
        tokens = batch["tokens"][:, :-1].long()
        t = tokens.shape[1]
        return (params["wte"][tokens] + params["wpe"][:t]).to(c)

    def loss_fn(params, x, batch):
        targets = batch["tokens"][:, 1:].long()
        x = layer_norm(x, params["ln_f_g"], params["ln_f_b"])
        logits = torch.einsum("btd,vd->btv", x.float(),
                              params["head_w"].float())
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, targets[..., None])[..., 0]
        loss = (logz - ll).mean()
        return loss, {"loss": loss}

    def split_params(full, plan: StagePlan, stage: int):
        full = _gpt_untie(full)
        out: Dict[str, Any] = {
            "blocks": plan.slice_stacked(full["blocks"], stage)
        }
        if plan.is_first(stage):
            out["wte"] = full["wte"]
            out["wpe"] = full["wpe"]
        if plan.is_last(stage):
            out["ln_f_g"] = full["ln_f_g"]
            out["ln_f_b"] = full["ln_f_b"]
            out["head_w"] = full["head_w"]
        return out

    def assemble_params(stage_params: List[Any], plan: StagePlan):
        if len(stage_params) != plan.n_stages:
            raise ValueError(
                f"{len(stage_params)} stage param trees for "
                f"{plan.n_stages} stages"
            )
        first, last = stage_params[0], stage_params[-1]
        blocks = {
            key: torch.cat([_host(sp["blocks"][key])
                            for sp in stage_params], dim=0)
            for key in first["blocks"]
        }
        return {
            "wte": _host(first["wte"]),
            "wpe": _host(first["wpe"]),
            "blocks": blocks,
            "ln_f_g": _host(last["ln_f_g"]),
            "ln_f_b": _host(last["ln_f_b"]),
            "head_w": _host(last["head_w"]),
        }

    return MpmdSpec(
        n_layers=cfg.n_layer,
        embed_fn=embed_fn,
        stage_fn=stage_fn,
        loss_fn=loss_fn,
        split_params=split_params,
        assemble_params=assemble_params,
        # The family's AdamW without the global-norm clip: the clip
        # couples leaves across stages and does not decompose.
        tx_factory=functools.partial(gpt_adamw, cfg),
    )


def resolve_mpmd_spec(module) -> MpmdSpec:
    """The MpmdSpec of a module: an explicit ``module.mpmd_spec()`` wins;
    a GPT gets the built-in adapter; anything else raises (pipelining
    needs model knowledge no generic wrapper can infer)."""
    maker = getattr(module, "mpmd_spec", None)
    if maker is not None:
        spec = maker()
        if not isinstance(spec, MpmdSpec):
            raise TypeError(
                f"{type(module).__name__}.mpmd_spec() returned "
                f"{type(spec).__name__}, expected MpmdSpec"
            )
        return spec
    from ray_lightning_tpu_torch.models.gpt import GPT

    if isinstance(module, GPT):
        return gpt_mpmd_spec(module)
    raise TypeError(
        f"MpmdStrategy needs a stage decomposition for "
        f"{type(module).__name__}: implement mpmd_spec() -> MpmdSpec "
        "(see ray_lightning_tpu_torch.mpmd.plan) or use a GPT module."
    )
