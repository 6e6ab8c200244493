"""The port's training path held against the JAX package (CPU, f32).

Parameters come from the JAX package (``init_params``) and are carried
across with ``params_from_jax``; batches come from the same numpy draws.
On the CPU the port's kernel wrappers run their plain versions; the JAX
references run their Pallas kernels under the interpreter where the test
says so.  Tolerances: loss 1e-5 and gradients 1e-4 absolute for one step
(as ``tests/test_gpt.py`` holds the kernel path against XLA); the
optimizer 1e-6 relative to the parameters' scale (the same f32 update
arithmetic, a schedule computed in double here and in f32 there, sums in
another order); the fit as stated at its test.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.models.gpt import (
    SyntheticLMDataModule as JaxSyntheticLM,
)
from ray_lightning_tpu.parallel.strategies import (
    LocalStrategy as JaxLocalStrategy,
)
from ray_lightning_tpu_torch.core.callbacks import Callback, ModelCheckpoint
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, SyntheticLMDataModule,
)
from ray_lightning_tpu_torch.models.optim import decay_mask, tree_map
from ray_lightning_tpu_torch.ops import flash_attention as tfa
from ray_lightning_tpu_torch.ops import layer_norm as tln
from ray_lightning_tpu_torch.parallel.step_fns import loss_and_grads
from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy
from ray_lightning_tpu_torch.telemetry.step_stats import (
    model_flops_per_token,
)

jgpt = importlib.import_module("ray_lightning_tpu.models.gpt")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + f"['{k}']")
        else:
            out[path] = node.detach().float().cpu().numpy()
    walk(tree, "")
    return out


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def test_clip_adamw_chain_matches_optax_over_six_steps():
    cfg = GPTConfig(lr=1e-2, warmup_steps=2, weight_decay=0.1)
    rng = np.random.default_rng(0)
    shapes = {"wte": (11, 4), "wpe": (5, 4), "ln_f_g": (4,),
              "blocks": {"qkv_w": (2, 4, 12), "qkv_b": (2, 12),
                         "ln1_g": (2, 4)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(
        np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))
    # Steps 0 and 3 clip (global norm > 1); the others do not.
    scales = [10.0, 0.05, 0.1, 5.0, 0.02, 0.1]
    grads = [jax.tree.map(lambda p, s=s: (rng.standard_normal(p.shape) * s
                                          * 0.2).astype(np.float32), params)
             for s in scales]

    jm = JaxGPT(JaxGPTConfig(lr=1e-2, warmup_steps=2, weight_decay=0.1))
    jtx = jm.configure_optimizers()
    jupdate = jax.jit(jtx.update)  # as the JAX trainer's step runs it
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)

    tx = GPT(cfg, device="cpu").configure_optimizers()
    tp = params_from_jax(params, "cpu")
    tstate = tx.init(tp)
    for g in grads:
        ju, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = tx.update(params_from_jax(g, "cpu"), tstate, tp)
        tp = tree_map(lambda p, u: p + u, tp, tu)
        want, got = _flat(jp), _flat_t(tp)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-6 * np.abs(want[k]).max())
        adam = next(s_ for s_ in jax.tree.leaves(
            jstate, is_leaf=lambda n: isinstance(n, optax.ScaleByAdamState))
            if isinstance(s_, optax.ScaleByAdamState))
        assert adam.mu["wte"].dtype == jnp.bfloat16
        assert tstate[1]["mu"]["wte"].dtype == torch.bfloat16
        np.testing.assert_allclose(
            _flat_t(tstate[1]["mu"])["['wte']"],
            np.asarray(adam.mu["wte"], np.float32), rtol=1e-2, atol=1e-7)
        np.testing.assert_allclose(
            _flat_t(tstate[1]["nu"])["['blocks']['qkv_w']"],
            np.asarray(adam.nu["blocks"]["qkv_w"]), rtol=1e-5)
    assert tstate[1]["count"] == 6


def test_schedule_on_a_device_count_matches_optax():
    """warmup 5, decay to 0 at 50: the linear warmup, the cosine, its end
    and past it, on an int32 count tensor (as a captured step reads it)
    against optax's jitted schedule; within 2 f32 ulps of the peak (cos
    and the division in another library's order)."""
    from ray_lightning_tpu_torch.models.optim import (
        warmup_cosine_decay_schedule,
    )

    counts = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(optax.warmup_cosine_decay_schedule(
        0.0, 3e-4, 5, 50)))(jnp.asarray(counts)))
    sched = warmup_cosine_decay_schedule(0.0, 3e-4, 5, 50)
    got = np.array([float(sched(torch.tensor(c, dtype=torch.int32)))
                    for c in counts], np.float32)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2 ** -23 * 3e-4)
    assert got[0] == 0.0 and got[5] == np.float32(3e-4)
    assert np.all(got[50:] == 0.0)
    assert np.all(np.diff(got[:6]) > 0) and np.all(np.diff(got[5:51]) < 0)


def test_first_update_uses_lr_zero_and_mask_names_matrices():
    cfg = GPTConfig(lr=1.0, warmup_steps=3)
    tx = GPT(cfg, device="cpu").configure_optimizers()
    p = {"wte": torch.ones(2, 2), "blocks": {"qkv_b": torch.ones(2)}}
    u, _ = tx.update({"wte": torch.ones(2, 2) * 0.1,
                      "blocks": {"qkv_b": torch.ones(2) * 0.1}},
                     tx.init(p), p)
    assert all(float(t.abs().max()) == 0.0 for t in (u["wte"],
                                                     u["blocks"]["qkv_b"]))
    mask = decay_mask({"wte": 0, "wpe": 0, "ln_f_g": 0,
                       "blocks": {"qkv_w": 0, "qkv_b": 0, "ln1_g": 0}})
    assert mask == {"wte": True, "wpe": False, "ln_f_g": False,
                    "blocks": {"qkv_w": True, "qkv_b": False,
                               "ln1_g": False}}
    # Every opt_state_dtype policy is ported; a name outside them is
    # refused at construction.
    for dtype in (None, "float32", "bfloat16", "int8"):
        GPT(dataclasses.replace(cfg, opt_state_dtype=dtype),
            device="cpu").configure_optimizers()
    with pytest.raises(ValueError, match="opt_state_dtype"):
        GPT(dataclasses.replace(cfg, opt_state_dtype="int4"), device="cpu")


# ---------------------------------------------------------------------------
# One training step
# ---------------------------------------------------------------------------

STEP_CFG = dict(vocab_size=512, n_layer=2, n_head=4, d_model=256,
                seq_len=128)


def test_training_step_loss_and_grads_match_jax_kernel_path(monkeypatch):
    jm = JaxGPT(JaxGPTConfig(**STEP_CFG, warmup_steps=2),
                attn_impl="flash")
    tree = _np_tree(jm.init_params(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(
        0, STEP_CFG["vocab_size"], (2, STEP_CFG["seq_len"] + 1)
    ).astype(np.int32)
    # The JAX LN sites forced onto the (interpreted) kernel, as
    # tests/test_gpt.py does; its flash attention is interpreted Pallas.
    orig = jgpt._layer_norm
    monkeypatch.setattr(
        jgpt, "_layer_norm",
        lambda x, g, b, up=False: orig(x, g, b, use_pallas=True))
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jm.training_step(p, {"tokens": jnp.asarray(tokens)},
                                   None)[0])(jax.tree.map(jnp.asarray, tree))

    tm = GPT(GPTConfig(**STEP_CFG), attn_impl="flash", device="cpu")
    ln0, fa0 = tln.ln_fwd.launches, tfa.flash_fwd.launches
    grads, logs = loss_and_grads(tm, params_from_jax(tree, "cpu"),
                                 {"tokens": torch.from_numpy(tokens)}, None)
    assert float(logs["train_loss"]) == pytest.approx(float(loss_j),
                                                      abs=1e-5)
    want, got = _flat(grads_j), _flat_t(grads)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert float(np.abs(got[k] - want[k]).max()) < 1e-4, k
    # The inference forward (full f32 logits) agrees too.
    logits_j = jm.forward(jax.tree.map(jnp.asarray, tree),
                          jnp.asarray(tokens[:, :-1]))
    with torch.no_grad():
        logits = tm.forward(params_from_jax(tree, "cpu"),
                            torch.from_numpy(tokens[:, :-1]))
    assert logits.dtype == torch.float32
    assert float(np.abs(logits.numpy() - np.asarray(logits_j)).max()) < 1e-4
    # The CPU path ran the plain pairs: no kernel launch was counted.
    assert (tln.ln_fwd.launches, tfa.flash_fwd.launches) == (ln0, fa0)


# ---------------------------------------------------------------------------
# Trainer.fit
# ---------------------------------------------------------------------------

class _Losses(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        self.losses.append(float(logs["train_loss"]))


def test_fit_matches_the_jax_fit_over_five_steps(tmp_path):
    """Five optimizer steps of GPTConfig.tiny() at batch 8 from the same
    initial params (``initial_params``) and batches.  The JAX fit runs its
    plain XLA path over the 8 CPU test devices; the port's, one device.
    Mean train loss within 1e-5 absolute.  Final params within 1e-5
    absolute: most leaves agree to ~1e-9, but where an f32 moment lies
    near a bf16 rounding boundary its stored mu may round the other way,
    moving that element's update by up to 2^-8 of a step (~1.2e-6 at
    lr 3e-4) in each of the four steps with lr > 0."""
    jcfg = JaxGPTConfig.tiny()
    jm = JaxGPT(jcfg)
    tree = _np_tree(jm.init_params(jax.random.PRNGKey(3)))
    jm.initial_params = tree
    jt = JaxTrainer(strategy=JaxLocalStrategy(), max_steps=5,
                    limit_val_batches=0, enable_checkpointing=False,
                    default_root_dir=str(tmp_path))
    jt.fit(jm, JaxSyntheticLM(jcfg, batch_size=8, num_batches=5, seed=4))

    cfg = GPTConfig.tiny()
    tm = GPT(cfg, device="cpu")
    tm.initial_params = params_from_jax(tree, "cpu")
    cb = _Losses()
    tr = Trainer(LocalStrategy(device="cpu"), max_steps=5,
                 limit_val_batches=0, callbacks=[cb],
                 enable_checkpointing=False)
    tr.fit(tm, SyntheticLMDataModule(cfg, batch_size=8, num_batches=5,
                                     seed=4))
    assert tr.global_step == jt.global_step == 5
    assert len(cb.losses) == 5
    assert tr.callback_metrics["train_loss"] == pytest.approx(
        jt.callback_metrics["train_loss"], abs=1e-5)
    want, got = _flat(jt.state.params), _flat_t(tr.state.params)
    for k in want:
        assert float(np.abs(got[k] - want[k]).max()) < 1e-5, k
    # The cheap telemetry tier is the default in both packages: the same
    # telemetry keys (and the same keys overall) land in callback_metrics.
    telemetry = {"step_time_ms", "data_wait_ms", "dispatch_ms",
                 "device_step_ms", "examples_per_sec", "tokens_per_sec",
                 "mfu", "recompiles"}
    assert set(tr.callback_metrics) & telemetry == (
        set(jt.callback_metrics) & telemetry)
    assert set(tr.callback_metrics) == set(jt.callback_metrics)


def test_fit_limits_validation_and_log_cadence():
    cfg = GPTConfig.tiny()
    tr = Trainer(LocalStrategy(device="cpu"), max_epochs=2,
                 limit_train_batches=2, limit_val_batches=1,
                 log_every_n_steps=1, enable_checkpointing=False)
    tr.fit(GPT(cfg, device="cpu"),
           SyntheticLMDataModule(cfg, batch_size=2, num_batches=3))
    assert (tr.global_step, tr.epochs_run) == (4, 2)
    m = tr.callback_metrics
    assert {"train_loss", "loss", "val_loss", "val_ppl"} <= set(m)
    assert m["val_ppl"] == pytest.approx(np.exp(m["val_loss"]), rel=1e-5)
    assert model_flops_per_token(GPTConfig.gpt2_small()) == pytest.approx(
        854.7e6, rel=1e-3)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_entry_points_refuse_what_is_not_ported():
    if torch.cuda.is_available():
        assert LocalStrategy().device.type == "cuda"
    else:
        for make in (LocalStrategy, Trainer, lambda: GPT(GPTConfig.tiny())):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    strat = LocalStrategy(device="cpu")
    # Checkpoints are ported: the default appends ModelCheckpoint(monitor=
    # None) as the JAX Trainer does, a user's ModelCheckpoint replaces it,
    # and resume_from_checkpoint reaches the fit's config.
    (cb,) = Trainer(strat).callbacks
    assert isinstance(cb, ModelCheckpoint) and cb.monitor is None
    mine = ModelCheckpoint(monitor="val_loss")
    assert Trainer(strat, callbacks=[mine]).callbacks == [mine]
    assert Trainer(strat, enable_checkpointing=False).callbacks == []
    tr = Trainer(strat, resume_from_checkpoint="x.ckpt")
    assert tr.config.resume_from_checkpoint == "x.ckpt"
    assert tr.config.default_root_dir == "rlt_logs"
    # remat is ported; an unknown save policy is refused at construction.
    with pytest.raises(ValueError, match="remat_policy"):
        GPT(GPTConfig.tiny(), device="cpu", remat=True,
            remat_policy="everything")
    # The cheap tier is ported; the full tier (spans) is refused.
    with pytest.raises(NotImplementedError, match="telemetry tier 'full'"):
        LocalStrategy(device="cpu", telemetry="full")
    moe = GPT(dataclasses.replace(GPTConfig.tiny(), n_experts=4),
              device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        moe.forward_hidden(moe.init_params(), torch.zeros(1, 4, dtype=torch.int32))
