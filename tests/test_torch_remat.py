"""Rematerialisation of the port's GPT held against the JAX package (CPU).

``GPT(remat=True, remat_policy=...)`` checkpoints each block with a
selective policy (``models/gpt.py::remat_policy_fn``).  A policy decides
what the backward keeps, never the math of the exact policies; so each is
held against the JAX ``GPT`` with the same policy on one training step:
the JAX side runs its kernel path as the port's step test does (flash
attention and LayerNorm on interpreted Pallas), with its fused CE forced
onto the interpreted Pallas kernels (``use_pallas=True``), and the port
runs its kernel route on the CPU (the plain versions).  Tolerances: loss
1e-5 and gradients 1e-4 absolute, as ``tests/test_torch_train.py`` holds
the step without remat.  ``bf16-resid`` rounds the carry between blocks
to bf16 in both packages; see its test for its tolerance.

The launch counts of each policy are pinned by counting the calls of the
plain versions on the CPU (``ln_fwd_plain``, ``flash_fwd_plain``): the
same counts the kernels' launch counters give on the card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
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
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.gpt import (
    GPT, REMAT_POLICIES, GPTConfig, SyntheticLMDataModule,
)
from ray_lightning_tpu_torch.ops import cross_entropy as tce
from ray_lightning_tpu_torch.ops import flash_attention as tfa
from ray_lightning_tpu_torch.ops import layer_norm as tln
from ray_lightning_tpu_torch.parallel.step_fns import loss_and_grads
from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

jgpt = importlib.import_module("ray_lightning_tpu.models.gpt")
jce = importlib.import_module("ray_lightning_tpu.ops.cross_entropy")

STEP_CFG = dict(vocab_size=512, n_layer=2, n_head=4, d_model=256,
                seq_len=128)


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


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """The JAX GPT's LN sites and fused CE forced onto their (interpreted)
    Pallas kernels, as on one TPU chip."""
    ln = jgpt._layer_norm
    monkeypatch.setattr(jgpt, "_layer_norm",
                        lambda x, g, b, up=False: ln(x, g, b,
                                                     use_pallas=True))
    ce = jce.fused_lm_head_cross_entropy
    monkeypatch.setattr(jce, "fused_lm_head_cross_entropy",
                        lambda *a, **k: ce(*a, **{**k, "use_pallas": True}))


def _step_both(policy):
    """One training step of STEP_CFG with remat under ``policy`` in both
    packages, from the same params and tokens: (JAX loss, JAX grads, port
    loss, port grads), the grads flattened by key path."""
    jm = JaxGPT(JaxGPTConfig(**STEP_CFG, warmup_steps=2), attn_impl="flash",
                remat=True, remat_policy=policy)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(
        0, STEP_CFG["vocab_size"], (2, STEP_CFG["seq_len"] + 1)
    ).astype(np.int32)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jm.training_step(p, {"tokens": jnp.asarray(tokens)},
                                   None)[0])(jax.tree.map(jnp.asarray, tree))
    tm = GPT(GPTConfig(**STEP_CFG), attn_impl="flash", device="cpu",
             remat=True, remat_policy=policy)
    grads, logs = loss_and_grads(tm, params_from_jax(tree, "cpu"),
                                 {"tokens": torch.from_numpy(tokens)}, None)
    return (float(loss_j), _flat(grads_j), float(logs["train_loss"]),
            _flat_t(grads))


@pytest.mark.parametrize("policy", ["dots+flash", "dots+flash-out", "dots"])
def test_remat_step_matches_jax_with_the_same_policy(jax_kernel_path,
                                                     policy):
    loss_j, want, loss, got = _step_both(policy)
    assert loss == pytest.approx(loss_j, abs=1e-5)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert float(np.abs(got[k] - want[k]).max()) < 1e-4, k


def test_bf16_resid_step_matches_jax_bf16_resid(jax_kernel_path):
    """At f32 precision both packages round the carry between blocks to
    bf16.  Where the two f32 carries differ by their ~1e-7 the rounding
    can land on two neighbouring bf16 values (2^-8 apart, relative), so
    the tolerance is the step test's scaled by the bf16 step: loss 1e-4,
    gradients 1e-4 + 2^-8·max|grad| of the leaf."""
    loss_j, want, loss, got = _step_both("bf16-resid")
    assert loss == pytest.approx(loss_j, abs=1e-4)
    for k in want:
        tol = 1e-4 + 2.0 ** -8 * float(np.abs(want[k]).max())
        assert float(np.abs(got[k] - want[k]).max()) < tol, k


def _count_step(monkeypatch, **kw):
    """(ln_fwd_plain calls, flash_fwd_plain calls, loss, grads) of one
    step of STEP_CFG with ``GPT(**kw)``."""
    calls = {"ln": 0, "flash": 0}
    ln, fa = tln.ln_fwd_plain, tfa.flash_fwd_plain

    def count_ln(*a):
        calls["ln"] += 1
        return ln(*a)

    def count_fa(*a):
        calls["flash"] += 1
        return fa(*a)

    monkeypatch.setattr(tln, "ln_fwd_plain", count_ln)
    monkeypatch.setattr(tfa, "flash_fwd_plain", count_fa)
    cfg = GPTConfig(**STEP_CFG)
    tm = GPT(cfg, device="cpu", **kw)
    params = tm.init_params()
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, cfg.seq_len + 1)))
    grads, logs = loss_and_grads(tm, params, {"tokens": tokens}, None)
    monkeypatch.setattr(tln, "ln_fwd_plain", ln)
    monkeypatch.setattr(tfa, "flash_fwd_plain", fa)
    return calls["ln"], calls["flash"], float(logs["train_loss"]), grads


def test_each_policy_runs_the_kernels_it_should(monkeypatch):
    """Per step at L = 2: without remat 2L+1 LN forwards and L flash
    forwards; every policy re-runs the 2L LN forwards of the blocks; only
    "dots" re-runs the flash forward.  The exact policies give the
    no-remat step's loss and gradients bit for bit, but for ``wte``, whose
    embedding backward on the CPU sums in an order that changes from run
    to run (~4e-9 apart with or without remat)."""
    L = STEP_CFG["n_layer"]
    ln0, fa0, loss0, grads0 = _count_step(monkeypatch)
    assert (ln0, fa0) == (2 * L + 1, L)
    for policy in REMAT_POLICIES:
        n_ln, n_fa, loss, grads = _count_step(monkeypatch, remat=True,
                                              remat_policy=policy)
        assert n_ln == 4 * L + 1, policy
        assert n_fa == (2 * L if policy == "dots" else L), policy
        if policy != "bf16-resid":
            assert loss == loss0, policy
            want = _flat_t(grads0)
            for k, v in _flat_t(grads).items():
                if k == "['wte']":
                    assert np.abs(v - want[k]).max() <= 1e-6 * np.abs(
                        want[k]).max(), policy
                else:
                    assert np.array_equal(v, want[k]), (policy, k)


def test_remat_policy_is_checked_and_recorded():
    with pytest.raises(ValueError, match="remat_policy"):
        GPT(GPTConfig.tiny(), device="cpu", remat_policy="everything")
    tm = GPT(GPTConfig.tiny(), device="cpu", remat=True, remat_policy="dots")
    assert (tm.hparams["remat"], tm.hparams["remat_policy"]) == (True,
                                                                 "dots")
    # Without a gradient the blocks run as they are (nothing to keep).
    with torch.no_grad():
        logits = tm.forward(tm.init_params(),
                            torch.zeros(1, 8, dtype=torch.int64))
    assert logits.shape == (1, 8, GPTConfig.tiny().vocab_size)


def test_fit_with_remat_and_the_ce_kernel_route_matches_the_jax_fit(
        tmp_path, monkeypatch):
    """Five optimizer steps of GPTConfig.tiny() (d = 128: the CE kernel
    route) at batch 8 with remat under "dots+flash" in both packages, as
    ``tests/test_torch_train.py`` holds the fit without remat: mean train
    loss and final params within 1e-5 absolute."""
    jcfg = JaxGPTConfig.tiny()
    jm = JaxGPT(jcfg, remat=True, remat_policy="dots+flash")
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(3)))
    jm.initial_params = tree
    jt = JaxTrainer(strategy=JaxLocalStrategy(), max_steps=5,
                    limit_val_batches=0, enable_checkpointing=False,
                    default_root_dir=str(tmp_path))
    jt.fit(jm, JaxSyntheticLM(jcfg, batch_size=8, num_batches=5, seed=4))

    calls = []
    fwd = tce.ce_fwd_plain
    monkeypatch.setattr(tce, "ce_fwd_plain",
                        lambda *a: calls.append(1) or fwd(*a))
    cfg = GPTConfig.tiny()
    assert cfg.d_model % 128 == 0  # the CE kernel route's gate
    tm = GPT(cfg, device="cpu", remat=True, remat_policy="dots+flash")
    tm.initial_params = params_from_jax(tree, "cpu")
    tr = Trainer(LocalStrategy(device="cpu"), max_steps=5,
                 limit_val_batches=0, enable_checkpointing=False)
    tr.fit(tm, SyntheticLMDataModule(cfg, batch_size=8, num_batches=5,
                                     seed=4))
    assert len(calls) == 5  # one CE kernel-route forward a step
    assert tr.global_step == jt.global_step == 5
    assert tr.callback_metrics["train_loss"] == pytest.approx(
        jt.callback_metrics["train_loss"], abs=1e-5)
    want, got = _flat(jt.state.params), _flat_t(tr.state.params)
    for k in want:
        assert float(np.abs(got[k] - want[k]).max()) < 1e-5, k
