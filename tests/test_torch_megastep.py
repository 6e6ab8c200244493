"""Megastep and gradient accumulation of the port's fit loop held against
the JAX package's (CPU, f32, ``GPTConfig.tiny()``).

Both fits start from the JAX package's ``init_params`` (carried across
with ``params_from_jax``) and draw the same batches.  On the CPU the
port runs a stride's K steps eagerly in a loop under the stride's
bookkeeping (the card replays a CUDA graph, ``tests/test_torch_gpu.py``);
the JAX package fuses them with ``lax.scan`` over its 8 CPU test devices.
Tolerances: losses, epoch means and final params within 1e-5 absolute,
as ``test_torch_train.py::test_fit_matches_the_jax_fit_over_five_steps``
holds the per-step fit (the same f32 arithmetic in another order, and a
bf16 first moment that may round the other way near a boundary); the
port's megastep fit against its own per-step fit: params bitwise.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.models.gpt import (
    SyntheticLMDataModule as JaxSyntheticLM,
)
from ray_lightning_tpu.parallel.strategies import (
    LocalStrategy as JaxLocalStrategy,
)
from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.loop import (
    FitConfig, _grouped, _normalize_megastep, _resolve_megastep,
)
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, SyntheticLMDataModule,
)
from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

jloop = importlib.import_module("ray_lightning_tpu.core.loop")

TOL = 1e-5


def _flat_j(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_t(v, path + f"['{k}']").items()}
    return {path: tree.detach().cpu().numpy()}


def _recorder(base):
    class Hooks(base):
        """Every on_train_batch_end (index, loss) and flush."""

        def __init__(self):
            self.batches, self.flushes = [], []

        def on_train_batch_end(self, trainer, module, logs, batch_idx):
            self.batches.append((batch_idx, float(logs["train_loss"])))

        def on_accumulation_flush(self, trainer, module, logs, batch_idx):
            self.flushes.append((trainer.global_step, batch_idx))

    return Hooks()


_INIT = {}


def _init_tree():
    if "tree" not in _INIT:
        _INIT["tree"] = jax.tree.map(np.asarray, JaxGPT(
            JaxGPTConfig.tiny()).init_params(jax.random.PRNGKey(3)))
    return _INIT["tree"]


def _jax_fit(tmp_path, megastep, accum, num_batches, epochs):
    m = JaxGPT(JaxGPTConfig.tiny())
    m.initial_params = _init_tree()
    hooks = _recorder(JaxCallback)
    tr = JaxTrainer(strategy=JaxLocalStrategy(megastep=megastep),
                    max_epochs=epochs, limit_val_batches=0,
                    accumulate_grad_batches=accum,
                    enable_checkpointing=False,
                    default_root_dir=str(tmp_path), callbacks=[hooks])
    tr.fit(m, JaxSyntheticLM(JaxGPTConfig.tiny(), batch_size=8,
                             num_batches=num_batches, seed=4))
    return tr, hooks


def _port_fit(megastep, accum, num_batches, epochs):
    cfg = GPTConfig.tiny()
    m = GPT(cfg, device="cpu")
    m.initial_params = params_from_jax(_init_tree(), "cpu")
    hooks = _recorder(Callback)
    tr = Trainer(LocalStrategy(device="cpu", megastep=megastep),
                 max_epochs=epochs, limit_val_batches=0,
                 accumulate_grad_batches=accum, callbacks=[hooks],
                 enable_checkpointing=False)
    tr.fit(m, SyntheticLMDataModule(cfg, batch_size=8,
                                    num_batches=num_batches, seed=4))
    return tr, hooks


def _same_fit(port, jt, port_hooks, jax_hooks):
    """Counters, hook calls, losses, epoch means and params alike."""
    assert (port.global_step, port.micro_step) == (jt.global_step,
                                                   jt.micro_step)
    assert [i for i, _ in port_hooks.batches] == [
        i for i, _ in jax_hooks.batches]
    assert port_hooks.flushes == jax_hooks.flushes
    np.testing.assert_allclose([x for _, x in port_hooks.batches],
                               [x for _, x in jax_hooks.batches],
                               rtol=0, atol=TOL)
    for key in ("train_loss", "loss"):
        assert port.callback_metrics[key] == pytest.approx(
            jt.callback_metrics[key], abs=TOL)
    assert set(port.callback_metrics) == set(jt.callback_metrics)
    want, got = _flat_j(jt.state.params), _flat_t(port.state.params)
    assert set(want) == set(got)
    for k in want:
        assert float(np.abs(got[k] - want[k]).max()) < TOL, k


def test_megastep_fit_matches_the_jax_megastep_fit(tmp_path):
    """megastep=4 over 10 micro-batches: strides at 0-3 and 4-7, then
    singles 8 and 9 (the partial stride); one hook call per stride."""
    jt, jh = _jax_fit(tmp_path, 4, 1, 10, 1)
    tr, th = _port_fit(4, 1, 10, 1)
    assert [i for i, _ in th.batches] == [3, 7, 8, 9]
    assert tr.telemetry_report["meta"]["megastep"] == 4
    _same_fit(tr, jt, th, jh)


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms for the test: on the CPU the
    embedding's backward (an accumulating ``index_put_``) otherwise sums
    ``wte``'s gradient in a thread-dependent order, so two runs of one
    per-step fit differ in the last bit."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_megastep_fit_is_bitwise_the_per_step_fit(deterministic):
    tr4, h4 = _port_fit(4, 1, 10, 1)
    tr1, h1 = _port_fit("off", 1, 10, 1)
    assert tr1.telemetry_report["meta"]["megastep"] == 1
    assert (tr4.global_step, tr4.micro_step) == (10, 10)
    per_step = dict(h1.batches)
    assert all(per_step[i] == x for i, x in h4.batches)
    a, b = _flat_t(tr4.state.params), _flat_t(tr1.state.params)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    opt4, opt1 = tr4.state.opt_state[1], tr1.state.opt_state[1]
    assert int(opt4["count"]) == int(opt1["count"]) == 10


@pytest.mark.parametrize("accum", [2, 3])
def test_accumulation_matches_the_jax_fit(tmp_path, deterministic, accum):
    """7 micro-batches a epoch for 2 epochs: each epoch ends in a partial
    window (7 % accum != 0), flushed as an optimizer step.  megastep=4
    against the JAX megastep=4 fit (a stride, then singles); the port's
    per-step fit against its megastep fit, bitwise (the JAX package's own
    tests hold its per-step fit to its megastep fit)."""
    jt, jh = _jax_fit(tmp_path, 4, accum, 7, 2)
    tr, th = _port_fit(4, accum, 7, 2)
    assert tr.micro_step == 14
    assert tr.global_step == 2 * (7 // accum + 1)
    assert len(th.flushes) == 2
    _same_fit(tr, jt, th, jh)
    t1, h1 = _port_fit("off", accum, 7, 2)
    assert (t1.global_step, t1.micro_step) == (tr.global_step, tr.micro_step)
    assert h1.flushes == th.flushes
    per_step = {}
    for i, x in h1.batches:
        per_step.setdefault(i, []).append(x)
    strided = {}
    for i, x in th.batches:
        strided.setdefault(i, []).append(x)
    assert all(per_step[i] == xs for i, xs in strided.items())
    a, b = _flat_t(tr.state.params), _flat_t(t1.state.params)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


_MEGASTEP_VALUES = [None, "auto", "off", "", " AUTO ", 1, 4, "8", " 3 ",
                    0, -2, "x", 2.5, True, "0"]


@pytest.mark.parametrize("value", _MEGASTEP_VALUES)
def test_normalize_megastep_agrees_with_jax(value):
    def outcome(fn):
        try:
            return ("ok", fn(value))
        except (TypeError, ValueError) as e:
            return (type(e).__name__, None)

    assert outcome(_normalize_megastep) == outcome(jloop._normalize_megastep)


@pytest.mark.parametrize("env", [None, "", "off", "auto", "4", "16"])
@pytest.mark.parametrize("value", [None, "auto", "off", 2, "6"])
def test_resolve_megastep_agrees_with_jax(monkeypatch, env, value):
    """The knob, then ``RLT_MEGASTEP`` (set, or set but empty), then
    auto; on the CPU auto is off in both packages."""
    if env is None:
        monkeypatch.delenv("RLT_MEGASTEP", raising=False)
    else:
        monkeypatch.setenv("RLT_MEGASTEP", env)
    got = _resolve_megastep(FitConfig(megastep=value), torch.device("cpu"))
    assert got == jloop._resolve_megastep(jloop.FitConfig(megastep=value))


def _stream(shapes):
    return [np.full(s, i, np.int32) for i, s in enumerate(shapes)]


@pytest.mark.parametrize("shapes,stack,limit", [
    ([(2, 3)] * 10, 4, None),             # two strides, a tail of 2
    ([(2, 3)] * 10, 4, 4),                # the limit allows one stride
    ([(2, 3)] * 3 + [(1, 3)] + [(2, 3)] * 5, 4, None),  # a ragged batch
    ([(2, 3)] * 8, 1, None),              # megastep off
    ([(2, 3)] * 9, 3, 6),
])
def test_strides_group_as_the_jax_loop_groups(shapes, stack, limit):
    def ids(groups):
        return [(kind, [int(b.flat[0]) for b in
                        (item if kind == "stride" else [item])])
                for kind, item in groups]

    assert ids(_grouped(_stream(shapes), stack, limit)) == ids(
        jloop._grouped(_stream(shapes), stack, limit))
