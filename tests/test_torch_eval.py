"""``Trainer.validate``, ``test`` and ``predict`` of the port held against
the JAX package's from one JAX checkpoint (CPU, f32, ``GPTConfig.tiny()``).

Tolerances: ``val_loss`` within 1e-6 relative (the same f32 forward in
another order of sums); predictions equal except where the top-2 logit
gap is below 1e-4, the serving gate, where f32 rounding may pick either
token.
"""

import os

import jax
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.callbacks import (
    ModelCheckpoint as JaxModelCheckpoint,
)
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.models.gpt import (
    SyntheticLMDataModule as JaxSyntheticLM,
)
from ray_lightning_tpu.parallel.strategies import (
    LocalStrategy as JaxLocalStrategy,
)
from ray_lightning_tpu_torch.core.data import TpuDataModule
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, SyntheticLMDataModule,
)
from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy
from ray_lightning_tpu_torch.utils import state_stream as ss

GAP = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny fits here run on one CPU thread: under the suite's
    parallel workers, torch's threads per worker oversubscribe the cores
    and a fit that takes a second alone takes minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_test_loader(base):
    class WithTest(base):
        def test_dataloader(self):
            return self._loader()

    return WithTest


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX fit of 2 steps and its checkpoint file."""
    root = tmp_path_factory.mktemp("jax")
    m = JaxGPT(JaxGPTConfig.tiny())
    m.initial_params = jax.tree.map(np.asarray, m.init_params(
        jax.random.PRNGKey(3)))
    jt = JaxTrainer(strategy=JaxLocalStrategy(), max_epochs=1,
                    limit_val_batches=0, default_root_dir=str(root),
                    callbacks=[JaxModelCheckpoint(monitor=None)])
    jt.fit(m, JaxSyntheticLM(JaxGPTConfig.tiny(), batch_size=8,
                             num_batches=2, seed=1))
    return jt, jt.best_model_path


def _dm(jax_side: bool, cls=None):
    base = cls or (JaxSyntheticLM if jax_side else SyntheticLMDataModule)
    cfg = JaxGPTConfig.tiny() if jax_side else GPTConfig.tiny()
    return base(cfg, batch_size=8, num_batches=3, seed=7)


def _port_trainer(tmp_path):
    return Trainer(LocalStrategy(device="cpu"), default_root_dir=str(
        tmp_path), enable_checkpointing=False)


def test_validate_and_test_from_a_jax_checkpoint(jax_ckpt, tmp_path):
    _, path = jax_ckpt
    jt = JaxTrainer(strategy=JaxLocalStrategy(), enable_checkpointing=False,
                    default_root_dir=str(tmp_path))
    want_val = jt.validate(JaxGPT(JaxGPTConfig.tiny()), _dm(True),
                           ckpt_path=path)
    want_test = jt.test(JaxGPT(JaxGPTConfig.tiny()),
                        _dm(True, _with_test_loader(JaxSyntheticLM)),
                        ckpt_path=path)
    tr = _port_trainer(tmp_path)
    got_val = tr.validate(GPT(GPTConfig.tiny(), device="cpu"), _dm(False),
                          ckpt_path=path)
    got_test = tr.test(GPT(GPTConfig.tiny(), device="cpu"),
                       _dm(False, _with_test_loader(SyntheticLMDataModule)),
                       ckpt_path=path)
    for got, want in ((got_val, want_val), (got_test, want_test)):
        assert set(got) == set(want) == {"val_loss", "val_ppl"}
        assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-6)
        assert got["val_ppl"] == pytest.approx(want["val_ppl"], rel=1e-5)
    assert tr.callback_metrics["val_loss"] == got_test["val_loss"]


def test_predict_from_a_jax_checkpoint_falls_back_to_the_test_loader(
        jax_ckpt, tmp_path):
    jt, path = jax_ckpt
    want = JaxTrainer(strategy=JaxLocalStrategy(), enable_checkpointing=False,
                      default_root_dir=str(tmp_path)).predict(
        JaxGPT(JaxGPTConfig.tiny()),
        _dm(True, _with_test_loader(JaxSyntheticLM)), ckpt_path=path)
    module = GPT(GPTConfig.tiny(), device="cpu")
    dm = _dm(False, _with_test_loader(SyntheticLMDataModule))
    got = _port_trainer(tmp_path).predict(module, dm, ckpt_path=path)
    assert got.dtype == np.int32 and got.shape == want.shape == (24, 128)
    # Rows agree except where the two best logits are within GAP.
    dm.setup("predict")
    tokens = torch.from_numpy(np.concatenate(
        [b["tokens"] for b in dm.test_dataloader()]))
    params = params_from_jax(jax.tree.map(np.asarray, jt.state.params),
                             "cpu")
    with torch.no_grad():
        top2 = torch.topk(module.forward(params, tokens[:, :-1]), 2).values
    close = (top2[..., 0] - top2[..., 1]).numpy() < GAP
    assert np.array_equal(got[~close], np.asarray(want)[~close])
    assert close.mean() < 0.05


def test_predict_without_a_loader_raises_as_jax_does(tmp_path):
    class NoLoaders(TpuDataModule):
        pass

    from ray_lightning_tpu.core.data import TpuDataModule as JaxDataModule

    class JaxNoLoaders(JaxDataModule):
        pass

    with pytest.raises(ValueError) as want:
        JaxTrainer(strategy=JaxLocalStrategy(), enable_checkpointing=False,
                   default_root_dir=str(tmp_path)).predict(
            JaxGPT(JaxGPTConfig.tiny()), JaxNoLoaders())
    with pytest.raises(ValueError) as got:
        _port_trainer(tmp_path).predict(GPT(GPTConfig.tiny(), device="cpu"),
                                        NoLoaders())
    assert str(got.value) == str(want.value) == (
        "datamodule provides no predict/test dataloader")
    with pytest.raises(ValueError, match="no test dataloader"):
        _port_trainer(tmp_path).test(GPT(GPTConfig.tiny(), device="cpu"),
                                     NoLoaders())


def test_validate_after_fit_uses_the_fitted_state(tmp_path):
    cfg = GPTConfig.tiny()
    module = GPT(cfg, device="cpu")
    tr = Trainer(LocalStrategy(device="cpu"), max_epochs=1,
                 default_root_dir=str(tmp_path))
    tr.fit(module, _dm(False))
    fitted = tr.callback_metrics["val_loss"]
    assert tr.validate(module, _dm(False))["val_loss"] == fitted
    # From the file the fit wrote: the same state.
    assert os.path.basename(tr.best_model_path) == "epoch=0-step=3.ckpt"
    from_file = tr.validate(module, _dm(False), ckpt_path=tr.best_model_path)
    assert from_file["val_loss"] == fitted
    # A trainer that never fitted evaluates the seed's init.
    fresh = _port_trainer(tmp_path).validate(module, _dm(False))
    assert fresh["val_loss"] != fitted
    # save_checkpoint writes the JAX Trainer's payload (no micro_step).
    path = str(tmp_path / "saved" / "final.ckpt")
    tr.save_checkpoint(path)
    payload = ss.load_state_stream(ss.state_stream_from_file(path))
    assert (payload["epoch"], payload["global_step"]) == (0, 3)
    assert "micro_step" not in payload
    assert tr.validate(module, _dm(False), ckpt_path=path)[
        "val_loss"] == fitted
