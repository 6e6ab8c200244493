"""``attn_impl="auto"`` in the port routes by the JAX package's shape gate.

The JAX ``causal_attention`` takes its flash kernel only where
``_flash_supported`` admits the shape (some 128-multiple block divides S,
head_dim in 64/128/256) and the plain XLA attention elsewhere.  The port
keeps the same shape rule and nothing more: where the rule admits a shape
that the port's kernels do not take (head_dim 256, f16, mixed dtypes),
``"auto"`` still routes to flash, whose kernel check raises and names
``impl='xla'`` rather than giving way to the plain attention.  Tolerance
of the fit: loss 1e-5 absolute, as ``tests/test_torch_train.py`` holds its
five-step fit; of the plain flash pair against the plain attention on the
CPU, 1e-6 absolute (f32).
"""

import jax
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.models.gpt import (
    SyntheticLMDataModule as JaxSyntheticLM,
)
from ray_lightning_tpu.ops.flash_attention import (
    DEFAULT_BLOCK_Q as JAX_DEFAULT_BLOCK_Q,
)
from ray_lightning_tpu.ops.flash_attention import pick_block as jax_pick_block
from ray_lightning_tpu.parallel.strategies import (
    LocalStrategy as JaxLocalStrategy,
)
from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, SyntheticLMDataModule,
)
from ray_lightning_tpu_torch.ops import attention as tattn
from ray_lightning_tpu_torch.ops import flash_attention as tfa
from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy


@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("S", [64, 128, 192, 384, 640, 1024, 1152])
def test_auto_gate_is_the_jax_shape_rule_within_the_kernels(S, d):
    """The gate is the JAX rule; where it admits a shape the kernels do
    not take, the kernel check (run here on CPU tensors) raises."""
    jax_rule = jax_pick_block(S) is not None and d in (64, 128, 256)
    q = torch.zeros(2, S, 3, d)
    assert tattn.pick_block(S) == jax_pick_block(S)
    assert tattn.flash_supported(q) == jax_rule
    assert tattn.resolve_impl("auto", q) == ("flash" if jax_rule else "xla")
    assert tattn.resolve_impl("flash", q) == "flash"
    assert tattn.resolve_impl("xla", q) == "xla"
    if jax_rule and d not in tfa.KERNEL_HEAD_DIMS:
        with pytest.raises(ValueError, match="impl='xla'"):
            tfa._kernel_args(q, q, q, "flash_fwd")
    elif jax_rule:
        assert tfa._kernel_args(q, q, q, "flash_fwd")[0] == 0


def test_auto_gate_keeps_the_kernels_own_limits():
    """dtype and grid limits of the kernels are not part of the gate:
    "auto" sends such inputs to flash, whose kernel check raises and
    names the plain attention; on the CPU the plain flash pair computes
    them, as the plain attention does."""
    assert tattn.DEFAULT_BLOCK_Q == JAX_DEFAULT_BLOCK_Q
    ok = torch.zeros(1, 128, 2, 64)
    # B·H over the kernels' grid, without the memory: a broadcast view.
    wide = torch.zeros(64).expand(1, 128, 65536, 64)
    for q in (ok, ok.bfloat16(), ok.half(), wide):
        assert tattn.flash_supported(q)
        assert tattn.resolve_impl("auto", q) == "flash"
    for args in ((ok.half(),) * 3, (ok, ok, ok.bfloat16()),
                 (wide,) * 3):
        with pytest.raises(ValueError, match="impl='xla'"):
            tfa._kernel_args(*args, "flash_fwd")
    with pytest.raises(ValueError, match="Unknown attention impl"):
        tattn.resolve_impl("ring", ok)
    gen = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(gen.standard_normal((1, 128, 2, 256),
                                                    dtype=np.float32))
               for _ in range(3))
    got = tattn.causal_attention(q, k, v)
    want = tattn.xla_causal_attention(q, k, v)
    assert torch.allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_args_take_head_dim_256(dtype):
    """The kernels take head_dim 256 in f32 and bf16 (the JAX gate's
    largest head_dim), and still refuse f16, mixed dtypes and B·H over
    the grid there, naming the plain attention."""
    q = torch.zeros(1, 128, 2, 256, dtype=dtype)
    code, strides = tfa._kernel_args(q, q, q, "flash_fwd")
    assert code == (0 if dtype == torch.float32 else 1)
    assert strides == q.stride()[:3] * 3
    wide = torch.zeros(256, dtype=dtype).expand(1, 128, 65536, 256)
    for args in ((q.half(),) * 3, (q, q, q.to(torch.float64)),
                 (q, q.half(), q), (wide,) * 3):
        with pytest.raises(ValueError, match="impl='xla'"):
            tfa._kernel_args(*args, "flash_fwd")


class _Losses(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        self.losses.append(float(logs["train_loss"]))


def test_tiny_fit_routes_to_plain_attention_and_matches_jax(tmp_path,
                                                             monkeypatch):
    """GPTConfig.tiny() has head_dim 32, which the JAX gate sends to its
    XLA attention: the port's "auto" fit must not reach the flash wrapper
    at all, and its three losses match the JAX fit's."""
    jcfg = JaxGPTConfig.tiny()
    jm = JaxGPT(jcfg)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(5)))
    jm.initial_params = tree
    jt = JaxTrainer(strategy=JaxLocalStrategy(), max_steps=3,
                    limit_val_batches=0, enable_checkpointing=False,
                    default_root_dir=str(tmp_path))
    jt.fit(jm, JaxSyntheticLM(jcfg, batch_size=8, num_batches=3, seed=6))

    calls = []
    real = tfa.flash_fwd
    monkeypatch.setattr(tfa, "flash_fwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = GPTConfig.tiny()
    assert cfg.head_dim == 32
    tm = GPT(cfg, device="cpu")
    tm.initial_params = params_from_jax(tree, "cpu")
    cb = _Losses()
    tr = Trainer(LocalStrategy(device="cpu"), max_steps=3,
                 limit_val_batches=0, callbacks=[cb],
                 enable_checkpointing=False)
    tr.fit(tm, SyntheticLMDataModule(cfg, batch_size=8, num_batches=3,
                                     seed=6))
    assert calls == [] and tfa.flash_fwd is not real
    assert tr.global_step == jt.global_step == 3 and len(cb.losses) == 3
    assert tr.callback_metrics["train_loss"] == pytest.approx(
        jt.callback_metrics["train_loss"], abs=1e-5)
