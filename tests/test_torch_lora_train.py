"""LoRA fine-tuning in the port held against the JAX package (CPU, f32):
the counterparts of ``tests/test_lora.py``.

Adapters on qkv and proj, the base frozen: its leaves get no gradient
(``GPT.trainable``), the optimizer zeroes their updates before the clip
and holds moments for the adapters alone.  Tolerances: forward logits
1e-5 absolute against JAX (the merged form 2e-5, as the JAX test holds
it); a five-step fit's loss and adapters within 1e-5 of the JAX fit's;
the base bitwise unchanged; the optimizer fed the same gradients 1e-6
of the update's scale; checkpoint streams byte-identical.  Launches are
the counted wrappers' (their plain versions on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.module import TrainState as JaxTrainState
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.models.gpt import (
    SyntheticLMDataModule as JaxSyntheticLM,
)
from ray_lightning_tpu.parallel.strategies import (
    LocalStrategy as JaxLocalStrategy,
)
from ray_lightning_tpu.utils import state_stream as jss
from ray_lightning_tpu_torch.core.module import TrainState
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models import optim as topt
from ray_lightning_tpu_torch.models.convert import (
    params_from_jax, train_state_from_jax, train_state_to_jax,
)
from ray_lightning_tpu_torch.models.generate import generate
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, SyntheticLMDataModule, add_lora_adapters, merge_lora,
)
from ray_lightning_tpu_torch.ops import cross_entropy as tce
from ray_lightning_tpu_torch.ops import flash_attention as tfa
from ray_lightning_tpu_torch.ops import layer_norm as tln
from ray_lightning_tpu_torch.parallel.step_fns import loss_and_grads
from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy
from ray_lightning_tpu_torch.utils import state_stream as ss

TOL = 1e-5
LORA = dict(vocab_size=512, n_layer=2, n_head=4, d_model=128, seq_len=128,
            warmup_steps=0, lr=1e-2, lora_rank=4)
ADAPTERS = ("lora_qkv_a", "lora_qkv_b", "lora_proj_a", "lora_proj_b")


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: under the suite's parallel workers torch's own
    threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_tree(cfg_kw=LORA, seed=0, b_scale=0.0):
    """JAX init params (adapters included), B factors random when
    ``b_scale`` > 0."""
    tree = _np(JaxGPT(JaxGPTConfig(**cfg_kw)).init_params(
        jax.random.PRNGKey(seed)))
    if b_scale:
        rng = np.random.default_rng(seed + 1)
        for k in ("lora_qkv_b", "lora_proj_b"):
            tree["blocks"][k] = (rng.standard_normal(
                tree["blocks"][k].shape) * b_scale).astype(np.float32)
    return tree


def _tokens(cfg_kw, shape=(2, 16), seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg_kw["vocab_size"], shape).astype(np.int32)


def _by_path(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _by_path(v, f"{path}['{k}']").items()}
    return {path: tree}


def _f32(t):
    return np.asarray(t.detach().float().cpu() if isinstance(
        t, torch.Tensor) else t, np.float32)


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

def test_lora_starts_identical_to_base():
    """B = 0: the adapted forward equals the base forward on the same
    base weights bitwise, and the JAX package's within 1e-5."""
    tree = _jax_tree()
    base = {**tree, "blocks": {k: v for k, v in tree["blocks"].items()
                               if not k.startswith("lora_")}}
    tokens = torch.from_numpy(_tokens(LORA))
    lora_m = GPT(GPTConfig(**LORA), device="cpu")
    base_m = GPT(GPTConfig(**{**LORA, "lora_rank": 0}), device="cpu")
    with torch.no_grad():
        out_l = lora_m.forward(params_from_jax(tree, "cpu"), tokens)
        out_b = base_m.forward(params_from_jax(base, "cpu"), tokens)
    assert torch.equal(out_l, out_b)
    want = JaxGPT(JaxGPTConfig(**LORA)).forward(tree, jnp.asarray(
        tokens.numpy()))
    np.testing.assert_allclose(out_l.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_adapter_forward_matches_jax_and_merge_reproduces_it(precision):
    """Non-zero B: the adapter terms equal the JAX ``forward`` (f32 1e-5;
    bf16, where both round the products to bf16, 2e-2 absolute on logits
    of O(1)), and ``merge_lora`` reproduces the adapter logits (2e-5, the
    JAX test's rule)."""
    tree = _jax_tree(b_scale=0.3)
    cfg = GPTConfig(**LORA)
    tokens = torch.from_numpy(_tokens(LORA))
    m = GPT(cfg, device="cpu", precision=precision)
    jm = JaxGPT(JaxGPTConfig(**LORA))
    jm.precision = precision
    with torch.no_grad():
        out = m.forward(params_from_jax(tree, "cpu"), tokens)
    want = np.asarray(jm.forward(tree, jnp.asarray(tokens.numpy())))
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=TOL if precision == "f32" else 2e-2)
    if precision != "f32":
        return
    merged = merge_lora(params_from_jax(tree, "cpu"), cfg)
    assert not any(k.startswith("lora_") for k in merged["blocks"])
    with torch.no_grad():
        out_merged = GPT(GPTConfig(**{**LORA, "lora_rank": 0}),
                         device="cpu").forward(merged, tokens)
    np.testing.assert_allclose(out_merged.numpy(), out.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_lora_rejects_moe_and_generate_rejects_unmerged_adapters():
    with pytest.raises(ValueError, match="lora"):
        GPT(GPTConfig(**{**LORA, "n_experts": 2}), device="cpu")
    cfg = GPTConfig(**LORA)
    m = GPT(cfg, device="cpu")
    params = m.init_params()
    with pytest.raises(ValueError, match="merge_lora"):
        generate(m, params, torch.ones(1, 4, dtype=torch.int32),
                 max_new_tokens=2, device="cpu")
    out = generate(GPT(GPTConfig(**{**LORA, "lora_rank": 0}), device="cpu"),
                   merge_lora(params, cfg),
                   torch.ones(1, 4, dtype=torch.int32), max_new_tokens=2,
                   device="cpu")
    assert tuple(out.shape) == (1, 6)
    with pytest.raises(ValueError, match="already contain"):
        add_lora_adapters(params, cfg, torch.Generator().manual_seed(1))


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

def _moments(state):
    return state[2]["train"]


def test_lora_base_has_no_optimizer_moments():
    """Moments for the four adapter tensors alone; the structure of the
    port's state, written as JAX's tree, is the tree JAX builds."""
    cfg = GPTConfig(**LORA)
    params = GPT(cfg, device="cpu").init_params()
    state = GPT(cfg, device="cpu").configure_optimizers().init(params)
    adapter_elems = cfg.n_layer * (2 * cfg.d_model * cfg.lora_rank
                                   + cfg.lora_rank * 3 * cfg.d_model
                                   + cfg.lora_rank * cfg.d_model)
    mu = topt.tree_leaves(_moments(state)["mu"])
    assert sum(t.numel() for t in mu) == adapter_elems
    assert topt.moment_bytes(state) == adapter_elems * (2 + 4)
    jm = JaxGPT(JaxGPTConfig(**LORA))
    theirs = JaxTrainState.create(_jax_tree(), jm.configure_optimizers())
    got = jss.load_state_stream(bytes(ss.to_state_stream(
        {"state": train_state_to_jax(TrainState(params, state))})))
    assert (jax.tree_util.tree_structure(got["state"])
            == jax.tree_util.tree_structure(theirs))


def test_clip_sees_adapter_norm_only():
    """Forged gradients, the base's 1e6 and the adapters' 1e-4: base
    updates are zero, adapter updates a full first step (the clip saw the
    adapters' norm alone); the updates equal the JAX optimizer's."""
    tree = _jax_tree()
    grads = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full_like(
            leaf, 1e-4 if str(getattr(path[-1], "key", "")).startswith(
                "lora_") else 1e6), tree)
    jtx = JaxGPT(JaxGPTConfig(**LORA)).configure_optimizers()
    ju, _ = jax.jit(jtx.update)(grads, jtx.init(tree), tree)
    tx = GPT(GPTConfig(**LORA), device="cpu").configure_optimizers()
    params = params_from_jax(tree, "cpu")
    tu, _ = tx.update(params_from_jax(grads, "cpu"), tx.init(params), params)
    assert float(tu["blocks"]["qkv_w"].abs().max()) == 0.0
    assert float(tu["blocks"]["lora_qkv_a"].abs().max()) > 1e-3
    want, got = _by_path(_np(ju)), _by_path(tu)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(_f32(got[k]), want[k], rtol=0,
                                   atol=1e-6 * max(np.abs(want[k]).max(),
                                                   1e-30))
    # The clip over the full model instead (the frozen gradients not
    # zeroed first) scales the adapters' update down to ~0.
    full = topt.chain(topt.clip_by_global_norm(1.0), topt.gpt_adamw(
        GPTConfig(**LORA)))
    fu, _ = full.update(params_from_jax(grads, "cpu"), full.init(params),
                        params)
    assert float(fu["blocks"]["lora_qkv_a"].abs().max()) < 1e-6


# ---------------------------------------------------------------------------
# Fits
# ---------------------------------------------------------------------------

STEPS = 5
# The family's default lr: at the 1e-2 of the other tests, Adam's first
# steps (~lr·sign(g)) turn the f32 backward's ~1e-7 differences in a
# near-zero gradient into ~5e-5 moves of that element.
FIT = {**LORA, "lr": 3e-4}


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("lora")
    tree = _jax_tree()
    jcfg = JaxGPTConfig(**FIT)
    jm = JaxGPT(jcfg)
    jm.initial_params = tree
    jt = JaxTrainer(strategy=JaxLocalStrategy(), max_steps=STEPS,
                    limit_val_batches=2, enable_checkpointing=False,
                    default_root_dir=str(root / "j"))
    jt.fit(jm, JaxSyntheticLM(jcfg, batch_size=8, num_batches=STEPS,
                              seed=4))
    cfg = GPTConfig(**FIT)
    tm = GPT(cfg, device="cpu")
    tm.initial_params = params_from_jax(tree, "cpu")
    tr = Trainer(LocalStrategy(device="cpu"), max_steps=STEPS,
                 limit_val_batches=2, enable_checkpointing=False,
                 default_root_dir=str(root / "p"))
    tr.fit(tm, SyntheticLMDataModule(cfg, batch_size=8, num_batches=STEPS,
                                     seed=4))
    return tree, jt, tr, tm


def test_lora_trains_only_adapters_and_matches_the_jax_fit(fits):
    """Five steps from the same params and batches: the base bitwise the
    starting tree in both packages, every adapter B moved, loss and
    adapters within 1e-5 of the JAX fit's, the validation loss (on the
    tree that still has its adapters) within 1e-5."""
    tree, jt, tr, _ = fits
    assert tr.global_step == jt.global_step == STEPS
    start, got, want = _by_path(tree), _by_path(tr.state.params), _by_path(
        _np(jt.state.params))
    for k in start:
        if any(a in k for a in ADAPTERS):
            np.testing.assert_allclose(_f32(got[k]), want[k], rtol=0,
                                       atol=TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(_f32(got[k]), start[k], err_msg=k)
            np.testing.assert_array_equal(want[k], start[k], err_msg=k)
    for k in ("lora_qkv_b", "lora_proj_b"):
        assert float(tr.state.params["blocks"][k].abs().max()) > 0, k
    for key in ("train_loss", "val_loss"):
        assert tr.callback_metrics[key] == pytest.approx(
            jt.callback_metrics[key], abs=TOL), key


def test_validate_runs_on_the_adapted_tree(fits):
    """``Trainer.validate`` on the fitted tree, adapters unmerged, in
    each package: within 1e-5."""
    _, jt, tr, tm = fits
    dm = SyntheticLMDataModule(GPTConfig(**FIT), batch_size=8,
                               num_batches=2, seed=9)
    got = tr.validate(tm, dm)
    want = jt.validate(JaxGPT(JaxGPTConfig(**FIT)), JaxSyntheticLM(
        JaxGPTConfig(**FIT), batch_size=8, num_batches=2, seed=9))
    assert got["val_loss"] == pytest.approx(want["val_loss"], abs=TOL)


def test_lora_checkpoint_round_trips_bytewise(fits, tmp_path):
    """The fitted JAX LoRA state: its stream read and written back by the
    port is byte-identical; the port's state written as JAX's tree has
    JAX's treedef and the JAX package resumes it."""
    _, jt, tr, _ = fits
    payload = {"state": jt.state, "epoch": 0, "global_step": STEPS,
               "micro_step": STEPS, "callback_metrics": {"x": 1.0}}
    stream = jss.to_state_stream(payload)
    loaded = ss.load_state_stream(stream)
    again = dict(loaded, state=train_state_to_jax(
        train_state_from_jax(loaded["state"])))
    assert bytes(ss.to_state_stream(again)) == stream
    mine = jss.load_state_stream(bytes(ss.to_state_stream(
        dict(payload, state=train_state_to_jax(tr.state)))))
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(_np(payload)))


# ---------------------------------------------------------------------------
# Launches: the frozen base computes no weight gradient
# ---------------------------------------------------------------------------

# Each kernel's plain version, which its wrapper runs on CPU tensors: a
# call here is a launch on the card.
PLAIN = {"ln_fwd": (tln, "ln_fwd_plain"), "ln_bwd": (tln, "ln_bwd_plain"),
         "flash_fwd": (tfa, "flash_fwd_plain"),
         "flash_bwd": (tfa, "flash_bwd_plain"),
         "ce_fwd": (tce, "ce_fwd_plain"), "ce_bwd_dx": (tce, "ce_bwd_dx_plain"),
         "ce_bwd_dw": (tce, "ce_bwd_dw_plain")}


@pytest.mark.parametrize("lora", [True, False])
def test_ce_dw_never_launches_under_lora(lora, monkeypatch):
    """Per step at a kernel-route width (d 256, head_dim 64): CE fwd 1, dx
    1, dW 0 under LoRA (1 without); LN fwd 2L+1 and flash fwd/bwd L each;
    LN bwd 2L under LoRA (layer 0's ln1 sees no input that needs a
    gradient), 2L+1 without.  The frozen leaves' gradients are known
    zeros."""
    calls = dict.fromkeys(PLAIN, 0)
    for name, (mod, attr) in PLAIN.items():
        real = getattr(mod, attr)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(mod, attr, counted)
    kw = dict(vocab_size=512, n_layer=2, n_head=4, d_model=256, seq_len=128,
              lora_rank=4 if lora else 0)
    cfg = GPTConfig(**kw)
    m = GPT(cfg, device="cpu")
    params = m.init_params()
    tokens = torch.from_numpy(_tokens(kw, (2, 129)))
    steps = 2
    for _ in range(steps):
        grads, _ = loss_and_grads(m, params, {"tokens": tokens}, None)
    L = cfg.n_layer
    want = {"ln_fwd": 2 * L + 1, "ln_bwd": 2 * L if lora else 2 * L + 1,
            "flash_fwd": L, "flash_bwd": L, "ce_fwd": 1, "ce_bwd_dx": 1,
            "ce_bwd_dw": 0 if lora else 1}
    assert {k: v / steps for k, v in calls.items()} == want
    for k, g in _by_path(grads).items():
        frozen = lora and not any(a in k for a in ADAPTERS)
        assert topt.is_known_zeros(g) == frozen, k


def test_scan_route_skips_dw_and_matches_the_kernel_route(monkeypatch):
    """``ce_kernel=False`` (the vocab-chunk scan): under LoRA its backward
    computes no dW products, and the adapters' gradients equal the kernel
    route's within 1e-5."""
    kw = dict(vocab_size=512, n_layer=2, n_head=4, d_model=256, seq_len=128,
              lora_rank=4)
    cfg = GPTConfig(**kw)
    asked = []
    real = tce._ce_bwd

    def spy(*args):
        asked.append(args[-1])
        return real(*args)

    monkeypatch.setattr(tce, "_ce_bwd", spy)
    tree = _jax_tree(kw, b_scale=0.1)
    batch = {"tokens": torch.from_numpy(_tokens(kw, (2, 129)))}
    g_scan, _ = loss_and_grads(GPT(cfg, device="cpu", ce_kernel=False),
                               params_from_jax(tree, "cpu"), batch, None)
    g_kern, _ = loss_and_grads(GPT(cfg, device="cpu"),
                               params_from_jax(tree, "cpu"), batch, None)
    assert asked == [False]
    for k in ADAPTERS:
        np.testing.assert_allclose(_f32(g_scan["blocks"][k]),
                                   _f32(g_kern["blocks"][k]), rtol=0,
                                   atol=TOL, err_msg=k)
