"""The port's speculative decoding held against the JAX package (CPU, f32).

One JAX GPT at test size (3 layers, block matrices scaled up so greedy
streams vary) converted leaf for leaf into the port, with three rank-4
LoRA tenants made with numpy.  ``paged_verify_step`` is compared with the
JAX function on the same numpy pool, tables, window and adapter buffers
(logits and pool contents within 1e-5: f32 sums in another order through
three layers); the draft helpers' trees with JAX's bit for bit (the
identity tail's fresh weights are torch's draws, as ``init_params``'s);
the engine's greedy streams under ``spec_k`` with the JAX
``ServeEngine(spec_k=...)``'s and ``generate()``'s on each tenant's merged
weights, token for token; its sampled streams with the same requests
served without speculation; and every refusal with the JAX engine's.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.serve import draft as jdraft
from ray_lightning_tpu.serve.engine import ServeConfig as JaxServeConfig
from ray_lightning_tpu.serve.engine import ServeEngine as JaxServeEngine
from ray_lightning_tpu_torch.models.convert import (
    adapter_from_jax, params_from_jax,
)
from ray_lightning_tpu_torch.models.generate import generate, prefill
from ray_lightning_tpu_torch.models.generate import init_kv_cache
from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig, merge_lora
from ray_lightning_tpu_torch.serve import draft
from ray_lightning_tpu_torch.serve.engine import ServeConfig, ServeEngine
from ray_lightning_tpu_torch.serve.kv_cache import (
    BlockAllocator, extend_block_coverage, paged_verify_step, truncate_to,
)
from ray_lightning_tpu_torch.serve.scheduler import Request, Scheduler

jkv = importlib.import_module("ray_lightning_tpu.serve.kv_cache")

CFG = dict(vocab_size=128, n_layer=3, n_head=4, d_model=64, seq_len=96)
RANK = 4
TENANTS = ("t0", "t1", "t2")
REQUESTS = [(5, "t0"), (9, None), (12, "t1"), (3, "t2"), (17, "t0"),
            (8, None)]
NEW = 12


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _prompt(seed, length):
    rng = np.random.default_rng(seed)
    return rng.integers(1, CFG["vocab_size"], size=(length,)).tolist()


@pytest.fixture(scope="module")
def world():
    jm = JaxGPT(JaxGPTConfig(**CFG, warmup_steps=1), attn_impl="xla")
    tree = _np_tree(jm.init_params(jax.random.PRNGKey(0)))
    for key in ("qkv_w", "proj_w", "mlp_in_w", "mlp_out_w"):
        tree["blocks"][key] = tree["blocks"][key] * 10.0
    tm = GPT(GPTConfig(**CFG), device="cpu")
    tp = params_from_jax(tree, "cpu")
    lora_cfg = dataclasses.replace(tm.config, lora_rank=RANK)
    L, d = CFG["n_layer"], CFG["d_model"]
    rng = np.random.default_rng(10)
    j_adapters, t_adapters, t_merged = {}, {}, {None: tp}
    for name in TENANTS:
        adapter = {
            "qkv_a": rng.standard_normal((L, d, RANK)) * 0.02,
            "qkv_b": rng.standard_normal((L, RANK, 3 * d)) * 0.3,
            "proj_a": rng.standard_normal((L, d, RANK)) * 0.02,
            "proj_b": rng.standard_normal((L, RANK, d)) * 0.3,
        }
        adapter = {k: v.astype(np.float32) for k, v in adapter.items()}
        adapter["scale"] = lora_cfg.lora_alpha / RANK
        j_adapters[name] = adapter
        t_adapters[name] = adapter_from_jax(adapter, "cpu")
        t_merged[name] = merge_lora({**tp, "blocks": {
            **tp["blocks"], **{f"lora_{k}": t_adapters[name][k]
                               for k in ("qkv_a", "qkv_b", "proj_a",
                                         "proj_b")}}}, lora_cfg)
    return dict(jm=jm, jp=jax.tree.map(jnp.asarray, tree), tm=tm, tp=tp,
                j_adapters=j_adapters, t_adapters=t_adapters,
                t_merged=t_merged)


def _stacked_buffers(world):
    L, d = CFG["n_layer"], CFG["d_model"]
    n1 = len(TENANTS) + 1
    bufs = {"qkv_a": np.zeros((L, n1, d, RANK), np.float32),
            "qkv_b": np.zeros((L, n1, RANK, 3 * d), np.float32),
            "proj_a": np.zeros((L, n1, d, RANK), np.float32),
            "proj_b": np.zeros((L, n1, RANK, d), np.float32)}
    for i, name in enumerate(TENANTS):
        ad = world["j_adapters"][name]
        for key in bufs:
            f = ad[key] * np.float32(ad["scale"]) if key.endswith("_b") \
                else ad[key]
            bufs[key][:, i + 1] = f
    return bufs


# ---------------------------------------------------------------------------
# Block arithmetic
# ---------------------------------------------------------------------------

def test_coverage_and_truncation_match_jax():
    """The same sequence of cover/truncate calls on both packages'
    allocators leaves the same blocks, tables and free lists."""
    states = []
    for pkg in ("jax", "port"):
        Alloc = jkv.BlockAllocator if pkg == "jax" else BlockAllocator
        ext = jkv.extend_block_coverage if pkg == "jax" \
            else extend_block_coverage
        trunc = jkv.truncate_to if pkg == "jax" else truncate_to
        a = Alloc(8)
        blocks, row = [], np.zeros((6,), np.int32)
        log = [ext(a, blocks, row, 9, 4), list(blocks), row.tolist()]
        log += [ext(a, blocks, row, 40, 4), list(blocks)]  # dry: nothing
        log += [trunc(a, blocks, row, 5, 4), list(blocks), row.tolist()]
        log += [trunc(a, blocks, row, 0, 4), list(blocks), a.free_blocks]
        states.append(log)
    assert states[0] == states[1]
    assert states[1][0] is True and states[1][3] is False


def test_scheduler_spec_bookkeeping():
    alloc = BlockAllocator(16)
    s = Scheduler(2, alloc, 4, 8, [4, 8, 16])
    s.submit(Request(rid="r", prompt=list(range(1, 7)), max_new_tokens=5,
                     spec=2))
    ((slot, req, bucket),), _ = s.poll()
    assert s.draft_lens[slot] == 6 and req.spec == 2
    assert s.needs_block(slot, upto_pos=8) and not s.needs_block(slot)
    assert s.cover(slot, 10) and len(s._blocks[slot]) == 3
    assert s.append_tokens(slot, [7, 8, 9]) == (3, False)
    assert s.append_tokens(slot, [10, 11, 12]) == (2, True)
    assert s.truncate_slot_to(slot, 7) == 1
    assert s.seq_lens[slot] == 7 and s.draft_lens[slot] == 6
    s.finish(slot)
    assert alloc.free_blocks == 15 and s.draft_lens[slot] == 0


# ---------------------------------------------------------------------------
# The verify step vs JAX
# ---------------------------------------------------------------------------

def test_paged_verify_step_matches_jax(world):
    cfg_j, cfg_t = world["jm"].config, world["tm"].config
    L, H, Dh = CFG["n_layer"], CFG["n_head"], 16
    rng = np.random.default_rng(7)
    pool = rng.standard_normal((L, 12, 8, H, Dh)).astype(np.float32)
    bufs = _stacked_buffers(world)
    # Slot 0: 13 cached, window 4 wide (limit 17); slot 1: 6 cached,
    # drafting 1 (limit 8, the rest trashed); slot 2 inactive; slot 3: 1
    # cached, its window crossing into block 5.
    tables = np.array([[3, 7, 10, 0], [4, 9, 0, 0], [0, 0, 0, 0],
                       [11, 5, 0, 0]], np.int32)
    seq_lens = np.array([13, 6, 0, 7], np.int32)
    window = rng.integers(1, CFG["vocab_size"], size=(4, 4)).astype(np.int32)
    limits = np.array([17, 8, 0, 11], np.int32)
    ad_ids = np.array([1, 0, 0, 3], np.int32)
    jl, jpool = jkv.paged_verify_step(
        cfg_j, world["jp"], {"k": jnp.asarray(pool), "v": jnp.asarray(pool)},
        jnp.asarray(tables), jnp.asarray(seq_lens), jnp.asarray(window),
        jnp.asarray(limits),
        adapters={k: jnp.asarray(v) for k, v in bufs.items()},
        adapter_ids=jnp.asarray(ad_ids),
    )
    tpool = {"k": torch.from_numpy(pool.copy()),
             "v": torch.from_numpy(pool.copy())}
    tl, tpool = paged_verify_step(
        cfg_t, world["tp"], tpool, torch.from_numpy(tables),
        torch.from_numpy(seq_lens), torch.from_numpy(window),
        torch.from_numpy(limits),
        adapters={k: torch.from_numpy(v) for k, v in bufs.items()},
        adapter_ids=torch.from_numpy(ad_ids),
    )
    assert tl.shape == (4, 4, CFG["vocab_size"])
    for slot, n in ((0, 4), (1, 2), (3, 4)):
        np.testing.assert_allclose(tl.numpy()[slot, :n],
                                   np.asarray(jl)[slot, :n],
                                   atol=1e-5, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(tpool[key].numpy()[:, 1:],
                                   np.asarray(jpool[key])[:, 1:],
                                   atol=1e-5, rtol=0)
    # head_at: the head at one window position, the same logits.
    tpool2 = {"k": torch.from_numpy(pool.copy()),
              "v": torch.from_numpy(pool.copy())}
    one, _ = paged_verify_step(
        cfg_t, world["tp"], tpool2, torch.from_numpy(tables),
        torch.from_numpy(seq_lens), torch.from_numpy(window),
        torch.from_numpy(limits),
        adapters={k: torch.from_numpy(v) for k, v in bufs.items()},
        adapter_ids=torch.from_numpy(ad_ids), head_at=2,
    )
    np.testing.assert_allclose(one.numpy(), tl.numpy()[:, 2], atol=1e-6,
                               rtol=0)


def test_verify_step_refuses_unprepared_params(world):
    """The step casts no weight: f32 params under a bf16 compute dtype
    are refused (``prepare_params`` casts them once)."""
    tp = world["tp"]
    pool = {k: torch.zeros(CFG["n_layer"], 4, 8, 4, 16) for k in "kv"}
    with pytest.raises(ValueError, match="prepare_params"):
        paged_verify_step(world["tm"].config, tp, pool,
                          torch.zeros(1, 2, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32),
                          torch.ones(1, 2, dtype=torch.int32),
                          torch.full((1,), 2), compute_dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# Draft helpers vs JAX
# ---------------------------------------------------------------------------

def test_early_exit_draft_is_jax_tree_and_views(world):
    jd, jdp = jdraft.early_exit_draft(world["jm"], world["jp"], 2)
    td, tdp = draft.early_exit_draft(world["tm"], world["tp"], 2)
    assert td.config == dataclasses.replace(world["tm"].config, n_layer=2)
    assert jd.config.n_layer == td.config.n_layer == 2
    want = _np_tree(jdp)
    for key, leaf in tdp["blocks"].items():
        np.testing.assert_array_equal(leaf.numpy(), want["blocks"][key])
        # A view of the target's stacked leaf, not a copy.
        assert leaf.data_ptr() == world["tp"]["blocks"][key].data_ptr()
    for key in ("wte", "wpe", "ln_f_g", "ln_f_b"):
        assert tdp[key] is world["tp"][key]
        np.testing.assert_array_equal(tdp[key].numpy(), want[key])
    for n in (0, CFG["n_layer"]):
        with pytest.raises(ValueError, match="n_layers"):
            draft.early_exit_draft(world["tm"], world["tp"], n)
        with pytest.raises(ValueError, match="n_layers"):
            jdraft.early_exit_draft(world["jm"], world["jp"], n)


def test_pad_identity_layers_matches_jax_and_is_identity(world):
    jt, jtp = jdraft.pad_identity_layers(world["jm"], world["jp"], 2)
    tt, ttp = draft.pad_identity_layers(world["tm"], world["tp"], 2)
    assert tt.config.n_layer == jt.config.n_layer == CFG["n_layer"] + 2
    want = _np_tree(jtp)
    L = CFG["n_layer"]
    for key, leaf in ttp["blocks"].items():
        assert leaf.shape == want["blocks"][key].shape, key
        # The head layers are the model's, bitwise.
        np.testing.assert_array_equal(leaf[:L].numpy(),
                                      want["blocks"][key][:L])
        if key in ("proj_w", "proj_b", "mlp_out_w", "mlp_out_b"):
            np.testing.assert_array_equal(leaf[L:].numpy(),
                                          want["blocks"][key][L:])
            assert not leaf[L:].any()
    # The target's logits are the model's, bitwise, in both packages.
    tokens = torch.tensor([_prompt(3, 9)])
    cache = init_kv_cache(world["tm"].config, 1, 9, device="cpu")
    base, _ = prefill(world["tm"].config, world["tp"], cache, tokens)
    cache = init_kv_cache(tt.config, 1, 9, device="cpu")
    deep, _ = prefill(tt.config, ttp, cache, tokens)
    assert torch.equal(base, deep)
    # noise > 0 perturbs the tail's residual-out leaves.
    _, noisy = draft.pad_identity_layers(world["tm"], world["tp"], 2,
                                         noise=0.1)
    assert noisy["blocks"]["proj_w"][L:].abs().max() > 0
    with pytest.raises(ValueError, match="n_extra"):
        draft.pad_identity_layers(world["tm"], world["tp"], 0)
    with pytest.raises(ValueError, match="n_extra"):
        jdraft.pad_identity_layers(world["jm"], world["jp"], 0)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _run(engine, reqs, **kw):
    handles = [engine.submit(_prompt(i, n), NEW, adapter=a, **kw)
               for i, (n, a) in enumerate(reqs)]
    engine.run_until_idle()
    return [h.result(0) if hasattr(h, "result") else None for h in handles]


@pytest.fixture(scope="module")
def jax_spec_tokens(world):
    """The JAX engine's greedy streams under spec_k=4 with a 1-layer
    early-exit draft, tenants and base mixed (computed once)."""
    jd, jdp = jdraft.early_exit_draft(world["jm"], world["jp"], 1)
    engine = JaxServeEngine(
        world["jm"], world["jp"],
        JaxServeConfig(num_slots=4, block_size=8, max_adapters=3,
                       adapter_rank=RANK, spec_k=4),
        draft_module=jd, draft_params=jdp, adapters=world["j_adapters"])
    handles = [engine.submit(_prompt(i, n), NEW, adapter=a)
               for i, (n, a) in enumerate(REQUESTS)]
    engine.run_until_idle()
    return [h.result() for h in handles], engine.snapshot()["counters"]


def _spec_engine(world, spec_k=4, n_draft=1, **kw):
    td, tdp = draft.early_exit_draft(world["tm"], world["tp"], n_draft)
    cfg = dict(num_slots=4, block_size=8, max_adapters=3, adapter_rank=RANK,
               spec_k=spec_k)
    cfg.update(kw)
    return ServeEngine(world["tm"], world["tp"], ServeConfig(**cfg),
                       adapters=world["t_adapters"], device="cpu",
                       draft_module=td, draft_params=tdp)


def test_greedy_spec_streams_equal_jax_engine_and_generate(
        world, jax_spec_tokens):
    want, jcounters = jax_spec_tokens
    engine = _spec_engine(world)
    got = _run(engine, REQUESTS)
    assert got == want
    c = engine.snapshot()["counters"]
    for key in ("spec_drafted", "spec_accepted", "spec_emitted",
                "spec_ticks", "verify_steps"):
        assert c[key] == jcounters[key], key
    assert c["spec_emitted"] > c["spec_ticks"] > 0
    for (n, name), tokens, i in zip(REQUESTS, got, range(len(REQUESTS))):
        prompt = _prompt(i, n)
        ref = generate(world["tm"], world["t_merged"][name], [prompt], NEW,
                       device="cpu")[0, len(prompt):].tolist()
        assert tokens == ref, name


def test_greedy_spec_without_tenants_equals_jax(world):
    reqs = [(n, None) for n, _ in REQUESTS]
    jd, jdp = jdraft.early_exit_draft(world["jm"], world["jp"], 2)
    jengine = JaxServeEngine(world["jm"], world["jp"],
                             JaxServeConfig(num_slots=3, block_size=8,
                                            spec_k=4),
                             draft_module=jd, draft_params=jdp)
    want = _run(jengine, reqs)
    td, tdp = draft.early_exit_draft(world["tm"], world["tp"], 2)
    engine = ServeEngine(world["tm"], world["tp"],
                         ServeConfig(num_slots=3, block_size=8, spec_k=4),
                         device="cpu", draft_module=td, draft_params=tdp)
    assert _run(engine, reqs) == want


def test_identity_tail_pair_accepts_everything(world):
    """Target = the model + 2 identity layers, draft = the model: every
    draft is accepted, and the streams are the model's own."""
    tt, ttp = draft.pad_identity_layers(world["tm"], world["tp"], 2)
    engine = ServeEngine(tt, ttp, ServeConfig(num_slots=4, block_size=8,
                                              spec_k=4),
                         device="cpu", draft_module=world["tm"],
                         draft_params=world["tp"])
    reqs = [(n, None) for n, _ in REQUESTS]
    got = _run(engine, reqs)
    c = engine.snapshot()["counters"]
    assert c["spec_accepted"] == c["spec_drafted"] > 0
    for (n, _), tokens, i in zip(reqs, got, range(len(reqs))):
        prompt = _prompt(i, n)
        assert tokens == generate(world["tm"], world["tp"], [prompt], NEW,
                                  device="cpu")[0, len(prompt):].tolist()


def test_sampled_spec_streams_equal_non_spec(world):
    """The draws are keyed by (request, position): sampled streams under
    speculation are the plain engine's, per-request ``spec=0`` too."""
    plain = ServeEngine(world["tm"], world["tp"],
                        ServeConfig(num_slots=4, block_size=8,
                                    max_adapters=3, adapter_rank=RANK),
                        adapters=world["t_adapters"], device="cpu")
    want = _run(plain, REQUESTS, temperature=0.8)
    engine = _spec_engine(world)
    assert _run(engine, REQUESTS, temperature=0.8) == want
    assert engine.snapshot()["counters"]["spec_ticks"] > 0
    engine = _spec_engine(world)
    assert _run(engine, REQUESTS, temperature=0.8, spec=0) == want
    assert engine.snapshot()["counters"].get("spec_ticks", 0) == 0


def test_spec_under_preemption_and_eos(world):
    """A pool too small for every window: windows shrink, the youngest is
    preempted for baseline coverage only, and the streams stay exact;
    an eos inside an accepted window stops the stream there."""
    engine = _spec_engine(world, num_blocks=9, max_model_len=48)
    got = _run(engine, REQUESTS)
    assert engine.snapshot()["counters"]["preempted"] > 0
    for (n, name), tokens, i in zip(REQUESTS, got, range(len(REQUESTS))):
        prompt = _prompt(i, n)
        assert tokens == generate(world["tm"], world["t_merged"][name],
                                  [prompt], NEW, device="cpu"
                                  )[0, len(prompt):].tolist()
    prompt = _prompt(0, 5)
    full = generate(world["tm"], world["t_merged"]["t0"], [prompt], NEW,
                    device="cpu")[0, len(prompt):].tolist()
    eos = full[4]
    stop = full.index(eos) + 1
    engine = _spec_engine(world)
    assert engine.generate(prompt, NEW, adapter="t0",
                           eos_token_id=eos) == full[:stop]


def test_refusals_match_jax(world):
    jd, jdp = jdraft.early_exit_draft(world["jm"], world["jp"], 1)
    td, tdp = draft.early_exit_draft(world["tm"], world["tp"], 1)
    small = JaxGPT(JaxGPTConfig(**{**CFG, "vocab_size": 64},
                                warmup_steps=1))
    tsmall = GPT(GPTConfig(**{**CFG, "vocab_size": 64}), device="cpu")
    short = JaxGPT(JaxGPTConfig(**{**CFG, "seq_len": 32}, warmup_steps=1))
    tshort = GPT(GPTConfig(**{**CFG, "seq_len": 32}), device="cpu")
    cases = [
        (dict(spec_k=2), dict(draft_module=True), "pair"),
        (dict(spec_k=-1), {}, "spec_k"),
        (dict(spec_k=2), {}, "draft model"),
        (dict(), dict(draft_module=True, draft_params=True), "spec_k"),
        (dict(spec_k=2), dict(small=True), "vocab"),
        (dict(spec_k=2), dict(short=True), "positional table"),
        (dict(prefill_chunk=12), {}, "multiple of block_size"),
        (dict(prefill_chunk=256), {}, "max_model_len"),
    ]
    for cfg, which, match in cases:
        for pkg in ("jax", "port"):
            if pkg == "jax":
                m, p, SC, SE = (world["jm"], world["jp"], JaxServeConfig,
                                JaxServeEngine)
                dm, dp = jd, jdp
                if which.get("small"):
                    dm = small
                    dp = small.init_params(jax.random.PRNGKey(1))
                if which.get("short"):
                    dm = short
                    dp = short.init_params(jax.random.PRNGKey(1))
                kw = {}
            else:
                m, p, SC, SE = (world["tm"], world["tp"], ServeConfig,
                                ServeEngine)
                dm, dp = td, tdp
                if which.get("small"):
                    dm, dp = tsmall, tsmall.init_params()
                if which.get("short"):
                    dm, dp = tshort, tshort.init_params()
                kw = {"device": "cpu"}
            if which.get("draft_module") and not which.get("draft_params"):
                kw.update(draft_module=dm)
            elif which:
                kw.update(draft_module=dm, draft_params=dp)
            with pytest.raises(ValueError, match=match):
                SE(m, p, SC(num_slots=2, block_size=8, **cfg), **kw)
    # Per-request spec on engines with and without a draft.
    for engine in (ServeEngine(world["tm"], world["tp"],
                               ServeConfig(num_slots=2, block_size=8),
                               device="cpu"),
                   JaxServeEngine(world["jm"], world["jp"],
                                  JaxServeConfig(num_slots=2,
                                                 block_size=8))):
        with pytest.raises(ValueError, match="without a draft model"):
            engine.submit([1, 2], 3, spec=1)
        with pytest.raises(ValueError, match="spec must be >= 0"):
            engine.submit([1, 2], 3, spec=-1)
        engine.submit([1, 2], 3, spec=0)
        engine.run_until_idle()
