"""The port's GPipe pipeline (``ray_lightning_tpu_torch/parallel/
pipeline.py``) and its one-program reference fit (``mpmd/reference.py``)
held against the JAX package's ``pipeline_apply`` and
``gpipe_reference_fit`` on the CPU mesh.

The pipe is a gloo group of two CPU ranks (``torch_dist_helpers.
pipeline_rank``, spawned through a strategy's workers): its forward and
the gradients of the input and of each rank's layers match JAX's
``pipeline_apply`` over ``{"pipe": 2}`` within 1e-5, and the reference
fit over that pipe matches JAX's losses within 1e-5.  A one-rank pipe
(``group=None``) is the plain scan over micro-batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_helpers as helpers
import torch_multi_fits as mf
from ray_lightning_tpu.parallel import pipeline as jax_pipe
from ray_lightning_tpu_torch.parallel import pipeline as pipe
from ray_lightning_tpu_torch.parallel.strategies import RayStrategy

L, B, D = 4, 8, 16
TINY = dict(vocab_size=32, n_layer=2, n_head=2, d_model=16, seq_len=8,
            warmup_steps=2)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((L, D)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((B, D)).astype(np.float32)}


def _jax_stage(params, x):
    def body(x, p):
        return jnp.tanh(x @ p["w"] + p["b"]), None

    x, _ = jax.lax.scan(body, x, params)
    return x


def _jax_pipeline(inp, n_stages, micro):
    """JAX's forward and the gradients of ``sum(out²)`` by params and x
    over ``{"pipe": n_stages}`` (one jitted vjp)."""
    mesh = Mesh(np.asarray(jax.devices()[:n_stages]), ("pipe",))

    @jax.jit
    def both(params, x):
        out, vjp = jax.vjp(lambda p, x: jax_pipe.pipeline_apply(
            _jax_stage, p, x, mesh, num_microbatches=micro), params, x)
        return out, vjp(2 * out)

    out, (gp, gx) = both({k: jnp.asarray(inp[k]) for k in ("w", "b")},
                         jnp.asarray(inp["x"]))
    return (np.asarray(out), np.asarray(gx), np.asarray(gp["w"]),
            np.asarray(gp["b"]))


@pytest.mark.parametrize("n,p", [(8, 4), (7, 3), (5, 4), (4, 1)])
def test_layer_splits_equal_jax(n, p):
    assert pipe.layer_splits(n, p) == jax_pipe.layer_splits(n, p)


def test_layer_splits_errors_equal_jax():
    for args, kw, match in (((7, 3), {"require_divisible": True},
                             "not divisible"),
                            ((2, 3), {}, "cannot fill"),
                            ((4, 0), {}, "n_stages")):
        with pytest.raises(ValueError, match=match):
            pipe.layer_splits(*args, **kw)
        with pytest.raises(ValueError, match=match):
            jax_pipe.layer_splits(*args, **kw)


@pytest.mark.parametrize("micro", [1, 4])
def test_one_rank_pipe_is_the_scan_and_matches_jax(micro):
    inp = _inputs(1)
    want, want_dx, want_dw, want_db = _jax_pipeline(inp, 1, micro)
    params = {k: torch.from_numpy(inp[k]).requires_grad_(True)
              for k in ("w", "b")}
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    out = pipe.pipeline_apply(helpers.tanh_stage, params, x, None,
                              num_microbatches=micro)
    (out ** 2).sum().backward()
    assert np.abs(out.detach().numpy() - want).max() < 1e-5
    for got, ref in ((x.grad, want_dx), (params["w"].grad, want_dw),
                     (params["b"].grad, want_db)):
        assert np.abs(got.numpy() - ref).max() < 1e-5


def test_pipeline_refuses_what_jax_refuses():
    inp = _inputs()
    params = {k: torch.from_numpy(inp[k]) for k in ("w", "b")}
    x = torch.from_numpy(inp["x"])
    with pytest.raises(ValueError, match="not divisible"):
        pipe.pipeline_apply(helpers.tanh_stage, params, x, None,
                            num_microbatches=3)
    with pytest.raises(ValueError, match="num_microbatches"):
        pipe.pipeline_apply(helpers.tanh_stage, params, x, None,
                            num_microbatches=0)


@pytest.fixture(scope="module")
def pool():
    strategy = RayStrategy(num_workers=2, **mf.WORKER)
    with mf.limit():
        strategy.setup()
    yield strategy
    strategy.teardown()


def _jax_reference_losses(full, batches, n_stages, micro):
    from ray_lightning_tpu.models.gpt import GPT as JaxGPT
    from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
    from ray_lightning_tpu.mpmd.plan import gpt_mpmd_spec
    from ray_lightning_tpu.mpmd.reference import gpipe_reference_fit

    module = JaxGPT(JaxConfig(**TINY), attn_impl="xla")
    module.precision = "f32"
    spec = gpt_mpmd_spec(module)
    return gpipe_reference_fit(
        spec, full, spec.tx_factory(), lambda s: batches[s], len(batches),
        n_stages=n_stages, n_micro=micro,
        devices=jax.devices()[:n_stages])["losses"]


def _tiny_gpt_inputs():
    from ray_lightning_tpu.models.gpt import GPT as JaxGPT
    from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
    from ray_lightning_tpu.mpmd.plan import _gpt_untie

    module = JaxGPT(JaxConfig(**TINY), attn_impl="xla")
    full = jax.tree.map(np.asarray, _gpt_untie(
        module.init_params(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(7)
    batches = [{"tokens": rng.integers(0, TINY["vocab_size"],
                                       (8, TINY["seq_len"] + 1)
                                       ).astype(np.int32)}
               for _ in range(2)]
    return full, batches


def _tiny_fit():
    full, batches = _tiny_gpt_inputs()
    return full, batches, list(_jax_reference_losses(full, batches, 2, 4))


@pytest.fixture(scope="module")
def tiny_fit(tmp_path_factory):
    """The tiny GPT's untied params and batches, and JAX's reference
    losses over ``{"pipe": 2}`` at 4 micro-batches (computed once)."""
    return mf.shared_once(tmp_path_factory, "jax-gpipe-reference-fit",
                          _tiny_fit)


def test_pipeline_over_two_gloo_ranks_matches_jax(pool, tiny_fit):
    """Forward, input and layer gradients of a two-stage pipe over gloo
    against JAX's ``pipeline_apply`` over ``{"pipe": 2}``; the reference
    fit over the same pipe against JAX's losses."""
    inp = _inputs(3)
    full, batches, want_losses = tiny_fit
    payload = {**inp, "micro": 4,
               "gpt": {"config": TINY, "params": full, "batches": batches,
                       "micro": 4}}
    with mf.limit():
        (ranks,) = helpers.wire_worlds(pool._workers, payload, timeout=120,
                                       worlds=(2,),
                                       fn=helpers.pipeline_rank).values()
    want, want_dx, want_dw, want_db = _jax_pipeline(inp, 2, 4)
    for r in ranks:
        lo, hi = r["rows"]
        assert np.abs(r["out"] - want).max() < 1e-5, r["rank"]
        assert np.abs(r["dx"] - want_dx).max() < 1e-5, r["rank"]
        assert np.abs(r["dw"] - want_dw[lo:hi]).max() < 1e-5, r["rank"]
        assert np.abs(r["db"] - want_db[lo:hi]).max() < 1e-5, r["rank"]
        np.testing.assert_allclose(r["losses"], want_losses, rtol=0,
                                   atol=1e-5)


def test_reference_fit_on_one_rank_matches_jax(tiny_fit):
    """The reference over a one-rank pipe (what the card runs) against
    JAX's over ``{"pipe": 2}``: the same math."""
    from ray_lightning_tpu_torch.models.convert import params_from_jax
    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
    from ray_lightning_tpu_torch.mpmd.plan import gpt_mpmd_spec
    from ray_lightning_tpu_torch.mpmd.reference import gpipe_reference_fit

    full, batches, want_losses = tiny_fit
    spec = gpt_mpmd_spec(GPT(GPTConfig(**TINY), device="cpu"))
    got = gpipe_reference_fit(spec, params_from_jax(full, "cpu"),
                              spec.tx_factory(), lambda s: batches[s],
                              len(batches), n_stages=2, n_micro=4,
                              device="cpu")
    np.testing.assert_allclose(got["losses"], want_losses, rtol=0,
                               atol=1e-5)
    assert got["state"].step == len(batches)
    with pytest.raises(ValueError, match="pipeline stages"):
        gpipe_reference_fit(spec, params_from_jax(full, "cpu"),
                            spec.tx_factory(), lambda s: batches[s], 1,
                            n_stages=3, n_micro=4, device="cpu")
