"""The port's CUDA kernel and a tiny engine on the card.

Marked ``gpu``; each test skips (inside its fixture, never at import)
when no CUDA device is available.  Run on the card with
``pytest -m gpu tests/test_torch_gpu.py``.  Kernel vs plain tolerances as
in ``chip_smoke.py``: f32 max abs error <= 1e-5·max|ref| + 1e-6 (f32 sums
in another order), bf16 <= 2e-2·max|ref| (one bf16 rounding of the
output, which may land on the other side).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch.models.generate import generate
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, synthetic_lora_adapter,
)
from ray_lightning_tpu_torch.ops import lora
from ray_lightning_tpu_torch.serve.engine import ServeConfig, ServeEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _case(gen, W, d, r, k, n, dtype):
    h = torch.randn(W, d, generator=gen, device="cuda").to(dtype)
    a = (torch.randn(n, d, r, generator=gen, device="cuda") * 0.1).to(dtype)
    b = (torch.randn(n, r, k, generator=gen, device="cuda") * 0.3).to(dtype)
    ids = torch.randint(0, n, (W,), generator=gen, device="cuda",
                        dtype=torch.int32)
    return h, a, b, ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W,d,r,k", [(8, 768, 16, 2304), (512, 768, 16, 768),
                                     (3, 100, 100, 1000), (1, 32, 1, 5),
                                     (40, 64, 128, 4096)])
def test_kernel_matches_plain(cuda, dtype, W, d, r, k):
    dt = getattr(torch, dtype)
    h, a, b, ids = _case(cuda, W, d, r, k, 5, dt)
    got = lora.bgmv(h, a, b, ids)
    ref = lora.bgmv_plain(h, a, b, ids)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (W, k)
    scale = ref.float().abs().max().item()
    tol = 1e-5 * scale + 1e-6 if dt == torch.float32 else 2e-2 * scale
    assert (got.float() - ref.float()).abs().max().item() <= tol


def test_null_slot_is_exactly_zero_and_launches_count(cuda):
    h, a, b, ids = _case(cuda, 8, 64, 8, 96, 3, torch.float32)
    a[0] = 0.0
    b[0] = 0.0
    before = lora.bgmv.launches
    out = lora.bgmv(h, a, b, torch.zeros_like(ids))
    torch.cuda.synchronize()
    assert (out == 0).all()
    assert lora.bgmv.launches == before + 1


def test_out_of_range_id_gives_nan_rows(cuda):
    h, a, b, ids = _case(cuda, 4, 64, 8, 96, 3, torch.float32)
    ids[2] = 7
    out = lora.bgmv(h, a, b, ids)
    torch.cuda.synchronize()
    assert torch.isnan(out[2]).all() and not torch.isnan(out[[0, 1, 3]]).any()


def test_kernel_rejects_what_it_does_not_take(cuda):
    h, a, b, ids = _case(cuda, 4, 64, 8, 96, 3, torch.float32)
    with pytest.raises(ValueError, match="int32"):
        lora.bgmv(h, a, b, ids.long())
    with pytest.raises(ValueError, match="dtype"):
        lora.bgmv(h.half(), a.half(), b.half(), ids)
    with pytest.raises(ValueError, match="one dtype"):
        lora.bgmv(h, a.to(torch.bfloat16), b, ids)
    with pytest.raises(ValueError, match="contiguous"):
        lora.bgmv(h.t().contiguous().t(), a, b, ids)
    with pytest.raises(ValueError, match="rank"):
        big = torch.zeros(3, 64, 129, device="cuda")
        lora.bgmv(h, big, torch.zeros(3, 129, 96, device="cuda"), ids)
    with pytest.raises(ValueError, match="is on"):
        lora.bgmv(h, a.cpu(), b, ids)


def test_tiny_engine_on_the_card_matches_merged_generate(cuda):
    cfg = GPTConfig(vocab_size=128, n_layer=2, n_head=4, d_model=64,
                    seq_len=64)
    module = GPT(cfg)  # the default device: the card
    params = module.init_params(cuda)
    for key in ("qkv_w", "proj_w", "mlp_in_w", "mlp_out_w"):
        params["blocks"][key] = params["blocks"][key] * 10.0
    lora_cfg = dataclasses.replace(cfg, lora_rank=4)
    tenants, merged = {}, {None: params}
    for name in ("a", "b"):
        tenants[name], merged[name] = synthetic_lora_adapter(
            params, lora_cfg, cuda, scale=0.3)
    engine = ServeEngine(module, params,
                         ServeConfig(num_slots=3, block_size=8,
                                     max_adapters=2, adapter_rank=4),
                         adapters=tenants)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, 128, size=(n,)).tolist(), a)
            for n, a in ((5, "a"), (11, None), (17, "b"), (9, "a"))]
    lora.bgmv.launches = 0
    handles = [engine.submit(p, 10, adapter=a) for p, a in reqs]
    engine.run_until_idle()
    c = engine.snapshot()["counters"]
    assert lora.bgmv.launches == 2 * cfg.n_layer * (c["prefills"]
                                                    + c["decode_steps"])
    for (p, a), h in zip(reqs, handles):
        ref = generate(module, merged[a], [p], 10)[0, len(p):].tolist()
        assert h.result(0) == ref
