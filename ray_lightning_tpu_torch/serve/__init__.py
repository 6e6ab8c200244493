"""Continuous-batching serving plane of the port: paged KV cache, block
allocator, scheduler with request deadlines, LoRA adapter pool and its
wire codec, sampler, the engine with its queue plane and exports, and
the client that reaches it from any process (as
``ray_lightning_tpu/serve/__init__.py`` exports them).  The disaggregated
fleet (prefill workers, decode replicas, the router) and the brownout
ladder are imported from their modules: ``from
ray_lightning_tpu_torch.serve.dist import launch_inproc_fleet``."""

from ray_lightning_tpu_torch.serve.client import (
    RetryPolicy,
    ServeClient,
    ServeRejected,
)
from ray_lightning_tpu_torch.serve.draft import (
    early_exit_draft,
    pad_identity_layers,
)
from ray_lightning_tpu_torch.serve.engine import ServeConfig, ServeEngine
from ray_lightning_tpu_torch.serve.kv_cache import (
    BlockAllocator,
    PagedKVCache,
    paged_decode_step,
    paged_prefill,
    paged_verify_step,
    sample_tokens,
)
from ray_lightning_tpu_torch.serve.lora import (
    AdapterPool,
    decode_adapter,
    encode_adapter,
)
from ray_lightning_tpu_torch.serve.metrics import ServeStats
from ray_lightning_tpu_torch.serve.scheduler import (
    Request,
    RequestState,
    Scheduler,
)

__all__ = [
    "ServeEngine",
    "ServeConfig",
    "ServeClient",
    "RetryPolicy",
    "ServeRejected",
    "ServeStats",
    "PagedKVCache",
    "BlockAllocator",
    "paged_prefill",
    "paged_decode_step",
    "paged_verify_step",
    "sample_tokens",
    "early_exit_draft",
    "pad_identity_layers",
    "AdapterPool",
    "encode_adapter",
    "decode_adapter",
    "Request",
    "RequestState",
    "Scheduler",
]
