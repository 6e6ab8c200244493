"""Disaggregated serving on one process's threads, as in
``ray_lightning_tpu/serve/dist/``: prefill workers run prompts and ship
their paged k/v blocks to decode replicas (N engines) behind one
load-aware router with per-replica admission, beat-based failover (a dead
replica's requests recompute on survivors with the router-stamped
sampling seeds; clients dedup by token index), live migration on a
planned drain, and a sliding-window restart governor for prefill
workers.

* :mod:`.handoff` — the wire frames;
* :mod:`.prefill` — the prefill worker (prefill → export → handoff);
* :mod:`.replica` — decode replicas and the in-process fleet;
* :mod:`.router` — placement, admission, failover, the
  ``router-live.json`` and per-replica OpenMetrics exports.

The JAX package's actor fleet (``ActorReplica``, ``ActorPrefill``,
``launch_actor_fleet``) waits for the port's actor and drain planes.
"""

from ray_lightning_tpu_torch.serve.dist.handoff import (
    KV_SEGMENT_PREFIX,
    make_adapter_load_item,
    make_beat_item,
    make_dispatch_item,
    make_handoff_item,
    make_hello_item,
    request_fields,
)
from ray_lightning_tpu_torch.serve.dist.prefill import PrefillRunner
from ray_lightning_tpu_torch.serve.dist.replica import (
    DecodeReplicaRunner,
    InprocPrefill,
    InprocReplica,
    ServeFleet,
    launch_inproc_fleet,
)
from ray_lightning_tpu_torch.serve.dist.router import RestartGovernor, Router

__all__ = [
    "Router",
    "RestartGovernor",
    "ServeFleet",
    "launch_inproc_fleet",
    "PrefillRunner",
    "DecodeReplicaRunner",
    "InprocReplica",
    "InprocPrefill",
    "KV_SEGMENT_PREFIX",
    "request_fields",
    "make_dispatch_item",
    "make_handoff_item",
    "make_adapter_load_item",
    "make_hello_item",
    "make_beat_item",
]
