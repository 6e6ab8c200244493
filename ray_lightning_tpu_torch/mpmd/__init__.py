"""MPMD pipeline parallelism (``ray_lightning_tpu/mpmd``): each pipeline
stage its own programs on its own device in its own worker process,
stages exchanging activations and activation gradients over the transfer
lane (shared-memory segments on one host, TCP queue frames otherwise),
each worker walking its own instruction stream (GPipe, 1F1B or
interleaved 1F1B).

Modules:

* :mod:`.plan` — :class:`StagePlan` (contiguous layer split) and
  :class:`MpmdSpec` (the model's decomposition, with the GPT adapter);
* :mod:`.schedule` — instruction streams, validation and simulation,
  and the ``bubble_fraction`` / ``stage_occupancy`` accounting;
* :mod:`.transfer` — the lane (mailbox, inbox, channels, wire codec)
  and the queue plane's tree codec;
* :mod:`.stage` — :class:`~.stage.StageRunner`, one stage's executor;
* :mod:`.inproc` — the stages as threads of one process;
* :mod:`.worker` — the stage worker's entry points and checkpoint
  discovery;
* :mod:`.reference` — the one-program GPipe reference fit the plane is
  held against.

The user-facing entry point is
:class:`ray_lightning_tpu_torch.parallel.strategies.MpmdStrategy`.
"""

from ray_lightning_tpu_torch.mpmd.plan import (  # noqa: F401
    MpmdSpec,
    StagePlan,
    gpt_mpmd_spec,
    resolve_mpmd_spec,
)
from ray_lightning_tpu_torch.mpmd.schedule import (  # noqa: F401
    Instr,
    build_schedule,
    build_streams,
    bubble_from_timeline,
    fleet_pipeline_stats,
    gpipe_schedule,
    interleaved_streams,
    one_f_one_b_schedule,
    simulate_streams,
    validate_streams,
)

__all__ = [
    "MpmdSpec",
    "StagePlan",
    "gpt_mpmd_spec",
    "resolve_mpmd_spec",
    "Instr",
    "build_schedule",
    "build_streams",
    "interleaved_streams",
    "gpipe_schedule",
    "one_f_one_b_schedule",
    "validate_streams",
    "simulate_streams",
    "bubble_from_timeline",
    "fleet_pipeline_stats",
]
