"""Telemetry of the port: the cheap tier of the JAX package's
``telemetry/`` (step-time split, throughput, MFU, capture count) in
``step_stats.py`` and ``runtime.py``; spans and trace exports (the
``"full"`` tier) come with a later slice."""
