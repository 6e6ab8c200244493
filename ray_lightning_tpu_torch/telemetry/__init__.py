"""Telemetry of the port: the cheap tier of the JAX package's
``telemetry/`` (step-time split, throughput, MFU, capture count) in
``step_stats.py`` and ``runtime.py``; the serving plane's request spans
and trace context (``spans.py``, ``propagate.py``), time series, SLOs
and OpenMetrics export (``timeseries.py``, ``slo.py``,
``export_prom.py``).  The trainer's ``"full"`` tier (spans and traces of
a fit) comes with a later slice."""
