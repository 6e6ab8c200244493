"""Telemetry of the port: model FLOP accounting so far (the JAX package's
step timing, spans and exporters come with a later slice)."""
