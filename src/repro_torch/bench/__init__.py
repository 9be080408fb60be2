"""Hot-path telemetry."""
