"""Metric readers: ``<metric>.py`` for each metric ``BENCHMARK.json`` names,
each with ``read(ctx) -> float | None`` (None: nothing to read here)."""
