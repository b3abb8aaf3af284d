"""Per-layer metric readers, one file per metric, named as the metric in
``BENCHMARK.json`` (``<name>.py``; names may hold dots). Each has
``read(ctx, summary)``, which returns the number or None when it finds
nothing to read, and may have ``install(ctx)``, called before the traced
slice to wrap the calls it counts (``trace.Context``)."""
