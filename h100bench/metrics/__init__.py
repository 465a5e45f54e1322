"""One reader a metric, named by the metric: ``read(reading)`` returns its
value or None where it finds nothing to read. ``UNIT`` (and for a per-layer
metric ``LAYER`` and ``MOVES``) repeat what ``BENCHMARK.json`` says."""
