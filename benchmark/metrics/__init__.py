"""Metrics: one reader a metric (``<name>.py``), each with ``read(record)``
returning the value or None (nothing to read: the metric is left out)."""
