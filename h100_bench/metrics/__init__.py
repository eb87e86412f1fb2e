"""One reader a per-layer metric: ``read(record) -> value or None``. A
reader that finds nothing to read returns None and the metric is left out
of the result line; a share of a roofline or a peak is never 0 for want of
a reading."""
