"""Blocking host reads a batch makes on the eval path (the program's
counter ``host_syncs``: each inside a ``molly/sync/<site>`` span), over the
stats batches. The stats mode's own phase marks are not counted."""

from h100_bench.metrics._recorded import stats_of


def read(record):
    batches = stats_of(record, "counts")
    if batches is None:
        return None
    return sum(s["counts"].get("host_syncs", 0) for s in batches) \
        / len(batches)
