"""Host milliseconds a batch spends in the batch CLI's own work around
``generate``: the spans ``molly/collate`` and ``molly/write`` (the JSONL
records), over the stats batches."""

from h100_bench.metrics._recorded import span_s, stats_of


def read(record):
    batches = stats_of(record, "spans")
    if batches is None:
        return None
    return 1e3 * sum(span_s(s, "molly/collate") + span_s(s, "molly/write")
                     for s in batches) / len(batches)
