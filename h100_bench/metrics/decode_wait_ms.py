"""Host milliseconds a decode step spends blocked on the device's backlog:
the host seconds of the ``molly/sync/*`` spans inside ``molly/decode_step``
(the EOS check, each layer's attention offset, the presence write), over
the steps of the stats batches."""

from h100_bench.metrics._recorded import span_s, stats_of

STEP = "molly/decode_step"


def read(record):
    batches = stats_of(record, "spans")
    if batches is None:
        return None
    steps = sum(s.get("decode_steps", 0) for s in batches)
    if not steps:
        return None
    return 1e3 * sum(span_s(s, STEP, "sync_s") for s in batches) / steps
