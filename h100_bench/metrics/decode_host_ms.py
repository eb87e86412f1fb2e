"""Host milliseconds a decode step spends issuing its work: the span
``molly/decode_step``'s host seconds less the time the host was blocked in
the ``molly/sync/*`` spans inside it, over the steps of the stats batches.
With ``decode_wait_ms`` it splits ``decode_step_ms``."""

from h100_bench.metrics._recorded import span_s, stats_of

STEP = "molly/decode_step"


def read(record):
    batches = stats_of(record, "spans")
    if batches is None:
        return None
    steps = sum(s.get("decode_steps", 0) for s in batches)
    if not steps:
        return None
    host = sum(span_s(s, STEP) - span_s(s, STEP, "sync_s")
               for s in batches)
    return 1e3 * host / steps
