"""Milliseconds a batch spends in the decoder's prefill and first sample:
``stats["prefill_s"]`` over the batches a traced run runs again after its
window."""

from h100_bench.metrics._batches import stat_mean_ms


def read(record):
    return stat_mean_ms(record, "prefill_s")
