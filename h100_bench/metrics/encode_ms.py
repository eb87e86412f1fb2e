"""Milliseconds a batch spends in the encoders, projectors and injection:
``engine.generate(stats=)["encode_s"]``, which synchronizes, so it is read
from the batches a traced run runs again after its window."""

from h100_bench.metrics._batches import stat_mean_ms


def read(record):
    return stat_mean_ms(record, "encode_s")
