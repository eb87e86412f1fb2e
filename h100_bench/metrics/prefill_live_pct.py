"""Share of the prefill's positions that are prompt tokens: the program's
counters ``prefill_positions_live`` (the attention mask's ones) over
``prefill_positions_run`` (batch x padded length), over the stats
batches."""

from h100_bench.metrics._recorded import count_ratio_pct


def read(record):
    return count_ratio_pct(record, "prefill_positions_live",
                           "prefill_positions_run")
