"""Share of the encoder tokens run that are live: the program's counters
``encoder_tokens_live`` (non-pad tokens of the slots a sample fills) over
``encoder_tokens_run`` (every token of every slot), both modalities, over
the stats batches."""

from h100_bench.metrics._recorded import count_ratio_pct


def read(record):
    return count_ratio_pct(record, "encoder_tokens_live",
                           "encoder_tokens_run")
