"""Flash attention forward's share of its roofline in the profiled batch
(encoders and decoder prefill; ``roofline/attn_fwd``)."""

from h100_bench.metrics._roofline import share


def read(record):
    return share(record, "attn_fwd")
