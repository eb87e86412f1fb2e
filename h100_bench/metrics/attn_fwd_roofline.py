"""Flash attention forward's share of its roofline in the profiled batch
(encoders and decoder prefill; ``roofline/attn_fwd``, the decoder's calls
from its ``reference/<decoder>.py``)."""

from h100_bench.metrics._roofline import share


def read(record):
    return share(record, "attn_fwd", record.get("decoder"))
