"""The latent attention prefill's flash kernel (its 192 / 128
instantiation) over its roofline in the profiled batch
(``roofline/mla_fwd``, the calls from the decoder's file); None where the
decoder has no latent or the slice ran no such kernel."""

from h100_bench.metrics._roofline import share


def read(record):
    return share(record, "mla_fwd", record.get("decoder"))
