"""The MoE prefill grouped GEMMs' share of their roofline in the profiled
batch (``roofline/moe_gemm``); None for a dense decoder."""

from h100_bench.metrics._roofline import share


def read(record):
    return share(record, "moe_gemm")
