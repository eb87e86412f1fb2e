"""The MoE prefill grouped GEMMs' share of their roofline in the profiled
batch (``roofline/moe_gemm``), over the layers the decoder's file counts
as MoE (its ``moe_layers``; a file without one, as ``qwen3.py``, has every
layer MoE). None for a dense decoder."""

from h100_bench.metrics._roofline import share


def read(record):
    moe_layers = getattr(record.get("decoder"), "moe_layers", None)
    if moe_layers is not None:
        config = record["config"]
        text = dict(config["text"],
                    num_hidden_layers=moe_layers(config["text"]))
        record = dict(record, config=dict(config, text=text))
    return share(record, "moe_gemm")
