"""The whole step's share of the card's bf16 peak: the model FLOPs that the
inputs of the traced run's window need (``roofline/model_flops``: live
segments, real prompt tokens, emitted tokens) over the window's seconds on
the host's clock (untraced, as in every run) and 989 TFLOP/s."""

from h100_bench.harness.peaks import PEAK_FLOPS
from h100_bench.roofline import model_flops


def read(record):
    batches = record.get("batches") or []
    if record.get("trace") is None or not batches:
        return None
    total = sum(model_flops.generate(b["shape"], record["config"],
                                     record["decoder"]) for b in batches)
    return 100.0 * total / record["window_s"] / PEAK_FLOPS["bf16"]
