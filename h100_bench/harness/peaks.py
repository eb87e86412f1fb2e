"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, no
sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp8": 1979e12,
              "int8": 1979e12, "tf32": 495e12, "fp32": 67e12}


def bound_s(flops: float, nbytes: float, kind: str = "bf16") -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[kind], nbytes / HBM_BYTES_PER_S)
