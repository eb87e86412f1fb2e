"""molly_tpu_torch — the PyTorch + CUDA port of molly_tpu for NVIDIA Hopper.

The JAX package ``molly_tpu`` stays the reference; this package mirrors its
module layout and names so each function has an obvious counterpart:

  - ``molly_tpu_torch.models``    Qwen3 decoder, ESM encoders, fusion model,
                                  and the param converter from JAX pytrees
  - ``molly_tpu_torch.ops``       attention / norms / int8 dispatch plus the
                                  hand-written Hopper kernels (CUDA C++ under
                                  ``csrc/``, Triton for RMSNorm)
  - ``molly_tpu_torch.inference`` sampling, the KV-cache generate loop and the
                                  batch inference CLI

It imports ``torch`` and never ``jax``; the jax-free parts of ``molly_tpu``
(``molly_tpu.data``) are reused as they are. Every kernel wrapper launches its
kernel for a CUDA tensor (or raises) and runs the kernel's plain PyTorch
version only for a CPU tensor.
"""

__version__ = "0.1.0"
