"""Ops with hand-written Hopper kernels behind them (counterparts of
``molly_tpu.ops``).

Each kernel wrapper launches its kernel for a CUDA tensor, or raises; for a
CPU tensor it runs the kernel's plain PyTorch version, which lives in the
same module. Every wrapper carries a ``launches`` counter that only its
kernel launch increments.
"""
