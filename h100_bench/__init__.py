"""The benchmark of ``molly_tpu_torch`` on NVIDIA H100 cards (see README.md)."""
