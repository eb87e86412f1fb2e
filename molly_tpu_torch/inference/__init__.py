"""Sampling, the KV-cache generate loop and the batch inference CLI in
PyTorch (counterparts of ``molly_tpu.inference``)."""
