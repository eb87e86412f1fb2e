"""The plain reference: its own prompt building (``prompt.py``) and a
float32 forward of the fusion model in plain PyTorch (``model.py``). It
imports nothing of the program (``molly_tpu_torch``) and nothing of JAX."""
