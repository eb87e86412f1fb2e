"""The plain reference: its own prompt building (``prompt.py``), a float32
forward of the fusion model's encoders and projectors in plain PyTorch
(``model.py``), and one file per decoder architecture (``qwen3.py``), which
a configuration names by its ``"decoder"`` key. It imports nothing of the
program (``molly_tpu_torch``) and nothing of JAX."""
