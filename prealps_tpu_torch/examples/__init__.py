"""Runnable examples of the PyTorch/CUDA port (``python -m
prealps_tpu_torch.examples.<name>``)."""
