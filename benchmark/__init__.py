"""The benchmark of the PyTorch and CUDA port (``prealps_tpu_torch``):
harness, inputs, reference checks, trace reading and the kernels' bounds.
Nothing here imports JAX or the JAX package; see ``run.py``."""
