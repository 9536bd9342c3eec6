"""prealps_tpu_torch — the enlarged-Krylov solver framework in PyTorch + CUDA.

The PyTorch/CUDA counterpart of ``prealps_tpu`` (JAX/Pallas), which stays
in the repository as the reference. Module paths mirror the JAX package so
each piece has an obvious counterpart:

* ``core``     host-side generators, scaling and row layouts (numpy/scipy)
* ``ops``      stencil formats, the stencil SpMM (hand-written CUDA kernel
               for CUDA tensors, plain PyTorch on the CPU), double-float
               arithmetic and small dense block operations
* ``solvers``  the ECG solver (stacked ODIR-fused step)
* ``direct``   device block-Jacobi assembly and inversion
* ``precond``  the two-level block-Jacobi preconditioner
* ``parallel`` the ``DistributedECG`` driver (one GPU)

The device is always explicit: nothing here picks CUDA or CPU by itself.
"""

from prealps_tpu_torch.config import strict_fp32

__all__ = ["strict_fp32"]
