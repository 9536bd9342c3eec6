"""Carry a built solver's state across from the JAX package.

``solver_from_reference`` builds a port ``DistributedECG`` directly on the
operands another build produced (the JAX ``DistributedECG``'s, handed over
as numpy arrays), skipping the port's own build. Both packages can then
solve on identical operands, which separates solver parity from build
parity in the tests.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from prealps_tpu_torch.config import resolve_device, strict_fp32
from prealps_tpu_torch.core.layout import RowLayout
from prealps_tpu_torch.parallel.driver import DistributedECG, StencilOperands
from prealps_tpu_torch.solvers.ecg import ECGOptions


def solver_from_reference(arrays: dict, meta: dict, device="cuda") -> DistributedECG:
    """Port solver on a reference build's operands.

    arrays — numpy unless noted:
      ``blocks``   stencil block table, (S, br, br, nrb) or flat (S·br², nrb)
      ``inv_f``    (nb, mb, mb) block inverses
      ``yq3``      (nb, q, mb) coarse modes
      ``ac_inv``   (nb·q, nb·q) coarse inverse
      ``scale_d``  (n,) RAC scaling vector, or None
      ``perm``, ``inv_perm``, ``layout_offsets``  the RowLayout arrays
      ``a_scaled`` scipy sparse scaled matrix (needed when refining), or None
    meta:
      ``stencil_offsets`` (S node offsets), ``br``, ``n``, ``n_pad``,
      ``rows_per_shard``, ``opts`` (dict of ECGOptions fields, as the
      reference solver holds them after build), ``target_tol``.

    The operands' dtype (float32 or float64) is the solve's dtype.
    """
    device = resolve_device(device)
    strict_fp32()
    br = int(meta["br"])
    offsets = tuple(int(o) for o in meta["stencil_offsets"])
    blocks = np.asarray(arrays["blocks"])
    nrb = blocks.shape[-1]
    # copies: arrays handed over from another framework may be read-only
    blocks_flat = np.array(blocks.reshape(len(offsets) * br * br, nrb), order="C")
    dtype = blocks_flat.dtype

    def dev(name):
        return torch.from_numpy(np.array(arrays[name], dtype=dtype, order="C")).to(device)

    operands = StencilOperands(
        blocks_flat=torch.from_numpy(blocks_flat).to(device), offsets=offsets,
        br=br, inv_f=dev("inv_f"), yq3=dev("yq3"), ac_inv=dev("ac_inv"))
    layout = RowLayout(
        n=int(meta["n"]), n_pad=int(meta["n_pad"]), nshards=1,
        rows_per_shard=int(meta["rows_per_shard"]),
        perm=np.asarray(arrays["perm"]), inv_perm=np.asarray(arrays["inv_perm"]),
        offsets=np.asarray(arrays["layout_offsets"]))
    a_scaled = arrays.get("a_scaled")
    scale_d = arrays.get("scale_d")
    return DistributedECG(
        layout=layout, opts=ECGOptions(**meta["opts"]),
        scale_d=None if scale_d is None else np.asarray(scale_d),
        operands=operands, device=device, dtype=np.dtype(dtype),
        target_tol=float(meta["target_tol"]),
        a_scaled=None if a_scaled is None else sp.csr_matrix(a_scaled),
    )
