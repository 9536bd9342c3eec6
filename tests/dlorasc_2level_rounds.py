"""The refinement rounds of chip_smoke's ``[dlorasc_dryrun]`` (4, 2)-mesh
path in both packages, with the native partition (ROADMAP A4).

``dryrun_multichip``'s "lorasc 2-level mesh" build (het elasticity3d 8³,
RAC-scaled, ``mesh_shape=(4, 2)``, max_deflation 16, ECG t 2 odir_fused to
1e-6), in f32 with host-f64 rounds and in f64: the JAX driver on 8 CPU
devices in this process, the port over 8 gloo ranks. Run from the
repository root (about a minute on 8 CPU cores):

    python -m tests.dlorasc_2level_rounds

It prints, per dtype and package, the deflated pairs and each round's
iterations, rhs norm and final residual norm, and for f64 the largest
difference of the two solutions relative to JAX's.
"""

import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
KW = dict(mesh_shape=(4, 2), max_deflation=16)
OPTS = dict(t=2, tol=1e-6, maxiter=6000)


def problem(elasticity3d, sym_rac_scaling, dtype):
    a, _ = sym_rac_scaling(elasticity3d(8, 8, 8))
    a = a.astype(dtype)
    return a, np.random.default_rng(0).standard_normal(a.shape[0]).astype(dtype)


def with_rounds(solver):
    """Record (iterations, ‖rhs‖, final ‖r‖) of each inner solve."""
    rounds = []
    once = solver._solve_scaled_once

    def wrapped(r):
        x, info = once(r)
        rounds.append((int(info["iters"]), float(np.linalg.norm(r)), float(info["res"])))
        return x, info

    solver._solve_scaled_once = wrapped
    return rounds


def port_rank(rank, group, dtype_name):
    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.core.scaling import sym_rac_scaling
    from prealps_tpu_torch.parallel.lorasc_driver import DistributedLorascECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    a, b = problem(elasticity3d, sym_rac_scaling, np.dtype(dtype_name))
    s = DistributedLorascECG.build(a, dtype=a.dtype, device="cpu", group=group,
                                   opts=ECGOptions(**OPTS), **KW)
    rounds = with_rounds(s)
    x, info = s.solve(b)
    return {"deflated": int(s.deflated), "rounds": rounds, "iters": int(info["iters"]), "x": x}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, str(HERE.parent))
    from prealps_tpu.core.generators import elasticity3d
    from prealps_tpu.core.scaling import sym_rac_scaling
    from prealps_tpu.parallel.lorasc_driver import DistributedLorascECG as JaxLorasc
    from prealps_tpu.solvers.ecg import ECGOptions as JaxOptions
    from prealps_tpu_torch.parallel import mesh

    for dtype in (np.float32, np.float64):
        a, b = problem(elasticity3d, sym_rac_scaling, dtype)
        s = JaxLorasc.build(a, dtype=dtype, opts=JaxOptions(**OPTS), **KW)
        rounds = with_rounds(s)
        x_j, info = s.solve(b)
        print(f"{np.dtype(dtype).name} JAX: {s.deflated} pairs, {info['iters']} "
              f"iterations, rounds (iters, |rhs|, |r|) {rounds}", flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            port = mesh.spawn(port_rank, 8, args=(np.dtype(dtype).name,),
                              init_method=f"file://{tmp}/store", timeout=900)[0]
        dx = float(np.abs(port["x"] - x_j).max() / np.abs(x_j).max())
        print(f"{np.dtype(dtype).name} port: {port['deflated']} pairs, {port['iters']} "
              f"iterations, rounds {port['rounds']}; max|x - x_jax| / max|x_jax| "
              f"{dx:.2e}", flush=True)


if __name__ == "__main__":
    main()
