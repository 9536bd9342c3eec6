"""The distributed LORASC's f32 build, stage by stage, in both packages
(ROADMAP C, "Other behaviours" 7; pinned by
``tests/test_torch_dlorasc.py::test_f32_solve_refines``).

elasticity3d(6,5,5) at 4 groups, f32, ``exact_schur=False``, ECG t 4 to
1e-8. Run from the repository root (a few minutes on 4 CPU cores):

    python -m tests.dlorasc_f32_stages

It prints, for the JAX build (``nshards=4`` on CPU devices, the Python
partition) with x64 on, as the test session runs it, and with x64 off,
each in its own process: the dtypes of the Lanczos Ritz values and of the
Rayleigh-Ritz outputs, the first Ritz values, theta, bnorm2 and resid,
deflated, sigma, and the iterations of each refinement round, also with
sigma scaled by 1 ± 1e-4. Then, for the port over 4 gloo ranks: the same
stages, and the rounds of its solve on its own operands, on the JAX
build's (``distributed_lorasc_from_reference``), on each with the other's
Ritz basis and sigma, and with its sigma scaled by 1 ± 1e-4; and which
operands the two builds hold bitwise equal.
"""

import argparse
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CASE = dict(nshards=4, dtype=np.float32, exact_schur=False,
            opts=dict(t=4, tol=1e-8, maxiter=600))
SHOW = 6   # leading values printed of each stage


def problem():
    from prealps_tpu_torch.core.generators import elasticity3d

    a = elasticity3d(6, 5, 5)
    return a, np.random.default_rng(0).standard_normal(a.shape[0])


def jax_stages(x64: bool):
    """The JAX build in this process (x64 as given); returns (stages,
    reference operands for the port)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["PREALPS_TPU_NO_NATIVE"] = "1"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", x64)
    import prealps_tpu.ops.lanczos as lanczos
    from prealps_tpu.parallel.lorasc_driver import DistributedLorascECG
    from prealps_tpu.solvers.ecg import ECGOptions
    from sharded_cases import lorasc_reference

    rec = {}

    def keep(name):
        def store(*arrays):
            rec.setdefault(name, [np.asarray(v) for v in arrays])
        return store

    refine = lanczos.rayleigh_ritz_refine

    def rr(*args, **kw):
        out = refine(*args, **kw)
        jax.debug.callback(keep("rr"), out[0], out[2], out[3])
        return out

    def traced(fn):
        def run(*args, **kw):
            res = fn(*args, **kw)
            jax.debug.callback(keep("ritz"), res.eigvalues, res.resid)
            return res
        return run

    lanczos.rayleigh_ritz_refine = rr
    for name in ("block_lanczos_thick_restart", "lanczos_thick_restart", "lanczos_gen"):
        setattr(lanczos, name, traced(getattr(lanczos, name)))
    a, b = problem()
    kw = dict(CASE)
    opts = ECGOptions(**kw.pop("opts"))

    def build_and_solve(eps=0.0):
        s = DistributedLorascECG.build(a, opts=opts, **kw)
        arrays, meta = lorasc_reference(s)
        if eps:
            s._operands[0]["sigma"] = s._operands[0]["sigma"] * np.float32(1 + eps)
        rounds, inner = [], s._solve_scaled_once

        def counted(r):
            x, info = inner(r)
            rounds.append(int(info["iters"]))
            return x, info

        s._solve_scaled_once = counted
        _, info = s.solve(b)
        return s, (int(info["iters"]), rounds), arrays, meta

    s, solved, arrays, meta = build_and_solve()
    (ritz, ritz_resid), (theta, bnorm2, resid) = rec["ritz"], rec["rr"]
    out = dict(ritz=ritz, ritz_resid=ritz_resid, theta=theta, bnorm2=bnorm2,
               resid=resid, deflated=s.deflated,
               sigma=np.asarray(s._operands[0]["sigma"]), own=solved)
    for eps in (1e-4, -1e-4):
        out[f"own_sigma_{eps:+g}"] = build_and_solve(eps)[1]
    return out, (arrays, meta)


def show(tag, st):
    print(f"== {tag}")
    for k in ("ritz", "ritz_resid", "theta", "bnorm2", "resid", "sigma"):
        v = np.asarray(st[k])
        print(f"  {k} ({v.dtype}): {np.array2string(v[:SHOW], precision=6)}")
    print(f"  deflated {st['deflated']}")
    for k, v in st.items():
        if isinstance(v, tuple):
            print(f"  {k}: {v[0]} iterations, rounds {v[1]}")
    if "ops_equal" in st:
        print(f"  operands bitwise equal to JAX's: {st['ops_equal']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax-x32", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    if args.jax_x32:                       # the child: JAX with x64 off
        with open(args.jax_x32, "wb") as f:
            pickle.dump(jax_stages(False)[0], f)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        out32 = Path(tmp) / "x32.pkl"
        subprocess.run([sys.executable, "-m", "tests.dlorasc_f32_stages",
                        "--jax-x32", str(out32)], check=True, cwd=HERE.parent)
        with open(out32, "rb") as f:
            x32 = pickle.load(f)
        x64, (arrays, meta) = jax_stages(True)
        show("JAX, x64 on", x64)
        show("JAX, x64 off", x32)
        import torch_shard_workers
        from prealps_tpu_torch.parallel import mesh

        a, b = problem()
        port = mesh.spawn(torch_shard_workers.lorasc_f32_stages, 4,
                          args=(a, b, CASE, arrays, meta),
                          init_method=f"file://{Path(tmp) / 'store'}", timeout=900)
        show("port, 4 gloo ranks (rank 0)", port[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
