"""Time the hand-written stencil (B1-B4), block-ELL (B5) and block-Jacobi
(B6) kernels at the shapes of PERF.md's kernel table, through their public
wrappers.

The script imports ``prealps_tpu_torch`` from the caller's path, so one copy
of it times any checkout of the port whose wrappers take these arguments;
run it once per checkout, in turns (A, B, B, A), to compare two of them on
one card:

    PYTHONPATH=<checkout> python prealps_tpu_torch/examples/kernel_ab.py [--only B5,B6]

(``--only`` times the named kernels' shapes alone.)

Shapes (all f32, inputs from ``default_rng``; the times do not depend on
the values):

* B1 on the headline operator (elasticity3d 36³ scaled, padded as the
  stencil path pads it: nrb 49,360, S 27, br 3) at t 12 and 1; at a
  4-shard headline shard's shape (rank 1's 12,400 nodes of the 4-shard
  layout, on its extended panel: halo 1,407) at t 12 and 1; on the DIA
  path's table (the scaled operator's 97 promoted diagonals, n_pad
  148,480) and the unscaled operator's 99, at t 12 and 1;
* B2a on the LORASC path's operator shape (heterogeneous elasticity3d 36³,
  nrb 49,284) at t 12, 8, 1, 97 (the build's nev) and 256 (its lift
  width), and at the sweep's t 4 and 16; B2b there at t 1 and on the
  unscaled DIA table at t 12;
* B2a's bf16-block instance on the same operator's bf16 table at t 12, 8,
  1 and 256, and B2b's at t 1, each in turns with the f32 instance at the
  same shape (f32, bf16, bf16, f32); a checkout whose wrappers refuse bf16
  blocks prints that it does not take them;
* B3 at t 12, 8, 1 and B4 at t 12 on the headline operator;
* B5 on the general path's operator (elasticity3d 36³ scaled, one shard,
  rows padded to 128: nrb 18,496, S 9) at bk 128 t 12 and t 1 and at bk 8
  t 12, and on rank 0's shard of the 4-rank block-ELL layout ([own ∥
  halo] blocks, bk 128) at t 12 and t 1, each beside ``torch.sparse.mm``
  of the same nonzero entries as CSR (cuSPARSE). A checkout with
  ``formats.pack_block_ell_entries`` packs each operator once first (its
  kernel reads the entries); an older one launches on the blocks. Bound:
  the entries (8 bytes each), the row pointers, the X rows they reference
  (on the shard not the padding of its halo slots) and y;
* B6 at the ``bj`` path's shape (nb 617, mb 240) and the ``dia`` path's (nb
  145, mb 1024), t 12, beside ``torch.bmm`` of the unpadded inverses.

Each time is a device time (``prealps_tpu_torch/timing.py::device_ms`` of
the script's own checkout, whichever package it times): the median of 3
batches of back-to-back calls between CUDA events, enqueued behind a spin
kernel that outlasts their enqueueing, so the host's launch path is not
timed (for
``torch.bmm`` the driver's whole apply, ``bj_apply_flat``: the GEMM and
its two layout copies). Bound: the bytes the call needs (each input read
once, each output written once; the stencil panel without halo columns,
B6's inverses unpadded) over 3.35 TB/s. It prints one line per shape and, last, one JSON
line with the package it loaded, the card and its power limit, and every
record.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import runpy

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated kernels to time (B1..B6); all by default")
    only = set(filter(None, ap.parse_args(argv).only.split(",")))

    def want(*kernels):
        return not only or bool(only & set(kernels))

    import prealps_tpu_torch
    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.core.scaling import sym_rac_scaling

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    # this checkout's yardstick, loaded by its path and not through
    # prealps_tpu_torch, so every checkout on PYTHONPATH (older ones have
    # no timing module) is timed the same way
    timing = runpy.run_path(str(pathlib.Path(__file__).resolve().parents[1]
                                / "timing.py"))
    device_ms = timing["device_ms"]
    rng = np.random.default_rng(0)
    recs = []

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    def record(kernel, shape, fn, nbytes, reps=20):
        ms, _ = device_ms(fn, reps=reps)
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        rec = {"kernel": kernel, "shape": shape, "ms": ms, "bound_ms": bound,
               "share_of_bound": bound / ms}
        print(f"[ab] {kernel} {shape}: {ms:.4f} ms, bound {bound:.4f} ms "
              f"({100 * bound / ms:.0f} %)", flush=True)
        recs.append(rec)

    nel = 36
    a = elasticity3d(nel, nel, nel, heterogeneous=False)
    a_s = sym_rac_scaling(a)[0]

    if want("B5"):
        b5_records(a_s, dev, rand, record)
    if want("B1", "B3", "B4"):
        stencil_records(a_s, dev, rand, record)
    if want("B1", "B2a", "B2b"):
        dia_records(a, a_s, dev, rand, record)
    if want("B2a", "B2b"):
        lorasc_records(nel, dev, rand, record)
    if want("B6"):
        bj_records(rand, record)

    card = timing["card_line"]()
    print(json.dumps({"package": prealps_tpu_torch.__file__, "card": card,
                      "records": recs}))
    return 0


def b5_records(a_s, dev, rand, record):
    """B5 at the general path's three shapes and a 4-rank shard's two, each
    beside torch.sparse.mm on the same entries."""
    from prealps_tpu_torch.core.layout import build_row_layout, permute_and_pad_matrix
    from prealps_tpu_torch.ops import formats
    from prealps_tpu_torch.ops.spmm import block_ell_spmm_pallas
    from prealps_tpu_torch.parallel.driver import _block_ell_shard

    pack = getattr(formats, "pack_block_ell_entries", None)

    def shapes():
        a_pad = permute_and_pad_matrix(a_s, build_row_layout(a_s, 1, row_multiple=128))
        for bk, ts in ((128, (12, 1)), (8, (12,))):
            yield (f"general bk{bk}", formats.csr_to_block_ell(
                a_pad, bm=8, bk=bk, dtype=np.float32, device=dev), ts)
        lay4 = build_row_layout(a_s, 4, row_multiple=128)
        mat, _ = _block_ell_shard(permute_and_pad_matrix(a_s, lay4), lay4, 0, 128,
                                  np.float32, dev)
        yield "4-rank shard 0 bk128", mat, (12, 1)

    for tag, mat, ts in shapes():
        nrb, s_max, bm, bk = mat.blocks.shape
        nz = mat.blocks != 0
        rb, slot, m, k = nz.nonzero(as_tuple=True)
        nnz = int(rb.numel())
        cols = mat.blkcols.long()[rb, slot] * bk + k
        # the X rows the entries reference: a shard's halo slots are padded
        ncols_ref = int(torch.unique(cols).numel())
        csr = torch.sparse_coo_tensor(
            torch.stack([rb * bm + m, cols]),
            mat.blocks[rb, slot, m, k], tuple(mat.shape)).coalesce().to_sparse_csr()
        del nz, rb, slot, m, k, cols
        if pack is not None:
            mat.entries = pack(mat)
        for t in ts:
            x = rand(mat.shape[1], t)
            nbytes = 8 * nnz + 4 * (nrb * bm + 1) + 4 * t * (ncols_ref + nrb * bm)
            shape = f"{tag} nrb{nrb} S{s_max} nnz{nnz} t{t}"
            record("B5", shape, lambda: block_ell_spmm_pallas(mat, x), nbytes)
            record("torch.sparse.mm", shape, lambda: torch.sparse.mm(csr, x), nbytes)
        del mat, csr


def stencil_records(a_s, dev, rand, record):
    """B1, B3 and B4 on the headline operator and a 4-rank shard of it."""
    from prealps_tpu_torch.core.layout import contiguous_row_layout, permute_and_pad_matrix
    from prealps_tpu_torch.ops.formats import csr_to_stencil_bsr_t, stencil_blocks_flat
    from prealps_tpu_torch.ops.spmm import (
        extend_wrap,
        stencil_blocks_planar,
        stencil_bsr_spmm_t_pallas,
        stencil_flat_ext,
        stencil_spmm_planar,
    )

    # headline operator, padded as the stencil path pads it (240-row blocks)
    lay = contiguous_row_layout(a_s.shape[0], 1, row_multiple=math.lcm(24, 240))
    head = csr_to_stencil_bsr_t(permute_and_pad_matrix(a_s, lay), br=3,
                                dtype=np.float32, device=dev)
    s_off, br, _, nrb = head.blocks_t.shape
    halo = max(abs(o) for o in head.offsets)
    bf = stencil_blocks_flat(head.blocks_t).contiguous()
    for t in (12, 1):
        x_ext = extend_wrap(rand(br * t, nrb), halo).contiguous()
        record("B1", f"headline br3 t{t}",
               lambda: stencil_flat_ext(bf, head.offsets, x_ext, halo, br),
               4 * (bf.numel() + 2 * br * t * nrb))
    for t in (12, 8, 1):
        x = rand(t, br, nrb)
        record("B3", f"headline br3 t{t}",
               lambda: stencil_bsr_spmm_t_pallas(head, x),
               4 * (head.blocks_t.numel() + 2 * x.numel()))
    # a shard of the headline over 4 ranks (the sharded driver's layout)
    lay4 = contiguous_row_layout(a_s.shape[0], 4, row_multiple=math.lcm(24, 240))
    nrb4 = lay4.rows_per_shard // br
    head4 = csr_to_stencil_bsr_t(permute_and_pad_matrix(a_s, lay4), br=3,
                                 dtype=np.float32, device=dev)
    bf4 = stencil_blocks_flat(head4.blocks_t)[:, nrb4:2 * nrb4].contiguous()
    del head4
    for t in (12, 1):
        x_ext = rand(br * t, nrb4 + 2 * halo)
        record("B1", f"4-rank shard br3 t{t} nrb{nrb4}",
               lambda: stencil_flat_ext(bf4, head.offsets, x_ext, halo, br),
               4 * (bf4.numel() + 2 * br * t * nrb4))
    del bf4
    b3 = stencil_blocks_planar(head.blocks_t).contiguous()
    x2 = rand(12, br * nrb)
    record("B4", "headline br3 t12",
           lambda: stencil_spmm_planar(b3, x2, offsets=head.offsets, br=br, nrb=nrb),
           4 * (b3.numel() + 2 * x2.numel()))
    del bf, b3, x2


def dia_records(a, a_s, dev, rand, record):
    """B1 on the DIA path's table and the unscaled one, B2b on the latter."""
    from prealps_tpu_torch.core.layout import build_row_layout, permute_and_pad_matrix
    from prealps_tpu_torch.ops.formats import dia_ell_host
    from prealps_tpu_torch.ops.spmm import extend_wrap, stencil_flat_ext, stencil_pallas_bs_ext

    # the DIA path's table (scaled: 97 diagonals) and the unscaled one (99)
    lay_d = build_row_layout(a_s, 1, row_multiple=1024)
    for tag, mat in (("DIA D97", permute_and_pad_matrix(a_s, lay_d)), ("DIA D99", a)):
        offsets, diags, _ = dia_ell_host(mat, min_fill=0.05, dtype=np.float32)
        diags = torch.from_numpy(diags).to(dev)
        d_halo = max(abs(o) for o in offsets)
        n = diags.shape[1]
        for t in (12, 1):
            x_ext = extend_wrap(rand(t, n), d_halo).contiguous()
            record("B1", f"{tag} br1 t{t}",
                   lambda: stencil_flat_ext(diags, offsets, x_ext, d_halo, 1),
                   4 * (diags.numel() + 2 * t * n))
        if tag == "DIA D99":
            d_t = diags[:, None, None, :].contiguous()
            x_ext = extend_wrap(rand(12, 1, n), d_halo).contiguous()
            record("B2b", f"{tag} br1 t12",
                   lambda: stencil_pallas_bs_ext(d_t, offsets, x_ext, d_halo),
                   4 * (d_t.numel() + 2 * 12 * n))
            del d_t
        del diags


def lorasc_records(nel, dev, rand, record):
    """B2a and B2b on the LORASC path's operator, f32 and bf16 blocks."""
    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.ops.formats import StencilBsrTMatrix, csr_to_stencil_bsr_t
    from prealps_tpu_torch.ops.spmm import (
        extend_wrap,
        stencil_bsr_spmm_t_pallas_bs,
        stencil_pallas_bs_ext,
    )

    # the LORASC path's operator shape
    het = csr_to_stencil_bsr_t(elasticity3d(nel, nel, nel, heterogeneous=True),
                               br=3, dtype=np.float32, device=dev)
    lor = StencilBsrTMatrix(het.blocks_t, het.offsets, het.shape)
    nrb_l = het.blocks_t.shape[-1]
    halo_l = max(abs(o) for o in het.offsets)
    for t in (12, 8, 1, 97, 256, 4, 16):
        x = rand(t, 3, nrb_l)
        record("B2a", f"lorasc br3 t{t}",
               lambda: stencil_bsr_spmm_t_pallas_bs(lor, x),
               4 * (het.blocks_t.numel() + 2 * x.numel()), reps=5 if t > 16 else 20)
    x_ext = extend_wrap(rand(1, 3, nrb_l), halo_l).contiguous()
    record("B2b", "lorasc br3 t1",
           lambda: stencil_pallas_bs_ext(het.blocks_t, het.offsets, x_ext, halo_l),
           4 * (het.blocks_t.numel() + 2 * 3 * nrb_l))

    # the bf16-block instance (a_store="bf16"), in turns with the f32 one
    lor16 = StencilBsrTMatrix(het.blocks_t.to(torch.bfloat16), het.offsets, het.shape)
    try:
        for t in (12, 8, 1, 256):
            x = rand(t, 3, nrb_l)
            reps = 5 if t > 16 else 20
            for blocks, tag in ((lor, "f32"), (lor16, "bf16"), (lor16, "bf16"),
                                (lor, "f32")):
                record("B2a", f"lorasc {tag} blocks br3 t{t}",
                       lambda: stencil_bsr_spmm_t_pallas_bs(blocks, x),
                       blocks.blocks_t.element_size() * blocks.blocks_t.numel()
                       + 8 * x.numel(), reps=reps)
        for bt, tag in ((het.blocks_t, "f32"), (lor16.blocks_t, "bf16"),
                        (lor16.blocks_t, "bf16"), (het.blocks_t, "f32")):
            record("B2b", f"lorasc {tag} blocks br3 t1",
                   lambda: stencil_pallas_bs_ext(bt, het.offsets, x_ext, halo_l),
                   bt.element_size() * bt.numel() + 8 * 3 * nrb_l)
    except TypeError as e:   # a checkout before the bf16 instance
        print(f"[ab] bf16 blocks not taken by this checkout: {e}", flush=True)
    del het, lor, lor16


def bj_records(rand, record):
    """B6 at the bj and the dia path's block sizes, beside torch.bmm."""
    from prealps_tpu_torch.direct.device_bj import bj_apply_flat, bj_apply_pallas, pack_bj_dense

    for nb, mb, bbr in ((617, 240, 3), (145, 1024, 1)):
        inv = rand(nb, mb, mb)
        b2 = pack_bj_dense(inv)
        z = rand(12, bbr, nb * mb // bbr)
        nbytes = 4 * (inv.numel() + 2 * z.numel())
        record("B6", f"nb{nb} mb{mb} t12", lambda: bj_apply_pallas(b2, z, bbr), nbytes)
        record("torch.bmm", f"nb{nb} mb{mb} t12", lambda: bj_apply_flat(inv, z), nbytes)
        del inv, b2, z


if __name__ == "__main__":
    raise SystemExit(main())
