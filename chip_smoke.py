#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (prealps_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits nonzero before a result is printed):
 1. the card: ``nvidia-smi`` name and power limit, torch's device name;
 2. build the CUDA kernels from prealps_tpu_torch/csrc (one nvcc per
    source, all started together, sm_90a);
2a. ``[native]`` the native host library (prealps_tpu_torch/native.py over
    csrc/host/graph.cpp and mmio.cpp, g++ with native/Makefile's flags):
    it must load, and the default partitioner must be it; the k-way
    partition and the block-arrow structure of elasticity3d(36³) into 8
    parts, native and Python (PREALPS_TPU_NO_NATIVE), timed on the host
    with their separator sizes. Every k-way or block-arrow partition below
    (the sharded and distributed-LORASC phases, [api_*]) is the native one;
 3. the headline path's build at full size: elasticity3d 36³ (n = 147,852),
    stencil format, two-level block Jacobi (240-row blocks), ECG t = 12;
 4. ``[kernel]`` B1 (``stencil_flat_ext``) against its plain PyTorch version
    on the card, at the shapes the path gives it (t = 12 for the solver,
    t = 1 for the refinement residual) plus a br = 1 and a generic shape;
    CUDA-event times of both (median of 5 batches of 20 back-to-back calls
    each, in turns plain, kernel, kernel, plain);
 5. ``[main]`` the headline path: launch counts zeroed, one solve of
    b = default_rng(0).standard_normal(n) to tol 1e-5 (f32 with
    double-float refinement), counts read back; then three timed solves
    and one under torch.profiler (chiprun_out/profile_solve.txt);
 6. ``[small]`` a small f32 solve on the card against a scipy direct solve;
 7. the general-sparse path's build at full size: the same operator,
    fmt="block_ell" (bm 8, bk 128), host block Jacobi (240-row blocks), ECG
    t = 12 odir_fused on row-major panels;
 8. ``[kernel]`` B5 (``block_ell_spmm_pallas``, on the blocks' packed
    nonzero entries) against ``block_ell_spmm`` at the path's shape
    (t = 12), at t = 1 and at bk = 8, timed in turns, with its device time,
    nnz, fill, entries a row, the entry stream's bound beside the block
    slots' and ``torch.sparse.mm`` on the same entries;
 9. ``[general]`` the general path: counts zeroed, one warm solve and three
    timed solves; host f64 relres < 1e-5, no breakdown, B5 launches >=
    iterations, iterations within 5 % of GENERAL_ANCHOR_ITERS (the JAX
    package's CPU run of the same build with fmt="block_ell_xla"); one solve
    under torch.profiler (chiprun_out/profile_general.txt);
 9a. ``[lx]`` the communication-avoiding kernel tier (ops/spmsv.py,
    tsqr.py, cholqr.py, tournament.py) on [general]'s operator (RAC-scaled
    36³) in block-ELL bk 128 with its packed entries and in square 32-row
    blocks: ``spmsv_chain`` (s 8, t 12, from the first 1/8 of the row
    blocks, dense_switch 0.5) through B5 and A-CholQR's two products, B5's
    count zeroed just before and read just after (one launch a product);
    every panel against the same chain through ``block_ell_spmm`` within
    KERNEL_TOL, the support exact; the support fractions and the step at
    which the chain goes dense; ``spmsv_packed`` at active fractions 1/16,
    1/4 and 1: its device time (``timing.py::device_ms`` of
    ``spmsv_packed_device``), its bound (the nonzero entries in B's active
    columns, B and C once), its format bound (C's active rows of dense
    blocks, B and C once) and the dense-carrier B5 product's device time,
    C against B5's product;
    TSQR and A-CholQR of a (n × 12) panel (‖QᵀQ − I‖_F, R against
    ``torch.linalg.qr``'s, ‖P̃ᵀAP̃ − I‖_F, each < LX_ORTH_TOL); TP-QR and
    TP-CUR (k 24) of the chain's s-step basis (n × 108): their error beside
    the best rank-24 error and each step's seconds (``utils/timing.py``'s
    ``Timers`` with the card synchronised), the pivoted Cholesky's among
    them;
10. ``[ell]`` fmt="ell" f32 at elasticity3d 20³ through the device
    double-float refinement rounds;
11. ``[bj]`` the stencil path with precond="bj" (block Jacobi alone, the
    JAX driver's "bj_flat") at full size, within 5 % of the JAX package's
    TPU record of 199 iterations;
12. ``[kernel]`` B6 (``bj_apply_pallas``) on the [bj] build's packed
    inverses at t = 12 against its plain version, with ``torch.bmm`` on the
    unpadded inverses (the driver's apply) timed beside them (and again on
    the [dia] build's 1024-row inverses in phase 20);
12a. ``[api_bj]`` [general]'s matrix through the single-device API:
    ``api.ECGSolver.build(elasticity3d(36³), ECGOptions(t=12, tol=1e-5),
    precond="block_jacobi", dtype=float32)`` (ELL operator, host block
    Jacobi, f32 inner solves to 1e-3 with host-f64 residual rounds): build
    stages, every operand on the card, a warm solve (host f64 relres <
    1e-5, iterations within ANCHOR_BAND of API_ANCHORS, the JAX
    ``ECGSolver`` on a CPU), TTS as the median of three solves, rounds, one
    solve under torch.profiler (chiprun_out/profile_api_bj.txt);
12b. ``[api_lorasc]`` / ``[api_presc]`` the reference's
    elasticity3d_12x10x10 (n = 4,290) at the CLI defaults through
    ``cli.lorasc_main`` (``python -m prealps_tpu_torch.cli lorasc``) on the
    card: -p lorasc (direct eigensolve) and -p presc (ssloc), in f64 (held
    to the JAX CLI's counts ±1) and, -p presc also, f32 (the card's
    default; logged beside JAX's count, relres < 1e-5; the f32 -p lorasc
    run was cut for time); each build again through ECGSolver in
    f64 (its pairs equal JAX's, its count ±1, its operands on the card),
    and ``[api_presc_banded]``: PRESC with ``schur_method="banded"``
    (block_banded_schur on the card), held the same way;
12c. ``[api_lanczos]`` build_lorasc with the Lanczos eigensolve on the card
    against the direct pairs of the same arrow (tests/test_lorasc.py's
    bar: at least min(direct, 3) − 1 pairs), with the eigenvalue gap;
12d. ``[checkpoint]`` ecg_solve_checkpointed on the card (the
    [api_lorasc] build, f64, chunks of 25 iterations): a run in chunks, and
    a run stopped after its first chunk and resumed from its file at
    iteration 25 in the same process; each one's count and x bitwise the
    straight solve's;
13. ``[lorasc]`` the single-GPU LORASC path at full size:
    ``StencilLorascECG.build`` of heterogeneous elasticity3d 36³ (generated
    once and shared by phases 13-19; nparts 8, ECG t = 12 omin,
    max_deflation 256, balancing ("deflate") correction, f32 with
    double-float refinement) as ``bench.py`` configures its het LORASC
    record; build stages, band shapes, deflated pairs (held to the record's
    97 within 10 %) and peak device memory;
14. ``[kernel]`` B2a (``stencil_bsr_spmm_t_pallas_bs``) on that build's
    operator at t = 12, 8, 1 and the build's nev, and B2b
    (``stencil_pallas_bs_ext``) at t = 1, each against its plain version,
    timed in turns;
15. ``[lorasc]`` the path's solve: launch counts zeroed, one warm solve to
    1e-5 (host f64 relres, no breakdown, iterations within 10 % of the
    record's 65, B2a launches >= 3 × iterations, B2b launched), counts read
    back; three timed solves; ``with_tol(1e-8)`` to relres < 1e-8 (the
    record: 128 iterations); one solve under torch.profiler
    (chiprun_out/profile_lorasc.txt) with its device-busy share;
16. ``[presc]`` the PRESC record's configuration (BENCH_r05.json
    ``ecg_tts_elasticity3d_145k_het_presc``): the [lorasc] build with
    ``pencil="sloc"`` and ``factor_store="bf16"``; build stages (the
    ``sloc`` stage among them), the owned separator widths (largest c) and
    peak device memory; deflated pairs within 10 % of the record's 61; a
    solve with B2a's and B2b's counts zeroed (iterations within 10 % of the
    record's 116, host f64 relres < 1e-5, B2a launches >= 3 × iterations,
    B2b launched), three timed solves and one under torch.profiler
    (chiprun_out/profile_presc.txt) with its device-busy share;
17. ``[presc f32]`` the same build with f32 factors (the card's default):
    the same deflated pairs exactly, iterations at most 10 % above the bf16
    run's, three timed solves, ``with_tol(1e-8)`` to relres < 1e-8 (logged
    beside the JAX package's reading of 229 iterations);
18. ``[saloc]`` the [presc] build with ``pencil="saloc"``: a solve to relres
    < 1e-5 without breakdown, its pairs and iterations logged beside the
    JAX package's reading at this size (2 pairs, 317 iterations);
19. ``[lorasc_bf16]`` the [lorasc] build with ``a_store="bf16"`` and
    ``factor_store="bf16"``: ``[kernel]`` lines of B2a's bf16-block
    instance on the build's bf16 sweep table at t 12, 8, 1 and the build's
    nev, and of B2b's at t 1, each against its plain version (KERNEL_TOL)
    and bitwise against the f32 instance on the widened blocks; a solve
    (iterations <= 1.2 × [lorasc]'s + 2, relres < 1e-5, the bf16 instance
    launched >= 2 × iterations) and three timed solves; then
    ``a_store="bf16_all"``, which must reproduce the JAX package's pinned
    failure (breakdown, or relres > 1e-3);
19a. ``[lorasc_f64]`` the same het operator in f64: the f64 deflation
    study's row at max_deflation 256 (``examples/deflation_study_f64.py``:
    8 box parts, t 12 odir_fused to 1e-5, the build's defaults, one ECG
    solve with no refinement) built by ``StencilLorascECG.build(a,
    dtype=np.float64, device=...)``; every operand f64; build stages, pairs
    beside the JAX package's 97, peak device memory; ``[kernel]`` lines of
    B2a's f64 instance at t 12, 1 and nev (256) and of B2b's at t 1,
    each within F64_KERNEL_TOL of its plain f64 version, with its device
    time, its bound at 8 bytes an entry and ``torch.sparse.mm`` of the f64
    CSR; the solve with B2a's counts zeroed (iterations within 5 % of
    LORASC_F64_ANCHOR_ITERS, the JAX package's f64 solve on a CPU; B2a
    launches >= 3 × iterations, every one the f64 instance), three timed
    solves and one under torch.profiler (chiprun_out/profile_lorasc_f64.txt);
20. ``[dia]`` fmt="dia" on lane-major panels at full size: elasticity3d 36³,
    its promoted diagonals (97 after RAC scaling, plus an ELL remainder) as
    a br = 1 stencil, device block Jacobi (1024-row blocks) from the
    diagonals, ECG t = 12, f32 with host-f64 refinement to 1e-5;
    ``[kernel]`` B1 on that table (t 12, t 1) and B1 (t 12, t 1) and B2b
    (t 12) at br 1 × D 99 on the unscaled operator's table; B6 on the
    build's packed block inverses (nb 145, mb 1024, t 12) beside
    ``torch.bmm``; the solve with
    B1's count zeroed
    (launches >= iterations, iterations within 10 % of DIA_ANCHOR_ITERS,
    the JAX package's CPU run of the same build); one solve under
    torch.profiler (chiprun_out/profile_dia.txt) with its device-busy share;
21. ``[auto]`` fmt="auto" on BENCH_r05.json's structure-hidden record
    (elasticity3d 20³ under ``default_rng(5).permutation``, bj with
    240-row blocks, t = 12 on ``nt``, f32, tol 1e-5): the cascade must
    choose Morton block-ELL, iterations within 10 % of the record's 100;
22. ``[spmm]`` the SpMM format sweep (prealps_tpu_torch.examples.bench_spmm)
    at nel = 36, t = 1, 4, 8, 12, 16, all five formats, its JSON lines
    printed; each format's y held to the ELL product within the kernel
    bound; B3 (``stencil_t_pallas``) launched;
23-27. the rest of the one-GPU driver, each a full-size f32 build of the
    headline operator (t 12, odir_fused on tbn, tol 1e-5, device
    double-float refinement) and a solve with B1's count zeroed before it
    and read after it (launches >= iterations), then three timed solves:
    ``[cheb]`` precond="chebyshev" (degree 8, κ 30; bench.py's
    PREALPS_BENCH_PRECOND=chebyshev): iterations within 10 % of
    CHEB_ANCHOR_ITERS, B1 launches >= 8 × iterations, one solve under
    torch.profiler (chiprun_out/profile_cheb.txt);
    ``[dedup]`` precond="bj" with grid= and the default bj_dedupe: x-line
    blocks (37 nodes), "bj_dedup", iterations within 10 % of
    DEDUP_ANCHOR_ITERS; ``[bj_lane]`` bj_dtype="bf16" without dedup: the
    apply's device time beside bj_apply_flat (information), w in f32,
    iterations <= max(1.3 × [bj]'s, [bj]'s + 12); ``[bj2l_nogrid]`` the
    headline with grid=None: iterations within 10 % of
    BJ2L_NOGRID_ANCHOR_ITERS; ``[omin_stacked]`` the headline build solved
    with variant="omin", stacked and unstacked: the stacked count within
    ±1 of the unstacked count plus one per inner solve (the stacked state's
    stop test reads the residual entering the iteration, as in the JAX
    package);
28. ``[sharded_nccl1]`` the headline built and solved through a one-rank
    NCCL group (``parallel/mesh.py``): 130 iterations and x bitwise
    ``[main]``'s, the collectives counted;
29. ``[kernel]`` B1 at a [sharded4] shard's shape (12,400 nodes, halo
    1,407, t 12; rank 1's nodes of the headline table), the library
    yardstick the shard's rows as CSR on the extended panel;
30. ``[sharded4]`` the headline at full width over 4 ranks spawned on this
    card (the ``spawn`` start method; a gloo group, since NCCL takes one
    card a rank): every rank the same x, host f64 relres < 1e-5, no
    breakdown, B1 launched >= iterations on every rank (counts zeroed in
    each rank just before its solve), iterations within 10 % of
    SHARDED4_ANCHOR_ITERS (the JAX driver at nshards 4 on a CPU); rank 0's
    timed solves, which are not a scaling number (4 ranks share one card),
    and one solve of rank 0 under torch.profiler (by host time:
    chiprun_out/profile_sharded4.txt); then in the same ranks the sharded
    LX kernels on a planted (n × 512) matrix made on the card from a seed
    (128 columns a rank, k 32): ``tsqr_r_distributed`` on its rows in f64
    (R within 1e-8 of ``torch.linalg.qr``'s), ``tournament_select_sharded``
    and ``tp_qr_sharded`` on its columns (every rank the same R, Q and ids,
    the planted columns found, Q orthonormal), and the collectives
    ablation: the headline operator with block Jacobi solved for
    ABLATION_ITERS iterations with PREALPS_TIMING_NO_COLLECTIVES off, on,
    on, off (no all-reduce and no ring exchange under it), rank 0's ms an
    iteration each way and comm_frac;
31. ``[sharded_dryrun]`` ``prealps_tpu_torch/dryrun.py``'s three
    DistributedECG paths (``__graft_entry__.dryrun_multichip``'s; het 8³,
    t 2, tol 1e-6) over 4 ranks on the card, stencil+bj2l also over 8 (88
    nodes a shard against a halo of 91: the all-gather branch): f32 (the
    stencil kernel's type), and ell+bj also in f64; stencil+bj2l (f32) and
    ell+bj (f64) within 10 % of the JAX driver's count at the same
    nshards, the f32 stencil+cheb and ell+bj counts logged beside JAX's
    (DRYRUN_ANCHOR_ITERS); every path converged, B1 launched at least once
    an iteration on the stencil paths;
32. ``[dlorasc_large]`` the distributed LORASC driver
    (``parallel/lorasc_driver.py::DistributedLorascECG``) at full width
    over 8 ranks spawned on this card (a gloo group, one spawn shared with
    phase 33): ``examples/demo_large_separator.py``'s configuration,
    heterogeneous elasticity3d 32³ (n = 104,544), 8 groups, f64, ECG t = 4
    odir_fused to 1e-5, the build's defaults otherwise (scaled, Lanczos
    deflation, σ correction, banded separator), b = default_rng(0): the
    groups, ng_max, the separator's padded rows, whether it is banded, the
    deflated pairs, rank 0's build stages and each rank's peak device
    memory; a solve with the collective counts zeroed just before and
    read just after (host f64 relres < 1e-5, no breakdown, every rank the
    same x, iterations within 5 % of DLORASC_LARGE_ANCHOR_ITERS, the JAX
    driver on a CPU with the native partition; the JAX record's 377, from
    the same partition, printed beside), its TTS,
    then the first PROFILE_ITERS iterations of a second solve, rank 0's
    under torch.profiler (device-busy share,
    chiprun_out/profile_dlorasc.txt), and each rank's wall time by step;
33. ``[dlorasc_dryrun]`` ``dryrun.py``'s three LORASC paths (het 8³,
    RAC-scaled, f32, t 2, tol 1e-6) over the same 8 ranks: "lorasc" (the
    exact Schur complement chosen automatically), "lorasc 2-level mesh"
    (mesh (4, 2), max_deflation 16) and "lorasc deflation" (omin,
    exact_schur=False, correction="deflate", max_deflation 64): each to
    relres < 1e-4 (the dry run's 100 × tol), every rank the same x, the
    deflated pairs equal to the JAX driver's on a CPU at the same mesh and
    the counts within ANCHOR_BAND of its counts (DLORASC_DRY_ANCHORS,
    native partition), but for the exact-Schur path, held to the card's
    own 4 (DLORASC_DRY_CARD_ITERS, with its second witness) beside JAX's
    5; MULTICHIP_r05.json's 5, 5 and 88 (19 pairs) printed beside them;
34. ``[sharded_general4]`` the general path ([general]: elasticity3d 36³,
    fmt="block_ell", host block Jacobi with 240-row blocks, t 12 on nt, f32
    with host-f64 rounds) at full width over 4 ranks spawned on this card
    (gloo): the k-way layout in 128-row blocks, each rank B5 on its
    [own ∥ halo] block space after the block halo plan's all-to-all. Every
    rank the same x, host f64 relres < 1e-5, no breakdown, B5 launched >=
    iterations on every rank (counts zeroed just before each rank's
    solve), iterations within 5 % of SHARDED_GENERAL4_ANCHOR_ITERS (the JAX
    driver's ``block_ell_xla`` at nshards 4 on a CPU); each rank's build
    stages, warm and timed solve, collectives and peak device memory; a
    window of PROFILE_ITERS iterations of rank 0 under torch.profiler (its
    device-busy share; by host time: chiprun_out/profile_sharded_general4.txt);
    then ``[kernel]`` B5 at rank 0's shard shape (its row blocks, s_max and
    extended columns; t 12 and t 1) against its plain version, with its
    device time (``timing.py::device_ms``), bound and ``torch.sparse.mm``
    of the shard's packed nonzero entries on its extended panel;
35. ``[sharded_dia4]`` [dia] over 4 ranks (SHARDED_DIA4_NEL³, tbn, bj,
    f32): each rank's promoted diagonals of the k-way layout as a br = 1
    table through B1 on the ring-extended panel, the remainder through its
    halo plan's all-to-all; the checks and the profiled window of phase 34
    with B1 and SHARDED_DIA4_ANCHOR_ITERS
    (chiprun_out/profile_sharded_dia4.txt), and ``[kernel]`` B1 at rank
    0's shard shape (D, halo, its nodes; t 12 and t 1);
36. ``[sharded_formats]`` the JAX tests' small sharded paths in f64 (the
    plain products; SHARDED_FORMATS): the stencil on nt (with ELL on its
    layout: the same count), block-ELL (``block_ell_xla``) and
    ``fmt="auto"`` on a shuffled band (which must choose ``dia_rcm``) over
    4 ranks, DIA on nt over 8: each within ANCHOR_BAND of the JAX driver's
    count at the same nshards (SHARDED_FORMATS_ANCHOR_ITERS), relres < 20 ×
    its tolerance, every rank the same x.

Beside the headline B1 checks, ``[kernel]`` lines hold B3 at t = 12 / 8 / 1
and B4 (planar) at t = 12 on the headline operator against their plain
versions. The bf16 instance's library yardstick is ``torch.sparse.mm`` of
the widened values as an f32 CSR matrix (the same function up to the
storage rounding); its bound counts two bytes a block entry. Every ``[kernel]`` line gives the kernel's and the plain
version's CUDA-event times, its bound (the larger of the bytes the
product needs -- each input read once, each output written once, the
stencil panel without its halo columns, B6's inverses unpadded -- over
3.35 TB/s and its flops over 67 TFLOP/s f32, 34 TFLOP/s f64) and, at each kernel's
first shape, the library yardstick: ``torch.sparse.mm`` of the same
operator as a CSR matrix on the row-major (n, t) panel (cuSPARSE SpMM), and
for B6 ``torch.bmm`` of the unpadded inverses.

The last lines of standard output are a ``[summary]`` JSON line (every
check, every path's numbers), the card's ``nvidia-smi`` name and power
limit, the kernels' JSON record (seven entries; ``ms``/``plain_ms``/
``bound_ms``/``library_ms`` at each kernel's first shape and, under
``shapes``, at every shape checked, B2a's and B2b's with their
``blocks_dtype``, B5's with ``device_ms``, ``format_bound_ms`` (the block
slots' bound) and ``nnz``; ``max_abs_err`` over its shapes, ``launches`` from its
path's run — for B4 and B6, which no path runs, chip_smoke's own calls;
B1's, B2a's, B2b's and B5's entries also list their count on every path's
solve under ``path_launches`` (B1's and B5's also each sharded rank's,
B5's also [lx]'s chain and A-CholQR),
B2a's that of its bf16 instance under
``bf16_launches`` and of its f64 instance under ``f64_launches``), and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 1e-5          # max |y_kernel - y_plain| <= KERNEL_TOL * max(|B|·|x|)
F64_KERNEL_TOL = 1e-13     # the same for the f64 instance (f64 sums, another order)
SOLVE_TOL = 1e-5
TPU_ANCHOR_ITERS = 130     # iterations of the same solve in the JAX package's record
# the general path (block-ELL, host block Jacobi, nt, f32, tol 1e-5): the JAX
# package's run on a CPU with fmt="block_ell_xla" (2 host refinement rounds
# of 97 + 105 iterations, PERF.md)
GENERAL_ANCHOR_ITERS = 202
BJ_ANCHOR_ITERS = 199      # stencil + bj: BENCH_r05.json ..._t12_tol1e-5_bj
ANCHOR_BAND = 0.05
# het LORASC (BENCH_r05.json ecg_tts_elasticity3d_145k_het_lorasc): 65
# iterations and 97 deflated pairs at tol 1e-5; 128 iterations at 1e-8
LORASC_ANCHOR_ITERS = 65
LORASC_ANCHOR_PAIRS = 97
LORASC_DEEP_ANCHOR_ITERS = 128
LORASC_BAND = 0.10
# PRESC (BENCH_r05.json ecg_tts_elasticity3d_145k_het_presc, bench.py:559-579
# and :209-226: the het LORASC build with pencil="sloc", bf16 banded factors
# as the TPU's factor_store="auto" picks them): 116 iterations and 61
# deflated pairs at tol 1e-5, relres 7.85e-6
PRESC_ANCHOR_ITERS = 116
PRESC_ANCHOR_PAIRS = 61
# readings, not bands (docs/PERFORMANCE.md:1034-1037 and :759-763, the JAX
# package on a TPU; iteration counts only): PRESC with_tol(1e-8) 229
# iterations; SALOC at this size 2 pairs and 317 iterations
PRESC_DEEP_READING = 229
SALOC_READING = (2, 317)
# [lorasc_f64]: the f64 deflation study's row at max_deflation 256
# (prealps_tpu_torch/examples/deflation_study_f64.py: het 36³, 8 box parts,
# t 12 odir_fused to 1e-5, the build's defaults, f64, no refinement): the
# JAX StencilLorascECG on a CPU (python -m tests.test_torch_anchors --path
# lorasc_f64 --nel 36): 54 iterations, 97 pairs, relres 6.99e-6 (the JAX
# study's record, docs/PERFORMANCE.md:472-492, had 70 and 75 pairs at 256
# from an older package; its 512 row is 54 and 97)
LORASC_F64_DEFLATION = 256
LORASC_F64_ANCHOR_ITERS = 54
LORASC_F64_ANCHOR_PAIRS = 97
# fmt="dia" on lane-major panels (elasticity3d 36³, bj, t 12, f32, tol 1e-5):
# the JAX package's run of the same build on a CPU
# (python -m tests.test_torch_anchors --nel 36: 182 iterations in 2 host
# refinement rounds, relres 1.0e-7)
DIA_ANCHOR_ITERS = 182
# fmt="auto" on the shuffled elasticity3d(20³) (BENCH_r05.json
# ecg_tts_elasticity3d_shuffled_26k_bj: Morton block-ELL, 100 iterations)
AUTO_ANCHOR_ITERS = 100
# the rest of the one-GPU driver (elasticity3d 36³, t 12, f32, tol 1e-5): the
# JAX package's runs of the same builds on a CPU
# (python -m tests.test_torch_anchors --path cheb|dedup|bj2l_nogrid --nel 36,
# each in 2 refinement rounds, relres 5.0e-7 / 5.0e-7 / 5.4e-7)
CHEB_ANCHOR_ITERS = 44          # precond="chebyshev", degree 8, κ 30
DEDUP_ANCHOR_ITERS = 234        # precond="bj", grid=, bj_dedupe: x-line blocks
BJ2L_NOGRID_ANCHOR_ITERS = 182  # precond="bj2l", grid=None
PATH_BAND = 0.10
# the sharded phases (the JAX driver over nshards CPU devices, f32:
# python -m tests.test_torch_anchors --path P --nshards N [--nel 36]
# [--dtype f64] --native). Both packages partition with the native host
# library by default, so the phases built on a k-way or block-arrow
# partition are held to the JAX counts under it (--native); the Python
# algorithm's counts (PREALPS_TPU_NO_NATIVE, without --native) are kept
# in the comments. [sharded4]: the headline at nshards 4 (n_pad 148,800;
# the stencil format's contiguous layout, no k-way partition), 131
# iterations in 2 rounds, relres 5.3e-7.
SHARDED4_ANCHOR_ITERS = 131
# [sharded_dryrun]: __graft_entry__.dryrun_multichip's DistributedECG paths
# (het elasticity3d 8³, RAC-scaled, t 2, tol 1e-6, f32). JAX on a CPU:
# nshards 4: stencil+cheb 1662, ell+bj 1025 (Python partition 967),
# stencil+bj2l 531; nshards 8: stencil+bj2l 559 (MULTICHIP_r05.json, 8
# shards: 1312 / 957 / 559); ell+bj in f64 at nshards 4: 162 (Python 192);
# the stencil paths keep their contiguous layout under either partitioner.
# Held to PATH_BAND: stencil+bj2l (f32) and
# ell+bj (f64). The f32 counts of stencil+cheb and ell+bj are logged beside
# JAX's only: at t 2 on the het operator they hinge on whether an f32 inner
# solve ends at a stall window (250 iterations), which follows the
# rounding, and they part between the packages on one shard already.
DRYRUN_ANCHOR_ITERS = {("dry_stencil_cheb", "f32", 4): 1662,
                       ("dry_ell_bj", "f32", 4): 1025,
                       ("dry_stencil_bj2l", "f32", 4): 531,
                       ("dry_stencil_bj2l", "f32", 8): 559,
                       ("dry_ell_bj", "f64", 4): 162}
DRYRUN_HELD = {("dry_stencil_bj2l", "f32"), ("dry_ell_bj", "f64")}
MULTICHIP_R05 = {"dry_stencil_cheb": 1312, "dry_ell_bj": 957, "dry_stencil_bj2l": 559}
# the distributed LORASC phases (the JAX DistributedLorascECG on a CPU,
# native block-arrow partition: python -m tests.test_torch_anchors --path P
# --nshards 8 | --mesh 4,2 --native). [dlorasc_large]: demo_large_separator.py's
# configuration at 8 groups (f64): 405 iterations, 1 pair, 18,152 padded
# separator rows (the Python partition: 425). Its JAX record, 377
# iterations (docs/PERFORMANCE.md, "Large-separator distributed LORASC"),
# has the same 18,152 rows but was not reproduced on a CPU; it is printed
# beside.
DLORASC_LARGE_ANCHOR_ITERS = 405
DLORASC_LARGE_RECORD_ITERS = 377
# [dlorasc_dryrun]: dryrun_multichip's LORASC paths (het 8³, f32, t 2, tol
# 1e-6); (iterations, deflated pairs) of the JAX driver on a CPU at the
# same mesh, native partition (Python partition: (4, 828), (4, 594),
# (61, 21)), and MULTICHIP_r05.json's (native partition) beside them
DLORASC_DRY_ANCHORS = {"dry_lorasc": (5, 786), "dry_lorasc_2level": (5, 562),
                       "dry_lorasc_deflation": (88, 19)}
DLORASC_DRY_R05 = {"dry_lorasc": "5", "dry_lorasc_2level": "5",
                   "dry_lorasc_deflation": "88 (19 pairs)"}
# the card's count where it is not JAX's: "dry_lorasc"'s second refinement
# round meets the inner 1e-3 in 2 counted iterations on the card
# (‖r‖/‖rhs‖ 7.5e-4) and in 3 on the host, the f32 rounding of a near-exact
# preconditioner deciding. The second witness of the card's 4: the card's
# build solved on the host and the host's build solved on the card take 4
# too; only the host's build solved on the host takes JAX's 5 (python -m
# prealps_tpu_torch.examples.dlorasc_dry_devices, on the H100)
DLORASC_DRY_CARD_ITERS = {"dry_lorasc": 4}
# the sharded driver's other formats (the JAX driver over nshards CPU
# devices, the native k-way partition: python -m tests.test_torch_anchors
# --path sharded_general4|sharded_dia4 --nel N --nshards 4 and --path
# sharded_formats, each with --native). [sharded_general4]: [general] over
# 4 ranks, the JAX driver's fmt="block_ell_xla" (its Pallas block-ELL is
# too slow in interpret mode at this size, and sums in f32 anyway): n_pad
# 159,744, 192 iterations in 2 host refinement rounds, relres 1.4e-8 (the
# Python partition: n_pad 155,648, 193).
SHARDED_GENERAL4_ANCHOR_ITERS = 192
# [sharded_dia4]: [dia] over 4 ranks, at SHARDED_DIA4_NEL: n_pad 159,744,
# 188 iterations in 2 rounds, relres 2.9e-8 (the Python partition: n_pad
# 155,648, 189).
SHARDED_DIA4_ANCHOR_ITERS = 188
SHARDED_DIA4_NEL = 36
# [sharded_formats]: (ranks, problem, build keywords, ECGOptions fields) of
# the JAX tests' sharded paths (tests/test_distributed.py:98-108, :79-83 and
# :440-456, tests/test_spmm.py:541-560), f64; ``auto`` keeps the row-major
# layout the JAX driver picks off a TPU (on a card auto_layout would take
# tbn, whose kernel is f32). The JAX driver's counts at the same nshards:
SHARDED_FORMATS = {
    "stencil_nt": (4, "ela", dict(fmt="stencil", br=3, precond="block_jacobi"),
                   dict(t=4, tol=1e-6, maxiter=2000, variant="odir_fused",
                        layout="nt")),
    "block_ell_xla": (4, "ela", dict(fmt="block_ell_xla", precond="block_jacobi"),
                      dict(t=4, tol=1e-8, maxiter=2000, variant="odir_fused",
                           layout="nt")),
    "auto": (4, "band", dict(fmt="auto", precond="block_jacobi", auto_layout=False),
             dict(t=2, tol=1e-10, maxiter=400, layout="nt")),
    "dia_nt": (8, "ela_b5", dict(fmt="dia", precond="block_jacobi"),
               dict(t=4, tol=1e-8, maxiter=2000, layout="nt")),
}
# (the native partition; the Python one gave 55, 51, 11 and 63)
SHARDED_FORMATS_ANCHOR_ITERS = {"stencil_nt": 55, "block_ell_xla": 47, "auto": 8,
                                "dia_nt": 55}
# the general-matrix single-device API (prealps_tpu_torch/api.py::ECGSolver):
# (elasticity3d keywords, precond, build keywords, ECGOptions fields).
# [api_bj] is [general]'s matrix (homogeneous 36³); [api_lorasc] and
# [api_presc] are the
# reference's elasticity3d_12x10x10 at the CLI's defaults (lorasc_main:
# 8 parts, t 4, tol 1e-5, odir_fused, σ correction, b from seed 0), PRESC
# also with the banded local Schur complements (block_banded_schur).
API_CLI_OPTS = dict(t=4, tol=1e-5, maxiter=10000, variant="odir_fused")
API_CASES = {
    "api_bj": (dict(nx=36, ny=36, nz=36, heterogeneous=False), "block_jacobi", {},
               dict(t=12, tol=1e-5, maxiter=3000, variant="odir_fused")),
    "api_lorasc": (dict(nx=12, ny=10, nz=10), "lorasc",
                   dict(nparts=8, deflation_tol=1e-2, eig_method="direct"), API_CLI_OPTS),
    "api_presc": (dict(nx=12, ny=10, nz=10), "presc",
                  dict(nparts=8, deflation_tol=1e-2, eigs_kind="ssloc"), API_CLI_OPTS),
    "api_presc_banded": (dict(nx=12, ny=10, nz=10), "presc",
                         dict(nparts=8, deflation_tol=1e-2, eigs_kind="ssloc",
                              schur_method="banded"), API_CLI_OPTS),
}
# the JAX ECGSolver's counts on a CPU (python -m tests.test_torch_anchors
# --path P --dtype f32|f64; the native partition, JAX's default) and the
# pairs its LORASC / PRESC build deflates: [api_bj]'s f32 count (held
# within ANCHOR_BAND); the CLI cases' f64 counts (held ±1) and f32 counts
# (logged beside the port's: they part with the rounding, ROADMAP A4).
API_ANCHORS = {
    "api_bj": 181,
    "api_lorasc": {"f64": 50, "pairs": 27},
    "api_presc": {"f64": 63, "f32": 2247, "pairs": 27},
    "api_presc_banded": {"f64": 63, "pairs": 27},
}
SHARDED_TIMEOUT = 420      # seconds a spawn of ranks may take before they are killed
# yardsticks: one H100 SXM's HBM3 rate and f32 rate outside the tensor cores
# (NVIDIA's data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12          # f64 outside the tensor cores


def sharded_formats_problem(name, elasticity3d):
    """The (a, b) of a [sharded_formats] problem, from either package's
    generator (they are bitwise equal): het elasticity3d(6,5,5) with b
    from default_rng(42) ("ela") or default_rng(5) ("ela_b5"), or the
    5-diagonal band of n 2,400 under default_rng(42)'s permutation, b from
    the same generator ("band")."""
    import numpy as np
    import scipy.sparse as sp

    if name == "band":
        n = 2400
        rng = np.random.default_rng(42)
        band = sp.diags([np.ones(n - 3), np.ones(n - 1), 5.0 * np.ones(n),
                         np.ones(n - 1), np.ones(n - 3)], [-3, -1, 0, 1, 3]).tocsr()
        pm = rng.permutation(n)
        return sp.csr_matrix(band[pm][:, pm]), rng.standard_normal(n)
    a = elasticity3d(6, 5, 5)
    seed = 5 if name == "ela_b5" else 42
    return a, np.random.default_rng(seed).standard_normal(a.shape[0])


def api_problem(path, elasticity3d):
    """The (a, b) of an [api_*] phase from either package's generator (they
    are bitwise equal): API_CASES' elasticity3d, b from default_rng(0) (the
    CLI's --seed 0)."""
    import numpy as np

    a = elasticity3d(**API_CASES[path][0])
    return a, np.random.default_rng(0).standard_normal(a.shape[0])


def _size_arg(problem) -> str:
    return f"{problem['nx']}x{problem['ny']}x{problem['nz']}"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def event_ms(fn, reps: int = 20, batches: int = 5, warm: int = 3):
    """CUDA-event time of one fn() call in ms: each of ``batches`` samples is
    ``reps`` calls back to back between two events, divided by ``reps`` (so
    the host's launch path overlaps the device work, as it does in a solve).
    Returns (median, samples)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(times), times


def bound(nbytes: float, flops: float, flops_rate: float = F32_FLOPS) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the HBM
    rate and its operations over the rate of their type (f32 unless
    ``flops_rate`` says otherwise)."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / flops_rate
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def stencil_csr(blocks_t, offsets):
    """The stencil operator (S, br, br, nrb) as a torch CSR matrix on its
    device, its zero (boundary) entries dropped: the library yardstick's
    operand (torch.sparse.mm, cuSPARSE SpMM on a row-major (n, t) panel)."""
    import torch

    _, br, _, nrb = blocks_t.shape
    r = torch.arange(nrb, device=blocks_t.device)
    rows, cols, vals = [], [], []
    for s_i, off in enumerate(offsets):
        c = r + off
        inside = (c >= 0) & (c < nrb)
        for m in range(br):
            for k in range(br):
                v = blocks_t[s_i, m, k]
                keep = inside & (v != 0)
                rows.append(r[keep] * br + m)
                cols.append(c[keep] * br + k)
                vals.append(v[keep])
    n = nrb * br
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                  torch.cat(vals), (n, n)).coalesce()
    return coo.to_sparse_csr()


def stencil_csr_ext(blocks_t, offsets, halo):
    """A shard's stencil rows (S, br, br, nrb) as a torch CSR matrix on the
    columns of its extended panel (nrb + 2·halo nodes): the same function
    as B1 on a pre-extended panel, for the torch.sparse.mm yardstick."""
    import torch

    _, br, _, nrb = blocks_t.shape
    r = torch.arange(nrb, device=blocks_t.device)
    rows, cols, vals = [], [], []
    for s_i, off in enumerate(offsets):
        for m in range(br):
            for k in range(br):
                v = blocks_t[s_i, m, k]
                keep = v != 0
                rows.append(r[keep] * br + m)
                cols.append((r[keep] + halo + off) * br + k)
                vals.append(v[keep])
    shape = (nrb * br, (nrb + 2 * halo) * br)
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                  torch.cat(vals), shape).coalesce()
    return coo.to_sparse_csr()


def scipy_csr(a, dev):
    """A scipy CSR matrix as an f32 torch CSR matrix on the card."""
    import numpy as np
    import torch

    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)),
        torch.from_numpy(a.indices.astype(np.int64)),
        torch.from_numpy(a.data.astype(np.float32)), a.shape).to(dev)


def entries_csr(mat):
    """A block-ELL operator's packed nonzero entries (``mat.entries``) as an
    f32 torch CSR matrix on their device: the library yardstick's operand,
    the same entries the kernel reads."""
    import torch

    e = mat.entries
    return torch.sparse_csr_tensor(e.row_ptr.long(), e.cols.long(), e.vals,
                                   tuple(mat.shape))


def library_ms(csr, t, seed):
    """CUDA-event time of one torch.sparse.mm of the operator on an (n, t)
    panel: the library call that computes the kernel's function."""
    import numpy as np
    import torch

    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (csr.shape[1], t))).to(device=csr.device, dtype=csr.dtype)
    ms, _ = event_ms(lambda: torch.sparse.mm(csr, x), reps=10)
    return ms


def check_kernel(name, blocks_flat, offsets, halo, br, t, seed, csr=None,
                 device_time=False):
    """Kernel vs plain version on the card for one shape; returns a record
    (with the cuSPARSE yardstick where ``csr`` is given, and with
    ``device_time`` the kernel's device time by ``timing.py::device_ms``)."""
    import numpy as np
    import torch

    from prealps_tpu_torch.ops.spmm import (
        extend_wrap,
        stencil_flat_ext,
        stencil_flat_ext_ref,
    )

    nrb = blocks_flat.shape[1]
    rng = np.random.default_rng(seed)
    xf = torch.from_numpy(rng.standard_normal((br * t, nrb)).astype(np.float32))
    x_ext = extend_wrap(xf.to(blocks_flat.device), halo).contiguous()
    y_k = stencil_flat_ext(blocks_flat, offsets, x_ext, halo, br)
    y_p = stencil_flat_ext_ref(blocks_flat, offsets, x_ext, halo, br)
    scale = stencil_flat_ext_ref(blocks_flat.abs(), offsets, x_ext.abs(), halo, br)
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max())
    err_bound = KERNEL_TOL * float(scale.max())
    if not bool(torch.isfinite(y_k).all()):
        fail(f"{name}: kernel output not finite")
    if err > err_bound:
        fail(f"{name}: max|kernel - plain| = {err:.3e} > {err_bound:.3e}")
    # the bytes the product needs: the unextended panel (the halo columns
    # are copies of it)
    nbytes = 4 * (blocks_flat.numel() + xf.numel() + y_k.numel())
    rec = {"shape": name, "br": br, "t": t, "S": len(offsets), "nrb": nrb,
           "halo": halo, "max_abs_err": err, "err_bound": err_bound,
           **in_turns(lambda: stencil_flat_ext(blocks_flat, offsets, x_ext, halo, br),
                      lambda: stencil_flat_ext_ref(blocks_flat, offsets, x_ext, halo, br),
                      nbytes),
           **bound(nbytes, 2 * len(offsets) * br * br * t * nrb),
           "library_ms": None if csr is None else library_ms(csr, t, seed)}
    if device_time:
        rec["device_ms"] = kernel_device_ms(
            lambda: stencil_flat_ext(blocks_flat, offsets, x_ext, halo, br))
    log_kernel(name, f"br={br} t={t} S={len(offsets)} nrb={nrb}", rec)
    return rec


def kernel_device_ms(fn) -> float:
    """Device time of one call by ``prealps_tpu_torch/timing.py::device_ms``
    (the calls enqueued behind a spin kernel)."""
    from prealps_tpu_torch.timing import device_ms

    return device_ms(fn)[0]


def log_kernel(name, shape, rec):
    lib = ("" if rec.get("library_ms") is None
           else f" library {rec['library_ms']:.4f} ms")
    if "device_ms" in rec:
        lib += f"; device time {rec['device_ms']:.4f} ms"
    log(f"[kernel] {name}: {shape} max_abs_err={rec['max_abs_err']:.3e} (bound "
        f"{rec['err_bound']:.3e}) kernel {rec['ms']:.4f} ms ({rec['GBps']:.0f} "
        f"GB/s, {rec['reckoned_MB']:.1f} MB) plain {rec['plain_ms']:.4f} ms "
        f"({rec['plain_GBps']:.0f} GB/s) bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}){lib}")


def in_turns(kernel_fn, plain_fn, nbytes, reps=20):
    """CUDA-event times of a kernel and its plain version, in turns plain,
    kernel, kernel, plain; GB/s from the reckoned bytes of one call."""
    p1, pt1 = event_ms(plain_fn, reps=reps)
    k1, kt1 = event_ms(kernel_fn, reps=reps)
    k2, kt2 = event_ms(kernel_fn, reps=reps)
    p2, pt2 = event_ms(plain_fn, reps=reps)
    ms = statistics.median(kt1 + kt2)
    plain_ms = statistics.median(pt1 + pt2)
    return {"ms": ms, "plain_ms": plain_ms, "reckoned_MB": nbytes / 1e6,
            "GBps": nbytes / (ms * 1e-3) / 1e9,
            "plain_GBps": nbytes / (plain_ms * 1e-3) / 1e9,
            "runs_ms": {"plain": [p1, p2], "kernel": [k1, k2]}}


def check_lane(name, a_t, t, seed, ext=False, b3=False, csr=None,
               device_time=False):
    """B2a (B2b with ``ext``, B3 with ``b3``) against its plain version on
    the card at width t; returns a record. On bf16 blocks (B2a, B2b) the
    kernel's output must also be bitwise the f32 instance's on the widened
    blocks (the same sums in the same order). On f64 blocks the panel is
    f64 (the f64 instance), held within F64_KERNEL_TOL, its bound at 8
    bytes an entry and the f64 rate. With ``device_time`` the record adds
    the kernel's device time (``timing.py::device_ms``)."""
    import numpy as np
    import torch

    from prealps_tpu_torch.ops.formats import StencilBsrTMatrix
    from prealps_tpu_torch.ops.spmm import (
        extend_wrap,
        stencil_bsr_spmm_t_pallas,
        stencil_bsr_spmm_t_pallas_bs,
        stencil_pallas_bs_ext,
        stencil_scan_accumulate,
    )

    s_max, br, _, nrb = a_t.blocks_t.shape
    halo = max(abs(o) for o in a_t.offsets)
    f64 = a_t.blocks_t.dtype == torch.float64
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (t, br, nrb))).to(device=a_t.blocks_t.device,
                          dtype=torch.float64 if f64 else torch.float32)
    x_ext = extend_wrap(x, halo).contiguous()

    def product(mat):
        if ext:
            return stencil_pallas_bs_ext(mat.blocks_t, mat.offsets, x_ext, halo)
        if b3:
            return stencil_bsr_spmm_t_pallas(mat, x)
        return stencil_bsr_spmm_t_pallas_bs(mat, x)

    kernel = lambda: product(a_t)
    plain = lambda: stencil_scan_accumulate(a_t.blocks_t, a_t.offsets, x_ext, halo)
    y_k = kernel()
    y_p = plain()
    bf16 = a_t.blocks_t.dtype == torch.bfloat16
    wide = a_t.blocks_t.float() if bf16 else a_t.blocks_t
    scale = stencil_scan_accumulate(wide.abs(), a_t.offsets, x_ext.abs(), halo)
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max())
    err_bound = (F64_KERNEL_TOL if f64 else KERNEL_TOL) * float(scale.max())
    del scale, y_p
    if not bool(torch.isfinite(y_k).all()) or y_k.dtype != x.dtype:
        fail(f"{name}: kernel output not finite or not {x.dtype}")
    if err > err_bound:
        fail(f"{name}: max|kernel - plain| = {err:.3e} > {err_bound:.3e}")
    if bf16 and not torch.equal(
            y_k, product(StencilBsrTMatrix(wide, a_t.offsets, a_t.shape))):
        fail(f"{name}: the bf16 instance is not bitwise the f32 instance on the "
             "widened blocks")
    del wide
    nbytes = (a_t.blocks_t.element_size() * a_t.blocks_t.numel()
              + x.element_size() * (x.numel() + y_k.numel()))
    rec = {"shape": name, "br": br, "t": t, "S": s_max, "nrb": nrb, "halo": halo,
           "blocks_dtype": "bf16" if bf16 else "f64" if f64 else "f32",
           "max_abs_err": err, "err_bound": err_bound,
           **in_turns(kernel, plain, nbytes, reps=5 if t > 12 else 20),
           **bound(nbytes, 2 * s_max * br * br * t * nrb,
                   F64_FLOPS if f64 else F32_FLOPS),
           "library_ms": None if csr is None else library_ms(csr, t, seed)}
    if device_time:
        rec["device_ms"] = kernel_device_ms(kernel)
    log_kernel(name, f"br={br} t={t} S={s_max} nrb={nrb}", rec)
    return rec


def check_planar(name, blocks_t, offsets, t, seed, csr=None):
    """B4 (planar panel, plane-major blocks) against its plain version on
    the card at width t; returns a record."""
    import numpy as np
    import torch

    from prealps_tpu_torch.ops.spmm import (
        stencil_blocks_planar,
        stencil_spmm_planar,
        stencil_spmm_planar_ref,
    )

    s_max, br, _, nrb = blocks_t.shape
    b3 = stencil_blocks_planar(blocks_t).contiguous()
    x2 = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (t, br * nrb)).astype(np.float32)).to(blocks_t.device)
    kw = dict(offsets=offsets, br=br, nrb=nrb)
    kernel = lambda: stencil_spmm_planar(b3, x2, **kw)
    plain = lambda: stencil_spmm_planar_ref(b3, x2, **kw)
    y_k = kernel()
    y_p = plain()
    scale = stencil_spmm_planar_ref(b3.abs(), x2.abs(), **kw)
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max())
    err_bound = KERNEL_TOL * float(scale.max())
    del scale, y_p
    if not bool(torch.isfinite(y_k).all()):
        fail(f"{name}: kernel output not finite")
    if err > err_bound:
        fail(f"{name}: max|kernel - plain| = {err:.3e} > {err_bound:.3e}")
    nbytes = 4 * (b3.numel() + x2.numel() + y_k.numel())
    rec = {"shape": name, "br": br, "t": t, "S": s_max, "nrb": nrb,
           "max_abs_err": err, "err_bound": err_bound,
           **in_turns(kernel, plain, nbytes),
           **bound(nbytes, 2 * s_max * br * br * t * nrb),
           "library_ms": None if csr is None else library_ms(csr, t, seed)}
    log_kernel(name, f"br={br} t={t} S={s_max} nrb={nrb}", rec)
    return rec


def check_block_ell(name, mat, t, seed):
    """B5 against block_ell_spmm on the card for one shape, its packed
    entries made first where the matrix has none; returns a record with
    the kernel's device time (``timing.py::device_ms``) and
    ``torch.sparse.mm`` on the same entries. The bound is the entry
    stream's (8 bytes an entry, the row pointers, the X rows the entries
    reference once, y once); the
    block slots' bound (PR 2's format) is kept beside it as
    ``format_bound_ms``."""
    import numpy as np
    import torch

    from prealps_tpu_torch.ops.formats import BlockEllMatrix, pack_block_ell_entries
    from prealps_tpu_torch.ops.spmm import block_ell_spmm, block_ell_spmm_pallas

    if mat.entries is None:
        mat.entries = pack_block_ell_entries(mat)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((mat.shape[1], t)).astype(
        np.float32)).to(mat.blocks.device)
    y_k = block_ell_spmm_pallas(mat, x)
    y_p = block_ell_spmm(mat, x)
    scale = block_ell_spmm(BlockEllMatrix(mat.blocks.abs(), mat.blkcols,
                                          mat.shape), x.abs())
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max())
    err_bound = KERNEL_TOL * float(scale.max())
    del scale, y_p
    if not bool(torch.isfinite(y_k).all()):
        fail(f"{name}: kernel output not finite")
    if err > err_bound:
        fail(f"{name}: max|kernel - plain| = {err:.3e} > {err_bound:.3e}")
    nrb, s_max, bm, bk = mat.blocks.shape
    n = nrb * bm
    nnz = mat.entries.nnz
    per_row = torch.diff(mat.entries.row_ptr)
    # X: the rows the entries reference (a shard's halo slots are padded)
    ncols_ref = int(torch.unique(mat.entries.cols).numel())
    nbytes = 8 * nnz + 4 * (n + 1) + 4 * t * ncols_ref + 4 * y_k.numel()
    format_nbytes = (4 * (mat.blocks.numel() + x.numel() + y_k.numel())
                     + 4 * mat.blkcols.numel())
    csr = entries_csr(mat)
    rec = {"shape": name, "nrb": nrb, "S": s_max, "bm": bm, "bk": bk, "t": t,
           "nnz": nnz, "fill": nnz / mat.blocks.numel(), "ncols_ref": ncols_ref,
           "entries_per_row_max": int(per_row.max()),
           "entries_per_row_mean": nnz / n,
           "max_abs_err": err, "err_bound": err_bound,
           **in_turns(lambda: block_ell_spmm_pallas(mat, x),
                      lambda: block_ell_spmm(mat, x), nbytes, reps=10),
           **bound(nbytes, 2 * nnz * t),
           "format_bound_ms": bound(format_nbytes, 2 * nrb * s_max * bm * bk * t)["bound_ms"],
           "library_ms": library_ms(csr, t, seed),
           "device_ms": kernel_device_ms(lambda: block_ell_spmm_pallas(mat, x))}
    del csr
    log_kernel(name, f"nrb={nrb} S={s_max} bm={bm} bk={bk} ncols={mat.shape[1]} "
               f"referenced {ncols_ref} t={t} "
               f"nnz={nnz} fill={100 * rec['fill']:.2f} % entries/row "
               f"max {rec['entries_per_row_max']} mean {rec['entries_per_row_mean']:.1f}; "
               f"block-slot bound {rec['format_bound_ms']:.4f} ms", rec)
    return rec


def check_bj_apply(inv_f, br, t, seed):
    """B6 against its plain version, and torch.bmm on the unpadded inverses
    (the driver's apply), on the card; returns a record."""
    import numpy as np
    import torch

    from prealps_tpu_torch.direct.device_bj import (
        bj_apply_flat,
        bj_apply_pallas,
        bj_apply_pallas_ref,
        pack_bj_dense,
    )

    nb, mb, _ = inv_f.shape
    b2 = pack_bj_dense(inv_f)
    nrb = nb * mb // br
    z = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (t, br, nrb)).astype(np.float32)).to(inv_f.device)
    w_k = bj_apply_pallas(b2, z, br)
    w_p = bj_apply_pallas_ref(b2, z, br)
    scale = bj_apply_pallas_ref(b2.abs(), z.abs(), br)
    torch.cuda.synchronize()
    err = float((w_k - w_p).abs().max())
    err_bmm = float((w_k - bj_apply_flat(inv_f, z)).abs().max())
    err_bound = KERNEL_TOL * float(scale.max())
    if not bool(torch.isfinite(w_k).all()):
        fail("bj_apply_pallas: kernel output not finite")
    if max(err, err_bmm) > err_bound:
        fail(f"bj_apply_pallas: max|kernel - plain| = {err:.3e}, "
             f"|kernel - bmm| = {err_bmm:.3e} > {err_bound:.3e}")
    # the bytes and flops the product needs: the unpadded inverses, not the
    # kernel's table padded to mbp rows
    nbytes = 4 * (inv_f.numel() + 2 * z.numel())
    mbp = b2.shape[1]
    rec = {"shape": f"nb={nb} mb={mb} mbp={mbp} t={t}", "t": t,
           "max_abs_err": err, "max_abs_err_vs_bmm": err_bmm, "err_bound": err_bound,
           **in_turns(lambda: bj_apply_pallas(b2, z, br),
                      lambda: bj_apply_pallas_ref(b2, z, br), nbytes),
           **bound(nbytes, 2 * nb * mb * mb * t)}
    # the library yardstick: one torch.bmm of the unpadded inverses (the
    # driver's apply)
    bmm_ms, _ = event_ms(lambda: bj_apply_flat(inv_f, z))
    rec["library_ms"] = bmm_ms
    rec["bmm_GBps"] = nbytes / (bmm_ms * 1e-3) / 1e9
    log_kernel("bj_apply_pallas", rec["shape"] + f" (vs bmm {err_bmm:.3e})", rec)
    return rec


def profile_solve(solver, b, name):
    """One solve under torch.profiler, the device's activity only (with the
    host's operator events too, reading the trace of one LORASC-family
    solve took 45-105 s); the table goes to chiprun_out/. Returns (device
    ms, wall ms) of the profiled solve."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from prealps_tpu_torch.timing import device_busy_ms

    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(b)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40)
    with open(os.path.join(HERE, "chiprun_out", f"profile_{name}.txt"), "w") as f:
        f.write(table)
    busy_ms = device_busy_ms(prof)
    log(f"[profile] one {name} solve by device time (device {busy_ms:.1f} ms "
        f"of {wall_ms:.1f} ms wall, busy {100 * busy_ms / wall_ms:.0f} %):")
    for line in table.splitlines()[:15]:
        log("[profile] " + line)
    return busy_ms, wall_ms


def timed_solves(solver, b, iters, tag):
    """Three timed solves (host clock around work that ends in a sync)."""
    import torch

    timed = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ik = solver.solve(b)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        if int(ik["iters"]) != iters or ik["breakdown"]:
            log(f"[{tag}] note: timed solve ran {ik['iters']} iterations")
    return timed


def checked_solve(solver, a, b, tag, counter=None):
    """One solve with the launch count zeroed just before and read just
    after; fails on a wrong shape, non-finite values, breakdown or host f64
    relres >= SOLVE_TOL. Returns (info dict, launches, seconds)."""
    import numpy as np
    import torch

    if counter is not None:
        counter.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counter.launches if counter is not None else None
    relres = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    if x.shape != (a.shape[0],) or not np.all(np.isfinite(x)):
        fail(f"[{tag}] solution not finite or of the wrong shape")
    if info["breakdown"]:
        fail(f"[{tag}] ECG breakdown")
    if not relres < SOLVE_TOL:
        fail(f"[{tag}] host f64 relres {relres:.3e} >= {SOLVE_TOL}")
    info = dict(info, relres=relres)
    info.pop("history", None)
    return info, launches, secs


def within(iters, anchor, band=ANCHOR_BAND):
    return abs(iters - anchor) <= band * anchor


def lorasc_build(a, nel, dev, **kw):
    """StencilLorascECG.build of the het operator in the configuration of
    the JAX package's het LORASC record (bench.py:209-226): 8 box parts,
    ECG t = 12 omin, nev 256, the balancing ("deflate") correction, f32 with
    double-float refinement to 1e-5; ``kw`` adds the pencil and the stores.
    Returns (solver, build seconds, peak device GB)."""
    import numpy as np
    import torch

    from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = StencilLorascECG.build(
        a, nparts=8, br=3, grid=(nel + 1, nel + 1, nel),
        opts=ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000, variant="omin",
                        layout="tbn"),
        max_deflation=256, correction="deflate", inner_tol=1e-3,
        dtype=np.float32, device=dev, **kw)
    torch.cuda.synchronize()
    return (solver, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated(dev) / 1e9)


def lorasc_phase(dev, a, b, nel=36):
    """Phases 13-15: the single-GPU LORASC path at full size (nel = 36) on
    the het operator ``a``. Returns (B2a checks, B2b checks, path record,
    B2a launches, B2b launches)."""
    import numpy as np
    import torch

    from prealps_tpu_torch.ops.spmm import (
        stencil_bsr_spmm_t_pallas_bs,
        stencil_pallas_bs_ext,
    )

    n = a.shape[0]
    solver, build_s, peak_gb = lorasc_build(a, nel, dev, pencil="agg")
    pc = solver.precond
    plan = pc.plan
    ops = pc.operands
    nev = pc.nev
    if "w_lift" not in ops:
        fail("[lorasc] the deflate build attached no deflation lift")
    lift_k = ops["w_lift"].shape[0]
    log(f"[lorasc] built in {build_s:.2f} s, stages (s): {json.dumps(pc.timings)}; "
        f"ng={plan.ng} bs_i={plan.bs_i} nblk_i={plan.nblk_i} bs_g={plan.bs_g} "
        f"nblk_g={plan.nblk_g} nev={nev} lift width={lift_k} deflated="
        f"{pc.deflated} (record {LORASC_ANCHOR_PAIRS}); peak device memory "
        f"{peak_gb:.2f} GB")
    if not within(pc.deflated, LORASC_ANCHOR_PAIRS, LORASC_BAND):
        fail(f"[lorasc] {pc.deflated} deflated pairs, outside "
             f"{LORASC_ANCHOR_PAIRS} ± {100 * LORASC_BAND:.0f} %")
    log(f"[lorasc] deflated pairs {pc.deflated} within "
        f"{100 * LORASC_BAND:.0f} % of the record's {LORASC_ANCHOR_PAIRS}")

    a_t = ops["a_stencil"]
    csr = stencil_csr(a_t.blocks_t, a_t.offsets)
    b2a = [check_lane(f"lorasc {what} (br3,t{t})", a_t, t, seed=30 + t,
                      csr=csr if t == 12 else None)
           for what, t in (("ECG + apply", 12), ("Lanczos panel", 8),
                           ("refinement finish", 1), ("Rayleigh-Ritz nev", nev),
                           ("deflation lift k", lift_k))]
    b2b = [check_lane("lorasc finish A_lo·x_hi, pre-extended (br3,t1)", a_t, 1,
                      seed=41, ext=True, csr=csr)]
    del csr

    stencil_bsr_spmm_t_pallas_bs.launches = 0
    stencil_pallas_bs_ext.launches = 0
    info, _, warm_s = checked_solve(solver, a, b, "lorasc")
    la, lb = stencil_bsr_spmm_t_pallas_bs.launches, stencil_pallas_bs_ext.launches
    iters = int(info["iters"])
    log(f"[lorasc] warm solve {warm_s:.3f} s: iters={iters} refine_rounds="
        f"{info['refine_rounds']} relres={info['relres']:.3e} breakdown="
        f"{info['breakdown']} B2a launches={la} B2b launches={lb} (record "
        f"{LORASC_ANCHOR_ITERS} iterations)")
    if la < 3 * iters:
        fail(f"[lorasc] B2a launched {la} times for {iters} iterations (< 3×)")
    if lb < 1:
        fail("[lorasc] B2b was not launched by the refinement finish")
    if not within(iters, LORASC_ANCHOR_ITERS, LORASC_BAND):
        fail(f"[lorasc] {iters} iterations, outside {LORASC_ANCHOR_ITERS} ± "
             f"{100 * LORASC_BAND:.0f} %")
    timed = timed_solves(solver, b, iters, "lorasc")
    solve_s = statistics.median(timed)
    log(f"[lorasc] timed solves (s): {[round(v, 4) for v in timed]}; median "
        f"{solve_s:.4f} s, {1e3 * solve_s / iters:.3f} ms/iteration")

    deep = solver.with_tol(1e-8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_d, info_d = deep.solve(b)
    torch.cuda.synchronize()
    deep_s = time.perf_counter() - t0
    rel_d = float(np.linalg.norm(b - a @ x_d) / np.linalg.norm(b))
    log(f"[lorasc] with_tol(1e-8): {deep_s:.3f} s, iters={info_d['iters']} "
        f"refine_rounds={info_d['refine_rounds']} relres={rel_d:.3e} (record "
        f"{LORASC_DEEP_ANCHOR_ITERS} iterations, relres 7.09e-10)")
    if not (rel_d < 1e-8) or info_d["breakdown"]:
        fail(f"[lorasc] with_tol(1e-8) reached relres {rel_d:.3e}")
    busy_ms, wall_ms = profile_solve(solver, b, "lorasc")
    log(f"[lorasc] device busy {busy_ms:.1f} ms per solve: "
        f"{100 * busy_ms / wall_ms:.0f} % of the profiled solve's "
        f"{wall_ms:.1f} ms (idle {100 - 100 * busy_ms / wall_ms:.0f} %)")
    path = {"n": n, "ng": plan.ng, "bs_i": plan.bs_i, "nblk_i": plan.nblk_i,
            "bs_g": plan.bs_g, "nblk_g": plan.nblk_g, "nev": nev, "lift_k": lift_k,
            "deflated": pc.deflated, "build_s": build_s,
            "build_stages_s": pc.timings, "peak_GB": peak_gb, "iters": iters,
            "refine_rounds": info["refine_rounds"], "relres": info["relres"],
            "solve_s": timed, "ms_per_iter": 1e3 * solve_s / iters,
            "b2a_launches": la, "b2b_launches": lb,
            "deep": {"iters": info_d["iters"], "relres": rel_d, "solve_s": deep_s,
                     "refine_rounds": info_d["refine_rounds"]},
            "profile_device_ms": busy_ms, "profile_wall_ms": wall_ms,
            "anchors": {"iters": LORASC_ANCHOR_ITERS, "pairs": LORASC_ANCHOR_PAIRS,
                        "deep_iters": LORASC_DEEP_ANCHOR_ITERS}}
    return b2a, b2b, path, la, lb


def lorasc_solve(solver, a, b, tag):
    """The path's solve with B2a's and B2b's counts (and B2a's count of its
    bf16-block instance) zeroed just before and read just after. Returns
    (info, B2a launches, B2b launches, bf16 B2a launches, seconds)."""
    from prealps_tpu_torch.ops.spmm import (
        stencil_bsr_spmm_t_pallas_bs,
        stencil_pallas_bs_ext,
    )

    stencil_bsr_spmm_t_pallas_bs.launches = 0
    stencil_bsr_spmm_t_pallas_bs.bf16_launches = 0
    stencil_pallas_bs_ext.launches = 0
    info, _, secs = checked_solve(solver, a, b, tag)
    return (info, stencil_bsr_spmm_t_pallas_bs.launches,
            stencil_pallas_bs_ext.launches,
            stencil_bsr_spmm_t_pallas_bs.bf16_launches, secs)


def lorasc_f64_phase(dev, a, b, nel=36):
    """[lorasc_f64]: the f64 deflation study's row at LORASC_F64_DEFLATION
    on the het operator ``a`` (``examples/deflation_study_f64.py``), through
    the user's entry point ``StencilLorascECG.build(a, dtype=np.float64,
    device=...)``: every operand f64, one ECG solve (no refinement), every
    operator product B2a's f64 instance. Returns (B2a checks, B2b checks,
    path record)."""
    import torch

    from prealps_tpu_torch.examples import deflation_study_f64 as study
    from prealps_tpu_torch.ops.spmm import (
        stencil_bsr_spmm_t_pallas_bs,
        stencil_pallas_bs_ext,
    )
    from prealps_tpu_torch.parallel.lorasc_stencil import StencilLorascECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    solver = StencilLorascECG.build(a, opts=ECGOptions(**study.OPTS), device=dev,
                                    **study.build_kwargs(nel, LORASC_F64_DEFLATION))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    pc = solver.precond
    ops = pc.operands
    a_t = ops["a_stencil"]
    if (solver.a_scaled is not None or "a_lo_blocks" in ops
            or any(v.dtype != torch.float64 for k, v in ops.items()
                   if isinstance(v, torch.Tensor) and v.is_floating_point())
            or a_t.blocks_t.dtype != torch.float64):
        fail("[lorasc_f64] the build is not f64 throughout, or refines")
    log(f"[lorasc_f64] built in {build_s:.2f} s, stages (s): "
        f"{json.dumps(pc.timings)}; ng={pc.plan.ng} nev={pc.nev} deflated="
        f"{pc.deflated} (the JAX package's f64 build: {LORASC_F64_ANCHOR_PAIRS}); "
        f"peak device memory {peak_gb:.2f} GB")
    csr = stencil_csr(a_t.blocks_t, a_t.offsets)
    b2a = [check_lane(f"lorasc_f64 {what} (br3,t{t},f64)", a_t, t, seed=130 + t,
                      csr=csr, device_time=True)
           for what, t in (("ECG + apply", 12), ("single vector", 1),
                           ("Rayleigh-Ritz nev", pc.nev))]
    b2b = [check_lane("lorasc_f64 pre-extended (br3,t1,f64)", a_t, 1, seed=141,
                      ext=True, csr=csr, device_time=True)]
    del csr

    stencil_bsr_spmm_t_pallas_bs.launches = 0
    stencil_bsr_spmm_t_pallas_bs.f64_launches = 0
    stencil_pallas_bs_ext.launches = 0
    info, _, warm_s = checked_solve(solver, a, b, "lorasc_f64")
    la = stencil_bsr_spmm_t_pallas_bs.launches
    la64 = stencil_bsr_spmm_t_pallas_bs.f64_launches
    lb = stencil_pallas_bs_ext.launches
    iters = int(info["iters"])
    log(f"[lorasc_f64] warm solve {warm_s:.3f} s: iters={iters} relres="
        f"{info['relres']:.3e} breakdown={info['breakdown']} B2a launches={la} "
        f"(f64 instance {la64}), B2b launches={lb} (no refinement finish in f64); "
        f"the JAX package's f64 solve on a CPU: {LORASC_F64_ANCHOR_ITERS} iterations")
    if la < 3 * iters or la64 != la:
        fail(f"[lorasc_f64] B2a launched {la} times ({la64} f64) for {iters} "
             "iterations (< 3×, or not all f64)")
    if not within(iters, LORASC_F64_ANCHOR_ITERS):
        fail(f"[lorasc_f64] {iters} iterations, outside {LORASC_F64_ANCHOR_ITERS} ± "
             f"{100 * ANCHOR_BAND:.0f} %")
    timed = timed_solves(solver, b, iters, "lorasc_f64")
    solve_s = statistics.median(timed)
    busy_ms, wall_ms = profile_solve(solver, b, "lorasc_f64")
    log(f"[lorasc_f64] timed solves (s): {[round(v, 4) for v in timed]}; median "
        f"{solve_s:.4f} s, {1e3 * solve_s / iters:.3f} ms/iteration; device busy "
        f"{busy_ms:.1f} ms a solve ({100 * busy_ms / wall_ms:.0f} % of the "
        "profiled solve's wall)")
    path = {"n": a.shape[0], "max_deflation": LORASC_F64_DEFLATION, "nev": pc.nev,
            "deflated": pc.deflated, "build_s": build_s, "build_stages_s": pc.timings,
            "peak_GB": peak_gb, "iters": iters, "relres": info["relres"],
            "solve_s": timed, "ms_per_iter": 1e3 * solve_s / iters,
            "b2a_launches": la, "b2a_f64_launches": la64, "b2b_launches": lb,
            "profile_device_ms": busy_ms, "profile_wall_ms": wall_ms,
            "anchors": {"iters": LORASC_F64_ANCHOR_ITERS,
                        "pairs": LORASC_F64_ANCHOR_PAIRS}}
    return b2a, b2b, path


def presc_phases(dev, a, b, lorasc_iters, nel=36):
    """Phases 16-19 on the het operator of [lorasc]: PRESC (the SSLOC
    pencil) with bf16 and with f32 banded factors, the SALOC pencil, and
    [lorasc] with the bf16 operator stores. Returns (bf16 B2a checks, bf16
    B2b checks, {phase: record})."""
    import numpy as np
    import torch

    out = {}
    # --- 16. [presc]: the record's configuration (bf16 factors) ---
    solver, build_s, peak_gb = lorasc_build(a, nel, dev, pencil="sloc",
                                            factor_store="bf16")
    pc, ops = solver.precond, solver.precond.operands
    if ops["aii_linv"].dtype != torch.bfloat16 or "w_lift" not in ops:
        fail("[presc] the build stored no bf16 factors or attached no lift")
    c = ops["sloc"].shape[1]
    owned = [int(v) for v in ops["own_dof_mask"].sum(dim=1).tolist()]
    log(f"[presc] built in {build_s:.2f} s, stages (s): {json.dumps(pc.timings)}; "
        f"owned separator dofs per part {owned}, largest c={c}; nev={pc.nev} "
        f"deflated={pc.deflated} (record {PRESC_ANCHOR_PAIRS}); peak device "
        f"memory {peak_gb:.2f} GB")
    if not within(pc.deflated, PRESC_ANCHOR_PAIRS, LORASC_BAND):
        fail(f"[presc] {pc.deflated} deflated pairs, outside {PRESC_ANCHOR_PAIRS} "
             f"± {100 * LORASC_BAND:.0f} %")
    info, la, lb, _, warm_s = lorasc_solve(solver, a, b, "presc")
    iters = int(info["iters"])
    log(f"[presc] warm solve {warm_s:.3f} s: iters={iters} refine_rounds="
        f"{info['refine_rounds']} relres={info['relres']:.3e} B2a launches={la} "
        f"B2b launches={lb} (record {PRESC_ANCHOR_ITERS} iterations, relres 7.85e-6)")
    if la < 3 * iters:
        fail(f"[presc] B2a launched {la} times for {iters} iterations (< 3×)")
    if lb < 1:
        fail("[presc] B2b was not launched by the refinement finish")
    if not within(iters, PRESC_ANCHOR_ITERS, LORASC_BAND):
        fail(f"[presc] {iters} iterations, outside {PRESC_ANCHOR_ITERS} ± "
             f"{100 * LORASC_BAND:.0f} %")
    timed = timed_solves(solver, b, iters, "presc")
    solve_s = statistics.median(timed)
    busy_ms, wall_ms = profile_solve(solver, b, "presc")
    log(f"[presc] timed solves (s): {[round(v, 4) for v in timed]}; median "
        f"{solve_s:.4f} s, {1e3 * solve_s / iters:.3f} ms/iteration; device busy "
        f"{busy_ms:.1f} ms per solve: {100 * busy_ms / wall_ms:.0f} % of "
        "the profiled solve's wall")
    out["presc"] = {"factor_store": "bf16", "build_s": build_s,
                    "build_stages_s": pc.timings, "c": c, "owned_dofs": owned,
                    "peak_GB": peak_gb, "nev": pc.nev, "deflated": pc.deflated,
                    "iters": iters, "refine_rounds": info["refine_rounds"],
                    "relres": info["relres"], "b2a_launches": la, "b2b_launches": lb,
                    "solve_s": timed, "ms_per_iter": 1e3 * solve_s / iters,
                    "profile_device_ms": busy_ms, "profile_wall_ms": wall_ms,
                    "anchors": {"iters": PRESC_ANCHOR_ITERS, "pairs": PRESC_ANCHOR_PAIRS}}
    del solver, pc, ops

    # --- 17. [presc] with f32 factors (the card's default) ---
    solver, build_s, peak_gb = lorasc_build(a, nel, dev, pencil="sloc",
                                            factor_store="f32")
    pc = solver.precond
    if pc.deflated != out["presc"]["deflated"]:
        fail(f"[presc f32] {pc.deflated} deflated pairs, the bf16 build "
             f"{out['presc']['deflated']}: the factor cast must follow the build")
    info, la, lb, _, warm_s = lorasc_solve(solver, a, b, "presc f32")
    iters32 = int(info["iters"])
    if iters32 > 1.1 * iters:
        fail(f"[presc f32] {iters32} iterations, > 1.1 × the bf16 run's {iters}")
    timed32 = timed_solves(solver, b, iters32, "presc f32")
    deep = solver.with_tol(1e-8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_d, info_d = deep.solve(b)
    torch.cuda.synchronize()
    deep_s = time.perf_counter() - t0
    rel_d = float(np.linalg.norm(b - a @ x_d) / np.linalg.norm(b))
    log(f"[presc f32] built in {build_s:.2f} s, stages (s): {json.dumps(pc.timings)}; "
        f"deflated={pc.deflated} (the bf16 build's); warm solve {warm_s:.3f} s: "
        f"iters={iters32} refine_rounds={info['refine_rounds']} relres="
        f"{info['relres']:.3e} B2a launches={la}; timed solves (s): "
        f"{[round(v, 4) for v in timed32]}; with_tol(1e-8): {deep_s:.3f} s, "
        f"iters={info_d['iters']} refine_rounds={info_d['refine_rounds']} "
        f"relres={rel_d:.3e} (the JAX package's round-5 reading: "
        f"{PRESC_DEEP_READING} iterations)")
    if not (rel_d < 1e-8) or info_d["breakdown"]:
        fail(f"[presc f32] with_tol(1e-8) reached relres {rel_d:.3e}")
    out["presc_f32"] = {"factor_store": "f32", "build_s": build_s,
                        "build_stages_s": pc.timings, "peak_GB": peak_gb,
                        "deflated": pc.deflated, "iters": iters32,
                        "refine_rounds": info["refine_rounds"], "relres": info["relres"],
                        "b2a_launches": la, "b2b_launches": lb, "solve_s": timed32,
                        "deep": {"iters": info_d["iters"], "relres": rel_d,
                                 "solve_s": deep_s,
                                 "refine_rounds": info_d["refine_rounds"]},
                        "deep_reading_iters": PRESC_DEEP_READING}
    del solver, deep, pc

    # --- 18. [saloc]: the SALOC pencil on the same build ---
    solver, build_s, peak_gb = lorasc_build(a, nel, dev, pencil="saloc",
                                            factor_store="bf16")
    pc = solver.precond
    info, la, lb, _, warm_s = lorasc_solve(solver, a, b, "saloc")
    log(f"[saloc] built in {build_s:.2f} s, stages (s): {json.dumps(pc.timings)}; "
        f"deflated={pc.deflated}; warm solve {warm_s:.3f} s: iters={info['iters']} "
        f"refine_rounds={info['refine_rounds']} relres={info['relres']:.3e} B2a "
        f"launches={la} (the JAX package's reading at this size: "
        f"{SALOC_READING[0]} pairs, {SALOC_READING[1]} iterations)")
    out["saloc"] = {"build_s": build_s, "build_stages_s": pc.timings,
                    "deflated": pc.deflated, "iters": int(info["iters"]),
                    "refine_rounds": info["refine_rounds"], "relres": info["relres"],
                    "b2a_launches": la, "b2b_launches": lb, "solve_s": warm_s,
                    "reading": {"pairs": SALOC_READING[0], "iters": SALOC_READING[1]}}
    del solver, pc

    # --- 19. [lorasc_bf16]: a_store="bf16" and bf16 factors, then bf16_all ---
    solver, build_s, peak_gb = lorasc_build(a, nel, dev, pencil="agg",
                                            a_store="bf16", factor_store="bf16")
    pc, ops = solver.precond, solver.precond.operands
    a_m = ops["a_stencil_m"]
    if (a_m.blocks_t.dtype != torch.bfloat16
            or ops["a_stencil"].blocks_t.dtype != torch.float32):
        fail("[lorasc_bf16] expected a bf16 sweep copy beside the f32 operator")
    log(f"[lorasc_bf16] built in {build_s:.2f} s, stages (s): "
        f"{json.dumps(pc.timings)}; deflated={pc.deflated}; bf16 sweep table "
        f"{a_m.blocks_t.numel() * 2 / 1e6:.1f} MB beside the f32 operator's "
        f"{ops['a_stencil'].blocks_t.numel() * 4 / 1e6:.1f} MB")
    csr = stencil_csr(a_m.blocks_t.float(), a_m.offsets)
    b2a = [check_lane(f"lorasc_bf16 {what}, bf16 blocks (br3,t{t})", a_m, t,
                      seed=90 + t, csr=csr if t == 12 else None)
           for what, t in (("sweeps", 12), ("Lanczos-width panel", 8),
                           ("single vector", 1), ("nev", pc.nev))]
    b2b = [check_lane("lorasc_bf16 pre-extended, bf16 blocks (br3,t1)", a_m, 1,
                      seed=99, ext=True, csr=csr)]
    del csr
    info, la, lb, l16, warm_s = lorasc_solve(solver, a, b, "lorasc_bf16")
    iters16 = int(info["iters"])
    limit = 1.2 * lorasc_iters + 2
    log(f"[lorasc_bf16] warm solve {warm_s:.3f} s: iters={iters16} refine_rounds="
        f"{info['refine_rounds']} relres={info['relres']:.3e} B2a launches={la} "
        f"(bf16 instance {l16}) B2b launches={lb}; [lorasc] {lorasc_iters}, "
        f"limit 1.2× + 2 = {limit:.1f} (the TPU record, bf16 factors: "
        f"{LORASC_ANCHOR_ITERS} iterations)")
    if l16 < 2 * iters16:
        fail(f"[lorasc_bf16] the bf16 instance launched {l16} times for "
             f"{iters16} iterations (< 2×)")
    if iters16 > limit:
        fail(f"[lorasc_bf16] {iters16} iterations > 1.2 × {lorasc_iters} + 2")
    timed16 = timed_solves(solver, b, iters16, "lorasc_bf16")
    log(f"[lorasc_bf16] timed solves (s): {[round(v, 4) for v in timed16]}; "
        f"median {statistics.median(timed16):.4f} s")
    out["lorasc_bf16"] = {"build_s": build_s, "build_stages_s": pc.timings,
                          "peak_GB": peak_gb, "deflated": pc.deflated,
                          "iters": iters16, "refine_rounds": info["refine_rounds"],
                          "relres": info["relres"], "b2a_launches": la,
                          "b2a_bf16_launches": l16, "b2b_launches": lb,
                          "solve_s": timed16, "lorasc_iters": lorasc_iters,
                          "limit": limit}
    del solver, pc, ops, a_m

    solver, build_s, _ = lorasc_build(a, nel, dev, pencil="agg", a_store="bf16_all",
                                      factor_store="bf16")
    if solver.precond.operands["a_stencil"].blocks_t.dtype != torch.bfloat16:
        fail("[lorasc_bf16_all] the iteration operator is not bf16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    rel = float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))
    log(f"[lorasc_bf16_all] {time.perf_counter() - t0:.3f} s: iters={info['iters']} "
        f"breakdown={info['breakdown']} relres={rel:.3e} (the JAX package's pinned "
        "failure: breakdown or relres > 1e-3)")
    if not (info["breakdown"] or rel > 1e-3):
        fail(f"[lorasc_bf16_all] converged (relres {rel:.3e}): bf16(A) was expected "
             "to break the iteration")
    out["lorasc_bf16_all"] = {"build_s": build_s, "iters": int(info["iters"]),
                              "breakdown": bool(info["breakdown"]), "relres": rel}
    del solver
    return b2a, b2b, out


def dia_phase(dev, a, b):
    """The fmt="dia" path on lane-major panels at full size: the promoted
    diagonals of elasticity3d(36³) as a br = 1 stencil through B1, device
    block Jacobi from the diagonals, f32 with host-f64 refinement. The
    scaled matrix has 97 promoted diagonals and a remainder (scaling drops
    the stencil's stored zeros); the unscaled operator's table has all 99
    and is the one of the br 1 × D 99 checks. Returns (B1 checks on both
    tables, the B2b check at br 1 × D 99, the B6 check on the path's block
    inverses, path record, B1 launches of the solve)."""
    import numpy as np
    import torch

    from prealps_tpu_torch.ops.formats import StencilBsrTMatrix, csr_to_dia_ell
    from prealps_tpu_torch.ops.spmm import stencil_flat_ext
    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    opts = ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000, variant="odir_fused",
                      layout="tbn")
    t0 = time.perf_counter()
    solver = DistributedECG.build(a, nshards=1, fmt="dia", precond="bj", grid=None,
                                  opts=opts, dtype=np.float32, device=dev)
    build_s = time.perf_counter() - t0
    ops = solver.operands
    n_diags = len(ops.offsets)
    log(f"[dia] built in {build_s:.2f} s, stages (s): "
        + json.dumps({k: round(v, 4) for k, v in solver.timings.items()})
        + f"; n_pad={solver.layout.n_pad} D={n_diags} diagonals, halo={ops.halo}, "
        f"remainder {'none' if ops.rem_vals is None else tuple(ops.rem_vals.shape)}; "
        f"block Jacobi nb={ops.inv_f.shape[0]} mb={ops.inv_f.shape[1]}")
    if n_diags > 512 or ops.halo > ops.nrb:
        fail(f"[dia] {n_diags} diagonals, halo {ops.halo}: the kernel takes "
             "at most 512 offsets and a halo of at most n")
    csr = stencil_csr(ops.blocks_flat[:, None, None, :], ops.offsets)
    b1 = [check_kernel(f"[dia] path table, B1 (br1,D{n_diags},t12)", ops.blocks_flat,
                       ops.offsets, ops.halo, 1, 12, seed=81, csr=csr),
          check_kernel(f"[dia] path table, B1 (br1,D{n_diags},t1)", ops.blocks_flat,
                       ops.offsets, ops.halo, 1, 1, seed=82)]
    # the unscaled operator's own DIA table: all 99 diagonals promoted (its
    # stored zeros included), no remainder. RAC scaling drops the stencil's
    # stored zeros, which leaves the scaled operator (the path's, and the
    # SpMM sweep's) 97 diagonals and 10,080 remainder entries.
    de = csr_to_dia_ell(a, min_fill=0.05, dtype=np.float32, device=dev)
    if len(de.offsets) != 99 or de.rem is not None:
        fail(f"[dia] the unscaled operator has {len(de.offsets)} diagonals "
             f"(remainder {de.rem is not None}); expected 99 and none")
    halo99 = max(abs(o) for o in de.offsets)
    dia_t = StencilBsrTMatrix(de.diags[:, None, None, :].contiguous(), de.offsets,
                              de.shape)
    b1 += [check_kernel(f"unscaled DIA table, B1 (br1,D99,t{t})", de.diags,
                        de.offsets, halo99, 1, t, seed=84 + t) for t in (12, 1)]
    b2b = [check_lane("unscaled DIA table, B2b pre-extended (br1,D99,t12)", dia_t,
                      12, seed=83, ext=True,
                      csr=stencil_csr(dia_t.blocks_t, de.offsets))]
    del csr, dia_t, de
    b6 = check_bj_apply(ops.inv_f, 1, 12, seed=86)

    info, launches, warm_s = checked_solve(solver, a, b, "dia", stencil_flat_ext)
    iters = int(info["iters"])
    log(f"[dia] warm solve {warm_s:.3f} s: iters={iters} refine_rounds="
        f"{info['refine_rounds']} (host f64) relres={info['relres']:.3e} "
        f"breakdown={info['breakdown']} stencil_flat_ext launches={launches} "
        f"(JAX package on a CPU: {DIA_ANCHOR_ITERS} iterations)")
    if launches < iters:
        fail(f"[dia] B1 launched {launches} times for {iters} iterations")
    if not within(iters, DIA_ANCHOR_ITERS, PATH_BAND):
        fail(f"[dia] {iters} iterations, outside {DIA_ANCHOR_ITERS} ± "
             f"{100 * PATH_BAND:.0f} %")
    timed = timed_solves(solver, b, iters, "dia")
    solve_s = statistics.median(timed)
    log(f"[dia] timed solves (s): {[round(v, 4) for v in timed]}; median "
        f"{solve_s:.4f} s, {1e3 * solve_s / iters:.3f} ms/iteration")
    busy_ms, wall_ms = profile_solve(solver, b, "dia")
    log(f"[dia] device busy {busy_ms:.1f} ms per solve: "
        f"{100 * busy_ms / wall_ms:.0f} % of the profiled solve's "
        f"{wall_ms:.1f} ms")
    path = {"n_pad": solver.layout.n_pad, "D": n_diags, "halo": ops.halo,
            "iters": iters, "refine_rounds": info["refine_rounds"],
            "relres": info["relres"], "launches": launches, "solve_s": timed,
            "ms_per_iter": 1e3 * solve_s / iters, "build_s": build_s,
            "build_stages_s": solver.timings, "profile_device_ms": busy_ms,
            "profile_wall_ms": wall_ms, "anchor_iters": DIA_ANCHOR_ITERS}
    return b1, b2b, b6, path, launches


def auto_phase(dev):
    """fmt="auto" on the structure-hidden record of BENCH_r05.json
    (bench.py:470-492): elasticity3d(20³) under a random symmetric
    permutation; the cascade must choose Morton block-ELL."""
    import numpy as np
    import scipy.sparse as sp

    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    a0 = elasticity3d(20, 20, 20, heterogeneous=False)
    n = a0.shape[0]
    rng = np.random.default_rng(5)
    pm = sp.eye(n, format="csr")[rng.permutation(n)]
    a = (pm @ a0 @ pm.T).tocsr()
    b = rng.standard_normal(n)
    opts = ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000, variant="odir_fused",
                      layout="nt")
    t0 = time.perf_counter()
    solver = DistributedECG.build(a, nshards=1, fmt="auto", precond="bj",
                                  block_size=240, opts=opts, dtype=np.float32,
                                  device=dev)
    build_s = time.perf_counter() - t0
    fi = solver.fmt_info
    log(f"[auto] shuffled elasticity3d(20³) n={n}: chose {fi['chosen']} "
        f"(layout={solver.opts.layout}) in {build_s:.2f} s, stages (s): "
        + json.dumps({k: round(v, 4) for k, v in solver.timings.items()})
        + f"; scores {json.dumps(fi)}")
    if fi["chosen"] != "block_ell_morton" or solver.pre_perm is None:
        fail(f"[auto] chose {fi['chosen']}, not block_ell_morton")
    info, _, warm_s = checked_solve(solver, a, b, "auto")
    iters = int(info["iters"])
    log(f"[auto] warm solve {warm_s:.3f} s: iters={iters} refine_rounds="
        f"{info['refine_rounds']} relres={info['relres']:.3e} (record "
        f"{AUTO_ANCHOR_ITERS} iterations)")
    if not within(iters, AUTO_ANCHOR_ITERS, PATH_BAND):
        fail(f"[auto] {iters} iterations, outside {AUTO_ANCHOR_ITERS} ± "
             f"{100 * PATH_BAND:.0f} %")
    timed = timed_solves(solver, b, iters, "auto")
    return {"n": n, "chosen": fi["chosen"], "fmt_info": fi, "iters": iters,
            "refine_rounds": info["refine_rounds"], "relres": info["relres"],
            "solve_s": timed, "build_s": build_s,
            "anchor_iters": AUTO_ANCHOR_ITERS}


def spmm_phase(dev, a):
    """The SpMM format sweep (prealps_tpu_torch.examples.bench_spmm) at
    nel = 36 on the card: every format's y held to the ELL product of the
    same panel within KERNEL_TOL · max(|A|·|x|). Returns (records, B3
    launches)."""
    import torch

    from prealps_tpu_torch.core.scaling import sym_rac_scaling
    from prealps_tpu_torch.examples import bench_spmm
    from prealps_tpu_torch.ops.spmm import stencil_bsr_spmm_t_pallas

    a_s = sym_rac_scaling(a)[0]
    abs_csr = scipy_csr(abs(a_s), dev)
    stencil_bsr_spmm_t_pallas.launches = 0
    recs, pending = [], {}
    for rec, x, y in bench_spmm.sweep(nel=36, ts=(1, 4, 8, 12, 16), reps=10,
                                      device=dev, a=a_s):
        log("[spmm] " + json.dumps(rec))
        recs.append(rec)
        pending.setdefault(rec["t"], {})[rec["format"]] = (x, y)
        group = pending[rec["t"]]
        if len(group) < len(bench_spmm.FORMATS):
            continue
        x, y_ell = group["ell"]
        err_bound = KERNEL_TOL * float(torch.sparse.mm(abs_csr, x.abs().float()).max())
        for fmt, (_, y) in group.items():
            err = float((y - y_ell).abs().max())
            if not bool(torch.isfinite(y).all()) or err > err_bound:
                fail(f"[spmm] {fmt} t={rec['t']}: max|y - y_ell| = {err:.3e} "
                     f"> {err_bound:.3e}")
            rec_f = next(r for r in recs if r["t"] == rec["t"] and r["format"] == fmt)
            rec_f["max_abs_err_vs_ell"] = err
        del pending[rec["t"]]
    launches = stencil_bsr_spmm_t_pallas.launches
    log(f"[spmm] {len(recs)} lines, every format within KERNEL_TOL of the ELL "
        f"product; B3 (stencil_t_pallas) launches={launches}")
    if launches < 1:
        fail("[spmm] B3 was not launched by the sweep")
    return recs, launches


def a1_build(a, nel, dev, tag, **kw):
    """One full-size f32 build of the headline operator for the phases of
    the rest of the one-GPU driver (t 12, odir_fused on tbn, tol 1e-5 with
    device double-float refinement), with its build time logged."""
    import numpy as np

    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    opts = ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000, variant="odir_fused",
                      layout="tbn")
    args = dict(fmt="stencil", br=3, block_size=240, grid=(nel + 1, nel + 1, nel))
    args.update(kw)
    t0 = time.perf_counter()
    solver = DistributedECG.build(a, nshards=1, opts=opts, dtype=np.float32,
                                  device=dev, **args)
    build_s = time.perf_counter() - t0
    log(f"[{tag}] built in {build_s:.2f} s ({solver.operands.precond_kind}), "
        "stages (s): " + json.dumps({k: round(v, 4) for k, v in
                                     solver.timings.items()}))
    return solver, build_s


def a1_solve(solver, a, b, tag, anchor=None, min_per_iter=1):
    """The path's solve with B1's count zeroed just before and read just
    after (launches >= min_per_iter × iterations), three timed solves, and
    with ``anchor`` the iterations held within PATH_BAND of it."""
    from prealps_tpu_torch.ops.spmm import stencil_flat_ext

    info, launches, warm_s = checked_solve(solver, a, b, tag, stencil_flat_ext)
    iters = int(info["iters"])
    timed = timed_solves(solver, b, iters, tag)
    solve_s = statistics.median(timed)
    log(f"[{tag}] warm solve {warm_s:.3f} s: iters={iters} refine_rounds="
        f"{info['refine_rounds']} relres={info['relres']:.3e} "
        f"stencil_flat_ext launches={launches}; timed solves (s): "
        f"{[round(v, 4) for v in timed]}, median {solve_s:.4f} s"
        + ("" if anchor is None else f" (JAX package on a CPU: {anchor} iterations)"))
    if launches < min_per_iter * iters:
        fail(f"[{tag}] B1 launched {launches} times for {iters} iterations "
             f"(< {min_per_iter}×)")
    if anchor is not None and not within(iters, anchor, PATH_BAND):
        fail(f"[{tag}] {iters} iterations, outside {anchor} ± "
             f"{100 * PATH_BAND:.0f} %")
    return {"iters": iters, "refine_rounds": info["refine_rounds"],
            "relres": info["relres"], "launches": launches, "solve_s": timed,
            "ms_per_iter": 1e3 * solve_s / iters, "anchor_iters": anchor}


def a1_phases(dev, a, b, nel, bj_iters):
    """Phases 23-27, the rest of the one-GPU driver at full size:
    Chebyshev, the deduplicated and the bf16 block Jacobi, bj2l without
    grid= and the stacked omin state. Returns {phase: record}."""
    import dataclasses

    import torch

    from prealps_tpu_torch.direct.device_bj import bj_apply_flat, bj_apply_lane_major
    from prealps_tpu_torch.timing import device_ms

    out = {}
    # --- [cheb]: bench.py PREALPS_BENCH_PRECOND=chebyshev (degree 8, κ 30) ---
    solver, build_s = a1_build(a, nel, dev, "cheb", precond="chebyshev",
                               cheb_degree=8, cheb_kappa=30.0, block_size=None,
                               grid=None)
    cheb = solver.operands.cheb
    log(f"[cheb] degree {cheb.degree}, lambda_max {cheb.lam_max:.6f}, "
        f"lambda_min {cheb.lam_min:.6f}: {cheb.degree - 1} B1 products per apply")
    rec = a1_solve(solver, a, b, "cheb", CHEB_ANCHOR_ITERS, min_per_iter=8)
    busy_ms, wall_ms = profile_solve(solver, b, "cheb")
    out["cheb"] = dict(rec, build_s=build_s, degree=cheb.degree,
                       lam_max=cheb.lam_max, lam_min=cheb.lam_min,
                       profile_device_ms=busy_ms, profile_wall_ms=wall_ms)
    del solver, cheb

    # --- [dedup]: PREALPS_BENCH_PRECOND=bj PREALPS_BENCH_BJ_DEDUPE=1 ---
    solver, build_s = a1_build(a, nel, dev, "dedup", precond="bj")
    ops = solver.operands
    if ops.precond_kind != "bj_dedup":
        fail(f"[dedup] built {ops.precond_kind}, not bj_dedup")
    mbn = ops.inv_u.shape[2]
    nb = ops.nrb // mbn
    log(f"[dedup] node blocks of {mbn} (the grid x-line; block_size // br = 80): "
        f"{ops.groups.num_groups} unique inverses for {nb} blocks "
        f"({ops.inv_u.numel() * 4 / 1e6:.1f} MB against "
        f"{nb * (3 * mbn) ** 2 * 4 / 1e6:.1f} MB flat)")
    if mbn != nel + 1:
        fail(f"[dedup] node blocks of {mbn}, not the x-line {nel + 1}")
    rec = a1_solve(solver, a, b, "dedup", DEDUP_ANCHOR_ITERS)
    out["dedup"] = dict(rec, build_s=build_s, mbn=mbn, nb=nb,
                        groups=ops.groups.num_groups)
    del solver, ops

    # --- [bj_lane]: PREALPS_BENCH_PRECOND=bj PREALPS_BENCH_BJ_DTYPE=bf16 ---
    solver, build_s = a1_build(a, nel, dev, "bj_lane", precond="bj",
                               bj_dedupe=False, bj_dtype="bf16")
    ops = solver.operands
    if ops.precond_kind != "bj_lane" or ops.inv5.dtype != torch.bfloat16:
        fail(f"[bj_lane] built {ops.precond_kind}, not bj_lane with bf16 inverses")
    nb, br, mbn = ops.inv5.shape[:3]
    z = torch.randn((12, br, ops.nrb), generator=torch.Generator(device=dev)
                    .manual_seed(5), device=dev)
    w = ops.m_apply(z)
    if w.dtype != torch.float32:
        fail(f"[bj_lane] the apply returned {w.dtype}, not float32")
    inv_f = ops.inv5.float().reshape(nb, br * mbn, br * mbn)
    lane_ms, _ = device_ms(lambda: bj_apply_lane_major(ops.inv5, z))
    flat_ms, _ = device_ms(lambda: bj_apply_flat(inv_f, z))
    log(f"[bj_lane] apply at nb {nb} mb {br * mbn} t 12 (device time, "
        f"information): bf16 split-input {lane_ms:.4f} ms, bj_apply_flat on the "
        f"same inverses in f32 {flat_ms:.4f} ms")
    del inv_f, z, w
    rec = a1_solve(solver, a, b, "bj_lane")
    limit = max(int(1.3 * bj_iters), bj_iters + 12)
    if rec["iters"] > limit:
        fail(f"[bj_lane] {rec['iters']} iterations > max(1.3 × {bj_iters}, "
             f"{bj_iters} + 12) = {limit}")
    log(f"[bj_lane] {rec['iters']} iterations within max(1.3×, +12) of [bj]'s "
        f"{bj_iters} (limit {limit})")
    out["bj_lane"] = dict(rec, build_s=build_s, apply_ms=lane_ms,
                          flat_apply_ms=flat_ms, bj_iters=bj_iters, limit=limit)
    del solver, ops

    # --- [bj2l_nogrid]: the headline without grid= (translation modes) ---
    solver, build_s = a1_build(a, nel, dev, "bj2l_nogrid", precond="bj2l",
                               grid=None)
    log(f"[bj2l_nogrid] coarse modes per block: {solver.operands.yq3.shape[1]}")
    rec = a1_solve(solver, a, b, "bj2l_nogrid", BJ2L_NOGRID_ANCHOR_ITERS)
    out["bj2l_nogrid"] = dict(rec, build_s=build_s)
    del solver

    # --- [omin_stacked]: the headline build with omin, stacked and not ---
    solver, build_s = a1_build(a, nel, dev, "omin_stacked", precond="bj2l")
    recs = {}
    for stacked in (True, False):
        s_ = dataclasses.replace(solver, opts=dataclasses.replace(
            solver.opts, variant="omin", stacked=stacked))
        recs[stacked] = a1_solve(s_, a, b, f"omin_stacked stacked={stacked}")
    # the stacked state's stop test reads the residual entering an
    # iteration (RᵀR comes with the first Gram, as in the JAX package), so
    # each inner solve runs one iteration more than the unstacked one
    it_s, it_u = recs[True]["iters"], recs[False]["iters"]
    expect = it_u + recs[True]["refine_rounds"]
    if abs(it_s - expect) > 1:
        fail(f"[omin_stacked] stacked {it_s} iterations against unstacked {it_u} "
             f"+ one per inner solve = {expect} (± 1)")
    log(f"[omin_stacked] stacked {it_s}, unstacked {it_u} iterations: within ±1 "
        f"of unstacked + one per inner solve ({expect})")
    out["omin_stacked"] = {"stacked": recs[True], "unstacked": recs[False],
                           "build_s": build_s}
    return out


def _headline_opts():
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    return ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000, variant="odir_fused",
                      layout="tbn")


def _headline_build(a, nel, device, group=None, nshards=1):
    """The headline build (stencil, bj2l with 240-row blocks, t 12, f32)."""
    import numpy as np

    from prealps_tpu_torch.parallel.driver import DistributedECG

    return DistributedECG.build(
        a, nshards=nshards, fmt="stencil", br=3, precond="bj2l", block_size=240,
        grid=(nel + 1, nel + 1, nel), opts=_headline_opts(), dtype=np.float32,
        device=device, group=group)


def _collective_calls():
    from prealps_tpu_torch.parallel import mesh

    return {f.__name__: f.calls for f in (mesh.all_reduce, mesh.all_gather,
                                          mesh.ring_exchange, mesh.all_to_all)}


LX_SHARDED_COLS = 512      # [sharded4]'s column-sharded matrix: 128 columns a rank
LX_SHARDED_K = 32          # selected columns: the planted ones
LX_SHARDED_SEED = 29
ABLATION_ITERS = 20        # [sharded4]'s ablation: a fixed-length solve
TIMING_KNOB = "PREALPS_TIMING_NO_COLLECTIVES"


def _planted_matrix(m, device):
    """[sharded4]'s (m, LX_SHARDED_COLS) f32 matrix, made on the card from a
    seed (every rank the same): a rank-64 background with graded scales
    plus 1e-3 noise, and LX_SHARDED_K columns of 50× larger random values
    planted at spread positions (8 on each rank's block of columns).
    Returns (matrix, planted positions)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(LX_SHARDED_SEED)
    n = LX_SHARDED_COLS

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    scale = torch.logspace(0, -3, 64, device=device)[:, None]
    a = randn(m, 64) @ (scale * randn(64, n)) + 1e-3 * randn(m, n)
    step = n // LX_SHARDED_K
    pos = [step * i + (5 * i) % step for i in range(LX_SHARDED_K)]
    a[:, pos] = 50.0 * randn(m, LX_SHARDED_K)
    return a, pos


def _sharded_lx(rank, group, m, device):
    """One rank's sharded LX checks on [sharded4]'s planted matrix:
    ``tsqr_r_distributed`` on its rows (rank 0 also against
    ``torch.linalg.qr`` of the whole matrix), ``tournament_select_sharded``
    and ``tp_qr_sharded`` on its columns; each step's seconds."""
    import hashlib

    import torch

    from prealps_tpu_torch.ops.tournament import tournament_select_sharded, tp_qr_sharded
    from prealps_tpu_torch.ops.tsqr import sign_fixed, tsqr_r_distributed
    from prealps_tpu_torch.parallel import mesh
    from prealps_tpu_torch.utils.timing import Timers

    world = mesh.size_of(group)
    full, pos = _planted_matrix(m, device)
    m_loc, n_loc = m // world, LX_SHARDED_COLS // world
    rows = full[rank * m_loc:(rank + 1) * m_loc].contiguous()
    cols = full[:, rank * n_loc:(rank + 1) * n_loc].contiguous()
    steps = Timers(device=device)

    # TSQR in f64: its R against one Householder QR of the whole matrix
    with steps.time("tsqr_r_distributed"):
        r = tsqr_r_distributed(rows.double(), group)
    rec = {"r_sha": hashlib.sha256(r.cpu().numpy().tobytes()).hexdigest()}
    if rank == 0:
        r_ref = sign_fixed(torch.linalg.qr(full.double(), mode="r").R)
        rec["r_rel"] = _fro(r - r_ref) / _fro(r_ref)
    with steps.time("tournament_select_sharded"):
        sel = tournament_select_sharded(cols, group, LX_SHARDED_K)
    with steps.time("tp_qr_sharded"):
        q, r_loc, qr_cols = tp_qr_sharded(cols, group, LX_SHARDED_K)
    rec.update(selected=sel.tolist(), qr_cols=qr_cols.tolist(), planted=pos,
               orth=_orth_err(q), secs=steps.as_dict(),
               q_sha=hashlib.sha256(q.cpu().numpy().tobytes()).hexdigest(),
               resid_sq=_fro(cols - q @ r_loc) ** 2, norm_sq=_fro(cols) ** 2)
    del full, rows, cols, q, r_loc
    return rec


def _ablation_solves(a, b, nel, device, group):
    """[sharded4]'s ablation on one rank: the headline operator with block
    Jacobi alone ([bj]'s 240-row blocks; the headline's bj2l gathers its
    coarse residual inside every apply, a collective the knob keeps, and
    under the knob ranks stop at different iterations, so those gathers
    would pair with other calls), solved for ABLATION_ITERS iterations
    (tol 1e-30, no stall window, no refinement round), in turns with the
    timing knob off, on, on, off (set and unset inside this rank); each
    solve's seconds, iterations, breakdown and collective calls (counts
    zeroed just before, read just after)."""
    import numpy as np

    from prealps_tpu_torch.parallel import mesh
    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions
    from prealps_tpu_torch.utils.timing import sync

    solver = DistributedECG.build(
        a, nshards=mesh.size_of(group), fmt="stencil", br=3, precond="bj",
        block_size=240, grid=(nel + 1, nel + 1, nel), bj_dedupe=False,
        opts=ECGOptions(t=12, tol=1e-30, maxiter=ABLATION_ITERS, stall_window=0,
                        variant="odir_fused", layout="tbn"),
        dtype=np.float32, refine=False, device=device, group=group)
    counters = (mesh.all_reduce, mesh.all_gather, mesh.ring_exchange, mesh.all_to_all)
    out = {"coll": [], "nocoll": []}
    for name in ("coll", "nocoll", "nocoll", "coll"):
        for f in counters:
            f.calls = 0
        if name == "nocoll":
            os.environ[TIMING_KNOB] = "1"
        try:
            sync(device)
            t0 = time.perf_counter()
            _, info = solver.solve(b)
            sync(device)
            secs = time.perf_counter() - t0
        finally:
            os.environ.pop(TIMING_KNOB, None)
        out[name].append({"secs": secs, "iters": int(info["iters"]),
                          "breakdown": bool(info["breakdown"]),
                          "calls": {f.__name__: f.calls for f in counters}})
    return out


def _sharded_headline_rank(rank, group, nel, timed, device):
    """One rank of [sharded4]: the headline built over the group on the
    shared card (``device``), a solve with B1's count zeroed just before
    and read just after, then ``timed`` timed solves (this rank's host
    clock)."""
    import hashlib

    import numpy as np
    import torch

    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.ops.spmm import stencil_flat_ext
    from prealps_tpu_torch.parallel import mesh
    from prealps_tpu_torch.utils.timing import sync

    a = elasticity3d(nel, nel, nel, heterogeneous=False)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    t0 = time.perf_counter()
    solver = _headline_build(a, nel, device, group, mesh.size_of(group))
    build_s = time.perf_counter() - t0
    ops = solver.operands
    stencil_flat_ext.launches = 0
    sync(device)
    t0 = time.perf_counter()
    x, info = solver.solve(b)
    sync(device)
    warm_s = time.perf_counter() - t0
    launches = stencil_flat_ext.launches
    calls = _collective_calls()
    timed_s = []
    for _ in range(timed):
        sync(device)
        t0 = time.perf_counter()
        solver.solve(b)
        sync(device)
        timed_s.append(time.perf_counter() - t0)
    # one more solve on every rank (the collectives must pair up), rank 0's
    # under torch.profiler on a CUDA device: its device time and its table
    prof_rec = {}
    if rank == 0 and torch.device(device).type == "cuda":
        from torch.profiler import ProfilerActivity, profile as tprofile

        from prealps_tpu_torch.timing import device_busy_ms

        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solver.solve(b)
            sync(device)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        table = prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=30)
        prof_rec = {"profile_device_ms": device_busy_ms(prof),
                    "profile_wall_ms": wall_ms, "profile_table": table}
    else:
        solver.solve(b)
    lx = _sharded_lx(rank, group, a.shape[0], device)
    ablation = _ablation_solves(a, b, nel, device, group)
    return {"rank": rank, "iters": int(info["iters"]), **prof_rec, "lx": lx,
            "ablation": ablation,
            "refine_rounds": info["refine_rounds"],
            "device_rounds": info["device_rounds"],
            "breakdown": bool(info["breakdown"]),
            "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
            "launches": launches, "calls": calls, "build_s": build_s,
            "warm_s": warm_s, "timed_s": timed_s, "n_pad": solver.layout.n_pad,
            "nrb_loc": ops.nrb, "halo": ops.halo, "timings": solver.timings,
            "x_sha": hashlib.sha256(x.tobytes()).hexdigest(),
            "x": x if rank == 0 else None}


def _dryrun_rank(rank, group, runs, device):
    """One rank of [sharded_dryrun]: each (path, dtype) of ``runs``
    through ``prealps_tpu_torch/dryrun.py::ecg_paths`` over the group on
    the shared card (``device``; scale=False, t 2, tol 1e-6), B1's count
    zeroed just before each solve and read just after."""
    from prealps_tpu_torch.dryrun import ecg_paths

    return ecg_paths(group, runs, device)


def _spawn_ranks(fn, world, args, timeout=SHARDED_TIMEOUT, threads=2):
    """``world`` ranks of ``fn`` on the card through one gloo group (a
    FileStore in a fresh directory); a failing or hung rank fails the run."""
    import shutil
    import tempfile

    from prealps_tpu_torch.parallel import mesh

    store = tempfile.mkdtemp(prefix="prealps_store_")
    try:
        return mesh.spawn(fn, world, args=args, init_method=f"file://{store}/store",
                          backend="gloo", timeout=timeout, threads=threads)
    except (RuntimeError, TimeoutError) as e:
        fail(f"{fn.__name__} over {world} ranks: {e}")
    finally:
        shutil.rmtree(store, ignore_errors=True)


def sharded_nccl1_phase(dev, a, b, nel, x_main, main_iters):
    """[sharded_nccl1]: the headline through a one-rank NCCL group must
    reproduce [main] exactly (iterations, and x bitwise). Returns (record,
    the group build's flat block table, its offsets and halo)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from prealps_tpu_torch.ops.spmm import stencil_flat_ext
    from prealps_tpu_torch.parallel import mesh

    store = tempfile.mkdtemp(prefix="prealps_nccl1_")
    group = mesh.init_group("nccl", 0, 1, f"file://{store}/store", timeout=300,
                            device=dev)
    try:
        solver = _headline_build(a, nel, dev, group=group)
        before = _collective_calls()
        stencil_flat_ext.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = solver.solve(b)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = stencil_flat_ext.launches
        calls = {k: v - before[k] for k, v in _collective_calls().items()}
        ops = solver.operands
        table, offsets, halo = ops.blocks_flat, ops.offsets, ops.halo
        backend = mesh.backend_of(group)
    finally:
        dist.destroy_process_group()
    iters = int(info["iters"])
    same = bool(np.array_equal(x, x_main))
    dx = float(np.linalg.norm(x - x_main) / np.linalg.norm(x_main))
    log(f"[sharded_nccl1] backend {backend}, 1 rank: {secs:.3f} s, iters={iters} "
        f"refine_rounds={info['refine_rounds']} B1 launches={launches}, "
        f"collectives {calls}; x bitwise [main]'s: {same} (|dx|/|x| {dx:.3e})")
    if iters != main_iters or iters != TPU_ANCHOR_ITERS:
        fail(f"[sharded_nccl1] {iters} iterations; [main] ran {main_iters}, the "
             f"record {TPU_ANCHOR_ITERS}")
    if not same:
        fail("[sharded_nccl1] x differs from [main]'s")
    if calls["all_reduce"] < iters or launches < iters:
        fail(f"[sharded_nccl1] the group path did not run: {calls}, B1 {launches}")
    return ({"backend": backend, "iters": iters, "launches": launches,
             "calls": calls, "solve_s": secs, "x_bitwise_main": same},
            table, offsets, halo)


def sharded4_phase(nel, x_main, card, device="cuda:0"):
    """[sharded4]: the headline at full width over 4 spawned ranks sharing
    cuda:0 through a gloo group, then in the same ranks the sharded LX
    kernels and the collectives ablation."""
    import numpy as np

    world = 4
    t0 = time.perf_counter()
    ranks = _spawn_ranks(_sharded_headline_rank, world, (nel, 2, device))
    wall_s = time.perf_counter() - t0
    r0 = ranks[0]
    for r in ranks:
        log(f"[sharded4] rank {r['rank']}: build {r['build_s']:.2f} s, warm solve "
            f"{r['warm_s']:.3f} s, iters={r['iters']} rounds={r['refine_rounds']} "
            f"(device {r['device_rounds']}) relres={r['relres']:.3e} B1 launches="
            f"{r['launches']}, collectives {r['calls']}")
        if r["x_sha"] != r0["x_sha"] or r["iters"] != r0["iters"]:
            fail(f"[sharded4] rank {r['rank']} returned another x or count than rank 0")
        if r["breakdown"] or not r["relres"] < SOLVE_TOL:
            fail(f"[sharded4] rank {r['rank']}: breakdown {r['breakdown']}, host f64 "
                 f"relres {r['relres']:.3e}")
        if r["launches"] < r["iters"]:
            fail(f"[sharded4] rank {r['rank']}: B1 launched {r['launches']} times "
                 f"for {r['iters']} iterations")
    iters = r0["iters"]
    x = r0["x"]
    if x.shape != x_main.shape or not np.all(np.isfinite(x)):
        fail("[sharded4] solution not finite or of the wrong shape")
    dx = float(np.linalg.norm(x - x_main) / np.linalg.norm(x_main))
    tts = statistics.median(r0["timed_s"])
    log(f"[sharded4] {world} ranks sharing one card (gloo, host copies): n_pad "
        f"{r0['n_pad']}, {r0['nrb_loc']} nodes a shard, halo {r0['halo']}; "
        f"iters={iters} (JAX package on a CPU at nshards 4: "
        f"{SHARDED4_ANCHOR_ITERS}); rank 0's timed solves (s) "
        f"{[round(v, 4) for v in r0['timed_s']]}, median {tts:.4f} s "
        f"({1e3 * tts / iters:.3f} ms/iteration; 4 ranks share one card: not a "
        f"scaling number); |x - x_main|/|x_main| = {dx:.3e}; spawn {wall_s:.1f} s")
    if not within(iters, SHARDED4_ANCHOR_ITERS, PATH_BAND):
        fail(f"[sharded4] {iters} iterations, outside {SHARDED4_ANCHOR_ITERS} ± "
             f"{100 * PATH_BAND:.0f} %")
    lx, ablation = sharded4_lx_checks(ranks, card)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_sharded4.txt"), "w") as f:
        f.write(r0["profile_table"])
    log(f"[profile] rank 0 of [sharded4], one solve by host time (device "
        f"{r0['profile_device_ms']:.1f} ms of {r0['profile_wall_ms']:.1f} ms wall, "
        f"busy {100 * r0['profile_device_ms'] / r0['profile_wall_ms']:.0f} %; "
        "4 ranks share the card):")
    for line in r0["profile_table"].splitlines()[:15]:
        log("[profile] " + line)
    return {"world": world, "iters": iters, "refine_rounds": r0["refine_rounds"],
            "relres": r0["relres"], "launches": [r["launches"] for r in ranks],
            "calls": r0["calls"], "build_s": [r["build_s"] for r in ranks],
            "build_stages_s": r0["timings"], "warm_s": r0["warm_s"],
            "solve_s": r0["timed_s"], "ms_per_iter": 1e3 * tts / iters,
            "n_pad": r0["n_pad"], "nrb_loc": r0["nrb_loc"], "halo": r0["halo"],
            "dx_main": dx, "spawn_s": wall_s, "anchor_iters": SHARDED4_ANCHOR_ITERS,
            "profile_device_ms": r0["profile_device_ms"],
            "profile_wall_ms": r0["profile_wall_ms"], "lx": lx, "ablation": ablation}


def sharded4_lx_checks(ranks, card):
    """[sharded4]'s sharded LX kernels and timing ablation, from every
    rank's records: the same R, Q and ids on every rank, the planted
    columns found, Q orthonormal; the ablation's fixed-length solves at
    ABLATION_ITERS on every rank, no all-reduce and no ring exchange with
    the knob on, and its ms an iteration with and without collectives."""
    import numpy as np

    lx0 = ranks[0]["lx"]
    for r in ranks:
        lx = r["lx"]
        if any(lx[k] != lx0[k] for k in ("r_sha", "q_sha", "selected", "qr_cols")):
            fail(f"[sharded4] lx: rank {r['rank']} returned another R, Q or "
                 "selection than rank 0")
    planted = set(lx0["planted"])
    resid = float(np.sqrt(sum(r["lx"]["resid_sq"] for r in ranks)
                          / sum(r["lx"]["norm_sq"] for r in ranks)))
    log(f"[sharded4] lx on a planted ({LX_SHARDED_COLS} columns, "
        f"{LX_SHARDED_COLS // len(ranks)} a rank) f32 matrix of the headline's rows, "
        f"k {LX_SHARDED_K}: tsqr_r_distributed (f64, rows sharded) ‖R − R_qr‖/‖R_qr‖ "
        f"{lx0['r_rel']:.3e}; tournament_select_sharded selected "
        f"{sorted(lx0['selected'])} (the planted columns: "
        f"{set(lx0['selected']) == planted}); tp_qr_sharded ‖QᵀQ − I‖_F "
        f"{lx0['orth']:.3e}, ‖A − QR‖_F/‖A‖_F {resid:.3e}; rank 0's seconds "
        + json.dumps({k: round(v, 4) for k, v in lx0["secs"].items()})
        + f"; every rank the same R, Q and ids | {card}")
    if set(lx0["selected"]) != planted or set(lx0["qr_cols"]) != planted:
        fail(f"[sharded4] lx: selected {sorted(lx0['selected'])}, planted "
             f"{sorted(planted)}")
    if not (lx0["r_rel"] < 1e-8 and lx0["orth"] < LX_ORTH_TOL):
        fail(f"[sharded4] lx: R {lx0['r_rel']:.3e}, Q {lx0['orth']:.3e}")
    for r in ranks:
        for name, runs in r["ablation"].items():
            for run in runs:
                calls = run["calls"]
                if name == "coll" and (run["iters"] != ABLATION_ITERS or run["breakdown"]):
                    fail(f"[sharded4] ablation: rank {r['rank']} ran {run['iters']} "
                         f"iterations with the collectives, not {ABLATION_ITERS}")
                if run["iters"] < 1:
                    fail(f"[sharded4] ablation: rank {r['rank']} ran no iteration")
                off = calls["all_reduce"] == 0 and calls["ring_exchange"] == 0
                if off != (name == "nocoll"):
                    fail(f"[sharded4] ablation: rank {r['rank']} {name} made the "
                         f"collectives {calls}")
    abl = ranks[0]["ablation"]
    # ms an iteration of rank 0, each solve by its own count: without the
    # collectives a rank's local algebra is wrong, and it may break down early
    ms = {name: statistics.median(1e3 * run["secs"] / run["iters"] for run in runs)
          for name, runs in abl.items()}
    comm_frac = 1.0 - ms["nocoll"] / ms["coll"]
    counts = [[run["iters"] for run in r["ablation"]["nocoll"]] for r in ranks]
    log(f"[sharded4] ablation ({TIMING_KNOB}, results wrong by construction): the "
        f"headline operator with block Jacobi, {ABLATION_ITERS} iterations a solve "
        f"(tol 1e-30), in turns off, on, on, off: {ms['coll']:.3f} ms an iteration "
        f"with the collectives, {ms['nocoll']:.3f} without; comm_frac "
        f"{comm_frac:.3f} (rank 0; 4 ranks share one card through gloo: host round "
        f"trips, not scaling); iterations without the collectives by rank "
        f"{counts} (a rank whose wrapped local operator is indefinite breaks down); "
        f"collectives a solve {abl['coll'][0]['calls']} / {abl['nocoll'][0]['calls']} "
        f"| {card}")
    lx = dict(lx0, resid=resid)
    for k in ("r_sha", "q_sha"):
        lx.pop(k)
    return lx, {"iters": ABLATION_ITERS, "ms_per_iter": ms["coll"],
                "ms_per_iter_nocoll": ms["nocoll"], "comm_frac": comm_frac,
                "nocoll_iters_by_rank": counts, "runs": abl}


def sharded_dryrun_phase(device="cuda:0"):
    """[sharded_dryrun]: dryrun_multichip's three DistributedECG paths over 4
    ranks sharing the card (f32; ell+bj also f64), stencil+bj2l also over
    8."""
    out = {}
    plan = ((4, [("dry_stencil_bj2l", "f32"), ("dry_ell_bj", "f32"),
                 ("dry_ell_bj", "f64"), ("dry_stencil_cheb", "f32")]),
            (8, [("dry_stencil_bj2l", "f32")]))
    for world, runs in plan:
        t0 = time.perf_counter()
        ranks = _spawn_ranks(_dryrun_rank, world, (runs, device))
        wall_s = time.perf_counter() - t0
        for key, rec in ranks[0].items():
            path, dt = rec["path"], rec["dtype"]
            for r in ranks:
                if r[key]["x_sha"] != rec["x_sha"] or r[key]["iters"] != rec["iters"]:
                    fail(f"[sharded_dryrun] {key} at {world}: ranks disagree")
            # f32 refines to the tolerance on the host f64 residual; f64 is
            # one solve, held to 10 × its tolerance
            if rec["breakdown"] or not rec["relres"] < (1e-6 if dt == "f32" else 1e-5):
                fail(f"[sharded_dryrun] {key} at {world}: breakdown "
                     f"{rec['breakdown']}, relres {rec['relres']:.3e}")
            stencil = path != "dry_ell_bj"
            if stencil and min(r[key]["launches"] for r in ranks) < rec["iters"]:
                fail(f"[sharded_dryrun] {key} at {world}: B1 launched fewer times "
                     "than iterations")
            anchor = DRYRUN_ANCHOR_ITERS[(path, dt, world)]
            held = (path, dt) in DRYRUN_HELD
            log(f"[sharded_dryrun] {path} {dt} over {world} ranks: iters="
                f"{rec['iters']} rounds={rec['refine_rounds']} relres="
                f"{rec['relres']:.3e} in {rec['secs']:.2f} s (rank 0), B1 "
                f"launches {[r[key]['launches'] for r in ranks]}, "
                f"{rec['nodes_a_shard']} nodes a shard, halo {rec['halo']}; JAX "
                f"on a CPU at nshards {world}: {anchor}"
                + (f" (held to ± {100 * PATH_BAND:.0f} %)" if held else
                   " (logged, not held: f32 stall windows)")
                + (f"; MULTICHIP_r05.json at 8 shards: {MULTICHIP_R05[path]}"
                   if dt == "f32" else ""))
            if held and not within(rec["iters"], anchor, PATH_BAND):
                fail(f"[sharded_dryrun] {key} at {world}: {rec['iters']} "
                     f"iterations, outside {anchor} ± {100 * PATH_BAND:.0f} %")
            out[f"{key}_x{world}"] = dict(
                rec, world=world, anchor_iters=anchor, held=held,
                launches=[r[key]["launches"] for r in ranks])
        log(f"[sharded_dryrun] {world} ranks: spawn and solves {wall_s:.1f} s")
    return out


PROFILE_ITERS = 40   # iterations of a profiled window ([sharded_general4],
                     # [sharded_dia4], [dlorasc_large]): a window keeps the
                     # profiler's event count, and its own cost, small
SHARDED_FULL = {   # the full-width sharded phases: build keywords, layout, kernel
    "sharded_general4": (dict(fmt="block_ell", precond="bj", block_size=240),
                         "nt", "block_ell_spmm_pallas"),
    "sharded_dia4": (dict(fmt="dia", precond="bj", grid=None), "tbn",
                     "stencil_flat_ext"),
}


def _sharded_full_rank(rank, group, path, nel, device):
    """One rank of [sharded_general4] or [sharded_dia4]: the path's f32
    build of elasticity3d(nel³) over the group on the shared card
    (``device``; t 12 odir_fused, tol 1e-5, host-f64 rounds), a solve with
    the path kernel's count zeroed just before and read just after, one
    timed solve (this rank's host clock), a window of PROFILE_ITERS
    iterations (one round) on every rank, rank 0's under torch.profiler,
    then on rank 0, while the others wait, the kernel against its plain
    version at this shard's shape (t 12 and t 1, device time, bound,
    torch.sparse.mm on the shard's rows of its extended operator)."""
    import hashlib
    from dataclasses import replace

    import numpy as np
    import torch

    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.ops import spmm
    from prealps_tpu_torch.parallel import mesh
    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions
    from prealps_tpu_torch.utils.timing import sync

    kw, layout, kernel = SHARDED_FULL[path]
    counter = getattr(spmm, kernel)
    a = elasticity3d(nel, nel, nel, heterogeneous=False)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    t0 = time.perf_counter()
    solver = DistributedECG.build(
        a, nshards=mesh.size_of(group), dtype=np.float32, device=device,
        group=group, opts=ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000,
                                     variant="odir_fused", layout=layout), **kw)
    build_s = time.perf_counter() - t0
    ops = solver.operands
    before = _collective_calls()
    counter.launches = 0
    sync(device)
    t0 = time.perf_counter()
    x, info = solver.solve(b)
    sync(device)
    warm_s = time.perf_counter() - t0
    launches = counter.launches
    calls = {k: v - before[k] for k, v in _collective_calls().items()}
    sync(device)
    t0 = time.perf_counter()
    solver.solve(b)
    sync(device)
    timed_s = time.perf_counter() - t0
    on_card = torch.device(device).type == "cuda"
    # the busy share: the first PROFILE_ITERS iterations of a third solve
    # on every rank (the collectives must pair up), rank 0's profiled
    solver.opts = replace(solver.opts, maxiter=PROFILE_ITERS)
    prof_rec = {}
    if rank == 0 and on_card:
        from torch.profiler import ProfilerActivity, profile as tprofile

        from prealps_tpu_torch.timing import device_busy_ms

        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, pinfo = solver.solve(b, max_refine_rounds=1)
            sync(device)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        prof_rec = {"profile_device_ms": device_busy_ms(prof),
                    "profile_wall_ms": wall_ms, "profile_iters": int(pinfo["iters"]),
                    "profile_table": prof.key_averages().table(
                        sort_by="self_cpu_time_total", row_limit=30)}
    else:
        solver.solve(b, max_refine_rounds=1)
    if path == "sharded_general4":
        shard = {"nrb": int(ops.mat.blocks.shape[0]), "s_max": int(ops.mat.blocks.shape[1]),
                 "ext_rows": int(ops.mat.shape[1]), "hb": int(ops.send_idx.shape[1]),
                 "blocks_MB": ops.mat.blocks.numel() * ops.mat.blocks.element_size() / 1e6,
                 "entries_MB": 8 * ops.mat.entries.nnz / 1e6}
    else:
        shard = {"D": len(ops.offsets), "halo": ops.halo, "nrb": ops.nrb,
                 "rem_width": None if ops.rem_vals is None else int(ops.rem_vals.shape[1]),
                 "rem_halo_rows": (None if ops.rem_send_idx is None
                                   else int(ops.rem_send_idx.numel()))}
    checks = []
    if rank == 0 and on_card:
        if path == "sharded_general4":
            checks = [check_block_ell(f"[{path}] rank 0's shard (bk128,t{t})", ops.mat, t,
                                      seed=90 + t)
                      for t in (12, 1)]
        else:
            flat = ops.blocks_flat
            csr = stencil_csr_ext(flat[:, None, None, :], ops.offsets, ops.halo)
            checks = [check_kernel(f"[{path}] rank 0's shard, B1 (br1,D{len(ops.offsets)},"
                                   f"t{t})", flat, ops.offsets, ops.halo, 1, t,
                                   seed=94 + t, csr=csr, device_time=True)
                      for t in (12, 1)]
            del csr
    mesh.all_reduce(torch.zeros(1), group)     # the others wait for rank 0's checks
    return {"rank": rank, "iters": int(info["iters"]), **prof_rec,
            "refine_rounds": info["refine_rounds"], "breakdown": bool(info["breakdown"]),
            "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
            "launches": launches, "calls": calls, "build_s": build_s,
            "build_stages_s": solver.timings, "warm_s": warm_s, "timed_s": timed_s,
            "n_pad": solver.layout.n_pad, "rows_per_shard": solver.layout.rows_per_shard,
            "shard": shard, "checks": checks,
            "peak_MB": torch.cuda.max_memory_allocated(device) / 1e6 if on_card else None,
            "x_sha": hashlib.sha256(x.tobytes()).hexdigest(),
            "x": x if rank == 0 else None}


def sharded_full_phase(path, anchor, nel, device="cuda:0"):
    """[sharded_general4] or [sharded_dia4]: the path at nel³ over 4
    spawned ranks sharing the card through a gloo group. Every rank the
    same x, host f64 relres < 1e-5, no breakdown, the path's kernel
    launched >= iterations on every rank, iterations within ANCHOR_BAND of
    the JAX driver's at nshards 4 on a CPU. Returns (record, the kernel
    checks of rank 0's shard)."""
    import numpy as np

    world = 4
    t0 = time.perf_counter()
    ranks = _spawn_ranks(_sharded_full_rank, world, (path, nel, device))
    wall_s = time.perf_counter() - t0
    r0 = ranks[0]
    kernel = SHARDED_FULL[path][2]
    for r in ranks:
        log(f"[{path}] rank {r['rank']}: build {r['build_s']:.2f} s (stages "
            + json.dumps({k: round(v, 3) for k, v in r["build_stages_s"].items()})
            + f"), warm solve {r['warm_s']:.3f} s, timed solve {r['timed_s']:.3f} s, "
            f"iters={r['iters']} rounds={r['refine_rounds']} relres={r['relres']:.3e} "
            f"{kernel} launches={r['launches']}, collectives {r['calls']}, peak "
            f"device memory {r['peak_MB']} MB; shard {r['shard']}")
        if r["x_sha"] != r0["x_sha"] or r["iters"] != r0["iters"]:
            fail(f"[{path}] rank {r['rank']} returned another x or count than rank 0")
        if r["breakdown"] or not r["relres"] < SOLVE_TOL:
            fail(f"[{path}] rank {r['rank']}: breakdown {r['breakdown']}, host f64 "
                 f"relres {r['relres']:.3e}")
        if r["launches"] < r["iters"]:
            fail(f"[{path}] rank {r['rank']}: {kernel} launched {r['launches']} times "
                 f"for {r['iters']} iterations")
    iters = r0["iters"]
    if r0["x"].shape != (3 * (nel + 1) * (nel + 1) * nel,) or not np.all(
            np.isfinite(r0["x"])):
        fail(f"[{path}] solution not finite or of the wrong shape")
    log(f"[{path}] {world} ranks sharing one card (gloo, host copies): n_pad "
        f"{r0['n_pad']}, {r0['rows_per_shard']} rows a shard; iters={iters} (JAX "
        f"package on a CPU at nshards 4: {anchor}); rank 0's timed solve "
        f"{r0['timed_s']:.3f} s ({1e3 * r0['timed_s'] / iters:.3f} ms/iteration; 4 "
        f"ranks share one card: not a scaling number); spawn {wall_s:.1f} s")
    if not within(iters, anchor):
        fail(f"[{path}] {iters} iterations, outside {anchor} ± "
             f"{100 * ANCHOR_BAND:.0f} %")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"profile_{path}.txt"), "w") as f:
        f.write(r0["profile_table"])
    log(f"[profile] rank 0 of [{path}], a window of {r0['profile_iters']} "
        f"iterations by host time (device {r0['profile_device_ms']:.1f} ms of "
        f"{r0['profile_wall_ms']:.1f} ms wall, busy "
        f"{100 * r0['profile_device_ms'] / r0['profile_wall_ms']:.1f} %; 4 ranks "
        "share the card):")
    for line in r0["profile_table"].splitlines()[:15]:
        log("[profile] " + line)
    rec = {k: r0[k] for k in ("iters", "refine_rounds", "relres", "n_pad",
                              "rows_per_shard", "shard", "build_stages_s", "calls",
                              "profile_device_ms", "profile_wall_ms",
                              "profile_iters")}
    rec.update(world=world, nel=nel, anchor_iters=anchor, spawn_s=wall_s,
               launches=[r["launches"] for r in ranks],
               build_s=[r["build_s"] for r in ranks],
               warm_s=[r["warm_s"] for r in ranks],
               timed_s=[r["timed_s"] for r in ranks],
               peak_MB=[r["peak_MB"] for r in ranks],
               ms_per_iter=1e3 * r0["timed_s"] / iters)
    return rec, r0["checks"]


def _formats_rank(rank, group, names, device):
    """One rank of [sharded_formats]: each path of ``names`` built over the
    group (f64) and solved; the stencil on nt also as ELL on its layout."""
    import hashlib

    import numpy as np

    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.parallel import mesh
    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions
    from prealps_tpu_torch.utils.timing import sync

    out = {}
    for name in names:
        _, problem, kw, opts = SHARDED_FORMATS[name]
        a, b = sharded_formats_problem(problem, elasticity3d)

        def run(**extra):
            s = DistributedECG.build(a, nshards=mesh.size_of(group), dtype=np.float64,
                                     device=device, group=group,
                                     opts=ECGOptions(**opts), **{**kw, **extra})
            sync(device)
            t0 = time.perf_counter()
            x, info = s.solve(b)
            sync(device)
            return s, x, info, time.perf_counter() - t0

        s, x, info, secs = run()
        rec = {"iters": int(info["iters"]), "breakdown": bool(info["breakdown"]),
               "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
               "tol": opts["tol"], "solve_s": secs, "n_pad": s.layout.n_pad,
               "chosen": (s.fmt_info or {}).get("chosen"),
               "operands": type(s.operands).__name__, "layout": s.operands.layout,
               "x_sha": hashlib.sha256(x.tobytes()).hexdigest()}
        if name == "stencil_nt":
            _, x_e, info_e, _ = run(fmt="ell", layout=s.layout)
            rec.update(ell_iters=int(info_e["iters"]),
                       ell_dx=float(np.linalg.norm(x - x_e) / np.linalg.norm(x_e)))
        out[name] = rec
    return out


def sharded_formats_phase(device="cuda:0"):
    """[sharded_formats]: the JAX tests' small sharded paths on the card, f64
    (the plain products): the stencil on nt (the iterations of ELL on its
    layout), block-ELL through its block halo, fmt="auto" choosing DIA
    under RCM over 4 ranks, DIA on nt over 8; each within ANCHOR_BAND of the
    JAX driver's count at the same nshards, relres < 20 × its tolerance,
    every rank the same x."""
    out = {}
    for world in sorted({v[0] for v in SHARDED_FORMATS.values()}):
        names = [k for k, v in SHARDED_FORMATS.items() if v[0] == world]
        t0 = time.perf_counter()
        ranks = _spawn_ranks(_formats_rank, world, (names, device))
        wall_s = time.perf_counter() - t0
        for name in names:
            rec = ranks[0][name]
            anchor = SHARDED_FORMATS_ANCHOR_ITERS[name]
            log(f"[sharded_formats] {name} over {world} ranks: {rec['operands']} on "
                f"{rec['layout']}" + (f" (chose {rec['chosen']})" if rec["chosen"] else "")
                + f", n_pad {rec['n_pad']}, iters={rec['iters']} relres="
                f"{rec['relres']:.3e} in {rec['solve_s']:.2f} s (rank 0); JAX on a CPU "
                f"at nshards {world}: {anchor}"
                + (f"; ELL on its layout {rec['ell_iters']} iterations, |dx|/|x| "
                   f"{rec['ell_dx']:.2e}" if name == "stencil_nt" else ""))
            if any(r[name]["x_sha"] != rec["x_sha"] or r[name]["iters"] != rec["iters"]
                   for r in ranks):
                fail(f"[sharded_formats] {name}: ranks disagree")
            if rec["breakdown"] or not rec["relres"] < 20 * rec["tol"]:
                fail(f"[sharded_formats] {name}: breakdown {rec['breakdown']}, "
                     f"relres {rec['relres']:.3e}")
            if not within(rec["iters"], anchor):
                fail(f"[sharded_formats] {name}: {rec['iters']} iterations, outside "
                     f"{anchor} ± {100 * ANCHOR_BAND:.0f} %")
            if name == "stencil_nt" and rec["ell_iters"] != rec["iters"]:
                fail(f"[sharded_formats] the stencil on nt took {rec['iters']} "
                     f"iterations, ELL on its layout {rec['ell_iters']}")
            if name == "auto" and rec["chosen"] != "dia_rcm":
                fail(f"[sharded_formats] auto chose {rec['chosen']}, not dia_rcm")
            out[name] = dict(rec, world=world, anchor_iters=anchor)
        log(f"[sharded_formats] {world} ranks: spawn and solves {wall_s:.1f} s")
    return out


DLORASC_TIMEOUT = 900      # seconds the distributed LORASC spawn may take


def _dlorasc_rank(rank, group, device):
    """One rank of [dlorasc_large] and [dlorasc_dryrun]: the 32³ build and
    solve over the group (collective counts zeroed just before the solve
    and read just after, then a solve of rank 0 under torch.profiler), then
    the three dry-run LORASC paths."""
    import hashlib
    from dataclasses import replace

    import numpy as np
    import torch

    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.parallel import mesh
    from prealps_tpu_torch.parallel.lorasc_driver import DistributedLorascECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions
    from prealps_tpu_torch.utils.timing import sync

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)       # the allocator's stats exist once it has run
    torch.cuda.reset_peak_memory_stats(dev)
    wall = {}
    t0 = time.perf_counter()
    a = elasticity3d(32, 32, 32)
    b = np.random.default_rng(0).standard_normal(a.shape[0])
    wall["generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    s = DistributedLorascECG.build(
        a, nshards=8, dtype=np.float64, device=device, group=group,
        opts=ECGOptions(t=4, tol=1e-5, maxiter=2000, variant="odir_fused"))
    wall["build"] = build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated(dev)
    for f in (mesh.all_reduce, mesh.all_gather, mesh.broadcast):
        f.calls = 0
    sync(dev)
    t0 = time.perf_counter()
    x, info = s.solve(b)
    sync(dev)
    wall["solve"] = solve_s = time.perf_counter() - t0
    calls = {f.__name__: f.calls for f in (mesh.all_reduce, mesh.all_gather,
                                            mesh.broadcast)}
    large = {"iters": int(info["iters"]), "breakdown": bool(info["breakdown"]),
             "deflated": int(info["deflated"]), "solve_s": solve_s,
             "relres": float(np.linalg.norm(b - a @ x) / np.linalg.norm(b)),
             "calls": calls, "build_s": build_s, "timings": s.timings,
             "ngroups": s.ngroups, "ng_max": s.ng_max, "ni_max": s.ni_max,
             "sep_padded_rows": s.ng_max * s.ngroups, "n": s.n,
             "n_pad": int(s.row_of.shape[0]), "ng_tot": s.geo["ng_tot"],
             "banded": bool(s.geo["agg_banded"]),
             "band": [s.geo["nblk"], s.geo["bs"]],
             "sep_band": [s.geo["nblk_a"], s.geo["bs_a"]],
             "peak_build_bytes": build_peak,
             "peak_bytes": torch.cuda.max_memory_allocated(dev),
             "x_sha": hashlib.sha256(x.tobytes()).hexdigest(),
             "x_ok": bool(x.shape == (a.shape[0],) and np.all(np.isfinite(x)))}
    # the busy share: rank 0's device time over a window of the first
    # PROFILE_ITERS iterations of a second solve (a window keeps the
    # profiler's event count, and its own cost, small)
    t0 = time.perf_counter()
    s.opts = replace(s.opts, maxiter=PROFILE_ITERS)
    if rank == 0:
        from torch.profiler import ProfilerActivity, profile as tprofile

        from prealps_tpu_torch.timing import device_busy_ms

        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            tp = time.perf_counter()
            _, pinfo = s.solve(b)
            sync(dev)
            wall_ms = 1e3 * (time.perf_counter() - tp)
        large.update(profile_device_ms=device_busy_ms(prof), profile_wall_ms=wall_ms,
                     profile_iters=int(pinfo["iters"]),
                     profile_table=prof.key_averages().table(
                         sort_by="self_cpu_time_total", row_limit=30))
    else:
        s.solve(b)
    wall["profile"] = time.perf_counter() - t0
    del s, a, x
    torch.cuda.empty_cache()

    from prealps_tpu_torch.dryrun import lorasc_paths

    t0 = time.perf_counter()
    dry = lorasc_paths(group, device)
    wall["dryrun"] = time.perf_counter() - t0
    large["wall_s"] = wall
    return {"rank": rank, "large": large, "dry": dry}


def dlorasc_phase(device="cuda:0"):
    """[dlorasc_large] and [dlorasc_dryrun]: the distributed LORASC driver
    over 8 ranks sharing the card (one spawn)."""
    world = 8
    t0 = time.perf_counter()
    ranks = _spawn_ranks(_dlorasc_rank, world, (device,),
                         timeout=DLORASC_TIMEOUT, threads=1)
    wall_s = time.perf_counter() - t0
    r0 = ranks[0]["large"]
    for r in ranks:
        lg = r["large"]
        if lg["x_sha"] != r0["x_sha"] or lg["iters"] != r0["iters"]:
            fail(f"[dlorasc_large] rank {r['rank']} returned another x or count "
                 "than rank 0")
        for path, rec in r["dry"].items():
            if rec["x_sha"] != ranks[0]["dry"][path]["x_sha"]:
                fail(f"[dlorasc_dryrun] {path}: rank {r['rank']} returned another x")
    st = r0["timings"]
    log(f"[dlorasc_large] elasticity3d(32³) n={r0['n']} over {world} ranks sharing "
        f"one card (gloo): ngroups={r0['ngroups']} ng_max={r0['ng_max']} separator "
        f"{r0['ng_tot']} rows, {r0['sep_padded_rows']} padded, banded={r0['banded']} "
        f"(nblk, bs) {r0['sep_band']}; interiors ni_max={r0['ni_max']} (nblk, bs) "
        f"{r0['band']}; n_pad={r0['n_pad']}; deflated={r0['deflated']}")
    log(f"[dlorasc_large] rank 0 build {r0['build_s']:.2f} s, stages (s): "
        + json.dumps({k: round(v, 3) for k, v in st.items()})
        + "; peak device memory per rank (GB, build / all): "
        + str([(round(r["large"]["peak_build_bytes"] / 1e9, 3),
                round(r["large"]["peak_bytes"] / 1e9, 3)) for r in ranks]))
    log(f"[dlorasc_large] solve: iters={r0['iters']} relres={r0['relres']:.3e} "
        f"breakdown={r0['breakdown']} TTS {r0['solve_s']:.3f} s (rank 0; 8 ranks "
        f"share one card: not a scaling number); collectives per solve "
        f"{r0['calls']}; JAX driver on a CPU, native partition: "
        f"{DLORASC_LARGE_ANCHOR_ITERS}; the JAX record: "
        f"{DLORASC_LARGE_RECORD_ITERS}; spawn {wall_s:.1f} s")
    if not r0["x_ok"] or r0["breakdown"] or not r0["relres"] < 1e-5:
        fail(f"[dlorasc_large] breakdown {r0['breakdown']}, relres "
             f"{r0['relres']:.3e}, finite x of the right shape {r0['x_ok']}")
    if not within(r0["iters"], DLORASC_LARGE_ANCHOR_ITERS):
        fail(f"[dlorasc_large] {r0['iters']} iterations, outside "
             f"{DLORASC_LARGE_ANCHOR_ITERS} ± {100 * ANCHOR_BAND:.0f} %")
    busy = r0["profile_device_ms"] / r0["profile_wall_ms"]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_dlorasc.txt"), "w") as f:
        f.write(r0["profile_table"])
    log(f"[profile] rank 0 of [dlorasc_large], the first {r0['profile_iters']} "
        f"iterations of a second solve: device {r0['profile_device_ms']:.1f} ms of "
        f"{r0['profile_wall_ms']:.1f} ms wall, busy {100 * busy:.1f} % (8 ranks "
        f"share the card); each rank's wall times (s): "
        + str([{k: round(v, 2) for k, v in r["large"]["wall_s"].items()}
               for r in ranks]))
    for line in r0["profile_table"].splitlines()[:15]:
        log("[profile] " + line)
    dry = {}
    for path, rec in ranks[0]["dry"].items():
        anchor, pairs = DLORASC_DRY_ANCHORS[path]
        log(f"[dlorasc_dryrun] {path} mesh {rec['mesh']}: iters={rec['iters']} "
            f"rounds={rec['refine_rounds']} deflated={rec['deflated']} relres="
            f"{rec['relres']:.3e} in {rec['secs']:.2f} s (rank 0); JAX on a CPU at "
            f"the same mesh: {anchor} iterations, {pairs} pairs; the card's "
            f"witnessed count: {DLORASC_DRY_CARD_ITERS.get(path, anchor)}; "
            f"MULTICHIP_r05.json: {DLORASC_DRY_R05[path]}")
        if rec["breakdown"] or not rec["relres"] < 1e-4:
            fail(f"[dlorasc_dryrun] {path}: breakdown {rec['breakdown']}, relres "
                 f"{rec['relres']:.3e}")
        held = DLORASC_DRY_CARD_ITERS.get(path, anchor)
        if not within(rec["iters"], held):
            fail(f"[dlorasc_dryrun] {path}: {rec['iters']} iterations, outside "
                 f"{held} ± {100 * ANCHOR_BAND:.0f} %")
        if rec["deflated"] != pairs:
            fail(f"[dlorasc_dryrun] {path}: {rec['deflated']} pairs deflated, not "
                 f"JAX's {pairs}")
        dry[path] = dict(rec, anchor_iters=anchor, anchor_pairs=pairs, held_iters=held)
    large = {k: v for k, v in r0.items() if k not in ("profile_table", "x_sha")}
    large.update(anchor_iters=DLORASC_LARGE_ANCHOR_ITERS,
                 record_iters=DLORASC_LARGE_RECORD_ITERS, busy_share=busy,
                 peak_bytes_per_rank=[r["large"]["peak_bytes"] for r in ranks],
                 spawn_s=wall_s)
    return {"dlorasc_large": large, "dlorasc_dryrun": dry}


# --- the communication-avoiding kernel tier ([lx]) -------------------------

LX_T = 12                 # panel width of the chain, TSQR and CholQR
LX_BS = 32                # spmsv_packed's square blocks
LX_STEPS = 8              # s of the s-step basis [B, AB, ..., A^s B]
LX_K = 24                 # columns TP-QR and TP-CUR select
LX_FRACTIONS = (1 / 16, 1 / 4, 1.0)   # spmsv_packed's active block rows
LX_DENSE_SWITCH = 0.5
LX_SEED = 13
LX_ORTH_TOL = 1e-4        # f32: ‖QᵀQ − I‖_F, ‖P̃ᵀAP̃ − I‖_F, R against torch.linalg.qr


def _fro(x) -> float:
    import torch

    return float(torch.linalg.norm(x.double()))


def _orth_err(q) -> float:
    """‖QᵀQ − I‖_F of a panel, formed in f64."""
    import torch

    q = q.double()
    return _fro(q.T @ q - torch.eye(q.shape[1], dtype=q.dtype, device=q.device))


def lx_phase(dev, a, card):
    """[lx]: the communication-avoiding kernel tier (ops/spmsv.py,
    ops/tsqr.py, ops/cholqr.py, ops/tournament.py) on the headline
    operator, symmetrically scaled as [general] scales it (n = 147,852),
    stored as block-ELL bk 128 with its packed entries (B5) and as square
    32-row blocks (spmsv_packed). Returns (record, B5's launches on the
    path's run)."""
    import numpy as np
    import torch

    from prealps_tpu_torch.core.scaling import sym_rac_scaling
    from prealps_tpu_torch.ops import tournament
    from prealps_tpu_torch.ops.cholqr import a_cholqr
    from prealps_tpu_torch.ops.formats import (
        BlockEllMatrix,
        csr_to_block_ell,
        pack_block_ell_entries,
    )
    from prealps_tpu_torch.ops.spmm import block_ell_spmm, block_ell_spmm_pallas
    from prealps_tpu_torch.ops.spmsv import (
        block_support_graph,
        pack_multivector,
        predict_c_support,
        spmsv_chain,
        spmsv_packed,
        spmsv_packed_device,
        unpack_multivector,
    )
    from prealps_tpu_torch.ops.tsqr import sign_fixed, tsqr
    from prealps_tpu_torch.timing import device_ms
    from prealps_tpu_torch.utils.timing import Timers, sync

    t_phase = time.perf_counter()
    n = a.shape[0]
    a_s, _ = sym_rac_scaling(a)
    bell = csr_to_block_ell(a_s, bm=8, bk=128, dtype=np.float32, device=dev)
    bell.entries = pack_block_ell_entries(bell)
    ab = csr_to_block_ell(a_s, bm=LX_BS, bk=LX_BS, dtype=np.float32, device=dev)
    nb, s32 = ab.blocks.shape[:2]
    offsets = np.minimum(np.arange(nb + 1) * LX_BS, n)
    graph = block_support_graph(a_s, offsets)
    absmat = BlockEllMatrix(bell.blocks.abs(), bell.blkcols, bell.shape)
    ncols = bell.shape[1]
    setup_s = time.perf_counter() - t_phase
    log(f"[lx] operator: elasticity3d(36³) RAC-scaled, n={n}; block-ELL bk 128 "
        f"({bell.entries.nnz} packed entries, B5) and {nb} row blocks of {LX_BS} "
        f"(S {s32}, {ab.blocks.numel() * 4 / 1e9:.3f} GB of dense blocks); block "
        f"graph nnz {graph.nnz}; set-up {setup_s:.2f} s | {card}")

    def padded(x):
        return torch.cat([x, x.new_zeros((ncols - n, x.shape[1]))])

    def b5(x):
        return block_ell_spmm_pallas(bell, padded(x))[:n]

    def plain(x):
        return block_ell_spmm(bell, padded(x))[:n]

    def abs_bound(x):
        """KERNEL_TOL · max(|A|·|x|): chip_smoke's f32 kernel tolerance."""
        return KERNEL_TOL * float(block_ell_spmm(absmat, padded(x.abs()))[:n].max())

    rng = np.random.default_rng(LX_SEED)
    b = torch.from_numpy(rng.standard_normal((n, LX_T)).astype(np.float32)).to(dev)
    p = torch.from_numpy(rng.standard_normal((n, LX_T)).astype(np.float32)).to(dev)
    struct0 = np.zeros(nb, dtype=bool)
    struct0[: nb // 8] = True

    # cuSOLVER's first calls (handles, workspaces) outside the timed steps
    tsqr(p)
    a_cholqr(p, p)
    # the path: the s-step chain and A-CholQR, B5's count zeroed just before
    # and read just after
    block_ell_spmm_pallas.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    panels, structs = spmsv_chain(b5, b, struct0, graph, offsets, LX_STEPS,
                                  dense_switch=LX_DENSE_SWITCH)
    sync(dev)
    chain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ap = b5(p)
    pt, apt, _ = a_cholqr(p, ap)
    a_pt = b5(pt)
    sync(dev)
    cholqr_s = time.perf_counter() - t0
    launches = block_ell_spmm_pallas.launches
    if dev.type == "cuda" and launches < LX_STEPS + 2:
        fail(f"[lx] B5 launched {launches} times on the path, fewer than its "
             f"{LX_STEPS + 2} products")

    # every panel against the same chain through the plain product
    plain_panels, plain_structs = spmsv_chain(plain, b, struct0, graph, offsets,
                                              LX_STEPS, dense_switch=LX_DENSE_SWITCH)
    b_masked = b.clone()
    b_masked[int(offsets[nb // 8]):] = 0
    chain_err = []
    for j in range(1, LX_STEPS + 1):
        prev = b_masked if j == 1 else plain_panels[j - 1]
        err = float((panels[j] - plain_panels[j]).abs().max())
        chain_err.append({"step": j, "max_abs_err": err, "err_bound": abs_bound(prev)})
        if not bool(torch.isfinite(panels[j]).all()):
            fail(f"[lx] chain step {j}: not finite")
        if err > chain_err[-1]["err_bound"]:
            fail(f"[lx] chain step {j}: max|B5 - plain| = {err:.3e} > "
                 f"{chain_err[-1]['err_bound']:.3e}")
        if not np.array_equal(structs[j], plain_structs[j]):
            fail(f"[lx] chain step {j}: the supports differ")
    fractions = [float(np.mean(s)) for s in structs]
    dense_at = next((j for j in range(1, LX_STEPS + 1)
                     if fractions[j] >= LX_DENSE_SWITCH), None)
    # the exact support: rows outside the predicted block rows are zero
    for j in range(1, LX_STEPS + 1):
        rows = np.repeat(structs[j], np.diff(offsets))
        outside = panels[j][torch.from_numpy(~rows).to(dev)]
        if outside.numel() and float(outside.abs().max()) != 0.0:
            fail(f"[lx] chain step {j}: nonzero rows outside the predicted support")
    errs = [f"{c['max_abs_err']:.2e}/{c['err_bound']:.2e}" for c in chain_err]
    log(f"[lx] spmsv_chain s={LX_STEPS} t={LX_T} from the first 1/8 of the row "
        f"blocks, dense_switch {LX_DENSE_SWITCH}: support fractions "
        f"{[round(f, 4) for f in fractions]}; dense from step "
        f"{dense_at if dense_at is not None else 'none (never reached)'}; "
        f"{chain_s:.3f} s; B5 launches on the path (chain + A-CholQR) {launches}; "
        f"per step max|B5 − plain| / bound {errs} | {card}")

    # spmsv_packed at three active fractions beside the dense-carrier B5
    packed = []
    for frac in LX_FRACTIONS:
        nact = max(1, int(round(frac * nb)))
        active = np.arange(nact)
        bf = torch.zeros((nb * LX_BS, LX_T), dtype=torch.float32, device=dev)
        hi = int(offsets[nact])
        bf[:hi] = b[:hi]
        b_ids, b_vals = pack_multivector(bf, LX_BS, active, cap=nact)
        c_ids = predict_c_support(graph, active, nb)
        c_ids_d, c_vals = spmsv_packed(ab, b_ids, b_vals, c_ids, len(c_ids))
        c = unpack_multivector(c_ids_d, c_vals, nb)[:n]
        y = b5(bf[:n])
        err = float((c - y).abs().max())
        err_bound = abs_bound(bf[:n])
        if not bool(torch.isfinite(c).all()) or err > err_bound:
            fail(f"[lx] spmsv_packed at {frac:.4f}: max|packed - B5| = {err:.3e} > "
                 f"{err_bound:.3e}")
        ms = device_ms(lambda: spmsv_packed_device(ab, b_ids, b_vals, c_ids_d))[0]
        xpad = padded(bf[:n])
        dense_ms = device_ms(lambda: block_ell_spmm_pallas(bell, xpad))[0]
        cap_c = len(c_ids)
        # the bound: the nonzero entries the product needs (A's in B's active
        # columns, f32 value and int32 column each, and the row pointers of
        # C's active rows), B's active rows read, C's active rows written;
        # the format bound: this algorithm's traffic, C's active block rows
        # of dense 32 × 32 blocks, every padded slot included
        nnz = int(np.count_nonzero(a_s.tocsr().indices < hi))
        c_rows = cap_c * LX_BS
        nbytes = 8 * nnz + 4 * (c_rows + 1) + 4 * LX_T * (hi + c_rows)
        format_nbytes = 4 * (cap_c * s32 * LX_BS * LX_BS + nact * LX_BS * LX_T
                             + cap_c * LX_BS * LX_T)
        rec = {"fraction": frac, "b_blocks": nact, "c_blocks": cap_c,
               "c_fraction": cap_c / nb, "ms": ms, "dense_b5_ms": dense_ms,
               "max_abs_err": err, "err_bound": err_bound, "nnz": nnz,
               "bytes": nbytes, "format_bytes": format_nbytes,
               **bound(nbytes, 2 * nnz * LX_T),
               "format_bound_ms": bound(format_nbytes, 2 * cap_c * s32 * LX_BS
                                        * LX_BS * LX_T)["bound_ms"]}
        packed.append(rec)
        log(f"[lx] spmsv_packed bs {LX_BS} t {LX_T}, B active {nact}/{nb} "
            f"({frac:.4f}), C active {cap_c} ({cap_c / nb:.4f}): device "
            f"{ms:.4f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
            f"{nbytes / 1e6:.1f} MB: the {nnz} entries in B's active columns, B, "
            f"C), format bound {rec['format_bound_ms']:.4f} ms ("
            f"{format_nbytes / 1e6:.1f} MB: C's active rows of dense blocks, B, "
            f"C); dense-carrier B5 on the same panel {dense_ms:.4f} ms; "
            f"max|packed − B5| {err:.3e} (bound {err_bound:.3e}) | {card}")
    base = packed[-1]["ms"]
    log("[lx] spmsv_packed cost against the active fraction: "
        + ", ".join(f"C {r['c_fraction']:.4f} -> {r['ms'] / base:.3f} of the full"
                    for r in packed) + f" | {card}")

    # TSQR and A-CholQR on a (n, 12) panel
    sync(dev)
    t0 = time.perf_counter()
    q, r = tsqr(p)
    sync(dev)
    tsqr_s = time.perf_counter() - t0
    r_ref = sign_fixed(torch.linalg.qr(p, mode="r").R)
    tsqr_rec = {"orth": _orth_err(q), "r_rel": _fro(r - r_ref) / _fro(r_ref),
                "recon": _fro(q @ r - p) / _fro(p), "secs": tsqr_s}
    ptap = pt.double().T @ a_pt.double()
    cholqr_rec = {"a_orth": _fro(ptap - torch.eye(LX_T, dtype=ptap.dtype, device=dev)),
                  "ap_consistency": _fro(apt - a_pt) / _fro(a_pt), "secs": cholqr_s}
    log(f"[lx] tsqr ({n} x {LX_T}, 8 leaves): ‖QᵀQ − I‖_F {tsqr_rec['orth']:.3e}, "
        f"‖R − R_qr‖/‖R_qr‖ {tsqr_rec['r_rel']:.3e} (torch.linalg.qr's R, signs "
        f"fixed), ‖QR − P‖/‖P‖ {tsqr_rec['recon']:.3e}, {tsqr_s:.4f} s; a_cholqr "
        f"with B5's AP: ‖P̃ᵀAP̃ − I‖_F {cholqr_rec['a_orth']:.3e}, ‖ÃP − AP̃‖/‖AP̃‖ "
        f"{cholqr_rec['ap_consistency']:.3e}, {cholqr_s:.4f} s (2 B5 products "
        f"included) | {card}")
    if not (tsqr_rec["orth"] < LX_ORTH_TOL and tsqr_rec["r_rel"] < LX_ORTH_TOL
            and tsqr_rec["recon"] < LX_ORTH_TOL):
        fail(f"[lx] tsqr off: {tsqr_rec}")
    if not cholqr_rec["a_orth"] < LX_ORTH_TOL:
        fail(f"[lx] a_cholqr off: {cholqr_rec}")

    # TP-QR and TP-CUR on the s-step basis [B, AB, ..., A^8 B]
    basis = torch.cat(panels, dim=1).contiguous()
    sv = torch.linalg.svdvals(torch.linalg.qr(basis.double(), mode="r").R)
    norm_b = float(torch.sqrt(torch.sum(sv ** 2)))
    best = float(torch.sqrt(torch.sum(sv[LX_K:] ** 2))) / norm_b
    tp = {}
    for name in ("tp_qr", "tp_cur"):
        steps = Timers(device=dev)
        sync(dev)
        t0 = time.perf_counter()
        out = getattr(tournament, name)(basis, LX_K, timers=steps)
        sync(dev)
        secs = time.perf_counter() - t0
        if name == "tp_qr":
            qk, rk, cols = out
            approx, rows = qk @ rk, None
            orth = _orth_err(qk)
        else:
            c_k, u_k, r_k, cols, rows = out
            approx, orth = c_k @ u_k @ r_k, None
        err = _fro(basis - approx) / norm_b
        rec = {"rel_err": err, "best_rank_k": best, "orth": orth, "secs": secs,
               "cols": cols.tolist(), "rows": None if rows is None else rows.tolist(),
               "steps_s": steps.as_dict(), "calls": dict(steps.count)}
        tp[name] = rec
        log(f"[lx] {name} of the s-step basis ({n} x {basis.shape[1]}), k {LX_K}: "
            f"‖S − approx‖_F/‖S‖_F {err:.3e} (best rank {LX_K}: {best:.3e})"
            + (f", ‖QᵀQ − I‖_F {orth:.3e}" if orth is not None else "")
            + f"; {secs:.3f} s, by step (s, calls): "
            + json.dumps({k: [round(v, 4), steps.count[k]] for k, v in steps.acc.items()})
            + f" (pivoted_cholesky inside tournament_select) | {card}")
        if not (np.isfinite(err) and err < 1.0):
            fail(f"[lx] {name}: relative error {err:.3e}")
        if len(set(rec["cols"])) != LX_K or (rows is not None
                                             and len(set(rec["rows"])) != LX_K):
            fail(f"[lx] {name}: repeated selections")
        if orth is not None and not orth < LX_ORTH_TOL:
            fail(f"[lx] {name}: ‖QᵀQ − I‖_F {orth:.3e}")
    del bell, ab, absmat, basis, panels, plain_panels
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"[lx] phase {secs:.1f} s | {card}")
    return {"n": n, "setup_s": setup_s, "chain_fractions": fractions,
            "dense_at_step": dense_at, "chain_s": chain_s, "chain_err": chain_err,
            "launches": launches, "packed": packed, "tsqr": tsqr_rec,
            "a_cholqr": cholqr_rec, **tp, "phase_s": secs, "card": card}, launches


# --- the native host library and the general-matrix single-device API -----

NATIVE_NEL = 36            # [native]: the partitions of elasticity3d(36³), 8 parts
NATIVE_PARTS = 8


def native_phase():
    """[native]: the host library built from prealps_tpu_torch/csrc/host
    (g++, native/Makefile's flags) must load; the k-way partition and the
    block-arrow structure of elasticity3d(36³) into 8 parts by it and by
    the Python algorithms (PREALPS_TPU_NO_NATIVE), timed on the host, with
    their separators."""
    import numpy as np

    from prealps_tpu_torch import native
    from prealps_tpu_torch.core import partition
    from prealps_tpu_torch.core.generators import elasticity3d

    t0 = time.perf_counter()
    ok = native.available()
    load_s = time.perf_counter() - t0
    if not ok:
        fail(f"[native] the native host library did not load: {native.build_info}")
    log(f"[native] library {os.path.relpath(native.build_info['path'], HERE)}: "
        f"g++ {native.build_info['seconds']:.2f} s (load {load_s:.2f} s)")
    a = elasticity3d(NATIVE_NEL, NATIVE_NEL, NATIVE_NEL)
    out = {"build_s": native.build_info["seconds"]}
    kway = partition.kway_partition
    for name, knob in (("native", None), ("python", "1")):
        if knob:
            os.environ["PREALPS_TPU_NO_NATIVE"] = knob
        seen = {}

        def timed_kway(*args, **kw):   # block_arrow_structure's own k-way call
            t0 = time.perf_counter()
            seen["part"] = kway(*args, **kw)
            seen["kway_s"] = time.perf_counter() - t0
            return seen["part"]

        partition.kway_partition = timed_kway
        try:
            if partition._use_native() != (knob is None):
                fail(f"[native] the {name} partitioner was not the one that ran")
            t0 = time.perf_counter()
            arrow = partition.block_arrow_structure(a, NATIVE_PARTS)
            arrow_s = time.perf_counter() - t0
        finally:
            partition.kway_partition = kway
            os.environ.pop("PREALPS_TPU_NO_NATIVE", None)
        sizes = np.bincount(seen["part"], minlength=NATIVE_PARTS)
        out[name] = {"kway_s": seen["kway_s"], "block_arrow_s": arrow_s,
                     "sep_size": arrow.sep_size, "part_min": int(sizes.min()),
                     "part_max": int(sizes.max())}
        log(f"[native] {name} partitioner, elasticity3d({NATIVE_NEL}³) n={a.shape[0]} "
            f"into {NATIVE_PARTS}: block_arrow_structure {arrow_s:.2f} s, of which "
            f"the k-way partition {seen['kway_s']:.2f} s (parts {sizes.min()}–"
            f"{sizes.max()} rows); separator {arrow.sep_size} rows")
    if not partition._use_native():
        fail("[native] the default partitioner is not the native library")
    return out


def _api_operands_on_card(solver, tag):
    """Every operand of an ECGSolver's solve must live on the card."""
    ops = solver.operands()
    off = [k for k, t in ops.items() if t.device.type != "cuda"]
    if not ops or off:
        fail(f"[{tag}] operands off the card: {off}")
    return len(ops)


def _pairs(solver) -> int:
    import torch

    return int(torch.count_nonzero(solver.precond.sigma))


def api_bj_phase(dev, a, b):
    """[api_bj]: [general]'s matrix through api.ECGSolver with host block
    Jacobi (1024-row blocks), f32 with host-f64 refinement rounds: every
    operand on the card, a checked solve held to relres < 1e-5 and to the
    JAX ECGSolver's count on a CPU within ANCHOR_BAND, TTS the median of
    three more, one solve under torch.profiler."""
    import numpy as np

    from prealps_tpu_torch.api import ECGSolver
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    problem, precond, kw, opts = API_CASES["api_bj"]
    anchor = API_ANCHORS["api_bj"]
    t0 = time.perf_counter()
    solver = ECGSolver.build(a, opts=ECGOptions(**opts), precond=precond,
                             dtype=np.float32, device=dev, **kw)
    build_s = time.perf_counter() - t0
    n_ops = _api_operands_on_card(solver, "api_bj")
    log(f"[api_bj] ECGSolver.build(elasticity3d({_size_arg(problem)}), block_jacobi, "
        f"f32) in {build_s:.2f} s, stages (s): "
        + json.dumps({k: round(v, 4) for k, v in solver.timings.items()})
        + f"; ELL width {solver.ell.vals.shape[1]}, block Jacobi nb="
        f"{solver.precond.factors.shape[0]} mb={solver.precond.factors.shape[1]} "
        f"mode={solver.precond.mode}; {n_ops} operands, all on the card")
    info, _, warm_s = checked_solve(solver, a, b, "api_bj")
    iters = int(info["iters"])
    timed = timed_solves(solver, b, iters, "api_bj")
    tts = statistics.median(timed)
    log(f"[api_bj] warm solve {warm_s:.3f} s: iters={iters} refine_rounds="
        f"{info['refine_rounds']} relres={info['relres']:.3e}; TTS median of 3 "
        f"{tts:.4f} s ({[round(v, 4) for v in timed]}), {1e3 * tts / iters:.3f} "
        f"ms/iteration (the JAX package on a CPU: {anchor} iterations)")
    if not within(iters, anchor):
        fail(f"[api_bj] ran {iters} iterations, outside {anchor} ± "
             f"{100 * ANCHOR_BAND:.0f} %")
    busy_ms, wall_ms = profile_solve(solver, b, "api_bj")
    return {"iters": iters, "refine_rounds": info["refine_rounds"],
            "relres": info["relres"], "warm_s": warm_s, "solve_s": timed,
            "tts_s": tts, "ms_per_iter": 1e3 * tts / iters, "build_s": build_s,
            "build_stages_s": solver.timings, "device_busy_ms": busy_ms,
            "profiled_wall_ms": wall_ms, "anchor_iters": anchor}


def _cli_json(argv):
    """One ``prealps_tpu_torch.cli lorasc`` run: (exit code, its JSON line)."""
    import contextlib
    import io

    from prealps_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["lorasc", *argv, "--json"])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    rec["cli_s"] = time.perf_counter() - t0
    return rc, rec


def api_schur_phases(dev):
    """[api_lorasc] / [api_presc]: the reference's elasticity3d_12x10x10 at
    the CLI's defaults through ``python -m prealps_tpu_torch.cli lorasc``
    on the card, -p lorasc (direct eigensolve) and -p presc (ssloc), in f64
    (held to JAX's CPU counts ±1, and their ECGSolver builds to JAX's
    pairs) and, -p presc, in f32 (the card's default: logged beside JAX's
    count, held to convergence); then PRESC with the banded local Schur
    complements (block_banded_schur on the card) through ECGSolver, f64."""
    import numpy as np

    from prealps_tpu_torch.api import ECGSolver
    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.solvers.ecg import ECGOptions

    out = {}
    for path in ("api_lorasc", "api_presc", "api_presc_banded"):
        problem, precond, kw, opts = API_CASES[path]
        tag = path
        a, b = api_problem(path, elasticity3d)
        anchor = API_ANCHORS[path]
        rec = {"n": a.shape[0]}
        if path != "api_presc_banded":
            # the f32 -p lorasc run (6,063 iterations, ~33 s, logged only) was
            # cut to keep the script inside its time limit
            for dname in ("f64",) if path == "api_lorasc" else ("f64", "f32"):
                rc, line = _cli_json([
                    "-p", precond, "--size", _size_arg(problem), "--nparts",
                    str(kw["nparts"]), "-e", str(opts["t"]), "-t", str(opts["tol"]),
                    "--dtype", dname])
                if rc != 0 or line["breakdown"]:
                    fail(f"[{tag}] the CLI in {dname} failed: {line}")
                rec[dname] = line
                ref = anchor[dname]
                log(f"[{tag}] cli lorasc -p {precond} --dtype {dname} (--size "
                    f"{_size_arg(problem)}, 8 parts, t 4, tol 1e-5): "
                    f"iters={line['iters']} refine_rounds={line.get('refine_rounds')} "
                    f"relres={line['relres']:.3e} in {line['cli_s']:.2f} s (the JAX "
                    f"package on a CPU: {ref} iterations)")
                if dname == "f64" and abs(line["iters"] - ref) > 1:
                    fail(f"[{tag}] f64 ran {line['iters']} iterations, JAX {ref} ± 1")
                if not line["relres"] < SOLVE_TOL:
                    fail(f"[{tag}] {dname} relres {line['relres']:.3e} >= {SOLVE_TOL}")
                if dname == "f32" and abs(line["iters"] - ref) > 0.1 * ref:
                    log(f"[{tag}] note: f32 count {line['iters']} differs from JAX's "
                        f"{ref} by more than 10 % (ROADMAP A4)")
        t0 = time.perf_counter()
        solver = ECGSolver.build(a, opts=ECGOptions(**opts), precond=precond,
                                 dtype=np.float64, device=dev, **kw)
        build_s = time.perf_counter() - t0
        _api_operands_on_card(solver, tag)
        pairs = _pairs(solver)
        info, _, solve_s = checked_solve(solver, a, b, tag)
        log(f"[{tag}] ECGSolver f64 on the card: built in {build_s:.2f} s (stages "
            + json.dumps({k: round(v, 4) for k, v in solver.timings.items()})
            + f"), ni={solver.precond.ni} ng={solver.precond.ng}, {pairs} pairs "
            f"(JAX {anchor['pairs']}); iters={info['iters']} (JAX {anchor['f64']}) "
            f"relres={info['relres']:.3e} in {solve_s:.3f} s")
        if pairs != anchor["pairs"]:
            fail(f"[{tag}] {pairs} deflated pairs, JAX {anchor['pairs']}")
        if abs(int(info["iters"]) - anchor["f64"]) > 1:
            fail(f"[{tag}] ECGSolver ran {info['iters']} iterations, JAX "
                 f"{anchor['f64']} ± 1")
        rec.update(pairs=pairs, build_s=build_s, build_stages_s=solver.timings,
                   solver_iters=int(info["iters"]), solver_relres=info["relres"],
                   solve_s=solve_s, anchor=anchor)
        out[path] = rec
    return out


def api_lanczos_phase(dev):
    """[api_lanczos]: build_lorasc with the Lanczos eigensolve on the card
    against the direct pairs of the same build (tests/test_lorasc.py:53-66:
    at least min(direct, 3) − 1 pairs), with the Ritz values beside the
    direct eigenvalues."""
    import numpy as np

    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.core.partition import block_arrow_structure
    from prealps_tpu_torch.core.scaling import sym_rac_scaling
    from prealps_tpu_torch.precond.lorasc import build_lorasc

    kw = API_CASES["api_lorasc"][2]
    a, _ = sym_rac_scaling(api_problem("api_lorasc", elasticity3d)[0])
    arrow = block_arrow_structure(a, kw["nparts"])
    built = {}
    for method in ("direct", "lanczos"):
        t0 = time.perf_counter()
        lor, _ = build_lorasc(a, arrow=arrow, deflation_tol=kw["deflation_tol"],
                              eig_method=method, device=dev)
        built[method] = (lor, time.perf_counter() - t0)
    (lor_d, d_s), (lor_l, l_s) = built["direct"], built["lanczos"]
    if lor_l.e_mat.device.type != "cuda":
        fail("[api_lanczos] the Lanczos pairs are not on the card")
    nd, nl = int((lor_d.sigma > 0).sum()), int((lor_l.sigma > 0).sum())
    lam = lambda lor: (kw["deflation_tol"] / (1 + lor.sigma)).cpu().numpy()
    k = min(nd, nl)
    gap = float(np.abs(lam(lor_l)[:k] - lam(lor_d)[:k]).max()) if k else 0.0
    log(f"[api_lanczos] separator {arrow.sep_size} rows: direct {nd} pairs in "
        f"{d_s:.2f} s, Lanczos (ncv {min(arrow.sep_size, 129)}) {nl} pairs in "
        f"{l_s:.2f} s on the card; max |λ_lanczos − λ_direct| over the first {k}: "
        f"{gap:.2e}")
    if nl < min(nd, 3) - 1:
        fail(f"[api_lanczos] Lanczos found {nl} pairs, direct {nd}")
    return {"direct_pairs": nd, "lanczos_pairs": nl, "max_lambda_gap": gap,
            "direct_s": d_s, "lanczos_s": l_s}


def checkpoint_phase(dev):
    """[checkpoint]: ecg_solve_checkpointed on the card (the [api_lorasc]
    build in f64, 25 iterations a chunk): a run in chunks, and a run
    stopped after its first chunk then resumed from its file in this
    process; each one's count and x equal the straight solve's."""
    import tempfile

    import numpy as np
    import torch

    from prealps_tpu_torch.api import ECGSolver
    from prealps_tpu_torch.core.generators import elasticity3d
    from prealps_tpu_torch.solvers.checkpoint import ecg_solve_checkpointed, load_state
    from prealps_tpu_torch.solvers.ecg import ECGOptions, ecg_solve

    class Stop(Exception):
        pass

    def stop_after_first(it, res):
        raise Stop

    _, precond, kw, opts = API_CASES["api_lorasc"]
    s = ECGSolver.build(api_problem("api_lorasc", elasticity3d)[0],
                        opts=ECGOptions(**opts), precond=precond,
                        dtype=np.float64, device=dev, **kw)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(s.n)).to(dev)
    straight = ecg_solve(s.a_apply, s.precond.apply, b, s.opts)
    chunks, resumed_chunks = [], []
    with tempfile.TemporaryDirectory() as tmp:
        res = ecg_solve_checkpointed(s.a_apply, s.precond.apply, b, s.opts,
                                     os.path.join(tmp, "whole.npz"), every=25,
                                     on_chunk=lambda it, r: chunks.append(it))
        path = os.path.join(tmp, "state.npz")
        try:
            ecg_solve_checkpointed(s.a_apply, s.precond.apply, b, s.opts, path,
                                   every=25, on_chunk=stop_after_first)
            fail("[checkpoint] the interrupted solve was not stopped")
        except Stop:
            pass
        half, _ = load_state(path, device=dev)
        resumed = ecg_solve_checkpointed(
            s.a_apply, s.precond.apply, b, s.opts, path, every=25,
            on_chunk=lambda it, r: resumed_chunks.append(it))
    same = bool(torch.equal(res.x, straight.x))
    same_resumed = bool(torch.equal(resumed.x, straight.x))
    log(f"[checkpoint] {len(chunks)} chunks at iterations {chunks}: {res.iters} "
        f"iterations, x bitwise equal to the straight solve's ({straight.iters}): "
        f"{same}; stopped at iteration {half.it}, resumed through {resumed_chunks}: "
        f"{resumed.iters} iterations, x bitwise equal: {same_resumed}")
    if res.iters != straight.iters or not same:
        fail("[checkpoint] the solve in chunks differs from the straight one")
    if half.it != 25 or half.mask.device.type != "cuda" or len(resumed_chunks) < 1:
        fail(f"[checkpoint] the interrupted solve's file holds iteration {half.it} "
             f"on {half.mask.device}, not 25 on the card")
    if resumed.iters != straight.iters or not same_resumed:
        fail("[checkpoint] the resumed solve differs from the straight one")
    if res.x.device.type != "cuda" or resumed.x.device.type != "cuda" or len(chunks) < 2:
        fail("[checkpoint] the solve did not run in chunks on the card")
    return {"chunks": chunks, "iters": int(res.iters), "bitwise": same,
            "stopped_at": int(half.it), "resumed_chunks": resumed_chunks,
            "resumed_iters": int(resumed.iters), "resumed_bitwise": same_resumed}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "prealps_tpu_torch")):
        fail("prealps_tpu_torch/ not found beside chip_smoke.py: run it from "
             "a checkout of the repository")
    sys.path.insert(0, HERE)
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")

    from prealps_tpu_torch import strict_fp32
    from prealps_tpu_torch.core.generators import elasticity3d, poisson3d
    from prealps_tpu_torch.core.layout import contiguous_row_layout, permute_and_pad_matrix
    from prealps_tpu_torch.direct.device_bj import bj_apply_pallas
    from prealps_tpu_torch.ops import _kernels
    from prealps_tpu_torch.ops.formats import (
        StencilBsrTMatrix,
        csr_to_block_ell,
        csr_to_stencil_bsr_t,
        stencil_blocks_flat,
    )
    from prealps_tpu_torch.ops.spmm import (
        block_ell_spmm_pallas,
        stencil_flat_ext,
        stencil_spmm_planar,
    )
    from prealps_tpu_torch.parallel.driver import DistributedECG
    from prealps_tpu_torch.solvers.ecg import ECGOptions
    from prealps_tpu_torch.timing import card_line

    strict_fp32()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # --- 1. the card ---
    smi = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi} | torch: {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    # --- 2. build the kernels ---
    t0 = time.perf_counter()
    _kernels.load()
    log(f"[build] kernels built in {time.perf_counter() - t0:.2f} s")
    for src, binfo in _kernels.build_info.items():
        log(f"[build] {src}: nvcc {binfo['seconds']:.2f} s -> "
            f"{os.path.relpath(binfo['path'], HERE)}")
        for line in binfo["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build] {line.strip()}")

    # --- 2a. the native host library: built, loaded, timed ---
    native_rec = native_phase()

    # --- 3. main path build at full size ---
    nel = 36
    t0 = time.perf_counter()
    a = elasticity3d(nel, nel, nel, heterogeneous=False)
    n = a.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    gen_s = time.perf_counter() - t0
    log(f"[main] elasticity3d({nel}³) n={n} nnz={a.nnz} generated in {gen_s:.2f} s")
    opts = ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000, variant="odir_fused",
                      layout="tbn")
    t0 = time.perf_counter()
    solver = DistributedECG.build(
        a, nshards=1, fmt="stencil", br=3, precond="bj2l", block_size=240,
        grid=(nel + 1, nel + 1, nel), opts=opts, dtype=np.float32, device=dev)
    build_s = time.perf_counter() - t0
    ops = solver.operands
    log(f"[main] built in {build_s:.2f} s, stages (s): "
        + json.dumps({k: round(v, 4) for k, v in solver.timings.items()})
        + f"; n_pad={solver.layout.n_pad} nrb={ops.nrb} S={len(ops.offsets)} "
        f"halo={ops.halo} nb={ops.inv_f.shape[0]} mb={ops.inv_f.shape[1]}")

    # --- 4. kernels vs plain versions on the card ---
    s_off = len(ops.offsets)
    head_t = StencilBsrTMatrix(ops.blocks_flat.view(s_off, 3, 3, ops.nrb),
                               ops.offsets, (3 * ops.nrb, 3 * ops.nrb))
    head_csr = stencil_csr(head_t.blocks_t, ops.offsets)
    log(f"[kernel] the headline operator as torch CSR: nnz={head_csr.values().numel()} "
        "(the torch.sparse.mm yardstick)")
    checks = [
        check_kernel("headline solver apply (br3,t12)", ops.blocks_flat,
                     ops.offsets, ops.halo, 3, 12, seed=1, csr=head_csr),
        check_kernel("refinement residual lo half (br3,t1)", ops.blocks_flat,
                     ops.offsets, ops.halo, 3, 1, seed=2),
        check_kernel("generic instantiation (br3,t4)", ops.blocks_flat,
                     ops.offsets, ops.halo, 3, 4, seed=3),
    ]
    pois = csr_to_stencil_bsr_t(poisson3d(40, 40, 40), br=1, dtype=np.float32,
                                device=dev)
    checks.append(check_kernel(
        "poisson3d 40³ (br1,t12)", stencil_blocks_flat(pois.blocks_t).contiguous(),
        pois.offsets, max(abs(o) for o in pois.offsets), 1, 12, seed=4))
    # the double-float residual product (plain PyTorch, once per round)
    x1 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 3, ops.nrb)).astype(np.float32)).to(dev)
    df_ms, _ = event_ms(lambda: ops.a_apply_df(x1), reps=2, batches=3, warm=1)
    log(f"[plain] stencil_scan_accumulate_df (br3,t1), the refinement "
        f"residual: {df_ms:.3f} ms")
    del pois
    # B3 (the sweep's stencil_t_pallas) and B4 (planar) on the same operator
    b3 = [check_lane(f"headline operator, B3 (br3,t{t})", head_t, t, seed=60 + t,
                     b3=True, csr=head_csr if t == 12 else None)
          for t in (12, 8, 1)]
    stencil_spmm_planar.launches = 0
    b4 = [check_planar("headline operator, B4 planar (br3,t12)", head_t.blocks_t,
                       ops.offsets, 12, seed=71, csr=head_csr)]
    b4_launches = stencil_spmm_planar.launches
    del head_csr, head_t

    # --- 5. the main path, through the user's entry points ---
    info, launches, warm_s = checked_solve(solver, a, b, "main", stencil_flat_ext)
    iters = int(info["iters"])
    log(f"[main] warm solve {warm_s:.3f} s: iters={iters} refine_rounds="
        f"{info.get('refine_rounds')} relres={info['relres']:.3e} breakdown="
        f"{info['breakdown']} stencil_flat_ext launches={launches}")
    if launches < iters:
        fail(f"kernel launched {launches} times for {iters} iterations")
    timed = timed_solves(solver, b, iters, "main")
    solve_s = statistics.median(timed)
    log(f"[main] timed solves (s): {[round(v, 4) for v in timed]}; median "
        f"{solve_s:.4f} s, {1e3 * solve_s / iters:.3f} ms/iteration "
        f"(iterations {iters}; the JAX package's record of this solve: "
        f"{TPU_ANCHOR_ITERS} iterations)")
    profile_solve(solver, b, "solve")
    x_main, _ = solver.solve(b)          # [sharded_nccl1] must reproduce it
    main_path = {
        "n": n, "nnz": int(a.nnz), "iters": iters,
        "refine_rounds": info.get("refine_rounds"), "relres": info["relres"],
        "solve_s": timed, "ms_per_iter": 1e3 * solve_s / iters,
        "build_s": build_s, "build_stages_s": solver.timings,
        "df_residual_ms": df_ms}
    del solver, ops, x1

    # --- 6. a small solve against a scipy direct solve ---
    a_s = elasticity3d(8, 8, 8, heterogeneous=False)
    b_s = np.random.default_rng(7).standard_normal(a_s.shape[0])
    small = DistributedECG.build(
        a_s, fmt="stencil", br=3, precond="bj2l", block_size=24,
        grid=(9, 9, 8), dtype=np.float32, device=dev,
        opts=ECGOptions(t=4, tol=1e-8, maxiter=3000, layout="tbn"))
    x_s, info_s = small.solve(b_s)
    x_ref = spla.spsolve(a_s.tocsc(), b_s)
    err_s = float(np.linalg.norm(x_s - x_ref) / np.linalg.norm(x_ref))
    rel_s = float(np.linalg.norm(b_s - a_s @ x_s) / np.linalg.norm(b_s))
    log(f"[small] elasticity3d(8³) f32+refinement on the card: "
        f"iters={info_s['iters']} relres={rel_s:.3e} "
        f"|x - x_direct|/|x_direct|={err_s:.3e}")
    if not (rel_s < 1e-8 and err_s < 1e-5):
        fail("small solve disagrees with the scipy direct solve")
    del small

    # --- 7. the general path's build at full size ---
    gopts = ECGOptions(t=12, tol=SOLVE_TOL, maxiter=3000, variant="odir_fused",
                       layout="nt")
    t0 = time.perf_counter()
    gsolver = DistributedECG.build(
        a, nshards=1, fmt="block_ell", precond="bj", block_size=240,
        opts=gopts, dtype=np.float32, device=dev)
    gbuild_s = time.perf_counter() - t0
    gops = gsolver.operands
    nrb, s_max, bm, bk = gops.mat.blocks.shape
    fill = int(a.nnz) / gops.mat.blocks.numel()
    log(f"[general] built in {gbuild_s:.2f} s, stages (s): "
        + json.dumps({k: round(v, 4) for k, v in gsolver.timings.items()})
        + f"; n_pad={gsolver.layout.n_pad} block-ELL nrb={nrb} S={s_max} "
        f"bm={bm} bk={bk} ({gops.mat.blocks.numel() * 4 / 1e9:.3f} GB, fill "
        f"{100 * fill:.1f} %), packed entries nnz={gops.mat.entries.nnz} "
        f"({8 * gops.mat.entries.nnz / 1e9:.3f} GB); block Jacobi nb={gops.bj.factors.shape[0]} "
        f"mb={gops.bj.factors.shape[1]} mode={gops.bj.mode}")

    # --- 8. B5 vs its plain version on the card ---
    b5_checks = [check_block_ell("general solver apply (bk128,t12)", gops.mat,
                                 12, seed=11),
                 check_block_ell("single vector (bk128,t1)", gops.mat, 1,
                                 seed=12)]
    bell8 = csr_to_block_ell(permute_and_pad_matrix(gsolver.a_scaled,
                                                    gsolver.layout),
                             bm=8, bk=8, dtype=np.float32, device=dev)
    b5_checks.append(check_block_ell("bk8 generic (bk8,t12)", bell8, 12,
                                     seed=13))
    del bell8

    # --- 9. the general path, through the user's entry points ---
    ginfo, glaunches, gwarm_s = checked_solve(gsolver, a, b, "general",
                                              block_ell_spmm_pallas)
    giters = int(ginfo["iters"])
    log(f"[general] warm solve {gwarm_s:.3f} s: iters={giters} refine_rounds="
        f"{ginfo['refine_rounds']} relres={ginfo['relres']:.3e} breakdown="
        f"{ginfo['breakdown']} block_ell_spmm_pallas launches={glaunches} "
        f"(JAX package on a CPU, fmt='block_ell_xla': {GENERAL_ANCHOR_ITERS} "
        "iterations)")
    if glaunches < giters:
        fail(f"block-ELL kernel launched {glaunches} times for {giters} iterations")
    if not within(giters, GENERAL_ANCHOR_ITERS):
        fail(f"general path ran {giters} iterations, outside "
             f"{GENERAL_ANCHOR_ITERS} ± {100 * ANCHOR_BAND:.0f} %")
    gtimed = timed_solves(gsolver, b, giters, "general")
    gsolve_s = statistics.median(gtimed)
    log(f"[general] timed solves (s): {[round(v, 4) for v in gtimed]}; median "
        f"{gsolve_s:.4f} s, {1e3 * gsolve_s / giters:.3f} ms/iteration")
    profile_solve(gsolver, b, "general")
    general_path = {
        "fmt": "block_ell", "nrb": nrb, "S": s_max, "bk": bk, "fill": fill,
        "iters": giters, "refine_rounds": ginfo["refine_rounds"],
        "relres": ginfo["relres"], "launches": glaunches, "solve_s": gtimed,
        "ms_per_iter": 1e3 * gsolve_s / giters, "build_s": gbuild_s,
        "build_stages_s": gsolver.timings, "anchor_iters": GENERAL_ANCHOR_ITERS}
    del gsolver, gops

    # --- 9a. the communication-avoiding kernel tier: spMSV, TSQR, CholQR,
    # tournament pivoting on the same operator, B5 its product ---
    lx_path, lx_launches = lx_phase(dev, a, smi)

    # --- 10. fmt="ell" through the device double-float rounds ---
    nel_e = 20
    a_e = elasticity3d(nel_e, nel_e, nel_e, heterogeneous=False)
    b_e = np.random.default_rng(0).standard_normal(a_e.shape[0])
    esolver = DistributedECG.build(a_e, nshards=1, fmt="ell", precond="bj",
                                   block_size=240, opts=gopts,
                                   dtype=np.float32, device=dev)
    einfo, _, ewarm_s = checked_solve(esolver, a_e, b_e, "ell")
    log(f"[ell] elasticity3d({nel_e}³) n={a_e.shape[0]} ELL width "
        f"{esolver.operands.mat.vals.shape[1]}: {ewarm_s:.3f} s, iters="
        f"{einfo['iters']} refine_rounds={einfo['refine_rounds']} (device "
        f"double-float rounds {einfo['device_rounds']}) relres="
        f"{einfo['relres']:.3e}")
    if einfo["device_rounds"] < 1:
        fail("[ell] no device double-float refinement round ran")
    ell_path = {"n": a_e.shape[0], "iters": einfo["iters"],
                "refine_rounds": einfo["refine_rounds"],
                "device_rounds": einfo["device_rounds"],
                "relres": einfo["relres"], "solve_s": ewarm_s}
    del esolver

    # --- 11. the stencil path with block Jacobi alone (bj_flat) ---
    t0 = time.perf_counter()
    bsolver = DistributedECG.build(
        a, nshards=1, fmt="stencil", br=3, precond="bj", block_size=240,
        grid=(nel + 1, nel + 1, nel), bj_dedupe=False, opts=opts,
        dtype=np.float32, device=dev)
    bbuild_s = time.perf_counter() - t0
    binfo, blaunches, bwarm_s = checked_solve(bsolver, a, b, "bj", stencil_flat_ext)
    biters = int(binfo["iters"])
    btimed = timed_solves(bsolver, b, biters, "bj")
    log(f"[bj] stencil + bj ({bsolver.operands.precond_kind}): built in "
        f"{bbuild_s:.2f} s; iters={biters} refine_rounds="
        f"{binfo['refine_rounds']} relres={binfo['relres']:.3e} "
        f"stencil_flat_ext launches={blaunches}; timed solves (s): "
        f"{[round(v, 4) for v in btimed]} (the JAX package's TPU record: "
        f"{BJ_ANCHOR_ITERS} iterations)")
    if blaunches < biters:
        fail(f"[bj] stencil kernel launched {blaunches} times for {biters} iterations")
    if not within(biters, BJ_ANCHOR_ITERS):
        fail(f"[bj] ran {biters} iterations, outside {BJ_ANCHOR_ITERS} ± "
             f"{100 * ANCHOR_BAND:.0f} %")
    bj_path = {"iters": biters, "refine_rounds": binfo["refine_rounds"],
               "relres": binfo["relres"], "solve_s": btimed,
               "build_s": bbuild_s, "anchor_iters": BJ_ANCHOR_ITERS}

    # --- 12. B6 vs its plain version and torch.bmm, on the bj inverses ---
    bj_apply_pallas.launches = 0
    b6 = [check_bj_apply(bsolver.operands.inv_f, 3, 12, seed=21)]
    del bsolver

    # --- 12a-12d. the general-matrix single-device API and its CLI ---
    api_paths = {"api_bj": api_bj_phase(dev, a, b), **api_schur_phases(dev),
                 "api_lanczos": api_lanczos_phase(dev),
                 "checkpoint": checkpoint_phase(dev)}

    # --- 13-15. the single-GPU LORASC path, with B2a and B2b, on the het
    # operator that phases 16-19 share ---
    t0 = time.perf_counter()
    a_het = elasticity3d(nel, nel, nel, heterogeneous=True)
    b_het = np.random.default_rng(0).standard_normal(a_het.shape[0])
    log(f"[lorasc] het elasticity3d({nel}³) n={a_het.shape[0]} nnz={a_het.nnz} "
        f"generated in {time.perf_counter() - t0:.2f} s")
    b2a, b2b, lorasc_path, la, lb = lorasc_phase(dev, a_het, b_het, nel)

    # --- 16-19. PRESC, SALOC and the bf16 stores, with B2a's bf16 instance ---
    b2a_bf16, b2b_bf16, presc_paths = presc_phases(dev, a_het, b_het,
                                                   lorasc_path["iters"], nel)
    # --- 19a. the same operator in f64 (the f64 deflation study's row) ---
    b2a_f64, b2b_f64, lorasc_f64_path = lorasc_f64_phase(dev, a_het, b_het, nel)
    del a_het, b_het

    # --- 20-22. fmt="dia", fmt="auto" and the SpMM format sweep ---
    b1_dia, b2b_dia, b6_dia, dia_path, dia_launches = dia_phase(dev, a, b)
    b6.append(b6_dia)
    b6_launches = bj_apply_pallas.launches
    auto_path = auto_phase(dev)
    spmm_recs, b3_launches = spmm_phase(dev, a)

    # --- 23-27. the rest of the one-GPU driver ---
    a1_paths = a1_phases(dev, a, b, nel, biters)

    # --- 28. the headline through a one-rank NCCL group ---
    nccl1, table, offsets, halo = sharded_nccl1_phase(dev, a, b, nel, x_main, iters)
    # --- 29. B1 at a [sharded4] shard's shape: rank 1's nodes ---
    nrb_loc = contiguous_row_layout(n, 4, row_multiple=240).rows_per_shard // 3
    shard_flat = table[:, nrb_loc:2 * nrb_loc].contiguous()
    shard_csr = stencil_csr_ext(shard_flat.view(len(offsets), 3, 3, nrb_loc),
                                offsets, halo)
    checks.append(check_kernel(f"[sharded4] shard apply (br3,t12,nrb {nrb_loc})",
                               shard_flat, offsets, halo, 3, 12, seed=81,
                               csr=shard_csr))
    del table, shard_flat, shard_csr
    # --- 30-31. over spawned ranks sharing the card through gloo ---
    sharded4 = sharded4_phase(nel, x_main, smi)
    dryrun = sharded_dryrun_phase()
    # --- 32-33. the distributed LORASC driver over 8 spawned ranks ---
    dlorasc = dlorasc_phase()
    # --- 34-36. the sharded driver's other formats over spawned ranks ---
    sharded_general4, b5_shard = sharded_full_phase(
        "sharded_general4", SHARDED_GENERAL4_ANCHOR_ITERS, nel)
    b5_checks += b5_shard
    sharded_dia4, b1_shard = sharded_full_phase(
        "sharded_dia4", SHARDED_DIA4_ANCHOR_ITERS, SHARDED_DIA4_NEL)
    checks += b1_shard
    sharded_formats = sharded_formats_phase()

    log("[summary] " + json.dumps({
        "checks": checks, "block_ell_checks": b5_checks, "bj_apply_checks": b6,
        "lane_checks": b2a + b2b, "lane_bf16_checks": b2a_bf16 + b2b_bf16,
        "lane_f64_checks": b2a_f64 + b2b_f64, "lorasc_f64_path": lorasc_f64_path,
        "b3_checks": b3, "b4_checks": b4,
        "dia_checks": b1_dia + b2b_dia, "main_path": main_path,
        "general_path": general_path, "lx": lx_path, "ell_path": ell_path,
        "bj_path": bj_path,
        "lorasc_path": lorasc_path, **presc_paths, "dia_path": dia_path,
        "auto_path": auto_path, "spmm_sweep": spmm_recs, **a1_paths,
        "sharded_nccl1": nccl1, "sharded4": sharded4, "sharded_dryrun": dryrun,
        **dlorasc, "sharded_general4": sharded_general4, "sharded_dia4": sharded_dia4,
        "sharded_formats": sharded_formats, "native": native_rec, **api_paths,
        "total_s": time.perf_counter() - t_start}))

    def entry(name, source, replaces, launches_, recs):
        """One kernel's record: times and yardsticks at its first shape
        (the path's) and at every shape checked, the largest error over
        them."""
        head = recs[0]
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda",
                "source": f"prealps_tpu_torch/csrc/{source}",
                "replaces": f"prealps_tpu/{replaces}", "launches": launches_,
                "max_abs_err": max(c["max_abs_err"] for c in recs),
                **{k: head[k] for k in keys},
                "shapes": [{"shape": c["shape"], **{k: c[k] for k in keys},
                            **{k: c[k] for k in ("blocks_dtype", "device_ms",
                                                 "format_bound_ms", "nnz")
                               if k in c}}
                           for c in recs]}

    b1 = entry("stencil_flat_ext", "stencil.cu", "ops/spmm.py:800", launches,
               checks + b1_dia)
    # B1's count on each path's own solve (counts zeroed before each)
    b1["path_launches"] = {"main": launches, "bj": blaunches, "dia": dia_launches,
                           **{k: (v["launches"] if "launches" in v else
                                  v["stacked"]["launches"] + v["unstacked"]["launches"])
                              for k, v in a1_paths.items()},
                           "sharded_nccl1": nccl1["launches"],
                           "sharded4": sharded4["launches"],
                           "sharded_dia4": sharded_dia4["launches"],
                           **{f"sharded_dryrun_{k}": v["launches"]
                              for k, v in dryrun.items() if "stencil" in k}}
    # B2a's and B2b's counts on each LORASC-family path's solve, of the
    # bf16-block instance on [lorasc_bf16]'s and of the f64 instance on
    # [lorasc_f64]'s
    lorasc_family = {"lorasc": lorasc_path, **presc_paths, "lorasc_f64": lorasc_f64_path}
    b2a_rec = entry("stencil_bsr_spmm_t_pallas_bs", "stencil.cu", "ops/spmm.py:511",
                    la, b2a + b2a_bf16 + b2a_f64)
    b2a_rec["path_launches"] = {k: v["b2a_launches"] for k, v in lorasc_family.items()
                                if "b2a_launches" in v}
    b2a_rec["bf16_launches"] = {"lorasc_bf16":
                                presc_paths["lorasc_bf16"]["b2a_bf16_launches"]}
    b2a_rec["f64_launches"] = {"lorasc_f64": lorasc_f64_path["b2a_f64_launches"]}
    b2b_rec = entry("stencil_pallas_bs_ext", "stencil.cu", "ops/spmm.py:695", lb,
                    b2b + b2b_bf16 + b2b_dia + b2b_f64)
    b2b_rec["path_launches"] = {k: v["b2b_launches"] for k, v in lorasc_family.items()
                                if "b2b_launches" in v}
    # B5's count on each path's solve: [general]'s, and each sharded rank's
    b5 = entry("block_ell_spmm_pallas", "block_ell.cu", "ops/spmm.py:97", glaunches,
               b5_checks)
    b5["path_launches"] = {"general": glaunches, "lx": lx_launches,
                           "sharded_general4": sharded_general4["launches"]}
    kernels = {"kernels": [
        b1,
        b5,
        entry("bj_apply_pallas", "bj_apply.cu", "direct/device_bj.py:165",
              b6_launches, b6),
        b2a_rec,
        b2b_rec,
        entry("stencil_bsr_spmm_t_pallas", "stencil.cu", "ops/spmm.py:417",
              b3_launches, b3),
        entry("stencil_spmm_planar", "stencil.cu", "ops/spmm.py:619", b4_launches,
              b4),
    ]}
    log(card_line())
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
