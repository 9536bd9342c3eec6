// Stencil-BSR SpMM for Hopper (sm_90a), every layout of the repository's
// stencil kernels in one body, bound to Python through ctypes.
//
// Replaces the TPU kernels of prealps_tpu/ops/spmm.py that compute
//
//   y = sum_s B_s o shift(x, off_s)      (S constant node offsets)
//
// over a stencil-BSR operator, each in its own layout:
//
//   B1 stencil_flat_ext (:800, body :772)   flat k-major panel, pre-extended
//   B2a stencil_bsr_spmm_t_pallas_bs (:511) lane-major panel, wrap halos
//   B2b stencil_pallas_bs_ext (:695)        lane-major panel, pre-extended
//   B3 stencil_bsr_spmm_t_pallas (:417)     lane-major panel, wrap halos
//   B4 stencil_spmm_planar (:619)           planar panel, plane-major blocks
//
// One body, templated on three index maps:
//
//   panel row   KMAJOR: row k*t + j of a (br*t, ncol) panel (B1);
//               else lane-major: row j*br + k of (t, br, ncol) (B2a, B2b,
//               B3, and B4, whose planar (t, br*nrb) panel has the same
//               memory as (t, br, nrb));
//   column      WRAP: (r + off) mod nrb of an unextended panel, ncol = nrb
//               (B2a, B3, B4 -- the TPU kernels' read of their wrap-extended
//               panels at r + halo + off); else r + lead + off of a panel
//               extended by the caller, ncol >= nrb + 2*lead (B1, B2b);
//   block row   PLANAR: (m*S + s)*br + k of B4's plane-major (br, S*br, nrb)
//               table; else (s*br + m)*br + k of (S, br, br, nrb), whose
//               memory equals B1's flat (S*br*br, nrb).
//
// The output y has the panel's row map over nrb columns. Four combinations
// are built, the ones the layouts above use, with f32 blocks; the two
// lane-major s-major ones (B2a / B3, B2b) also with bf16 blocks and in f64
// (below).
//
// What bounds it: bytes. At the headline operator (S = 27, br = 3, t = 12,
// nrb = 49,360) one call must read the block table once (48.0 MB) and the
// panel (7.1 MB) and write y (7.1 MB): 62.2 MB -> 18.6 us at 3.35 TB/s, for
// 2*S*br*br*t*nrb = 11.5 MFLOP, far below the card's balance point. The
// DIA form (br = 1, D = 97, t = 12, nrb = 148,480): 71.9 MB -> 21.5 us.
//
// The first cut ran one thread per node with all br*t sums in registers
// and read its block entries and panel values straight from memory, one
// offset after the other; it reached 28-32 % of the bound at t = 12, and its
// t-tiled form (one thread per (node, row m, 8 columns), the column tiles
// on grid.y) 4-16 %. Nsight Compute does not run on the machine that has
// the card, so no counter was read; variants timed side by side on the card
// against the first cut (CUDA events, bitwise-equal outputs; PERF.md §6
// quotes every reading) located the loss instead. At the headline, t = 12,
// where the first cut took 0.057 ms:
//  - more warps did not help: a thread per (node, 4 columns), 3x the warps
//    (with the ring below), 0.063-0.067 ms;
//  - streaming the block table through a cp.async shared-memory ring (2-6
//    stages, 32-128 nodes a CTA) did not either: 0.058 ms at best;
//  - nor did the panel re-read per offset: staging each run of consecutive
//    offsets' panel window once a tile in shared memory (cp.async), which
//    by count reads a panel value from L2 once a run (3 offsets at the
//    headline) instead of once an offset, took 0.091 ms at best;
//  - the offset loop did: each warp waited a memory latency per offset,
//    since offset s + 1's loads were issued only after offset s's FMAs.
//    Loading offset s + 1's block entries and panel values into registers
//    while offset s is summed took 0.033 ms, past half the bound, with no
//    change of occupancy (one wave of 386 CTAs: registers are free);
//  - the t-tiled form re-read the block table from device memory once per
//    column tile; chunks of a tile in consecutive CTAs read it from L2.
//
// Design: one body. A thread owns one node and a chunk of JG panel columns
// and keeps the chunk's br*JG sums in registers; it loads the block entries
// and panel values of the next D offsets into registers (D = 1 to 3 by
// width) while summing the current ones. The widths the paths use (1, 4,
// 8, 12, 16) are whole-width instances with the width a compile-time constant
// (their address arithmetic folds; with a runtime width the same loop ran
// markedly slower at t = 12); other widths run in chunks of 8 columns, the
// chunks of one tile in consecutive CTAs. At t = 1 the plain loop (D = 0)
// is kept: the table is most of the bytes there, it already runs at 65-80 %
// of the bound, and a prefetch made it slower. Deeper prefetch did not help
// the br = 1 form at t = 12 (97 offsets of 12 loads and 12 FMAs each): it
// stays near 40 % of its bound. Up to MAX_OFFSETS offsets (csr_to_dia_ell's
// max_diags) travel by value in the kernel's parameter space (2 KB of the
// constant bank), read uniformly by every thread.
//
// Accumulation is f32 with fmaf, each output's sum in one thread in the
// order s, then k, like the first cut and the TPU kernels, so the results
// are bitwise the first cut's and every path's iteration count is
// unchanged; no tensor cores (f32 parity rules out TF32). A br other than 1
// or 3 (no path of the repository has one) takes the generic kernel below:
// one thread per (node, output row m, 8 columns).
//
// Block element type. The TPU kernels take bf16 blocks too: the lane-major
// body promotes them (spmm.py:482-507, B2a and B2b), the flat body widens
// them (:786-790, B1). Here the block type TB is a template parameter of
// the body: float, or __nv_bfloat16, whose entries are loaded as 2-byte
// words (coalesced along nrb), kept in registers through the prefetch and
// widened to f32 where they are used (__bfloat162float, exact). The panel,
// the sums and y stay f32 in the same fmaf order, so a bf16 instance's
// output is bitwise the f32 instance's on the widened blocks. bf16 is
// instantiated for the lane-major maps (wrap and pre-extended), the ones a
// path runs: LORASC's a_store="bf16" sweeps and a_store="bf16_all"'s
// iteration operator. At the het LORASC operator (nrb = 49,284, S = 27,
// br = 3) the bf16 table halves the block bytes: t = 12 needs 38.1 MB
// (11.4 us at 3.35 TB/s) against the f32 instance's 62.1 MB (18.5 us).
//
// Value type. The JAX package runs the lane-major product in f64 too (its
// f64 tests and its f64 deflation study take the XLA route,
// stencil_bsr_spmm_t). The value type TV of the panel, the sums and y is a
// template parameter of the body beside TB: float (the f32 and bf16
// instances above, unchanged), or double with double blocks, whose sums are
// fma in the same order (s, then k, one thread an output). f64 is
// instantiated for the lane-major maps (wrap and pre-extended): the f64
// StencilLorascECG runs B2a, and B2b's f64 instance runs a halo-overlap
// shard product. An f64 entry is twice the bytes and registers of an f32
// one; this first f64 instance keeps the plain loop (no prefetch) at every
// width but t = 4, where one offset ahead fits: ptxas reports no spill at
// br = 3 (128 registers at t = 12, 168 at t = 16). Whether a prefetch pays
// in f64 is untried. At the het operator (nrb = 49,284, S = 27, br = 3)
// t = 12 needs 124.2 MB: 37.1 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#define PREALPS_STENCIL_MAX_OFFSETS 512
#define TT 8

struct StencilOffsets {
  int v[PREALPS_STENCIL_MAX_OFFSETS];
};

template <bool WRAP>
__device__ __forceinline__ int col_of(int r, int off, int nrb, int lead) {
  if (WRAP) {
    int c = r + off;
    c += c < 0 ? nrb : 0;
    c -= c >= nrb ? nrb : 0;
    return c;
  }
  return r + lead + off;
}

template <bool KMAJOR>
__device__ __forceinline__ size_t row_of(int j, int k, int br, int t) {
  return KMAJOR ? (size_t)k * t + j : (size_t)j * br + k;
}

// One block entry, as stored (the prefetch keeps it in this type) ...
__device__ __forceinline__ float load_blk(const float* p) { return __ldg(p); }
__device__ __forceinline__ double load_blk(const double* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 load_blk(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
// ... and widened to f32 where it is used (exact for bf16).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// b * x + acc, one rounding, in the value type
__device__ __forceinline__ float fma_v(float b, float x, float acc) {
  return fmaf(b, x, acc);
}
__device__ __forceinline__ double fma_v(double b, double x, double acc) {
  return fma(b, x, acc);
}

template <bool PLANAR>
__device__ __forceinline__ size_t blk_of(int s, int m, int k, int br,
                                         int n_off) {
  return PLANAR ? ((size_t)m * n_off + s) * br + k
                : ((size_t)s * br + m) * br + k;
}

// The one body. A thread owns one node and a chunk of JG panel columns
// (blockIdx.x = tile * nchunks + chunk, 128 nodes a tile; WHOLE: JG = t, one
// chunk, the width a compile-time constant) and keeps the chunk's br*JG
// sums in registers. With D > 0 the block entries and panel values of the
// next D offsets are loaded into registers while the current D are summed
// (the loop is unrolled by two, so the two register sets alternate without
// copies); with D = 0 each offset's values are loaded as it is summed.
template <typename TB, typename TV, int BR, int JG, int D, bool WHOLE,
          bool KMAJOR, bool WRAP, bool PLANAR>
__global__ void __launch_bounds__(128)
stencil_pipe(const TB* __restrict__ blocks, const TV* __restrict__ x,
             TV* __restrict__ y, const StencilOffsets offs, int n_off,
             int t_run, int nrb, int ncol, int lead, int nchunks) {
  constexpr int BB = BR * BR;
  constexpr int NX = BR * JG;
  const int t = WHOLE ? JG : t_run;
  const int tile = WHOLE ? blockIdx.x : blockIdx.x / nchunks;
  const int chunk = WHOLE ? 0 : blockIdx.x - tile * nchunks;
  const int r = tile * blockDim.x + threadIdx.x;
  if (r >= nrb) return;
  const int j0 = chunk * JG;
  const int nj = WHOLE ? JG : min(JG, t - j0);
  TV acc[NX];  // acc[m*JG + jj]
#pragma unroll
  for (int i = 0; i < NX; ++i) acc[i] = TV(0);

  auto load = [&](int s, TB (&b)[BB], TV (&xv)[NX]) {
    const size_t col = (size_t)col_of<WRAP>(r, offs.v[s], nrb, lead);
#pragma unroll
    for (int m = 0; m < BR; ++m)
#pragma unroll
      for (int k = 0; k < BR; ++k)
        b[m * BR + k] = load_blk(blocks + blk_of<PLANAR>(s, m, k, BR, n_off) * nrb + r);
#pragma unroll
    for (int k = 0; k < BR; ++k)
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
        xv[k * JG + jj] =
            jj < nj ? __ldg(x + row_of<KMAJOR>(j0 + jj, k, BR, t) * ncol + col)
                    : TV(0);
  };
  auto sum = [&](const TB (&b)[BB], const TV (&xv)[NX]) {
#pragma unroll
    for (int k = 0; k < BR; ++k)
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int m = 0; m < BR; ++m)
          acc[m * JG + jj] =
              fma_v(widen(b[m * BR + k]), xv[k * JG + jj], acc[m * JG + jj]);
  };

  if constexpr (D == 0) {
    for (int s = 0; s < n_off; ++s) {
      TB b[BB];
      TV xv[NX];
      load(s, b, xv);
      sum(b, xv);
    }
  } else {
    TB bc[D][BB];
    TV xc[D][NX];
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (d < n_off) load(d, bc[d], xc[d]);
#pragma unroll 2
    for (int s0 = 0; s0 < n_off; s0 += D) {
      TB bn[D][BB];
      TV xn[D][NX];
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (s0 + D + d < n_off) load(s0 + D + d, bn[d], xn[d]);
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (s0 + d < n_off) sum(bc[d], xc[d]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
#pragma unroll
        for (int i = 0; i < BB; ++i) bc[d][i] = bn[d][i];
#pragma unroll
        for (int i = 0; i < NX; ++i) xc[d][i] = xn[d][i];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < BR; ++m)
#pragma unroll
    for (int jj = 0; jj < JG; ++jj)
      if (jj < nj) y[row_of<KMAJOR>(j0 + jj, m, BR, t) * nrb + r] = acc[m * JG + jj];
}

// Any br: blockIdx.y = tile * br + m; the thread sums output row m of
// panel columns [tile*TT, tile*TT + TT) ∩ [0, t).
template <typename TB, typename TV, bool KMAJOR, bool WRAP, bool PLANAR>
__global__ void __launch_bounds__(128)
stencil_any_br(const TB* __restrict__ blocks, const TV* __restrict__ x,
               TV* __restrict__ y, const StencilOffsets offs, int n_off,
               int br, int t, int nrb, int ncol, int lead) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrb) return;
  const int m = blockIdx.y % br;
  const int j0 = (blockIdx.y / br) * TT;
  const int nj = min(TT, t - j0);
  TV acc[TT];
#pragma unroll
  for (int jj = 0; jj < TT; ++jj) acc[jj] = TV(0);
  for (int s = 0; s < n_off; ++s) {
    const size_t col = (size_t)col_of<WRAP>(r, offs.v[s], nrb, lead);
    for (int k = 0; k < br; ++k) {
      const TV bv =
          widen(load_blk(blocks + blk_of<PLANAR>(s, m, k, br, n_off) * nrb + r));
#pragma unroll
      for (int jj = 0; jj < TT; ++jj)
        if (jj < nj)
          acc[jj] = fma_v(
              bv, __ldg(x + row_of<KMAJOR>(j0 + jj, k, br, t) * ncol + col),
              acc[jj]);
    }
  }
#pragma unroll
  for (int jj = 0; jj < TT; ++jj)
    if (jj < nj) y[row_of<KMAJOR>(j0 + jj, m, br, t) * nrb + r] = acc[jj];
}

template <typename TB, typename TV, int BR, int JG, int D, bool WHOLE,
          bool KMAJOR, bool WRAP, bool PLANAR>
static cudaError_t launch_pipe(const TB* blocks, const TV* x, TV* y,
                               const StencilOffsets& offs, int n_off, int t,
                               int nrb, int ncol, int lead, cudaStream_t st) {
  const int nchunks = (t + JG - 1) / JG;
  const long long ntiles = (nrb + 127) / 128;
  if (ntiles * nchunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  stencil_pipe<TB, TV, BR, JG, D, WHOLE, KMAJOR, WRAP, PLANAR>
      <<<dim3((unsigned)(ntiles * nchunks)), 128, 0, st>>>(
          blocks, x, y, offs, n_off, t, nrb, ncol, lead, nchunks);
  return cudaSuccess;
}

// The widths the repository's paths use (1, 4, 8, 12, 16) are whole-width
// instances: no prefetch at t = 1 (the table is most of the bytes and the
// plain loop runs at 65-80 % of the bound), three offsets ahead at t = 4,
// two at t = 8, one at t = 12 and 16 (the depths that timed fastest).
// Other widths (the LORASC build's nev and lift width) take chunks of 8
// columns, one offset ahead; any other br stencil_any_br. The f64 instance
// (TV double) has the same widths with no prefetch but one offset ahead at
// t = 4, its chunks of 8 columns with none (see the note on the value type).
template <typename TB, typename TV, bool KMAJOR, bool WRAP, bool PLANAR>
static cudaError_t launch(const TB* blocks, const TV* x, TV* y,
                          const StencilOffsets& offs, int n_off, int br, int t,
                          int nrb, int ncol, int lead, cudaStream_t st) {
#define PREALPS_PIPE(BR_, JG_, D_, WHOLE_)                                 \
  return launch_pipe<TB, TV, BR_, JG_, D_, WHOLE_, KMAJOR, WRAP, PLANAR>(  \
      blocks, x, y, offs, n_off, t, nrb, ncol, lead, st)
#define PREALPS_WIDTHS(BR_)                        \
  switch (t) {                                     \
    case 1: PREALPS_PIPE(BR_, 1, 0, true);         \
    case 4: PREALPS_PIPE(BR_, 4, 3, true);         \
    case 8: PREALPS_PIPE(BR_, 8, 2, true);         \
    case 12: PREALPS_PIPE(BR_, 12, 1, true);       \
    case 16: PREALPS_PIPE(BR_, 16, 1, true);       \
    default: PREALPS_PIPE(BR_, 8, 1, false);       \
  }
#define PREALPS_WIDTHS_F64(BR_)                    \
  switch (t) {                                     \
    case 1: PREALPS_PIPE(BR_, 1, 0, true);         \
    case 4: PREALPS_PIPE(BR_, 4, 1, true);         \
    case 8: PREALPS_PIPE(BR_, 8, 0, true);         \
    case 12: PREALPS_PIPE(BR_, 12, 0, true);       \
    case 16: PREALPS_PIPE(BR_, 16, 0, true);       \
    default: PREALPS_PIPE(BR_, 8, 0, false);       \
  }
  if constexpr (sizeof(TV) == 8) {
    if (br == 3) PREALPS_WIDTHS_F64(3);
    if (br == 1) PREALPS_WIDTHS_F64(1);
  } else {
    if (br == 3) PREALPS_WIDTHS(3);
    if (br == 1) PREALPS_WIDTHS(1);
  }
#undef PREALPS_WIDTHS_F64
#undef PREALPS_WIDTHS
#undef PREALPS_PIPE
  if ((long long)br * ((t + TT - 1) / TT) > 65535) return cudaErrorInvalidValue;
  const dim3 grid((nrb + 127) / 128, br * ((t + TT - 1) / TT));
  stencil_any_br<TB, TV, KMAJOR, WRAP, PLANAR><<<grid, 128, 0, st>>>(
      blocks, x, y, offs, n_off, br, t, nrb, ncol, lead);
  return cudaSuccess;
}

// The lane-major maps, wrap (B2a / B3) or pre-extended (B2b).
template <typename TB, typename TV>
static cudaError_t launch_lane(const void* blocks, const void* x, void* y,
                               const StencilOffsets& offs, int n_off, int br,
                               int t, int nrb, int ncol, int lead, int wrap,
                               cudaStream_t st) {
  const TB* b = static_cast<const TB*>(blocks);
  const TV* xv = static_cast<const TV*>(x);
  TV* yv = static_cast<TV*>(y);
  if (wrap)
    return launch<TB, TV, false, true, false>(b, xv, yv, offs, n_off, br, t,
                                              nrb, ncol, lead, st);
  return launch<TB, TV, false, false, false>(b, xv, yv, offs, n_off, br, t,
                                             nrb, ncol, lead, st);
}

extern "C" {

// The one entry point of every stencil layout.
//   blocks_dtype: 0 for float blocks, 1 for bf16 blocks, the panel and y
//           float; 2 for double blocks, the panel and y double; 1 and 2 on
//           the lane-major maps only (not kmajor, not planar);
//   kmajor: the panel is (br*t, ncol) with row k*t + j (else (t, br, ncol),
//           row j*br + k); y has the same row map over nrb columns;
//   wrap:   columns wrap mod nrb (ncol = nrb, lead = 0); else the panel
//           carries `lead` halo columns on each side (ncol >= nrb + 2*lead);
//   planar: blocks are (br, S*br, nrb) plane-major (else (S, br, br, nrb)).
// Launches on `stream` (a cudaStream_t passed as void*) of card `device`
// and returns cudaGetLastError() of the launch; does not synchronise or
// allocate. The library links its own CUDA runtime, so the card is set here
// rather than inherited from the caller's runtime.
int prealps_stencil(const void* blocks, int blocks_dtype, const void* x,
                    void* y, const int* offsets_host, int n_off, int br, int t,
                    int nrb, int ncol, int lead, int kmajor, int wrap,
                    int planar, int device, void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_off < 1 || n_off > PREALPS_STENCIL_MAX_OFFSETS || br < 1 || t < 1 ||
      nrb < 1 || lead < 0 || ncol < nrb + 2 * lead ||
      (wrap && (lead != 0 || ncol != nrb)) || (kmajor && (wrap || planar)) ||
      (planar && !wrap) || blocks_dtype < 0 || blocks_dtype > 2 ||
      (blocks_dtype != 0 && (kmajor || planar)))
    return (int)cudaErrorInvalidValue;
  StencilOffsets offs;
  for (int i = 0; i < PREALPS_STENCIL_MAX_OFFSETS; ++i)
    offs.v[i] = i < n_off ? offsets_host[i] : 0;
  // the wrap map folds an offset once (|off| <= nrb); the extended map
  // reads r + lead + off, so there |off| <= lead is all it needs (a shard
  // thinner than the stencil halo has offsets wider than its nodes)
  for (int i = 0; i < n_off; ++i)
    if ((wrap && (offs.v[i] < -nrb || offs.v[i] > nrb)) ||
        (!wrap && (offs.v[i] < -lead || offs.v[i] > lead)))
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // the maps the repository's layouts use: B1 (k-major, extended), B4
  // (lane-major, wrap, plane-major), B2a / B3 and B2b (lane-major, s-major),
  // the last two also with bf16 blocks and in f64
  cudaError_t e;
  if (blocks_dtype == 1)
    e = launch_lane<__nv_bfloat16, float>(blocks, x, y, offs, n_off, br, t, nrb,
                                          ncol, lead, wrap, st);
  else if (blocks_dtype == 2)
    e = launch_lane<double, double>(blocks, x, y, offs, n_off, br, t, nrb, ncol,
                                    lead, wrap, st);
  else if (kmajor)
    e = launch<float, float, true, false, false>(
        static_cast<const float*>(blocks), static_cast<const float*>(x),
        static_cast<float*>(y), offs, n_off, br, t, nrb, ncol, lead, st);
  else if (planar)
    e = launch<float, float, false, true, true>(
        static_cast<const float*>(blocks), static_cast<const float*>(x),
        static_cast<float*>(y), offs, n_off, br, t, nrb, ncol, lead, st);
  else
    e = launch_lane<float, float>(blocks, x, y, offs, n_off, br, t, nrb, ncol,
                                  lead, wrap, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The largest offset count the entry point takes.
int prealps_stencil_max_offsets(void) { return PREALPS_STENCIL_MAX_OFFSETS; }

const char* prealps_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
