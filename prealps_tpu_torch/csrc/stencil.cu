// Stencil-BSR SpMM for Hopper (sm_90a), every layout of the repository's
// stencil kernels in one body, bound to Python through ctypes.
//
// Replaces the four TPU kernels of prealps_tpu/ops/spmm.py that compute
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
// are built, the ones the layouts above use.
//
// What bounds it: bytes. At the headline operator (S = 27, br = 3, t = 12,
// nrb = 49,360) one call must read the block table once (48.0 MB) and the
// panel (7.1-7.5 MB) and write y (7.1 MB): ~62 MB for 2*S*br*br*t*nrb =
// 11.5 MFLOP, ~0.18 FLOP/byte, far below the card's balance point. The DIA
// form of the same operator (br = 1, D = 99 diagonals, n = 148,480) reads a
// 58.8 MB table.
//
// Design: one thread per node r. It walks the offsets, loads its block
// entries (consecutive threads read consecutive r: coalesced, each block
// byte read once) and keeps its sums in registers; its x reads are
// coalesced across the warp too, and the panel, re-read once per offset,
// stays in the 50 MB L2. The main path's shapes (br 3 x t 1 / 8 / 12, br 1 x
// t 1 / 12) are templates that hold all br*t sums in registers; every other
// shape takes the tiled kernel: one thread per (node, output row m, tile of
// TT panel columns), the tiles on the grid's y dimension, so the registers
// per thread stay bounded at any t. The TPU kernels' chunk grids, shifted
// BlockSpec views and double-buffered DMAs have no counterpart: a thread
// computes its own column. Up to MAX_OFFSETS offsets (csr_to_dia_ell's
// max_diags) travel by value in the kernel's parameter space (2 KB of the
// constant bank), read uniformly by every thread. Accumulation is f32 with
// FMA, in the order s, then k, like the TPU kernels; no tensor cores (f32
// parity rules out TF32).

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

template <bool PLANAR>
__device__ __forceinline__ size_t blk_of(int s, int m, int k, int br,
                                         int n_off) {
  return PLANAR ? ((size_t)m * n_off + s) * br + k
                : ((size_t)s * br + m) * br + k;
}

template <int BR, int T, bool KMAJOR, bool WRAP, bool PLANAR>
__global__ void __launch_bounds__(128)
stencil_fixed(const float* __restrict__ blocks, const float* __restrict__ x,
              float* __restrict__ y, const StencilOffsets offs, int n_off,
              int nrb, int ncol, int lead) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrb) return;
  float acc[BR * T];  // acc[m*T + j]
#pragma unroll
  for (int i = 0; i < BR * T; ++i) acc[i] = 0.0f;
  for (int s = 0; s < n_off; ++s) {
    const size_t col = (size_t)col_of<WRAP>(r, offs.v[s], nrb, lead);
    float b[BR * BR];
#pragma unroll
    for (int m = 0; m < BR; ++m)
#pragma unroll
      for (int k = 0; k < BR; ++k)
        b[m * BR + k] = __ldg(
            blocks + blk_of<PLANAR>(s, m, k, BR, n_off) * nrb + r);
#pragma unroll
    for (int k = 0; k < BR; ++k) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const float xv = __ldg(x + row_of<KMAJOR>(j, k, BR, T) * ncol + col);
#pragma unroll
        for (int m = 0; m < BR; ++m)
          acc[m * T + j] = fmaf(b[m * BR + k], xv, acc[m * T + j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < BR; ++m)
#pragma unroll
    for (int j = 0; j < T; ++j)
      y[row_of<KMAJOR>(j, m, BR, T) * nrb + r] = acc[m * T + j];
}

// Any (br, t): blockIdx.y = tile * br + m; the thread sums output row m of
// panel columns [tile*TT, tile*TT + TT) ∩ [0, t).
template <bool KMAJOR, bool WRAP, bool PLANAR>
__global__ void __launch_bounds__(128)
stencil_tiled(const float* __restrict__ blocks, const float* __restrict__ x,
              float* __restrict__ y, const StencilOffsets offs, int n_off,
              int br, int t, int nrb, int ncol, int lead) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrb) return;
  const int m = blockIdx.y % br;
  const int j0 = (blockIdx.y / br) * TT;
  const int nj = min(TT, t - j0);
  float acc[TT];
#pragma unroll
  for (int jj = 0; jj < TT; ++jj) acc[jj] = 0.0f;
  for (int s = 0; s < n_off; ++s) {
    const size_t col = (size_t)col_of<WRAP>(r, offs.v[s], nrb, lead);
    for (int k = 0; k < br; ++k) {
      const float bv =
          __ldg(blocks + blk_of<PLANAR>(s, m, k, br, n_off) * nrb + r);
#pragma unroll
      for (int jj = 0; jj < TT; ++jj)
        if (jj < nj)
          acc[jj] = fmaf(
              bv, __ldg(x + row_of<KMAJOR>(j0 + jj, k, br, t) * ncol + col),
              acc[jj]);
    }
  }
#pragma unroll
  for (int jj = 0; jj < TT; ++jj)
    if (jj < nj) y[row_of<KMAJOR>(j0 + jj, m, br, t) * nrb + r] = acc[jj];
}

template <bool KMAJOR, bool WRAP, bool PLANAR>
static void launch(const float* blocks, const float* x, float* y,
                   const StencilOffsets& offs, int n_off, int br, int t,
                   int nrb, int ncol, int lead, cudaStream_t st) {
  const dim3 block(128);
  dim3 grid((nrb + 127) / 128);
#define PREALPS_FIXED(BR_, T_)                                             \
  stencil_fixed<BR_, T_, KMAJOR, WRAP, PLANAR><<<grid, block, 0, st>>>( \
      blocks, x, y, offs, n_off, nrb, ncol, lead)
  if (br == 3 && t == 12) {
    PREALPS_FIXED(3, 12);
  } else if (br == 3 && t == 8) {
    PREALPS_FIXED(3, 8);
  } else if (br == 3 && t == 1) {
    PREALPS_FIXED(3, 1);
  } else if (br == 1 && t == 12) {
    PREALPS_FIXED(1, 12);
  } else if (br == 1 && t == 1) {
    PREALPS_FIXED(1, 1);
  } else {
    grid.y = br * ((t + TT - 1) / TT);
    stencil_tiled<KMAJOR, WRAP, PLANAR><<<grid, block, 0, st>>>(
        blocks, x, y, offs, n_off, br, t, nrb, ncol, lead);
  }
#undef PREALPS_FIXED
}

extern "C" {

// The one entry point of every stencil layout.
//   kmajor: the panel is (br*t, ncol) with row k*t + j (else (t, br, ncol),
//           row j*br + k); y has the same row map over nrb columns;
//   wrap:   columns wrap mod nrb (ncol = nrb, lead = 0); else the panel
//           carries `lead` halo columns on each side (ncol >= nrb + 2*lead);
//   planar: blocks are (br, S*br, nrb) plane-major (else (S, br, br, nrb)).
// Launches on `stream` (a cudaStream_t passed as void*) of card `device`
// and returns cudaGetLastError() of the launch; does not synchronise or
// allocate. The library links its own CUDA runtime, so the card is set here
// rather than inherited from the caller's runtime.
int prealps_stencil_f32(const float* blocks, const float* x, float* y,
                        const int* offsets_host, int n_off, int br, int t,
                        int nrb, int ncol, int lead, int kmajor, int wrap,
                        int planar, int device, void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_off < 1 || n_off > PREALPS_STENCIL_MAX_OFFSETS || br < 1 || t < 1 ||
      nrb < 1 || lead < 0 || ncol < nrb + 2 * lead ||
      (wrap && (lead != 0 || ncol != nrb)) || (kmajor && (wrap || planar)) ||
      (planar && !wrap) || (long long)br * ((t + TT - 1) / TT) > 65535)
    return (int)cudaErrorInvalidValue;
  StencilOffsets offs;
  for (int i = 0; i < PREALPS_STENCIL_MAX_OFFSETS; ++i)
    offs.v[i] = i < n_off ? offsets_host[i] : 0;
  for (int i = 0; i < n_off; ++i)
    if (offs.v[i] < -nrb || offs.v[i] > nrb ||
        (!wrap && (offs.v[i] < -lead || offs.v[i] > lead)))
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // the maps the repository's layouts use: B1 (k-major, extended), B4
  // (lane-major, wrap, plane-major), B2a / B3 and B2b (lane-major, s-major)
  if (kmajor) {
    launch<true, false, false>(blocks, x, y, offs, n_off, br, t, nrb, ncol,
                               lead, st);
  } else if (planar) {
    launch<false, true, true>(blocks, x, y, offs, n_off, br, t, nrb, ncol,
                              lead, st);
  } else {
    if (wrap)
      launch<false, true, false>(blocks, x, y, offs, n_off, br, t, nrb, ncol,
                                 lead, st);
    else
      launch<false, false, false>(blocks, x, y, offs, n_off, br, t, nrb,
                                  ncol, lead, st);
  }
  return (int)cudaGetLastError();
}

// The largest offset count the entry point takes.
int prealps_stencil_max_offsets(void) { return PREALPS_STENCIL_MAX_OFFSETS; }

const char* prealps_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
