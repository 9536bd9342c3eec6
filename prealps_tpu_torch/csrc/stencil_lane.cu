// Lane-major stencil-BSR SpMM for Hopper (sm_90a), bound to Python through
// ctypes.
//
// Replaces the two TPU entry points that share the kernel body
// _stencil_bs_kernel in prealps_tpu/ops/spmm.py:482-507, and computes what
// they compute:
//
//   y[j, m, r] = sum_s sum_k B[s, m, k, r] * x[j, k, idx(r, off_s)]
//
//   stencil_bsr_spmm_t_pallas_bs (spmm.py:511), x (t, br, nrb), wrap halos
//   taken inside:  idx = (r + off) mod nrb   (every |off| <= nrb)
//   stencil_pallas_bs_ext (spmm.py:695), x_ext (t, br, nrb + 2*halo) with
//   halos attached by the caller:  idx = r + halo + off
//
// blocks B: (S, br, br, nrb) f32, node axis minor; y: (t, br, nrb) f32.
// The wrapped index equals the TPU kernel's read of its wrap-extended panel
// x_ext = [x[nrb-h:], x, x[:h]] at r + h + off.
//
// What bounds it: bytes. At the LORASC solve's operator (S = 27, br = 3,
// nrb = 49,360, t = 12) one call must read the block table once (48.0 MB)
// and the panel (7.1 MB) and write y (7.1 MB): 62.2 MB for 2*S*br*br*t*nrb
// = 5.8 MFLOP, ~0.09 FLOP/byte, far below the card's balance point.
//
// Design: B1's (csrc/stencil_flat.cu) with the lane-major strides. One
// thread per node r walks the S offsets, loads its br*br block entries
// (consecutive threads read consecutive r: coalesced, each block byte read
// once) and keeps its accumulators in registers; its x reads are coalesced
// across the warp too, and the panel, re-read once per offset, stays in the
// 50 MB L2. The TPU's three shifted BlockSpec views and its chunk grid have
// no counterpart: a thread computes its own (wrapped) column. Offsets
// travel by value in the kernel's parameter space. Accumulation is f32
// with FMA, in the order s, then k, like the TPU kernel; no tensor cores.
//
// Shapes: the LORASC path runs t = 12 (ECG iteration and preconditioner
// sweeps), 8 (block Lanczos panels) and 1 (refinement finish) at br = 3 --
// those are templates holding all br*t sums in registers. Every other shape
// (the build's wide panels at t = k deflated pairs and t = nev, br = 1
// operators) takes the tiled kernel: one thread per (node, output row m,
// tile of LANE_TT panel columns), the tiles on the grid's y dimension, so
// the registers per thread stay bounded at any t.

#include <cuda_runtime.h>
#include <stddef.h>

#define PREALPS_LANE_MAX_OFFSETS 64
#define LANE_TT 8

struct LaneOffsets {
  int v[PREALPS_LANE_MAX_OFFSETS];
};

template <bool WRAP>
__device__ __forceinline__ int lane_col(int r, int off, int nrb, int lead) {
  if (WRAP) {
    int c = r + off;
    c += c < 0 ? nrb : 0;
    c -= c >= nrb ? nrb : 0;
    return c;
  }
  return r + lead + off;
}

template <int BR, int T, bool WRAP>
__global__ void __launch_bounds__(128)
stencil_lane_fixed(const float* __restrict__ blocks,
                   const float* __restrict__ x, float* __restrict__ y,
                   const LaneOffsets offs, int n_off, int nrb, int ncol,
                   int lead) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrb) return;
  float acc[T * BR];  // acc[j*BR + m]
#pragma unroll
  for (int i = 0; i < T * BR; ++i) acc[i] = 0.0f;
  for (int s = 0; s < n_off; ++s) {
    const size_t col = (size_t)lane_col<WRAP>(r, offs.v[s], nrb, lead);
    float b[BR * BR];
#pragma unroll
    for (int e = 0; e < BR * BR; ++e)
      b[e] = __ldg(blocks + (size_t)(s * BR * BR + e) * nrb + r);
#pragma unroll
    for (int k = 0; k < BR; ++k) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const float xv = __ldg(x + (size_t)(j * BR + k) * ncol + col);
#pragma unroll
        for (int m = 0; m < BR; ++m)
          acc[j * BR + m] = fmaf(b[m * BR + k], xv, acc[j * BR + m]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < T * BR; ++i) y[(size_t)i * nrb + r] = acc[i];
}

// Any (br, t): blockIdx.y = tile * br + m; the thread sums output row m of
// panel columns [tile*LANE_TT, tile*LANE_TT + LANE_TT) ∩ [0, t).
template <bool WRAP>
__global__ void __launch_bounds__(128)
stencil_lane_tiled(const float* __restrict__ blocks,
                   const float* __restrict__ x, float* __restrict__ y,
                   const LaneOffsets offs, int n_off, int br, int t, int nrb,
                   int ncol, int lead) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrb) return;
  const int m = blockIdx.y % br;
  const int j0 = (blockIdx.y / br) * LANE_TT;
  const int nj = min(LANE_TT, t - j0);
  float acc[LANE_TT];
#pragma unroll
  for (int jj = 0; jj < LANE_TT; ++jj) acc[jj] = 0.0f;
  for (int s = 0; s < n_off; ++s) {
    const size_t col = (size_t)lane_col<WRAP>(r, offs.v[s], nrb, lead);
    for (int k = 0; k < br; ++k) {
      const float bv =
          __ldg(blocks + (size_t)((s * br + m) * br + k) * nrb + r);
#pragma unroll
      for (int jj = 0; jj < LANE_TT; ++jj)
        if (jj < nj)
          acc[jj] = fmaf(
              bv, __ldg(x + (size_t)((j0 + jj) * br + k) * ncol + col),
              acc[jj]);
    }
  }
#pragma unroll
  for (int jj = 0; jj < LANE_TT; ++jj)
    if (jj < nj) y[(size_t)((j0 + jj) * br + m) * nrb + r] = acc[jj];
}

template <bool WRAP>
static void launch(const float* blocks, const float* x, float* y,
                   const LaneOffsets& offs, int n_off, int br, int t,
                   int nrb, int ncol, int lead, cudaStream_t st) {
  const dim3 block(128);
  dim3 grid((nrb + 127) / 128);
  if (br == 3 && t == 12) {
    stencil_lane_fixed<3, 12, WRAP><<<grid, block, 0, st>>>(
        blocks, x, y, offs, n_off, nrb, ncol, lead);
  } else if (br == 3 && t == 8) {
    stencil_lane_fixed<3, 8, WRAP><<<grid, block, 0, st>>>(
        blocks, x, y, offs, n_off, nrb, ncol, lead);
  } else if (br == 3 && t == 1) {
    stencil_lane_fixed<3, 1, WRAP><<<grid, block, 0, st>>>(
        blocks, x, y, offs, n_off, nrb, ncol, lead);
  } else {
    grid.y = br * ((t + LANE_TT - 1) / LANE_TT);
    stencil_lane_tiled<WRAP><<<grid, block, 0, st>>>(
        blocks, x, y, offs, n_off, br, t, nrb, ncol, lead);
  }
}

extern "C" {

int prealps_lane_max_offsets(void) { return PREALPS_LANE_MAX_OFFSETS; }

// wrap != 0: B2a, x is (t, br, nrb) and columns wrap (ncol = nrb, lead = 0);
// wrap == 0: B2b, x is (t, br, ncol) with ncol = nrb + 2*lead, lead = halo.
// Launches on `stream` (a cudaStream_t passed as void*) of card `device`
// and returns cudaGetLastError() of the launch; does not synchronise or
// allocate. The library links its own CUDA runtime, so the card is set here.
int prealps_stencil_lane_f32(const float* blocks, const float* x, float* y,
                             const int* offsets_host, int n_off, int br,
                             int t, int nrb, int ncol, int lead, int wrap,
                             int device, void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_off < 1 || n_off > PREALPS_LANE_MAX_OFFSETS || br < 1 || t < 1 ||
      nrb < 1 || lead < 0 || ncol < nrb + 2 * lead ||
      (long long)br * ((t + LANE_TT - 1) / LANE_TT) > 65535)
    return (int)cudaErrorInvalidValue;
  LaneOffsets offs;
  for (int i = 0; i < PREALPS_LANE_MAX_OFFSETS; ++i)
    offs.v[i] = i < n_off ? offsets_host[i] : 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (wrap)
    launch<true>(blocks, x, y, offs, n_off, br, t, nrb, ncol, lead, st);
  else
    launch<false>(blocks, x, y, offs, n_off, br, t, nrb, ncol, lead, st);
  return (int)cudaGetLastError();
}

const char* prealps_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
