// Block-ELL SpMM for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel _spmm_kernel / block_ell_spmm_pallas in
// prealps_tpu/ops/spmm.py:69-143 and computes what it computes:
//
//   y[rb*8 + m, j] = sum_s sum_k blocks[rb, s, m, k] * x[blkcols[rb, s]*bk + k, j]
//
// blocks: (nrb, S, 8, bk) f32; blkcols: (nrb, S) int32; x: (ncols_pad, t)
// f32 row-major; y: (nrb*8, t) f32. Padding slots point at column block 0
// with zero values, so they add exact zeros.
//
// What bounds it: bytes. At the general path's operator (elasticity3d 36^3
// in natural order: nrb = 18,496, S = 9, bk = 128, t = 12) one call streams
// the blocks once (681.8 MB), reads the 7.1 MB X panel and writes 7.1 MB of
// y: ~0.70 GB for 2*nrb*S*8*bk*t = 0.41 GFLOP, ~0.6 FLOP/byte, so the floor
// is the blocks' stream, ~0.21 ms at 3.35 TB/s.
//
// Design (not the TPU's: there, the whole X panel sits in VMEM and a
// sequential grid walks chunks of row blocks with scalar-prefetched block
// columns): one warp per row block. The warp reads its own blkcols row.
// Lane l owns the block columns k = l + 32c (c < 4): for each slot it reads
// column k of the 8x bk block (8 loads, each one 128-byte coalesced line
// across the warp, every block byte read exactly once) and row k of the
// matching X block (t floats, 16-byte loads when t = 12), which come from L2
// (the 7.1 MB panel stays resident in the 50 MB L2) and L1 (neighbouring row
// blocks of a CTA share their column blocks). The 8*t partial sums stay in
// registers across the S slots; at the end a warp reduce-scatter (xor
// shuffles halving the set each level) leaves lane l the finished sums of
// outputs 3l..3l+2 (t = 12), which it stores coalesced. Products are f32
// FMAs, no tensor cores (f32 parity rules out TF32). The summation order
// differs from the plain version's (lane-partial sums, then a tree), so the
// two agree to f32 rounding of a length-S*bk dot product.
//
// Kernels: bk = 128 with t = 12 or t = 1 specialised (the general path's
// panel and a single vector), and a generic kernel for any bk that is a
// multiple of 8 up to 128 and any t (t in chunks of 4 columns along
// grid.y, which re-reads the blocks once per chunk).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define WARPS_PER_CTA 4

// One level of the reduce-scatter: lanes whose bit OFF is set keep the upper
// half of the live values, the others the lower half, and each adds its
// partner's copy of the half it keeps. The live set halves at every level.
template <int NV, int OFF>
__device__ __forceinline__ void reduce_scatter_level(float (&v)[NV], int lane) {
  constexpr int HALF = NV * OFF / 32;
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
  if constexpr (OFF > 1) reduce_scatter_level<NV, OFF / 2>(v, lane);
}

// v[0 .. NV/32) of lane l end up holding the warp-wide sums of the entries
// l*(NV/32) .. l*(NV/32) + NV/32 - 1. NV must be a multiple of 32.
template <int NV>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[NV], int lane) {
  static_assert(NV % 32 == 0, "reduce-scatter needs a multiple of 32 values");
  reduce_scatter_level<NV, 16>(v, lane);
}

// Full warp sum of each of NV values (NV < 32): lanes 0..NV-1 store one each.
template <int NV>
__device__ __forceinline__ void warp_reduce_store(float (&v)[NV], int lane,
                                                  float* __restrict__ out) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
  float mine = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane == i) mine = v[i];
  if (lane < NV) out[lane] = mine;
}

// bk = 128, t = T (12 or 1). x_vec4: x rows may be read as float4.
template <int T>
__global__ void __launch_bounds__(32 * WARPS_PER_CTA)
block_ell_bk128(const float* __restrict__ blocks,
                const int* __restrict__ blkcols, const float* __restrict__ x,
                float* __restrict__ y, int nrb, int s_max) {
  constexpr int BK = 128;
  const int lane = threadIdx.x & 31;
  const int rb = blockIdx.x * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (rb >= nrb) return;  // uniform across the warp
  float acc[8 * T];
#pragma unroll
  for (int i = 0; i < 8 * T; ++i) acc[i] = 0.0f;
  const float* brow = blocks + (size_t)rb * s_max * 8 * BK;
  const int* crow = blkcols + (size_t)rb * s_max;
  for (int s = 0; s < s_max; ++s) {
    const int cb = __ldg(crow + s);
    const float* blk = brow + (size_t)s * 8 * BK;
    const float* xs = x + (size_t)cb * BK * T;
#pragma unroll
    for (int c = 0; c < BK / 32; ++c) {
      const int k = c * 32 + lane;
      float b[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) b[m] = __ldg(blk + m * BK + k);
      float xv[T];
      if constexpr (T % 4 == 0) {
        const float4* xr = reinterpret_cast<const float4*>(xs + (size_t)k * T);
#pragma unroll
        for (int q = 0; q < T / 4; ++q) {
          const float4 v4 = __ldg(xr + q);
          xv[4 * q] = v4.x;
          xv[4 * q + 1] = v4.y;
          xv[4 * q + 2] = v4.z;
          xv[4 * q + 3] = v4.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < T; ++j) xv[j] = __ldg(xs + (size_t)k * T + j);
      }
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int j = 0; j < T; ++j)
          acc[m * T + j] = fmaf(b[m], xv[j], acc[m * T + j]);
    }
  }
  float* out = y + (size_t)rb * 8 * T;
  if constexpr ((8 * T) % 32 == 0) {
    warp_reduce_scatter<8 * T>(acc, lane);
    constexpr int PER = (8 * T) / 32;
#pragma unroll
    for (int i = 0; i < PER; ++i) out[lane * PER + i] = acc[i];
  } else {
    warp_reduce_store<8 * T>(acc, lane, out);
  }
}

// Any bk (multiple of 8, <= 128) and any t: columns j0 .. j0+3 of y, with
// j0 = 4*blockIdx.y.
__global__ void __launch_bounds__(32 * WARPS_PER_CTA)
block_ell_generic(const float* __restrict__ blocks,
                  const int* __restrict__ blkcols,
                  const float* __restrict__ x, float* __restrict__ y, int nrb,
                  int s_max, int bk, int t) {
  constexpr int TJ = 4;
  const int lane = threadIdx.x & 31;
  const int rb = blockIdx.x * WARPS_PER_CTA + (threadIdx.x >> 5);
  if (rb >= nrb) return;
  const int j0 = blockIdx.y * TJ;
  float acc[8 * TJ];
#pragma unroll
  for (int i = 0; i < 8 * TJ; ++i) acc[i] = 0.0f;
  const float* brow = blocks + (size_t)rb * s_max * 8 * bk;
  const int* crow = blkcols + (size_t)rb * s_max;
  for (int s = 0; s < s_max; ++s) {
    const int cb = __ldg(crow + s);
    const float* blk = brow + (size_t)s * 8 * bk;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = c * 32 + lane;
      if (k < bk) {
        float b[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) b[m] = __ldg(blk + m * bk + k);
        const float* xr = x + ((size_t)cb * bk + k) * t;
        float xv[TJ];
#pragma unroll
        for (int jj = 0; jj < TJ; ++jj)
          xv[jj] = (j0 + jj < t) ? __ldg(xr + j0 + jj) : 0.0f;
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int jj = 0; jj < TJ; ++jj)
            acc[m * TJ + jj] = fmaf(b[m], xv[jj], acc[m * TJ + jj]);
      }
    }
  }
  warp_reduce_scatter<8 * TJ>(acc, lane);
  // lane l holds output (m, jj) = (l / TJ, l % TJ)
  const int m = lane / TJ;
  const int j = j0 + lane % TJ;
  if (j < t) y[((size_t)rb * 8 + m) * t + j] = acc[0];
}

extern "C" {

// Launches on `stream` (a cudaStream_t passed as void*) of card `device`
// and returns cudaGetLastError() of the launch; does not synchronise or
// allocate. The library links its own CUDA runtime, so the card is set here.
int prealps_block_ell_f32(const float* blocks, const int* blkcols,
                          const float* x, float* y, int nrb, int s_max,
                          int bk, int t, int device, void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (nrb < 1 || s_max < 1 || t < 1 || bk < 8 || bk > 128 || bk % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(32 * WARPS_PER_CTA);
  dim3 grid((nrb + WARPS_PER_CTA - 1) / WARPS_PER_CTA);
  const bool x16 = ((uintptr_t)x % 16) == 0;
  if (bk == 128 && t == 12 && x16) {
    block_ell_bk128<12><<<grid, block, 0, st>>>(blocks, blkcols, x, y, nrb,
                                                s_max);
  } else if (bk == 128 && t == 1) {
    block_ell_bk128<1><<<grid, block, 0, st>>>(blocks, blkcols, x, y, nrb,
                                               s_max);
  } else {
    grid.y = (t + 3) / 4;
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    block_ell_generic<<<grid, block, 0, st>>>(blocks, blkcols, x, y, nrb,
                                              s_max, bk, t);
  }
  return (int)cudaGetLastError();
}

const char* prealps_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
