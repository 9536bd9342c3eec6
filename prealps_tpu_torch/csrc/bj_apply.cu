// Batched block-Jacobi apply for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel _bj_pallas_kernel / bj_apply_pallas in
// prealps_tpu/direct/device_bj.py:159-202 and computes its batched product:
//
//   out[b, i, j] = sum_k B[b, i, k] * z[b, k, j]
//
// B: (nb, mbp, mbp) f32 dense block inverses (pack_bj_dense: mb rounded up
// to a multiple of 128 with zero padding); z: (nb, mbp, t) f32; out: (nb,
// mbp, t) f32. The wrapper (direct/device_bj.py::bj_apply_pallas) moves the
// lane-major panel into and out of this block layout.
//
// What bounds it: bytes. At the general path's preconditioner (nb = 617,
// mb = 240 -> mbp = 256, t = 12) one call reads B once (161.7 MB) and z and
// out (7.6 MB each): ~177 MB for 2*nb*mbp*mbp*t = 0.97 GFLOP, ~5.5
// FLOP/byte, still far below the card's f32 balance point (~20 FLOP/byte
// without tensor cores), so the floor is the B stream, ~0.05 ms at
// 3.35 TB/s.
//
// Design (the TPU kernel streams (128, mbp) row tiles of B through a
// BlockSpec pipeline against a VMEM-resident z block): two CTAs per block b,
// one for each half of its rows. A CTA stages the z block (mbp x t) into
// shared memory; each of its warps then takes groups of 8 rows of B. Lane l
// owns the columns k = l + 32c: it reads B[b, i, k] (one 128-byte coalesced
// line per row across the warp, every byte of B read exactly once) and row
// k of the staged z (16-byte shared loads; a 12-float row stride keeps the
// 8 lanes of a phase on distinct banks), keeping the 8*t partial sums in
// registers. A warp reduce-scatter
// then leaves lane l the finished sums of outputs 3l..3l+2 (t = 12), stored
// coalesced. f32 FMAs, no tensor cores. t = 12 is specialised; any other t
// runs in chunks of 4 columns along grid.y.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define BJ_WARPS 4
#define BJ_ROWS 8   // rows of B per warp pass
#define BJ_SPLIT 2  // CTAs per block (row halves): 2*nb CTAs fill the card better

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
// l*(NV/32) .. l*(NV/32) + NV/32 - 1 (see csrc/block_ell.cu).
template <int NV>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[NV], int lane) {
  static_assert(NV % 32 == 0, "reduce-scatter needs a multiple of 32 values");
  reduce_scatter_level<NV, 16>(v, lane);
}

// Columns j0 .. j0 + TJ - 1 of the output (j0 = TJ * blockIdx.y); t is the
// full panel width. WHOLE: t == TJ (the t = 12 specialisation, grid.y = 1),
// so the block's z rows are one contiguous run staged with 16-byte loads.
// The staging loops are unrolled so a thread's loads are all in flight
// before its shared-memory stores wait on them.
template <int TJ, bool WHOLE>
__global__ void __launch_bounds__(32 * BJ_WARPS)
bj_apply_kernel(const float* __restrict__ B, const float* __restrict__ z,
                float* __restrict__ out, int mbp, int t) {
  extern __shared__ float4 zs4[];  // (mbp, TJ) staged z columns
  float* zs = reinterpret_cast<float*>(zs4);
  const int b = blockIdx.x;
  const int j0 = blockIdx.y * TJ;
  const int rows = mbp / BJ_SPLIT;
  const int row_lo = blockIdx.z * rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* zb = z + (size_t)b * mbp * t;
  if constexpr (WHOLE) {
    const float4* src = reinterpret_cast<const float4*>(zb);
#pragma unroll 8
    for (int e = threadIdx.x; e < mbp * TJ / 4; e += blockDim.x)
      zs4[e] = __ldg(src + e);
  } else {
#pragma unroll 8
    for (int e = threadIdx.x; e < mbp * TJ; e += blockDim.x) {
      const int k = e / TJ;
      const int jj = e - k * TJ;
      zs[e] = (j0 + jj < t) ? __ldg(zb + (size_t)k * t + j0 + jj) : 0.0f;
    }
  }
  __syncthreads();
  const float* Bb = B + (size_t)b * mbp * mbp;
  for (int r0 = row_lo + warp * BJ_ROWS; r0 < row_lo + rows;
       r0 += BJ_WARPS * BJ_ROWS) {
    float acc[BJ_ROWS * TJ];
#pragma unroll
    for (int i = 0; i < BJ_ROWS * TJ; ++i) acc[i] = 0.0f;
#pragma unroll 8
    for (int k = lane; k < mbp; k += 32) {
      float bv[BJ_ROWS];
#pragma unroll
      for (int r = 0; r < BJ_ROWS; ++r)
        bv[r] = __ldg(Bb + (size_t)(r0 + r) * mbp + k);
      float zv[TJ];
      const float4* zr = reinterpret_cast<const float4*>(zs + k * TJ);
#pragma unroll
      for (int q = 0; q < TJ / 4; ++q) {
        const float4 v4 = zr[q];
        zv[4 * q] = v4.x;
        zv[4 * q + 1] = v4.y;
        zv[4 * q + 2] = v4.z;
        zv[4 * q + 3] = v4.w;
      }
#pragma unroll
      for (int r = 0; r < BJ_ROWS; ++r)
#pragma unroll
        for (int j = 0; j < TJ; ++j)
          acc[r * TJ + j] = fmaf(bv[r], zv[j], acc[r * TJ + j]);
    }
    warp_reduce_scatter<BJ_ROWS * TJ>(acc, lane);
    // lane l holds outputs (r, jj) with r*TJ + jj = l*PER + i
    constexpr int PER = BJ_ROWS * TJ / 32;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = lane * PER + i;
      const int r = idx / TJ;
      const int j = j0 + idx - r * TJ;
      if (j < t) out[((size_t)b * mbp + r0 + r) * t + j] = acc[i];
    }
  }
}

extern "C" {

int prealps_bj_apply_max_rows(int t) {
  // shared memory for the staged z block: mbp * TJ floats within 48 KB
  const int tj = (t == 12) ? 12 : 4;
  return (48 * 1024) / (4 * tj);
}

// Launches on `stream` (a cudaStream_t passed as void*) of card `device`
// and returns cudaGetLastError() of the launch; does not synchronise or
// allocate. The library links its own CUDA runtime, so the card is set here.
int prealps_bj_apply_f32(const float* B, const float* z, float* out, int nb,
                         int mbp, int t, int device, void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (nb < 1 || t < 1 || mbp < 32 || mbp % 32 ||
      mbp > prealps_bj_apply_max_rows(t))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(32 * BJ_WARPS);
  if (t == 12) {
    const dim3 grid(nb, 1, BJ_SPLIT);
    bj_apply_kernel<12, true><<<grid, block, (size_t)mbp * 12 * sizeof(float), st>>>(
        B, z, out, mbp, t);
  } else {
    const dim3 grid(nb, (t + 3) / 4, BJ_SPLIT);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    bj_apply_kernel<4, false><<<grid, block, (size_t)mbp * 4 * sizeof(float), st>>>(
        B, z, out, mbp, t);
  }
  return (int)cudaGetLastError();
}

const char* prealps_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
