// Flat stencil-BSR SpMM for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel _stencil_flat_kernel / stencil_flat_ext in
// prealps_tpu/ops/spmm.py:772-846 and computes what it computes:
//
//   y[m*t + j, r] = sum_s sum_k B[s*br*br + m*br + k, r]
//                             * x_ext[k*t + j, r + halo + off_s]
//
// blocks B: (S*br*br, nrb) f32, node axis minor; x_ext: (br*t, nrb + 2*halo)
// f32, k-major rows, halos attached by the caller; y: (br*t, nrb) f32.
//
// What bounds it: bytes. At the headline operator (S=27, br=3, t=12,
// nrb=49,360) one call must read the block table once (48.0 MB), the
// extended panel (7.5 MB) and write y (7.1 MB): ~62.6 MB for 2*S*br*br*t*nrb
// = 11.5 MFLOP, i.e. ~0.18 FLOP/byte, far below the card's balance point.
//
// Design: one thread per node r. The thread walks the S offsets, loads its
// br*br block entries (consecutive threads read consecutive r: coalesced,
// each block byte read exactly once), and keeps the br*t accumulators in
// registers (BR and T are template parameters for the main path's shapes,
// with a generic one-thread-per-output kernel for the rest). Its x reads
// x_ext[k*t + j, r + halo + off_s] are coalesced across the warp as well;
// the extended panel is re-read once per offset, but at 7.5 MB it stays
// resident in the 50 MB L2, so device memory sees the block table and the
// panel about once. The offsets travel by value in the kernel's parameter
// space (constant bank), read uniformly by every thread. Accumulation is
// f32 with FMA, in the order s, then k, like the TPU kernel; no tensor
// cores (f32 parity rules out TF32).

#include <cuda_runtime.h>
#include <stddef.h>

#define PREALPS_MAX_OFFSETS 64

struct StencilOffsets {
  int v[PREALPS_MAX_OFFSETS];
};

template <int BR, int T>
__global__ void __launch_bounds__(128)
stencil_flat_fixed(const float* __restrict__ blocks,
                   const float* __restrict__ x_ext, float* __restrict__ y,
                   const StencilOffsets offs, int n_off, int nrb, int ncol,
                   int halo) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrb) return;
  float acc[BR * T];
#pragma unroll
  for (int i = 0; i < BR * T; ++i) acc[i] = 0.0f;
  for (int s = 0; s < n_off; ++s) {
    const size_t col = (size_t)(r + halo + offs.v[s]);
    float b[BR * BR];
#pragma unroll
    for (int e = 0; e < BR * BR; ++e)
      b[e] = __ldg(blocks + (size_t)(s * BR * BR + e) * nrb + r);
#pragma unroll
    for (int k = 0; k < BR; ++k) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const float xv = __ldg(x_ext + (size_t)(k * T + j) * ncol + col);
#pragma unroll
        for (int m = 0; m < BR; ++m)
          acc[m * T + j] = fmaf(b[m * BR + k], xv, acc[m * T + j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BR * T; ++i) y[(size_t)i * nrb + r] = acc[i];
}

// Any (br, t): one thread per output element (row m*t + j = blockIdx.y).
__global__ void __launch_bounds__(128)
stencil_flat_generic(const float* __restrict__ blocks,
                     const float* __restrict__ x_ext, float* __restrict__ y,
                     const StencilOffsets offs, int n_off, int br, int t,
                     int nrb, int ncol, int halo) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrb) return;
  const int row = blockIdx.y;
  const int m = row / t;
  const int j = row % t;
  float acc = 0.0f;
  for (int s = 0; s < n_off; ++s) {
    const size_t col = (size_t)(r + halo + offs.v[s]);
    for (int k = 0; k < br; ++k) {
      const float bv =
          __ldg(blocks + (size_t)(s * br * br + m * br + k) * nrb + r);
      const float xv = __ldg(x_ext + (size_t)(k * t + j) * ncol + col);
      acc = fmaf(bv, xv, acc);
    }
  }
  y[(size_t)row * nrb + r] = acc;
}

extern "C" {

int prealps_max_offsets(void) { return PREALPS_MAX_OFFSETS; }

// Launches on `stream` (a cudaStream_t passed as void*) of card `device`
// and returns cudaGetLastError() of the launch; does not synchronise or
// allocate. The library links its own CUDA runtime, so the card is set here
// rather than inherited from the caller's runtime.
int prealps_stencil_flat_f32(const float* blocks, const float* x_ext,
                             float* y, const int* offsets_host, int n_off,
                             int br, int t, int nrb, int halo, int device,
                             void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_off < 1 || n_off > PREALPS_MAX_OFFSETS || br < 1 || t < 1 ||
      nrb < 1 || br * t > 65535)
    return (int)cudaErrorInvalidValue;
  StencilOffsets offs;
  for (int i = 0; i < PREALPS_MAX_OFFSETS; ++i)
    offs.v[i] = i < n_off ? offsets_host[i] : 0;
  const int ncol = nrb + 2 * halo;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 block(128);
  dim3 grid((nrb + 127) / 128);
  if (br == 3 && t == 12) {
    stencil_flat_fixed<3, 12><<<grid, block, 0, st>>>(blocks, x_ext, y, offs,
                                                     n_off, nrb, ncol, halo);
  } else if (br == 3 && t == 1) {
    stencil_flat_fixed<3, 1><<<grid, block, 0, st>>>(blocks, x_ext, y, offs,
                                                    n_off, nrb, ncol, halo);
  } else if (br == 1 && t == 12) {
    stencil_flat_fixed<1, 12><<<grid, block, 0, st>>>(blocks, x_ext, y, offs,
                                                     n_off, nrb, ncol, halo);
  } else if (br == 1 && t == 1) {
    stencil_flat_fixed<1, 1><<<grid, block, 0, st>>>(blocks, x_ext, y, offs,
                                                    n_off, nrb, ncol, halo);
  } else {
    grid.y = br * t;
    stencil_flat_generic<<<grid, block, 0, st>>>(blocks, x_ext, y, offs,
                                                 n_off, br, t, nrb, ncol,
                                                 halo);
  }
  return (int)cudaGetLastError();
}

const char* prealps_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
