// Batched block-Jacobi apply for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel _bj_pallas_kernel / bj_apply_pallas in
// prealps_tpu/direct/device_bj.py:159-202 and computes its function as
// seen at the wrapper: the lane-major panel z (t, br, nrb) goes to the
// lane-major w of the same shape through nb packed block inverses,
//
//   w[j, m, b*mbn + rl] = sum_i' B[b, m*mbn + rl, i'] * zb[i', j],
//   zb[m'*mbn + rl', j] = z[j, m', b*mbn + rl'],
//
// B: (nb, mbp, mbp) f32 from pack_bj_dense, of which only the first
// mb = br*mbn rows and columns are nonzero (mbp = mb rounded up to 128).
//
// What bounds it: bytes. At the stencil bj path's preconditioner (nb = 617,
// mb = 240, t = 12) the product needs the unpadded inverses once (142.2 MB)
// plus z and w (7.1 MB each): 156.4 MB -> 46.7 us at 3.35 TB/s; its
// 2*nb*mb*mb*t = 0.85 GFLOP take 12.7 us at the 67 TFLOP/s f32 rate. At
// the DIA path's blocks (nb = 145, mb = 1024) it is 608 MB -> 0.18 ms.
//
// The first cut (a warp per 8 rows reading B straight from device memory,
// lane-split k, a warp reduce-scatter) reached a third of that bound and
// lost to torch.bmm: it read the 256-row padded table (12 % more bytes),
// needed two copy kernels in its wrapper to move z into and out of a
// (nb, mbp, t) block panel, and kept 96 sums plus 64 unrolled B values per
// lane, so few warps and few bytes were in flight per SM. Nsight Compute
// does not run on the machine that has the card, so no counter was read;
// variants timed side by side on the card showed the rest: a first
// redesign that staged z with ordinary loads before its pipeline started
// still lost to torch.bmm (each CTA waited out ~20-100 dependent z loads),
// and two rows per thread or a 16-column stage ran slower than one row and
// 32 columns (fewer CTAs fit an SM beside the z block).
//
// Design: a CTA owns RT = 128 rows of one block (grid: block, row tile,
// chunk of <= 12 panel columns) and one thread owns one row and all of the
// chunk's columns, so a sum stays in one thread in the order of k, no
// reduction across threads. The CTA
//  1. copies its block's z columns once, straight from the lane-major
//     panel, with cp.async in the pipeline's first group (block b's entries
//     are runs of mbn floats per (j, m): 16-byte copies where mbn and nrb
//     are multiples of 4), as 12 rows of mb floats in shared memory (opt-in
//     dynamic shared memory past 48 KB: mb up to 3,690 at 12 columns);
//  2. streams its rows of B, valid columns only (mb rounded up to 4; the
//     rows past mb are not read), through a 3-stage shared-memory ring of
//     (RT x 32) tiles with cp.async (16-byte copies, one 128-byte line per 8
//     threads): two stages, 32 KB, stay in flight per CTA whatever the
//     thread count, and the copies need no registers;
//  3. per 4 columns of k: one 16-byte shared load of its B row (a 36-float
//     row stride puts the 8 threads of a phase on distinct banks) and one
//     broadcast 16-byte load of z per panel column, then 4 * 12 f32 FMAs
//     into registers;
//  4. writes w straight into the lane-major output, coalesced in rl.
// No tensor cores: f32 parity rules out TF32 (as for csrc/block_ell.cu).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define BJ_RT 128      // rows per CTA, one thread each
#define BJ_KC 32       // columns of k per ring stage
#define BJ_STAGES 3
#define BJ_BSTRIDE (BJ_KC + 4)  // floats per staged row (16-byte aligned)
#define BJ_TJ 12       // panel columns per CTA at most
#define BJ_RING_FLOATS (BJ_STAGES * BJ_RT * BJ_BSTRIDE)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// TJ panel columns per CTA (blockIdx.z = chunk of columns). Thread i owns
// row i of the CTA's tile. zs holds the block's z columns as TJ rows of
// mb rounded up to 4 floats (zero past mb); rows past the panel's width
// are left unset, and the sums they feed are never stored. vec: 16-byte z
// copies (mbn and nrb multiples of 4).
template <int TJ>
__global__ void __launch_bounds__(BJ_RT)
bj_apply_kernel(const float* __restrict__ B, const float* __restrict__ z,
                float* __restrict__ w, int mb, int mbp, int mbn, int br,
                int nrb, int t, int vec) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* zs = ring + BJ_RING_FLOATS;
  const int b = blockIdx.x;
  const int i0 = blockIdx.y * BJ_RT;
  const int j0 = blockIdx.z * TJ;
  const int nj = min(TJ, t - j0);
  const int mb4 = (mb + 3) & ~3;
  const int nk = (mb4 + BJ_KC - 1) / BJ_KC;
  const int rows = min(BJ_RT, mb - i0);
  const float* Bt = B + ((size_t)b * mbp + i0) * mbp;
  const size_t zoff = (size_t)b * mbn;

  auto load_stage = [&](int c) {
    float* dst = ring + (c % BJ_STAGES) * (BJ_RT * BJ_BSTRIDE);
    const int k0 = c * BJ_KC;
#pragma unroll
    for (int e = threadIdx.x; e < BJ_RT * (BJ_KC / 4); e += BJ_RT) {
      const int r = e / (BJ_KC / 4);
      const int q = e - r * (BJ_KC / 4);
      const int k = k0 + 4 * q;
      const bool ok = r < rows && k < mb4;
      cp_async16(dst + r * BJ_BSTRIDE + 4 * q,
                 ok ? Bt + (size_t)r * mbp + k : Bt, ok ? 16 : 0);
    }
  };

  // the z block, copied asynchronously with the first stage: row jj of zs
  // is column j0 + jj, its entries k = m*mbn + rl runs of mbn floats of
  // the lane-major panel
  if (vec) {
    const int per = mbn >> 2;
    for (int e = threadIdx.x; e < nj * br * per; e += BJ_RT) {
      const int row = e / per;  // jj*br + m
      const int q = e - row * per;
      const int jj = row / br;
      const int m = row - jj * br;
      cp_async16(zs + jj * mb4 + m * mbn + 4 * q,
                 z + ((size_t)(j0 + jj) * br + m) * nrb + zoff + 4 * q, 16);
    }
  } else {
    for (int e = threadIdx.x; e < nj * mb; e += BJ_RT) {
      const int jj = e / mb;
      const int k = e - jj * mb;
      const int m = k / mbn;
      cp_async4(zs + jj * mb4 + k,
                z + ((size_t)(j0 + jj) * br + m) * nrb + zoff + (k - m * mbn));
    }
  }
  for (int e = threadIdx.x; e < nj * (mb4 - mb); e += BJ_RT) {
    const int jj = e / (mb4 - mb);
    zs[jj * mb4 + mb + (e - jj * (mb4 - mb))] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < BJ_STAGES - 1; ++c) {
    if (c < nk) load_stage(c);
    cp_async_commit();
  }

  float acc[TJ];
#pragma unroll
  for (int j = 0; j < TJ; ++j) acc[j] = 0.0f;
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<BJ_STAGES - 2>();
    __syncthreads();
    if (c + BJ_STAGES - 1 < nk) load_stage(c + BJ_STAGES - 1);
    cp_async_commit();
    const float* bs = ring + (c % BJ_STAGES) * (BJ_RT * BJ_BSTRIDE) + threadIdx.x * BJ_BSTRIDE;
    const float* zc = zs + c * BJ_KC;
    const int kn = min(BJ_KC, mb4 - c * BJ_KC);
#pragma unroll
    for (int kk = 0; kk < BJ_KC; kk += 4) {
      if (kk < kn) {
        const float4 bv = *reinterpret_cast<const float4*>(bs + kk);
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          const float4 zv = *reinterpret_cast<const float4*>(zc + j * mb4 + kk);
          acc[j] = fmaf(bv.x, zv.x, acc[j]);
          acc[j] = fmaf(bv.y, zv.y, acc[j]);
          acc[j] = fmaf(bv.z, zv.z, acc[j]);
          acc[j] = fmaf(bv.w, zv.w, acc[j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int r = threadIdx.x;
  if (r < rows) {
    const int i = i0 + r;
    const int m = i / mbn;
    float* wr = w + (size_t)m * nrb + zoff + (i - m * mbn);
#pragma unroll
    for (int j = 0; j < TJ; ++j)
      if (j < nj) wr[(size_t)(j0 + j) * br * nrb] = acc[j];
  }
}

static size_t smem_bytes(int tj, int mb) {
  return sizeof(float) * ((size_t)BJ_RING_FLOATS + (size_t)((mb + 3) & ~3) * tj);
}

template <int TJ>
static int launch(const float* B, const float* z, float* w, int nb, int mb,
                  int mbp, int mbn, int br, int nrb, int t, cudaStream_t st) {
  const size_t bytes = smem_bytes(TJ, mb);
  cudaError_t e = cudaFuncSetAttribute(
      bj_apply_kernel<TJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(nb, (mb + BJ_RT - 1) / BJ_RT, (t + TJ - 1) / TJ);
  const int vec = mbn % 4 == 0 && nrb % 4 == 0 && ((uintptr_t)z & 15) == 0;
  bj_apply_kernel<TJ><<<grid, BJ_RT, bytes, st>>>(B, z, w, mb, mbp, mbn,
                                                       br, nrb, t, vec);
  return (int)cudaGetLastError();
}

extern "C" {

// The largest block (mb rows) the kernel takes at width t on card `device`:
// the ring and the staged z block must fit the opt-in shared memory of one
// CTA. Returns 0 if the card cannot be queried.
int prealps_bj_apply_max_rows(int t, int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  const int tj = t < BJ_TJ ? t : BJ_TJ;
  const long long room = (long long)optin - (long long)sizeof(float) * BJ_RING_FLOATS;
  return room <= 0 ? 0 : (int)((room / ((long long)sizeof(float) * tj)) & ~3LL);
}

// Launches on `stream` (a cudaStream_t passed as void*) of card `device`
// and returns the launch's error code; does not synchronise or allocate.
// z and w are lane-major (t, br, nrb) panels, nrb = nb*mbn, mb = br*mbn;
// B is (nb, mbp, mbp), 16-byte aligned, mbp a multiple of 4 and >= mb,
// zero in columns [mb, mbp). The library links its own CUDA runtime, so
// the card is set here.
int prealps_bj_apply_f32(const float* B, const float* z, float* w, int nb,
                         int mb, int mbp, int mbn, int br, int nrb, int t,
                         int device, void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (nb < 1 || t < 1 || br < 1 || mbn < 1 || mb != br * mbn ||
      (long long)nb * mbn != nrb || mbp < mb || mbp % 4 ||
      ((uintptr_t)B & 15) || mb > prealps_bj_apply_max_rows(t, device) ||
      (t + BJ_TJ - 1) / BJ_TJ > 65535 || (mb + BJ_RT - 1) / BJ_RT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define PREALPS_BJ(TJ_) \
  case TJ_:             \
    return launch<TJ_>(B, z, w, nb, mb, mbp, mbn, br, nrb, t, st)
  switch (t < BJ_TJ ? t : BJ_TJ) {
    PREALPS_BJ(1);
    PREALPS_BJ(2);
    PREALPS_BJ(3);
    PREALPS_BJ(4);
    PREALPS_BJ(5);
    PREALPS_BJ(6);
    PREALPS_BJ(7);
    PREALPS_BJ(8);
    PREALPS_BJ(9);
    PREALPS_BJ(10);
    PREALPS_BJ(11);
    PREALPS_BJ(12);
  }
#undef PREALPS_BJ
  return (int)cudaErrorInvalidValue;
}

const char* prealps_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
