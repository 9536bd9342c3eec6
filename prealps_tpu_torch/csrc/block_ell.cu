// Block-ELL SpMM for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel _spmm_kernel / block_ell_spmm_pallas in
// prealps_tpu/ops/spmm.py:69-143 and computes what it computes:
//
//   y[rb*8 + m, j] = sum_s sum_k blocks[rb, s, m, k] * x[blkcols[rb, s]*bk + k, j]
//
// but reads the operator as the blocks' nonzero entries, packed once per
// operator by ops/formats.py::pack_block_ell_entries: row_ptr (n+1) int32,
// cols (nnz) int32, vals (nnz) f32, each row's entries in slot order (s,
// then k: ascending column), columns in the matrix's own column space
// (on a shard, the [own || halo] coordinates). x: (ncols, t) f32 row-major;
// y: (n, t) f32. A dropped zero changes nothing unless x holds Inf or NaN
// (0 * Inf is NaN; the block form would have added it).
//
// Why not the TPU's design. The MXU wanted dense 8 x 128 tiles, so the TPU
// kernel streams every slot of every block. At the general path's operator
// (elasticity3d 36^3 in natural order, bk 128) those blocks are 5.5 % full,
// and 2.5 % on a 4-rank shard's [own || halo] blocks: ~95-97 % of the bytes
// the block kernel streamed were zeros. Hopper at that fill wants the
// entries: 8 bytes each (value and column), no tensor cores (f32 FMAs; TF32
// would break f32 parity, and at this fill they would have nothing to do).
//
// What bounds it. Bytes, each input read once and each output written
// once: 8 * nnz + 4 * (n + 1) + 4 * ncols * t + 4 * n * t. One shard at
// t 12 (nnz 9.3 M): ~75 + 0.6 + 7.1 + 7.1 MB, ~27 us at 3.35 TB/s (the
// block slots were 682 MB, ~208 us). What really limits it is the gather
// of x rows: every entry fetches its column's t-float row (48 bytes at
// t 12, two 32-byte sectors) through L1 from L2, where the whole panel
// stays resident (7 MB of the 50 MB L2): ~0.45 GB of gathered rows on one
// shard at t 12, so the kernel reaches about a third of the bytes bound
// there and about two thirds at t 1 (4 bytes an entry).
//
// Design. A CTA takes a contiguous run of rows, so its entries are one
// contiguous span of cols / vals. The span is staged through shared memory
// in chunks of CAP entries with 16-byte cp.async copies, double-buffered:
// the next chunk streams in, coalesced and read once, while the current
// one computes. Each row's entries are then walked from shared memory:
//  * t = 12 (the solver's panel): 3 lanes per row, lane q owns columns
//    4q..4q+3 and reads them from x as one float4 (__ldg, L2). Lanes of
//    consecutive rows sit side by side, so the three rows of one
//    elasticity node (the same column list) can gather the same x row in
//    the same warp step.
//  * t = 1 (a solve at enlarging factor 1): 4 lanes per row, lane p takes
//    the row's entries p, p+4, p+8, ... in slot order; the four part sums
//    are combined in a fixed tree ((p0 + p1) + (p2 + p3), xor shuffles).
//  * any other t (up to 1024), or an x not 16-byte aligned: ceil(t/4)
//    lanes per row, each owning up to 4 columns, scalar loads. At t 12 it
//    takes 1.5x the float4 kernel's time and at t 1 1.9-4.5x the strided
//    one's (examples/kernel_ab.py against a copy sending every t here).
//
// Summation order, a rule: each output sums its row's entries in slot
// order with f32 fmaf (t = 1: four strided part sums in slot order, then
// the fixed tree). It depends on nothing of the launch's geometry or the
// chunking, so two launches give the same bits, and it differs from the
// plain version's (a multiply, then an add, per slot) only by the rounding
// of fmaf against that of a product and a sum.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define CAP 2048          // entries of one staged chunk (8 KB of cols + vals)
#define THREADS 256       // threads of a CTA, about (rows per CTA) x (lanes per row)
#define T1_LANES 4        // lanes per row at t = 1

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage entries [cb, ce) of cols / vals (cb a multiple of 4, so every copy
// is 16-byte aligned) into one buffer; the tail copy reads only what lies
// before ce and zero-fills the rest.
__device__ __forceinline__ void stage_chunk(int* __restrict__ s_cols,
                                            float* __restrict__ s_vals,
                                            const int* __restrict__ cols,
                                            const float* __restrict__ vals,
                                            int cb, int ce) {
  const int nvec = (ce - cb + 3) >> 2;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int g = cb + 4 * i;
    const int bytes = min(16, 4 * (ce - g));
    cp_async16(s_cols + 4 * i, cols + g, bytes);
    cp_async16(s_vals + 4 * i, vals + g, bytes);
  }
}

// The chunk loop every kernel shares: the CTA's span [e0, e1) of entries
// in chunks of CAP (aligned down to a multiple of 4 at the start), double
// buffered; body(s_cols, s_vals, cb, ce) runs once per chunk on the staged
// entries [cb, ce), with s_* indexed by k - cb.
template <typename Body>
__device__ __forceinline__ void for_each_chunk(const int* __restrict__ cols,
                                               const float* __restrict__ vals,
                                               int e0, int e1, Body body) {
  __shared__ __align__(16) int s_cols[2][CAP];
  __shared__ __align__(16) float s_vals[2][CAP];
  const int base = e0 & ~3;
  const int nch = e1 > e0 ? (e1 - base + CAP - 1) / CAP : 0;
  if (nch > 0) {
    stage_chunk(s_cols[0], s_vals[0], cols, vals, base, min(base + CAP, e1));
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    const int cb = base + c * CAP;
    const int ce = min(cb + CAP, e1);
    if (c + 1 < nch) {
      const int nb = cb + CAP;
      stage_chunk(s_cols[(c + 1) & 1], s_vals[(c + 1) & 1], cols, vals, nb,
                  min(nb + CAP, e1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(s_cols[c & 1], s_vals[c & 1], cb, ce);
    __syncthreads();  // the buffer is restaged two chunks on
  }
}

// t = 12, x rows read as float4: Q = 3 lanes per row, THREADS / Q rows a
// CTA.
__global__ void __launch_bounds__(THREADS)
entries_t12(const int* __restrict__ row_ptr, const int* __restrict__ cols,
            const float* __restrict__ vals, const float* __restrict__ x,
            float* __restrict__ y, int n) {
  constexpr int Q = 3;
  constexpr int ROWS = THREADS / Q;
  constexpr int T = 4 * Q;
  const int r0 = blockIdx.x * ROWS;
  const int r1 = min(r0 + ROWS, n);
  const int row = r0 + (int)threadIdx.x / Q;
  const int q = (int)threadIdx.x % Q;
  const bool live = threadIdx.x < ROWS * Q && row < r1;
  const int ks = live ? __ldg(row_ptr + row) : 0;
  const int ke = live ? __ldg(row_ptr + row + 1) : 0;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for_each_chunk(cols, vals, __ldg(row_ptr + r0), __ldg(row_ptr + r1),
                 [&](const int* sc, const float* sv, int cb, int ce) {
    const int lo = max(ks, cb), hi = min(ke, ce);
#pragma unroll 4
    for (int k = lo; k < hi; ++k) {
      const float v = sv[k - cb];
      const float4 xv =
          __ldg(reinterpret_cast<const float4*>(x + (size_t)sc[k - cb] * T) + q);
      acc.x = fmaf(v, xv.x, acc.x);
      acc.y = fmaf(v, xv.y, acc.y);
      acc.z = fmaf(v, xv.z, acc.z);
      acc.w = fmaf(v, xv.w, acc.w);
    }
  });
  if (live) reinterpret_cast<float4*>(y + (size_t)row * T)[q] = acc;
}

// t = 1: T1_LANES lanes per row, strided over the row's entries, then the
// fixed xor tree inside each aligned group of T1_LANES lanes of a warp.
__global__ void __launch_bounds__(THREADS)
entries_t1(const int* __restrict__ row_ptr, const int* __restrict__ cols,
           const float* __restrict__ vals, const float* __restrict__ x,
           float* __restrict__ y, int n) {
  constexpr int ROWS = THREADS / T1_LANES;
  const int r0 = blockIdx.x * ROWS;
  const int r1 = min(r0 + ROWS, n);
  const int row = r0 + (int)threadIdx.x / T1_LANES;
  const int p = (int)threadIdx.x % T1_LANES;
  const bool live = row < r1;
  const int ks = live ? __ldg(row_ptr + row) : 0;
  const int ke = live ? __ldg(row_ptr + row + 1) : 0;
  float acc = 0.0f;
  for_each_chunk(cols, vals, __ldg(row_ptr + r0), __ldg(row_ptr + r1),
                 [&](const int* sc, const float* sv, int cb, int ce) {
    const int lo = max(ks, cb), hi = min(ke, ce);
    // first k >= lo with k - ks = p (mod T1_LANES)
    int k = lo + ((p - (lo - ks)) % T1_LANES + T1_LANES) % T1_LANES;
    for (; k < hi; k += T1_LANES)
      acc = fmaf(sv[k - cb], __ldg(x + sc[k - cb]), acc);
  });
#pragma unroll
  for (int off = 1; off < T1_LANES; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && p == 0) y[row] = acc;
}

// Any t up to 4 * THREADS: q = ceil(t/4) lanes per row, THREADS / q rows a
// CTA (at least one), lane l owning columns 4l .. min(4l+4, t).
__global__ void __launch_bounds__(THREADS)
entries_generic(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                const float* __restrict__ vals, const float* __restrict__ x,
                float* __restrict__ y, int n, int t) {
  const int q_n = (t + 3) / 4;
  const int rows = THREADS / q_n;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, n);
  const int row = r0 + (int)threadIdx.x / q_n;
  const int j0 = 4 * ((int)threadIdx.x % q_n);
  const bool live = (int)threadIdx.x < rows * q_n && row < r1;
  const int ks = live ? __ldg(row_ptr + row) : 0;
  const int ke = live ? __ldg(row_ptr + row + 1) : 0;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for_each_chunk(cols, vals, __ldg(row_ptr + r0), __ldg(row_ptr + r1),
                 [&](const int* sc, const float* sv, int cb, int ce) {
    const int lo = max(ks, cb), hi = min(ke, ce);
    for (int k = lo; k < hi; ++k) {
      const float v = sv[k - cb];
      const float* xr = x + (size_t)sc[k - cb] * t + j0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (j0 + jj < t) acc[jj] = fmaf(v, __ldg(xr + jj), acc[jj]);
    }
  });
  if (live) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (j0 + jj < t) y[(size_t)row * t + j0 + jj] = acc[jj];
  }
}

extern "C" {

// Launches on `stream` (a cudaStream_t passed as void*) of card `device`
// and returns cudaGetLastError() of the launch; does not synchronise or
// allocate. The library links its own CUDA runtime, so the card is set here.
// cols and vals must be 16-byte aligned (cp.async); x takes the float4
// kernel at t = 12 when it is.
int prealps_block_ell_f32(const int* row_ptr, const int* cols,
                          const float* vals, const float* x, float* y, int n,
                          int t, int device, void* stream) {
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n < 1 || t < 1 || t > 4 * THREADS || ((uintptr_t)cols % 16) ||
      ((uintptr_t)vals % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool x16 = ((uintptr_t)x % 16) == 0;
  const dim3 block(THREADS);
  auto blocks_of = [n](int rows) { return dim3((n + rows - 1) / rows); };
  if (t == 1) {
    entries_t1<<<blocks_of(THREADS / T1_LANES), block, 0, st>>>(
        row_ptr, cols, vals, x, y, n);
  } else if (t == 12 && x16) {
    entries_t12<<<blocks_of(THREADS / 3), block, 0, st>>>(row_ptr, cols, vals,
                                                           x, y, n);
  } else {
    entries_generic<<<blocks_of(THREADS / ((t + 3) / 4)), block, 0, st>>>(
        row_ptr, cols, vals, x, y, n, t);
  }
  return (int)cudaGetLastError();
}

const char* prealps_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
