// True-fp32 SIMT GEMM tile for Hopper (sm_90a), shared by A1 aac_imdct
// (aac_dense.cu) and V1 vorbis_imdct (vorbis_dense.cu):
//   Y[L, N] = A[L, K] . M[N, K]^T,  M row-major (one row per output column).
// One 256-thread block computes a 64 x 128 output tile. K runs in 32-deep
// slabs of A and M, staged transposed in odd-strided (conflict-free) shared
// memory; each thread keeps a 4 x 8 register tile and adds one fmaf per
// product in K order, the order of a plain sequential dot product. On the
// card cuBLAS's fp32 product was seen to match it bit for bit at these
// shapes; the CPU's summation order depends on the row count, so a CPU twin
// gets a fixed order only by running fixed-size row blocks (vorbis_dense.py's
// CPU_ROWS), and is held to a tolerance, not to bits. The tensor cores offer
// TF32 at best, which the reference's bars do not allow.
// Shapes: K % 32 == 0 and N % 4 == 0; columns at or past N read zeros and
// are not stored, so N may be below the 128-wide tile. A, M and Y must be
// 16-byte aligned. How A's rows are read is the caller's (the ALoad functor:
// A1 dequantizes the entropy stage's handoff rows there).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace simt_gemm {

constexpr int kThreads = 256;
constexpr int kBM = 64;         // output rows per block
constexpr int kBN = 128;        // output columns per block
constexpr int kBK = 32;         // K slab
constexpr int kAPad = kBM + 1;  // odd strides: the transposing stores
constexpr int kBPad = kBN + 1;  // below hit 32 distinct banks
constexpr int kSlabFloats = kBK * kAPad + kBK * kBPad;

// A read straight from a row-major [L, K] array.
struct RowsA {
  const float* __restrict__ X;
  int K;
  __device__ __forceinline__ float4 operator()(int /*slot*/, int64_t row,
                                               int k) const {
    return *reinterpret_cast<const float4*>(X + row * K + k);
  }
};

// This thread loads float4 number (tid + s * 256) of each 64 x 32 A slab:
// tile row (tid + s * 256) / 8, columns 4 * ((tid + s * 256) % 8) + 0..3.
// rows[s] is that row's index in A, -1 past the last row (zeros).
__device__ __forceinline__ void a_rows(int64_t row0, int64_t L,
                                       int64_t (&rows)[2]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int64_t r = row0 + ((threadIdx.x + s * kThreads) >> 3);
    rows[s] = r < L ? r : -1;
  }
}

// acc += the tile's product over K; load_a(s, rows[s], k) gives A[rows[s],
// k..k+3]. As and Bs hold kBK * kAPad and kBK * kBPad floats.
template <class ALoad>
__device__ __forceinline__ void tile_product(
    const ALoad& load_a, const int64_t (&rows)[2],
    const float* __restrict__ M, int K, int N, int col0, float* As,
    float* Bs, float (&acc)[4][8]) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const float* m_base = M + static_cast<int64_t>(col0) * K;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous slab has been read
#pragma unroll
    for (int s = 0; s < 2; ++s) {  // A: 64 rows x 8 float4
      const int f = tid + s * kThreads;
      const int m = f >> 3, kq = f & 7;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (rows[s] >= 0) v = load_a(s, rows[s], k0 + kq * 4);
      As[(kq * 4 + 0) * kAPad + m] = v.x;
      As[(kq * 4 + 1) * kAPad + m] = v.y;
      As[(kq * 4 + 2) * kAPad + m] = v.z;
      As[(kq * 4 + 3) * kAPad + m] = v.w;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {  // B: 128 rows of M x 8 float4
      const int f = tid + s * kThreads;
      const int c = f >> 3, kq = f & 7;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col0 + c < N)
        v = *reinterpret_cast<const float4*>(
            m_base + static_cast<int64_t>(c) * K + k0 + kq * 4);
      Bs[(kq * 4 + 0) * kBPad + c] = v.x;
      Bs[(kq * 4 + 1) * kBPad + c] = v.y;
      Bs[(kq * 4 + 2) * kBPad + c] = v.z;
      Bs[(kq * 4 + 3) * kBPad + c] = v.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * kAPad + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk * kBPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Y[r, col] = acc for this thread's rows r < L and columns col < N.
__device__ __forceinline__ void store_tile(float* __restrict__ Y,
                                           const float (&acc)[4][8],
                                           int64_t row0, int64_t L, int col0,
                                           int N) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + ty * 4 + i;
    if (r >= L) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < N) Y[r * N + col] = acc[i][j];
    }
  }
}

}  // namespace simt_gemm
