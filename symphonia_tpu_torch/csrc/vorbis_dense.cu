// Vorbis dense stage for Hopper (sm_90a): kernels V1 vorbis_imdct and V2
// vorbis_lap.
//
// V1 replaces symphonia_tpu/ops/vorbis_dense.py:21 _imdct_jax (K10):
//   Y[L, n] = X[L, n/2] . M^T,  M = imdct_matrix(n), [n, n/2] unscaled fp32,
// one launch per block size n (a power of two, 64..8192), over the
// packet-channel lanes of every stream with that block size.
// V1 computes half of that product, Z = X . M[n/4 : 3n/4]^T ([L, n/2]), on
// simt_gemm.cuh's tile (shared with A1 aac_imdct: 128 x 128 Z entries per
// 256-thread block, an 8 x 8 register tile a thread, 32-deep K slabs in a
// three-stage cp.async ring of 96 KB, true fp32 in K order, since the
// reference's parity bars leave no room for TF32), and writes the other
// half in the tile's mirrored epilogue: with h = n/4, y[h + j] = Z[j],
// y[h - 1 - j] = 0 - Z[j] (j < h), y[n + h - 1 - j] = Z[j] (j >= h).
// For n = 64..4096 the matrix satisfies that mirror exactly and V1 equals
// the dense product bit for bit. At n = 8192 it does not: 1618 of the
// matrix's 16.8M entries differ from their mirror by one ulp (2.98e-8), so
// there V1's output is the half product's, held to V1's bar (1e-6 of the
// larger of 1 and the peak, against the dense twin in chip_smoke.py), not
// to bits. n = 64 has 32 Z columns, below the 128-wide tile: the tile's
// column guard reads zeros past them and stores nothing there.
// What bounds V1: arithmetic while the half matrix stays in L2. At n = 2048
// a lane needs 1.05M multiply-adds (half the dense 2.1M) against 4 KB of
// spectrum and 8 KB of output, and the half matrix (4 MB) stays in the 50
// MB L2. At n = 8192 it is 64 MB, still beyond L2: the grid walks row tiles
// fastest, so the row tiles of one Z column tile (a 2 MB slice of M) run
// together and share its slice through L2; only when a wave holds fewer
// row tiles than the batch does a slice come from HBM again. Even then a
// block does 67M multiply-adds per 4 MB read, past the card's fp32 ridge
// (~20 flop/byte), so the kernel stays near its arithmetic bound.
//
// V2 vorbis_lap replaces the Vorbis lap of the driver's combined decode
// step (__graft_entry__.py:117-121, in K14): over V equal-size blocks of n1
// samples (V1's output t [V, n1]) with the window slope w [n1/2],
//   pcm[r, j] = ov[r, j] * w[n1/2 - 1 - j] + t[r, j] * w[j],  j < n1/2,
// where ov[r] = t[r - 1, n1/2:] and ov[0] = 0. One thread per output
// sample; each reads its lane's first half and the previous lane's second
// half, so no block waits for another. Bound by memory: each t row is read
// once as a whole (its halves by two lanes' threads), 4 B written per
// output. The reference rounds each product and the sum; nvcc would
// contract a * b + c into one fused multiply-add, so both products and the
// sum are explicit __fmul_rn / __fadd_rn and the kernel equals its twin bit
// for bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "simt_gemm.cuh"

namespace {

using simt_gemm::kBM;
using simt_gemm::kBN;
constexpr int kStages = 3;
constexpr int kSmem = simt_gemm::smem_bytes(kStages);

__global__ void __launch_bounds__(simt_gemm::kThreads, 2)
vorbis_imdct_kernel(const float* __restrict__ X, const float* __restrict__ M,
                    float* __restrict__ Y, int L, int n) {
  extern __shared__ __align__(16) float smem[];
  const int K = n / 2;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  const simt_gemm::Thread th;
  // B: rows col0.. of the half matrix M[K/2 : 3K/2].
  const simt_gemm::SlabCopy m(M + static_cast<int64_t>(K / 2) * K, K, col0,
                              K - col0);
  simt_gemm::RowsA load{simt_gemm::SlabCopy(X, K, row0, L - row0)};
  float acc[8][8] = {};
  simt_gemm::tile_product<kStages>(load, m, K, smem, th, acc);
  simt_gemm::store_mirrored(Y, acc, th, row0, L, col0, K);
}

constexpr int kLapThreads = 256;

__global__ void __launch_bounds__(kLapThreads)
vorbis_lap_kernel(const float* __restrict__ t, const float* __restrict__ w,
                  float* __restrict__ pcm, int64_t total, int h) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kLapThreads
                    + threadIdx.x;
  if (i >= total) return;
  const int64_t r = i / h;
  const int j = static_cast<int>(i - r * h);
  const float ov = r > 0 ? t[(2 * r - 1) * h + j] : 0.f;
  pcm[i] = __fadd_rn(__fmul_rn(ov, w[h - 1 - j]),
                     __fmul_rn(t[2 * r * h + j], w[j]));
}

}  // namespace

// Y [L, n] = X [L, n/2] . M^T with M the full [n, n/2] matrix (V1 reads
// its rows n/4 .. 3n/4 - 1); n a power of two in 64..8192.
extern "C" int vorbis_imdct_launch(const void* X, const void* M, void* Y,
                                   int L, int n, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  if (n < 64 || n > 8192 || (n & (n - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = simt_gemm::opt_in(vorbis_imdct_kernel, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((L + kBM - 1) / kBM),
                  static_cast<unsigned>((n / 2 + kBN - 1) / kBN));
  vorbis_imdct_kernel<<<grid, simt_gemm::kThreads, kSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const float*>(M),
      static_cast<float*>(Y), L, n);
  return static_cast<int>(cudaGetLastError());
}

// V1's registers, local bytes and blocks per SM (simt_gemm::attributes):
// out[3].
extern "C" int vorbis_imdct_attributes(int* out) {
  return simt_gemm::attributes(vorbis_imdct_kernel, kSmem, out);
}

// pcm [V, n1/2] = the lap of t [V, n1] (consecutive blocks of n1 samples)
// with the window slope w [n1/2]; n1 even.
extern "C" int vorbis_lap_launch(const void* T, const void* W, void* P,
                                 int64_t V, int n1, void* stream) {
  if (V <= 0) return static_cast<int>(cudaGetLastError());
  if (n1 < 2 || n1 % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int h = n1 / 2;
  const int64_t total = V * h;
  const int64_t blocks = (total + kLapThreads - 1) / kLapThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  vorbis_lap_kernel<<<static_cast<unsigned>(blocks), kLapThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T), static_cast<const float*>(W),
      static_cast<float*>(P), total, h);
  return static_cast<int>(cudaGetLastError());
}
