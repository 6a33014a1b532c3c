// AAC-LC dense stage for Hopper (sm_90a): kernels A1-A3. They replace the
// device programs of symphonia_tpu/ops/aac_dense.py.
//
// A1 aac_imdct replaces _dequant_imdct_long_jax (:87, K6) with its dequant
// prologue on, and _imdct_jax (:112, K7) with it off:
//   Y[L, 2n] = X[L, n] . M^T,  M the [2n, n] scaled IMDCT matrix,
// for n = 1024 (long-window frames, one row each) and n = 128 (the eight
// short windows of an EIGHT_SHORT frame, one row each). With the prologue
// on (n = 1024), the A-tile load of a row r with deq[r] == 0 builds
//   X[r, k] = +-(pow43[min(|q|, 8191)] * scales[r, sfb_map[k]])
// from q = qbuf[r, k]; every other row reads X itself. The choice is made
// per row, never by multiplying with a mask: rows with deq != 0 carry stale
// qbuf and scales whose product can overflow, and 0 * inf is NaN.
// What bounds A1: arithmetic, 2.1M multiply-adds per long row against 4 KB
// of input (the matrix, 8 MB, stays in L2). The reference's bar (1e-5 on
// outputs near 0.12) needs true fp32, which the tensor cores do not offer
// (TF32 keeps ~10 mantissa bits), so A1 is a SIMT GEMM as M2 is: the
// 64 x 128 tile of simt_gemm.cuh (shared with V1 vorbis_imdct), 32-deep K
// slabs staged transposed in odd-strided (conflict-free) shared memory, a
// 4 x 8 register tile per thread. The prologue gathers from the 32 KiB
// pow43 table and the sfb map, both staged in shared memory once per block.
//
// A2 aac_dequant replaces _dequant_jax (:51, K9): the prologue alone,
// written out as [L, 1024] coefficients. It is the same device function
// (dequant_one); it reads the table through the read-only cache. Bound by
// memory: 2 B of qbuf and 4 B of coeffs in, 4 B out per coefficient.
//
// A3 aac_ola replaces _ola_jax (:209, K8): one thread per output sample of
//   out[l, i] = head(l, i) + (l == 0 || first[l] ? 0 : delay(l - 1, i))
// over pcm [L, 2048] (short frames hold their 8 x 256 windows flattened).
// head and delay are frame-local window products selected by (seq, shape,
// prev_shape); for EIGHT_SHORT frames they are slices of the in-frame 8 x
// 256 overlap-add at hop 128, where each position sums at most two windows.
// A block does not wait for lane l-1's block: each thread recomputes
// delay(l - 1, i) from pcm[l - 1], so there is no carried state and no
// order between blocks, and one launch covers many sequences (first[l]
// marks where one starts). Bound by memory (8 KB of pcm read, 4 KB written
// per lane, twice-read rows hit L2). The reference asserts it bit for bit
// against the sequential chain, and nvcc contracts a * b + c into one fused
// multiply-add by default, which rounds once instead of twice: every
// product and sum here is an explicit __fmul_rn / __fadd_rn, in the
// reference's order.

#include <cstdint>
#include <cuda_runtime.h>

#include "simt_gemm.cuh"

namespace {

constexpr int kLong = 1024;      // long-window coefficients per frame
constexpr int kSfbs = 64;        // scale slots per frame
constexpr int kPow43 = 8192;     // |q|^(4/3) table entries
constexpr int kEightShort = 2;   // window_sequence of a short frame
constexpr int kP0 = 448;         // 512 - 64
constexpr int kP1 = 576;         // 512 + 64

// One dequantized coefficient: +-(pow43[min(|q|, 8191)] * scale). The
// product is one IEEE multiply, the sign flip exact, and the trailing +0.0
// turns -0.0 (a negative q in a band of scale 0) into +0.0, as
// native.aac_dequant_host does.
__device__ __forceinline__ float dequant_one(int q, float scale,
                                             const float* pow43) {
  const int mag = min(abs(q), kPow43 - 1);
  float v = __fmul_rn(pow43[mag], scale);
  if (q < 0) v = -v;
  return __fadd_rn(v, 0.f);
}

// ----- A1 -------------------------------------------------------------

using simt_gemm::kBK;
using simt_gemm::kBM;
using simt_gemm::kBN;
using simt_gemm::kThreads;
constexpr int kSmemPlain = simt_gemm::kSlabFloats * 4;
constexpr int kSmemDeq = kSmemPlain + kPow43 * 4 + kLong * 4;

// The prologue's A rows: a handoff row (deq == 0) is dequantized from its
// quants while it loads, any other row is read from X.
struct DequantA {
  const float* __restrict__ X;
  const int16_t* __restrict__ qbuf;
  const float* __restrict__ scales;
  const int32_t* sfb;   // shared memory
  const float* pow43;   // shared memory
  bool handoff[2];      // per load slot
  __device__ __forceinline__ float4 operator()(int s, int64_t row,
                                               int k) const {
    if (!handoff[s])
      return *reinterpret_cast<const float4*>(X + row * kLong + k);
    const short4 q = *reinterpret_cast<const short4*>(qbuf + row * kLong + k);
    const float* sc = scales + row * kSfbs;
    return make_float4(dequant_one(q.x, sc[sfb[k + 0]], pow43),
                       dequant_one(q.y, sc[sfb[k + 1]], pow43),
                       dequant_one(q.z, sc[sfb[k + 2]], pow43),
                       dequant_one(q.w, sc[sfb[k + 3]], pow43));
  }
};

template <bool kDeq>
__global__ void __launch_bounds__(kThreads)
aac_imdct_kernel(const float* __restrict__ X, const float* __restrict__ M,
                 const int16_t* __restrict__ qbuf,
                 const float* __restrict__ scales,
                 const int32_t* __restrict__ deq,
                 const int32_t* __restrict__ sfb_map,
                 const float* __restrict__ pow43_g, float* __restrict__ Y,
                 int L, int n) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = As + kBK * simt_gemm::kAPad;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  int64_t rows[2];
  simt_gemm::a_rows(row0, L, rows);
  float acc[4][8] = {};
  if constexpr (kDeq) {
    float* pow43 = Bs + kBK * simt_gemm::kBPad;
    int32_t* sfb = reinterpret_cast<int32_t*>(pow43 + kPow43);
    // Read after the first __syncthreads of the K loop.
    for (int i = threadIdx.x; i < kPow43; i += kThreads) pow43[i] = pow43_g[i];
    for (int i = threadIdx.x; i < kLong; i += kThreads) sfb[i] = sfb_map[i];
    const DequantA load{X, qbuf, scales, sfb, pow43,
                        {rows[0] >= 0 && deq[rows[0]] == 0,
                         rows[1] >= 0 && deq[rows[1]] == 0}};
    simt_gemm::tile_product(load, rows, M, n, 2 * n, col0, As, Bs, acc);
  } else {
    simt_gemm::tile_product(simt_gemm::RowsA{X, n}, rows, M, n, 2 * n, col0,
                            As, Bs, acc);
  }
  simt_gemm::store_tile(Y, acc, row0, L, col0, 2 * n);
}

// ----- A2 -------------------------------------------------------------

__global__ void aac_dequant_kernel(const float* __restrict__ coeffs,
                                   const int16_t* __restrict__ qbuf,
                                   const float* __restrict__ scales,
                                   const int32_t* __restrict__ deq,
                                   const int32_t* __restrict__ sfb_map,
                                   const float* __restrict__ pow43,
                                   float* __restrict__ out, int64_t total) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t r = idx / kLong;
  const int k = static_cast<int>(idx - r * kLong);
  out[idx] = deq[r] == 0
                 ? dequant_one(qbuf[idx], __ldg(scales + r * kSfbs +
                                                __ldg(sfb_map + k)),
                               pow43)
                 : coeffs[idx];
}

// ----- A3 -------------------------------------------------------------

// Position j in [0, 1152) of an EIGHT_SHORT frame's in-frame overlap-add:
// window k = j / 128 contributes its left half, window k - 1 its right
// half, summed right + left as the reference's accumulation does.
__device__ __forceinline__ float short_sum(const float* __restrict__ p,
                                           int j, const float* lw0,
                                           const float* lw,
                                           const float* rw) {
  const int k = j >> 7, t = j & 127;
  if (k == 0) return __fadd_rn(0.f, __fmul_rn(p[t], lw0[t]));
  const float right = __fmul_rn(p[(k - 1) * 256 + 128 + t], rw[t]);
  if (k == 8) return right;
  return __fadd_rn(right, __fmul_rn(p[k * 256 + t], lw[t]));
}

__global__ void aac_ola_kernel(
    const float* __restrict__ pcm, const int32_t* __restrict__ seqs,
    const int32_t* __restrict__ shapes,
    const int32_t* __restrict__ prev_shapes,
    const uint8_t* __restrict__ first, const float* __restrict__ head_t,
    const float* __restrict__ delay_t, const float* __restrict__ s_first,
    const float* __restrict__ s_left, const float* __restrict__ s_right,
    float* __restrict__ out, int64_t total) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t l = idx / kLong;
  const int i = static_cast<int>(idx - l * kLong);

  // head(l, i): window_sequence is a 2-bit field of the bitstream.
  const int seq = seqs[l] & 3;
  const int shape = shapes[l] != 0;
  const int prev = prev_shapes[l] != 0;
  const float* p = pcm + l * 2048;
  float head;
  if (seq == kEightShort) {
    head = i < kP0 ? 0.f
                   : short_sum(p, i - kP0, s_first + prev * 128,
                               s_left + shape * 128, s_right + shape * 128);
  } else {
    head = __fmul_rn(p[i], head_t[(seq * 2 + prev) * kLong + i]);
  }

  // delay(l - 1, i): lane l-1's tail, zero where a sequence starts.
  float delay = 0.f;
  if (l > 0 && first[l] == 0) {
    const int64_t q = l - 1;
    const int qseq = seqs[q] & 3;
    const int qshape = shapes[q] != 0;
    const float* pq = pcm + q * 2048;
    if (qseq == kEightShort) {
      if (i < kP1) {
        const int qprev = prev_shapes[q] != 0;
        delay = short_sum(pq, kP1 + i, s_first + qprev * 128,
                          s_left + qshape * 128, s_right + qshape * 128);
      }
    } else {
      delay = __fmul_rn(pq[kLong + i],
                        delay_t[(qseq * 2 + qshape) * kLong + i]);
    }
  }
  out[idx] = __fadd_rn(head, delay);
}

int launch_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Y [L, 2n] = X [L, n] . M^T; qbuf == nullptr turns the dequant prologue
// off (then scales, deq, sfb_map and pow43 are unused). n % 64 == 0, and
// n == 1024 with the prologue.
extern "C" int aac_imdct_launch(const void* X, const void* M,
                                const void* qbuf, const void* scales,
                                const void* deq, const void* sfb_map,
                                const void* pow43, void* Y, int L, int n,
                                void* stream) {
  if (L <= 0) return launch_error();
  if (n <= 0 || n % kBK != 0 || (2 * n) % kBN != 0 ||
      (qbuf != nullptr && n != kLong))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((L + kBM - 1) / kBM), 2 * n / kBN);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qbuf != nullptr) {
    // Above 48 KB, dynamic shared memory needs the opt-in.
    const cudaError_t e = cudaFuncSetAttribute(
        aac_imdct_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemDeq);
    if (e != cudaSuccess) return static_cast<int>(e);
    aac_imdct_kernel<true><<<grid, kThreads, kSmemDeq, st>>>(
        static_cast<const float*>(X), static_cast<const float*>(M),
        static_cast<const int16_t*>(qbuf), static_cast<const float*>(scales),
        static_cast<const int32_t*>(deq),
        static_cast<const int32_t*>(sfb_map),
        static_cast<const float*>(pow43), static_cast<float*>(Y), L, n);
  } else {
    aac_imdct_kernel<false><<<grid, kThreads, kSmemPlain, st>>>(
        static_cast<const float*>(X), static_cast<const float*>(M), nullptr,
        nullptr, nullptr, nullptr, nullptr, static_cast<float*>(Y), L, n);
  }
  return launch_error();
}

extern "C" int aac_dequant_launch(const void* coeffs, const void* qbuf,
                                  const void* scales, const void* deq,
                                  const void* sfb_map, const void* pow43,
                                  void* out, int L, void* stream) {
  const int64_t total = static_cast<int64_t>(L) * kLong;
  if (total <= 0) return launch_error();
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  aac_dequant_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const int16_t*>(qbuf),
      static_cast<const float*>(scales), static_cast<const int32_t*>(deq),
      static_cast<const int32_t*>(sfb_map), static_cast<const float*>(pow43),
      static_cast<float*>(out), total);
  return launch_error();
}

extern "C" int aac_ola_launch(const void* pcm, const void* seqs,
                              const void* shapes, const void* prev_shapes,
                              const void* first, const void* head_t,
                              const void* delay_t, const void* s_first,
                              const void* s_left, const void* s_right,
                              void* out, int L, void* stream) {
  const int64_t total = static_cast<int64_t>(L) * kLong;
  if (total <= 0) return launch_error();
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  aac_ola_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pcm), static_cast<const int32_t*>(seqs),
      static_cast<const int32_t*>(shapes),
      static_cast<const int32_t*>(prev_shapes),
      static_cast<const uint8_t*>(first), static_cast<const float*>(head_t),
      static_cast<const float*>(delay_t), static_cast<const float*>(s_first),
      static_cast<const float*>(s_left), static_cast<const float*>(s_right),
      static_cast<float*>(out), total);
  return launch_error();
}
