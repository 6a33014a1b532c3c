// AAC-LC dense stage for Hopper (sm_90a): kernels A1-A3. They replace the
// device programs of symphonia_tpu/ops/aac_dense.py.
//
// A1 aac_imdct replaces _dequant_imdct_long_jax (:87, K6) with its dequant
// prologue on, and _imdct_jax (:112, K7) with it off:
//   Y[L, 2n] = X[L, n] . M^T,  M the [2n, n] scaled IMDCT matrix,
// for n = 1024 (long-window frames, one row each) and n = 128 (the eight
// short windows of an EIGHT_SHORT frame, one row each). It computes half
// of that product, Z = X . M[n/2 : 3n/2]^T, on simt_gemm.cuh's tile (shared
// with V1 vorbis_imdct) and writes the other half in the tile's mirrored
// epilogue: y[n/2 + j] = Z[j], y[n/2 - 1 - j] = 0 - Z[j] (j < n/2) and
// y[5n/2 - 1 - j] = Z[j] (j >= n/2). Both AAC matrices satisfy that mirror
// exactly, so A1 equals the dense product bit for bit, signs of zero
// included (simt_gemm.cuh says why the negation is 0 - z).
// With the prologue on (n = 1024), a row r with deq[r] == 0 gets
//   X[r, k] = +-(pow43[min(|q|, 8191)] * scales[r, sfb_map[k]])
// from q = qbuf[r, k]; every other row is copied from X by cp.async. The
// choice is made per row, never by multiplying with a mask: rows with deq
// != 0 carry stale qbuf and scales whose product can overflow, and 0 * inf
// is NaN. A handoff row's quants for the next slab are copied by cp.async
// with the next slab's operands, before the current slab's fmaf, and
// dequantized into the next stage after them, so their latency hides
// behind the product.
// What bounds A1: arithmetic, 1.05M multiply-adds per long row (half the
// dense 2.1M) against 4 KB of input and 8 KB of output (the half matrix, 4
// MB, stays in L2). The reference's bar (1e-5 on outputs near 0.12) needs
// true fp32, which the tensor cores do not offer (TF32 keeps ~10 mantissa
// bits), so A1 is a SIMT GEMM. The prologue's dequantization repeats once
// per 128-column tile of Z: 8 times at n = 1024 (16 times on the dense
// product). It gathers from the 32 KiB pow43 table and the sfb map, staged
// in shared memory once per block beside a two-stage ring and 8 KB of
// quants (108 KB a block); without the prologue the ring has three stages
// (96 KB). Two blocks fit on an SM either way.
//
// A2 aac_dequant replaces _dequant_jax (:51, K9): the prologue alone,
// written out as [L, 1024] coefficients. It is the same device function
// (dequant_one); it reads the table through the read-only cache. Bound by
// memory: 2 B of qbuf and 4 B of coeffs in, 4 B out per coefficient.
//
// The row map (A1 and A2). The reference's step (__graft_entry__.py:62,
// K14) computes both IMDCTs over every lane and selects per lane; the
// port computes each lane's own. Its entry step sorts the lanes on the
// device, long ones first, and hands A1 that index with the count of long
// lanes and, reversed, with the count of short ones, both device scalars:
// no count reaches the host, nothing is gathered into a new buffer and
// nothing scattered back. A1's block keeps its 128 tile rows' operand rows
// in shared memory (simt_gemm.cuh's fill_row_map, MappedSlabCopy,
// store_mapped); a lane is one row at n = 1024 and eight at n = 128 (its
// short windows in the [8A, 128] view of the coefficients and the [8A,
// 256] view of the output). A block past the count returns before its
// first copy. A2 reads its rows through the same index and writes each of
// them, dequantized where deq == 0 and copied where not: the short IMDCT
// then reads every short lane from A2's output, one source, and the
// caller's coefficients stay as they were. That copy moves what the
// gather it replaces moved.
//
// A3 aac_ola replaces _ola_jax (:209, K8):
//   out[l, i] = head(l, i) + (l == 0 || first[l] ? 0 : delay(l - 1, i))
// over pcm [L, 2048] (short frames hold their 8 x 256 windows flattened).
// head and delay are frame-local window products selected by (seq, shape,
// prev_shape); for EIGHT_SHORT frames they are slices of the in-frame 8 x
// 256 overlap-add at hop 128, where each position sums at most two windows.
// A block does not wait for lane l-1's block: it recomputes delay(l - 1, .)
// from pcm[l - 1], so there is no carried state and no order between
// blocks, and one launch covers many sequences (first[l] marks where one
// starts). Bound by memory: a lane's head takes one half of its pcm row
// and the next lane's delay the other half (long lanes: p[0:1024] and
// p[1024:2048]; short lanes: positions 0-575 and 576-1151 of the in-frame
// sum), so every pcm element is read once, 8 KB a lane, and 4 KB written.
// The first kernel made one output a thread: each thread loaded up to
// seven per-lane scalars before it knew which words to load, then moved
// 4-byte words, about eleven load instructions for four bytes of output;
// instruction count and latency, not traffic, held it under half of the
// bytes bound. This kernel gives a lane one 256-thread block: the lane's
// and its predecessor's scalars are loaded once a thread, all seven at
// once, and the choice of path (long or short, which table rows) is the
// block's; a thread makes four consecutive outputs from 16-byte loads of
// pcm and of the window rows and one 16-byte store. Every region edge (448,
// 576, the 128-sample hop) is a multiple of four, so a group of four never
// straddles a region or a short window. The reference asserts K8 bit for
// bit against the sequential chain, and nvcc contracts a * b + c into one
// fused multiply-add by default, which rounds once instead of twice: every
// product and sum here is an explicit __fmul_rn / __fadd_rn, in the
// reference's order.

#include <cstdint>
#include <type_traits>
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
constexpr int kStagesPlain = 3;
constexpr int kStagesDeq = 2;  // the tables and quants take a stage's room
constexpr int kSmemPlain = simt_gemm::smem_bytes(kStagesPlain);
// The ring, then pow43, sfb_map and four 8-byte quant slots a thread.
constexpr int kSmemDeq = simt_gemm::smem_bytes(kStagesDeq) + kPow43 * 4 +
                         kLong * 4 + 4 * kThreads * 8;
// Through a row map a block also keeps its 128 tile rows' operand rows, at
// the end of its shared memory.
constexpr int kMapBytes = kBM * 4;
template <bool kDeq, bool kMapped>
constexpr int kSmem = (kDeq ? kSmemDeq : kSmemPlain) + (kMapped ? kMapBytes
                                                                : 0);

// The prologue's A slab: a handoff row (deq == 0) is dequantized from its
// quants, any other row is copied from X. start() copies the X rows, and
// the handoff rows' quants into this thread's own slots of a small shared
// buffer, by cp.async; finish(), called after the current slab's fmaf,
// waits for them, gathers their scales and dequantizes them into the
// stage. Nothing of the prologue stays in registers across the fmaf: at
// the 128 registers that two blocks an SM leave a thread, even the eight
// of four prefetched quants made ptxas spill inside the product. Copy is
// SlabCopy (slot s is row r0 + 32 s) or MappedSlabCopy (slot s's row is
// the block's map entry, read from shared memory where it is used).
template <class Copy>
struct DequantA {
  static constexpr bool kMapped =
      !std::is_same<Copy, simt_gemm::SlabCopy>::value;
  Copy x;
  const int16_t* __restrict__ qbuf;
  const float* __restrict__ scales;
  const int32_t* sfb;              // shared memory
  const float* pow43;              // shared memory
  short4* quants;                  // shared memory: slot s at [s * kThreads]
  int r0;                          // slot 0's row (SlabCopy)
  unsigned handoff;                // bit s: slot s's row hands off

  __device__ __forceinline__ int row(int s) const {
    if constexpr (kMapped) return x.row(s);
    else return r0 + 32 * s;
  }

  __device__ __forceinline__ bool valid(int s) const {
    if constexpr (kMapped) return x.row(s) >= 0;
    else return s < x.slots;
  }

  __device__ __forceinline__ void start(float* tile, int k0) {
    const int k = k0 + 4 * (threadIdx.x & 7);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (handoff >> s & 1u)
        simt_gemm::cp_async8(quants + s * kThreads,
                             qbuf + static_cast<int64_t>(row(s)) * kLong + k);
      else
        x.start_one(tile, k0, s);
    }
  }

  __device__ __forceinline__ void finish(float* tile, int k0) {
    simt_gemm::cp_async_wait<0>();  // this thread's quants have landed
    const int k = k0 + 4 * (threadIdx.x & 7);
    const int b0 = sfb[k], b1 = sfb[k + 1], b2 = sfb[k + 2], b3 = sfb[k + 3];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!(handoff >> s & 1u)) continue;
      const short4 q = quants[s * kThreads];
      const float* r = scales + static_cast<int64_t>(row(s)) * kSfbs;
      *reinterpret_cast<float4*>(x.slot_dst(tile, s)) = make_float4(
          dequant_one(q.x, r[b0], pow43), dequant_one(q.y, r[b1], pow43),
          dequant_one(q.z, r[b2], pow43), dequant_one(q.w, r[b3], pow43));
    }
  }
};

// acc += A . M_half^T over K = n for this block's A rows, read by x (the
// contiguous SlabCopy or the row map's MappedSlabCopy); with kDeq the
// handoff rows are dequantized on the way in. r0 is slot 0's row for a
// SlabCopy. The caller has filled the map, if any; the first barrier here
// publishes it with the tables.
template <bool kDeq, class Copy>
__device__ __forceinline__ void imdct_product(
    const Copy& x, int r0, const simt_gemm::SlabCopy& m,
    const int16_t* __restrict__ qbuf, const float* __restrict__ scales,
    const int32_t* __restrict__ deq, const int32_t* __restrict__ sfb_map,
    const float* __restrict__ pow43_g, int n, float* smem,
    const simt_gemm::Thread& th, float (&acc)[8][8]) {
  constexpr bool kMapped = DequantA<Copy>::kMapped;
  if constexpr (kDeq) {
    float* pow43 = smem + simt_gemm::smem_bytes(kStagesDeq) / 4;
    int32_t* sfb = reinterpret_cast<int32_t*>(pow43 + kPow43);
    short4* quants = reinterpret_cast<short4*>(sfb + kLong);
    for (int i = threadIdx.x; i < kPow43; i += kThreads) pow43[i] = pow43_g[i];
    for (int i = threadIdx.x; i < kLong; i += kThreads) sfb[i] = sfb_map[i];
    __syncthreads();  // the first slabs dequantize before the K loop
    DequantA<Copy> load{x, qbuf, scales, sfb, pow43, quants + threadIdx.x,
                        r0, 0u};
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (load.valid(s) && deq[load.row(s)] == 0) load.handoff |= 1u << s;
    simt_gemm::tile_product<kStagesDeq>(load, m, n, smem, th, acc);
  } else if constexpr (kMapped) {
    __syncthreads();  // the map
    simt_gemm::MappedRowsA load{x};
    simt_gemm::tile_product<kStagesPlain>(load, m, n, smem, th, acc);
  } else {
    simt_gemm::RowsA load{x};
    simt_gemm::tile_product<kStagesPlain>(load, m, n, smem, th, acc);
  }
}

// Two blocks an SM: ptxas keeps a thread within 128 registers.
// kMapped: the block's 128 tile rows are the lanes rows[0 .. *n_rows),
// group operand rows a lane (simt_gemm::fill_row_map); a block at or past
// the end returns before its first copy, so the count stays on the device
// and the grid is sized by the index's length. Otherwise rows row0.. of X
// and Y, before L.
template <bool kDeq, bool kMapped>
__global__ void __launch_bounds__(kThreads, 2)
aac_imdct_kernel(const float* __restrict__ X, const float* __restrict__ M,
                 const int16_t* __restrict__ qbuf,
                 const float* __restrict__ scales,
                 const int32_t* __restrict__ deq,
                 const int32_t* __restrict__ sfb_map,
                 const float* __restrict__ pow43_g, float* __restrict__ Y,
                 int L, int n, const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ n_rows, int group) {
  extern __shared__ __align__(16) float smem[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  const simt_gemm::Thread th;
  // B: rows col0.. of the half matrix M[n/2 : 3n/2].
  const simt_gemm::SlabCopy m(M + static_cast<int64_t>(n / 2) * n, n, col0,
                              n - col0);
  float acc[8][8] = {};
  if constexpr (kMapped) {
    const int end = group * __ldg(n_rows);
    if (row0 >= end) return;
    int* map = reinterpret_cast<int*>(
        smem + (kSmem<kDeq, true> - kMapBytes) / 4);
    simt_gemm::fill_row_map(map, static_cast<int>(row0), end, rows, group);
    const simt_gemm::MappedSlabCopy x(X, n, map);
    imdct_product<kDeq>(x, 0, m, qbuf, scales, deq, sfb_map, pow43_g, n,
                        smem, th, acc);
    simt_gemm::store_mapped(Y, acc, th, map, col0, n);
  } else {
    const simt_gemm::SlabCopy x(X, n, row0, L - row0);
    // This thread's copy slots s: rows r0 + 32 s (L < 2^31 rows).
    imdct_product<kDeq>(x, static_cast<int>(row0) + (threadIdx.x >> 3), m,
                        qbuf, scales, deq, sfb_map, pow43_g, n, smem, th,
                        acc);
    simt_gemm::store_mirrored(Y, acc, th, row0, L, col0, n);
  }
}

template <bool kDeq, bool kMapped>
cudaError_t launch_imdct(dim3 grid, cudaStream_t st, const void* X,
                         const void* M, const void* qbuf, const void* scales,
                         const void* deq, const void* sfb_map,
                         const void* pow43, void* Y, int L, int n,
                         const void* rows, const void* n_rows, int group) {
  constexpr int smem = kSmem<kDeq, kMapped>;
  const cudaError_t e =
      simt_gemm::opt_in(aac_imdct_kernel<kDeq, kMapped>, smem);
  if (e != cudaSuccess) return e;
  aac_imdct_kernel<kDeq, kMapped><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(X), static_cast<const float*>(M),
      static_cast<const int16_t*>(qbuf), static_cast<const float*>(scales),
      static_cast<const int32_t*>(deq), static_cast<const int32_t*>(sfb_map),
      static_cast<const float*>(pow43), static_cast<float*>(Y), L, n,
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(n_rows),
      group);
  return cudaGetLastError();
}

template <bool kDeq, bool kMapped>
int imdct_attributes(int* out) {
  return simt_gemm::attributes(aac_imdct_kernel<kDeq, kMapped>,
                               kSmem<kDeq, kMapped>, out);
}

// ----- A2 -------------------------------------------------------------

__global__ void aac_dequant_kernel(const float* __restrict__ coeffs,
                                   const int16_t* __restrict__ qbuf,
                                   const float* __restrict__ scales,
                                   const int32_t* __restrict__ deq,
                                   const int32_t* __restrict__ sfb_map,
                                   const float* __restrict__ pow43,
                                   float* __restrict__ out, int64_t total,
                                   const int32_t* __restrict__ rows,
                                   const int32_t* __restrict__ n_rows) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int64_t r = idx / kLong;
  const int k = static_cast<int>(idx - r * kLong);
  // Through the index: entry r names the row; entries at or past *n_rows
  // do nothing.
  if (rows != nullptr) {
    if (r >= __ldg(n_rows)) return;
    r = __ldg(rows + r);
  }
  const int64_t i = r * kLong + k;
  out[i] = deq[r] == 0
               ? dequant_one(qbuf[i], __ldg(scales + r * kSfbs +
                                            __ldg(sfb_map + k)),
                             pow43)
               : coeffs[i];
}

// ----- A3 -------------------------------------------------------------

constexpr int kOlaThreads = 256;  // four outputs each: one lane a block
static_assert(kOlaThreads * 4 == kLong, "a block covers a lane");
static_assert(kOlaThreads == simt_gemm::kThreads, "attributes' block");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 mul4(const float4& a, const float4& b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// Positions j .. j + 3 (j % 4 == 0) in [0, 1152) of an EIGHT_SHORT frame's
// in-frame overlap-add: window k = j / 128 contributes its left half,
// window k - 1 its right half, summed right + left as the reference's
// accumulation does. The four share k.
__device__ __forceinline__ float4 short_sum4(const float* __restrict__ p,
                                             int j, const float* lw0,
                                             const float* lw,
                                             const float* rw) {
  const int k = j >> 7, t = j & 127;
  if (k == 0)
    return add4(make_float4(0.f, 0.f, 0.f, 0.f),
                mul4(load4(p + t), load4(lw0 + t)));
  const float4 right = mul4(load4(p + (k - 1) * 256 + 128 + t), load4(rw + t));
  if (k == 8) return right;
  return add4(right, mul4(load4(p + k * 256 + t), load4(lw + t)));
}

__global__ void __launch_bounds__(kOlaThreads) aac_ola_kernel(
    const float* __restrict__ pcm, const int32_t* __restrict__ seqs,
    const int32_t* __restrict__ shapes,
    const int32_t* __restrict__ prev_shapes,
    const uint8_t* __restrict__ first, const float* __restrict__ head_t,
    const float* __restrict__ delay_t, const float* __restrict__ s_first,
    const float* __restrict__ s_left, const float* __restrict__ s_right,
    float* __restrict__ out) {
  const int64_t l = blockIdx.x;
  const int i = 4 * threadIdx.x;
  // The lane's scalars and its predecessor's (lane 0 reads its own twice
  // and uses none of them): seven independent loads, the same for every
  // thread of the block. window_sequence is a 2-bit field of the bitstream.
  const int64_t q = l > 0 ? l - 1 : 0;
  const int seq = __ldg(seqs + l) & 3;
  const int shape = __ldg(shapes + l) != 0;
  const int prev = __ldg(prev_shapes + l) != 0;
  const bool linked = __ldg(first + l) == 0 && l > 0;
  const int qseq = __ldg(seqs + q) & 3;
  const int qshape = __ldg(shapes + q) != 0;
  const int qprev = __ldg(prev_shapes + q) != 0;

  // head(l, i .. i + 3)
  const float* p = pcm + l * 2048;
  float4 head;
  if (seq == kEightShort) {
    head = i < kP0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                   : short_sum4(p, i - kP0, s_first + prev * 128,
                                s_left + shape * 128, s_right + shape * 128);
  } else {
    head = mul4(load4(p + i), load4(head_t + (seq * 2 + prev) * kLong + i));
  }

  // delay(l - 1, i .. i + 3): lane l-1's tail, zero where a sequence starts.
  float4 delay = make_float4(0.f, 0.f, 0.f, 0.f);
  if (linked) {
    const float* pq = pcm + q * 2048;
    if (qseq == kEightShort) {
      if (i < kP1)
        delay = short_sum4(pq, kP1 + i, s_first + qprev * 128,
                           s_left + qshape * 128, s_right + qshape * 128);
    } else {
      delay = mul4(load4(pq + kLong + i),
                   load4(delay_t + (qseq * 2 + qshape) * kLong + i));
    }
  }
  *reinterpret_cast<float4*>(out + l * kLong + i) = add4(head, delay);
}

int launch_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Y [L, 2n] = X [L, n] . M^T with M the full [2n, n] matrix (A1 reads its
// rows n/2 .. 3n/2 - 1); qbuf == nullptr turns the dequant prologue off
// (then scales, deq, sfb_map and pow43 are unused). n % 32 == 0, and
// n == 1024 with the prologue. rows == nullptr: every row of X and Y.
// Otherwise only the rows of the lanes rows[0 .. *n_rows) (rows int32 [R],
// n_rows one int32, both on the device, *n_rows <= R): lane l is rows
// group * l .. group * l + group - 1 of X and of Y, the grid covers R
// lanes, and no other row of Y is written; group == 1 with the prologue.
extern "C" int aac_imdct_launch(const void* X, const void* M,
                                const void* qbuf, const void* scales,
                                const void* deq, const void* sfb_map,
                                const void* pow43, void* Y, int L, int n,
                                const void* rows, const void* n_rows, int R,
                                int group, void* stream) {
  const bool mapped = rows != nullptr;
  const int64_t tiles = mapped ? static_cast<int64_t>(R) * group : L;
  if (tiles <= 0) return launch_error();
  if (n <= 0 || n % kBK != 0 || (qbuf != nullptr && n != kLong) ||
      mapped != (n_rows != nullptr) || group < 1 ||
      (qbuf != nullptr && group != 1) || tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((tiles + kBM - 1) / kBM),
                  static_cast<unsigned>((n + kBN - 1) / kBN));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto f = qbuf != nullptr ? (mapped ? &launch_imdct<true, true>
                                           : &launch_imdct<true, false>)
                                 : (mapped ? &launch_imdct<false, true>
                                           : &launch_imdct<false, false>);
  return static_cast<int>(f(grid, st, X, M, qbuf, scales, deq, sfb_map,
                            pow43, Y, L, n, rows, n_rows, group));
}

// A1's registers, local bytes and blocks per SM (simt_gemm::attributes):
// out[3]. variant bit 0: the dequant prologue; bit 1: the row map.
extern "C" int aac_imdct_attributes(int variant, int* out) {
  switch (variant & 3) {
    case 0: return imdct_attributes<false, false>(out);
    case 1: return imdct_attributes<true, false>(out);
    case 2: return imdct_attributes<false, true>(out);
    default: return imdct_attributes<true, true>(out);
  }
}

// out [L, 1024]: the dequantized quants where deq == 0, coeffs elsewhere.
// rows == nullptr: every row. Otherwise only the rows rows[0 .. *n_rows)
// (rows int32 [R], n_rows one int32, on the device; the grid covers R
// rows), and no other row of out is written.
extern "C" int aac_dequant_launch(const void* coeffs, const void* qbuf,
                                  const void* scales, const void* deq,
                                  const void* sfb_map, const void* pow43,
                                  void* out, int L, const void* rows,
                                  const void* n_rows, int R, void* stream) {
  const bool mapped = rows != nullptr;
  if (mapped != (n_rows != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(mapped ? R : L) * kLong;
  if (total <= 0) return launch_error();
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  aac_dequant_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const int16_t*>(qbuf),
      static_cast<const float*>(scales), static_cast<const int32_t*>(deq),
      static_cast<const int32_t*>(sfb_map), static_cast<const float*>(pow43),
      static_cast<float*>(out), total, static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(n_rows));
  return launch_error();
}

// pcm [L, 2048] -> out [L, 1024]; pcm, out and the five tables 16-byte
// aligned.
extern "C" int aac_ola_launch(const void* pcm, const void* seqs,
                              const void* shapes, const void* prev_shapes,
                              const void* first, const void* head_t,
                              const void* delay_t, const void* s_first,
                              const void* s_left, const void* s_right,
                              void* out, int L, void* stream) {
  if (L <= 0) return launch_error();
  aac_ola_kernel<<<static_cast<unsigned>(L), kOlaThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pcm), static_cast<const int32_t*>(seqs),
      static_cast<const int32_t*>(shapes),
      static_cast<const int32_t*>(prev_shapes),
      static_cast<const uint8_t*>(first), static_cast<const float*>(head_t),
      static_cast<const float*>(delay_t), static_cast<const float*>(s_first),
      static_cast<const float*>(s_left), static_cast<const float*>(s_right),
      static_cast<float*>(out));
  return launch_error();
}

// A3's registers, local bytes and blocks per SM (simt_gemm::attributes):
// out[3].
extern "C" int aac_ola_attributes(int* out) {
  return simt_gemm::attributes(aac_ola_kernel, 0, out);
}
