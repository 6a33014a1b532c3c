// MPEG audio dense stages for Hopper (sm_90a): kernels M1 and M2 (Layer
// III) and L1 (Layer I/II). M1 and M2 together replace
// symphonia_tpu/ops/mp3_dense.py:346 mp3_dense_batch_jax (K5), its
// polyphase product included; L1 replaces :273 l12_dense_batch_jax (K11).
//
// M1 mp3_hybrid (steps 1-4 of the reference, plus the operand layout of
// step 5): for each (granule g, channel c) of x [G, C, 576] (sample index
// k*18 + j for subband k, line j):
//   1. antialias butterflies at 31, 1 or 0 subband boundaries (block type
//      and mixed flag);
//   2. per-subband 36x18 hybrid IMDCT with the block type's matrix (mixed
//      short blocks: subbands 0-1 long, the rest short);
//   3. overlap-add of the first 18 outputs with granule g-1's last 18
//      (zero where boundary[g]; the carried tail0 at g = 0);
//   4. frequency inversion: times finv[k][j] (+-1, the reference's table);
//   5. write S[g, c, t*32 + k], the polyphase product's operand layout.
// The tail of granule G-1 goes to tail_out. Blocks run in no order, so a
// block does not wait for g-1's block: it recomputes g-1's IMDCT tail from
// x[g-1] (antialiased with g-1's own block type). That doubles a cheap
// step (18 MACs per output) instead of adding a pass and a scratch array.
// What bounds M1: memory traffic (read 2 x 576 and write 576 floats per
// granule-channel, 36-54 MACs per output); the hybrid matrices (10 KB)
// are staged once per block in shared memory and the block walks over
// several granule-channels. Granule-major, channel-minor layout with one
// granule-channel per block iteration keeps every load and store
// coalesced (the reference's granule-minor layout was for TPU lanes).
//
// M2 mp3_synth (steps 5-6) and L1 mpa_l12_synth (which replaces
// symphonia_tpu/ops/mp3_dense.py:273 l12_dense_batch_jax, K11) are one
// body, synth_kernel<T>, for T subband samples per granule or frame: 18
// (Layer III granules, M2), 12 (Layer I frames) and 36 (Layer II frames).
// The reference multiplies each frame by its dense combined polyphase
// matrix [(T + 15) * 32, 32T] (_polyphase_combined_matrix(T)), shaped for
// the TPU's matrix unit. That matrix is block-banded with repeating
// blocks, so the kernel computes the same function in factored form, as
// the reference's host oracle (polyphase_response_np) does, over the
// stream of slots (one slot = 32 subband samples) of one channel:
//   matrixing  V[x][q] = sum_k N[q][k] S[x][k]       (N [64, 32])
//   FIR        y[x][i] = sum_j W[j][i] V[x - j][i + 32 (j & 1)]
//                                                     (W [16, 32], j < 16)
// Output slot m of frame g takes taps whose source slot lies in frames g,
// g - 1, .. g - KS (KS = ceil(480 / 32T): 1 for T = 18 and 36, 2 for
// T = 12). term_k, the sum of the taps from frame g - k in increasing tap
// order, is kept apart, and
//   pcm[g, p] = term_0 + prev(g, p),  prev = term_1 + ... + term_KS
//   term_k    = the taps' sum  if 0 <= g - k < F (and, for M2, !boundary[g])
//             = tail0[c, gn + p] if g - k == -1 and gn + p < 480
//             = 0                 otherwise,
// where n = 32T, p = 32m + i, and term_k exists only where its first tap
// is below 16 (kn + p < n + 480): the carried tail0 stands in for all the
// frames before the call, and tail0 is not used where boundary[0]. The
// outgoing tail comes from KS virtual frames F .. F + KS - 1 with no
// samples of their own:
//   tail_out[c, (g - F) n + p] = prev(g, p)  for (g - F) n + p < 480.
// V of a slot comes from one loop whichever block computes it, and prev
// sums the terms in one order, so a stream chained over calls adds the
// very bits one call adds. With F = 1 at Layer I the carried tail's last
// 96 samples pass into the outgoing tail as term_2 of virtual frame 1.
// N mirrors exactly in float32: N[32 - q] = -N[q] for q = 0..15 and
// N[96 - q] = N[q] for q = 33..47, so 33 rows are computed (0..16 and
// 33..48) and the other 31 written mirrored, the negated ones as
// __fsub_rn(0, v) (+0 for an exact zero). Every computed row but 16 (~1e-14,
// not 0) also folds exactly, N[q][31 - k] = (-1)^q N[q][k], so it takes
// 16 multiply-adds on the folded slot (S[k] + S[31 - k] for even q, the
// difference for odd); row 16 takes its 32.
// Work a frame-channel (M2): 18 slots x (32 x 16 + 32 + 16 x 32) = 19.0K
// multiply-adds, against 608K for the dense product, for 128T bytes of S
// read and as many of pcm written: the kernel is bound by memory, where
// the reference's product is bound by arithmetic.
// Design: a 256-thread block takes one channel and 144 consecutive output
// slots (8 granules at T = 18, 12 frames at T = 12, 4 at T = 36) plus the
// 15 slots before them (the FIR's halo, recomputed by the neighbouring
// block). (1) It stages their S by cp.async (16-byte copies of M2's
// slot-major rows; for L1, 4-byte copies from the bitstream stage's sb
// [F, C, 32, T] into their transposed places) and the 33 computed rows of
// N by coalesced loads (a lane loading its own rows from device memory
// touches 16 lines a load). (2) A thread a slot computes
// V's row 16 and folds its S in place. (3) The matrixing: lane l of a
// half-warp holds rows l and 48 - l (same parity) in registers and the
// two half-warps take two slots, so each shared-memory load (four banks:
// two slots, sum or difference) feeds two fmaf; V [159][72] is written to
// shared memory. (4) The FIR: a warp takes a run of output slots of one
// frame, lane i their sample i, W[.][i] in registers; walking the source
// slots from the last down, it reads each V[x][i] and V[x][i + 32] once
// for every output they feed, and since the outputs, taps and terms of a
// run are compile-time (the run's place in its frame is), each output
// sums its taps in increasing order into its term_k with no test at run
// time. True fp32 throughout (the reference's 2e-5 bar; the tensor cores
// offer TF32 at best).

#include <cstdint>
#include <cuda_runtime.h>

#include "simt_gemm.cuh"  // cp.async helpers, opt_in, attributes

namespace {

constexpr int kBlockShort = 2;
constexpr int kThreads = 576;  // M1: one thread per (line t, subband k)
constexpr int kXStride = 19;   // padded subband stride in shared memory

// Antialias butterflies in place on a [32][kXStride] shared buffer.
__device__ __forceinline__ void antialias(float* xs, int nb, const float* cs,
                                          const float* ca) {
  const int tid = threadIdx.x;
  if (tid < 31 * 8) {
    const int b = tid >> 3;  // boundary between subbands b and b+1
    const int i = tid & 7;
    if (b < nb) {
      float* plo = xs + b * kXStride + 17 - i;
      float* phi = xs + (b + 1) * kXStride + i;
      const float lo = *plo, hi = *phi;
      *plo = lo * cs[i] - hi * ca[i];
      *phi = hi * cs[i] + lo * ca[i];
    }
  }
}

__device__ __forceinline__ int n_bounds(int bt, bool mixed) {
  return bt == kBlockShort ? (mixed ? 1 : 0) : 31;
}

// Matrix index for subband k (hybrid_matrices() order), -1 for a block
// type outside 0..3 (the reference's one-hot selection then gives zero).
__device__ __forceinline__ int matrix_index(int bt, bool mixed, int k) {
  if (static_cast<unsigned>(bt) > 3u) return -1;
  if (bt != kBlockShort) return bt;
  return (mixed && k < 2) ? 0 : kBlockShort;
}

// sum_j T[m][row][j] * xs[k][j]
__device__ __forceinline__ float imdct_row(const float* T, int m, int row,
                                           const float* xs, int k) {
  if (m < 0) return 0.f;
  const float* tr = T + (m * 36 + row) * 18;
  const float* xr = xs + k * kXStride;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 18; ++j) acc = fmaf(tr[j], xr[j], acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
mp3_hybrid_kernel(const float* __restrict__ x, const int32_t* __restrict__ bt,
                  const uint8_t* __restrict__ mixed,
                  const uint8_t* __restrict__ boundary,
                  const float* __restrict__ tail0,
                  const float* __restrict__ T, const float* __restrict__ cs_g,
                  const float* __restrict__ ca_g,
                  const float* __restrict__ finv, float* __restrict__ S,
                  float* __restrict__ tail_out, int G, int C) {
  __shared__ float Ts[4 * 36 * 18];
  __shared__ float xcur[32 * kXStride];
  __shared__ float xprev[32 * kXStride];
  __shared__ float cs[8], ca[8];
  const int tid = threadIdx.x;
  for (int i = tid; i < 4 * 36 * 18; i += kThreads) Ts[i] = T[i];
  if (tid < 8) {
    cs[tid] = cs_g[tid];
    ca[tid] = ca_g[tid];
  }
  const int k = tid & 31;  // subband
  const int t = tid >> 5;  // line 0..17
  const float sign = finv[k * 18 + t];
  const int64_t pairs = static_cast<int64_t>(G) * C;
  for (int64_t p = blockIdx.x; p < pairs; p += gridDim.x) {
    const int g = static_cast<int>(p / C);
    const int c = static_cast<int>(p - static_cast<int64_t>(g) * C);
    const bool cut = boundary != nullptr && boundary[g] != 0;
    const bool has_prev = g > 0 && !cut;
    __syncthreads();  // Ts ready / previous iteration done with x buffers
    const int bt_c = bt[p];
    const bool mx_c = mixed[p] != 0;
    const float* xg = x + p * 576;
    xcur[(tid / 18) * kXStride + tid % 18] = xg[tid];
    int bt_p = 0;
    bool mx_p = false;
    if (has_prev) {
      const int64_t q = p - C;
      bt_p = bt[q];
      mx_p = mixed[q] != 0;
      xprev[(tid / 18) * kXStride + tid % 18] = x[q * 576 + tid];
    }
    __syncthreads();
    antialias(xcur, n_bounds(bt_c, mx_c), cs, ca);
    if (has_prev) antialias(xprev, n_bounds(bt_p, mx_p), cs, ca);
    __syncthreads();
    const int m_c = matrix_index(bt_c, mx_c, k);
    const float head = imdct_row(Ts, m_c, t, xcur, k);
    float prev;
    if (has_prev) {
      prev = imdct_row(Ts, matrix_index(bt_p, mx_p, k), 18 + t, xprev, k);
    } else if (g == 0 && !cut && tail0 != nullptr) {
      prev = tail0[(c * 32 + k) * 18 + t];
    } else {
      prev = 0.f;
    }
    S[p * 576 + t * 32 + k] = (head + prev) * sign;
    if (g == G - 1)
      tail_out[(c * 32 + k) * 18 + t] = imdct_row(Ts, m_c, 18 + t, xcur, k);
  }
}

// ----- M2 and L1 --------------------------------------------------------

constexpr int kSynthThreads = 256;
static_assert(kSynthThreads == simt_gemm::kThreads, "attributes' block");
constexpr int kSynthWarps = kSynthThreads / 32;
constexpr int kSlots = 144;   // output slots a block: 144 = 4 * lcm(12, 18, 36)
constexpr int kHalo = 15;     // FIR taps reaching back past the first slot
constexpr int kRows = kSlots + kHalo;  // staged slots
constexpr int kSStride = 36;  // S row stride: 16-byte rows
constexpr int kVStride = 72;  // V row stride (8 mod 32)
constexpr int kNRows = 33;    // computed rows of N: 0..16, 33..48
constexpr int kNStride = 33;  // odd: lanes reading 16 rows hit 16 banks
constexpr int kOla = 480;     // samples a frame's response reaches forward
constexpr int kMatPairs = 2;  // slot pairs a warp takes at once
// Shared memory: S [kRows][kSStride], V [kRows][kVStride], the computed
// rows of N [kNRows][kNStride] (3 blocks an SM).
constexpr int kSynthSmem =
    (kRows * (kSStride + kVStride) + kNRows * kNStride) * 4;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // src-size 0 writes a zero and reads nothing.
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Frames after its own that a frame's response reaches (KS).
template <int T>
constexpr int kSynthSteps = (kOla + 32 * T - 1) / (32 * T);

// Where term_k of a frame comes from: its taps' sum, the carried tail (the
// frame before the call), or nothing.
enum TermSource { kSum, kCarried, kNone };

// Output slots kM0 .. kM0 + kP - 1 of one frame (its V row 0 at `v`, lane
// i's sample i of V row x at v[x * kVStride + i]): the 16-tap FIR and
// the overlap. Source slots x (frame-local, from the last down to kM0 -
// 15) are read once each (both halves, lo = V[x][i], hi = V[x][i + 32])
// for every output m they feed (tap j = m - x < 16), so each output sums
// its taps in increasing j; the taps from frame g - k (x < 0: k = 1 for
// -T <= x, else 2) go to a[m][k]. All of it is unrolled: taps, outputs
// and terms are compile-time.
template <int T, int kM0, int kP>
__device__ __forceinline__ void fir_chunk(const float* v, const float (&w)[16],
                                          const TermSource (&src)[3], int g,
                                          int lane, int c, int F, int C,
                                          const float* tail0, float* pcm,
                                          float* tail_out) {
  constexpr int kN = 32 * T;
  constexpr int kSteps = kSynthSteps<T>;
  float a[kP][kSteps + 1];
#pragma unroll
  for (int m = 0; m < kP; ++m)
#pragma unroll
    for (int k = 0; k <= kSteps; ++k) a[m][k] = 0.f;
#pragma unroll
  for (int x = kM0 + kP - 1; x >= kM0 - kHalo; --x) {
    const float lo = v[x * kVStride + lane];
    const float hi = v[x * kVStride + lane + 32];
#pragma unroll
    for (int m = kM0; m < kM0 + kP; ++m) {
      const int j = m - x;
      if (j < 0 || j > 15) continue;
      const int k = x >= 0 ? 0 : (x >= -T ? 1 : 2);
      a[m - kM0][k] = fmaf(w[j], (j & 1) ? hi : lo, a[m - kM0][k]);
    }
  }
#pragma unroll
  for (int m = kM0; m < kM0 + kP; ++m) {
    const int p = m * 32 + lane;
    float prev = 0.f;
#pragma unroll
    for (int k = 1; k <= kSteps; ++k) {
      if (m + (k - 1) * T >= kHalo) break;  // no tap of frame g - k
      float term = 0.f;
      if (src[k] == kSum) {
        term = a[m - kM0][k];
      } else if (src[k] == kCarried) {
        const int t = g * kN + p;
        if (t < kOla) term = tail0[c * kOla + t];
      }
      prev = k == 1 ? term : prev + term;
    }
    if (g < F) {
      pcm[(static_cast<int64_t>(g) * C + c) * kN + p] =
          m < kHalo ? a[m - kM0][0] + prev : a[m - kM0][0];
    } else {
      const int t = (g - F) * kN + p;
      if (t < kOla) tail_out[c * kOla + t] = prev;
    }
  }
}

// Grid: x over ceil((F + KS) / (kSlots / T)) runs of frames (frames F ..
// F + KS - 1 are the virtual frames that yield tail_out), y over channels.
// kSbMajor: S is the bitstream stage's sb [F, C, 32, T] (L1), else M2's
// S [F, C, T * 32].
template <int T, bool kSbMajor>
__global__ void __launch_bounds__(kSynthThreads)
synth_kernel(const float* __restrict__ S, const float* __restrict__ N,
             const float* __restrict__ W, const float* __restrict__ tail0,
             const uint8_t* __restrict__ boundary, float* __restrict__ pcm,
             float* __restrict__ tail_out, int F, int C) {
  constexpr int kN = 32 * T;                // samples a frame
  constexpr int kFrames = kSlots / T;       // frames a block
  constexpr int kSteps = kSynthSteps<T>;
  static_assert(kSlots % T == 0 && T >= 12, "T is 12, 18 or 36");
  extern __shared__ __align__(16) float smem[];
  float* Ss = smem;
  float* Vs = Ss + kRows * kSStride;
  float* Ns = Vs + kRows * kVStride;  // row r: N's row r (r <= 16), r + 16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.y;
  const int g0 = blockIdx.x * kFrames;
  const int base = g0 * T - kHalo;  // stream slot of staged row 0

  // 1. Stage S of slots base .. base + kRows - 1 (zeros outside 0 .. F-1).
  if constexpr (kSbMajor) {
    // Slot-fastest order: consecutive threads read consecutive samples t.
    for (int e = tid; e < kRows * 32; e += kSynthThreads) {
      const int k = e / kRows, row = e - k * kRows;
      const int x = base + row;
      const int f = (x + 2 * T) / T - 2;  // floor(x / T), x >= -15
      const bool valid = f >= 0 && f < F;
      const float* src =
          valid ? S + (static_cast<int64_t>(f) * C + c) * kN + k * T +
                      (x - f * T)
                : S;
      cp_async4(Ss + row * kSStride + k, src, valid);
    }
  } else {
    for (int e = tid; e < kRows * 8; e += kSynthThreads) {
      const int row = e >> 3, kq = e & 7;
      const int x = base + row;
      const int f = (x + 2 * T) / T - 2;
      const bool valid = f >= 0 && f < F;
      const float* src =
          valid ? S + (static_cast<int64_t>(f) * C + c) * kN +
                      (x - f * T) * 32 + kq * 4
                : S;
      simt_gemm::cp_async16(Ss + row * kSStride + kq * 4, src, valid);
    }
  }
  simt_gemm::cp_async_commit();
  // The computed rows of N, coalesced (a lane reading its own rows from
  // device memory would touch 16 lines a load).
  for (int e = tid; e < kNRows * 32; e += kSynthThreads) {
    const int r = e >> 5, k = e & 31;
    Ns[r * kNStride + k] = __ldg(N + (r < 17 ? r : r + 16) * 32 + k);
  }
  simt_gemm::cp_async_wait<0>();
  __syncthreads();

  // 2. Thread t takes slot t: row 16 of V, the only row of N that does not
  // satisfy N[q][31 - k] = (-1)^q N[q][k] exactly, as a 32-term product;
  // then S folded in place: [S[k] + S[31-k] | S[k] - S[31-k]], k < 16.
  if (tid < kRows) {
    float x[32];
    const float4* s4 = reinterpret_cast<const float4*>(Ss + tid * kSStride);
#pragma unroll
    for (int kq = 0; kq < 8; ++kq) {
      const float4 v = s4[kq];
      x[4 * kq] = v.x;
      x[4 * kq + 1] = v.y;
      x[4 * kq + 2] = v.z;
      x[4 * kq + 3] = v.w;
    }
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k) acc = fmaf(Ns[16 * kNStride + k], x[k], acc);
    Vs[tid * kVStride + 16] = acc;
    float4* f4 = reinterpret_cast<float4*>(Ss + tid * kSStride);
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      const int k = 4 * kq;
      f4[kq] = make_float4(x[k] + x[31 - k], x[k + 1] + x[30 - k],
                           x[k + 2] + x[29 - k], x[k + 3] + x[28 - k]);
      f4[4 + kq] = make_float4(x[k] - x[31 - k], x[k + 1] - x[30 - k],
                               x[k + 2] - x[29 - k], x[k + 3] - x[28 - k]);
    }
  }
  __syncthreads();

  // 3. Matrixing, folded: V[q] = sum_k<16 N[q][k] (S[k] +- S[31-k]), the
  // sum for even q and the difference for odd; one fmaf chain in k order
  // from +0 per V. A warp takes kMatPairs slot pairs at once; each load
  // feeds two fmaf (rows hl and 48 - hl), and a warp's four addresses (two
  // slots, sums or differences) lie in four banks. The other rows are
  // mirrored: N[32 - q] = -N[q] (0 - v: +0 for an exact zero), N[96 - q] =
  // N[q].
  // Lane l (half h = l / 16, hl = l % 16) computes rows hl and 48 - hl
  // (same parity) of slots 2p + h, their coefficients in registers.
  const int hl = lane & 15, half = lane >> 4;
  const int odd = hl & 1;
  float na[16], nb[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    na[k] = Ns[hl * kNStride + k];
    nb[k] = Ns[(32 - hl) * kNStride + k];
  }
  for (int p0 = warp; 2 * p0 < kRows; p0 += kMatPairs * kSynthWarps) {
    const float* fp[kMatPairs];
    float acc_a[kMatPairs], acc_b[kMatPairs];
#pragma unroll
    for (int i = 0; i < kMatPairs; ++i) {
      const int row = min(2 * (p0 + i * kSynthWarps) + half, kRows - 1);
      fp[i] = Ss + row * kSStride + 16 * odd;
      acc_a[i] = 0.f;
      acc_b[i] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
#pragma unroll
      for (int i = 0; i < kMatPairs; ++i) {
        const float f = fp[i][k];
        acc_a[i] = fmaf(na[k], f, acc_a[i]);
        acc_b[i] = fmaf(nb[k], f, acc_b[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kMatPairs; ++i) {
      const int row = 2 * (p0 + i * kSynthWarps) + half;
      if (row >= kRows) break;
      float* v = Vs + row * kVStride;
      v[hl] = acc_a[i];
      v[32 - hl] = __fsub_rn(0.f, acc_a[i]);  // rows 32 .. 17
      v[48 - hl] = acc_b[i];
      if (hl > 0) v[48 + hl] = acc_b[i];  // rows 49 .. 63
    }
  }
  float w[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = __ldg(W + j * 32 + lane);
  __syncthreads();

  // 4. FIR and overlap: a warp an item of kP output slots of one frame
  // (fir_chunk), lane i their sample i. Where each term_k of the frame
  // comes from is decided once an item.
  constexpr int kP = T == 12 ? 6 : 18;  // 24 items at T = 12, else 8
  constexpr int kChunks = T / kP;
  static_assert((kFrames * kChunks) % kSynthWarps == 0, "FIR rounds");
  const bool carry = tail0 != nullptr && (boundary == nullptr || !boundary[0]);
  for (int item = warp; item < kFrames * kChunks; item += kSynthWarps) {
    const int fl = item / kChunks, chunk = item - fl * kChunks;
    const int g = g0 + fl;
    if (g >= F + kSteps) break;
    const bool cut = g < F && boundary != nullptr && boundary[g];
    TermSource src[3] = {kSum, kNone, kNone};
#pragma unroll
    for (int k = 1; k <= kSteps; ++k) {
      const int f = g - k;
      src[k] = f == -1 ? (carry ? kCarried : kNone)
                       : (f >= 0 && f < F && !cut ? kSum : kNone);
    }
    const float* v = Vs + (fl * T + kHalo) * kVStride;
    if (chunk == 0) {
      fir_chunk<T, 0, kP>(v, w, src, g, lane, c, F, C, tail0, pcm, tail_out);
    } else if constexpr (kChunks > 1) {
      fir_chunk<T, kP, kP>(v, w, src, g, lane, c, F, C, tail0, pcm,
                           tail_out);
    }
  }
}

template <int T, bool kSbMajor>
int launch_synth(const void* S, const void* N, const void* W,
                 const void* tail0, const void* boundary, void* pcm,
                 void* tail_out, int F, int C, void* stream) {
  if (F <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kFrames = kSlots / T;
  const cudaError_t e =
      simt_gemm::opt_in(synth_kernel<T, kSbMajor>, kSynthSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(
      static_cast<unsigned>((F + kSynthSteps<T> + kFrames - 1) / kFrames),
      static_cast<unsigned>(C));
  synth_kernel<T, kSbMajor><<<grid, kSynthThreads, kSynthSmem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), static_cast<const float*>(N),
      static_cast<const float*>(W), static_cast<const float*>(tail0),
      static_cast<const uint8_t*>(boundary), static_cast<float*>(pcm),
      static_cast<float*>(tail_out), F, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mp3_hybrid_launch(const void* x, const void* bt,
                                 const void* mixed, const void* boundary,
                                 const void* tail0, const void* T,
                                 const void* cs, const void* ca,
                                 const void* finv, void* S, void* tail_out,
                                 int G, int C, void* stream) {
  const int64_t pairs = static_cast<int64_t>(G) * C;
  if (pairs <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid =
      static_cast<unsigned>(pairs < 132 * 8 ? pairs : 132 * 8);
  mp3_hybrid_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(bt),
      static_cast<const uint8_t*>(mixed),
      static_cast<const uint8_t*>(boundary),
      static_cast<const float*>(tail0), static_cast<const float*>(T),
      static_cast<const float*>(cs), static_cast<const float*>(ca),
      static_cast<const float*>(finv), static_cast<float*>(S),
      static_cast<float*>(tail_out), G, C);
  return static_cast<int>(cudaGetLastError());
}

// S [G, C, 576] (index t*32 + k) -> pcm [G, C, 576], tail_out [C, 480];
// N [64, 32], W [16, 32]; tail0 and boundary may be null.
extern "C" int mp3_synth_launch(const void* S, const void* N, const void* W,
                                const void* tail0, const void* boundary,
                                void* pcm, void* tail_out, int G, int C,
                                void* stream) {
  return launch_synth<18, false>(S, N, W, tail0, boundary, pcm, tail_out, G,
                                 C, stream);
}

// sb [F, C, 32, T] (T = 12 or 36) -> pcm [F, C, 32T], tail_out [C, 480];
// N [64, 32], W [16, 32]; tail0 may be null.
extern "C" int mpa_l12_synth_launch(const void* sb, const void* N,
                                    const void* W, const void* tail0,
                                    void* pcm, void* tail_out, int F, int C,
                                    int T, void* stream) {
  if (T == 12)
    return launch_synth<12, true>(sb, N, W, tail0, nullptr, pcm, tail_out, F,
                                  C, stream);
  if (T == 36)
    return launch_synth<36, true>(sb, N, W, tail0, nullptr, pcm, tail_out, F,
                                  C, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The synthesis kernel's registers, local bytes and blocks per SM at T
// (12, 18 or 36; simt_gemm::attributes): out[3].
extern "C" int mp3_synth_attributes(int T, int* out) {
  if (T == 12)
    return simt_gemm::attributes(synth_kernel<12, true>, kSynthSmem, out);
  if (T == 18)
    return simt_gemm::attributes(synth_kernel<18, false>, kSynthSmem, out);
  if (T == 36)
    return simt_gemm::attributes(synth_kernel<36, true>, kSynthSmem, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
