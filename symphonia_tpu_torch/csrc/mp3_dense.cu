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
// The tail of granule G-1 goes to tail_out.
// What bounded the first M1 was shared memory's load rate, not device
// memory (9.4 KB moved for 31K multiply-adds a granule-channel). It
// made one output a thread and fed each of its 36-54 fmaf by two 4-byte
// shared-memory loads (the matrix entry, broadcast, and x at stride 19):
// two lane-loads a multiply-add, and an SM serves 32 lanes a clock, so the
// loads alone took four times the bytes bound; it also read and
// antialiased x[g-1] again for every granule and passed three block
// barriers a granule-channel.
// This kernel blocks the product in registers along the subband. A warp
// takes one channel and a run of `run` consecutive granules; lane k is
// subband k and holds the subband's 18 antialiased inputs in registers.
//   - x[g, c] (2304 contiguous bytes) comes by 16-byte cp.async into the
//     warp's own shared buffer and is read back as nine 8-byte loads a
//     lane (lane k's floats 18k .. 18k + 17; 16 lanes' pairs fall in 32
//     distinct banks). Once the warp has read it, the copy of the next
//     granule starts into the same buffer and lands during the product.
//   - The butterflies run in registers: lane k gets lane k+1's sample i
//     and lane k-1's sample 17 - i by shuffle (i < 8), each product and sum
//     rounded once (__fmul_rn, __fadd_rn, __fsub_rn), as the plain twin's.
//   - The four matrices lie in shared memory as they lie in device memory
//     ([4][36][18]); two rows are 36 floats, nine 16-byte words, so a lane
//     reads a row pair as nine broadcast 16-byte loads and three pairs are
//     in flight: 27 loads feed 108 fmaf on six independent chains. Each row
//     is one chain of fmaf in increasing j from +0, the first kernel's sum.
//     The matrix is chosen by a per-lane base pointer: only a mixed short
//     block has two in one warp. A block type outside 0..3 takes a fifth
//     matrix of zeros, as the reference's one-hot selection multiplies by
//     zero.
//   - Rows 0-17 meet the carried tail and finv and are stored at once (32
//     lanes write 128 contiguous bytes a row); rows 18-35 replace the tail
//     in registers for the next granule of the run. x[g-1] is read and
//     transformed again (rows 18-35 only) at the start of a run, unless
//     boundary[g] or g = 0, so runs do not depend on each other; the
//     recomputed tail is the same chain of fmaf, so S does not depend on
//     `run` by any bit. `run` trades that reuse against parallelism (C *
//     ceil(G / run) warps); the wrapper's run_length chooses it.
// What holds this kernel is the throughput of its instruction mix (about
// 1100 a granule-channel: 648 fmaf, 166 16-byte shared loads): on an
// NVIDIA H100 its time did not move with 8 or 16 warps a multiprocessor,
// with three or nine row pairs in flight, or with the product rolled into
// a loop, and halving the matrix loads took a ninth off.
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
constexpr int kHybThreads = 256;  // eight warps, a run of granules each
static_assert(kHybThreads == simt_gemm::kThreads, "attributes' block");
constexpr int kHybWarps = kHybThreads / 32;
constexpr int kMat4 = 36 * 18 / 4;  // 16-byte words of one matrix
constexpr int kPair4 = 9;           // ... of two rows
constexpr int kInFlight = 3;        // row pairs in flight
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int n_bounds(int bt, bool mixed) {
  return bt == kBlockShort ? (mixed ? 1 : 0) : 31;
}

// Matrix index for subband k (hybrid_matrices() order); 4, a matrix of
// zeros, for a block type outside 0..3 (the reference's one-hot selection
// then multiplies by zero).
__device__ __forceinline__ int matrix_index(int bt, bool mixed, int k) {
  if (static_cast<unsigned>(bt) > 3u) return 4;
  if (bt != kBlockShort) return bt;
  return (mixed && k < 2) ? 0 : kBlockShort;
}

// Start the copy of one granule-channel (144 16-byte words) into the
// warp's buffer.
__device__ __forceinline__ void stage_granule(float* buf, const float* xg,
                                              int lane) {
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int w = i * 32 + lane;
    if (w < 144) simt_gemm::cp_async16(buf + 4 * w, xg + 4 * w, true);
  }
  simt_gemm::cp_async_commit();
}

// Antialias butterflies across lanes: lane b's sample 17 - i with lane
// b + 1's sample i, for the boundaries b < nb (nb is the warp's).
__device__ __forceinline__ void antialias(float (&x)[18], int nb, int lane,
                                          const float* cs, const float* ca) {
  if (nb == 0) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float lo = x[17 - i], hi = x[i];
    const float hi_above = __shfl_down_sync(kFullMask, hi, 1);
    const float lo_below = __shfl_up_sync(kFullMask, lo, 1);
    const float c = cs[i], a = ca[i];
    if (lane < nb)
      x[17 - i] = __fsub_rn(__fmul_rn(lo, c), __fmul_rn(hi_above, a));
    if (lane >= 1 && lane <= nb)
      x[i] = __fadd_rn(__fmul_rn(hi, c), __fmul_rn(lo_below, a));
  }
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Rows 2 * pair0 .. 2 * pair0 + 5 of the lane's matrix (`m4`, shared
// memory, 16-byte words) times x: out[r] = sum_j T[row r][j] * x[j], one
// chain of fmaf in increasing j from +0 a row, three row pairs in flight.
__device__ __forceinline__ void imdct_rows(const float4* m4, int pair0,
                                           const float (&x)[18],
                                           float (&out)[2 * kInFlight]) {
#pragma unroll
  for (int r = 0; r < 2 * kInFlight; ++r) out[r] = 0.f;
  const float4* p = m4 + pair0 * kPair4;
#pragma unroll
  for (int q = 0; q < kPair4; ++q) {
    float4 v[kInFlight];
#pragma unroll
    for (int s = 0; s < kInFlight; ++s) v[s] = p[s * kPair4 + q];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * q + i;        // element of the 36-float row pair
      const int r = e >= 18 ? 1 : 0;  // its row of the pair, and column
      const int j = e - 18 * r;
#pragma unroll
      for (int s = 0; s < kInFlight; ++s)
        out[2 * s + r] = fmaf(component(v[s], i), x[j], out[2 * s + r]);
    }
  }
}

// Two blocks an SM: within 128 registers ptxas keeps the 18 inputs, the
// 18-row tail, the 18 signs, six sums and the row pairs in flight with no
// spill (held to three blocks it spills).
__global__ void __launch_bounds__(kHybThreads, 2)
mp3_hybrid_kernel(const float* __restrict__ x, const int32_t* __restrict__ bt,
                  const uint8_t* __restrict__ mixed,
                  const uint8_t* __restrict__ boundary,
                  const float* __restrict__ tail0,
                  const float* __restrict__ T, const float* __restrict__ cs_g,
                  const float* __restrict__ ca_g,
                  const float* __restrict__ finv, float* __restrict__ S,
                  float* __restrict__ tail_out, int G, int C, int run) {
  __shared__ __align__(16) float Ts[5 * 36 * 18];  // the fifth: zeros
  __shared__ __align__(16) float xs[kHybWarps][576];
  __shared__ float cs[8], ca[8];
  const int tid = threadIdx.x;
  for (int i = tid; i < 5 * 36 * 18; i += kHybThreads)
    Ts[i] = i < 4 * 36 * 18 ? T[i] : 0.f;
  if (tid < 8) {
    cs[tid] = cs_g[tid];
    ca[tid] = ca_g[tid];
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kHybWarps + warp;
  const int runs = (G + run - 1) / run;
  if (item >= static_cast<int64_t>(runs) * C) return;
  const int c = static_cast<int>(item % C);
  const int g0 = static_cast<int>(item / C) * run;
  const int n = min(run, G - g0);  // granules of this run
  float* buf = xs[warp];
  float sign[18];
#pragma unroll
  for (int t = 0; t < 18; ++t) sign[t] = finv[lane * 18 + t];

  // The tail that meets granule g0: the carried one at g0 = 0; else
  // granule g0 - 1's, recomputed as step -1 of the loop below unless
  // boundary[g0] cuts it off.
  float tail[18];
#pragma unroll
  for (int t = 0; t < 18; ++t) tail[t] = 0.f;
  bool cut_n = boundary != nullptr && boundary[g0] != 0;
  if (g0 == 0 && !cut_n && tail0 != nullptr) {
#pragma unroll
    for (int t = 0; t < 18; ++t) tail[t] = tail0[(c * 32 + lane) * 18 + t];
  }
  const int first = (g0 > 0 && !cut_n) ? -1 : 0;

  // Granule g0 + first's copy and block type go ahead of the loop; inside,
  // step it + 1's are started before step it's product.
  int64_t p_n = static_cast<int64_t>(g0 + first) * C + c;
  stage_granule(buf, x + p_n * 576, lane);
  int bt_n = bt[p_n];
  bool mx_n = mixed[p_n] != 0;
#pragma unroll 1
  for (int it = first; it < n; ++it) {
    const int64_t p = p_n;
    const int bt_c = bt_n;
    const bool mx_c = mx_n, cut = cut_n;
    simt_gemm::cp_async_wait<0>();
    __syncwarp();  // every lane's copies have landed
    float xr[18];
    const float2* b2 = reinterpret_cast<const float2*>(buf + 18 * lane);
#pragma unroll
    for (int m = 0; m < 9; ++m) {
      const float2 v = b2[m];
      xr[2 * m] = v.x;
      xr[2 * m + 1] = v.y;
    }
    __syncwarp();  // every lane has read the buffer: refill it
    if (it + 1 < n) {
      p_n = static_cast<int64_t>(g0 + it + 1) * C + c;
      stage_granule(buf, x + p_n * 576, lane);
      bt_n = bt[p_n];
      mx_n = mixed[p_n] != 0;
      cut_n = boundary != nullptr && boundary[g0 + it + 1] != 0;
    }
    antialias(xr, n_bounds(bt_c, mx_c), lane, cs, ca);
    const float4* m4 = reinterpret_cast<const float4*>(Ts) +
                       matrix_index(bt_c, mx_c, lane) * kMat4;
    float acc[2 * kInFlight];
    if (it >= 0) {
      float* Sg = S + p * 576 + lane;
#pragma unroll
      for (int pair = 0; pair < 9; pair += kInFlight) {
        imdct_rows(m4, pair, xr, acc);
#pragma unroll
        for (int r = 0; r < 2 * kInFlight; ++r) {
          const int t = 2 * pair + r;
          Sg[t * 32] = (acc[r] + (cut ? 0.f : tail[t])) * sign[t];
        }
      }
    }
#pragma unroll
    for (int pair = 9; pair < 18; pair += kInFlight) {
      imdct_rows(m4, pair, xr, acc);
#pragma unroll
      for (int r = 0; r < 2 * kInFlight; ++r)
        tail[2 * pair + r - 18] = acc[r];
    }
  }
  if (g0 + n == G) {
#pragma unroll
    for (int t = 0; t < 18; ++t) tail_out[(c * 32 + lane) * 18 + t] = tail[t];
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

// x [G, C, 576] (16-byte aligned) -> S [G, C, 576], tail_out [C, 32, 18];
// boundary and tail0 may be null; `run` >= 1 granules a warp.
extern "C" int mp3_hybrid_launch(const void* x, const void* bt,
                                 const void* mixed, const void* boundary,
                                 const void* tail0, const void* T,
                                 const void* cs, const void* ca,
                                 const void* finv, void* S, void* tail_out,
                                 int G, int C, int run, void* stream) {
  if (G <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  if (run < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t warps = static_cast<int64_t>((G + run - 1) / run) * C;
  const unsigned grid =
      static_cast<unsigned>((warps + kHybWarps - 1) / kHybWarps);
  mp3_hybrid_kernel<<<grid, kHybThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(bt),
      static_cast<const uint8_t*>(mixed),
      static_cast<const uint8_t*>(boundary),
      static_cast<const float*>(tail0), static_cast<const float*>(T),
      static_cast<const float*>(cs), static_cast<const float*>(ca),
      static_cast<const float*>(finv), static_cast<float*>(S),
      static_cast<float*>(tail_out), G, C, run);
  return static_cast<int>(cudaGetLastError());
}

// M1's registers, local bytes and blocks per SM (simt_gemm::attributes):
// out[3].
extern "C" int mp3_hybrid_attributes(int* out) {
  return simt_gemm::attributes(mp3_hybrid_kernel, 0, out);
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
