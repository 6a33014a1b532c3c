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
// With n = 32 T, M the combined polyphase matrix [n + 480, n]
// (_polyphase_combined_matrix(T), its K axis in the operand's order) and
// rows r = g*C + c of the operand S [F*C, n], each frame's response is
// S[r].M^T: its first n columns are the frame's own PCM, the last 480
// overlap the next KS = ceil(480 / n) frames (1 for T = 18 and 36, 2 for
// T = 12). So
//   pcm[r, j] = S[r].M[j] + prev(g, j),  prev = term_1 + ... + term_KS
//   term_k = S[r - kC].M[kn + j]  if 0 <= g - k < F (and kn + j < n + 480)
//          = tail0[c, gn + j]     if g - k == -1 and gn + j < 480
//          = 0                    otherwise,
// where the carried tail0 stands in for all the frames before the call.
// M2 also takes boundary [G]: term_1 is 0 where boundary[g] (a new stream
// starts), and tail0 is not used where boundary[0]. The response's last 480
// columns never reach device memory: the block that owns row r computes
// each term_k itself, as a K pass over S[r - kC]. The outgoing tail comes
// from KS virtual frames F.. F+KS-1 with no product of their own:
//   tail_out[c, (g - F) n + j] = prev(g, j)  for (g - F) n + j < 480.
// Every term comes from the same accumulator and loop whichever call
// computes it, and prev sums the terms in one order, so a stream chained
// over calls adds the very bits one call would. For Layer I (n = 384),
// output columns 0-95 take three K passes and 96-383 take two; its tail
// spans two virtual frames, and with F = 1 the carried tail's last 96
// samples pass straight into the outgoing tail.
// What bounds M2 and L1: arithmetic, about 608K (M2), 332K (Layer I) and
// 1.9M (Layer II) multiply-adds per frame-channel against 128 T bytes of S
// read and as many of pcm written; M (1.3-7.5 MB) stays in L2. The
// reference's bar (2e-5) needs true fp32, which the tensor cores do not
// offer (TF32 keeps ~10 mantissa bits), so this is a SIMT GEMM: a 64 x 96
// output tile per 256-thread block (n is a multiple of 96 for all three
// T), 32-deep K slabs of S and M staged in padded (conflict-free) shared
// memory, a 4 x 6 register tile per thread and K pass. Layer I/II's S is
// the bitstream stage's sb [F, C, 32, T] as it is (K index k*T + t), with
// M's columns permuted to match on the host, so both operands load as
// contiguous float4 rows and no transpose pass runs.

#include <cstdint>
#include <cuda_runtime.h>

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
constexpr int kBM = 64;        // output rows (frame-channels) per block
constexpr int kBN = 96;        // output columns per block; 480 = 5 * 96
constexpr int kBK = 32;        // K slab
constexpr int kOla = 480;      // overlapped columns
constexpr int kAPad = kBM + 1; // shared strides: odd, so the transposing
constexpr int kBPad = kBN + 1; // stores below hit 32 distinct banks

// One K pass: acc[i][j] += sum_k A[row i][k] * M[col j][k] over the tile.
// a_rows[s] is the source row of S for the s-th float4 this thread loads
// (-1: zeros); m_base points at M's first column of the tile.
template <int kK>
__device__ __forceinline__ void synth_pass(
    float (&acc)[4][6], const float* __restrict__ S,
    const int64_t (&a_rows)[2], const float* __restrict__ m_base,
    float* As, float* Bs) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  for (int k0 = 0; k0 < kK; k0 += kBK) {
    __syncthreads();  // the previous slab has been read
#pragma unroll
    for (int s = 0; s < 2; ++s) {  // A: 64 rows x 8 float4
      const int f = tid + s * kSynthThreads;
      const int m = f >> 3, kq = f & 7;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a_rows[s] >= 0)
        v = *reinterpret_cast<const float4*>(S + a_rows[s] * kK + k0 + kq * 4);
      As[(kq * 4 + 0) * kAPad + m] = v.x;
      As[(kq * 4 + 1) * kAPad + m] = v.y;
      As[(kq * 4 + 2) * kAPad + m] = v.z;
      As[(kq * 4 + 3) * kAPad + m] = v.w;
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {  // B: 96 columns of M x 8 float4
      const int f = tid + s * kSynthThreads;
      const int n = f >> 3, kq = f & 7;
      const float4 v = *reinterpret_cast<const float4*>(
          m_base + static_cast<int64_t>(n) * kK + k0 + kq * 4);
      Bs[(kq * 4 + 0) * kBPad + n] = v.x;
      Bs[(kq * 4 + 1) * kBPad + n] = v.y;
      Bs[(kq * 4 + 2) * kBPad + n] = v.z;
      Bs[(kq * 4 + 3) * kBPad + n] = v.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[6];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * kAPad + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 6; ++j) b[j] = Bs[kk * kBPad + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Grid: x over ceil((F + KS) * C / 64) row tiles (rows r >= F*C are the
// virtual frames that yield tail_out), y over the n / 96 column tiles.
template <int T>
__global__ void __launch_bounds__(kSynthThreads)
synth_kernel(const float* __restrict__ S, const float* __restrict__ M,
             const float* __restrict__ tail0,
             const uint8_t* __restrict__ boundary, float* __restrict__ pcm,
             float* __restrict__ tail_out, int F, int C) {
  constexpr int kN = 32 * T;                      // PCM per frame; depth
  constexpr int kTotal = kN + kOla;               // response length
  constexpr int kSteps = (kOla + kN - 1) / kN;    // frames the tail reaches
  // Column tiles never straddle the end of a K pass's columns.
  static_assert(kN % kBN == 0 && kOla % kBN == 0, "T % 3 == 0");
  __shared__ float As[kBK * kAPad];
  __shared__ float Bs[kBK * kBPad];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t R = static_cast<int64_t>(F) * C;            // real rows
  const int64_t R_all = static_cast<int64_t>(F + kSteps) * C;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int col0 = blockIdx.y * kBN;
  // Pass k (k >= 1) covers this tile when kN * k + col0 < kTotal; pass 1
  // always does when any does.
  const bool ola = kN + col0 < kTotal;

  float acc[kSteps + 1][4][6];  // [0]: own product, [k]: term_k
#pragma unroll
  for (int k = 0; k <= kSteps; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) acc[k][i][j] = 0.f;

  int64_t a_rows[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int64_t r = row0 + ((tid + s * kSynthThreads) >> 3);
    a_rows[s] = r < R ? r : -1;
  }
  synth_pass<kN>(acc[0], S, a_rows, M + static_cast<int64_t>(col0) * kN, As,
                 Bs);
#pragma unroll
  for (int k = 1; k <= kSteps; ++k) {
    if (kN * k + col0 >= kTotal) break;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int64_t r = row0 + ((tid + s * kSynthThreads) >> 3);
      const int64_t g = r / C;
      const bool linked = r < R_all && g - k >= 0 && g - k < F &&
                          (g >= F || boundary == nullptr || !boundary[g]);
      a_rows[s] = linked ? r - static_cast<int64_t>(k) * C : -1;
    }
    synth_pass<kN>(acc[k], S, a_rows,
                   M + static_cast<int64_t>(kN * k + col0) * kN, As, Bs);
  }

  const bool carry = tail0 != nullptr && (boundary == nullptr || !boundary[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = row0 + ty * 4 + i;
    if (r >= R_all) break;
    const int64_t g = r / C;
    const int c = static_cast<int>(r - g * C);
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int n = col0 + tx + 16 * j;
      float prev = 0.f;
#pragma unroll
      for (int k = 1; k <= kSteps; ++k) {
        if (kN * k + col0 >= kTotal) break;
        float term = acc[k][i][j];  // zero where S[r - kC] does not exist
        if (g - k == -1) {
          const int64_t t = g * kN + n;
          term = carry && t < kOla ? tail0[c * kOla + t] : 0.f;
        }
        prev = k == 1 ? term : prev + term;
      }
      if (r >= R) {  // a virtual frame: the outgoing tail
        const int64_t t = (g - F) * kN + n;
        if (t < kOla) tail_out[c * kOla + t] = prev;
      } else {
        pcm[r * kN + n] = ola ? acc[0][i][j] + prev : acc[0][i][j];
      }
    }
  }
}

template <int T>
int launch_synth(const void* S, const void* M, const void* tail0,
                 const void* boundary, void* pcm, void* tail_out, int F,
                 int C, void* stream) {
  if (F <= 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kSteps = (kOla + 32 * T - 1) / (32 * T);
  const int64_t rows = (static_cast<int64_t>(F) + kSteps) * C;
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
                  32 * T / kBN);
  synth_kernel<T><<<grid, kSynthThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(S), static_cast<const float*>(M),
      static_cast<const float*>(tail0),
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

extern "C" int mp3_synth_launch(const void* S, const void* M,
                                const void* tail0, const void* boundary,
                                void* pcm, void* tail_out, int G, int C,
                                void* stream) {
  return launch_synth<18>(S, M, tail0, boundary, pcm, tail_out, G, C, stream);
}

// sb [F, C, 32, T] (T = 12 or 36) -> pcm [F, C, 32T], tail_out [C, 480];
// M [(T + 15) * 32, 32T] with columns in sb's order; tail0 may be null.
extern "C" int mpa_l12_synth_launch(const void* sb, const void* M,
                                    const void* tail0, void* pcm,
                                    void* tail_out, int F, int C, int T,
                                    void* stream) {
  if (T == 12)
    return launch_synth<12>(sb, M, tail0, nullptr, pcm, tail_out, F, C,
                            stream);
  if (T == 36)
    return launch_synth<36>(sb, M, tail0, nullptr, pcm, tail_out, F, C,
                            stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
