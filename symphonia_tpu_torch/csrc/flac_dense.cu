// FLAC dense stage for Hopper (sm_90a): kernels F1 and F2.
//
// F1 flac_lpc replaces symphonia_tpu/ops/flac_dense.py:44
// lpc_reconstruct_batch and :71 apply_wasted_bits, and does the job of the
// 32-bit-limb int64 emulation in ops/i64emu.py with native int64.
// For every lane (one subframe of one frame):
//   x[n] = r[n]                                    for n < order
//   x[n] = r[n] + int32((sum_{j<32} c_j * x[n-1-j]) >> shift)  otherwise
//   out[n] = x[n] << wasted
// The sum is the exact product sum modulo 2^64 (what the limb emulation
// computes); the shifted value is truncated to its low 32 bits, as
// i64_shr_to_i32 does; shifts outside [0, 31] give a zero prediction and
// wasted shifts outside [0, 31] a zero sample, as XLA's shifts do. The
// adds and the left shift wrap in uint32 (signed overflow is undefined in
// C++; the reference's int32 arithmetic wraps).
//
// What bounds F1 on this card (NVIDIA H100 80GB HBM3, 700.00 W): the
// 32 x 32 + 64-bit multiply-add. It is one IMAD.WIDE, which the card issues
// at 6.5e12 a second (measured by imad_rate_kernel below: a fifth of the
// fp32 multiply-add peak), so 32 taps on [16384, 4112] need 0.33 ms, twice the
// bytes' time (8 bytes a sample, 0.16 ms); lanes with few taps are bound by
// bytes. A lane is a serial recurrence, so lanes are the only parallelism,
// and 16384 lanes are one warp a scheduler.
// What held the first version of this kernel (one thread a lane, all 32
// taps for every lane, a tile loaded, computed and stored in turn; 2.74
// ms, 17x the bytes bound), found with cuobjdump -sass, ptxas -v and timed
// variants: (1) at 168 registers the compiler issued the 32 row loads of a
// tile one after the other, each followed by its shared-memory store, so a
// tile waited for 32 device-memory round trips that nothing overlapped
// (1.7 of the 2.74 ms; the same loop at 32 registers took 0.75 ms with
// the stores); (2) (int64_t)c * h compiled to a 64 x 64-bit multiply
// (IMAD.WIDE.U32, two IMAD, a sign SHF and carries: about 600
// instructions a sample with the 31 moves of the history shift), 0.85 ms
// alone; the stores added 0.2 ms. The recurrence's dependency was not it:
// feeding the history from the residuals changed nothing.
// What the design does:
// - Only the taps a lane has. The helper flac_lane_order counts taps = 32
//   less the row's trailing zero coefficients (exact for any input: the
//   reference multiplies all 32 whatever `order` says) and sorts the lanes
//   by it, most taps first. A warp takes consecutive slots of that order,
//   reads and writes rows through the index, and runs the recurrence
//   instantiated for the bucket (4, 8, 12, 16, 24, 32) of its largest
//   count; a warp of tap-less lanes (verbatim, constant) copies and shifts.
// - One IMAD.WIDE a tap (inline mad.wide.s32).
// - Tap 0 last: taps 1.. of sample n use x[n-2] and older and are summed
//   while x[n-1] is still in flight; c_0 * x[n-1], the shift and the add
//   are all that waits for it.
// - No history moves: the sample loop is unrolled by the ring's length, so
//   ring indices are compile-time.
// - A lane's taps on P = 2 or 4 adjacent threads (the wrapper picks P for
//   about two warps a scheduler: 2 at 16384 lanes, 4 at 8192; one thread a
//   lane was slower at every size measured and is gone): each holds a run of the coefficients and of the history; partial sums meet
//   by __shfl_xor_sync before tap 0 is added, and a thread's oldest sample
//   passes to the next by __shfl_up_sync, off the critical path.
// - Tiles of [lanes x 32 samples] double-buffered in shared memory: the
//   next tile's rows come by cp.async (all in flight at once, coalesced
//   along n) while the recurrence runs, and a finished tile's stores drain
//   behind the next one.
// The sum is exact modulo 2^64 in any grouping, so results equal the plain
// twin bit for bit.
//
// F2 flac_decorrelate replaces ops/flac_dense.py:84 decorrelate_batch:
// elementwise over [F, 2, n], undoing left/side, right/side and mid/side
// per frame. Bound by memory bandwidth (16 bytes per sample pair); one
// thread per sample pair, coalesced along n, wrapping uint32 arithmetic.
// F2 stays a separate kernel: F1 takes lanes in the order of their tap
// counts, so the two channel lanes of a frame meet in no one warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 32;
constexpr int kTile = 32;        // samples per staged tile
constexpr int kWarps = 4;        // warps per block; they never synchronise
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// acc + a * b with the product signed 32 x 32 -> 64: one IMAD.WIDE. Written
// in C++ ((int64_t)a * b + acc) the compiler multiplies sign-extended 64-bit
// values, several instructions a tap.
__device__ __forceinline__ uint64_t mad_wide(int32_t a, int32_t b,
                                             uint64_t acc) {
  uint64_t d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(acc));
  return d;
}

// The history ring holds a power of two of samples so that it divides the
// tile: a full tile returns the ring to phase 0.
__host__ __device__ constexpr int ring_size(int taps) {
  return taps <= 1 ? 1 : taps <= 2 ? 2 : taps <= 4 ? 4 : taps <= 8 ? 8
       : taps <= 16 ? 16 : 32;
}

// What a lane's threads need for every sample.
struct LaneParams {
  int ord;
  int sh;            // shift & 31
  uint32_t sh_mask;  // all ones where the shift is in [0, 31], else 0
  int wb;            // wasted & 31
  uint32_t wb_mask;
  int32_t c0;        // tap 0, held by every thread of the lane
};

// The recurrence over one staged tile t[lane][sample], in place. T is the
// warp's tap bucket, P (2 or 4) the threads a lane. A thread holds KE
// "early" taps (taps 1 .. T - 1 of the lane, dealt in runs of KE over its P
// threads and padded with a zero) and their history in ring g; tap 0 is
// added last.
// Unrolled by the ring size R, so every index into ce and g is a constant
// and no history register moves.
template <int T, int P, bool FULL>
__device__ __forceinline__ void lpc_tile(
    int32_t (*t)[kTile + 1], int li, int part, int base, int width,
    const LaneParams& p, const int32_t (&ce)[T / P],
    uint32_t (&g)[ring_size(T / P)], uint32_t& xprev) {
  constexpr int KE = T / P;
  constexpr int R = ring_size(KE);
  for (int i0 = 0; i0 < kTile; i0 += R) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = i0 + u;
      if (FULL || i < width) {
        const uint32_t r_n = static_cast<uint32_t>(t[li][i]);
        // Early taps: x[n - 2] and older, so none waits for x[n - 1].
        // Logical history h[k] = x[n - 2 - part * KE - k] = g[(k - u) % R].
        uint64_t e[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < KE; ++k)
          e[k & 3] = mad_wide(ce[k], static_cast<int32_t>(g[(k - u + R) % R]),
                              e[k & 3]);
        uint64_t early = (e[0] + e[1]) + (e[2] + e[3]);
        early += __shfl_xor_sync(kFull, early, 1);
        if (P == 4) early += __shfl_xor_sync(kFull, early, 2);
        // The only work that waits for x[n - 1]: one multiply-add, the
        // shift (low word of acc >> sh, sh in [0, 31]), a mask, the add.
        const uint64_t acc =
            mad_wide(p.c0, static_cast<int32_t>(xprev), early);
        const uint32_t mask = base + i < p.ord ? 0u : p.sh_mask;
        const uint32_t pred =
            __funnelshift_r(static_cast<uint32_t>(acc),
                            static_cast<uint32_t>(acc >> 32), p.sh) & mask;
        const uint32_t x_n = r_n + pred;
        // The lane's first thread takes x[n - 1] into its ring; every
        // other takes the oldest sample of the thread before it (old
        // data: off the critical path).
        const uint32_t from_prev =
            __shfl_up_sync(kFull, g[(KE - 1 - u + R) % R], 1);
        g[(2 * R - 1 - u) % R] = part == 0 ? xprev : from_prev;
        xprev = x_n;
        if (part == 0)
          t[li][i] = static_cast<int32_t>((x_n << p.wb) & p.wb_mask);
      }
    }
  }
}

// One warp's lanes (32 / P of them; res_off[] and out_off[] are their rows'
// offsets in res and out, -1 past the end) at tap bucket T:
// tiles of [lanes x 32 samples] double-buffered in shared memory. The next
// tile's rows are in flight (cp.async, coalesced along n) while the
// recurrence runs over the current one, and a finished tile's stores are
// issued and left to drain.
template <int T, int P>
__device__ __forceinline__ void lpc_rows(
    const int32_t* __restrict__ res, const int32_t* __restrict__ coefs,
    int32_t* __restrict__ out, int n, int32_t (*tile)[32 / P][kTile + 1],
    const int64_t* res_off, const int64_t* out_off, int my_row,
    LaneParams p) {
  constexpr int LW = 32 / P;
  constexpr int KE = T / P;
  constexpr int R = ring_size(KE);
  const int tid = threadIdx.x & 31;
  const int li = tid / P;
  const int part = tid % P;
  const bool live = my_row >= 0;
  const int32_t* crow =
      coefs + static_cast<int64_t>(live ? my_row : 0) * kMaxTaps;
  int32_t ce[KE];
#pragma unroll
  for (int k = 0; k < KE; ++k) {
    const int j = part * KE + k + 1;
    ce[k] = live && j < kMaxTaps ? crow[j] : 0;
  }
  p.c0 = live ? crow[0] : 0;
  uint32_t g[R];
#pragma unroll
  for (int k = 0; k < R; ++k) g[k] = 0;
  uint32_t xprev = 0;

  auto issue = [&](int k, int buf) {
    const int col = k * kTile + tid;
#pragma unroll
    for (int r = 0; r < LW; ++r) {
      const int64_t off = res_off[r];
      if (off >= 0 && col < n) cp_async4(&tile[buf][r][tid], res + off + col);
    }
    cp_async_commit();
  };

  const int tiles = (n + kTile - 1) / kTile;
  issue(0, 0);
  for (int k = 0; k < tiles; ++k) {
    const int buf = k & 1;
    if (k + 1 < tiles) {
      issue(k + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int base = k * kTile;
    const int width = min(kTile, n - base);
    if (width == kTile)
      lpc_tile<T, P, true>(tile[buf], li, part, base, width, p, ce, g, xprev);
    else
      lpc_tile<T, P, false>(tile[buf], li, part, base, width, p, ce, g,
                            xprev);
    __syncwarp();
    const int col = base + tid;
#pragma unroll
    for (int r = 0; r < LW; ++r) {
      const int64_t off = out_off[r];
      if (off >= 0 && col < n) out[off + col] = tile[buf][r][tid];
    }
  }
}

// A warp whose lanes have no tap at all: a copy and the wasted-bits shift,
// a column of all its rows at a time, so that one load a row is in flight
// together. wbs[] holds wasted, or -1 outside [0, 31].
template <int LW>
__device__ __forceinline__ void copy_rows(
    const int32_t* __restrict__ res, int32_t* __restrict__ out, int n,
    const int64_t* res_off, const int64_t* out_off, const int32_t* wbs) {
  const int tid = threadIdx.x & 31;
  for (int col = tid; col < n; col += kTile) {
    uint32_t v[LW];
#pragma unroll
    for (int r = 0; r < LW; ++r) {
      const int64_t off = res_off[r];
      v[r] = off >= 0 ? static_cast<uint32_t>(__ldg(res + off + col)) : 0u;
    }
#pragma unroll
    for (int r = 0; r < LW; ++r) {
      const int64_t off = out_off[r];
      const int w = wbs[r];
      if (off >= 0)
        out[off + col] = w >= 0 ? static_cast<int32_t>(v[r] << w) : 0;
    }
  }
}

// A warp takes 32 / P consecutive slots of perm (lanes sorted by tap count,
// most taps first, so the longest warps start first) and runs the
// recurrence instantiated for the bucket of its largest tap count.
template <int P>
__global__ void __launch_bounds__(32 * kWarps, 1)
flac_lpc_kernel(const int32_t* __restrict__ res, int64_t res_stride,
                const int32_t* __restrict__ coefs,
                const int32_t* __restrict__ order,
                const int32_t* __restrict__ shift,
                const int32_t* __restrict__ wasted,
                const int32_t* __restrict__ perm,
                const int32_t* __restrict__ taps,
                int32_t* __restrict__ out, int64_t L, int n) {
  constexpr int LW = 32 / P;
  __shared__ int32_t tile[kWarps][2][LW][kTile + 1];
  __shared__ int64_t res_offs[kWarps][LW];
  __shared__ int64_t out_offs[kWarps][LW];
  __shared__ int32_t wbs[kWarps][LW];
  const int warp = threadIdx.x >> 5;
  const int tid = threadIdx.x & 31;
  const int64_t slot0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * LW;
  if (slot0 >= L) return;  // whole warp past the end
  const int li = tid / P;
  const int64_t slot = slot0 + li;
  const int row = slot < L ? perm[slot] : -1;
  const int my_taps = row >= 0 ? taps[row] : 0;
  const int sh = row >= 0 ? shift[row] : 0;
  const int wb = row >= 0 ? wasted[row] : 0;
  LaneParams p;
  p.ord = row >= 0 ? order[row] : 0;
  p.sh = sh & 31;
  p.sh_mask = static_cast<unsigned>(sh) <= 31u ? kFull : 0u;
  p.wb = wb & 31;
  p.wb_mask = static_cast<unsigned>(wb) <= 31u ? kFull : 0u;
  p.c0 = 0;
  if (tid % P == 0) {
    res_offs[warp][li] = row >= 0 ? row * res_stride : -1;
    out_offs[warp][li] = row >= 0 ? static_cast<int64_t>(row) * n : -1;
    wbs[warp][li] = static_cast<unsigned>(wb) <= 31u ? wb : -1;
  }
  __syncwarp();
  const int tmax = __reduce_max_sync(kFull, my_taps);
  const int64_t* ro = res_offs[warp];
  const int64_t* oo = out_offs[warp];
  if (tmax == 0)
    copy_rows<LW>(res, out, n, ro, oo, wbs[warp]);
  else if (tmax <= 4)
    lpc_rows<4, P>(res, coefs, out, n, tile[warp], ro, oo, row, p);
  else if (tmax <= 8)
    lpc_rows<8, P>(res, coefs, out, n, tile[warp], ro, oo, row, p);
  else if (tmax <= 12)
    lpc_rows<12, P>(res, coefs, out, n, tile[warp], ro, oo, row, p);
  else if (tmax <= 16)
    lpc_rows<16, P>(res, coefs, out, n, tile[warp], ro, oo, row, p);
  else if (tmax <= 24)
    lpc_rows<24, P>(res, coefs, out, n, tile[warp], ro, oo, row, p);
  else
    lpc_rows<32, P>(res, coefs, out, n, tile[warp], ro, oo, row, p);
}

// F1's helper flac_lane_order, two small kernels: taps[l] = 32 less the
// trailing zero coefficients of row l (each row read once as 16-byte
// words) with a count of each tap count per block; then perm = the lanes in
// the order of their tap counts, most taps first, a counting sort whose
// cursors each block derives from all blocks' counts. The order within one
// count is whatever the atomics give, and F1's result does not depend on
// it. Neither needs a zeroed buffer, and the two launches cost less than
// the several small library kernels of the same function in tensor code
// (the twin, ops/flac_dense.py).
constexpr int kOrderThreads = 256;
constexpr int kCounts = kMaxTaps + 1;

__global__ void __launch_bounds__(kOrderThreads)
flac_lane_taps_kernel(const int32_t* __restrict__ coefs,
                      int32_t* __restrict__ taps,
                      int32_t* __restrict__ block_count, int L) {
  __shared__ int count[kCounts];
  if (threadIdx.x < kCounts) count[threadIdx.x] = 0;
  __syncthreads();
  const int l = blockIdx.x * kOrderThreads + threadIdx.x;
  if (l < L) {
    const int4* __restrict__ row =
        reinterpret_cast<const int4*>(coefs + static_cast<int64_t>(l) *
                                                  kMaxTaps);
    int t = 0;
#pragma unroll
    for (int q = 0; q < kMaxTaps / 4; ++q) {
      const int4 v = __ldg(row + q);
      if (v.x != 0) t = 4 * q + 1;
      if (v.y != 0) t = 4 * q + 2;
      if (v.z != 0) t = 4 * q + 3;
      if (v.w != 0) t = 4 * q + 4;
    }
    taps[l] = t;
    atomicAdd(&count[t], 1);
  }
  __syncthreads();
  if (threadIdx.x < kCounts)
    block_count[blockIdx.x * kCounts + threadIdx.x] = count[threadIdx.x];
}

__global__ void __launch_bounds__(kOrderThreads)
flac_lane_sort_kernel(const int32_t* __restrict__ taps,
                      const int32_t* __restrict__ block_count,
                      int32_t* __restrict__ perm, int L) {
  __shared__ int total[kCounts];   // lanes of each tap count, all blocks
  __shared__ int before[kCounts];  // ... in the blocks before this one
  __shared__ int cursor[kCounts];
  if (threadIdx.x < kCounts) total[threadIdx.x] = before[threadIdx.x] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < gridDim.x * kCounts; e += kOrderThreads) {
    const int v = block_count[e];
    atomicAdd(&total[e % kCounts], v);
    if (e / kCounts < blockIdx.x) atomicAdd(&before[e % kCounts], v);
  }
  __syncthreads();
  if (threadIdx.x < kCounts) {
    int first = before[threadIdx.x];
    for (int t = threadIdx.x + 1; t < kCounts; ++t) first += total[t];
    cursor[threadIdx.x] = first;
  }
  __syncthreads();
  const int l = blockIdx.x * kOrderThreads + threadIdx.x;
  if (l < L) perm[atomicAdd(&cursor[taps[l]], 1)] = l;
}

// The card's rate for F1's arithmetic, measured: eight chains a thread of
// 32 x 32 + 64-bit multiply-adds (IMAD.WIDE), each multiplicand the low
// word of a neighbouring chain so that nothing folds at compile time.
constexpr int kRateThreads = 256;
constexpr int kRateChains = 8;

__global__ void __launch_bounds__(kRateThreads)
imad_rate_kernel(int32_t* __restrict__ out, int iters) {
  const int gid = blockIdx.x * kRateThreads + threadIdx.x;
  int32_t c[kRateChains];
  uint64_t a[kRateChains];
#pragma unroll
  for (int k = 0; k < kRateChains; ++k) {
    c[k] = 2 * (gid + k) + 1;
    a[k] = static_cast<uint64_t>(gid) * 77u + k;
  }
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kRateChains; ++k)
      a[k] = mad_wide(c[k], static_cast<int32_t>(a[(k + 1) % kRateChains]),
                      a[k]);
  }
  uint64_t x = 0;
#pragma unroll
  for (int k = 0; k < kRateChains; ++k) x ^= a[k];
  out[gid] = static_cast<int32_t>(x ^ (x >> 32));
}

__global__ void flac_decorrelate_kernel(const int32_t* __restrict__ x,
                                        const int32_t* __restrict__ assign,
                                        int32_t* __restrict__ out, int64_t F,
                                        int n) {
  const int64_t total = F * static_cast<int64_t>(n);
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t f = idx / n;
    const int64_t i = idx - f * n;
    const int64_t o0 = f * 2 * n + i;
    const int64_t o1 = o0 + n;
    const uint32_t c0 = static_cast<uint32_t>(x[o0]);
    const uint32_t c1 = static_cast<uint32_t>(x[o1]);
    uint32_t y0 = c0, y1 = c1;
    switch (assign[f]) {
      case 1:  // left/side: L = c0, R = c0 - c1
        y1 = c0 - c1;
        break;
      case 2:  // right/side: L = c0 + c1, R = c1
        y0 = c0 + c1;
        break;
      case 3: {  // mid/side: m2 = (mid << 1) | (side & 1)
        const uint32_t m2 = (c0 << 1) | (c1 & 1u);
        y0 = static_cast<uint32_t>(static_cast<int32_t>(m2 + c1) >> 1);
        y1 = static_cast<uint32_t>(static_cast<int32_t>(m2 - c1) >> 1);
        break;
      }
      default:
        break;
    }
    out[o0] = static_cast<int32_t>(y0);
    out[o1] = static_cast<int32_t>(y1);
  }
}

template <class Kernel>
int kernel_attributes(Kernel kernel, int threads, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      threads, 0);
  if (e == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(e);
}

template <int P>
cudaError_t launch_lpc(const void* res, int64_t res_stride, const void* coefs,
                       const void* order, const void* shift,
                       const void* wasted, const void* perm, const void* taps,
                       void* out, int64_t L, int n, cudaStream_t stream) {
  const int64_t lanes_per_block = kWarps * (32 / P);
  const int64_t grid = (L + lanes_per_block - 1) / lanes_per_block;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  flac_lpc_kernel<P><<<static_cast<unsigned>(grid), 32 * kWarps, 0, stream>>>(
      static_cast<const int32_t*>(res), res_stride,
      static_cast<const int32_t*>(coefs), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(shift), static_cast<const int32_t*>(wasted),
      static_cast<const int32_t*>(perm), static_cast<const int32_t*>(taps),
      static_cast<int32_t*>(out), L, n);
  return cudaGetLastError();
}

}  // namespace

// perm [L]: the lanes sorted by taps, most first; taps [L]: 32 less the
// row's trailing zero coefficients; parts: threads a lane (2 or 4).
extern "C" int flac_lpc_launch(const void* res, int64_t res_stride,
                               const void* coefs, const void* order,
                               const void* shift, const void* wasted,
                               const void* perm, const void* taps, void* out,
                               int64_t L, int n, int parts, void* stream) {
  if (L <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (L > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (parts == 2)
    err = launch_lpc<2>(res, res_stride, coefs, order, shift, wasted, perm,
                        taps, out, L, n, s);
  else if (parts == 4)
    err = launch_lpc<4>(res, res_stride, coefs, order, shift, wasted, perm,
                        taps, out, L, n, s);
  return static_cast<int>(err);
}

// taps [L] and perm [L] int32 from coefs [L, 32] int32 (16-byte aligned);
// scratch holds 33 int32 for every 256 lanes.
extern "C" int flac_lane_order_launch(const void* coefs, void* taps,
                                      void* perm, void* scratch, int64_t L,
                                      void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  if (L > 0x7fffffff || reinterpret_cast<uintptr_t>(coefs) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid =
      static_cast<unsigned>((L + kOrderThreads - 1) / kOrderThreads);
  flac_lane_taps_kernel<<<grid, kOrderThreads, 0, s>>>(
      static_cast<const int32_t*>(coefs), static_cast<int32_t*>(taps),
      static_cast<int32_t*>(scratch), static_cast<int>(L));
  flac_lane_sort_kernel<<<grid, kOrderThreads, 0, s>>>(
      static_cast<const int32_t*>(taps),
      static_cast<const int32_t*>(scratch), static_cast<int32_t*>(perm),
      static_cast<int>(L));
  return static_cast<int>(cudaGetLastError());
}

// out[0..2] = registers a thread, local-memory bytes a thread (nonzero
// where ptxas spilled) and resident blocks an SM of F1 at `parts`.
extern "C" int flac_lpc_attributes(int parts, int* out) {
  if (parts == 2)
    return kernel_attributes(flac_lpc_kernel<2>, 32 * kWarps, out);
  if (parts == 4)
    return kernel_attributes(flac_lpc_kernel<4>, 32 * kWarps, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Runs blocks x 256 threads x iters x 8 multiply-adds; out [blocks * 256]
// int32 takes each thread's folded sums (so nothing is optimised away).
extern "C" int flac_imad_rate_launch(void* out, int blocks, int iters,
                                     void* stream) {
  if (blocks <= 0 || iters <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  imad_rate_kernel<<<blocks, kRateThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flac_decorrelate_launch(const void* x, const void* assign,
                                       void* out, int64_t F, int n,
                                       void* stream) {
  const int64_t total = F * static_cast<int64_t>(n);
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const unsigned grid =
      static_cast<unsigned>(want < 132 * 64 ? want : 132 * 64);
  flac_decorrelate_kernel<<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(assign),
      static_cast<int32_t*>(out), F, n);
  return static_cast<int>(cudaGetLastError());
}
