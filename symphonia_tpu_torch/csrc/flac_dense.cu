// FLAC dense stage for Hopper (sm_90a): kernels F1, F2 and F3.
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
//
// F3 flac_md5 replaces no kernel of symphonia_tpu: the JAX package hashes
// on the host (batch._flac_md5_ok), as the port does for a single stream.
// It computes STREAMINFO's MD5 of each stream of a merged dispatch from
// the decoded lanes x [F, C, n_max] int32 (F1's or F2's output, still on
// the card): the bytes md5_bytes_of builds, channels interleaved, each
// sample little-endian at 1 to 4 bytes, across frame boundaries that need
// not fall on 64-byte blocks, the first n_hash samples of the stream's
// frames. What bounds it: MD5 is one serial chain a stream, 64 steps a
// 64-byte block, each waiting on the one before through three dependent
// operations as compiled (LOP3 for F, G, H or I; IADD3 of a, m[g] + k and
// that; LEA.HI, the rotate and the add of b in one), so the longest
// stream's blocks x 64 x one step's latency (measured by md5_chain_kernel
// below); bytes (4 read a sample) take a two-hundredth of that. Design:
// - One warp a stream. The warp loads a round of 256 samples coalesced
//   along n, narrows them and writes their bytes into a 2 KB ring in
//   shared memory; the loads of the next round are issued before the
//   current round's blocks are compressed, so their latency hides under
//   the chain.
// - Before the chain runs, the lanes write each whole block's 64 values
//   m[g] + k to shared memory (two a lane), and the chain reads them as
//   16-byte loads. With m[g] and k apart the compiler added k after F, a
//   fourth operation on the chain (10.76 ms against 8.77 at the FLAC bulk
//   cell's shape; PERF.md).
// - Resumable across lane chunks: each stream's state (a, b, c, d, the
//   length, the <= 63 bytes past the last whole block) lives in a device
//   row that the next chunk's launch resumes; the launch that holds the
//   stream's last frame pads and finalizes it, and the digest replaces
//   a, b, c, d. Only the digests go back to the host.

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

// F3 flac_md5. A stream's table row: frame0 (its first frame in this
// chunk), frames (0: not in this chunk), n_hash (samples still to hash in
// this chunk), width (bytes a sample, 1 to 4), flags (kMd5First: start
// from MD5's initial state; kMd5Last: pad and finalize), three unused.
// Its state row: a, b, c, d (the digest, once finalized), the message
// length in bytes (low, high word), two unused, then the 16 words of the
// block that the last <= 63 bytes begin.
constexpr int kMd5Row = 8;
constexpr int kMd5StateWords = 24;
constexpr int kMd5First = 1;
constexpr int kMd5Last = 2;
constexpr int kMd5Per = 8;                 // samples a lane loads a round
constexpr int kMd5Round = 32 * kMd5Per;    // samples a round
constexpr int kMd5Ring = 2048;             // bytes: 63 pending + 4 x 256
constexpr int kMd5Blocks = 16;             // most whole blocks a round

// RFC 1321: each step's constant and message word.
__constant__ uint32_t kMd5K[64] = {
    0xd76aa478u, 0xe8c7b756u, 0x242070dbu, 0xc1bdceeeu,
    0xf57c0fafu, 0x4787c62au, 0xa8304613u, 0xfd469501u,
    0x698098d8u, 0x8b44f7afu, 0xffff5bb1u, 0x895cd7beu,
    0x6b901122u, 0xfd987193u, 0xa679438eu, 0x49b40821u,
    0xf61e2562u, 0xc040b340u, 0x265e5a51u, 0xe9b6c7aau,
    0xd62f105du, 0x02441453u, 0xd8a1e681u, 0xe7d3fbc8u,
    0x21e1cde6u, 0xc33707d6u, 0xf4d50d87u, 0x455a14edu,
    0xa9e3e905u, 0xfcefa3f8u, 0x676f02d9u, 0x8d2a4c8au,
    0xfffa3942u, 0x8771f681u, 0x6d9d6122u, 0xfde5380cu,
    0xa4beea44u, 0x4bdecfa9u, 0xf6bb4b60u, 0xbebfbc70u,
    0x289b7ec6u, 0xeaa127fau, 0xd4ef3085u, 0x04881d05u,
    0xd9d4d039u, 0xe6db99e5u, 0x1fa27cf8u, 0xc4ac5665u,
    0xf4292244u, 0x432aff97u, 0xab9423a7u, 0xfc93a039u,
    0x655b59c3u, 0x8f0ccc92u, 0xffeff47du, 0x85845dd1u,
    0x6fa87e4fu, 0xfe2ce6e0u, 0xa3014314u, 0x4e0811a1u,
    0xf7537e82u, 0xbd3af235u, 0x2ad7d2bbu, 0xeb86d391u};
__constant__ int kMd5G[64] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    1, 6, 11, 0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12,
    5, 8, 11, 14, 1, 4, 7, 10, 13, 0, 3, 6, 9, 12, 15, 2,
    0, 7, 14, 5, 12, 3, 10, 1, 8, 15, 6, 13, 4, 11, 2, 9};

// RFC 1321's four functions; each compiles to one LOP3.
__device__ __forceinline__ uint32_t md5_F(uint32_t b, uint32_t c, uint32_t d) {
  return d ^ (b & (c ^ d));
}
__device__ __forceinline__ uint32_t md5_G(uint32_t b, uint32_t c, uint32_t d) {
  return c ^ (d & (b ^ c));
}
__device__ __forceinline__ uint32_t md5_H(uint32_t b, uint32_t c, uint32_t d) {
  return b ^ c ^ d;
}
__device__ __forceinline__ uint32_t md5_I(uint32_t b, uint32_t c, uint32_t d) {
  return c ^ (b | ~d);
}

// One step of RFC 1321 with mk[i] = m[g] + k from shared memory: a + mk[i]
// + F(b, c, d) is one 3-input add, and the rotate and the add of b
// compile to one LEA.HI.
#define MD5_STEP(fn, a, b, c, d, i, s)                  \
  {                                                     \
    const uint32_t u_ = a + mk[i] + md5_##fn(b, c, d);  \
    a = __funnelshift_l(u_, u_, s) + b;                 \
  }

// h = MD5 compression of h by one block, given as mk[i] = m[g(i)] + k[i]
// for its 64 steps (16-byte aligned, shared memory), every lane alike.
__device__ __forceinline__ void md5_block(uint32_t (&h)[4],
                                          const uint32_t* w) {
  uint32_t mk[64];
  const uint4* q = reinterpret_cast<const uint4*>(w);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint4 v = q[k];
    mk[4 * k] = v.x;
    mk[4 * k + 1] = v.y;
    mk[4 * k + 2] = v.z;
    mk[4 * k + 3] = v.w;
  }
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  MD5_STEP(F, a, b, c, d, 0, 7);
  MD5_STEP(F, d, a, b, c, 1, 12);
  MD5_STEP(F, c, d, a, b, 2, 17);
  MD5_STEP(F, b, c, d, a, 3, 22);
  MD5_STEP(F, a, b, c, d, 4, 7);
  MD5_STEP(F, d, a, b, c, 5, 12);
  MD5_STEP(F, c, d, a, b, 6, 17);
  MD5_STEP(F, b, c, d, a, 7, 22);
  MD5_STEP(F, a, b, c, d, 8, 7);
  MD5_STEP(F, d, a, b, c, 9, 12);
  MD5_STEP(F, c, d, a, b, 10, 17);
  MD5_STEP(F, b, c, d, a, 11, 22);
  MD5_STEP(F, a, b, c, d, 12, 7);
  MD5_STEP(F, d, a, b, c, 13, 12);
  MD5_STEP(F, c, d, a, b, 14, 17);
  MD5_STEP(F, b, c, d, a, 15, 22);
  MD5_STEP(G, a, b, c, d, 16, 5);
  MD5_STEP(G, d, a, b, c, 17, 9);
  MD5_STEP(G, c, d, a, b, 18, 14);
  MD5_STEP(G, b, c, d, a, 19, 20);
  MD5_STEP(G, a, b, c, d, 20, 5);
  MD5_STEP(G, d, a, b, c, 21, 9);
  MD5_STEP(G, c, d, a, b, 22, 14);
  MD5_STEP(G, b, c, d, a, 23, 20);
  MD5_STEP(G, a, b, c, d, 24, 5);
  MD5_STEP(G, d, a, b, c, 25, 9);
  MD5_STEP(G, c, d, a, b, 26, 14);
  MD5_STEP(G, b, c, d, a, 27, 20);
  MD5_STEP(G, a, b, c, d, 28, 5);
  MD5_STEP(G, d, a, b, c, 29, 9);
  MD5_STEP(G, c, d, a, b, 30, 14);
  MD5_STEP(G, b, c, d, a, 31, 20);
  MD5_STEP(H, a, b, c, d, 32, 4);
  MD5_STEP(H, d, a, b, c, 33, 11);
  MD5_STEP(H, c, d, a, b, 34, 16);
  MD5_STEP(H, b, c, d, a, 35, 23);
  MD5_STEP(H, a, b, c, d, 36, 4);
  MD5_STEP(H, d, a, b, c, 37, 11);
  MD5_STEP(H, c, d, a, b, 38, 16);
  MD5_STEP(H, b, c, d, a, 39, 23);
  MD5_STEP(H, a, b, c, d, 40, 4);
  MD5_STEP(H, d, a, b, c, 41, 11);
  MD5_STEP(H, c, d, a, b, 42, 16);
  MD5_STEP(H, b, c, d, a, 43, 23);
  MD5_STEP(H, a, b, c, d, 44, 4);
  MD5_STEP(H, d, a, b, c, 45, 11);
  MD5_STEP(H, c, d, a, b, 46, 16);
  MD5_STEP(H, b, c, d, a, 47, 23);
  MD5_STEP(I, a, b, c, d, 48, 6);
  MD5_STEP(I, d, a, b, c, 49, 10);
  MD5_STEP(I, c, d, a, b, 50, 15);
  MD5_STEP(I, b, c, d, a, 51, 21);
  MD5_STEP(I, a, b, c, d, 52, 6);
  MD5_STEP(I, d, a, b, c, 53, 10);
  MD5_STEP(I, c, d, a, b, 54, 15);
  MD5_STEP(I, b, c, d, a, 55, 21);
  MD5_STEP(I, a, b, c, d, 56, 6);
  MD5_STEP(I, d, a, b, c, 57, 10);
  MD5_STEP(I, c, d, a, b, 58, 15);
  MD5_STEP(I, b, c, d, a, 59, 21);
  MD5_STEP(I, a, b, c, d, 60, 6);
  MD5_STEP(I, d, a, b, c, 61, 10);
  MD5_STEP(I, c, d, a, b, 62, 15);
  MD5_STEP(I, b, c, d, a, 63, 21);
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
}

__global__ void __launch_bounds__(32)
flac_md5_kernel(const int32_t* __restrict__ x,
                const int32_t* __restrict__ table,
                const int32_t* __restrict__ blocks,
                uint32_t* __restrict__ state, int F, int C, int n_max) {
  __shared__ __align__(16) uint32_t ring[kMd5Ring / 4];
  __shared__ __align__(16) uint32_t mk[kMd5Blocks][64];
  uint8_t* ring8 = reinterpret_cast<uint8_t*>(ring);
  const int lane = threadIdx.x;
  // Lane l schedules steps l and l + 32 of every block: m[g] + k.
  const int g0 = kMd5G[lane], g1 = kMd5G[lane + 32];
  const uint32_t k0 = kMd5K[lane], k1 = kMd5K[lane + 32];
  const int32_t* row = table + static_cast<int64_t>(blockIdx.x) * kMd5Row;
  const int frame0 = row[0];
  const int frames = row[1];
  int left = row[2];
  const int w = row[3];
  const int flags = row[4];
  if (frames <= 0) return;
  uint32_t* st = state + static_cast<int64_t>(blockIdx.x) * kMd5StateWords;
  uint32_t h[4];
  uint64_t pos = 0;  // message bytes so far
  if (flags & kMd5First) {
    h[0] = 0x67452301u;
    h[1] = 0xefcdab89u;
    h[2] = 0x98badcfeu;
    h[3] = 0x10325476u;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = st[k];
    pos = st[4] | static_cast<uint64_t>(st[5]) << 32;
    if (lane < 16)
      ring[((pos & ~63ull) & (kMd5Ring - 1)) / 4 + lane] = st[8 + lane];
  }
  uint64_t done = pos & ~63ull;  // bytes compressed
  __syncwarp();

  // The rounds: up to kMd5Round samples (channel-interleaved) of one
  // frame, the frames in turn, each frame's block cut to what is left.
  const int fend = min(frame0 + frames, F);
  int f = frame0 - 1, e = 0, E = 0;
  auto next = [&](int& rf, int& re, int& rn) {
    while (e >= E && f < fend) {
      if (++f < fend) {
        const int n = min(blocks[f], left);
        left -= n;
        E = n * C;
        e = 0;
      }
    }
    rf = f;
    re = e;
    rn = f < fend ? min(kMd5Round, E - e) : 0;
    e += rn;
  };
  // The next n whole blocks of the ring, from byte `done`, as m[g] + k.
  auto schedule = [&](int n) {
    for (int b = 0; b < n; ++b) {
      const uint32_t* blk = ring + ((done + 64 * b) & (kMd5Ring - 1)) / 4;
      mk[b][lane] = blk[g0] + k0;
      mk[b][lane + 32] = blk[g1] + k1;
    }
    __syncwarp();
  };
  auto load = [&](int rf, int re, int rn, int32_t (&v)[kMd5Per]) {
#pragma unroll
    for (int q = 0; q < kMd5Per; ++q) {
      const int i = q * 32 + lane;
      v[q] = 0;
      if (i < rn) {
        const int el = re + i;
        const int s = el / C;
        const int c = el - s * C;
        v[q] = __ldg(x + (static_cast<int64_t>(rf) * C + c) * n_max + s);
      }
    }
  };

  int rf, re, rn;
  int32_t v[kMd5Per];
  next(rf, re, rn);
  load(rf, re, rn, v);
  while (rn > 0) {
#pragma unroll
    for (int q = 0; q < kMd5Per; ++q) {
      const int i = q * 32 + lane;
      if (i < rn) {
        const uint64_t p = pos + static_cast<uint64_t>(i) * w;
        const uint32_t u = static_cast<uint32_t>(v[q]);
        for (int b = 0; b < w; ++b)
          ring8[(p + b) & (kMd5Ring - 1)] = static_cast<uint8_t>(u >> (8 * b));
      }
    }
    pos += static_cast<uint64_t>(rn) * w;
    __syncwarp();
    next(rf, re, rn);
    load(rf, re, rn, v);  // in flight while the chain runs
    const int n = static_cast<int>((pos - done) / 64);
    schedule(n);
    for (int b = 0; b < n; ++b) md5_block(h, mk[b]);
    done += 64 * static_cast<uint64_t>(n);
    __syncwarp();
  }

  if (flags & kMd5Last) {
    // Padding: 0x80, zeros to 56 mod 64, the length in bits (64-bit LE).
    const int r = static_cast<int>(pos - done);
    const int nb = r < 56 ? 1 : 2;
    const uint64_t bits = pos * 8;
    for (int i = r + lane; i < 64 * nb; i += 32) {
      const int k = i - (64 * nb - 8);
      const uint8_t byte = i == r ? 0x80
                           : k >= 0 ? static_cast<uint8_t>(bits >> (8 * k))
                                    : 0;
      ring8[(done + i) & (kMd5Ring - 1)] = byte;
    }
    __syncwarp();
    schedule(nb);
    for (int b = 0; b < nb; ++b) md5_block(h, mk[b]);
    if (lane < 4) st[lane] = h[lane];
  } else {
    if (lane < 4) st[lane] = h[lane];
    if (lane == 4) st[4] = static_cast<uint32_t>(pos);
    if (lane == 5) st[5] = static_cast<uint32_t>(pos >> 32);
    if (lane < 16) st[8 + lane] = ring[(done & (kMd5Ring - 1)) / 4 + lane];
  }
}

// The latency of one step of the chain, measured: one thread runs iters
// steps of an MD5 step's chain shape (LOP3, add, rotate and add: three
// dependent operations as compiled), each on the result of the one before.
__global__ void md5_chain_kernel(uint32_t* out, uint32_t c, uint32_t d,
                                 uint32_t k, int iters) {
  uint32_t b = out[0];
#pragma unroll 16
  for (int it = 0; it < iters; ++it) {
    const uint32_t u = md5_F(b, c, d) + k;
    b = __funnelshift_l(u, u, 7) + b;
  }
  out[0] = b;
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

// table [S, 8] and state [S, 24] int32 (see flac_md5_kernel), blocks [F]:
// each frame's block size; x [F, C, n_max] int32. One warp a stream.
extern "C" int flac_md5_launch(const void* x, const void* table,
                               const void* blocks, void* state, int64_t S,
                               int64_t F, int C, int n_max, void* stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  if (S > 0x7fffffff || F > 0x7fffffff || C <= 0 || n_max <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  flac_md5_kernel<<<static_cast<unsigned>(S), 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(blocks), static_cast<uint32_t*>(state),
      static_cast<int>(F), C, n_max);
  return static_cast<int>(cudaGetLastError());
}

// out[0..2] as flac_lpc_attributes, of F3.
extern "C" int flac_md5_attributes(int* out) {
  return kernel_attributes(flac_md5_kernel, 32, out);
}

// One thread, iters steps; out [1] uint32 seeds and takes the chain's
// end.
extern "C" int flac_md5_chain_launch(void* out, int iters, void* stream) {
  if (iters <= 0) return static_cast<int>(cudaErrorInvalidValue);
  md5_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), 0x98badcfeu, 0x10325476u, 0xd76aa478u,
      iters);
  return static_cast<int>(cudaGetLastError());
}
