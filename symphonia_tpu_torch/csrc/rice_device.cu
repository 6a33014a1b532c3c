// Device FLAC Rice decode for Hopper (sm_90a): kernel R1 rice_decode.
//
// Replaces symphonia_tpu/ops/rice_device.py:40 rice_decode_lanes (K13), a
// lax.scan over n symbols with the B lanes vectorised. Each lane decodes
// exactly n symbols from its bit cursor in one shared big-endian bitstream
// of W 32-bit words: the unary quotient q is the count of leading zeros of
// the 32-bit window at the cursor (__clz(0) == 32, as lax.clz gives), then
// k remainder bits from the window after the terminator, u = (q << k) | r
// in uint32, and the zig-zag step (u >> 1) ^ -(u & 1) gives the residual.
// Cursors are uint32 and wrap, as the reference's do, and word indices
// clamp to W - 1 as XLA's gather clamps, so no cursor reads outside the
// buffer.
//
// What bounds R1: the chain of symbols in a lane. Its bytes bound is small
// (at [8192, 4096] with k = 4, ~22 MB of words and 134 MB of residuals,
// ~0.05 ms at 3.35 TB/s), and every symbol waits on the cursor of the one
// before it, so a lane's time is its symbols times the latency of one.
// The design keeps memory off that chain and keeps the chain short:
//  - Each lane holds the stream at its cursor in registers, four words
//    w0..w3 and a bit offset, and the two words after them: the 64 bits at
//    the cursor are two funnel shifts, so a symbol is funnel shift -> bfind
//    -> add -> a shift of the window by 0, 1 or 2 words made of selects (no
//    branch), and r comes from the same 64 bits (from the first word alone
//    where q + 1 + k <= 32). The two words after the window are read for
//    the next symbol while this one finishes.
//  - The words after the window wait in a ring of 64 words a lane in
//    shared memory, filled by 16-byte cp.async at every write-back (below)
//    for the words up to 64 past the lane's position, and waited for at the
//    next one. Lanes consume at their own pace, so a load into a register
//    would stall the whole warp whenever any lane refilled; the ring's loads
//    land in shared memory, and the warp waits for them once every 32
//    symbols, long after they were issued. A lane that outruns the ring
//    (over 64 words in two write-back periods) reads its next words from
//    device memory directly.
//  - Residuals are staged in shared memory, 32 symbols of each of a warp's
//    32 lanes, and written back by all 32 threads as 128-byte rows instead
//    of a 4-byte store 16 KB apart for every lane and symbol.
//  - The register reader is exact only while the 64 bits at the cursor lie
//    below 32 * W and the cursor cannot wrap. A lane that gets past that
//    line (or whose k is outside 0..31) decodes the rest of its symbols by
//    the reference's arithmetic: two clamped windows a symbol from memory.
// The words may start anywhere 4-byte aligned: chunks are counted from the
// 16-byte boundary below them, and a chunk that reaches outside the words
// is copied word by word (the words outside are never read).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // a block is a warp: 32 lanes, one a thread
constexpr int kTile = 32;     // symbols a lane stages between write-backs
constexpr int kRing = 64;     // words of a lane's ring (a power of two)
// Ring rows are 16-byte aligned; slots kRing..kRing + 3 repeat slots 0..3,
// so the two words at any slot are adjacent.
constexpr int kRingStride = kRing + 4;

__device__ __forceinline__ uint32_t window(const uint32_t* __restrict__ words,
                                           int64_t last, uint32_t cur) {
  const int64_t wi = cur >> 5;
  const uint32_t off = cur & 31u;
  const uint32_t hi = __ldg(words + (wi < last ? wi : last));
  if (off == 0) return hi;
  const uint32_t lo = __ldg(words + (wi + 1 < last ? wi + 1 : last));
  return (hi << off) | (lo >> (32u - off));
}

// Two words at offsets next and next + 1 from device memory, offsets past
// hi clamped: a lane that outran its ring (kept out of line: it is rare).
__device__ __noinline__ uint2 read2(const uint32_t* __restrict__ src,
                                    uint32_t next, uint32_t hi) {
  return make_uint2(__ldg(src + (next < hi ? next : hi)),
                    __ldg(src + (next + 1 < hi ? next + 1 : hi)));
}

__device__ __forceinline__ void copy16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// A lane's register bit reader. Word indices are offsets from `src`, a
// multiple of kRing words past `pa` (the words' start rounded down to 16
// bytes), so a word's ring slot is its offset % kRing; the stream's words
// are offsets lo..hi. The cursor is 32 * (offset of w0) + off; `next` is
// the offset of the word after w3. The ring holds words [next, issued),
// those below `landed` copied in.
struct Reader {
  uint32_t w0, w1, w2, w3, off;
  uint32_t r4, r5;  // the words at next and next + 1
  uint32_t next, landed, issued;
  const uint32_t* src;
  const uint32_t* ring;
  uint32_t ring_s;  // the ring's shared-space address

  // Request the words up to kRing past `next` (whole chunks; the slots of
  // the words below `next` are free).
  __device__ __forceinline__ void fill(int64_t lo, int64_t hi) {
    const uint32_t end = (next + kRing) & ~3u;
    uint32_t x = (issued > next ? issued : next) & ~3u;
    for (; x < end; x += 4) {
      const uint32_t slot = x & (kRing - 1);
      const uint32_t dst = ring_s + 4u * slot;
      const uint32_t copies = slot == 0 ? 2 : 1;  // slots 0..3 twice
      for (uint32_t i = 0; i < copies; ++i) {
        const uint32_t d = dst + 4u * kRing * i;
        if (x >= lo && x + 3 <= hi) {
          copy16(d, src + x);
        } else {
          for (uint32_t t = 0; t < 4; ++t)
            if (x + t >= lo && x + t <= hi) copy4(d + 4u * t, src + x + t);
        }
      }
    }
    if (end > issued) issued = end;
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // Wait for the last fill, then request the next.
  __device__ __forceinline__ void refill(int64_t lo, int64_t hi) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    landed = issued;
    fill(lo, hi);
  }

  // The two words after w3, from the ring where it holds them, else from
  // device memory (`hi` clamps past the last word). kRingOnly: the caller
  // knows the ring holds them.
  template <bool kRingOnly>
  __device__ __forceinline__ void peek(uint32_t hi) {
    if (kRingOnly || __builtin_expect(next + 2 <= landed, 1)) {
      const uint32_t* p = ring + (next & (kRing - 1));
      r4 = p[0];
      r5 = p[1];
    } else {
      const uint2 v = read2(src, next, hi);
      r4 = v.x;
      r5 = v.y;
    }
  }

  // One symbol of parameter k (kp = 32 + k, rk = 31 - k): returns u and
  // moves the cursor on by q + 1 + k <= 64 bits.
  template <bool kRingOnly>
  __device__ __forceinline__ uint32_t symbol(uint32_t k, uint32_t kp,
                                             uint32_t rk, uint32_t& c,
                                             uint32_t hi) {
    const uint32_t h = __funnelshift_l(w1, w0, off);
    const uint32_t l = __funnelshift_l(w2, w1, off);
    uint32_t pos;  // 31 - q; 0xffffffff (q = 32) when h == 0
    asm("bfind.u32 %0, %1;" : "=r"(pos) : "r"(h));
    const uint32_t q = 31u - pos;
    const uint32_t bits = kp - pos;  // q + 1 + k
    const uint32_t o = (off + kp) - pos;  // off + bits < 96
    c += bits;
    // The window at c1 = c + q + 1, from the same 64 bits (q + 1 <= 33);
    // where q + 1 + k <= 32 its top k bits are h's.
    const uint64_t acc = (static_cast<uint64_t>(h) << 32) | l;
    const uint32_t w2nd = static_cast<uint32_t>((acc << (q + 1u)) >> 32);
    const uint32_t r = (w2nd >> 1) >> rk;  // 0 for k == 0
    // The window moves on by 0, 1 or 2 words.
    const uint32_t sh = o >> 5;
    off = o & 31u;
    const uint32_t a0 = sh == 0 ? w0 : (sh == 1 ? w1 : w2);
    const uint32_t a1 = sh == 0 ? w1 : (sh == 1 ? w2 : w3);
    const uint32_t a2 = sh == 0 ? w2 : (sh == 1 ? w3 : r4);
    const uint32_t a3 = sh == 0 ? w3 : (sh == 1 ? r4 : r5);
    w0 = a0;
    w1 = a1;
    w2 = a2;
    w3 = a3;
    next += sh;
    peek<kRingOnly>(hi);
    return (q << k) | r;
  }
};

__global__ void __launch_bounds__(kThreads)
rice_decode_kernel(const uint32_t* __restrict__ words, int64_t W,
                   const uint32_t* __restrict__ pa, int64_t delta,
                   int64_t limit, const int64_t* __restrict__ cur,
                   const int32_t* __restrict__ param,
                   int32_t* __restrict__ out, int64_t* __restrict__ cur_end,
                   int64_t B, int n) {
  __shared__ int32_t stage[kThreads][kTile + 1];
  __shared__ __align__(16) uint32_t rings[kThreads][kRingStride];
  const int t = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows = B - row0 < kThreads ? static_cast<int>(B - row0) : kThreads;
  // Threads past B (in the last warp) decode nothing and only help write
  // the warp's rows back.
  const bool decodes = t < rows;

  const int64_t last = W - 1;
  uint32_t c = 0, k = 32;
  if (decodes) {
    c = static_cast<uint32_t>(cur[row0 + t]);
    k = static_cast<uint32_t>(param[row0 + t]);
  }
  const uint32_t rs = (32u - k) & 31u;
  const uint32_t kp = 32u + k, rk = 31u - k;
  // The register reader is exact while the 64 bits at the cursor lie in
  // the words and c + 64 does not wrap: c <= limit.
  const uint32_t lim = limit < 0 ? 0u : static_cast<uint32_t>(limit);
  bool fast = decodes && k < 32u && limit >= 0 && c <= lim;
  Reader rd;
  int64_t lo = 0, hi = 0;  // the stream's words, as offsets from src
  uint32_t hi32 = 0;
  if (fast) {
    const int64_t wi = c >> 5;  // <= W - 2
    const int64_t base = (wi + delta) & ~int64_t{kRing - 1};
    lo = delta - base;
    hi = delta + last - base;
    hi32 = hi < 0xffffffffLL ? static_cast<uint32_t>(hi) : 0xffffffffu;
    rd.off = c & 31u;
    rd.w0 = __ldg(words + wi);
    rd.w1 = __ldg(words + wi + 1);
    rd.w2 = __ldg(words + (wi + 2 < last ? wi + 2 : last));
    rd.w3 = __ldg(words + (wi + 3 < last ? wi + 3 : last));
    rd.src = pa + base;
    rd.ring = rings[t];
    rd.ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(rd.ring));
    rd.next = static_cast<uint32_t>(wi + 4 + delta - base);
    rd.issued = rd.next;
    rd.fill(lo, hi);
    rd.refill(lo, hi);  // waits for the first fill
    rd.peek<false>(hi32);
  }

  for (int i0 = 0; i0 < n; i0 += kTile) {
    const int cnt = n - i0 < kTile ? n - i0 : kTile;
    // A symbol moves the cursor by 33 + k bits at most. Where the cursors
    // of the tile stay within the register reader's range, a symbol needs
    // no range test; where the ring also holds every word the tile can
    // read, no ring test. Each warp takes the loop all its lanes allow, so
    // no two loops diverge within it (threads without a lane agree).
    const uint32_t most = static_cast<uint32_t>(cnt) * (33u + k);
    const bool in_range = fast && lim - c >= most;
    const unsigned all = 0xffffffffu;
    if (__all_sync(all, !decodes || (in_range &&
                   rd.landed >= rd.next + (rd.off + most) / 32u + 2u))) {
      if (decodes) {
#pragma unroll 4
        for (int s = 0; s < cnt; ++s) {
          const uint32_t u = rd.symbol<true>(k, kp, rk, c, hi32);
          stage[t][s] = static_cast<int32_t>((u >> 1) ^ (0u - (u & 1u)));
        }
      }
    } else if (__all_sync(all, !decodes || in_range)) {
      if (decodes) {
#pragma unroll 4
        for (int s = 0; s < cnt; ++s) {
          const uint32_t u = rd.symbol<false>(k, kp, rk, c, hi32);
          stage[t][s] = static_cast<int32_t>((u >> 1) ^ (0u - (u & 1u)));
        }
      }
    } else if (decodes) {
      for (int s = 0; s < cnt; ++s) {
        uint32_t u;
        if (fast) {
          u = rd.symbol<false>(k, kp, rk, c, hi32);
          fast = c <= lim;
        } else {
          const uint32_t q = static_cast<uint32_t>(
              __clz(static_cast<int>(window(words, last, c))));
          const uint32_t c1 = c + q + 1u;
          const uint32_t r = k == 0 ? 0u : window(words, last, c1) >> rs;
          c = c1 + k;
          u = (k >= 32u ? 0u : q << k) | r;
        }
        stage[t][s] = static_cast<int32_t>((u >> 1) ^ (0u - (u & 1u)));
      }
    }
    // Row j of the tile goes back as consecutive columns: one 128-byte line.
    __syncwarp();
    if (rows == kThreads && cnt == kTile) {
      int32_t* __restrict__ o = out + row0 * n + i0 + t;
#pragma unroll
      for (int j = 0; j < kThreads; ++j)
        o[j * static_cast<int64_t>(n)] = stage[j][t];
    } else {
      for (int j = 0; j < rows; ++j)
        if (t < cnt) out[(row0 + j) * n + i0 + t] = stage[j][t];
    }
    __syncwarp();
    if (fast) rd.refill(lo, hi);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // none left in flight
  if (decodes) cur_end[row0 + t] = c;
}

}  // namespace

// out [B, n] int32 residuals and cur_end [B] int64 (uint32 values) of B
// lanes at cursors cur [B] (taken mod 2^32) with parameters param [B] over
// words [W] (W >= 1, 4-byte aligned).
extern "C" int rice_decode_launch(const void* words, int64_t W,
                                  const void* cur, const void* param,
                                  void* out, void* cur_end, int64_t B, int n,
                                  void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const uintptr_t addr = reinterpret_cast<uintptr_t>(words);
  if (W <= 0 || n < 0 || addr % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // The last cursor whose 64 bits lie below both 32 * W and 2^32 - 1.
  const int64_t limit = (32 * W < 0xffffffffLL ? 32 * W : 0xffffffffLL) - 64;
  rice_decode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), W,
      reinterpret_cast<const uint32_t*>(addr & ~uintptr_t{15}),
      static_cast<int64_t>((addr >> 2) & 3), limit,
      static_cast<const int64_t*>(cur), static_cast<const int32_t*>(param),
      static_cast<int32_t*>(out), static_cast<int64_t*>(cur_end), B, n);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local (spill) bytes a thread and resident blocks an
// SM of the kernel, from the CUDA runtime.
extern "C" int rice_decode_attributes(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, rice_decode_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], rice_decode_kernel, kThreads, 0);
  if (e == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(e);
}
