// Device FLAC Rice decode for Hopper (sm_90a): kernel R1 rice_decode.
//
// Replaces symphonia_tpu/ops/rice_device.py:40 rice_decode_lanes (K13), a
// lax.scan over n symbols with the B lanes vectorised. Each lane decodes
// exactly n symbols from its bit cursor in one shared big-endian bitstream
// of W 32-bit words: the unary quotient q is the count of leading zeros of
// the 32-bit window at the cursor (__clz(0) == 32, as lax.clz gives), then
// k remainder bits from the window after the terminator, u = (q << k) | r
// in uint32, and the zig-zag step (u >> 1) ^ -(u & 1) gives the residual.
// Cursors are uint32 and wrap, as the reference's do. A window takes two
// word loads, with indices clamped to W - 1 as XLA's gather clamps, so no
// cursor reads outside the buffer. Shifts by 32 are undefined in CUDA:
// off == 0 takes the high word alone, k == 0 takes no remainder, and the
// remainder shift is (32 - k) & 31, all as the reference writes them.
//
// What bounds R1: the chain of symbols in a lane. Its bytes bound is tiny
// (at [8192, 4096] with k = 4, ~22 MB of words and 134 MB of residuals,
// ~0.05 ms at 3.35 TB/s), but every symbol waits on the cursor of the one
// before it: two dependent windows of loads that L1 or L2 serve, then a
// few integer steps. One thread per lane, 32 threads per block, so the
// lanes spread over every SM; each lane writes its row of the output, so a
// warp's stores are strided by n and merge in L2. Interleaving the stores
// or starting symbols in parallel is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ uint32_t window(const uint32_t* __restrict__ words,
                                           int64_t last, uint32_t cur) {
  const int64_t wi = cur >> 5;
  const uint32_t off = cur & 31u;
  const uint32_t hi = __ldg(words + (wi < last ? wi : last));
  if (off == 0) return hi;
  const uint32_t lo = __ldg(words + (wi + 1 < last ? wi + 1 : last));
  return (hi << off) | (lo >> (32u - off));
}

__global__ void __launch_bounds__(kThreads)
rice_decode_kernel(const uint32_t* __restrict__ words, int64_t last,
                   const int64_t* __restrict__ cur,
                   const int32_t* __restrict__ param,
                   int32_t* __restrict__ out, int64_t* __restrict__ cur_end,
                   int64_t B, int n) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (l >= B) return;
  uint32_t c = static_cast<uint32_t>(cur[l]);
  const uint32_t k = static_cast<uint32_t>(param[l]);
  const uint32_t rs = (32u - k) & 31u;
  int32_t* __restrict__ o = out + l * n;
  for (int i = 0; i < n; ++i) {
    const uint32_t q =
        static_cast<uint32_t>(__clz(static_cast<int>(window(words, last, c))));
    const uint32_t c1 = c + q + 1u;
    const uint32_t r = k == 0 ? 0u : window(words, last, c1) >> rs;
    c = c1 + k;
    const uint32_t u = (k >= 32u ? 0u : q << k) | r;
    o[i] = static_cast<int32_t>((u >> 1) ^ (0u - (u & 1u)));
  }
  cur_end[l] = c;
}

}  // namespace

// out [B, n] int32 residuals and cur_end [B] int64 (uint32 values) of B
// lanes at cursors cur [B] (taken mod 2^32) with parameters param [B] over
// words [W] (W >= 1).
extern "C" int rice_decode_launch(const void* words, int64_t W,
                                  const void* cur, const void* param,
                                  void* out, void* cur_end, int64_t B, int n,
                                  void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (W <= 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  rice_decode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), W - 1,
      static_cast<const int64_t*>(cur), static_cast<const int32_t*>(param),
      static_cast<int32_t*>(out), static_cast<int64_t*>(cur_end), B, n);
  return static_cast<int>(cudaGetLastError());
}
