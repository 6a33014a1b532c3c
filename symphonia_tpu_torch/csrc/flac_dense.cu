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
// What bounds F1 on this card: the per-lane recurrence. Each sample waits
// for the previous one (32 dependent multiply-adds and a shift), so a lane
// is a serial chain of ~n_samples * 32 int64 MACs; lanes are the only
// parallelism (16K lanes = 512 warps, ~4 per SM). Memory traffic is small
// by comparison (8 bytes per sample).
// What the design does about it: one thread per lane with the 32-sample
// history and the 32 coefficients in registers (fully unrolled, so no
// local-memory indexing); the dot product is split into four partial sums
// to shorten the dependent chain. Rows are [L, stride] row-major, so one
// thread per row would read strided memory: each warp instead stages a
// [32 lanes x 32 samples] tile through shared memory with coalesced loads
// and stores, and the recurrence reads and writes the tile.
// First perf item: the recurrence latency itself (interleave two lanes
// per thread, or a block-parallel formulation of the prediction).
//
// F2 flac_decorrelate replaces ops/flac_dense.py:84 decorrelate_batch:
// elementwise over [F, 2, n], undoing left/side, right/side and mid/side
// per frame. Bound by memory bandwidth (16 bytes per sample pair); one
// thread per sample pair, coalesced along n, wrapping uint32 arithmetic.
// F2 stays a separate kernel: fusing it into F1 needs one thread to own
// both channel lanes of a frame, which halves F1's lane parallelism, and
// F1 is latency-bound on exactly that parallelism.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOrder = 32;
constexpr int kTile = 32;        // samples per staged tile
constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
flac_lpc_kernel(const int32_t* __restrict__ res, int64_t res_stride,
                const int32_t* __restrict__ coefs,
                const int32_t* __restrict__ order,
                const int32_t* __restrict__ shift,
                const int32_t* __restrict__ wasted,
                int32_t* __restrict__ out, int64_t L, int n) {
  __shared__ int32_t tile[kWarpsPerBlock][kTile][kTile + 1];
  const int warp = threadIdx.x >> 5;
  const int lane_in_warp = threadIdx.x & 31;
  const int64_t lane0 = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                         warp) * 32;
  if (lane0 >= L) return;  // whole warp past the end
  const int64_t lane = lane0 + lane_in_warp;
  const bool live = lane < L;
  int32_t (*t)[kTile + 1] = tile[warp];

  int32_t c[kOrder];
  int32_t h[kOrder];  // h[j] = x[n-1-j]
#pragma unroll
  for (int j = 0; j < kOrder; ++j) {
    c[j] = live ? coefs[lane * kOrder + j] : 0;
    h[j] = 0;
  }
  const int ord = live ? order[lane] : 0;
  const int sh = live ? shift[lane] : 0;
  const int wb = live ? wasted[lane] : 0;
  const bool sh_ok = static_cast<unsigned>(sh) <= 31u;
  const bool wb_ok = static_cast<unsigned>(wb) <= 31u;

  for (int base = 0; base < n; base += kTile) {
    const int width = min(kTile, n - base);
    // Coalesced load: row r of the tile is lane0 + r, threads along n.
#pragma unroll 4
    for (int r = 0; r < 32; ++r) {
      const int64_t ln = lane0 + r;
      if (ln < L && lane_in_warp < width)
        t[r][lane_in_warp] = res[ln * res_stride + base + lane_in_warp];
    }
    __syncwarp();
    for (int i = 0; i < width; ++i) {
      const int nn = base + i;
      const int32_t r_n = t[lane_in_warp][i];
      uint64_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
      for (int j = 0; j < kOrder; j += 4) {
        a0 += static_cast<uint64_t>(static_cast<int64_t>(c[j]) * h[j]);
        a1 += static_cast<uint64_t>(static_cast<int64_t>(c[j + 1]) * h[j + 1]);
        a2 += static_cast<uint64_t>(static_cast<int64_t>(c[j + 2]) * h[j + 2]);
        a3 += static_cast<uint64_t>(static_cast<int64_t>(c[j + 3]) * h[j + 3]);
      }
      const int64_t acc = static_cast<int64_t>((a0 + a1) + (a2 + a3));
      const uint32_t pred =
          sh_ok ? static_cast<uint32_t>(acc >> sh) : 0u;
      const int32_t x_n = nn < ord
          ? r_n
          : static_cast<int32_t>(static_cast<uint32_t>(r_n) + pred);
#pragma unroll
      for (int j = kOrder - 1; j > 0; --j) h[j] = h[j - 1];
      h[0] = x_n;
      t[lane_in_warp][i] =
          wb_ok ? static_cast<int32_t>(static_cast<uint32_t>(x_n) << wb) : 0;
    }
    __syncwarp();
    // Coalesced store of the finished tile.
#pragma unroll 4
    for (int r = 0; r < 32; ++r) {
      const int64_t ln = lane0 + r;
      if (ln < L && lane_in_warp < width)
        out[ln * static_cast<int64_t>(n) + base + lane_in_warp] =
            t[r][lane_in_warp];
    }
    __syncwarp();
  }
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

}  // namespace

extern "C" int flac_lpc_launch(const void* res, int64_t res_stride,
                               const void* coefs, const void* order,
                               const void* shift, const void* wasted,
                               void* out, int64_t L, int n, void* stream) {
  if (L <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t lanes_per_block = 32 * kWarpsPerBlock;
  const unsigned grid =
      static_cast<unsigned>((L + lanes_per_block - 1) / lanes_per_block);
  flac_lpc_kernel<<<grid, 32 * kWarpsPerBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(res), res_stride,
      static_cast<const int32_t*>(coefs), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(shift), static_cast<const int32_t*>(wasted),
      static_cast<int32_t*>(out), L, n);
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
