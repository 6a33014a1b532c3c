// MPEG audio Layer III output placement for Hopper (sm_90a): kernel M3.
//
// M3 mp3_place replaces no TPU program. The reference brings each dense
// chunk's PCM [g, C, 576] to the host, concatenates the chunks, turns each
// clip's granules into [C, G x 576] and cuts off the encoder delay and
// padding there (symphonia_tpu/batch.py: np.concatenate, transpose,
// _gapless_trim): two copies of every sample in host memory, and for a
// request of 32 clips of 30 s most of its time. M3 makes that layout on
// the card instead. After each chunk's M2 it copies the chunk's PCM into
// one buffer that holds a merged group's output, each clip as [C, N]
// already trimmed, the clips back to back in the callers' order, so that a
// clip comes down as one contiguous copy and the host moves no sample. It
// copies and computes nothing: its output is the host layout's to the bit.
//
// The table has one int64 row a clip: first granule (in the group's
// granule order), granules G, trim start, trimmed length N, output offset
// (floats). Output sample n of clip row (k, c) is source sample start + n
// of that clip and channel, which lies in granule first + (start + n) /
// 576 at position (start + n) % 576. A launch takes one chunk (granules
// g0 .. g0 + g of the group) and the rows k0 .. k1 whose granules meet it;
// a clip may straddle chunks, and a trim may start inside any granule.
//
// What bounds it: bytes, each sample read and written once (678 MB for
// the fma_mp3.shard32 cell's request, 0.20 ms at 3.35 TB/s). The design:
//   - the output side is aligned: a thread takes one aligned 16-byte quad
//     of the buffer and writes it with one 16-byte store, so a warp's
//     store is 512 contiguous bytes. The trim shifts the source against
//     the output by (delay mod 4) floats; the thread realigns on the load
//     side, from the two aligned source quads that hold its four values
//     (576 is a multiple of 4, so no quad straddles a granule). The second
//     is the next lane's first, so it comes from L1, not device memory;
//   - quads where a row starts or ends (a clip's channel, the chunk's
//     edge, the trim) hold samples of two rows or of two chunks: each
//     sample there takes its own 4-byte store, so rows never write the
//     same byte;
//   - the grid fills the card at one 4096-granule chunk: y the channel, x
//     the multiprocessors times eight blocks of 256 threads (over C),
//     striding over each row's quads; a row's source positions are 32-bit
//     within the chunk, so a granule index is a multiply-high, not an
//     int64 division.
// A row whose numbers do not fit (a negative count, a trim outside its
// granules, an output outside the buffer) is skipped, so no table makes
// the kernel read or write out of bounds.
//
// Built for the host as well (without __CUDACC__): the same thread body
// behind mp3_place_host, which runs every thread of a grid in turn; the
// CPU tests compare it with the plain twin.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_FN __device__ __forceinline__
using Quad = float4;
M3_FN Quad load_quad(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
M3_FN void store_quad(float* p, Quad v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
#else
#define M3_FN static inline
struct Quad {
  float x, y, z, w;
};
M3_FN Quad load_quad(const float* p) { return Quad{p[0], p[1], p[2], p[3]}; }
M3_FN void store_quad(float* p, Quad v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
  p[3] = v.w;
}
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kGranule = 576;
constexpr int kBlocksPerSm = 2048 / kThreads;

struct Chunk {
  const float* pcm;     // [g, C, 576]
  const int64_t* table;  // [K, 5]
  float* out;
  int64_t g0;  // the chunk's first granule in the group
  int g;       // its granules
  int C;
  int k0, k1;  // the rows that meet it
  int64_t out_n;
};

// Source sample u of the chunk (u / 576 its granule, u % 576 the position)
// in channel c.
M3_FN const float* source(const Chunk& ch, uint32_t u, int c) {
  const uint32_t gi = u / kGranule;
  return ch.pcm + (static_cast<int64_t>(gi) * ch.C + c) * kGranule +
         (u - gi * kGranule);
}

// The quads of row (k, c) that thread `t` of `stride` takes.
M3_FN void place_row(const Chunk& ch, int k, int c, int64_t t,
                     int64_t stride) {
  const int64_t* r = ch.table + 5 * static_cast<int64_t>(k);
  const int64_t first = r[0], G = r[1], start = r[2], N = r[3], off = r[4];
  if (G < 0 || start < 0 || N <= 0 || start > G * kGranule - N || off < 0 ||
      off > ch.out_n - ch.C * N)
    return;
  // Chunk-relative positions: u = (first - g0) * 576 + s for clip sample
  // s, and the output index o = delta + u.
  const int64_t base = (first - ch.g0) * kGranule;
  const int64_t chunk_n = static_cast<int64_t>(ch.g) * kGranule;
  const int64_t u_lo = base + start > 0 ? base + start : 0;
  const int64_t u_end = base + start + N;
  const int64_t u_hi = u_end < chunk_n ? u_end : chunk_n;
  if (u_lo >= u_hi) return;
  const int64_t delta = off + c * N - start - base;
  const int64_t o_lo = delta + u_lo, o_hi = delta + u_hi;
  const int64_t q_end = (o_hi + 3) >> 2;
  const int shift = static_cast<int>((-delta) & 3);
  for (int64_t q = (o_lo >> 2) + t; q < q_end; q += stride) {
    const int64_t o0 = 4 * q;
    float* dst = ch.out + o0;
    if (o0 >= o_lo && o0 + 4 <= o_hi) {
      const uint32_t a = static_cast<uint32_t>(o0 - delta) - shift;
      const Quad A = load_quad(source(ch, a, c));
      if (shift == 0) {
        store_quad(dst, A);
        continue;
      }
      const Quad B = load_quad(source(ch, a + 4, c));
      Quad v;
      if (shift == 1) {
        v = Quad{A.y, A.z, A.w, B.x};
      } else if (shift == 2) {
        v = Quad{A.z, A.w, B.x, B.y};
      } else {
        v = Quad{A.w, B.x, B.y, B.z};
      }
      store_quad(dst, v);
    } else {
      for (int j = 0; j < 4; ++j) {
        const int64_t o = o0 + j;
        if (o >= o_lo && o < o_hi)
          dst[j] = *source(ch, static_cast<uint32_t>(o - delta), c);
      }
    }
  }
}

M3_FN void place_thread(const Chunk& ch, int c, int64_t t, int64_t stride) {
  for (int k = ch.k0; k < ch.k1; ++k) place_row(ch, k, c, t, stride);
}

// Blocks in x: enough for the longest row a chunk can hold (g x 144 + 1
// quads), at most the card's resident blocks shared over the channels.
int64_t grid_x(int g, int C, int sms) {
  const int64_t need =
      (static_cast<int64_t>(g) * (kGranule / 4) + 1 + kThreads - 1) /
      kThreads;
  int64_t fill = static_cast<int64_t>(sms) * kBlocksPerSm / C;
  if (fill < 1) fill = 1;
  return need < fill ? need : fill;
}

bool valid(const void* pcm, const void* out, int64_t g0, int g, int C,
           int K, int k0, int k1) {
  return g > 0 && C > 0 && g0 >= 0 && k0 >= 0 && k0 <= k1 && k1 <= K &&
         static_cast<int64_t>(g) * kGranule <= 0x7fffffffLL &&
         reinterpret_cast<uintptr_t>(pcm) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kThreads)
    mp3_place_kernel(Chunk ch) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  place_thread(ch, blockIdx.y, t, static_cast<int64_t>(gridDim.x) * kThreads);
}
#endif

}  // namespace

#ifdef __CUDACC__
// pcm [g, C, 576] float32 (16-byte aligned): granules g0 .. g0 + g of the
// group; table [K, 5] int64 (first granule, granules, trim start, trimmed
// length, output offset); rows k0 .. k1 of it meet the chunk; out
// [out_n] float32 (16-byte aligned).
extern "C" int mp3_place_launch(const void* pcm, int64_t g0, int g, int C,
                                const void* table, int K, int k0, int k1,
                                void* out, int64_t out_n, void* stream) {
  if (k0 == k1) return static_cast<int>(cudaGetLastError());
  if (!valid(pcm, out, g0, g, C, K, k0, k1))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Chunk ch{static_cast<const float*>(pcm),
                 static_cast<const int64_t*>(table),
                 static_cast<float*>(out), g0, g, C, k0, k1, out_n};
  const dim3 grid(static_cast<unsigned>(grid_x(g, C, sms)),
                  static_cast<unsigned>(C));
  mp3_place_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ch);
  return static_cast<int>(cudaGetLastError());
}

// out[0..2]: registers a thread, local-memory bytes a thread and resident
// blocks an SM of M3.
extern "C" int mp3_place_attributes(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, mp3_place_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], mp3_place_kernel, kThreads, 0);
  if (e == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(e);
}
#else
// The same thread body on the host, every thread of the grid in turn (the
// CPU tests' build of this file); the arguments as mp3_place_launch's,
// with the card's multiprocessors given (`sms`), so that the grid and its
// stride are the card's.
extern "C" int mp3_place_host(const void* pcm, int64_t g0, int g, int C,
                              const void* table, int K, int k0, int k1,
                              void* out, int64_t out_n, int sms) {
  if (k0 == k1) return 0;
  if (!valid(pcm, out, g0, g, C, K, k0, k1) || sms < 1) return -1;
  const Chunk ch{static_cast<const float*>(pcm),
                 static_cast<const int64_t*>(table),
                 static_cast<float*>(out), g0, g, C, k0, k1, out_n};
  const int64_t nx = grid_x(g, C, sms), stride = nx * kThreads;
  for (int c = 0; c < C; ++c)
    for (int64_t t = 0; t < stride; ++t) place_thread(ch, c, t, stride);
  return 0;
}
#endif
