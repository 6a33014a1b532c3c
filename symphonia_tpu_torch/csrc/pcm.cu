// PCM batch unpack for Hopper (sm_90a): kernel P1 pcm_unpack.
//
// Replaces symphonia_tpu/ops/pcm.py:174 _combine_bytes_int and :197
// decode_pcm_batch_jax (K12): a padded batch of raw PCM packets, in [B, N]
// uint8 (row stride N bytes), becomes [B, n] int32 samples, n = N / bps; the
// trailing N % bps bytes of a row are dropped, as the reference's
// [:, : n * bps] does. Each sample combines bps bytes in little- or
// big-endian order, then one finish:
//   SIGNED    sign-extend from 8 * bps bits (s8, s16, s24, s32; f32 is the
//             signed 32-bit word, reinterpreted as float32 by the wrapper);
//   UNSIGNED  subtract 1 << (8 * bps - 1) in uint32 (u8, u16, u24; for u32
//             the wrapped subtraction is the reference's sign-bit flip);
//   G.711     mu-law or A-law expansion of the byte, computed in registers
//             from the formulas the 256-entry tables of ops/pcm.py are
//             built from (a table in shared memory costs a gather a
//             sample, whose 32 lookups of a warp collide on banks).
// All arithmetic is on uint32_t: shifting a negative int32_t left is
// undefined in C++17, so words are handled as uint32_t, which is the wrap
// XLA's int32 ops give.
//
// What bounds P1: bytes. It reads B * N bytes and writes 4 * B * n; at
// [16384, 16384] s16le that is 268 MB in and 537 MB out, 0.24 ms at
// 3.35 TB/s, and the arithmetic is a few instructions a sample. So the
// design spends as few instructions and memory transactions a byte as the
// layout allows: a thread makes four consecutive samples of one row from
// ONE load of 4 * bps bytes (4, 8, 16 bytes; three or four words for
// 24-bit samples) and writes them as ONE 16-byte store, so a warp's loads
// and its stores are each one contiguous span; byte order, the 24-bit
// extraction and the sign extension are one prmt (byte permute) a sample.
// Rows are indexed by the grid (no divide, no wrap test a sample). A batch
// whose rows do not start on the load's alignment (N not a multiple of it,
// a view at an odd storage offset) takes the scalar kernel below, a thread
// a sample from single bytes; the launcher chooses from the pointers and N.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSigned = 0;
constexpr int kUnsigned = 1;
constexpr int kMulaw = 2;
constexpr int kAlaw = 3;

// The finish of a sample already sign-extended from 8 * BPS bits. For
// UNSIGNED, u - (1 << (bits - 1)) equals the sign-extended word with its
// sign bit and everything above flipped. G.711 expands in registers (the
// formulas the tables of ops/pcm.py are built from); only the low byte of
// `s` is used.
template <int BPS, int FIN>
__device__ __forceinline__ int32_t finish(uint32_t s) {
  if (FIN == kSigned) return static_cast<int32_t>(s);
  if (FIN == kUnsigned)
    return static_cast<int32_t>(s ^ (0xffffffffu << (8 * BPS - 1)));
  if (FIN == kMulaw) {
    const uint32_t v = ~s;
    const int32_t t = static_cast<int32_t>(
        ((((v & 0x0Fu) << 3) + 0x84u) << ((v & 0x70u) >> 4)) - 0x84u);
    return (v & 0x80u) ? -t : t;
  }
  const uint32_t v = s ^ 0x55u;
  const uint32_t seg = (v & 0x70u) >> 4;
  const int32_t t = static_cast<int32_t>(
      (((v & 0x0Fu) << 4) + (seg == 0 ? 8u : 0x108u))
      << (seg > 1 ? seg - 1 : 0u));
  return (v & 0x80u) ? t : -t;
}

// The prmt selector that builds one sign-extended sample from the
// BPS bytes starting at byte f of the pair {a: bytes 0-3, b: bytes 4-7}:
// result byte i is source byte f + i (little endian) or f + BPS - 1 - i
// (big endian); the bytes above the sample replicate the sign of its most
// significant byte (selector bit 3).
template <int BPS, bool BE>
__host__ __device__ constexpr unsigned selector(int f) {
  unsigned sel = 0;
  for (int i = 0; i < 4; ++i) {
    const int src = i < BPS ? (BE ? f + BPS - 1 - i : f + i)
                            : 8 | (BE ? f : f + BPS - 1);
    sel |= static_cast<unsigned>(src) << (4 * i);
  }
  return sel;
}

// PTX prmt in its default mode: result byte i is byte sel[4i+2 : 4i] of
// {b, a}, or, where sel[4i+3] is set, that byte's sign bit replicated
// (__byte_perm ignores that bit).
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         unsigned sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Sample K (0-3) of a group whose 4 * BPS bytes lie in w[0 .. BPS - 1].
template <int BPS, bool BE, int FIN, int K>
__device__ __forceinline__ int32_t group_sample(const uint32_t (&w)[4]) {
  constexpr int wi = K * BPS / 4;
  constexpr int f = K * BPS % 4;
  constexpr unsigned sel = selector<BPS, BE>(f);
  const uint32_t b = f + BPS > 4 ? w[wi + 1 < 4 ? wi + 1 : 3] : 0u;
  return finish<BPS, FIN>(prmt(w[wi], b, sel));
}

// One sample from single bytes at any alignment.
template <int BPS, bool BE, int FIN>
__device__ __forceinline__ int32_t unpack_scalar(
    const uint8_t* __restrict__ p) {
  uint32_t u = 0;
#pragma unroll
  for (int b = 0; b < BPS; ++b)
    u |= static_cast<uint32_t>(__ldg(p + b)) << (8 * (BE ? BPS - 1 - b : b));
  constexpr int kShift = 32 - 8 * BPS;
  return finish<BPS, FIN>(
      static_cast<uint32_t>(static_cast<int32_t>(u << kShift) >> kShift));
}

// The vector path: grid.x walks a row's groups of four samples, grid.y its
// rows. A thread makes one group from one load of 4 * BPS bytes and stores
// it as 16 bytes. Needs `in` and every row start aligned to the load (4, 8
// or 16 bytes; 4 for 24-bit samples) and `out` to 16 bytes. A row of
// 24-bit samples starts at any sample count in `out`: its groups are
// shifted by a = (row * n) % 4 samples so that the stores stay aligned,
// which puts the group's bytes `a` bytes past a word; four words and a
// funnel shift bring them back. A row's first and last partial groups take
// single bytes.
template <int BPS, bool BE, int FIN>
__global__ void __launch_bounds__(kThreads)
pcm_unpack_vec_kernel(const uint8_t* __restrict__ in,
                      int32_t* __restrict__ out, int64_t B, int64_t n,
                      int64_t N) {
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t row = blockIdx.y; row < B; row += gridDim.y) {
    const uint8_t* __restrict__ src = in + row * N;
    int32_t* __restrict__ dst = out + row * n;
    const int a = BPS == 3 ? static_cast<int>((row * n) & 3) : 0;
    const int64_t j0 = 4 * g - a;
    if (j0 >= n) continue;
    if (j0 >= 0 && j0 + 4 <= n) {
      uint32_t w[4] = {0, 0, 0, 0};
      if (BPS == 1) {
        w[0] = __ldg(reinterpret_cast<const uint32_t*>(src + j0));
      } else if (BPS == 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(src + 2 * j0));
        w[0] = v.x;
        w[1] = v.y;
      } else if (BPS == 4) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + 4 * j0));
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      } else {
        const uint32_t* __restrict__ q =
            reinterpret_cast<const uint32_t*>(src + 3 * j0 - a);
        const uint32_t t0 = __ldg(q), t1 = __ldg(q + 1), t2 = __ldg(q + 2);
        const uint32_t t3 = a ? __ldg(q + 3) : 0u;
        w[0] = __funnelshift_r(t0, t1, 8 * a);
        w[1] = __funnelshift_r(t1, t2, 8 * a);
        w[2] = __funnelshift_r(t2, t3, 8 * a);
      }
      *reinterpret_cast<int4*>(dst + j0) =
          make_int4(group_sample<BPS, BE, FIN, 0>(w),
                    group_sample<BPS, BE, FIN, 1>(w),
                    group_sample<BPS, BE, FIN, 2>(w),
                    group_sample<BPS, BE, FIN, 3>(w));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t j = j0 + k;
        if (j >= 0 && j < n)
          dst[j] = unpack_scalar<BPS, BE, FIN>(src + j * BPS);
      }
    }
  }
}

// The scalar path, for a batch whose rows do not start on the vector
// path's alignment: a thread a sample from single bytes, a warp's stores
// one contiguous span.
template <int BPS, bool BE, int FIN>
__global__ void __launch_bounds__(kThreads)
pcm_unpack_scalar_kernel(const uint8_t* __restrict__ in,
                         int32_t* __restrict__ out, int64_t B, int64_t n,
                         int64_t N) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  for (int64_t row = blockIdx.y; row < B; row += gridDim.y)
    out[row * n + j] = unpack_scalar<BPS, BE, FIN>(in + row * N + j * BPS);
}

// Calls f.run<BPS, BE, FIN>() for the codec's layout.
template <class F>
cudaError_t dispatch(int bps, bool be, int fin, const F& f) {
  switch (bps * 8 + fin * 2 + (be ? 1 : 0)) {
    case 8 + 0: return f.template run<1, false, kSigned>();
    case 8 + 2: return f.template run<1, false, kUnsigned>();
    case 8 + 4: return f.template run<1, false, kMulaw>();
    case 8 + 6: return f.template run<1, false, kAlaw>();
    case 16 + 0: return f.template run<2, false, kSigned>();
    case 16 + 1: return f.template run<2, true, kSigned>();
    case 16 + 2: return f.template run<2, false, kUnsigned>();
    case 16 + 3: return f.template run<2, true, kUnsigned>();
    case 24 + 0: return f.template run<3, false, kSigned>();
    case 24 + 1: return f.template run<3, true, kSigned>();
    case 24 + 2: return f.template run<3, false, kUnsigned>();
    case 24 + 3: return f.template run<3, true, kUnsigned>();
    case 32 + 0: return f.template run<4, false, kSigned>();
    case 32 + 1: return f.template run<4, true, kSigned>();
    case 32 + 2: return f.template run<4, false, kUnsigned>();
    case 32 + 3: return f.template run<4, true, kUnsigned>();
    default: return cudaErrorInvalidValue;
  }
}

// Whether [B, N] at `in` with `out` meets the vector path's alignment.
template <int BPS>
bool vector_ok(const void* in, const void* out, int64_t B, int64_t N) {
  constexpr int kAlign = BPS == 3 ? 4 : 4 * BPS;
  return reinterpret_cast<uintptr_t>(in) % kAlign == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
         (N % kAlign == 0 || (B == 1 && BPS != 3));
}

struct Launch {
  const void* in;
  void* out;
  int64_t B, N;
  cudaStream_t stream;

  template <int BPS, bool BE, int FIN>
  cudaError_t run() const {
    const int64_t n = N / BPS;
    const bool vec = vector_ok<BPS>(in, out, B, N);
    // Threads along a row: groups of four samples (one more where 24-bit
    // groups are shifted), or samples.
    const int64_t items = vec ? (n + 3) / 4 + (BPS == 3 ? 1 : 0) : n;
    const int threads = static_cast<int>(
        items >= kThreads ? kThreads : (items + 31) / 32 * 32);
    const int64_t gx = (items + threads - 1) / threads;
    if (gx > 0x7fffffff) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(gx),
                    static_cast<unsigned>(B < 65535 ? B : 65535));
    const uint8_t* src = static_cast<const uint8_t*>(in);
    int32_t* dst = static_cast<int32_t*>(out);
    if (vec)
      pcm_unpack_vec_kernel<BPS, BE, FIN>
          <<<grid, threads, 0, stream>>>(src, dst, B, n, N);
    else
      pcm_unpack_scalar_kernel<BPS, BE, FIN>
          <<<grid, threads, 0, stream>>>(src, dst, B, n, N);
    return cudaGetLastError();
  }
};

struct Attributes {
  bool vec;
  int* out;

  template <int BPS, bool BE, int FIN>
  cudaError_t run() const {
    cudaFuncAttributes a;
    cudaError_t e;
    if (vec) {
      e = cudaFuncGetAttributes(&a, pcm_unpack_vec_kernel<BPS, BE, FIN>);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[2], pcm_unpack_vec_kernel<BPS, BE, FIN>, kThreads, 0);
    } else {
      e = cudaFuncGetAttributes(&a, pcm_unpack_scalar_kernel<BPS, BE, FIN>);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[2], pcm_unpack_scalar_kernel<BPS, BE, FIN>, kThreads, 0);
    }
    if (e == cudaSuccess) {
      out[0] = a.numRegs;
      out[1] = static_cast<int>(a.localSizeBytes);
    }
    return e;
  }
};

}  // namespace

// out [B, N / bps] int32 = the samples of in [B, N] uint8; bps in 1..4,
// finish 0 signed, 1 unsigned, 2 mu-law, 3 A-law (G.711: bps 1). The
// launcher takes the vector path where the pointers and N allow it.
extern "C" int pcm_unpack_launch(const void* in, void* out, int64_t B,
                                 int64_t N, int bps, int big_endian,
                                 int finish, void* stream) {
  if (bps < 1 || bps > 4 || finish < 0 || finish > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || N / bps <= 0) return static_cast<int>(cudaGetLastError());
  const Launch f{in, out, B, N, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(
      dispatch(bps, bps > 1 && big_endian != 0, finish, f));
}

// out[0..2] = registers a thread, local-memory bytes a thread (nonzero
// where ptxas spilled) and resident blocks an SM of P1's kernel for the
// layout, on the vector or the scalar path.
extern "C" int pcm_unpack_attributes(int bps, int big_endian, int finish,
                                     int vector, int* out) {
  if (bps < 1 || bps > 4 || finish < 0 || finish > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const Attributes f{vector != 0, out};
  return static_cast<int>(
      dispatch(bps, bps > 1 && big_endian != 0, finish, f));
}
