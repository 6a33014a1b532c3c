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
//   TABLE     a G.711 table lookup (mu-law, A-law), the 256-entry int32
//             table staged in shared memory.
// All arithmetic is on uint32_t: shifting a negative int32_t left is
// undefined in C++17, so the word is shifted as uint32_t, cast, then
// shifted right arithmetically, which is the wrap XLA's int32 ops give.
//
// What bounds P1: bytes. It reads B * N bytes and writes 4 * B * n; at
// [16384, 16384] s16le that is 268 MB in and 537 MB out, 0.24 ms at
// 3.35 TB/s. One thread makes four consecutive outputs of the flattened
// [B * n] index space and stores them as one 16-byte vector (rows may
// split a group; the row and column advance per sample), so stores are
// fully coalesced; the bytes are read one at a time, and a warp's loads
// of one instruction fall in a few 128-byte lines that L1 serves to the
// instructions after it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSigned = 0;
constexpr int kUnsigned = 1;
constexpr int kTable = 2;

template <int BPS, bool BE, int FIN>
__device__ __forceinline__ int32_t unpack(const uint8_t* __restrict__ p,
                                          const int32_t* lut) {
  if (FIN == kTable) return lut[__ldg(p)];
  uint32_t u = 0;
#pragma unroll
  for (int b = 0; b < BPS; ++b)
    u |= static_cast<uint32_t>(__ldg(p + b)) << (8 * (BE ? BPS - 1 - b : b));
  constexpr int kShift = 32 - 8 * BPS;
  if (FIN == kSigned) return static_cast<int32_t>(u << kShift) >> kShift;
  return static_cast<int32_t>(u - (1u << (8 * BPS - 1)));
}

template <int BPS, bool BE, int FIN>
__global__ void __launch_bounds__(kThreads)
pcm_unpack_kernel(const uint8_t* __restrict__ in,
                  const int32_t* __restrict__ table,
                  int32_t* __restrict__ out, int64_t total, int64_t n,
                  int64_t N) {
  __shared__ int32_t lut[FIN == kTable ? 256 : 1];
  if (FIN == kTable) {
    for (int k = threadIdx.x; k < 256; k += kThreads) lut[k] = table[k];
    __syncthreads();
  }
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i0 >= total) return;
  int64_t r = i0 / n;
  int64_t j = i0 - r * n;
  int32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = i0 + k < total ? unpack<BPS, BE, FIN>(in + r * N + j * BPS, lut)
                          : 0;
    if (++j == n) {
      j = 0;
      ++r;
    }
  }
  if (i0 + 4 <= total) {
    *reinterpret_cast<int4*>(out + i0) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k < total) out[i0 + k] = v[k];
  }
}

template <int BPS, bool BE, int FIN>
cudaError_t launch(const void* in, const void* table, void* out, int64_t B,
                   int64_t N, cudaStream_t stream) {
  const int64_t n = N / BPS;
  const int64_t total = B * n;
  const int64_t blocks = (total + 4 * kThreads - 1) / (4 * kThreads);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  pcm_unpack_kernel<BPS, BE, FIN>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const uint8_t*>(in),
          static_cast<const int32_t*>(table), static_cast<int32_t*>(out),
          total, n, N);
  return cudaGetLastError();
}

template <int BPS>
cudaError_t launch_bps(const void* in, const void* table, void* out,
                       int64_t B, int64_t N, bool be, int finish,
                       cudaStream_t s) {
  if (finish == kSigned)
    return be ? launch<BPS, true, kSigned>(in, table, out, B, N, s)
              : launch<BPS, false, kSigned>(in, table, out, B, N, s);
  if (finish == kUnsigned)
    return be ? launch<BPS, true, kUnsigned>(in, table, out, B, N, s)
              : launch<BPS, false, kUnsigned>(in, table, out, B, N, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// out [B, N / bps] int32 = the samples of in [B, N] uint8; bps in 1..4,
// finish 0 signed, 1 unsigned, 2 G.711 table (bps 1, table [256] int32).
extern "C" int pcm_unpack_launch(const void* in, const void* table,
                                 void* out, int64_t B, int64_t N, int bps,
                                 int big_endian, int finish, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N / (bps > 0 ? bps : 1) <= 0)
    return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaErrorInvalidValue;
  const bool be = big_endian != 0;
  switch (bps) {
    case 1:
      if (finish == kTable) {
        if (table == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        err = launch<1, false, kTable>(in, table, out, B, N, s);
      } else {
        err = launch_bps<1>(in, table, out, B, N, false, finish, s);
      }
      break;
    case 2: err = launch_bps<2>(in, table, out, B, N, be, finish, s); break;
    case 3: err = launch_bps<3>(in, table, out, B, N, be, finish, s); break;
    case 4: err = launch_bps<4>(in, table, out, B, N, be, finish, s); break;
    default: break;
  }
  return static_cast<int>(err);
}
