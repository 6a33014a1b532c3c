// True-fp32 SIMT tile for Hopper (sm_90a) that computes half of an IMDCT
// product and writes the whole output, shared by A1 aac_imdct
// (aac_dense.cu) and V1 vorbis_imdct (vorbis_dense.cu).
//
// The product. M is the full [2K, K] IMDCT matrix (one row per output
// column) and A is [L, K]. With h = K / 2, the rows h..h+K-1 of M hold
// every distinct row: row h-1-j is the exact negation of row h+j (j < h)
// and row 2K+h-1-j an exact copy of row h+j (h <= j < K), bit for bit in
// the float32 matrices the port builds (ops/imdct_host.py uses the same
// identity on the host). So the tile computes only
//   Z[L, K] = A . M[h : h+K]^T      (read from M + h * K, no new buffer)
// and its epilogue writes each Z column twice:
//   y[h + j]          =  Z[j]       j < K
//   y[h - 1 - j]      = -Z[j]       j < h
//   y[2K + h - 1 - j] =  Z[j]       h <= j < K.
// Each Z entry is one chain of fmaf in K order starting from +0, the chain
// of the dense product's row h+j; the dense product's mirrored rows are the
// same chain on negated (or equal) matrix entries, whose result is the
// exact negation, except that an exactly zero sum is +0 on both sides
// (round to nearest never turns x + -x into -0, and with no product below
// the normal range no step rounds to a signed zero). The negated copy is
// therefore written as __fsub_rn(0.f, z), never -z, which would turn an
// exact zero (digital silence, padding rows) into -0. Where the identity
// holds exactly the outputs equal the dense SIMT product bit for bit, and
// cuBLAS's fp32 product was seen to match that at the main shapes. The
// one matrix where it does not hold exactly is Vorbis n = 8192 (1618 of its
// 16.8M entries differ by one ulp from the mirror): there V1 is held to its
// bars, not to bits (vorbis_dense.cu).
//
// The tile. One 256-thread block computes 128 rows x 128 Z columns; each
// thread keeps an 8 x 8 register tile: rows 4 ty + 0..3 and 64 + 4 ty +
// 0..3, Z columns 4 tx + 0..3 and 64 + 4 tx + 0..3 (ty, tx in 0..15; a
// quarter-warp shares ty and holds eight consecutive tx). K runs in 32-deep
// slabs through a ring of shared-memory stages filled by cp.async, so slab
// s + 1's copy (and s + 2's, with three stages) is in flight while slab s
// is multiplied, and one __syncthreads guards each slab. Both operands lie
// in shared memory as they lie in device memory, k-contiguous ([row][k]),
// so a 16-byte copy moves four consecutive k untransposed and a thread
// reads four k of one row with one 128-bit shared load: 16 loads per 256
// fmaf. The 16-byte k-quad q of row r is stored at quad q ^ ((r / 4) % 8)
// of that row (no padding): the eight threads of a quarter-warp read rows
// 4 tx + c for eight consecutive tx, whose quads land in eight distinct
// bank groups, and the four row groups of a warp's A reads do too. A row
// pad (stride BK + 4) cannot do this: rows four apart would share a bank
// group, and owning four consecutive Z columns is what lets the epilogue
// write a 16-byte store on each side of the mirror. TMA would need a
// tensor map per operand built on the host; cp.async needs none.
// Registers: 64 sums, 32 of B's and 4 of A's fragments a thread; the
// k-quad loop is not unrolled, which keeps a thread within the 128
// registers that two blocks an SM allow, with no spill.
// The tensor cores offer TF32 at best, which the reference's bars (1e-5 for
// AAC and Vorbis, 1e-6 of the peak in phase 2) do not allow, and a split-K
// or 3xTF32 sum would change the bits that chip_smoke.py's entry step
// compares; so this stays fp32 SIMT in K order.
//
// Shapes: K % 32 == 0 (then h % 16 == 0, so every 16-byte store of the
// epilogue is aligned); Z columns at or past K read zeros and are not
// stored, so K may be below the 128-wide tile (Vorbis n = 64: K = 32). A,
// M and Y must be 16-byte aligned. How A's slab gets into shared memory is
// the caller's (the ALoad policy: A1 dequantizes the entropy stage's
// handoff rows there). A's rows are contiguous (SlabCopy, RowsA:
// V1) or named by a row map that the block keeps in shared memory
// (MappedSlabCopy, MappedRowsA, store_mapped: A1, whose caller picks the
// long or short lanes of a batch by an index on the device, with no
// gather or scatter copy and no count on the host).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace simt_gemm {

constexpr int kThreads = 256;
constexpr int kBM = 128;                     // output rows per block
constexpr int kBN = 128;                     // Z columns per block
constexpr int kBK = 32;                      // K slab
constexpr int kQuads = kBK / 4;              // 16-byte k-quads in a slab row
constexpr int kTileFloats = kBM * kBK;       // one operand of one stage
constexpr int kStageFloats = 2 * kTileFloats;  // A tile, then B tile

__host__ __device__ constexpr int smem_bytes(int stages) {
  return stages * kStageFloats * 4;
}

// Float offset of k-quad q of row r in an operand tile.
__device__ __forceinline__ int quad_offset(int r, int q) {
  return 4 * (r * kQuads + (q ^ ((r >> 2) & 7)));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// This thread's four 16-byte copies of a 128 x 32 slab of a row-major
// [rows, K] operand: slot s is tile row tid / 8 + 32 s, k-quad tid % 8.
// Rows at or past `rows` are zero-filled.
struct SlabCopy {
  const float* src;  // slot 0's row at its k-quad (the operand's start if
                     // that row is past the end: a valid address)
  int slot_stride;   // 32 rows, in floats
  int slots;         // slots 0 .. slots - 1 hold rows before the end
  int dst;           // slot 0's float offset in the tile

  __device__ __forceinline__ SlabCopy(const float* op, int K,
                                      int64_t first_row, int64_t rows) {
    const int tid = threadIdx.x;
    const int row = tid >> 3;
    slots = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) slots += row + 32 * s < rows;
    src = slots ? op + (first_row + row) * K + (tid & 7) * 4 : op;
    slot_stride = 32 * K;
    dst = quad_offset(row, tid & 7);
  }

  // Tile row tid / 8 + 32 s has the swizzle of tid / 8: 32 s / 4 % 8 == 0.
  __device__ __forceinline__ float* slot_dst(float* tile, int s) const {
    return tile + dst + 32 * s * kBK;
  }

  __device__ __forceinline__ void start_one(float* tile, int k0,
                                            int s) const {
    const bool ok = s < slots;
    cp_async16(slot_dst(tile, s), ok ? src + s * slot_stride + k0 : src, ok);
  }

  __device__ __forceinline__ void start(float* tile, int k0) const {
#pragma unroll
    for (int s = 0; s < 4; ++s) start_one(tile, k0, s);
  }
};

// A read straight from a row-major [L, K] array: all of it by cp.async.
struct RowsA {
  SlabCopy copy;
  __device__ __forceinline__ void start(float* tile, int k0) {
    copy.start(tile, k0);
  }
  __device__ __forceinline__ void finish(float* /*tile*/, int /*k0*/) {}
};

// The row-map policy beside SlabCopy: the same four copies of a thread,
// but tile row t is operand row map[t], from the block's 128-entry map in
// shared memory (fill_row_map); -1 is past the end and zero-filled. A slot
// reads its row number from the map at each copy, so the policy keeps no
// more registers than SlabCopy across the product (a pointer, the map's
// address, K and the tile offset).
struct MappedSlabCopy {
  const float* src;  // row 0 of the operand, at this thread's k-quad
  const int* map;    // shared: slot 0's entry; slot s's at map[32 s]
  int K;
  int dst;           // slot 0's float offset in the tile

  __device__ __forceinline__ MappedSlabCopy(const float* op, int K_,
                                            const int* block_map) {
    const int tid = threadIdx.x;
    src = op + (tid & 7) * 4;
    map = block_map + (tid >> 3);
    K = K_;
    dst = quad_offset(tid >> 3, tid & 7);
  }

  // Slot s's operand row, or -1.
  __device__ __forceinline__ int row(int s) const { return map[32 * s]; }

  __device__ __forceinline__ float* slot_dst(float* tile, int s) const {
    return tile + dst + 32 * s * kBK;
  }

  __device__ __forceinline__ void start_one(float* tile, int k0,
                                            int s) const {
    const int r = row(s);
    cp_async16(slot_dst(tile, s),
               r >= 0 ? src + static_cast<int64_t>(r) * K + k0 : src, r >= 0);
  }

  __device__ __forceinline__ void start(float* tile, int k0) const {
#pragma unroll
    for (int s = 0; s < 4; ++s) start_one(tile, k0, s);
  }
};

// A read through the block's row map: all of it by cp.async.
struct MappedRowsA {
  MappedSlabCopy copy;
  __device__ __forceinline__ void start(float* tile, int k0) {
    copy.start(tile, k0);
  }
  __device__ __forceinline__ void finish(float* /*tile*/, int /*k0*/) {}
};

// The block's row map (threads 0..127 write one entry each; the caller
// syncs before the first copy): tile row t of the block at tile row row0,
// g = row0 + t, names operand row group * rows[g / group] + g % group while
// g < end, else -1. A map entry of `rows` names a whole lane of `group`
// consecutive operand rows (AAC's eight short windows of a lane: group 8).
// Operand rows < 2^31.
__device__ __forceinline__ void fill_row_map(int* map, int row0, int end,
                                             const int* __restrict__ rows,
                                             int group) {
  const int t = threadIdx.x;
  if (t >= kBM) return;
  const int g = row0 + t;
  map[t] = g < end ? group * __ldg(rows + g / group) + g % group : -1;
}

// This thread's place in the 16 x 16 thread grid of the block tile.
struct Thread {
  int ty, tx;
  __device__ __forceinline__ Thread() {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    ty = ((w >> 1) << 2) | (lane >> 3);
    tx = ((w & 1) << 3) | (lane & 7);
  }
  // Tile row (or Z column) of register index i in 0..7.
  static __device__ __forceinline__ int offset(int t, int i) {
    return 4 * t + (i & 3) + 64 * (i >> 2);
  }
};

// acc += the product of one stage's A and B tiles over its 32 k.
__device__ __forceinline__ void slab_product(const float* As, const float* Bs,
                                             const Thread& th,
                                             float (&acc)[8][8]) {
  // Rows 4 t + c and 64 + 4 t + c share the swizzle (t & 7).
  const float4* a4 = reinterpret_cast<const float4*>(As) + 4 * kQuads * th.ty;
  const float4* b4 = reinterpret_cast<const float4*>(Bs) + 4 * kQuads * th.tx;
  const int sa = th.ty & 7, sb = th.tx & 7;
#pragma unroll 1
  for (int q = 0; q < kQuads; ++q) {
    const float4* aq = a4 + (q ^ sa);
    const float4* bq = b4 + (q ^ sb);
    float4 b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = bq[((j & 3) + 64 * (j >> 2)) * kQuads];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = aq[((i & 3) + 64 * (i >> 2)) * kQuads];
      // k ascending: each output's fmaf chain stays in K order.
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
    }
  }
}

// acc += the tile's product over K through a ring of kStages stages in
// smem (smem_bytes(kStages)). load_a.start(tile, k0) starts the A tile of
// the slab at k0 (cp.async, or copies it transforms later);
// load_a.finish(tile, k0) completes the tile, after the commit of the
// copies start() began and after the current slab's fmaf.
template <int kStages, class ALoad>
__device__ __forceinline__ void tile_product(ALoad& load_a,
                                             const SlabCopy& load_b, int K,
                                             float* smem, const Thread& th,
                                             float (&acc)[8][8]) {
  static_assert(kStages >= 2, "one stage in flight while one is read");
  const int slabs = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    float* st = smem + s * kStageFloats;
    if (s < slabs) {
      load_a.start(st, s * kBK);
      load_b.start(st + kTileFloats, s * kBK);
    }
    cp_async_commit();
    if (s < slabs) load_a.finish(st, s * kBK);
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slab s landed
    __syncthreads();  // everyone's, and everyone is done with slab s - 1
    const int next = s + kStages - 1;
    float* nt = smem + (next % kStages) * kStageFloats;
    if (next < slabs) {
      load_a.start(nt, next * kBK);
      load_b.start(nt + kTileFloats, next * kBK);
    }
    cp_async_commit();
    const float* st = smem + (s % kStages) * kStageFloats;
    slab_product(st, st + kTileFloats, th, acc);
    if (next < slabs) load_a.finish(nt, next * kBK);
  }
}

// The mirrored epilogue: Y[r, 2K] from this thread's Z[r, col0 + c] for
// rows r < L and Z columns < K, four consecutive columns per 16-byte store
// on each side of the mirror.
__device__ __forceinline__ void store_mirrored(float* __restrict__ Y,
                                               const float (&acc)[8][8],
                                               const Thread& th,
                                               int64_t row0, int64_t L,
                                               int col0, int K) {
  const int h = K / 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = row0 + Thread::offset(th.ty, i);
    if (r >= L) continue;
    float* y = Y + r * 2 * K;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int c = col0 + Thread::offset(th.tx, 4 * g);
      if (c >= K) continue;
      const float4 z = make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                                   acc[i][4 * g + 2], acc[i][4 * g + 3]);
      *reinterpret_cast<float4*>(y + h + c) = z;
      if (c < h) {
        *reinterpret_cast<float4*>(y + h - 4 - c) = make_float4(
            __fsub_rn(0.f, z.w), __fsub_rn(0.f, z.z), __fsub_rn(0.f, z.y),
            __fsub_rn(0.f, z.x));
      } else {
        *reinterpret_cast<float4*>(y + 2 * K + h - 4 - c) =
            make_float4(z.w, z.z, z.y, z.x);
      }
    }
  }
}

// store_mirrored through the block's row map in shared memory (tile row t
// is output row map[t], none where it is negative). A loop of its own: with
// both stores one template over a row function, V1 took 2.6% longer on the
// H100 (tools/time_trees.py, parent and change in one call).
__device__ __forceinline__ void store_mapped(float* __restrict__ Y,
                                             const float (&acc)[8][8],
                                             const Thread& th, const int* map,
                                             int col0, int K) {
  const int h = K / 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = map[Thread::offset(th.ty, i)];
    if (r < 0) continue;
    float* y = Y + static_cast<int64_t>(r) * 2 * K;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int c = col0 + Thread::offset(th.tx, 4 * g);
      if (c >= K) continue;
      const float4 z = make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                                   acc[i][4 * g + 2], acc[i][4 * g + 3]);
      *reinterpret_cast<float4*>(y + h + c) = z;
      if (c < h) {
        *reinterpret_cast<float4*>(y + h - 4 - c) = make_float4(
            __fsub_rn(0.f, z.w), __fsub_rn(0.f, z.z), __fsub_rn(0.f, z.y),
            __fsub_rn(0.f, z.x));
      } else {
        *reinterpret_cast<float4*>(y + 2 * K + h - 4 - c) =
            make_float4(z.w, z.z, z.y, z.x);
      }
    }
  }
}

// Host side: let `kernel` take `smem` bytes of dynamic shared memory (above
// 48 KB only after this opt-in) and prefer the largest shared-memory
// carveout, so that two blocks fit on an SM.
template <class Kernel>
inline cudaError_t opt_in(Kernel kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

// out[0..2] = registers a thread, local-memory bytes a thread (nonzero
// where ptxas spilled) and resident blocks an SM of `kernel` at `smem`
// bytes of dynamic shared memory; returns the CUDA error code.
template <class Kernel>
inline int attributes(Kernel kernel, int smem, int* out) {
  cudaError_t e = opt_in(kernel, smem);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      kThreads, smem);
  if (e == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(e);
}

}  // namespace simt_gemm
