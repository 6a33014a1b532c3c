// MPEG audio Layer III entropy decode for Hopper (sm_90a): kernel M0.
//
// M0 mp3_entropy replaces no TPU program: the reference extracts Layer III
// on the host (native/mp3_entropy.cpp sh_mp3_extract, called by
// symphonia_tpu/batch.py), and its dense stage takes the float spectra
// from there. M0 does that extraction on the card, frame by frame as the
// scalar path of sh_mp3_extract does it: header and side info (MPEG-1, 2
// and 2.5, CRC), the bit reservoir, scalefactors (scfsi; MPEG-2's
// intensity tables), Huffman big values with linbits and signs, count1
// quads with the part-3 under/overrun epilogue, requantisation, mid/side
// and intensity stereo, and the short-block reorder. It writes each
// granule-channel's 576 spectral values, block type and mixed flag into
// the lanes M1 reads, and one status a frame with the host's codes: 0, or
// -1 header, -2 side info, -3 no main data, -4 reservoir underflow, -5
// scalefactors or Huffman data; and -6 where this kernel does not take a
// frame the host does (another granule count than its clip's, or more
// channels), so that its clip goes to the host.
//
// What bounds it: not bytes (the frames are read once and the spectra
// written once, 0.11 ms for the fma_mp3.shard32 cell's request of 32
// clips of 30 s at 3.35 TB/s) but each frame's serial chain (a code's
// length decides where the next one starts: ~1,000 dependent table probes
// a frame) and, with one thread a frame, the memory system's
// transactions: every store a thread makes lands in its own lanes, so a
// warp's store touches 32 rows. The design:
//   - one thread a frame, all frames of a request in one launch (~37K
//     threads a request, one wave at 64 threads a block), and no serial
//     pass over the reservoir. A frame's main data buffer is the last
//     main_data_begin bytes of its clip's earlier main data, then its
//     own; the thread finds them by walking back over the frames before
//     it, each one's header and side info parsed again (the host's
//     reservoir keeps the main data of every frame whose side info
//     parses, -4 and -5 ones too), and reads them in place as segments of
//     the clip's bytes;
//   - the bit reader keeps 64 bits in a register and refills 32 at a time
//     from two aligned 4-byte loads; a code is one 12-bit table probe (and
//     a 7-bit one for the few longer codes of tables 13, 15 and 16), the
//     tables read through the read-only cache;
//   - requantisation is folded into the writes (a value is written once,
//     scaled by its band's factor), values go out in pairs (8-byte
//     stores), mid/side runs 16 bytes at a time, and the short-block
//     reorder goes through a per-thread buffer of two windows.
//   - the walk to the next segment and the stereo stage are out of line
//     (M0_COLD): inlined at every refill and granule they tripled the
//     kernel's code and its build (33 s against 11 s), for no time.
// On an NVIDIA H100 (700 W) these took the request from 4.8 ms to 3.1 ms.
// ptxas spills ~190 bytes a thread; the build without spills (211
// registers, 32-thread blocks, everything inlined) took 4.5 ms.
//
// Exactness: the values are the host's to the bit. |q|^(4/3), 2^(x/4) and
// the intensity ratios are tables the wrapper computes with the host's
// libm (ops/mp3_entropy.py); every product and sum is one IEEE operation
// (__fmul_rn, __fadd_rn, __fsub_rn), as the host's. The reader follows the
// host's semantics past the end of a buffer: a read that does not fit
// sets a sticky error and returns 0 without moving, a code that does not
// fit fails the frame, an error fails the frame at the next code or
// granule-channel (not after the last one).
//
// Built for the host as well (without __CUDACC__): the same frame body
// behind mp3_entropy_host, which runs it for every frame in turn; the CPU
// tests compare that with the native library.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M0_FN __device__ __forceinline__
#define M0_M __device__ __forceinline__
#define M0_COLD __device__ __noinline__
#define M0_LD(p) __ldg(p)
#define M0_MUL(a, b) __fmul_rn(a, b)
#define M0_ADD(a, b) __fadd_rn(a, b)
#define M0_SUB(a, b) __fsub_rn(a, b)
#else
#define M0_FN static inline
#define M0_M inline
#define M0_COLD static
#define M0_LD(p) (*(p))
#define M0_MUL(a, b) ((a) * (b))
#define M0_ADD(a, b) ((a) + (b))
#define M0_SUB(a, b) ((a) - (b))
#endif

namespace {

// Layout of the three table blocks (ops/mp3_entropy.py `tables`).
// huff (uint16): first level [20][4096] by the next 12 bits (table 1-15 as
// numbered, 16 the linbits tables 16-23, 17 tables 24-31, 18 and 19 count1
// A and B): 0 no code, bit 15 a second-level table, else len << 8 | value;
// then the second-level tables [.][128] by the 7 bits after those 12.
constexpr int kL1Bits = 12;
constexpr int kL2Bits = 7;
constexpr int kL2Base = 20 << kL1Bits;
constexpr int kQuadTable = 18;
// fl (float): |i|^(4/3) for i < 8207, 2^(k/4) for k in [-390, 45], the
// MPEG-1 intensity ratios [7][2], MPEG-2's [2][32][2], 1/sqrt(2).
constexpr int kPow43 = 0;
constexpr int kGain = 8207;
constexpr int kGainMin = -390;
constexpr int kGainMax = 45;
constexpr int kIsM1 = kGain + (kGainMax - kGainMin + 1);
constexpr int kIsM2 = kIsM1 + 14;
constexpr int kSqrtHalf = kIsM2 + 128;
// it (int32): scalefactor bands and the header's tables.
constexpr int kSfbLong = 0;                   // [9][23]
constexpr int kSfbShort = kSfbLong + 207;     // [9][40]
constexpr int kSfbMixed = kSfbShort + 360;    // [9][40], kMixedLen used
constexpr int kMixedLen = kSfbMixed + 360;    // [9]
constexpr int kMixedSwitch = kMixedLen + 9;   // [9]
constexpr int kSlen = kMixedSwitch + 9;       // [16][2]
constexpr int kNsfb = kSlen + 32;             // [6][3][4]
constexpr int kLinbits = kNsfb + 72;          // [32]
constexpr int kPretab = kLinbits + 32;        // [22]
constexpr int kRateL3 = kPretab + 22;         // [15] MPEG-1 Layer III
constexpr int kRateLsf = kRateL3 + 15;        // [15] MPEG-2/2.5 Layer II/III
constexpr int kSampleRate = kRateLsf + 15;    // [3][3] by version row
// Widest short band (66 lines at 48 kHz): one window triplet.
constexpr int kMaxShortWidth = 66;

struct Ctx {
  const uint8_t* data;
  int64_t n;             // bytes of data
  const int64_t* frames; // [F][2]: offset, size
  const int64_t* clips;  // [K][5]: first frame, frames, first lane, C, granules
  int K;
  int64_t L;             // lanes of the outputs
  const uint16_t* huff;
  const float* fl;
  const int32_t* it;
};

M0_FN int ti(const Ctx& c, int i) { return M0_LD(c.it + i); }
M0_FN float tf(const Ctx& c, int i) { return M0_LD(c.fl + i); }

// Four bytes at data[i..i+3], big-endian; zeros past n.
M0_FN uint32_t ld_be32(const Ctx& c, int64_t i) {
#ifdef __CUDACC__
  if (i >= 0 && i + 8 <= c.n) {
    const uint32_t* w =
        reinterpret_cast<const uint32_t*>(c.data + (i & ~int64_t(3)));
    const uint32_t v =
        __funnelshift_r(__ldg(w), __ldg(w + 1), static_cast<int>(i & 3) * 8);
    return __byte_perm(v, 0, 0x0123);
  }
#endif
  uint32_t v = 0;
  for (int k = 0; k < 4; ++k)
    v = (v << 8) | (i + k < c.n ? c.data[i + k] : 0u);
  return v;
}

struct Hdr {
  int version;  // 1, 2, 3 (2.5)
  int sr_idx;
  int channel_mode;  // 0 stereo 1 joint 2 dual 3 mono
  int mode_ext;
  bool crc;
  int frame_size;
  M0_M int n_ch() const { return channel_mode == 3 ? 1 : 2; }
  M0_M bool mpeg1() const { return version == 1; }
  M0_M bool intensity() const { return channel_mode == 1 && (mode_ext & 1); }
  M0_M bool mid_side() const { return channel_mode == 1 && (mode_ext & 2); }
  M0_M int side_len() const {
    return mpeg1() ? (n_ch() == 1 ? 17 : 32) : (n_ch() == 1 ? 9 : 17);
  }
  M0_M int md_pos() const { return 4 + (crc ? 2 : 0) + side_len(); }
};

M0_FN bool parse_hdr(const Ctx& c, uint32_t w, Hdr* h) {
  if (((w >> 21) & 0x7FF) != 0x7FF) return false;
  const int vb = (w >> 19) & 3;
  if (vb == 1) return false;
  h->version = vb == 3 ? 1 : (vb == 2 ? 2 : 3);
  if (((w >> 17) & 3) != 1) return false;  // Layer III only
  h->crc = !((w >> 16) & 1);
  const int bi = (w >> 12) & 0xF;
  if (bi == 0 || bi == 15) return false;
  const int ri = (w >> 10) & 3;
  if (ri == 3) return false;
  const int padding = (w >> 9) & 1;
  h->channel_mode = (w >> 6) & 3;
  h->mode_ext = (w >> 4) & 3;
  if ((w & 3) == 2) return false;
  const int64_t rate = ti(c, kSampleRate + (h->version - 1) * 3 + ri);
  h->sr_idx = (h->version - 1) * 3 + ri;
  const int64_t bitrate = ti(c, (h->version == 1 ? kRateL3 : kRateLsf) + bi);
  const int64_t spf = h->version == 1 ? 1152 : 576;
  h->frame_size = static_cast<int>(spf / 8 * bitrate / rate) + padding;
  return true;
}

// MSB-first reader over contiguous bytes (a frame's side info, which the
// header's frame size always holds, so it never runs out). Its methods
// take the context, so the readers hold no copy of it: its fields stay
// the kernel's parameters.
struct RBits {
  int64_t byte;
  uint64_t cache;
  int cnt;
  M0_M uint32_t read(const Ctx& c, int nb) {
    if (cnt < nb) {
      cache |= static_cast<uint64_t>(ld_be32(c, byte)) << (32 - cnt);
      cnt += 32;
      byte += 4;
    }
    const uint32_t v = static_cast<uint32_t>(cache >> (64 - nb));
    cache <<= nb;
    cnt -= nb;
    return v;
  }
};

struct Gc {
  int part23, big_values, global_gain, scalefac_compress;
  int block_type;  // 0 long 1 start 2 short 3 end
  bool mixed;
  int table_select[3], subblock_gain[3];
  int region1_start, region2_start;
  bool preflag, scalefac_scale;
  int count1table;
  int rzero;
};

// Side info of the frame whose side info starts at byte `at`: the host's
// read_side_info; false where it fails (big_values > 288, or a window
// switch with block type 0).
M0_FN bool read_side_info(const Ctx& c, const Hdr& h, int64_t at,
                          int* main_data_begin, bool scfsi[2][4],
                          Gc gr[2][2]) {
  RBits bs{at, 0, 0};
  const int n_ch = h.n_ch();
  const int sfb_long = kSfbLong + h.sr_idx * 23;
  if (h.mpeg1()) {
    *main_data_begin = bs.read(c, 9);
    bs.read(c, n_ch == 1 ? 5 : 3);
    for (int ch = 0; ch < n_ch; ch++)
      for (int i = 0; i < 4; i++) scfsi[ch][i] = bs.read(c, 1);
  } else {
    *main_data_begin = bs.read(c, 8);
    bs.read(c, n_ch == 1 ? 1 : 2);
    for (int ch = 0; ch < 2; ch++)
      for (int i = 0; i < 4; i++) scfsi[ch][i] = false;
  }
  const int n_gr = h.mpeg1() ? 2 : 1;
  for (int g = 0; g < n_gr; g++)
    for (int ch = 0; ch < n_ch; ch++) {
      Gc& q = gr[g][ch];
      q.part23 = bs.read(c, 12);
      q.big_values = bs.read(c, 9);
      if (q.big_values > 288) return false;
      q.global_gain = bs.read(c, 8);
      q.scalefac_compress = bs.read(c, h.mpeg1() ? 4 : 9);
      if (bs.read(c, 1)) {
        const int bt = bs.read(c, 2);
        const bool mixed = bs.read(c, 1);
        if (bt == 0) return false;
        q.block_type = bt;
        q.mixed = mixed && bt == 2;
        q.table_select[0] = bs.read(c, 5);
        q.table_select[1] = bs.read(c, 5);
        q.table_select[2] = 0;
        for (int i = 0; i < 3; i++) q.subblock_gain[i] = bs.read(c, 3);
        if (h.version == 3)
          q.region1_start =
              ti(c, sfb_long + ((q.block_type == 2 && !q.mixed) ? 6 : 8));
        else if (h.mpeg1() || bt == 2)
          q.region1_start = 36;
        else
          q.region1_start = 54;
        q.region2_start = 576;
      } else {
        q.block_type = 0;
        q.mixed = false;
        for (int i = 0; i < 3; i++) q.table_select[i] = bs.read(c, 5);
        for (int i = 0; i < 3; i++) q.subblock_gain[i] = 0;
        const int r0 = bs.read(c, 4) + 1;
        const int r01 = bs.read(c, 3) + r0 + 1;
        q.region1_start = ti(c, sfb_long + r0);
        q.region2_start = r01 <= 22 ? ti(c, sfb_long + r01) : 576;
      }
      q.preflag = h.mpeg1() ? bs.read(c, 1) : false;
      q.scalefac_scale = bs.read(c, 1);
      q.count1table = bs.read(c, 1);
    }
  return true;
}

// Whether the host's side-info parse of frame `at` succeeds: the same
// fields skipped, the same two tests.
M0_FN bool side_info_ok(const Ctx& c, const Hdr& h, int64_t at) {
  RBits bs{at, 0, 0};
  const int n_ch = h.n_ch();
  bs.read(c, h.mpeg1() ? (n_ch == 1 ? 18 : 20) : (n_ch == 1 ? 9 : 10));
  const int n_gr = h.mpeg1() ? 2 : 1;
  for (int g = 0; g < n_gr; g++)
    for (int ch = 0; ch < n_ch; ch++) {
      bs.read(c, 12);
      if (bs.read(c, 9) > 288) return false;
      bs.read(c, h.mpeg1() ? 12 : 17);
      if (bs.read(c, 1)) {
        if (bs.read(c, 2) == 0) return false;
        bs.read(c, 20);
      } else {
        bs.read(c, 22);
      }
      bs.read(c, h.mpeg1() ? 3 : 2);
    }
  return true;
}

// Frame j's status as far as its main data is concerned (0, -1, -2, -3),
// and where its main data lies.
M0_FN int frame_main_data(const Ctx& c, int j, Hdr* h, int64_t* md,
                          int* md_len) {
  const int64_t off = c.frames[2 * int64_t(j)];
  const int64_t size = c.frames[2 * int64_t(j) + 1];
  if (off < 0 || size < 4 || off + size > c.n ||
      !parse_hdr(c, ld_be32(c, off), h) || h->frame_size > size)
    return -1;
  if (!side_info_ok(c, *h, off + 4 + (h->crc ? 2 : 0))) return -2;
  *md = off + h->md_pos();
  *md_len = h->frame_size - h->md_pos();
  return *md_len < 0 ? -3 : 0;
}

// The segment of a frame's main data buffer after frame `frame`'s: the
// next frame before f whose main data the host keeps, else f's own. Out
// of line: the readers cross a segment a few times a frame, and inlined at
// each of their refills it multiplied the kernel's code.
struct Seg {
  int64_t raw;
  int frame, len;
};

M0_COLD Seg next_seg(const uint8_t* data, int64_t n, const int64_t* frames,
                     const int32_t* it, int frame, int f) {
  const Ctx c{data, n, frames, nullptr, 0, 0, nullptr, nullptr, it};
  int j = frame + 1;
  int64_t md = 0;
  int md_len = 0;
  Hdr h;
  while (j < f && frame_main_data(c, j, &h, &md, &md_len) != 0) ++j;
  if (j >= f) {
    const int64_t off = frames[2 * int64_t(f)];
    parse_hdr(c, ld_be32(c, off), &h);
    md = off + h.md_pos();
    md_len = h.frame_size - h.md_pos();
    j = f;
  }
  return Seg{md, j, md_len};
}

// MSB-first reader over a frame's main data buffer: the reservoir's bytes
// (the tail of earlier frames' main data, frame by frame) then the frame's
// own, read in place as segments. bits_read(), read() and the sticky
// error follow the host's Bits exactly. Positions in the buffer (at most
// 511 bytes and a frame's) are 32-bit; the methods take the context, as
// RBits's do.
struct MBits {
  int f;              // this frame: the last segment
  int len;            // bytes in the buffer
  int seg_frame;      // frame of the current segment
  int seg_v0, seg_v1; // its first and end byte in the buffer
  int64_t seg_raw;    // data offset of its first byte
  int nbyte;          // next byte of the buffer to load
  uint64_t cache;     // left-aligned; bits past cnt are zero
  int cnt;
  bool error;

  M0_M void next_segment(const Ctx& c) {
    const Seg s = next_seg(c.data, c.n, c.frames, c.it, seg_frame, f);
    seg_frame = s.frame;
    seg_v0 = seg_v1;
    seg_v1 += s.len;
    seg_raw = s.raw;
  }
  M0_M uint32_t byte_at(const Ctx& c, int q) {
    while (q >= seg_v1) next_segment(c);
    return c.data[seg_raw + (q - seg_v0)];
  }
  M0_M void refill(const Ctx& c) {
    while (nbyte < len && nbyte >= seg_v1) next_segment(c);
    if (cnt <= 32 && nbyte + 4 <= seg_v1) {
      cache |= static_cast<uint64_t>(ld_be32(c, seg_raw + (nbyte - seg_v0)))
               << (32 - cnt);
      cnt += 32;
      nbyte += 4;
      return;
    }
    while (cnt <= 56 && nbyte < len) {
      cache |= static_cast<uint64_t>(byte_at(c, nbyte)) << (56 - cnt);
      cnt += 8;
      ++nbyte;
    }
  }
  M0_M void need(const Ctx& c, int nb) {
    if (cnt < nb) refill(c);
  }
  M0_M int bits_read() const { return nbyte * 8 - cnt; }
  M0_M void skip(int nb) {
    cache <<= nb;
    cnt -= nb;
  }
  M0_M uint32_t read(const Ctx& c, int nb) {
    if (nb == 0) return 0;
    need(c, nb);
    if (cnt < nb) {
      error = true;
      return 0;
    }
    const uint32_t v = static_cast<uint32_t>(cache >> (64 - nb));
    skip(nb);
    return v;
  }
  M0_M void ignore(const Ctx& c, int n) {
    while (n > 32) {
      read(c, 32);
      n -= 32;
    }
    if (n > 0) read(c, n);
  }
  // One code of table t: its value, or -1 where the frame fails (an
  // earlier error, no code, or a code longer than what is left).
  M0_M int decode(const Ctx& c, int t) {
    if (error) return -1;
    need(c, kL1Bits + kL2Bits);
    const uint32_t top = static_cast<uint32_t>(cache >> (64 - kL1Bits - kL2Bits));
    uint32_t e = M0_LD(c.huff + (t << kL1Bits) + (top >> kL2Bits));
    if (e & 0x8000u)
      e = M0_LD(c.huff + kL2Base + ((e & 0x7FFFu) << kL2Bits) +
                (top & ((1u << kL2Bits) - 1)));
    const int ln = static_cast<int>(e >> 8);
    if (e == 0 || ln > cnt) return -1;
    skip(ln);
    return static_cast<int>(e & 0xFF);
  }
};

M0_FN int read_scf_mpeg1(const Ctx& c, MBits& bs, int g, int ch,
                         const bool scfsi[2][4], const Gc& q,
                         uint8_t sf[2][2][40]) {
  const int slen1 = ti(c, kSlen + q.scalefac_compress * 2);
  const int slen2 = ti(c, kSlen + q.scalefac_compress * 2 + 1);
  uint8_t* s = sf[g][ch];
  int bits = 0;
  if (q.block_type == 2) {
    const int n_sfb = q.mixed ? 8 + 9 : 18;
    if (slen1) {
      for (int i = 0; i < n_sfb; i++) s[i] = bs.read(c, slen1);
      bits += n_sfb * slen1;
    }
    if (slen2) {
      for (int i = n_sfb; i < n_sfb + 18; i++) s[i] = bs.read(c, slen2);
      bits += 18 * slen2;
    }
  } else {
    const int lo[4] = {0, 6, 11, 16}, hi[4] = {6, 11, 16, 21};
    for (int i = 0; i < 4; i++) {
      const int slen = i < 2 ? slen1 : slen2;
      if (g > 0 && scfsi[ch][i]) {
        for (int k = lo[i]; k < hi[i]; k++) s[k] = sf[0][ch][k];
      } else if (slen) {
        for (int k = lo[i]; k < hi[i]; k++) s[k] = bs.read(c, slen);
        bits += slen * (hi[i] - lo[i]);
      }
    }
  }
  return bits;
}

M0_FN int read_scf_mpeg2(const Ctx& c, MBits& bs, bool is_intensity, Gc& q,
                         uint8_t* s) {
  const int block_index =
      (q.block_type == 2 && q.mixed) ? 2 : (q.block_type == 2 ? 1 : 0);
  int slens[4];
  int row;
  if (is_intensity) {
    const int sfc = q.scalefac_compress >> 1;
    if (sfc < 180) {
      slens[0] = sfc / 36; slens[1] = (sfc % 36) / 6;
      slens[2] = (sfc % 36) % 6; slens[3] = 0;
      row = 0;
    } else if (sfc < 244) {
      slens[0] = ((sfc - 180) % 64) >> 4; slens[1] = ((sfc - 180) % 16) >> 2;
      slens[2] = (sfc - 180) % 4; slens[3] = 0;
      row = 1;
    } else {
      slens[0] = (sfc - 244) / 3; slens[1] = (sfc - 244) % 3;
      slens[2] = 0; slens[3] = 0;
      row = 2;
    }
  } else {
    const int sfc = q.scalefac_compress;
    q.preflag = sfc >= 500;
    if (sfc < 400) {
      slens[0] = (sfc >> 4) / 5; slens[1] = (sfc >> 4) % 5;
      slens[2] = (sfc % 16) >> 2; slens[3] = sfc % 4;
      row = 3;
    } else if (sfc < 500) {
      slens[0] = ((sfc - 400) >> 2) / 5; slens[1] = ((sfc - 400) >> 2) % 5;
      slens[2] = (sfc - 400) % 4; slens[3] = 0;
      row = 4;
    } else {
      slens[0] = (sfc - 500) / 3; slens[1] = (sfc - 500) % 3;
      slens[2] = 0; slens[3] = 0;
      row = 5;
    }
  }
  const int nsfb = kNsfb + (row * 3 + block_index) * 4;
  int bits = 0, start = 0;
  for (int i = 0; i < 4; i++) {
    const int slen = slens[i], n = ti(c, nsfb + i);
    if (slen) {
      for (int k = start; k < start + n; k++) s[k] = bs.read(c, slen);
      bits += slen * n;
    }
    start += n;
  }
  return bits;
}

M0_FN void zero_lane(float* buf) {
#ifdef __CUDACC__
  float4* b4 = reinterpret_cast<float4*>(buf);
  for (int k = 0; k < 144; ++k) b4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#else
  for (int k = 0; k < 576; ++k) buf[k] = 0.f;
#endif
}

M0_FN float gain(const Ctx& c, int k) { return tf(c, kGain + k - kGainMin); }

// The host's requantize, folded into the values' writes: band j of the
// granule-channel's scalefactor bands (long, short, or mixed: long bands
// then short ones) scales every value written in it by
// 2^((global_gain - 210 - 8 subblock_gain - (scalefactor + pretab) <<
// shift) / 4). Values past rzero are zeros, which the host leaves alone
// and a product would leave +0, so the result is the host's.
struct Bands {
  int base, n_long, j, end, a, shift;
  bool preflag;
  const uint8_t* sf;
  const int* sbg;
  float m;

  M0_M void set(const Ctx& c, int jj) {
    j = jj;
    end = ti(c, base + j + 1);
    if (j < n_long) {
      const int pre = preflag ? ti(c, kPretab + j) : 0;
      m = gain(c, a - ((sf[j] + pre) << shift));
    } else {
      m = gain(c, a - 8 * sbg[(j - n_long) % 3] - (sf[j] << shift));
    }
  }
  M0_M float at(const Ctx& c, int k) {
    while (k >= end) set(c, j + 1);
    return m;
  }
};

M0_FN Bands bands_of(const Ctx& c, const Hdr& h, const Gc& q,
                     const uint8_t* sf) {
  Bands b;
  if (q.block_type == 2 && !q.mixed) {
    b.base = kSfbShort + h.sr_idx * 40;
    b.n_long = 0;
  } else if (q.block_type == 2) {
    b.base = kSfbMixed + h.sr_idx * 40;
    b.n_long = ti(c, kMixedSwitch + h.sr_idx);
  } else {
    b.base = kSfbLong + h.sr_idx * 23;
    b.n_long = 22;
  }
  b.a = q.global_gain - 210;
  b.shift = q.scalefac_scale ? 2 : 1;
  b.preflag = q.preflag;
  b.sf = sf;
  b.sbg = q.subblock_gain;
  b.set(c, 0);
  return b;
}

// Two values at buf[i] (i even): one 8-byte store on the card.
M0_FN void store2(float* buf, int i, float a, float b) {
#ifdef __CUDACC__
  *reinterpret_cast<float2*>(buf + i) = make_float2(a, b);
#else
  buf[i] = a;
  buf[i + 1] = b;
#endif
}

M0_FN float pow43(const Ctx& c, int x, uint32_t sign) {
  const float v = tf(c, kPow43 + x);
  return sign ? -v : v;
}

// The host's read_huffman and requantize: false where the frame fails.
M0_FN bool read_huffman(const Ctx& c, MBits& bs, const Hdr& h, Gc& q,
                        const uint8_t* sf, int part3, float* buf) {
  zero_lane(buf);
  if (part3 == 0) {
    q.rzero = 0;
    return true;
  }
  Bands band = bands_of(c, h, q, sf);
  const int start = bs.bits_read();
  int i = 0;
  const int bvlen = 2 * q.big_values;
  const int regions[3] = {
      q.region1_start < bvlen ? q.region1_start : bvlen,
      q.region2_start < bvlen ? q.region2_start : bvlen,
      bvlen < 576 ? bvlen : 576,
  };
  for (int r = 0; r < 3; r++) {
    const int ts = q.table_select[r];
    if (ts == 0 || ts == 4 || ts == 14) {
      if (i < regions[r]) i = regions[r];
      continue;
    }
    const int linbits = ti(c, kLinbits + ts);
    const int t = ts <= 15 ? ts : (ts <= 23 ? 16 : 17);
    while (i < regions[r] && bs.bits_read() - start < part3) {
      const int v = bs.decode(c, t);
      if (v < 0) return false;
      int x = v >> 4, y = v & 15;
      // Band boundaries are even: a pair lies in one band. A zero is
      // written +0, as the lane holds already.
      const float m = band.at(c, i);
      float vx = 0.f, vy = 0.f;
      if (x) {
        if (x == 15 && linbits) x += bs.read(c, linbits);
        vx = M0_MUL(pow43(c, x, bs.read(c, 1)), m);
      }
      if (y) {
        if (y == 15 && linbits) y += bs.read(c, linbits);
        vy = M0_MUL(pow43(c, y, bs.read(c, 1)), m);
      }
      store2(buf, i, vx, vy);
      i += 2;
    }
  }
  const int t1 = kQuadTable + q.count1table;
  while (i <= 572 && bs.bits_read() - start < part3) {
    const int v = bs.decode(c, t1);
    if (v < 0) return false;
    float q4[4];
    for (int j = 0; j < 4; j++)
      q4[j] = (v & (8 >> j))
                  ? M0_MUL(bs.read(c, 1) ? -1.0f : 1.0f, band.at(c, i + j))
                  : 0.f;
    store2(buf, i, q4[0], q4[1]);
    store2(buf, i + 2, q4[2], q4[3]);
    i += 4;
  }
  const int bits_read = bs.bits_read() - start;
  if (bits_read < part3) {
    bs.ignore(c, part3 - bits_read);
  } else if (bits_read > part3 && i > bvlen) {
    i -= 4;
    for (int j = 0; j < 4; j++) buf[i + j] = 0.f;
  }
  q.rzero = i;
  return true;
}

M0_FN void reorder(const Ctx& c, const Hdr& h, Gc& q, float* buf) {
  if (q.block_type != 2) return;
  int bands, n;
  if (q.mixed) {
    const int sw = ti(c, kMixedSwitch + h.sr_idx);
    bands = kSfbMixed + h.sr_idx * 40 + sw;
    n = ti(c, kMixedLen + h.sr_idx) - sw;
  } else {
    bands = kSfbShort + h.sr_idx * 40;
    n = 40;
  }
  // Windows 1 and 2 of a band set aside, then the band's lines written
  // interleaved from its last: line k's three values go to 3k..3k+2, past
  // window 0's lines still to be read.
  float tmp[2 * kMaxShortWidth];
  int i = ti(c, bands);
  for (int bi = 0; bi + 3 < n; bi += 3) {
    const int s0 = ti(c, bands + bi), s1 = ti(c, bands + bi + 1);
    if (s0 >= q.rzero) break;
    const int w = s1 - s0;
    for (int k = 0; k < 2 * w; k++) tmp[k] = buf[s1 + k];
    for (int k = w - 1; k >= 0; k--) {
      const float v = buf[s0 + k];
      buf[s0 + 3 * k] = v;
      buf[s0 + 3 * k + 1] = tmp[k];
      buf[s0 + 3 * k + 2] = tmp[w + k];
    }
    i = s0 + 3 * w;
  }
  if (q.rzero < i) q.rzero = i;
}

M0_FN bool band_zero(const float* p, int n) {
  for (int i = 0; i < n; i++)
    if (p[i] != 0) return false;
  return true;
}

M0_FN void mid_side1(float* __restrict__ c0, float* __restrict__ c1, int k,
                     float s) {
  const float l = M0_MUL(M0_ADD(c0[k], c1[k]), s);
  const float r = M0_MUL(M0_SUB(c0[k], c1[k]), s);
  c0[k] = l;
  c1[k] = r;
}

// Mid/side over lines [lo, hi) of the lanes c0 and c1 (16-byte aligned):
// 16 bytes at a time between the ends on the card.
M0_FN void mid_side(const Ctx& c, float* __restrict__ c0,
                     float* __restrict__ c1, int lo, int hi) {
  const float s = tf(c, kSqrtHalf);
  int k = lo;
#ifdef __CUDACC__
  for (; k < hi && (k & 3); ++k) mid_side1(c0, c1, k, s);
  for (; k + 4 <= hi; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(c0 + k);
    const float4 b = *reinterpret_cast<const float4*>(c1 + k);
    *reinterpret_cast<float4*>(c0 + k) = make_float4(
        M0_MUL(M0_ADD(a.x, b.x), s), M0_MUL(M0_ADD(a.y, b.y), s),
        M0_MUL(M0_ADD(a.z, b.z), s), M0_MUL(M0_ADD(a.w, b.w), s));
    *reinterpret_cast<float4*>(c1 + k) = make_float4(
        M0_MUL(M0_SUB(a.x, b.x), s), M0_MUL(M0_SUB(a.y, b.y), s),
        M0_MUL(M0_SUB(a.z, b.z), s), M0_MUL(M0_SUB(a.w, b.w), s));
  }
#endif
  for (; k < hi; ++k) mid_side1(c0, c1, k, s);
}

// table: the ratio pairs' first float; inv_pos: positions at and above it
// are not intensity-coded. Lines [lo, hi).
M0_FN void apply_intensity(const Ctx& c, int pos, int table, int inv_pos,
                           bool ms, float* __restrict__ c0,
                           float* __restrict__ c1, int lo, int hi) {
  if (pos < inv_pos) {
    const float kl = tf(c, table + 2 * pos), kr = tf(c, table + 2 * pos + 1);
    for (int i = lo; i < hi; i++) {
      const float v = c0[i];
      c0[i] = M0_MUL(kl, v);
      c1[i] = M0_MUL(kr, v);
    }
  } else if (ms) {
    mid_side(c, c0, c1, lo, hi);
  }
}

M0_COLD void stereo(const Ctx& c, const Hdr& h, Gc gr[2], const uint8_t* sf1,
                  float* ch0, float* ch1) {
  if (h.channel_mode != 1) return;
  const bool ms = h.mid_side(), inten = h.intensity();
  if (!ms && !inten) return;
  const Gc& c1 = gr[1];
  const int end = gr[0].rzero > c1.rzero ? gr[0].rzero : c1.rzero;
  int table, inv_pos;
  if (h.mpeg1()) {
    table = kIsM1;
    inv_pos = 7;
  } else {
    table = kIsM2 + (c1.scalefac_compress & 1) * 64;
    inv_pos = 31;
  }
  int bound = end;
  if (inten) {
    if (c1.block_type == 2) {
      int short_bands, long_bands = -1, n_short, sfi, n_long = 0;
      if (c1.mixed) {
        const int sw = ti(c, kMixedSwitch + h.sr_idx);
        const int len = ti(c, kMixedLen + h.sr_idx);
        short_bands = kSfbMixed + h.sr_idx * 40 + sw;
        n_short = len - sw;
        long_bands = kSfbMixed + h.sr_idx * 40;
        n_long = sw + 1;
        sfi = len - 1;
      } else {
        short_bands = kSfbShort + h.sr_idx * 40;
        n_short = 40;
        sfi = 39;
      }
      // is_pos[i]: scalefactor i for i < 36, 33..35 again for 36..38.
      bool wz[3] = {true, true, true};
      bool found = false;
      for (int bi = (n_short - 1) / 3 * 3 - 3; bi >= 0; bi -= 3) {
        int s[4];
        for (int k = 0; k < 4; k++) s[k] = ti(c, short_bands + bi + k);
        for (int w = 2; w >= 0; w--) {
          const int lo = s[w], hi = s[w + 1];
          wz[w] = wz[w] && band_zero(ch1 + lo, hi - lo);
          const int p = sfi - 1;
          const int pos = sf1[p < 36 ? p : p - 3];
          if (wz[w])
            apply_intensity(c, pos, table, inv_pos, ms, ch0, ch1, lo, hi);
          else if (ms)
            mid_side(c, ch0, ch1, lo, hi);
          sfi--;
        }
        bound = s[0];
        found = !wz[0] && !wz[1] && !wz[2];
        if (found) break;
      }
      if (!found && long_bands >= 0) {
        for (int i = n_long - 2; i >= 0; i--) {
          const int s = ti(c, long_bands + i), e = ti(c, long_bands + i + 1);
          if (!band_zero(ch1 + s, e - s)) break;
          const int p = sfi - 1;
          const int pos = sf1[p < 36 ? p : p - 3];
          apply_intensity(c, pos, table, inv_pos, ms, ch0, ch1, s, e);
          sfi--;
          bound = s;
        }
      }
    } else {
      const int bands = kSfbLong + h.sr_idx * 23;
      for (int i = 21; i >= 0; i--) {
        const int s = ti(c, bands + i), e = ti(c, bands + i + 1);
        const bool z = s >= c1.rzero || band_zero(ch1 + s, e - s);
        if (!z) break;
        const int pos = sf1[i < 21 ? i : 20];
        apply_intensity(c, pos, table, inv_pos, ms, ch0, ch1, s, e);
        bound = s;
      }
    }
  }
  if (ms && bound > 0) mid_side(c, ch0, ch1, 0, bound);
  if (inten || ms) {
    gr[0].rzero = end;
    gr[1].rzero = end;
  }
}

// The largest clip whose first frame is at or before f.
M0_FN int clip_of(const Ctx& c, int f) {
  int lo = 0, hi = c.K - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (c.clips[5 * mid] <= f)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Frame f: its status, and its granules' lanes where the status is 0.
M0_FN int decode_frame(const Ctx& c, int f, float* spectra, int32_t* bt,
                       uint8_t* mixed) {
  const int k = clip_of(c, f);
  const int64_t first = c.clips[5 * k], lane0 = c.clips[5 * k + 2];
  const int64_t C = c.clips[5 * k + 3], clip_gr = c.clips[5 * k + 4];
  if (f < first || f >= first + c.clips[5 * k + 1]) return -6;
  Hdr h;
  int64_t md = 0;
  int md_len = 0;
  const int st = frame_main_data(c, f, &h, &md, &md_len);
  if (st != 0) return st;
  int main_data_begin;
  bool scfsi[2][4];
  Gc gr[2][2];
  read_side_info(c, h, md - h.side_len(), &main_data_begin, scfsi, gr);

  // The reservoir: the frames before f (in its clip) whose main data the
  // host keeps, back until they hold main_data_begin bytes.
  MBits bs{f, main_data_begin + md_len, f, 0, md_len, md, 0, 0, 0, false};
  if (main_data_begin > 0) {
    int acc = 0, j = f - 1, len = 0;
    int64_t jmd = 0;
    Hdr hj;
    while (acc < main_data_begin) {
      if (j < first) return -4;
      if (frame_main_data(c, j, &hj, &jmd, &len) == 0) acc += len;
      --j;
    }
    const int skip = acc - main_data_begin;  // bytes of frame j+1 left out
    bs.seg_frame = j + 1;
    bs.seg_raw = jmd + skip;
    bs.seg_v1 = len - skip;
  }
  const int n_gr = h.mpeg1() ? 2 : 1, n_ch = h.n_ch();
  const int64_t row0 = lane0 + (f - first) * n_gr * C;
  if (n_gr != clip_gr || n_ch > C || C > 2 || lane0 < 0 ||
      row0 + n_gr * C > c.L)
    return -6;

  uint8_t sf[2][2][40];
  for (int g = 0; g < n_gr; g++)
    for (int ch = 0; ch < 2; ch++)
      for (int i = 0; i < 40; i++) sf[g][ch][i] = 0;
  for (int g = 0; g < n_gr; g++) {
    const int64_t lane = row0 + g * C;
    float* s0 = spectra + lane * 576;
    float* s1 = C == 2 ? s0 + 576 : nullptr;
    if (s1) zero_lane(s1);
    for (int ch = 0; ch < n_ch; ch++) {
      Gc& q = gr[g][ch];
      const int part2 =
          h.mpeg1() ? read_scf_mpeg1(c, bs, g, ch, scfsi, q, sf)
                    : read_scf_mpeg2(c, bs, ch == 1 && h.intensity(), q,
                                     sf[g][ch]);
      const int part3 = q.part23 - part2;
      if (part3 < 0 || bs.error) return -5;
      float* dst = ch == 0 ? s0 : s1;
      if (!read_huffman(c, bs, h, q, sf[g][ch], part3, dst)) return -5;
    }
    if (n_ch == 2) stereo(c, h, gr[g], sf[g][1], s0, s1);
    for (int ch = 0; ch < n_ch; ch++) reorder(c, h, gr[g][ch], ch ? s1 : s0);
    for (int ch = 0; ch < static_cast<int>(C); ch++) {
      bt[lane + ch] = ch < n_ch ? gr[g][ch].block_type : 0;
      mixed[lane + ch] = ch < n_ch && gr[g][ch].mixed ? 1 : 0;
    }
  }
  return 0;
}

#ifdef __CUDACC__
constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
    mp3_entropy_kernel(Ctx c, int64_t F, float* spectra, int32_t* bt,
                       uint8_t* mixed, int32_t* status) {
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (f >= F) return;
  status[f] = decode_frame(c, static_cast<int>(f), spectra, bt, mixed);
}
#endif

}  // namespace

#ifdef __CUDACC__
// data [n] uint8 (4-byte aligned); frames [F][2] int64 (offset, size);
// clips [K][5] int64 (first frame, frames, first lane, channels C,
// granules a frame), in frame order, covering [0, F); huff, fl, it: the
// tables; spectra [L][576] float32 (16-byte aligned), bt [L] int32, mixed
// [L] uint8, status [F] int32. A frame outside data reads -1 and a clip
// whose lanes fall outside [0, L) -6, so no table makes the kernel read
// or write out of bounds.
extern "C" int mp3_entropy_launch(const void* data, int64_t n,
                                  const void* frames, int64_t F,
                                  const void* clips, int K, const void* huff,
                                  const void* fl, const void* it,
                                  void* spectra, int64_t L, void* bt,
                                  void* mixed, void* status, void* stream) {
  if (F <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || F > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(data) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(spectra) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Ctx c{static_cast<const uint8_t*>(data), n,
              static_cast<const int64_t*>(frames),
              static_cast<const int64_t*>(clips), K, L,
              static_cast<const uint16_t*>(huff),
              static_cast<const float*>(fl), static_cast<const int32_t*>(it)};
  const unsigned grid = static_cast<unsigned>((F + kThreads - 1) / kThreads);
  mp3_entropy_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      c, F, static_cast<float*>(spectra), static_cast<int32_t*>(bt),
      static_cast<uint8_t*>(mixed), static_cast<int32_t*>(status));
  return static_cast<int>(cudaGetLastError());
}

// out[0..2]: registers a thread, local-memory bytes a thread (the
// per-thread arrays, and spills) and resident blocks an SM of M0.
extern "C" int mp3_entropy_attributes(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, mp3_entropy_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], mp3_entropy_kernel, kThreads, 0);
  if (e == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
  }
  return static_cast<int>(e);
}
#else
// The same frame body on the host, every frame in turn (the CPU tests'
// build of this file); the arguments as mp3_entropy_launch's.
extern "C" int mp3_entropy_host(const void* data, int64_t n,
                                const void* frames, int64_t F,
                                const void* clips, int K, const void* huff,
                                const void* fl, const void* it,
                                void* spectra, int64_t L, void* bt,
                                void* mixed, void* status) {
  const Ctx c{static_cast<const uint8_t*>(data), n,
              static_cast<const int64_t*>(frames),
              static_cast<const int64_t*>(clips), K, L,
              static_cast<const uint16_t*>(huff),
              static_cast<const float*>(fl), static_cast<const int32_t*>(it)};
  if (F > 0x7fffffffLL) return -1;
  for (int64_t f = 0; f < F; ++f)
    static_cast<int32_t*>(status)[f] =
        decode_frame(c, static_cast<int>(f), static_cast<float*>(spectra),
                     static_cast<int32_t*>(bt), static_cast<uint8_t*>(mixed));
  return 0;
}
#endif
