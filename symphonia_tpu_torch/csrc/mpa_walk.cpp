// The frame table of a seekable MPEG audio stream (Layers I, II and III;
// MPEG-1, 2 and 2.5), walked on the host in one call.
//
// Host code, built with g++ (mpa_walk.py), not a kernel. It gives the same
// answer as the reader's Python walk (formats/mpa.py MpaReader.__init__,
// _resync and codecs/mpa_common.py _parse_header) for every input:
//   - a header parses unless its sync (11 bits) is wrong, its version or
//     layer is reserved, its bitrate index is free-format (0) or invalid
//     (15), its rate index is reserved (3) or its emphasis is reserved
//     (2); its frame size is 4 x (12 bitrate / rate + padding) bytes for
//     Layer I and spf / 8 x bitrate / rate + padding otherwise, spf 1152
//     for Layer II and MPEG-1 Layer III, 576 for MPEG-2/2.5 Layer III;
//   - two headers are compatible when version, layer and sample rate are
//     equal;
//   - a resync from `start` tries each 0xFF byte followed by a byte with
//     the top three bits set, up to the last byte but one; it takes the
//     first candidate that parses (and is compatible with the reference
//     header, where there is one) and whose successor parses and is
//     compatible with it, checked only where the successor's four bytes
//     lie inside the stream;
//   - the walk starts at the first frame, found by a resync from 0 with no
//     reference; a header that does not parse or is not compatible with
//     the first starts a resync from the next byte, and the walk stops
//     where no four bytes are left, where a resync finds nothing, or at a
//     frame that runs past the end.
// The bitrate and sample-rate tables come from the caller (the decoder's
// own constants), so the walk has no copy of them.

#include <cstdint>

namespace {

struct Header {
  int version;  // 1 MPEG-1, 2 MPEG-2, 3 MPEG-2.5 (mpa_common's values)
  int layer;    // 1..3
  int rate;     // Hz
  int64_t size; // bytes, header included
};

struct Tables {
  const int32_t* bitrates;  // [5][16]: MPEG-1 L1, L2, L3; MPEG-2 L1, L2/3
  const int32_t* rates;     // [3][3]: by version, then rate index
};

inline bool parse(const uint8_t* p, const Tables& t, Header* h) {
  const uint32_t w = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                     (uint32_t(p[2]) << 8) | uint32_t(p[3]);
  if (((w >> 21) & 0x7FF) != 0x7FF) return false;
  static const int kVersion[4] = {3, 0, 2, 1};
  static const int kLayer[4] = {0, 3, 2, 1};
  const int version = kVersion[(w >> 19) & 0x3];
  const int layer = kLayer[(w >> 17) & 0x3];
  if (version == 0 || layer == 0) return false;
  const int bitrate_idx = (w >> 12) & 0xF;
  if (bitrate_idx == 0 || bitrate_idx == 15) return false;
  const int rate_idx = (w >> 10) & 0x3;
  if (rate_idx == 3) return false;
  const int64_t padding = (w >> 9) & 0x1;
  if ((w & 0x3) == 0x2) return false;
  const int row = version == 1 ? layer - 1 : (layer == 1 ? 3 : 4);
  const int64_t bitrate = t.bitrates[row * 16 + bitrate_idx];
  const int64_t rate = t.rates[(version - 1) * 3 + rate_idx];
  if (layer == 1) {
    h->size = (12 * bitrate / rate + padding) * 4;
  } else {
    const int64_t spf = (layer == 3 && version != 1) ? 576 : 1152;
    h->size = spf / 8 * bitrate / rate + padding;
  }
  h->version = version;
  h->layer = layer;
  h->rate = int(rate);
  return true;
}

inline bool compatible(const Header& a, const Header& b) {
  return a.version == b.version && a.layer == b.layer && a.rate == b.rate;
}

int64_t resync(const uint8_t* buf, int64_t n, int64_t start,
               const Header* ref, const Tables& t) {
  for (int64_t pos = start; pos < n - 1; ++pos) {
    if (buf[pos] != 0xFF || (buf[pos + 1] & 0xE0) != 0xE0) continue;
    Header h;
    if (pos + 4 > n || !parse(buf + pos, t, &h)) continue;
    if (ref != nullptr && !compatible(h, *ref)) continue;
    const int64_t nxt = pos + h.size;
    if (nxt + 4 <= n) {
      Header h2;
      if (!parse(buf + nxt, t, &h2) || !compatible(h2, h)) continue;
    }
    return pos;
  }
  return -1;
}

}  // namespace

// Walks buf[0, n): writes the first verified frame's offset to *first and
// the frame table from it (the first frame included) to offsets/sizes.
// Returns the number of frames, -1 where no frame is found (*first left
// as is), or -2 where more than cap frames would be written.
extern "C" int64_t mpa_walk(const uint8_t* buf, int64_t n,
                            const int32_t* bitrates, const int32_t* rates,
                            int64_t* first, int64_t* offsets, int64_t* sizes,
                            int64_t cap) {
  const Tables t{bitrates, rates};
  const int64_t start = resync(buf, n, 0, nullptr, t);
  if (start < 0) return -1;
  *first = start;
  Header ref;
  parse(buf + start, t, &ref);
  int64_t count = 0;
  int64_t pos = start;
  while (pos + 4 <= n) {
    Header h;
    if (!parse(buf + pos, t, &h) || !compatible(h, ref)) {
      const int64_t nxt = resync(buf, n, pos + 1, &ref, t);
      if (nxt < 0) break;
      pos = nxt;
      continue;
    }
    if (pos + h.size > n) break;  // truncated final frame
    if (count == cap) return -2;
    offsets[count] = pos;
    sizes[count] = h.size;
    ++count;
    pos += h.size;
  }
  return count;
}
