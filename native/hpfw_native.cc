// hpfw_jax native runtime: WAV decode, resampling, and a threaded CPU
// Hamming matcher.
//
// The reference library is C++ end to end (SURVEY.md §2.1); in this rebuild
// the accelerator owns the compute path (JAX/XLA) and this library owns the
// host-side runtime the way the reference's native code does:
//   - audio decode + resample (the data loader feeding the device),
//   - the CPU matcher used by BASELINE config 1 ("match ... on CPU") and as
//     a host-side fallback, scanning offsets with XOR + POPCNT across a
//     std::thread pool over tracks (the reference's batch-driver analog,
//     SURVEY.md §2.1 row 8).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment);
// every function has a NumPy twin that tests assert bit-identical behavior
// (tests/test_native.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#include "hpfw_internal.h"

extern "C" {

// ---------------------------------------------------------------------------
// Audio decode: WAV (PCM 8/16/24/32, float32/64, mu-law, A-law, extensible)
// and AIFF/AIFF-C (big-endian PCM, 'NONE'/'sowt'), any channel count -> mono
// float32. Returns 0 on success. On success *out_n / *out_rate are set and
// the caller passes a buffer of capacity *out_n (two-call protocol: first
// call with out=nullptr fills sizes only).
// ---------------------------------------------------------------------------
static const float* mulaw_table() {
  static float t[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) {
      uint8_t u = (uint8_t)~i;
      int exp = (u >> 4) & 7, mant = u & 0xF;
      int32_t mag = (((mant << 3) + 0x84) << exp) - 0x84;
      t[i] = (float)((u & 0x80) ? -mag : mag) / 32768.0f;
    }
    init = true;
  }
  return t;
}

static const float* alaw_table() {
  static float t[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) {
      uint8_t a = (uint8_t)(i ^ 0x55);
      int exp = (a >> 4) & 7, mant = a & 0xF;
      int32_t mag = exp == 0 ? (mant << 4) + 8 : ((mant << 4) + 0x108) << (exp - 1);
      t[i] = (float)((a & 0x80) ? -mag : mag) / 32768.0f;
    }
    init = true;
  }
  return t;
}

static uint32_t rd_be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
}

static double decode_f80(const uint8_t* p) {  // AIFF sample-rate field
  int e = ((p[0] & 0x7F) << 8) | p[1];
  uint64_t mant = 0;
  for (int i = 0; i < 8; ++i) mant = (mant << 8) | p[2 + i];
  if (e == 0 && mant == 0) return 0.0;
  double v = (double)mant * pow(2.0, e - 16383 - 63);
  return (p[0] & 0x80) ? -v : v;
}

static int aiff_decode(const uint8_t* data, int64_t size,
                       float* out, int64_t* out_n, int32_t* out_rate) {
  if (size < 12 || memcmp(data + 8, "AIF", 3) != 0) return -1;
  int64_t pos = 12;
  int n_ch = 0, bits = 0;
  int32_t rate = 0;
  bool little = false;  // 'sowt' AIFF-C
  const uint8_t* raw = nullptr;
  int64_t raw_size = 0;
  while (pos + 8 <= size) {
    const uint8_t* cid = data + pos;
    uint32_t csize = rd_be32(data + pos + 4);
    const uint8_t* body = data + pos + 8;
    if (pos + 8 + (int64_t)csize > size) return -2;
    if (memcmp(cid, "COMM", 4) == 0 && csize >= 18) {
      n_ch = (int16_t)((body[0] << 8) | body[1]);
      bits = (int16_t)((body[6] << 8) | body[7]);
      rate = (int32_t)(decode_f80(body + 8) + 0.5);
      if (csize >= 22) {
        if (memcmp(body + 18, "sowt", 4) == 0) little = true;
        else if (memcmp(body + 18, "NONE", 4) != 0) return -4;
      }
    } else if (memcmp(cid, "SSND", 4) == 0 && csize >= 8) {
      uint32_t off = rd_be32(body);
      raw = body + 8 + off;
      raw_size = csize - 8 - off;
    }
    pos += 8 + csize + (csize & 1);
  }
  if (!raw || n_ch <= 0 || rate <= 0) return -3;
  int64_t bytes_per = bits / 8;
  if (bytes_per <= 0) return -4;
  int64_t frames = raw_size / (bytes_per * n_ch);
  *out_n = frames;
  *out_rate = rate;
  if (!out) return 0;
  for (int64_t i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < n_ch; ++c) {
      const uint8_t* p = raw + (i * n_ch + c) * bytes_per;
      double v = 0.0;
      if (bits == 16) {
        int16_t s = little ? (int16_t)(p[0] | (p[1] << 8))
                           : (int16_t)((p[0] << 8) | p[1]);
        v = s / 32768.0;
      } else if (bits == 8) {
        v = (int8_t)p[0] / 128.0;
      } else if (bits == 24) {
        int32_t s = little ? (int32_t)(p[0] | (p[1] << 8) | ((int8_t)p[2] << 16))
                           : (int32_t)(p[2] | (p[1] << 8) | ((int8_t)p[0] << 16));
        v = s / 8388608.0;
      } else if (bits == 32) {
        uint32_t u = little ? (uint32_t)(p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24))
                            : rd_be32(p);
        v = (int32_t)u / 2147483648.0;
      } else return -4;
      acc += v;
    }
    out[i] = (float)(acc / n_ch);
  }
  return 0;
}

int hpfw_wav_decode(const uint8_t* data, int64_t size,
                    float* out, int64_t* out_n, int32_t* out_rate) {
  if (size >= 12 && memcmp(data, "FORM", 4) == 0)
    return aiff_decode(data, size, out, out_n, out_rate);
  if (size < 12 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WAVE", 4) != 0)
    return -1;
  int64_t pos = 12;
  int audio_format = 0, n_ch = 0, bits = 0;
  int32_t rate = 0;
  const uint8_t* raw = nullptr;
  int64_t raw_size = 0;
  while (pos + 8 <= size) {
    const uint8_t* cid = data + pos;
    uint32_t csize;
    memcpy(&csize, data + pos + 4, 4);
    const uint8_t* body = data + pos + 8;
    if (pos + 8 + csize > size) return -2;
    if (memcmp(cid, "fmt ", 4) == 0 && csize >= 16) {
      uint16_t fmt16, ch16, bits16;
      memcpy(&fmt16, body, 2);
      memcpy(&ch16, body + 2, 2);
      memcpy(&rate, body + 4, 4);
      memcpy(&bits16, body + 14, 2);
      audio_format = fmt16;
      n_ch = ch16;
      bits = bits16;
      if (audio_format == 0xFFFE) {
        // WAVE_FORMAT_EXTENSIBLE: real format code = first uint16 of the
        // SubFormat GUID at fmt-body offset 24.
        if (csize < 26) return -5;
        uint16_t sub16;
        memcpy(&sub16, body + 24, 2);
        audio_format = sub16;
      }
    } else if (memcmp(cid, "data", 4) == 0) {
      raw = body;
      raw_size = csize;
    }
    pos += 8 + csize + (csize & 1);
  }
  if (!raw || n_ch <= 0 || rate <= 0) return -3;

  int64_t bytes_per = bits / 8;
  int64_t n_frames_total = raw_size / (bytes_per * n_ch);
  *out_n = n_frames_total;
  *out_rate = rate;
  if (!out) return 0;

  for (int64_t i = 0; i < n_frames_total; ++i) {
    double acc = 0.0;
    for (int c = 0; c < n_ch; ++c) {
      const uint8_t* p = raw + (i * n_ch + c) * bytes_per;
      double v = 0.0;
      if (audio_format == 1) {  // integer PCM
        if (bits == 16) {
          int16_t s; memcpy(&s, p, 2); v = s / 32768.0;
        } else if (bits == 32) {
          int32_t s; memcpy(&s, p, 4); v = s / 2147483648.0;
        } else if (bits == 24) {
          int32_t s = (int32_t)(p[0] | (p[1] << 8) | ((int8_t)p[2] << 16));
          v = s / 8388608.0;
        } else if (bits == 8) {
          v = ((int)p[0] - 128) / 128.0;
        } else return -4;
      } else if (audio_format == 3) {  // IEEE float
        if (bits == 32) { float f; memcpy(&f, p, 4); v = f; }
        else if (bits == 64) { double d; memcpy(&d, p, 8); v = d; }
        else return -4;
      } else if (audio_format == 6) {  // G.711 A-law
        v = alaw_table()[p[0]];
      } else if (audio_format == 7) {  // G.711 mu-law
        v = mulaw_table()[p[0]];
      } else return -4;
      acc += v;
    }
    out[i] = (float)(acc / n_ch);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// FLAC decode. Mirrors hpfw_jax/io/flac.py (the NumPy twin is the oracle;
// tests/test_flac.py asserts bit-identical float output): STREAMINFO, frame
// headers with CRC-8, CONSTANT/VERBATIM/FIXED/LPC subframes, Rice + Rice2
// partitions with escapes, wasted bits, all four channel assignments, frame
// CRC-16. Same two-call protocol as hpfw_wav_decode.
// ---------------------------------------------------------------------------
namespace flac {

// 64-bit-cached MSB-first bit reader: reads refill a word cache, unary
// codes consume whole cached runs via clz — ~20x faster than per-bit reads
// (FLAC ingestion feeds the device extraction pipeline; the reader is the
// decoder's hot loop).
struct BitR {
  const uint8_t* d;
  int64_t size;     // bytes
  int64_t bytepos;  // next byte to cache
  uint64_t cache;   // low nbits_c bits are unread, MSB-first
  int nbits_c;
};

static inline int64_t bit_pos(const BitR* b) {
  return b->bytepos * 8 - b->nbits_c;
}

static inline int fill(BitR* b, int need) {
  while (b->nbits_c < need) {
    if (b->bytepos >= b->size) return -1;
    b->cache = (b->cache << 8) | b->d[b->bytepos++];
    b->nbits_c += 8;
  }
  return 0;
}

static inline int rd(BitR* b, int n, uint32_t* out) {  // n <= 32
  if (n == 0) { *out = 0; return 0; }
  if (fill(b, n)) return -1;
  b->nbits_c -= n;
  *out = (uint32_t)((b->cache >> b->nbits_c) & ((1ull << n) - 1));
  return 0;
}

static inline int rd64(BitR* b, int n, uint64_t* out) {  // n <= 57
  if (n == 0) { *out = 0; return 0; }
  if (fill(b, n)) return -1;
  b->nbits_c -= n;
  *out = (b->cache >> b->nbits_c) & ((1ull << n) - 1);
  return 0;
}

// Signed reads must handle n up to bps+1 = 33 bits: stereo-decorrelated
// side channels of 32-bit streams carry 33-bit warmup/CONSTANT/VERBATIM
// samples, which a uint32-truncating read would corrupt.
static inline int rds(BitR* b, int n, int64_t* out) {  // signed, 1 <= n <= 57
  uint64_t v;
  if (rd64(b, n, &v)) return -1;
  int64_t s = (int64_t)v;
  if (v & (1ull << (n - 1))) s -= (1ll << n);
  *out = s;
  return 0;
}

static inline int rd_unary(BitR* b, uint32_t* q) {
  uint32_t total = 0;
  for (;;) {
    if (b->nbits_c == 0 && fill(b, 1)) return -1;
    uint64_t mask = b->nbits_c >= 64 ? b->cache
                                     : b->cache & ((1ull << b->nbits_c) - 1);
    if (mask == 0) {                 // all cached bits are zeros: consume
      total += (uint32_t)b->nbits_c;
      b->nbits_c = 0;
      continue;
    }
    int top = 63 - __builtin_clzll(mask);   // highest set bit
    total += (uint32_t)(b->nbits_c - 1 - top);
    b->nbits_c = top;                // consume the zeros AND the one-bit
    *q = total;
    return 0;
  }
}

static inline void align_byte(BitR* b) {
  b->nbits_c -= b->nbits_c & 7;
}

static uint8_t crc8(const uint8_t* d, int64_t n) {
  uint8_t c = 0;
  for (int64_t i = 0; i < n; ++i) {
    c ^= d[i];
    for (int k = 0; k < 8; ++k) c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
  }
  return c;
}

static uint16_t crc16(const uint8_t* d, int64_t n) {
  uint16_t c = 0;
  for (int64_t i = 0; i < n; ++i) {
    c ^= (uint16_t)(d[i] << 8);
    for (int k = 0; k < 8; ++k)
      c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
  }
  return c;
}

static int utf8_num(BitR* b, uint64_t* out) {
  uint32_t b0;
  if (rd(b, 8, &b0)) return -1;
  if (b0 < 0x80) { *out = b0; return 0; }
  int n_extra = 0;
  for (uint32_t mask = 0x40; b0 & mask; mask >>= 1) ++n_extra;
  if (n_extra == 0 || n_extra > 6) return -1;
  uint64_t v = b0 & ((0x40u >> n_extra) - 1);
  for (int i = 0; i < n_extra; ++i) {
    uint32_t bb;
    if (rd(b, 8, &bb) || (bb & 0xC0) != 0x80) return -1;
    v = (v << 6) | (bb & 0x3F);
  }
  *out = v;
  return 0;
}

static int residual(BitR* b, int blocksize, int order, int64_t* res) {
  uint32_t method, porder;
  if (rd(b, 2, &method) || method > 1) return -1;
  int pbits = method == 0 ? 4 : 5;
  uint32_t escape = (1u << pbits) - 1;
  if (rd(b, 4, &porder)) return -1;
  int n_part = 1 << porder;
  if (blocksize % n_part) return -1;
  int64_t filled = 0;
  for (int p = 0; p < n_part; ++p) {
    int count = blocksize >> porder;
    if (p == 0) count -= order;
    if (count < 0) return -1;
    uint32_t param;
    if (rd(b, pbits, &param)) return -1;
    if (param == escape) {
      uint32_t raw_bits;
      if (rd(b, 5, &raw_bits)) return -1;
      for (int k = 0; k < count; ++k) {
        int64_t v = 0;
        if (raw_bits && rds(b, (int)raw_bits, &v)) return -1;
        res[filled++] = v;
      }
    } else {
      for (int k = 0; k < count; ++k) {
        uint32_t q, r = 0;
        if (rd_unary(b, &q)) return -1;
        if (param && rd(b, (int)param, &r)) return -1;
        uint64_t u = ((uint64_t)q << param) | r;
        res[filled++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
  }
  return 0;
}

static const int kFixedCoef[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

static int subframe(BitR* b, int blocksize, int bps, int64_t* out) {
  uint32_t pad, ftype, wflag;
  if (rd(b, 1, &pad) || pad) return -1;
  if (rd(b, 6, &ftype)) return -1;
  if (rd(b, 1, &wflag)) return -1;
  int wasted = 0;
  if (wflag) {
    uint32_t q;
    if (rd_unary(b, &q)) return -1;
    wasted = (int)q + 1;
  }
  int eff = bps - wasted;
  if (eff <= 0) return -1;
  std::vector<int64_t> res(blocksize);
  if (ftype == 0) {  // CONSTANT
    int64_t v;
    if (rds(b, eff, &v)) return -1;
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (ftype == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i)
      if (rds(b, eff, &out[i])) return -1;
  } else if (ftype >= 8 && ftype <= 12) {  // FIXED
    int order = (int)ftype - 8;
    for (int i = 0; i < order; ++i)
      if (rds(b, eff, &out[i])) return -1;
    if (residual(b, blocksize, order, res.data())) return -1;
    for (int i = order; i < blocksize; ++i) {
      int64_t p = 0;
      for (int j = 0; j < order; ++j) p += kFixedCoef[order][j] * out[i - 1 - j];
      out[i] = res[i - order] + p;
    }
  } else if (ftype >= 32) {  // LPC
    int order = (int)(ftype & 31) + 1;
    for (int i = 0; i < order; ++i)
      if (rds(b, eff, &out[i])) return -1;
    uint32_t prec4;
    if (rd(b, 4, &prec4) || prec4 == 15) return -1;
    int prec = (int)prec4 + 1;
    int64_t shift;
    if (rds(b, 5, &shift) || shift < 0) return -1;
    int64_t coef[32];
    for (int i = 0; i < order; ++i)
      if (rds(b, prec, &coef[i])) return -1;
    if (residual(b, blocksize, order, res.data())) return -1;
    for (int i = order; i < blocksize; ++i) {
      int64_t p = 0;
      for (int j = 0; j < order; ++j) p += coef[j] * out[i - 1 - j];
      out[i] = res[i - order] + (p >> shift);
    }
  } else {
    return -1;
  }
  if (wasted)
    for (int i = 0; i < blocksize; ++i) out[i] <<= wasted;
  return 0;
}

}  // namespace flac

static int flac_decode_vec(const uint8_t* data, int64_t size,
                           std::vector<float>* out, int32_t* out_rate) {
  using namespace flac;
  if (size < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
  int64_t pos = 4;
  int32_t sr = 0;
  int n_ch = 0, bps = 0;
  int64_t total = -1;
  while (pos + 4 <= size) {
    uint8_t hdr = data[pos];
    uint32_t bsize = ((uint32_t)data[pos + 1] << 16) |
                     ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    const uint8_t* body = data + pos + 4;
    if (pos + 4 + bsize > size) return -2;
    if ((hdr & 0x7F) == 0 && bsize >= 34) {  // STREAMINFO
      sr = ((int32_t)body[10] << 12) | ((int32_t)body[11] << 4) | (body[12] >> 4);
      n_ch = ((body[12] >> 1) & 7) + 1;
      bps = (((body[12] & 1) << 4) | (body[13] >> 4)) + 1;
      total = ((int64_t)(body[13] & 0xF) << 32) | rd_be32(body + 14);
    }
    pos += 4 + bsize;
    if (hdr & 0x80) break;
  }
  if (sr <= 0 || n_ch <= 0 || n_ch > 8 || bps <= 0) return -3;
  // total_samples == 0 in STREAMINFO means "unknown" (streamed encodes):
  // decode until the bitstream ends, mirroring the NumPy twin.
  if (total == 0) total = -1;

  static const int kBsCode[16] = {0, 192, 576, 1152, 2304, 4608, -1, -2,
                                  256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
  static const int kSsCode[8] = {0, 8, 12, -1, 16, 20, 24, 32};
  BitR br{data, size, pos, 0, 0};
  int64_t count = 0;
  std::vector<std::vector<int64_t>> ch(n_ch);
  double scale = (double)(1ll << (bps - 1));
  while (bit_pos(&br) + 40 <= size * 8 && (total < 0 || count < total)) {
    int64_t frame_start = bit_pos(&br) >> 3;
    uint32_t sync, resv, bs_code, sr_code, ch_code, ss_code;
    if (rd(&br, 14, &sync) || sync != 0x3FFE) return -10;
    if (rd(&br, 2, &resv)) return -10;  // reserved + blocking strategy
    if (rd(&br, 4, &bs_code) || rd(&br, 4, &sr_code) ||
        rd(&br, 4, &ch_code) || rd(&br, 3, &ss_code) || rd(&br, 1, &resv))
      return -10;
    uint64_t fnum;
    if (utf8_num(&br, &fnum)) return -10;
    int blocksize;
    if (bs_code == 6) {
      uint32_t v; if (rd(&br, 8, &v)) return -10;
      blocksize = (int)v + 1;
    } else if (bs_code == 7) {
      uint32_t v; if (rd(&br, 16, &v)) return -10;
      blocksize = (int)v + 1;
    } else {
      blocksize = kBsCode[bs_code];
      if (blocksize <= 0) return -10;
    }
    if (sr_code == 12) { uint32_t v; if (rd(&br, 8, &v)) return -10; }
    else if (sr_code == 13 || sr_code == 14) { uint32_t v; if (rd(&br, 16, &v)) return -10; }
    else if (sr_code == 15) return -10;
    int frame_bps = ss_code ? kSsCode[ss_code] : bps;
    if (frame_bps <= 0) return -10;
    int64_t crc8_pos = bit_pos(&br) >> 3;
    uint32_t hcrc;
    if (rd(&br, 8, &hcrc)) return -10;
    if (crc8(data + frame_start, crc8_pos - frame_start) != (uint8_t)hcrc)
      return -11;

    std::vector<std::vector<int64_t>> sub;
    if (ch_code < 8) {
      if ((int)ch_code + 1 != n_ch) return -12;
      sub.assign(n_ch, std::vector<int64_t>(blocksize));
      for (int c = 0; c < n_ch; ++c)
        if (subframe(&br, blocksize, frame_bps, sub[c].data())) return -13;
    } else if (ch_code <= 10) {
      if (n_ch != 2) return -12;
      int lb = frame_bps + (ch_code == 9 ? 1 : 0);
      int rb = frame_bps + (ch_code != 9 ? 1 : 0);
      std::vector<int64_t> a(blocksize), bch(blocksize);
      if (subframe(&br, blocksize, lb, a.data())) return -13;
      if (subframe(&br, blocksize, rb, bch.data())) return -13;
      sub.assign(2, std::vector<int64_t>(blocksize));
      for (int i = 0; i < blocksize; ++i) {
        if (ch_code == 8) {        // left/side
          sub[0][i] = a[i];
          sub[1][i] = a[i] - bch[i];
        } else if (ch_code == 9) { // right/side
          sub[0][i] = bch[i] + a[i];
          sub[1][i] = bch[i];
        } else {                   // mid/side
          int64_t mid = (a[i] << 1) | (bch[i] & 1);
          sub[0][i] = (mid + bch[i]) >> 1;
          sub[1][i] = (mid - bch[i]) >> 1;
        }
      }
    } else {
      return -12;
    }
    align_byte(&br);
    int64_t crc16_pos = bit_pos(&br) >> 3;
    uint32_t fcrc;
    if (rd(&br, 16, &fcrc)) return -10;
    if (crc16(data + frame_start, crc16_pos - frame_start) != (uint16_t)fcrc)
      return -14;
    for (int c = 0; c < n_ch; ++c)
      ch[c].insert(ch[c].end(), sub[c].begin(), sub[c].end());
    count += blocksize;
  }
  if (total >= 0 && count > total) count = total;
  *out_rate = sr;
  out->resize(count);
  for (int64_t i = 0; i < count; ++i) {
    double acc = 0.0;
    for (int c = 0; c < n_ch; ++c) acc += (double)ch[c][i];
    (*out)[i] = (float)(acc / n_ch / scale);
  }
  return 0;
}

int hpfw_flac_decode(const uint8_t* data, int64_t size,
                     float* out, int64_t* out_n, int32_t* out_rate) {
  std::vector<float> v;
  int rc = flac_decode_vec(data, size, &v, out_rate);
  if (rc) return rc;
  *out_n = (int64_t)v.size();
  if (out) memcpy(out, v.data(), v.size() * sizeof(float));
  return 0;
}

// ---------------------------------------------------------------------------
// Ogg Vorbis decode. Mirrors hpfw_jax/io/{ogg,vorbis}.py (the NumPy twin;
// tests/test_vorbis.py asserts float32-rounding-level equality): Ogg pages
// with CRC verification, LSB-first bit unpacking, codebooks (ordered/sparse
// lengths, lookup 0/1/2), first-fit canonical Huffman, floor 1, residues
// 0/1/2, coupling inversion, direct IMDCT (double; O(n^2) per block — fine
// for fingerprint ingestion), window slopes for long/short transitions,
// overlap-add with granule trim, mono downmix. Floor type 0 is rejected
// like the twin. Same two-call protocol as the other decoders.
// ---------------------------------------------------------------------------
namespace vorbis {

struct OggBitR {         // LSB-first within bytes
  const std::vector<uint8_t>* d;
  int64_t pos;           // bit position
};

static inline int vrd(OggBitR* b, int n, uint32_t* out) {  // n <= 32
  const std::vector<uint8_t>& d = *b->d;
  if (b->pos + n > (int64_t)d.size() * 8) return -1;
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) {
    int64_t p = b->pos + i;
    v |= (uint32_t)((d[p >> 3] >> (p & 7)) & 1) << i;
  }
  b->pos += n;
  *out = v;
  return 0;
}

static inline int vbit(OggBitR* b, int* out) {
  const std::vector<uint8_t>& d = *b->d;
  if (b->pos >= (int64_t)d.size() * 8) return -1;
  *out = (d[b->pos >> 3] >> (b->pos & 7)) & 1;
  b->pos += 1;
  return 0;
}

static int vilog(int64_t x) {
  int n = 0;
  while (x > 0) { ++n; x >>= 1; }
  return n;
}

static double vfloat32_unpack(uint32_t x) {
  double mant = (double)(x & 0x1FFFFF);
  int exp = (int)((x & 0x7FE00000u) >> 21);
  if (x & 0x80000000u) mant = -mant;
  return mant * pow(2.0, exp - 788);
}

static int64_t lookup1_values(int64_t entries, int dim) {
  int64_t v = 1;
  for (;;) {
    double p = pow((double)(v + 1), (double)dim);
    if (p > (double)entries + 0.5) break;
    ++v;
  }
  return v;
}

// Huffman tree as a node pool: children >= 0 are node ids, < -1 encodes
// leaf entry -(e+2), -1 means empty.
struct Tree {
  std::vector<int64_t> kid;  // 2 per node
  int64_t alloc_node() { kid.push_back(-1); kid.push_back(-1); return kid.size() / 2 - 1; }
};

static int tree_alloc(Tree* t, int64_t node, int length, std::vector<int>* path) {
  for (int b = 0; b < 2; ++b) {
    int64_t child = t->kid[node * 2 + b];
    if (length == 1) {
      if (child == -1) { path->push_back(b); return 0; }
      continue;
    }
    if (child <= -2) continue;       // assigned leaf shadows prefix
    if (child == -1) {
      path->push_back(b);
      for (int i = 1; i < length; ++i) path->push_back(0);
      return 0;
    }
    path->push_back(b);
    if (tree_alloc(t, child, length - 1, path) == 0) return 0;
    path->pop_back();
  }
  return -1;
}

struct Codebook {
  int dim = 0;
  int64_t entries = 0;
  std::vector<int> lengths;
  Tree tree;
  int64_t root = -1;
  int64_t single = -1;       // single-used-entry book
  int lookup = 0;
  std::vector<double> vec;   // entries * dim VQ values
};

static int parse_codebook(OggBitR* br, Codebook* cb) {
  uint32_t sync, v;
  if (vrd(br, 24, &sync) || sync != 0x564342) return -1;
  if (vrd(br, 16, &v)) return -1;
  cb->dim = (int)v;
  if (vrd(br, 24, &v)) return -1;
  cb->entries = v;
  if (cb->entries <= 0 || cb->dim <= 0) return -1;
  cb->lengths.assign(cb->entries, 0);
  int bit;
  if (vbit(br, &bit)) return -1;
  if (bit) {                          // ordered
    uint32_t cl;
    if (vrd(br, 5, &cl)) return -1;
    int cur_len = (int)cl + 1;
    int64_t cur = 0;
    while (cur < cb->entries) {
      uint32_t num;
      if (vrd(br, vilog(cb->entries - cur), &num)) return -1;
      if (cur + (int64_t)num > cb->entries) return -1;
      for (int64_t i = cur; i < cur + (int64_t)num; ++i)
        cb->lengths[i] = cur_len;
      cur += num;
      ++cur_len;
      if (cur_len > 32) return -1;
    }
  } else {
    int sparse;
    if (vbit(br, &sparse)) return -1;
    for (int64_t i = 0; i < cb->entries; ++i) {
      if (sparse) {
        int used;
        if (vbit(br, &used)) return -1;
        if (!used) continue;
      }
      uint32_t l;
      if (vrd(br, 5, &l)) return -1;
      cb->lengths[i] = (int)l + 1;
    }
  }
  int64_t n_used = 0, only = -1;
  for (int64_t i = 0; i < cb->entries; ++i)
    if (cb->lengths[i]) { ++n_used; only = i; }
  if (n_used == 1) {
    cb->single = only;
  } else if (n_used > 1) {
    cb->root = cb->tree.alloc_node();
    std::vector<int> path;
    for (int64_t i = 0; i < cb->entries; ++i) {
      if (!cb->lengths[i]) continue;
      path.clear();
      if (tree_alloc(&cb->tree, cb->root, cb->lengths[i], &path)) return -2;
      int64_t node = cb->root;
      for (size_t j = 0; j + 1 < path.size(); ++j) {
        int64_t* slot = &cb->tree.kid[node * 2 + path[j]];
        if (*slot == -1) {
          int64_t fresh = cb->tree.alloc_node();
          // alloc_node may reallocate the vector; recompute the slot.
          cb->tree.kid[node * 2 + path[j]] = fresh;
          node = fresh;
        } else {
          node = *slot;
        }
      }
      cb->tree.kid[node * 2 + path.back()] = -(i + 2);
    }
  }
  uint32_t lt;
  if (vrd(br, 4, &lt)) return -1;
  cb->lookup = (int)lt;
  if (cb->lookup == 1 || cb->lookup == 2) {
    uint32_t mn, dl, vb;
    int seq;
    if (vrd(br, 32, &mn) || vrd(br, 32, &dl) || vrd(br, 4, &vb) ||
        vbit(br, &seq))
      return -1;
    double minv = vfloat32_unpack(mn), delta = vfloat32_unpack(dl);
    int value_bits = (int)vb + 1;
    int64_t count = cb->lookup == 1 ? lookup1_values(cb->entries, cb->dim)
                                    : cb->entries * cb->dim;
    std::vector<uint32_t> mult(count);
    for (int64_t i = 0; i < count; ++i)
      if (vrd(br, value_bits, &mult[i])) return -1;
    cb->vec.assign(cb->entries * cb->dim, 0.0);
    if (cb->lookup == 1) {
      int64_t lv = lookup1_values(cb->entries, cb->dim);
      for (int64_t e = 0; e < cb->entries; ++e) {
        double last = 0.0;
        int64_t idx_div = 1;
        for (int d = 0; d < cb->dim; ++d) {
          int64_t off = (e / idx_div) % lv;
          double val = mult[off] * delta + minv + last;
          if (seq) last = val;
          cb->vec[e * cb->dim + d] = val;
          idx_div *= lv;
        }
      }
    } else {
      for (int64_t e = 0; e < cb->entries; ++e) {
        double last = 0.0;
        for (int d = 0; d < cb->dim; ++d) {
          double val = mult[e * cb->dim + d] * delta + minv + last;
          if (seq) last = val;
          cb->vec[e * cb->dim + d] = val;
        }
      }
    }
  } else if (cb->lookup != 0) {
    return -1;
  }
  return 0;
}

static int cb_decode(const Codebook* cb, OggBitR* br, int64_t* entry) {
  if (cb->single >= 0) {
    uint32_t dummy;
    if (vrd(br, cb->lengths[cb->single], &dummy)) return -1;
    *entry = cb->single;
    return 0;
  }
  if (cb->root < 0) return -1;
  int64_t node = cb->root;
  for (;;) {
    int b;
    if (vbit(br, &b)) return -1;
    int64_t child = cb->tree.kid[node * 2 + b];
    if (child == -1) return -1;
    if (child <= -2) { *entry = -(child)-2; return 0; }
    node = child;
  }
}

struct Floor1 {
  int partitions = 0;
  std::vector<int> class_list, class_dims, class_subs, masterbooks;
  std::vector<std::vector<int>> subclass_books;
  int multiplier = 1;
  int rangebits = 0;
  std::vector<int> x_list;
};

static int parse_floor1(OggBitR* br, Floor1* fl) {
  uint32_t v;
  if (vrd(br, 5, &v)) return -1;
  fl->partitions = (int)v;
  int n_classes = 0;
  for (int p = 0; p < fl->partitions; ++p) {
    if (vrd(br, 4, &v)) return -1;
    fl->class_list.push_back((int)v);
    n_classes = std::max(n_classes, (int)v + 1);
  }
  for (int c = 0; c < n_classes; ++c) {
    if (vrd(br, 3, &v)) return -1;
    fl->class_dims.push_back((int)v + 1);
    uint32_t subs;
    if (vrd(br, 2, &subs)) return -1;
    fl->class_subs.push_back((int)subs);
    if (subs) {
      if (vrd(br, 8, &v)) return -1;
      fl->masterbooks.push_back((int)v);
    } else {
      fl->masterbooks.push_back(-1);
    }
    std::vector<int> row;
    for (int s = 0; s < (1 << subs); ++s) {
      if (vrd(br, 8, &v)) return -1;
      row.push_back((int)v - 1);
    }
    fl->subclass_books.push_back(row);
  }
  if (vrd(br, 2, &v)) return -1;
  fl->multiplier = (int)v + 1;
  if (vrd(br, 4, &v)) return -1;
  fl->rangebits = (int)v;
  fl->x_list = {0, 1 << fl->rangebits};
  for (int p = 0; p < fl->partitions; ++p)
    for (int d = 0; d < fl->class_dims[fl->class_list[p]]; ++d) {
      if (vrd(br, fl->rangebits, &v)) return -1;
      fl->x_list.push_back((int)v);
    }
  for (size_t i = 0; i < fl->x_list.size(); ++i)
    for (size_t j = i + 1; j < fl->x_list.size(); ++j)
      if (fl->x_list[i] == fl->x_list[j]) return -1;
  return 0;
}

static int render_point(int x0, int y0, int x1, int y1, int x) {
  int dy = y1 - y0, adx = x1 - x0;
  int err = abs(dy) * (x - x0);
  int off = err / adx;
  return dy < 0 ? y0 - off : y0 + off;
}

static void render_line(int x0, int y0, int x1, int y1, int64_t* v, int n2) {
  int dy = y1 - y0, adx = x1 - x0, ady = abs(dy);
  int base = adx ? dy / adx : 0;        // C truncation, like the twin
  int sy = dy < 0 ? base - 1 : base + 1;
  ady -= abs(base) * adx;
  int x = x0, y = y0, err = 0;
  if (x >= 0 && x < n2) v[x] = y;
  for (x = x0 + 1; x < x1 && x < n2; ++x) {
    err += ady;
    if (err >= adx) { err -= adx; y += sy; } else { y += base; }
    v[x] = y;
  }
}

static const double kInvDbLo = 1.0649863e-07;

// floor decode: returns 1 with curve filled, 0 for unused channel, <0 error
static int floor1_decode(const Floor1* fl, OggBitR* br,
                         const std::vector<Codebook>& books, int n2,
                         double* curve) {
  int nz;
  if (vbit(br, &nz)) return -1;
  if (!nz) return 0;
  static const int kRange[4] = {256, 128, 86, 64};
  int rng = kRange[fl->multiplier - 1];
  int ybits = vilog(rng - 1);
  int count = (int)fl->x_list.size();
  std::vector<int> y(count, 0);
  uint32_t v;
  if (vrd(br, ybits, &v)) return -1;
  y[0] = (int)v;
  if (vrd(br, ybits, &v)) return -1;
  y[1] = (int)v;
  int offset = 2;
  for (int p = 0; p < fl->partitions; ++p) {
    int cls = fl->class_list[p];
    int cdim = fl->class_dims[cls];
    int cbits = fl->class_subs[cls];
    int csub = (1 << cbits) - 1;
    int64_t cval = 0;
    if (cbits) {
      if (fl->masterbooks[cls] < 0 ||
          fl->masterbooks[cls] >= (int)books.size())
        return -1;
      if (cb_decode(&books[fl->masterbooks[cls]], br, &cval)) return -1;
    }
    for (int d = 0; d < cdim; ++d) {
      int book = fl->subclass_books[cls][cval & csub];
      cval >>= cbits;
      if (book >= 0) {
        if (book >= (int)books.size()) return -1;
        int64_t e;
        if (cb_decode(&books[book], br, &e)) return -1;
        y[offset + d] = (int)e;
      } else {
        y[offset + d] = 0;
      }
    }
    offset += cdim;
  }
  // amplitude synthesis
  std::vector<int> fin(count, 0);
  std::vector<char> step2(count, 0);
  fin[0] = y[0]; fin[1] = y[1];
  step2[0] = step2[1] = 1;
  for (int i = 2; i < count; ++i) {
    int lo = -1, hi = -1;
    for (int n = 0; n < i; ++n) {
      if (fl->x_list[n] < fl->x_list[i] &&
          (lo < 0 || fl->x_list[n] > fl->x_list[lo])) lo = n;
      if (fl->x_list[n] > fl->x_list[i] &&
          (hi < 0 || fl->x_list[n] < fl->x_list[hi])) hi = n;
    }
    if (lo < 0 || hi < 0) return -1;
    int pred = render_point(fl->x_list[lo], fin[lo], fl->x_list[hi], fin[hi],
                            fl->x_list[i]);
    int val = y[i];
    int highroom = rng - pred, lowroom = pred;
    int room = 2 * std::min(highroom, lowroom);
    if (val) {
      step2[lo] = step2[hi] = step2[i] = 1;
      if (val >= room)
        fin[i] = highroom > lowroom ? val - lowroom + pred
                                    : pred - (val - highroom) - 1;
      else if (val & 1)
        fin[i] = pred - ((val + 1) >> 1);
      else
        fin[i] = pred + (val >> 1);
    } else {
      step2[i] = 0;
      fin[i] = pred;
    }
  }
  std::vector<int> order(count);
  for (int i = 0; i < count; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return fl->x_list[a] < fl->x_list[b];
  });
  std::vector<int64_t> out(n2, 0);
  int hx = 0, lx = 0;
  int hy = fin[order[0]] * fl->multiplier;
  int ly = hy;
  for (int oi = 0; oi < count; ++oi) {
    int i = order[oi];
    if (!step2[i]) continue;
    hx = std::min(fl->x_list[i], n2);
    hy = fin[i] * fl->multiplier;
    if (hx > lx) render_line(lx, ly, fl->x_list[i], hy, out.data(), n2);
    lx = fl->x_list[i];
    ly = hy;
    if (lx >= n2) break;
  }
  if (hx < n2)
    for (int j = hx; j < n2; ++j) out[j] = hy;
  double lgstep = log(1.0 / kInvDbLo) / 255.0;
  for (int j = 0; j < n2; ++j) {
    int64_t idx = out[j] < 0 ? 0 : (out[j] > 255 ? 255 : out[j]);
    curve[j] = kInvDbLo * exp((double)idx * lgstep);
  }
  return 1;
}

struct ResidueCfg {
  int rtype = 0;
  int64_t begin = 0, end = 0, psize = 0;
  int classifications = 0, classbook = 0;
  std::vector<int> cascades;
  std::vector<std::vector<int>> books;
};

static int parse_residue(OggBitR* br, int rtype, ResidueCfg* rs) {
  uint32_t v;
  rs->rtype = rtype;
  if (vrd(br, 24, &v)) return -1;
  rs->begin = v;
  if (vrd(br, 24, &v)) return -1;
  rs->end = v;
  if (vrd(br, 24, &v)) return -1;
  rs->psize = (int64_t)v + 1;
  if (vrd(br, 6, &v)) return -1;
  rs->classifications = (int)v + 1;
  if (vrd(br, 8, &v)) return -1;
  rs->classbook = (int)v;
  for (int c = 0; c < rs->classifications; ++c) {
    uint32_t low;
    if (vrd(br, 3, &low)) return -1;
    int flag;
    if (vbit(br, &flag)) return -1;
    uint32_t high = 0;
    if (flag && vrd(br, 5, &high)) return -1;
    rs->cascades.push_back((int)((high << 3) | low));
  }
  for (int c = 0; c < rs->classifications; ++c) {
    std::vector<int> row;
    for (int p = 0; p < 8; ++p) {
      if (rs->cascades[c] & (1 << p)) {
        if (vrd(br, 8, &v)) return -1;
        row.push_back((int)v);
      } else {
        row.push_back(-1);
      }
    }
    rs->books.push_back(row);
  }
  return 0;
}

static int residue_partition(const ResidueCfg* rs, const Codebook* book,
                             OggBitR* br, double* v, int64_t offset,
                             int64_t limit) {
  int dim = book->dim;
  if (dim <= 0 || book->vec.empty()) return -1;
  if (offset + rs->psize > limit) return -1;   // matches the twin's guard
  if (rs->rtype == 0) {
    int64_t step = rs->psize / dim;
    for (int64_t i = 0; i < step; ++i) {
      int64_t e;
      if (cb_decode(book, br, &e)) return -1;
      for (int d = 0; d < dim; ++d)
        v[offset + i + d * step] += book->vec[e * dim + d];
    }
  } else {
    for (int64_t i = 0; i < rs->psize; i += dim) {
      int64_t e;
      if (cb_decode(book, br, &e)) return -1;
      for (int d = 0; d < dim && offset + i + d < limit; ++d)
        v[offset + i + d] += book->vec[e * dim + d];
    }
  }
  return 0;
}

static int residue_core(const ResidueCfg* rs, OggBitR* br,
                        const std::vector<Codebook>& books,
                        std::vector<double*>& vecs,
                        const std::vector<char>& skip, int64_t n) {
  int ch = (int)vecs.size();
  int64_t begin = std::min(rs->begin, n), end = std::min(rs->end, n);
  int64_t n_read = end - begin;
  if (n_read <= 0) return 0;
  if (rs->classbook >= (int)books.size()) return -1;
  const Codebook& classbook = books[rs->classbook];
  int cw = classbook.dim;
  if (cw <= 0 || rs->psize <= 0) return -1;
  int64_t parts = n_read / rs->psize;
  std::vector<std::vector<int>> classifs(
      ch, std::vector<int>(parts + cw, 0));
  for (int pass = 0; pass < 8; ++pass) {
    int64_t p = 0;
    while (p < parts) {
      if (pass == 0) {
        for (int c = 0; c < ch; ++c) {
          if (skip[c]) continue;
          int64_t temp;
          if (cb_decode(&classbook, br, &temp)) return -1;
          for (int i = cw - 1; i >= 0; --i) {
            classifs[c][p + i] = (int)(temp % rs->classifications);
            temp /= rs->classifications;
          }
        }
      }
      for (int k = 0; k < cw && p < parts; ++k, ++p) {
        for (int c = 0; c < ch; ++c) {
          if (skip[c]) continue;
          int cls = classifs[c][p];
          int vq = rs->books[cls][pass];
          if (vq < 0) continue;
          if (vq >= (int)books.size()) return -1;
          if (residue_partition(rs, &books[vq], br, vecs[c],
                                begin + p * rs->psize, n))
            return -1;
        }
      }
    }
  }
  return 0;
}

struct MappingCfg {
  int submaps = 1;
  std::vector<std::pair<int, int>> coupling;
  std::vector<int> mux, floor_i, residue_i;
};

struct ModeCfg {
  int blockflag = 0;
  int mapping = 0;
};

}  // namespace vorbis

static int vorbis_decode_vec(const uint8_t* data, int64_t size,
                             std::vector<float>* out, int32_t* out_rate) {
  using namespace vorbis;
  // ---- Ogg layer ----
  if (size < 27 || memcmp(data, "OggS", 4) != 0) return -1;
  std::vector<std::vector<uint8_t>> packets;
  std::vector<int64_t> pkt_granule;
  {
    std::vector<uint8_t> cur;
    int64_t pos = 0;
    while (pos + 27 <= size) {
      if (memcmp(data + pos, "OggS", 4) != 0) return -20;
      if (data[pos + 4] != 0) return -21;
      int64_t granule;
      memcpy(&granule, data + pos + 6, 8);
      uint32_t crc;
      memcpy(&crc, data + pos + 22, 4);
      int n_segs = data[pos + 26];
      if (pos + 27 + n_segs > size) return -22;
      int64_t body_len = 0;
      for (int i = 0; i < n_segs; ++i) body_len += data[pos + 27 + i];
      int64_t body_start = pos + 27 + n_segs;
      if (body_start + body_len > size) return -22;
      // CRC with the checksum field zeroed (table-free bitwise form).
      uint32_t c = 0;
      for (int64_t i = pos; i < body_start + body_len; ++i) {
        uint8_t byte = (i >= pos + 22 && i < pos + 26) ? 0 : data[i];
        c ^= (uint32_t)byte << 24;
        for (int k = 0; k < 8; ++k)
          c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : (c << 1);
      }
      if (c != crc) return -23;
      int64_t off = body_start;
      for (int i = 0; i < n_segs; ++i) {
        int lv = data[pos + 27 + i];
        cur.insert(cur.end(), data + off, data + off + lv);
        off += lv;
        if (lv < 255) {
          packets.push_back(cur);
          pkt_granule.push_back(granule);
          cur.clear();
        }
      }
      pos = body_start + body_len;
    }
    if (!cur.empty()) return -24;
  }
  if (packets.size() < 4) return -25;

  // ---- headers ----
  const std::vector<uint8_t>& ident = packets[0];
  if (ident.size() < 30 || memcmp(ident.data(), "\x01vorbis", 7) != 0)
    return -30;
  uint32_t version;
  memcpy(&version, ident.data() + 7, 4);
  if (version != 0) return -30;
  int channels = ident[11];
  int32_t rate;
  memcpy(&rate, ident.data() + 12, 4);
  if (channels <= 0 || rate <= 0) return -30;
  int bs0 = 1 << (ident[28] & 0xF), bs1 = 1 << (ident[28] >> 4);
  if (bs0 < 64 || bs1 > 8192 || bs0 > bs1) return -30;
  if (!(ident[29] & 1)) return -30;
  if (packets[1].size() < 7 || memcmp(packets[1].data(), "\x03vorbis", 7))
    return -31;
  if (packets[2].size() < 7 || memcmp(packets[2].data(), "\x05vorbis", 7))
    return -32;
  std::vector<uint8_t> setup(packets[2].begin() + 7, packets[2].end());
  OggBitR br{&setup, 0};
  uint32_t v;
  if (vrd(&br, 8, &v)) return -33;
  std::vector<Codebook> books(v + 1);
  for (auto& cb : books)
    if (parse_codebook(&br, &cb)) return -34;
  if (vrd(&br, 6, &v)) return -33;
  for (uint32_t i = 0; i <= v; ++i) {
    uint32_t t;
    if (vrd(&br, 16, &t) || t != 0) return -35;
  }
  if (vrd(&br, 6, &v)) return -33;
  std::vector<Floor1> floors(v + 1);
  for (auto& fl : floors) {
    uint32_t ft;
    if (vrd(&br, 16, &ft)) return -33;
    if (ft != 1) return -36;             // floor 0 unsupported, like the twin
    if (parse_floor1(&br, &fl)) return -36;
  }
  if (vrd(&br, 6, &v)) return -33;
  std::vector<ResidueCfg> residues(v + 1);
  for (auto& rs : residues) {
    uint32_t rt;
    if (vrd(&br, 16, &rt) || rt > 2) return -37;
    if (parse_residue(&br, (int)rt, &rs)) return -37;
  }
  if (vrd(&br, 6, &v)) return -33;
  std::vector<MappingCfg> mappings(v + 1);
  for (auto& mp : mappings) {
    uint32_t mt;
    if (vrd(&br, 16, &mt) || mt != 0) return -38;
    int flag;
    if (vbit(&br, &flag)) return -38;
    if (flag) {
      if (vrd(&br, 4, &v)) return -38;
      mp.submaps = (int)v + 1;
    }
    if (vbit(&br, &flag)) return -38;
    if (flag) {
      if (vrd(&br, 8, &v)) return -38;
      int steps = (int)v + 1;
      int bits = vilog(channels - 1);
      for (int s = 0; s < steps; ++s) {
        uint32_t m, a;
        if (vrd(&br, bits, &m) || vrd(&br, bits, &a)) return -38;
        if ((int)m >= channels || (int)a >= channels || m == a) return -38;
        mp.coupling.push_back({(int)m, (int)a});
      }
    }
    if (vrd(&br, 2, &v) || v != 0) return -38;
    mp.mux.assign(channels, 0);
    if (mp.submaps > 1)
      for (int c = 0; c < channels; ++c) {
        if (vrd(&br, 4, &v)) return -38;
        if ((int)v >= mp.submaps) return -38;
        mp.mux[c] = (int)v;
      }
    for (int s = 0; s < mp.submaps; ++s) {
      if (vrd(&br, 8, &v)) return -38;
      if (vrd(&br, 8, &v)) return -38;
      if ((int)v >= (int)floors.size()) return -38;
      mp.floor_i.push_back((int)v);
      if (vrd(&br, 8, &v)) return -38;
      if ((int)v >= (int)residues.size()) return -38;
      mp.residue_i.push_back((int)v);
    }
  }
  if (vrd(&br, 6, &v)) return -33;
  std::vector<ModeCfg> modes(v + 1);
  for (auto& md : modes) {
    int flag;
    if (vbit(&br, &flag)) return -39;
    md.blockflag = flag;
    uint32_t w16;
    if (vrd(&br, 16, &w16) || w16 != 0) return -39;
    if (vrd(&br, 16, &w16) || w16 != 0) return -39;
    if (vrd(&br, 8, &v)) return -39;
    if ((int)v >= (int)mappings.size()) return -39;
    md.mapping = (int)v;
  }
  int fb;
  if (vbit(&br, &fb) || !fb) return -33;

  // ---- audio packets ----
  int mode_bits = vilog((int64_t)modes.size() - 1);
  std::vector<std::vector<double>> prev_right(channels);
  int prev_n = 0;
  std::vector<std::vector<double>> pcm(channels);
  int64_t granule = -1;
  // IMDCT basis cache per block size (at most two: blocksize0/1). The
  // direct per-element cos() was ~6x realtime; tabulating the basis keeps
  // the accumulation order (and thus the output bits) identical while the
  // inner loop becomes a pure FMA row dot the compiler vectorizes — the
  // NumPy twin does the same (io/vorbis.py _imdct_matrix).
  std::vector<double> imdct_tbl[2];
  int imdct_tbl_n[2] = {0, 0};
  for (size_t pi = 3; pi < packets.size(); ++pi) {
    OggBitR pb{&packets[pi], 0};
    int bit;
    if (vbit(&pb, &bit) || bit != 0) return -40;
    uint32_t mnum = 0;
    if (mode_bits && vrd(&pb, mode_bits, &mnum)) return -40;
    if (mnum >= modes.size()) return -40;
    const ModeCfg& mode = modes[mnum];
    const MappingCfg& mp = mappings[mode.mapping];
    int n = mode.blockflag ? bs1 : bs0;
    int n2 = n / 2;
    int wf_prev = 1, wf_next = 1;
    if (mode.blockflag) {
      if (vbit(&pb, &wf_prev) || vbit(&pb, &wf_next)) return -40;
    }
    std::vector<std::vector<double>> curves(channels);
    std::vector<char> no_res(channels, 0);
    for (int c = 0; c < channels; ++c) {
      curves[c].assign(n2, 0.0);
      int rc = floor1_decode(&floors[mp.floor_i[mp.mux[c]]], &pb, books, n2,
                             curves[c].data());
      if (rc < 0) return -41;
      no_res[c] = rc == 0;
    }
    for (auto& cp : mp.coupling)
      if (!(no_res[cp.first] && no_res[cp.second]))
        no_res[cp.first] = no_res[cp.second] = 0;
    std::vector<std::vector<double>> res(channels,
                                         std::vector<double>(n2, 0.0));
    for (int sm = 0; sm < mp.submaps; ++sm) {
      std::vector<int> chans;
      for (int c = 0; c < channels; ++c)
        if (mp.mux[c] == sm) chans.push_back(c);
      const ResidueCfg& rs = residues[mp.residue_i[sm]];
      if (rs.rtype == 2) {
        bool all_skip = true;
        for (int c : chans) all_skip = all_skip && no_res[c];
        if (!all_skip) {
          std::vector<double> inter((int64_t)chans.size() * n2, 0.0);
          std::vector<double*> vecs{inter.data()};
          std::vector<char> skip{0};
          if (residue_core(&rs, &pb, books, vecs, skip,
                           (int64_t)chans.size() * n2))
            return -42;
          for (size_t ci = 0; ci < chans.size(); ++ci)
            for (int j = 0; j < n2; ++j)
              res[chans[ci]][j] += inter[(int64_t)j * chans.size() + ci];
        }
      } else {
        std::vector<double*> vecs;
        std::vector<char> skip;
        for (int c : chans) {
          vecs.push_back(res[c].data());
          skip.push_back(no_res[c]);
        }
        if (residue_core(&rs, &pb, books, vecs, skip, n2)) return -42;
      }
    }
    for (int s = (int)mp.coupling.size() - 1; s >= 0; --s) {
      double* m = res[mp.coupling[s].first].data();
      double* a = res[mp.coupling[s].second].data();
      for (int j = 0; j < n2; ++j) {
        double M = m[j], A = a[j], nm, na;
        if (M > 0) {
          if (A > 0) { nm = M; na = M - A; }
          else { na = M; nm = M + A; }
        } else {
          if (A > 0) { nm = M; na = M + A; }
          else { na = M; nm = M - A; }
        }
        m[j] = nm; a[j] = na;
      }
    }
    // window geometry
    int left_n = (mode.blockflag && !wf_prev) ? bs0 : n;
    int right_n = (mode.blockflag && !wf_next) ? bs0 : n;
    int left_start = n / 4 - left_n / 4;
    int right_start = 3 * n / 4 - right_n / 4;
    std::vector<double> win(n, 0.0);
    for (int i = 0; i < left_n / 2; ++i) {
      double s = sin(M_PI / left_n * (i + 0.5));
      win[left_start + i] = sin(0.5 * M_PI * s * s);
    }
    for (int i = left_start + left_n / 2; i < right_start; ++i) win[i] = 1.0;
    for (int i = 0; i < right_n / 2; ++i) {
      double s = sin(M_PI / right_n * (right_n / 2 + i + 0.5));
      win[right_start + i] = sin(0.5 * M_PI * s * s);
    }
    for (int c = 0; c < channels; ++c) {
      std::vector<double> blk(n, 0.0);
      if (!no_res[c]) {
        // spectrum = floor * residue; IMDCT as a tabulated-basis matvec
        std::vector<double> spec(n2);
        for (int j = 0; j < n2; ++j) spec[j] = curves[c][j] * res[c][j];
        int slot = (imdct_tbl_n[0] == n) ? 0
                   : (imdct_tbl_n[1] == n) ? 1
                   : (imdct_tbl_n[0] == 0 ? 0 : 1);
        if (imdct_tbl_n[slot] != n) {
          imdct_tbl[slot].resize((size_t)n * n2);
          for (int j = 0; j < n; ++j)
            for (int k = 0; k < n2; ++k)
              imdct_tbl[slot][(size_t)j * n2 + k] =
                  cos(2.0 * M_PI / n * (j + 0.5 + n2 / 2.0) * (k + 0.5));
          imdct_tbl_n[slot] = n;
        }
        const double* tbl = imdct_tbl[slot].data();
        for (int j = 0; j < n; ++j) {
          const double* row = tbl + (size_t)j * n2;
          double acc = 0.0;
          for (int k = 0; k < n2; ++k) acc += spec[k] * row[k];
          blk[j] = acc;
        }
      }
      for (int j = 0; j < n; ++j) blk[j] *= win[j];
      if (!prev_right[c].empty() || prev_n) {
        int span = prev_n / 4 + n / 4;
        std::vector<double> buf(span, 0.0);
        int m = std::min((int)prev_right[c].size(), span);
        for (int j = 0; j < m; ++j) buf[j] += prev_right[c][j];
        int shift = span - n2;
        int j0 = shift < 0 ? -shift : 0;
        for (int j = j0; j < n2; ++j) buf[shift + j] += blk[j];
        pcm[c].insert(pcm[c].end(), buf.begin(), buf.end());
      }
      prev_right[c].assign(blk.begin() + n2, blk.end());
    }
    prev_n = n;
    if (pkt_granule[pi] >= 0) granule = pkt_granule[pi];
  }
  if (pcm[0].empty()) return -43;
  int64_t total = (int64_t)pcm[0].size();
  if (granule >= 0 && granule < total) total = granule;
  *out_rate = rate;
  out->resize(total);
  for (int64_t i = 0; i < total; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) acc += pcm[c][i];
    (*out)[i] = (float)(acc / channels);
  }
  return 0;
}

int hpfw_vorbis_decode(const uint8_t* data, int64_t size,
                       float* out, int64_t* out_n, int32_t* out_rate) {
  std::vector<float> v;
  int rc = vorbis_decode_vec(data, size, &v, out_rate);
  if (rc) return rc;
  *out_n = (int64_t)v.size();
  if (out) memcpy(out, v.data(), v.size() * sizeof(float));
  return 0;
}

// Linear resampler — arithmetic identical to io/wav.py resample_linear.
int64_t hpfw_resample_len(int64_t n_in, int32_t sr_in, int32_t sr_out) {
  return (int64_t)((double)n_in * sr_out / sr_in);
}

void hpfw_resample_linear(const float* in, int64_t n_in, int32_t sr_in,
                          int32_t sr_out, float* out, int64_t n_out) {
  double step = (double)sr_in / sr_out;
  for (int64_t i = 0; i < n_out; ++i) {
    double src = i * step;
    int64_t i0 = (int64_t)src;
    if (i0 > n_in - 1) i0 = n_in - 1;
    int64_t i1 = i0 + 1 < n_in ? i0 + 1 : n_in - 1;
    float frac = (float)(src - (double)i0);
    out[i] = (1.0f - frac) * in[i0] + frac * in[i1];
  }
}

// ---------------------------------------------------------------------------
// Polyphase windowed-sinc (Kaiser) resampler — the reference-grade default.
// Mirrors io/wav.py resample_sinc (scipy.resample_poly-equivalent design);
// float64 accumulation, so the NumPy twin matches to ~1 float32 ulp
// (tests/test_resample.py margin-tests rather than bit-asserts — the only
// twin pair that is float, not integer).
// ---------------------------------------------------------------------------
static double bessel_i0(double x) {
  // Power series; converges fast for the beta*sqrt(...) <= 5 range used.
  double sum = 1.0, term = 1.0, hx = x / 2.0;
  for (int k = 1; k < 256; ++k) {
    double f = hx / k;
    term *= f * f;
    sum += term;
    if (term < sum * 1e-18) break;
  }
  return sum;
}

static int64_t gcd64(int64_t a, int64_t b) {
  while (b) { int64_t t = a % b; a = b; b = t; }
  return a;
}

int64_t hpfw_resample_sinc_len(int64_t n_in, int32_t sr_in, int32_t sr_out) {
  int64_t g = gcd64(sr_in, sr_out);
  int64_t l = sr_out / g, m = sr_in / g;
  if (l == m) return n_in;
  return (n_in * l + m - 1) / m;
}

void hpfw_resample_sinc(const float* in, int64_t n_in, int32_t sr_in,
                        int32_t sr_out, float* out, int64_t n_out) {
  int64_t g = gcd64(sr_in, sr_out);
  int64_t l = sr_out / g, m = sr_in / g;
  if (l == m) {
    for (int64_t i = 0; i < n_out && i < n_in; ++i) out[i] = in[i];
    return;
  }
  const double beta = 5.0;                   // scipy resample_poly default
  int64_t mx = l > m ? l : m;
  int64_t half = 10 * mx;
  int64_t taps = 2 * half + 1;
  std::vector<double> h(taps);
  double denom = bessel_i0(beta);
  double alpha = (double)(taps - 1) / 2.0;
  double sum = 0.0;
  for (int64_t i = 0; i < taps; ++i) {
    double t = (double)(i - half);
    double a = M_PI * t / (double)mx;
    double snc = t == 0.0 ? 1.0 : sin(a) / a;
    double r = ((double)i - alpha) / alpha;
    double w = bessel_i0(beta * sqrt(std::max(0.0, 1.0 - r * r))) / denom;
    h[i] = (1.0 / (double)mx) * snc * w;
    sum += h[i];
  }
  for (int64_t i = 0; i < taps; ++i) h[i] = h[i] / sum * (double)l;
  int64_t d = half;                          // center-tap group delay
  for (int64_t o = 0; o < n_out; ++o) {
    int64_t u = d + o * m;                   // position on upsampled grid
    int64_t ihi = u / l;
    double acc = 0.0;
    for (int64_t i = ihi; i >= 0; --i) {     // tap index ascending, like the twin
      int64_t k = u - l * i;
      if (k >= taps) break;
      if (i < n_in) acc += h[k] * (double)in[i];
    }
    out[o] = (float)acc;
  }
}

// ---------------------------------------------------------------------------
// Hashprint extraction (the reference's C++ fingerprint() surface,
// SURVEY.md §1.2): framed NDFT CQT -> log magnitude -> context-window
// projection -> delta -> sign -> packed 64-bit hashprints. Mirrors
// hpfw_jax/oracle/pipeline.py in float64; the sign threshold makes the
// result equal to the oracle except at ~zero delta margins
// (tests/test_native.py margin-audits it). Frames parallelize across a
// std::thread pool — the reference's CPU batch-driver style.
// Two-call protocol like the decoders; out holds uint64 hashprints.
// ---------------------------------------------------------------------------
static void parallel_for(int64_t n, int32_t n_threads,
                         const std::function<void(int64_t)>& fn) {
  if (n_threads <= 0)
    n_threads = (int32_t)std::max(1u, std::thread::hardware_concurrency());
  n_threads = (int32_t)std::min<int64_t>(n_threads, n);
  if (n_threads <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int32_t i = 0; i < n_threads; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

int hpfw_fingerprint(
    const float* pcm, int64_t n_samples, const float* filters,
    int32_t sample_rate, int32_t frame_len, int32_t hop, int32_t n_bins,
    double fmin, int32_t bins_per_octave, int32_t window_hamming,
    double log_eps, int32_t context_w, int32_t delta_lag,
    int32_t bit_order_msb0, int32_t tie_ge, int32_t n_threads,
    uint64_t* out, int64_t* out_n) {
  if (sample_rate <= 0 || frame_len <= 0 || hop <= 0 || n_bins <= 0 ||
      context_w <= 0 || delta_lag <= 0)
    return -1;
  int64_t n_frames =
      n_samples < frame_len ? 0 : 1 + (n_samples - frame_len) / hop;
  int64_t n_ctx = n_frames - context_w + 1;
  int64_t n_prints = n_ctx - delta_lag;
  if (n_prints < 0) n_prints = 0;
  *out_n = n_prints;
  if (!out) return 0;
  if (n_prints == 0) return 0;

  // Per-bin CQT kernels (window-weighted complex exponentials / n_k).
  double q = 1.0 / (pow(2.0, 1.0 / bins_per_octave) - 1.0);
  std::vector<int32_t> koff(n_bins), klen(n_bins);
  std::vector<std::vector<double>> kre(n_bins), kim(n_bins);
  for (int32_t k = 0; k < n_bins; ++k) {
    double f_k = fmin * pow(2.0, (double)k / bins_per_octave);
    int32_t n_k = (int32_t)ceil(q * sample_rate / f_k);
    if (n_k > frame_len) return -2;
    klen[k] = n_k;
    koff[k] = (frame_len - n_k) / 2;
    kre[k].resize(n_k);
    kim[k].resize(n_k);
    for (int32_t n = 0; n < n_k; ++n) {
      double win =
          window_hamming
              ? 0.54 - 0.46 * cos(2.0 * M_PI * (n + 0.5) / n_k)
              : 0.5 - 0.5 * cos(2.0 * M_PI * (n + 0.5) / n_k);
      double ph = -2.0 * M_PI * f_k * n / sample_rate;
      kre[k][n] = win * cos(ph) / n_k;
      kim[k][n] = win * sin(ph) / n_k;
    }
  }

  // Log-magnitude CQT, frames across the thread pool.
  std::vector<double> spec((size_t)n_frames * n_bins);
  parallel_for(n_frames, n_threads, [&](int64_t t) {
    const float* fr = pcm + t * hop;
    for (int32_t k = 0; k < n_bins; ++k) {
      const double* re = kre[k].data();
      const double* im = kim[k].data();
      const float* x = fr + koff[k];
      double sr_ = 0.0, si = 0.0;
      for (int32_t n = 0; n < klen[k]; ++n) {
        double v = (double)x[n];
        sr_ += v * re[n];
        si += v * im[n];
      }
      spec[t * n_bins + k] = log(log_eps + sqrt(sr_ * sr_ + si * si));
    }
  });

  // Context projection y(n) = F^T x(n), then delta/sign/pack per print.
  std::vector<double> y((size_t)n_ctx * 64);
  parallel_for(n_ctx, n_threads, [&](int64_t n) {
    double acc[64] = {0.0};
    for (int32_t j = 0; j < context_w; ++j) {
      const double* s = &spec[(n + j) * n_bins];
      const float* frow = filters + (size_t)j * n_bins * 64;
      for (int32_t b = 0; b < n_bins; ++b) {
        double v = s[b];
        const float* fcol = frow + (size_t)b * 64;
        for (int32_t f = 0; f < 64; ++f) acc[f] += v * (double)fcol[f];
      }
    }
    for (int32_t f = 0; f < 64; ++f) y[n * 64 + f] = acc[f];
  });

  parallel_for(n_prints, n_threads, [&](int64_t n) {
    uint64_t h = 0;
    for (int32_t f = 0; f < 64; ++f) {
      double d = y[n * 64 + f] - y[(n + delta_lag) * 64 + f];
      bool bit = tie_ge ? (d >= 0.0) : (d > 0.0);
      int32_t pos = bit_order_msb0 ? 63 - f : f;
      if (bit) h |= (uint64_t)1 << pos;
    }
    out[n] = h;
  });
  return 0;
}

// ---------------------------------------------------------------------------
// CPU Hamming matcher. Packed prints as uint64 words (lo|hi<<32 of the
// uint32 pairs). Semantics identical to oracle.match_track: offsets
// [0, len-N] for len >= N, else truncated head overlap at offset 0; best
// score with first-offset tie-break.
// ---------------------------------------------------------------------------
static inline int64_t score_at(const uint64_t* q, int64_t nq,
                               const uint64_t* d) {
  int64_t pop = 0;
  for (int64_t n = 0; n < nq; ++n)
    pop += __builtin_popcountll(q[n] ^ d[n]);
  return 64 * nq - pop;
}

void hpfw_match_track(const uint64_t* query, int64_t n_query,
                      const uint64_t* track, int64_t n_track,
                      int64_t* best_score, int64_t* best_offset) {
  if (n_track < n_query) {
    *best_score = score_at(query, n_track, track);
    *best_offset = 0;
    return;
  }
  int64_t bs = -1, bo = 0;
  for (int64_t o = 0; o + n_query <= n_track; ++o) {
    int64_t s = score_at(query, n_query, track + o);
    if (s > bs) { bs = s; bo = o; }
  }
  *best_score = bs;
  *best_offset = bo;
}

// Batch scan: tracks are rows of a padded (n_tracks, max_len) uint64 array
// with per-track lengths; a thread pool splits tracks (the reference's
// CPU-parallel catalog driver, rebuilt).
void hpfw_match_db(const uint64_t* query, int64_t n_query,
                   const uint64_t* db, const int64_t* lengths,
                   int64_t n_tracks, int64_t max_len,
                   int64_t* scores, int64_t* offsets, int32_t n_threads) {
  if (n_threads <= 0)
    n_threads = (int32_t)std::max(1u, std::thread::hardware_concurrency());
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t t = next.fetch_add(1);
      if (t >= n_tracks) return;
      hpfw_match_track(query, n_query, db + t * max_len, lengths[t],
                       &scores[t], &offsets[t]);
    }
  };
  std::vector<std::thread> pool;
  int32_t n = (int32_t)std::min<int64_t>(n_threads, n_tracks);
  pool.reserve(n);
  for (int32_t i = 0; i < n; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Threaded multi-file ingest driver — the native batch front end for
// files -> fingerprints -> DB catalog builds (SURVEY.md §3.2: "for each
// catalog track: fingerprint(audio)" from files; §2.1 rows 1+8: the
// reference pairs its native loader with a CPU thread pool over tracks).
// Each file is read, magic-dispatched to the one-pass decoder, downmixed,
// and resampled to the target rate entirely in native code across the
// std::thread pool; Python copies out finished PCM (or falls back to the
// NumPy loader for files this driver rejects, e.g. Sun .au).
// ---------------------------------------------------------------------------

namespace ingest {

struct Batch {
  std::vector<std::vector<float>> pcm;
  std::vector<int32_t> rate;
  std::vector<int32_t> rc;
};

static int read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -100;
  if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -100; }
  long sz = ftell(f);
  if (sz < 0) { fclose(f); return -100; }
  if (fseek(f, 0, SEEK_SET) != 0) { fclose(f); return -100; }
  out->resize((size_t)sz);
  size_t got = sz ? fread(out->data(), 1, (size_t)sz, f) : 0;
  fclose(f);
  return got == (size_t)sz ? 0 : -100;
}

static int decode_dispatch(const uint8_t* data, int64_t size,
                           std::vector<float>* out, int32_t* rate) {
  if (size >= 4 && memcmp(data, "fLaC", 4) == 0)
    return flac_decode_vec(data, size, out, rate);
  if (size >= 4 && memcmp(data, "OggS", 4) == 0) {
    // The first packet's codec magic decides Opus vs Vorbis (the first Ogg
    // page is tiny, so the ident packet starts right after the lacing).
    int n_segs = size >= 27 ? data[26] : 0;
    int64_t b0 = 27 + n_segs;
    if (size >= b0 + 8 && memcmp(data + b0, "OpusHead", 8) == 0)
      return hpfw_opus_decode_vec(data, size, out, rate, nullptr);
    return vorbis_decode_vec(data, size, out, rate);
  }
  if (size >= 12 && ((memcmp(data, "RIFF", 4) == 0 &&
                      memcmp(data + 8, "WAVE", 4) == 0) ||
                     memcmp(data, "FORM", 4) == 0)) {
    // WAV/AIFF sizing from the header is cheap; reuse the two-call entry.
    int64_t n = 0;
    int rc = hpfw_wav_decode(data, size, nullptr, &n, rate);
    if (rc) return rc;
    out->resize(n);
    return hpfw_wav_decode(data, size, out->data(), &n, rate);
  }
  // Known container magics WITHOUT a native decoder (Sun .au) must be
  // rejected here — their PCM payloads can contain spurious MPEG sync
  // patterns the last-resort decoder would happily turn into garbage.
  if (size >= 4 && memcmp(data, ".snd", 4) == 0) return -101;
  // ADTS AAC first (its chained sync scan is decisive; the MPEG heuristic
  // can fire on spurious syncs inside AAC payload bytes — io/wav.py keeps
  // the same order).
  {
    int64_t scan = size < 8192 ? size : 8192;
    int64_t p = hpfw_aac_find_sync(data, scan, 0);
    if (p >= 0 && p <= 4096) return hpfw_aac_decode_vec(data, size, out, rate);
  }
  // No decisive container magic: treat as MPEG audio (ID3 tag or raw frame
  // sync). The decoder fails cleanly (-1) on non-MPEG bytes; callers fall
  // back to the Python loader for anything rejected here.
  return hpfw_mp3_decode_vec(data, size, out, rate);
}

}  // namespace ingest

extern "C" {

// Decode (and resample) n_files audio files across the thread pool.
// Returns an opaque handle (free with hpfw_ingest_free) whose per-file
// results are read with the getters below; rc 0 = ok, negative = read or
// decode failure for that file only. target_rate 0 keeps source rates.
void* hpfw_ingest_files(const char* const* paths, int64_t n_files,
                        int32_t target_rate, int32_t n_threads) {
  auto* b = new ingest::Batch;
  b->pcm.resize(n_files);
  b->rate.assign(n_files, 0);
  b->rc.assign(n_files, -99);
  parallel_for(n_files, n_threads, [&](int64_t i) {
    std::vector<uint8_t> raw;
    int rc = ingest::read_file(paths[i], &raw);
    if (rc == 0)
      rc = ingest::decode_dispatch(raw.data(), (int64_t)raw.size(),
                                   &b->pcm[i], &b->rate[i]);
    if (rc == 0 && target_rate > 0 && b->rate[i] != target_rate) {
      int64_t n_out = hpfw_resample_sinc_len((int64_t)b->pcm[i].size(),
                                             b->rate[i], target_rate);
      std::vector<float> res((size_t)n_out);
      hpfw_resample_sinc(b->pcm[i].data(), (int64_t)b->pcm[i].size(),
                         b->rate[i], target_rate, res.data(), n_out);
      b->pcm[i] = std::move(res);
      b->rate[i] = target_rate;
    }
    if (rc != 0) b->pcm[i].clear();
    b->rc[i] = rc;
  });
  return b;
}

int32_t hpfw_ingest_rc(void* h, int64_t i) {
  return static_cast<ingest::Batch*>(h)->rc[(size_t)i];
}

int64_t hpfw_ingest_len(void* h, int64_t i) {
  return (int64_t)static_cast<ingest::Batch*>(h)->pcm[(size_t)i].size();
}

int32_t hpfw_ingest_rate(void* h, int64_t i) {
  return static_cast<ingest::Batch*>(h)->rate[(size_t)i];
}

int hpfw_ingest_get(void* h, int64_t i, float* out) {
  auto* b = static_cast<ingest::Batch*>(h);
  if (b->rc[(size_t)i] != 0) return b->rc[(size_t)i];
  memcpy(out, b->pcm[(size_t)i].data(),
         b->pcm[(size_t)i].size() * sizeof(float));
  return 0;
}

void hpfw_ingest_free(void* h) { delete static_cast<ingest::Batch*>(h); }

}  // extern "C"
