// MPEG-1 audio decoder (Layers I/II/III) — C++ twin of hpfw_jax/io/mp3.py.
//
// Mirrors the from-spec NumPy decoder operation for operation (same
// recovered tables via mpeg_tables.inc, same double-precision pipeline,
// same frame-loop semantics: ID3 skip, two-frame sync, truncated-final-
// frame drop, stop at mid-stream format changes) so the two paths are
// interchangeable; float64 accumulation-order differences are margin-
// tested rather than bit-asserted (tests/test_mp3.py, test_native.py).
// Reference parity: SURVEY.md §2.1 row 1 (native audio loader; the
// reference wraps a system decoder — mount empty, recollection).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "hpfw_internal.h"
#include "mpeg_tables.inc"

namespace {

constexpr double kPi = 3.14159265358979323846;

// ISO Table B.1: scalefactor idx 0..62 -> 2^(1 - idx/3); 63 forbidden -> 0.
struct ScfTable {
  double v[64];
  ScfTable() {
    for (int i = 0; i < 63; ++i) v[i] = std::pow(2.0, 1.0 - i / 3.0);
    v[63] = 0.0;
  }
};
const ScfTable kScf;

// Synthesis matrixing N[i][k] = cos((16+i)(2k+1)pi/64).
struct NMat {
  double v[64][32];
  NMat() {
    for (int i = 0; i < 64; ++i)
      for (int k = 0; k < 32; ++k)
        v[i][k] = std::cos((16 + i) * (2 * k + 1) * kPi / 64.0);
  }
};
const NMat kN;

struct BitR2 {
  const uint8_t* d;
  int64_t nbits;
  int64_t pos = 0;
  bool fail = false;
  BitR2(const uint8_t* data, int64_t nbytes, int64_t pos_bits = 0)
      : d(data), nbits(nbytes * 8), pos(pos_bits) {}
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      if (pos >= nbits) { fail = true; return 0; }
      v = (v << 1) | ((d[pos >> 3] >> (7 - (pos & 7))) & 1);
      ++pos;
    }
    return v;
  }
};

struct Header {
  int layer, bitrate_kbps, bitrate_idx, sample_rate, sr_idx;
  int padding, mode, mode_ext, protection, frame_bytes, channels;
  bool lsf, mpeg25;
};

const int kBitratesL1[15] = {0, 32, 64, 96, 128, 160, 192, 224, 256,
                             288, 320, 352, 384, 416, 448};
const int kBitratesL2[15] = {0, 32, 48, 56, 64, 80, 96, 112, 128,
                             160, 192, 224, 256, 320, 384};
const int kBitratesL3[15] = {0, 32, 40, 48, 56, 64, 80, 96, 112,
                             128, 160, 192, 224, 256, 320};
const int kBitratesL1Lsf[15] = {0, 32, 48, 56, 64, 80, 96, 112, 128,
                                144, 160, 176, 192, 224, 256};
const int kBitratesL23Lsf[15] = {0, 8, 16, 24, 32, 40, 48, 56, 64,
                                 80, 96, 112, 128, 144, 160};
const int kSampleRates[3] = {44100, 48000, 32000};
const int kSampleRatesV2[3] = {22050, 24000, 16000};
const int kSampleRatesV25[3] = {11025, 12000, 8000};

bool parse_header(uint32_t word, Header* h) {
  if (((word >> 21) & 0x7FF) != 0x7FF) return false;
  int version = (word >> 19) & 3;
  if (version == 1) return false;  // reserved
  h->lsf = version != 3;
  h->mpeg25 = version == 0;
  int layer_bits = (word >> 17) & 3;
  if (layer_bits == 0) return false;
  h->layer = (layer_bits == 3) ? 1 : (layer_bits == 2) ? 2 : 3;
  h->protection = (word >> 16) & 1;
  int br_idx = (word >> 12) & 0xF;
  if (br_idx == 15) return false;
  h->bitrate_idx = br_idx;  // 0 = free format: size measured at stream level
  if (h->lsf)
    h->bitrate_kbps = (h->layer == 1 ? kBitratesL1Lsf
                                     : kBitratesL23Lsf)[br_idx];
  else
    h->bitrate_kbps = (h->layer == 1 ? kBitratesL1
                       : h->layer == 2 ? kBitratesL2
                                       : kBitratesL3)[br_idx];
  h->sr_idx = (word >> 10) & 3;
  if (h->sr_idx == 3) return false;
  h->sample_rate = (h->mpeg25 ? kSampleRatesV25
                    : h->lsf ? kSampleRatesV2
                             : kSampleRates)[h->sr_idx];
  h->padding = (word >> 9) & 1;
  h->mode = (word >> 6) & 3;
  h->mode_ext = (word >> 4) & 3;
  h->channels = h->mode == 3 ? 1 : 2;
  int br = h->bitrate_kbps * 1000;
  if (br == 0)
    h->frame_bytes = 0;  // free format: filled by the stream loop
  else if (h->layer == 1)
    h->frame_bytes = (12 * br / h->sample_rate + h->padding) * 4;
  else if (h->layer == 3 && h->lsf)
    h->frame_bytes = 72 * br / h->sample_rate + h->padding;
  else
    h->frame_bytes = 144 * br / h->sample_rate + h->padding;
  return true;
}

// Free-format base frame size: distance to the next matching sync minus
// the first frame's padding slot (io/mp3.py _free_format_size twin).
int64_t free_format_size(const uint8_t* d, int64_t size, int64_t pos,
                         const Header& h) {
  int unit = h.layer == 1 ? 4 : 1;
  int64_t limit = size - 4 < pos + 5000 ? size - 4 : pos + 5000;
  for (int64_t i = pos + 16; i <= limit; ++i) {
    if (d[i] == 0xFF && (d[i + 1] & 0xE0) == 0xE0) {
      Header h2;
      uint32_t word = (uint32_t(d[i]) << 24) | (uint32_t(d[i + 1]) << 16) |
                      (uint32_t(d[i + 2]) << 8) | d[i + 3];
      if (!parse_header(word, &h2)) continue;
      if (h2.layer == h.layer && h2.sample_rate == h.sample_rate &&
          h2.channels == h.channels && h2.bitrate_idx == 0)
        return (i - pos) - int64_t(h.padding) * unit;
    }
  }
  return -1;
}

// (long 23-edge, short 14-edge) boundary tables for a frame header.
void sfb_tables(const Header& h, const int** sfb_l, const int** sfb_s) {
  if (h.lsf) {
    for (int i = 0; i < 6; ++i)
      if (kLsfRates[i] == h.sample_rate) {
        *sfb_l = kSfbLongLsf[i];
        *sfb_s = kSfbShortLsf[i];
        return;
      }
  }
  *sfb_l = kSfbLong[h.sr_idx];
  *sfb_s = kSfbShort[h.sr_idx];
}

// --- polyphase synthesis ---------------------------------------------------

struct SynthState {
  double V[16][64];  // row 0 = newest
  bool init = false;
};

// One subband-sample time: S[32] -> 32 PCM samples appended to out.
void synth_step(const double* S, SynthState* st, double* out) {
  if (!st->init) {
    std::memset(st->V, 0, sizeof(st->V));
    st->init = true;
  }
  // shift FIFO (newest at index 0)
  for (int r = 15; r > 0; --r)
    std::memcpy(st->V[r], st->V[r - 1], sizeof(double) * 64);
  for (int i = 0; i < 64; ++i) {
    double acc = 0.0;
    for (int k = 0; k < 32; ++k) acc += kN.v[i][k] * S[k];
    st->V[0][i] = acc;
  }
  for (int j = 0; j < 32; ++j) {
    double acc = 0.0;
    for (int q = 0; q < 8; ++q) {
      acc += kSynthWindow[64 * q + j] * st->V[2 * q][j];
      acc += kSynthWindow[64 * q + 32 + j] * st->V[2 * q + 1][32 + j];
    }
    out[j] = acc;
  }
}

// --- Layer I ---------------------------------------------------------------

double l1_requant(uint32_t code, int nb) {
  double f = code * std::pow(2.0, 1 - nb) - 1.0;
  double n = double(int64_t(1) << nb);
  return (f + std::pow(2.0, 1 - nb)) * (n / (n - 1.0));
}

// S: (12, 32, nch) flattened [s][sb][ch]
bool decode_layer1(const Header& h, BitR2* br, double* S) {
  int nch = h.channels;
  int bound = h.mode == 1 ? (h.mode_ext + 1) * 4 : 32;
  int alloc[32][2] = {};
  for (int sb = 0; sb < 32; ++sb) {
    if (h.mode == 1 && sb >= bound) {
      int a = br->read(4);
      alloc[sb][0] = alloc[sb][1] = a;
    } else {
      for (int ch = 0; ch < nch; ++ch) alloc[sb][ch] = br->read(4);
    }
  }
  int scf[32][2] = {};
  for (int sb = 0; sb < 32; ++sb)
    for (int ch = 0; ch < nch; ++ch)
      if (alloc[sb][ch]) scf[sb][ch] = br->read(6);
  for (int s = 0; s < 12; ++s)
    for (int sb = 0; sb < 32; ++sb) {
      if (h.mode == 1 && sb >= bound) {
        if (alloc[sb][0]) {
          int nb = alloc[sb][0] + 1;
          double v = l1_requant(br->read(nb), nb);
          for (int ch = 0; ch < nch; ++ch)
            S[(s * 32 + sb) * nch + ch] = v * kScf.v[scf[sb][ch]];
        }
      } else {
        for (int ch = 0; ch < nch; ++ch)
          if (alloc[sb][ch]) {
            int nb = alloc[sb][ch] + 1;
            double v = l1_requant(br->read(nb), nb);
            S[(s * 32 + sb) * nch + ch] = v * kScf.v[scf[sb][ch]];
          }
      }
    }
  return !br->fail;
}

// --- Layer II --------------------------------------------------------------

int qclass_index(int n) {
  for (int i = 0; i < kQClassN; ++i)
    if (kQClassLevels[i] == n) return i;
  return -1;
}

// scfsi value -> (count, part map), mirroring io/_mp3_layer2.SCFSI_MAP
const int kScfsiCount[4] = {3, 2, 1, 2};
const int kScfsiPart[4][3] = {{0, 1, 2}, {0, 0, 1}, {0, 0, 0}, {0, 1, 1}};

// S: (36, 32, nch)
bool decode_layer2(const Header& h, BitR2* br, double* S) {
  int nch = h.channels;
  int ti = h.lsf ? kL2NumTables - 1  // the single ISO 13818-3 B.1 table
                 : kL2Translate[h.sr_idx][nch == 1 ? 1 : 0][h.bitrate_idx];
  int t0 = kL2TableOff[ti];
  int sblimit = kL2TableOff[ti + 1] - t0;
  int bound = h.mode == 1 ? (h.mode_ext + 1) * 4 : sblimit;
  if (bound > sblimit) bound = sblimit;

  int alloc[32][2] = {};
  for (int sb = 0; sb < sblimit; ++sb) {
    int nbal = kL2Nbal[t0 + sb];
    if (sb < bound) {
      for (int ch = 0; ch < nch; ++ch) alloc[sb][ch] = br->read(nbal);
    } else {
      int a = br->read(nbal);
      alloc[sb][0] = alloc[sb][1] = a;
    }
  }
  int scfsi[32][2] = {};
  for (int sb = 0; sb < sblimit; ++sb)
    for (int ch = 0; ch < nch; ++ch)
      if (alloc[sb][ch]) scfsi[sb][ch] = br->read(2);
  double scf[32][2][3] = {};
  for (int sb = 0; sb < sblimit; ++sb)
    for (int ch = 0; ch < nch; ++ch)
      if (alloc[sb][ch]) {
        int si = scfsi[sb][ch];
        int got[3] = {};
        for (int i = 0; i < kScfsiCount[si]; ++i) got[i] = br->read(6);
        for (int part = 0; part < 3; ++part)
          scf[sb][ch][part] = kScf.v[got[kScfsiPart[si][part]]];
      }
  for (int gr = 0; gr < 12; ++gr) {
    int part = gr >> 2;
    for (int sb = 0; sb < sblimit; ++sb) {
      bool shared = sb >= bound;
      for (int ch = 0; ch < (shared ? 1 : nch); ++ch) {
        int a = alloc[sb][ch];
        if (!a) continue;
        int n = kL2Classes[kL2ClassOff[t0 + sb] + a - 1];
        int qi = qclass_index(n);
        int bits = kQClassBits[qi];
        uint32_t vals[3];
        if (kQClassGrouped[qi]) {
          uint32_t c = br->read(bits);
          vals[0] = c % n;
          vals[1] = (c / n) % n;
          vals[2] = c / (n * n);
        } else {
          for (int i = 0; i < 3; ++i) vals[i] = br->read(bits);
        }
        for (int tch = 0; tch < (shared ? nch : 1); ++tch) {
          int och = shared ? tch : ch;
          for (int i = 0; i < 3; ++i) {
            double r = (2.0 * vals[i] + 1.0 - n) / n;
            S[((3 * gr + i) * 32 + sb) * nch + och] =
                r * scf[sb][och][part];
          }
        }
      }
    }
  }
  return !br->fail;
}

// --- Layer III -------------------------------------------------------------

struct HuffTree {
  // node: [left, right]; >= 0 -> child node, < 0 -> ~entry_index
  std::vector<int> lr;
  void insert(int len, uint32_t code, int entry) {
    if (lr.empty()) lr.assign(2, INT32_MIN);
    int node = 0;
    for (int b = len - 1; b >= 0; --b) {
      int bit = (code >> b) & 1;
      size_t idx = 2 * size_t(node) + bit;
      if (b == 0) {
        lr[idx] = ~entry;
      } else {
        if (lr[idx] == INT32_MIN) {
          int child = int(lr.size() / 2);
          lr[idx] = child;
          lr.push_back(INT32_MIN);
          lr.push_back(INT32_MIN);
        }
        node = lr[idx];
      }
    }
  }
  int decode(BitR2* br) const {  // returns entry index or -1
    int node = 0;
    for (;;) {
      int bit = br->read(1);
      if (br->fail) return -1;
      int slot = lr[2 * node + bit];
      if (slot == INT32_MIN) return -1;
      if (slot < 0) return ~slot;
      node = slot;
    }
  }
};

struct HuffSet {
  HuffTree bv[32];
  HuffTree c1[2];
  HuffSet() {
    for (int t = 0; t < 32; ++t)
      for (int e = kHuffOff[t]; e < kHuffOff[t + 1]; ++e)
        bv[t].insert(kHuffEntries[e][0], kHuffEntries[e][1], e);
    for (int t = 0; t < 2; ++t)
      for (int e = kC1Off[t]; e < kC1Off[t + 1]; ++e)
        c1[t].insert(kC1Entries[e][0], kC1Entries[e][1], e);
  }
};
const HuffSet kHuff;

// IMDCT bases and windows (io/_mp3_layer3.py exact formulas).
struct L3Const {
  double imdct36[36][18], imdct12[12][6];
  double win[4][36], win_s[12];
  double cs[8], ca[8];
  L3Const() {
    for (int i = 0; i < 36; ++i)
      for (int j = 0; j < 18; ++j)
        imdct36[i][j] = std::cos(kPi / 72.0 * (2 * i + 19) * (2 * j + 1));
    for (int i = 0; i < 12; ++i)
      for (int j = 0; j < 6; ++j)
        imdct12[i][j] = std::cos(kPi / 24.0 * (2 * i + 7) * (2 * j + 1));
    for (int i = 0; i < 36; ++i) win[0][i] = std::sin(kPi / 36.0 * (i + 0.5));
    for (int i = 0; i < 36; ++i) win[1][i] = win[0][i];
    for (int i = 18; i < 24; ++i) win[1][i] = 1.0;
    for (int i = 24; i < 30; ++i)
      win[1][i] = std::sin(kPi / 12.0 * (i - 18 + 0.5));
    for (int i = 30; i < 36; ++i) win[1][i] = 0.0;
    for (int i = 0; i < 36; ++i) win[2][i] = 0.0;  // block_type 2: unused
    for (int i = 0; i < 36; ++i) win[3][i] = win[0][i];
    for (int i = 0; i < 6; ++i) win[3][i] = 0.0;
    for (int i = 6; i < 12; ++i)
      win[3][i] = std::sin(kPi / 12.0 * (i - 6 + 0.5));
    for (int i = 12; i < 18; ++i) win[3][i] = 1.0;
    for (int i = 0; i < 12; ++i) win_s[i] = std::sin(kPi / 12.0 * (i + 0.5));
    const double ci[8] = {-0.6, -0.535, -0.33, -0.185,
                          -0.095, -0.041, -0.0142, -0.0037};
    for (int j = 0; j < 8; ++j) {
      cs[j] = 1.0 / std::sqrt(1.0 + ci[j] * ci[j]);
      ca[j] = ci[j] / std::sqrt(1.0 + ci[j] * ci[j]);
    }
  }
};
const L3Const kL3;

struct Granule {
  int part2_3_length, big_values, global_gain, scalefac_compress;
  int window_switching, block_type, mixed_block;
  int table_select[3], subblock_gain[3];
  int region0_count, region1_count;
  int preflag, scalefac_scale, count1table_select;
};

struct L3State {
  static const int kMaxReservoir = 2048;
  std::vector<uint8_t> reservoir;
  double overlap[2][32][18] = {};
};

void read_side_info(const Header& h, BitR2* br, int* main_data_begin,
                    int scfsi[2][4], Granule gr[2][2]) {
  int nch = h.channels;
  int n_gr = h.lsf ? 1 : 2;
  *main_data_begin = br->read(h.lsf ? 8 : 9);
  br->read(nch == 1 ? (h.lsf ? 1 : 5) : (h.lsf ? 2 : 3));
  for (int ch = 0; ch < nch; ++ch)
    for (int i = 0; i < 4; ++i)
      scfsi[ch][i] = h.lsf ? 0 : int(br->read(1));
  for (int g = 0; g < n_gr; ++g)
    for (int ch = 0; ch < nch; ++ch) {
      Granule& gi = gr[g][ch];
      gi.part2_3_length = br->read(12);
      gi.big_values = br->read(9);
      gi.global_gain = br->read(8);
      gi.scalefac_compress = br->read(h.lsf ? 9 : 4);
      gi.window_switching = br->read(1);
      if (gi.window_switching) {
        gi.block_type = br->read(2);
        gi.mixed_block = br->read(1);
        gi.table_select[0] = br->read(5);
        gi.table_select[1] = br->read(5);
        gi.table_select[2] = 0;
        for (int w = 0; w < 3; ++w) gi.subblock_gain[w] = br->read(3);
        gi.region0_count = 7;
        gi.region1_count = 36;
      } else {
        gi.block_type = 0;
        gi.mixed_block = 0;
        for (int r = 0; r < 3; ++r) gi.table_select[r] = br->read(5);
        for (int w = 0; w < 3; ++w) gi.subblock_gain[w] = 0;
        gi.region0_count = br->read(4);
        gi.region1_count = br->read(3);
      }
      gi.preflag = h.lsf ? 0 : int(br->read(1));
      gi.scalefac_scale = br->read(1);
      gi.count1table_select = br->read(1);
    }
}

// LSF decomposition of the 9-bit scalefac_compress (ISO 13818-3
// 2.4.3.2); mirrors io/_mp3_layer3.py _lsf_slen.
void lsf_slen(const Granule& g, bool is_ch, int slen[4], int* bn,
              int* preflag, int* int_scale) {
  int sc = g.scalefac_compress;
  *preflag = 0;
  *int_scale = 0;
  if (is_ch) {
    *int_scale = sc & 1;
    sc >>= 1;
    if (sc < 180) {
      slen[0] = sc / 36; slen[1] = (sc % 36) / 6; slen[2] = sc % 6;
      slen[3] = 0;
      *bn = 3;
    } else if (sc < 244) {
      sc -= 180;
      slen[0] = (sc & 63) >> 4; slen[1] = (sc & 15) >> 2; slen[2] = sc & 3;
      slen[3] = 0;
      *bn = 4;
    } else {
      sc -= 244;
      slen[0] = sc / 3; slen[1] = sc % 3; slen[2] = 0; slen[3] = 0;
      *bn = 5;
    }
  } else {
    if (sc < 400) {
      slen[0] = (sc >> 4) / 5; slen[1] = (sc >> 4) % 5;
      slen[2] = (sc & 15) >> 2; slen[3] = sc & 3;
      *bn = 0;
    } else if (sc < 500) {
      sc -= 400;
      slen[0] = (sc >> 2) / 5; slen[1] = (sc >> 2) % 5; slen[2] = sc & 3;
      slen[3] = 0;
      *bn = 1;
    } else {
      sc -= 500;
      slen[0] = sc / 3; slen[1] = sc % 3; slen[2] = 0; slen[3] = 0;
      *bn = 2;
      *preflag = 1;
    }
  }
}

// LSF scalefactor reading; max_* carry each slot's (2^slen - 1) marker
// (the LSF illegal intensity position). Sets g's preflag via *preflag.
void read_scalefactors_lsf(BitR2* br, Granule* g, bool is_ch,
                           int* scf_l, int* scf_s, int* max_l,
                           int* max_s) {
  int slen[4], bn, preflag, int_scale;
  lsf_slen(*g, is_ch, slen, &bn, &preflag, &int_scale);
  g->preflag = preflag;
  bool is_short = g->window_switching && g->block_type == 2;
  int cls = (is_short && g->mixed_block) ? 2 : (is_short ? 1 : 0);
  const int* counts = kNrOfSfb[bn][cls];
  int vals[40], maxes[40], nv = 0;
  for (int i = 0; i < 4; ++i)
    for (int k = 0; k < counts[i]; ++k) {
      vals[nv] = br->read(slen[i]);
      maxes[nv] = (1 << slen[i]) - 1;
      ++nv;
    }
  std::memset(scf_l, 0, sizeof(int) * 22);
  std::memset(scf_s, 0, sizeof(int) * 13 * 3);
  std::memset(max_l, 0, sizeof(int) * 22);
  std::memset(max_s, 0, sizeof(int) * 13 * 3);
  if (cls == 0) {
    for (int i = 0; i < 21; ++i) { scf_l[i] = vals[i]; max_l[i] = maxes[i]; }
  } else if (cls == 1) {
    for (int i = 0; i < 36; ++i) { scf_s[i] = vals[i]; max_s[i] = maxes[i]; }
  } else {
    for (int i = 0; i < 6; ++i) { scf_l[i] = vals[i]; max_l[i] = maxes[i]; }
    for (int i = 0; i < 27; ++i) {
      scf_s[9 + i] = vals[6 + i];
      max_s[9 + i] = maxes[6 + i];
    }
  }
}

void read_scalefactors(BitR2* br, const Granule& g,
                       const int* scfsi_ch, const int* prev_l,
                       int* scf_l, int* scf_s /* [13*3] */) {
  int slen1 = kSlen[g.scalefac_compress][0];
  int slen2 = kSlen[g.scalefac_compress][1];
  std::memset(scf_l, 0, sizeof(int) * 22);
  std::memset(scf_s, 0, sizeof(int) * 13 * 3);
  if (g.window_switching && g.block_type == 2) {
    if (g.mixed_block) {
      for (int sfb = 0; sfb < 8; ++sfb) scf_l[sfb] = br->read(slen1);
      for (int sfb = 3; sfb < 12; ++sfb) {
        int slen = sfb < 6 ? slen1 : slen2;
        for (int w = 0; w < 3; ++w) scf_s[sfb * 3 + w] = br->read(slen);
      }
    } else {
      for (int sfb = 0; sfb < 12; ++sfb) {
        int slen = sfb < 6 ? slen1 : slen2;
        for (int w = 0; w < 3; ++w) scf_s[sfb * 3 + w] = br->read(slen);
      }
    }
  } else {
    const int groups[4][2] = {{0, 6}, {6, 11}, {11, 16}, {16, 21}};
    for (int gi = 0; gi < 4; ++gi) {
      if (prev_l != nullptr && scfsi_ch[gi]) {
        for (int sfb = groups[gi][0]; sfb < groups[gi][1]; ++sfb)
          scf_l[sfb] = prev_l[sfb];
      } else {
        int slen = gi < 2 ? slen1 : slen2;
        for (int sfb = groups[gi][0]; sfb < groups[gi][1]; ++sfb)
          scf_l[sfb] = br->read(slen);
      }
    }
  }
}

void decode_huffman(BitR2* br, const Granule& g, const Header& h,
                    const int* sfb_l, int64_t end_bit,
                    double* xs /* 576 */) {
  std::memset(xs, 0, sizeof(double) * 576);
  int r0_end, r1_end;
  if (g.window_switching) {
    // Implied regions (probe-pinned vs the reference decoder): MPEG-1
    // 36 lines; LSF 36 (short) / 54 (start/stop); 2.5 from the band
    // table (sfb 6 pure short, sfb 8 otherwise).
    if (h.mpeg25)
      r0_end = sfb_l[(g.block_type == 2 && !g.mixed_block) ? 6 : 8];
    else if (h.lsf && g.block_type != 2)
      r0_end = 54;
    else
      r0_end = 36;
    r1_end = 576;
  } else {
    int a = g.region0_count + 1;
    int b = a + g.region1_count + 1;
    r0_end = sfb_l[a < 22 ? a : 22];
    r1_end = sfb_l[b < 22 ? b : 22];
  }
  int bv_end = 2 * g.big_values;
  if (bv_end > 576) bv_end = 576;  // malformed big_values: clamp
  int i = 0;
  while (i < bv_end) {
    int tsel = i < r0_end ? g.table_select[0]
               : i < r1_end ? g.table_select[1]
                            : g.table_select[2];
    int linbits = kHuffLinbits[tsel];
    if (kHuffOff[tsel] == kHuffOff[tsel + 1]) {
      i += 2;
      continue;
    }
    int e = kHuff.bv[tsel].decode(br);
    if (e < 0) break;
    int x = kHuffEntries[e][2], y = kHuffEntries[e][3];
    if (x == 15 && linbits) x += br->read(linbits);
    if (x && br->read(1)) x = -x;
    if (y == 15 && linbits) y += br->read(linbits);
    if (y && br->read(1)) y = -y;
    xs[i] = x;
    if (i + 1 < 576) xs[i + 1] = y;
    i += 2;
    if (br->pos > end_bit) {
      xs[i - 2] = 0.0;
      if (i - 1 < 576) xs[i - 1] = 0.0;
      break;
    }
  }
  const HuffTree& ct = kHuff.c1[g.count1table_select];
  while (br->pos < end_bit && i + 3 < 576) {
    int64_t mark = br->pos;
    int e = ct.decode(br);
    if (e < 0) { br->pos = mark; break; }
    int mask = kC1Entries[e][2];
    double vals[4];
    for (int j = 0; j < 4; ++j) {
      int v = (mask >> j) & 1;
      if (v && br->read(1)) v = -v;
      vals[j] = v;
    }
    if (br->pos > end_bit) {
      br->pos = mark;
      break;
    }
    for (int j = 0; j < 4; ++j) xs[i + j] = vals[j];
    i += 4;
  }
}

void requantize(const double* xs, const Granule& g, const int* sfb_l,
                const int* sfb_s, const int* scf_l, const int* scf_s,
                double* xr) {
  std::memset(xr, 0, sizeof(double) * 576);
  double mag[576];
  for (int i = 0; i < 576; ++i) {
    double a = std::fabs(xs[i]);
    mag[i] = std::pow(a, 4.0 / 3.0) * (xs[i] < 0 ? -1.0 : xs[i] > 0 ? 1.0
                                                                    : 0.0);
  }
  double step = 0.5 * (1 + g.scalefac_scale);
  bool is_short = g.window_switching && g.block_type == 2;
  // mixed long part ends where short sfb 3 starts (72 at 8 kHz LSF)
  int long_end = (is_short && g.mixed_block) ? 3 * sfb_s[3]
                                             : (is_short ? 0 : 576);
  if (long_end) {
    double gain = std::pow(2.0, (g.global_gain - 210) / 4.0);
    for (int sfb = 0; sfb < 22; ++sfb) {
      double e = -step * (scf_l[sfb] + (g.preflag ? kPretab[sfb] : 0));
      double scale = gain * std::pow(2.0, e);
      int hi = sfb_l[sfb + 1] < long_end ? sfb_l[sfb + 1] : long_end;
      for (int i = sfb_l[sfb]; i < hi; ++i) xr[i] = mag[i] * scale;
      if (sfb_l[sfb + 1] >= long_end) break;
    }
  }
  if (is_short) {
    int start_sfb = g.mixed_block ? 3 : 0;
    int pos = long_end;
    for (int sfb = start_sfb; sfb < 13; ++sfb) {
      int width = sfb_s[sfb + 1] - sfb_s[sfb];
      for (int w = 0; w < 3; ++w) {
        double gain = std::pow(
            2.0, (g.global_gain - 210 - 8 * g.subblock_gain[w]) / 4.0);
        int s = sfb < 12 ? scf_s[sfb * 3 + w] : 0;
        double scale = gain * std::pow(2.0, -step * s);
        for (int l = 0; l < width; ++l)
          xr[3 * sfb_s[sfb] + 3 * l + w] = mag[pos + l] * scale;
        pos += width;
      }
    }
  }
}

// Intensity-stereo factors (io/_mp3_layer3.py _IS_LEFT/_IS_RIGHT).
// 16 entries: positions 8..15 are out-of-spec but encodable when
// slen > 3; the reference decoder applies its table's raw tan-law
// extension there, mirrored here (poles at 6 and 12 pinned exactly).
struct IsTab {
  double l[16], r[16];
  IsTab() {
    for (int i = 0; i < 16; ++i) {
      double t = std::tan(i * kPi / 12.0);
      l[i] = t / (1.0 + t);
      r[i] = 1.0 / (1.0 + t);
    }
    l[6] = 1.0;
    r[6] = 0.0;
    l[12] = 0.0;
    r[12] = 1.0;
  }
};
const IsTab kIs;

struct Band {
  int w, lo, hi, sfb;  // w < 0 marks long bands
};

int band_seq(const Granule& g, const int* sfb_l, const int* sfb_s,
             Band* bands /* cap 64 */) {
  bool is_short = g.window_switching && g.block_type == 2;
  int n = 0;
  if (!is_short || g.mixed_block) {
    int long_end = is_short ? 3 * sfb_s[3] : 576;
    for (int sfb = 0; sfb < 22 && sfb_l[sfb] < long_end; ++sfb)
      bands[n++] = {-1, sfb_l[sfb], sfb_l[sfb + 1], sfb};
  }
  if (is_short) {
    int start = g.mixed_block ? 3 : 0;
    for (int sfb = start; sfb < 13; ++sfb)
      for (int w = 0; w < 3; ++w)
        bands[n++] = {w, 3 * sfb_s[sfb], 3 * sfb_s[sfb + 1], sfb};
  }
  return n;
}

// LSF intensity factors (ISO 13818-3 2.4.3.4; probe-pinned): p = 0 copies
// to both; odd p scales left by io^((p+1)/2); even p scales right by
// io^(p/2); io = 2^-1/4 (intensity_scale 0) or 2^-1/2 (1).
void lsf_is_factors(int is_pos, int int_scale, double* kl, double* kr) {
  if (is_pos == 0) {
    *kl = 1.0;
    *kr = 1.0;
    return;
  }
  double io = std::pow(2.0, -0.25 * (1 + int_scale));
  double k = std::pow(io, (is_pos + 1) / 2);
  if (is_pos % 2) {
    *kl = k;
    *kr = 1.0;
  } else {
    *kl = 1.0;
    *kr = k;
  }
}

void stereo_process(const Header& h, const Granule& g_r,
                    const int* sfb_l, const int* sfb_s,
                    const int* scf_l_r, const int* scf_s_r,
                    const int* max_l_r, const int* max_s_r,
                    double* xr0, double* xr1) {
  if (h.mode != 1 || h.mode_ext == 0) return;
  bool ms = (h.mode_ext & 2) != 0;
  bool intensity = (h.mode_ext & 1) != 0;
  const double inv = 1.0 / std::sqrt(2.0);
  if (!intensity) {
    if (ms)
      for (int i = 0; i < 576; ++i) {
        double m = xr0[i], s = xr1[i];
        xr0[i] = (m + s) * inv;
        xr1[i] = (m - s) * inv;
      }
    return;
  }
  int int_scale = 0;
  if (h.lsf) {
    int slen[4], bn, pre;
    lsf_slen(g_r, true, slen, &bn, &pre, &int_scale);
  }
  Band bands[64];
  int nb = band_seq(g_r, sfb_l, sfb_s, bands);
  int last_nz[4] = {-1, -1, -1, -1};  // index 0 = long (-1), 1..3 = w 0..2
  for (int bi = 0; bi < nb; ++bi) {
    const Band& b = bands[bi];
    bool nz = false;
    if (b.w < 0) {
      for (int i = b.lo; i < b.hi; ++i)
        if (xr1[i] != 0.0) { nz = true; break; }
    } else {
      for (int i = b.lo + b.w; i < b.hi; i += 3)
        if (xr1[i] != 0.0) { nz = true; break; }
    }
    if (nz) last_nz[b.w + 1] = bi;
  }
  bool is_short = g_r.window_switching && g_r.block_type == 2;
  if (is_short && g_r.mixed_block &&
      (last_nz[1] >= 0 || last_nz[2] >= 0 || last_nz[3] >= 0)) {
    for (int bi = 0; bi < nb; ++bi)
      if (bands[bi].w < 0) last_nz[0] = bi;
  }
  for (int bi = 0; bi < nb; ++bi) {
    const Band& b = bands[bi];
    bool below = bi <= last_nz[b.w + 1];
    int is_pos = 7, illegal = 7;
    if (!below) {
      if (b.w < 0) {
        int i = b.sfb < 20 ? b.sfb : 20;
        is_pos = scf_l_r[i];
        illegal = h.lsf ? max_l_r[i] : 7;
      } else {
        int i = (b.sfb < 11 ? b.sfb : 11) * 3 + b.w;
        is_pos = scf_s_r[i];
        illegal = h.lsf ? max_s_r[i] : 7;
      }
    }
    bool do_is = !below && is_pos != illegal;
    if (do_is) {
      double kl, kr;
      if (h.lsf) {
        lsf_is_factors(is_pos, int_scale, &kl, &kr);
      } else {
        kl = kIs.l[is_pos];
        kr = kIs.r[is_pos];
      }
      if (b.w < 0) {
        for (int i = b.lo; i < b.hi; ++i) {
          double m = xr0[i];
          xr0[i] = m * kl;
          xr1[i] = m * kr;
        }
      } else {
        for (int i = b.lo + b.w; i < b.hi; i += 3) {
          double m = xr0[i];
          xr0[i] = m * kl;
          xr1[i] = m * kr;
        }
      }
    } else if (ms) {
      if (b.w < 0) {
        for (int i = b.lo; i < b.hi; ++i) {
          double m = xr0[i], s = xr1[i];
          xr0[i] = (m + s) * inv;
          xr1[i] = (m - s) * inv;
        }
      } else {
        for (int i = b.lo + b.w; i < b.hi; i += 3) {
          double m = xr0[i], s = xr1[i];
          xr0[i] = (m + s) * inv;
          xr1[i] = (m - s) * inv;
        }
      }
    }
  }
}

void alias_reduce(double* xr, int n_boundaries) {
  for (int sb = 0; sb < n_boundaries; ++sb) {
    int lo = 18 * sb;
    for (int j = 0; j < 8; ++j) {
      double a = xr[lo + 17 - j];
      double b = xr[lo + 18 + j];
      xr[lo + 17 - j] = a * kL3.cs[j] - b * kL3.ca[j];
      xr[lo + 18 + j] = b * kL3.cs[j] + a * kL3.ca[j];
    }
  }
}

// xr (576,) -> out (18, 32) [t][sb]; updates overlap[32][18] in place.
// n_long_sb: subbands of the mixed long part (2 except 8 kHz LSF's 4).
void imdct_granule(const double* xr, const Granule& g,
                   double overlap[32][18], double out[18][32],
                   int n_long_sb) {
  bool is_short = g.window_switching && g.block_type == 2;
  for (int sb = 0; sb < 32; ++sb) {
    const double* X = xr + 18 * sb;
    double raw[36] = {};
    bool sb_short = is_short && !(g.mixed_block && sb < n_long_sb);
    if (sb_short) {
      for (int w = 0; w < 3; ++w) {
        for (int i = 0; i < 12; ++i) {
          double acc = 0.0;
          for (int j = 0; j < 6; ++j)
            acc += kL3.imdct12[i][j] * X[3 * j + w];
          raw[6 + 6 * w + i] += acc * kL3.win_s[i];
        }
      }
    } else {
      int bt = is_short ? 0 : g.block_type;
      for (int i = 0; i < 36; ++i) {
        double acc = 0.0;
        for (int j = 0; j < 18; ++j) acc += kL3.imdct36[i][j] * X[j];
        raw[i] = acc * kL3.win[bt][i];
      }
    }
    for (int t = 0; t < 18; ++t) out[t][sb] = raw[t] + overlap[sb][t];
    for (int t = 0; t < 18; ++t) overlap[sb][t] = raw[18 + t];
  }
  for (int t = 1; t < 18; t += 2)
    for (int sb = 1; sb < 32; sb += 2) out[t][sb] = -out[t][sb];
}

// S: (36, 32, nch). Returns false only on unrecoverable reader failure.
bool decode_layer3(const Header& h, const uint8_t* frame, L3State* st,
                   double* S) {
  int nch = h.channels;
  int n_gr = h.lsf ? 1 : 2;
  BitR2 br(frame, h.frame_bytes, (32 + (h.protection == 0 ? 16 : 0)));
  int main_data_begin;
  int scfsi[2][4];
  Granule gr[2][2];
  read_side_info(h, &br, &main_data_begin, scfsi, gr);
  if (br.fail) return false;
  int side_bytes = h.lsf ? (nch == 1 ? 9 : 17) : (nch == 1 ? 17 : 32);
  int head = 4 + (h.protection == 0 ? 2 : 0) + side_bytes;
  size_t res_before = st->reservoir.size();
  st->reservoir.insert(st->reservoir.end(), frame + head,
                       frame + h.frame_bytes);
  int64_t start_byte = int64_t(res_before) - main_data_begin;
  auto trim = [st]() {
    if (st->reservoir.size() > size_t(L3State::kMaxReservoir))
      st->reservoir.erase(
          st->reservoir.begin(),
          st->reservoir.begin() +
              (st->reservoir.size() - L3State::kMaxReservoir));
  };
  std::memset(S, 0, sizeof(double) * size_t(18 * n_gr) * 32 * nch);
  if (start_byte < 0) {
    trim();
    return true;  // undecodable granules at stream start: silence
  }
  BitR2 mbr(st->reservoir.data(), st->reservoir.size(), start_byte * 8);
  const int* sfb_l;
  const int* sfb_s;
  sfb_tables(h, &sfb_l, &sfb_s);
  int n_long_sb = (3 * sfb_s[3]) / 18;
  int prev_scf_l[2][22];
  for (int g = 0; g < n_gr; ++g) {
    double xr[2][576];
    int cur_l[2][22], cur_s[2][13 * 3];
    int max_l[2][22], max_s[2][13 * 3];
    for (int ch = 0; ch < nch; ++ch) {
      Granule& gi = gr[g][ch];
      int64_t end_bit = mbr.pos + gi.part2_3_length;
      if (h.lsf) {
        bool is_ch = ch == 1 && h.mode == 1 && (h.mode_ext & 1);
        read_scalefactors_lsf(&mbr, &gi, is_ch, cur_l[ch], cur_s[ch],
                              max_l[ch], max_s[ch]);
      } else {
        read_scalefactors(&mbr, gi, scfsi[ch],
                          g == 1 ? prev_scf_l[ch] : nullptr,
                          cur_l[ch], cur_s[ch]);
      }
      if (g == 0)
        std::memcpy(prev_scf_l[ch], cur_l[ch], sizeof(int) * 22);
      double xs[576];
      decode_huffman(&mbr, gi, h, sfb_l, end_bit, xs);
      mbr.pos = end_bit;
      requantize(xs, gi, sfb_l, sfb_s, cur_l[ch], cur_s[ch], xr[ch]);
    }
    if (nch == 2)
      stereo_process(h, gr[g][1], sfb_l, sfb_s, cur_l[1], cur_s[1],
                     max_l[1], max_s[1], xr[0], xr[1]);
    for (int ch = 0; ch < nch; ++ch) {
      const Granule& gi = gr[g][ch];
      bool is_short = gi.window_switching && gi.block_type == 2;
      int nbd = (is_short && gi.mixed_block) ? n_long_sb - 1
                                             : (is_short ? 0 : 31);
      alias_reduce(xr[ch], nbd);
      double out[18][32];
      imdct_granule(xr[ch], gi, st->overlap[ch], out, n_long_sb);
      for (int t = 0; t < 18; ++t)
        for (int sb = 0; sb < 32; ++sb)
          S[((18 * g + t) * 32 + sb) * nch + ch] = out[t][sb];
    }
  }
  trim();
  return true;
}

// --- stream loop -----------------------------------------------------------

int64_t skip_id3(const uint8_t* d, int64_t size) {
  if (size >= 10 && d[0] == 'I' && d[1] == 'D' && d[2] == '3') {
    int64_t sz = ((d[6] & 0x7F) << 21) | ((d[7] & 0x7F) << 14) |
                 ((d[8] & 0x7F) << 7) | (d[9] & 0x7F);
    return 10 + sz;
  }
  return 0;
}

int64_t find_sync(const uint8_t* d, int64_t size, int64_t start) {
  for (int64_t i = start; i + 4 <= size; ++i) {
    if (d[i] == 0xFF && (d[i + 1] & 0xE0) == 0xE0) {
      Header h;
      uint32_t word = (uint32_t(d[i]) << 24) | (uint32_t(d[i + 1]) << 16) |
                      (uint32_t(d[i + 2]) << 8) | d[i + 3];
      if (parse_header(word, &h)) return i;
    }
  }
  return -1;
}

}  // namespace

// One-pass decode into a growable buffer (hpfw_internal.h) — the primary
// implementation; the extern-C two-call entry wraps it, and the threaded
// ingest driver calls it directly so batch decode happens exactly once.
int hpfw_mp3_decode_vec(const uint8_t* data, int64_t size,
                        std::vector<float>* out, int32_t* sample_rate) {
  int64_t pos = skip_id3(data, size);
  std::vector<double> pcm;  // mono mean
  int sr = 0, nch = 0;
  SynthState synth[2];
  L3State* l3 = nullptr;
  std::vector<double> S;
  int64_t free_size = -2;  // free-format base size, measured once
  while (true) {
    pos = find_sync(data, size, pos);
    if (pos < 0) break;
    Header h;
    uint32_t word = (uint32_t(data[pos]) << 24) |
                    (uint32_t(data[pos + 1]) << 16) |
                    (uint32_t(data[pos + 2]) << 8) | data[pos + 3];
    parse_header(word, &h);
    if (h.bitrate_idx == 0) {  // free format
      if (free_size == -2) {
        int64_t measured = free_format_size(data, size, pos, h);
        if (measured <= 0) {
          // spurious sync in junk / lone trailing frame: resync past it
          ++pos;
          continue;
        }
        free_size = measured;
      }
      h.frame_bytes = int(free_size + int64_t(h.padding) *
                                          (h.layer == 1 ? 4 : 1));
    }
    if (h.frame_bytes <= 0 || pos + h.frame_bytes > size)
      break;  // truncated final frame
    if (sr == 0) {
      sr = h.sample_rate;
      nch = h.channels;
    } else if (h.sample_rate != sr || h.channels != nch) {
      break;  // format change mid-stream
    }
    const uint8_t* frame = data + pos;
    // samples per frame / 32: Layer I 12; Layers II/III 36, except LSF
    // Layer III's single 576-sample granule (18)
    int T = h.layer == 1 ? 12 : (h.layer == 3 && h.lsf) ? 18 : 36;
    S.assign(size_t(T) * 32 * nch, 0.0);
    bool ok;
    if (h.layer == 1) {
      BitR2 br(frame, h.frame_bytes, 32 + (h.protection == 0 ? 16 : 0));
      ok = decode_layer1(h, &br, S.data());
    } else if (h.layer == 2) {
      BitR2 br(frame, h.frame_bytes, 32 + (h.protection == 0 ? 16 : 0));
      ok = decode_layer2(h, &br, S.data());
    } else {
      if (l3 == nullptr) l3 = new L3State();
      ok = decode_layer3(h, frame, l3, S.data());
    }
    if (ok) {
      size_t base = pcm.size();
      pcm.resize(base + size_t(T) * 32, 0.0);
      double step_in[32], step_out[32];
      for (int ch = 0; ch < nch; ++ch) {
        for (int t = 0; t < T; ++t) {
          for (int sb = 0; sb < 32; ++sb)
            step_in[sb] = S[(size_t(t) * 32 + sb) * nch + ch];
          synth_step(step_in, &synth[ch], step_out);
          for (int j = 0; j < 32; ++j)
            pcm[base + size_t(t) * 32 + j] += step_out[j] / nch;
        }
      }
    }
    pos += h.frame_bytes;
  }
  delete l3;
  if (sr == 0 || pcm.empty()) return -1;
  *sample_rate = sr;
  out->resize(pcm.size());
  for (size_t i = 0; i < pcm.size(); ++i) (*out)[i] = float(pcm[i]);
  return 0;
}

extern "C" {

// MPEG audio bytes -> mono float32 PCM (channel mean, like the NumPy
// twin's _decode_mpeg_bytes). Two-call protocol: out == nullptr queries
// the length. Returns 0 on success, -1 when no decodable frames exist.
int hpfw_mp3_decode(const uint8_t* data, int64_t size, float* out,
                    int64_t* n_samples, int32_t* sample_rate) {
  std::vector<float> v;
  int rc = hpfw_mp3_decode_vec(data, size, &v, sample_rate);
  if (rc) return rc;
  *n_samples = (int64_t)v.size();
  if (out) memcpy(out, v.data(), v.size() * sizeof(float));
  return 0;
}

}  // extern "C"
