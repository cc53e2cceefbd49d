// ADTS AAC-LC decoder — C++ twin of hpfw_jax/io/aac.py.
//
// Mirrors the from-spec NumPy decoder operation for operation (same
// probe-recovered tables via the GENERATED aac_tables.inc, same
// double-precision pipeline, same frame-walk semantics: 3-frame chained
// sync, truncated-final-frame drop, LC-only profile check, mono
// downmix by channel mean) so the two paths are interchangeable;
// float64 accumulation-order differences are margin-tested rather than
// bit-asserted (tests/test_native.py), the same convention as the MPEG
// twin. Reference parity: SURVEY.md §2.1 row 1 (native audio loader).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

#include "hpfw_internal.h"
#include "aac_tables.inc"

namespace aac {

constexpr double kPi = 3.14159265358979323846;

struct BitR {
  const uint8_t* d;
  int64_t nbits;
  int64_t pos = 0;
  bool fail = false;
  BitR(const uint8_t* data, int64_t nbytes) : d(data), nbits(nbytes * 8) {}
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

// ------------------------------------------------------------- huffman

struct Huff {
  // (length << 24) | code -> row index
  std::unordered_map<uint32_t, int> map;
  int maxlen = 0;
};

static Huff build_huff(const int* rows, int n, int stride) {
  Huff h;
  for (int i = 0; i < n; ++i) {
    int len = rows[i * stride];
    uint32_t code = (uint32_t)rows[i * stride + 1];
    h.map.emplace(((uint32_t)len << 24) | code, i);
    if (len > h.maxlen) h.maxlen = len;
  }
  return h;
}

struct Tables {
  Huff sf;
  Huff spec[12];
  double tns[2][2][16];  // [res][compress][code]
  Tables() {
    sf = build_huff(&kSfBook[0][0], kSfBookN, 3);
    for (int cb = 1; cb <= 11; ++cb)
      spec[cb] = build_huff(kSpecBooks[cb], kSpecBookN[cb], 6);
    for (int res = 0; res < 2; ++res) {
      int len = res + 3, n = 1 << len;
      std::vector<double> full(n);
      for (int i = 0; i < n / 2; ++i) full[i] = std::sin(i * kPi / (n - 1));
      for (int i = n / 2; i < n; ++i)
        full[i] = -std::sin((n - i) * kPi / (n + 1));
      for (int i = 0; i < n; ++i) tns[res][0][i] = full[i];
      for (int i = 0; i < n / 4; ++i) {
        tns[res][1][i] = full[i];
        tns[res][1][n / 4 + i] = full[3 * n / 4 + i];
      }
    }
  }
};
static const Tables kT;

static int huff_decode(BitR* br, const Huff& h) {
  uint32_t code = 0;
  for (int len = 1; len <= h.maxlen; ++len) {
    code = (code << 1) | br->read(1);
    if (br->fail) return -1;
    auto it = h.map.find(((uint32_t)len << 24) | code);
    if (it != h.map.end()) return it->second;
  }
  return -1;
}

// ------------------------------------------------------------- windows

struct Windows {
  double long_w[2][1024];
  double short_w[2][128];
  Windows() {
    for (int i = 0; i < 1024; ++i)
      long_w[0][i] = std::sin(kPi / 2048.0 * (i + 0.5));
    for (int i = 0; i < 128; ++i)
      short_w[0][i] = std::sin(kPi / 256.0 * (i + 0.5));
    kbd(long_w[1], 1024, 4.0);
    kbd(short_w[1], 128, 6.0);
  }
  static double bessel_i0(double x) {
    // power series, same convergence form as numpy.i0 at these arguments
    double sum = 1.0, term = 1.0;
    for (int k = 1; k < 64; ++k) {
      term *= (x / (2.0 * k)) * (x / (2.0 * k));
      sum += term;
      if (term < 1e-21 * sum) break;
    }
    return sum;
  }
  static void kbd(double* out, int n, double alpha) {
    std::vector<double> cum(n + 1);
    double a = kPi * alpha, acc = 0.0;
    for (int i = 0; i <= n; ++i) {
      double x = (double)i / n;
      double t = 1.0 - (2.0 * x - 1.0) * (2.0 * x - 1.0);
      acc += bessel_i0(a * std::sqrt(t > 0 ? t : 0.0));
      cum[i] = acc;
    }
    for (int i = 0; i < n; ++i) out[i] = std::sqrt(cum[i] / cum[n]);
  }
};
static const Windows kW;

// IMDCT basis tables (2/N-normalized), built lazily once.
struct Imdct {
  std::vector<double> long_tab;   // 2048 x 1024
  std::vector<double> short_tab;  // 256 x 128
  Imdct() {
    long_tab.resize(2048 * 1024);
    for (int n = 0; n < 2048; ++n)
      for (int k = 0; k < 1024; ++k)
        long_tab[(size_t)n * 1024 + k] =
            (2.0 / 2048.0) *
            std::cos(2 * kPi / 2048.0 * (n + 512.5) * (k + 0.5));
    short_tab.resize(256 * 128);
    for (int n = 0; n < 256; ++n)
      for (int k = 0; k < 128; ++k)
        short_tab[(size_t)n * 128 + k] =
            (2.0 / 256.0) * std::cos(2 * kPi / 256.0 * (n + 64.5) * (k + 0.5));
  }
};
static const Imdct* imdct_tables() {
  static const Imdct t;
  return &t;
}

static void imdct(const double* spec, int half, double* out) {
  const Imdct* t = imdct_tables();
  const double* tab = half == 1024 ? t->long_tab.data() : t->short_tab.data();
  int N = half * 2;
  // skip the zero tail: spectra are sparse above the coded bands
  int kmax = half;
  while (kmax > 0 && spec[kmax - 1] == 0.0) --kmax;
  for (int n = 0; n < N; ++n) {
    const double* row = tab + (size_t)n * half;
    double acc = 0.0;
    for (int k = 0; k < kmax; ++k) acc += row[k] * spec[k];
    out[n] = acc;
  }
}

// ------------------------------------------------------------- ics state

struct IcsInfo {
  int window_sequence = 0;
  int window_shape = 0;
  int max_sfb = 0;
  int num_windows = 1;
  std::vector<int> group_lens;
  const int* swb = nullptr;
  int num_swb = 0;
  int tns_max_bands = 0;
};

struct TnsFilt {
  int length, order, direction;
  double coefs[12];
};

struct ChannelData {
  IcsInfo ics;
  std::vector<int> band_cb;             // [group][sfb]
  std::vector<int> sf;                  // [group][sfb]
  std::vector<std::vector<TnsFilt>> tns;  // per window
  bool tns_present = false;
  std::vector<double> spec;             // num_windows x (1024/num_windows)
};

struct ChannelState {
  double overlap[1024] = {0};
  int prev_shape = 0;  // reference zero-initializes: frame 0 left = sine
};

struct Lcg {
  uint32_t state = 0x1F2E3D4C;
  double draw() {
    state = state * 1664525u + 1013904223u;
    return (double)(int32_t)state;
  }
};

// ------------------------------------------------------------- parsing

static int parse_ics_info(BitR* br, int sr_idx, IcsInfo* ics) {
  if (br->read(1)) return -1;  // ics_reserved_bit
  ics->window_sequence = br->read(2);
  ics->window_shape = br->read(1);
  if (ics->window_sequence == 2) {  // EIGHT_SHORT
    ics->max_sfb = br->read(4);
    uint32_t grouping = br->read(7);
    ics->num_windows = 8;
    ics->group_lens.assign(1, 1);
    for (int b = 6; b >= 0; --b) {
      if ((grouping >> b) & 1)
        ics->group_lens.back() += 1;
      else
        ics->group_lens.push_back(1);
    }
    ics->swb = kSwbShort[sr_idx];
    ics->num_swb = kSwbShortCount[sr_idx];
    ics->tns_max_bands = kTnsMaxShort[sr_idx];
  } else {
    ics->max_sfb = br->read(6);
    if (br->read(1)) return -1;  // predictor/LTP in LC
    ics->num_windows = 1;
    ics->group_lens.assign(1, 1);
    ics->swb = kSwbLong[sr_idx];
    ics->num_swb = kSwbLongCount[sr_idx];
    ics->tns_max_bands = kTnsMaxLong[sr_idx];
  }
  if (ics->max_sfb > ics->num_swb || br->fail) return -1;
  return 0;
}

static int parse_sections(BitR* br, const IcsInfo& ics,
                          std::vector<int>* band_cb) {
  int bits = ics.window_sequence == 2 ? 3 : 5;
  int esc = ics.window_sequence == 2 ? 7 : 31;
  band_cb->assign(ics.group_lens.size() * ics.max_sfb, 0);
  for (size_t g = 0; g < ics.group_lens.size(); ++g) {
    int covered = 0;
    while (covered < ics.max_sfb) {
      int cb = br->read(4);
      int run = 0, incr;
      do {
        incr = br->read(bits);
        run += incr;
      } while (incr == esc && !br->fail);
      if (br->fail || covered + run > ics.max_sfb) return -1;
      for (int s = 0; s < run; ++s)
        (*band_cb)[g * ics.max_sfb + covered + s] = cb;
      covered += run;
    }
  }
  return 0;
}

static int parse_scalefactors(BitR* br, const IcsInfo& ics,
                              const std::vector<int>& band_cb,
                              int global_gain, std::vector<int>* sf) {
  int cur = global_gain;
  int noise_nrg = global_gain - 90;
  int is_pos = 0;
  bool noise_pcm = true;
  sf->assign(band_cb.size(), 0);
  for (size_t g = 0; g < ics.group_lens.size(); ++g) {
    for (int s = 0; s < ics.max_sfb; ++s) {
      int cb = band_cb[g * ics.max_sfb + s];
      if (cb == 0) continue;
      if (cb == 14 || cb == 15) {
        int i = huff_decode(br, kT.sf);
        if (i < 0) return -1;
        is_pos += kSfBook[i][2];
        (*sf)[g * ics.max_sfb + s] = is_pos;
      } else if (cb == 13) {
        if (noise_pcm) {
          noise_pcm = false;
          noise_nrg += (int)br->read(9) - 256;
        } else {
          int i = huff_decode(br, kT.sf);
          if (i < 0) return -1;
          noise_nrg += kSfBook[i][2];
        }
        (*sf)[g * ics.max_sfb + s] = noise_nrg;
      } else {
        int i = huff_decode(br, kT.sf);
        if (i < 0) return -1;
        cur += kSfBook[i][2];
        if (cur < 0 || cur >= 256) return -1;
        (*sf)[g * ics.max_sfb + s] = cur;
      }
    }
  }
  return br->fail ? -1 : 0;
}

static int parse_tns(BitR* br, const IcsInfo& ics, ChannelData* ch) {
  bool is8 = ics.window_sequence == 2;
  int filt_bits = is8 ? 1 : 2;
  int len_bits = is8 ? 4 : 6, ord_bits = is8 ? 3 : 5;
  ch->tns.assign(ics.num_windows, {});
  for (int w = 0; w < ics.num_windows; ++w) {
    int n_filt = br->read(filt_bits);
    int coef_res = n_filt ? (int)br->read(1) : 0;
    for (int f = 0; f < n_filt; ++f) {
      TnsFilt tf;
      tf.length = br->read(len_bits);
      tf.order = br->read(ord_bits);
      if (tf.order > 12) return -1;
      tf.direction = 0;
      if (tf.order) {
        tf.direction = br->read(1);
        int compress = br->read(1);
        int coef_len = coef_res + 3 - compress;
        for (int i = 0; i < tf.order; ++i)
          tf.coefs[i] = kT.tns[coef_res][compress][br->read(coef_len)];
      }
      ch->tns[w].push_back(tf);
    }
  }
  return br->fail ? -1 : 0;
}

static int parse_spectrum(BitR* br, const IcsInfo& ics,
                          const std::vector<int>& band_cb,
                          std::vector<double>* quant) {
  int nwin = ics.num_windows;
  int wlen = 1024 / nwin;
  quant->assign((size_t)nwin * wlen, 0.0);
  int win_base = 0;
  for (size_t g = 0; g < ics.group_lens.size(); ++g) {
    int glen = ics.group_lens[g];
    for (int s = 0; s < ics.max_sfb; ++s) {
      int cb = band_cb[g * ics.max_sfb + s];
      int lo = ics.swb[s], hi = ics.swb[s + 1];
      if (cb == 0 || cb >= 13) continue;
      if (cb == 12) return -1;  // reserved
      int dims = kSpecDims[cb];
      bool is_signed = kSpecSigned[cb];
      const int* rows = kSpecBooks[cb];
      for (int w = 0; w < glen; ++w) {
        for (int k = lo; k < hi; k += dims) {
          int idx = huff_decode(br, kT.spec[cb]);
          if (idx < 0) return -1;
          const int* row = rows + (size_t)idx * 6;
          long vals[4];
          int signs[4] = {0, 0, 0, 0};
          for (int i = 0; i < dims; ++i) vals[i] = row[2 + i];
          if (!is_signed) {
            for (int i = 0; i < dims; ++i)
              if (vals[i]) signs[i] = br->read(1);
          } else {
            for (int i = 0; i < dims; ++i) {
              if (vals[i] < 0) { signs[i] = 1; vals[i] = -vals[i]; }
            }
          }
          if (cb == 11) {
            for (int i = 0; i < dims; ++i) {
              if (vals[i] == 16) {
                int n = 0;
                while (br->read(1) && !br->fail) ++n;
                if (n > 16 || br->fail) return -1;
                vals[i] = (1L << (n + 4)) + br->read(n + 4);
              }
            }
          }
          for (int i = 0; i < dims; ++i)
            (*quant)[(size_t)(win_base + w) * wlen + k + i] =
                signs[i] ? -(double)vals[i] : (double)vals[i];
        }
      }
    }
    win_base += glen;
  }
  return br->fail ? -1 : 0;
}

// ------------------------------------------------------ spectra building

static void spectra_from_ics(ChannelData* ch, Lcg* lcg) {
  const IcsInfo& ics = ch->ics;
  int nwin = ics.num_windows;
  int wlen = 1024 / nwin;
  std::vector<double>& spec = ch->spec;
  // dequant |q|^(4/3) with sign
  for (auto& v : spec) {
    double a = std::fabs(v);
    double d = std::pow(a, 4.0 / 3.0);
    v = v < 0 ? -d : d;
  }
  int win_base = 0;
  for (size_t g = 0; g < ics.group_lens.size(); ++g) {
    int glen = ics.group_lens[g];
    for (int s = 0; s < ics.max_sfb; ++s) {
      int cb = ch->band_cb[g * ics.max_sfb + s];
      int lo = ics.swb[s], hi = ics.swb[s + 1];
      int sfv = ch->sf[g * ics.max_sfb + s];
      if (cb == 14 || cb == 15) continue;
      if (cb == 13) {
        double gain = std::pow(2.0, 0.25 * sfv);
        for (int w = 0; w < glen; ++w) {
          double energy = 0.0;
          double* band = &spec[(size_t)(win_base + w) * wlen + lo];
          for (int k = 0; k < hi - lo; ++k) {
            band[k] = lcg->draw();
            energy += band[k] * band[k];
          }
          double scale = gain / std::sqrt(energy);
          for (int k = 0; k < hi - lo; ++k) band[k] *= scale;
        }
      } else if (cb != 0) {
        double gain = std::pow(2.0, 0.25 * (sfv - 100));
        for (int w = 0; w < glen; ++w)
          for (int k = lo; k < hi; ++k)
            spec[(size_t)(win_base + w) * wlen + k] *= gain;
      }
    }
    win_base += glen;
  }
  for (auto& v : spec) v /= 32768.0;
}

static void apply_tns(ChannelData* ch) {
  if (!ch->tns_present) return;
  const IcsInfo& ics = ch->ics;
  int wlen = 1024 / ics.num_windows;
  int mmm = ics.tns_max_bands < ics.max_sfb ? ics.tns_max_bands
                                            : ics.max_sfb;
  for (int w = 0; w < ics.num_windows; ++w) {
    int bottom = ics.num_swb;
    for (const TnsFilt& tf : ch->tns[w]) {
      int top = bottom;
      bottom = top - tf.length;
      if (bottom < 0) bottom = 0;
      if (tf.order == 0) continue;
      double lpc[12] = {0};
      for (int m = 0; m < tf.order; ++m) {
        double k = tf.coefs[m];
        double nw[12];
        for (int i = 0; i < m; ++i) nw[i] = lpc[i] + k * lpc[m - 1 - i];
        nw[m] = k;
        for (int i = 0; i <= m; ++i) lpc[i] = nw[i];
      }
      int bidx = bottom < mmm ? bottom : mmm;
      int tidx = top < mmm ? top : mmm;
      int start = ics.swb[bidx], end = ics.swb[tidx];
      if (end <= start) continue;
      double* x = &ch->spec[(size_t)w * wlen];
      double hist[12] = {0};
      if (tf.direction) {
        for (int k = end - 1; k >= start; --k) {
          double dot = 0.0;
          for (int i = 0; i < tf.order; ++i) dot += lpc[i] * hist[i];
          double y = x[k] - dot;
          for (int i = tf.order - 1; i > 0; --i) hist[i] = hist[i - 1];
          hist[0] = y;
          x[k] = y;
        }
      } else {
        for (int k = start; k < end; ++k) {
          double dot = 0.0;
          for (int i = 0; i < tf.order; ++i) dot += lpc[i] * hist[i];
          double y = x[k] - dot;
          for (int i = tf.order - 1; i > 0; --i) hist[i] = hist[i - 1];
          hist[0] = y;
          x[k] = y;
        }
      }
    }
  }
}

// ------------------------------------------------------------- synthesis

static void synthesize(const ChannelData& ch, ChannelState* st,
                       double* out) {
  const IcsInfo& ics = ch.ics;
  int shape = ics.window_shape;
  int prev = st->prev_shape;
  int seq = ics.window_sequence;
  if (seq != 2) {
    double x[2048];
    imdct(ch.spec.data(), 1024, x);
    double wl[1024], wr[1024];
    if (seq == 3) {  // LONG_STOP
      for (int i = 0; i < 448; ++i) wl[i] = 0.0;
      for (int i = 0; i < 128; ++i) wl[448 + i] = kW.short_w[prev][i];
      for (int i = 576; i < 1024; ++i) wl[i] = 1.0;
    } else {
      for (int i = 0; i < 1024; ++i) wl[i] = kW.long_w[prev][i];
    }
    if (seq == 1) {  // LONG_START
      for (int i = 0; i < 448; ++i) wr[i] = 1.0;
      for (int i = 0; i < 128; ++i) wr[448 + i] = kW.short_w[shape][127 - i];
      for (int i = 576; i < 1024; ++i) wr[i] = 0.0;
    } else {
      for (int i = 0; i < 1024; ++i) wr[i] = kW.long_w[shape][1023 - i];
    }
    for (int i = 0; i < 1024; ++i) out[i] = st->overlap[i] + x[i] * wl[i];
    for (int i = 0; i < 1024; ++i) st->overlap[i] = x[1024 + i] * wr[i];
  } else {
    double buf[2048] = {0};
    for (int w = 0; w < 8; ++w) {
      double xw[256];
      imdct(&ch.spec[(size_t)w * 128], 128, xw);
      const double* wlw = w == 0 ? kW.short_w[prev] : kW.short_w[shape];
      int off = 448 + 128 * w;
      for (int i = 0; i < 128; ++i) buf[off + i] += xw[i] * wlw[i];
      for (int i = 0; i < 128; ++i)
        buf[off + 128 + i] += xw[128 + i] * kW.short_w[shape][127 - i];
    }
    for (int i = 0; i < 1024; ++i) out[i] = st->overlap[i] + buf[i];
    for (int i = 0; i < 1024; ++i) st->overlap[i] = buf[1024 + i];
  }
  st->prev_shape = shape;
}

// ------------------------------------------------------------- elements

static int decode_ics(BitR* br, int sr_idx, Lcg* lcg, const IcsInfo* common,
                      ChannelData* ch) {
  int global_gain = br->read(8);
  if (common) {
    ch->ics = *common;
  } else {
    if (parse_ics_info(br, sr_idx, &ch->ics)) return -1;
  }
  if (parse_sections(br, ch->ics, &ch->band_cb)) return -1;
  if (parse_scalefactors(br, ch->ics, ch->band_cb, global_gain, &ch->sf))
    return -1;
  int pulse_start = -1;
  int pulse_off[4], pulse_amp[4], n_pulse = 0;
  if (br->read(1)) {  // pulse
    if (ch->ics.window_sequence == 2) return -1;
    n_pulse = br->read(2) + 1;
    pulse_start = br->read(6);
    for (int i = 0; i < n_pulse; ++i) {
      pulse_off[i] = br->read(5);
      pulse_amp[i] = br->read(4);
    }
  }
  ch->tns_present = false;
  if (br->read(1)) {
    ch->tns_present = true;
    if (parse_tns(br, ch->ics, ch)) return -1;
  }
  if (br->read(1)) return -1;  // gain control (SSR)
  if (parse_spectrum(br, ch->ics, ch->band_cb, &ch->spec)) return -1;
  if (pulse_start >= 0) {
    if (pulse_start > ch->ics.num_swb) return -1;
    int k = ch->ics.swb[pulse_start];
    for (int i = 0; i < n_pulse; ++i) {
      k += pulse_off[i];
      if (k >= 1024) return -1;
      double base = ch->spec[k];
      ch->spec[k] = base > 0 ? base + pulse_amp[i] : base - pulse_amp[i];
    }
  }
  spectra_from_ics(ch, lcg);
  return br->fail ? -1 : 0;
}

static int decode_cpe(BitR* br, int sr_idx, Lcg* lcg, ChannelData* L,
                      ChannelData* R) {
  br->read(4);
  int common_window = br->read(1);
  std::vector<int> ms_used;
  IcsInfo common;
  bool have_common = false;
  if (common_window) {
    if (parse_ics_info(br, sr_idx, &common)) return -1;
    have_common = true;
    int ms_mask = br->read(2);
    if (ms_mask == 3) return -1;
    size_t nbits = common.group_lens.size() * common.max_sfb;
    if (ms_mask == 1) {
      ms_used.resize(nbits);
      for (size_t i = 0; i < nbits; ++i) ms_used[i] = br->read(1);
    } else if (ms_mask == 2) {
      ms_used.assign(nbits, 1);
    }
  }
  if (decode_ics(br, sr_idx, lcg, have_common ? &common : nullptr, L))
    return -1;
  if (decode_ics(br, sr_idx, lcg, have_common ? &common : nullptr, R))
    return -1;
  if (have_common) {
    const IcsInfo& ics = L->ics;
    int wlen = 1024 / ics.num_windows;
    int win_base = 0;
    for (size_t g = 0; g < ics.group_lens.size(); ++g) {
      int glen = ics.group_lens[g];
      for (int s = 0; s < ics.max_sfb; ++s) {
        size_t gi = g * ics.max_sfb + s;
        int lo = ics.swb[s], hi = ics.swb[s + 1];
        int cbl = L->band_cb[gi], cbr = R->band_cb[gi];
        if (!ms_used.empty() && ms_used[gi] && cbl < 13 && cbr < 13) {
          for (int w = 0; w < glen; ++w) {
            double* l = &L->spec[(size_t)(win_base + w) * wlen];
            double* r = &R->spec[(size_t)(win_base + w) * wlen];
            for (int k = lo; k < hi; ++k) {
              double m = l[k], sdif = r[k];
              l[k] = m + sdif;
              r[k] = m - sdif;
            }
          }
        }
        if (cbr == 14 || cbr == 15) {
          double sign = cbr == 15 ? 1.0 : -1.0;
          if (!ms_used.empty() && ms_used[gi]) sign = -sign;
          double scale = sign * std::pow(2.0, -0.25 * R->sf[gi]);
          for (int w = 0; w < glen; ++w) {
            double* l = &L->spec[(size_t)(win_base + w) * wlen];
            double* r = &R->spec[(size_t)(win_base + w) * wlen];
            for (int k = lo; k < hi; ++k) r[k] = l[k] * scale;
          }
        }
      }
      win_base += glen;
    }
  }
  apply_tns(L);
  apply_tns(R);
  return 0;
}

}  // namespace aac

// ----------------------------------------------------------------- ADTS

namespace {

struct AdtsHeader {
  int sample_rate, channels, frame_length, header_len, profile;
};

static int parse_adts(const uint8_t* d, int64_t n, int64_t pos,
                      AdtsHeader* h) {
  if (pos + 7 > n || d[pos] != 0xFF || (d[pos + 1] & 0xF6) != 0xF0)
    return -1;
  int protection_absent = d[pos + 1] & 1;
  h->profile = d[pos + 2] >> 6;
  int sr_idx = (d[pos + 2] >> 2) & 0xF;
  if (sr_idx >= 12) return -1;
  h->sample_rate = kAacRates[sr_idx];
  h->channels = ((d[pos + 2] & 1) << 2) | (d[pos + 3] >> 6);
  h->frame_length = ((d[pos + 3] & 3) << 11) | (d[pos + 4] << 3) |
                    (d[pos + 5] >> 5);
  if (h->frame_length < 7) return -1;
  if (d[pos + 6] & 3) return -1;  // multi-raw-data-block frames
  h->header_len = 7 + (protection_absent ? 0 : 2);
  return 0;
}

static int sr_index(int rate) {
  for (int i = 0; i < 12; ++i)
    if (kAacRates[i] == rate) return i;
  return -1;
}

}  // namespace

// Verified-chain sync scan: mirrors io/aac.py::_find_adts (chain=2).
int64_t hpfw_aac_find_sync(const uint8_t* d, int64_t n, int64_t pos) {
  while (pos + 7 <= n) {
    AdtsHeader h;
    if (parse_adts(d, n, pos, &h) == 0) {
      int64_t nxt = pos + h.frame_length;
      bool ok = true;
      for (int c = 0; c < 2; ++c) {
        if (nxt == n) break;
        AdtsHeader h2;
        if (parse_adts(d, n, nxt, &h2) != 0) { ok = false; break; }
        nxt += h2.frame_length;
      }
      if (ok && nxt <= n) return pos;
    }
    ++pos;
  }
  return -1;
}

// One-pass ADTS AAC-LC decode; mono downmix by channel mean (matching
// io/wav.py::_decode_adts_bytes). rc 0 ok, negative on failure.
int hpfw_aac_decode_vec(const uint8_t* data, int64_t size,
                        std::vector<float>* out, int32_t* sample_rate) {
  int64_t pos = hpfw_aac_find_sync(data, size, 0);
  if (pos < 0) return -1;
  aac::Lcg lcg;
  aac::ChannelState states[2];
  int sr = 0, nch = 0, sr_idx = -1;
  out->clear();
  aac::ChannelData chdata[2];
  double outbuf[2][1024];
  while (pos >= 0 && pos + 7 <= size) {
    AdtsHeader h;
    if (parse_adts(data, size, pos, &h) != 0) {
      pos = hpfw_aac_find_sync(data, size, pos + 1);
      continue;
    }
    if (h.profile != 1) return -2;  // LC only
    int64_t end = pos + h.frame_length;
    if (end > size) break;
    if (sr == 0) {
      sr = h.sample_rate;
      nch = h.channels;
      sr_idx = sr_index(sr);
      if ((nch != 1 && nch != 2) || sr_idx < 0) return -3;
    }
    aac::BitR br(data + pos + h.header_len,
                 h.frame_length - h.header_len);
    int got_ch = 0;
    bool frame_ok = true;
    while (frame_ok) {
      int ele = br.read(3);
      if (br.fail) { frame_ok = false; break; }
      if (ele == 7) break;  // END
      if (ele == 0 || ele == 3) {  // SCE / LFE
        if (got_ch >= 2) { frame_ok = false; break; }
        br.read(4);
        if (aac::decode_ics(&br, sr_idx, &lcg, nullptr, &chdata[got_ch])) {
          frame_ok = false;
          break;
        }
        aac::apply_tns(&chdata[got_ch]);
        ++got_ch;
      } else if (ele == 1) {  // CPE
        if (got_ch != 0) { frame_ok = false; break; }
        if (aac::decode_cpe(&br, sr_idx, &lcg, &chdata[0], &chdata[1])) {
          frame_ok = false;
          break;
        }
        got_ch = 2;
      } else if (ele == 4) {  // DSE
        br.read(4);
        int align = br.read(1);
        int cnt = br.read(8);
        if (cnt == 255) cnt += br.read(8);
        if (align) br.pos += (8 - (br.pos & 7)) & 7;
        br.pos += 8 * (int64_t)cnt;
      } else if (ele == 6) {  // FIL
        int cnt = br.read(4);
        if (cnt == 15) cnt += (int)br.read(8) - 1;
        br.pos += 8 * (int64_t)cnt;
      } else {
        frame_ok = false;  // PCE/CCE unsupported in the native twin
        break;
      }
    }
    if (!frame_ok || got_ch != nch || br.fail) return -4;
    for (int c = 0; c < nch; ++c)
      aac::synthesize(chdata[c], &states[c], outbuf[c]);
    size_t base = out->size();
    out->resize(base + 1024);
    if (nch == 1) {
      for (int i = 0; i < 1024; ++i)
        (*out)[base + i] = (float)outbuf[0][i];
    } else {
      for (int i = 0; i < 1024; ++i)
        (*out)[base + i] = (float)(0.5 * (outbuf[0][i] + outbuf[1][i]));
    }
    pos = end;
    if (pos + 7 > size) break;
    if (!(data[pos] == 0xFF && (data[pos + 1] & 0xF6) == 0xF0))
      pos = hpfw_aac_find_sync(data, size, pos);
  }
  if (out->empty()) return -5;
  *sample_rate = sr;
  return 0;
}

extern "C" {

// Two-call ABI matching hpfw_mp3_decode: out==nullptr sizes the buffer.
int hpfw_aac_decode(const uint8_t* data, int64_t size, float* out,
                    int64_t* n_samples, int32_t* sample_rate) {
  std::vector<float> v;
  int rc = hpfw_aac_decode_vec(data, size, &v, sample_rate);
  if (rc) return rc;
  if (out) {
    int64_t n = (int64_t)v.size() < *n_samples ? (int64_t)v.size()
                                               : *n_samples;
    std::memcpy(out, v.data(), (size_t)n * sizeof(float));
  }
  *n_samples = (int64_t)v.size();
  return 0;
}

}  // extern "C"
