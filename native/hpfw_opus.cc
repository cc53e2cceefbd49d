// hpfw_opus.cc — C++ twin of the from-spec Opus (CELT) decoder.
//
// Operation-for-operation mirror of hpfw_jax/io/opus.py and the _celt_*
// modules (RFC 6716 §3/§4 + RFC 7845 Ogg Opus). Everything that decides
// bitstream consumption is exact integer arithmetic identical to the NumPy
// twin (a single mis-decoded symbol desyncs the range coder, and the
// final_range check in tests/test_opus.py proves sync bit-exactly); the
// signal path runs in double like the twin and is margin-tested against it.
// Static mode tables come from celt_tables.inc, GENERATED by
// tools/gen_celt_tables.py from the probe-recovered Python tables — never
// edited by hand. Reference mount is empty (SURVEY.md §0); the system
// libopus oracle (hpfw_jax/io/opus_ref.py) is the certification target for
// the Python twin, and this file is certified against that twin.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include "hpfw_internal.h"

#include "celt_tables.inc"

namespace celt {

constexpr int kNbBands = 21;
constexpr int kBitres = 3;           // eighth-bit budget resolution
constexpr int kMaxFineBits = 8;
constexpr int kOverlap = 120;
constexpr int kShortMdct = 120;
constexpr int kMaxLm = 3;
constexpr int kDecodeBuffer = 2048;
constexpr int kCombMinPeriod = 15;
constexpr double kSigScale = 32768.0;
constexpr double kPreemph = 0.85;
constexpr double kSqrtHalf = 0.7071067811865476;

static inline int ilog(uint32_t x) { return x ? 32 - __builtin_clz(x) : 0; }

// ---------------------------------------------------------------------------
// Range (entropy) decoder — twin of _celt_ec.py (RFC 6716 §4.1).
// ---------------------------------------------------------------------------

struct RangeDec {
  const uint8_t* buf;
  int64_t storage;
  int64_t offs = 0;            // front (range-coded) cursor
  int64_t end_offs = 0;        // back (raw-bit) cursor
  uint32_t end_window = 0;
  int nend_bits = 0;
  int64_t nbits_total;
  uint32_t rng, val, ext = 0, rem;
  int error = 0;

  static constexpr int kSymBits = 8;
  static constexpr int kCodeBits = 32;
  static constexpr uint32_t kSymMax = (1u << kSymBits) - 1;
  static constexpr uint32_t kCodeTop = 1u << (kCodeBits - 1);
  static constexpr uint32_t kCodeBot = kCodeTop >> kSymBits;
  static constexpr int kCodeExtra = (kCodeBits - 2) % kSymBits + 1;  // 7
  static constexpr int kUintBits = 8;
  static constexpr int kWindowSize = 32;

  explicit RangeDec(const uint8_t* data, int64_t size)
      : buf(data), storage(size) {
    nbits_total = kCodeBits + 1
                  - ((kCodeBits - kCodeExtra) / kSymBits) * kSymBits;
    rng = 1u << kCodeExtra;
    rem = read_byte();
    val = rng - 1 - (rem >> (kSymBits - kCodeExtra));
    normalize();
  }

  uint32_t read_byte() {
    if (offs < storage) return buf[offs++];
    return 0;
  }
  uint32_t read_byte_from_end() {
    if (end_offs < storage) {
      ++end_offs;
      return buf[storage - end_offs];
    }
    return 0;
  }

  void normalize() {
    while (rng <= kCodeBot) {
      nbits_total += kSymBits;
      rng <<= kSymBits;
      uint32_t sym = rem;
      rem = read_byte();
      sym = ((sym << kSymBits) | rem) >> (kSymBits - kCodeExtra);
      val = ((val << kSymBits) + (kSymMax & ~sym)) & (kCodeTop - 1);
    }
  }

  uint32_t decode(uint32_t ft) {
    ext = rng / ft;
    uint32_t s = val / ext;
    return ft - std::min<uint32_t>(s + 1, ft);
  }
  uint32_t decode_bin(int bits) {
    ext = rng >> bits;
    uint32_t s = val / ext;
    return (1u << bits) - std::min<uint32_t>(s + 1, 1u << bits);
  }
  void update(uint32_t fl, uint32_t fh, uint32_t ft) {
    uint32_t s = ext * (ft - fh);
    val -= s;
    rng = fl > 0 ? ext * (fh - fl) : rng - s;
    normalize();
  }
  int dec_bit_logp(int logp) {
    uint32_t r = rng, d = val;
    uint32_t s = r >> logp;
    int ret = d < s ? 1 : 0;
    if (!ret) val = d - s;
    rng = ret ? s : r - s;
    normalize();
    return ret;
  }
  int dec_icdf(const int* icdf, int ftb) {
    uint32_t d = val;
    uint32_t r = rng >> ftb;
    int ret = -1;
    uint32_t s = rng, t;
    do {
      t = s;
      ++ret;
      s = r * (uint32_t)icdf[ret];
    } while (d < s);
    val = d - s;
    rng = t - s;
    normalize();
    return ret;
  }
  uint32_t dec_uint(uint32_t ft) {
    // assert(ft > 1) in the twin
    ft -= 1;
    int ftb = ilog(ft);
    if (ftb > kUintBits) {
      ftb -= kUintBits;
      uint32_t ft1 = (ft >> ftb) + 1;
      uint32_t s = decode(ft1);
      update(s, s + 1, ft1);
      uint32_t t = (s << ftb) | dec_bits(ftb);
      if (t <= ft) return t;
      error = 1;
      return ft;
    }
    uint32_t s = decode(ft + 1);
    update(s, s + 1, ft + 1);
    return s;
  }
  uint32_t dec_bits(int bits) {
    uint32_t window = end_window;
    int available = nend_bits;
    if (available < bits) {
      while (available <= kWindowSize - kSymBits) {
        window |= read_byte_from_end() << available;
        available += kSymBits;
      }
    }
    uint32_t ret = window & ((bits < 32 ? (1u << bits) : 0u) - 1);
    window >>= bits;
    available -= bits;
    end_window = window;
    nend_bits = available;
    nbits_total += bits;
    return ret;
  }
  int64_t tell() const { return nbits_total - ilog(rng); }
  int64_t tell_frac() const {
    static const uint32_t kCorrection[8] = {35733, 38967, 42495, 46340,
                                            50535, 55109, 60097, 65535};
    int64_t nbits = nbits_total << kBitres;
    int lg = ilog(rng);
    uint32_t r = rng >> (lg - 16);
    int b = (int)(r >> 12) - 8;
    b += r > kCorrection[b] ? 1 : 0;
    int lgq3 = (lg << 3) + b;
    return nbits - lgq3;
  }
};

// Laplace-coded coarse-energy residuals (twin of laplace_decode).
static int laplace_decode(RangeDec* dec, int fs, int decay) {
  constexpr int kLogMinp = 0;
  constexpr int kMinp = 1 << kLogMinp;
  constexpr int kNmin = 16;
  int val = 0;
  int fl = 0;
  int fm = (int)dec->decode_bin(15);
  if (fm >= fs) {
    val += 1;
    fl = fs;
    int ft = 32768 - kMinp * (2 * kNmin) - fs;
    fs = ((ft * (16384 - decay)) >> 15) + kMinp;
    while (fs > kMinp && fm >= fl + 2 * fs) {
      fs *= 2;
      fl += fs;
      fs = ((fs - 2 * kMinp) * decay) >> 15;
      fs += kMinp;
      val += 1;
    }
    if (fs <= kMinp) {
      int di = (fm - fl) >> (kLogMinp + 1);
      val += di;
      fl += 2 * di * kMinp;
    }
    if (fm < fl + fs)
      val = -val;
    else
      fl += fs;
  }
  dec->update((uint32_t)fl, (uint32_t)std::min(fl + fs, 32768), 32768);
  return val;
}

// ---------------------------------------------------------------------------
// PVQ codeword enumeration (CWRS) + spreading rotation — twin of
// _celt_pvq.py. V(N, K) fits uint64 for every reachable codebook (all
// reachable values are < 2^32 by the pulse-cache construction; the DP's
// dependency chain for any queried cell is monotone, so no intermediate
// overflow can corrupt a queried value).
// ---------------------------------------------------------------------------

constexpr int kPvqMaxN = 176;   // widest band: (100-78) << LM=3
constexpr int kPvqMaxK = 130;   // get_pulses(40) = 128, +2 slack for U(K+1)

static uint64_t* pvq_table() {
  static uint64_t t[(kPvqMaxN + 1) * (kPvqMaxK + 1)];
  static std::once_flag once;
  std::call_once(once, [] {
    auto at = [&](int n, int k) -> uint64_t& {
      return t[n * (kPvqMaxK + 1) + k];
    };
    for (int k = 0; k <= kPvqMaxK; ++k) at(0, k) = k == 0 ? 1 : 0;
    for (int n = 1; n <= kPvqMaxN; ++n) {
      at(n, 0) = 1;
      for (int k = 1; k <= kPvqMaxK; ++k)
        at(n, k) = at(n - 1, k) + at(n, k - 1) + at(n - 1, k - 1);
    }
  });
  return t;
}

static inline uint64_t pvq_v(int n, int k) {
  return pvq_table()[n * (kPvqMaxK + 1) + k];
}

// Codewords of dim n, norm k, with first coordinate > 0 (twin of _u).
static inline uint64_t pvq_u(int k, int n) {
  if (n < 1) return 0;
  return (pvq_v(n, k) - pvq_v(n - 1, k)) / 2;
}

// Index -> pulse vector (twin of cwrsi, §4.3.4.1).
static void cwrsi(int n, int k, uint64_t i, int* y) {
  std::memset(y, 0, sizeof(int) * n);
  if (k == 0) return;
  int pos = 0;
  while (n > 2) {
    uint64_t p = pvq_u(k, n);
    uint64_t q = pvq_u(k + 1, n);
    if (p <= i && i < q) {
      i -= p;
      y[pos] = 0;
    } else {
      bool neg = i >= q;
      if (neg) i -= q;
      int k0 = k;
      p = pvq_u(k, n);
      while (p > i) {
        k -= 1;
        p = pvq_u(k, n);
      }
      i -= p;
      int v = k0 - k;
      y[pos] = neg ? -v : v;
    }
    pos += 1;
    n -= 1;
  }
  if (n == 2) {
    uint64_t p = 2 * (uint64_t)k + 1;
    bool neg = i >= p;
    if (neg) i -= p;
    int k0 = k;
    k = (int)((i + 1) >> 1);
    if (k) i -= 2 * (uint64_t)k - 1;
    int v = k0 - k;
    y[pos] = neg ? -v : v;
    pos += 1;
  }
  y[pos] = i ? -k : k;
}

// Spreading rotation constants (vq.c twin).
constexpr int kSpreadNone = 0;
constexpr int kSpreadAggressive = 3;
constexpr int kSpreadNormal = 2;
static const int kSpreadFactor[3] = {15, 10, 5};  // LIGHT, NORMAL, AGGRESSIVE

static void exp_rotation1(double* x, int ln, int stride, double c, double s) {
  for (int i = 0; i < ln - stride; ++i) {
    double x1 = x[i], x2 = x[i + stride];
    x[i + stride] = c * x2 + s * x1;
    x[i] = c * x1 - s * x2;
  }
  for (int i = ln - 2 * stride - 1; i >= 0; --i) {
    double x1 = x[i], x2 = x[i + stride];
    x[i + stride] = c * x2 + s * x1;
    x[i] = c * x1 - s * x2;
  }
}

static void exp_rotation(double* x, int n, int dirn, int stride, int k,
                         int spread) {
  if (2 * k >= n || spread == kSpreadNone) return;
  int factor = kSpreadFactor[spread - 1];
  double gain = (double)n / (double)(n + factor * k);
  double theta = 0.5 * gain * gain;
  double c = std::cos(0.5 * M_PI * theta);
  double s = std::cos(0.5 * M_PI * (1.0 - theta));  // sin
  int stride2 = 0;
  if (n >= 8 * stride) {
    stride2 = 1;
    while ((stride2 * stride2 + stride2) * stride + (stride >> 2) < n)
      stride2 += 1;
  }
  int ln = n / stride;
  for (int i = 0; i < stride; ++i) {
    double* seg = x + i * ln;
    if (dirn < 0) {
      if (stride2) exp_rotation1(seg, ln, stride2, s, c);
      exp_rotation1(seg, ln, 1, c, s);
    } else {
      exp_rotation1(seg, ln, 1, c, -s);
      if (stride2) exp_rotation1(seg, ln, stride2, s, -c);
    }
  }
}

static int extract_collapse_mask(const int* y, int n, int b) {
  if (b <= 1) return 1;
  int n0 = n / b;
  int mask = 0;
  for (int blk = 0; blk < b; ++blk) {
    bool any = false;
    for (int j = 0; j < n0; ++j)
      if (y[blk * n0 + j]) { any = true; break; }
    if (any) mask |= 1 << blk;
  }
  return mask;
}

// Decode one PVQ band shape into x (length n); returns the collapse mask.
static int alg_unquant(RangeDec* dec, double* x, int n, int k, int spread,
                       int b, double gain) {
  int y[kPvqMaxN];
  uint64_t idx = dec->dec_uint((uint32_t)pvq_v(n, k));
  cwrsi(n, k, idx, y);
  double e = 0.0;
  for (int j = 0; j < n; ++j) e += (double)y[j] * (double)y[j];
  double g = e > 0 ? gain / std::sqrt(e) : 0.0;
  for (int j = 0; j < n; ++j) x[j] = g * y[j];
  exp_rotation(x, n, -1, b, k, spread);
  return extract_collapse_mask(y, n, b);
}

// ---------------------------------------------------------------------------
// Band energy decode — twin of _celt_energy.py (§4.3.2).
// ---------------------------------------------------------------------------

static const int kSmallEnergyIcdf[3] = {2, 1, 0};

static void unquant_coarse_energy(int start, int end, float old_e[2][21],
                                  bool intra, RangeDec* dec, int c, int lm) {
  const unsigned char* prob_model = kEProbModel[lm][intra ? 1 : 0];
  double coef, beta;
  if (intra) {
    coef = 0.0;
    beta = (double)kBetaIntra;
  } else {
    coef = (double)kPredCoef[lm];
    beta = (double)kBetaCoef[lm];
  }
  int64_t budget = dec->storage * 8;
  double prev[2] = {0.0, 0.0};
  for (int i = start; i < end; ++i) {
    for (int ch = 0; ch < c; ++ch) {
      int64_t tell = dec->tell();
      int qi;
      if (budget - tell >= 15) {
        int pi = 2 * std::min(i, 20);
        qi = laplace_decode(dec, (int)prob_model[pi] << 7,
                            (int)prob_model[pi + 1] << 6);
      } else if (budget - tell >= 2) {
        qi = dec->dec_icdf(kSmallEnergyIcdf, 2);
        qi = (qi >> 1) ^ -(qi & 1);
      } else if (budget - tell >= 1) {
        qi = -dec->dec_bit_logp(1);
      } else {
        qi = -1;
      }
      double q = (double)qi;
      double e = std::max(-9.0, (double)old_e[ch][i]);
      double tmp = coef * e + prev[ch] + q;
      old_e[ch][i] = (float)tmp;
      prev[ch] = prev[ch] + q - beta * q;
    }
  }
}

static void unquant_fine_energy(int start, int end, float old_e[2][21],
                                const int* fine_quant, RangeDec* dec,
                                int c) {
  for (int i = start; i < end; ++i) {
    if (fine_quant[i] <= 0) continue;
    for (int ch = 0; ch < c; ++ch) {
      uint32_t q2 = dec->dec_bits(fine_quant[i]);
      double offset = ((double)q2 + 0.5) * (double)(1 << (14 - fine_quant[i]))
                      / 16384.0 - 0.5;
      old_e[ch][i] = (float)((double)old_e[ch][i] + offset);
    }
  }
}

static void unquant_energy_finalise(int start, int end, float old_e[2][21],
                                    const int* fine_quant,
                                    const int* fine_priority,
                                    int64_t bits_left, RangeDec* dec,
                                    int c) {
  for (int prio = 0; prio < 2; ++prio) {
    int i = start;
    while (i < end && bits_left >= c) {
      if (fine_quant[i] >= kMaxFineBits || fine_priority[i] != prio) {
        ++i;
        continue;
      }
      for (int ch = 0; ch < c; ++ch) {
        int q2 = (int)dec->dec_bits(1);
        double offset = ((double)q2 - 0.5)
                        * (double)(1 << (14 - fine_quant[i] - 1)) / 16384.0;
        old_e[ch][i] = (float)((double)old_e[ch][i] + offset);
        bits_left -= 1;
      }
      ++i;
    }
  }
}

// Scale unit-norm band shapes back to linear energy (float-build twin).
static void denormalise_bands(const double* x, const float* band_log_e,
                              int start, int end, int m, int n, bool silence,
                              float* freq) {
  std::memset(freq, 0, sizeof(float) * n);
  if (silence) return;
  for (int i = start; i < end; ++i) {
    int j0 = m * kEBand5ms[i];
    int j1 = m * kEBand5ms[i + 1];
    double lg = std::min(32.0, (double)band_log_e[i] + (double)kEMeans[i]);
    float g = (float)std::exp2(lg);
    for (int j = j0; j < j1; ++j) freq[j] = (float)(x[j] * (double)g);
  }
}

namespace bands {

using celt::RangeDec;
using celt::kBitres;
using celt::kNbBands;
using celt::ilog;

constexpr int kLogMaxPseudo = 6;
constexpr int kAllocSteps = 6;
constexpr int kFineOffset = 21;
constexpr int kQThetaOffset = 4;
constexpr int kQThetaOffsetTwophase = 16;

// rate.c: log2 fractions (Q3) of the intensity-band count.
static const int kLog2FracTable[24] = {
    0,  8,  13, 16, 19, 21, 23, 24, 26, 27, 28, 29,
    30, 31, 32, 32, 33, 34, 34, 35, 36, 36, 37, 37};

static inline int get_pulses(int i) {
  return i < 8 ? i : (8 + (i & 7)) << ((i >> 3) - 1);
}

static inline const int* cache_row(int band, int lm) {
  int idx = kCacheIndex50[lm + 1][band];
  if (idx < 0) return nullptr;
  return kCacheBits50 + idx;
}

static int bits2pulses(int band, int lm, int bits) {
  const int* cache = cache_row(band, lm);
  int lo = 0, hi = cache[0];
  bits -= 1;
  for (int it = 0; it < kLogMaxPseudo; ++it) {
    int mid = (lo + hi + 1) >> 1;
    if (cache[mid] >= bits)
      hi = mid;
    else
      lo = mid;
  }
  if (bits - (lo == 0 ? -1 : cache[lo]) <= cache[hi] - bits) return lo;
  return hi;
}

static int pulses2bits(int band, int lm, int pulses) {
  if (pulses == 0) return 0;
  return cache_row(band, lm)[pulses] + 1;
}

// Per-band hard bit caps (celt.c init_caps twin), eighth-bit units.
static void init_caps(int lm, int c, int* caps) {
  for (int i = 0; i < kNbBands; ++i) {
    int n = (kEBand5ms[i + 1] - kEBand5ms[i]) << lm;
    caps[i] = ((int)kCacheCaps50[2 * lm + c - 1][i] + 64) * c * n >> 2;
  }
}

// tf_res decode (celt.c tf_decode twin).
static void tf_decode(int start, int end, bool is_transient, int lm,
                      RangeDec* dec, int* tf_res) {
  int64_t budget = dec->storage * 8;
  int64_t tell = dec->tell();
  int logp = is_transient ? 2 : 4;
  int tf_select_rsv = (lm > 0 && tell + logp + 1 <= budget) ? 1 : 0;
  budget -= tf_select_rsv;
  int tf_changed = 0;
  int curr = 0;
  for (int i = 0; i < kNbBands; ++i) tf_res[i] = 0;
  for (int i = start; i < end; ++i) {
    if (tell + logp <= budget) {
      curr ^= dec->dec_bit_logp(logp);
      tell = dec->tell();
      tf_changed |= curr;
    }
    tf_res[i] = curr;
    logp = is_transient ? 4 : 5;
  }
  int tf_select = 0;
  int base = is_transient ? 4 : 0;
  if (tf_select_rsv && (kTfSelect[lm][base + 0 + tf_changed]
                        != kTfSelect[lm][base + 2 + tf_changed]))
    tf_select = dec->dec_bit_logp(1);
  for (int i = start; i < end; ++i)
    tf_res[i] = kTfSelect[lm][base + 2 * tf_select + tf_res[i]];
}

struct Allocation {
  int coded_bands, balance, intensity, dual_stereo;
  int bits[kNbBands], ebits[kNbBands], fine_priority[kNbBands];
};

// rate.c interp_bits2pulses twin (decode side).
static void interp_bits2pulses(int start, int end, int skip_start,
                               const int* bits1, const int* bits2,
                               const int* thresh, const int* cap, int total,
                               int skip_rsv, int intensity_rsv,
                               int dual_stereo_rsv, int c, int lm,
                               RangeDec* dec, Allocation* out) {
  int alloc_floor = c << kBitres;
  int stereo = c > 1 ? 1 : 0;
  int logm = lm << kBitres;
  int lo = 0, hi = 1 << kAllocSteps;
  for (int it = 0; it < kAllocSteps; ++it) {
    int mid = (lo + hi) >> 1;
    int64_t psum = 0;
    bool done = false;
    for (int j = end - 1; j >= start; --j) {
      int tmp = bits1[j] + ((mid * bits2[j]) >> kAllocSteps);
      if (tmp >= thresh[j] || done) {
        done = true;
        psum += std::min(tmp, cap[j]);
      } else if (tmp >= alloc_floor) {
        psum += alloc_floor;
      }
    }
    if (psum > total)
      hi = mid;
    else
      lo = mid;
  }
  int64_t psum = 0;
  bool done = false;
  int* bits = out->bits;
  for (int j = 0; j < kNbBands; ++j) bits[j] = 0;
  for (int j = end - 1; j >= start; --j) {
    int tmp = bits1[j] + ((lo * bits2[j]) >> kAllocSteps);
    if (tmp < thresh[j] && !done) {
      tmp = tmp >= alloc_floor ? alloc_floor : 0;
    } else {
      done = true;
    }
    tmp = std::min(tmp, cap[j]);
    bits[j] = tmp;
    psum += tmp;
  }

  // Skip decisions, working back from the top band.
  int coded_bands = end;
  while (true) {
    int j = coded_bands - 1;
    if (j <= skip_start) {
      total += skip_rsv;
      break;
    }
    int64_t left = total - psum;
    int64_t percoeff = left / (kEBand5ms[coded_bands] - kEBand5ms[start]);
    left -= (int64_t)(kEBand5ms[coded_bands] - kEBand5ms[start]) * percoeff;
    int64_t rem = std::max<int64_t>(left - (kEBand5ms[j] - kEBand5ms[start]),
                                    0);
    int band_width = kEBand5ms[coded_bands] - kEBand5ms[j];
    int64_t band_bits = bits[j] + percoeff * band_width + rem;
    if (band_bits >= std::max(thresh[j], alloc_floor + (1 << kBitres))) {
      if (dec->dec_bit_logp(1)) break;
      psum += 1 << kBitres;
      band_bits -= 1 << kBitres;
    }
    psum -= bits[j] + intensity_rsv;
    if (intensity_rsv > 0) intensity_rsv = kLog2FracTable[j - start];
    psum += intensity_rsv;
    if (band_bits >= alloc_floor) {
      psum += alloc_floor;
      bits[j] = alloc_floor;
    } else {
      bits[j] = 0;
    }
    coded_bands -= 1;
  }

  int intensity = 0;
  if (intensity_rsv > 0)
    intensity = start + (int)dec->dec_uint(coded_bands + 1 - start);
  if (intensity <= start) {
    total += dual_stereo_rsv;
    dual_stereo_rsv = 0;
  }
  int dual_stereo = dual_stereo_rsv > 0 ? dec->dec_bit_logp(1) : 0;

  int64_t left = total - psum;
  int64_t percoeff = left / (kEBand5ms[coded_bands] - kEBand5ms[start]);
  left -= (int64_t)(kEBand5ms[coded_bands] - kEBand5ms[start]) * percoeff;
  for (int j = start; j < coded_bands; ++j)
    bits[j] += (int)(percoeff * (kEBand5ms[j + 1] - kEBand5ms[j]));
  for (int j = start; j < coded_bands; ++j) {
    int tmp = (int)std::min<int64_t>(left, kEBand5ms[j + 1] - kEBand5ms[j]);
    bits[j] += tmp;
    left -= tmp;
  }

  int* ebits = out->ebits;
  int* fine_priority = out->fine_priority;
  for (int j = 0; j < kNbBands; ++j) { ebits[j] = 0; fine_priority[j] = 0; }
  int balance = 0;
  for (int j = start; j < coded_bands; ++j) {
    int n0 = kEBand5ms[j + 1] - kEBand5ms[j];
    int n = n0 << lm;
    int bit = bits[j] + balance;
    int excess = 0;
    if (n > 1) {
      excess = std::max(bit - cap[j], 0);
      bits[j] = bit - excess;
      int den = c * n + ((c == 2 && n > 2 && !dual_stereo && j < intensity)
                             ? 1 : 0);
      int nclogn = den * (kLogN400[j] + logm);
      int offset = (nclogn >> 1) - den * kFineOffset;
      if (n == 2) offset += den << kBitres >> 2;
      if (bits[j] + offset < (den * 2) << kBitres)
        offset += nclogn >> 2;
      else if (bits[j] + offset < (den * 3) << kBitres)
        offset += nclogn >> 3;
      int eb = std::max(0, bits[j] + offset + (den << (kBitres - 1)));
      eb = (eb / den) >> kBitres;
      if (c * eb > (bits[j] >> kBitres)) eb = bits[j] >> stereo >> kBitres;
      eb = std::min(eb, kMaxFineBits);
      fine_priority[j] = eb * (den << kBitres) >= bits[j] + offset ? 1 : 0;
      bits[j] -= (c * eb) << kBitres;
      ebits[j] = eb;
    } else {
      excess = std::max(0, bit - (c << kBitres));
      bits[j] = bit - excess;
      ebits[j] = 0;
      fine_priority[j] = 1;
    }
    if (excess > 0) {
      int extra_fine = std::min(excess >> (stereo + kBitres),
                                kMaxFineBits - ebits[j]);
      ebits[j] += extra_fine;
      int extra_bits = (extra_fine * c) << kBitres;
      fine_priority[j] = extra_bits >= excess - balance ? 1 : 0;
      excess -= extra_bits;
    }
    balance = excess;
  }

  for (int j = coded_bands; j < end; ++j) {
    ebits[j] = bits[j] >> stereo >> kBitres;
    bits[j] = 0;
    fine_priority[j] = ebits[j] < 1 ? 1 : 0;
  }
  out->coded_bands = coded_bands;
  out->balance = balance;
  out->intensity = intensity;
  out->dual_stereo = dual_stereo;
}

// rate.c clt_compute_allocation twin (decode side).
static void compute_allocation(int start, int end, const int* offsets,
                               const int* cap, int alloc_trim, int total,
                               int c, int lm, RangeDec* dec,
                               Allocation* out) {
  total = std::max(total, 0);
  int skip_start = start;
  int skip_rsv = total >= (1 << kBitres) ? (1 << kBitres) : 0;
  total -= skip_rsv;
  int intensity_rsv = 0, dual_stereo_rsv = 0;
  if (c == 2) {
    intensity_rsv = kLog2FracTable[end - start];
    if (intensity_rsv > total) {
      intensity_rsv = 0;
    } else {
      total -= intensity_rsv;
      if (total >= (1 << kBitres)) {
        dual_stereo_rsv = 1 << kBitres;
        total -= dual_stereo_rsv;
      }
    }
  }

  int thresh[kNbBands], trim_offset[kNbBands];
  for (int j = 0; j < kNbBands; ++j) { thresh[j] = 0; trim_offset[j] = 0; }
  for (int j = start; j < end; ++j) {
    int width = kEBand5ms[j + 1] - kEBand5ms[j];
    thresh[j] = std::max(c << kBitres, (3 * width << lm << kBitres) >> 4);
    trim_offset[j] = (c * width * (alloc_trim - 5 - lm) * (end - j - 1)
                      * (1 << (lm + kBitres))) >> 6;
    if ((width << lm) == 1) trim_offset[j] -= c << kBitres;
  }

  int lo = 1, hi = kBandAllocRows - 1;
  while (lo <= hi) {
    bool done = false;
    int64_t psum = 0;
    int mid = (lo + hi) >> 1;
    for (int j = end - 1; j >= start; --j) {
      int width = kEBand5ms[j + 1] - kEBand5ms[j];
      int bitsj = (c * width * (int)kBandAlloc[mid][j]) << lm >> 2;
      if (bitsj > 0) bitsj = std::max(0, bitsj + trim_offset[j]);
      bitsj += offsets[j];
      if (bitsj >= thresh[j] || done) {
        done = true;
        psum += std::min(bitsj, cap[j]);
      } else if (bitsj >= c << kBitres) {
        psum += c << kBitres;
      }
    }
    if (psum > total)
      hi = mid - 1;
    else
      lo = mid + 1;
  }
  hi = lo;
  lo -= 1;

  int bits1[kNbBands], bits2[kNbBands];
  for (int j = 0; j < kNbBands; ++j) { bits1[j] = 0; bits2[j] = 0; }
  for (int j = start; j < end; ++j) {
    int width = kEBand5ms[j + 1] - kEBand5ms[j];
    int b1 = (c * width * (int)kBandAlloc[lo][j]) << lm >> 2;
    int b2 = hi >= kBandAllocRows
                 ? cap[j]
                 : (c * width * (int)kBandAlloc[hi][j]) << lm >> 2;
    if (b1 > 0) b1 = std::max(0, b1 + trim_offset[j]);
    if (b2 > 0) b2 = std::max(0, b2 + trim_offset[j]);
    if (lo > 0) b1 += offsets[j];
    b2 += offsets[j];
    if (offsets[j] > 0) skip_start = j;
    b2 = std::max(0, b2 - b1);
    bits1[j] = b1;
    bits2[j] = b2;
  }
  interp_bits2pulses(start, end, skip_start, bits1, bits2, thresh, cap,
                     total, skip_rsv, intensity_rsv, dual_stereo_rsv, c, lm,
                     dec, out);
}

// -- fixed-point helpers shared with the reference bit-exactly ---------------

static inline int frac_mul16(int a, int b) {
  int16_t a16 = (int16_t)a, b16 = (int16_t)b;
  return (16384 + (int)a16 * (int)b16) >> 15;
}

static int bitexact_cos(int x) {
  int tmp = (4096 + x * x) >> 13;
  int x2 = tmp;
  x2 = (32767 - x2) + frac_mul16(
      x2, -7651 + frac_mul16(x2, 8277 + frac_mul16(-626, x2)));
  return 1 + x2;
}

static int bitexact_log2tan(int isin, int icos) {
  int lc = ilog((uint32_t)icos);
  int ls = ilog((uint32_t)isin);
  icos <<= 15 - lc;
  isin <<= 15 - ls;
  return (ls - lc) * (1 << 11)
         + frac_mul16(isin, frac_mul16(isin, -2597) + 7932)
         - frac_mul16(icos, frac_mul16(icos, -2597) + 7932);
}

static inline uint32_t isqrt32(uint32_t n) {
  uint32_t r = (uint32_t)std::sqrt((double)n);
  while (r > 0 && r * (uint64_t)r > n) --r;
  while ((r + 1) * (uint64_t)(r + 1) <= n) ++r;
  return r;
}

static inline uint32_t celt_lcg_rand(uint32_t seed) {
  return 1664525u * seed + 1013904223u;
}

// -- signal-domain helpers (float-build twins) --------------------------------

static void haar1(double* x, int n0, int stride) {
  n0 >>= 1;
  for (int i = 0; i < stride; ++i) {
    for (int j = 0; j < n0; ++j) {
      int idx0 = stride * 2 * j + i;
      int idx1 = idx0 + stride;
      double a = celt::kSqrtHalf * x[idx0];
      double b = celt::kSqrtHalf * x[idx1];
      x[idx0] = a + b;
      x[idx1] = a - b;
    }
  }
}

static void deinterleave_hadamard(double* x, int n0, int stride,
                                  bool hadamard) {
  int n = n0 * stride;
  std::vector<double> tmp(n);
  if (hadamard) {
    const int* ordery = kOrdery + (stride - 2);
    for (int i = 0; i < stride; ++i)
      for (int j = 0; j < n0; ++j) tmp[ordery[i] * n0 + j] = x[j * stride + i];
  } else {
    for (int i = 0; i < stride; ++i)
      for (int j = 0; j < n0; ++j) tmp[i * n0 + j] = x[j * stride + i];
  }
  std::memcpy(x, tmp.data(), sizeof(double) * n);
}

static void interleave_hadamard(double* x, int n0, int stride,
                                bool hadamard) {
  int n = n0 * stride;
  std::vector<double> tmp(n);
  if (hadamard) {
    const int* ordery = kOrdery + (stride - 2);
    for (int i = 0; i < stride; ++i)
      for (int j = 0; j < n0; ++j) tmp[j * stride + i] = x[ordery[i] * n0 + j];
  } else {
    for (int i = 0; i < stride; ++i)
      for (int j = 0; j < n0; ++j) tmp[j * stride + i] = x[i * n0 + j];
  }
  std::memcpy(x, tmp.data(), sizeof(double) * n);
}

static void renormalise_vector(double* x, int n, double gain) {
  double e = 0.0;
  for (int j = 0; j < n; ++j) e += x[j] * x[j];
  if (e > 0) {
    double g = gain / std::sqrt(e);
    for (int j = 0; j < n; ++j) x[j] *= g;
  }
}

static void stereo_merge(double* x, double* y, double mid, int n) {
  double xp = 0.0, side = 0.0;
  for (int j = 0; j < n; ++j) {
    xp += y[j] * x[j];
    side += y[j] * y[j];
  }
  xp *= mid;
  double el = mid * mid + side - 2 * xp;
  double er = mid * mid + side + 2 * xp;
  if (er < 6e-4 || el < 6e-4) {
    std::memcpy(y, x, sizeof(double) * n);
    return;
  }
  double lgain = 1.0 / std::sqrt(el);
  double rgain = 1.0 / std::sqrt(er);
  for (int j = 0; j < n; ++j) {
    double l = mid * x[j];
    double r = y[j];
    x[j] = lgain * (l - r);
    y[j] = rgain * (l + r);
  }
}

// -- theta (mid/side or low/high split angle) — twin of compute_theta ---------

struct BandCtx {
  RangeDec* dec;
  int i = 0;
  int intensity;
  int spread;
  int tf_change = 0;
  int64_t remaining_bits = 0;
  uint32_t seed;
  bool disable_inv = false;
};

struct SplitCtx {
  int inv, imid, iside, delta, itheta, qalloc;
};

static int compute_qn(int n, int b, int offset, int pulse_cap, bool stereo) {
  int n2 = 2 * n - 1;
  if (stereo && n == 2) n2 -= 1;
  int qb = (b + n2 * offset) / n2;
  qb = std::min(b - pulse_cap - (4 << kBitres), qb);
  qb = std::min(8 << kBitres, qb);
  if (qb < (1 << kBitres >> 1)) return 1;
  int qn = kExp2Table8[qb & 0x7] >> (14 - (qb >> kBitres));
  return ((qn + 1) >> 1) << 1;
}

// Returns the updated b; fill updated through *fill.
static int compute_theta(BandCtx* ctx, SplitCtx* sctx, int n, int b,
                         int b_blocks, int b0, int lm, bool stereo,
                         int* fill) {
  RangeDec* dec = ctx->dec;
  int i = ctx->i;
  int itheta = 0;
  int inv = 0;
  int pulse_cap = kLogN400[i] + lm * (1 << kBitres);
  int offset = (pulse_cap >> 1)
               - (stereo && n == 2 ? kQThetaOffsetTwophase : kQThetaOffset);
  int qn = compute_qn(n, b, offset, pulse_cap, stereo);
  if (stereo && i >= ctx->intensity) qn = 1;
  int64_t tell = dec->tell_frac();
  if (qn != 1) {
    if (stereo && n > 2) {
      int p0 = 3;
      int x0 = qn / 2;
      uint32_t ft = (uint32_t)(p0 * (x0 + 1) + x0);
      uint32_t fs = dec->decode(ft);
      int x;
      if (fs < (uint32_t)((x0 + 1) * p0))
        x = (int)(fs / (uint32_t)p0);
      else
        x = x0 + 1 + (int)(fs - (uint32_t)((x0 + 1) * p0));
      uint32_t fl = x <= x0 ? (uint32_t)(p0 * x)
                            : (uint32_t)((x - 1 - x0) + (x0 + 1) * p0);
      uint32_t fh = x <= x0 ? (uint32_t)(p0 * (x + 1))
                            : (uint32_t)((x - x0) + (x0 + 1) * p0);
      dec->update(fl, fh, ft);
      itheta = x;
    } else if (b0 > 1 || stereo) {
      itheta = (int)dec->dec_uint(qn + 1);
    } else {
      // triangular pdf
      uint32_t ft = (uint32_t)(((qn >> 1) + 1) * ((qn >> 1) + 1));
      uint32_t fm = dec->decode(ft);
      uint32_t fs, fl;
      if (fm < (uint32_t)((qn >> 1) * ((qn >> 1) + 1) >> 1)) {
        itheta = (int)((isqrt32(8 * fm + 1) - 1) >> 1);
        fs = itheta + 1;
        fl = (uint32_t)(itheta * (itheta + 1) >> 1);
      } else {
        itheta = (2 * (qn + 1) - (int)isqrt32(8 * (ft - fm - 1) + 1)) >> 1;
        fs = qn + 1 - itheta;
        fl = ft - (uint32_t)((qn + 1 - itheta) * (qn + 2 - itheta) >> 1);
      }
      dec->update(fl, fl + fs, ft);
    }
    itheta = (int)(((int64_t)itheta * 16384) / qn);
  } else if (stereo) {
    if (b > 2 << kBitres && ctx->remaining_bits > 2 << kBitres)
      inv = dec->dec_bit_logp(2);
    else
      inv = 0;
    if (ctx->disable_inv) inv = 0;  // the bit is still consumed above
    itheta = 0;
  }
  int qalloc = (int)(dec->tell_frac() - tell);
  b -= qalloc;

  int imid, iside, delta;
  if (itheta == 0) {
    imid = 32767;
    iside = 0;
    *fill &= (1 << b_blocks) - 1;
    delta = -16384;
  } else if (itheta == 16384) {
    imid = 0;
    iside = 32767;
    *fill &= ((1 << b_blocks) - 1) << b_blocks;
    delta = 16384;
  } else {
    imid = bitexact_cos(itheta);
    iside = bitexact_cos(16384 - itheta);
    delta = frac_mul16((n - 1) << 7, bitexact_log2tan(iside, imid));
  }

  sctx->inv = inv;
  sctx->imid = imid;
  sctx->iside = iside;
  sctx->delta = delta;
  sctx->itheta = itheta;
  sctx->qalloc = qalloc;
  return b;
}

// -- band shape decoding (bands.c quant_* family, decode side) ----------------

static int quant_band(BandCtx* ctx, double* x, int n, int b, int b_blocks,
                      double* lowband, int lm, double* lowband_out,
                      double gain, double* lowband_scratch, int fill);

// One-sample band: a sign per channel (quant_band_n1 twin).
static int quant_band_n1(BandCtx* ctx, double* x, double* y, int b,
                         double* lowband_out) {
  double* arrs[2] = {x, y};
  for (int a = 0; a < 2; ++a) {
    double* arr = arrs[a];
    if (arr == nullptr) continue;
    int sign = 0;
    if (ctx->remaining_bits >= 1 << kBitres) {
      sign = (int)ctx->dec->dec_bits(1);
      ctx->remaining_bits -= 1 << kBitres;
      b -= 1 << kBitres;
    }
    arr[0] = sign ? -1.0 : 1.0;
  }
  if (lowband_out != nullptr) lowband_out[0] = x[0];
  return 1;
}

// Recursive split-or-PVQ decode of one (sub)band (quant_partition twin).
static int quant_partition(BandCtx* ctx, double* x, int n, int b,
                           int b_blocks, double* lowband, int lm,
                           double gain, int fill) {
  RangeDec* dec = ctx->dec;
  int i = ctx->i;
  int b0 = b_blocks;
  const int* cache = cache_row(i, lm);
  if (lm != -1 && b > cache[cache[0]] + 12 && n > 2) {
    n >>= 1;
    double* y = x + n;
    lm -= 1;
    if (b_blocks == 1) fill = (fill & 1) | (fill << 1);
    b_blocks = (b_blocks + 1) >> 1;

    SplitCtx sctx;
    b = compute_theta(ctx, &sctx, n, b, b_blocks, b0, lm, false, &fill);
    int imid = sctx.imid, iside = sctx.iside;
    int delta = sctx.delta, itheta = sctx.itheta, qalloc = sctx.qalloc;
    double mid = imid / 32768.0;
    double side = iside / 32768.0;

    if (b0 > 1 && (itheta & 0x3FFF)) {
      if (itheta > 8192)
        delta -= delta >> (4 - lm);
      else
        delta = std::min(0, delta + (n << kBitres >> (5 - lm)));
    }
    int mbits = std::max(0, std::min(b, (b - delta) / 2));
    int sbits = b - mbits;
    ctx->remaining_bits -= qalloc;

    double* next_lowband2 = lowband != nullptr ? lowband + n : nullptr;
    int64_t rebalance = ctx->remaining_bits;
    int cm;
    if (mbits >= sbits) {
      cm = quant_partition(ctx, x, n, mbits, b_blocks, lowband, lm,
                           gain * mid, fill);
      rebalance = mbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << kBitres && itheta != 0)
        sbits += (int)(rebalance - (3 << kBitres));
      cm |= quant_partition(ctx, y, n, sbits, b_blocks, next_lowband2, lm,
                            gain * side, fill >> b_blocks)
            << (b0 >> 1);
    } else {
      cm = quant_partition(ctx, y, n, sbits, b_blocks, next_lowband2, lm,
                           gain * side, fill >> b_blocks)
           << (b0 >> 1);
      rebalance = sbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << kBitres && itheta != 16384)
        mbits += (int)(rebalance - (3 << kBitres));
      cm |= quant_partition(ctx, x, n, mbits, b_blocks, lowband, lm,
                            gain * mid, fill);
    }
    return cm;
  }

  // Leaf: PVQ (or folding when no pulses fit).
  int q = bits2pulses(i, lm, b);
  int curr_bits = pulses2bits(i, lm, q);
  ctx->remaining_bits -= curr_bits;
  while (ctx->remaining_bits < 0 && q > 0) {
    ctx->remaining_bits += curr_bits;
    q -= 1;
    curr_bits = pulses2bits(i, lm, q);
    ctx->remaining_bits -= curr_bits;
  }
  if (q != 0)
    return alg_unquant(dec, x, n, get_pulses(q), ctx->spread, b_blocks,
                       gain);
  // No pulses: noise fill or spectral folding.
  int cm_mask = (1 << b_blocks) - 1;
  fill &= cm_mask;
  if (!fill) {
    std::memset(x, 0, sizeof(double) * n);
    return 0;
  }
  int cm;
  if (lowband == nullptr) {
    uint32_t seed = ctx->seed;
    for (int j = 0; j < n; ++j) {
      seed = celt_lcg_rand(seed);
      x[j] = (double)((int32_t)seed >> 20);
    }
    ctx->seed = seed;
    cm = cm_mask;
  } else {
    uint32_t seed = ctx->seed;
    for (int j = 0; j < n; ++j) {
      seed = celt_lcg_rand(seed);
      double tmp = 1.0 / 256.0;
      x[j] = (seed & 0x8000) ? lowband[j] + tmp : lowband[j] - tmp;
    }
    ctx->seed = seed;
    cm = fill;
  }
  renormalise_vector(x, n, gain);
  return cm;
}

// Mono band decode: tf pre/post transforms around quant_partition.
static int quant_band(BandCtx* ctx, double* x, int n, int b, int b_blocks,
                      double* lowband, int lm, double* lowband_out,
                      double gain, double* lowband_scratch, int fill) {
  int n0 = n;
  int n_b = n / b_blocks;
  int b0 = b_blocks;
  int time_divide = 0;
  int recombine = 0;
  bool long_blocks = b0 == 1;
  int tf_change = ctx->tf_change;

  if (n == 1) return quant_band_n1(ctx, x, nullptr, b, lowband_out);

  if (tf_change > 0) recombine = tf_change;
  if (lowband_scratch != nullptr && lowband != nullptr &&
      (recombine || ((n_b & 1) == 0 && tf_change < 0) || b0 > 1)) {
    std::memcpy(lowband_scratch, lowband, sizeof(double) * n);
    lowband = lowband_scratch;
  }

  for (int k = 0; k < recombine; ++k) {
    if (lowband != nullptr) haar1(lowband, n >> k, 1 << k);
    fill = kBitInterleave[fill & 0xF] | (kBitInterleave[fill >> 4] << 2);
  }
  b_blocks >>= recombine;
  n_b <<= recombine;

  while ((n_b & 1) == 0 && tf_change < 0) {
    if (lowband != nullptr) haar1(lowband, n_b, b_blocks);
    fill |= fill << b_blocks;
    b_blocks <<= 1;
    n_b >>= 1;
    time_divide += 1;
    tf_change += 1;
  }
  b0 = b_blocks;
  int n_b0 = n_b;

  if (b0 > 1 && lowband != nullptr)
    deinterleave_hadamard(lowband, n_b >> recombine, b0 << recombine,
                          long_blocks);

  int cm = quant_partition(ctx, x, n, b, b_blocks, lowband, lm, gain, fill);

  // resynthesis (always, we are a decoder)
  if (b0 > 1)
    interleave_hadamard(x, n_b >> recombine, b0 << recombine, long_blocks);
  n_b = n_b0;
  b_blocks = b0;
  for (int t = 0; t < time_divide; ++t) {
    b_blocks >>= 1;
    n_b <<= 1;
    cm |= cm >> b_blocks;
    haar1(x, n_b, b_blocks);
  }
  for (int k = 0; k < recombine; ++k) {
    cm = kBitDeinterleave[cm];
    haar1(x, n0 >> k, 1 << k);
  }
  b_blocks <<= recombine;

  if (lowband_out != nullptr) {
    double nrm = std::sqrt((double)n0);
    for (int j = 0; j < n0; ++j) lowband_out[j] = nrm * x[j];
  }
  return cm & ((1 << b_blocks) - 1);
}

// Stereo band decode (quant_band_stereo twin, decode side).
static int quant_band_stereo(BandCtx* ctx, double* x, double* y, int n,
                             int b, int b_blocks, double* lowband, int lm,
                             double* lowband_out, double* lowband_scratch,
                             int fill) {
  RangeDec* dec = ctx->dec;
  if (n == 1) return quant_band_n1(ctx, x, y, b, lowband_out);
  int orig_fill = fill;

  SplitCtx sctx;
  b = compute_theta(ctx, &sctx, n, b, b_blocks, b_blocks, lm, true, &fill);
  int inv = sctx.inv, imid = sctx.imid, iside = sctx.iside;
  int delta = sctx.delta, itheta = sctx.itheta, qalloc = sctx.qalloc;
  double mid = imid / 32768.0;
  double side = iside / 32768.0;
  int cm;

  if (n == 2) {
    int mbits = b;
    int sbits = 0;
    if (itheta != 0 && itheta != 16384) sbits = 1 << kBitres;
    mbits -= sbits;
    bool swap = itheta > 8192;
    ctx->remaining_bits -= qalloc + sbits;
    double* x2 = swap ? y : x;
    double* y2 = swap ? x : y;
    int sign = sbits ? (int)dec->dec_bits(1) : 0;
    sign = 1 - 2 * sign;
    cm = quant_band(ctx, x2, n, mbits, b_blocks, lowband, lm, lowband_out,
                    1.0, lowband_scratch, orig_fill);
    y2[0] = -sign * x2[1];
    y2[1] = sign * x2[0];
    x[0] *= mid;
    x[1] *= mid;
    y[0] *= side;
    y[1] *= side;
    double tmp = x[0];
    x[0] = tmp - y[0];
    y[0] = tmp + y[0];
    tmp = x[1];
    x[1] = tmp - y[1];
    y[1] = tmp + y[1];
  } else {
    int mbits = std::max(0, std::min(b, (b - delta) / 2));
    int sbits = b - mbits;
    ctx->remaining_bits -= qalloc;
    int64_t rebalance = ctx->remaining_bits;
    if (mbits >= sbits) {
      cm = quant_band(ctx, x, n, mbits, b_blocks, lowband, lm, lowband_out,
                      1.0, lowband_scratch, fill);
      rebalance = mbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << kBitres && itheta != 0)
        sbits += (int)(rebalance - (3 << kBitres));
      cm |= quant_band(ctx, y, n, sbits, b_blocks, nullptr, lm, nullptr,
                       side, nullptr, fill >> b_blocks);
    } else {
      cm = quant_band(ctx, y, n, sbits, b_blocks, nullptr, lm, nullptr,
                      side, nullptr, fill >> b_blocks);
      rebalance = sbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << kBitres && itheta != 16384)
        mbits += (int)(rebalance - (3 << kBitres));
      cm |= quant_band(ctx, x, n, mbits, b_blocks, lowband, lm, lowband_out,
                       1.0, lowband_scratch, fill);
    }
  }

  if (n != 2) stereo_merge(x, y, mid, n);
  if (inv)
    for (int j = 0; j < n; ++j) y[j] = -y[j];
  return cm;
}

// quant_all_bands twin (decode side). Returns the updated LCG seed.
static uint32_t quant_all_bands(int start, int end, double* x_full,
                                double* y_full, uint8_t* collapse_masks,
                                const int* pulses, int short_blocks,
                                int spread, int dual_stereo, int intensity,
                                const int* tf_res, int64_t total_bits,
                                int64_t balance, RangeDec* dec, int lm,
                                int coded_bands, uint32_t seed,
                                bool disable_inv, double* scratch_base) {
  int c = y_full != nullptr ? 2 : 1;
  int m = 1 << lm;
  int b_big = short_blocks ? m : 1;
  int norm_offset = m * kEBand5ms[start];
  int norm_len = m * kEBand5ms[kNbBands - 1] - norm_offset;
  std::vector<double> norm_buf(norm_len, 0.0);
  std::vector<double> norm2_buf(c == 2 ? norm_len : 0, 0.0);
  double* norm = norm_buf.data();
  double* norm2 = c == 2 ? norm2_buf.data() : norm;

  BandCtx ctx;
  ctx.dec = dec;
  ctx.intensity = intensity;
  ctx.spread = spread;
  ctx.seed = seed;
  ctx.disable_inv = disable_inv;
  int lowband_offset = 0;
  bool update_lowband = true;

  for (int i = start; i < end; ++i) {
    ctx.i = i;
    bool last = i == end - 1;
    double* x = x_full + m * kEBand5ms[i];
    double* y = y_full != nullptr ? y_full + m * kEBand5ms[i] : nullptr;
    int n = m * kEBand5ms[i + 1] - m * kEBand5ms[i];
    int64_t tell = dec->tell_frac();

    if (i != start) balance -= tell;
    int64_t remaining_bits = total_bits - tell - 1;
    ctx.remaining_bits = remaining_bits;
    int b;
    if (i <= coded_bands - 1) {
      int64_t curr_balance = balance / std::min(3, coded_bands - i);
      b = (int)std::max<int64_t>(
          0, std::min<int64_t>(
                 16383, std::min<int64_t>(remaining_bits + 1,
                                          pulses[i] + curr_balance)));
    } else {
      b = 0;
    }

    if ((m * kEBand5ms[i] - n >= m * kEBand5ms[start] || i == start + 1) &&
        (update_lowband || lowband_offset == 0))
      lowband_offset = i;
    // special_hybrid_folding only applies when start != 0 (hybrid mode,
    // not reachable from CELT-only packets).

    ctx.tf_change = tf_res[i];
    double* lowband_scratch = scratch_base;
    if (last) lowband_scratch = nullptr;

    int effective_lowband;
    int x_cm, y_cm;
    if (lowband_offset != 0 &&
        (spread != kSpreadAggressive || b_big > 1 || tf_res[i] < 0)) {
      effective_lowband = std::max(
          0, m * kEBand5ms[lowband_offset] - norm_offset - n);
      int fold_start = lowband_offset;
      while (true) {
        fold_start -= 1;
        if (m * kEBand5ms[fold_start] <= effective_lowband + norm_offset)
          break;
      }
      int fold_end = lowband_offset - 1;
      while (true) {
        fold_end += 1;
        if (!(fold_end < i &&
              m * kEBand5ms[fold_end] < effective_lowband + norm_offset + n))
          break;
      }
      x_cm = 0;
      y_cm = 0;
      int fold_i = fold_start;
      while (true) {
        x_cm |= (int)collapse_masks[fold_i * c + 0];
        y_cm |= (int)collapse_masks[fold_i * c + c - 1];
        fold_i += 1;
        if (fold_i >= fold_end) break;
      }
    } else {
      effective_lowband = -1;
      x_cm = y_cm = (1 << b_big) - 1;
    }

    if (dual_stereo && i == intensity) {
      dual_stereo = 0;
      int q = m * kEBand5ms[i] - norm_offset;
      for (int j = 0; j < q; ++j) norm[j] = 0.5 * (norm[j] + norm2[j]);
    }

    double* lowband =
        effective_lowband != -1 ? norm + effective_lowband : nullptr;
    double* lowband_out =
        last ? nullptr : norm + (m * kEBand5ms[i] - norm_offset);
    if (dual_stereo) {
      double* lowband2 =
          effective_lowband != -1 ? norm2 + effective_lowband : nullptr;
      double* lowband2_out =
          last ? nullptr : norm2 + (m * kEBand5ms[i] - norm_offset);
      x_cm = quant_band(&ctx, x, n, b / 2, b_big, lowband, lm, lowband_out,
                        1.0, lowband_scratch, x_cm);
      y_cm = quant_band(&ctx, y, n, b / 2, b_big, lowband2, lm,
                        lowband2_out, 1.0, lowband_scratch, y_cm);
    } else if (y != nullptr) {
      x_cm = quant_band_stereo(&ctx, x, y, n, b, b_big, lowband, lm,
                               lowband_out, lowband_scratch, x_cm | y_cm);
      y_cm = x_cm;
    } else {
      x_cm = quant_band(&ctx, x, n, b, b_big, lowband, lm, lowband_out,
                        1.0, lowband_scratch, x_cm);
      y_cm = x_cm;
    }
    collapse_masks[i * c + 0] = (uint8_t)(x_cm & 0xFF);
    collapse_masks[i * c + c - 1] = (uint8_t)(y_cm & 0xFF);
    balance += pulses[i] + tell;
    update_lowband = b > (n << kBitres);
  }
  return ctx.seed;
}

// anti_collapse twin (float build).
static void anti_collapse(double* x_full, const uint8_t* collapse_masks,
                          int lm, int c, int size, int start, int end,
                          const float old_e[2][21],
                          const float prev1_log_e[2][21],
                          const float prev2_log_e[2][21], const int* pulses,
                          uint32_t seed) {
  for (int i = start; i < end; ++i) {
    int n0 = kEBand5ms[i + 1] - kEBand5ms[i];
    int depth = ((1 + pulses[i]) / n0) >> lm;
    double thresh = 0.5 * std::exp2(-0.125 * depth);
    double sqrt_1 = 1.0 / std::sqrt((double)(n0 << lm));
    for (int ch = 0; ch < c; ++ch) {
      double prev1 = (double)prev1_log_e[ch][i];
      double prev2 = (double)prev2_log_e[ch][i];
      if (c == 1) {
        prev1 = std::max(prev1, (double)prev1_log_e[1][i]);
        prev2 = std::max(prev2, (double)prev2_log_e[1][i]);
      }
      double e_diff = std::max(
          0.0, (double)old_e[ch][i] - std::min(prev1, prev2));
      double r = 2.0 * std::exp2(-e_diff);
      if (lm == 3) r *= 1.41421356;
      r = std::min(thresh, r) * sqrt_1;
      double* xb = x_full + ch * size + (kEBand5ms[i] << lm);
      bool renorm = false;
      int mask = (int)collapse_masks[i * c + ch];
      for (int k = 0; k < (1 << lm); ++k) {
        if (!(mask & (1 << k))) {
          for (int j = 0; j < n0; ++j) {
            seed = celt_lcg_rand(seed);
            xb[(j << lm) + k] = (seed & 0x8000) ? r : -r;
          }
          renorm = true;
        }
      }
      if (renorm) renormalise_vector(xb, n0 << lm, 1.0);
    }
  }
}

}  // namespace bands

// ---------------------------------------------------------------------------
// Frame decoder — twin of _celt_frame.py (celt_decoder.c semantics,
// 48 kHz mode, float build).
// ---------------------------------------------------------------------------

// celt.c comb_filter tapset gains (3 tapsets x 3 taps).
static const double kPfGains[3][3] = {
    {0.3066406250, 0.2170410156, 0.1296386719},
    {0.4638671875, 0.2680664062, 0.0},
    {0.7998046875, 0.1000976562, 0.0}};

// y[i] = x[i] + g0*x[i-T] + g1*(x[i-T+1]+x[i-T-1]) + g2*(x[i-T+2]+x[i-T-2])
// in place; the sequential loop matches the twin's chunked semantics (an
// IIR when T < n: reads at p-T+2 < p always see already-updated samples).
static void comb_const(double* sig, int64_t off, int t, int n, double g0,
                       double g1, double g2) {
  for (int i = 0; i < n; ++i) {
    int64_t p = off + i;
    sig[p] += g0 * sig[p - t]
              + g1 * (sig[p - t + 1] + sig[p - t - 1])
              + g2 * (sig[p - t + 2] + sig[p - t - 2]);
  }
}

static void comb_filter(double* sig, int64_t off, int t0, int t1, int n,
                        double g0, double g1, int tapset0, int tapset1) {
  if (g0 == 0.0 && g1 == 0.0) return;
  t0 = std::max(t0, kCombMinPeriod);
  t1 = std::max(t1, kCombMinPeriod);
  double g00 = g0 * kPfGains[tapset0][0];
  double g01 = g0 * kPfGains[tapset0][1];
  double g02 = g0 * kPfGains[tapset0][2];
  double g10 = g1 * kPfGains[tapset1][0];
  double g11 = g1 * kPfGains[tapset1][1];
  double g12 = g1 * kPfGains[tapset1][2];
  int overlap = 0;
  if (!(g0 == g1 && t0 == t1 && tapset0 == tapset1)) {
    overlap = std::min(kOverlap, n);
    for (int i = 0; i < overlap; ++i) {
      double w = (double)kWindow120[i];
      double f = w * w;
      int64_t p = off + i;
      double oldv = g00 * sig[p - t0]
                    + g01 * (sig[p - t0 + 1] + sig[p - t0 - 1])
                    + g02 * (sig[p - t0 + 2] + sig[p - t0 - 2]);
      double newv = g10 * sig[p - t1]
                    + g11 * (sig[p - t1 + 1] + sig[p - t1 - 1])
                    + g12 * (sig[p - t1 + 2] + sig[p - t1 - 2]);
      sig[p] += (1.0 - f) * oldv + f * newv;
    }
  }
  if (g1 == 0.0) return;
  comb_const(sig, off + overlap, t1, n - overlap, g10, g11, g12);
}

// IMDCT synthesis basis, rows [pad, pad+nb+OVERLAP) of the (2*nb, nb)
// unnormalized direct form (twin of _imdct_matrix + the xf slice): the
// synthesis pair of the reference's 4/N-scaled forward transform, so
// backward gain is exactly 1. Static per block size, built once.
struct ImdctBasis {
  int nb = 0;
  std::vector<double> m;  // (nb + kOverlap) x nb, row-major
};

static const ImdctBasis* imdct_basis(int nb) {
  static ImdctBasis bases[4];  // nb = 120 << {0,1,2,3}
  static std::once_flag once[4];
  int idx = ilog((uint32_t)(nb / kShortMdct)) - 1;
  std::call_once(once[idx], [nb, idx] {
    ImdctBasis* b = &bases[idx];
    b->nb = nb;
    int rows = nb + kOverlap;
    int pad = (nb - kOverlap) >> 1;
    b->m.resize((size_t)rows * nb);
    for (int r = 0; r < rows; ++r) {
      double nn = (double)(r + pad) + 0.5 + nb / 2.0;
      for (int k = 0; k < nb; ++k)
        b->m[(size_t)r * nb + k] = std::cos(M_PI / nb * nn * (k + 0.5));
    }
  });
  return &bases[idx];
}

// The nonzero span (length nb+OVERLAP) of the low-overlap window.
static void window_nonzero(int nb, double* w) {
  for (int i = 0; i < nb + kOverlap; ++i) w[i] = 1.0;
  for (int i = 0; i < kOverlap; ++i) {
    w[i] = (double)kWindow120[i];
    w[nb + i] = (double)kWindow120[kOverlap - 1 - i];
  }
}

struct CeltDecoder {
  int cc;
  bool disable_inv;
  float old_band_e[2][kNbBands] = {};
  float old_log_e[2][kNbBands];
  float old_log_e2[2][kNbBands];
  uint32_t rng = 0;
  uint32_t final_range = 0;
  double preemph_mem[2] = {0.0, 0.0};
  std::vector<double> sig_hist;  // cc * kDecodeBuffer
  std::vector<double> ola_tail;  // cc * kOverlap
  int pf_period = 0, pf_period_old = 0;
  double pf_gain = 0.0, pf_gain_old = 0.0;
  int pf_tapset = 0, pf_tapset_old = 0;

  explicit CeltDecoder(int channels)
      : cc(channels),
        disable_inv(channels == 1),
        sig_hist((size_t)channels * kDecodeBuffer, 0.0),
        ola_tail((size_t)channels * kOverlap, 0.0) {
    for (int ch = 0; ch < 2; ++ch)
      for (int i = 0; i < kNbBands; ++i) {
        old_log_e[ch][i] = -28.0f;
        old_log_e2[ch][i] = -28.0f;
      }
  }

  // IMDCT + windowed overlap-add for one channel (twin of _synth_channel).
  void synth_channel(int ch, const float* freq, int n, int nb, int b,
                     double* out) {
    std::vector<double> syn((size_t)n + kOverlap, 0.0);
    for (int i = 0; i < kOverlap; ++i)
      syn[i] += ola_tail[(size_t)ch * kOverlap + i];
    std::vector<double> wnz((size_t)nb + kOverlap);
    window_nonzero(nb, wnz.data());
    const ImdctBasis* basis = imdct_basis(nb);
    std::vector<double> spec(nb);
    for (int blk = 0; blk < b; ++blk) {
      for (int k = 0; k < nb; ++k) spec[k] = (double)freq[blk + k * b];
      for (int r = 0; r < nb + kOverlap; ++r) {
        const double* row = basis->m.data() + (size_t)r * nb;
        double acc = 0.0;
        for (int k = 0; k < nb; ++k) acc += row[k] * spec[k];
        syn[(size_t)blk * nb + r] += wnz[r] * acc;
      }
    }
    for (int i = 0; i < kOverlap; ++i)
      ola_tail[(size_t)ch * kOverlap + i] = syn[(size_t)n + i];
    std::memcpy(out, syn.data(), sizeof(double) * n);
  }

  // Decode one CELT frame -> (n, cc) float PCM, interleaved. rc 0 ok.
  int decode_frame(const uint8_t* data, int64_t len, int n,
                   int stream_channels, int end_band, float* pcm_out) {
    int lm = ilog((uint32_t)(n / kShortMdct)) - 1;
    if ((kShortMdct << lm) != n || lm < 0 || lm > kMaxLm) return -40;
    int c = stream_channels;
    int m = 1 << lm;
    int start = 0, end = end_band;

    RangeDec dec(data, len);
    int64_t total_bits = len * 8;
    auto& old_e = old_band_e;

    int64_t tell = dec.tell();
    int silence = 0;
    if (tell >= total_bits)
      silence = 1;
    else if (tell == 1)
      silence = dec.dec_bit_logp(15);
    if (silence) {
      // Pretend we've read all the bits: every flag below defaults.
      dec.nbits_total += total_bits - dec.tell();
      tell = total_bits;
    }

    double new_pf_gain = 0.0;
    int new_pf_period = 0;
    int new_pf_tapset = 0;
    if (start == 0 && tell + 16 <= total_bits) {
      if (dec.dec_bit_logp(1)) {
        int octave = (int)dec.dec_uint(6);
        new_pf_period = (16 << octave) + (int)dec.dec_bits(4 + octave) - 1;
        int qg = (int)dec.dec_bits(3);
        if (dec.tell() + 2 <= total_bits)
          new_pf_tapset = dec.dec_icdf(kTapsetIcdf, 2);
        new_pf_gain = 0.09375 * (qg + 1);
      }
      tell = dec.tell();
    }

    int is_transient = 0;
    if (lm > 0 && tell + 3 <= total_bits) {
      is_transient = dec.dec_bit_logp(3);
      tell = dec.tell();
    }
    int short_blocks = is_transient ? m : 0;

    bool intra = tell + 3 <= total_bits ? dec.dec_bit_logp(3) != 0 : false;
    unquant_coarse_energy(start, end, old_e, intra, &dec, c, lm);
    int tf_res[kNbBands];
    bands::tf_decode(start, end, is_transient != 0, lm, &dec, tf_res);
    tell = dec.tell();
    int spread = kSpreadNormal;
    if (tell + 4 <= total_bits) spread = dec.dec_icdf(kSpreadIcdf, 5);

    int cap[kNbBands];
    bands::init_caps(lm, c, cap);
    int offsets[kNbBands] = {};
    int dynalloc_logp = 6;
    int64_t total_bits_q3 = total_bits << kBitres;
    int64_t tell_q3 = dec.tell_frac();
    for (int i = start; i < end; ++i) {
      int width = c * (kEBand5ms[i + 1] - kEBand5ms[i]) << lm;
      int quanta = std::min(width << kBitres,
                            std::max(6 << kBitres, width));
      int dynalloc_loop_logp = dynalloc_logp;
      int boost = 0;
      while (tell_q3 + ((int64_t)dynalloc_loop_logp << kBitres)
                 < total_bits_q3
             && boost < cap[i]) {
        int flag = dec.dec_bit_logp(dynalloc_loop_logp);
        tell_q3 = dec.tell_frac();
        if (!flag) break;
        boost += quanta;
        total_bits_q3 -= quanta;
        dynalloc_loop_logp = 1;
      }
      offsets[i] = boost;
      if (boost > 0) dynalloc_logp = std::max(2, dynalloc_logp - 1);
    }

    int alloc_trim = 5;
    if (tell_q3 + (6 << kBitres) <= total_bits_q3)
      alloc_trim = dec.dec_icdf(kTrimIcdf, 7);

    int64_t bits = (len * 8 << kBitres) - dec.tell_frac() - 1;
    int anti_collapse_rsv =
        (is_transient && lm >= 2 && bits >= ((int64_t)lm + 2) << kBitres)
            ? (1 << kBitres) : 0;
    bits -= anti_collapse_rsv;
    bands::Allocation alloc;
    bands::compute_allocation(start, end, offsets, cap, alloc_trim,
                              (int)bits, c, lm, &dec, &alloc);

    unquant_fine_energy(start, end, old_e, alloc.ebits, &dec, c);

    std::vector<double> x_full((size_t)c * m * kShortMdct, 0.0);
    double* x = x_full.data();
    double* y = c == 2 ? x_full.data() + (size_t)m * kShortMdct : nullptr;
    uint8_t collapse_masks[kNbBands * 2] = {};
    // The twin's lowband_scratch alias: x_full[m * eBands[nbEBands-1]:].
    double* scratch_base = x_full.data() + (size_t)m * kEBand5ms[kNbBands - 1];
    rng = bands::quant_all_bands(
        start, end, x, y, collapse_masks, alloc.bits, short_blocks, spread,
        alloc.dual_stereo, alloc.intensity, tf_res,
        len * (8 << kBitres) - anti_collapse_rsv, alloc.balance, &dec, lm,
        alloc.coded_bands, rng, disable_inv, scratch_base);

    int anti_collapse_on = 0;
    if (anti_collapse_rsv > 0) anti_collapse_on = (int)dec.dec_bits(1);
    unquant_energy_finalise(start, end, old_e, alloc.ebits,
                            alloc.fine_priority, len * 8 - dec.tell(), &dec,
                            c);
    if (anti_collapse_on)
      bands::anti_collapse(x_full.data(), collapse_masks, lm, c, n, start,
                           end, old_e, old_log_e, old_log_e2, alloc.bits,
                           rng);
    if (silence)
      for (int ch = 0; ch < 2; ++ch)
        for (int i = 0; i < kNbBands; ++i) old_e[ch][i] = -28.0f;

    // Synthesis: denormalise + IMDCT/OLA per output channel.
    int nb = is_transient ? kShortMdct : kShortMdct << lm;
    int b_blk = is_transient ? m : 1;
    std::vector<double> out((size_t)cc * n);
    std::vector<float> freq(n);
    if (cc == 2 && c == 1) {
      denormalise_bands(x, old_e[0], start, end, m, n, silence != 0,
                        freq.data());
      for (int ch = 0; ch < 2; ++ch)
        synth_channel(ch, freq.data(), n, nb, b_blk,
                      out.data() + (size_t)ch * n);
    } else if (cc == 1 && c == 2) {
      std::vector<float> f1(n);
      denormalise_bands(x, old_e[0], start, end, m, n, silence != 0,
                        freq.data());
      denormalise_bands(y, old_e[1], start, end, m, n, silence != 0,
                        f1.data());
      // np scalar*float32 stays float32 in the twin: match in float.
      for (int j = 0; j < n; ++j) freq[j] = 0.5f * (freq[j] + f1[j]);
      synth_channel(0, freq.data(), n, nb, b_blk, out.data());
    } else {
      for (int ch = 0; ch < cc; ++ch) {
        const double* xc = ch == 0 ? x : y;
        denormalise_bands(xc, old_e[ch], start, end, m, n, silence != 0,
                          freq.data());
        synth_channel(ch, freq.data(), n, nb, b_blk,
                      out.data() + (size_t)ch * n);
      }
    }

    // Pitch postfilter over the synthesized frame, with history.
    for (int ch = 0; ch < cc; ++ch) {
      std::vector<double> sig((size_t)kDecodeBuffer + n);
      std::memcpy(sig.data(), sig_hist.data() + (size_t)ch * kDecodeBuffer,
                  sizeof(double) * kDecodeBuffer);
      std::memcpy(sig.data() + kDecodeBuffer, out.data() + (size_t)ch * n,
                  sizeof(double) * n);
      int64_t off = kDecodeBuffer;
      int p_old = std::max(pf_period_old, kCombMinPeriod);
      int p_cur = std::max(pf_period, kCombMinPeriod);
      comb_filter(sig.data(), off, p_old, p_cur, kShortMdct, pf_gain_old,
                  pf_gain, pf_tapset_old, pf_tapset);
      if (lm != 0)
        comb_filter(sig.data(), off + kShortMdct, p_cur, new_pf_period,
                    n - kShortMdct, pf_gain, new_pf_gain, pf_tapset,
                    new_pf_tapset);
      std::memcpy(sig_hist.data() + (size_t)ch * kDecodeBuffer,
                  sig.data() + sig.size() - kDecodeBuffer,
                  sizeof(double) * kDecodeBuffer);
      // Deemphasis (preemph coef 0.85, float build).
      double mem = preemph_mem[ch];
      for (int j = 0; j < n; ++j) {
        double tmp = sig[off + j] + mem;
        mem = kPreemph * tmp;
        pcm_out[(size_t)j * cc + ch] = (float)(tmp / kSigScale);
      }
      preemph_mem[ch] = mem;
    }

    pf_period_old = pf_period;
    pf_gain_old = pf_gain;
    pf_tapset_old = pf_tapset;
    pf_period = new_pf_period;
    pf_gain = new_pf_gain;
    pf_tapset = new_pf_tapset;
    if (lm != 0) {
      pf_period_old = pf_period;
      pf_gain_old = pf_gain;
      pf_tapset_old = pf_tapset;
    }

    // Roll the energy history for prediction / anti-collapse. A mono frame
    // keeps both channel slots in sync (the twin mirrors the reference's
    // copy before the roll so anti-collapse's cross-channel MAX works).
    if (c == 1)
      for (int i = 0; i < kNbBands; ++i) old_e[1][i] = old_e[0][i];
    if (!is_transient) {
      std::memcpy(old_log_e2, old_log_e, sizeof(old_log_e2));
      std::memcpy(old_log_e, old_e, sizeof(old_log_e));
    } else {
      for (int ch = 0; ch < 2; ++ch)
        for (int i = 0; i < kNbBands; ++i)
          old_log_e[ch][i] = std::min(old_log_e[ch][i], old_e[ch][i]);
    }
    for (int ch = 0; ch < 2; ++ch)
      for (int i = 0; i < kNbBands; ++i) {
        if (i < start || i >= end) {
          old_e[ch][i] = 0.0f;
          old_log_e[ch][i] = -28.0f;
          old_log_e2[ch][i] = -28.0f;
        }
      }
    // The next frame's noise-fill seed is the range coder's final state,
    // NOT the continuation of the LCG chain (the anti_collapse call above
    // already consumed the LCG-chained value, matching the twin's order).
    rng = dec.rng;
    final_range = dec.rng;
    return 0;
  }
};

}  // namespace celt

// ---------------------------------------------------------------------------
// Opus packet layer (RFC 6716 §3) + Ogg Opus container (RFC 7845) — twin of
// hpfw_jax/io/opus.py. CELT mode only (music streams); SILK/hybrid packets
// are rejected like the twin.
// ---------------------------------------------------------------------------

namespace opus {

struct PacketInfo {
  int mode;           // 0 silk, 1 hybrid, 2 celt
  int end_band;       // CELT end band from the TOC bandwidth
  int frame_samples;  // at 48 kHz
  bool stereo;
  // Frame spans into the packet payload.
  std::vector<std::pair<int64_t, int64_t>> frames;  // (offset, length)
};

// One RFC 6716 §3.2.1 frame length; returns length or -1, advances *pos.
static int read_frame_len(const uint8_t* d, int64_t n, int64_t* pos) {
  if (*pos >= n) return -1;
  int x = d[(*pos)++];
  if (x >= 252) {
    if (*pos >= n) return -1;
    x += 4 * d[(*pos)++];
  }
  return x;
}

// Split an Opus packet (codes 0-3 incl. CBR/VBR and padding). rc 0 ok.
static int parse_packet(const uint8_t* pkt, int64_t len, PacketInfo* out) {
  if (len < 1) return -1;
  int toc = pkt[0];
  int config = toc >> 3;
  if (config < 12) {
    out->mode = 0;
    static const int kSilkFrames[4] = {480, 960, 1920, 2880};
    out->frame_samples = kSilkFrames[config & 3];
    out->end_band = 0;
  } else if (config < 16) {
    out->mode = 1;
    out->frame_samples = (config & 1) ? 960 : 480;
    out->end_band = 0;
  } else {
    out->mode = 2;
    static const int kCeltEndBand[4] = {13, 17, 19, 21};  // NB WB SWB FB
    out->end_band = kCeltEndBand[(config - 16) >> 2];
    static const int kCeltFrames[4] = {120, 240, 480, 960};
    out->frame_samples = kCeltFrames[config & 3];
  }
  out->stereo = (toc & 0x4) != 0;
  int code = toc & 0x3;
  const uint8_t* body = pkt + 1;
  int64_t blen = len - 1;
  out->frames.clear();
  if (code == 0) {
    out->frames.emplace_back(1, blen);
  } else if (code == 1) {
    if (blen % 2) return -2;
    out->frames.emplace_back(1, blen / 2);
    out->frames.emplace_back(1 + blen / 2, blen / 2);
  } else if (code == 2) {
    int64_t pos = 0;
    int n1 = read_frame_len(body, blen, &pos);
    if (n1 < 0 || pos + n1 > blen) return -3;
    out->frames.emplace_back(1 + pos, n1);
    out->frames.emplace_back(1 + pos + n1, blen - pos - n1);
  } else {
    if (blen < 1) return -4;
    int fc = body[0];
    bool vbr = (fc & 0x80) != 0;
    bool has_pad = (fc & 0x40) != 0;
    int mcount = fc & 0x3F;
    if (mcount == 0) return -5;
    int64_t pos = 1;
    int64_t pad_len = 0;
    if (has_pad) {
      while (true) {
        if (pos >= blen) return -6;
        int p = body[pos++];
        pad_len += p < 255 ? p : 254;
        if (p < 255) break;
      }
    }
    int64_t end = blen - pad_len;
    if (end < pos) return -7;
    std::vector<int64_t> lens;
    if (vbr) {
      int64_t sum = 0;
      for (int i = 0; i < mcount - 1; ++i) {
        int ln = read_frame_len(body, blen, &pos);
        if (ln < 0) return -8;
        lens.push_back(ln);
        sum += ln;
      }
      int64_t rest = end - pos - sum;
      if (rest < 0) return -8;
      lens.push_back(rest);
    } else {
      if ((end - pos) % mcount) return -9;
      lens.assign(mcount, (end - pos) / mcount);
    }
    for (int64_t ln : lens) {
      out->frames.emplace_back(1 + pos, ln);
      pos += ln;
    }
  }
  if ((int64_t)out->frame_samples * (int64_t)out->frames.size() > 5760)
    return -10;
  return 0;
}

// Ogg page CRC (poly 0x04C11DB7, init 0, no reflection — Ogg's variant).
static uint32_t ogg_crc(const uint8_t* d, int64_t n, int64_t zero_from,
                        int64_t zero_to) {
  uint32_t c = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t byte = (i >= zero_from && i < zero_to) ? 0 : d[i];
    c ^= (uint32_t)byte << 24;
    for (int k = 0; k < 8; ++k)
      c = (c & 0x80000000u) ? (c << 1) ^ 0x04C11DB7u : (c << 1);
  }
  return c;
}

}  // namespace opus

// Ogg Opus -> mono float32 PCM at 48 kHz (twin of io/opus.py decode_opus:
// honors pre-skip, output gain, and end trimming via the final granule).
// final_range (nullable) receives the last frame's range-coder state — the
// cross-implementation sync check. rc 0 ok, negative on failure.
int hpfw_opus_decode_vec(const uint8_t* data, int64_t size,
                         std::vector<float>* out, int32_t* sample_rate,
                         uint32_t* final_range) {
  using opus::PacketInfo;
  if (size < 27 || std::memcmp(data, "OggS", 4) != 0) return -1;
  // ---- Ogg layer (CRC-verified, continued-packet reassembly) ----
  std::vector<std::vector<uint8_t>> packets;
  std::vector<int64_t> pkt_granule;
  {
    std::vector<uint8_t> cur;
    int64_t pos = 0;
    while (pos + 27 <= size) {
      if (std::memcmp(data + pos, "OggS", 4) != 0) return -20;
      if (data[pos + 4] != 0) return -21;
      int64_t granule;
      std::memcpy(&granule, data + pos + 6, 8);
      uint32_t crc;
      std::memcpy(&crc, data + pos + 22, 4);
      int n_segs = data[pos + 26];
      if (pos + 27 + n_segs > size) return -22;
      int64_t body_len = 0;
      for (int i = 0; i < n_segs; ++i) body_len += data[pos + 27 + i];
      int64_t body_start = pos + 27 + n_segs;
      if (body_start + body_len > size) return -22;
      if (opus::ogg_crc(data + pos, body_start + body_len - pos, 22, 26)
          != crc)
        return -23;
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
  if (packets.size() < 2) return -25;

  // ---- RFC 7845 headers ----
  const std::vector<uint8_t>& head = packets[0];
  if (head.size() < 19 || std::memcmp(head.data(), "OpusHead", 8) != 0)
    return -30;
  if ((head[8] >> 4) != 0) return -30;  // version
  int channels = head[9];
  uint16_t pre_skip;
  int16_t gain_q8;
  std::memcpy(&pre_skip, head.data() + 10, 2);
  std::memcpy(&gain_q8, head.data() + 16, 2);
  int family = head[18];
  if (family != 0) return -31;  // mono/stereo only, like the twin
  if (channels != 1 && channels != 2) return -31;
  double gain = std::pow(10.0, gain_q8 / (20.0 * 256.0));
  if (packets[1].size() < 8 ||
      std::memcmp(packets[1].data(), "OpusTags", 8) != 0)
    return -32;

  // ---- audio packets ----
  celt::CeltDecoder dec(channels);
  std::vector<float> pcm;  // interleaved (n, channels)
  int64_t total = 0;
  int64_t last_granule = -1;
  std::vector<float> frame_buf;
  for (size_t pi = 2; pi < packets.size(); ++pi) {
    const std::vector<uint8_t>& pkt = packets[pi];
    if (pkt.empty()) continue;
    PacketInfo info;
    int rc = opus::parse_packet(pkt.data(), (int64_t)pkt.size(), &info);
    if (rc != 0) return -40 + rc;
    if (info.mode != 2) return -50;  // SILK/hybrid out of scope
    int c = info.stereo ? 2 : 1;
    for (auto& fr : info.frames) {
      frame_buf.resize((size_t)info.frame_samples * channels);
      rc = dec.decode_frame(pkt.data() + fr.first, fr.second,
                            info.frame_samples, c, info.end_band,
                            frame_buf.data());
      if (rc != 0) return rc;
      pcm.insert(pcm.end(), frame_buf.begin(), frame_buf.end());
      total += info.frame_samples;
    }
    if (pkt_granule[pi] >= 0) last_granule = pkt_granule[pi];
  }
  if (total == 0) return -51;
  int64_t n = total;
  if (last_granule >= 0) n = std::max<int64_t>(0, std::min(total,
                                                           last_granule));
  int64_t skip = std::min<int64_t>(pre_skip, n);
  out->clear();
  out->reserve((size_t)(n - skip));
  for (int64_t j = skip; j < n; ++j) {
    float v;
    if (channels == 1)
      v = pcm[(size_t)j];
    else
      v = 0.5f * (pcm[(size_t)j * 2] + pcm[(size_t)j * 2 + 1]);
    if (gain_q8 != 0) v = v * (float)gain;
    out->push_back(v);
  }
  if (out->empty()) return -52;
  *sample_rate = 48000;
  if (final_range != nullptr) *final_range = dec.final_range;
  return 0;
}

extern "C" {

// Two-call ABI matching hpfw_mp3_decode/hpfw_aac_decode, plus an optional
// final_range out-param (nullable): the last frame's range-coder state,
// compared bit-exactly against the NumPy twin in tests/test_opus.py.
int hpfw_opus_decode(const uint8_t* data, int64_t size, float* out,
                     int64_t* n_samples, int32_t* sample_rate,
                     uint32_t* final_range) {
  std::vector<float> v;
  int rc = hpfw_opus_decode_vec(data, size, &v, sample_rate, final_range);
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
