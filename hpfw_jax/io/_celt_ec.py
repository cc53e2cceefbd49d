"""CELT range (entropy) decoder — RFC 6716 §4.1, from spec.

The Opus payload is one entropy-coded bitstream read from BOTH ends: range-
coded symbols consume bytes from the front, "raw" equiprobable bits consume
bits from the back (§4.1.4). The two cursors share the byte budget; the
decoder tracks total consumption in eighth-bit (Q3) resolution via
tell_frac() because CELT's allocator budgets in eighth-bits.

All arithmetic is exact 32-bit unsigned (Python ints masked), matching the
reference decoder's normative behavior: a single mis-decoded symbol desyncs
everything after it, so this module is the foundation the per-frame
certification in tests/test_opus.py rests on.

Reference parity target: libopus entdec.c/entcode.c semantics (the system
oracle hpfw_jax/io/opus_ref.py certifies the full decode; reference mount
empty per SURVEY.md §0, so the system libopus is the stand-in reference).
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF

# Window/precision constants (RFC 6716 §4.1 / entcode.h).
SYM_BITS = 8
CODE_BITS = 32
SYM_MAX = (1 << SYM_BITS) - 1
CODE_TOP = 1 << (CODE_BITS - 1)
CODE_BOT = CODE_TOP >> SYM_BITS
CODE_EXTRA = (CODE_BITS - 2) % SYM_BITS + 1          # 7
UINT_BITS = 8
WINDOW_SIZE = 32
BITRES = 3                                            # eighth-bit resolution


def ilog(x: int) -> int:
    """Position of the highest set bit + 1; ilog(0) == 0 (EC_ILOG)."""
    return x.bit_length()


class RangeDecoder:
    """Stateful range decoder over one frame's compressed bytes."""

    def __init__(self, data: bytes):
        self.buf = data
        self.storage = len(data)
        # front (range-coded) cursor
        self.offs = 0
        # back (raw-bit) cursor
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = (CODE_BITS + 1
                            - ((CODE_BITS - CODE_EXTRA) // SYM_BITS)
                            * SYM_BITS)
        self.rng = 1 << CODE_EXTRA
        self.rem = self._read_byte()
        self.val = self.rng - 1 - (self.rem >> (SYM_BITS - CODE_EXTRA))
        self.error = 0
        self._normalize()

    # -- byte feeds ---------------------------------------------------------
    def _read_byte(self) -> int:
        if self.offs < self.storage:
            b = self.buf[self.offs]
            self.offs += 1
            return b
        return 0

    def _read_byte_from_end(self) -> int:
        if self.end_offs < self.storage:
            self.end_offs += 1
            return self.buf[self.storage - self.end_offs]
        return 0

    def _normalize(self) -> None:
        while self.rng <= CODE_BOT:
            self.nbits_total += SYM_BITS
            self.rng = (self.rng << SYM_BITS) & _M32
            sym = self.rem
            self.rem = self._read_byte()
            sym = ((sym << SYM_BITS) | self.rem) >> (SYM_BITS - CODE_EXTRA)
            self.val = (((self.val << SYM_BITS) + (SYM_MAX & ~sym))
                        & (CODE_TOP - 1))

    # -- range-coded symbols (front) ----------------------------------------
    def decode(self, ft: int) -> int:
        """Begin decoding a symbol with cumulative-frequency total ft."""
        self.ext = self.rng // ft
        s = self.val // self.ext
        return ft - min(s + 1, ft)

    def decode_bin(self, bits: int) -> int:
        self.ext = self.rng >> bits
        s = self.val // self.ext
        return (1 << bits) - min(s + 1, 1 << bits)

    def update(self, fl: int, fh: int, ft: int) -> None:
        """Commit the symbol whose cumulative range is [fl, fh) of ft."""
        s = self.ext * (ft - fh)
        self.val -= s
        self.rng = self.ext * (fh - fl) if fl > 0 else self.rng - s
        self._normalize()

    def dec_bit_logp(self, logp: int) -> int:
        """One binary symbol with P(1) = 2^-logp. Returns 0 or 1."""
        r = self.rng
        d = self.val
        s = r >> logp
        ret = 1 if d < s else 0
        if not ret:
            self.val = d - s
        self.rng = s if ret else r - s
        self._normalize()
        return ret

    def dec_icdf(self, icdf, ftb: int) -> int:
        """Symbol from an inverse-CDF table (icdf[k] = ft - cumfreq(k+1),
        scaled so ft = 1 << ftb)."""
        d = self.val
        r = self.rng >> ftb
        ret = -1
        s = self.rng
        while True:
            t = s
            ret += 1
            s = r * icdf[ret]
            if d >= s:
                break
        self.val = d - s
        self.rng = t - s
        self._normalize()
        return ret

    def dec_uint(self, ft: int) -> int:
        """Uniform integer in [0, ft) (§4.1.5): large ranges split into a
        range-coded high part and raw low bits."""
        assert ft > 1
        ft -= 1
        ftb = ilog(ft)
        if ftb > UINT_BITS:
            ftb -= UINT_BITS
            ft1 = (ft >> ftb) + 1
            s = self.decode(ft1)
            self.update(s, s + 1, ft1)
            t = (s << ftb) | self.dec_bits(ftb)
            if t <= ft:
                return t
            self.error = 1
            return ft
        s = self.decode(ft + 1)
        self.update(s, s + 1, ft + 1)
        return s

    # -- raw bits (back) ------------------------------------------------------
    def dec_bits(self, bits: int) -> int:
        window = self.end_window
        available = self.nend_bits
        if available < bits:
            while available <= WINDOW_SIZE - SYM_BITS:
                window |= self._read_byte_from_end() << available
                available += SYM_BITS
        ret = window & ((1 << bits) - 1)
        window >>= bits
        available -= bits
        self.end_window = window
        self.nend_bits = available
        self.nbits_total += bits
        return ret

    # -- budget ---------------------------------------------------------------
    def tell(self) -> int:
        """Whole bits consumed so far (conservative, §4.1.6.1)."""
        return self.nbits_total - ilog(self.rng)

    def tell_frac(self) -> int:
        """Eighth-bits consumed (Q3, §4.1.6.2) — the allocator's budget unit."""
        correction = (35733, 38967, 42495, 46340, 50535, 55109, 60097, 65535)
        nbits = self.nbits_total << BITRES
        lg = ilog(self.rng)
        r = self.rng >> (lg - 16)
        b = (r >> 12) - 8
        b += 1 if r > correction[b] else 0
        lg = (lg << 3) + b
        return nbits - lg


# -- Laplace-coded coarse-energy residuals (RFC 6716 §4.3.2.1 / laplace.c) --

_LAPLACE_LOG_MINP = 0
_LAPLACE_MINP = 1 << _LAPLACE_LOG_MINP
_LAPLACE_NMIN = 16


def _laplace_get_freq1(fs0: int, decay: int) -> int:
    ft = 32768 - _LAPLACE_MINP * (2 * _LAPLACE_NMIN) - fs0
    return (ft * (16384 - decay)) >> 15


def laplace_decode(dec: RangeDecoder, fs: int, decay: int) -> int:
    """Signed integer with a two-sided geometric (Laplace) prior; fs is the
    P(0) frequency out of 32768, decay the per-step Q15 ratio."""
    val = 0
    fl = 0
    fm = dec.decode_bin(15)
    if fm >= fs:
        val += 1
        fl = fs
        fs = _laplace_get_freq1(fs, decay) + _LAPLACE_MINP
        while fs > _LAPLACE_MINP and fm >= fl + 2 * fs:
            fs *= 2
            fl += fs
            fs = ((fs - 2 * _LAPLACE_MINP) * decay) >> 15
            fs += _LAPLACE_MINP
            val += 1
        if fs <= _LAPLACE_MINP:
            di = (fm - fl) >> (_LAPLACE_LOG_MINP + 1)
            val += di
            fl += 2 * di * _LAPLACE_MINP
        if fm < fl + fs:
            val = -val
        else:
            fl += fs
    dec.update(fl, min(fl + fs, 32768), 32768)
    return val
