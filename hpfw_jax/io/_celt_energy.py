"""CELT band-energy decode: coarse / fine / final — RFC 6716 §4.3.2.

Energy is coded per band in a base-2 log domain (float-build semantics:
the Q8/DB_SHIFT macros are identity). Coarse energy is a Laplace-coded
residual from a 2-D prediction (per-band time prediction `coef`, in-frame
frequency integrator `beta`); fine energy refines with raw bits; leftover
whole bits are spent one per band by priority at the end of the frame.

Sync-critical integer behavior (which symbols are read, with which
parameters) is exact; the energy values themselves are float and
margin-tested. Parity target: libopus quant_bands.c decode side,
certified end-to-end against the system libopus oracle
(hpfw_jax/io/opus_ref.py; reference mount empty per SURVEY.md §0).
"""

from __future__ import annotations

import numpy as np

from ._celt_ec import RangeDecoder, laplace_decode
from ._celt_tables import (BETA_COEF, BETA_INTRA, E_PROB_MODEL, EMEANS,
                           PRED_COEF)

NB_BANDS = 21
MAX_FINE_BITS = 8

# quant_bands.c small_energy_icdf: zig-zag {0, +1, -1} fallback when the
# budget is nearly gone.
_SMALL_ENERGY_ICDF = (2, 1, 0)


def unquant_coarse_energy(start: int, end: int, old_e: np.ndarray,
                          intra: bool, dec: RangeDecoder, c: int,
                          lm: int) -> None:
    """Decode coarse energies in place into old_e (shape (2, NB_BANDS),
    channel-major — the decoder's persistent oldBandE)."""
    prob_model = E_PROB_MODEL[lm][1 if intra else 0]
    if intra:
        coef = 0.0
        beta = float(BETA_INTRA)
    else:
        coef = float(PRED_COEF[lm])
        beta = float(BETA_COEF[lm])
    budget = dec.storage * 8
    prev = [0.0, 0.0]
    for i in range(start, end):
        for ch in range(c):
            tell = dec.tell()
            if budget - tell >= 15:
                pi = 2 * min(i, 20)
                qi = laplace_decode(dec, prob_model[pi] << 7,
                                    prob_model[pi + 1] << 6)
            elif budget - tell >= 2:
                qi = dec.dec_icdf(_SMALL_ENERGY_ICDF, 2)
                qi = (qi >> 1) ^ -(qi & 1)
            elif budget - tell >= 1:
                qi = -dec.dec_bit_logp(1)
            else:
                qi = -1
            q = float(qi)
            e = max(-9.0, float(old_e[ch, i]))
            tmp = coef * e + prev[ch] + q
            old_e[ch, i] = np.float32(tmp)
            prev[ch] = prev[ch] + q - beta * q


def unquant_fine_energy(start: int, end: int, old_e: np.ndarray,
                        fine_quant: list[int], dec: RangeDecoder,
                        c: int) -> None:
    for i in range(start, end):
        if fine_quant[i] <= 0:
            continue
        for ch in range(c):
            q2 = dec.dec_bits(fine_quant[i])
            offset = ((q2 + 0.5) * (1 << (14 - fine_quant[i]))
                      / 16384.0 - 0.5)
            old_e[ch, i] = np.float32(float(old_e[ch, i]) + offset)


def unquant_energy_finalise(start: int, end: int, old_e: np.ndarray,
                            fine_quant: list[int], fine_priority: list[int],
                            bits_left: int, dec: RangeDecoder,
                            c: int) -> None:
    for prio in (0, 1):
        i = start
        while i < end and bits_left >= c:
            if fine_quant[i] >= MAX_FINE_BITS or fine_priority[i] != prio:
                i += 1
                continue
            for ch in range(c):
                q2 = dec.dec_bits(1)
                offset = (q2 - 0.5) * (1 << (14 - fine_quant[i] - 1)) \
                    / 16384.0
                old_e[ch, i] = np.float32(float(old_e[ch, i]) + offset)
                bits_left -= 1
            i += 1


def denormalise_bands(x: np.ndarray, band_log_e: np.ndarray, start: int,
                      end: int, m: int, n: int, silence: bool,
                      eband5ms: list[int]) -> np.ndarray:
    """Scale unit-norm band shapes back to linear energy (quant_bands.c
    denormalise_bands, float build; downsample==1 at 48 kHz)."""
    freq = np.zeros(n, np.float32)
    if silence:
        return freq
    for i in range(start, end):
        j0 = m * eband5ms[i]
        j1 = m * eband5ms[i + 1]
        lg = min(32.0, float(band_log_e[i]) + float(EMEANS[i]))
        g = np.float32(np.exp2(lg))
        freq[j0:j1] = x[j0:j1] * g
    return freq
