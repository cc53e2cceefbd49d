"""In-repo MPEG-1 audio bitstream composers (fixture generators).

Frame composers for MPEG-1 audio (ISO/IEC 11172-3) used to build
spec-valid test fixtures offline, mirroring the FLAC/Vorbis strategy
(`io/flac.py` encoder, `io/vorbis.py` encoder): the decoder under test is
`hpfw_jax.io.mp3`; these composers give tests exact control over every
field so each decode path can be exercised deterministically, and —
where system libmpg123 is present — every composed stream can also be
decoded by a real reference decoder and compared.

Layer I composer: direct control of allocation/scalefactor/sample codes
(no psychoacoustics — fixtures need exactness, not compression quality).
Layer II and Layer III composers follow the same raw-field philosophy.

Reference parity: the C++ reference takes decoded PCM from a system audio
library (SURVEY.md §2.1 row 1); fixtures there are real audio files. In
this offline environment fixtures are composed from spec instead.
"""

from __future__ import annotations

import numpy as np

# Bitrate/sample-rate tables come from the decoder (the source of truth).
from .mp3 import BITRATES, BITRATES_LSF, SAMPLE_RATES, SAMPLE_RATES_V2

BITRATES_L1, BITRATES_L2, BITRATES_L3 = BITRATES[1], BITRATES[2], BITRATES[3]
BITRATES_L1_LSF, BITRATES_L2_LSF = BITRATES_LSF[1], BITRATES_LSF[2]  # header sampling_frequency index 0..2


class BitWriter:
    """MSB-first bit accumulator."""

    def __init__(self):
        self._bits: list[int] = []

    def write(self, value: int, n: int) -> None:
        assert 0 <= value < (1 << n), (value, n)
        for i in range(n - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def pad_to_bytes(self, total_bytes: int) -> None:
        want = total_bytes * 8
        assert len(self._bits) <= want, (len(self._bits), want)
        self._bits.extend([0] * (want - len(self._bits)))

    def bytes(self) -> bytes:
        assert len(self._bits) % 8 == 0
        out = bytearray()
        for i in range(0, len(self._bits), 8):
            b = 0
            for bit in self._bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def frame_header(layer: int, bitrate_idx: int, sr_idx: int, *,
                 mode: int = 3, padding: int = 0, mode_ext: int = 0,
                 version: int = 3) -> int:
    """32-bit MPEG frame header. mode 3 = single channel; version 3 =
    MPEG-1, 2 = MPEG-2 LSF, 0 = MPEG-2.5."""
    assert layer in (1, 2, 3)
    assert version in (0, 2, 3)
    layer_bits = {1: 0b11, 2: 0b10, 3: 0b01}[layer]
    h = 0x7FF
    h = (h << 2) | version
    h = (h << 2) | layer_bits
    h = (h << 1) | 1             # protection_bit=1: no CRC
    h = (h << 4) | bitrate_idx
    h = (h << 2) | sr_idx
    h = (h << 1) | padding
    h = (h << 1) | 0             # private
    h = (h << 2) | mode
    h = (h << 2) | mode_ext
    h = (h << 1) | 0             # copyright
    h = (h << 1) | 0             # original
    h = (h << 2) | 0             # emphasis
    return h


def layer1_frame_mono(codes: np.ndarray, alloc: np.ndarray,
                      scf: np.ndarray, *, bitrate_idx: int = 14,
                      sr_idx: int = 1, lsf: bool = False) -> bytes:
    """Compose one MPEG-1 (or MPEG-2 LSF) Layer I mono frame (384 samples).

    codes: (12, 32) unsigned sample codes (only allocated subbands read);
    alloc: (32,) allocation codes (0 = silent, 1..14 -> nb = code+1 bits);
    scf:   (32,) scalefactor indices 0..62 (only allocated subbands read).
    """
    codes = np.asarray(codes)
    alloc = np.asarray(alloc)
    scf = np.asarray(scf)
    assert codes.shape == (12, 32) and alloc.shape == (32,)
    sr = (SAMPLE_RATES_V2 if lsf else SAMPLE_RATES)[sr_idx]
    kbps = (BITRATES_L1_LSF if lsf else BITRATES_L1)[bitrate_idx]
    slots = (12 * kbps * 1000) // sr  # 4-byte slots
    nbytes = slots * 4
    w = BitWriter()
    w.write(frame_header(1, bitrate_idx, sr_idx,
                         version=2 if lsf else 3), 32)
    for sb in range(32):
        a = int(alloc[sb])
        assert 0 <= a <= 14
        w.write(a, 4)
    for sb in range(32):
        if alloc[sb]:
            w.write(int(scf[sb]), 6)
    for s in range(12):
        for sb in range(32):
            a = int(alloc[sb])
            if a:
                nb = a + 1
                w.write(int(codes[s, sb]), nb)
    w.pad_to_bytes(nbytes)
    return w.bytes()


def layer2_frame(digits: np.ndarray, alloc: np.ndarray, scfsi: np.ndarray,
                 scf: np.ndarray, *, bitrate_idx: int, sr_idx: int = 1,
                 mode: int = 3, mode_ext: int = 0, lsf: bool = False) -> bytes:
    """Compose one MPEG-1 (or MPEG-2 LSF) Layer II frame (1152 samples).

    digits: (36, sblimit, nch) per-sample quantization digits in [0, n)
            (grouped classes are packed into base-n triplet codes here);
    alloc:  (sblimit, nch) allocation codes (for joint stereo, subbands
            >= bound read channel 0);
    scfsi:  (sblimit, nch) scalefactor-selection codes 0..3;
    scf:    (sblimit, nch, 3) scalefactor indices per part (slots beyond
            the scfsi-transmitted count are ignored).
    """
    from ._mpeg_l2_tables import ALLOC_TABLES, LSF_TABLE, QCLASS, select_table
    from ._mp3_layer2 import SCFSI_MAP

    nch = 1 if mode == 3 else 2
    table = ALLOC_TABLES[LSF_TABLE if lsf else
                         select_table(sr_idx, nch == 1, bitrate_idx)]
    sblimit = len(table)
    bound = min((mode_ext + 1) * 4, sblimit) if mode == 1 else sblimit
    assert digits.shape == (36, sblimit, nch)
    sr = (SAMPLE_RATES_V2 if lsf else SAMPLE_RATES)[sr_idx]
    kbps = (BITRATES_L2_LSF if lsf else BITRATES_L2)[bitrate_idx]
    nbytes = 144 * kbps * 1000 // sr  # padding=0: floor frame size
    w = BitWriter()
    w.write(frame_header(2, bitrate_idx, sr_idx, mode=mode,
                         mode_ext=mode_ext, version=2 if lsf else 3), 32)
    for sb in range(sblimit):
        nbal = table[sb][0]
        for ch in range(1 if sb >= bound else nch):
            a = int(alloc[sb, ch])
            assert a < (1 << nbal)
            w.write(a, nbal)
    for sb in range(sblimit):
        for ch in range(nch):
            if alloc[sb, ch]:
                w.write(int(scfsi[sb, ch]), 2)
    for sb in range(sblimit):
        for ch in range(nch):
            if alloc[sb, ch]:
                count, _ = SCFSI_MAP[int(scfsi[sb, ch])]
                for slot in range(count):
                    w.write(int(scf[sb, ch, slot]), 6)
    for gr in range(12):
        for sb in range(sblimit):
            shared = sb >= bound
            for ch in range(1 if shared else nch):
                a = int(alloc[sb, ch])
                if not a:
                    continue
                n = table[sb][1][a - 1]
                bits, grouped = QCLASS[n]
                v = digits[3 * gr:3 * gr + 3, sb, ch]
                assert np.all((v >= 0) & (v < n)), (sb, n, v)
                if grouped:
                    w.write(int(v[0] + n * v[1] + n * n * v[2]), bits)
                else:
                    for i in range(3):
                        w.write(int(v[i]), bits)
    w.pad_to_bytes(nbytes)
    return w.bytes()


def encode_mp3(pcm: np.ndarray, sr: int, *, bitrate_idx: int = 14,
               max_int: int = 13) -> bytes:
    """Encode mono/stereo float PCM to MPEG-1 Layer III (fixture grade).

    A real encoder in miniature: polyphase analysis (the adjoint of the
    recovered synthesis filterbank — the QMF bank is near-paraunitary,
    so the adjoint inverts it to ~60 dB), forward MDCT with TDAC, inverse
    alias butterflies, per-granule global_gain selection, and Huffman
    coding with the probe-recovered tables (table 13 pairs + count1 B
    quads, long blocks, no reservoir). No psychoacoustics: fixtures need
    spec validity and round-trip fidelity, not compression. sr must be
    one of 44100/48000/32000.
    """
    from ._mp3_layer3 import _CA, _CS, _IMDCT36, _WIN
    from ._mp3_huffman import BIG_VALUE_TABLES, COUNT1_TABLES
    from .mp3 import SAMPLE_RATES, _N

    sr_idx = SAMPLE_RATES.index(sr)
    pcm = np.asarray(pcm, np.float64)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    nch = pcm.shape[1]
    assert nch in (1, 2)
    n_gr_samples = 576
    total = ((pcm.shape[0] + 2 * n_gr_samples - 1)
             // (2 * n_gr_samples)) * (2 * n_gr_samples)
    pcm = np.pad(pcm, ((0, total - pcm.shape[0]), (0, 0)))

    inv13 = {v: k for k, v in BIG_VALUE_TABLES[13][1].items()}
    invB = {v: k for k, v in COUNT1_TABLES[1].items()}

    frames = []
    n_frames = total // (2 * n_gr_samples)
    S_all = [_analysis(pcm[:, ch]) for ch in range(nch)]  # (T,32) each
    prev = [np.zeros((32, 18)) for _ in range(nch)]
    for fi in range(n_frames):
        granules = [[None] * nch for _ in range(2)]
        for gr in range(2):
            for ch in range(nch):
                t0 = fi * 36 + gr * 18
                xr = _forward_mdct(S_all[ch], t0, prev[ch])
                _alias_expand(xr)
                granules[gr][ch] = _quantize_encode(xr, inv13, invB)
        frames.append(layer3_frame(
            granules, bitrate_idx=bitrate_idx, sr_idx=sr_idx,
            mode=3 if nch == 1 else 0))
    return b"".join(frames)


def _analysis(x: np.ndarray) -> np.ndarray:
    """Polyphase analysis: PCM (32T,) -> subband samples (T, 32).

    Adjoint of io/mp3.py's synthesis (same window/matrix run backward),
    scaled so synthesis(analysis(x)) ~ x with the filterbank's 481-sample
    delay. Verified to ~60 dB reconstruction in tests.
    """
    from ._mpeg_window import SYNTH_WINDOW as D
    from .mp3 import _N

    T = len(x) // 32
    blocks = x[:T * 32].reshape(T, 32)
    Vadj = np.zeros((T, 64))
    for q in range(8):
        # synthesis: out[t] += V[t-2q, :32]*D0q + V[t-2q-1, 32:]*D1q
        D0 = D[64 * q:64 * q + 32]
        D1 = D[64 * q + 32:64 * q + 64]
        Vadj[:T - 2 * q, :32] += blocks[2 * q:] * D0
        if T - 2 * q - 1 > 0:
            Vadj[:T - 2 * q - 1, 32:] += blocks[2 * q + 1:] * D1
    S = Vadj @ _N  # adjoint of V = S @ N.T
    return S / 32.0  # N columns have squared-norm 32


def _forward_mdct(S: np.ndarray, t0: int, prev: list) -> np.ndarray:
    """18 subband sample times starting at t0 -> 576 spectral lines.

    TDAC: X = (2/36)*(win*frame) @ IMDCT basis; `prev` holds each
    subband's previous 18 samples (50% overlap). Includes the encoder
    side of frequency inversion (odd subband, odd time).
    """
    from ._mp3_layer3 import _IMDCT36, _WIN

    xr = np.zeros(576)
    cur = S[t0:t0 + 18]  # (18, 32)
    for sb in range(32):
        frame = np.concatenate([prev[sb], cur[:, sb]])
        if sb % 2:
            frame = frame * _FREQ_INV36
        xr[18 * sb:18 * sb + 18] = \
            (4.0 / 36.0) * ((_WIN[0] * frame) @ _IMDCT36)
        prev[sb] = np.asarray(cur[:, sb]).copy()
    return xr


_FREQ_INV36 = np.where(np.arange(36) % 2 == 1, -1.0, 1.0)


def _alias_expand(xr: np.ndarray) -> None:
    """Inverse of the decoder's alias-reduction butterflies (det = 1)."""
    from ._mp3_layer3 import _CA, _CS

    for sb in range(31):
        lo = 18 * sb
        for j in range(8):
            a = xr[lo + 17 - j]
            b = xr[lo + 18 + j]
            xr[lo + 17 - j] = a * _CS[j] + b * _CA[j]
            xr[lo + 18 + j] = b * _CS[j] - a * _CA[j]


def _quantize_encode(xr: np.ndarray, inv13: dict, invB: dict,
                     max_int: int = 13) -> dict:
    """xr (576,) -> composer granule fields (gg choice + Huffman bits)."""
    peak = np.abs(xr).max()
    if peak <= 0:
        return dict()
    # decoder: xr = v^(4/3) * 2^((gg-210)/4); choose gg so max v <= max_int
    gg = 210 + int(np.ceil(4 * np.log2(peak / max_int ** (4.0 / 3.0))))
    gg = min(max(gg, 0), 255)
    scale = 2.0 ** ((gg - 210) / 4.0)
    v = np.sign(xr) * np.round((np.abs(xr) / scale) ** 0.75)
    v = np.clip(v, -15, 15).astype(int)
    # split: big values (pairs) up to the last |v|>1, then count1 quads
    nz = np.nonzero(np.abs(v) > 1)[0]
    big_end = (int(nz[-1]) + 2) // 2 * 2 if len(nz) else 0
    nz1 = np.nonzero(v)[0]
    c1_end = (int(nz1[-1]) + 4 + 3) // 4 * 4 if len(nz1) else 0
    c1_end = max(c1_end, big_end)
    bits = []
    for i in range(0, big_end, 2):
        x, y = abs(v[i]), abs(v[i + 1])
        bits.append(inv13[(x, y)])
        if x:
            bits.append("1" if v[i] < 0 else "0")
        if y:
            bits.append("1" if v[i + 1] < 0 else "0")
    for i in range(big_end, c1_end, 4):
        quad = tuple(abs(v[i + j]) if i + j < 576 else 0 for j in range(4))
        bits.append(invB[quad])
        for j in range(4):
            if quad[j]:
                bits.append("1" if v[i + j] < 0 else "0")
    return dict(big_values=big_end // 2, global_gain=gg,
                table_select=(13, 13, 13), region0_count=15,
                region1_count=7, count1table_select=1,
                huff_bits="".join(bits))


def _default_granule() -> dict:
    return dict(big_values=0, global_gain=210, scalefac_compress=0,
                window_switching=0, block_type=0, mixed_block=0,
                table_select=(0, 0, 0), subblock_gain=(0, 0, 0),
                region0_count=0, region1_count=0, preflag=0,
                scalefac_scale=0, count1table_select=0,
                scf_bits=(), huff_bits="")


def layer3_side(granules, w: BitWriter, *, bitrate_idx: int = 13,
                sr_idx: int = 1, mode: int = 3, mode_ext: int = 0,
                main_data_begin: int = 0, scfsi=None,
                version: int = 3) -> None:
    """Write the header + side info of one Layer III frame into `w`.
    version 3 = MPEG-1 (2 granules, scfsi, 4-bit scalefac_compress,
    preflag bit); 2/0 = LSF/2.5 (1 granule, 9-bit scalefac_compress)."""
    nch = 1 if mode == 3 else 2
    lsf = version != 3
    if scfsi is None:
        scfsi = [[0] * 4 for _ in range(nch)]
    w.write(frame_header(3, bitrate_idx, sr_idx, mode=mode,
                         mode_ext=mode_ext, version=version), 32)
    w.write(main_data_begin, 8 if lsf else 9)
    w.write(0, (1 if lsf else 5) if nch == 1 else (2 if lsf else 3))
    if not lsf:
        for ch in range(nch):
            for b in scfsi[ch]:
                w.write(b, 1)
    for gr in range(1 if lsf else 2):
        for ch in range(nch):
            g = dict(_default_granule(), **granules[gr][ch])
            part2_3 = sum(nb for _v, nb in g["scf_bits"]) \
                + len(g["huff_bits"])
            w.write(part2_3, 12)
            w.write(g["big_values"], 9)
            w.write(g["global_gain"], 8)
            w.write(g["scalefac_compress"], 9 if lsf else 4)
            w.write(g["window_switching"], 1)
            if g["window_switching"]:
                w.write(g["block_type"], 2)
                w.write(g["mixed_block"], 1)
                for r in range(2):
                    w.write(g["table_select"][r], 5)
                for sw in range(3):
                    w.write(g["subblock_gain"][sw], 3)
            else:
                for r in range(3):
                    w.write(g["table_select"][r], 5)
                w.write(g["region0_count"], 4)
                w.write(g["region1_count"], 3)
            if not lsf:
                w.write(g["preflag"], 1)
            w.write(g["scalefac_scale"], 1)
            w.write(g["count1table_select"], 1)


def layer3_main_bits(granules, mode: int = 3, n_gr: int = 2) -> "BitWriter":
    """Write the main-data bits (scalefactors + Huffman) of a frame."""
    nch = 1 if mode == 3 else 2
    w = BitWriter()
    for gr in range(n_gr):
        for ch in range(nch):
            g = dict(_default_granule(), **granules[gr][ch])
            for v, nb in g["scf_bits"]:
                w.write(int(v), nb)
            for bit in g["huff_bits"]:
                w.write(int(bit), 1)
    return w


def layer3_frame(granules, *, bitrate_idx: int = 13, sr_idx: int = 1,
                 mode: int = 3, mode_ext: int = 0, scfsi=None,
                 version: int = 3) -> bytes:
    """Compose one self-contained MPEG-1 Layer III frame.

    granules: [gr][ch] dicts (see _default_granule); `scf_bits` is a
    sequence of (value, nbits) written verbatim as the scalefactor part,
    `huff_bits` a '0'/'1' string written verbatim as the Huffman part —
    part2_3_length is their sum, so probes control the spectrum bit
    layout exactly. main_data_begin = 0: all main data in-frame; use
    layer3_side/layer3_main_bits directly for bit-reservoir layouts.
    """
    lsf = version != 3
    from .mp3 import SAMPLE_RATES_V25

    if version == 0:
        sr = SAMPLE_RATES_V25[sr_idx]
    else:
        sr = (SAMPLE_RATES_V2 if lsf else SAMPLE_RATES)[sr_idx]
    kbps = (BITRATES_L2_LSF if lsf else BITRATES_L3)[bitrate_idx]
    nbytes = (72 if lsf else 144) * kbps * 1000 // sr
    w = BitWriter()
    layer3_side(granules, w, bitrate_idx=bitrate_idx, sr_idx=sr_idx,
                mode=mode, mode_ext=mode_ext, scfsi=scfsi, version=version)
    mw = layer3_main_bits(granules, mode, 1 if lsf else 2)
    for bit in mw._bits:
        w._bits.append(bit)
    w.pad_to_bytes(nbytes)
    return w.bytes()
