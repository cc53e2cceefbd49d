"""MPEG-1 audio (MP3) tests: from-spec decoder vs system libmpg123, in-repo
composer/encoder roundtrips, and load_audio dispatch.

Fixture strategy mirrors FLAC/Vorbis (tests/test_flac.py, test_vorbis.py):
spec-valid streams are composed in-repo (io/mp3enc.py) with direct control
over every bitstream field, so each decode path is exercised
deterministically offline. When the system reference decoder (libmpg123)
and encoder (libmp3lame) are present, every composed stream is additionally
decoded by the reference and compared at the float32 floor, and real
lame-encoded streams (bit reservoir, joint stereo, mixed block types) are
decoded by both decoders and compared — the strongest available stand-in
for the empty reference mount (SURVEY.md §2.1 row 1).

mpg123 emits float32; our decoder computes in float64. The observed
difference on identical streams is < 2e-6 (a couple of float32 ulps at
full scale), which is the tolerance used throughout.
"""

import numpy as np
import pytest

from hpfw_jax.config import HpfwConfig
from hpfw_jax.io import mpeg_ref, wav
from hpfw_jax.io._mpeg_l2_tables import ALLOC_TABLES, select_table
from hpfw_jax.io.mp3 import FrameHeader, decode_mp3
from hpfw_jax.io.mp3enc import (
    encode_mp3,
    layer1_frame_mono,
    layer2_frame,
    layer3_frame,
)

needs_ref = pytest.mark.skipif(
    not mpeg_ref.mpg123_available(), reason="system libmpg123 not present"
)
needs_lame = pytest.mark.skipif(
    not mpeg_ref.available(), reason="system libmpg123/libmp3lame not present"
)
needs_twolame = pytest.mark.skipif(
    not (mpeg_ref.mpg123_available() and mpeg_ref.twolame_available()),
    reason="system libmpg123/libtwolame not present")

FLOAT32_FLOOR = 2e-6


def _sig(n, sr, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = (0.4 * np.sin(2 * np.pi * 440.0 * t)
         + 0.2 * np.sin(2 * np.pi * 1870.0 * t)
         + 0.1 * np.sin(2 * np.pi * 523.25 * t * (1 + 0.05 * t)))
    if noise:
        x = x + noise * rng.standard_normal(n)
    return x.astype(np.float64)


def _ref_diff(stream: bytes) -> float:
    """Decode `stream` with both decoders; max abs difference, normalized
    by the reference peak when it exceeds full scale (the exhaustive
    allocation tests stack code extremes to ~10x full scale, where
    mpg123's float32 ulp grows proportionally)."""
    ours, sr_o = decode_mp3(stream)
    ref, sr_r = mpeg_ref.mpg123_decode(stream)
    assert sr_o == sr_r
    assert ours.shape[1] == ref.shape[1]
    # mpg123's feed API may hold back a final partial buffer; compare the
    # common prefix but require it to be nearly everything.
    n = min(ours.shape[0], ref.shape[0])
    assert n >= ours.shape[0] - 1152 and n > 0
    ref64 = ref[:n].astype(np.float64)
    scale = max(1.0, float(np.abs(ref64).max()))
    return float(np.abs(ours[:n] - ref64).max()) / scale


def _snr(got, want):
    n = min(len(got), len(want))
    a, b = want[:n], got[:n]
    err = a - b
    return 10 * np.log10(np.sum(a ** 2) / (np.sum(err ** 2) + 1e-30))


# --- Layer I ---------------------------------------------------------------


def _layer1_frames_covering(pairs, rng):
    """Frames (448 kbps @ 48 kHz: 3584-bit budget) covering every requested
    (subband, allocation-code) pair, packed capacity-aware."""
    budget = (12 * 448000 // 48000) * 4 * 8
    frames = []
    todo = list(pairs)
    while todo:
        used = 32 + 32 * 4  # header + allocation field
        alloc = np.zeros(32, dtype=np.int64)
        codes = np.zeros((12, 32), dtype=np.int64)
        scf = rng.integers(0, 63, size=32)
        taken = set()
        rest = []
        for sb, a in todo:
            cost = 6 + 12 * (a + 1)
            if sb in taken or used + cost > budget:
                rest.append((sb, a))
                continue
            taken.add(sb)
            used += cost
            alloc[sb] = a
            nb = a + 1
            codes[:, sb] = rng.integers(0, (1 << nb) - 1, size=12)
            codes[0, sb] = 0
            codes[1, sb] = (1 << nb) - 2  # class extremes
        frames.append(layer1_frame_mono(codes, alloc, scf,
                                        bitrate_idx=14, sr_idx=1))
        assert len(rest) < len(todo), "pair does not fit any frame"
        todo = rest
    return frames


@needs_ref
def test_layer1_every_allocation_code_vs_ref():
    """Every (subband, allocation code 1..14) pair decodes identically to
    mpg123, with sample codes hitting each class's extremes."""
    rng = np.random.default_rng(0)
    pairs = [(sb, a) for a in range(1, 15) for sb in range(32)]
    frames = _layer1_frames_covering(pairs, rng)
    assert _ref_diff(b"".join(frames)) < FLOAT32_FLOOR


# --- Layer II --------------------------------------------------------------

def _distinct_l2_tables():
    """One representative (sr_idx, mono, bitrate_idx) per allocation table."""
    seen = {}
    for sr_idx in range(3):
        for mono in (True, False):
            for br in range(1, 15):
                ti = select_table(sr_idx, mono, br)
                if ti not in seen:
                    seen[ti] = (sr_idx, mono, br)
    return sorted(seen.items())


def _l2_sample_bits(n):
    from hpfw_jax.io._mpeg_l2_tables import QCLASS

    bits, grouped = QCLASS[n]
    return bits if grouped else 3 * bits


def _l2_frames_covering(ti, sr_idx, mono, br, rng):
    """Frames covering every (subband, allocation code) pair of table `ti`
    with random in-range digits, packed under the frame bit budget."""
    from hpfw_jax.io._mp3_layer2 import SCFSI_MAP

    table = ALLOC_TABLES[ti]
    sblimit = len(table)
    nch = 1 if mono else 2
    mode = 3 if mono else 0
    sr = (44100, 48000, 32000)[sr_idx]
    kbps = (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
            320, 384)[br]
    budget = (144 * kbps * 1000 // sr) * 8
    fixed = 32 + nch * sum(row[0] for row in table)
    todo = [(sb, a) for sb in range(sblimit)
            for a in range(1, 1 << table[sb][0])]
    frames = []
    while todo:
        used = fixed
        alloc = np.zeros((sblimit, nch), dtype=np.int64)
        digits = np.zeros((36, sblimit, nch), dtype=np.int64)
        scfsi = rng.integers(0, 4, size=(sblimit, nch))
        scf = rng.integers(0, 63, size=(sblimit, nch, 3))
        taken = set()
        rest = []
        for sb, a in todo:
            n = table[sb][1][a - 1]
            cost = sum(2 + SCFSI_MAP[int(scfsi[sb, ch])][0] * 6
                       + 12 * _l2_sample_bits(n) for ch in range(nch))
            if sb in taken or used + cost > budget:
                rest.append((sb, a))
                continue
            taken.add(sb)
            used += cost
            for ch in range(nch):
                alloc[sb, ch] = a
                digits[:, sb, ch] = rng.integers(0, n, size=36)
                digits[0, sb, ch] = 0
                digits[1, sb, ch] = n - 1  # class extremes
        frames.append(layer2_frame(digits, alloc, scfsi, scf,
                                   bitrate_idx=br, sr_idx=sr_idx, mode=mode))
        assert len(rest) < len(todo), "pair does not fit any frame"
        todo = rest
    return frames


@needs_ref
@pytest.mark.parametrize("ti,rep", _distinct_l2_tables(),
                         ids=[f"table{ti}" for ti, _ in _distinct_l2_tables()])
def test_layer2_every_allocation_vs_ref(ti, rep):
    """ISO Tables B.2a-d certification: every (subband, allocation code)
    combination of each distinct table decodes identically to mpg123 —
    the exhaustive check promised in io/_mpeg_l2_tables.py."""
    sr_idx, mono, br = rep
    rng = np.random.default_rng(ti)
    frames = _l2_frames_covering(ti, sr_idx, mono, br, rng)
    assert _ref_diff(b"".join(frames)) < FLOAT32_FLOOR


@needs_ref
def test_layer2_joint_stereo_bounds_vs_ref():
    """Intensity-stereo mode: subbands above the mode_ext bound share one
    allocation/sample set; all four bounds exercised."""
    rng = np.random.default_rng(7)
    sr_idx, br = 1, 12
    ti = select_table(sr_idx, False, br)
    table = ALLOC_TABLES[ti]
    sblimit = len(table)
    from hpfw_jax.io._mp3_layer2 import SCFSI_MAP

    sr = (44100, 48000, 32000)[sr_idx]
    kbps = (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
            320, 384)[br]
    budget = (144 * kbps * 1000 // sr) * 8
    frames = []
    for mode_ext in range(4):
        bound = min((mode_ext + 1) * 4, sblimit)
        fixed = 32 + sum(row[0] * (2 if sb < bound else 1)
                         for sb, row in enumerate(table))
        used = fixed
        alloc = np.zeros((sblimit, 2), dtype=np.int64)
        digits = np.zeros((36, sblimit, 2), dtype=np.int64)
        scfsi = rng.integers(0, 4, size=(sblimit, 2))
        scf = rng.integers(0, 63, size=(sblimit, 2, 3))
        for sb in rng.permutation(sblimit):
            a = int(rng.integers(1, 1 << table[sb][0]))
            n = table[sb][1][a - 1]
            shared = sb >= bound
            cost = sum(2 + SCFSI_MAP[int(scfsi[sb, ch])][0] * 6
                       for ch in range(2))
            cost += 12 * _l2_sample_bits(n) * (1 if shared else 2)
            if used + cost > budget:
                continue
            used += cost
            for ch in range(2):
                alloc[sb, ch] = a
                digits[:, sb, ch] = rng.integers(0, n, size=36)
        frames.append(layer2_frame(digits, alloc, scfsi, scf,
                                   bitrate_idx=br, sr_idx=sr_idx,
                                   mode=1, mode_ext=mode_ext))
    assert _ref_diff(b"".join(frames)) < FLOAT32_FLOOR


# --- Layer III: real reference streams (lame) ------------------------------


LAME_CASES = [
    ("mono_128", dict(bitrate_kbps=128), False, 44100),
    ("mono_320", dict(bitrate_kbps=320), False, 44100),
    ("mono_32k_sr", dict(bitrate_kbps=96), False, 32000),
    ("mono_48k_sr", dict(bitrate_kbps=128), False, 48000),
    ("mono_no_reservoir", dict(bitrate_kbps=128, reservoir=False), False,
     44100),
    ("joint_stereo", dict(bitrate_kbps=160), True, 44100),
    ("dual_stereo", dict(bitrate_kbps=192, stereo=True), True, 44100),
    # low bitrate forces short/mixed block switching on transients
    ("mono_transients", dict(bitrate_kbps=64), False, 44100),
]


@needs_lame
@pytest.mark.parametrize("name,kw,stereo,sr", LAME_CASES,
                         ids=[c[0] for c in LAME_CASES])
def test_layer3_lame_stream_vs_ref(name, kw, stereo, sr):
    """Real lame-encoded streams (bit reservoir, ms/intensity stereo, block
    switching) decode identically to mpg123 at the float32 floor."""
    x = _sig(sr, sr, seed=11, noise=0.01).astype(np.float32)
    if name == "mono_transients":
        # click train: forces window switching (short/mixed blocks)
        x = x * 0.1
        x[::4096] = 0.95
    if stereo:
        x = np.stack([x, np.roll(x, 97) * -0.8], axis=1)
    stream = mpeg_ref.lame_encode(x, sr, **kw)
    assert _ref_diff(stream) < FLOAT32_FLOOR


# --- Layer III: in-repo encoder -------------------------------------------


def test_encoder_roundtrip_snr():
    """encode_mp3 -> decode_mp3 reconstructs tonal audio above 20 dB SNR at
    the filterbank's 576-sample encode+decode delay (fixture-grade: table-13
    Huffman, no psychoacoustics)."""
    sr = 44100
    x = _sig(2 * sr, sr, seed=3) * np.hanning(2 * sr)
    stream = encode_mp3(x, sr)
    pcm, osr = decode_mp3(stream)
    assert osr == sr
    y = pcm[:, 0]
    d = 576
    n = min(len(x), len(y) - d)
    assert _snr(y[d + 2000:d + n - 2000], x[2000:n - 2000]) > 20.0


@needs_ref
def test_encoder_stream_vs_ref():
    """The in-repo encoder emits spec-valid streams: mpg123 accepts them and
    produces the same PCM as our decoder (mono and stereo)."""
    sr = 44100
    x = _sig(sr, sr, seed=5) * np.hanning(sr)
    assert _ref_diff(encode_mp3(x, sr)) < FLOAT32_FLOOR
    xs = np.stack([x, -0.5 * x], axis=1)
    assert _ref_diff(encode_mp3(xs, sr)) < FLOAT32_FLOOR


@needs_ref
def test_layer3_composed_sparse_spectrum_vs_ref():
    """Hand-composed Layer III frames (count1-only and big-value granules)
    decode identically in both decoders — direct bit-level control of the
    side info + Huffman part, independent of the encoder."""
    from hpfw_jax.io._mp3_huffman import BIG_VALUE_TABLES, COUNT1_TABLES

    inv13 = {v: k for k, v in BIG_VALUE_TABLES[13][1].items()}
    invB = {v: k for k, v in COUNT1_TABLES[1].items()}
    # granule A: four big-value pairs then count1 quads
    bits = []
    for (xv, yv), (sx, sy) in zip([(3, 1), (0, 2), (5, 5), (1, 0)],
                                  [(0, 1), (0, 0), (1, 1), (1, 0)]):
        bits.append(inv13[(xv, yv)])
        if xv:
            bits.append(str(sx))
        if yv:
            bits.append(str(sy))
    for quad in [(1, 0, 1, 0), (0, 0, 0, 1)]:
        bits.append(invB[quad])
        for q in quad:
            if q:
                bits.append("0")
    ga = dict(big_values=4, global_gain=200, table_select=(13, 13, 13),
              region0_count=15, region1_count=7, count1table_select=1,
              huff_bits="".join(bits))
    # granule B: silent
    gb = dict()
    stream = layer3_frame([[ga], [gb]], bitrate_idx=13, sr_idx=1, mode=3)
    assert _ref_diff(stream * 3) < FLOAT32_FLOOR


# --- Layer III: intensity stereo (probe-composed; ISO 2.4.3.4.9.3) ---------


def _hl3_pairs(coded_vals):
    """coded position -> signed value dict, as table-13 big-value bits."""
    from hpfw_jax.io._mp3_huffman import BIG_VALUE_TABLES

    inv13 = {v: k for k, v in BIG_VALUE_TABLES[13][1].items()}
    if not coded_vals:
        return 0, ""
    n_pairs = (max(coded_vals) + 2) // 2
    bits = []
    for i in range(n_pairs):
        x = coded_vals.get(2 * i, 0)
        y = coded_vals.get(2 * i + 1, 0)
        bits.append(inv13[(abs(x), abs(y))])
        if x:
            bits.append("1" if x < 0 else "0")
        if y:
            bits.append("1" if y < 0 else "0")
    return n_pairs, "".join(bits)


def _l3_granule(coded_vals, scf_bits, kind="long", gg=210):
    n_pairs, bits = _hl3_pairs(coded_vals)
    g = dict(big_values=n_pairs, global_gain=gg, scalefac_compress=13,
             table_select=(13, 13, 13), region0_count=15, region1_count=7,
             count1table_select=0, scf_bits=scf_bits, huff_bits=bits)
    if kind != "long":
        g.update(window_switching=1, block_type=2,
                 mixed_block=1 if kind == "mixed" else 0,
                 table_select=(13, 13, 0), subblock_gain=(0, 0, 0))
    return g


_IS_CASES = [(kind, mode_ext, variant)
             for kind in ("long", "short", "mixed")
             for mode_ext in (1, 3)
             for variant in range(4)]


@needs_ref
@pytest.mark.parametrize("kind,mode_ext,variant", _IS_CASES,
                         ids=[f"{k}-me{m}-v{v}" for k, m, v in _IS_CASES])
def test_intensity_stereo_vs_ref(kind, mode_ext, variant):
    """Intensity (and MS+intensity) streams decode identically to mpg123:
    random is_pos per band incl. the illegal 7, zero boundaries at varied
    positions, per-window short-block positions, mixed-block long parts,
    and the untransmitted last band inheriting its predecessor."""
    rng = np.random.default_rng(97 * variant + mode_ext + len(kind))
    n_scf = {"long": 21, "short": 36, "mixed": 35}[kind]
    left = {2 * i: int(rng.integers(-7, 8)) for i in range(40)}
    left[140] = 5
    if kind == "long":
        left[400] = 3
    right = [{}, {2 * i: int(rng.integers(-3, 4)) for i in range(20)},
             {130: 1}, {120: 1}][variant]
    gl = _l3_granule(left, [(0, 3)] * n_scf, kind)
    gr = _l3_granule(right, [(int(rng.integers(0, 8)), 3)
                             for _ in range(n_scf)], kind)
    granules = [[gl, gr], [dict(gl), dict(gr)]]
    stream = layer3_frame(granules, bitrate_idx=13, sr_idx=1, mode=1,
                          mode_ext=mode_ext) * 3
    assert _ref_diff(stream) < FLOAT32_FLOOR


def test_intensity_split_matches_tan_law():
    """Offline analytical check: a lone left-channel line in an intensity
    band splits by l/r = tan(is_pos*pi/12) with unchanged total energy."""
    for p in (1, 2, 3, 4, 5):
        gl = _l3_granule({140: 5}, [(0, 3)] * 21)
        gr = _l3_granule({}, [(p if j == 15 else 0, 3) for j in range(21)])
        granules = [[gl, gr], [dict(gl), dict(gr)]]
        stream = layer3_frame(granules, bitrate_idx=13, sr_idx=1, mode=1,
                              mode_ext=1) * 3
        pcm, _ = decode_mp3(stream)
        seg = pcm[1152:2304]
        al = np.abs(seg[:, 0]).max()
        ar = np.abs(seg[:, 1]).max()
        np.testing.assert_allclose(al / ar, np.tan(p * np.pi / 12.0),
                                   rtol=1e-9)


# --- Malformed / out-of-spec streams ---------------------------------------


@needs_ref
def test_out_of_spec_intensity_positions_vs_ref():
    """MPEG-1 is_pos 8..15 (encodable when slen > 3) are out-of-spec; the
    reference decoder applies its table's raw tan-law extension and so do
    we (position 9 excluded: the reference hits the tan pole and emits
    NaN; ours yields the finite float64 pole value — both garbage)."""
    for p in (7, 8, 10, 12, 15):
        scf_bits = [(p if sfb == 8 else 0, 4 if sfb < 11 else 2)
                    for sfb in range(21)]
        gr = dict(big_values=0, global_gain=210, scalefac_compress=14,
                  table_select=(0, 0, 0), region0_count=0, region1_count=0,
                  count1table_select=0, scf_bits=scf_bits, huff_bits="")
        gl = _l3_granule({38: 5}, [(0, 0)] * 21)
        stream = layer3_frame([[gl, gr], [dict(gl), dict(gr)]],
                              bitrate_idx=13, sr_idx=1, mode=1,
                              mode_ext=1) * 3
        assert _ref_diff(stream) < FLOAT32_FLOOR, f"is_pos={p}"


def test_malformed_frames_degrade_gracefully():
    """Spec-illegal field values must not crash either decoder: oversized
    big_values (> 288 pairs), part2_3_length past the reservoir, and
    frames too small for their side info all decode to (possibly shorter)
    finite PCM, identically in the NumPy and C++ paths."""
    import struct

    def both(stream):
        a, _ = decode_mp3(stream)
        assert np.isfinite(a).all()
        if native.available():
            b, _ = native.decode_mp3(stream)
            assert np.isfinite(b).all()
            m = _mono32(a)
            assert m.shape == b.shape
            np.testing.assert_array_equal(m, b)
        return a

    bad = dict(_l3_granule({38: 5}, ()), big_values=400)
    both(layer3_frame([[bad], [dict()]], bitrate_idx=13, sr_idx=1,
                      mode=3) * 2)

    # patch part2_3_length (12 bits at offset 54 in a mono MPEG-1 frame)
    # to 4095 so the granule claims main data far past the reservoir
    g = dict(big_values=100, global_gain=210, table_select=(13, 13, 13),
             region0_count=15, region1_count=7, count1table_select=0,
             huff_bits="")
    s = bytearray(layer3_frame([[dict(g)], [dict(g)]], bitrate_idx=1,
                               sr_idx=1, mode=3))
    for i in range(12):
        s[(54 + i) >> 3] |= 1 << (7 - ((54 + i) & 7))
    both(bytes(s) * 2)

    hdr = (0xFFE00000 | (2 << 19) | (1 << 17) | (1 << 16) | (1 << 12)
           | (1 << 10))  # LSF Layer III 8 kbps 24 kHz stereo
    frame = struct.pack(">I", hdr) + b"\x00" * (72 * 8000 // 24000 - 4)
    both(frame * 3)


def _strip_bitrate(stream):
    """Rewrite every frame header's bitrate field to 0 (free format);
    the bytes are otherwise unchanged, so a free-format-capable decoder
    must produce the identical PCM."""
    b = bytearray(stream)
    pos = 0
    while pos + 4 <= len(b):
        try:
            h = FrameHeader(int.from_bytes(b[pos:pos + 4], "big"))
        except ValueError:
            break
        if h.frame_bytes == 0:
            break
        b[pos + 2] &= 0x0F
        pos += h.frame_bytes
    return bytes(b)


@needs_lame
def test_free_format_streams():
    """Free format (bitrate index 0): the frame size is measured from the
    next matching sync (padding-adjusted, Layer I in 4-byte slots). A
    bitrate-stripped stream must decode byte-identically to the original
    in our decoder AND in mpg123, and the twins must agree."""
    sr = 44100  # 417/418-byte padding alternation exercises the slot logic
    x = (0.4 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr)).astype(
        np.float32)
    orig = mpeg_ref.lame_encode(x, sr, 128)
    free = _strip_bitrate(orig)
    a, sra = decode_mp3(orig)
    b, srb = decode_mp3(free)
    assert sra == srb and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    assert _ref_diff(free) < FLOAT32_FLOOR
    if native.available():
        na, _ = native.decode_mp3(free)
        np.testing.assert_array_equal(na, _mono32(b))
    # LSF free format too
    x2 = (0.4 * np.sin(2 * np.pi * 440 * np.arange(22050) / 22050)).astype(
        np.float32)
    free2 = _strip_bitrate(mpeg_ref.lame_encode(x2, 22050, 64))
    assert _ref_diff(free2) < FLOAT32_FLOOR
    assert wav._looks_like_mpeg(free)


@needs_twolame
def test_crc_protected_frames():
    """protection=0 streams carry a 16-bit CRC after the header; the
    decoder skips it (like a reference decoder with a passing check) and
    decodes at the float32 floor, in both twins."""
    x = (0.4 * np.sin(2 * np.pi * 440 * np.arange(44100) / 44100)).astype(
        np.float32)
    stream = mpeg_ref.twolame_encode(x, 44100, 128, error_protection=True)
    assert FrameHeader(int.from_bytes(stream[:4], "big")).protection == 0
    assert _ref_diff(stream) < FLOAT32_FLOOR
    if native.available():
        na, _ = native.decode_mp3(stream)
        np.testing.assert_array_equal(na, _mono32(decode_mp3(stream)[0]))


@needs_twolame
def test_free_format_layer2():
    x = (0.4 * np.sin(2 * np.pi * 440 * np.arange(48000) / 48000)).astype(
        np.float32)
    orig = mpeg_ref.twolame_encode(x, 48000, 192)
    free = _strip_bitrate(orig)
    a, _ = decode_mp3(orig)
    b, _ = decode_mp3(free)
    np.testing.assert_array_equal(a, b)
    assert _ref_diff(free) < FLOAT32_FLOOR


def test_spurious_free_sync_resyncs():
    """A junk prefix that happens to parse as a free-format header must be
    skipped like any other false sync — the real stream decodes fully in
    both decoders and the sniff still routes the file (review finding)."""
    sr = 44100
    x = 0.4 * np.sin(2 * np.pi * 440 * np.arange(sr // 2) / sr)
    stream = encode_mp3(x, sr)
    junk = bytes([0xFF, 0xFB, 0x00, 0x00]) + b"\x00" * 32  # bitrate-0 sync
    a, _ = decode_mp3(stream)
    b, _ = decode_mp3(junk + stream)
    np.testing.assert_array_equal(a, b)
    if native.available():
        na, _ = native.decode_mp3(junk + stream)
        np.testing.assert_array_equal(na, _mono32(a))
    assert wav._looks_like_mpeg(junk + stream)


def test_mp3_fuzz_no_crash():
    """Random corruptions and random bytes must decode (possibly to less
    audio) or raise ValueError — never crash, hang, or emit non-finite
    PCM — in both decoders."""
    rng = np.random.default_rng(8)
    sr = 44100
    x = 0.4 * np.sin(2 * np.pi * 440 * np.arange(sr // 2) / sr)
    blob = bytearray(encode_mp3(x, sr))
    cases = []
    for _ in range(40):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] ^= int(rng.integers(1, 256))
        cases.append(bytes(b))
    for _ in range(20):
        cases.append(rng.integers(0, 256, int(rng.integers(10, 4000)),
                                  dtype=np.uint8).tobytes())
    for data in cases:
        try:
            pcm, _ = decode_mp3(data)
            assert np.isfinite(pcm).all()
        except ValueError:
            pass
        if native.available():
            try:
                pcm, _ = native.decode_mp3(data)
                assert np.isfinite(pcm).all()
            except ValueError:
                pass


def test_large_wav_sniff_is_fast():
    """_looks_like_mpeg must not scan whole sync-free files (it rejects
    syncs past 4 KiB anyway)."""
    import time

    data = b"RIFF\x00\x00\x00\x00WAVE" + b"\x00" * (20 << 20)
    t0 = time.perf_counter()
    assert not wav._looks_like_mpeg(data)
    assert time.perf_counter() - t0 < 0.1


# --- Stream handling -------------------------------------------------------


def test_id3_tag_skipped():
    sr = 44100
    x = _sig(sr // 2, sr, seed=9) * 0.5
    stream = encode_mp3(x, sr)
    body = b"x" * 100
    tag = b"ID3\x04\x00\x00" + bytes(
        [(len(body) >> 21) & 0x7F, (len(body) >> 14) & 0x7F,
         (len(body) >> 7) & 0x7F, len(body) & 0x7F]) + body
    a, sra = decode_mp3(stream)
    b, srb = decode_mp3(tag + stream)
    assert sra == srb and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_garbage_prefix_resync():
    """Leading junk before the first sync word is skipped."""
    sr = 44100
    x = _sig(sr // 2, sr, seed=9) * 0.5
    stream = encode_mp3(x, sr)
    a, _ = decode_mp3(stream)
    b, _ = decode_mp3(b"\x00\x12junk" + stream)
    np.testing.assert_array_equal(a, b)


def test_truncated_final_frame():
    """A mid-frame truncation drops only the incomplete frame."""
    sr = 44100
    x = _sig(sr // 2, sr, seed=9) * 0.5
    stream = encode_mp3(x, sr)
    full, _ = decode_mp3(stream)
    cut, _ = decode_mp3(stream[:-100])
    assert cut.shape[0] == full.shape[0] - 1152
    np.testing.assert_array_equal(full[:cut.shape[0]], cut)


# --- MPEG-2 LSF / MPEG-2.5 -------------------------------------------------


LSF_RATES = (22050, 24000, 16000)
V25_RATES = (11025, 12000, 8000)


@needs_lame
@pytest.mark.parametrize("sr", LSF_RATES + V25_RATES)
def test_lsf_lame_streams_vs_ref(sr):
    """MPEG-2 LSF (and 2.5) Layer III lame streams decode at the float32
    floor: all 6 low/quarter sample rates, long + window-switching frames,
    joint and dual stereo, with and without the bit reservoir."""
    rng = np.random.default_rng(sr)
    t = np.arange(2 * sr) / sr
    x = (0.4 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 1870 * t * (sr / 22050))
         + 0.01 * rng.standard_normal(2 * sr)).astype(np.float32)
    assert _ref_diff(mpeg_ref.lame_encode(x, sr, 32)) < FLOAT32_FLOOR
    xc = (x * 0.1).copy()
    xc[::2048] = 0.95  # transients: short blocks + start/stop blocks
    assert _ref_diff(mpeg_ref.lame_encode(xc, sr, 24)) < FLOAT32_FLOOR
    xs = np.stack([x, np.roll(x, 97) * -0.8], axis=1)
    assert _ref_diff(mpeg_ref.lame_encode(xs, sr, 48)) < FLOAT32_FLOOR
    assert _ref_diff(
        mpeg_ref.lame_encode(x, sr, 32, reservoir=False)) < FLOAT32_FLOOR


@needs_twolame
@pytest.mark.parametrize("sr", (44100, 48000, 32000) + LSF_RATES)
def test_layer2_twolame_streams_vs_ref(sr):
    """Real Layer II encoder streams (twolame): MPEG-1 and MPEG-2 LSF,
    mono/joint/dual stereo, decode at the float32 floor."""
    rng = np.random.default_rng(sr)
    t = np.arange(2 * sr) / sr
    x = (0.4 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 1870 * t * (sr / 22050))
         + 0.01 * rng.standard_normal(2 * sr)).astype(np.float32)
    br = 64 if sr < 32000 else 128
    assert _ref_diff(mpeg_ref.twolame_encode(x, sr, br)) < FLOAT32_FLOOR
    xs = np.stack([x, np.roll(x, 97) * -0.8], axis=1)
    assert _ref_diff(
        mpeg_ref.twolame_encode(xs, sr, 2 * br, mode=1)) < FLOAT32_FLOOR
    assert _ref_diff(
        mpeg_ref.twolame_encode(xs, sr, 2 * br, mode=0)) < FLOAT32_FLOOR


@needs_ref
def test_lsf_layer2_every_allocation_vs_ref():
    """ISO 13818-3 Table B.1 certification: every (subband, allocation)
    pair of the LSF Layer II table decodes identically to mpg123."""
    from hpfw_jax.io._mpeg_l2_tables import LSF_TABLE

    table = ALLOC_TABLES[LSF_TABLE]
    sblimit = len(table)
    budget = (144 * 160 * 1000 // 16000) * 8
    fixed = 32 + sum(r[0] for r in table)
    todo = [(sb, a) for sb in range(sblimit)
            for a in range(1, 1 << table[sb][0])]
    rng = np.random.default_rng(3)
    frames = []
    while todo:
        used = fixed
        alloc = np.zeros((sblimit, 1), dtype=np.int64)
        digits = np.zeros((36, sblimit, 1), dtype=np.int64)
        scfsi = rng.integers(0, 4, size=(sblimit, 1))
        scf = rng.integers(0, 63, size=(sblimit, 1, 3))
        taken = set()
        rest = []
        for sb, a in todo:
            from hpfw_jax.io._mp3_layer2 import SCFSI_MAP

            n = table[sb][1][a - 1]
            cost = 2 + SCFSI_MAP[int(scfsi[sb, 0])][0] * 6 \
                + 12 * _l2_sample_bits(n)
            if sb in taken or used + cost > budget:
                rest.append((sb, a))
                continue
            taken.add(sb)
            used += cost
            alloc[sb, 0] = a
            digits[:, sb, 0] = rng.integers(0, n, size=36)
            digits[0, sb, 0] = 0
            digits[1, sb, 0] = n - 1
        frames.append(layer2_frame(digits, alloc, scfsi, scf,
                                   bitrate_idx=14, sr_idx=2, lsf=True))
        assert len(rest) < len(todo)
        todo = rest
    assert _ref_diff(b"".join(frames)) < FLOAT32_FLOOR


@needs_ref
def test_lsf_layer1_every_allocation_vs_ref():
    """LSF Layer I: every (subband, allocation code) pair vs mpg123."""
    rng = np.random.default_rng(0)
    budget = (12 * 256000 // 16000) * 4 * 8
    todo = [(sb, a) for a in range(1, 15) for sb in range(32)]
    frames = []
    while todo:
        used = 32 + 128
        alloc = np.zeros(32, dtype=np.int64)
        codes = np.zeros((12, 32), dtype=np.int64)
        scf = rng.integers(0, 63, size=32)
        taken = set()
        rest = []
        for sb, a in todo:
            cost = 6 + 12 * (a + 1)
            if sb in taken or used + cost > budget:
                rest.append((sb, a))
                continue
            taken.add(sb)
            used += cost
            alloc[sb] = a
            nb = a + 1
            codes[:, sb] = rng.integers(0, (1 << nb) - 1, size=12)
            codes[0, sb] = 0
            codes[1, sb] = (1 << nb) - 2
        frames.append(layer1_frame_mono(codes, alloc, scf, bitrate_idx=14,
                                        sr_idx=2, lsf=True))
        assert len(rest) < len(todo)
        todo = rest
    assert _ref_diff(b"".join(frames)) < FLOAT32_FLOOR


def _lsf_granule(coded_vals, sc, scf_bits, kind="long", gg=210):
    n_pairs, bits = _hl3_pairs(coded_vals)
    g = dict(big_values=n_pairs, global_gain=gg, scalefac_compress=sc,
             table_select=(13, 13, 13), region0_count=15, region1_count=7,
             count1table_select=0, scf_bits=scf_bits, huff_bits=bits)
    if kind != "long":
        g.update(window_switching=1, block_type=2,
                 mixed_block=1 if kind == "mixed" else 0,
                 table_select=(13, 13, 0), subblock_gain=(0, 0, 0))
    return g


@needs_ref
@pytest.mark.parametrize("kind,mode_ext,int_scale",
                         [(k, m, i) for k in ("long", "short")
                          for m in (1, 3) for i in (0, 1)])
def test_lsf_intensity_vs_ref(kind, mode_ext, int_scale):
    """LSF intensity stereo (ISO 13818-3 2.4.3.4): io^ceil(p/2) law with
    io selected by intensity_scale, illegal = the slot's all-ones value,
    MS fallback — composed probes decode identically to mpg123.

    Mixed blocks are deliberately excluded: mpg123 approximates the mixed
    short part with window-independent long-style bands, which cannot
    express the ISO per-window is_pos semantics; this decoder follows the
    spec there (no real encoder emits LSF mixed intensity streams), and
    the C++ twin matches it bit-for-bit (test_native_twin_lsf)."""
    rng = np.random.default_rng(mode_ext * 7 + int_scale)
    n_scf = {"long": 21, "short": 36}[kind]
    sc_r = 258 + int_scale  # IS-channel decomposition: slen (3,3,3)
    for variant in range(3):
        left = {2 * i: int(rng.integers(-7, 8)) for i in range(40)}
        left[200] = 5
        right = [{}, {2 * i: int(rng.integers(-3, 4)) for i in range(15)},
                 {100: 1}][variant]
        gl = _lsf_granule(left, 0,
                          [(0, 0)] * (21 if kind == "long" else 36), kind)
        gr = _lsf_granule(right, sc_r,
                          [(int(rng.integers(0, 8)), 3)
                           for _ in range(n_scf)], kind)
        stream = layer3_frame([[gl, gr]], bitrate_idx=14, sr_idx=0,
                              mode=1, mode_ext=mode_ext, version=2) * 4
        assert _ref_diff(stream) < FLOAT32_FLOOR


@needs_ref
def test_lsf_scalefactor_partitions_vs_ref():
    """LSF 9-bit scalefac_compress decomposition: one composed stream per
    partition class (sc < 400 / < 500 / >= 500, incl. the implied
    preflag), each certified against mpg123."""
    rng = np.random.default_rng(1)
    coded = {2 * i: int(rng.integers(-7, 8)) for i in range(40)}
    for sc in (101, 303, 399, 404, 460, 499, 500, 505, 511):
        from hpfw_jax.io._mp3_layer3 import _NR_OF_SFB, _lsf_slen

        class _G:
            scalefac_compress = sc
            window_switching = 0
            block_type = 0
            mixed_block = 0

        slen, bn, _pre, _ = _lsf_slen(_G, False)
        counts = _NR_OF_SFB[bn][0]
        scf_bits = []
        for i in range(4):
            scf_bits += [(int(rng.integers(0, 1 << slen[i])), slen[i])
                         for _ in range(counts[i])]
        g = _lsf_granule(coded, sc, scf_bits)
        stream = layer3_frame([[g]], bitrate_idx=14, sr_idx=0, mode=3,
                              version=2) * 4
        assert _ref_diff(stream) < FLOAT32_FLOOR, f"sc={sc}"


# --- C++ twin (native/hpfw_mp3.cc) -----------------------------------------

from hpfw_jax.io import native  # noqa: E402

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native library unavailable")


def _mono32(pcm):
    """The NumPy decoder's output through the documented downmix."""
    x = pcm.mean(axis=1) if pcm.shape[1] > 1 else pcm[:, 0]
    return x.astype(np.float32)


def _twin_identical(stream):
    a, sra = native.decode_mp3(stream)
    braw, srb = decode_mp3(stream)
    b = _mono32(braw)
    assert sra == srb
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@needs_native
def test_native_twin_layer1_layer2():
    """The C++ decoder is bit-identical (float32 output) to the NumPy twin
    on the exhaustive Layer I/II allocation streams."""
    rng = np.random.default_rng(0)
    pairs = [(sb, a) for a in range(1, 15) for sb in range(32)]
    _twin_identical(b"".join(_layer1_frames_covering(pairs, rng)))
    for ti, rep in _distinct_l2_tables():
        rng = np.random.default_rng(ti)
        _twin_identical(b"".join(_l2_frames_covering(ti, *rep, rng)))


@needs_native
@pytest.mark.parametrize("kind,mode_ext",
                         [(k, m) for k in ("long", "short", "mixed")
                          for m in (1, 3)])
def test_native_twin_intensity(kind, mode_ext):
    rng = np.random.default_rng(5)
    n_scf = {"long": 21, "short": 36, "mixed": 35}[kind]
    left = {2 * i: int(rng.integers(-7, 8)) for i in range(40)}
    left[140] = 5
    gl = _l3_granule(left, [(0, 3)] * n_scf, kind)
    gr = _l3_granule({120: 1}, [(int(rng.integers(0, 8)), 3)
                                for _ in range(n_scf)], kind)
    granules = [[gl, gr], [dict(gl), dict(gr)]]
    _twin_identical(layer3_frame(granules, bitrate_idx=13, sr_idx=1,
                                 mode=1, mode_ext=mode_ext) * 3)


@needs_native
def test_native_twin_layer3_streams():
    """Encoder output, ID3 tags, garbage prefixes, and truncated final
    frames take identical paths in both decoders."""
    sr = 44100
    x = _sig(sr, sr, seed=7) * np.hanning(sr)
    s = encode_mp3(x, sr)
    _twin_identical(s)
    tag = b"ID3\x03\x00\x00\x00\x00\x00\x05" + b"\x00" * 5
    _twin_identical(tag + s)
    _twin_identical(s[:-100])
    _twin_identical(b"\x01\x02junk" + s)
    xs = np.stack([x, -0.5 * x], axis=1)
    _twin_identical(encode_mp3(xs, sr))


@needs_native
@needs_lame
def test_native_twin_lsf():
    """LSF/2.5 parity between the decoders: lame streams at all 6 low
    rates, plus composed LSF intensity streams for every block kind —
    including the mixed-block case where both follow ISO rather than
    mpg123's long-band approximation."""
    rng = np.random.default_rng(2)
    for sr in LSF_RATES + V25_RATES:
        t = np.arange(sr) / sr
        x = (0.4 * np.sin(2 * np.pi * 440 * t)
             + 0.01 * rng.standard_normal(sr)).astype(np.float32)
        _twin_identical(mpeg_ref.lame_encode(x, sr, 32))
        xs = np.stack([x, -0.7 * x], axis=1)
        _twin_identical(mpeg_ref.lame_encode(xs, sr, 48))
    for kind, n_scf in (("long", 21), ("short", 36), ("mixed", 33)):
        for mode_ext in (1, 3):
            left = {2 * i: int(rng.integers(-7, 8)) for i in range(40)}
            gl = _lsf_granule(left, 0, [(0, 0)] * n_scf, kind)
            gr = _lsf_granule({100: 1}, 259,
                              [(int(rng.integers(0, 8)), 3)
                               for _ in range(n_scf)], kind)
            _twin_identical(layer3_frame([[gl, gr]], bitrate_idx=14,
                                         sr_idx=0, mode=1,
                                         mode_ext=mode_ext, version=2) * 4)


@needs_native
@needs_twolame
def test_native_twin_twolame():
    rng = np.random.default_rng(4)
    for sr in (44100, 22050, 16000):
        t = np.arange(sr) / sr
        x = (0.4 * np.sin(2 * np.pi * 440 * t)
             + 0.01 * rng.standard_normal(sr)).astype(np.float32)
        br = 64 if sr < 32000 else 128
        _twin_identical(mpeg_ref.twolame_encode(x, sr, br))
        xs = np.stack([x, -0.6 * x], axis=1)
        _twin_identical(mpeg_ref.twolame_encode(xs, sr, 2 * br, mode=1))


@needs_native
@needs_lame
def test_native_twin_lame_streams():
    sr = 44100
    x = _sig(sr, sr, seed=11, noise=0.01).astype(np.float32)
    _twin_identical(mpeg_ref.lame_encode(x, sr, 128))
    xc = (x * 0.1).copy()
    xc[::4096] = 0.95  # transients: short/mixed blocks
    _twin_identical(mpeg_ref.lame_encode(xc, sr, 64))
    xs = np.stack([x, np.roll(x, 97) * -0.8], axis=1)
    _twin_identical(mpeg_ref.lame_encode(xs, sr, 96))


# --- load_audio dispatch ---------------------------------------------------


def test_load_audio_dispatch_mp3(tmp_path):
    """load_audio detects headerless MP3 by the two-frame heuristic,
    downmixes to mono float32, and resamples to the config rate."""
    sr = 44100
    x = _sig(sr, sr, seed=13) * 0.5
    xs = np.stack([x, np.roll(x, 50)], axis=1)
    p = tmp_path / "clip.mp3"
    p.write_bytes(encode_mp3(xs, sr))
    cfg = HpfwConfig()
    pcm, got_sr = wav.load_audio(str(p), cfg)
    assert got_sr == cfg.sample_rate
    assert pcm.dtype == np.float32 and pcm.ndim == 1
    # duration preserved through decode+resample (filterbank delay aside)
    assert abs(pcm.shape[0] - x.shape[0] * cfg.sample_rate / sr) < 0.1 * sr

    # ID3-tagged variant dispatches too
    p2 = tmp_path / "tagged.mp3"
    p2.write_bytes(b"ID3\x03\x00\x00\x00\x00\x00\x0a" + b"\x00" * 10
                   + encode_mp3(x, sr))
    pcm2, sr2 = wav.load_audio(str(p2), cfg)
    assert sr2 == cfg.sample_rate and pcm2.ndim == 1


def test_looks_like_mpeg_rejects_other_binaries():
    rng = np.random.default_rng(0)
    assert not wav._looks_like_mpeg(rng.integers(0, 256, 8192,
                                                 dtype=np.uint8).tobytes())
    assert not wav._looks_like_mpeg(b"RIFF\x00\x00\x00\x00WAVE" + b"\x00" * 64)
    assert not wav._looks_like_mpeg(b"\xff\xfb" + b"\x00" * 64)  # bad header


def test_fingerprint_identical_across_codecs(tmp_path):
    """The full pipeline contract: the same audio through WAV and MP3 paths
    yields overwhelmingly similar hashprints (lossy codec, same config)."""
    from hpfw_jax import api

    cfg = HpfwConfig()
    sr = cfg.sample_rate
    x = _sig(6 * sr, sr, seed=21, noise=0.005).astype(np.float32) * 0.5
    pw = tmp_path / "a.wav"
    wav.save_wav(str(pw), x, sr)
    pm = tmp_path / "a.mp3"
    # 44.1k encode (MPEG-1 has no 22.05k); load resamples back to cfg rate
    x44 = wav.resample(x, sr, 44100)
    pm.write_bytes(encode_mp3(x44.astype(np.float64), 44100))
    rng = np.random.default_rng(0)
    filters = rng.standard_normal(
        (cfg.n_bins * cfg.context_w, 64)).astype(np.float32)
    pcm_w, _ = wav.load_audio(str(pw), cfg)
    pcm_m, _ = wav.load_audio(str(pm), cfg)
    fp_w = np.asarray(api.fingerprint(pcm_w, filters, cfg))
    fp_m = np.asarray(api.fingerprint(pcm_m, filters, cfg))
    n = min(len(fp_w), len(fp_m))
    assert n > 0
    diff = np.bitwise_xor(fp_w[:n], fp_m[:n])
    bits = int(np.bitwise_count(diff).sum())
    frac = bits / (64.0 * n)
    assert frac < 0.35, f"hashprint bit disagreement {frac:.2f}"
