"""AAC-LC decoder certification against the system reference decoder.

The from-spec decoder (io/aac.py, tables probe-recovered by
tools/recover_aac_tables.py) must match libavcodec's AAC decoder
sample-exactly at the float32 floor on REAL encoder streams — the same
certification bar the MPEG decoder meets against libmpg123 and the Vorbis
decoder against libvorbisfile. Composed-bitstream tests cover the paths
no encoder emits (pulse data, every TNS coefficient table, explicit
escape values), using the same frame composer the recovery tool probes
with.

Everything here is skipped when the libavcodec shim is unavailable
(io/aac_ref.py builds it on demand; this environment ships the
libraries).
"""

import os
import sys

import numpy as np
import pytest

from hpfw_jax.io import aac_ref, wav
from hpfw_jax.io.aac import (TNS_MAX_BANDS_LONG, TNS_MAX_BANDS_SHORT,
                             decode_aac)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

pytestmark = pytest.mark.skipif(not aac_ref.available(),
                                reason="libavcodec shim unavailable")

TOL = 4e-6   # absolute, on float32 PCM in [-1, 1] (float32-floor scale)


def _sig(sr, secs, ch, seed=7):
    """Attack-rich test content: onsets (short blocks + TNS), a swept
    partial, and noise (PNS at low bitrates)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * secs)) / sr
    x = (0.3 * np.sin(2 * np.pi * 330 * t) * np.exp(-((t % 0.5) / 0.12) ** 2)
         + 0.2 * np.sin(2 * np.pi * (880 + 200 * np.sin(2 * np.pi * 0.5 * t))
                        * t)
         + 0.04 * rng.standard_normal(t.size))
    if ch == 2:
        y = np.roll(x, 777) * 0.8 + 0.05 * rng.standard_normal(t.size)
        return np.stack([x, y], 1).astype(np.float32)
    return x.astype(np.float32)


def _certify(pcm, sr, kbps):
    blob = aac_ref.aac_encode(pcm, sr, kbps)
    ref, sr_ref = aac_ref.aac_decode_ref(blob)
    mine, sr_mine = decode_aac(blob)
    assert sr_mine == sr_ref
    n = min(len(ref), len(mine))
    assert n >= len(ref) - 2048
    d = float(np.abs(ref[:n] - np.atleast_2d(mine.T).T[:n]).max())
    assert d < TOL, f"max|diff| {d} at {sr} Hz {kbps} kbps"
    return blob


@pytest.mark.parametrize("sr", [8000, 11025, 16000, 22050, 32000, 44100,
                                48000, 96000])
def test_real_stream_mono(sr):
    _certify(_sig(sr, 1.5, 1), sr, 32)
    _certify(_sig(sr, 1.5, 1, seed=8), sr, 128)


@pytest.mark.parametrize("sr", [8000, 22050, 44100, 48000])
def test_real_stream_stereo(sr):
    """Stereo exercises CPE with common windows, M/S and (at low rates)
    intensity bands — verified exercised by the feature spy during
    development."""
    _certify(_sig(sr, 1.5, 2), sr, 32)
    _certify(_sig(sr, 1.5, 2, seed=9), sr, 128)


def test_correlated_stereo_low_bitrate():
    """Near-identical channels at low bitrate bait intensity stereo and
    grouped M/S masks."""
    sr = 22050
    _certify(_sig(sr, 2.0, 2, seed=11), sr, 24)
    x = _sig(sr, 2.0, 1, seed=12)
    pcm = np.stack([x, 0.9 * x], 1)
    _certify(pcm, sr, 24)


# --------------------------------------------------------------- composed

def _tool():
    import tools.recover_aac_tables as R

    return R


def test_composed_pulse():
    """No encoder emits pulse data; certify the probe-pinned semantics
    (amplitude adds toward the coefficient's sign, zero goes negative)."""
    R = _tool()
    import json

    b1 = json.load(open(os.path.join(R.OUT_DIR, "spec_book_1.json")))
    cw = {tuple(v): c for c, v in b1.items()}
    sf0 = R._sf0_bits()
    offs = json.load(open(os.path.join(R.OUT_DIR, "swb_long.json")))["44100"]
    nq = offs[12] // 4

    def pulse_bits(start_sfb, pulses):
        w = R.BitWriter()
        w.put(len(pulses) - 1, 2)
        w.put(start_sfb, 6)
        for off, amp in pulses:
            w.put(off, 5)
            w.put(amp, 4)
        return "".join(str(b) for b in w.bits)

    vals = {10: 1, 14: -1}
    spec = "".join(cw[tuple(vals.get(4 * q + i, 0) for i in range(4))]
                   for q in range(nq))
    payload = R.compose_sce(150, 12, [(1, 12)], sf_bits=sf0 * 12,
                            spec_bits=spec,
                            pulse_bits=pulse_bits(2, [(2, 5), (4, 7)]))
    z = R.zero_frame()
    blob = R.stream(4, [payload, z, z])
    ref, _ = aac_ref.aac_decode_ref(blob)
    mine, _ = decode_aac(blob)
    n = min(len(ref), len(mine))
    assert float(np.abs(ref[:n, 0] - mine[:n, 0]).max()) < TOL


def test_composed_tns_all_tables():
    """Order-1 TNS under every (coef_res, coef_compress) combination —
    the compressed tables keep the OUTER quarters of the wider ladder
    (the bug real streams caught during development)."""
    R = _tool()
    import json

    b1 = json.load(open(os.path.join(R.OUT_DIR, "spec_book_1.json")))
    cw = {tuple(v): c for c, v in b1.items()}
    sf0 = R._sf0_bits()
    offs = json.load(open(os.path.join(R.OUT_DIR, "swb_long.json")))["44100"]
    MAX = 40
    nq = offs[MAX] // 4
    imp = cw[(0, 0, 0, 0)] * 100 + cw[(1, 0, 0, 0)] \
        + cw[(0, 0, 0, 0)] * (nq - 101)
    z = R.zero_frame()
    for res, comp in ((0, 0), (1, 0), (0, 1), (1, 1)):
        nbits = res + 3 - comp
        for code in (1, (1 << nbits) - 1):
            w = R.BitWriter()
            w.put(1, 2)
            w.put(res, 1)
            w.put(MAX, 6)
            w.put(1, 5)
            w.put(0, 1)
            w.put(comp, 1)
            w.put(code, nbits)
            tns = "".join(str(b) for b in w.bits)
            payload = R.compose_sce(150, MAX, [(1, MAX)], sf_bits=sf0 * MAX,
                                    spec_bits=imp, tns_bits=tns)
            blob = R.stream(4, [payload, z, z])
            ref, _ = aac_ref.aac_decode_ref(blob)
            mine, _ = decode_aac(blob)
            n = min(len(ref), len(mine))
            d = float(np.abs(ref[:n, 0] - mine[:n, 0]).max())
            assert d < TOL, (res, comp, code, d)


def test_composed_escapes():
    """Codebook-11 escape words N=0..2 with signs, against the reference."""
    R = _tool()
    import json

    b11 = json.load(open(os.path.join(R.OUT_DIR, "spec_book_11.json")))
    cw16 = [c for c, v in b11.items() if v == [16, 0]][0]
    cw1616 = [c for c, v in b11.items() if v == [16, 16]][0]
    sf0 = R._sf0_bits()
    z = R.zero_frame()
    zero_unit = "0000"
    for bits in (cw16 + "0" + "00111",          # +23
                 cw16 + "1" + "1011111",        # -63
                 cw1616 + "01" + "00000" + "01000"):   # +16, -24
        payload = R.compose_sce(120, 1, [(11, 1)], sf_bits=sf0,
                                spec_bits=bits + zero_unit)
        blob = R.stream(4, [payload, z, z])
        ref, _ = aac_ref.aac_decode_ref(blob)
        mine, _ = decode_aac(blob)
        n = min(len(ref), len(mine))
        assert float(np.abs(ref[:n, 0] - mine[:n, 0]).max()) < TOL


def test_composed_pns_grouped_short():
    """PNS inside grouped short windows: the LCG draw order (group, sfb,
    window) must match the reference exactly."""
    R = _tool()
    import json

    sfbook = {int(k): v for k, v in json.load(
        open(os.path.join(R.OUT_DIR, "sf_book.json"))).items()}
    offs = json.load(open(os.path.join(R.OUT_DIR, "swb_short.json")))["22050"]
    b1 = json.load(open(os.path.join(R.OUT_DIR, "spec_book_1.json")))
    cw = {tuple(v): c for c, v in b1.items()}
    max_sfb = 6
    sections, spec, sf = [], [], ""
    for g, glen in enumerate([3, 5]):
        if g == 1:
            sections.extend([(1, 1), (13, 2), (1, max_sfb - 3)])
        else:
            sections.extend([(13, 1), (1, max_sfb - 1)])
        for s in range(max_sfb):
            noise = (g == 0 and s == 0) or (g == 1 and s in (1, 2))
            if noise:
                sf += (format(260, "09b") if (g, s) == (0, 0)
                       else sfbook[4 - 3 * (s == 2)])
                continue
            sf += sfbook[0]
            nqs = (offs[s + 1] - offs[s]) // 4
            for _ in range(glen * nqs):
                spec.append(cw[(0, 0, 0, 0)])
    payload = R.compose_sce(150, max_sfb, sections, sf_bits=sf,
                            spec_bits="".join(spec),
                            window_sequence=R.EIGHT_SHORT,
                            grouping=0b1101111)
    z = R.zero_frame()
    blob = R.stream(7, [payload, payload, z, z])   # 22050 = index 7
    ref, _ = aac_ref.aac_decode_ref(blob)
    mine, _ = decode_aac(blob)
    n = min(len(ref), len(mine))
    assert float(np.abs(ref[:n, 0] - mine[:n, 0]).max()) < TOL
    # determinism: our decoder reproduces itself
    again, _ = decode_aac(blob)
    assert np.array_equal(mine, again)


# ---------------------------------------------------------------- dispatch

def test_load_dispatch(tmp_path):
    from hpfw_jax.config import HpfwConfig

    sr = 44100
    pcm = _sig(sr, 1.0, 2, seed=3)
    blob = aac_ref.aac_encode(pcm, sr, 96)
    p = tmp_path / "clip.aac"
    p.write_bytes(blob)
    cfg = HpfwConfig()
    out, osr = wav.load_wav(str(p), cfg)
    assert osr == cfg.sample_rate
    assert out.ndim == 1 and out.dtype == np.float32
    ref, _ = aac_ref.aac_decode_ref(blob)
    assert abs(out.shape[0] - ref.shape[0] * cfg.sample_rate / sr) < 4096


def test_adts_sniff_dispatch(tmp_path):
    """The ADTS sniff claims AAC streams and rejects MP3 streams. (The
    MPEG sniff can fire on spurious syncs inside AAC payload bytes, which
    is why load_wav checks ADTS FIRST; the ADTS sniff's 3-frame chain
    keeps the reverse misroute out.)"""
    from hpfw_jax.io.mpeg_ref import lame_encode
    from hpfw_jax.io.wav import _looks_like_adts

    sr = 44100
    pcm = _sig(sr, 0.5, 1)
    aac = aac_ref.aac_encode(pcm, sr, 96)
    assert _looks_like_adts(aac)
    mp3 = lame_encode(pcm, sr, bitrate_kbps=128)
    assert not _looks_like_adts(mp3)
    ogg = b"OggS" + bytes(4096)
    assert not _looks_like_adts(ogg)


def test_malformed_streams():
    with pytest.raises(ValueError):
        decode_aac(b"\x00" * 4096)
    sr = 22050
    blob = aac_ref.aac_encode(_sig(sr, 0.7, 1), sr, 64)
    # truncation mid-frame: decodes the whole frames before it
    cut = decode_aac(blob[: len(blob) * 2 // 3])
    assert cut[0].shape[0] >= 1024
    ref_full, _ = aac_ref.aac_decode_ref(blob)
    n = cut[0].shape[0] - 1024   # all complete frames before the cut
    assert float(np.abs(cut[0][:n, 0] - ref_full[:n, 0]).max()) < TOL
    # HE-AAC style profile bytes are rejected, not misdecoded
    bad = bytearray(blob)
    bad[2] = (bad[2] & 0x3F) | (2 << 6)      # profile = SSR
    with pytest.raises(ValueError):
        decode_aac(bytes(bad))


def test_tns_clamp_tables_complete():
    for table in (TNS_MAX_BANDS_LONG, TNS_MAX_BANDS_SHORT):
        assert sorted(table) == sorted(aac_ref.ADTS_RATES)


# ------------------------------------------------------------ native twin

def test_native_twin_bit_identical():
    """The C++ decoder mirrors the NumPy pipeline operation for operation;
    on these streams the float32 outputs are bit-identical (any future
    accumulation-order drift is margin-tested at the float32 floor, the
    MP3-twin convention)."""
    from hpfw_jax.io import native

    if not native.available():
        pytest.skip("native library unavailable")
    for sr, ch, kbps, seed in [(22050, 1, 32, 1), (44100, 2, 32, 2),
                               (8000, 2, 32, 3), (48000, 2, 128, 4)]:
        pcm = _sig(sr, 1.2, ch, seed=seed)
        blob = aac_ref.aac_encode(pcm, sr, kbps)
        py, sr1 = decode_aac(blob)
        pymono = py.mean(axis=1).astype(np.float32)
        nat, sr2 = native.decode_aac(blob)
        assert sr1 == sr2 and len(nat) == len(pymono)
        assert float(np.abs(nat - pymono).max()) < 1e-7


def test_native_ingest_aac(tmp_path):
    """ingest_files decodes .aac files identically to load_audio."""
    from hpfw_jax.io import ingest, native
    from hpfw_jax.config import HpfwConfig

    if not native.available():
        pytest.skip("native library unavailable")
    cfg = HpfwConfig()
    paths = []
    for i in range(3):
        pcm = _sig(44100, 1.0, 2 if i % 2 else 1, seed=20 + i)
        p = tmp_path / f"t{i}.aac"
        p.write_bytes(aac_ref.aac_encode(pcm, 44100, 96))
        paths.append(str(p))
    got = ingest.load_files(paths, cfg, n_threads=2)
    for p, pcm in zip(paths, got):
        ref, sr = wav.load_wav(p, cfg)
        assert sr == cfg.sample_rate
        np.testing.assert_allclose(pcm, ref, atol=2e-6,
                                   err_msg=f"ingest != load_audio for {p}")


def test_fuzz_bitflips_never_crash():
    """Random bit flips in a valid stream must decode or raise ValueError
    — never crash (the MP3 decoder's fuzz-hardening convention)."""
    from hpfw_jax.io import native

    rng = np.random.default_rng(0)
    pcm = _sig(22050, 1.0, 1, seed=0)
    blob = bytearray(aac_ref.aac_encode(pcm, 22050, 64))
    for _ in range(150):
        b = bytearray(blob)
        for _ in range(rng.integers(1, 8)):
            b[rng.integers(7, len(b))] ^= 1 << rng.integers(0, 8)
        try:
            decode_aac(bytes(b))
        except ValueError:
            pass
        if native.available():
            try:
                native.decode_aac(bytes(b))
            except (ValueError, RuntimeError):
                pass
