"""Opus (CELT mode) tests: from-spec decoder vs the system libopus oracle.

Certification follows the house method (SURVEY.md §4 / CLAUDE.md): fixtures
come from the REAL reference encoder (libopus via ctypes, io/opus_ref.py),
decode is compared against opus_decode_float at the float32 floor, and the
range coder is held to bit-exactness via the final-range check (the same
invariant libopus itself exposes as OPUS_GET_FINAL_RANGE). Packet-layer
parsing (RFC 6716 §3.2 codes 0-3) is unit-tested standalone, offline.

Oracle-dependent tests skip when libopus is absent; packet/container logic
tests always run.
"""

import ctypes as C

import numpy as np
import pytest

from hpfw_jax.io import wav
from hpfw_jax.io.opus import (OpusDecoder, decode_opus, decode_opus_packets,
                              parse_packet)
from hpfw_jax.io.opus_ref import (opus_ref_available, opus_ref_decode_packets,
                                  opus_ref_encode_ogg,
                                  opus_ref_encode_packets)

needs_opus = pytest.mark.skipif(not opus_ref_available(),
                                reason="system libopus unavailable")


def _sig(n, seed=0, kind="music"):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    if kind == "noise":
        return (0.3 * rng.standard_normal(n)).astype(np.float32)
    x = np.zeros(n)
    for f0, a in ((220.0, .3), (330.0, .2), (495.5, .15), (1240.0, .1)):
        x += a * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 6))
    x *= 0.4 + 0.6 * np.abs(np.sin(2 * np.pi * 0.7 * t))
    x += 0.01 * rng.standard_normal(n)
    return np.clip(x, -1, 1).astype(np.float32)


def _snr(got, want):
    n = min(len(got), len(want))
    err = got[:n].astype(np.float64) - want[:n]
    return 10 * np.log10(np.mean(want[:n] ** 2) / (np.mean(err ** 2) + 1e-30))


# -- packet layer (offline) ---------------------------------------------------

def test_parse_packet_codes():
    # code 0: one frame
    mode, bw, fs, stereo, frames = parse_packet(bytes([31 << 3]) + b"ab")
    assert (mode, bw, fs, stereo) == ("celt", "FB", 960, False)
    assert frames == [b"ab"]
    # code 1: two equal frames
    _, _, _, _, frames = parse_packet(bytes([(31 << 3) | 1]) + b"abcd")
    assert frames == [b"ab", b"cd"]
    # code 2: explicit first length
    _, _, _, _, frames = parse_packet(bytes([(31 << 3) | 2, 1]) + b"abc")
    assert frames == [b"a", b"bc"]
    # code 3 CBR: count=2
    _, _, _, _, frames = parse_packet(
        bytes([(16 << 3) | 3, 2]) + b"abcd")
    assert frames == [b"ab", b"cd"]
    # code 3 VBR with padding
    pkt = bytes([(16 << 3) | 3, 0x80 | 0x40 | 2, 2, 1]) + b"abc" + b"\x00\x00"
    _, _, _, _, frames = parse_packet(pkt)
    assert frames == [b"a", b"bc"]
    # stereo flag
    _, _, _, stereo, _ = parse_packet(bytes([(31 << 3) | 0x4]) + b"x")
    assert stereo


def test_parse_packet_rejects():
    with pytest.raises(ValueError):
        parse_packet(b"")
    with pytest.raises(ValueError):  # code-1 odd payload
        parse_packet(bytes([(31 << 3) | 1]) + b"abc")
    with pytest.raises(ValueError):  # code-3 zero frames
        parse_packet(bytes([(31 << 3) | 3, 0]))
    with pytest.raises(ValueError):  # > 120 ms
        parse_packet(bytes([(31 << 3) | 3, 7]) + b"x" * 7)
    with pytest.raises(ValueError):  # code-2 overrun
        parse_packet(bytes([(31 << 3) | 2, 200]) + b"abc")


def test_silk_mode_rejected():
    dec = OpusDecoder(1)
    with pytest.raises(ValueError, match="SILK"):
        dec.decode_packet(bytes([0]) + b"\x00" * 10)
    with pytest.raises(ValueError, match="SILK"):
        dec.decode_packet(bytes([12 << 3]) + b"\x00" * 10)


def test_garbage_payload_does_not_crash():
    """Random bytes under a valid CELT TOC must decode to SOMETHING (the
    range decoder never desyncs into unbounded state) — resilience the
    reference decoder also guarantees."""
    rng = np.random.default_rng(7)
    dec = OpusDecoder(1)
    for i in range(20):
        body = rng.integers(0, 256, rng.integers(1, 200)).astype(np.uint8)
        pcm = dec.decode_packet(bytes([31 << 3]) + body.tobytes())
        assert pcm.shape == (960, 1)
        assert np.all(np.isfinite(pcm))


# -- oracle certification -----------------------------------------------------

@needs_opus
@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("bitrate", [32_000, 96_000, 192_000])
def test_full_opus_packets_match_reference(ch, bitrate):
    """Real libopus encoder (CELT forced) -> from-spec decode == reference
    decode at the float32 floor, mono and stereo, low to high bitrate."""
    x = _sig(48_000, seed=ch * 10 + 1)
    pcm = x if ch == 1 else np.stack([x, np.roll(x, 31) * -0.7], axis=1)
    pkts = opus_ref_encode_packets(pcm, bitrate=bitrate)
    ref = opus_ref_decode_packets(pkts, channels=ch)
    mine = decode_opus_packets(pkts, ch)
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, atol=2e-4)


@needs_opus
@pytest.mark.parametrize("kind", ["music", "noise"])
def test_low_bitrate_folding_paths(kind):
    """24 kb/s stereo: the noise-fill / spectral-folding / LCG-seed paths
    (the decoder state includes the range coder's final range — the bug
    class this test pins)."""
    x = _sig(48_000, seed=3, kind=kind)
    pcm = np.stack([x, np.roll(x, 7) * 0.8], axis=1)
    pkts = opus_ref_encode_packets(pcm, bitrate=24_000)
    ref = opus_ref_decode_packets(pkts, channels=2)
    mine = decode_opus_packets(pkts, 2)
    np.testing.assert_allclose(mine, ref, atol=2e-4)


@needs_opus
def test_transient_frames_match_reference():
    """Click train forces transient (short-MDCT) frames + anti-collapse."""
    n = 48_000
    x = np.zeros(n, np.float32)
    x[::4801] = 0.9
    pkts = opus_ref_encode_packets(x, bitrate=48_000)
    ref = opus_ref_decode_packets(pkts, channels=1)
    mine = decode_opus_packets(pkts, 1)
    np.testing.assert_allclose(mine, ref, atol=2e-4)


@needs_opus
def test_final_range_bit_exact():
    """The range coder's final state matches libopus for every packet —
    bitstream consumption is bit-exact, not merely output-close."""
    lib = C.CDLL("libopus.so.0")
    lib.opus_decoder_create.restype = C.c_void_p
    lib.opus_decode_float.restype = C.c_int
    lib.opus_decode_float.argtypes = [C.c_void_p, C.c_char_p, C.c_int32,
                                      C.POINTER(C.c_float), C.c_int, C.c_int]
    err = C.c_int(0)
    ref = lib.opus_decoder_create(48_000, 1, C.byref(err))
    assert ref and err.value == 0
    OPUS_GET_FINAL_RANGE = 4031
    x = _sig(48_000 // 2, seed=5, kind="noise")
    pkts = opus_ref_encode_packets(x, bitrate=24_000)
    mine = OpusDecoder(1)
    buf = np.empty((5760, 1), np.float32)
    for pkt in pkts:
        lib.opus_decode_float(C.c_void_p(ref), pkt, len(pkt),
                              buf.ctypes.data_as(C.POINTER(C.c_float)),
                              5760, 0)
        fr = C.c_uint(0)
        lib.opus_decoder_ctl(C.c_void_p(ref), OPUS_GET_FINAL_RANGE,
                             C.byref(fr))
        mine.decode_packet(pkt)
        assert mine._celt.final_range == fr.value
    lib.opus_decoder_destroy(C.c_void_p(ref))


# -- container ----------------------------------------------------------------

@needs_opus
def test_ogg_opus_end_to_end():
    """Real-encoder Ogg Opus: exact length (pre-skip + granule trim) and
    codec-grade SNR vs the original signal."""
    x = _sig(48_000 * 2, seed=9)
    blob = opus_ref_encode_ogg(x, bitrate=96_000)
    pcm, sr = decode_opus(blob)
    assert sr == 48_000
    assert len(pcm) == len(x)
    assert _snr(pcm, x) > 20.0


@needs_opus
def test_ogg_opus_stereo_downmix():
    x = _sig(48_000, seed=11)
    xs = np.stack([x, np.roll(x, 31) * -0.7], axis=1)
    blob = opus_ref_encode_ogg(xs, bitrate=128_000)
    pcm, sr = decode_opus(blob)
    assert len(pcm) == len(x)
    assert _snr(pcm, xs.mean(axis=1)) > 15.0


@needs_opus
def test_opus_load_wav_dispatch(tmp_path, cfg):
    """load_wav sniffs OpusHead inside Ogg and resamples to cfg rate."""
    x = _sig(48_000, seed=13)
    p = tmp_path / "t.opus"
    p.write_bytes(opus_ref_encode_ogg(x, bitrate=96_000))
    pcm, sr = wav.load_wav(str(p), cfg)
    assert sr == cfg.sample_rate
    assert abs(len(pcm) - cfg.sample_rate) <= 2


def test_ogg_opus_rejects_malformed():
    with pytest.raises(ValueError):
        decode_opus(b"OggS" + b"\x00" * 64)
    # valid pages but missing OpusHead
    from hpfw_jax.io.ogg import write_pages
    blob = write_pages([(b"NotOpusH" + b"\x00" * 12, 0)])
    with pytest.raises(ValueError):
        decode_opus(blob)


# -- native twin ----------------------------------------------------------------

@needs_opus
def test_native_twin_margin_and_final_range():
    """The C++ decoder (native/hpfw_opus.cc) mirrors the NumPy pipeline
    operation for operation: the range coder's final state is bit-exact
    (proving identical bitstream consumption end to end) and the float
    synthesis sits at the float32 floor (the double pipelines differ only
    in accumulation order, MP3/AAC-twin convention)."""
    from hpfw_jax.io import native
    from hpfw_jax.io.ogg import pages_to_packets, parse_pages
    from hpfw_jax.io.opus import _parse_head

    if not native.available():
        pytest.skip("native library unavailable")
    for ch, br, kind, seed in [(1, 96_000, "music", 1),
                               (2, 64_000, "music", 2),
                               (1, 24_000, "noise", 3),
                               (2, 128_000, "music", 4)]:
        x = _sig(48_000, seed=seed, kind=kind)
        pcm_in = x if ch == 1 else np.stack([x, np.roll(x, 7) * 0.8], 1)
        blob = opus_ref_encode_ogg(pcm_in, bitrate=br)
        py, sr1 = decode_opus(blob)
        nat, sr2, fr = native.decode_opus(blob, return_final_range=True)
        assert sr1 == sr2 == 48_000
        assert py.shape == nat.shape
        assert float(np.abs(py - nat).max()) < 1e-6

        # Python-side final range on the same packet stream.
        pk = pages_to_packets(parse_pages(blob))
        chs, _, _ = _parse_head(pk[0][0])
        dec = OpusDecoder(chs)
        for p, _g in pk[2:]:
            if p:
                dec.decode_packet(p)
        assert fr == dec._celt.final_range


@needs_opus
def test_native_ingest_opus(tmp_path, cfg):
    """ingest_files decodes .opus files identically to load_audio (both
    route through the native decoder + sinc resampler)."""
    from hpfw_jax.io import ingest, native

    if not native.available():
        pytest.skip("native library unavailable")
    paths = []
    for i in range(3):
        x = _sig(48_000, seed=30 + i)
        pcm_in = x if i % 2 == 0 else np.stack([x, -0.6 * x], 1)
        p = tmp_path / f"t{i}.opus"
        p.write_bytes(opus_ref_encode_ogg(pcm_in, bitrate=96_000))
        paths.append(str(p))
    got = ingest.load_files(paths, cfg, n_threads=2)
    for p, pcm in zip(paths, got):
        ref, sr = wav.load_wav(p, cfg)
        assert sr == cfg.sample_rate
        np.testing.assert_allclose(pcm, ref, atol=2e-6,
                                   err_msg=f"ingest != load_audio for {p}")


def test_native_opus_rejects_malformed():
    from hpfw_jax.io import native

    if not native.available():
        pytest.skip("native library unavailable")
    with pytest.raises(ValueError):
        native.decode_opus(b"OggS" + b"\x00" * 64)
