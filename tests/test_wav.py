"""WAV decode edge cases, NumPy path and native C++ path (bit-identical).

Covers WAVE_FORMAT_EXTENSIBLE (format code 0xFFFE with the real sample
format in the SubFormat GUID) for both PCM and IEEE-float sub-formats —
the most common "weird WAV" in real catalogs (SURVEY.md §2.1 row 1).
"""

import struct

import numpy as np
import pytest

from hpfw_jax.io import native, wav

# First 2 bytes of the SubFormat GUID are the format code; the remainder is
# the fixed KSDATAFORMAT suffix.
_GUID_SUFFIX = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"


def _extensible_wav(samples: np.ndarray, sample_rate: int, sub_format: int,
                    n_ch: int = 1) -> bytes:
    """Build a WAVE_FORMAT_EXTENSIBLE file around raw sample bytes."""
    raw = samples.tobytes()
    bits = samples.dtype.itemsize * 8
    block = n_ch * bits // 8
    fmt_body = struct.pack(
        "<HHIIHH", 0xFFFE, n_ch, sample_rate, sample_rate * block, block, bits
    ) + struct.pack("<HHI", 22, bits, (1 << n_ch) - 1) \
      + struct.pack("<H", sub_format) + _GUID_SUFFIX
    chunks = (b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
              + b"data" + struct.pack("<I", len(raw)) + raw)
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


@pytest.fixture
def float_samples():
    rng = np.random.default_rng(7)
    return (rng.standard_normal(512) * 0.3).astype(np.float32)


def test_extensible_float32_decodes_exactly(float_samples):
    data = _extensible_wav(float_samples, 22050, sub_format=3)
    pcm, sr = wav._decode_wav_bytes(data)
    assert sr == 22050
    np.testing.assert_array_equal(pcm, float_samples)


def test_extensible_pcm16_decodes_exactly():
    ints = np.array([-32768, -1, 0, 1, 12345, 32767], dtype="<i2")
    data = _extensible_wav(ints, 8000, sub_format=1)
    pcm, sr = wav._decode_wav_bytes(data)
    assert sr == 8000
    np.testing.assert_array_equal(pcm, ints.astype(np.float32) / 32768.0)


def test_extensible_stereo_float_downmixes(float_samples):
    stereo = np.stack([float_samples, -float_samples], axis=1).reshape(-1)
    data = _extensible_wav(stereo, 16000, sub_format=3, n_ch=2)
    pcm, sr = wav._decode_wav_bytes(data)
    assert sr == 16000
    np.testing.assert_allclose(pcm, np.zeros_like(float_samples), atol=1e-7)


def test_extensible_unknown_subformat_raises(float_samples):
    data = _extensible_wav(float_samples, 22050, sub_format=0x0055)  # MP3
    with pytest.raises(ValueError):
        wav._decode_wav_bytes(data)


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_extensible_matches_numpy(float_samples):
    ints = (np.clip(float_samples, -1, 1) * 32767).astype("<i2")
    for data in (_extensible_wav(float_samples, 22050, sub_format=3),
                 _extensible_wav(ints, 44100, sub_format=1)):
        got, sr_n = native.decode_wav(data)
        want, sr_p = wav._decode_wav_bytes(data)
        assert sr_n == sr_p
        np.testing.assert_array_equal(got, want)


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_extensible_unknown_subformat_rejected(float_samples):
    data = _extensible_wav(float_samples, 22050, sub_format=0x0055)
    with pytest.raises(ValueError):
        native.decode_wav(data)


def _plain_wav(raw: bytes, fmt_code: int, sample_rate: int, bits: int,
               n_ch: int = 1) -> bytes:
    block = n_ch * bits // 8
    fmt_body = struct.pack("<HHIIHH", fmt_code, n_ch, sample_rate,
                           sample_rate * block, block, bits)
    chunks = (b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
              + b"data" + struct.pack("<I", len(raw)) + raw)
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _aiff(samples_be: bytes, n_frames: int, sample_rate: int, bits: int,
          n_ch: int = 1, comp: bytes = b"") -> bytes:
    # 80-bit float sample rate
    e = 16383 + 63
    mant = sample_rate
    while mant < (1 << 63):
        mant <<= 1
        e -= 1
    comm = struct.pack(">hIh", n_ch, n_frames, bits) \
        + struct.pack(">H", e) + mant.to_bytes(8, "big") + comp
    ssnd = struct.pack(">II", 0, 0) + samples_be
    body = (b"COMM" + struct.pack(">I", len(comm)) + comm + (b"\0" if len(comm) % 2 else b"")
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    form_type = b"AIFC" if comp else b"AIFF"
    return b"FORM" + struct.pack(">I", 4 + len(body)) + form_type + body


def _g711_reference_mulaw(b):
    u = ~np.asarray(b, dtype=np.uint8)
    sign = (u & 0x80) != 0
    mag = ((((u & 0xF).astype(np.int32) << 3) + 0x84) << ((u >> 4) & 7)) - 0x84
    return np.where(sign, -mag, mag).astype(np.float32) / 32768.0


def test_mulaw_and_alaw_wav_decode():
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, 512, dtype=np.uint8).tobytes()
    pcm_u, sr = wav._decode_wav_bytes(_plain_wav(raw, 7, 8000, 8))
    assert sr == 8000 and pcm_u.shape == (512,)
    np.testing.assert_array_equal(pcm_u, _g711_reference_mulaw(np.frombuffer(raw, np.uint8)))
    pcm_a, _ = wav._decode_wav_bytes(_plain_wav(raw, 6, 8000, 8))
    assert np.all(np.abs(pcm_a) <= 1.0) and pcm_a.std() > 0


def test_aiff_decode_pcm16_be_and_sowt():
    ints = np.array([-32768, -1, 0, 1, 12345, 32767], dtype=np.int16)
    be = _aiff(ints.astype(">i2").tobytes(), len(ints), 22050, 16)
    pcm, sr = wav._decode_wav_bytes(be)
    assert sr == 22050
    np.testing.assert_array_equal(pcm, ints.astype(np.float32) / 32768.0)
    sowt = _aiff(ints.astype("<i2").tobytes(), len(ints), 44100, 16,
                 comp=b"sowt" + struct.pack(">B", 4) + b"sowt")
    # AIFF-C stores a pstring after compression id; our parsers read only
    # the 4-byte compression type at offset 18 of COMM.
    pcm2, sr2 = wav._decode_wav_bytes(sowt)
    assert sr2 == 44100
    np.testing.assert_array_equal(pcm2, ints.astype(np.float32) / 32768.0)


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_new_formats_match_numpy():
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, 333, dtype=np.uint8).tobytes()
    ints = (rng.standard_normal(400) * 20000).astype(np.int16)
    cases = [
        _plain_wav(raw, 7, 8000, 8),
        _plain_wav(raw, 6, 8000, 8),
        _aiff(ints.astype(">i2").tobytes(), len(ints), 22050, 16),
        _aiff(np.stack([ints, -ints], 1).astype(">i2").tobytes(),
              len(ints), 16000, 16, n_ch=2),
    ]
    for i, data in enumerate(cases):
        got, sr_n = native.decode_wav(data)
        want, sr_p = wav._decode_wav_bytes(data)
        assert sr_n == sr_p, f"case {i}"
        np.testing.assert_allclose(got, want, atol=1e-7, err_msg=f"case {i}")


def test_aifc_ulaw_alaw():
    """AIFF-C 'ulaw'/'alaw' compression decodes via the exact G.711
    expansion tables (same bytes as the WAV format-7/6 path)."""
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, 600, dtype=np.uint8).tobytes()
    blob = _aiff(raw, 600, 8000, 8, comp=b"ulaw")
    pcm, sr = wav._decode_wav_bytes(blob)
    assert sr == 8000 and pcm.shape == (600,)
    np.testing.assert_array_equal(
        pcm, _g711_reference_mulaw(np.frombuffer(raw, np.uint8)))
    ref_wav, _ = wav._decode_wav_bytes(_plain_wav(raw, 6, 8000, 8))
    pcm_a, _ = wav._decode_wav_bytes(_aiff(raw, 600, 8000, 8, comp=b"alaw"))
    np.testing.assert_array_equal(pcm_a, ref_wav)


def _au(body: bytes, enc: int, sr: int, n_ch: int = 1) -> bytes:
    return b".snd" + struct.pack(">IIIII", 24, len(body), enc, sr, n_ch) \
        + body


def test_au_decode():
    """Sun .au: mu-law, A-law, and big-endian PCM/float variants."""
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 256, 512, dtype=np.uint8).tobytes()
    pcm, sr = wav._decode_wav_bytes(_au(raw, 1, 8000))
    assert sr == 8000
    np.testing.assert_array_equal(
        pcm, _g711_reference_mulaw(np.frombuffer(raw, np.uint8)))
    ints = (rng.standard_normal(300) * 20000).astype(">i2")
    pcm16, sr16 = wav._decode_wav_bytes(_au(ints.tobytes(), 3, 22050))
    assert sr16 == 22050
    np.testing.assert_allclose(pcm16,
                               ints.astype(np.float32) / 32768.0)
    f32 = rng.standard_normal(300).astype(">f4")
    pcmf, _ = wav._decode_wav_bytes(_au(f32.tobytes(), 6, 16000))
    np.testing.assert_array_equal(pcmf, f32.astype(np.float32))
    # stereo downmix + load_wav dispatch
    st = np.stack([ints, (-ints).astype(">i2")], 1).astype(">i2")
    pcm_st, _ = wav._decode_wav_bytes(_au(st.tobytes(), 3, 22050, n_ch=2))
    np.testing.assert_allclose(pcm_st, np.zeros(300), atol=1e-6)
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.au")
        with open(p, "wb") as f:
            f.write(_au(ints.tobytes(), 3, 22050))
        got, gsr = wav.load_wav(p)
        assert gsr == 22050 and got.shape == (300,)


def test_wav_with_embedded_mpeg_payload_routes_to_wav(tmp_path):
    """ADVICE r3: decisive container magic (RIFF/WAVE) must beat the
    heuristic MPEG sniff — a PCM payload containing a genuine MPEG stream
    (sync patterns that verify two-frame) must still decode as WAV."""
    from hpfw_jax.io.mp3enc import encode_mp3

    rng = np.random.default_rng(3)
    mp3_bytes = encode_mp3((rng.standard_normal(4096) * 0.2
                            ).astype(np.float32), 44100)
    raw = mp3_bytes[: (len(mp3_bytes) // 2) * 2]
    fmt_body = struct.pack("<HHIIHH", 1, 1, 22050, 22050 * 2, 2, 16)
    chunks = (b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
              + b"data" + struct.pack("<I", len(raw)) + raw)
    data = b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks
    p = tmp_path / "sneaky.wav"
    p.write_bytes(data)
    pcm, sr = wav.load_audio(str(p))
    assert sr == 22050
    np.testing.assert_array_equal(
        pcm, np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0)


def test_lone_midfile_truncated_sync_is_not_mpeg():
    """ADVICE r3: a mid-file sync whose frame extends past EOF (so no second
    header can verify it) is payload junk, not an MPEG stream; but a
    genuine truncated single-frame stream starting at byte 0 still sniffs."""
    from hpfw_jax.io.mp3enc import encode_mp3

    frame = encode_mp3(np.zeros(2048, dtype=np.float32), 44100)[:200]
    assert wav._looks_like_mpeg(frame)  # truncated frame at pos 0: decisive
    assert not wav._looks_like_mpeg(b"\x00" * 64 + frame)  # mid-file: junk
