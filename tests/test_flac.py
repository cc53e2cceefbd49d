"""FLAC bitstream tests: NumPy decoder vs in-repo encoder roundtrips, C++
decoder bit-equality, load_wav dispatch, and CRC integrity checking.

No FLAC tooling exists in this offline environment, so fixtures come from
hpfw_jax.io.flac.encode_flac — a real, spec-conforming encoder (CRC-8/16,
Rice partitions, stereo decorrelation), making these true bitstream tests
rather than self-inverses of one codec implementation: the encoder and the
two decoders are three independent code paths over the wire format.
"""

import numpy as np
import pytest

from hpfw_jax.io import native, wav
from hpfw_jax.io.flac import decode_flac, encode_flac


def _sig(n, seed=0, stereo=False):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    x = (0.4 * np.sin(2 * np.pi * 440.0 * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    if stereo:
        return np.stack([x, np.roll(x, 61) * -0.7], axis=1)
    return x


def _ints(x, bps=16):
    s = float(1 << (bps - 1))
    i = np.clip(np.round(np.asarray(x, np.float64) * s), -s, s - 1)
    return i.astype(np.int64)


CASES = [
    ("fixed0", dict(mode="fixed", order=0), False),
    ("fixed2", dict(mode="fixed", order=2), False),
    ("fixed4", dict(mode="fixed", order=4), False),
    ("verbatim", dict(mode="verbatim"), False),
    ("partitions", dict(mode="fixed", order=2, porder=3), False),
    ("escape", dict(mode="fixed", order=1, escape_bits=18), False),
    ("wasted", dict(mode="verbatim", wasted=2), False),
    ("stereo_independent", dict(channel_mode="independent"), True),
    ("stereo_left_side", dict(channel_mode="left_side"), True),
    ("stereo_right_side", dict(channel_mode="right_side"), True),
    ("stereo_mid_side", dict(channel_mode="mid_side"), True),
    # 32-bit stereo decorrelation: side channels carry 33-bit samples, which
    # exercises the >32-bit signed reads in both decoders (ADVICE r2).
    ("stereo32_left_side", dict(channel_mode="left_side", bps=32,
                                mode="verbatim"), True),
    ("stereo32_mid_side", dict(channel_mode="mid_side", bps=32), True),
]


@pytest.mark.parametrize("name,kw,stereo", CASES, ids=[c[0] for c in CASES])
def test_flac_roundtrip_exact(name, kw, stereo):
    """Decoded samples equal the encoder's quantized input exactly."""
    x = _sig(7003, seed=3, stereo=stereo)
    blob = encode_flac(x, 22050, blocksize=2048, **kw)
    pcm, sr = decode_flac(blob)
    assert sr == 22050
    bps = kw.get("bps", 16)
    scale = float(1 << (bps - 1))
    xi = _ints(x, bps)
    if kw.get("wasted"):
        xi = (xi >> kw["wasted"]) << kw["wasted"]
    want = xi.mean(axis=1) if xi.ndim == 2 else xi.astype(np.float64)
    # float32 output carries a 24-bit mantissa, so 32-bit samples round:
    # exact at sample resolution means within float32 rounding of the scale.
    np.testing.assert_allclose(pcm.astype(np.float64) * scale, want,
                               atol=scale * 3e-7)


@pytest.mark.parametrize("name,kw,stereo", CASES, ids=[c[0] for c in CASES])
def test_flac_native_equals_numpy(name, kw, stereo):
    """C++ decoder output is bit-identical to the NumPy twin."""
    if not native.available():
        pytest.skip("native library unavailable")
    x = _sig(5407, seed=4, stereo=stereo)
    blob = encode_flac(x, 22050, blocksize=1024, **kw)
    py, r1 = decode_flac(blob)
    cc, r2 = native.decode_flac(blob)
    assert r1 == r2 == 22050
    np.testing.assert_array_equal(py, cc)


def test_flac_total_zero_means_unknown():
    """STREAMINFO total_samples == 0 is 'unknown' (streamed encodes): both
    decoders must decode to the end of the bitstream, not return empty."""
    x = _sig(5000, seed=7)
    blob = bytearray(encode_flac(x, 22050, blocksize=1024))
    # STREAMINFO body starts at offset 8; zero the 36-bit total_samples
    # field (low nibble of body[13] + body[14:18]).
    blob[8 + 13] &= 0xF0
    blob[8 + 14:8 + 18] = b"\x00" * 4
    pcm, sr = decode_flac(bytes(blob))
    assert sr == 22050 and pcm.shape[0] == 5000
    np.testing.assert_allclose(pcm.astype(np.float64) * 32768.0,
                               _ints(x).astype(np.float64), atol=1e-2)
    if native.available():
        cc, r2 = native.decode_flac(bytes(blob))
        assert r2 == 22050
        np.testing.assert_array_equal(pcm, cc)


def test_flac_constant_subframe():
    x = np.full(3000, 0.125, np.float32)
    blob = encode_flac(x, 22050, mode="constant")
    pcm, _ = decode_flac(blob)
    np.testing.assert_allclose(pcm, 0.125, atol=1e-4)
    assert len(blob) < 200   # constant frames are a few bytes each


def test_flac_load_wav_dispatch(tmp_path, cfg):
    """load_wav detects FLAC by magic and resamples to the config rate."""
    x = _sig(22050, seed=5)
    p = tmp_path / "t.flac"
    p.write_bytes(encode_flac(x, 22050))
    pcm, sr = wav.load_wav(str(p), cfg)
    assert sr == cfg.sample_rate
    want = wav.resample_linear(_ints(x).astype(np.float32) / 32768.0,
                               22050, cfg.sample_rate)
    np.testing.assert_allclose(pcm, want, atol=1e-6)


def test_flac_crc_detects_corruption():
    blob = bytearray(encode_flac(_sig(4096, seed=6), 22050))
    blob[len(blob) // 2] ^= 0x40    # flip a bit mid-frame
    with pytest.raises(ValueError):
        decode_flac(bytes(blob))
    if native.available():
        with pytest.raises(ValueError):
            native.decode_flac(bytes(blob))


def test_flac_rejects_garbage():
    with pytest.raises(ValueError):
        decode_flac(b"fLaX" + b"\x00" * 100)
    with pytest.raises(ValueError):
        wav._decode_wav_bytes(b"\x00" * 64)


def test_flac_fuzz_no_crash():
    """Random corruptions of a valid stream must raise ValueError (or decode
    if the corruption is benign) — never crash or hang, in both decoders."""
    rng = np.random.default_rng(8)
    blob = bytearray(encode_flac(_sig(6000, seed=9), 22050, blocksize=1024))
    for _ in range(40):
        b = bytearray(blob)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(4, len(b)))] ^= int(rng.integers(1, 256))
        try:
            decode_flac(bytes(b))
        except ValueError:
            pass
        if native.available():
            try:
                native.decode_flac(bytes(b))
            except ValueError:
                pass
    # Pure garbage with a valid magic must also fail cleanly.
    junk = b"fLaC" + bytes(rng.integers(0, 256, 300, dtype=np.uint8))
    with pytest.raises(ValueError):
        decode_flac(junk)
