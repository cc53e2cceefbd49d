"""Windowed-sinc resampler: scipy anchor, C++ twin, anti-aliasing property,
and hashprint stability under 44.1 -> 22.05 kHz ingestion (VERDICT r2
missing #2)."""

import numpy as np
import pytest

from hpfw_jax import api
from hpfw_jax.io import native, wav
from tests.test_persist import _filters


def _sig(n, sr, freqs, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = sum(a * np.sin(2 * np.pi * f * t + p) for f, a, p in
            [(f, rng.uniform(0.2, 0.4), rng.uniform(0, 6)) for f in freqs])
    return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 22050), (48000, 22050),
                                          (44100, 16000), (22050, 44100),
                                          (8000, 22050)])
def test_sinc_matches_scipy(sr_in, sr_out):
    """The NumPy polyphase path equals scipy.signal.resample_poly with its
    default Kaiser(5.0) design to float64 rounding."""
    from math import gcd

    from scipy.signal import resample_poly

    x = _sig(sr_in, sr_in, [440, 2000, 7000], seed=1)
    mine = wav.resample_sinc(x, sr_in, sr_out)
    g = gcd(sr_in, sr_out)
    ref = resample_poly(x.astype(np.float64), sr_out // g, sr_in // g,
                        window=("kaiser", 5.0))
    assert mine.shape[0] == ref.shape[0]
    np.testing.assert_allclose(mine, ref, atol=1e-6)


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 22050), (48000, 22050),
                                          (22050, 44100)])
def test_sinc_native_equals_numpy(sr_in, sr_out):
    """C++ twin vs NumPy twin: identical to within ~1 float32 ulp (the only
    float twin pair — both accumulate float64; order may differ)."""
    if not native.available():
        pytest.skip("native library unavailable")
    x = _sig(2 * sr_in, sr_in, [330, 1500, 9000], seed=2)
    a = wav.resample_sinc(x, sr_in, sr_out)
    b = native.resample_sinc(x, sr_in, sr_out)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=4e-7)


def test_sinc_antialiases_linear_does_not():
    """A 13 kHz tone (above the 22.05 kHz target's Nyquist) must be
    suppressed by the sinc path; the linear path aliases it into band."""
    sr_in, sr_out = 44100, 22050
    n = sr_in
    t = np.arange(n) / sr_in
    x = np.sin(2 * np.pi * 13000 * t).astype(np.float32)
    sinc_rms = float(np.sqrt(np.mean(wav.resample_sinc(x, sr_in, sr_out)[
        2000:-2000] ** 2)))
    lin_rms = float(np.sqrt(np.mean(wav.resample_linear(x, sr_in, sr_out)[
        2000:-2000] ** 2)))
    assert sinc_rms < 0.02           # > 30 dB suppression
    assert lin_rms > 0.2             # linear aliases most of the energy


def test_fingerprints_stable_under_441_to_2205_ingestion(cfg):
    """Prints from 44.1 kHz MUSIC ingested through the sinc resampler agree
    closely with prints of the same piece rendered natively at 22.05 kHz
    (hashprints are log-magnitude-CQT features, so this is the end-to-end
    ingestion-stability check), and at least as well as the linear path's.

    Stationary tone stacks are useless here — their deltas are ~0 and the
    sign bits are noise — so the fixture is the structured synth music.
    """
    import dataclasses

    from hpfw_jax.io import synth

    cfg_hi = dataclasses.replace(cfg, sample_rate=2 * cfg.sample_rate)
    # Noiseless renders: the generator's per-rate noise floor would cap
    # agreement at ~0.80 regardless of resampler quality (delta-sign bits
    # flip at small margins); the resampler's own aliasing difference is
    # carried by test_sinc_antialiases_linear_does_not.
    hi = synth.synth_track(33, 4.0, cfg_hi, noise_db=-100.0)
    lo = synth.synth_track(33, 4.0, cfg, noise_db=-100.0)
    filters = _filters(cfg)
    want = api.fingerprint(lo, filters, cfg)

    def agreement(pcm):
        got = api.fingerprint(pcm, filters, cfg)
        n = min(got.shape[0], want.shape[0])
        pop = np.unpackbits(np.bitwise_xor(got[:n], want[:n]).view(np.uint8))
        return 1.0 - pop.sum() / (n * 64)

    sinc_agree = agreement(
        wav.resample_sinc(hi, cfg_hi.sample_rate, cfg.sample_rate))
    lin_agree = agreement(
        wav.resample_linear(hi, cfg_hi.sample_rate, cfg.sample_rate))
    assert sinc_agree > 0.99
    assert sinc_agree >= lin_agree - 0.001


def test_load_wav_uses_config_resampler(cfg, tmp_path):
    """load_wav resamples per cfg.resample (sinc default, linear opt-in)."""
    import dataclasses

    x = _sig(44100, 44100, [500, 3000], seed=4)
    p = str(tmp_path / "t.wav")
    wav.save_wav(p, x, 44100)
    pcm_sinc, sr = wav.load_wav(p, cfg)
    assert sr == cfg.sample_rate
    lin_cfg = dataclasses.replace(cfg, resample="linear")
    pcm_lin, _ = wav.load_wav(p, lin_cfg)
    x16 = np.clip(np.asarray(x, np.float64), -1, 1)
    x16 = (x16 * 32767.0).round().astype(np.int16).astype(np.float32) / 32768.0
    np.testing.assert_allclose(
        pcm_sinc, wav.resample(x16, 44100, cfg.sample_rate, kind="sinc"),
        atol=1e-6)
    np.testing.assert_array_equal(
        pcm_lin, wav.resample_linear(x16, 44100, cfg.sample_rate))
