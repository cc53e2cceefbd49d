"""Device-side catalog synthesis fixtures (io/synth_jax.py)."""

import numpy as np

from hpfw_jax import api
from hpfw_jax.io import synth_jax
from tests.test_persist import _filters


def test_synth_batch_deterministic_across_batches(cfg):
    a = np.asarray(synth_jax.synth_batch(np.arange(8), 3.0, cfg))
    b = np.asarray(synth_jax.synth_batch([3, 5], 3.0, cfg))
    np.testing.assert_array_equal(a[3], b[0])
    np.testing.assert_array_equal(a[5], b[1])
    assert a.shape == (8, 3 * cfg.sample_rate) and a.dtype == np.float32
    assert np.all(np.abs(a).max(axis=1) <= 0.9 + 1e-6)


def test_synth_batch_single_matches_batch(cfg):
    """B=1 must render identically to the same track inside a batch (the
    single-iteration lax.map inlining pitfall)."""
    a = np.asarray(synth_jax.synth_batch(np.arange(6), 3.0, cfg))
    one = np.asarray(synth_jax.synth_batch([4], 3.0, cfg))
    np.testing.assert_array_equal(one[0], a[4])


def test_query_excerpts_catalog_audio(cfg):
    pcm = np.asarray(synth_jax.synth_batch(np.arange(6), 4.0, cfg))
    s = int(0.5 * cfg.sample_rate)
    q = np.asarray(synth_jax.query_batch([5], [s], 4.0, 2.0, cfg,
                                         noise_db=-80.0))
    ref = pcm[5][s:s + q.shape[1]]
    assert np.abs(q[0] - ref).max() < 1e-3   # only the -80 dB noise differs


def test_covers_have_correlated_prints(cfg):
    """Track i%10==3 re-renders track i-3 pitch-shifted: hashprints must be
    far more similar than unrelated tracks (the correlated-print stress the
    recall study needs), but not identical."""
    assert synth_jax.cover_source(3) == 0 and synth_jax.cover_source(4) is None
    pcm = np.asarray(synth_jax.synth_batch(np.arange(5), 4.0, cfg))
    filters = _filters(cfg)
    fps = api.fingerprint_batch(pcm, filters, cfg)

    def sim(a, b):
        pop = np.unpackbits(np.bitwise_xor(a, b).view(np.uint8)).sum()
        return 1.0 - pop / (a.size * 32)

    cover = sim(fps[3], fps[0])
    unrelated = sim(fps[4], fps[0])
    assert cover > 0.65 and abs(unrelated - 0.5) < 0.1
    assert cover < 0.999  # fresh noise: a cover is not a byte-copy


def test_live_query_identity_matches_query_batch(cfg):
    """pitch 0 / stretch 1 live renditions reproduce query_batch audio to
    float32 rounding (separate render function, same parameter stream)."""
    q0 = np.asarray(synth_jax.query_batch([2, 7], [1000, 3000], 4.0, 2.0,
                                          cfg, noise_db=-10.0))
    q1 = np.asarray(synth_jax.live_query_batch([2, 7], [1000, 3000], 4.0,
                                               2.0, cfg, pitch_st=0.0,
                                               stretch=1.0, noise_db=-10.0))
    assert q0.shape == q1.shape
    # same notes + same noise stream; only fusion-level f32 rounding differs
    err = np.abs(q0 - q1).max()
    assert err < 1e-3, err


def test_live_query_pitch_shift_moves_spectrum(cfg):
    """+12 st doubles the spectral centroid (octave up), stretch keeps it."""
    def centroid(x):
        f = np.abs(np.fft.rfft(x * np.hanning(x.shape[0])))
        freqs = np.fft.rfftfreq(x.shape[0], 1.0 / cfg.sample_rate)
        return float((f * freqs).sum() / f.sum())

    base = np.asarray(synth_jax.live_query_batch(
        [2], [0], 4.0, 3.0, cfg, noise_db=-40.0))[0]
    up = np.asarray(synth_jax.live_query_batch(
        [2], [0], 4.0, 3.0, cfg, pitch_st=12.0, noise_db=-40.0))[0]
    ratio = centroid(up) / centroid(base)
    assert 1.6 < ratio < 2.4, ratio


def test_live_query_stretch_shifts_timing_not_pitch(cfg):
    """A 20% slower rendition places the same content ~25% later in real
    time; the excerpt at the mapped start should correlate with the
    original content far better than an unmapped one."""
    dur, qs = 4.0, 1.5
    start = int(1.2 * cfg.sample_rate)
    ref = np.asarray(synth_jax.query_batch([5], [start], dur, qs, cfg,
                                           noise_db=-40.0))[0]
    slow = np.asarray(synth_jax.live_query_batch(
        [5], [start], dur, qs, cfg, stretch=0.8, noise_db=-40.0))[0]
    # envelope correlation (pitch phases differ in real time under stretch)
    def env(x, w=256):
        e = np.sqrt(np.convolve(x * x, np.ones(w) / w, mode="same"))
        return (e - e.mean()) / (e.std() + 1e-9)
    c = float(np.mean(env(ref) * env(slow)))
    assert c > 0.5, c
