"""Oracle self-consistency tests (SURVEY.md §4.2, §4.3).

The oracle is the behavioral contract; these tests pin its own invariants:
framing/window vs scipy, CQT peak location, pack/unpack round-trip,
time-shift property, and self-match identity.
"""

import numpy as np
import pytest
import scipy.signal

from hpfw_jax import oracle
from hpfw_jax.config import HpfwConfig
from hpfw_jax.io import synth
from hpfw_jax.io.wav import load_wav, resample_linear, save_wav


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters))
    return oracle.fix_eigenvector_signs(f)


def test_framing_matches_manual(cfg):
    pcm = np.arange(cfg.frame_len + 5 * cfg.hop + 17, dtype=np.float64)
    frames = oracle.frame_signal(pcm, cfg)
    assert frames.shape == (6, cfg.frame_len)
    for t in range(6):
        np.testing.assert_array_equal(frames[t], pcm[t * cfg.hop:t * cfg.hop + cfg.frame_len])


def test_cqt_kernel_window_is_hann(cfg):
    # The per-bin kernel magnitude envelope equals a (normalized) Hann window.
    K = oracle.cqt_kernel_matrix(cfg)
    k = cfg.n_bins // 2
    col = K[:, k]
    nz = np.flatnonzero(np.abs(col) > 0)
    n_k = int(np.ceil(cfg.q_factor * cfg.sample_rate / cfg.bin_frequency(k)))
    assert len(nz) == pytest.approx(n_k, abs=2)
    n = np.arange(n_k)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * (n + 0.5) / n_k)
    got = np.abs(col[nz[0]:nz[0] + n_k]) * n_k
    np.testing.assert_allclose(got, hann, rtol=1e-12, atol=1e-12)
    # cross-check shape against scipy's periodic-symmetric family
    ref = scipy.signal.get_window("hann", n_k, fftbins=False)
    assert np.corrcoef(got, ref)[0, 1] > 0.999


def test_cqt_peaks_at_tone_frequency(cfg):
    # A pure tone at bin k's center frequency peaks at bin k.
    for k in [5, cfg.n_bins // 2, cfg.n_bins - 5]:
        f_k = cfg.bin_frequency(k)
        t = np.arange(cfg.sample_rate, dtype=np.float64) / cfg.sample_rate
        pcm = 0.5 * np.sin(2 * np.pi * f_k * t)
        spec = oracle.cqt(pcm, cfg)
        assert int(np.argmax(spec.mean(axis=0))) == k


def test_context_windows_layout(cfg):
    spec = np.arange(12 * cfg.n_bins, dtype=np.float64).reshape(12, cfg.n_bins)
    x = oracle.context_windows(spec, cfg)
    w = cfg.context_w
    assert x.shape == (12 - w + 1, cfg.context_dim)
    np.testing.assert_array_equal(x[0], spec[:w].reshape(-1))
    np.testing.assert_array_equal(x[3], spec[3:3 + w].reshape(-1))


def test_pack_bits_lsb0_and_uint64_roundtrip(cfg):
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, size=(50, 64)).astype(bool)
    packed = oracle.pack_bits(bits, cfg)
    # filter i -> bit i of the logical 64-bit word
    h = oracle.packed_to_uint64(packed)
    for i in range(64):
        got = (h >> np.uint64(i)) & np.uint64(1)
        np.testing.assert_array_equal(got.astype(bool), bits[:, i])
    np.testing.assert_array_equal(oracle.uint64_to_packed(h), packed)


def test_fingerprint_shape_and_determinism(cfg):
    pcm = synth.synth_track(1, 2.0, cfg)
    filters = _filters(cfg)
    fp1 = oracle.fingerprint(pcm, filters, cfg)
    fp2 = oracle.fingerprint(pcm.copy(), filters, cfg)
    assert fp1.shape == (cfg.n_hashprints(len(pcm)), 2)
    assert fp1.dtype == np.uint32
    np.testing.assert_array_equal(fp1, fp2)


def test_hamming_similarity_identity_and_bounds(cfg):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2 ** 32, size=(40, 2), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, size=(40, 2), dtype=np.uint32)
    assert oracle.hamming_similarity(a, a) == 64 * 40
    s = oracle.hamming_similarity(a, b)
    assert 0 <= s <= 64 * 40
    assert oracle.hamming_similarity(a, ~b) == 64 * 40 - oracle.hamming_similarity(a, b)


def test_time_shift_property(cfg):
    """Shifting the query start by k hops shifts the best offset by k (SURVEY §4.3)."""
    track = synth.synth_track(11, 6.0, cfg)
    filters = _filters(cfg)
    db_fp = oracle.fingerprint(track, filters, cfg)
    for k in [0, 3, 7]:
        q_pcm = track[k * cfg.hop: k * cfg.hop + int(2.5 * cfg.sample_rate)]
        q_fp = oracle.fingerprint(q_pcm, filters, cfg)
        score, off = oracle.match_track(q_fp, db_fp)
        assert off == k
        assert score == 64 * q_fp.shape[0]  # exact excerpt -> perfect score


def test_match_ranks_true_track_first(cfg):
    tracks = synth.synth_catalog(8, 4.0, cfg)
    filters = _filters(cfg)
    db = [oracle.fingerprint(t, filters, cfg) for t in tracks]
    q = synth.make_query(tracks[5], 0.7, 2.0, cfg, noise_db=-20.0, seed=9)
    q_fp = oracle.fingerprint(q, filters, cfg)
    idx, scores, offs = oracle.match(q_fp, db, top_k=3)
    assert idx[0] == 5
    assert scores[0] > scores[1]


def test_learned_filters_orthonormal(cfg):
    corpus = synth.synth_catalog(3, 2.0, cfg, base_seed=50)
    filters = oracle.learn_filters(corpus, cfg)
    assert filters.shape == (cfg.context_dim, cfg.n_filters)
    gram = filters.T @ filters
    np.testing.assert_allclose(gram, np.eye(cfg.n_filters), atol=1e-8)
    # deterministic sign convention
    idx = np.argmax(np.abs(filters), axis=0)
    assert np.all(filters[idx, np.arange(64)] > 0)


def test_wav_roundtrip_and_resample(tmp_path, cfg):
    pcm = synth.synth_track(2, 1.0, cfg)
    p = str(tmp_path / "t.wav")
    save_wav(p, pcm, cfg.sample_rate)
    loaded, sr = load_wav(p)
    assert sr == cfg.sample_rate
    assert loaded.shape == pcm.shape
    assert np.max(np.abs(loaded - pcm)) < 2.0 / 32768.0
    # resample identity and length scaling
    np.testing.assert_array_equal(resample_linear(pcm, sr, sr), pcm)
    half = resample_linear(pcm, sr, sr // 2)
    assert abs(half.shape[0] - pcm.shape[0] // 2) <= 1
