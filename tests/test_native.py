"""C++ native runtime vs NumPy twins — bit-identical behavior required."""

import numpy as np
import pytest

from hpfw_jax import oracle
from hpfw_jax.io import native, synth, wav


pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def test_native_wav_decode_matches_python(tmp_path, cfg):
    pcm = synth.synth_track(9, 1.5, cfg)
    p = str(tmp_path / "t.wav")
    wav.save_wav(p, pcm, cfg.sample_rate)
    data = open(p, "rb").read()
    got, sr = native.decode_wav(data)
    want, sr2 = wav.load_wav(p)
    assert sr == sr2 == cfg.sample_rate
    np.testing.assert_array_equal(got, want)


def test_native_resample_matches_python(cfg):
    pcm = synth.synth_track(10, 0.7, cfg)
    for sr_out in [8000, 16000, 44100]:
        got = native.resample_linear(pcm, cfg.sample_rate, sr_out)
        want = wav.resample_linear(pcm, cfg.sample_rate, sr_out)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_native_match_equals_oracle():
    rng = np.random.default_rng(0)
    lengths = [300, 120, 37, 300, 251]
    tracks = [rng.integers(0, 2 ** 32, (ln, 2), dtype=np.uint32) for ln in lengths]
    q = rng.integers(0, 2 ** 32, (50, 2), dtype=np.uint32)
    tracks[3][77:127] = q  # planted
    scores, offsets = native.match_db(q, tracks, n_threads=4)
    for i, t in enumerate(tracks):
        s_want, o_want = oracle.match_track(q, t)
        assert int(scores[i]) == s_want, f"track {i}"
        assert int(offsets[i]) == o_want, f"track {i}"
    assert scores[3] == 64 * 50 and offsets[3] == 77


def test_native_match_single_thread_deterministic():
    rng = np.random.default_rng(1)
    tracks = [rng.integers(0, 2 ** 32, (200, 2), dtype=np.uint32) for _ in range(6)]
    q = rng.integers(0, 2 ** 32, (30, 2), dtype=np.uint32)
    s1, o1 = native.match_db(q, tracks, n_threads=1)
    s8, o8 = native.match_db(q, tracks, n_threads=8)
    np.testing.assert_array_equal(s1, s8)
    np.testing.assert_array_equal(o1, o8)


def test_native_fingerprint_matches_oracle(cfg):
    """Full C++ extraction (CQT + projection + delta + sign + pack) equals
    the float64 oracle, margin-audited: the two float64 pipelines may only
    disagree where |delta| ~ 0 (different GEMM accumulation orders)."""
    from tests.test_pipeline import assert_bits_match_with_margin_audit

    rng = np.random.default_rng(11)
    filters = (rng.standard_normal((cfg.context_dim, 64))
               / np.sqrt(cfg.context_dim))
    filters = oracle.fix_eigenvector_signs(filters).astype(np.float32)
    pcm = synth.synth_track(3, 7.0, cfg)
    got = native.fingerprint_cpu(pcm, filters, cfg)
    want = oracle.fingerprint(pcm, filters, cfg)
    assert got.shape == want.shape and got.shape[0] > 0
    margins = oracle.delta_margins(pcm, filters, cfg)
    assert_bits_match_with_margin_audit(got, want, margins, rel_tol=1e-6)


def test_native_fingerprint_msb0_and_short_input(cfg):
    import dataclasses

    cfg2 = dataclasses.replace(cfg, bit_order="msb0", tie_break="ge")
    rng = np.random.default_rng(12)
    filters = (rng.standard_normal((cfg2.context_dim, 64))
               / np.sqrt(cfg2.context_dim)).astype(np.float32)
    pcm = synth.synth_track(4, 6.5, cfg2)
    got = native.fingerprint_cpu(pcm, filters, cfg2)
    want = oracle.fingerprint(pcm, filters, cfg2)
    margins = oracle.delta_margins(pcm, filters, cfg2)
    from tests.test_pipeline import assert_bits_match_with_margin_audit

    assert_bits_match_with_margin_audit(got, want, margins, rel_tol=1e-6)
    # Too-short input yields zero prints, not an error (cfg.min_samples).
    short = native.fingerprint_cpu(pcm[: cfg2.min_samples() - 1], filters, cfg2)
    assert short.shape == (0, 2)
