"""JAX pipeline vs float64 oracle — the golden parity tests.

SURVEY.md §4.1: packed hashprints must match the oracle bit-exactly except at
bits whose float64 delta margin is below the float32 noise floor (the
tolerance audit of §7.4.1). The audit asserts the exempt fraction is tiny, so
the test stays meaningful.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hpfw_jax import api, oracle
from hpfw_jax.io import synth
from hpfw_jax.learn import pca
from hpfw_jax.match import matcher
from hpfw_jax.ops import fingerprint as fp_ops
from hpfw_jax.ops import frontend


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return oracle.fix_eigenvector_signs(f).astype(np.float32)


assert_bits_match_with_margin_audit = oracle.assert_bits_match_with_margin_audit


def test_cqt_matches_oracle(cfg):
    pcm = synth.synth_track(5, 1.5, cfg)
    got = np.asarray(frontend.cqt(jnp.asarray(pcm), cfg))
    want = oracle.cqt(pcm, cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_projection_matches_oracle(cfg):
    pcm = synth.synth_track(6, 1.5, cfg)
    filters = _filters(cfg)
    spec64 = oracle.cqt(pcm, cfg)
    y_want = oracle.features(spec64, filters, cfg)
    y_got = np.asarray(
        fp_ops.project_features(jnp.asarray(spec64, dtype=jnp.float32), jnp.asarray(filters), cfg)
    )
    np.testing.assert_allclose(y_got, y_want, rtol=0, atol=1e-3)


def test_pack_bits_matches_oracle(cfg):
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, size=(70, 64)).astype(bool)
    got = np.asarray(fp_ops.pack_bits(jnp.asarray(bits), cfg))
    want = oracle.pack_bits(bits, cfg)
    np.testing.assert_array_equal(got, want)
    back = np.asarray(fp_ops.unpack_bits(jnp.asarray(got), cfg))
    np.testing.assert_array_equal(back, bits)


def test_fingerprint_bit_exact_with_margin_audit(cfg):
    filters = _filters(cfg)
    for seed in [1, 2, 3]:
        pcm = synth.synth_track(seed, 2.0, cfg)
        got = api.fingerprint(pcm, filters, cfg)
        want = oracle.fingerprint(pcm, filters, cfg)
        margins = oracle.delta_margins(pcm, filters, cfg)
        assert got.shape == want.shape == (cfg.n_hashprints(len(pcm)), 2)
        assert_bits_match_with_margin_audit(got, want, margins)


def test_fingerprint_short_input(cfg):
    filters = _filters(cfg)
    out = api.fingerprint(np.zeros(10, np.float32), filters, cfg)
    assert out.shape == (0, 2)


def test_matcher_matches_oracle_dense(cfg):
    tracks = synth.synth_catalog(7, 3.0, cfg)
    filters = _filters(cfg)
    fps = [oracle.fingerprint(t, filters, cfg) for t in tracks]
    # Vary lengths: truncate some tracks' prints.
    fps = [fp[: fp.shape[0] - 7 * i] for i, fp in enumerate(fps)]
    q = oracle.fingerprint(synth.make_query(tracks[3], 0.5, 1.5, cfg), filters, cfg)

    prints, lengths = matcher.pad_prints(fps)
    scores, offsets = matcher.score_tracks(jnp.asarray(q), jnp.asarray(prints), jnp.asarray(lengths))
    for i, fp in enumerate(fps):
        s_want, o_want = oracle.match_track(q, fp)
        assert int(scores[i]) == s_want, f"track {i}"
        assert int(offsets[i]) == o_want, f"track {i}"


def test_matcher_short_track_semantics(cfg):
    rng = np.random.default_rng(5)
    q = rng.integers(0, 2 ** 32, (40, 2), dtype=np.uint32)
    short = q[:15].copy()  # shorter than the query
    prints, lengths = matcher.pad_prints([short], min_len=q.shape[0])
    scores, offsets = matcher.score_tracks(jnp.asarray(q), jnp.asarray(prints), jnp.asarray(lengths))
    assert int(scores[0]) == 64 * 15
    assert int(offsets[0]) == 0


def test_end_to_end_api_match(cfg):
    tracks = synth.synth_catalog(10, 3.0, cfg)
    filters = _filters(cfg)
    db = api.build_db({f"track{i:02d}": t for i, t in enumerate(tracks)}, filters, cfg)
    q = synth.make_query(tracks[7], 1.0, 1.5, cfg, noise_db=-18.0, seed=2)
    ids, scores, offsets = api.match(api.fingerprint(q, filters, cfg), db, top_k=3)
    assert ids[0] == "track07"
    expected_off = round(1.0 * cfg.sample_rate / cfg.hop)
    assert abs(int(offsets[0]) - expected_off) <= 1
    assert scores[0] > scores[1]


def test_db_save_load_roundtrip(tmp_path, cfg):
    tracks = synth.synth_catalog(4, 2.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    p = str(tmp_path / "db.npz")
    db.save(p)
    db2 = api.FingerprintDB.load(p)
    assert db2.cfg == cfg
    assert db2.track_ids == db.track_ids
    np.testing.assert_array_equal(db2.prints, db.prints)
    np.testing.assert_array_equal(db2.lengths, db.lengths)
    np.testing.assert_array_equal(db2.filters, db.filters)


def test_learn_filters_close_to_oracle(cfg):
    corpus = synth.synth_catalog(3, 2.0, cfg, base_seed=77)
    got = pca.learn_filters(corpus, cfg)
    want = oracle.learn_filters(corpus, cfg)
    assert got.shape == want.shape
    # Filters are f32-accumulated; compare via absolute cosine similarity
    # per filter (eigenvector directions, sign-fixed).
    cos = np.abs(np.sum(got.astype(np.float64) * want, axis=0))
    assert np.all(cos > 0.98), cos.min()


def test_learn_filters_resumable(tmp_path, cfg):
    corpus = synth.synth_catalog(4, 1.5, cfg, base_seed=90)
    s1 = pca.CovarianceState.zero(cfg)
    for t in corpus:
        s1 = pca.accumulate_track(s1, t, cfg)
    # checkpoint after 2 tracks, resume in a "new process"
    s2 = pca.CovarianceState.zero(cfg)
    for t in corpus[:2]:
        s2 = pca.accumulate_track(s2, t, cfg)
    ckpt = str(tmp_path / "cov.npz")
    s2.save(ckpt)
    s3 = pca.CovarianceState.load(ckpt)
    for t in corpus[2:]:
        s3 = pca.accumulate_track(s3, t, cfg)
    np.testing.assert_allclose(s3.xtx, s1.xtx, rtol=1e-6)
    assert s3.count == s1.count
    f1 = pca.finalize_filters(s1, cfg)
    f3 = pca.finalize_filters(s3, cfg)
    np.testing.assert_allclose(f1, f3, atol=1e-5)


def test_fingerprint_stream_double_buffered(cfg):
    filters = _filters(cfg)
    tracks = synth.synth_catalog(7, 2.0, cfg)
    n = min(len(t) for t in tracks)
    batches = [np.stack([tracks[i][:n], tracks[i + 1][:n]]) for i in range(0, 6, 2)]
    streamed = list(api.fingerprint_stream(iter(batches), filters, cfg))
    assert len(streamed) == 3
    for i, batch in enumerate(batches):
        want = api.fingerprint_batch(batch, filters, cfg)
        np.testing.assert_array_equal(streamed[i], want)


def test_pack_bits_msb0_order():
    from hpfw_jax.config import HpfwConfig
    from hpfw_jax.ops import fingerprint as fp_ops
    import jax.numpy as jnp

    cfg_msb = HpfwConfig(bit_order="msb0")
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (20, 64)).astype(bool)
    got = np.asarray(fp_ops.pack_bits(jnp.asarray(bits), cfg_msb))
    want = oracle.pack_bits(bits, cfg_msb)
    np.testing.assert_array_equal(got, want)
    # filter 0 -> bit 63 of the logical word
    h = oracle.packed_to_uint64(want)
    np.testing.assert_array_equal(((h >> np.uint64(63)) & np.uint64(1)).astype(bool), bits[:, 0])
    back = np.asarray(fp_ops.unpack_bits(jnp.asarray(got), cfg_msb))
    np.testing.assert_array_equal(back, bits)


def test_fingerprint_bucketing_exact(cfg):
    """Length bucketing pads PCM but returns identical prints (and count)."""
    filters = _filters(cfg)
    rng = np.random.default_rng(11)
    for extra in [0, 17, cfg.hop - 1, 3 * cfg.hop + 5]:
        pcm = synth.synth_track(40, 1.7, cfg)
        pcm = pcm[: len(pcm) - extra]
        unbucketed = api.fingerprint(pcm, filters, cfg, bucket_s=0)
        bucketed = api.fingerprint(pcm, filters, cfg, bucket_s=0.25)
        assert bucketed.shape == unbucketed.shape == (cfg.n_hashprints(len(pcm)), 2)
        np.testing.assert_array_equal(bucketed, unbucketed)


def test_precise_dot_is_true_float32():
    """Extraction GEMMs request HIGHEST precision (no TF32, no bf16)."""
    from hpfw_jax.ops import dot

    a = jnp.ones((4, 3), jnp.float32)
    jaxpr = jax.make_jaxpr(dot.precise_dot)(a, a.T)
    (eqn,) = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert str(eqn.params["precision"]).count("HIGHEST") == 2
