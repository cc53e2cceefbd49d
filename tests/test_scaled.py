"""Two-stage coarse->fine matcher tests (single device + 8-device mesh)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hpfw_jax import api, oracle
from hpfw_jax.io import synth
from hpfw_jax.match.scaled import TwoStageDB
from hpfw_jax.ops import coarse as coarse_ops
from hpfw_jax.parallel import mesh as meshlib


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return oracle.fix_eigenvector_signs(f).astype(np.float32)


def test_unpack_pm1_roundtrip(cfg):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (30, 64)).astype(bool)
    packed = oracle.pack_bits(bits, cfg)
    pm1 = np.asarray(coarse_ops.unpack_bits_pm1(jnp.asarray(packed)))
    np.testing.assert_array_equal(pm1 == 1, bits)


def test_coarse_majority_definition(cfg):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (40, 64)).astype(bool)
    packed = oracle.pack_bits(bits, cfg)
    s = 4
    c = np.asarray(coarse_ops.coarse_pm1(jnp.asarray(packed), s))
    assert c.shape == (10, 64)
    pm1 = bits.astype(np.int32) * 2 - 1
    want = np.where(pm1.reshape(10, s, 64).sum(1) > 0, 1, -1)
    np.testing.assert_array_equal(c, want)


def test_coarse_correlation_exact(cfg):
    rng = np.random.default_rng(2)
    q = rng.choice([-1, 1], (6, 64)).astype(np.int8)
    d = rng.choice([-1, 1], (3, 20, 64)).astype(np.int8)
    corr = np.asarray(coarse_ops.coarse_correlation(jnp.asarray(q), jnp.asarray(d)))
    assert corr.shape == (3, 15)
    for t in range(3):
        for a in range(15):
            want = int((q.astype(np.int32) * d[t, a:a + 6].astype(np.int32)).sum())
            assert corr[t, a] == want


def test_two_stage_agrees_with_exhaustive(cfg):
    """On the pool it returns, two-stage scores/offsets are exact."""
    tracks = synth.synth_catalog(24, 4.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    ts = TwoStageDB(db, stride=4)
    q = synth.make_query(tracks[13], 0.9, 2.0, cfg, noise_db=-18.0, seed=5)
    qfp = api.fingerprint(q, filters, cfg)
    ids, scores, offs = ts.match(qfp, top_k=5, pool=24)
    ids_d, scores_d, offs_d = api.match(qfp, db, top_k=5)
    assert ids[0] == ids_d[0] == "13"
    assert int(scores[0]) == int(scores_d[0])
    assert int(offs[0]) == int(offs_d[0])


def test_two_stage_sharded_equals_single(cfg):
    assert len(jax.devices()) == 8
    mesh = meshlib.db_mesh(8)
    tracks = synth.synth_catalog(19, 4.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    single = TwoStageDB(db, stride=4)
    sharded = TwoStageDB(db, stride=4, mesh=mesh)
    q = synth.make_query(tracks[7], 1.1, 2.0, cfg, noise_db=-15.0, seed=3)
    qfp = api.fingerprint(q, filters, cfg)
    ids_1, s_1, o_1 = single.match(qfp, top_k=3, pool=5)
    ids_8, s_8, o_8 = sharded.match(qfp, top_k=3, pool=5)
    assert ids_1[0] == ids_8[0] == "7"
    assert ids_1 == ids_8
    np.testing.assert_array_equal(s_1, s_8)
    np.testing.assert_array_equal(o_1, o_8)


def test_two_stage_exact_excerpt_perfect_score(cfg):
    tracks = synth.synth_catalog(10, 4.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    ts = TwoStageDB(db, stride=4)
    k = 11
    q_pcm = tracks[6][k * cfg.hop: k * cfg.hop + 2 * cfg.sample_rate]
    qfp = api.fingerprint(q_pcm, filters, cfg)
    ids, scores, offs = ts.match(qfp, top_k=1, pool=10)
    assert ids[0] == "6"
    assert int(scores[0]) == 64 * qfp.shape[0]
    assert int(offs[0]) == k


def test_two_stage_sharded_pallas_fine(cfg):
    """The four-device production path: per-shard coarse sweep + band-gather
    fine rescan + all-gather merge — must equal the single-device result."""
    mesh = meshlib.db_mesh(8)
    tracks = synth.synth_catalog(19, 4.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    single = TwoStageDB(db, stride=4)
    sharded = TwoStageDB(db, stride=4, mesh=mesh)
    q = synth.make_query(tracks[12], 0.7, 2.0, cfg, noise_db=-15.0, seed=8)
    qfp = api.fingerprint(q, filters, cfg)
    ids_1, s_1, o_1 = single.match(qfp, top_k=3, pool=19)
    ids_8, s_8, o_8 = sharded.match(qfp, top_k=3, pool=19)
    assert ids_1[0] == ids_8[0] == "12"
    assert ids_1 == ids_8
    np.testing.assert_array_equal(s_1, s_8)
    np.testing.assert_array_equal(o_1, o_8)


def test_two_stage_single_device_pallas_tight_planes(cfg):
    """Single-device path, first and LAST track included: the band gather
    never reads past a track's rows into its neighbour's — exact agreement
    with the dense matcher on the top hit."""
    tracks = synth.synth_catalog(14, 4.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    ts = TwoStageDB(db, stride=4)
    for seed, tid in [(1, 9), (2, 0), (3, 13)]:  # incl. first and LAST track
        q = synth.make_query(tracks[tid], 0.8, 2.0, cfg, noise_db=-15.0, seed=seed)
        qfp = api.fingerprint(q, filters, cfg)
        ids_p, s_p, o_p = ts.match(qfp, top_k=3, pool=14)
        ids_d, s_d, o_d = api.match(qfp, db, top_k=3)
        assert ids_p[0] == ids_d[0] == str(tid)
        assert int(s_p[0]) == int(s_d[0]) and int(o_p[0]) == int(o_d[0])


def test_two_stage_overlong_query_raises(cfg):
    tracks = synth.synth_catalog(6, 2.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    ts = TwoStageDB(db, stride=4)
    n_long = (ts.db_c.shape[1] + 1) * 4
    q = np.zeros((n_long, 2), dtype=np.uint32)
    with pytest.raises(ValueError, match="longer than"):
        ts.match(q, top_k=1)


def test_dense_match_overlong_query_truncated_overlap(cfg):
    """Query longer than every DB track: oracle head-overlap semantics."""
    tracks = synth.synth_catalog(5, 1.5, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    rng = np.random.default_rng(11)
    n_long = db.prints.shape[1] + 7
    q = rng.integers(0, 2 ** 32, (n_long, 2), dtype=np.uint32)
    fps = [db.prints[i, : db.lengths[i]] for i in range(db.n_tracks)]
    q[: fps[2].shape[0]] = fps[2]  # plant track 2 as the head of the query
    ids, scores, offs = api.match(q, db, top_k=5)
    want = [oracle.match_track(q, f) for f in fps]
    order = np.lexsort((np.arange(5), -np.array([w[0] for w in want])))
    assert ids[0] == str(order[0]) == "2"
    for rank_i, ti in enumerate(order):
        assert ids[rank_i] == str(ti)
        assert int(scores[rank_i]) == want[ti][0]
        assert int(offs[rank_i]) == want[ti][1]


def test_two_stage_pallas_coarse_equals_xla_coarse(cfg):
    """The coarse stage pools identically on one device and on the 8-device
    mesh: with the same catalog-wide pool (smaller than the catalog), the
    full top-5 (ids, scores, offsets) agree."""
    tracks = synth.synth_catalog(24, 4.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    a = TwoStageDB(db, stride=4)
    b = TwoStageDB(db, stride=4, mesh=meshlib.db_mesh(8))
    for seed in (0, 1):
        q = synth.make_query(tracks[seed + 9], 0.7, 2.0, cfg,
                             noise_db=-12.0, seed=seed)
        qfp = api.fingerprint(q, filters, cfg)
        ids_a, s_a, o_a = a.match(qfp, top_k=5, pool=7)
        ids_b, s_b, o_b = b.match(qfp, top_k=5, pool=7)
        assert ids_a == ids_b
        np.testing.assert_array_equal(s_a, s_b)
        np.testing.assert_array_equal(o_a, o_b)


def test_pool_candidates_two_level_exact(cfg):
    """The two-level top-k pool returns the identical candidate list (values,
    order, tie-breaks) as one flat lax.top_k — heavy ties included."""
    from hpfw_jax.match.scaled import _POOL_ROWS, _pool_candidates

    rng = np.random.default_rng(7)
    pool = 16
    t = 4 * _POOL_ROWS * pool          # large enough for the two-level path
    scores = jnp.asarray(rng.integers(-5, 5, t, dtype=np.int32))  # many ties
    got = np.asarray(_pool_candidates(scores, pool))
    _, want = jax.lax.top_k(scores, pool)
    np.testing.assert_array_equal(got, np.asarray(want))
    # Small inputs take the flat path; a pool beyond the catalog returns
    # every track once.
    small = jnp.asarray(rng.integers(-5, 5, 5, dtype=np.int32))
    got_s = np.asarray(_pool_candidates(small, 3))
    np.testing.assert_array_equal(got_s, np.asarray(jax.lax.top_k(small, 3)[1]))
    got_all = np.asarray(_pool_candidates(small, 9))
    assert sorted(got_all.tolist()) == list(range(5))


def test_two_stage_reduced_channels_matches_full_on_pool(cfg):
    """coarse_channels=32 halves coarse bytes; the two-stage result stays
    exact-on-pool (scores/offsets equal the exhaustive matcher when the
    true track pools), on the single-device and sharded paths."""
    import dataclasses

    tracks = synth.synth_catalog(24, 4.0, cfg)
    filters = _filters(cfg)
    cfg32 = dataclasses.replace(cfg, coarse_channels=32)
    db = api.build_db(tracks, filters, cfg32)
    xla = TwoStageDB(db, stride=4)
    pal = TwoStageDB(db, stride=4, mesh=meshlib.db_mesh(8))
    assert xla.coarse_channels == pal.coarse_channels == 32
    assert xla.db_c.shape[2] == 32
    for seed in (0, 1):
        q = synth.make_query(tracks[seed + 11], 0.8, 2.0, cfg,
                             noise_db=-15.0, seed=seed)
        qfp = api.fingerprint(q, filters, cfg)
        ia, sa, oa = xla.match(qfp, top_k=3, pool=6)
        ip, sp, op = pal.match(qfp, top_k=3, pool=6)
        assert ia == ip
        np.testing.assert_array_equal(sa, sp)
        np.testing.assert_array_equal(oa, op)
        assert ia[0] == str(seed + 11)
        w_ids, w_s, w_o = api.match(qfp, db, top_k=1)
        assert (ia[0], int(sa[0]), int(oa[0])) == \
            (w_ids[0], int(w_s[0]), int(w_o[0]))


def test_phase_max_coarse_exact_and_robust(cfg):
    """query_phases > 1: (a) with a full pool, results match the dense scan
    exactly for misphased excerpts (phase-corrected centers must land the
    fine band on the true offset); (b) the phased coarse ranks a misphased
    true track at least as high as the unphased coarse."""
    import jax.numpy as jnp

    from hpfw_jax.match.scaled import _coarse_best_phased
    from hpfw_jax.ops import coarse as coarse_ops

    rng = np.random.default_rng(5)
    T, L, NQ, stride = 48, 200, 64, 8
    prints = rng.integers(0, 2 ** 32, (T, L, 2), dtype=np.uint32)
    db = api.FingerprintDB(cfg, _filters(cfg), [str(i) for i in range(T)],
                           prints, np.full(T, L, np.int32))
    for ts in (TwoStageDB(db, stride=stride, query_phases=4),
               TwoStageDB(db, stride=stride, query_phases=4,
                          mesh=meshlib.db_mesh(8))):
        for r in (0, 3, 4, 7):                 # worst misphase incl. r=s/2
            off = 5 * stride + r
            q = prints[7, off:off + NQ].copy()
            flip = (rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32)
                    & rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32)
                    & rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32))
            q = np.bitwise_xor(q, flip)
            ids, s, o = ts.match(q, top_k=1, pool=T)
            ids_d, s_d, o_d = api.match(q, db, top_k=1)
            assert ids[0] == ids_d[0] == "7", (r, ids[0], ids_d[0])
            assert int(s[0]) == int(s_d[0]) and int(o[0]) == int(o_d[0])

    # (b) coarse ranking robustness at the worst misphase
    q = prints[3, 5 * stride + stride // 2:
               5 * stride + stride // 2 + NQ].copy()
    db_c3 = coarse_ops.coarse_pm1(jnp.asarray(prints), stride)
    qc = coarse_ops.coarse_pm1(jnp.asarray(q), stride)
    best1 = coarse_ops.coarse_best(qc[None], db_c3)[0][0]
    bestp, centers = _coarse_best_phased(
        jnp.asarray(q)[None], db_c3, stride=stride, phases=4,
        coarse_kind="sign", coarse_channels=64)
    bestp, centers = bestp[0], centers[0]
    rank1 = int((np.asarray(best1) >= np.asarray(best1)[3]).sum())
    rankp = int((np.asarray(bestp) >= np.asarray(bestp)[3]).sum())
    assert rankp <= rank1
    # the phase-corrected center must be within fine_window of the truth
    assert abs(int(np.asarray(centers)[3]) - (5 * stride + stride // 2)) <= stride


def test_two_pass_prefilter_coarse(cfg):
    """prefilter > 0 (two-pass phased coarse): (a) with prefilter >= T the
    result is IDENTICAL to the one-pass phased match (sorted-subset pooling
    keeps the global tie-break); (b) a small prefilter still lands the
    misphased true track with dense-exact score/offset; (c) batched and
    sharded paths agree."""
    rng = np.random.default_rng(9)
    T, L, NQ, stride = 48, 200, 64, 8
    prints = rng.integers(0, 2 ** 32, (T, L, 2), dtype=np.uint32)
    db = api.FingerprintDB(cfg, _filters(cfg), [str(i) for i in range(T)],
                           prints, np.full(T, L, np.int32))
    one = TwoStageDB(db, stride=stride, query_phases=4)
    two = TwoStageDB(db, stride=stride, query_phases=4,
                     prefilter=T, prefilter_phases=2)
    qs = []
    for k, r in enumerate((1, 3, 4, 7)):
        off = (4 + k) * stride + r
        q = prints[7 + k, off:off + NQ].copy()
        flip = (rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32)
                & rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32)
                & rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32))
        qs.append(np.bitwise_xor(q, flip))
    # (a) prefilter >= T: exact equality with one-pass phased, full ranking
    for q in qs:
        i1, s1, o1 = one.match(q, top_k=5, pool=T)
        i2, s2, o2 = two.match(q, top_k=5, pool=T)
        assert i1 == i2
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(o1, o2)
    # (b) small prefilter: true track found, dense-exact score/offset
    for k, q in enumerate(qs):
        ids, s, o = two.match(q, top_k=1, pool=8, prefilter=16)
        ids_d, s_d, o_d = api.match(q, db, top_k=1)
        assert ids[0] == ids_d[0] == str(7 + k)
        assert int(s[0]) == int(s_d[0]) and int(o[0]) == int(o_d[0])
    # (c) batched two-pass == per-query two-pass; sharded agrees on top-1
    batch = np.stack(qs)
    res_b = two.match_batch(batch, top_k=1, pool=8, prefilter=16)
    for k, (tid, s, o) in enumerate(res_b):
        ids, s1, o1 = two.match(qs[k], top_k=1, pool=8, prefilter=16)
        assert tid[0] == ids[0]
        assert int(s[0]) == int(s1[0]) and int(o[0]) == int(o1[0])
    mesh = meshlib.db_mesh(8)
    sharded = TwoStageDB(db, stride=stride, mesh=mesh, query_phases=4,
                         prefilter=4, prefilter_phases=2)
    for k, q in enumerate(qs):
        ids, s, o = sharded.match(q, top_k=1, pool=4)
        ids_d, s_d, o_d = api.match(q, db, top_k=1)
        assert ids[0] == ids_d[0] == str(7 + k)
        assert int(s[0]) == int(s_d[0]) and int(o[0]) == int(o_d[0])
    res_sb = sharded.match_batch(batch, top_k=1, pool=4)
    for k, (tid, s, o) in enumerate(res_sb):
        assert tid[0] == str(7 + k)


def test_prefilter_channel_subset(cfg, tmp_path):
    """prefilter_channels < coarse_channels (cheap pass-1 sweep on the
    C1-prefix coarse DB): (a) with prefilter >= T results are IDENTICAL to
    the full-channel one-pass phased match (every track pools regardless of
    pass-1 ranking); (b) a small prefilter still lands the true track with
    dense-exact score/offset, single and batched; (c) the derived subset DB
    save/loads; (d) the sharded path agrees."""
    rng = np.random.default_rng(21)
    T, L, NQ, stride = 48, 200, 64, 8
    prints = rng.integers(0, 2 ** 32, (T, L, 2), dtype=np.uint32)
    db = api.FingerprintDB(cfg, _filters(cfg), [str(i) for i in range(T)],
                           prints, np.full(T, L, np.int32))
    one = TwoStageDB(db, stride=stride, query_phases=4)
    sub = TwoStageDB(db, stride=stride, query_phases=4,
                     prefilter=T, prefilter_phases=2, prefilter_channels=32,
                     keep_host=True)
    assert sub.db_c1 is not sub.db_c
    assert sub.db_c1.shape[2] == 32 < sub.db_c.shape[2]
    qs = []
    for k, r in enumerate((1, 3, 4, 7)):
        off = (4 + k) * stride + r
        q = prints[7 + k, off:off + NQ].copy()
        flip = (rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32)
                & rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32)
                & rng.integers(0, 1 << 32, (NQ, 2), dtype=np.uint32))
        qs.append(np.bitwise_xor(q, flip))
    # (a) prefilter >= T: pass-1 ranking is irrelevant, exact equality
    for q in qs:
        i1, s1, o1 = one.match(q, top_k=5, pool=T)
        i2, s2, o2 = sub.match(q, top_k=5, pool=T)
        assert i1 == i2
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(o1, o2)
    # (b) small prefilter on the 32-channel pass 1 still finds the truth
    for k, q in enumerate(qs):
        ids, s, o = sub.match(q, top_k=1, pool=8, prefilter=16)
        ids_d, s_d, o_d = api.match(q, db, top_k=1)
        assert ids[0] == ids_d[0] == str(7 + k)
        assert int(s[0]) == int(s_d[0]) and int(o[0]) == int(o_d[0])
    res_b = sub.match_batch(np.stack(qs), top_k=1, pool=8, prefilter=16)
    for k, (tid, s, o) in enumerate(res_b):
        assert tid[0] == str(7 + k)
    # (c) save/load keeps the subset DB and the results
    p = str(tmp_path / "ts_cache")
    sub.save(p)
    loaded = TwoStageDB.load(p)
    assert loaded.prefilter_channels == 32
    assert loaded.db_c1.shape == sub.db_c1.shape
    for k, q in enumerate(qs):
        ids, s, o = loaded.match(q, top_k=1, pool=8, prefilter=16,
                                 phases=4, phases1=2)
        assert ids[0] == str(7 + k)
    # (d) sharded path with the subset pass-1
    mesh = meshlib.db_mesh(8)
    sharded = TwoStageDB(db, stride=stride, mesh=mesh, query_phases=4,
                         prefilter=4, prefilter_phases=2,
                         prefilter_channels=32)
    for k, q in enumerate(qs):
        ids, s, o = sharded.match(q, top_k=1, pool=4)
        assert ids[0] == str(7 + k)
    res_sb = sharded.match_batch(np.stack(qs), top_k=1, pool=4)
    for k, (tid, s, o) in enumerate(res_sb):
        assert tid[0] == str(7 + k)


def test_catalog_scale_preset(cfg):
    """HpfwConfig.catalog_scale() pins the measured 250k recall point and
    TwoStageDB picks its knobs up; overrides pass through."""
    from hpfw_jax.config import HpfwConfig

    c = HpfwConfig.catalog_scale()
    c.validate()
    assert (c.coarse_query_phases, c.coarse_prefilter,
            c.coarse_prefilter_phases, c.coarse_prefilter_channels,
            c.fine_candidates) == (8, 8192, 2, 32, 1024)
    c2 = HpfwConfig.catalog_scale(coarse_prefilter_channels=16,
                                  db_downsample=32)
    assert c2.coarse_prefilter_channels == 16 and c2.db_downsample == 32
    rng = np.random.default_rng(33)
    prints = rng.integers(0, 2 ** 32, (16, 120, 2), dtype=np.uint32)
    db = api.FingerprintDB(c, _filters(c), [str(i) for i in range(16)],
                           prints, np.full(16, 120, np.int32))
    ts = TwoStageDB(db)
    assert (ts.query_phases, ts.prefilter, ts.prefilter_phases,
            ts.prefilter_channels) == (8, 8192, 2, 32)
    assert ts.db_c1 is not ts.db_c


def test_two_pass_prefilter_single_and_mesh(cfg):
    """The two-pass preset runs on the single-device path and on the
    8-device mesh; with every track pooled both equal the dense matcher
    (score and offset) for misphased noisy excerpts."""
    rng = np.random.default_rng(10)
    T, L, NQ, stride = 32, 120, 48, 8
    prints = rng.integers(0, 2 ** 32, (T, L, 2), dtype=np.uint32)
    db = api.FingerprintDB(cfg, _filters(cfg), [str(i) for i in range(T)],
                           prints, np.full(T, L, np.int32))
    kw = dict(stride=stride, query_phases=4, prefilter=8, prefilter_phases=2,
              prefilter_channels=32)
    single = TwoStageDB(db, **kw)
    sharded = TwoStageDB(db, mesh=meshlib.db_mesh(8), **kw)
    for k, r in enumerate((2, 5)):
        off = 3 * stride + r
        q = prints[4 + 9 * k, off:off + NQ].copy()
        q[::7] ^= np.uint32(0x0F0F0F0F)
        ids_d, s_d, o_d = api.match(q, db, top_k=1)
        for ts, pool in ((single, 8), (sharded, 2)):
            ids, s, o = ts.match(q, top_k=1, pool=pool)
            assert ids[0] == ids_d[0] == str(4 + 9 * k)
            assert int(s[0]) == int(s_d[0]) and int(o[0]) == int(o_d[0])


def test_phased_batch_sweep_equals_per_query(cfg):
    """The B*P variant rows of a phased batch ride one sweep; each query's
    (best, center) equals its own single-query phased sweep."""
    from hpfw_jax.match.scaled import _coarse_best_phased
    from hpfw_jax.ops import coarse as coarse_ops

    rng = np.random.default_rng(12)
    T, L, NQ, stride = 16, 120, 48, 8
    prints = rng.integers(0, 2 ** 32, (T, L, 2), dtype=np.uint32)
    queries = jnp.asarray(
        np.stack([prints[i, 8 * i // 4 + i % 4:][:NQ] for i in range(6)]))
    db_c = coarse_ops.coarse_pm1(jnp.asarray(prints), stride)
    kw = dict(stride=stride, phases=4, coarse_kind="sign",
              coarse_channels=64)
    got_b, got_c = _coarse_best_phased(queries, db_c, **kw)
    for i in range(6):
        want_b, want_c = _coarse_best_phased(queries[i:i + 1], db_c, **kw)
        np.testing.assert_array_equal(np.asarray(got_b[i]), np.asarray(want_b[0]))
        np.testing.assert_array_equal(np.asarray(got_c[i]), np.asarray(want_c[0]))


def test_dispatch_is_a_batch_of_one(cfg):
    """dispatch(q) is dispatch_batch(q[None])[0]: one program, one result."""
    rng = np.random.default_rng(3)
    prints = rng.integers(0, 2 ** 32, (8, 40, 2), dtype=np.uint32)
    db = api.FingerprintDB(cfg, _filters(cfg), [str(i) for i in range(8)],
                           prints, np.full(8, 40, np.int32))
    ts = TwoStageDB(db, stride=4)
    q = jnp.asarray(prints[5, 3:23])
    one = np.asarray(ts.dispatch(q, pool=4))
    batch = np.asarray(ts.dispatch_batch(jnp.stack([q, q[::-1]]), pool=4))
    assert one.shape == (3, 4)
    np.testing.assert_array_equal(one, batch[0])
    assert one[1, 0] == 5 and one[0, 0] == 64 * 20 and one[2, 0] == 3


@pytest.mark.parametrize("mode", ["single_pass", "phased", "two_pass"])
def test_mesh_result_equals_one_device(cfg, mode):
    """Pools are chosen catalog-wide under a mesh: with pools smaller than
    a shard and a catalog that needs padding, the 8-device result (full
    top-k ids, scores, offsets) equals the one-device result, through
    match and match_batch."""
    rng = np.random.default_rng(40)
    T, L, NQ, stride = 250, 120, 48, 8
    prints = rng.integers(0, 2 ** 32, (T, L, 2), dtype=np.uint32)
    db = api.FingerprintDB(cfg, _filters(cfg), [str(i) for i in range(T)],
                           prints, np.full(T, L, np.int32))
    kw = {"single_pass": {},
          "phased": dict(query_phases=4),
          "two_pass": dict(query_phases=4, prefilter=24, prefilter_phases=2,
                           prefilter_channels=32)}[mode]
    one = TwoStageDB(db, stride=stride, **kw)
    sharded = TwoStageDB(db, stride=stride, mesh=meshlib.db_mesh(8), **kw)
    qs = []
    for k, t in enumerate((3, 77, 160, 249)):
        q = prints[t, 10 + k:10 + k + NQ].copy()
        q[::3] ^= np.uint32(0x00FF00FF)
        qs.append(q)
    qs = np.stack(qs)
    want = [one.match(q, top_k=8, pool=12) for q in qs]
    got = ([sharded.match(q, top_k=8, pool=12) for q in qs]
           + sharded.match_batch(qs, top_k=8, pool=12))
    for (ids, s, o), (ids_w, s_w, o_w) in zip(got, want + want):
        assert ids == ids_w
        np.testing.assert_array_equal(s, s_w)
        np.testing.assert_array_equal(o, o_w)
    assert [w[0][0] for w in want] == ["3", "77", "160", "249"]
