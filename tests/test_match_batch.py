"""Batched two-stage matching == per-query matching (CPU, 8-device sim)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from hpfw_jax import api, oracle
from hpfw_jax.io import synth
from hpfw_jax.match.scaled import TwoStageDB, _fine_rescan
from hpfw_jax.ops import coarse as coarse_ops


def test_coarse_correlation_batch_equals_single(cfg):
    rng = np.random.default_rng(0)
    qs = rng.choice([-1, 1], (3, 6, 64)).astype(np.int8)
    d = rng.choice([-1, 1], (5, 40, 64)).astype(np.int8)
    batch = np.asarray(coarse_ops.coarse_correlation_batch(jnp.asarray(qs), jnp.asarray(d)))
    for b in range(3):
        single = np.asarray(coarse_ops.coarse_correlation(jnp.asarray(qs[b]), jnp.asarray(d)))
        np.testing.assert_array_equal(batch[b], single)


def test_fine_rescan_batch_equals_single():
    rng = np.random.default_rng(1)
    t, l, n, fw = 24, 300, 60, 8
    n_fine = 2 * fw + 1
    prints = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
    lengths = np.full(t, l, np.int32)
    queries = rng.integers(0, 2 ** 32, (2, n, 2), dtype=np.uint32)
    prints[5, 100:100 + n] = queries[0]
    prints[9, 40:40 + n] = queries[1]
    k = 8
    cand = np.stack([rng.permutation(t)[:k], rng.permutation(t)[:k]]).astype(np.int32)
    cand[0, 0] = 5
    cand[1, 0] = 9
    centers = np.stack([np.full(k, 100), np.full(k, 40)]).astype(np.int32)
    span = n + n_fine - 1
    starts = np.clip(centers - fw, 0, max(l - span, 0)).astype(np.int32)
    args = (jnp.asarray(prints), jnp.asarray(lengths))
    s_b, o_b = _fine_rescan(jnp.asarray(queries), *args, jnp.asarray(cand),
                            jnp.asarray(starts), n_fine=n_fine)
    for b in range(2):
        s_1, o_1 = _fine_rescan(jnp.asarray(queries[b:b + 1]), *args,
                                jnp.asarray(cand[b:b + 1]),
                                jnp.asarray(starts[b:b + 1]), n_fine=n_fine)
        np.testing.assert_array_equal(np.asarray(s_b[b]), np.asarray(s_1[0]))
        np.testing.assert_array_equal(np.asarray(o_b[b]), np.asarray(o_1[0]))
    assert int(s_b[0, 0]) == 64 * n and int(o_b[0, 0]) == 100
    assert int(s_b[1, 0]) == 64 * n and int(o_b[1, 0]) == 40


def test_match_batch_equals_match_single_device(cfg):
    """match_batch rows equal match() of each query, full top-k, on the
    single-device path (one program: a match is a batch of one)."""
    tracks = synth.synth_catalog(11, 4.0, cfg)
    rng = np.random.default_rng(4)
    filters = oracle.fix_eigenvector_signs(
        rng.standard_normal((cfg.context_dim, cfg.n_filters))
        / np.sqrt(cfg.context_dim)).astype(np.float32)
    db = api.build_db(tracks, filters, cfg)
    ts = TwoStageDB(db, stride=4, query_phases=2)
    queries = np.stack([
        api.fingerprint(synth.make_query(tracks[2 * b + 1], 0.6, 2.0, cfg,
                                         noise_db=-12.0, seed=b),
                        filters, cfg)
        for b in range(4)])
    for kw in ({}, {"phases": 1}, {"prefilter": 6, "phases1": 2}):
        res = ts.match_batch(queries, top_k=5, pool=6, **kw)
        for b in range(4):
            ids, s, o = ts.match(queries[b], top_k=5, pool=6, **kw)
            assert res[b][0] == ids
            np.testing.assert_array_equal(res[b][1], s)
            np.testing.assert_array_equal(res[b][2], o)
        assert [r[0][0] for r in res] == [str(2 * b + 1) for b in range(4)]


def test_match_batch_sharded_equals_single(cfg):
    """Sharded batched serving: 8-dev mesh match_batch == single-device
    match_batch == per-query match (VERDICT r1 item 3)."""
    from hpfw_jax.parallel import mesh as meshlib

    assert len(jax.devices()) == 8
    tracks = synth.synth_catalog(13, 4.0, cfg)
    rng = np.random.default_rng(0)
    filters = rng.standard_normal((cfg.context_dim, cfg.n_filters)).astype(np.float32)
    filters = oracle.fix_eigenvector_signs(filters / np.sqrt(cfg.context_dim))
    db = api.build_db(tracks, filters, cfg)
    single = TwoStageDB(db, stride=4)
    sharded = TwoStageDB(db, stride=4, mesh=meshlib.db_mesh(8))
    queries = np.stack([
        api.fingerprint(
            synth.make_query(tracks[3 + b], 0.8, 2.0, cfg, noise_db=-15.0,
                             seed=b), filters, cfg)
        for b in range(3)
    ])
    res_1 = single.match_batch(queries, top_k=4, pool=8)
    res_8 = sharded.match_batch(queries, top_k=4, pool=2)
    for b in range(3):
        ids1, s1, o1 = res_1[b]
        ids8, s8, o8 = res_8[b]
        assert ids1[0] == ids8[0] == str(3 + b)
        assert int(s1[0]) == int(s8[0]) and int(o1[0]) == int(o8[0])
        # per-query path agrees on the top hit
        ids_q, s_q, o_q = single.match(queries[b], top_k=4, pool=8)
        assert ids_q[0] == ids1[0] and int(s_q[0]) == int(s1[0])
