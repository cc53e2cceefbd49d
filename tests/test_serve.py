"""MatchServer micro-batching: results equal direct match(); batching real."""

import numpy as np
import pytest

from hpfw_jax import api, oracle
from hpfw_jax.io import synth
from hpfw_jax.match.scaled import TwoStageDB
from hpfw_jax.serve import MatchServer


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return oracle.fix_eigenvector_signs(f).astype(np.float32)


@pytest.fixture(scope="module")
def served(cfg):
    tracks = synth.synth_catalog(16, 4.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    ts = TwoStageDB(db, stride=4)
    return cfg, tracks, filters, ts


def test_server_results_equal_direct_match(served):
    cfg, tracks, filters, ts = served
    queries = []
    for seed in range(6):
        q = synth.make_query(tracks[seed + 4], 0.5, 2.0, cfg,
                             noise_db=-15.0, seed=seed)
        queries.append(api.fingerprint(q, filters, cfg))
    n_q = min(q.shape[0] for q in queries)
    queries = [q[:n_q] for q in queries]
    with MatchServer(ts, n_q, max_batch=4, max_wait_ms=30.0,
                     pool=16) as srv:
        futs = [srv.submit(q) for q in queries]
        got = [f.result(timeout=120) for f in futs]
    for q, (ids, scores, offs) in zip(queries, got):
        w_ids, w_scores, w_offs = ts.match(q, pool=16)
        assert ids == w_ids
        np.testing.assert_array_equal(scores, w_scores)
        np.testing.assert_array_equal(offs, w_offs)


def test_server_rejects_wrong_length_and_closes(served):
    cfg, tracks, filters, ts = served
    srv = MatchServer(ts, 40, max_batch=2, max_wait_ms=1.0, pool=16)
    bad = srv.submit(np.zeros((7, 2), np.uint32))
    with pytest.raises(ValueError):
        bad.result(timeout=10)
    srv.close()
    late = srv.submit(np.zeros((40, 2), np.uint32))
    with pytest.raises(RuntimeError):
        late.result(timeout=10)


def test_server_bounded_queue_sheds_load(served):
    """When the submit queue is full the server rejects with ServerSaturated
    instead of queueing unboundedly; accepted queries still resolve
    correctly."""
    from hpfw_jax.serve import ServerSaturated

    cfg, tracks, filters, ts = served
    q = synth.make_query(tracks[5], 0.5, 2.0, cfg, noise_db=-15.0, seed=9)
    qfp = api.fingerprint(q, filters, cfg)
    with MatchServer(ts, qfp.shape[0], max_batch=1, max_wait_ms=0.1,
                     depth=1, max_queue=2, pool=16) as srv:
        futs = [srv.submit(qfp) for _ in range(40)]
        done = [f.result(timeout=300) if not f.exception(timeout=300)
                else None for f in futs]
    rejected = sum(d is None for d in done)
    accepted = [d for d in done if d is not None]
    assert rejected > 0, "a 2-deep queue must shed some of 40 instant submits"
    assert accepted, "some submissions must still be served"
    for f, d in zip(futs, done):
        if d is None:
            assert isinstance(f.exception(), ServerSaturated)
    w_ids, w_scores, _ = ts.match(qfp, pool=16)
    for ids, scores, _ in accepted:
        assert ids == w_ids
        np.testing.assert_array_equal(scores, w_scores)


def test_server_on_mesh(cfg):
    """MatchServer over a mesh-sharded TwoStageDB (8-device CPU sim)."""
    import jax

    from hpfw_jax.parallel import mesh as meshlib

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU sim")
    tracks = synth.synth_catalog(16, 4.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    mesh = meshlib.db_mesh(8)
    ts = TwoStageDB(db, stride=4, mesh=mesh)
    q = synth.make_query(tracks[6], 0.5, 2.0, cfg, noise_db=-15.0, seed=1)
    qfp = api.fingerprint(q, filters, cfg)
    with MatchServer(ts, qfp.shape[0], max_batch=4, max_wait_ms=10.0,
                     pool=16) as srv:
        ids, scores, offs = srv.match(qfp)
    w_ids, w_scores, w_offs = ts.match(qfp, pool=16)
    assert ids == w_ids
    np.testing.assert_array_equal(scores, w_scores)


def test_escalating_server_end_to_end(cfg):
    """EscalatingMatchServer: in-tempo queries resolve on the rigid class
    (escalated=False), a stretched rendition escalates to the scan class
    and recovers (escalated=True); results agree with the batch API's
    escalation semantics; stats are consistent."""
    import dataclasses

    from hpfw_jax.io import synth_jax
    from hpfw_jax.serve import EscalatingMatchServer

    cfg2 = dataclasses.replace(cfg, stretch_span=0.03, pitch_span_bins=0)
    tracks = np.asarray(synth_jax.synth_batch(np.arange(12), 6.0, cfg2))
    filters = _filters(cfg2)
    db = api.build_db(list(tracks), filters, cfg2)
    ts = TwoStageDB(db, stride=4)
    n_samples = int(4.0 * cfg2.sample_rate)
    truths = [3, 9, 5]
    pcms = [
        np.asarray(synth_jax.live_query_batch(
            [truths[0]], [int(0.5 * cfg2.sample_rate)], 6.0, 4.0, cfg2,
            stretch=1.0, noise_db=-25.0))[0],
        np.asarray(synth_jax.live_query_batch(
            [truths[1]], [int(0.5 * cfg2.sample_rate)], 6.0, 4.0, cfg2,
            stretch=1.03, noise_db=-25.0))[0],
        np.asarray(synth_jax.live_query_batch(
            [truths[2]], [int(0.8 * cfg2.sample_rate)], 6.0, 4.0, cfg2,
            stretch=1.0, noise_db=-25.0))[0]]
    with EscalatingMatchServer(ts, filters, n_samples, max_batch=4,
                               max_wait_ms=20.0, pool=16,
                               top_k=2) as srv:
        srv.warmup(pcms[0])
        futs = [srv.submit(p) for p in pcms]
        got = [f.result(timeout=600) for f in futs]
        stats = dict(srv.stats)
    for (ids, sc, off, esc), t in zip(got, truths):
        assert ids[0] == str(t)
        assert len(ids) == 2            # top_k honored
    assert got[1][3] is True            # the stretched one escalated
    assert stats["submitted"] == 3
    assert stats["escalated"] >= 1
    assert stats["confident"] + stats["escalated"] == 3
    # batch-API agreement on the stretched query
    res = api.match_scan_escalating(np.stack(pcms), filters, ts, cfg2,
                                    top_k=2, pool=16)
    assert got[1][0][0] == res[1][0][0]


def test_escalating_server_rejects_and_closes(cfg):
    import dataclasses

    from hpfw_jax.io import synth_jax
    from hpfw_jax.serve import EscalatingMatchServer

    cfg2 = dataclasses.replace(cfg, stretch_span=0.02)
    tracks = np.asarray(synth_jax.synth_batch(np.arange(6), 6.0, cfg2))
    filters = _filters(cfg2)
    db = api.build_db(list(tracks), filters, cfg2)
    ts = TwoStageDB(db, stride=4)
    n_samples = int(4.0 * cfg2.sample_rate)
    srv = EscalatingMatchServer(ts, filters, n_samples, max_batch=2,
                                max_wait_ms=1.0, pool=8)
    bad = srv.submit(np.zeros(100, np.float32))
    with pytest.raises(ValueError):
        bad.result(timeout=10)
    srv.close()
    late = srv.submit(np.zeros(n_samples, np.float32))
    with pytest.raises(RuntimeError):
        late.result(timeout=10)


def test_escalating_server_structure_gate(cfg):
    """The structural rung in serving: with the score gate pinned
    impossibly high, an in-tempo TRUE answer is kept WITHOUT scanning
    (collinear sub-window offsets, escalated=False), while a stretched
    rendition fails the slope gate, escalates, and recovers."""
    import dataclasses

    from hpfw_jax.io import synth_jax
    from hpfw_jax.serve import EscalatingMatchServer

    cfg2 = dataclasses.replace(cfg, stretch_span=0.03, pitch_span_bins=0)
    tracks = np.asarray(synth_jax.synth_batch(np.arange(12), 6.0, cfg2))
    filters = _filters(cfg2)
    db = api.build_db(list(tracks), filters, cfg2)
    ts = TwoStageDB(db, stride=4)
    n_samples = int(4.0 * cfg2.sample_rate)
    truths = [3, 9]
    pcms = [
        np.asarray(synth_jax.live_query_batch(
            [truths[0]], [int(0.5 * cfg2.sample_rate)], 6.0, 4.0, cfg2,
            stretch=1.0, noise_db=-25.0))[0],
        np.asarray(synth_jax.live_query_batch(
            [truths[1]], [int(0.5 * cfg2.sample_rate)], 6.0, 4.0, cfg2,
            stretch=1.03, noise_db=-25.0))[0]]
    # override=10.0 would block every rescue; override_unstructured=0.0
    # restores it for gate-failed rigid answers (the only kind that
    # reaches the scan queue) — same semantics as the api-level knob.
    with EscalatingMatchServer(ts, filters, n_samples, max_batch=2,
                               max_wait_ms=20.0, pool=16, top_k=1,
                               threshold=1.01, hi_sim=1.01,
                               structure_gate=0.75, override=10.0,
                               override_unstructured=0.0) as srv:
        srv.warmup(pcms[0])
        futs = [srv.submit(p) for p in pcms]
        got = [f.result(timeout=600) for f in futs]
        stats = dict(srv.stats)
    for (ids, sc, off, esc), t in zip(got, truths):
        assert ids[0] == str(t)
    assert got[0][3] is False           # kept by structure, never scanned
    assert got[1][3] is True            # stretched query escalated
    assert stats["structure_kept"] == 1
    assert stats["escalated"] == 1
    assert stats["confident"] == 0
