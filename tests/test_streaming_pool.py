"""StreamingPool: batched concurrent live-ID streams.

Equivalence anchor: a pool stream fed the same chunk schedule as a lone
StreamingSession must reach the same hypothesis (the batched extraction
is the same jitted step vmapped, and match_batch returns per-query
results equal to match()).
"""

import numpy as np
import pytest

from hpfw_jax import api
from hpfw_jax.io import synth
from hpfw_jax.match.scaled import TwoStageDB
from hpfw_jax.streaming.pool import StreamingPool
from hpfw_jax.streaming.session import StreamingSession
from tests.test_persist import _filters


@pytest.fixture(scope="module")
def setup(cfg):
    tracks = synth.synth_catalog(6, 6.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    return tracks, filters, db


def _chunks(pcm, size):
    return [pcm[i:i + size] for i in range(0, len(pcm), size)]


def test_pool_identifies_concurrent_streams(cfg, setup):
    tracks, filters, db = setup
    pool = StreamingPool(db, filters, cfg, capacity=4, query_prints=64,
                         chunk_prints=16)
    plan = {"a": 1, "b": 3, "c": 5}
    for sid in plan:
        pool.add_stream(sid)
    rng = np.random.default_rng(0)
    feeds = {}
    for sid, t in plan.items():
        audio = tracks[t][int(0.5 * cfg.sample_rate):]
        audio = audio + 0.02 * rng.standard_normal(audio.shape[0]).astype(
            np.float32)
        feeds[sid] = _chunks(audio, 4096)
    n = min(len(f) for f in feeds.values())
    out = {}
    for i in range(n):
        out = pool.feed({sid: feeds[sid][i] for sid in plan})
    for sid, t in plan.items():
        assert out[sid] is not None, sid
        assert out[sid].track_id == str(t), (sid, out[sid])
        assert out[sid].confidence > 0.5
    stats = pool.latency_stats()
    assert stats["n_matches"] > 0


def test_pool_stream_equals_session(cfg, setup):
    """One pool stream == a lone StreamingSession on the same schedule."""
    tracks, filters, db = setup
    audio = tracks[2][int(0.3 * cfg.sample_rate):int(4.0 * cfg.sample_rate)]
    chunks = _chunks(audio, 4096)

    sess = StreamingSession(db, filters, cfg, query_prints=64,
                            chunk_prints=16)
    for c in chunks:
        h_sess = sess.feed(c)

    pool = StreamingPool(db, filters, cfg, capacity=2, query_prints=64,
                         chunk_prints=16)
    pool.add_stream("x")
    for c in chunks:
        h_pool = pool.feed({"x": c})["x"]

    assert h_pool is not None and h_sess is not None
    assert h_pool.track_id == h_sess.track_id == "2"
    assert h_pool.score == h_sess.score
    assert h_pool.offset == h_sess.offset

    # Big chunks spanning several windows: both match once per feed, so
    # the vote tallies (hence confidence) still agree.
    big = _chunks(audio, 5 * 4096)
    sess2 = StreamingSession(db, filters, cfg, query_prints=64,
                             chunk_prints=16)
    pool2 = StreamingPool(db, filters, cfg, capacity=2, query_prints=64,
                          chunk_prints=16)
    pool2.add_stream("y")
    for c in big:
        h_s2 = sess2.feed(c)
        h_p2 = pool2.feed({"y": c})["y"]
    assert h_p2.track_id == h_s2.track_id == "2"
    assert h_p2.score == h_s2.score
    assert abs(h_p2.confidence - h_s2.confidence) < 1e-9


def test_pool_capacity_and_lifecycle(cfg, setup):
    tracks, filters, db = setup
    pool = StreamingPool(db, filters, cfg, capacity=2, query_prints=64,
                         chunk_prints=16)
    pool.add_stream("a")
    pool.add_stream("b")
    with pytest.raises(ValueError):
        pool.add_stream("c")
    with pytest.raises(ValueError):
        pool.add_stream("a")
    pool.remove_stream("a")
    pool.add_stream("c")
    assert sorted(pool.stream_ids) == ["b", "c"]


def test_pool_sharded_mesh(cfg, setup):
    """The pool against a mesh-sharded TwoStageDB (the v4-8 production
    shape): two concurrent streams over the 8-device CPU-sim mesh both
    identify correctly through the sharded match_batch dispatch."""
    import jax

    from hpfw_jax.parallel import mesh as meshlib

    assert len(jax.devices()) == 8
    tracks, filters, db = setup
    ts = TwoStageDB(db, stride=4, mesh=meshlib.db_mesh(8))
    pool = StreamingPool(ts, filters, cfg, capacity=2, query_prints=64,
                         chunk_prints=16, query_buckets=(64,))
    pool.add_stream("a")
    pool.add_stream("b")
    fa = _chunks(tracks[1][: int(4.0 * cfg.sample_rate)], 8192)
    fb = _chunks(tracks[5][: int(4.0 * cfg.sample_rate)], 8192)
    out = {}
    for ca, cb in zip(fa, fb):
        out = pool.feed({"a": ca, "b": cb})
    assert out["a"].track_id == "1"
    assert out["b"].track_id == "5"


def test_pool_two_stage_buckets(cfg, setup):
    """The grouped-bucket path against a TwoStageDB (match_batch): two
    streams started at different times occupy different buckets in the
    same tick and both identify correctly."""
    tracks, filters, db = setup
    ts = TwoStageDB(db, keep_host=True)
    pool = StreamingPool(ts, filters, cfg, capacity=2, query_prints=64,
                         chunk_prints=16)
    pool.add_stream("early")
    feeds_e = _chunks(tracks[0][: int(5.0 * cfg.sample_rate)], 8192)
    feeds_l = _chunks(tracks[4][: int(5.0 * cfg.sample_rate)], 8192)
    out = {}
    for i, c in enumerate(feeds_e):
        chunk = {"early": c}
        if i == 3:
            pool.add_stream("late")
        if i >= 3 and i - 3 < len(feeds_l):
            chunk["late"] = feeds_l[i - 3]
        out = pool.feed(chunk)
    assert out["early"].track_id == "0"
    assert out["late"].track_id == "4"


def test_pool_feed_rejects_unknown_stream_ids(cfg, setup):
    """ADVICE r3: a bad caller key must raise a descriptive ValueError
    before any buffering, not abort the shared tick with a KeyError."""
    tracks, filters, db = setup
    pool = StreamingPool(db, filters, cfg, capacity=2, query_prints=64,
                         chunk_prints=16)
    pool.add_stream("a")
    chunk = np.zeros(pool.step_samples, dtype=np.float32)
    with pytest.raises(ValueError, match="unknown stream ids"):
        pool.feed({"a": chunk, "ghost": chunk})
    # the known stream's buffer must be untouched by the failed call
    assert pool._streams["a"].buf.shape[0] == 0


def test_pool_ragged_cadences_join_and_leave(cfg, setup):
    """VERDICT r3 weak #7: streams at DIFFERENT chunk cadences, joining and
    leaving mid-run, must all identify correctly — the pool's batched tick
    may extract several windows for a fast feeder while a slow one waits."""
    tracks, filters, db = setup
    pool = StreamingPool(db, filters, cfg, capacity=3, query_prints=64,
                         chunk_prints=16)
    rng = np.random.default_rng(1)

    def noisy(t):
        a = tracks[t][int(0.3 * cfg.sample_rate):]
        return a + 0.02 * rng.standard_normal(a.shape[0]).astype(np.float32)

    # cadences: "a" feeds 2x the pool step per call, "b" 0.5x, "c" joins
    # late at ~1.7x and "a" leaves mid-run.
    sizes = {"a": 2 * pool.step_samples, "b": pool.step_samples // 2,
             "c": int(1.7 * pool.step_samples)}
    feeds = {"a": _chunks(noisy(1), sizes["a"]),
             "b": _chunks(noisy(3), sizes["b"]),
             "c": _chunks(noisy(5), sizes["c"])}
    pool.add_stream("a")
    pool.add_stream("b")
    pos = {"a": 0, "b": 0, "c": 0}
    results = {}
    a_result = None
    for tick in range(60):
        if tick == 8:
            pool.add_stream("c")
        if tick == 30:
            a_result = results.get("a")
            pool.remove_stream("a")
        chunks = {}
        for sid in pool.stream_ids:
            f = feeds[sid]
            if pos[sid] < len(f):
                chunks[sid] = f[pos[sid]]
                pos[sid] += 1
        if not chunks:
            break
        results = pool.feed(chunks)
    assert a_result is not None and a_result.track_id == "1"
    assert results["b"] is not None and results["b"].track_id == "3"
    assert results["c"] is not None and results["c"].track_id == "5"
    assert "a" not in results
    assert results["b"].confidence > 0.5 and results["c"].confidence > 0.5
