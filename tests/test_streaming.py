"""Streaming / chunked-extraction tests (SURVEY.md §4.3 halo property)."""

import numpy as np

from hpfw_jax import api, oracle
from hpfw_jax.io import synth
from hpfw_jax.streaming.session import ChunkedExtractor, StreamingSession, extract_chunked


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return oracle.fix_eigenvector_signs(f).astype(np.float32)


def test_chunked_extraction_bit_identical(cfg):
    """Chunked (halo) extraction == whole-track extraction, bit for bit."""
    pcm = synth.synth_track(21, 4.0, cfg)
    filters = _filters(cfg)
    whole = api.fingerprint(pcm, filters, cfg)
    for chunk in [8, 32, 57]:
        chunked = extract_chunked(pcm, filters, cfg, chunk_prints=chunk)
        np.testing.assert_array_equal(chunked, whole, err_msg=f"chunk={chunk}")


def test_chunked_extractor_incremental_feed(cfg):
    """Feeding the stream in odd-sized pieces yields the same prints."""
    pcm = synth.synth_track(22, 3.0, cfg)
    filters = _filters(cfg)
    whole = api.fingerprint(pcm, filters, cfg)
    ex = ChunkedExtractor(filters, cfg, chunk_prints=16)
    got = []
    rng = np.random.default_rng(0)
    pos = 0
    while pos < len(pcm):
        n = int(rng.integers(100, 5000))
        got.append(ex.feed(pcm[pos:pos + n]))
        pos += n
    got = np.concatenate(got, axis=0)
    n = min(got.shape[0], whole.shape[0])
    assert n > 0
    np.testing.assert_array_equal(got[:n], whole[:n])


def test_streaming_session_identifies_track(cfg):
    tracks = synth.synth_catalog(6, 5.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    sess = StreamingSession(db, filters, cfg, query_prints=64, chunk_prints=16)
    # stream a noisy performance of track 4, in ~0.25 s chunks
    live = synth.make_query(tracks[4], 0.5, 4.0, cfg, noise_db=-15.0, seed=7)
    best = None
    step = cfg.sample_rate // 4
    for pos in range(0, len(live), step):
        best = sess.feed(live[pos:pos + step])
    assert best is not None
    assert best[0] == "4"
    assert 0.0 <= best.confidence <= 1.0
    stats = sess.latency_stats()
    assert stats["n_matches"] > 0
    assert np.isfinite(stats["match_p50_ms"])


def test_streaming_progressive_buckets_lock_early(cfg):
    """With progressive query buckets the session must produce a (correct)
    hypothesis before the full ring could possibly have filled."""
    tracks = synth.synth_catalog(6, 5.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    sess = StreamingSession(db, filters, cfg, query_prints=64,
                            chunk_prints=16)
    assert sess.query_buckets == (16, 32, 64)
    live = synth.make_query(tracks[2], 0.5, 4.0, cfg, noise_db=-20.0, seed=3)
    full_ring_samples = (64 * cfg.hop + sess.extractor.window_samples)
    step = cfg.sample_rate // 4
    first_lock = None
    fed = 0
    for pos in range(0, len(live), step):
        best = sess.feed(live[pos:pos + step])
        fed += step
        if best is not None and first_lock is None:
            first_lock = fed
    assert first_lock is not None and first_lock < full_ring_samples
    assert sess.current_best.track_id == "2"
    assert sess.current_best.confidence > 0.5


def test_streaming_session_with_two_stage_db(cfg):
    """Catalog-scale pairing: live stream matched against a TwoStageDB
    (the production live-song-ID path) converges to the truth and agrees
    with the dense-DB session."""
    from hpfw_jax.match.scaled import TwoStageDB

    tracks = synth.synth_catalog(12, 5.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    ts = TwoStageDB(db, stride=4)
    live = synth.make_query(tracks[9], 0.5, 4.0, cfg, noise_db=-15.0, seed=2)
    sess_ts = StreamingSession(ts, filters, cfg, query_prints=64, chunk_prints=16)
    sess_dense = StreamingSession(db, filters, cfg, query_prints=64, chunk_prints=16)
    step = cfg.sample_rate // 4
    best_ts = best_dense = None
    for pos in range(0, len(live), step):
        chunk = live[pos:pos + step]
        best_ts = sess_ts.feed(chunk)
        best_dense = sess_dense.feed(chunk)
    assert best_ts is not None and best_ts[0] == "9"
    # Same final hypothesis as the dense session (two-stage is exact-on-pool).
    assert best_ts == best_dense
    assert sess_ts.latency_stats()["n_matches"] > 0


def test_streaming_session_stretch_scan(cfg):
    """Live tempo drift through the STREAMING surface: a rendition 3%
    faster than the catalog (synth_jax.live_query_batch — same score,
    different tempo, PCM level) is streamed into sessions backed by
    TwoStageDBs with and without the config-driven tempo scan
    (HpfwConfig.stretch_span -> TwoStageDB.match, match/stretch.py). The
    scan needs no session API: the knob serializes on the DB config. At
    this scale both sessions lock the right track (the 250k-scale recall
    table is a pre-GPU run, see git history); the scan must recover a clearly better
    alignment score on the same stream, and an undistorted control must
    be unaffected by scanning."""
    import dataclasses

    from hpfw_jax.io import synth_jax
    from hpfw_jax.match.scaled import TwoStageDB

    tracks = [np.asarray(t) for t in synth_jax.synth_batch(
        np.arange(12), 6.0, cfg)]
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    live = np.asarray(synth_jax.live_query_batch(
        [5], [int(0.3 * cfg.sample_rate)], 6.0, 5.0, cfg,
        stretch=1.03, noise_db=-12.0))[0]
    step = cfg.sample_rate // 4

    def run_session(span, stream, **kw):
        cfg2 = dataclasses.replace(cfg, stretch_span=span)
        db2 = api.FingerprintDB(cfg2, filters, db.track_ids, db.prints,
                                db.lengths)
        sess = StreamingSession(TwoStageDB(db2, stride=4), filters, cfg2,
                                query_prints=128, chunk_prints=16, **kw)
        best = None
        for pos in range(0, len(stream), step):
            best = sess.feed(stream[pos:pos + step])
        return best

    rigid = run_session(0.0, live)
    print_scan = run_session(0.03, live, spec_scan=False)
    spec_scan = run_session(0.03, live)     # spec is the span>0 default
    assert rigid is not None and print_scan is not None
    assert spec_scan.track_id == print_scan.track_id \
        == rigid.track_id == "5"
    # Re-timing recovers most of the drift the rigid alignment loses
    # (calibrated: ~14% score gap at 3% tempo over 128-print windows);
    # the spec-level scan must do at least as well as the print gather
    # (it removes the gather's within-context distortion).
    assert print_scan.score > 1.08 * rigid.score
    assert spec_scan.score >= print_scan.score
    # Undistorted control: the 1.0 hypothesis is always in the grid, so
    # scanning an in-tempo stream must not change the lock (either level).
    clean = np.asarray(synth_jax.live_query_batch(
        [5], [int(0.3 * cfg.sample_rate)], 6.0, 5.0, cfg,
        stretch=1.0, noise_db=-12.0))[0]
    for kw in ({}, {"spec_scan": False}):
        ctrl = run_session(0.03, clean, **kw)
        assert ctrl is not None and ctrl.track_id == "5"


def test_streaming_tempo_acquire_track(cfg):
    """The spec-scan session ACQUIRES with the full grid, LOCKS the true
    tempo factor, then TRACKS with a 3-point mini-grid (rigid-only for an
    in-tempo lock); variant provenance comes back through
    TwoStageDB.match(return_variant=True)."""
    import dataclasses

    from hpfw_jax.io import synth_jax
    from hpfw_jax.match.scaled import TwoStageDB

    cfg2 = dataclasses.replace(cfg, stretch_span=0.03)
    tracks = [np.asarray(t) for t in synth_jax.synth_batch(
        np.arange(10), 6.0, cfg2)]
    filters = _filters(cfg2)
    db = api.build_db(tracks, filters, cfg2)
    ts = TwoStageDB(db, stride=4)

    def stream(stretch):
        return np.asarray(synth_jax.live_query_batch(
            [4], [int(0.3 * cfg2.sample_rate)], 6.0, 5.0, cfg2,
            stretch=stretch, noise_db=-20.0))[0]

    step = cfg2.sample_rate // 4
    # 3%-fast rendition: session must lock tempo ~1.03 and be tracking.
    sess = StreamingSession(ts, filters, cfg2, query_prints=128,
                            chunk_prints=16)
    assert sess._scan_state == "acquire"
    best = None
    for pos in range(0, len(stream(1.03)), step):
        best = sess.feed(stream(1.03)[pos:pos + step])
    assert best is not None and best.track_id == "4"
    assert sess._scan_state == "track"
    assert abs(sess.tempo - 1.03) < 0.015   # within one grid step
    # In-tempo stream: locks at 1.0 and tracking degenerates to rigid.
    sess2 = StreamingSession(ts, filters, cfg2, query_prints=128,
                             chunk_prints=16)
    for pos in range(0, len(stream(1.0)), step):
        best2 = sess2.feed(stream(1.0)[pos:pos + step])
    assert best2 is not None and best2.track_id == "4"
    assert sess2._scan_state == "track" and sess2.tempo == 1.0
    assert sess2._scan_factors() == ()      # rigid-only while locked


def test_streaming_pitch_acquire_track(cfg):
    """Round-5 pitch axis in sessions: a +0.5 st (= +1 CQT bin at 24
    bins/octave) live rendition ACQUIRES over the pitch x tempo grid,
    locks the right pitch roll, and TRACKS with the tempo mini-grid
    pinned at that roll (a performed key holds; re-acquisition handles
    key changes)."""
    import dataclasses

    from hpfw_jax.io import synth_jax
    from hpfw_jax.match.scaled import TwoStageDB

    cfg2 = dataclasses.replace(cfg, stretch_span=0.03, pitch_span_bins=1)
    tracks = [np.asarray(t) for t in synth_jax.synth_batch(
        np.arange(10), 6.0, cfg2)]
    filters = _filters(cfg2)
    db = api.build_db(tracks, filters, cfg2)
    ts = TwoStageDB(db, stride=4)
    live = np.asarray(synth_jax.live_query_batch(
        [4], [int(0.3 * cfg2.sample_rate)], 6.0, 5.0, cfg2,
        pitch_st=0.5, noise_db=-20.0))[0]
    sess = StreamingSession(ts, filters, cfg2, query_prints=128,
                            chunk_prints=16)
    # Acquisition grid is the full pitch x tempo product.
    assert len(sess._scan_factors()) == 7 * 3
    step = cfg2.sample_rate // 4
    best = None
    for pos in range(0, len(live), step):
        best = sess.feed(live[pos:pos + step])
    assert best is not None and best.track_id == "4"
    assert sess._scan_state == "track"
    assert sess.pitch == 1
    # Tracking: 3-point tempo neighborhood, every hypothesis at roll 1.
    fs = sess._scan_factors()
    assert fs and all(r == 1 for _, r in fs) and len(fs) <= 3
    # Pitch-only config (no tempo axis): spec scan still enabled, and a
    # non-zero pitch lock keeps exactly one scan hypothesis.
    cfg3 = dataclasses.replace(cfg, stretch_span=0.0, pitch_span_bins=1)
    sess3 = StreamingSession(ts, filters, cfg3, query_prints=128,
                             chunk_prints=16)
    assert sess3._spec_scan and len(sess3._scan_factors()) == 3
    sess3._scan_state, sess3.pitch = "track", 1
    assert sess3._scan_factors() == ((1.0, 1),)


def test_streaming_spec_scan_sharded_db(cfg):
    """The spec-scan session also works against a mesh-sharded dense DB
    (per-variant fallback path): a 3%-fast stream locks the right track."""
    import dataclasses

    import jax

    from hpfw_jax.io import synth_jax
    from hpfw_jax.match.sharded import ShardedDB

    cfg2 = dataclasses.replace(cfg, stretch_span=0.03)
    tracks = [np.asarray(t) for t in synth_jax.synth_batch(
        np.arange(8), 6.0, cfg2)]
    filters = _filters(cfg2)
    db = api.build_db(tracks, filters, cfg2)
    sdb = ShardedDB(db, jax.make_mesh((8,), ("db",)))
    live = np.asarray(synth_jax.live_query_batch(
        [5], [int(0.3 * cfg2.sample_rate)], 6.0, 4.0, cfg2,
        stretch=1.03, noise_db=-20.0))[0]
    sess = StreamingSession(sdb, filters, cfg2, query_prints=64,
                            chunk_prints=16)
    step = cfg2.sample_rate // 4
    best = None
    for pos in range(0, len(live), step):
        best = sess.feed(live[pos:pos + step])
    assert best is not None and best.track_id == "5"
    assert sess._scan_state == "track" and abs(sess.tempo - 1.03) < 0.015


def test_streaming_frame_ring_matches_whole_track(cfg):
    """The extractor's frame ring matches the whole-track CQT frames to
    float32 accumulation noise (the NDFT GEMM over different window
    lengths reassociates — the PRINT-level chunking invariant is exact
    because sign margins dwarf that ~1e-5 noise), and the spec-scan
    identity row from the ring reproduces the print ring bit for bit —
    so the streaming scan only ADDS hypotheses."""
    import jax.numpy as jnp

    from hpfw_jax.ops import frontend
    from hpfw_jax.streaming.session import ChunkedExtractor

    pcm = synth.synth_track(3, 5.0, cfg)
    halo = cfg.context_w + cfg.delta_lag - 1
    ex = ChunkedExtractor(_filters(cfg), cfg, chunk_prints=16,
                          frame_ring=64 + halo)
    step = cfg.sample_rate // 3
    prints = []
    for pos in range(0, len(pcm), step):
        prints.append(ex.feed(pcm[pos:pos + step]))
    prints = np.concatenate(prints, axis=0)
    whole = np.asarray(frontend.cqt(jnp.asarray(pcm), cfg))
    ring = np.asarray(ex.frame_ring)
    n_emitted = prints.shape[0]
    # ring covers frames [n_emitted + halo - len(ring), n_emitted + halo)
    lo = n_emitted + halo - ring.shape[0]
    np.testing.assert_allclose(ring, whole[lo:n_emitted + halo],
                               rtol=1e-5, atol=1e-4)
    # spec-scan identity row == the print ring, bit for bit (margins are
    # audited orders of magnitude above the frame noise)
    from hpfw_jax import api as api_mod

    frames = ring[-(64 + halo):]
    stack = np.asarray(api_mod.scan_from_spec(
        jnp.asarray(frames), jnp.asarray(_filters(cfg)), cfg,
        (0.97, 1.0, 1.03)))
    np.testing.assert_array_equal(stack[1], prints[-64:])


def test_streaming_track_change_relocks(cfg):
    """VERDICT r3 weak #7: when the fed audio switches songs mid-stream the
    session must re-lock onto the new track within a bounded number of
    match windows (the ring flush + a few tally-crossover windows)."""
    tracks = synth.synth_catalog(8, 6.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    sess = StreamingSession(db, filters, cfg, query_prints=64,
                            chunk_prints=16)
    a = synth.make_query(tracks[3], 0.5, 4.0, cfg, noise_db=-18.0, seed=5)
    b = synth.make_query(tracks[6], 1.0, 5.0, cfg, noise_db=-18.0, seed=6)
    live = np.concatenate([a, b])
    step = cfg.sample_rate // 4
    switch_pos = len(a)
    locked_a = False
    windows_after_switch = None
    relock_window = None
    for pos in range(0, len(live), step):
        n_before = len(sess.match_latencies_ms)
        best = sess.feed(live[pos:pos + step])
        matched = len(sess.match_latencies_ms) > n_before
        if pos + step <= switch_pos:
            if best is not None and best.track_id == "3":
                locked_a = True
        else:
            if windows_after_switch is None:
                windows_after_switch = 0
            if matched:
                windows_after_switch += 1
                if best.track_id == "6" and relock_window is None:
                    relock_window = windows_after_switch
    assert locked_a, "never locked the first track"
    assert relock_window is not None, "never re-locked after the switch"
    # Bound: ring flush is query_prints/chunk_prints = 4 windows of mixed
    # audio; allow a few more for the decayed tally to cross over.
    assert relock_window <= 10, f"re-lock took {relock_window} windows"
    assert sess.current_best.track_id == "6"
