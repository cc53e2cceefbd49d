"""Query-side tempo scan (match/stretch.py + TwoStageDB stretch_span).

Live renditions differ from the catalog in tempo; rigid-alignment Hamming
scoring collapses past ~1% tempo error over a production-length query
(pre-GPU run, see git history, robustness at 250k). The scan re-times the query's print
sequence at a grid of hypothesized tempo factors (a pure time-axis gather
on the PACKED prints) and ranks every hypothesis's candidates together.

Tests simulate a rendition at tempo factor s at the PRINT level — query
frame k shows catalog frame round(k*s), the exact frame-grid geometry the
scan inverts — so they are deterministic and fast; the PCM-level behavior
(within-context distortion included) was measured by study scripts
before the GPU port (see git history).
"""

import numpy as np
import pytest

from hpfw_jax import api, oracle
from hpfw_jax.config import HpfwConfig
from hpfw_jax.io import synth
from hpfw_jax.match.scaled import TwoStageDB
from hpfw_jax.match.stretch import print_variants, stretch_grid
from hpfw_jax.parallel import mesh as meshlib


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) \
        / np.sqrt(cfg.context_dim)
    return oracle.fix_eigenvector_signs(f).astype(np.float32)


def test_stretch_grid_centered_identity():
    g = stretch_grid(0.03, 0.01)
    assert g == [0.97, 0.98, 0.99, 1.0, 1.01, 1.02, 1.03]
    assert g[len(g) // 2] == 1.0
    assert stretch_grid(0.02, 0.01) == [0.98, 0.99, 1.0, 1.01, 1.02]


def test_print_variants_identity_and_shape():
    rng = np.random.default_rng(3)
    q = rng.integers(0, 1 << 32, (40, 2), dtype=np.uint32)
    v = print_variants(q, [0.98, 1.0, 1.02])
    assert v.shape == (1, 3, 40, 2)
    np.testing.assert_array_equal(v[0, 1], q)          # 1.0 = as-is
    # batched form
    qb = rng.integers(0, 1 << 32, (5, 40, 2), dtype=np.uint32)
    vb = print_variants(qb, [1.0])
    assert vb.shape == (5, 1, 40, 2)
    np.testing.assert_array_equal(vb[:, 0], qb)


def test_print_variants_inverts_frame_grid():
    """Gathering at the true factor recovers the catalog frame sequence."""
    n = 200
    base = np.arange(n, dtype=np.uint32)[:, None] * np.ones(2, np.uint32)
    for s in (0.97, 1.01, 1.03):
        # rendition at tempo s: query frame k shows catalog frame round(k*s)
        rend = base[np.clip(np.round(np.arange(n) * s).astype(int), 0, n - 1)]
        rec = print_variants(rend, [s])[0, 0]
        # frame ids recovered within one frame (double rounding) wherever
        # the rendition actually contains them; for s < 1 the final
        # (1-s)*n frames don't exist in the rendition and clamp to its
        # tail — the few-percent neutral-bit cost the module doc states.
        valid = int(n * min(s, 1.0)) - 1
        err = np.abs(rec[:valid, 0].astype(int) - np.arange(valid))
        assert err.max() <= 1
        # ...and exactly for >=90% of frames
        assert (err == 0).mean() >= 0.90


@pytest.fixture(scope="module")
def small_db():
    cfg = HpfwConfig()
    tracks = synth.synth_catalog(24, 4.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    return cfg, tracks, filters, db


def _stretched_query(db, track, start, n, s):
    """Print-level rendition of `track` at tempo factor s (see module doc)."""
    prints = db.prints[track]
    idx = np.clip(np.round(np.arange(n) * s).astype(int) + start, 0,
                  prints.shape[0] - 1)
    return prints[idx]


def test_stretch_scan_recovers_tempo(small_db):
    cfg, tracks, filters, db = small_db
    ts = TwoStageDB(db, stride=4)
    n = 100
    q_plain = _stretched_query(db, 13, 4, n, 1.0)
    q_fast = _stretched_query(db, 13, 4, n, 1.03)
    ids0, s0, _ = ts.match(q_plain, top_k=1, pool=24)
    assert ids0[0] == "13"
    # rigid alignment degrades heavily at 3% tempo...
    _, s_rigid, _ = ts.match(q_fast, top_k=1, pool=24)
    assert s_rigid[0] < 0.82 * s0[0]
    # ...the scan recovers id and nearly all of the score
    ids2, s2, _ = ts.match(q_fast, top_k=1, pool=24,
                           stretch_span=0.03, stretch_step=0.01)
    assert ids2[0] == "13"
    assert s2[0] > 0.93 * s0[0]


def test_stretch_scan_identity_unchanged(small_db):
    """On an undistorted query the scan returns the plain top-1 (the 1.0
    hypothesis reproduces the scan-free dispatch; extra hypotheses can only
    add candidates that rank below an exact alignment)."""
    cfg, tracks, filters, db = small_db
    ts = TwoStageDB(db, stride=4)
    q = _stretched_query(db, 7, 2, 100, 1.0)
    ids_p, s_p, o_p = ts.match(q, top_k=1, pool=24)
    ids_s, s_s, o_s = ts.match(q, top_k=1, pool=24, stretch_span=0.03)
    assert ids_s[0] == ids_p[0]
    assert s_s[0] >= s_p[0]      # max over hypotheses includes 1.0
    assert o_s[0] == o_p[0]


def test_stretch_config_default_drives_match(small_db):
    """stretch_span serialized on the config is the match-time default."""
    cfg, tracks, filters, db = small_db
    cfg2 = HpfwConfig(stretch_span=0.03)
    cfg2.validate()
    db2 = api.FingerprintDB(cfg2, filters, db.track_ids, db.prints, db.lengths)
    ts = TwoStageDB(db2, stride=4)
    q = _stretched_query(db2, 5, 6, 100, 1.02)
    ids, _, _ = ts.match(q, top_k=1, pool=24)     # no per-call override
    assert ids[0] == "5"
    # explicit 0 turns the scan off for one call
    _, s_off, _ = ts.match(q, top_k=1, pool=24, stretch_span=0.0)
    _, s_on, _ = ts.match(q, top_k=1, pool=24)
    assert s_on[0] > s_off[0]


def test_stretch_match_batch_agrees_with_match(small_db):
    """Batched scan (B*V-row dispatch, Pallas interpret) == per-query scan."""
    cfg, tracks, filters, db = small_db
    ts = TwoStageDB(db, stride=4)
    qs = np.stack([_stretched_query(db, t, 3, 100, s)
                   for t, s in [(2, 1.02), (19, 0.98), (11, 1.0)]])
    batch = ts.match_batch(qs, top_k=2, pool=8, stretch_span=0.02)
    for (t, s), (ids, sc, off) in zip([(2, 1.02), (19, 0.98), (11, 1.0)],
                                      batch):
        one_ids, one_sc, one_off = ts.match(
            qs[list([(2, 1.02), (19, 0.98), (11, 1.0)]).index((t, s))],
            top_k=2, pool=8, stretch_span=0.02)
        assert ids[0] == one_ids[0] == str(t)
        np.testing.assert_array_equal(sc, one_sc)
        np.testing.assert_array_equal(off, one_off)


def test_stretch_sharded_mesh(small_db):
    """The scan composes with the 8-device sharded path (all-gather merge)."""
    cfg, tracks, filters, db = small_db
    mesh = meshlib.db_mesh(8)
    ts = TwoStageDB(db, stride=4, mesh=mesh)
    q = _stretched_query(db, 17, 5, 100, 1.03)
    ids, s, _ = ts.match(q, top_k=1, pool=3, stretch_span=0.03)
    assert ids[0] == "17"


def test_scan_batch_identity_row_is_plain_extraction(cfg):
    """The spec-level scan's center variant (hypothesis 1.0) is the exact
    plain extraction, bit for bit: at s=1 the frame gather is the identity
    (frac 0 on every frame), so fingerprint_scan_batch only ADDS
    hypotheses, it never perturbs the rigid path."""
    pcm = np.stack([synth.synth_track(31 + i, 4.0, cfg) for i in range(2)])
    filters = _filters(cfg)
    plain = api.fingerprint_batch(pcm, filters, cfg)
    for interp in ("linear", "nearest"):
        var = api.fingerprint_scan_batch(pcm, filters, cfg, span=0.02,
                                         interp=interp)
        assert var.shape == (2, 5, plain.shape[1], 2)
        np.testing.assert_array_equal(var[:, 2], plain, err_msg=interp)


def test_scan_batch_validation(cfg):
    pcm = np.zeros((1, cfg.sample_rate), np.float32)
    filters = _filters(cfg)
    with pytest.raises(ValueError):
        api.fingerprint_scan_batch(pcm[0], filters, cfg, span=0.02)  # 1-D
    with pytest.raises(ValueError):
        api.fingerprint_scan_batch(pcm, filters, cfg)  # span unset, cfg 0
    with pytest.raises(ValueError):
        api.fingerprint_scan_batch(pcm, filters, cfg, span=0.02,
                                   interp="cubic")
    cfg2 = HpfwConfig(frame_len=2048, fmin=380.0, n_bins=73, hop=256,
                      context_w=8, delta_lag=4, stretch_span=0.03)
    out = api.fingerprint_scan_batch(pcm, filters, cfg2)  # span from config
    assert out.shape[1] == 7


def test_match_accepts_prescanned_variant_stacks(small_db):
    """A (V, N, 2) stack into match() / a (B, V, N, 2) stack into
    match_batch() ranks each query's variant rows together — same contract
    as the print-level scan, but with caller-built variants (the spec-level
    scan's output)."""
    cfg, tracks, filters, db = small_db
    ts = TwoStageDB(db, stride=4)
    # a V=1 stack must be exactly the plain match
    q = _stretched_query(db, 9, 3, 100, 1.0)
    def same(a, b):
        assert list(a[0]) == list(b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])

    plain = ts.match(q, top_k=2, pool=8)
    one = ts.match(q[None], top_k=2, pool=8)
    same(one, plain)
    # a print-variant stack passed pre-made == the built-in scan
    q_fast = _stretched_query(db, 13, 4, 100, 1.03)
    stack = print_variants(q_fast, stretch_grid(0.03, 0.01))[0]
    pre = ts.match(stack, top_k=1, pool=24)
    builtin = ts.match(q_fast, top_k=1, pool=24, stretch_span=0.03)
    same(pre, builtin)
    # batched 4-D form agrees with per-query form
    qs = np.stack([print_variants(_stretched_query(db, t, 3, 100, s),
                                  stretch_grid(0.02, 0.01))[0]
                   for t, s in [(2, 1.02), (19, 0.98)]])
    batch = ts.match_batch(qs, top_k=2, pool=8)
    for i, (t, s) in enumerate([(2, 1.02), (19, 0.98)]):
        one_ids, one_sc, one_off = ts.match(qs[i], top_k=2, pool=8)
        assert batch[i][0][0] == one_ids[0] == str(t)
        np.testing.assert_array_equal(batch[i][1], one_sc)


def test_spec_scan_recovers_tempo_end_to_end(cfg):
    """PCM-level: a 3%-fast rendition (synth_jax.live_query_batch) is
    recovered by the spec-level scan where the rigid path mis-scores it.
    Small-scale twin of the 250k measurement (pre-GPU run, see git history)."""
    from hpfw_jax.io import synth_jax

    tracks = np.asarray(synth_jax.synth_batch(np.arange(16), 6.0, cfg))
    filters = _filters(cfg)
    db = api.build_db(list(tracks), filters, cfg)
    ts = TwoStageDB(db, stride=4)
    truths = [3, 11]
    pcm = np.asarray(synth_jax.live_query_batch(
        truths, [int(0.5 * cfg.sample_rate)] * 2, 6.0, 4.0, cfg,
        stretch=1.03, noise_db=-25.0))
    qvar = api.fingerprint_scan_batch(pcm, filters, cfg, span=0.03)
    res = ts.match_batch(qvar, top_k=1, pool=16)
    for (ids, sc, off), t in zip(res, truths):
        assert ids[0] == str(t)
    # the scan's best score clearly beats the rigid (identity-row) score
    rigid = ts.match_batch(qvar[:, 3], top_k=1, pool=16)
    for (ids, sc, _), (rids, rsc, _) in zip(res, rigid):
        assert sc[0] > 1.05 * rsc[0]


def test_match_scan_escalating(cfg):
    """Identity-first serving: in-tempo queries resolve on the rigid
    dispatch (no scan cost), sub-threshold (tempo-distorted) queries
    escalate to the spec-level stack and recover; return_variant exposes
    which hypothesis won."""
    import dataclasses

    from hpfw_jax.io import synth_jax

    cfg2 = dataclasses.replace(cfg, stretch_span=0.03)
    tracks = np.asarray(synth_jax.synth_batch(np.arange(12), 6.0, cfg2))
    filters = _filters(cfg2)
    db = api.build_db(list(tracks), filters, cfg2)
    ts = TwoStageDB(db, stride=4)
    truths = [3, 9]
    # one in-tempo, one 3%-fast
    pcm = np.stack([
        np.asarray(synth_jax.live_query_batch(
            [truths[0]], [int(0.5 * cfg2.sample_rate)], 6.0, 4.0, cfg2,
            stretch=1.0, noise_db=-25.0))[0],
        np.asarray(synth_jax.live_query_batch(
            [truths[1]], [int(0.5 * cfg2.sample_rate)], 6.0, 4.0, cfg2,
            stretch=1.03, noise_db=-25.0))[0]])
    res = api.match_scan_escalating(pcm, filters, ts, cfg2, top_k=1, pool=16)
    assert len(res) == 2
    for (ids, sc, off), t in zip(res, truths):
        assert ids[0] == str(t)
    # return_variant: the stretched query's winner is a non-identity row
    stack = api.fingerprint_scan_batch(pcm[1:2], filters, cfg2)[0]
    ids, sc, off, var = ts.match(stack, top_k=1, pool=16,
                                 return_variant=True)
    assert ids[0] == str(truths[1])
    from hpfw_jax.match.stretch import stretch_grid

    factors = stretch_grid(0.03, 0.01)
    assert abs(factors[int(var[0])] - 1.03) < 0.015
    # rigid match with return_variant reports variant 0
    q = api.fingerprint_batch(pcm[:1], filters, cfg2)[0]
    ids, sc, off, var = ts.match(q, top_k=2, pool=8, return_variant=True,
                                 stretch_span=0.0)
    assert (var == 0).all()


def test_escalation_structure_gate_and_retry(cfg):
    """The two cheap rungs below the rendition scan: an unconfident
    in-tempo TRUE answer is kept by the structure gate (collinear,
    ~zero slope — no scan dispatched), a tempo-distorted query fails the
    slope gate and still escalates + recovers; the retry rung re-matches
    unconfident queries with a deeper pool first and records itself."""
    import dataclasses

    from hpfw_jax.io import synth_jax

    cfg2 = dataclasses.replace(cfg, stretch_span=0.03)
    tracks = np.asarray(synth_jax.synth_batch(np.arange(12), 6.0, cfg2))
    filters = _filters(cfg2)
    db = api.build_db(list(tracks), filters, cfg2)
    ts = TwoStageDB(db, stride=4)
    truths = [3, 9]
    pcm = np.stack([
        np.asarray(synth_jax.live_query_batch(
            [truths[0]], [int(0.5 * cfg2.sample_rate)], 6.0, 4.0, cfg2,
            stretch=1.0, noise_db=-25.0))[0],
        np.asarray(synth_jax.live_query_batch(
            [truths[1]], [int(0.5 * cfg2.sample_rate)], 6.0, 4.0, cfg2,
            stretch=1.03, noise_db=-25.0))[0]])
    # threshold=1.01 of perfect: NOTHING is score-confident, so without
    # the structure gate both queries would escalate.
    st: dict = {}
    res = api.match_scan_escalating(
        pcm, filters, ts, cfg2, top_k=1, pool=16,
        threshold=1.01, hi_sim=1.01, structure_gate=0.75, stats=st)
    for (ids, sc, off), t in zip(res, truths):
        assert ids[0] == str(t)
    assert st["structure_kept"] == [0]      # in-tempo true answer kept
    assert st["escalated"] == [1]           # stretched query still scans
    # retry rung: unconfident queries re-match with a deeper pool once
    st2: dict = {}
    res2 = api.match_scan_escalating(
        pcm, filters, ts, cfg2, top_k=1, pool=8,
        threshold=1.01, hi_sim=1.01, retry_pool=32,
        structure_gate=0.75, stats=st2)
    assert st2["retried"] == [0, 1]
    for (ids, sc, off), t in zip(res2, truths):
        assert ids[0] == str(t)
    # hi_sim<=0 pins rigid-only: no rung runs at all
    st3: dict = {}
    api.match_scan_escalating(pcm, filters, ts, cfg2, top_k=1, pool=16,
                              hi_sim=0.0, retry_pool=32,
                              structure_gate=0.75, stats=st3)
    assert st3["retried"] == [] and st3["escalated"] == []
    # override_unstructured: once the gate has voted the rigid answer
    # scattered, the scan wins on ANY score improvement — even under an
    # absurd normal override bar that would block the rescue.
    st4: dict = {}
    res4 = api.match_scan_escalating(
        pcm, filters, ts, cfg2, top_k=1, pool=16,
        threshold=1.01, hi_sim=1.01, structure_gate=0.75,
        override=10.0, override_unstructured=0.0, stats=st4)
    assert st4["escalated"] == [1] and st4["overridden"] == [1]
    assert res4[1][0][0] == str(truths[1])
    # ...and without it the same bar blocks the override (the stretched
    # query keeps its wrong rigid answer).
    st5: dict = {}
    api.match_scan_escalating(
        pcm, filters, ts, cfg2, top_k=1, pool=16,
        threshold=1.01, hi_sim=1.01, structure_gate=0.75,
        override=10.0, stats=st5)
    assert st5["escalated"] == [1] and st5["overridden"] == []
    assert st3["structure_kept"] == []


def test_calibrated_variant_ranking(small_db):
    """calibrate=True ranks hypotheses by excess over each row's candidate
    background; with a single variant it cannot change the winner, and on
    a genuine stretched query the truth still wins (both paths exercise
    the float-score/int-index split)."""
    cfg, tracks, filters, db = small_db
    ts = TwoStageDB(db, stride=4)
    q = _stretched_query(db, 13, 4, 100, 1.03)
    plain = ts.match(q, top_k=1, pool=24, stretch_span=0.03)
    cal = ts.match(q, top_k=1, pool=24, stretch_span=0.03, calibrate=True)
    assert cal[0][0] == plain[0][0] == "13"
    stack = print_variants(q, stretch_grid(0.03, 0.01))[0]
    batch = ts.match_batch(stack[None], top_k=1, pool=24, calibrate=True)
    assert batch[0][0][0] == "13"
    # calibrated scores are floats (excess over background), idx/offs ints
    assert isinstance(batch[0][0][0], str)
    assert np.issubdtype(np.asarray(batch[0][2]).dtype, np.integer)


def test_stretch_config_validation():
    HpfwConfig(stretch_span=0.03).validate()
    with pytest.raises(AssertionError):
        HpfwConfig(stretch_span=0.5).validate()
    with pytest.raises(AssertionError):
        HpfwConfig(stretch_span=0.005, stretch_step=0.01).validate()
    with pytest.raises(AssertionError):
        HpfwConfig(stretch_step=0.0).validate()
    HpfwConfig(pitch_span_bins=2).validate()
    with pytest.raises(AssertionError):
        HpfwConfig(pitch_span_bins=-1).validate()
    with pytest.raises(AssertionError):
        HpfwConfig(pitch_span_bins=7).validate()     # > 1.5 st at 24 b/o


def test_pitch_and_hypothesis_grids():
    from hpfw_jax.match.stretch import hypothesis_grid, pitch_grid

    assert pitch_grid(0) == [0]
    assert pitch_grid(2) == [-2, -1, 0, 1, 2]
    g = hypothesis_grid(stretch_grid(0.01, 0.01), pitch_grid(1))
    assert len(g) == 9
    assert g[len(g) // 2] == (1.0, 0)        # combined identity at V//2
    assert g[0] == (0.99, -1) and g[-1] == (1.01, 1)


def test_scan_from_spec_pitch_roll_rekeys_bins(cfg):
    """A (1.0, roll) hypothesis is exactly fingerprinting the bin-rolled
    (edge-clamped) spectrogram: catalog bin k <- query bin k+roll."""
    import jax.numpy as jnp

    from hpfw_jax.ops import fingerprint as fp_ops

    rng = np.random.default_rng(5)
    spec = rng.standard_normal((60, cfg.n_bins)).astype(np.float32)
    filters = _filters(cfg)
    out = np.asarray(api.scan_from_spec(
        jnp.asarray(spec), jnp.asarray(filters), cfg,
        ((1.0, -2), (1.0, 0), (1.0, 1))))
    for v, roll in [(0, -2), (1, 0), (2, 1)]:
        idx = np.clip(np.arange(cfg.n_bins) + roll, 0, cfg.n_bins - 1)
        want = np.asarray(fp_ops.fingerprint_from_spec(
            jnp.asarray(spec[:, idx]), jnp.asarray(filters), cfg))
        np.testing.assert_array_equal(out[v], want, err_msg=f"roll {roll}")


def test_scan_batch_product_grid_identity_row(cfg):
    """The combined pitch x tempo grid's center variant (V//2) is still
    bit-exact plain extraction, and the stack has V = tempo * pitch rows."""
    pcm = np.stack([synth.synth_track(51 + i, 4.0, cfg) for i in range(2)])
    filters = _filters(cfg)
    plain = api.fingerprint_batch(pcm, filters, cfg)
    var = api.fingerprint_scan_batch(pcm, filters, cfg, span=0.02,
                                     pitch_span_bins=1)
    assert var.shape == (2, 15, plain.shape[1], 2)
    np.testing.assert_array_equal(var[:, 7], plain)
    # pitch-only scan (span 0): V = 2p+1, identity still centered
    var_p = api.fingerprint_scan_batch(pcm, filters, cfg, span=0.0,
                                       pitch_span_bins=2)
    assert var_p.shape == (2, 5, plain.shape[1], 2)
    np.testing.assert_array_equal(var_p[:, 2], plain)


def test_pitch_scan_recovers_key_end_to_end(cfg):
    """PCM-level: a +0.5 st rendition (one CQT bin at 24 bins/octave) is
    re-keyed by the +1-bin-roll hypothesis — the scan's best score beats
    the rigid score and the winning variant is the true roll. Small-scale
    twin of the 250k pitch measurement."""
    from hpfw_jax.io import synth_jax

    tracks = np.asarray(synth_jax.synth_batch(np.arange(16), 6.0, cfg))
    filters = _filters(cfg)
    db = api.build_db(list(tracks), filters, cfg)
    ts = TwoStageDB(db, stride=4)
    truths = [3, 11]
    pcm = np.asarray(synth_jax.live_query_batch(
        truths, [int(0.5 * cfg.sample_rate)] * 2, 6.0, 4.0, cfg,
        pitch_st=0.5, noise_db=-25.0))
    qvar = api.fingerprint_scan_batch(pcm, filters, cfg, span=0.0,
                                      pitch_span_bins=1)   # V=3: rolls -1,0,1
    res = ts.match_batch(qvar, top_k=1, pool=16)
    for (ids, sc, off), t in zip(res, truths):
        assert ids[0] == str(t)
    # the re-keyed score clearly beats the rigid (identity-row) score
    rigid = ts.match_batch(qvar[:, 1], top_k=1, pool=16)
    for (ids, sc, _), (rids, rsc, _) in zip(res, rigid):
        assert sc[0] > 1.03 * rsc[0]
    # the winning hypothesis is the true roll (+1 = index 2)
    ids, sc, off, var = ts.match(qvar[0], top_k=1, pool=16,
                                 return_variant=True)
    assert int(var[0]) == 2


def test_combined_pitch_tempo_scan_end_to_end(cfg):
    """The realistic live case: pitched +0.5 st AND 3% fast. The product
    grid contains the true (tempo, roll) combo and recovers the track
    where both single-axis scans mis-score."""
    from hpfw_jax.io import synth_jax

    tracks = np.asarray(synth_jax.synth_batch(np.arange(16), 6.0, cfg))
    filters = _filters(cfg)
    db = api.build_db(list(tracks), filters, cfg)
    ts = TwoStageDB(db, stride=4)
    truths = [5, 13]
    pcm = np.asarray(synth_jax.live_query_batch(
        truths, [int(0.5 * cfg.sample_rate)] * 2, 6.0, 4.0, cfg,
        pitch_st=0.5, stretch=1.03, noise_db=-25.0))
    qvar = api.fingerprint_scan_batch(pcm, filters, cfg, span=0.03,
                                      pitch_span_bins=1)   # V = 7*3 = 21
    assert qvar.shape[1] == 21
    res = ts.match_batch(qvar, top_k=1, pool=16)
    for (ids, sc, off), t in zip(res, truths):
        assert ids[0] == str(t)
    # ...and the product-grid best clearly beats the rigid identity row
    rigid = ts.match_batch(qvar[:, 10], top_k=1, pool=16)
    for (ids, sc, _), (rids, rsc, _) in zip(res, rigid):
        assert sc[0] > 1.03 * rsc[0]
