"""Alignment-structure evidence (match/align.py).

Print-level frame-grid simulation (same geometry as test_stretch.py): a
rendition at tempo factor s shows catalog frame round(n*s) at query frame
n, so a true match's sub-window shifts lie on the line d(p) = p*(s-1)
while an imposter's per-window argmaxes scatter across the band.
"""

import numpy as np
import pytest

from hpfw_jax.match.align import (offset_line_fit, structure_evidence,
                                  subwindow_offsets)


def _prints(seed, l=600):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (l, 2), dtype=np.uint32)


def _rendition(track, start, n, s, flip_bits=0, seed=0):
    """Query prints excerpted at tempo factor s + optional bit noise."""
    idx = np.clip(np.round(np.arange(n) * s).astype(int) + start, 0,
                  track.shape[0] - 1)
    q = track[idx].copy()
    if flip_bits:
        rng = np.random.default_rng(seed)
        mask = (rng.random((n, 64)) < flip_bits / 64.0)
        packed = np.zeros((n, 2), dtype=np.uint32)
        for wd in range(2):
            packed[:, wd] = np.packbits(
                mask[:, wd * 32:(wd + 1) * 32][:, ::-1],
                axis=1, bitorder="little").view(np.uint32)[:, 0]
        q ^= packed
    return q


def test_true_match_rigid_slope_zero():
    track = _prints(1)
    q = _rendition(track, 50, 320, 1.0, flip_bits=6, seed=2)
    ev = structure_evidence(q, track, 50, k=8, band=24)
    assert abs(ev["slope"]) < 0.005
    assert ev["inlier_frac"] == 1.0
    assert ev["mean_sim"] > 0.85
    assert abs(ev["intercept"]) <= 1.0


def test_true_match_stretched_slope_is_tempo_error():
    track = _prints(3)
    for s in (0.97, 1.03):
        q = _rendition(track, 40, 400, s, flip_bits=6, seed=4)
        ev = structure_evidence(q, track, 40, k=8, band=24)
        # slope estimates s-1 (the drift per query print)
        assert abs(ev["slope"] - (s - 1.0)) < 0.01, s
        assert ev["inlier_frac"] >= 0.75, s


def test_imposter_scatters():
    track = _prints(5)
    other = _prints(6)
    q = _rendition(other, 80, 320, 1.0, flip_bits=6, seed=7)
    ev = structure_evidence(q, track, 80, k=8, band=24)
    # unrelated content: sub-window argmaxes scatter, similarity ~0.5
    assert ev["inlier_frac"] <= 0.625
    assert ev["mean_sim"] < 0.62
    assert ev["rms"] > 2.0


def test_rigid_structured_separates_true_from_imposter():
    from hpfw_jax.api import rigid_structured

    track = _prints(11)
    q = _rendition(track, 60, 320, 1.0, flip_bits=6, seed=12)
    assert rigid_structured(q, track, 60, inlier=0.75, slope_tol=0.005)
    # a 3%-stretched rendition is collinear but NOT rigid — slope gate
    qs = _rendition(track, 60, 320, 1.03, flip_bits=6, seed=13)
    assert not rigid_structured(qs, track, 60, inlier=0.75,
                                slope_tol=0.005)
    # unrelated content scatters — inlier gate
    other = _prints(14)
    qo = _rendition(other, 60, 320, 1.0, flip_bits=6, seed=15)
    assert not rigid_structured(qo, track, 60, inlier=0.75,
                                slope_tol=0.005)


def test_offset_line_fit_robust_to_outlier():
    p = np.arange(8) * 50.0
    d = 0.02 * p + 1.0
    d[3] = -20.0                      # one scattered window
    slope, intercept, inlier, rms = offset_line_fit(p, d, tol=2.0)
    assert abs(slope - 0.02) < 0.004
    assert inlier == pytest.approx(7 / 8)


def test_subwindow_offsets_shapes_and_clamp():
    track = _prints(8, l=100)
    q = _rendition(track, 10, 64, 1.0)
    pos, shifts, sims, proms = subwindow_offsets(q, track, 10, k=4, band=30)
    assert pos.shape == shifts.shape == sims.shape == proms.shape == (4,)
    assert np.all(np.abs(shifts) <= 30)
    assert np.all(shifts == 0)        # exact excerpt: perfect local locks
    assert np.all(sims == 1.0)
    assert np.all(proms > 0.3)        # genuine locks are strongly peaked
    with pytest.raises(ValueError):
        subwindow_offsets(q[:3], track, 0, k=8)


def test_flat_surface_is_uninformative_not_collinear():
    """A candidate whose similarity surface is FLAT (constant prints —
    quiet audio, generic near-match) must score inlier 0.0, not the
    degenerate 1.0 that tie-broken argmaxes would produce: at 250k the
    unmasked gate confirmed 30% of wrong rigid answers on stretched
    queries through exactly this mode (pre-GPU run, see git history)."""
    track = np.tile(np.array([[0xDEADBEEF, 0x12345678]], np.uint32),
                    (600, 1))
    q = _prints(21, l=320)
    pos, shifts, sims, proms = subwindow_offsets(q, track, 50, k=8, band=24)
    assert np.all(shifts == shifts[0])      # ties -> same index everywhere
    assert np.all(proms == 0.0)             # ...but zero prominence
    ev = structure_evidence(q, track, 50, k=8, band=24)
    assert ev["inlier_frac"] == 0.0
    assert ev["n_informative"] == 0
    from hpfw_jax.api import rigid_structured
    assert not rigid_structured(q, track, 50, inlier=0.75)
