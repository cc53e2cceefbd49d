"""Alignment-structure evidence: sub-window offset regression.

The matcher's score is a single max-over-offsets Hamming correlation — one
scalar per (track, hypothesis). At 250k real-audio tracks that scalar
saturates as a decision signal: wrong answers sit in a dense imposter tail
whose top scores are high AND nearly tied (pre-GPU run, see git history, escalation
probe), and the tempo scan loses a measured 12 points of recovery to
score competition with the true factor on the grid.

What the scalar throws away is STRUCTURE. Split the query into K
sub-windows and find each sub-window's best local alignment against a
candidate track: a genuine match's offsets lie on a line in sub-window
position — residual drift d(p) ~= d0 + (s_true/s_hyp - 1) * p, whose
slope IS the tempo error (SURVEY.md §2.3 step 8's offset geometry,
extended per sub-window) — while an imposter's per-window argmaxes
scatter across the search band (each window locks onto an unrelated
local coincidence). Three uses:

- VERIFY a rigid answer: slope ~= 0 + tight residuals <=> the match is
  real — a second, structural signal for the escalation gate, orthogonal
  to score/margin arithmetic (which round 4 measured as exhausted).
- PICK the scan winner: rank escalated candidates by structural
  consistency instead of raw max score (tied imposter tails do not
  produce collinear sub-window offsets).
- ESTIMATE tempo off-grid: the fitted slope is a direct tempo-factor
  estimate, finer than the hypothesis grid.

This is the NumPy reference (host-side: candidates are few — it runs on
the handful of top tracks per query, whose print rows live in the
FingerprintDB). The geometry is deliberately identical to
match/stretch.py's frame-grid model: a rendition at tempo factor s shows
catalog frame n*s at query frame n, so the catalog-side alignment of the
sub-window starting at query print p drifts by p*(s-1).
"""

from __future__ import annotations

import numpy as np


def subwindow_offsets(query: np.ndarray, track: np.ndarray, o_center: int,
                      *, k: int = 8, band: int = 24,
                      length: int | None = None):
    """Best local alignment shift per query sub-window against one track.

    query (N, 2) uint32, track (L, 2) uint32 packed hashprints; o_center
    is the candidate's reported global offset (catalog print index of
    query print 0). Sub-window j covers query prints [j*w, (j+1)*w)
    (w = N // k, tail remainder dropped) and scans catalog positions
    o_center + j*w + d for d in [-band, band] (clamped to the track).

    Returns (positions (k,), shifts (k,), sims (k,)):
      positions[j] = j*w              — the sub-window's query position,
      shifts[j]    = best d           — local offset residual,
      sims[j]      = best similarity in [0, 1] (fraction of matching bits).
    """
    q = np.asarray(query, dtype=np.uint32)
    t = np.asarray(track, dtype=np.uint32)
    n = q.shape[0]
    l = t.shape[0] if length is None else int(length)
    w = n // k
    if w < 1:
        raise ValueError(f"query too short ({n} prints) for k={k} windows")
    positions = np.arange(k, dtype=np.int64) * w
    ds = np.arange(-band, band + 1, dtype=np.int64)           # (D,)
    # Catalog index grid: (k, D, w); clamp rows whose band leaves the
    # track — clamped positions score against wrong prints and lose,
    # which is the correct behavior at track edges.
    base = o_center + positions[:, None, None] + ds[None, :, None]
    idx = np.clip(base + np.arange(w, dtype=np.int64)[None, None, :],
                  0, l - 1)
    wins = t[idx]                                             # (k, D, w, 2)
    qwin = q[positions[:, None] + np.arange(w)[None, :]]      # (k, w, 2)
    x = np.bitwise_xor(wins, qwin[:, None])
    agree = 64 * w - np.bitwise_count(x).astype(np.int64).sum(axis=(2, 3))
    best = np.argmax(agree, axis=1)                           # first on ties
    sims = agree[np.arange(k), best] / (64.0 * w)
    # Peak prominence: best minus the window's MEDIAN over shifts. A
    # window whose similarity surface is flat (quiet audio, generic
    # near-match) has prominence ~ the noise extreme (~2.3 sigma ~= 0.02
    # at w~50); argmax then ties to the same index in every window and
    # k flat windows masquerade as a perfect zero-slope line — the
    # measured failure mode that let the structure gate confirm 30% of
    # wrong rigid answers on stretched queries at 250k (pre-GPU run, see git history).
    # Callers treat low-prominence windows as uninformative.
    proms = (agree[np.arange(k), best]
             - np.median(agree, axis=1)) / (64.0 * w)
    return positions, ds[best], sims, proms


def offset_line_fit(positions: np.ndarray, shifts: np.ndarray,
                    *, tol: float = 2.0):
    """Robust line fit shifts ~= intercept + slope * positions.

    Theil–Sen: slope = median of pairwise slopes, intercept = median of
    (shift - slope*position) — one scattered sub-window (a quiet bar, a
    drum fill) cannot drag the fit the way least squares would.

    Returns (slope, intercept, inlier_frac, rms): inlier_frac is the
    fraction of sub-windows within `tol` prints of the line (the
    consistency score — a genuine match concentrates near 1.0, an
    imposter's uniform-scatter expectation is ~tol/band), rms the
    residual RMS.
    """
    p = np.asarray(positions, dtype=np.float64)
    d = np.asarray(shifts, dtype=np.float64)
    k = p.shape[0]
    if k < 2:
        return 0.0, float(d[0]) if k else 0.0, 1.0, 0.0
    i, j = np.triu_indices(k, 1)
    slopes = (d[j] - d[i]) / (p[j] - p[i])
    slope = float(np.median(slopes))
    intercept = float(np.median(d - slope * p))
    resid = d - (intercept + slope * p)
    inlier = float(np.mean(np.abs(resid) <= tol))
    rms = float(np.sqrt(np.mean(resid ** 2)))
    return slope, intercept, inlier, rms


def structure_evidence(query: np.ndarray, track: np.ndarray, o_center: int,
                       *, k: int = 8, band: int = 24, tol: float = 2.0,
                       prom_min: float = 0.05,
                       length: int | None = None) -> dict:
    """Sub-window scan + robust fit, as one evidence record.

    Returns {slope, intercept, inlier_frac, rms, mean_sim, sims, shifts,
    proms, n_informative}: `slope` estimates (s_true/s_aligned - 1) — for
    a rigid candidate that is the tempo error directly; `inlier_frac` is
    the structural consistency in [0, 1]; `mean_sim` the mean sub-window
    similarity.

    Only INFORMATIVE windows (peak prominence >= `prom_min`; a genuine
    lock peaks ~0.1 above its surroundings, a flat surface's noise
    extreme is ~0.02 at w~50) participate in the line fit and can count
    as inliers — uninformative windows count against inlier_frac, so k
    flat windows score 0.0, not the degenerate 1.0 the tie-broken argmax
    would otherwise produce. prom_min=0 restores the unmasked behavior.
    """
    positions, shifts, sims, proms = subwindow_offsets(
        query, track, o_center, k=k, band=band, length=length)
    info = proms >= prom_min
    n_info = int(np.count_nonzero(info))
    if n_info >= 2:
        slope, intercept, inlier, rms = offset_line_fit(
            positions[info], shifts[info], tol=tol)
        inlier *= n_info / float(k)
    else:
        slope, intercept, inlier, rms = 0.0, 0.0, 0.0, float("inf")
    return {"slope": slope, "intercept": intercept,
            "inlier_frac": inlier, "rms": rms,
            "mean_sim": float(np.mean(sims)),
            "positions": positions, "shifts": shifts, "sims": sims,
            "proms": proms, "n_informative": n_info}
