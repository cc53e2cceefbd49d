"""Query-side tempo (time-stretch) scan for live-rendition matching.

Live performances differ from the catalog in tempo; the matcher's scoring
is a rigid-alignment Hamming correlation, so at the production 10 s query
(~430 frames, 23.2 ms hop) a 3% tempo error mis-aligns >95% of the window
and top-1 collapses to the noise floor (pre-GPU run, see git history, robustness at
250k; SURVEY.md §1.1 [P] — live song ID is the system's stated purpose).

The mitigation is query-side re-timing: a rendition at tempo factor s
places catalog frame i at query frame i/s, so gathering the query's print
sequence at indices round(i/s_h) for a hypothesized s_h re-times it to
catalog tempo — a pure time-axis gather on the PACKED prints. No catalog
change, no re-extraction (the residual within-context distortion the
gather cannot undo costs ~2 points at 3%; pre-GPU run, see git history). Scanning a small grid of hypotheses and
keeping the best score recovers stretched queries; grid spacing 1%
(residual <= 0.5%) preserves top-1 per the study's tolerance curve.

Tempo changes the FRAME GRID, not the spectrum; pitch changes the
SPECTRUM, not the frame grid — at 24 bins/octave a key shift of k*0.5 st
is exactly a k-bin roll of the log-mag CQT. The learned filters absorb
part of a key change (config 5: 0.63-0.71 at ±0.5-1 st vs 0.865 in-key at
250k, pre-GPU run, see git history) and the pitch-hypothesis scan (pitch_grid + the
spec-level re-key in api.scan_from_spec) recovers the rest; the two axes
compose as a product grid (hypothesis_grid) for the realistic live case
where both move at once.

Two re-timing levels share this module's frame-grid geometry:

- PRINT level (print_variants): gather the packed prints. Zero extraction
  cost, available wherever prints are (streaming rings) — but each
  gathered print was computed from context windows of the STRETCHED
  signal, and that within-context distortion interacts badly with imposter
  density: at 250k tracks the oracle-inverse print gather recovers only
  0.51 vs the 0.865 noise-only point (pre-GPU run, see git history, stretch diag).
- SPEC level (api.fingerprint_scan_batch): re-time the CQT FRAMES before
  context assembly and re-run the cheap back half of extraction per
  hypothesis (the NDFT frontend — the expensive GEMM — is shared). Context
  windows and delta lags are then built on the catalog frame grid, so the
  only residual is sub-frame interpolation; no pitch shift (a PCM resample
  would cost ~0.5 st at 3 percent) and no within-context drift.
"""

from __future__ import annotations

import numpy as np


def stretch_grid(span: float = 0.03, step: float = 0.01) -> list[float]:
    """Symmetric tempo-hypothesis grid: 1±span in `step` increments.

    The identity hypothesis 1.0 is always the center element, so an
    undistorted query scores identically to a scan-free match on that
    variant (the scan can only add competing hypotheses, measured to cost
    <=1 top-1 point at 400 tracks — stretch_study s=1.0 grid column).
    """
    k = int(round(span / step))
    return [round(1.0 + i * step, 6) for i in range(-k, k + 1)]


def pitch_grid(span_bins: int) -> list[int]:
    """Symmetric pitch-hypothesis grid: CQT bin rolls -span..+span.

    At 24 bins/octave one bin = 0.5 semitone, so span_bins=2 covers the
    ±1 st live-key range (BASELINE.json:11 names pitch-shift; the r4
    measurement put the unmitigated hole at 16-24 points of top-1 at
    250k). Roll +r hypothesizes the query is performed r bins HIGH:
    content at catalog bin k sits at query bin k+r, so re-keying gathers
    query bin k+r back to catalog bin k. 0 (the identity key) is always
    the center element.
    """
    return list(range(-int(span_bins), int(span_bins) + 1))


def hypothesis_grid(factors, rolls) -> list[tuple[float, int]]:
    """Product grid of (tempo factor, pitch roll) hypotheses.

    Ordered rolls-major so that with both axes centered (stretch_grid,
    pitch_grid) the combined identity hypothesis (1.0, 0) sits at index
    V//2 — the same center-row invariant the tempo-only scan's callers
    rely on (the identity row of a scan stack is bit-exact plain
    extraction).
    """
    return [(float(s), int(r)) for r in rolls for s in factors]


def print_variants(qprints: np.ndarray, factors) -> np.ndarray:
    """Re-time packed query prints at each hypothesized tempo factor.

    qprints: (N, 2) uint32 or batched (B, N, 2).
    factors: iterable of tempo hypotheses s_h (1.0 = as-is).
    Returns (B, V, N, 2) (B=1 for the unbatched form) — variant v at
    catalog-tempo frame i gathers query frame round(i / s_h), clamped; a
    slower-than-catalog hypothesis (s_h < 1) duplicates the final
    (1 - s_h) fraction of frames at the tail, which scores as a few
    percent of neutral bits rather than corrupting the alignment.
    """
    q = np.asarray(qprints, dtype=np.uint32)
    if q.ndim == 2:
        q = q[None]
    n = q.shape[1]
    base = np.arange(n, dtype=np.float64)
    idx = np.stack([np.clip(np.round(base / s).astype(np.int64), 0, n - 1)
                    for s in factors])                    # (V, N)
    return q[:, idx]                                      # (B, V, N, 2)
