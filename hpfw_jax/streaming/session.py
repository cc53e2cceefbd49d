"""Streaming live-song identification (SURVEY.md §3.4, BASELINE config 3).

The reference's stated purpose is live song ID; its streaming loop is at most
an example driver (SURVEY.md §3.4). Here it is a first-class subsystem:

- ChunkedExtractor: fixed-shape jitted step that turns each new audio chunk
  into hashprints, carrying a (context_w + delta_lag - 1)-frame halo so
  chunked extraction is BIT-IDENTICAL to whole-track extraction (the
  sequence-parallel analog of SURVEY.md §2.2: time-axis chunking with halo
  overlap). One compile, any stream length.
- StreamingSession: ring of recent prints as the sliding query, continuous
  match against a FingerprintDB (dense), ShardedDB (mesh), or TwoStageDB
  (catalog scale — the production live-song-ID pairing), per-step latency
  tracking for the p50/p99 harness.
"""

from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HpfwConfig
from ..match import matcher
from ..ops import fingerprint as fp_ops
from ..ops import frontend


class ChunkedExtractor:
    """Bit-identical chunked hashprint extraction with halo overlap.

    Emits `chunk_prints` hashprints per step. A step consumes the PCM
    window covering CQT frames [t, t + chunk_prints + halo) where
    halo = context_w + delta_lag - 1; consecutive windows overlap by
    halo frames worth of samples plus (frame_len - hop).
    """

    def __init__(self, filters: np.ndarray, cfg: HpfwConfig,
                 chunk_prints: int = 32, *, frame_ring: int = 0):
        self.cfg = cfg
        self.chunk_prints = chunk_prints
        self.halo_frames = cfg.context_w + cfg.delta_lag - 1
        self.frames_per_step = chunk_prints + self.halo_frames
        # PCM samples needed to produce frames_per_step frames:
        self.window_samples = cfg.frame_len + (self.frames_per_step - 1) * cfg.hop
        # New samples consumed per step:
        self.step_samples = chunk_prints * cfg.hop
        self._filters = jnp.asarray(filters, dtype=jnp.float32)
        # frame_ring > 0: also retain the most recent `frame_ring` log-mag
        # CQT frames (the sliding query's raw spectral view — what the
        # session's SPEC-level tempo scan re-times; print i of the print
        # ring was built from frames [i, i + halo]).
        self.frame_ring: deque | None = (
            deque(maxlen=frame_ring) if frame_ring else None)

        def step(pcm_window, filters):
            spec = frontend.cqt(pcm_window, cfg)
            return fp_ops.fingerprint_from_spec(spec, filters, cfg), spec

        self._step = jax.jit(step)
        self._buf = np.zeros(0, dtype=np.float32)
        self._primed = False

    def feed(self, pcm: np.ndarray) -> np.ndarray:
        """Append audio; return newly available hashprints (k*chunk, 2)."""
        pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, pcm])
        out = []
        while self._buf.shape[0] >= self.window_samples:
            window = self._buf[: self.window_samples]
            prints, spec = self._step(jnp.asarray(window), self._filters)
            prints = np.asarray(prints)
            out.append(prints[: self.chunk_prints])
            if self.frame_ring is not None:
                # The window's first halo frames re-derive the previous
                # window's halo tail (to float32 accumulation noise ~1e-5;
                # sign margins make the PRINT-level invariant exact), so
                # drop that stale tail and append the whole window: the
                # ring always ends at the newest frame, and
                # ring[-(n + halo):] are exactly the frames of the last n
                # prints.
                spec = np.asarray(spec)
                if self.frame_ring:
                    for _ in range(min(self.halo_frames,
                                       len(self.frame_ring))):
                        self.frame_ring.pop()
                self.frame_ring.extend(spec)
            self._buf = self._buf[self.step_samples:]
        if out:
            return np.concatenate(out, axis=0)
        return np.zeros((0, 2), dtype=np.uint32)


class StreamHypothesis(NamedTuple):
    """The session's current best guess. confidence is the normalized vote
    margin (top tally minus runner-up, over top) in [0, 1] — 1.0 when no
    other track has ever won a window."""

    track_id: str
    score: int
    offset: int
    confidence: float


class StreamingSession:
    """Continuous live-song ID over an audio stream.

    feed() audio in arbitrary-size chunks; after each print-chunk boundary
    the sliding query is matched against the database and the running best
    hypothesis updates. The query ring grows PROGRESSIVELY through
    `query_buckets` (default powers of two from chunk_prints up to
    query_prints): matching starts as soon as the smallest bucket fills
    (~1 s of audio) with the largest filled bucket as the query, instead of
    waiting ~3 s for the full ring (VERDICT r2 weak #6). Each bucket is one
    fixed-shape jit program. Match latency and end-to-end step latency are
    recorded for p50/p99 reporting.

    Live-rendition tempo (cfg.stretch_span > 0): by default the session
    runs the SPEC-level scan — the extractor keeps a ring of log-mag CQT
    frames alongside the prints; a match tick re-times the newest n+halo
    frames onto the catalog grid per hypothesis and re-runs the cheap back
    half of extraction (scan_from_spec), feeding the (V, n, 2) stack to
    the matcher so every hypothesis ranks together. The scan runs as
    ACQUIRE/TRACK: the full hypothesis grid only until a window clears the
    imposter vote floor, then just a 3-point neighborhood of the locked
    tempo (rigid-only when locked at 1.0 — in-tempo streams pay the scan
    nothing after acquisition, which also avoids the measured 250k
    variant-competition recall cost); three consecutive sub-floor windows
    re-enter acquisition (track change / tempo shift). spec_scan=False
    falls back to the print-level gather inside TwoStageDB.match (no
    extra extraction, but its within-context distortion caps recovery at
    catalog scale; pre-GPU run, see git history).
    """

    def __init__(self, db, filters: np.ndarray, cfg: HpfwConfig | None = None,
                 *, query_prints: int = 128, chunk_prints: int = 32,
                 match_every: int = 1, vote_decay: float = 0.8,
                 query_buckets: tuple | None = None,
                 vote_floor: float = 0.55, spec_scan: bool | None = None,
                 lock_margin: float = 0.05):
        self.db = db                      # FingerprintDB, ShardedDB, TwoStageDB
        self.cfg = cfg if cfg is not None else getattr(db, "cfg", None) or db.db.cfg
        # Live-rendition tempo handling (cfg.stretch_span > 0): the SPEC-
        # level scan re-times the frame ring onto the catalog grid and
        # re-runs the cheap back half per hypothesis — the print-level
        # gather (spec_scan=False: stretch_span passed through db.match)
        # caps at 0.51 top-1 at 250k tracks from within-context distortion
        # (pre-GPU run, see git history, stretch diag), so spec is the default.
        if spec_scan is None:
            spec_scan = (self.cfg.stretch_span > 0.0
                         or self.cfg.pitch_span_bins > 0)
        if spec_scan and self.cfg.stretch_span <= 0.0 \
                and self.cfg.pitch_span_bins <= 0:
            raise ValueError("spec_scan=True needs cfg.stretch_span > 0 "
                             "and/or cfg.pitch_span_bins > 0")
        self._spec_scan = bool(spec_scan)
        halo = self.cfg.context_w + self.cfg.delta_lag - 1
        self.extractor = ChunkedExtractor(
            filters, self.cfg, chunk_prints,
            frame_ring=(query_prints + halo) if self._spec_scan else 0)
        self._scan_progs: dict[tuple, object] = {}
        self._scan_state = "acquire"   # full grid until a lock, then track
        self.tempo = 1.0               # locked tempo-hypothesis factor
        self.pitch = 0                 # locked pitch roll (CQT bins; round 5)
        self._subfloor = 0             # consecutive unconfident windows
        self.lock_margin = lock_margin  # top1->top2 gap to lock tempo
        self.query_prints = query_prints
        self.match_every = match_every
        # Live song ID integrates evidence over time (SURVEY.md §3.4
        # "update per-track running scores"): each window's top hit casts a
        # score-weighted vote into an exponentially-decayed tally, so one
        # noisy window at catalog scale can't flip the running hypothesis.
        self.vote_decay = vote_decay
        # Vote weight is the score's EXCESS over vote_floor * 64 * N — the
        # imposter ceiling (a wrong best-match at catalog scale sits at
        # ~0.52-0.55 similarity, a true match at ~0.7+). Early small-window
        # mismatches thus contribute ~zero tally and the first genuinely
        # matching window takes the hypothesis immediately, instead of
        # having to out-decay accumulated noise votes.
        self.vote_floor = vote_floor
        if query_buckets is None:
            buckets = []
            b = max(16, chunk_prints)
            while b < query_prints:
                buckets.append(b)
                b *= 2
            buckets.append(query_prints)
            query_buckets = tuple(buckets)
        self.query_buckets = tuple(sorted(set(query_buckets)))
        assert self.query_buckets[-1] <= query_prints
        self._votes: dict[str, float] = {}
        self._last: dict[str, tuple[int, int]] = {}   # id -> (score, offset)
        self._ring: deque = deque(maxlen=query_prints)
        self._chunks_seen = 0
        self.match_latencies_ms: list[float] = []
        self.step_latencies_ms: list[float] = []
        self.last_match: tuple[str, int, int] | None = None  # instantaneous
        self.current_best: StreamHypothesis | None = None   # integrated

    def _scan_factors(self) -> tuple:
        """Current (tempo, pitch-roll) hypotheses: the full grid while
        ACQUIRING; once a hypothesis has cleared the vote floor (TRACK
        state) just a 3-point tempo neighborhood at the locked pitch —
        live tempo drifts slowly and a performed KEY holds (re-acquisition
        handles key changes), so tracking costs <=3 dispatches instead of
        V, and a lock at (1.0, 0) needs only the rigid dispatch (full-scan
        cost on in-key in-tempo streams: zero after acquisition)."""
        if self._scan_state == "acquire":
            from .. import api

            return api.scan_hypotheses(self.cfg)
        if self.tempo == 1.0 and self.pitch == 0:
            return ()                      # rigid only
        if self.cfg.stretch_span <= 0.0:
            return ((1.0, self.pitch),)    # pitch-only lock
        step = self.cfg.stretch_step
        lo, hi = 1.0 - self.cfg.stretch_span, 1.0 + self.cfg.stretch_span
        return tuple((s, self.pitch) for s in
                     sorted({max(lo, round(self.tempo - step, 6)),
                             round(self.tempo, 6),
                             min(hi, round(self.tempo + step, 6))}))

    def _scan_stack(self, n: int, factors: tuple) -> np.ndarray:
        """(V, n, 2) tempo-hypothesis prints from the newest n+halo frames.

        One jitted scan_from_spec program per (bucket, grid); the identity
        row equals the print ring's last n prints bit for bit (tested), so
        the scan only ADDS hypotheses."""
        halo = self.extractor.halo_frames
        frames = np.asarray(self.extractor.frame_ring,
                            dtype=np.float32)[-(n + halo):]
        prog = self._scan_progs.get((n, factors))
        if prog is None:
            from .. import api

            prog = jax.jit(lambda spec, filt: api.scan_from_spec(
                spec, filt, self.cfg, factors))
            self._scan_progs[(n, factors)] = prog
        return np.asarray(prog(jnp.asarray(frames), self.extractor._filters))

    def _match_window(self):
        n = max(b for b in self.query_buckets if b <= len(self._ring))
        q = np.array(self._ring, dtype=np.uint32)[-n:]
        # Tempo hypotheses need the longest evidence: a short early bucket
        # can't resolve span*n < ~2 frames of drift, and letting it lock
        # would freeze tempo at 1.0 before the scan ever discriminates —
        # so the scan (and the lock state machine below) only runs on
        # full-ring windows; progressive early buckets match rigid.
        full = n == self.query_prints
        factors = (self._scan_factors() if self._spec_scan and full
                   and len(self.extractor.frame_ring)
                   >= n + self.extractor.halo_frames else ())
        t0 = time.perf_counter()
        win_factor = (1.0, 0)
        k = 2 if self._spec_scan else 1   # runner-up feeds the lock margin
        if factors:
            stack = self._scan_stack(n, factors)
            if hasattr(self.db, "dispatch"):
                # TwoStageDB ranks the (V, n, 2) stack's rows together
                # (pre-scanned variants supersede its print-level scan).
                ids, scores, offs, var = self.db.match(
                    stack, top_k=k, return_variant=True)
                if len(ids):
                    win_factor = factors[int(var[0])]
            else:
                # Dense FingerprintDB / ShardedDB: per-variant match, best
                # score wins.
                from .. import api

                def one(v):
                    if hasattr(self.db, "match"):
                        return self.db.match(v, top_k=k)
                    return api.match(v, self.db, top_k=k)

                best, ids, scores, offs = None, [], [], []
                for s, v in zip(factors, stack):
                    r = one(v)
                    if len(r[0]) and (best is None or r[1][0] > scores[0]):
                        best, (ids, scores, offs) = s, r
                if best is not None:
                    win_factor = best
        elif hasattr(self.db, "match"):  # ShardedDB / TwoStageDB
            ids, scores, offs = self.db.match(q, top_k=k)
        else:  # dense FingerprintDB
            from .. import api

            ids, scores, offs = api.match(q, self.db, top_k=k)
        self.match_latencies_ms.append((time.perf_counter() - t0) * 1e3)
        if self._spec_scan and full and len(ids):
            # Tempo lock state: locking (or re-centering) the tempo needs a
            # CONFIDENT window — above the imposter floor AND clear of its
            # runner-up. Absolute score alone cannot gate this: at 250k a
            # wrong answer on a tempo-distorted window scores high but
            # nearly TIED with the dense imposter tail (measured, round 4),
            # while a true match separates. Consecutive unconfident windows
            # (track change, tempo shift) fall back to acquisition.
            s1 = float(scores[0])
            s2 = float(scores[1]) if len(scores) > 1 else 0.0
            clear = (s1 > self.vote_floor * 64.0 * n
                     and (s1 - s2) / max(s1, 1e-9) >= self.lock_margin)
            if clear:
                self._scan_state = "track"
                s, r = (win_factor if factors else (1.0, 0))
                self.tempo, self.pitch = float(s), int(r)
                self._subfloor = 0
            else:
                self._subfloor += 1
                if self._subfloor >= 3:
                    self._scan_state = "acquire"
                    self._subfloor = 0
        if len(ids):
            self.last_match = (ids[0], int(scores[0]), int(offs[0]))
            for k in self._votes:
                self._votes[k] *= self.vote_decay
            excess = max(0.0, float(scores[0])
                         - self.vote_floor * 64.0 * q.shape[0])
            self._votes[ids[0]] = self._votes.get(ids[0], 0.0) + excess
            self._last[ids[0]] = (int(scores[0]), int(offs[0]))
            ranked = sorted(self._votes.items(), key=lambda kv: -kv[1])
            top, v_top = ranked[0]
            if v_top > 0:
                v_second = ranked[1][1] if len(ranked) > 1 else 0.0
                conf = (v_top - v_second) / v_top
                self.current_best = StreamHypothesis(top, *self._last[top],
                                                     conf)
            else:
                # No window has cleared the imposter floor yet: surface the
                # instantaneous best with zero confidence.
                self.current_best = StreamHypothesis(*self.last_match, 0.0)

    def feed(self, pcm: np.ndarray):
        """Stream in audio; returns the current StreamHypothesis (track_id,
        score, offset, confidence) or None before the first match."""
        t0 = time.perf_counter()
        new_prints = self.extractor.feed(pcm)
        if new_prints.shape[0]:
            for p in new_prints:
                self._ring.append(p)
            n_chunks = new_prints.shape[0] // self.extractor.chunk_prints
            for _ in range(max(n_chunks, 1)):
                self._chunks_seen += 1
                if (len(self._ring) >= self.query_buckets[0]
                        and self._chunks_seen % self.match_every == 0):
                    self._match_window()
                    break  # one match per feed call is enough
        self.step_latencies_ms.append((time.perf_counter() - t0) * 1e3)
        return self.current_best

    def latency_stats(self) -> dict:
        def pct(xs, p):
            return float(np.percentile(xs, p)) if xs else float("nan")

        return {
            "match_p50_ms": pct(self.match_latencies_ms, 50),
            "match_p99_ms": pct(self.match_latencies_ms, 99),
            "step_p50_ms": pct(self.step_latencies_ms, 50),
            "step_p99_ms": pct(self.step_latencies_ms, 99),
            "n_matches": len(self.match_latencies_ms),
        }


def extract_chunked(pcm: np.ndarray, filters: np.ndarray, cfg: HpfwConfig,
                    *, chunk_prints: int = 256) -> np.ndarray:
    """Whole-track extraction via the chunked path (unbounded length).

    Bit-identical to api.fingerprint(pcm) — property-tested (§4.3) — but
    compiles one fixed-shape step regardless of track length.
    """
    ex = ChunkedExtractor(filters, cfg, chunk_prints)
    total = cfg.n_hashprints(np.asarray(pcm).shape[0])
    if total <= 0:
        return np.zeros((0, 2), dtype=np.uint32)
    # Pad the tail so the final partial chunk still fills a full window.
    pad = ex.window_samples
    prints = ex.feed(np.concatenate([np.asarray(pcm, np.float32), np.zeros(pad, np.float32)]))
    return prints[:total]
