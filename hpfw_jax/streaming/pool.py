"""Batched live-song-ID: many concurrent streams on one device.

StreamingSession (session.py) drives ONE stream with one extraction and
one match dispatch per chunk, so N independent sessions serialize N
dispatches and N device syncs per tick. StreamingPool runs up to
`capacity` streams against one database with

  - ONE batched extraction dispatch per tick (the ChunkedExtractor step
    vmapped over the pool's ready windows — fixed (capacity, W) shape,
    absent streams ride as zero windows and their prints are discarded),
  - one batched match dispatch per QUERY BUCKET per tick
    (TwoStageDB.match_batch needs equal-length queries, so streams group
    by their progressive ring bucket; at steady state every stream sits
    in the top bucket and the whole pool matches in a single coarse DB
    sweep),

while keeping each stream's vote integration, confidence, and hypothesis
identical in structure to StreamingSession (the per-stream matcher
results are what they would be alone — match_batch returns per-query
results equal to match(), tests/test_match_batch.py).

Reference parity: the reference is a single-process library whose
streaming loop is at most an example driver (SURVEY.md §3.4); batched
concurrent streams are the accelerator's production shape of that
capability (one device's coarse sweep amortized over all live streams).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HpfwConfig
from ..ops import fingerprint as fp_ops
from ..ops import frontend
from .session import StreamHypothesis


class _StreamState:
    __slots__ = ("buf", "ring", "votes", "last", "best", "chunks")

    def __init__(self):
        self.buf = np.zeros(0, dtype=np.float32)
        self.ring = np.zeros((0, 2), dtype=np.uint32)
        self.votes: dict[str, float] = {}
        self.last: dict[str, tuple[int, int]] = {}
        self.best: StreamHypothesis | None = None
        self.chunks = 0


class StreamingPool:
    """Up to `capacity` concurrent StreamingSession-equivalent streams,
    batched per tick. add_stream()/remove_stream() manage slots; feed()
    takes {stream_id: pcm chunk} and returns {stream_id: hypothesis}."""

    def __init__(self, db, filters: np.ndarray, cfg: HpfwConfig | None = None,
                 *, capacity: int = 8, query_prints: int = 128,
                 chunk_prints: int = 32, vote_decay: float = 0.8,
                 vote_floor: float = 0.55,
                 query_buckets: tuple | None = None):
        self.db = db
        self.cfg = (cfg if cfg is not None
                    else getattr(db, "cfg", None) or db.db.cfg)
        c = self.cfg
        self.capacity = capacity
        self.chunk_prints = chunk_prints
        self.query_prints = query_prints
        self.vote_decay = vote_decay
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
        assert self.query_buckets[-1] <= query_prints, \
            "query_buckets must fit within query_prints"
        halo = c.context_w + c.delta_lag - 1
        self.frames_per_step = chunk_prints + halo
        self.window_samples = c.frame_len + (self.frames_per_step - 1) * c.hop
        self.step_samples = chunk_prints * c.hop
        self._filters = jnp.asarray(filters, dtype=jnp.float32)

        def step(pcm_window, filters):
            spec = frontend.cqt(pcm_window, c)
            return fp_ops.fingerprint_from_spec(spec, filters, c)

        self._step_batch = jax.jit(jax.vmap(step, in_axes=(0, None)))
        self._streams: dict[str, _StreamState] = {}
        self.match_latencies_ms: list[float] = []
        self.tick_latencies_ms: list[float] = []

    # -- stream management --------------------------------------------------

    def add_stream(self, sid: str) -> None:
        if sid in self._streams:
            raise ValueError(f"stream {sid!r} already exists")
        if len(self._streams) >= self.capacity:
            raise ValueError("pool at capacity")
        self._streams[sid] = _StreamState()

    def remove_stream(self, sid: str) -> None:
        self._streams.pop(sid, None)

    @property
    def stream_ids(self):
        return list(self._streams)

    # -- the tick -----------------------------------------------------------

    def feed(self, chunks: dict[str, np.ndarray]) -> dict:
        """Append audio per stream, run at most one batched extraction and
        one batched match per bucket, return {sid: StreamHypothesis|None}."""
        t0 = time.perf_counter()
        unknown = [sid for sid in chunks if sid not in self._streams]
        if unknown:
            # One bad caller key must not abort the shared tick for every
            # other live stream with an opaque KeyError.
            raise ValueError(
                f"unknown stream ids {unknown!r}; add_stream() them first "
                f"(live: {sorted(self._streams)!r})")
        for sid, pcm in chunks.items():
            st = self._streams[sid]
            st.buf = np.concatenate(
                [st.buf, np.asarray(pcm, dtype=np.float32).reshape(-1)])
        # Streams may have buffered several windows; drain every full
        # window (batched extraction) so slow feeders can't stall fast
        # ones, then match AT MOST ONCE per feed call — the same cadence
        # as StreamingSession (one vote per feed keeps a pool stream's
        # hypothesis identical to a lone session's on the same schedule).
        advanced: set = set()
        while True:
            ready = [sid for sid, st in self._streams.items()
                     if st.buf.shape[0] >= self.window_samples]
            if not ready:
                break
            self._extract_tick(ready)
            advanced.update(ready)
        if advanced:
            self._match_tick(sorted(advanced))
            # only ticks that extracted+matched count toward tick latency
            self.tick_latencies_ms.append((time.perf_counter() - t0) * 1e3)
        return {sid: st.best for sid, st in self._streams.items()}

    def _extract_tick(self, ready: list) -> None:
        """One fixed-shape batched extraction over the pool's slots."""
        windows = np.zeros((self.capacity, self.window_samples),
                           dtype=np.float32)
        slot_of = {}
        for slot, sid in enumerate(ready):
            windows[slot] = self._streams[sid].buf[: self.window_samples]
            slot_of[sid] = slot
        prints = np.asarray(self._step_batch(jnp.asarray(windows),
                                             self._filters))
        for sid in ready:
            st = self._streams[sid]
            new = prints[slot_of[sid], : self.chunk_prints]
            st.ring = np.concatenate([st.ring, new])[-self.query_prints:]
            st.buf = st.buf[self.step_samples:]
            st.chunks += 1

    def _match_tick(self, ready: list) -> None:
        """Group matchable streams by query bucket; one batched dispatch
        per group (padded to the group's bucket count so the jit cache
        holds one program per bucket)."""
        groups: dict[int, list] = {}
        for sid in ready:
            st = self._streams[sid]
            fits = [b for b in self.query_buckets if b <= st.ring.shape[0]]
            if fits:
                groups.setdefault(max(fits), []).append(sid)
        for bucket, sids in sorted(groups.items()):
            queries = np.stack([self._streams[s].ring[-bucket:]
                                for s in sids])
            t0 = time.perf_counter()
            results = self._match_batch(queries)
            self.match_latencies_ms.append(
                (time.perf_counter() - t0) * 1e3)
            for sid, (ids, scores, offs) in zip(sids, results):
                self._integrate(sid, ids, scores, offs, bucket)

    def _match_batch(self, queries: np.ndarray):
        # TwoStageDB: one batched dispatch.
        if hasattr(self.db, "match_batch"):
            n = queries.shape[0]
            if n < self.capacity:
                # Pad to capacity with the first query so every bucket has
                # ONE compiled batch shape; padded rows are discarded.
                pad = np.broadcast_to(
                    queries[:1], (self.capacity - n,) + queries.shape[1:])
                queries = np.concatenate([queries, pad])
            return self.db.match_batch(queries, top_k=1)[:n]
        # dense FingerprintDB / ShardedDB: per-query match, no padding
        # (each row costs a full match)
        from .. import api

        out = []
        for q in queries:
            if hasattr(self.db, "match"):
                out.append(self.db.match(q, top_k=1))
            else:
                out.append(api.match(q, self.db, top_k=1))
        return out

    def _integrate(self, sid: str, ids, scores, offs, bucket: int) -> None:
        """StreamingSession's vote integration, per stream."""
        st = self._streams[sid]
        if not len(ids):
            return
        for k in st.votes:
            st.votes[k] *= self.vote_decay
        excess = max(0.0, float(scores[0])
                     - self.vote_floor * 64.0 * bucket)
        st.votes[ids[0]] = st.votes.get(ids[0], 0.0) + excess
        st.last[ids[0]] = (int(scores[0]), int(offs[0]))
        ranked = sorted(st.votes.items(), key=lambda kv: -kv[1])
        top, v_top = ranked[0]
        if v_top > 0:
            v_second = ranked[1][1] if len(ranked) > 1 else 0.0
            conf = (v_top - v_second) / v_top
            st.best = StreamHypothesis(top, *st.last[top], conf)
        else:
            st.best = StreamHypothesis(ids[0], int(scores[0]),
                                       int(offs[0]), 0.0)

    def latency_stats(self) -> dict:
        def pct(xs, p):
            return float(np.percentile(xs, p)) if xs else float("nan")

        return {
            "match_p50_ms": pct(self.match_latencies_ms, 50),
            "match_p99_ms": pct(self.match_latencies_ms, 99),
            "tick_p50_ms": pct(self.tick_latencies_ms, 50),
            "tick_p99_ms": pct(self.tick_latencies_ms, 99),
            "n_matches": len(self.match_latencies_ms),
        }
