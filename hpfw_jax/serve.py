"""Micro-batching match server: the serving loop around the batched matcher.

BASELINE config 4's QPS story is batched serving — B queries share one
coarse-DB sweep (`TwoStageDB.dispatch_batch`). This module provides the
production loop that turns that kernel into a service: callers submit
queries from any thread and get futures; a single dispatcher thread groups
up to `max_batch` queries (waiting at most `max_wait_ms` for the batch to
fill), issues ONE device dispatch per group, and a worker pool materializes
results and ranks them.

Design points:
  - One dispatcher thread owns DISPATCH: a single in-order queue keeps the
    device fed without lock contention on the hot path. Materialization
    (the device->host sync) and host ranking run on `rank_workers` pool
    threads, so the dispatcher never blocks on a result and consecutive
    batches pipeline on the device.
  - Up to `depth` batches are in flight on the device before the dispatcher
    waits (semaphore released as results land) — bounded device queue.
  - The submit queue is BOUNDED (`max_queue`): when the server is saturated
    submissions fail fast with ServerSaturated (optionally after blocking
    `submit_timeout_ms`) instead of building unbounded latency — load
    shedding is the correct backpressure for a latency-SLO service.
  - Queries must share one print length (`query_prints`): batched matching
    is a fixed-shape jit program; a serving deployment pins the query
    window (e.g. 10 s) at config time, exactly like the streaming session
    pins its window. Wrong-length submissions fail fast.

The reference has no serving stack (single-process C++ library, SURVEY.md
§1.1); this is the production wrapper over its match() surface.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np


class ServerSaturated(RuntimeError):
    """Submit queue is full: the server is shedding load."""


class MatchServer:
    """Micro-batching wrapper around TwoStageDB.dispatch_batch."""

    def __init__(self, ts, query_prints: int, *, max_batch: int = 16,
                 max_wait_ms: float = 5.0, depth: int = 2,
                 top_k: int | None = None, pool: int | None = None,
                 max_queue: int = 256, submit_timeout_ms: float = 0.0,
                 rank_workers: int = 4):
        import jax.numpy as jnp

        self._jnp = jnp
        self.ts = ts
        self.n_q = int(query_prints)
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1e3
        self.depth = int(depth)
        self.top_k = top_k
        self.pool = pool
        self.submit_timeout = submit_timeout_ms / 1e3
        self._q: queue.Queue = queue.Queue(maxsize=int(max_queue))
        self._stop = threading.Event()
        self._device_slots = threading.Semaphore(self.depth)
        self._rank_pool = ThreadPoolExecutor(
            max_workers=int(rank_workers), thread_name_prefix="hpfw-rank")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ---- client surface -------------------------------------------------
    def submit(self, query_prints: np.ndarray,
               timeout_ms: float | None = None) -> Future:
        """Queue one (N, 2)-uint32 query; resolves to (ids, scores, offs).

        When the bounded submit queue is full, blocks up to `timeout_ms`
        (default: the server's submit_timeout_ms) and then resolves the
        future with ServerSaturated — callers see backpressure, not
        unbounded queueing latency.
        """
        q = np.asarray(query_prints, dtype=np.uint32)
        fut: Future = Future()
        if q.shape != (self.n_q, 2):
            fut.set_exception(ValueError(
                f"server is pinned to {self.n_q}-print queries, "
                f"got {q.shape}"))
            return fut
        if self._stop.is_set():
            fut.set_exception(RuntimeError("server closed"))
            return fut
        wait = self.submit_timeout if timeout_ms is None else timeout_ms / 1e3
        try:
            if wait > 0:
                self._q.put((q, fut), timeout=wait)
            else:
                self._q.put_nowait((q, fut))
        except queue.Full:
            fut.set_exception(ServerSaturated(
                f"submit queue full ({self._q.maxsize} pending)"))
        return fut

    def match(self, query_prints: np.ndarray):
        """Blocking convenience wrapper."""
        return self.submit(query_prints, timeout_ms=None).result()

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 4
        return min(b, self.max_batch)

    def warmup(self, example_query: np.ndarray) -> None:
        """Compile every batch bucket up front (serving should never pay a
        first-compile inside a latency SLO)."""
        b = 1
        while True:
            qs = self._jnp.asarray(
                np.broadcast_to(example_query, (min(b, self.max_batch),
                                                self.n_q, 2)))
            np.asarray(self.ts.dispatch_batch(qs, pool=self.pool))
            if b >= self.max_batch:
                break
            b *= 4

    def close(self) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(None)       # wake the dispatcher
        except queue.Full:
            pass                           # dispatcher is draining; stop flag set
        self._thread.join()
        self._rank_pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- dispatcher -----------------------------------------------------
    def _collect(self):
        """Block for one query, then soak up to max_batch within max_wait."""
        item = self._q.get()
        if item is None:
            return []
        batch = [item]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _run(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                break
            # Bucketed batch shapes: a jit program exists per (B, N)
            # signature, so variable-size batches would recompile constantly
            # under Poisson arrivals. Batches pad (replicating the last
            # query; padded rows are dropped before ranking) to the next
            # power-of-4 bucket — a handful of programs, compiled up front
            # by warmup(), with at most 4x padding waste at low fill.
            rows = [q for q, _ in batch]
            rows += [rows[-1]] * (self._bucket(len(rows)) - len(rows))
            # Bound the device queue: a slot frees when a result lands.
            acquired = False
            while not acquired and not self._stop.is_set():
                acquired = self._device_slots.acquire(timeout=0.1)
            if not acquired:
                for _, fut in batch:
                    if fut.set_running_or_notify_cancel():
                        fut.set_exception(RuntimeError("server closed"))
                break
            qs = self._jnp.asarray(np.stack(rows))
            out_dev = self.ts.dispatch_batch(qs, pool=self.pool)
            self._rank_pool.submit(self._finish, out_dev,
                                   [f for _, f in batch])
        # Fail anything still queued after close().
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(RuntimeError("server closed"))

    def _finish(self, out_dev, futs):
        """Worker-pool side: device sync + per-query host ranking."""
        try:
            out = np.asarray(out_dev)
        except Exception as e:                     # device failure: fail futures
            self._device_slots.release()
            for fut in futs:
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(e)
            return
        self._device_slots.release()
        for b, fut in enumerate(futs):
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(self._rank(out[b]))
                except Exception as e:
                    fut.set_exception(e)

    def _rank(self, out_b: np.ndarray):
        from .match.scaled import _rank_dedup

        cfg = self.ts.db.cfg
        scores, idx, offs = out_b
        real = idx < self.ts.n_real
        return _rank_dedup(scores[real], idx[real], offs[real],
                           self.ts.db.track_ids,
                           self.top_k if self.top_k else cfg.top_k)


class EscalatingMatchServer:
    """PCM-in serving loop with identity-first rendition-scan escalation.

    The production shape of api.match_scan_escalating as a service: callers submit raw PCM
    windows; a rigid dispatcher batches extraction (one jitted program
    yields the log-mag CQT AND the packed prints) plus one rigid match
    dispatch per batch; results that fail the confidence gate
    (api.rigid_confident) re-enter on a SECOND dispatch class — a scan
    dispatcher that re-runs the cheap back half of extraction per
    (tempo, pitch) hypothesis on the saved spec (api.scan_from_spec; the
    NDFT GEMM is never recomputed) and re-matches the variant stack,
    overriding the rigid answer only on decisively better evidence
    (api.scan_overrides). Two dispatch classes mean clean traffic never
    queues behind scans on the host side; the device interleaves the
    ms-scale dispatches FIFO.

    Futures resolve to (ids, scores, offsets, escalated: bool). The
    reference has no serving stack (SURVEY.md §1.1); this wraps its
    match() surface for an accelerator.
    """

    def __init__(self, ts, filters, query_samples: int, *,
                 max_batch: int = 16, max_wait_ms: float = 5.0,
                 scan_batch: int | None = None,
                 scan_wait_ms: float | None = None,
                 depth: int = 2, top_k: int | None = None,
                 pool: int | None = None, max_queue: int = 256,
                 submit_timeout_ms: float = 0.0, rank_workers: int = 4,
                 threshold: float = 0.62, margin: float = 0.04,
                 hi_sim: float = 0.78, override: float = 0.02,
                 span: float | None = None, step: float | None = None,
                 pitch_span_bins: int | None = None,
                 structure_gate: float | None = None,
                 structure_slope_tol: float = 0.005,
                 override_unstructured: float | None = None,
                 interp: str = "linear"):
        import jax
        import jax.numpy as jnp

        from . import api
        from .ops import fingerprint as fp_ops
        from .ops import frontend

        self._jnp = jnp
        self._api = api
        self.ts = ts
        cfg = ts.db.cfg
        self.cfg = cfg
        self.n_samples = int(query_samples)
        self.n_q = cfg.n_hashprints(self.n_samples)
        if self.n_q <= 0:
            raise ValueError(f"query window of {query_samples} samples "
                             "yields no hashprints")
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1e3
        self.top_k = top_k
        self.pool = pool
        self.gate = dict(threshold=threshold, margin=margin, hi_sim=hi_sim)
        self.override = override
        # The cheap structural rung between "confident" and the scan
        # (api.rigid_structured): accept an unconfident rigid answer whose
        # sub-window offsets are collinear at ~zero slope. Host-side over
        # the candidate's catalog print row; needs host prints (mmap OK).
        self.structure_gate = structure_gate
        self.structure_slope_tol = structure_slope_tol
        # Override bar for scans whose rigid answer FAILED the structure
        # gate (geometry already voted against it — see
        # api.match_scan_escalating's override_unstructured).
        self.override_unstructured = (
            override_unstructured if structure_gate is not None else None)
        if structure_gate is not None and ts.db.prints is None:
            raise ValueError("structure_gate needs host print rows on "
                             "ts.db.prints")
        self.hyps = api.scan_hypotheses(cfg, span, step, pitch_span_bins)
        # Bound the scan dispatch class to ~70 variant rows per dispatch.
        v = len(self.hyps)
        auto = max(1, 70 // v)
        self.scan_batch = int(scan_batch) if scan_batch else auto
        self.scan_wait = (scan_wait_ms / 1e3 if scan_wait_ms is not None
                          else 2 * self.max_wait)
        self.submit_timeout = submit_timeout_ms / 1e3
        self._filters = jnp.asarray(np.asarray(filters, dtype=np.float32))

        def extract(pcms, filt):
            def one(p):
                spec = frontend.cqt(p, cfg)
                return spec, fp_ops.fingerprint_from_spec(spec, filt, cfg)
            return jax.lax.map(one, pcms)

        self._extract = jax.jit(extract)

        def scan(specs, filt):
            return jax.lax.map(
                lambda s: api.scan_from_spec(s, filt, cfg, self.hyps,
                                             interp), specs)

        self._scan = jax.jit(scan)
        self._q: queue.Queue = queue.Queue(maxsize=int(max_queue))
        self._scan_q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._device_slots = threading.Semaphore(int(depth))
        self._rank_pool = ThreadPoolExecutor(
            max_workers=int(rank_workers), thread_name_prefix="hpfw-esc")
        self._lock = threading.Lock()
        self.stats = {"submitted": 0, "confident": 0, "escalated": 0,
                      "overridden": 0, "structure_kept": 0, "shed": 0}
        self._rigid_thread = threading.Thread(target=self._run_rigid,
                                              daemon=True)
        self._scan_thread = threading.Thread(target=self._run_scan,
                                             daemon=True)
        self._rigid_thread.start()
        self._scan_thread.start()

    def _count(self, key, n=1):
        with self._lock:
            self.stats[key] += n

    # ---- client surface -------------------------------------------------
    def submit(self, pcm: np.ndarray,
               timeout_ms: float | None = None) -> Future:
        """Queue one PCM window; resolves to (ids, scores, offs, escalated)."""
        p = np.asarray(pcm, dtype=np.float32)
        fut: Future = Future()
        if p.shape != (self.n_samples,):
            fut.set_exception(ValueError(
                f"server is pinned to {self.n_samples}-sample queries, "
                f"got {p.shape}"))
            return fut
        if self._stop.is_set():
            fut.set_exception(RuntimeError("server closed"))
            return fut
        wait = self.submit_timeout if timeout_ms is None else timeout_ms / 1e3
        try:
            if wait > 0:
                self._q.put((p, fut), timeout=wait)
            else:
                self._q.put_nowait((p, fut))
            self._count("submitted")
        except queue.Full:
            self._count("shed")
            fut.set_exception(ServerSaturated(
                f"submit queue full ({self._q.maxsize} pending)"))
        return fut

    def match(self, pcm: np.ndarray):
        return self.submit(pcm, timeout_ms=None).result()

    def _bucket(self, n: int, cap: int) -> int:
        b = 1
        while b < n:
            b *= 4
        return min(b, cap)

    def warmup(self, example_pcm: np.ndarray) -> None:
        """Compile extraction, rigid-match, and scan buckets up front."""
        p = np.asarray(example_pcm, dtype=np.float32)
        spec1 = None
        b = 1
        while True:
            bb = min(b, self.max_batch)
            pcms = self._jnp.asarray(np.broadcast_to(p, (bb, self.n_samples)))
            specs, prints = self._extract(pcms, self._filters)
            if spec1 is None:
                spec1 = specs[0]
            np.asarray(self.ts.dispatch_batch(prints, pool=self.pool))
            if b >= self.max_batch:
                break
            b *= 4
        b = 1
        while True:
            bb = self._bucket(b, self.scan_batch)
            specs = self._jnp.stack([spec1] * bb)
            stacks = self._scan(specs, self._filters)
            np.asarray(self.ts.dispatch_batch(
                stacks.reshape(-1, self.n_q, 2), pool=self.pool))
            if bb >= self.scan_batch:
                break
            b *= 4

    def close(self) -> None:
        self._stop.set()
        for q in (self._q, self._scan_q):
            try:
                q.put_nowait(None)
            except queue.Full:
                pass
        self._rigid_thread.join()
        self._scan_thread.join()
        self._rank_pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- dispatchers ----------------------------------------------------
    def _collect(self, q, first_block, max_n, max_wait):
        try:
            item = q.get() if first_block else q.get(timeout=max_wait)
        except queue.Empty:
            return []
        if item is None:
            return []
        batch = [item]
        deadline = time.monotonic() + max_wait
        while len(batch) < max_n:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                nxt = q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _acquire_slot(self) -> bool:
        while not self._stop.is_set():
            if self._device_slots.acquire(timeout=0.1):
                return True
        return False

    def _run_rigid(self):
        while not self._stop.is_set():
            batch = self._collect(self._q, True, self.max_batch,
                                  self.max_wait)
            if not batch:
                if self._stop.is_set():
                    break
                continue
            rows = [p for p, _ in batch]
            rows += [rows[-1]] * (self._bucket(len(rows), self.max_batch)
                                  - len(rows))
            if not self._acquire_slot():
                for _, fut in batch:
                    if fut.set_running_or_notify_cancel():
                        fut.set_exception(RuntimeError("server closed"))
                break
            pcms = self._jnp.asarray(np.stack(rows))
            specs, prints = self._extract(pcms, self._filters)
            out_dev = self.ts.dispatch_batch(prints, pool=self.pool)
            self._rank_pool.submit(self._finish_rigid, out_dev, specs,
                                   prints, [f for _, f in batch])
        self._drain(self._q)

    def _finish_rigid(self, out_dev, specs, prints, futs):
        try:
            out = np.asarray(out_dev)
        except Exception as e:
            self._device_slots.release()
            for fut in futs:
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(e)
            return
        self._device_slots.release()
        # Resolve confident answers FIRST: the structural rung's one D2H
        # (the unconfident rows' query prints) must not sit in front of
        # clean traffic's futures.
        unconfident = []
        for b, fut in enumerate(futs):
            try:
                ranked = self._rank(out[b], 1)
                if self._api.rigid_confident(ranked[1], self.n_q,
                                             **self.gate):
                    self._count("confident")
                    if fut.set_running_or_notify_cancel():
                        fut.set_result(self._trim(ranked) + (False,))
                else:
                    unconfident.append((b, ranked, fut))
            except Exception as e:
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(e)
        if not unconfident:
            return
        qprints = None
        if self.structure_gate is not None:
            rows = np.asarray([b for b, _, _ in unconfident])
            try:
                qprints = np.asarray(prints[self._jnp.asarray(rows)])
            except Exception:
                qprints = None     # fall through: everything escalates
        for j, (b, ranked, fut) in enumerate(unconfident):
            kept = False
            if qprints is not None and len(ranked[0]):
                try:
                    db = self.ts.db
                    row = db.index_of(ranked[0][0])
                    kept = self._api.rigid_structured(
                        qprints[j], db.prints[row], int(ranked[2][0]),
                        inlier=self.structure_gate,
                        slope_tol=self.structure_slope_tol,
                        length=int(db.lengths[row]))
                except Exception:
                    kept = False
            if kept:
                self._count("structure_kept")
                if fut.set_running_or_notify_cancel():
                    fut.set_result(self._trim(ranked) + (False,))
            else:
                self._count("escalated")
                self._scan_q.put((specs[b], ranked, fut))

    def _run_scan(self):
        while not self._stop.is_set():
            batch = self._collect(self._scan_q, False, self.scan_batch,
                                  self.scan_wait)
            if not batch:
                continue
            rows = [s for s, _, _ in batch]
            pad = self._bucket(len(rows), self.scan_batch) - len(rows)
            rows += [rows[-1]] * pad
            if not self._acquire_slot():
                for _, _, fut in batch:
                    if fut.set_running_or_notify_cancel():
                        fut.set_exception(RuntimeError("server closed"))
                break
            specs = self._jnp.stack(rows)
            stacks = self._scan(specs, self._filters)
            out_dev = self.ts.dispatch_batch(
                stacks.reshape(-1, self.n_q, 2), pool=self.pool)
            self._rank_pool.submit(self._finish_scan, out_dev,
                                   [(r, f) for _, r, f in batch])
        self._drain(self._scan_q, triple=True)

    def _finish_scan(self, out_dev, items):
        try:
            out = np.asarray(out_dev)
        except Exception as e:
            self._device_slots.release()
            for _, fut in items:
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(e)
            return
        self._device_slots.release()
        v = len(self.hyps)
        # (B*V, 3, K) -> (B, 3, V*K): each query's hypothesis rows rank
        # together (match_batch's pre-scanned regrouping).
        out = np.moveaxis(out.reshape(-1, v, 3, out.shape[-1]), 1, 2)
        out = out.reshape(out.shape[0], 3, -1)
        # Everything in the scan queue already failed the structure gate
        # (gated queries resolve in _finish_rigid), so the unstructured
        # bar applies to the whole batch when configured.
        ov = (self.override_unstructured
              if self.override_unstructured is not None else self.override)
        for b, (rigid, fut) in enumerate(items):
            try:
                ranked = self._rank(out[b], v)
                if self._api.scan_overrides(ranked[1], rigid[1],
                                            override=ov):
                    self._count("overridden")
                    result = ranked
                else:
                    result = rigid
                if fut.set_running_or_notify_cancel():
                    fut.set_result(self._trim(result) + (True,))
            except Exception as e:
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(e)

    def _rank(self, out_b, n_var):
        from .match.scaled import _rank_dedup

        scores, idx, offs = out_b
        real = idx < self.ts.n_real
        k = self.top_k if self.top_k else self.cfg.top_k
        # rank one deeper than requested: the margin gate reads top-2
        return _rank_dedup(scores[real], idx[real], offs[real],
                           self.ts.db.track_ids, max(2, k))

    def _trim(self, ranked):
        k = self.top_k if self.top_k else self.cfg.top_k
        return tuple(x[:k] for x in ranked)

    def _drain(self, q, triple=False):
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                fut = item[2] if triple else item[1]
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(RuntimeError("server closed"))
