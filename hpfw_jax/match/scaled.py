"""Two-stage coarse->fine matcher for catalog-scale databases (1M tracks).

Stage 1 (coarse): majority-vote coarse prints (ops/coarse.py) for every
track are scanned against the coarse query with an int8 +/-1 correlation
on the tensor cores — all tracks, all coarse offsets, exact int32
arithmetic. Cost shrinks by stride^2 vs the full scan.

Stage 2 (fine, exact): the top `pool` tracks by coarse peak are rescanned
with the exact XOR+popcount scoring, restricted to a +/-fine_window offset
band around each coarse peak. Scores returned are EXACT Hamming similarities
(identical semantics to match/matcher.py on the evaluated offsets).

The two-stage result is exact-on-pool: if the coarse stage ranks the true
track into the pool (measured by the robustness eval, BASELINE config 5),
its reported score/offset equals the exhaustive scan's. With a mesh, the
same program runs per shard, each pool is chosen catalog-wide from
all-gathered shard top-k lists, and the candidates merge with one more
all-gather, so a 1M-track catalog splits into per-device shards scanned in
parallel (SURVEY.md §3.3 rebuild) and returns the one-device result.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import coarse as coarse_ops
from ..parallel.mesh import DB_AXIS
from .stretch import print_variants, stretch_grid


def _fine_rescan(queries, prints, lengths, cand, starts, *, n_fine):
    """Exact masked scores for offsets starts .. starts + n_fine - 1.

    queries (B, N, 2) uint32; prints (T, L, 2) uint32; lengths (T,);
    cand / starts (B, K) int32 candidate tracks and band starts (clamped by
    the caller to [0, L - span]). Only the band is gathered, with 2-D
    (track, position) indices — no whole rows, no flat offsets that could
    overflow int32 at catalog scale. Returns (scores (B, K), offsets
    (B, K)): the best exact similarity in the band, first offset on ties,
    -1 (at the band start) where no offset is valid.
    """
    n = queries.shape[1]
    f = jnp.arange(n_fine, dtype=jnp.int32)
    pos = (starts[..., None, None] + f[:, None]
           + jnp.arange(n, dtype=jnp.int32)[None, :])         # (B, K, F, N)
    win = prints[cand[..., None, None], pos]                    # (B, K, F, N, 2)
    x = jnp.bitwise_xor(win, queries[:, None, None])
    sim = 64 - jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
    length = lengths[cand][..., None]                           # (B, K, 1)
    sim = jnp.where(pos < length[..., None], sim, 0)
    score = jnp.sum(sim, axis=-1)                               # (B, K, F)
    o = starts[..., None] + f
    score = jnp.where(o <= jnp.maximum(length - n, 0), score, -1)
    best = jnp.max(score, axis=-1)
    first = jnp.min(jnp.where(score == best[..., None], o, jnp.int32(2 ** 30)),
                    axis=-1)
    return best, first


_POOL_ROWS = 64


def _pool_candidates(best_corr, pool: int):
    """EXACT top-`pool` track indices (int32), best first, lower index
    first on ties.

    Exact lax.top_k (not approx_max_k): exact pooling is what the module
    docstring's exact-on-pool guarantee rests on. At catalog sizes the
    selection runs TWO-LEVEL — per-row top-k over a (64, T/64) reshape,
    then top-k of the 64k survivors — which returns the identical
    candidate list: any global top-k element is a top-k element of its
    row, rows partition the index space in ascending order, and lax.top_k
    breaks ties toward lower indices at both levels."""
    t = best_corr.shape[0]
    k = max(1, min(pool, t))
    if t % _POOL_ROWS == 0 and t // _POOL_ROWS >= k and t >= 2 * _POOL_ROWS * k:
        cols = t // _POOL_ROWS
        vals, idx = jax.lax.top_k(best_corr.reshape(_POOL_ROWS, cols), k)
        gidx = idx.astype(jnp.int32) + (
            jnp.arange(_POOL_ROWS, dtype=jnp.int32) * cols)[:, None]
        _, i2 = jax.lax.top_k(vals.reshape(-1), k)
        return jnp.take(gidx.reshape(-1), i2)
    return jax.lax.top_k(best_corr, k)[1].astype(jnp.int32)


def _rank_dedup(scores, idx, offs, track_ids, top_k, aux=None):
    """Host ranking: desc score, asc index, duplicates dropped. aux: an
    optional per-candidate array returned ranked alongside (e.g. tempo-
    variant provenance)."""
    order = np.lexsort((idx, -scores))
    seen = set()
    keep = []
    for i in order:
        if int(idx[i]) not in seen:
            seen.add(int(idx[i]))
            keep.append(i)
        if len(keep) == top_k:
            break
    keep = np.array(keep, dtype=np.int64)
    out = ([track_ids[i] for i in idx[keep]], scores[keep], offs[keep])
    return out if aux is None else out + (aux[keep],)


class TwoStageDB:
    """Catalog-scale database: packed prints + int8 coarse prints on device.

    mesh=None keeps everything on the default device; with a mesh, every
    array shards over tracks and matching runs per shard with catalog-wide
    pools, so results do not depend on the mesh size (`pool` and
    `prefilter` count candidates of the whole catalog). One program serves
    every dispatch form —
    single, batched, phased and the two-pass prefilter — as a batch of B
    equal-length queries (a single query is B = 1), so a match_batch row
    is the match() of its query by construction. Every coarse sweep is
    XLA's int8 GEMM (ops/coarse.coarse_best); the fine rescan gathers only
    each candidate's band.
    """

    _CACHE_VERSION = 2

    def __init__(self, db, *, stride: int | None = None, mesh: Mesh | None = None,
                 coarse_kind: str | None = None,
                 coarse_channels: int | None = None,
                 keep_host: bool = False,
                 query_phases: int | None = None,
                 prefilter: int | None = None,
                 prefilter_phases: int | None = None,
                 prefilter_channels: int | None = None):
        self.db = db
        self._host_state = None
        cfg = db.cfg
        self.stride = stride if stride is not None else cfg.db_downsample
        self.coarse_kind = (coarse_kind if coarse_kind is not None
                            else cfg.coarse_kind)
        self.coarse_channels = (coarse_channels if coarse_channels is not None
                                else cfg.coarse_channels)
        self.query_phases = (query_phases if query_phases is not None
                             else cfg.coarse_query_phases)
        self.prefilter = (prefilter if prefilter is not None
                          else cfg.coarse_prefilter)
        self.prefilter_phases = (
            prefilter_phases if prefilter_phases is not None
            else cfg.coarse_prefilter_phases)
        pc = (prefilter_channels if prefilter_channels is not None
              else cfg.coarse_prefilter_channels)
        self.prefilter_channels = pc if pc else self.coarse_channels
        if self.prefilter_channels > self.coarse_channels:
            raise ValueError("prefilter_channels must be <= coarse_channels")
        if self.stride % self.query_phases:
            raise ValueError("query_phases must divide the coarse stride")
        if self.prefilter_phases > 1 and self.stride % self.prefilter_phases:
            raise ValueError("prefilter_phases must divide the coarse stride")
        self.mesh = mesh
        prints = np.asarray(db.prints, np.uint32)
        lengths = np.asarray(db.lengths, np.int32)
        t = prints.shape[0]
        self.n_real = t
        # Whole tracks per mesh shard; padded tracks are all-zero, score 0
        # and fall to the n_real cut.
        n_dev = mesh.devices.size if mesh is not None else 1
        t_pad = -(-t // n_dev) * n_dev
        if t_pad != t:
            prints = np.concatenate(
                [prints, np.zeros((t_pad - t,) + prints.shape[1:], prints.dtype)])
            lengths = np.concatenate([lengths, np.zeros(t_pad - t, lengths.dtype)])
        if mesh is None:
            arrays = self._derive(prints, lengths, None)
        else:
            # Each shard derives on its own device from its own host rows:
            # no device ever holds more than its shard.
            shard = NamedSharding(mesh, P(DB_AXIS))
            rows = shard.devices_indices_map((t_pad,))
            parts = {d: self._derive(prints[r[0]], lengths[r[0]], d)
                     for d, r in rows.items()}
            arrays = tuple(
                jax.make_array_from_single_device_arrays(
                    (t_pad,) + parts[next(iter(parts))][k].shape[1:], shard,
                    [parts[d][k] for d in rows])
                for k in range(4))
        self.prints, self.lengths, self.db_c, self.db_c1 = arrays
        if keep_host:
            # Host copies so save() need not pull the arrays back.
            self._host_state = {"prints": prints, "lengths": lengths,
                                "coarse": np.asarray(self.db_c)}

    def _derive(self, prints, lengths, device):
        """Upload one shard's rows and derive its coarse DBs on `device`.

        Coarse prints are derived in track chunks: the unpack intermediate
        is ~256x the packed size, so a whole-catalog unpack would not fit.
        Windows past each track's length are zeroed (the majority of
        all-zero padding prints is -1, which would correlate).
        Returns (prints, lengths, coarse (T, Lc, C), pass-1 coarse).
        """
        stride, c = self.stride, self.coarse_channels
        kind = self.coarse_kind
        prints_dev = jax.device_put(prints, device)
        lengths_dev = jax.device_put(lengths, device)
        t, l = prints.shape[:2]
        chunk = max(1, min(t, 134_217_728 // max(l * 64, 1)))
        parts = [_coarse_rows(prints_dev[i:i + chunk],
                              lengths_dev[i:i + chunk], stride=stride,
                              kind=kind, channels=c)
                 for i in range(0, t, chunk)]
        coarse = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        del parts
        coarse1 = coarse
        if self.prefilter_channels < c:
            # Channel-subset pass-1 DB: channels are PCA-ordered, so the C1
            # prefix is each window's most informative bits, and the pass-1
            # sweep reads C1/C of the bytes.
            coarse1 = coarse[..., : self.prefilter_channels]
        return prints_dev, lengths_dev, coarse, coarse1

    # -- derived-state persistence (SURVEY.md §5 checkpoint/resume) --------
    #
    # The reference memory-maps its serialized catalog cache; the equivalent
    # here is the DERIVED device state — packed prints, the int8 coarse DB,
    # padded lengths — written as raw .npy binaries (mmap-able) plus a JSON
    # manifest. load() then goes disk -> (mmap) -> device with no derivation
    # pass (the pass-1 channel subset is a slice of the coarse DB).

    def save(self, path: str) -> None:
        """Write the derived two-stage state as flat binaries + manifest."""
        import json
        import os

        os.makedirs(path, exist_ok=True)
        hs = self._host_state or {}
        manifest = {
            "format_version": self._CACHE_VERSION,
            "stride": int(self.stride),
            "coarse_kind": self.coarse_kind,
            "coarse_channels": int(self.coarse_channels),
            "prefilter_channels": int(self.prefilter_channels),
            "n_real": int(self.n_real),
            "mesh_size": int(self.mesh.devices.size) if self.mesh is not None else 0,
            "config_json": self.db.cfg.to_json(),
        }

        def dump(name, arr):
            np.save(os.path.join(path, name + ".npy"), np.asarray(arr))

        dump("prints", hs.get("prints", self.prints))
        dump("coarse", hs.get("coarse", self.db_c))
        dump("lengths", hs.get("lengths", self.lengths))
        dump("filters", self.db.filters)
        dump("track_ids", np.array(self.db.track_ids))
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        self._host_state = None

    @classmethod
    def load(cls, path: str, *, mesh: Mesh | None = None, mmap: bool = True,
             install_cache: bool = True) -> "TwoStageDB":
        """Reconstruct a TwoStageDB from save() output without re-deriving.

        A cache written without a mesh loads without one, a mesh-built
        cache needs a mesh of the same size (the track padding differs).
        Caches of an older layout are refused: rebuild them.

        install_cache=True additionally installs any compile-cache entries
        bundled by bundle_compile_cache() into this process's persistent
        cache (no-op on runtime mismatch or if none were shipped).
        """
        import json
        import os

        if install_cache:
            from ..utils import cache as cache_util

            try:
                n = cache_util.install_bundle(path)
                if n:
                    import logging

                    logging.getLogger(__name__).info(
                        "installed %d bundled compile-cache entries", n)
            except Exception:
                pass  # the bundle is an optimization only

        from ..api import FingerprintDB

        with open(os.path.join(path, "manifest.json")) as f:
            m = json.load(f)
        if m["format_version"] != cls._CACHE_VERSION:
            raise ValueError(
                f"two-stage cache format {m['format_version']} is not this "
                f"version's layout ({cls._CACHE_VERSION}); rebuild the cache")
        mesh_size = mesh.devices.size if mesh is not None else 0
        if mesh_size != m["mesh_size"]:
            raise ValueError(
                f"cache was built for mesh size {m['mesh_size']}, "
                f"loading with mesh size {mesh_size}; rebuild the cache for "
                "this layout")
        mm = "r" if mmap else None

        def grab(name):
            return np.load(os.path.join(path, name + ".npy"), mmap_mode=mm)

        from ..config import HpfwConfig

        cfg = HpfwConfig.from_json(m["config_json"])
        lengths = grab("lengths")
        n_real = m["n_real"]
        db = FingerprintDB(cfg, np.load(os.path.join(path, "filters.npy")),
                           [str(t) for t in np.load(os.path.join(path, "track_ids.npy"))],
                           np.zeros((n_real, 0, 2), np.uint32),
                           np.asarray(lengths[:n_real]))
        self = cls.__new__(cls)
        self.db = db
        self._host_state = None
        self.stride = m["stride"]
        self.coarse_kind = m["coarse_kind"]
        self.coarse_channels = m["coarse_channels"]
        self.prefilter_channels = m["prefilter_channels"]
        self.n_real = n_real
        self.query_phases = cfg.coarse_query_phases
        self.prefilter = cfg.coarse_prefilter
        self.prefilter_phases = cfg.coarse_prefilter_phases
        self.mesh = mesh
        put = ((lambda a: jax.device_put(a, NamedSharding(mesh, P(DB_AXIS))))
               if mesh is not None else jnp.asarray)
        self.lengths = put(np.asarray(lengths))
        self.prints = put(grab("prints"))
        self.db_c = put(grab("coarse"))
        self.db_c1 = (self.db_c[..., : self.prefilter_channels]
                      if self.prefilter_channels < self.coarse_channels
                      else self.db_c)
        return self

    def warmup(self, query_lens, *, batch_sizes=(), pool=None,
               fine_window=None) -> None:
        """Compile the serving programs for the given query shapes now.

        With the persistent XLA compile cache enabled (utils/cache.py),
        running this once at DB-build time seeds the cache so a later
        serving process pays I/O, not compilation, for its first query.
        """
        for n in query_lens:
            q = jnp.zeros((int(n), 2), jnp.uint32)
            self.dispatch(q, pool=pool, fine_window=fine_window
                          ).block_until_ready()
            for b in batch_sizes:
                qs = jnp.zeros((int(b), int(n), 2), jnp.uint32)
                self.dispatch_batch(qs, pool=pool, fine_window=fine_window
                                    ).block_until_ready()

    def bundle_compile_cache(self, path: str, query_lens, *, batch_sizes=(),
                             pool=None, fine_window=None) -> int:
        """warmup() + ship the resulting compile-cache entries WITH the DB.

        Runs warmup for the given serving shapes while recording which
        persistent-cache entries the programs read or write, then copies
        exactly those into <path>/xla_cache/<runtime_key>/ (path is the
        save() artifact directory). A deployment machine that has never
        compiled then loads them via TwoStageDB.load(..., install_cache=True);
        a jax/backend mismatch falls back to normal compilation. Returns
        entries bundled.

        Call it in the same process ONLY for shapes not already dispatched
        (in-memory jit hits bypass the persistent cache and can't be
        recorded) — the CLI build-cache flow satisfies this by construction.
        """
        from ..utils import cache as cache_util

        keys: set = set()
        with cache_util.record_cache_keys(keys):
            self.warmup(query_lens, batch_sizes=batch_sizes, pool=pool,
                        fine_window=fine_window)
        return cache_util.bundle_entries(path, keys)

    def _check_query_len(self, n: int) -> None:
        """The two-stage scan needs at least one coarse alignment; queries
        longer than every DB track have no catalog-scale use (the dense
        api.match path implements the oracle's truncated-overlap semantics
        if that's really wanted)."""
        lc = self.db_c.shape[1]
        if n // self.stride > lc:
            raise ValueError(
                f"query ({n} prints, {n // self.stride} coarse) is longer than "
                f"every DB track ({lc} coarse windows); two-stage matching "
                "needs query <= padded DB length — use api.match for "
                "truncated-overlap semantics")

    def _statics(self, pool, fine_window, phases, prefilter, phases1):
        """Resolve the per-dispatch knobs into the program's static args."""
        cfg = self.db.cfg
        ph = phases if phases is not None else self.query_phases
        pf = prefilter if prefilter is not None else self.prefilter
        p1 = phases1 if phases1 is not None else self.prefilter_phases
        if pf and ph > 1:
            if self.stride % p1:
                raise ValueError("phases1 must divide the coarse stride")
            pf = min(int(pf), int(self.lengths.shape[0]))
        else:
            pf, p1 = 0, 1
        return dict(
            stride=self.stride,
            pool=int(pool if pool is not None else cfg.fine_candidates),
            fine_window=int(fine_window if fine_window is not None
                            else self.stride),
            coarse_kind=self.coarse_kind,
            coarse_channels=self.coarse_channels,
            phases=int(ph), phases1=int(p1), prefilter=pf,
            # The pass-1 channel count only matters with a prefilter; pin
            # it otherwise so toggling prefilter off doesn't fork the jit
            # cache key.
            channels1=self.prefilter_channels if pf else self.coarse_channels)

    def dispatch_batch(self, queries_dev, *, pool: int | None = None,
                       fine_window: int | None = None,
                       phases: int | None = None,
                       prefilter: int | None = None,
                       phases1: int | None = None):
        """Queue one batched match ((B, N, 2) device array) without a host
        sync; returns the (B, 3, K) stacked [scores, track idx, offsets]
        device array. The exact program match/match_batch run — benchmarks
        queue it directly."""
        st = self._statics(pool, fine_window, phases, prefilter, phases1)
        args = (queries_dev, self.prints, self.lengths, self.db_c, self.db_c1)
        if self.mesh is None:
            return _two_stage_jit(*args, **st)
        return _two_stage_sharded_jit(*args, mesh=self.mesh, **st)

    def dispatch(self, query_dev, **kw):
        """dispatch_batch of one (N, 2) query: the (3, K) device array."""
        return self.dispatch_batch(query_dev[None], **kw)[0]

    def _stretch_factors(self, span, step):
        """Resolve the tempo-scan grid for a dispatch (None = config)."""
        cfg = self.db.cfg
        span = span if span is not None else cfg.stretch_span
        step = step if step is not None else cfg.stretch_step
        return stretch_grid(span, step) if span else None

    def match(self, query_prints: np.ndarray, *, top_k: int | None = None,
              pool: int | None = None, fine_window: int | None = None,
              phases: int | None = None, prefilter: int | None = None,
              phases1: int | None = None,
              stretch_span: float | None = None,
              stretch_step: float | None = None,
              return_variant: bool = False,
              calibrate: bool = False):
        cfg = self.db.cfg
        top_k = top_k if top_k is not None else cfg.top_k
        qh = np.asarray(query_prints, dtype=np.uint32)
        variants = None
        if qh.ndim == 3:
            # Pre-scanned (V, N, 2) tempo-variant stack (spec-level scan,
            # api.fingerprint_scan_batch) — rank the given rows together;
            # the config's print-level scan is superseded for this call.
            variants = qh
            qh = qh[qh.shape[0] // 2]      # identity row (grid center)
        self._check_query_len(qh.shape[0])
        factors = self._stretch_factors(stretch_span, stretch_step)
        if variants is None and factors is not None:
            # Tempo scan (live renditions — match/stretch.py): V re-timed
            # print variants each run the full two-stage program; candidates
            # from every tempo hypothesis rank together below, so the best-
            # scoring hypothesis wins per track.
            variants = print_variants(qh, factors)[0]
        if variants is not None:
            # Dispatches queue before the first materialization.
            outs = [self.dispatch(jnp.asarray(v), pool=pool,
                                  fine_window=fine_window, phases=phases,
                                  prefilter=prefilter, phases1=phases1)
                    for v in variants]
            host = [np.asarray(o) for o in outs]
            scores = np.concatenate([o[0] for o in host])
            idx = np.concatenate([o[1] for o in host])
            offs = np.concatenate([o[2] for o in host])
            if calibrate:
                # Per-hypothesis background subtraction: a re-timed row's
                # correlations shift systematically (interpolation blur), so
                # ranking raw scores across hypotheses lets a blurrier row's
                # imposters outrank the truth. The row's candidate-pool
                # median is an imposter-background estimate (the truth is
                # one track in a ~pool-sized sample); rank by the EXCESS
                # over it. Scores returned are the calibrated ones.
                scores = np.concatenate(
                    [o[0] - np.median(o[0][o[1] < self.n_real])
                     for o in host])
            # Variant provenance: candidate j came from hypothesis j // P
            # (per-variant dispatches concatenate along the candidate axis).
            var = np.repeat(np.arange(len(variants), dtype=np.int32),
                            scores.shape[0] // len(variants))
        else:
            # One device dispatch, one host materialization: the query's
            # coarse derivation runs inside the same jit and the three
            # result vectors come back stacked.
            out = self.dispatch(jnp.asarray(qh), pool=pool,
                                fine_window=fine_window,
                                phases=phases, prefilter=prefilter,
                                phases1=phases1)
            scores, idx, offs = np.asarray(out)
            var = np.zeros(scores.shape[0], dtype=np.int32)
        real = idx < self.n_real
        scores, idx, offs, var = scores[real], idx[real], offs[real], var[real]
        return _rank_dedup(scores, idx, offs, self.db.track_ids, top_k,
                           aux=var if return_variant else None)

    def match_batch(self, query_batch: np.ndarray, *, top_k: int | None = None,
                    pool: int | None = None, fine_window: int | None = None,
                    phases: int | None = None, prefilter: int | None = None,
                    phases1: int | None = None,
                    stretch_span: float | None = None,
                    stretch_step: float | None = None,
                    calibrate: bool = False):
        """Match B equal-length queries in one device dispatch.

        The coarse database streams from HBM once for the whole batch, so
        per-query cost approaches pure compute — the serving-throughput path.
        Returns a list of B (track_ids, scores, offsets) tuples, each
        identical to what match() returns for that query.

        """
        cfg = self.db.cfg
        top_k = top_k if top_k is not None else cfg.top_k
        pool = pool if pool is not None else cfg.fine_candidates
        fw = fine_window if fine_window is not None else self.stride
        qh = np.asarray(query_batch, dtype=np.uint32)
        n_var = 1
        if qh.ndim == 4:
            # Pre-scanned (B, V, N, 2) tempo-variant stacks (spec-level
            # scan, api.fingerprint_scan_batch): flatten to B*V rows; each
            # query's V rows rank together below. Supersedes the config's
            # print-level scan for this call.
            n_var = qh.shape[1]
            qh = qh.reshape(-1, qh.shape[2], 2)
        self._check_query_len(qh.shape[1])
        factors = (self._stretch_factors(stretch_span, stretch_step)
                   if n_var == 1 else None)
        if factors is not None:
            # Tempo scan: the (B, V, N, 2) variant stack flattens into one
            # B*V-row batched dispatch (same compiled program, bigger B);
            # each query's V hypothesis rows rank together below.
            n_var = len(factors)
            qh = print_variants(qh, factors).reshape(-1, qh.shape[1], 2)
        out = np.asarray(self.dispatch_batch(jnp.asarray(qh), pool=pool,
                                             fine_window=fw,
                                             phases=phases,
                                             prefilter=prefilter,
                                             phases1=phases1))
        cal = None
        if n_var > 1:
            # (B*V, 3, K) -> (B, 3, V*K): variant rows concatenate along the
            # candidate axis so the per-query ranking sees every hypothesis.
            out = out.reshape(-1, n_var, 3, out.shape[-1])
            if calibrate:
                # Per-hypothesis background subtraction (see match());
                # kept separate so idx/offs stay integer. Variant-major
                # order matches the moveaxis reshape below.
                cal = out[:, :, 0].astype(np.float64)
                cal -= np.nanmedian(
                    np.where(out[:, :, 1] < self.n_real, cal, np.nan),
                    axis=-1, keepdims=True)
                cal = cal.reshape(cal.shape[0], -1)
            out = np.moveaxis(out, 1, 2).reshape(out.shape[0], 3, -1)
        results = []
        for b in range(out.shape[0]):
            scores, idx, offs = out[b]
            if cal is not None:
                scores = cal[b]
            real = idx < self.n_real
            scores, idx, offs = scores[real], idx[real], offs[real]
            results.append(_rank_dedup(scores, idx, offs, self.db.track_ids, top_k))
        return results


def _phase_variants(query, *, stride, phases, kind, channels):
    """P phase-shifted coarse views of one query.

    The query's majority-vote windows are anchored to its own first print;
    at true offset o* with r = (-o*) mod stride != 0 every window straddles
    two DB windows and the correlation peak collapses (pre-GPU run, see git
    history: top-1 0.78 at r~0 vs 0.55 at r~stride/2 on a 250k real-audio
    catalog). Variant p drops the first p*stride/P prints so one of the P
    variants is within stride/(2P) of DB window phase. Returns
    ((P, Nc, C) int8, (P,) r).
    """
    step = stride // phases
    n = query.shape[0]
    nc = (n - (stride - step)) // stride
    qs = [coarse_ops.coarse_pm1(
        jax.lax.slice_in_dim(query, p * step, p * step + nc * stride, axis=0),
        stride, kind=kind, channels=channels) for p in range(phases)]
    return (jnp.stack(qs),
            jnp.arange(phases, dtype=jnp.int32) * step)


@functools.partial(jax.jit, static_argnames=("stride", "kind", "channels"))
def _coarse_rows(prints, lengths, *, stride, kind, channels):
    """(T, L, 2) packed prints -> (T, Lc, C) int8 coarse rows, zero past
    each track's last complete window."""
    coarse = coarse_ops.coarse_pm1(prints, stride, kind=kind,
                                   channels=channels)
    ok = jnp.arange(coarse.shape[1])[None, :] < (lengths // stride)[:, None]
    return jnp.where(ok[..., None], coarse, 0).astype(jnp.int8)


def _coarse_best_phased(queries, db_c, *, stride, phases, coarse_kind,
                        coarse_channels):
    """Phase-max coarse stage for B queries in ONE sweep (the B*P variant
    rows ride the same DB pass). Returns ((B, T) best, (B, T) center of
    query print 0)."""
    b = queries.shape[0]
    qcs = jax.vmap(lambda q: _phase_variants(
        q, stride=stride, phases=phases, kind=coarse_kind,
        channels=coarse_channels)[0])(queries)               # (B, P, Nc, C)
    best, idx = coarse_ops.coarse_best(
        qcs.reshape((b * phases,) + qcs.shape[2:]), db_c)
    t = best.shape[1]
    best = best.reshape(b, phases, t)
    idx = idx.reshape(b, phases, t)
    p_star = jnp.argmax(best, axis=1)                        # (B, T)
    idx_sel = jnp.take_along_axis(idx, p_star[:, None], axis=1)[:, 0]
    centers = idx_sel * stride - p_star * (stride // phases)
    return jnp.max(best, axis=1), centers


_NEG = -(2 ** 31)          # pooling score of a slot that must rank last
_FOREIGN = 2 ** 31 - 1     # track index of a candidate another shard owns


def _top_pool(scores, k, axis, ids=None):
    """Top-k candidates of the whole catalog from one shard's scores.

    scores (B, n) int32; ids (B, n) their global track indices, ascending
    along n (None: this shard's own tracks in order). Returns (pos, own),
    both (B, min(k, n)): positions into n of this shard's top entries
    (best first, lower index first on ties) and whether each is in the
    catalog-wide top-k under the same order. Without a mesh axis the shard
    is the catalog and every entry is owned. Under one, each catalog-wide
    top-k member is among its own shard's top-k, so the owned entries of
    all shards are exactly the one-device pool, whatever the mesh size.
    """
    pos = jax.vmap(lambda row: _pool_candidates(row, k))(scores)
    if axis is None:
        return pos, jnp.ones(pos.shape, bool)
    vals = jnp.take_along_axis(scores, pos, axis=1)
    if ids is None:
        shard = jax.lax.axis_index(axis).astype(jnp.int32)
        g = pos + shard * scores.shape[1]
    else:
        g = jnp.take_along_axis(ids, pos, axis=1)
    all_v = jax.lax.all_gather(vals, axis, axis=1, tiled=True)
    all_g = jax.lax.all_gather(g, axis, axis=1, tiled=True)
    # Shard order puts equal values in ascending global index, so top_k's
    # lower-position tie-break is the one-device tie-break; the k-th entry
    # is the threshold of the catalog-wide pool.
    _, sel = jax.lax.top_k(all_v, min(k, all_v.shape[1]))
    v_k = jnp.take_along_axis(all_v, sel[:, -1:], axis=1)
    g_k = jnp.take_along_axis(all_g, sel[:, -1:], axis=1)
    return pos, (vals > v_k) | ((vals == v_k) & (g <= g_k))


def _coarse_pool_twopass(queries, lengths, db_c, db_c1, *, stride, phases,
                         phases1, prefilter, pool, coarse_kind,
                         coarse_channels, channels1, axis):
    """Two-pass phased coarse stage: a cheap pass-1 sweep of the WHOLE
    catalog (phases1 variant rows on the channels1-channel DB) pools the
    top `prefilter` tracks per query; pass 2 rescans only those gathered
    rows with the full `phases` grid at full channel count. The one-pass
    phased sweep spends `phases` variant rows on every track; this spends
    them on `prefilter` << T tracks.

    Returns (cand (B, K) local track indices, centers (B, K), own (B, K)).
    """
    if phases1 > 1:
        best1, _ = _coarse_best_phased(
            queries, db_c1, stride=stride, phases=phases1,
            coarse_kind=coarse_kind, coarse_channels=channels1)
    else:
        qc = jax.vmap(lambda q: coarse_ops.coarse_pm1(
            q, stride, kind=coarse_kind, channels=channels1))(queries)
        best1, _ = coarse_ops.coarse_best(qc, db_c1)
    best1 = jnp.where(lengths > 0, best1, _NEG)
    pos_m, own_m = _top_pool(best1, prefilter, axis)
    # Sorted subset: within-subset index order == global order, so pass-2
    # pooling keeps the exact tie-break (lower global index) and prefilter
    # >= T reproduces the one-pass phased result exactly (tested).
    order = jnp.argsort(pos_m, axis=1)
    cand_m = jnp.take_along_axis(pos_m, order, axis=1)           # (B, M)
    own_m = jnp.take_along_axis(own_m, order, axis=1)
    qcs = jax.vmap(lambda q: _phase_variants(
        q, stride=stride, phases=phases, kind=coarse_kind,
        channels=coarse_channels)[0])(queries)               # (B, P, Nc, C)
    best2, idx2 = jax.vmap(coarse_ops.coarse_best)(qcs, db_c[cand_m])
    p_star = jnp.argmax(best2, axis=1)                       # (B, M)
    idx_sel = jnp.take_along_axis(idx2, p_star[:, None], axis=1)[:, 0]
    centers = idx_sel * stride - p_star * (stride // phases)
    best2 = jnp.where(own_m, jnp.max(best2, axis=1), _NEG)
    ids = None
    if axis is not None:
        ids = cand_m + (jax.lax.axis_index(axis).astype(jnp.int32)
                        * db_c.shape[0])
    pos_k, own_k = _top_pool(best2, pool, axis, ids)             # (B, K)
    return (jnp.take_along_axis(cand_m, pos_k, axis=1),
            jnp.take_along_axis(centers, pos_k, axis=1),
            own_k & jnp.take_along_axis(own_m, pos_k, axis=1))


def _match_local(queries, prints, lengths, db_c, db_c1, *, stride, pool,
                 fine_window, coarse_kind, coarse_channels, phases, phases1,
                 prefilter, channels1, axis=None):
    """B equal-length queries against one shard: coarse pool, then the
    exact fine rescan of each candidate's band. Returns the (B, 3, K)
    [scores, global track idx, offsets] stack; under a mesh axis, slots
    whose track another shard owns carry idx _FOREIGN. Empty tracks
    (length 0, the mesh's padding among them) pool last."""
    if phases > 1 and prefilter:
        cand, centers, own = _coarse_pool_twopass(
            queries, lengths, db_c, db_c1, stride=stride, phases=phases,
            phases1=phases1, prefilter=prefilter, pool=pool,
            coarse_kind=coarse_kind, coarse_channels=coarse_channels,
            channels1=channels1, axis=axis)
    else:
        if phases > 1:
            best, centers_all = _coarse_best_phased(
                queries, db_c, stride=stride, phases=phases,
                coarse_kind=coarse_kind, coarse_channels=coarse_channels)
        else:
            qc = jax.vmap(lambda q: coarse_ops.coarse_pm1(
                q, stride, kind=coarse_kind, channels=coarse_channels))(queries)
            best, best_a = coarse_ops.coarse_best(qc, db_c)
            centers_all = best_a * stride
        best = jnp.where(lengths > 0, best, _NEG)
        cand, own = _top_pool(best, pool, axis)
        centers = jnp.take_along_axis(centers_all, cand, axis=1)
    n_fine = 2 * fine_window + 1
    span = queries.shape[1] + n_fine - 1
    starts = jnp.clip(centers - fine_window, 0,
                      max(prints.shape[1] - span, 0))
    s, o = _fine_rescan(queries, prints, lengths, cand, starts,
                        n_fine=n_fine)
    idx = cand
    if axis is not None:
        shard = jax.lax.axis_index(axis).astype(jnp.int32)
        idx = jnp.where(own, cand + shard * prints.shape[0], _FOREIGN)
    return jnp.stack([s, idx, o], axis=1)


_STATICS = ("stride", "pool", "fine_window", "coarse_kind", "coarse_channels",
            "phases", "phases1", "prefilter", "channels1")

_two_stage_jit = jax.jit(_match_local, static_argnames=_STATICS)


@functools.partial(jax.jit, static_argnames=("mesh",) + _STATICS)
def _two_stage_sharded_jit(queries, prints, lengths, db_c, db_c1, *, mesh,
                           stride, pool, fine_window, coarse_kind,
                           coarse_channels, phases, phases1, prefilter,
                           channels1):
    """Per shard: the same program on its own tracks, its pools chosen
    catalog-wide; the (B, 3, K) blocks merge with one all-gather along K,
    and the host drops the _FOREIGN slots. The result is the one-device
    result."""

    def shard_fn(qs, p, ln, dc, dc1):
        out = _match_local(
            qs, p, ln, dc, dc1, stride=stride, pool=pool,
            fine_window=fine_window, coarse_kind=coarse_kind,
            coarse_channels=coarse_channels, phases=phases, phases1=phases1,
            prefilter=prefilter, channels1=channels1, axis=DB_AXIS)
        return jax.lax.all_gather(out, DB_AXIS, tiled=True, axis=2)

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(),) + (P(DB_AXIS),) * 4,
        out_specs=P(),
        check_vma=False,
    )(queries, prints, lengths, db_c, db_c1)
