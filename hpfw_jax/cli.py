"""Command-line interface — the rebuild of the reference's example drivers
(SURVEY.md §2.1 row 9: build-DB and identify-query binaries).

    python -m hpfw_jax.cli demo                    # end-to-end on synth audio
    python -m hpfw_jax.cli learn SONGS... -o filters.npz
    python -m hpfw_jax.cli build-db SONGS... --filters filters.npz -o db.npz
    python -m hpfw_jax.cli fingerprint SONG.wav --filters filters.npz
    python -m hpfw_jax.cli match QUERY.wav --db db.npz [--top-k 5] [--scaled]
    python -m hpfw_jax.cli build-cache --db db.npz -o cache/   # derived state
    python -m hpfw_jax.cli match QUERY.wav --cache cache/      # warm start
    python -m hpfw_jax.cli stream AUDIO.wav --db db.npz        # live-ID sim
    python -m hpfw_jax.cli build-artist-db DIR... -o adb.npz   # dir per artist
    python -m hpfw_jax.cli match-artist QUERY.wav --db adb.npz [--artist NAME]
    python -m hpfw_jax.cli artist-demo             # known-artist end-to-end
    python -m hpfw_jax.cli selfcheck               # oracle-vs-device parity
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load_filters(path):
    z = np.load(path)
    return z["filters"]


def cmd_demo(args):
    from . import api
    from .config import HpfwConfig
    from .io import synth

    cfg = HpfwConfig() if not args.small else HpfwConfig(
        frame_len=2048, fmin=380.0, n_bins=73, hop=256, context_w=8, delta_lag=4)
    print(f"synthesizing {args.tracks} tracks x {args.seconds}s ...")
    catalog = {f"track{i:02d}": t
               for i, t in enumerate(synth.synth_catalog(args.tracks, args.seconds, cfg))}
    print("learning filters ...")
    filters = api.learn_filters(list(catalog.values())[: max(3, args.tracks // 4)], cfg)
    print("building database ...")
    db = api.build_db(catalog, filters, cfg)
    true_id = f"track{args.tracks - 2:02d}"
    q = synth.make_query(catalog[true_id], 1.0, min(5.0, args.seconds / 2), cfg,
                         noise_db=-12.0, seed=1)
    t0 = time.time()
    ids, scores, offs = api.match(api.fingerprint(q, filters, cfg), db, top_k=3)
    dt = (time.time() - t0) * 1e3
    print(f"query: noisy excerpt of {true_id}")
    for i, (tid, s, o) in enumerate(zip(ids, scores, offs)):
        print(f"  #{i + 1} {tid}  score={int(s)}  offset={int(o)}")
    print(f"match time: {dt:.1f} ms   ({'OK' if ids[0] == true_id else 'MISMATCH'})")
    return 0 if ids[0] == true_id else 1


def cmd_learn(args):
    from . import api
    from .config import HpfwConfig
    from .io.wav import load_wav

    cfg = HpfwConfig.from_json(open(args.config).read()) if args.config else HpfwConfig()
    corpus = []
    for p in args.audio:
        pcm, _ = load_wav(p, cfg)
        corpus.append(pcm)
        print(f"  loaded {p}: {len(pcm) / cfg.sample_rate:.1f}s")
    filters = api.learn_filters(corpus, cfg)
    np.savez_compressed(args.output, filters=filters,
                        config_json=np.frombuffer(cfg.to_json().encode(), np.uint8))
    print(f"wrote {args.output}: filters {filters.shape}")
    return 0


def cmd_build_db(args):
    import os
    import time

    from . import api
    from .config import HpfwConfig

    cfg = HpfwConfig.from_json(open(args.config).read()) if args.config else HpfwConfig()
    filters = _load_filters(args.filters)
    paths = []
    for p in args.audio:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                paths.extend(os.path.join(root, f) for f in sorted(files))
        else:
            paths.append(p)
    t0 = time.time()
    db = api.build_db_from_files(
        paths, filters, cfg, n_threads=args.threads, batch=args.batch,
        progress=lambda done, total: print(f"  {done}/{total} tracks"))
    db.save(args.output)
    dt = time.time() - t0
    print(f"wrote {args.output}: {db.n_tracks} tracks, "
          f"{int(db.lengths.sum())} hashprints in {dt:.1f}s")
    return 0


def cmd_fingerprint(args):
    from . import api, oracle
    from .config import HpfwConfig
    from .io.wav import load_wav

    cfg = HpfwConfig.from_json(open(args.config).read()) if args.config else HpfwConfig()
    filters = _load_filters(args.filters)
    pcm, _ = load_wav(args.audio, cfg)
    if args.cpu:
        from .io import native

        fp = native.fingerprint_cpu(pcm, filters, cfg)
    else:
        fp = api.fingerprint(pcm, filters, cfg)
    if args.output:
        np.savez_compressed(args.output, prints=fp)
        print(f"wrote {args.output}: {fp.shape[0]} hashprints")
    else:
        for h in oracle.packed_to_uint64(fp)[: args.head]:
            print(f"{h:016x}")
        if fp.shape[0] > args.head:
            print(f"... ({fp.shape[0]} hashprints total)")
    return 0


def cmd_match(args):
    from . import api
    from .io.wav import load_wav

    if not args.cache and not args.db:
        print("error: provide --db or --cache", file=sys.stderr)
        return 2
    if args.cache:
        from .match.scaled import TwoStageDB

        ts = TwoStageDB.load(args.cache)
        db = ts.db
    else:
        db = api.FingerprintDB.load(args.db)
        ts = None
    pcm, _ = load_wav(args.query, db.cfg)
    qfp = api.fingerprint(pcm, db.filters, db.cfg)
    t0 = time.time()
    ts_kw = dict(pool=getattr(args, "pool", None),
                 phases=getattr(args, "phases", None),
                 prefilter=getattr(args, "prefilter", None))
    if ts is not None:
        ids, scores, offs = ts.match(qfp, top_k=args.top_k, **ts_kw)
    elif args.scaled:
        from .match.scaled import TwoStageDB

        ids, scores, offs = TwoStageDB(db).match(qfp, top_k=args.top_k,
                                                 **ts_kw)
    else:
        ids, scores, offs = api.match(qfp, db, top_k=args.top_k)
    dt = (time.time() - t0) * 1e3
    fps = db.cfg.frames_per_second
    for i, (tid, s, o) in enumerate(zip(ids, scores, offs)):
        rel = int(s) / max(64 * qfp.shape[0], 1)
        print(f"#{i + 1} {tid}  score={int(s)} ({rel:.0%})  "
              f"offset={int(o)} ({int(o) / fps:.2f}s)")
    print(f"[{dt:.1f} ms, {db.n_tracks} tracks]")
    return 0


def cmd_build_cache(args):
    """Derive + persist the two-stage serving state (mmap-able binaries)."""
    from . import api
    from .match.scaled import TwoStageDB

    db = api.FingerprintDB.load(args.db)
    t0 = time.time()
    ts = TwoStageDB(db, stride=args.stride, coarse_channels=args.channels,
                    prefilter_channels=args.prefilter_channels,
                    keep_host=True)
    print(f"derived two-stage state in {time.time() - t0:.1f}s")
    ts.save(args.output)
    print(f"wrote {args.output} ({db.n_tracks} tracks, stride {ts.stride}, "
          f"C={ts.coarse_channels})")
    if args.warmup_prints:
        batches = tuple(int(x) for x in args.warmup_batches.split(",") if x)
        t0 = time.time()
        n = ts.bundle_compile_cache(args.output, [args.warmup_prints],
                                    batch_sizes=batches)
        print(f"warmed serving compiles for N={args.warmup_prints}, "
              f"batches {batches or '()'} in {time.time() - t0:.1f}s "
              f"({n} compile-cache entries bundled into the artifact; "
              "persistent compile cache seeded)")
    return 0


def cmd_stream(args):
    """Simulate live-song ID: feed a file in 100 ms chunks, print the
    running hypothesis with its confidence as it evolves."""
    from . import api
    from .io.wav import load_wav
    from .streaming.session import StreamingSession

    if not args.cache and not args.db:
        print("error: provide --db or --cache", file=sys.stderr)
        return 2
    if args.cache:
        from .match.scaled import TwoStageDB

        dbobj = TwoStageDB.load(args.cache)
        cfg, filters = dbobj.db.cfg, dbobj.db.filters
    else:
        db = api.FingerprintDB.load(args.db)
        dbobj, cfg, filters = db, db.cfg, db.filters
    pcm, _ = load_wav(args.audio, cfg)
    sess = StreamingSession(dbobj, filters, cfg,
                            query_prints=args.query_prints)
    chunk = cfg.sample_rate // 10
    last = None
    for pos in range(0, len(pcm), chunk):
        best = sess.feed(pcm[pos:pos + chunk])
        if best is not None and (last is None or best.track_id != last):
            print(f"{pos / cfg.sample_rate:6.1f}s  -> {best.track_id}  "
                  f"confidence {best.confidence:.2f}")
            last = best.track_id
    if sess.current_best is None:
        print("no hypothesis (stream too short?)")
        return 1
    b = sess.current_best
    stats = sess.latency_stats()
    print(f"final: {b.track_id}  score={b.score}  offset={b.offset}  "
          f"confidence {b.confidence:.2f}")
    print(f"[match p50 {stats['match_p50_ms']:.1f} ms over "
          f"{stats['n_matches']} windows]")
    return 0


def cmd_pool(args):
    """Simulate concurrent live streams: each audio file becomes one pool
    stream, fed in lockstep 100 ms chunks through one StreamingPool."""
    from . import api
    from .io.wav import load_wav
    from .streaming.pool import StreamingPool

    if not args.cache and not args.db:
        print("error: provide --db or --cache", file=sys.stderr)
        return 2
    if args.cache:
        from .match.scaled import TwoStageDB

        dbobj = TwoStageDB.load(args.cache)
        cfg, filters = dbobj.db.cfg, dbobj.db.filters
    else:
        db = api.FingerprintDB.load(args.db)
        dbobj, cfg, filters = db, db.cfg, db.filters
    pcms = {}
    for path in args.audio:
        pcm, _ = load_wav(path, cfg)
        pcms[path] = pcm
    pool = StreamingPool(dbobj, filters, cfg, capacity=len(pcms),
                         query_prints=args.query_prints)
    for sid in pcms:
        pool.add_stream(sid)
    chunk = cfg.sample_rate // 10
    n = max(len(p) for p in pcms.values())
    out = {}
    for pos in range(0, n, chunk):
        out = pool.feed({sid: p[pos:pos + chunk]
                         for sid, p in pcms.items() if pos < len(p)})
    rc = 0
    for sid in pcms:
        h = out.get(sid)
        if h is None:
            print(f"{sid}: no hypothesis (stream too short?)")
            rc = 1
        else:
            print(f"{sid}: {h.track_id}  score={h.score}  "
                  f"offset={h.offset}  confidence {h.confidence:.2f}")
    stats = pool.latency_stats()
    print(f"[tick p50 {stats['tick_p50_ms']:.1f} ms, "
          f"{stats['n_matches']} batched matches]")
    return rc


def cmd_build_artist_db(args):
    """Each positional arg is a directory of one artist's WAV files."""
    import os

    from .artist import ArtistDB
    from .config import HpfwConfig
    from .io.wav import load_wav

    cfg = HpfwConfig.from_json(open(args.config).read()) if args.config else HpfwConfig()
    catalogs = {}
    for d in args.dirs:
        name = os.path.basename(os.path.normpath(d))
        wavs = sorted(f for f in os.listdir(d) if f.lower().endswith(".wav"))
        if not wavs:
            print(f"warning: no .wav files in {d}", file=sys.stderr)
            continue
        catalogs[name] = {os.path.splitext(w)[0]: load_wav(os.path.join(d, w), cfg)[0]
                          for w in wavs}
        print(f"{name}: {len(wavs)} tracks")
    adb = ArtistDB.build(catalogs, cfg)
    adb.save(args.output)
    print(f"wrote {args.output} ({len(catalogs)} artists)")
    return 0


def cmd_match_artist(args):
    from .artist import ArtistDB
    from .io.wav import load_wav

    adb = ArtistDB.load(args.db)
    pcm, _ = load_wav(args.query, adb.cfg)
    if args.artist:
        ids, scores, offs = adb.match(pcm, artist=args.artist, top_k=args.top_k)
        rows = [(f"{args.artist}/{t}", s, o) for t, s, o in zip(ids, scores, offs)]
    else:
        pairs, scores, offs = adb.match(pcm, top_k=args.top_k)
        rows = [(f"{a}/{t}", s, o) for (a, t), s, o in zip(pairs, scores, offs)]
    for i, (label, s, o) in enumerate(rows):
        print(f"#{i + 1} {label}  score={int(s)}  offset={int(o)}")
    return 0


def cmd_artist_demo(args):
    from .artist import ArtistDB
    from .config import HpfwConfig
    from .io import synth

    cfg = HpfwConfig() if not args.small else HpfwConfig(
        frame_len=2048, fmin=380.0, n_bins=73, hop=256, context_w=8, delta_lag=4)
    print(f"synthesizing {args.artists} artists x {args.tracks} tracks ...")
    catalogs = {
        f"artist{a}": {f"t{i:02d}": synth.synth_artist_track(a, i, args.seconds, cfg)
                       for i in range(args.tracks)}
        for a in range(args.artists)
    }
    print("learning per-artist banks + building databases ...")
    adb = ArtistDB.build(catalogs, cfg)
    truth_a, truth_t = f"artist{args.artists - 1}", f"t{args.tracks - 2:02d}"
    q = synth.make_query(catalogs[truth_a][truth_t], 1.0,
                         min(5.0, args.seconds / 2), cfg, noise_db=-12.0, seed=1)
    print(f"query: noisy excerpt of {truth_a}/{truth_t} (artist not given)")
    pairs, scores, offs = adb.match(q, top_k=3)
    for i, ((a, t), s, o) in enumerate(zip(pairs, scores, offs)):
        print(f"  #{i + 1} {a}/{t}  score={int(s)}  offset={int(o)}")
    ok = pairs[0] == (truth_a, truth_t)
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


def cmd_selfcheck(args):
    from . import api, oracle
    from .config import HpfwConfig
    from .io import synth

    cfg = HpfwConfig(frame_len=2048, fmin=380.0, n_bins=73, hop=256,
                     context_w=8, delta_lag=4)
    rng = np.random.default_rng(0)
    filters = oracle.fix_eigenvector_signs(
        rng.standard_normal((cfg.context_dim, 64)) / 50).astype(np.float32)
    pcm = synth.synth_track(7, 3.0, cfg)
    got = api.fingerprint(pcm, filters, cfg)
    want = oracle.fingerprint(pcm, filters, cfg)
    nbits = int(np.bitwise_count(np.bitwise_xor(got, want).astype(np.uint64)).sum())
    total = got.size * 32
    print(json.dumps({"differing_bits": nbits, "total_bits": total,
                      "backend": __import__("jax").default_backend()}))
    return 0 if nbits <= total * 1e-4 else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hpfw_jax", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="end-to-end demo on synthetic audio")
    d.add_argument("--tracks", type=int, default=10)
    d.add_argument("--seconds", type=float, default=8.0)
    d.add_argument("--small", action="store_true", help="small/fast config")
    d.set_defaults(fn=cmd_demo)

    l = sub.add_parser("learn", help="learn projection filters from audio")
    l.add_argument("audio", nargs="+")
    l.add_argument("-o", "--output", required=True)
    l.add_argument("--config")
    l.set_defaults(fn=cmd_learn)

    b = sub.add_parser("build-db", help="fingerprint a catalog into a database")
    b.add_argument("audio", nargs="+",
                   help="audio files, or directories to scan recursively")
    b.add_argument("--filters", required=True)
    b.add_argument("-o", "--output", required=True)
    b.add_argument("--config")
    b.add_argument("--threads", type=int, default=0,
                   help="native decode threads (0 = all cores)")
    b.add_argument("--batch", type=int, default=8,
                   help="tracks per device extraction dispatch")
    b.set_defaults(fn=cmd_build_db)

    f = sub.add_parser("fingerprint", help="audio -> 64-bit hashprints")
    f.add_argument("audio")
    f.add_argument("--filters", required=True)
    f.add_argument("--config")
    f.add_argument("-o", "--output")
    f.add_argument("--cpu", action="store_true",
                   help="native C++ extraction (no JAX)")
    f.add_argument("--head", type=int, default=16)
    f.set_defaults(fn=cmd_fingerprint)

    m = sub.add_parser("match", help="identify a query against a database")
    m.add_argument("query")
    m.add_argument("--db")
    m.add_argument("--cache", help="two-stage cache dir from build-cache")
    m.add_argument("--top-k", type=int, default=5)
    m.add_argument("--scaled", action="store_true",
                   help="two-stage coarse->fine matcher")
    m.add_argument("--phases", type=int, default=None,
                   help="coarse query phase variants (two-stage; default "
                        "from the DB's config)")
    m.add_argument("--prefilter", type=int, default=None,
                   help="two-pass coarse: pass-1 pool size (0 = one-pass)")
    m.add_argument("--pool", type=int, default=None,
                   help="fine rescan candidate pool (two-stage)")
    m.set_defaults(fn=cmd_match)

    bc = sub.add_parser("build-cache", help="persist derived two-stage state "
                        "(+ optionally pre-seed serving compiles)")
    bc.add_argument("--db", required=True)
    bc.add_argument("-o", "--output", required=True)
    bc.add_argument("--stride", type=int, default=None)
    bc.add_argument("--channels", type=int, default=None)
    bc.add_argument("--prefilter-channels", type=int, default=None,
                    help="pass-1 coarse channels (< channels derives the "
                    "cheap prefilter sweep DB into the cache)")
    bc.add_argument("--warmup-prints", type=int, default=0,
                    help="query print count to compile serving programs for")
    bc.add_argument("--warmup-batches", default="",
                    help="comma-separated batch sizes to also compile")
    bc.set_defaults(fn=cmd_build_cache)

    st = sub.add_parser("stream", help="live-song-ID simulation over a file")
    st.add_argument("audio")
    st.add_argument("--db")
    st.add_argument("--cache")
    st.add_argument("--query-prints", type=int, default=128)
    st.set_defaults(fn=cmd_stream)

    pl = sub.add_parser("pool", help="concurrent live-ID simulation over "
                        "several files (one batched pool)")
    pl.add_argument("audio", nargs="+")
    pl.add_argument("--db")
    pl.add_argument("--cache")
    pl.add_argument("--query-prints", type=int, default=128)
    pl.set_defaults(fn=cmd_pool)

    ab = sub.add_parser("build-artist-db",
                        help="per-artist filter banks from WAV directories")
    ab.add_argument("dirs", nargs="+", help="one directory per artist")
    ab.add_argument("-o", "--output", required=True)
    ab.add_argument("--config")
    ab.set_defaults(fn=cmd_build_artist_db)

    ma = sub.add_parser("match-artist", help="identify a query (known artist "
                        "with --artist, else ranked across artists)")
    ma.add_argument("query")
    ma.add_argument("--db", required=True)
    ma.add_argument("--artist")
    ma.add_argument("--top-k", type=int, default=5)
    ma.set_defaults(fn=cmd_match_artist)

    ad = sub.add_parser("artist-demo", help="known-artist end-to-end demo")
    ad.add_argument("--artists", type=int, default=4)
    ad.add_argument("--tracks", type=int, default=5)
    ad.add_argument("--seconds", type=float, default=8.0)
    ad.add_argument("--small", action="store_true")
    ad.set_defaults(fn=cmd_artist_demo)

    s = sub.add_parser("selfcheck", help="oracle-vs-device bit parity")
    s.set_defaults(fn=cmd_selfcheck)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
