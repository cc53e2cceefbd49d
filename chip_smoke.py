#!/usr/bin/env python3
"""Bring-up check on one NVIDIA GPU: extraction -> two-stage catalog match
-> serving, through the public entry points, at full width.

    python chip_smoke.py [--seed 0]          # phases a-c on one card
    python chip_smoke.py --devices 4         # phase d alone, four cards

a. extract   default HpfwConfig (22.05 kHz, 121 CQT bins, 8192-sample
             frames, 64 filters): 16 x 240 s tracks through
             api.fingerprint_batch, 2 of them margin-audited against the
             float64 oracle; api.learn_filters over 32 x 30 s against
             oracle.learn_filters.
b. catalog   HpfwConfig.catalog_scale() over 250,000 x 60 s tracks (random
             prints from the seed, plus 64 planted synthesized tracks),
             32 noisy 10 s queries at -10 dB: TwoStageDB.match,
             match_batch at B = 16 and a MatchServer answering 64 requests,
             checked for exactness, batch/server agreement, the dense
             ceiling on 4 queries and identification of every query.
c. gpu-tests the `gpu`-marked pytest tests (kernels at real widths), run in
             this process.
d. --devices 4: the 1M x 60 s catalog sharded over four cards against the
             same catalog on card 0: identical (ids, scores, offsets) for
             32 queries, through match and match_batch at B = 16.

Fails (non-zero exit, no result line) when JAX finds no GPU or any check
fails. The last line of stdout is the JSON result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    """Card name and power limit, read by a child that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi unavailable: {e}")
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def peak_bytes(dev) -> int:
    return int(dev.memory_stats().get("peak_bytes_in_use", -1))


def synth_many(seeds, seconds, cfg) -> np.ndarray:
    """synth.synth_track for each seed on host threads (numpy releases the
    GIL in its array loops)."""
    from concurrent.futures import ThreadPoolExecutor

    from hpfw_jax.io import synth

    with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        return np.stack(list(ex.map(
            lambda s: synth.synth_track(s, seconds, cfg), seeds)))


def random_filters(cfg, rng):
    from hpfw_jax import oracle

    f = rng.standard_normal((cfg.context_dim, cfg.n_filters))
    return oracle.fix_eigenvector_signs(
        f / np.sqrt(cfg.context_dim)).astype(np.float32)


# --------------------------------------------------------------------------
# a. extraction
# --------------------------------------------------------------------------

def phase_extract(seed: int, n_tracks: int = 16, seconds: float = 240.0,
                  n_learn: int = 32):
    from hpfw_jax import api, oracle
    from hpfw_jax.config import HpfwConfig
    from hpfw_jax.ops import dot

    t0 = time.perf_counter()
    cfg = HpfwConfig()
    log(f"[a] dot precision: {dot.PRECISION} (float32, no TF32)")
    rng = np.random.default_rng(seed)
    filters = random_filters(cfg, rng)
    n = int(seconds * cfg.sample_rate)
    pcms = synth_many([seed * 1000 + 100 + i for i in range(n_tracks)],
                      seconds, cfg)[:, :n]
    t1 = time.perf_counter()
    prints = api.fingerprint_batch(pcms, filters, cfg)
    t_first = time.perf_counter() - t1
    t1 = time.perf_counter()
    prints = api.fingerprint_batch(pcms, filters, cfg)
    t_warm = time.perf_counter() - t1
    want_n = cfg.n_hashprints(n)
    if prints.shape != (n_tracks, want_n, 2):
        fail(f"[a] extraction shape {prints.shape}, want "
             f"({n_tracks}, {want_n}, 2)")
    for i in (0, min(9, n_tracks - 1)):
        want = oracle.fingerprint(pcms[i], filters, cfg)
        margins = oracle.delta_margins(pcms[i], filters, cfg)
        oracle.assert_bits_match_with_margin_audit(prints[i], want, margins,
                                            rel_tol=1e-4)
        diff = int(np.bitwise_count(np.bitwise_xor(prints[i], want)).sum())
        log(f"[a] track {i}: margin audit passed vs float64 oracle "
            f"({diff} differing bits of {want.size * 32})")
    log(f"[a] extraction {n_tracks} x {seconds:.0f} s: first call "
        f"{t_first:.3f} s, warm {t_warm:.3f} s "
        f"({n_tracks * seconds / t_warm:.0f}x realtime, host clock, "
        "includes host<->device copies)")
    corpus = list(synth_many([seed * 1000 + 500 + i for i in range(n_learn)],
                             30.0, cfg))
    t1 = time.perf_counter()
    learned = api.learn_filters(corpus, cfg)
    t_learn = time.perf_counter() - t1
    ref = oracle.learn_filters(corpus, cfg)
    cos = np.abs(np.sum(learned.astype(np.float64) * ref, axis=0))
    if learned.shape != ref.shape or not np.all(cos > 0.98):
        fail(f"[a] learned filters vs oracle: min |cos| {cos.min():.4f}")
    log(f"[a] learn_filters {n_learn} x 30 s: {t_learn:.3f} s, min |cos| vs oracle "
        f"{cos.min():.6f} (> 0.98)")
    log(f"[a] ok in {time.perf_counter() - t0:.1f} s")
    return learned


# --------------------------------------------------------------------------
# b. catalog
# --------------------------------------------------------------------------

def _catalog(cfg, n_tracks, n_planted, filters, seed):
    """Random-print background + planted synthesized tracks (extracted on
    the device). Returns (FingerprintDB, planted rows, planted pcm)."""
    from hpfw_jax import api

    l_prints = cfg.n_hashprints(int(60.0 * cfg.sample_rate))
    rng = np.random.default_rng(seed)
    prints = rng.integers(0, 2 ** 32, (n_tracks, l_prints, 2), dtype=np.uint32)
    lengths = np.full(n_tracks, l_prints, np.int32)
    rows = np.sort(rng.choice(n_tracks, n_planted, replace=False))
    pcm = synth_many([seed * 1000 + 2000 + i for i in range(n_planted)],
                     60.0, cfg)
    fps = api.fingerprint_batch(pcm, filters, cfg)
    prints[rows] = 0
    prints[rows, :fps.shape[1]] = fps
    lengths[rows] = fps.shape[1]
    db = api.FingerprintDB(cfg, filters, [f"t{i}" for i in range(n_tracks)],
                           prints, lengths)
    return db, rows, pcm


def _queries(cfg, pcm, rows, n_queries, filters, seed):
    """Noisy 10 s excerpts at -10 dB of planted tracks, at hop-aligned
    starts. Returns (prints (Q, N, 2), true rows, true offsets)."""
    from hpfw_jax import api
    from hpfw_jax.io import synth

    rng = np.random.default_rng(seed + 1)
    pick = rng.choice(len(rows), n_queries, replace=False)
    starts = rng.integers(0, int(45.0 * cfg.sample_rate) // cfg.hop, n_queries)
    clips = np.stack([
        synth.make_query(pcm[p], s * cfg.hop / cfg.sample_rate, 10.0, cfg,
                         noise_db=-10.0, seed=seed + 10 + k).astype(np.float32)
        for k, (p, s) in enumerate(zip(pick, starts))])
    n = int(round(10.0 * cfg.sample_rate))
    q = api.fingerprint_batch(clips[:, :n], filters, cfg)
    return q, rows[pick], starts.astype(np.int64)


def _same(a, b) -> bool:
    return (list(a[0]) == list(b[0]) and np.array_equal(a[1], b[1])
            and np.array_equal(a[2], b[2]))


def _exact_at(q, track, length, off) -> int:
    """Exact similarity of q at offset `off` of one track (numpy)."""
    n = q.shape[0]
    seg = track[off:off + n]
    sim = 64 - np.bitwise_count(np.bitwise_xor(seg, q[:seg.shape[0]])).sum(1)
    return int(np.where(off + np.arange(seg.shape[0]) < length, sim, 0).sum())


def phase_catalog(seed: int, filters, dev, n_tracks: int = 250_000):
    import jax
    import jax.numpy as jnp

    from hpfw_jax.config import HpfwConfig
    from hpfw_jax.match import matcher
    from hpfw_jax.match.scaled import TwoStageDB
    from hpfw_jax.serve import MatchServer

    t0 = time.perf_counter()
    cfg = HpfwConfig.catalog_scale()
    n_planted, n_q = 64, 32
    db, rows, pcm = _catalog(cfg, n_tracks, n_planted, filters, seed)
    q, q_rows, q_offs = _queries(cfg, pcm, rows, n_q, filters, seed)
    log(f"[b] catalog {n_tracks} x {db.prints.shape[1]} prints "
        f"({db.prints.nbytes / 1e9:.2f} GB packed), {n_planted} planted; "
        f"{n_q} queries of {q.shape[1]} prints; host set-up "
        f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    ts = TwoStageDB(db)
    jax.block_until_ready((ts.prints, ts.db_c, ts.db_c1))
    log(f"[b] TwoStageDB build {time.perf_counter() - t1:.1f} s; device "
        f"prints {ts.prints.nbytes / 1e9:.2f} GB, coarse "
        f"{ts.db_c.nbytes / 1e9:.2f} GB, pass-1 coarse "
        f"{ts.db_c1.nbytes / 1e9:.2f} GB; peak_bytes_in_use "
        f"{peak_bytes(dev)}")

    t1 = time.perf_counter()
    single = [ts.match(q[0])]
    t_first = time.perf_counter() - t1
    t1 = time.perf_counter()
    single += [ts.match(q[i]) for i in range(1, n_q)]
    t_single = (time.perf_counter() - t1) / (n_q - 1)
    log(f"[b] match(): first call {t_first:.2f} s, then "
        f"{t_single * 1e3:.2f} ms/query (host clock, {n_q - 1} queries)")
    t1 = time.perf_counter()
    batch = ts.match_batch(q[:16])
    t_bfirst = time.perf_counter() - t1
    t1 = time.perf_counter()
    batch += ts.match_batch(q[16:])
    t_batch = time.perf_counter() - t1
    log(f"[b] match_batch B=16: first call {t_bfirst:.2f} s, then "
        f"{t_batch * 1e3:.2f} ms/batch = {t_batch / 16 * 1e3:.2f} ms/query")
    with MatchServer(ts, q.shape[1], max_batch=16) as srv:
        srv.warmup(q[0])
        order = np.random.default_rng(seed + 2).permutation(2 * n_q) % n_q
        t1 = time.perf_counter()
        futs = [(i, srv.submit(q[i])) for i in order]
        served = [(i, f.result(timeout=600)) for i, f in futs]
        t_srv = time.perf_counter() - t1
    log(f"[b] MatchServer: {len(served)} requests in {t_srv:.2f} s")
    log(f"[b] peak_bytes_in_use after matching {peak_bytes(dev)}")

    # batch and server agree with match()
    bad = [i for i in range(n_q) if not _same(batch[i], single[i])]
    if bad:
        fail(f"[b] match_batch rows differ from match() for queries {bad}")
    bad = [i for i, r in served if not _same(r, single[i])]
    if bad:
        fail(f"[b] server answers differ from match() for queries {bad}")
    log("[b] match_batch rows and all 64 server answers equal match()")

    # identification + exact on the pool
    id_of = {t: i for i, t in enumerate(db.track_ids)}
    n_checked = n_global = 0
    for i, (ids, sc, off) in enumerate(single):
        if ids[0] != db.track_ids[q_rows[i]] or int(off[0]) != q_offs[i]:
            fail(f"[b] query {i}: top-1 {ids[0]}@{off[0]}, want "
                 f"{db.track_ids[q_rows[i]]}@{q_offs[i]}")
        rows_i = np.array([id_of[t] for t in ids])
        s_ex, o_ex = matcher.score_tracks(
            jnp.asarray(q[i]), ts.prints[rows_i], ts.lengths[rows_i])
        s_ex, o_ex = np.asarray(s_ex), np.asarray(o_ex)
        for k, r in enumerate(rows_i):
            at = _exact_at(q[i], db.prints[r], db.lengths[r], int(off[k]))
            if at != int(sc[k]) or int(sc[k]) > s_ex[k]:
                fail(f"[b] query {i} rank {k}: reported {sc[k]}@{off[k]}, "
                     f"exact there {at}, exhaustive best {s_ex[k]}")
            n_checked += 1
            n_global += int(s_ex[k] == sc[k] and o_ex[k] == off[k])
        if (s_ex[0], o_ex[0]) != (sc[0], off[0]):
            fail(f"[b] query {i}: top-1 {sc[0]}@{off[0]} is not the "
                 f"track's exhaustive best {s_ex[0]}@{o_ex[0]}")
    log(f"[b] identification: {n_q}/{n_q} planted queries top-1 at their "
        "true offset")
    log(f"[b] exact on the pool: {n_checked} returned (track, score, offset) "
        f"scored exactly at their offset; every top-1 equals its track's "
        f"exhaustive best and first-best offset; {n_global}/{n_checked} "
        "equal the track's exhaustive best (the rest are imposters whose "
        "best offset lies outside their fine band)")

    # dense ceiling on 4 queries
    t1 = time.perf_counter()
    chunk = min(25_000, n_tracks)
    for i in range(4):
        s_all, o_all = [], []
        for c0 in range(0, n_tracks, chunk):
            s, o = matcher.score_tracks(jnp.asarray(q[i]),
                                        ts.prints[c0:c0 + chunk],
                                        ts.lengths[c0:c0 + chunk])
            s_all.append(np.asarray(s))
            o_all.append(np.asarray(o))
        order, s_d, o_d = matcher.rank(np.concatenate(s_all),
                                       np.concatenate(o_all), 1)
        ids, sc, off = single[i]
        if db.track_ids[order[0]] in ids and \
                (db.track_ids[order[0]], int(s_d[0]), int(o_d[0])) != \
                (ids[0], int(sc[0]), int(off[0])):
            fail(f"[b] dense ceiling query {i}: dense top-1 "
                 f"{db.track_ids[order[0]]} {s_d[0]}@{o_d[0]} vs two-stage "
                 f"{ids[0]} {sc[0]}@{off[0]}")
    log(f"[b] dense ceiling: 4 queries scanned exhaustively over "
        f"{n_tracks} tracks, top-1 equal ({time.perf_counter() - t1:.1f} s)")
    log(f"[b] ok in {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# c. gpu tests
# --------------------------------------------------------------------------

def phase_gpu_tests():
    import pytest

    t0 = time.perf_counter()
    os.environ["HPFW_TEST_PLATFORM"] = "gpu"
    outcomes = {"passed": 0, "failed": 0, "skipped": 0}

    class Count:
        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                outcomes[report.outcome] += 1

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(ROOT, "tests", "test_gpu_kernels.py")],
                     plugins=[Count()])
    if rc != 0 or outcomes["failed"] or outcomes["skipped"] \
            or outcomes["passed"] == 0:
        fail(f"[c] gpu tests: rc {rc}, {outcomes}")
    log(f"[c] gpu tests: {outcomes['passed']} passed in "
        f"{time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# d. four cards
# --------------------------------------------------------------------------

def phase_four(seed: int, n_dev: int, n_tracks: int):
    import jax

    from hpfw_jax.api import FingerprintDB
    from hpfw_jax.config import HpfwConfig
    from hpfw_jax.match.scaled import TwoStageDB
    from hpfw_jax.parallel.mesh import db_mesh

    t0 = time.perf_counter()
    cfg = HpfwConfig.catalog_scale()
    l_prints = cfg.n_hashprints(int(60.0 * cfg.sample_rate))
    n_q = cfg.n_hashprints(int(10.0 * cfg.sample_rate))
    rng = np.random.default_rng(seed)
    prints = rng.integers(0, 2 ** 32, (n_tracks, l_prints, 2), dtype=np.uint32)
    db = FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32),
                       [f"t{i}" for i in range(n_tracks)], prints,
                       np.full(n_tracks, l_prints, np.int32))
    rows = rng.choice(n_tracks, 32, replace=False)
    offs = rng.integers(0, l_prints - n_q + 1, 32)
    q = np.stack([prints[r, o:o + n_q] for r, o in zip(rows, offs)])
    flip = (rng.random(q.shape + (32,)) < 0.15).astype(np.uint32)
    q ^= (flip << np.arange(32, dtype=np.uint32)).sum(-1).astype(np.uint32)
    log(f"[d] catalog {n_tracks} x {l_prints} prints "
        f"({prints.nbytes / 1e9:.2f} GB packed), 32 noisy excerpts; host "
        f"set-up {time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    sharded = TwoStageDB(db, mesh=db_mesh(n_dev))
    jax.block_until_ready(sharded.db_c1)
    log(f"[d] sharded build over {n_dev} cards {time.perf_counter() - t1:.1f} s;"
        f" peak_bytes_in_use per card "
        f"{[peak_bytes(d) for d in jax.devices()[:n_dev]]}")
    t1 = time.perf_counter()
    res_s = [sharded.match(q[0])]
    t_first = time.perf_counter() - t1
    t1 = time.perf_counter()
    res_s += [sharded.match(q[i]) for i in range(1, 32)]
    log(f"[d] sharded match(): first call {t_first:.2f} s, then "
        f"{(time.perf_counter() - t1) / 31 * 1e3:.2f} ms/query (host clock)")
    t1 = time.perf_counter()
    res_sb = sharded.match_batch(q[:16])
    t_first = time.perf_counter() - t1
    t1 = time.perf_counter()
    res_sb += sharded.match_batch(q[16:])
    log(f"[d] sharded match_batch B=16: first call {t_first:.2f} s, then "
        f"{(time.perf_counter() - t1) * 1e3:.2f} ms/batch (host clock)")
    del sharded
    gc.collect()

    t1 = time.perf_counter()
    single = TwoStageDB(db)
    jax.block_until_ready(single.db_c1)
    log(f"[d] single-card build {time.perf_counter() - t1:.1f} s; "
        f"peak_bytes_in_use card 0 {peak_bytes(jax.devices()[0])}")
    t1 = time.perf_counter()
    res_1 = [single.match(q[i]) for i in range(32)]
    log(f"[d] single-card match(): {time.perf_counter() - t1:.2f} s for 32 "
        "queries incl. first-call compile")
    bad = [i for i in range(32)
           if not (_same(res_s[i], res_1[i]) and _same(res_sb[i], res_1[i]))]
    if bad:
        fail(f"[d] sharded and single-card results differ for queries {bad}")
    miss = [i for i in range(32)
            if (res_1[i][0][0], int(res_1[i][2][0])) != (f"t{rows[i]}",
                                                          int(offs[i]))]
    if miss:
        fail(f"[d] queries {miss} not identified at their true offset")
    log("[d] sharded match() and match_batch() equal single-card match() "
        "for 32 queries: full top-10 (ids, scores, offsets) identical; "
        "every top-1 is the true track at its true offset")
    log(f"[d] ok in {time.perf_counter() - t0:.1f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    ap.add_argument("--tracks", type=int, default=1_000_000,
                    help="catalog size of the --devices 4 phase")
    args = ap.parse_args()

    card = card_line()
    sys.path.insert(0, ROOT)
    import jax

    import hpfw_jax  # noqa: F401 - the program itself; absent when run alone

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"JAX found no GPU (platform {devs[0].platform})")
    if len(devs) < args.devices:
        fail(f"need {args.devices} GPUs, JAX sees {len(devs)}")
    for line in card.splitlines():
        log(f"card: {line}")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")

    if args.devices == 4:
        if args.tracks != 1_000_000:
            log(f"[d] catalog cut to {args.tracks} tracks (--tracks)")
        phase_four(args.seed, 4, args.tracks)
    else:
        filters = phase_extract(args.seed)
        phase_catalog(args.seed, filters, devs[0])
        gc.collect()
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
