"""The matcher's stages on the card at catalog width, timed.

    python benchmarks/matcher_kernels.py [--tracks 250000] [--reps 5]
                                         [--stages sweep,pass2,fine,e2e]

Catalog: random coarse rows / packed prints at the 60 s, 250k-track operating
point (158 coarse windows, 2,533 prints), 10 s queries (23 coarse windows,
380 prints). Stages:

  sweep    whole-catalog coarse (best, first offset) per (row, track) with
           XLA's int8 phase GEMM (ops/coarse.coarse_best). Rows 1/16/32 at
           64 channels (the single-pass sweep at B = 1/16/32), rows 2/32/64
           at 32 channels (catalog_scale() pass 1: two phase rows per
           query);
  pass2    the two-pass rescan of 8,192 gathered rows x 8 phase rows;
  fine     band-gather fine rescan, pool 1,024;
  e2e      TwoStageDB.dispatch_batch under catalog_scale() at B = 1/16/32.

Times are on the host clock around block_until_ready, median of --reps
after a warm-up call that also compiles. Prints the card's name and power
limit; every number also goes to chiprun_out/matcher_kernels.json,
rewritten after each measurement. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join("chiprun_out", "matcher_kernels.json")


def timed(fn, reps):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts)) * 1e3, first


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tracks", type=int, default=250_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--stages", default="sweep,pass2,fine,e2e")
    args = ap.parse_args()
    stages = args.stages.split(",")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    import jax
    import jax.numpy as jnp

    from hpfw_jax.api import FingerprintDB
    from hpfw_jax.config import HpfwConfig
    from hpfw_jax.match import scaled
    from hpfw_jax.ops import coarse as coarse_ops

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("needs a GPU")
    print(f"card: {card}; jax {jax.__version__} {dev.device_kind}", flush=True)
    t, lc, nc, l, n = args.tracks, 158, 23, 2533, 380
    res = {"card": card, "device_kind": dev.device_kind, "tracks": t,
           "reps": args.reps, "ms": {}, "first_call_s": {}}
    key = jax.random.key(0)
    os.makedirs("chiprun_out", exist_ok=True)

    def record(tag, ms, first=None):
        res["ms"][tag] = ms
        if first is not None:
            res["first_call_s"][tag] = round(first, 3)
        print(f"{tag}: {ms}" + (f" (first call {first:.2f} s)"
                                if first is not None else ""), flush=True)
        with open(OUT, "w") as f:
            json.dump(res, f, indent=1)

    def pm1(k, shape):
        return jnp.where(jax.random.bernoulli(k, 0.5, shape), 1, -1
                         ).astype(jnp.int8)

    gemm = jax.jit(coarse_ops.coarse_best)
    for c, rows in ((64, (1, 16, 32)), (32, (2, 32, 64))):
        if "sweep" not in stages:
            break
        db = pm1(jax.random.fold_in(key, c), (t, lc, c))
        for r in rows:
            qs = pm1(jax.random.fold_in(key, 100 * c + r), (r, nc, c))
            _, ms, first = timed(lambda: gemm(qs, db), args.reps)
            record(f"sweep_C{c}_R{r}_xla_gemm", ms, first)
        del db

    m = 8192
    rescan = jax.jit(jax.vmap(coarse_ops.coarse_best))
    for b in ((1, 16) if "pass2" in stages else ()):
        sub = pm1(jax.random.fold_in(key, 7), (b, m, lc, 64))
        qs = pm1(jax.random.fold_in(key, 8), (b, 8, nc, 64))
        _, ms, first = timed(lambda: rescan(qs, sub), args.reps)
        record(f"pass2_B{b}_xla_gemm", ms, first)
        del sub

    if "fine" in stages:
        prints = jax.random.bits(jax.random.fold_in(key, 9), (t, l, 2),
                                 jnp.uint32)
        lengths = jnp.full((t,), l, jnp.int32)
        fine = jax.jit(scaled._fine_rescan, static_argnames=("n_fine",))
        for b in (1, 16):
            rng = np.random.default_rng(b)
            cand = jnp.asarray(rng.integers(0, t, (b, 1024)).astype(np.int32))
            starts = jnp.asarray(
                rng.integers(0, l - n - 32, (b, 1024)).astype(np.int32))
            qs = jax.random.bits(jax.random.fold_in(key, 10 + b), (b, n, 2),
                                 jnp.uint32)
            _, ms, first = timed(
                lambda: fine(qs, prints, lengths, cand, starts, n_fine=33),
                args.reps)
            record(f"fine_B{b}_xla_gather", ms, first)
        del prints

    if "e2e" in stages:
        cfg = HpfwConfig.catalog_scale()
        rng = np.random.default_rng(0)
        host = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
        db = FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32),
                           [str(i) for i in range(t)], host,
                           np.full(t, l, np.int32))
        ts = scaled.TwoStageDB(db)
        del host, db
        for b in (1, 16, 32):
            qs = jax.random.bits(jax.random.fold_in(key, 50 + b), (b, n, 2),
                                 jnp.uint32)
            _, ms, first = timed(lambda: ts.dispatch_batch(qs), args.reps)
            record(f"e2e_B{b}", ms, first)
    res["peak_bytes_in_use"] = int(dev.memory_stats()["peak_bytes_in_use"])
    with open(OUT, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
