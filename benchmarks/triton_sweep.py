"""A candidate Triton-route kernel for the whole-catalog coarse sweep, and
a sweep of its tile shapes against XLA's int8 GEMM (ops/coarse.coarse_best,
the matcher's one path) on the card.

    python benchmarks/triton_sweep.py [--tracks 250000] [--budget-s 240]

Shapes: catalog_scale() pass 1 at 250k x 60 s (158 coarse windows, 32
channels), 10 s queries (23 windows), rows 32 (B = 16, two phase rows per
query) for every tile shape, then rows 2 (B = 1) for the four fastest.
Each output is checked equal to the GEMM's. Times are on the host clock
around block_until_ready, median of 4 after a warm-up call. Writes
chiprun_out/triton_sweep.json. Needs a GPU.

The kernel: each program owns `tt` tracks and `L` phase lanes (L / P
queries) and walks the offset blocks itself. Block m scores offsets
m*P .. m*P + P-1 as an int8 product of the tracks' flat coarse rows
(columns m*P*C onwards) with the P-shift phase matrix, accumulated in
int32 over KB-column steps; the running (max, first offset) per lane stays
in registers, and the program writes two words per (track, query). It
skips the GEMM's MACs on the phase matrix's zeros and never writes the
(T, rows*offsets) int32 surface. The Triton lowering addresses an operand
of 2^31..2^32 bytes with int32 offsets, so the DB here stays below 2^31
bytes.
"""

import argparse
import functools
import itertools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import triton as plgpu  # noqa: E402

from hpfw_jax.ops.coarse import coarse_best, phase_matrix  # noqa: E402

_NEG = -(2 ** 31) + 1
_BIG = 2 ** 30


def _kernel(w_ref, db_ref, best_ref, idx_ref, *, n_tracks, lcw, n_off,
            m_blocks, n_kb, c, tt, lanes, P, KB):
    q_blk = pl.program_id(0)
    row0 = pl.program_id(1) * tt
    nq = lanes // P
    rows = row0 + jnp.arange(tt, dtype=jnp.int32)
    row_ok = rows < n_tracks
    kcol = jnp.arange(KB, dtype=jnp.int32)
    lane0 = q_blk * lanes
    r_lane = jax.lax.broadcasted_iota(jnp.int32, (tt, lanes), 1) % P

    def m_body(m, carry):
        best, idx = carry
        col0 = m * (P * c)

        def k_body(kk, acc):
            col = col0 + kk * KB
            x = plgpu.load(
                db_ref.at[pl.ds(row0, tt), pl.ds(col, KB)],
                mask=row_ok[:, None] & (col + kcol < lcw)[None, :], other=0)
            w = w_ref[pl.ds(kk * KB, KB), pl.ds(lane0, lanes)]
            return acc + jax.lax.dot_general(
                x, w, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)

        acc = jax.lax.fori_loop(0, n_kb, k_body,
                                jnp.zeros((tt, lanes), jnp.int32))
        off = m * P + r_lane
        corr = jnp.where(off < n_off, acc, _NEG)
        take = corr > best          # strict: earlier blocks win ties
        return jnp.where(take, corr, best), jnp.where(take, off, idx)

    best, idx = jax.lax.fori_loop(
        0, m_blocks, m_body,
        (jnp.full((tt, lanes), _NEG, jnp.int32),
         jnp.zeros((tt, lanes), jnp.int32)))
    best3 = best.reshape(tt, nq, P)
    idx3 = idx.reshape(tt, nq, P)
    top = jnp.max(best3, axis=2)
    first = jnp.min(jnp.where(best3 == top[:, :, None], idx3, _BIG), axis=2)
    out = (pl.ds(row0, tt), pl.ds(q_blk * nq, nq))
    plgpu.store(best_ref.at[out], top, mask=row_ok[:, None])
    plgpu.store(idx_ref.at[out], first, mask=row_ok[:, None])


@functools.partial(jax.jit, static_argnames=("tt", "L", "P", "KB", "nw", "ns",
                                             "interpret"))
def sweep(query_cs, db_c, *, tt=128, L=64, P=8, KB=128, nw=4, ns=3,
          interpret=False):
    """(B, Nc, C) int8 rows vs a (T, Lc, C) int8 coarse DB below 2^31
    bytes: ((B, T), (B, T)) int32 best correlation and first best offset,
    equal to coarse_best. Defaults: the fastest tile of the sweep on one
    H100 (PERF.md). interpret=True runs it on the CPU."""
    b0, nc, c = query_cs.shape
    t, lc, _ = db_c.shape
    n_off = lc - nc + 1
    b = 1
    while b < b0:
        b *= 2
    if b != b0:   # power-of-two row count; extra rows repeat row 0
        query_cs = jnp.concatenate(
            [query_cs, jnp.broadcast_to(query_cs[:1], (b - b0, nc, c))])
    lanes = min(b * P, L)
    n_kb = -(-((nc + P - 1) * c) // KB)
    w = phase_matrix(query_cs.astype(jnp.int8), P, n_kb * KB)
    lcw = lc * c
    kernel = functools.partial(
        _kernel, n_tracks=t, lcw=lcw, n_off=n_off, m_blocks=-(-n_off // P),
        n_kb=n_kb, c=c, tt=tt, lanes=lanes, P=P, KB=KB)
    best, idx = pl.pallas_call(
        kernel, grid=(b * P // lanes, -(-t // tt)),
        out_shape=[jax.ShapeDtypeStruct((t, b), jnp.int32),
                   jax.ShapeDtypeStruct((t, b), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=nw, num_stages=ns),
        interpret=interpret,
        name="coarse_sweep")(w, db_c.astype(jnp.int8).reshape(t, lcw))
    return best.T[:b0], idx.T[:b0]


def timed(fn, reps=4):
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tracks", type=int, default=250_000)
    ap.add_argument("--budget-s", type=float, default=240.0)
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("needs a GPU")
    t, lc, nc, c = args.tracks, 158, 23, 32
    if t * lc * c >= 2 ** 31:
        sys.exit("DB of 2^31 bytes or more: the kernel's int32 offsets wrap")
    key = jax.random.key(0)

    def pm1(k, s):
        return jnp.where(jax.random.bernoulli(k, 0.5, s), 1, -1
                         ).astype(jnp.int8)

    db = pm1(jax.random.fold_in(key, 1), (t, lc, c))
    res = {"device_kind": dev.device_kind, "tracks": t, "ms": {}}
    gemm = jax.jit(coarse_best)
    qs = {r: pm1(jax.random.fold_in(key, 10 + r), (r, nc, c)) for r in (2, 32)}
    ref = {r: gemm(qs[r], db) for r in qs}
    os.makedirs("chiprun_out", exist_ok=True)

    def record(tag, value):
        res["ms"][tag] = value
        print(f"{tag}: {value}", flush=True)
        with open(os.path.join("chiprun_out", "triton_sweep.json"), "w") as fh:
            json.dump(res, fh, indent=1)

    def run(tag, rows, **tiles):
        fn = functools.partial(sweep, **tiles)
        try:
            out = fn(qs[rows], db)
            ok = all(bool(jnp.array_equal(a, b))
                     for a, b in zip(out, ref[rows]))
            ms = timed(lambda: fn(qs[rows], db))
            record(tag, ms if ok else f"MISMATCH {ms:.3f}")
        except Exception as e:                  # noqa: BLE001 - report it
            record(tag, f"failed {type(e).__name__}: {str(e)[:120]}")

    for r in qs:
        record(f"gemm_R{r}", timed(lambda: gemm(qs[r], db)))
    names = ("tt", "L", "P", "KB", "nw", "ns")
    grid = [dict(zip(names, v)) for v in itertools.product(
        (64, 128), (64, 128, 256), (8, 16), (64, 128), (4, 8), (2, 3))]
    t_start = time.perf_counter()
    for g in grid:
        if time.perf_counter() - t_start > args.budget_s:
            print("time budget reached", flush=True)
            break
        run("tt{tt}_L{L}_P{P}_KB{KB}_nw{nw}_ns{ns}_R32".format(**g), 32, **g)
    done = {k: v for k, v in res["ms"].items()
            if k.endswith("_R32") and isinstance(v, float)}
    for k in sorted(done, key=done.get)[:4]:
        g = dict(zip(names, (int(f[len(n):]) for f, n in
                             zip(k.split("_"), names))))
        run(k[:-4] + "_R2", 2, **g)


if __name__ == "__main__":
    main()
