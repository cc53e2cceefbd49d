"""Headline benchmark: fingerprint-extraction realtime factor on one GPU.

Prints ONE JSON line:
  {"metric": "extraction_realtime_factor_per_chip", "value": N,
   "unit": "x_realtime", "vs_baseline": N, "device": {...}}

vs_baseline is relative to the driver-defined target of 1000x realtime per
chip (BASELINE.md — the reference publishes no numbers). Details go to
stderr; stdout carries only the JSON line. Needs a GPU: it fails, and
prints no result, when JAX finds none.

Run: python bench.py [--tracks N] [--seconds S] [--iters K]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tracks", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args()

    import jax

    from hpfw_jax import api
    from hpfw_jax.config import HpfwConfig
    from hpfw_jax.io import synth
    from hpfw_jax.oracle import fix_eigenvector_signs

    cfg = HpfwConfig()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU (JAX platform {dev.platform})")
    log(f"{len(jax.devices())} x {dev.device_kind}")

    rng = np.random.default_rng(0)
    filters = fix_eigenvector_signs(
        rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    ).astype(np.float32)

    n_samples = int(args.seconds * cfg.sample_rate)
    log(f"synthesizing {args.tracks} x {args.seconds}s tracks...")
    pcms = np.stack(
        [synth.synth_track(100 + i, args.seconds, cfg) for i in range(args.tracks)]
    )[:, :n_samples]

    import jax.numpy as jnp

    log("warmup/compile...")
    fn = api._fingerprint_batch_jit(cfg, n_samples)
    filters_dev = jnp.asarray(filters)
    t0 = time.time()
    out = np.asarray(fn(jnp.asarray(pcms), filters_dev))
    log(f"compile+first run: {time.time() - t0:.1f}s, prints/track={out.shape[1]}")

    # Device throughput: inputs are uploaded once, every dispatch is
    # queued, and the window ends when the last result is ready.
    bufs = [jnp.asarray(pcms + np.float32(i) * np.float32(1e-6))
            for i in range(args.iters)]
    jax.block_until_ready(bufs)
    t0 = time.perf_counter()
    jax.block_until_ready([fn(b, filters_dev) for b in bufs])
    elapsed = time.perf_counter() - t0
    audio_seconds = args.iters * args.tracks * args.seconds
    rtf = audio_seconds / elapsed
    log(f"{args.iters} dispatches of {args.tracks}x{args.seconds:.0f}s in "
        f"{elapsed:.3f}s -> rtf {rtf:.0f}x")

    print(json.dumps({
        "metric": "extraction_realtime_factor_per_chip",
        "value": round(rtf, 1),
        "unit": "x_realtime",
        "vs_baseline": round(rtf / 1000.0, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
