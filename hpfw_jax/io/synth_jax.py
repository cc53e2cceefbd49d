"""Device-side synthetic-music generation (catalog-scale fixtures).

The host-side generator (io/synth.py) renders one track at a time in NumPy
and ships PCM over the host link — fine for tests, slow for a 250k-track
catalog (60 s of PCM per track is ~5 MB; 250k tracks are ~1.3 TB of PCM).
This module renders the same *kind* of music — note-like partials on a
chromatic grid with onset/decay envelopes and vibrato, a slow log-sweep
chirp, a noise floor — entirely on device with `jax.random`, so catalog
construction runs at device speed and composes with extraction in a single
jit (seeds -> hashprints, nothing but prints ever leaves the device).

Tracks are deterministic functions of (base_seed, track_id). A fraction of
tracks are "covers": track i with i % 10 == 3 re-renders track (i-3)'s note
parameters pitch-shifted by a quarter semitone with fresh noise — the
correlated-print stress the recall study showed matters (pre-GPU run, see
git history).

This is a FIXTURE GENERATOR, not part of the fingerprinting pipeline; it has
no oracle twin. Statistical realism (note structure, covers) is what makes
catalogs built from it honest recall subjects, per VERDICT r2 weak #1.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HpfwConfig

COVER_PERIOD = 10          # every 10th track (i % 10 == 3) is a cover
COVER_SHIFT_ST = 0.25      # cover pitch shift, semitones
N_PARTIALS = 6
NOISE_DB = -30.0


def cover_source(track_id: int) -> int | None:
    """The track a given id covers, or None if it is an original."""
    return track_id - 3 if (track_id % COVER_PERIOD == 3 and track_id >= 3) else None


def _render_one(key, pitch_factor, t, duration_s, sr, fmin):
    """One track's PCM from its parameter key (shapes static, all device)."""
    out = jnp.zeros_like(t)
    for p in range(N_PARTIALS):
        kp = jax.random.fold_in(key, p)
        u = jax.random.uniform(kp, (7,), dtype=jnp.float32)
        semi = jnp.floor(u[0] * 60.0)                       # 5 octaves, chromatic
        pitch = fmin * 2.0 ** (semi / 12.0) * pitch_factor
        vib_rate = 3.0 + 4.0 * u[1]
        vib = 1.0 + 0.002 * jnp.sin(2 * jnp.pi * vib_rate * t
                                    + 2 * jnp.pi * u[2])
        onset = 0.5 * u[3] * duration_s
        length = (0.3 + 0.7 * u[4]) * duration_s
        env = (jnp.clip((t - onset) / 0.05, 0.0, 1.0)
               * jnp.clip((onset + length - t) / 0.2, 0.0, 1.0))
        amp = 0.1 + 0.4 * u[5]
        out = out + amp * env * jnp.sin(
            2 * jnp.pi * pitch * vib * t + 2 * jnp.pi * u[6])
    kc = jax.random.fold_in(key, N_PARTIALS)
    uc = jax.random.uniform(kc, (2,), dtype=jnp.float32)
    f0 = fmin * 2.0 ** (2.0 * uc[0]) * pitch_factor
    f1 = f0 * 2.0 ** (1.0 + 2.0 * uc[1])
    sweep = f0 * (f1 / f0) ** (t / duration_s)
    out = out + 0.2 * jnp.sin(2 * jnp.pi * jnp.cumsum(sweep) / sr)
    return out


def _render_one_live(key, pitch_factor, stretch, t, duration_s, sr, fmin):
    """A LIVE RENDITION of the track `key` parametrizes: same notes, but
    played in a (possibly) different key and at a (possibly) different
    tempo — the two axes real live performances move on (SURVEY.md §1.1).

    `stretch` is the tempo factor: score time runs at stretch x real time
    (onsets, note lengths, vibrato, and the chirp's frequency trajectory
    compress/expand) while instantaneous PITCH is untouched — a band
    playing the same song 3% faster. `pitch_factor` scales every frequency
    (playing in a different key) without changing timing. This deliberately
    mirrors _render_one's parameter decoding EXACTLY (same fold_in/uniform
    stream) so the rendition shares the catalog track's score; it is a
    separate function so the catalog render program stays untouched (its
    f32 chirp phase is fusion-sensitive — see synth_batch's B=1 note)."""
    ts = t * stretch                  # score-time position of each sample
    out = jnp.zeros_like(t)
    for p in range(N_PARTIALS):
        kp = jax.random.fold_in(key, p)
        u = jax.random.uniform(kp, (7,), dtype=jnp.float32)
        semi = jnp.floor(u[0] * 60.0)
        pitch = fmin * 2.0 ** (semi / 12.0) * pitch_factor
        vib_rate = 3.0 + 4.0 * u[1]
        vib = 1.0 + 0.002 * jnp.sin(2 * jnp.pi * vib_rate * ts
                                    + 2 * jnp.pi * u[2])
        onset = 0.5 * u[3] * duration_s
        length = (0.3 + 0.7 * u[4]) * duration_s
        env = (jnp.clip((ts - onset) / 0.05, 0.0, 1.0)
               * jnp.clip((onset + length - ts) / 0.2, 0.0, 1.0))
        amp = 0.1 + 0.4 * u[5]
        out = out + amp * env * jnp.sin(
            2 * jnp.pi * pitch * vib * t + 2 * jnp.pi * u[6])
    kc = jax.random.fold_in(key, N_PARTIALS)
    uc = jax.random.uniform(kc, (2,), dtype=jnp.float32)
    f0 = fmin * 2.0 ** (2.0 * uc[0]) * pitch_factor
    f1 = f0 * 2.0 ** (1.0 + 2.0 * uc[1])
    sweep = f0 * (f1 / f0) ** (ts / duration_s)
    out = out + 0.2 * jnp.sin(2 * jnp.pi * jnp.cumsum(sweep) / sr)
    return out


def _finish(out, noise_key, n):
    noise_amp = 10.0 ** (NOISE_DB / 20.0)
    out = out + noise_amp * jax.random.normal(noise_key, (n,), dtype=jnp.float32)
    peak = jnp.max(jnp.abs(out))
    return jnp.where(peak > 0, 0.9 * out / peak, out)


@functools.partial(jax.jit, static_argnames=("duration_s", "sr", "fmin",
                                             "base_seed", "pitch_st",
                                             "stretch"))
def _live_batch_jit(track_ids, *, duration_s, sr, fmin, base_seed,
                    pitch_st, stretch):
    """Live renditions of catalog tracks: pitch-shifted / time-stretched.

    Renders enough real-time samples to cover the whole score even when the
    performance is slower (stretch < 1)."""
    n = int(round(duration_s * sr / min(float(stretch), 1.0)))
    t = jnp.arange(n, dtype=jnp.float32) / sr
    base = jax.random.PRNGKey(base_seed)
    shift = jnp.float32(2.0 ** (float(pitch_st) / 12.0))

    def one(tid):
        is_cover = jnp.logical_and(tid % COVER_PERIOD == 3, tid >= 3)
        param_id = jnp.where(is_cover, tid - 3, tid)
        factor = jnp.where(is_cover,
                           jnp.float32(2.0 ** (COVER_SHIFT_ST / 12.0)),
                           jnp.float32(1.0)) * shift
        key = jax.random.fold_in(base, param_id)
        out = _render_one_live(key, factor, jnp.float32(float(stretch)), t,
                               duration_s, sr, fmin)
        return _finish(out, jax.random.fold_in(base, 1_000_003 + tid), n)

    return jax.lax.map(one, track_ids)


def live_query_batch(track_ids, start_samples, duration_s: float,
                     query_seconds: float, cfg: HpfwConfig, *,
                     pitch_st: float = 0.0, stretch: float = 1.0,
                     noise_db: float = -10.0, noise_seeds=None,
                     base_seed: int = 7000) -> jnp.ndarray:
    """Noisy LIVE-RENDITION query excerpts (the robustness axes live song
    ID exists for): the catalog track's score performed `pitch_st`
    semitones up/down and at `stretch` x tempo, then excerpted + noised
    exactly like query_batch. `start_samples` are CATALOG positions; the
    excerpt is taken where that content lands in the rendition
    (start / stretch). pitch_st=0, stretch=1 reproduces query_batch's
    audio to float32 rounding (asserted in tests/test_synth_jax.py)."""
    ids = np.asarray(track_ids, dtype=np.int32).reshape(-1)
    starts = np.asarray(np.round(np.asarray(start_samples) / stretch),
                        dtype=np.int32).reshape(-1)
    if noise_seeds is None:
        noise_seeds = 77_000 + ids
    nseeds = np.asarray(noise_seeds, dtype=np.int32).reshape(-1)
    b0 = ids.shape[0]
    if b0 == 1:  # see synth_batch: single-iteration lax.map fuses differently
        ids, starts, nseeds = (np.concatenate([a, a])
                               for a in (ids, starts, nseeds))
    full = _live_batch_jit(jnp.asarray(ids), duration_s=float(duration_s),
                           sr=cfg.sample_rate, fmin=cfg.fmin,
                           base_seed=base_seed, pitch_st=float(pitch_st),
                           stretch=float(stretch))
    q_samples = int(round(query_seconds * cfg.sample_rate))
    starts = np.minimum(starts, full.shape[1] - q_samples - 1)
    out = _excerpt_jit(full, jnp.asarray(starts), jnp.asarray(nseeds),
                       q_samples=q_samples, noise_db=float(noise_db))
    return out[:b0]


@functools.partial(jax.jit, static_argnames=("duration_s", "sr", "fmin",
                                             "base_seed"))
def _synth_batch_jit(track_ids, *, duration_s, sr, fmin, base_seed):
    n = int(round(duration_s * sr))
    t = jnp.arange(n, dtype=jnp.float32) / sr
    base = jax.random.PRNGKey(base_seed)

    def one(tid):
        is_cover = jnp.logical_and(tid % COVER_PERIOD == 3, tid >= 3)
        param_id = jnp.where(is_cover, tid - 3, tid)
        factor = jnp.where(is_cover,
                           jnp.float32(2.0 ** (COVER_SHIFT_ST / 12.0)),
                           jnp.float32(1.0))
        key = jax.random.fold_in(base, param_id)
        out = _render_one(key, factor, t, duration_s, sr, fmin)
        # Noise folds the ACTUAL id, so covers share notes, not samples.
        return _finish(out, jax.random.fold_in(base, 1_000_003 + tid), n)

    # lax.map (not vmap): bounds peak memory to one track's partial
    # temporaries regardless of batch size.
    return jax.lax.map(one, track_ids)


def synth_batch(track_ids, duration_s: float, cfg: HpfwConfig,
                *, base_seed: int = 7000) -> jnp.ndarray:
    """(B,) int32 track ids -> (B, N) float32 PCM, rendered on device."""
    ids = np.asarray(track_ids, dtype=np.int32).reshape(-1)
    # A single-iteration lax.map gets inlined and fused differently by XLA,
    # perturbing the f32 chirp phase vs the same track rendered in a batch
    # (measured ~-30 dB). Pad B=1 to 2 so every render runs the loop body.
    b0 = ids.shape[0]
    if b0 == 1:
        ids = np.concatenate([ids, ids])
    out = _synth_batch_jit(jnp.asarray(ids), duration_s=float(duration_s),
                           sr=cfg.sample_rate, fmin=cfg.fmin,
                           base_seed=base_seed)
    return out[:b0]


def artist_style(artist_seed: int) -> dict:
    """A persistent per-artist musical style (known-artist fixtures).

    Like io/synth.py's synth_artist_track: the artist seed fixes a scale
    (pitch-class subset), register, voice count, vibrato depth and chirp
    level shared by all of that artist's tracks, so per-artist
    context-window covariances genuinely differ and per-artist filter
    learning has signal to exploit (SURVEY.md §2.3 step 4). Style params
    are host-side (they become static jit args); rendering is on device.
    """
    arng = np.random.default_rng(100003 * artist_seed + 17)
    return {
        "scale": tuple(int(x) for x in
                       np.sort(arng.choice(12, size=arng.integers(5, 8),
                                           replace=False))),
        "octave_lo": int(arng.integers(0, 3)),
        "n_octaves": int(arng.integers(2, 4)),
        "n_partials": int(arng.integers(4, 10)),
        "vib_depth": float(arng.uniform(0.0005, 0.004)),
        "chirp_amp": float(arng.uniform(0.05, 0.3)),
    }


@functools.partial(jax.jit, static_argnames=(
    "duration_s", "sr", "fmin", "base_seed", "scale", "octave_lo",
    "n_octaves", "n_partials", "vib_depth", "chirp_amp"))
def _artist_batch_jit(track_ids, *, duration_s, sr, fmin, base_seed, scale,
                      octave_lo, n_octaves, n_partials, vib_depth, chirp_amp):
    n = int(round(duration_s * sr))
    t = jnp.arange(n, dtype=jnp.float32) / sr
    base = jax.random.PRNGKey(base_seed)
    scale_arr = jnp.asarray(scale, dtype=jnp.float32)

    def one(tid):
        key = jax.random.fold_in(base, tid)
        out = jnp.zeros_like(t)
        for p in range(n_partials):
            kp = jax.random.fold_in(key, p)
            u = jax.random.uniform(kp, (7,), dtype=jnp.float32)
            pc = scale_arr[jnp.floor(u[0] * len(scale)).astype(jnp.int32)]
            octave = octave_lo + jnp.floor(u[1] * n_octaves)
            pitch = fmin * 2.0 ** (octave + pc / 12.0)
            vib = 1.0 + vib_depth * jnp.sin(
                2 * jnp.pi * (3.0 + 4.0 * u[2]) * t + 2 * jnp.pi * u[3])
            onset = 0.5 * u[4] * duration_s
            length = (0.3 + 0.7 * u[5]) * duration_s
            env = (jnp.clip((t - onset) / 0.05, 0.0, 1.0)
                   * jnp.clip((onset + length - t) / 0.2, 0.0, 1.0))
            amp = 0.1 + 0.4 * jax.random.uniform(
                jax.random.fold_in(kp, 1), dtype=jnp.float32)
            out = out + amp * env * jnp.sin(
                2 * jnp.pi * pitch * vib * t + 2 * jnp.pi * u[6])
        kc = jax.random.fold_in(key, 1009)
        uc = jax.random.uniform(kc, (2,), dtype=jnp.float32)
        f0 = fmin * 2.0 ** (octave_lo + uc[0])
        f1 = f0 * 2.0 ** (1.0 + uc[1])
        sweep = f0 * (f1 / f0) ** (t / duration_s)
        out = out + chirp_amp * jnp.sin(2 * jnp.pi * jnp.cumsum(sweep) / sr)
        return _finish(out, jax.random.fold_in(key, 2_000_003), n)

    return jax.lax.map(one, track_ids)


def synth_artist_batch(artist_seed: int, track_ids, duration_s: float,
                       cfg: HpfwConfig, *, base_seed: int = 0) -> jnp.ndarray:
    """(B,) track ids -> (B, N) PCM in one artist's persistent style."""
    ids = np.asarray(track_ids, dtype=np.int32).reshape(-1)
    b0 = ids.shape[0]
    if b0 == 1:  # see synth_batch: single-iteration lax.map fuses differently
        ids = np.concatenate([ids, ids])
    style = artist_style(artist_seed)
    out = _artist_batch_jit(
        jnp.asarray(ids), duration_s=float(duration_s), sr=cfg.sample_rate,
        fmin=cfg.fmin, base_seed=1_000_000_007 * artist_seed + base_seed,
        **style)
    return out[:b0]


@functools.partial(jax.jit, static_argnames=("q_samples", "noise_db"))
def _excerpt_jit(full, starts, noise_seeds, *, q_samples, noise_db):
    def one(pcm, start, nseed):
        clip = jax.lax.dynamic_slice_in_dim(pcm, start, q_samples)
        rms = jnp.sqrt(jnp.mean(clip ** 2)) + 1e-12
        noise = jax.random.normal(jax.random.PRNGKey(nseed), (q_samples,),
                                  dtype=jnp.float32)
        noise = noise * (rms * 10.0 ** (noise_db / 20.0)
                         / (jnp.sqrt(jnp.mean(noise ** 2)) + 1e-12))
        clip = clip + noise
        peak = jnp.max(jnp.abs(clip))
        return jnp.where(peak > 1.0, clip / peak, clip)

    return jax.lax.map(lambda a: one(*a), (full, starts, noise_seeds))


def query_batch(track_ids, start_samples, duration_s: float,
                query_seconds: float, cfg: HpfwConfig, *,
                noise_db: float = -10.0, noise_seeds=None,
                base_seed: int = 7000) -> jnp.ndarray:
    """Noisy query excerpts of catalog tracks, rendered on device.

    track_ids (B,), start_samples (B,) -> (B, Q) float32. The track render
    runs through the SAME compiled program as synth_batch (excerpting is a
    separate jit) so query audio is bit-identical to the catalog's — nesting
    the render in a larger jit changes XLA fusion enough to jitter the f32
    chirp phase by ~-30 dB.
    """
    ids = np.asarray(track_ids, dtype=np.int32).reshape(-1)
    starts = np.asarray(start_samples, dtype=np.int32).reshape(-1)
    if noise_seeds is None:
        noise_seeds = 77_000 + ids
    nseeds = np.asarray(noise_seeds, dtype=np.int32).reshape(-1)
    b0 = ids.shape[0]
    if b0 == 1:  # see synth_batch: single-iteration lax.map fuses differently
        ids, starts, nseeds = (np.concatenate([a, a])
                               for a in (ids, starts, nseeds))
    full = synth_batch(ids, duration_s, cfg, base_seed=base_seed)
    out = _excerpt_jit(
        full, jnp.asarray(starts), jnp.asarray(nseeds),
        q_samples=int(round(query_seconds * cfg.sample_rate)),
        noise_db=float(noise_db))
    return out[:b0]
