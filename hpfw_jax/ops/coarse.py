"""Coarse fingerprint derivation for the two-stage 1M-track matcher.

A full-resolution linear scan of a million tracks is bandwidth-impossible
(~80 GB of packed prints per pass; SURVEY.md §6 flags the memory/cost wall),
so matching runs in two stages (SURVEY.md §7.4.4):

  coarse: a temporally smoothed, stride-s summary print per s frames,
          scanned for ALL tracks as an int8 +/-1 correlation GEMM;
  fine:   the exact XOR+popcount scan, restricted to the top candidates in
          a +/-s offset window around each coarse peak.

The coarse print is a per-bit MAJORITY VOTE over s consecutive full-res
prints. Unlike plain decimation (which collapses when query/DB strides are
out of phase), majority windows overlap a misaligned query window by
(s-r)/s, so coarse correlation degrades gracefully with phase error r —
the coarse stage only has to put the true track into the candidate pool;
exactness comes from the fine stage.

Derived purely from packed prints, so databases need no extra pipeline
output and streaming queries can build them on the fly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def unpack_bits_pm1(packed: jnp.ndarray, dtype=jnp.int8) -> jnp.ndarray:
    """(..., 2) uint32 packed prints -> (..., 64) +/-1 (lsb0 bit order)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[..., :, None] >> shifts) & jnp.uint32(1)   # (..., 2, 32)
    bits = bits.reshape(*packed.shape[:-1], 64)
    return (bits.astype(jnp.int32) * 2 - 1).astype(dtype)


def coarse_pm1(packed: jnp.ndarray, stride: int, *, dtype=jnp.int8,
               kind: str = "sign", channels: int = 64) -> jnp.ndarray:
    """Coarse summary prints per stride-window of full-res prints.

    packed: (L, 2) or (T, L, 2) uint32. Returns (Lc, C) or (T, Lc, C)
    with Lc = L // stride (tail prints beyond the last full window drop)
    and C = `channels` <= 64: hashprint channels are PCA-ordered (filter 0
    = top eigenvector), so the first C are each print's most informative
    bits — C < 64 shrinks coarse bytes by C/64 at the same stride
    (the recall cost was measured before the GPU port, see git history).

    kind="sign": majority vote — sign of the per-bit +/-1 sum; ties (even s)
    break to -1, fixed and identical everywhere.
    kind="sum":  the per-bit +/-1 window SUM itself (range +/-stride) — the
    same int8 bytes carrying log2(stride)+1 extra nominal bits per channel.
    Measured WORSE than "sign" at 10k real-audio tracks at every stride x
    pool point (pre-GPU run, see git history; the sum's magnitude variance
    pollutes coarse ranking), so "sign" is the default — this stays as the
    measured alternative. Requires stride <= 127 to fit int8.
    """
    squeeze = packed.ndim == 2
    if squeeze:
        packed = packed[None]
    t, l, _ = packed.shape
    lc = l // stride
    pm1 = unpack_bits_pm1(packed[:, : lc * stride], jnp.int32)
    sums = pm1.reshape(t, lc, stride, 64).sum(axis=2)
    if kind == "sum":
        assert stride <= 127, "sum coarse prints need stride <= 127 (int8)"
        out = sums.astype(dtype)
    else:
        out = jnp.where(sums > 0, 1, -1).astype(dtype)
    if channels < 64:
        out = out[:, :, :channels]
    return out[0] if squeeze else out


def coarse_lengths(lengths: jnp.ndarray, stride: int) -> jnp.ndarray:
    """Full-res lengths -> number of complete coarse windows per track."""
    return lengths // stride


def phase_matrix(query_cs: jnp.ndarray, s: int, k: int) -> jnp.ndarray:
    """(B, Nc, C) coarse queries -> (k, B*s) phase-shift matrix, same dtype.

    Column b*s + r holds query b shifted down r windows in the flat
    (window-major, channel-minor) coarse layout, so a flat coarse row
    x (Lc*C,) dotted with column b*s + r is query b's correlation at
    coarse offset r. Rows past k are cut off (they only feed offsets that
    run past the track) and rows past the query are zero.
    """
    b, nc, c = query_cs.shape
    row = jnp.arange(k, dtype=jnp.int32)[:, None]
    src = row - jnp.arange(s, dtype=jnp.int32)[None, :] * c      # (k, s)
    ok = (src >= 0) & (src < nc * c)
    flat = query_cs.reshape(b, nc * c)
    w = jnp.where(ok[None], flat[:, jnp.clip(src, 0, nc * c - 1)], 0)
    return w.astype(query_cs.dtype).transpose(1, 0, 2).reshape(k, b * s)


def coarse_correlation_batch(
    query_cs: jnp.ndarray,  # (B, Nc, C) int8 (equal-length queries)
    db_c: jnp.ndarray,      # (T, Lc, C) int8, zero where padded
) -> jnp.ndarray:
    """corr(b, t, a) = sum_j q_b(j) . d(t, a+j): (B, T, Lc - Nc + 1) int32.

    One int8 GEMM with int32 accumulation, exact for any int8 values: the
    flat coarse rows (T, Lc*C) — a free reshape of the stored layout —
    times the (Lc*C, B*s) phase matrix, with s the offset count rounded up
    to a multiple of 8. Every track's bytes are read once for the whole
    batch; the phase matrix spends ~Lc/Nc times the useful MACs to keep the
    product a plain dense GEMM. Padded coarse positions are 0 and
    contribute nothing.
    """
    b, nc, c = query_cs.shape
    t, lc, _ = db_c.shape
    n_off = lc - nc + 1
    if n_off <= 0:
        return jnp.zeros((b, t, max(n_off, 0)), jnp.int32)
    s = -(-n_off // 8) * 8
    w = phase_matrix(query_cs.astype(jnp.int8), s, lc * c)
    corr = jax.lax.dot_general(
        db_c.astype(jnp.int8).reshape(t, lc * c), w,
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    return corr.reshape(t, b, s)[:, :, :n_off].transpose(1, 0, 2)


def coarse_correlation(query_c: jnp.ndarray, db_c: jnp.ndarray) -> jnp.ndarray:
    """Single-query coarse_correlation_batch: (T, Lc - Nc + 1) int32."""
    return coarse_correlation_batch(query_c[None], db_c)[0]


def coarse_best(query_cs: jnp.ndarray, db_c: jnp.ndarray):
    """Per (query, track) best correlation and FIRST best coarse offset.

    ((B, T), (B, T)) int32 — the coarse stage's whole output. Plain XLA:
    the GEMM of coarse_correlation_batch, then max and argmax (which takes
    the first index on ties) over the offsets.
    """
    corr = coarse_correlation_batch(query_cs, db_c)
    return jnp.max(corr, axis=2), jnp.argmax(corr, axis=2).astype(jnp.int32)
