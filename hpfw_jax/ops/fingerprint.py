"""Fingerprint stage: context projection + delta + sign + bit-pack (jnp path).

The reference's hashprint encoder projects spectro-temporal context windows
onto 64 learned filters, takes a time-lagged delta, sign-binarizes, and packs
to a 64-bit word per frame (SURVEY.md §2.3 steps 3-7; §2.1 row 5).

Formulation: instead of materializing (M, n_bins*w) context vectors, the
projection is folded into w small GEMMs against filter slices —
y(n) = sum_j spec[n+j] @ F_j — without the w-fold memory blow-up.
Bit-packing uses shifts + sums over a (M, 2, 32) bit cube; JAX keeps 64-bit
integers off by default, so hashprints are (N, 2) uint32 words everywhere
(word 0 = filters 0..31, lsb0 — see oracle.pack_bits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import HpfwConfig
from .dot import precise_dot


def project_features(spec: jnp.ndarray, filters: jnp.ndarray, cfg: HpfwConfig) -> jnp.ndarray:
    """y(n) = F^T x(n) over context windows, shape (F-w+1, 64).

    filters: (context_dim, 64) = (n_bins * w, 64), time-major layout
    (filter rows j*n_bins:(j+1)*n_bins act on spec frame n+j).
    """
    f, b = spec.shape
    w = cfg.context_w
    m = f - w + 1
    # Materialize the context windows (w shifted copies, cheap) and project
    # with ONE precise GEMM — precise dots compile slowly on this stack, so
    # one (M x D) @ (D x 64) beats w skinny ones (and runs faster too).
    x = jnp.concatenate(
        [jax.lax.dynamic_slice_in_dim(spec, j, m, axis=0) for j in range(w)],
        axis=1,
    )
    return precise_dot(x, filters.astype(jnp.float32))


def delta(y: jnp.ndarray, cfg: HpfwConfig) -> jnp.ndarray:
    """d(n) = y(n) - y(n+T), shape (M-T, 64)."""
    t = cfg.delta_lag
    return y[:-t] - y[t:]


def pack_bits(bits: jnp.ndarray, cfg: HpfwConfig) -> jnp.ndarray:
    """(N, 64) bool -> (N, 2) uint32 packed words, matching oracle.pack_bits."""
    n = bits.shape[0]
    b = bits.astype(jnp.uint32).reshape(n, 2, 32)
    if cfg.bit_order == "lsb0":
        shifts = jnp.arange(32, dtype=jnp.uint32)
    else:  # msb0: filter i -> bit (63-i); within each word reverse order
        b = b[:, ::-1, :]
        shifts = jnp.arange(31, -1, -1, dtype=jnp.uint32)
    return jnp.sum(b << shifts[None, None, :], axis=2).astype(jnp.uint32)


def unpack_bits(packed: jnp.ndarray, cfg: HpfwConfig) -> jnp.ndarray:
    """(N, 2) uint32 -> (N, 64) bool; inverse of pack_bits."""
    n = packed.shape[0]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    if cfg.bit_order == "msb0":
        bits = bits[:, ::-1, ::-1]
    return bits.reshape(n, 64).astype(bool)


def binarize_and_pack(d: jnp.ndarray, cfg: HpfwConfig) -> jnp.ndarray:
    bits = d > 0.0 if cfg.tie_break == "gt" else d >= 0.0
    return pack_bits(bits, cfg)


def fingerprint_from_spec(spec: jnp.ndarray, filters: jnp.ndarray, cfg: HpfwConfig) -> jnp.ndarray:
    """CQT spectrogram -> packed hashprints (N, 2) uint32."""
    y = project_features(spec, filters, cfg)
    return binarize_and_pack(delta(y, cfg), cfg)
