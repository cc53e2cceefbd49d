"""Precision-controlled matmul for the bit-exactness contract.

The hashprint contract needs float32-grade GEMMs (SURVEY.md §7.4.1): a
reduced-precision product (bf16, or TF32, which a GPU applies to float32
dots at default precision) flips hashprint bits against the float64
oracle. Every extraction GEMM therefore runs at Precision.HIGHEST: true
float32, no TF32.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

PRECISION = lax.Precision.HIGHEST


def precise_dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a @ b in true float32 (no TF32, no bf16 passes)."""
    return jnp.dot(a, b, precision=PRECISION)
