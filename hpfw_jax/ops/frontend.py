"""CQT front end — GEMM-native NDFT.

The reference computes its spectrogram frame-by-frame with an FFT on CPU
(SURVEY.md §2.1 row 2; mount empty, reconstructed). On an accelerator the
idiomatic formulation is one big matmul: frame the PCM, then multiply by a
dense complex NDFT kernel matrix (real and imaginary parts as two f32
GEMMs). No FFT butterflies, no per-bin loops, static shapes throughout —
XLA hands the (F x frame_len) @ (frame_len x n_bins) contraction to its
GEMM library. (GEMM-native NDFT frontends: PAPERS.md, MelT.)

All GEMMs run at float32-grade precision (ops/dot.py) so results track the
float64 oracle to ~1e-5 relative or better — the margin-audit tests
(tests/test_pipeline.py) quantify the agreement at the bit level.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HpfwConfig
from ..oracle.pipeline import cqt_kernel_matrix
from .dot import precise_dot


@functools.lru_cache(maxsize=8)
def cqt_kernel_arrays(cfg: HpfwConfig) -> tuple[np.ndarray, np.ndarray]:
    """The oracle's complex NDFT kernel as two float32 matrices (re, im).

    Shape (frame_len, n_bins) each. Cached per config; computed in float64
    then rounded once to float32 so every caller sees identical weights.
    """
    k = cqt_kernel_matrix(cfg)
    return (
        np.ascontiguousarray(k.real, dtype=np.float32),
        np.ascontiguousarray(k.imag, dtype=np.float32),
    )


def frame_signal(pcm: jnp.ndarray, cfg: HpfwConfig) -> jnp.ndarray:
    """(S,) PCM -> (F, frame_len) overlapping frames; F is static given S.

    Frame t = pcm[t*hop : t*hop + frame_len], identical to the oracle.

    Gather-free: when hop divides frame_len (the default: 8192 = 16*512),
    each frame is a run of frame_len//hop consecutive hop-blocks, so framing
    is frame_len//hop shifted static slices of the block-reshaped signal —
    pure copies that XLA handles at memcpy speed.
    """
    f = cfg.n_frames(pcm.shape[0])
    if f == 0:
        return jnp.zeros((0, cfg.frame_len), pcm.dtype)
    if cfg.frame_len % cfg.hop == 0:
        r = cfg.frame_len // cfg.hop
        n_blocks = f - 1 + r
        blocks = jax.lax.slice(pcm, (0,), (n_blocks * cfg.hop,)).reshape(n_blocks, cfg.hop)
        return jnp.concatenate(
            [jax.lax.dynamic_slice_in_dim(blocks, j, f, axis=0) for j in range(r)],
            axis=1,
        )
    idx = (
        jnp.arange(cfg.frame_len, dtype=jnp.int32)[None, :]
        + cfg.hop * jnp.arange(f, dtype=jnp.int32)[:, None]
    )
    return pcm[idx]


def cqt(pcm: jnp.ndarray, cfg: HpfwConfig) -> jnp.ndarray:
    """Log-magnitude CQT, shape (F, n_bins) float32.

    spec = log(eps + |frames @ K|) with the complex GEMM split into two real
    GEMMs. Mirrors oracle.cqt bit-for-bit up to f32-grade rounding (see
    ops/dot.py for the precision story).
    """
    return cqt_from_frames(frame_signal(pcm.astype(jnp.float32), cfg), cfg)


def cqt_from_frames(frames: jnp.ndarray, cfg: HpfwConfig) -> jnp.ndarray:
    """CQT for pre-framed input (streaming path reuses frames).

    Real and imaginary kernels are concatenated column-wise so the complex
    NDFT is ONE (F x frame_len) @ (frame_len x 2*n_bins) GEMM — precise dots
    are expensive to compile on this stack, so the pipeline keeps their
    count minimal (2 total: NDFT here, projection in ops/fingerprint.py).
    """
    kr, ki = cqt_kernel_arrays(cfg)
    k = jnp.asarray(np.concatenate([kr, ki], axis=1))
    reim = precise_dot(frames.astype(jnp.float32), k)
    re = reim[:, : cfg.n_bins]
    im = reim[:, cfg.n_bins:]
    mag = jnp.sqrt(re * re + im * im)
    return jnp.log(cfg.log_eps + mag)
