"""Projection-filter learning on device: streaming covariance + eigh.

The reference accumulates a covariance of spectro-temporal context vectors
over a training corpus and takes the top-64 eigenvectors as filters
(SURVEY.md §2.1 row 4, §3.2). Device version: per-track X^T X rank-k
updates are (context_dim x M) @ (M x context_dim) GEMMs
(context_dim ~ 2420 -> a ~2420^2 matrix, trivial for eigh), accumulated in
float32 at f32-grade dot precision (ops/dot.py); the eigendecomposition runs via
jnp.linalg.eigh.

The accumulator state is a plain pytree and serializes to .npz, making
filter learning resumable mid-corpus (SURVEY.md §5 "Checkpoint/resume").
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HpfwConfig
from ..ops import frontend
from ..ops.dot import precise_dot


@dataclasses.dataclass
class CovarianceState:
    """Streaming (sum X^T X, sum X, count) over context vectors."""
    xtx: np.ndarray    # (D, D) float32
    xsum: np.ndarray   # (D,) float32
    count: int

    @classmethod
    def zero(cls, cfg: HpfwConfig) -> "CovarianceState":
        d = cfg.context_dim
        return cls(np.zeros((d, d), np.float32), np.zeros(d, np.float32), 0)

    def save(self, path: str) -> None:
        np.savez_compressed(path, xtx=self.xtx, xsum=self.xsum,
                            count=np.int64(self.count))

    @classmethod
    def load(cls, path: str) -> "CovarianceState":
        z = np.load(path)
        return cls(z["xtx"], z["xsum"], int(z["count"]))


@functools.lru_cache(maxsize=16)
def _track_moments_jit(cfg: HpfwConfig, n_samples: int):
    """Jitted PCM -> (X^T X, sum X, count) for one track of fixed length."""

    def run(pcm):
        spec = frontend.cqt(pcm, cfg)
        f, b = spec.shape
        w = cfg.context_w
        m = f - w + 1
        # Materialize context windows once per track: (M, D). For typical
        # tracks this is tens of MB — fine in device memory, and the X^T X
        # GEMM is one large matrix product.
        x = jnp.concatenate(
            [jax.lax.dynamic_slice_in_dim(spec, j, m, axis=0) for j in range(w)],
            axis=1,
        )
        xtx = precise_dot(x.T, x)
        return xtx, jnp.sum(x, axis=0), m

    return jax.jit(run)


def accumulate_track(state: CovarianceState, pcm: np.ndarray, cfg: HpfwConfig) -> CovarianceState:
    """Fold one training track into the covariance accumulator."""
    pcm = np.asarray(pcm, dtype=np.float32).reshape(-1)
    if cfg.n_frames(pcm.shape[0]) < cfg.context_w:
        return state
    xtx, xsum, m = _track_moments_jit(cfg, pcm.shape[0])(jnp.asarray(pcm))
    return CovarianceState(
        state.xtx + np.asarray(xtx),
        state.xsum + np.asarray(xsum),
        state.count + int(m),
    )


def finalize_filters(state: CovarianceState, cfg: HpfwConfig) -> np.ndarray:
    """Covariance -> top-64 eigenvector filters, deterministic signs.

    eigh runs in float64 on host (the matrix is small and eigenvector
    accuracy directly controls downstream bit margins); sign convention
    matches oracle.fix_eigenvector_signs.
    """
    if state.count == 0:
        raise ValueError("no context windows accumulated")
    mean = state.xsum.astype(np.float64) / state.count
    cov = state.xtx.astype(np.float64) / state.count - np.outer(mean, mean)
    _, evecs = np.linalg.eigh(cov)
    top = evecs[:, ::-1][:, : cfg.n_filters]
    from ..oracle.pipeline import fix_eigenvector_signs

    return fix_eigenvector_signs(top).astype(np.float32)


def learn_filters(corpus: list[np.ndarray], cfg: HpfwConfig) -> np.ndarray:
    state = CovarianceState.zero(cfg)
    for pcm in corpus:
        state = accumulate_track(state, pcm, cfg)
    return finalize_filters(state, cfg)
