"""The candidate Triton-route sweep kernel of benchmarks/triton_sweep.py in
interpret mode against XLA's int8 GEMM (ops/coarse.coarse_best): exact
int32 scores and first best offsets, at the tile shapes its sweep times."""

import importlib.util
import os

import numpy as np
import pytest

import jax.numpy as jnp

from hpfw_jax.ops import coarse as coarse_ops

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "benchmarks", "triton_sweep.py")
_spec = importlib.util.spec_from_file_location("triton_sweep", _PATH)
triton_sweep = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(triton_sweep)


def _mk(rng, t, lc, nc, b, c):
    q = rng.choice([-1, 1], (b, nc, c)).astype(np.int8)
    d = rng.choice([-1, 1], (t, lc, c)).astype(np.int8)
    for i, ln in enumerate(rng.integers(0, lc + 1, size=t)):
        d[i, ln:] = 0                       # short and empty tracks
    return q, d


@pytest.mark.parametrize("tiles", [
    dict(tt=64, L=64, P=8, KB=64),
    dict(tt=128, L=64, P=8, KB=128),
    dict(tt=64, L=128, P=16, KB=128),
])
@pytest.mark.parametrize("b", [2, 5])
def test_candidate_sweep_equals_gemm(tiles, b):
    """Ragged track tiles, one and several lane blocks, padded row counts,
    zero-padded tracks: kernel == GEMM, offsets first on ties."""
    rng = np.random.default_rng(b)
    q, d = _mk(rng, 70, 30, 6, b, 32)
    d[9] = d[3]                             # cross-track ties
    q[0] = d[5, 4:10]                       # a planted peak
    got = triton_sweep.sweep(jnp.asarray(q), jnp.asarray(d), interpret=True,
                             **tiles)
    want = coarse_ops.coarse_best(jnp.asarray(q), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert int(got[0][0, 5]) == 6 * 32 and int(got[1][0, 5]) == 4
