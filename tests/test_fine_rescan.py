"""Fine rescan: the band gather against a per-offset numpy reference and the
exhaustive matcher — exact scores, first best offset, masked tails."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hpfw_jax import oracle
from hpfw_jax.match import matcher
from hpfw_jax.match.scaled import _fine_rescan


def _np_band(q, track, length, start, n_fine):
    """Best exact similarity over offsets start..start+n_fine-1 (the
    oracle's per-offset score, masked past `length`), first offset on
    ties; (-1, start) when no offset is valid."""
    n = q.shape[0]
    best, first = -1, start
    for o in range(start, start + n_fine):
        if o > max(length - n, 0):
            continue
        sc = 0
        for j in range(n):
            if o + j < length:
                x = np.bitwise_xor(track[o + j], q[j])
                sc += 64 - int(np.bitwise_count(x).sum())
        if sc > best:
            best, first = sc, o
    return best, first


@pytest.mark.parametrize("fw", [2, 8])
def test_fine_rescan_matches_oracle(fw):
    """Short tracks, a track shorter than the query, bands clamped at both
    ends, planted exact and near peaks."""
    rng = np.random.default_rng(0)
    t, l, n = 12, 90, 30
    n_fine = 2 * fw + 1
    span = n + n_fine - 1
    prints = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
    lengths = np.array([l, 60, 20, l, 45, l, l, 33, l, l, 70, l], np.int32)
    for i, ln in enumerate(lengths):
        prints[i, ln:] = 0
    qs = rng.integers(0, 2 ** 32, (2, n, 2), dtype=np.uint32)
    prints[3, 17:17 + n] = qs[0]
    prints[6, 40:40 + n] = qs[1]
    prints[6, 40 + 1:40 + 1 + n][::3] = qs[1][::3]     # a near-duplicate peak
    cand = np.stack([np.arange(t), np.roll(np.arange(t), 5)]).astype(np.int32)
    centers = rng.integers(0, l, (2, t)).astype(np.int32)
    centers[0, 3], centers[1, 1] = 17, 40
    starts = np.clip(centers - fw, 0, l - span).astype(np.int32)
    s, o = _fine_rescan(jnp.asarray(qs), jnp.asarray(prints),
                        jnp.asarray(lengths), jnp.asarray(cand),
                        jnp.asarray(starts), n_fine=n_fine)
    s, o = np.asarray(s), np.asarray(o)
    for b in range(2):
        for k in range(t):
            tr = cand[b, k]
            want = _np_band(qs[b], prints[tr], lengths[tr], starts[b, k],
                            n_fine)
            assert (s[b, k], o[b, k]) == want, (b, k)
    assert s[0, 3] == 64 * n and o[0, 3] == 17


def test_fine_rescan_full_band_equals_dense_matcher():
    """A band wide enough to cover every offset reproduces the exhaustive
    matcher (and so the oracle) exactly."""
    rng = np.random.default_rng(1)
    t, l, n = 6, 50, 20
    prints = rng.integers(0, 2 ** 32, (t, l, 2), dtype=np.uint32)
    lengths = np.array([l, 41, l, 27, l, 36], np.int32)
    for i, ln in enumerate(lengths):
        prints[i, ln:] = 0
    q = prints[2, 11:11 + n] ^ np.uint32(1)
    n_fine = l - n + 1
    s, o = _fine_rescan(jnp.asarray(q[None]), jnp.asarray(prints),
                        jnp.asarray(lengths),
                        jnp.arange(t, dtype=jnp.int32)[None],
                        jnp.zeros((1, t), jnp.int32), n_fine=n_fine)
    sd, od = matcher.score_tracks(jnp.asarray(q), jnp.asarray(prints),
                                  jnp.asarray(lengths))
    np.testing.assert_array_equal(np.asarray(s[0]), np.asarray(sd))
    np.testing.assert_array_equal(np.asarray(o[0]), np.asarray(od))
    for i in range(t):
        assert int(sd[i]) == oracle.match_track(q, prints[i, :lengths[i]])[0]


def test_fine_rescan_gathers_band_with_2d_indices():
    """The band gather never forms a flat (track * L + position) offset —
    the program holds no int32 product of a track index and a row length,
    which would overflow past 2^31 words at catalog scale."""
    q = jax.ShapeDtypeStruct((2, 16, 2), jnp.uint32)
    p = jax.ShapeDtypeStruct((64, 100, 2), jnp.uint32)
    ln = jax.ShapeDtypeStruct((64,), jnp.int32)
    c = jax.ShapeDtypeStruct((2, 8), jnp.int32)
    jaxpr = jax.make_jaxpr(lambda *a: _fine_rescan(*a, n_fine=5))(
        q, p, ln, c, c)
    gathers = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "gather"]
    assert gathers and all(e.invars[1].aval.shape[-1] == 2 for e in gathers
                           if e.invars[0].aval.ndim == 3)
    assert not any(e.primitive.name == "mul" for e in jaxpr.jaxpr.eqns)
