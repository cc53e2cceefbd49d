"""Coarse sweep (XLA's int8 phase GEMM, ops/coarse.coarse_best) against a
numpy correlation — exact int32 equality, first best offset on ties.

The same program runs at catalog width on the card in
tests/test_gpu_kernels.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hpfw_jax.ops import coarse as coarse_ops


def _np_best(qs, d):
    """numpy reference over (B, Nc, C) queries and (T, Lc, C) rows."""
    nc = qs.shape[1]
    win = np.lib.stride_tricks.sliding_window_view(
        d.astype(np.int64), nc, axis=1)               # (T, off, C, Nc)
    corr = np.einsum("bjc,tocj->bto", qs.astype(np.int64), win)
    return corr.max(-1), corr.argmax(-1)


def _sweep(qs, d):
    b, i = coarse_ops.coarse_best(jnp.asarray(qs), jnp.asarray(d))
    return np.asarray(b), np.asarray(i)


def _mk(rng, t, lc, nc, b=1, c=64, lengths=None):
    q = rng.choice([-1, 1], (b, nc, c)).astype(np.int8)
    d = rng.choice([-1, 1], (t, lc, c)).astype(np.int8)
    if lengths is not None:
        for i, ln in enumerate(lengths):
            d[i, ln:] = 0
    return q, d


@pytest.mark.parametrize("lc,nc,b", [(19, 5, 1), (40, 5, 3), (40, 11, 2)])
def test_pallas_coarse_equals_xla(lc, nc, b):
    """Offset counts that are and are not multiples of 8 (the phase
    matrix pads them), single and batched queries; GEMM == numpy."""
    rng = np.random.default_rng(0)
    t = 32
    q, d = _mk(rng, t, lc, nc, b, lengths=rng.integers(nc, lc + 1, size=t))
    want = _np_best(q, d)
    got = _sweep(q, d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_pallas_coarse_first_argmax_on_ties():
    """Planted equal peaks: the reported offset must be the FIRST best."""
    rng = np.random.default_rng(1)
    nc, lc, t = 4, 40, 16
    q = rng.choice([-1, 1], (1, nc, 64)).astype(np.int8)
    d = np.zeros((t, lc, 64), np.int8)
    for i in range(t):
        d[i, 3:3 + nc] = q[0]      # peak at offset 3
        d[i, 11:11 + nc] = q[0]    # identical peak, same block
        d[i, 30:30 + nc] = q[0]    # identical peak, later block
    best, idx = _sweep(q, d)
    want = _np_best(q, d)
    np.testing.assert_array_equal(best, want[0])
    np.testing.assert_array_equal(idx, want[1])
    assert np.all(idx == 3)


def test_pallas_coarse_zero_padded_tracks_score_zero():
    rng = np.random.default_rng(2)
    nc, lc, t = 3, 10, 16
    q, d = _mk(rng, t, lc, nc)
    d[t // 2:] = 0   # padded track slots
    best, idx = _sweep(q, d)
    assert np.all(best[0, t // 2:] == 0) and np.all(idx[0, t // 2:] == 0)
    np.testing.assert_array_equal(best, _np_best(q, d)[0])


def test_pallas_coarse_sum_valued_prints():
    """Exactness for sum-kind coarse prints (values beyond +/-1)."""
    rng = np.random.default_rng(5)
    t, lc, nc = 32, 30, 6
    q = rng.integers(-16, 17, (2, nc, 64)).astype(np.int8)
    d = rng.integers(-16, 17, (t, lc, 64)).astype(np.int8)
    want = _np_best(q, d)
    got = _sweep(q, d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_coarse_sum_kind_definition(cfg):
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, (40, 64)).astype(bool)
    from hpfw_jax import oracle
    packed = oracle.pack_bits(bits, cfg)
    c = np.asarray(coarse_ops.coarse_pm1(jnp.asarray(packed), 8, kind="sum"))
    pm1 = bits.astype(np.int32) * 2 - 1
    np.testing.assert_array_equal(c, pm1.reshape(5, 8, 64).sum(1))


def test_pallas_coarse_stacked_equals_single():
    """A batch sweep of 9 queries == each query swept alone, with
    cross-track ties and variable lengths."""
    rng = np.random.default_rng(7)
    t, lc, nc, b = 32, 37, 5, 9
    q, d = _mk(rng, t, lc, nc, b, lengths=rng.integers(0, lc + 1, size=t))
    d[3] = d[7]                       # force cross-track (and offset) ties
    best_b, idx_b = _sweep(q, d)
    assert best_b.shape == (b, t)
    for k in range(b):
        best_1, idx_1 = _sweep(q[k:k + 1], d)
        np.testing.assert_array_equal(best_b[k], best_1[0])
        np.testing.assert_array_equal(idx_b[k], idx_1[0])


def test_pallas_coarse_reduced_channels():
    """C<64 coarse prints (top-PCA-channel slices) stay exact."""
    rng = np.random.default_rng(9)
    t, lc, nc, c = 32, 36, 5, 32
    q, d = _mk(rng, t, lc, nc, 3, c=c, lengths=rng.integers(nc, lc + 1, size=t))
    want = _np_best(q, d)
    got = _sweep(q, d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_pallas_coarse_rescan_stacked_block_diagonal():
    """Two-pass pass 2: variant v of query q scanned against ONLY query q's
    gathered rows (the vmapped GEMM of the matcher) == a per-variant scan
    of that subset."""
    rng = np.random.default_rng(11)
    t, lc, nc, b, m = 48, 37, 5, 3, 16
    _, d = _mk(rng, t, lc, nc, lengths=rng.integers(nc, lc + 1, size=t))
    d[3] = d[7]                              # force ties
    cand = np.sort(np.stack([rng.permutation(t)[:m] for _ in range(b)]), axis=1)
    sub = d[cand]                            # (B, M, Lc, C)
    for v in (2, 4, 8):
        qs = rng.choice([-1, 1], (b, v, nc, 64)).astype(np.int8)
        best, idx = jax.vmap(coarse_ops.coarse_best)(jnp.asarray(qs),
                                                     jnp.asarray(sub))
        assert best.shape == (b, v, m)
        for q in range(b):
            want = _np_best(qs[q], sub[q])
            np.testing.assert_array_equal(np.asarray(best[q]), want[0])
            np.testing.assert_array_equal(np.asarray(idx[q]), want[1])


def test_coarse_correlation_int32_accumulation_exact():
    """Products at the int8 extremes summed over thousands of columns: the
    GEMM accumulates in int32, beyond any 16-bit or float16 range."""
    rng = np.random.default_rng(13)
    t, lc, nc = 4, 70, 60
    q = rng.choice([-127, 127], (1, nc, 64)).astype(np.int8)
    d = np.broadcast_to(q[0], (t, nc, 64)).copy()
    d = np.concatenate([d, rng.integers(-128, 128, (t, lc - nc, 64)).astype(np.int8)], 1)
    corr = np.asarray(coarse_ops.coarse_correlation(jnp.asarray(q[0]),
                                                    jnp.asarray(d)))
    assert corr[0, 0] == nc * 64 * 127 * 127          # 61.9M > 2^24
    want = _np_best(q, d)
    np.testing.assert_array_equal(corr.max(1), want[0][0])


def test_coarse_correlation_query_longer_than_rows():
    """No valid offset: an empty (B, T, 0) surface, not an error."""
    q = jnp.ones((2, 9, 64), jnp.int8)
    d = jnp.ones((3, 8, 64), jnp.int8)
    assert coarse_ops.coarse_correlation_batch(q, d).shape == (2, 3, 0)


def test_phase_matrix_definition():
    """Column b*s + r is query b shifted down r windows, cut at k rows."""
    rng = np.random.default_rng(14)
    b, nc, c, s, k = 2, 3, 8, 5, 40
    q = rng.integers(-3, 4, (b, nc, c)).astype(np.int8)
    w = np.asarray(coarse_ops.phase_matrix(jnp.asarray(q), s, k))
    assert w.shape == (k, b * s)
    for bb in range(b):
        for r in range(s):
            col = np.zeros(max(k, (nc + r) * c), np.int8)
            col[r * c:(r + nc) * c] = q[bb].reshape(-1)
            np.testing.assert_array_equal(w[:, bb * s + r], col[:k])
