"""`gpu` tests: the matcher's kernels compiled for the card, at real widths.

    HPFW_TEST_PLATFORM=gpu python -m pytest -m gpu tests/test_gpu_kernels.py -q

Widths are the catalog operating point: 250k tracks of 60 s (2,533 prints,
158 coarse windows), 10 s queries (380 prints), B = 16. Each test compares
a compiled kernel with its plain reference: the int8 coarse sweep with a
numpy correlation on a slice, the band-gather fine rescan with numpy, the
catalog preset's batch with its single queries, and extraction with the
float64 oracle. Without a card they skip (the `gpu_device` fixture
decides); the CPU suite covers the same code at small sizes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu

T_TRACKS = 250_000
L_PRINTS = 2533          # 60 s at the default config
N_QUERY = 380            # 10 s
STRIDE = 16
BATCH = 16


def _np_corr(q, d):
    """numpy reference: (B, Nc, C) x (T, Lc, C) -> (B, T, offsets) int64."""
    nc = q.shape[1]
    win = np.lib.stride_tricks.sliding_window_view(
        d.astype(np.int64), nc, axis=1)               # (T, off, C, Nc)
    return np.einsum("bjc,tocj->bto", q.astype(np.int64), win)


def _pm1(key, shape):
    return jnp.where(jax.random.bernoulli(key, 0.5, shape), 1, -1).astype(jnp.int8)


@pytest.mark.parametrize("channels,lanes", [(64, BATCH), (32, 2 * BATCH)])
def test_coarse_sweep_exact_at_catalog_width(gpu_device, channels, lanes):
    """Pass-1 shapes: full 64 channels at B rows, and the C1 = 32 subset at
    2B rows (two phase variants per query)."""
    from hpfw_jax.ops import coarse as coarse_ops

    lc, nc = L_PRINTS // STRIDE, N_QUERY // STRIDE
    k1, k2 = jax.random.split(jax.random.key(channels))
    db = _pm1(k1, (T_TRACKS, lc, channels))
    db = db.at[-3:, lc // 2:].set(0)                 # short tracks
    qs = _pm1(k2, (lanes, nc, channels))
    qs = qs.at[1].set(db[123, 40:40 + nc])            # a planted peak
    got = jax.block_until_ready(coarse_ops.coarse_best(qs, db))
    assert int(got[0][1, 123]) == nc * channels and int(got[1][1, 123]) == 40
    rows = np.r_[0:64, T_TRACKS - 64:T_TRACKS]
    corr = _np_corr(np.asarray(qs), np.asarray(db[rows]))
    np.testing.assert_array_equal(np.asarray(got[0])[:, rows], corr.max(-1))
    np.testing.assert_array_equal(np.asarray(got[1])[:, rows], corr.argmax(-1))


def test_fine_rescan_exact_at_catalog_width(gpu_device):
    """Band gather + XOR/popcount over a 250k x 2,533 print catalog, pool
    1024 per query, against a numpy rescan of the same bands."""
    from hpfw_jax.match.scaled import _fine_rescan

    fw, pool = STRIDE, 1024
    n_fine = 2 * fw + 1
    rng = np.random.default_rng(5)
    prints = jax.random.bits(jax.random.key(3), (T_TRACKS, L_PRINTS, 2),
                             jnp.uint32)
    lengths = jnp.asarray(
        rng.integers(N_QUERY // 2, L_PRINTS + 1, T_TRACKS).astype(np.int32))
    cand = rng.integers(0, T_TRACKS, (BATCH, pool)).astype(np.int32)
    cand[:, 0] = T_TRACKS - 1                           # last row
    span = N_QUERY + n_fine - 1
    starts = rng.integers(0, L_PRINTS - span + 1, (BATCH, pool)).astype(np.int32)
    queries = np.asarray(jax.random.bits(jax.random.key(4),
                                         (BATCH, N_QUERY, 2), jnp.uint32))
    t_plant, o_plant = int(cand[3, 7]), int(starts[3, 7]) + 5
    prints = prints.at[t_plant, o_plant:o_plant + N_QUERY].set(queries[3])
    lengths = lengths.at[t_plant].set(L_PRINTS)
    s, o = jax.block_until_ready(_fine_rescan(
        jnp.asarray(queries), prints, lengths, jnp.asarray(cand),
        jnp.asarray(starts), n_fine=n_fine))
    assert int(s[3, 7]) == 64 * N_QUERY and int(o[3, 7]) == o_plant
    # numpy reference on a slice of candidates
    pk = np.asarray(prints[cand[:, :32]])               # (B, 32, L, 2)
    ln = np.asarray(lengths)[cand[:, :32]]
    for b in range(BATCH):
        for k in range(32):
            st = starts[b, k]
            band = pk[b, k, st:st + span]
            best, first = None, None
            for f in range(n_fine):
                x = np.bitwise_xor(band[f:f + N_QUERY], queries[b])
                sim = 64 - np.bitwise_count(x).sum(axis=1)
                sim = np.where(st + f + np.arange(N_QUERY) < ln[b, k], sim, 0)
                sc = int(sim.sum()) if st + f <= max(ln[b, k] - N_QUERY, 0) else -1
                if best is None or sc > best:    # first offset on ties,
                    best, first = sc, st + f     # -1 (no valid offset) too
            assert (int(s[b, k]), int(o[b, k])) == (best, first), (b, k)


def test_two_stage_preset_batch_equals_single(gpu_device):
    """catalog_scale() on the card: match_batch rows equal match(), and the
    planted tracks come back at their true offsets with exact scores."""
    from hpfw_jax.api import FingerprintDB
    from hpfw_jax.config import HpfwConfig
    from hpfw_jax.match.scaled import TwoStageDB

    cfg = HpfwConfig.catalog_scale()
    t = 20_000
    rng = np.random.default_rng(6)
    prints = rng.integers(0, 2 ** 32, (t, L_PRINTS, 2), dtype=np.uint32)
    db = FingerprintDB(cfg, np.zeros((cfg.context_dim, 64), np.float32),
                       [str(i) for i in range(t)], prints,
                       np.full(t, L_PRINTS, np.int32))
    ts = TwoStageDB(db)
    tracks = rng.choice(t, BATCH, replace=False)
    offs = rng.integers(0, L_PRINTS - N_QUERY, BATCH)
    qs = np.stack([prints[k, o:o + N_QUERY] for k, o in zip(tracks, offs)])
    flips = (rng.random(qs.shape + (32,)) < 0.1).astype(np.uint32)
    qs = qs ^ (flips << np.arange(32, dtype=np.uint32)).sum(-1).astype(np.uint32)
    batch = ts.match_batch(qs, top_k=3)
    for i, (ids, sc, of) in enumerate(batch):
        ids1, sc1, of1 = ts.match(qs[i], top_k=3)
        assert ids == ids1
        np.testing.assert_array_equal(sc, sc1)
        np.testing.assert_array_equal(of, of1)
        assert ids[0] == str(tracks[i]) and int(of[0]) == offs[i]


def test_extraction_bit_exact_on_gpu(gpu_device):
    """Full default config, HIGHEST float32: margin-audited bit-exactness
    against the float64 oracle."""
    from hpfw_jax import api, oracle
    from hpfw_jax.config import HpfwConfig
    from hpfw_jax.io import synth

    cfg = HpfwConfig()
    pcm = synth.synth_track(5, 8.0, cfg)
    rng = np.random.default_rng(3)
    filters = oracle.fix_eigenvector_signs(
        rng.standard_normal((cfg.context_dim, cfg.n_filters))
        / np.sqrt(cfg.context_dim)).astype(np.float32)
    got = api.fingerprint(pcm, filters, cfg)
    want = oracle.fingerprint(pcm, filters, cfg)
    margins = oracle.delta_margins(pcm, filters, cfg)
    oracle.assert_bits_match_with_margin_audit(got, want, margins, rel_tol=1e-4)

