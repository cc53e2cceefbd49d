"""Sharded matcher tests on a simulated 8-device CPU mesh (SURVEY.md §4.4).

The sharded path must agree exactly with the dense single-device matcher
(and hence the oracle): same winners, same scores, same offsets, for any
top-k pool that covers the comparison set.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hpfw_jax import api, oracle
from hpfw_jax.io import synth
from hpfw_jax.match import matcher
from hpfw_jax.match.sharded import ShardedDB, sharded_score
from hpfw_jax.parallel import mesh as meshlib


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must provide the 8-device CPU sim"
    return meshlib.db_mesh(8)


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return oracle.fix_eigenvector_signs(f).astype(np.float32)


def test_sharded_equals_dense(cfg, mesh8):
    tracks = synth.synth_catalog(19, 3.0, cfg)  # deliberately not /8
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    sdb = ShardedDB(db, mesh8)

    q = synth.make_query(tracks[11], 0.8, 1.5, cfg, noise_db=-15.0, seed=1)
    qfp = api.fingerprint(q, filters, cfg)

    ids_d, s_d, o_d = api.match(qfp, db, top_k=10)
    ids_s, s_s, o_s = sdb.match(qfp, top_k=10, top_pool=19)
    assert ids_s == ids_d
    np.testing.assert_array_equal(s_s, s_d)
    np.testing.assert_array_equal(o_s, o_d)
    assert ids_s[0] == "11"


def test_sharded_padding_never_wins(cfg, mesh8):
    # 3 real tracks on an 8-device mesh: 5 shards hold only padding.
    tracks = synth.synth_catalog(3, 3.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    sdb = ShardedDB(db, mesh8)
    q = synth.make_query(tracks[0], 0.2, 1.0, cfg)
    qfp = api.fingerprint(q, filters, cfg)
    ids, scores, _ = sdb.match(qfp, top_k=10)
    assert len(ids) == 3  # padded entries dropped
    assert ids[0] == "0"


def test_sharded_score_is_replicated_and_fixed_size(cfg, mesh8):
    tracks = synth.synth_catalog(16, 2.5, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    sdb = ShardedDB(db, mesh8)
    q = api.fingerprint(synth.make_query(tracks[4], 0.1, 1.0, cfg), filters, cfg)
    s, idx, off = sharded_score(
        jnp.asarray(q), sdb.prints, sdb.lengths, mesh=mesh8, top_pool=2
    )
    # 8 shards x pool 2 = 16 candidates, replicated on every device.
    assert s.shape == (16,)
    assert idx.shape == (16,) and off.shape == (16,)
    assert int(jnp.max(idx)) < 16


def test_time_shift_property_sharded(cfg, mesh8):
    """SURVEY.md §4.3 property test, through the sharded path."""
    tracks = synth.synth_catalog(9, 4.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    sdb = ShardedDB(db, mesh8)
    for k in [0, 5]:
        q_pcm = tracks[6][k * cfg.hop: k * cfg.hop + int(2.0 * cfg.sample_rate)]
        qfp = api.fingerprint(q_pcm, filters, cfg)
        ids, scores, offs = sdb.match(qfp, top_k=1)
        assert ids[0] == "6"
        assert int(offs[0]) == k
        assert int(scores[0]) == 64 * qfp.shape[0]


def test_dryrun_multichip_runs_the_sharded_path():
    """__graft_entry__.dryrun_multichip: covariance psum, dense sharded
    match and the two-stage matcher (single, batched, two-pass) on the
    8-device mesh."""
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)
