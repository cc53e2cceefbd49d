"""Two-stage cache persistence: save() -> load() must reproduce the matcher
byte-for-byte, with no re-derivation, single-device and sharded.
SURVEY.md §5 checkpoint/resume.
"""

import numpy as np
import pytest

from hpfw_jax import api, oracle
from hpfw_jax.io import synth
from hpfw_jax.match.scaled import TwoStageDB
from hpfw_jax.parallel import mesh as meshlib


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((cfg.context_dim, cfg.n_filters)) / np.sqrt(cfg.context_dim)
    return oracle.fix_eigenvector_signs(f).astype(np.float32)


@pytest.fixture(scope="module")
def small_db(cfg):
    tracks = synth.synth_catalog(14, 4.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    q = synth.make_query(tracks[9], 0.8, 2.0, cfg, noise_db=-15.0, seed=2)
    qfp = api.fingerprint(q, filters, cfg)
    return db, qfp


def _assert_same_match(a, b, qfp):
    ids_a, s_a, o_a = a.match(qfp, top_k=5, pool=14)
    ids_b, s_b, o_b = b.match(qfp, top_k=5, pool=14)
    assert ids_a == ids_b
    np.testing.assert_array_equal(s_a, s_b)
    np.testing.assert_array_equal(o_a, o_b)


def test_save_load_xla_path(small_db, tmp_path):
    db, qfp = small_db
    ts = TwoStageDB(db, stride=4, keep_host=True)
    ts.save(str(tmp_path / "cache"))
    assert ts._host_state is None  # host copies released after save
    loaded = TwoStageDB.load(str(tmp_path / "cache"))
    assert loaded.stride == 4 and loaded.n_real == 14
    assert loaded.db.cfg == db.cfg
    assert loaded.db.track_ids == db.track_ids
    _assert_same_match(ts, loaded, qfp)


def test_save_load_pallas_planes(small_db, tmp_path):
    db, qfp = small_db
    ts = TwoStageDB(db, stride=4,
                    keep_host=True)
    ts.save(str(tmp_path / "cache"))
    loaded = TwoStageDB.load(str(tmp_path / "cache"))
    assert loaded.prints.shape == ts.prints.shape
    assert loaded.db_c.shape == ts.db_c.shape and loaded.db_c.dtype == np.int8
    _assert_same_match(ts, loaded, qfp)


def test_load_refuses_older_layout(small_db, tmp_path):
    """Caches of an earlier layout (format 1: flat word planes) are refused
    with a rebuild hint, never half-loaded."""
    import json

    db, _ = small_db
    TwoStageDB(db, stride=4).save(str(tmp_path / "cache"))
    mf = tmp_path / "cache" / "manifest.json"
    m = json.loads(mf.read_text())
    m["format_version"] = 1
    mf.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="rebuild"):
        TwoStageDB.load(str(tmp_path / "cache"))


def test_save_load_sharded(small_db, tmp_path):
    db, qfp = small_db
    mesh = meshlib.db_mesh(8)
    ts = TwoStageDB(db, stride=4, mesh=mesh, keep_host=True)
    ts.save(str(tmp_path / "cache"))
    loaded = TwoStageDB.load(str(tmp_path / "cache"), mesh=mesh)
    ids_a, s_a, o_a = ts.match(qfp, top_k=3, pool=2)
    ids_b, s_b, o_b = loaded.match(qfp, top_k=3, pool=2)
    assert ids_a == ids_b
    np.testing.assert_array_equal(s_a, s_b)
    np.testing.assert_array_equal(o_a, o_b)


def test_save_without_keep_host_pulls_from_device(small_db, tmp_path):
    db, qfp = small_db
    ts = TwoStageDB(db, stride=4)  # no host copies
    ts.save(str(tmp_path / "cache"))
    loaded = TwoStageDB.load(str(tmp_path / "cache"), mmap=False)
    _assert_same_match(ts, loaded, qfp)


def test_load_mesh_mismatch_rejected(small_db, tmp_path):
    db, _ = small_db
    ts = TwoStageDB(db, stride=4)
    ts.save(str(tmp_path / "cache"))
    with pytest.raises(ValueError, match="mesh size"):
        TwoStageDB.load(str(tmp_path / "cache"), mesh=meshlib.db_mesh(8))


def test_warmup_compiles_serving_shapes(small_db, tmp_path):
    db, qfp = small_db
    ts = TwoStageDB(db, stride=4)
    ts.warmup([qfp.shape[0]], batch_sizes=(2,), pool=14)
    # After warmup the real dispatch hits the jit cache; results unchanged.
    ids, s, o = ts.match(qfp, top_k=1, pool=14)
    assert ids[0] == "9"


def test_compile_cache_bundle_and_install(small_db, tmp_path):
    """bundle_compile_cache ships warmup's persistent-cache entries with
    the artifact; load(install_cache=True) installs them into a fresh
    machine's cache dir (VERDICT r3 weak #6). Runtime-mismatch bundles are
    ignored (install returns 0)."""
    import jax

    from jax._src import compilation_cache as cc
    from hpfw_jax.utils import cache as cache_util

    db, qfp = small_db
    art = str(tmp_path / "artifact")
    build_cache = tmp_path / "cache_build"
    fresh_cache = tmp_path / "cache_fresh"
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs

    def set_cache(d):
        jax.config.update("jax_compilation_cache_dir", str(d))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        cc.reset_cache()

    # In-memory jit hits bypass the persistent cache and can't be recorded
    # (the documented caveat), so warm a query shape no earlier test in this
    # module has dispatched.
    qlen = qfp.shape[0] - 7
    try:
        set_cache(build_cache)
        ts = TwoStageDB(db, stride=4, keep_host=True)
        ts.save(art)
        n = ts.bundle_compile_cache(art, [qlen], pool=9)
        assert n >= 1
        key = cache_util.runtime_key()
        bundled = list((tmp_path / "artifact" / "xla_cache" / key).iterdir())
        assert len(bundled) == n

        # fresh "machine": empty cache dir; install must copy the entries
        set_cache(fresh_cache)
        loaded = TwoStageDB.load(art)
        installed = [p for p in fresh_cache.iterdir()
                     if p.name.endswith("-cache")]
        assert len(installed) == n
        ids_a, s_a, o_a = ts.match(qfp[:qlen], top_k=3, pool=9)
        ids_b, s_b, o_b = loaded.match(qfp[:qlen], top_k=3, pool=9)
        assert ids_a == ids_b
        np.testing.assert_array_equal(s_a, s_b)
        np.testing.assert_array_equal(o_a, o_b)

        # mismatched runtime: bundle dir for another key is ignored
        import shutil

        shutil.rmtree(tmp_path / "artifact" / "xla_cache" / key)
        (tmp_path / "artifact" / "xla_cache" / "jax0.0_other").mkdir()
        assert cache_util.install_bundle(art) == 0
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old_min)
        cc.reset_cache()
