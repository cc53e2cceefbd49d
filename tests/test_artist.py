"""Known-artist (per-artist filter bank) subsystem tests."""

import numpy as np

from hpfw_jax import api
from hpfw_jax.artist import ArtistDB
from hpfw_jax.io import synth


def _build(cfg, n_artists=3, n_tracks=4, seconds=4.0):
    catalogs = {
        f"artist{a}": {
            f"a{a}t{i}": synth.synth_artist_track(a, i, seconds, cfg)
            for i in range(n_tracks)
        }
        for a in range(n_artists)
    }
    return catalogs, ArtistDB.build(catalogs, cfg)


def test_per_artist_filters_differ(cfg):
    _, adb = _build(cfg, n_artists=2, n_tracks=3)
    f0 = adb.banks["artist0"].filters
    f1 = adb.banks["artist1"].filters
    assert f0.shape == (cfg.context_dim, cfg.n_filters)
    assert not np.allclose(f0, f1)


def test_fingerprint_multi_bitexact_per_bank(cfg):
    catalogs, adb = _build(cfg, n_artists=3, n_tracks=2)
    pcm = synth.synth_artist_track(1, 7, 3.0, cfg)
    stack = np.stack([adb.banks[a].filters for a in adb.artists])
    multi = api.fingerprint_multi(pcm, stack, cfg)
    for i, a in enumerate(adb.artists):
        single = api.fingerprint(pcm, adb.banks[a].filters, cfg)
        np.testing.assert_array_equal(multi[i], single, err_msg=a)


def test_known_artist_match(cfg):
    catalogs, adb = _build(cfg)
    track = catalogs["artist1"]["a1t2"]
    q = synth.make_query(track, 0.8, 2.0, cfg, noise_db=-15.0, seed=1)
    ids, scores, offs = adb.match(q, artist="artist1", top_k=3)
    assert ids[0] == "a1t2"


def test_unknown_artist_match_selects_artist(cfg):
    catalogs, adb = _build(cfg)
    track = catalogs["artist2"]["a2t1"]
    q = synth.make_query(track, 0.6, 2.0, cfg, noise_db=-15.0, seed=2)
    pairs, scores, offs = adb.match(q, top_k=5)
    assert pairs[0] == ("artist2", "a2t1")
    assert scores[0] >= scores[-1]


def test_scaled_known_artist_equals_dense(cfg):
    """scaled=True routes known-artist matches through per-artist TwoStageDB
    banks; with a full pool the result must equal the dense path exactly."""
    catalogs, adb = _build(cfg)
    scaled = ArtistDB(cfg, adb.banks, scaled=True, stride=4)
    for a, tid, seed in [("artist1", "a1t2", 1), ("artist0", "a0t0", 4)]:
        q = synth.make_query(catalogs[a][tid], 0.8, 2.0, cfg,
                             noise_db=-15.0, seed=seed)
        ids_d, s_d, o_d = adb.match(q, artist=a, top_k=3)
        ids_s, s_s, o_s = scaled.match(q, artist=a, top_k=3,
                                       pool=adb.banks[a].n_tracks)
        # Exact-on-pool guarantee covers the winner: identical id, exact
        # dense score and offset. Lower ranks may score band-limited.
        assert ids_s[0] == ids_d[0] == tid
        assert int(s_s[0]) == int(s_d[0])
        assert int(o_s[0]) == int(o_d[0])
    # Banks derive lazily and are cached.
    assert set(scaled._ts_banks) == {"artist1", "artist0"}


def test_scaled_unknown_artist_ranks_globally(cfg):
    catalogs, adb = _build(cfg)
    scaled = ArtistDB(cfg, adb.banks, scaled=True, stride=4)
    track = catalogs["artist2"]["a2t1"]
    q = synth.make_query(track, 0.6, 2.0, cfg, noise_db=-15.0, seed=2)
    pairs, scores, offs = scaled.match(q, top_k=5, pool=4)
    want = adb.match(q, top_k=5)
    assert pairs[0] == want[0][0] == ("artist2", "a2t1")


def test_synth_artist_batch_styles(cfg):
    """Device-side artist rendering: deterministic, style-consistent."""
    from hpfw_jax.io import synth_jax

    a0 = np.asarray(synth_jax.synth_artist_batch(1, np.arange(4), 3.0, cfg))
    a0b = np.asarray(synth_jax.synth_artist_batch(1, [2], 3.0, cfg))
    np.testing.assert_array_equal(a0[2], a0b[0])
    a1 = np.asarray(synth_jax.synth_artist_batch(2, np.arange(4), 3.0, cfg))
    assert not np.allclose(a0, a1)
    s1, s2 = synth_jax.artist_style(1), synth_jax.artist_style(2)
    assert s1 != s2 and len(s1["scale"]) in range(5, 8)


def test_artist_db_roundtrip(cfg, tmp_path):
    catalogs, adb = _build(cfg, n_artists=2, n_tracks=2)
    p = str(tmp_path / "adb.npz")
    adb.save(p)
    loaded = ArtistDB.load(p)
    assert loaded.artists == adb.artists
    for a in adb.artists:
        np.testing.assert_array_equal(loaded.banks[a].filters,
                                      adb.banks[a].filters)
        np.testing.assert_array_equal(loaded.banks[a].prints,
                                      adb.banks[a].prints)
        assert loaded.banks[a].track_ids == adb.banks[a].track_ids
    track_pcm = synth.synth_artist_track(0, 1, 4.0, cfg)
    q = synth.make_query(track_pcm, 0.5, 2.0, cfg, noise_db=-18.0, seed=3)
    ids, _, _ = loaded.match(q, artist="artist0", top_k=1)
    assert ids[0] == "a0t1"
