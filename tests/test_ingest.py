"""Batch file ingestion: threaded native decode + files->DB build.

Contracts:
- native ingest_files output is IDENTICAL to per-file load_audio for every
  supported container (they share the same decoders and resampler);
- a file the native driver rejects falls back to the Python loader;
- build_db_from_files produces a DB with prints equal to build_db on the
  same decoded PCM (bucket zero-padding must not change emitted prints).
"""

import os

import numpy as np
import pytest

from hpfw_jax import api
from hpfw_jax.io import ingest, native, synth
from hpfw_jax.io.flac import encode_flac
from hpfw_jax.io.mp3enc import encode_mp3
from hpfw_jax.io.vorbis import encode_vorbis
from hpfw_jax.io.wav import load_audio, resample, save_wav
from tests.test_persist import _filters

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


def _write_fixtures(tmp_path, cfg):
    """One file per container format, all carrying synth music."""
    paths = []
    tracks = synth.synth_catalog(4, 3.0, cfg)
    p = os.path.join(tmp_path, "a.wav")
    save_wav(p, tracks[0], cfg.sample_rate)
    paths.append(p)
    p = os.path.join(tmp_path, "b.flac")
    ints = (np.clip(tracks[1], -1, 1) * 32767.0).round().astype(np.int16)
    with open(p, "wb") as f:
        f.write(encode_flac(ints[:, None], cfg.sample_rate))
    paths.append(p)
    p = os.path.join(tmp_path, "c.ogg")
    with open(p, "wb") as f:
        f.write(encode_vorbis(tracks[2], cfg.sample_rate))
    paths.append(p)
    p = os.path.join(tmp_path, "d.mp3")
    with open(p, "wb") as f:
        f.write(encode_mp3(resample(tracks[3], cfg.sample_rate, 44100), 44100))
    paths.append(p)
    return paths


def test_ingest_matches_per_file_load(tmp_path, cfg):
    paths = _write_fixtures(tmp_path, cfg)
    got = ingest.load_files(paths, cfg, n_threads=2)
    assert len(got) == len(paths)
    for p, pcm in zip(paths, got):
        ref, sr = load_audio(p, cfg)
        assert sr == cfg.sample_rate
        np.testing.assert_array_equal(
            pcm, ref, err_msg=f"ingest != load_audio for {p}")


def test_ingest_native_rejection_falls_back(tmp_path, cfg):
    """Sun .au has no native decoder; the Python loader must cover it."""
    from tests.test_wav import _au  # fixture builder

    ints = (np.sin(np.arange(8000) / 20.0) * 20000).astype(">i2")
    p = os.path.join(tmp_path, "e.au")
    with open(p, "wb") as f:
        f.write(_au(ints.tobytes(), 3, 22050))
    raw = native.ingest_files([p], target_rate=0)
    assert raw[0] is None  # native driver rejects
    got = ingest.load_files([p], cfg)
    ref, _ = load_audio(p, cfg)
    np.testing.assert_array_equal(got[0], ref)


def test_ingest_missing_file_raises(tmp_path, cfg):
    with pytest.raises((ValueError, FileNotFoundError, OSError)):
        ingest.load_files([os.path.join(tmp_path, "nope.wav")], cfg)


def test_build_db_from_files_equals_build_db(tmp_path, cfg):
    paths = _write_fixtures(tmp_path, cfg)
    filters = _filters(cfg)
    pcms = ingest.load_files(paths, cfg)
    ref = api.build_db(dict(zip(paths, pcms)), filters, cfg)
    got = api.build_db_from_files(paths, filters, cfg, batch=3,
                                  bucket_seconds=2.0)
    assert got.track_ids == ref.track_ids
    np.testing.assert_array_equal(got.lengths, ref.lengths)
    lmax = min(got.prints.shape[1], ref.prints.shape[1])
    for t in range(len(paths)):
        n = int(ref.lengths[t])
        assert n <= lmax
        np.testing.assert_array_equal(got.prints[t, :n], ref.prints[t, :n],
                                      err_msg=f"track {t} prints differ")


def test_build_db_from_files_matches_query(tmp_path, cfg):
    """End-to-end: files -> DB -> a query excerpt identifies its track."""
    paths = _write_fixtures(tmp_path, cfg)
    filters = _filters(cfg)
    db = api.build_db_from_files(paths, filters, cfg)
    pcm, _ = load_audio(paths[1], cfg)
    q = api.fingerprint(pcm[: 2 * cfg.sample_rate], filters, cfg)
    ids, scores, offs = api.match(q, db, top_k=2)
    assert ids[0] == paths[1]
    assert int(offs[0]) == 0
