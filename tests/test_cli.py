"""CLI surface tests (in-process main() invocation)."""

import numpy as np

from hpfw_jax import api, cli
from hpfw_jax.io import synth
from hpfw_jax.io.wav import save_wav
from tests.test_persist import _filters


def _setup(cfg, tmp_path, n=6):
    tracks = synth.synth_catalog(n, 4.0, cfg)
    filters = _filters(cfg)
    db = api.build_db(tracks, filters, cfg)
    dbp = str(tmp_path / "db.npz")
    db.save(dbp)
    q = synth.make_query(tracks[3], 0.8, 2.0, cfg, noise_db=-15.0, seed=1)
    qp = str(tmp_path / "q.wav")
    save_wav(qp, q, cfg.sample_rate)
    return dbp, qp


def test_cli_match_db_and_cache(cfg, tmp_path, capsys):
    dbp, qp = _setup(cfg, tmp_path)
    assert cli.main(["match", qp, "--db", dbp, "--top-k", "2"]) == 0
    assert "#1 3 " in capsys.readouterr().out
    cache = str(tmp_path / "cache")
    assert cli.main(["build-cache", "--db", dbp, "-o", cache,
                     "--stride", "4"]) == 0
    capsys.readouterr()
    assert cli.main(["match", qp, "--cache", cache, "--top-k", "2"]) == 0
    assert "#1 3 " in capsys.readouterr().out


def test_cli_stream(cfg, tmp_path, capsys):
    dbp, qp = _setup(cfg, tmp_path)
    assert cli.main(["stream", qp, "--db", dbp, "--query-prints", "64"]) == 0
    out = capsys.readouterr().out
    assert "final: 3" in out and "confidence" in out


def test_cli_match_requires_db_or_cache(cfg, tmp_path):
    _, qp = _setup(cfg, tmp_path)
    assert cli.main(["match", qp]) == 2


def test_cli_pool(cfg, tmp_path, capsys):
    dbp, qp = _setup(cfg, tmp_path)
    # second stream: another catalog track
    from hpfw_jax import api
    from hpfw_jax.io import synth

    tracks = synth.synth_catalog(6, 4.0, cfg)
    q2 = synth.make_query(tracks[1], 0.5, 2.2, cfg, noise_db=-15.0, seed=2)
    qp2 = str(tmp_path / "q2.wav")
    save_wav(qp2, q2, cfg.sample_rate)
    assert cli.main(["pool", qp, qp2, "--db", dbp,
                     "--query-prints", "64"]) == 0
    out = capsys.readouterr().out
    assert f"{qp}: 3" in out and f"{qp2}: 1" in out


def test_cli_match_mp3_query(cfg, tmp_path, capsys):
    """The CLI accepts lossy-codec queries transparently via load_audio
    (here: an MP3 at 44.1 kHz, resampled on ingest)."""
    from hpfw_jax.io.mp3enc import encode_mp3
    from hpfw_jax.io.wav import load_wav, resample

    dbp, qp = _setup(cfg, tmp_path)
    q, sr = load_wav(qp)
    q44 = resample(q, sr, 44100)
    mp = str(tmp_path / "q.mp3")
    with open(mp, "wb") as f:
        f.write(encode_mp3(q44.astype(np.float64), 44100))
    assert cli.main(["match", mp, "--db", dbp, "--top-k", "2"]) == 0
    assert "#1 3 " in capsys.readouterr().out
