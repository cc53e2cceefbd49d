"""Compile-cache placement and the chip smoke script's refusal to run
without a GPU (both in child processes: they set process-global state)."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(code, **env):
    e = {k: v for k, v in os.environ.items()
         if k not in ("HPFW_NO_COMPILE_CACHE", "JAX_COMPILATION_CACHE_DIR")}
    e.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **env)
    return subprocess.run([sys.executable, "-c", code], env=e, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


_PRINT_DIR = ("import hpfw_jax, jax; "
              "print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_uses_env_dir(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX's own directory, none from code."""
    out = _child(_PRINT_DIR, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path)


def test_compile_cache_defaults_inside_checkout():
    """Unset: a fixed directory inside the checkout, listed in .gitignore."""
    from hpfw_jax.utils.cache import CACHE_DIR

    out = _child(_PRINT_DIR)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == CACHE_DIR
    assert os.path.dirname(CACHE_DIR) == ROOT
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert os.path.basename(CACHE_DIR) + "/" in f.read().split()


def _smoke(cwd, tmp_path):
    """chip_smoke.py on the CPU, with a stand-in nvidia-smi on PATH so the
    run gets past the card query to the checks under test."""
    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "nvidia-smi").write_text("#!/bin/sh\necho 'Fake Card, 1.00 W'\n")
    (fake / "nvidia-smi").chmod(0o755)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PATH": f"{fake}{os.pathsep}{os.environ.get('PATH', '')}"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_gpu(tmp_path):
    out = _smoke(ROOT, tmp_path)
    assert out.returncode != 0
    assert "JAX found no GPU" in out.stdout
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the repository it cannot import the program."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    out = _smoke(alone, tmp_path)
    assert out.returncode != 0
    assert "No module named 'hpfw_jax'" in out.stderr
    assert '"ok"' not in out.stdout
