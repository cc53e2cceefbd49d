"""Persistent XLA compilation cache setup.

Compiling the catalog programs takes a while on every cold process; the
persistent cache makes it a once-per-machine cost. Enabled on package
import unless HPFW_NO_COMPILE_CACHE=1:

  - JAX_COMPILATION_CACHE_DIR set: JAX reads it itself, and this module
    sets no other directory;
  - otherwise: CACHE_DIR, a fixed directory inside the checkout (fixed
    because the path is part of the cache's key; listed in .gitignore).
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compilation_cache() -> None:
    if (os.environ.get("HPFW_NO_COMPILE_CACHE") == "1"
            or os.environ.get("JAX_COMPILATION_CACHE_DIR")):
        return
    import jax

    if jax.config.jax_compilation_cache_dir is None:
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


# ---------------------------------------------------------------------------
# Shipping compile-cache entries WITH a DB artifact: warmup() seeds this
# machine's persistent cache, but a deployment target that has never
# compiled still pays every compile on its first query. bundle/install move
# the exact cache entries the serving programs use into the artifact
# directory, keyed by the jax/backend runtime so a mismatched target falls
# back to normal compilation.
# ---------------------------------------------------------------------------

import contextlib


def active_cache_dir() -> str | None:
    import jax

    try:
        return jax.config.jax_compilation_cache_dir
    except Exception:
        return None


def runtime_key() -> str:
    """Identifies the compile environment a cache entry is valid for.

    jax's own cache keys already hash the full compile environment, so a
    mismatched entry can never be *hit* — this key only routes bundles so
    install() copies entries that have a chance of hitting."""
    import jax
    import jaxlib

    backend = jax.default_backend()
    kind = jax.devices()[0].device_kind.replace(" ", "_") if jax.devices() else "none"
    return f"jax{jax.__version__}_jaxlib{jaxlib.__version__}_{backend}_{kind}"


@contextlib.contextmanager
def record_cache_keys(out: set):
    """Record every persistent-compile-cache key read or written inside the
    block (cache files are named <key>-cache in the cache dir)."""
    from jax._src import compilation_cache as cc

    orig_get = cc.get_executable_and_time
    orig_put = cc.put_executable_and_time

    def get(key, *a, **k):
        out.add(key)
        return orig_get(key, *a, **k)

    def put(key, *a, **k):
        out.add(key)
        return orig_put(key, *a, **k)

    cc.get_executable_and_time, cc.put_executable_and_time = get, put
    try:
        yield
    finally:
        cc.get_executable_and_time, cc.put_executable_and_time = orig_get, orig_put


def bundle_entries(artifact_path: str, keys) -> int:
    """Copy the cache entries for `keys` from the active cache dir into
    <artifact_path>/xla_cache/<runtime_key>/. Returns entries copied."""
    import shutil

    src = active_cache_dir()
    if not src:
        return 0
    dst = os.path.join(artifact_path, "xla_cache", runtime_key())
    os.makedirs(dst, exist_ok=True)
    n = 0
    for key in sorted(keys):
        f = os.path.join(src, f"{key}-cache")
        if os.path.exists(f):
            shutil.copy2(f, os.path.join(dst, f"{key}-cache"))
            n += 1
    return n


def install_bundle(artifact_path: str) -> int:
    """Copy bundled cache entries for THIS runtime into the active cache
    dir (skipping ones already present). Returns entries installed; 0 on a
    runtime mismatch or when no bundle/cache dir exists — callers fall back
    to normal compilation."""
    import shutil

    dst = active_cache_dir()
    src = os.path.join(artifact_path, "xla_cache", runtime_key())
    if not dst or not os.path.isdir(src):
        return 0
    os.makedirs(dst, exist_ok=True)
    n = 0
    for name in os.listdir(src):
        if not name.endswith("-cache"):
            continue
        t = os.path.join(dst, name)
        if not os.path.exists(t):
            shutil.copy2(os.path.join(src, name), t)
            n += 1
    return n
