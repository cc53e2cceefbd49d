"""Device mesh construction for the sharded fingerprint database.

The reference is single-process CPU with no distributed axis (SURVEY.md
§2.2); the one real distributed dimension of this workload is the database:
tracks shard across devices, the query replicates, each device scans its
shard, and per-shard top-k candidates merge with an all-gather (SURVEY.md
§3.3 rebuild). A 1-D mesh is therefore the native topology — four GPUs of
one host, all to all over NVLink, or an 8-device CPU sim in tests.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DB_AXIS = "db"


def db_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the database axis using the first n devices."""
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return jax.make_mesh((n,), (DB_AXIS,), devices=devs[:n])


def shard_spec() -> P:
    """Partition spec for track-sharded arrays: leading axis over DB_AXIS."""
    return P(DB_AXIS)


def replicated_spec() -> P:
    return P()


def track_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, shard_spec())


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, replicated_spec())


def pad_tracks_to_mesh(n_tracks: int, mesh: Mesh) -> int:
    """Tracks must divide evenly over the mesh; returns the padded count."""
    n = mesh.devices.size
    return -(-n_tracks // n) * n
