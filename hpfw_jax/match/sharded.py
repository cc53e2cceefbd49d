"""Sharded matcher: per-shard Hamming scan + all-gather top-k merge.

Device-mesh equivalent of "scan the whole catalog" (SURVEY.md §3.3): the
packed print database shards across the mesh's DB axis (tracks axis), the
query replicates, every device scans only its shard with the same masked
XOR+popcount scan as the dense matcher, reduces to a fixed-size per-shard
top-k candidate list, and one small all-gather (NCCL on GPUs) merges the
candidates. Communication is O(devices * top_pool * 3 words) regardless of
catalog size — the scan itself never leaves the device.

Placement-invariant by construction: tests run the same code on a simulated
8-device CPU mesh (SURVEY.md §4.4).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..parallel.mesh import DB_AXIS, pad_tracks_to_mesh
from .matcher import _block_scores, rank


def _shard_scan(query, prints, lengths, *, top_pool: int, offset_block: int):
    """Runs on one shard: local scan -> local top-k candidates."""
    t_local, l, _ = prints.shape
    n = query.shape[0]
    n_offsets = l - n + 1
    n_blocks = -(-n_offsets // offset_block)
    pad = n_blocks * offset_block + n - 1 - l
    prints = jnp.pad(prints, ((0, 0), (0, pad), (0, 0)))

    def one_block(b):
        o_start = (b * offset_block).astype(jnp.int32)
        s = _block_scores(query, prints, lengths, o_start, offset_block)
        o = o_start + jnp.arange(offset_block, dtype=jnp.int32)
        s = jnp.where(o[None, :] < n_offsets, s, -1)
        best = jnp.argmax(s, axis=1).astype(jnp.int32)
        return s[jnp.arange(t_local), best], o_start + best

    scores, offsets = jax.lax.map(one_block, jnp.arange(n_blocks))
    best_block = jnp.argmax(scores, axis=0)
    ar = jnp.arange(t_local)
    track_scores = scores[best_block, ar]
    track_offsets = offsets[best_block, ar]

    k = min(top_pool, t_local)
    top_scores, top_local = jax.lax.top_k(track_scores, k)
    shard = jax.lax.axis_index(DB_AXIS)
    top_global = shard.astype(jnp.int32) * t_local + top_local.astype(jnp.int32)
    top_offsets = track_offsets[top_local]
    # Fixed-size candidate exchange.
    g_scores = jax.lax.all_gather(top_scores, DB_AXIS, tiled=True)
    g_idx = jax.lax.all_gather(top_global, DB_AXIS, tiled=True)
    g_off = jax.lax.all_gather(top_offsets, DB_AXIS, tiled=True)
    return g_scores, g_idx, g_off


@functools.partial(
    jax.jit, static_argnames=("mesh", "top_pool", "offset_block")
)
def sharded_score(
    query: jnp.ndarray,     # (N, 2) uint32, replicated
    prints: jnp.ndarray,    # (T_padded, L, 2) uint32, sharded over tracks
    lengths: jnp.ndarray,   # (T_padded,) int32, sharded
    *,
    mesh: Mesh,
    top_pool: int = 128,
    offset_block: int = 64,
):
    """Merged candidate pool: ((D*k,) scores, (D*k,) track idx, (D*k,) offsets)."""
    fn = jax.shard_map(
        functools.partial(_shard_scan, top_pool=top_pool, offset_block=offset_block),
        mesh=mesh,
        in_specs=(P(), P(DB_AXIS), P(DB_AXIS)),
        out_specs=(P(), P(), P()),
        check_vma=False,  # all_gather outputs are replicated by construction
    )
    return fn(query, prints, lengths)


class ShardedDB:
    """A FingerprintDB laid out across a device mesh for matching.

    Pads the track axis to a multiple of the mesh size (padded entries have
    length 0 and can never outrank a real track; final ranking drops them).
    """

    def __init__(self, db, mesh: Mesh):
        self.db = db
        self.mesh = mesh
        t = db.prints.shape[0]
        t_pad = pad_tracks_to_mesh(t, mesh)
        prints = db.prints
        lengths = db.lengths
        if t_pad != t:
            prints = np.concatenate(
                [prints, np.zeros((t_pad - t,) + prints.shape[1:], prints.dtype)]
            )
            lengths = np.concatenate([lengths, np.zeros(t_pad - t, lengths.dtype)])
        self.prints = jax.device_put(prints, NamedSharding(mesh, P(DB_AXIS)))
        self.lengths = jax.device_put(lengths, NamedSharding(mesh, P(DB_AXIS)))
        self.n_real = t

    def match(self, query_prints: np.ndarray, *, top_k: int | None = None,
              top_pool: int = 128, offset_block: int = 64):
        """Ranked (track_ids, scores, offsets) — same semantics as api.match."""
        top_k = top_k if top_k is not None else self.db.cfg.top_k
        q = jax.device_put(
            np.asarray(query_prints, dtype=np.uint32),
            NamedSharding(self.mesh, P()),
        )
        s, idx, off = sharded_score(
            q, self.prints, self.lengths,
            mesh=self.mesh, top_pool=top_pool, offset_block=offset_block,
        )
        s, idx, off = np.asarray(s), np.asarray(idx), np.asarray(off)
        real = idx < self.n_real
        s, idx, off = s[real], idx[real], off[real]
        # Host-side final merge: descending score, ascending track id on ties
        # (identical to the dense path's rank()).
        order = np.lexsort((idx, -s))[:top_k]
        ids = [self.db.track_ids[i] for i in idx[order]]
        return ids, s[order], off[order]
