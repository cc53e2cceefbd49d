"""Dense Hamming-scan matcher (single-device jnp path).

The reference's matcher slides the query over every alignment offset of every
DB track and scores with XOR + popcount (SURVEY.md §2.3 step 8, §3.3). Here
the scan is expressed as a masked, offset-blocked tensor computation using
jax.lax.population_count on the packed uint32 words — static shapes, no
data-dependent control flow.

Semantics (identical to oracle.match_track):
  - track length >= query length: best over offsets o in [0, len-N] of
      sum_n (64 - popcount(q[n] ^ d[o+n]))
  - shorter track: offset 0 with the query truncated to the track length.
Padding positions are masked out of the sum, and invalid offsets are masked
to -1, which reproduces both cases exactly.

The sharded multi-chip version (shard_map over a DB-sharded mesh + top-k
merge) wraps this in match/sharded.py; the two-stage matcher's fine
rescan (match/scaled.py) is tested equal to this path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _block_scores(
    query: jnp.ndarray,      # (N, 2) uint32
    prints: jnp.ndarray,     # (T, L, 2) uint32, zero-padded
    lengths: jnp.ndarray,    # (T,) int32
    o_start: jnp.ndarray,    # scalar int32, block offset origin
    block: int,
) -> jnp.ndarray:
    """Scores for offsets [o_start, o_start+block), shape (T, block) int32."""
    n = query.shape[0]
    t = prints.shape[0]
    # Slice enough context for all offsets in the block, then window it.
    chunk = jax.lax.dynamic_slice_in_dim(prints, o_start, block + n - 1, axis=1)
    win = jnp.arange(block, dtype=jnp.int32)[:, None] + jnp.arange(n, dtype=jnp.int32)[None, :]
    wins = chunk[:, win]                                   # (T, block, N, 2)
    x = jnp.bitwise_xor(wins, query[None, None])
    sim = 64 - jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
    # Mask positions beyond each track's real length (zero padding).
    pos = o_start + win                                    # (block, N)
    valid_pos = pos[None] < lengths[:, None, None]
    score = jnp.sum(jnp.where(valid_pos, sim, 0), axis=-1)  # (T, block)
    # Mask offsets the oracle never scans: o > max(len - N, 0).
    o = o_start + jnp.arange(block, dtype=jnp.int32)
    max_o = jnp.maximum(lengths - n, 0)
    valid_off = o[None, :] <= max_o[:, None]
    return jnp.where(valid_off, score, -1)


@functools.partial(jax.jit, static_argnames=("offset_block",))
def score_tracks(
    query: jnp.ndarray,
    prints: jnp.ndarray,
    lengths: jnp.ndarray,
    offset_block: int = 64,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Best (score, offset) per track. Returns ((T,) int32, (T,) int32).

    Scans all L-N+1 offsets in blocks of offset_block via lax.map (bounded
    memory), tracking the running best. Ties prefer the smallest offset,
    matching the oracle's first-wins scan.
    """
    t_count, l, _ = prints.shape
    n = query.shape[0]
    assert l >= n, "DB print array must be padded to at least the query length"
    n_offsets = l - n + 1
    n_blocks = -(-n_offsets // offset_block)
    # Pad prints along time so every block can slice block+n-1 columns.
    pad = n_blocks * offset_block + n - 1 - l
    prints = jnp.pad(prints, ((0, 0), (0, pad), (0, 0)))

    def one_block(b):
        o_start = (b * offset_block).astype(jnp.int32)
        s = _block_scores(query, prints, lengths, o_start, offset_block)
        # Invalidate offsets >= n_offsets introduced by block padding.
        o = o_start + jnp.arange(offset_block, dtype=jnp.int32)
        s = jnp.where(o[None, :] < n_offsets, s, -1)
        best = jnp.argmax(s, axis=1).astype(jnp.int32)
        return s[jnp.arange(t_count), best], o_start + best

    scores, offsets = jax.lax.map(one_block, jnp.arange(n_blocks))
    # (n_blocks, T) -> best per track; argmax picks the first (lowest-offset)
    # block on ties, and within a block argmax picked the first offset.
    best_block = jnp.argmax(scores, axis=0)
    ar = jnp.arange(t_count)
    return scores[best_block, ar], offsets[best_block, ar]


def rank(scores: np.ndarray, offsets: np.ndarray, top_k: int):
    """Host-side final ranking: descending score, ascending index on ties."""
    scores = np.asarray(scores)
    offsets = np.asarray(offsets)
    order = np.lexsort((np.arange(scores.shape[0]), -scores))[:top_k]
    return order, scores[order], offsets[order]


def pad_prints(tracks: list[np.ndarray], min_len: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Stack variable-length packed print sequences into (T, L, 2) + lengths."""
    lengths = np.array([t.shape[0] for t in tracks], dtype=np.int32)
    l = max(int(lengths.max(initial=0)), min_len)
    out = np.zeros((len(tracks), l, 2), dtype=np.uint32)
    for i, tr in enumerate(tracks):
        out[i, : tr.shape[0]] = tr
    return out, lengths
