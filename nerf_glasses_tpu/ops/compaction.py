"""Stable-partition permutation for on-device ray/sample compaction.

Every compacting loop in the renderer (march epochs, deferred shading,
significant-sample color, mesh hit shading) needs the same primitive:
given a boolean mask over N slots, a permutation that lists the True ids
first (in order), then the False ids — the static-shape analogue of
the reference's atomic compaction counters (testbed.cu:1973-2053).

The naive form is two full-length `jnp.cumsum`s, which XLA lowers to
O(log N) full passes, charged once per march epoch plus once per shade
pass. This module computes the same permutation with a block-decomposed
prefix sum:

  - within-block exclusive prefix: one (N/B, B) x (B, B) matmul against
    a strict upper-triangular ones matrix — one matrix-unit pass;
  - block offsets: one cumsum over N/B block sums (tiny);
  - the dead-side prefix comes for free: a slot's exclusive dead count
    is its global index minus its exclusive alive count.

Whether this still beats the cumsum formulation on the GPU is not
measured.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp

BLOCK = 512


@lru_cache(maxsize=None)
def _strict_upper(block: int):
    """(B, B) f32 with U[j, k] = 1 for j < k (exclusive-prefix matmul).
    Cached as NUMPY: a cached jnp array created during a jit trace would
    be a tracer and leak into later traces."""
    import numpy as np
    return np.triu(np.ones((block, block), np.float32), 1)


def stable_partition_ids(mask: jnp.ndarray, block: int = BLOCK):
    """mask (N,) bool, N % block == 0 -> (perm (N,) int32, n_true int32).

    perm lists the indices of True entries first (ascending), then the
    False entries (ascending) — identical to the two-cumsum stable
    partition it replaces.
    """
    n = mask.shape[0]
    ids = jnp.arange(n, dtype=jnp.int32)
    if n % block:
        # odd sizes (tiny test batches): plain two-cumsum partition
        m = mask.astype(jnp.int32)
        n_true = jnp.sum(m)
        pos_a = jnp.cumsum(m) - 1
        pos_d = n_true + jnp.cumsum(1 - m) - 1
        slot = jnp.where(mask, pos_a, pos_d)
        perm = jnp.zeros((n,), jnp.int32).at[slot].set(ids)
        return perm, n_true
    mb = mask.reshape(n // block, block).astype(jnp.float32)
    # exclusive alive prefix within each block (counts <= block are exact
    # in f32; the package pins f32 matmul precision)
    within = jnp.dot(mb, _strict_upper(block))
    bs = jnp.sum(mb, axis=1)
    boff = jnp.cumsum(bs) - bs                       # exclusive block sums
    n_true = (boff[-1] + bs[-1]).astype(jnp.int32)
    pos_a = (boff[:, None] + within).reshape(-1).astype(jnp.int32)
    # a slot's exclusive dead count is ids - pos_a
    slot = jnp.where(mask, pos_a, n_true + ids - pos_a)
    perm = jnp.zeros((n,), jnp.int32).at[slot].set(ids)
    return perm, n_true
