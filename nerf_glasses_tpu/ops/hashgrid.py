"""Multiresolution hash-grid encoding (Instant-NGP) — jnp reference path.

Functionally equivalent to tiny-cuda-nn's GridEncoding with
otype=HashGrid, hash=CoherentPrime, interpolation=Linear
(tiny-cuda-nn/include/tiny-cuda-nn/encodings/grid.h:112-198, 260-395):

- per-level scale:    s_l = 2^(l * log2(b)) * N_min - 1, res_l = ceil(s_l)+1
- vertex coords:      p = x * s_l + 0.5 ; corner = floor(p); w = frac(p)
- index:              dense x + res*y + res^2*z if the level fits,
                      else (x*1 ^ y*2654435761 ^ z*805459861), both
                      taken modulo the level's table size
- output:             trilinear interpolation of F=2 features over the 8
                      corners, concatenated level-major (L*F features).

Layout: the table is a *uniform* (n_levels, S, F) array — every level
padded to the largest level size — and the encode is a lax.scan over
levels. This (a) bounds device-memory temporaries to one level's working
set (XLA would otherwise schedule all 16 independent level gathers
concurrently), and (b) gives a fused encode kernel a single
constant-stride table. Conversion to/from the tcnn
packed (offset-table) layout happens only at the snapshot boundary
(ops/network.py pack_params/unpack_params).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nerf_glasses_tpu.config import NGPConfig, grid_scale
from nerf_glasses_tpu import constants as C

# The 8 corner offsets of a cell, bit i of idx selects dim i (grid.h:320-334).
_CORNERS = np.array(
    [[(i >> d) & 1 for d in range(3)] for i in range(8)], dtype=np.int32
)  # (8, 3)


def level_constants(config: NGPConfig):
    """Per-level (scale, resolution, hashmap_size, is_dense) numpy arrays."""
    lp = config.level_params()
    scales = np.array(
        [grid_scale(l, config.log2_per_level_scale, config.base_resolution)
         for l in range(config.n_levels)], np.float32)
    res = np.array([p[2] for p in lp], np.uint32)
    sizes = np.array([p[1] for p in lp], np.uint32)
    dense = np.array([(not config.all_hash) and int(p[2]) ** 3 <= int(p[1])
                      for p in lp], bool)
    return scales, res, sizes, dense


def padded_table_rows(config: NGPConfig) -> int:
    return max(p[1] for p in config.level_params())


def corner_indices_and_weights(pos, scale: float, resolution: int,
                               hashmap_size: int, dense: bool):
    """Vectorized per-level corner indices + trilinear weights; level
    constants are Python scalars so the compiler strength-reduces the
    modulo. -> (idx (N,8) int32, weights (N,8) f32)."""
    p = pos * jnp.float32(scale) + 0.5
    grid_f = jnp.floor(p)
    frac = p - grid_f
    grid = grid_f.astype(jnp.int32)

    corners = grid[:, None, :] + _CORNERS[None]          # (N, 8, 3)
    w = jnp.where(_CORNERS[None].astype(bool), frac[:, None, :],
                  1.0 - frac[:, None, :])
    weights = w[..., 0] * w[..., 1] * w[..., 2]

    cu = corners.astype(jnp.uint32)
    resolution = int(resolution)
    hashmap_size = int(hashmap_size)
    if dense:
        idx = (cu[..., 0] + cu[..., 1] * jnp.uint32(resolution)
               + cu[..., 2] * jnp.uint32(resolution * resolution
                                         & 0xFFFFFFFF))
    else:
        idx = (cu[..., 0] * jnp.uint32(C.HASH_PRIMES[0])
               ^ cu[..., 1] * jnp.uint32(C.HASH_PRIMES[1])
               ^ cu[..., 2] * jnp.uint32(C.HASH_PRIMES[2]))
    if hashmap_size & (hashmap_size - 1) == 0:
        idx = idx & jnp.uint32(hashmap_size - 1)
    else:
        idx = idx % jnp.uint32(hashmap_size)
    return idx.astype(jnp.int32), weights


def _take_rows(tab, idx):
    """tab (S, W), idx (N, 8) -> (N, 8, W) batched-row gather.

    The backward (scatter-add into the table) is expected to dominate
    the training step. Autodiff's native transpose is kept: a custom VJP
    splitting it into 8 per-corner scatters is the obvious alternative,
    and XLA schedules the single fused transpose in context (not
    measured on the GPU)."""
    return jnp.take(tab, idx.reshape(-1), axis=0).reshape(
        idx.shape + (tab.shape[-1],))


def hash_encode_soa(table: jnp.ndarray, px, py, pz, config: NGPConfig,
                    compute_dtype=jnp.float32) -> jnp.ndarray:
    """table: (L, S, W) uniform-padded; px/py/pz: (N,) components in [0,1]
    -> (N, L*F) features (level-major).

    One batched (N*8)-row gather per level. The alternatives — an
    8-unrolled-corner formulation (64 small gather ops) and a
    levels-fused single gather from the concatenated table — are
    expected to lose to it (per-op overhead, and a table too large to
    stay in cache); not measured on the GPU.

    Per-level constants stay Python values so XLA strength-reduces the
    `% hashmap_size` (a traced divisor compiles to real integer
    division); levels are chained through optimization_barrier so XLA
    schedules them sequentially (bounds gather temporaries at large N)."""
    L = config.n_levels
    F = config.n_features_per_level
    scales, res, sizes, dense = level_constants(config)
    n = px.shape[0]

    pos = jnp.stack([px, py, pz], axis=-1)
    feats = []
    for lvl in range(L):
        idx, w = corner_indices_and_weights(
            pos, float(scales[lvl]), int(res[lvl]), int(sizes[lvl]),
            bool(dense[lvl]))
        tab_l = table[lvl]
        vals = _take_rows(tab_l, idx)                      # (n, 8, W)
        f = jnp.sum(vals.astype(compute_dtype)
                    * w[..., None].astype(compute_dtype), axis=1)
        feats.append(f[:, :F])
        if lvl + 1 < L:
            pos, = jax.lax.optimization_barrier((pos + 0.0 * f[0, 0],))
    return jnp.concatenate(feats, axis=-1)


def hash_encode(table: jnp.ndarray, pos: jnp.ndarray, config: NGPConfig,
                compute_dtype=jnp.float32) -> jnp.ndarray:
    """table: (L, S, F) uniform-padded; pos: (N, 3) in [0,1]
    -> (N, L*F) features (level-major). AoS boundary wrapper around
    hash_encode_soa."""
    return hash_encode_soa(table, pos[..., 0], pos[..., 1], pos[..., 2],
                           config, compute_dtype)


WIDE_ROW = 128   # one 512-byte fp32 row — see NGPConfig.wide_rows


def table_row_width(config: NGPConfig) -> int:
    return WIDE_ROW if config.wide_rows else config.n_features_per_level


def hash_table_init(key, config: NGPConfig, dtype=jnp.float32) -> jnp.ndarray:
    """Uniform(-1e-4, 1e-4) init, matching tcnn grid.h initialize_params.
    Wide-row tables zero the dead pad lanes (never read, never packed)."""
    F = config.n_features_per_level
    tab = jax.random.uniform(
        key, (config.n_levels, padded_table_rows(config), F),
        minval=-1e-4, maxval=1e-4, dtype=dtype)
    W = table_row_width(config)
    if W != F:
        tab = jnp.concatenate(
            [tab, jnp.zeros(tab.shape[:2] + (W - F,), dtype)], axis=-1)
    return tab


def table_to_tcnn(table: np.ndarray, config: NGPConfig) -> np.ndarray:
    """(L, S, W) padded -> flat tcnn param vector (offset-table layout);
    wide-row pad lanes are dropped."""
    F = config.n_features_per_level
    parts = []
    for lvl, (offset, size, _res) in enumerate(config.level_params()):
        parts.append(np.asarray(table[lvl][:size, :F]).reshape(-1))
    return np.concatenate(parts)


def table_from_tcnn(flat: np.ndarray, config: NGPConfig) -> np.ndarray:
    """Flat tcnn param vector -> (L, S, W) padded (wide pad lanes zero)."""
    L = config.n_levels
    F = config.n_features_per_level
    S = padded_table_rows(config)
    out = np.zeros((L, S, table_row_width(config)), np.float32)
    for lvl, (offset, size, _res) in enumerate(config.level_params()):
        out[lvl, :size, :F] = flat[offset * F:(offset + size) * F
                                   ].reshape(size, F)
    return out


# Retained for tests / parity checks against the tcnn indexing rules.
def level_corner_indices(pos: jnp.ndarray, resolution: int, scale: float,
                         hashmap_size: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    dense = resolution ** 3 <= hashmap_size
    return corner_indices_and_weights(pos, float(scale), int(resolution),
                                      int(hashmap_size), dense)
