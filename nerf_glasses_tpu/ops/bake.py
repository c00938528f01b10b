"""Baked-density fast rendering (MERF/SNeRG-style, opt-in).

The march's dominant cost is hash-table gathers: every sample pays
`levels x 8` lookups for sigma+color. Baking evaluates the network's
density field once onto a dense 3D grid (the fine-grained sibling of the
128^3 occupancy grid); at render time

  - sigma comes from an 8-gather trilinear lookup into the baked grid
    (vs 64+ hash gathers + the density MLP), and
  - the full network runs only for *significant* samples (prospective
    compositing weight above a threshold), compacted across the chunk
    with the same cumsum-partition machinery as ray compaction.

This changes rendering output only by (a) the grid's resolution limit on
the density field and (b) dropped sub-threshold color contributions
(bounded by sig_threshold per sample). It is an explicit opt-in
(`Testbed.bake()`), not the default path — the reference renderer has no
baking (the VDB-acceleration literature, PAPERS.md, motivates it where
random gathers are the wall).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from nerf_glasses_tpu.config import NGPConfig
from nerf_glasses_tpu.ops.network import (apply_density_activation,
                                          density_raw)


def _occ_mask(occ, R: int, level: int = 0) -> Optional[np.ndarray]:
    """(8, G, G, G) or (G, G, G) occupancy -> (R, R, R) bool mask of the
    1-voxel-dilated occupied region, nearest-neighbor resampled.
    The dilation keeps boundary trilinear corners alive."""
    if occ is None:
        return None
    o = np.asarray(occ)
    if o.ndim == 4:
        o = o[level]
    m = o > 0
    md = m.copy()
    for axis in range(3):
        md = (md | np.roll(md, 1, axis) | np.roll(md, -1, axis))
    G = m.shape[0]
    i = np.minimum((np.arange(R) * G) // R, G - 1)
    return md[np.ix_(i, i, i)]


LOG_SIGMA_PAD = -20.0   # raw-density fill for empty cells in a
                        # log-space bake: exp(-20) ~ 2e-9 keeps the
                        # "baked grid is ~zero in empty space" contract
                        # the flash vector rounds rely on, while the
                        # boundary ramp toward occupied raws (~[-5, 10])
                        # stays well-conditioned for trilerp


def bake_grids(params, config: NGPConfig, resolution: int = 256,
               batch: int = 1 << 20, occ=None, features: bool = False,
               log_space: bool = False, mip: int = 0, aabb=None):
    """Evaluate the density network at cell centers of a resolution^3
    grid over the unit cube -> (sigma (R, R, R) float32 [z, y, x],
    feat ((R^3, 16) bfloat16 raw density-MLP outputs, or None)).

    Both come from ONE network sweep: sigma is the activated first
    channel; `feat` is the full 16-wide raw output — exactly the
    position-dependent half of the color MLP's input
    (nerf_network.cuh:75-135), so a deferred-shade pass can replace the
    hash-encode + density MLP with one trilinear lookup (scene["feat"]).

    When `occ` ((8, G, G, G) or (G, G, G) occupancy) is given, the
    network is evaluated ONLY inside the (1-voxel-dilated) occupied
    region and both outputs are zero elsewhere. Correctness: the
    network emits junk density in space the occupancy grid culls, and
    render paths that trust the baked grid for emptiness (flash/vector
    rounds) would otherwise composite it as fog; `feat` is only read at
    compositing-significant samples, which the sigma grid confines to
    occupied space. Cost: the sweep visits ~the occupied fraction of
    cells (converged captures: ~10%) instead of all R^3.

    log_space=True stores RAW (pre-activation) density, with empty
    cells at LOG_SIGMA_PAD; the sampler applies the activation AFTER
    trilinear interpolation. For the exp activation this turns linear
    interpolation of sigma into geometric interpolation — linear lerp
    between an opaque cell (sigma e^6 ~ 400) and empty space puts a
    half-density halo a full voxel wide around every silhouette, the
    dominant remaining holdout error of the baked paths.

    Multi-cascade scenes (aabb_scale > 1, testbed.cu:188-202): `mip`
    selects the cascade — the grid covers the cube of side 2^mip
    centered at 0.5 (same cube convention as occupancy.mip_from_pos),
    masked by occupancy level `mip`, and `aabb` ((min, max) arrays)
    supplies the network's training-aabb normalization (identity for
    the scale-1 unit cube)."""
    R = resolution
    up = _occ_mask(occ, R, level=mip)
    empty_fill = np.float32(LOG_SIGMA_PAD if log_space else 0.0)
    side = float(1 << mip)

    if aabb is not None:
        aabb_lo = jnp.asarray(np.asarray(aabb[0], np.float32))
        aabb_hi = jnp.asarray(np.asarray(aabb[1], np.float32))

    # one jitted fn evaluates position -> (sigma-or-raw, features);
    # everything downstream (concat, scatter, reshape) stays on device —
    # a 640^3 sweep used to round-trip gigabytes through host numpy
    @jax.jit
    def fn(p, x):
        if aabb is not None:
            x = (x - aabb_lo) / (aabb_hi - aabb_lo)
        d_out = density_raw(p, x, config)
        raw = d_out[:, 0]
        if log_space:
            # clamp so exp after interpolation cannot overflow f32
            sig = jnp.minimum(raw, 30.0)
        else:
            sig = apply_density_activation(raw, config.density_activation)
        return sig, (d_out.astype(jnp.bfloat16) if features else sig[:0])

    def sweep(pos_sel):
        sig, feat = [], []
        for s in range(0, pos_sel.shape[0], batch):
            s_out, f_out = fn(params, pos_sel[s:s + batch])
            sig.append(s_out)
            if features:
                feat.append(f_out)
        sig = (jnp.concatenate(sig) if sig
               else jnp.zeros((0,), jnp.float32))
        feat = (jnp.concatenate(feat) if features and feat
                else (jnp.zeros((0, 16), jnp.bfloat16) if features
                      else None))
        return sig, feat

    if up is None:
        idx = np.arange(R * R * R, dtype=np.int64)
    else:
        idx = np.flatnonzero(up.ravel())        # [z, y, x] ravel order
    idx_d = jnp.asarray(idx.astype(np.int32))   # R <= 1024: fits int32
    iz, rem = jnp.divmod(idx_d, R * R)
    iy, ix = jnp.divmod(rem, R)
    gd = (jnp.arange(R, dtype=jnp.float32) + 0.5) / R
    gd = (gd - 0.5) * side + 0.5          # cascade-local -> raw coords
    pos = jnp.stack([gd[ix], gd[iy], gd[iz]], -1)
    sig, feat = sweep(pos)
    if up is None:
        grid = sig.reshape(R, R, R)
        return grid, (feat if features else None)
    full = jnp.full((R * R * R,), empty_fill, jnp.float32)
    grid = full.at[idx_d].set(sig).reshape(R, R, R)
    if not features:
        return grid, None
    feat_full = jnp.zeros((R * R * R, 16), jnp.bfloat16).at[idx_d].set(feat)
    return grid, feat_full


def bake_grids_cascades(params, config: NGPConfig, resolution: int = 256,
                        occ=None, log_space: bool = True, aabb=None,
                        features: bool = False,
                        feat_resolution: Optional[int] = None):
    """Bake a per-cascade sigma pyramid for aabb_scale > 1 scenes ->
    (packed (n_casc * B^3, 128) brick table,
     feat ((n_casc * Rf^3, 16) bfloat16 pyramid or None), n_casc).

    Cascade c's R^3 grid covers the cube of side 2^c centered at 0.5 —
    exactly the cube occupancy mip c covers (testbed.cu:188-202,
    occupancy.mip_from_pos), so the march's per-sample mip selection
    (mip_from_dt) picks the same cascade for the sigma lookup as it does
    for the occupancy gate. Each cascade is packed with
    pack_sigma_bricks and the tables are row-concatenated; sampling goes
    through sample_sigma_bricks_mip_soa with row offset mip * B^3.

    features=True additionally bakes the per-cascade 16-wide density-MLP
    output pyramid (row offset mip * Rf^3, sample_feat_grid_mip) so the
    deferred shade runs with zero hash-table traffic on multi-cascade
    scenes too — without it every shaded ray re-paid hash-encode +
    density MLP, the round-4 multicascade fps gap."""
    n_casc = config.max_cascade + 1
    if feat_resolution is None:
        feat_resolution = min(resolution, 256)
    same = feat_resolution == resolution
    packed, feats = [], []
    for c in range(n_casc):
        grid, feat = bake_grids(params, config, resolution, occ=occ,
                                features=features and same,
                                log_space=log_space, mip=c, aabb=aabb)
        packed.append(pack_sigma_bricks(grid))
        if features and not same:
            _, feat = bake_grids(params, config, feat_resolution, occ=occ,
                                 features=True, mip=c, aabb=aabb)
        if features:
            feats.append(feat)
    feat = jnp.concatenate(feats, axis=0) if features else None
    return jnp.concatenate(packed, axis=0), feat, n_casc


def sample_sigma_bricks_mip_soa(bricks: jnp.ndarray, n_casc: int,
                                px, py, pz, mip) -> jnp.ndarray:
    """Cascade-aware trilinear lookup from a bake_grids_cascades table:
    px/py/pz (...,) in RAW marching coords, mip (...,) int32 -> sigma.

    Maps each sample into its cascade's local [0,1] cube
    (q = (p - 0.5) * 2^-mip + 0.5, the occupied_at convention) and
    gathers from that cascade's brick rows. Same one-wide-row-gather
    cost as the single-cascade sampler."""
    B = round((bricks.shape[0] // n_casc) ** (1.0 / 3.0))
    R = 4 * B
    shp = px.shape
    mip_scale = jnp.exp2(-mip.astype(jnp.float32)).reshape(-1)

    def prep(p):
        q = (p.reshape(-1) - 0.5) * mip_scale + 0.5
        q = jnp.clip(q, 0.0, 1.0) * R - 0.5
        i0 = jnp.clip(jnp.floor(q).astype(jnp.int32), 0, R - 2)
        return i0, jnp.clip(q - i0, 0.0, 1.0)

    ix, fx = prep(px)
    iy, fy = prep(py)
    iz, fz = prep(pz)
    row = ((iz >> 2) * B + (iy >> 2)) * B + (ix >> 2)
    row = row + mip.reshape(-1).astype(jnp.int32) * (B * B * B)
    rows = jnp.take(bricks, row, axis=0)               # (N, 128)

    j = jnp.arange(5, dtype=jnp.int32)[None]

    def axis_w(i0, f):
        l = (i0 & 3)[:, None]
        fa = f[:, None]
        return jnp.where(j == l, 1.0 - fa, jnp.where(j == l + 1, fa, 0.0))

    wx, wy, wz = axis_w(ix, fx), axis_w(iy, fy), axis_w(iz, fz)
    w = (wz[:, :, None, None] * wy[:, None, :, None]
         * wx[:, None, None, :]).reshape(-1, 125)
    return jnp.sum(rows[:, :125] * w, axis=1).reshape(shp)


def bake_density_grid(params, config: NGPConfig, resolution: int = 256,
                      batch: Optional[int] = None, occ=None) -> jnp.ndarray:
    """Activated density at cell centers -> (R, R, R); see bake_grids.
    batch=None defers to bake_grids' tuned default."""
    kw = {} if batch is None else {"batch": batch}
    return bake_grids(params, config, resolution, occ=occ, **kw)[0]


def sample_feat_grid(feat: jnp.ndarray, pos01: jnp.ndarray) -> jnp.ndarray:
    """Trilinear lookup into a bake_grids feature table: feat (R^3, 16)
    [z, y, x raveled], pos01 (N, 3) in [0,1] -> (N, 16) float32.

    Eight 16-wide row gathers + lerp — the deferred-shade replacement
    for hash_encode (L*8 gathers) + the density MLP."""
    R = round(feat.shape[0] ** (1.0 / 3.0))
    p = jnp.clip(pos01, 0.0, 1.0) * R - 0.5
    i0 = jnp.clip(jnp.floor(p).astype(jnp.int32), 0, R - 2)
    f = jnp.clip(p - i0, 0.0, 1.0)
    ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]

    def at(dx, dy, dz):
        idx = ((iz + dz) * R + (iy + dy)) * R + (ix + dx)
        return jnp.take(feat, idx, axis=0).astype(jnp.float32)

    fx = f[..., 0:1]
    fy = f[..., 1:2]
    fz = f[..., 2:3]
    c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
    c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
    c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
    c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _expand_last_to_bricks(a: jnp.ndarray) -> jnp.ndarray:
    """(..., R) -> (..., B, 5) where out[..., b, d] = a_pad[..., 4b + d]
    and a_pad is `a` edge-padded by one: the 4-sample block plus the
    first sample of the next block (replicated at the far edge)."""
    R = a.shape[-1]
    B = R // 4
    core = a.reshape(a.shape[:-1] + (B, 4))
    nxt = jnp.concatenate([a[..., 4::4], a[..., -1:]], axis=-1)  # (..., B)
    return jnp.concatenate([core, nxt[..., None]], axis=-1)


@jax.jit
def _pack_sigma_bricks_impl(g: jnp.ndarray) -> jnp.ndarray:
    R = g.shape[0]
    B = R // 4
    g1 = _expand_last_to_bricks(g)                       # (Z, Y, BX, dx)
    g2 = _expand_last_to_bricks(jnp.moveaxis(g1, 1, -1))  # (Z, BX, dx, BY, dy)
    g3 = _expand_last_to_bricks(jnp.moveaxis(g2, 0, -1))  # (BX, dx, BY, dy, BZ, dz)
    out = g3.transpose(4, 2, 0, 5, 3, 1)                 # (BZ, BY, BX, dz, dy, dx)
    flat = out.reshape(B * B * B, 125)
    return jnp.pad(flat, ((0, 0), (0, 3)))


def sample_feat_grid_mip(feat: jnp.ndarray, n_casc: int,
                         pos_raw: jnp.ndarray, mip) -> jnp.ndarray:
    """Cascade-aware trilinear lookup into a bake_grids_cascades feature
    pyramid: feat (n_casc * R^3, 16) [z, y, x raveled per cascade],
    pos_raw (N, 3) RAW marching coords, mip (N,) int32 -> (N, 16) f32.

    Maps each point into its cascade's local [0,1] cube
    (q = (p - 0.5) * 2^-mip + 0.5, the occupied_at convention) and
    gathers from that cascade's rows (offset mip * R^3) — the
    multi-cascade sibling of sample_feat_grid."""
    R = round((feat.shape[0] // n_casc) ** (1.0 / 3.0))
    scale = jnp.exp2(-mip.astype(jnp.float32))[..., None]
    q = jnp.clip((pos_raw - 0.5) * scale + 0.5, 0.0, 1.0) * R - 0.5
    i0 = jnp.clip(jnp.floor(q).astype(jnp.int32), 0, R - 2)
    f = jnp.clip(q - i0, 0.0, 1.0)
    ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
    base = mip.astype(jnp.int32) * (R * R * R)

    def at(dx, dy, dz):
        idx = base + ((iz + dz) * R + (iy + dy)) * R + (ix + dx)
        return jnp.take(feat, idx, axis=0).astype(jnp.float32)

    fx = f[..., 0:1]
    fy = f[..., 1:2]
    fz = f[..., 2:3]
    c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
    c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
    c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
    c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def pack_sigma_bricks(sigma_grid) -> jnp.ndarray:
    """(R, R, R) [z, y, x] dense grid -> (B^3, 128) brick table, B = R/4.

    Brick (bz, by, bx) stores the 5x5x5 sample block
    grid[4bz+dz, 4by+dy, 4bx+dx], dz/dy/dx in [0, 5) (blocks overlap by
    one sample plane; the edge is replicated). Any trilinear lookup's 8
    corners live inside ONE brick: base voxel i0 (clipped to R-2) has
    local = i0 & 3 <= 3, so corners local..local+1 <= 4.

    125 floats pad to 128 = one aligned 512-byte row — one gather per
    sample instead of eight.

    Runs entirely on device under ONE jit (reshape/concat per axis —
    NOT a 125-way strided gather, which cost ~32 s on host at 640^3 and
    serialized the whole bake through host memory; un-jitted, the
    intermediates materialize one by one and OOM a 16 GB chip next to a
    baked feature grid)."""
    g = jnp.asarray(sigma_grid, jnp.float32)
    R = g.shape[0]
    assert R % 4 == 0 and g.shape == (R, R, R)
    return _pack_sigma_bricks_impl(g)


def sample_sigma_bricks_soa(bricks: jnp.ndarray, px, py, pz) -> jnp.ndarray:
    """Trilinear lookup from a pack_sigma_bricks table with component
    arrays px/py/pz (...,) in [0,1] -> sigma (...).

    One wide-row gather per sample; the 8 corners are then combined with
    an outer-product weight mask over the 125 in-brick lanes (pure VPU
    work, no second gather)."""
    B = round(bricks.shape[0] ** (1.0 / 3.0))
    R = 4 * B
    shp = px.shape

    def prep(p):
        q = jnp.clip(p.reshape(-1), 0.0, 1.0) * R - 0.5
        i0 = jnp.clip(jnp.floor(q).astype(jnp.int32), 0, R - 2)
        return i0, jnp.clip(q - i0, 0.0, 1.0)

    ix, fx = prep(px)
    iy, fy = prep(py)
    iz, fz = prep(pz)
    row = ((iz >> 2) * B + (iy >> 2)) * B + (ix >> 2)
    rows = jnp.take(bricks, row, axis=0)               # (N, 128)

    j = jnp.arange(5, dtype=jnp.int32)[None]

    def axis_w(i0, f):
        l = (i0 & 3)[:, None]
        fa = f[:, None]
        return jnp.where(j == l, 1.0 - fa, jnp.where(j == l + 1, fa, 0.0))

    wx, wy, wz = axis_w(ix, fx), axis_w(iy, fy), axis_w(iz, fz)
    w = (wz[:, :, None, None] * wy[:, None, :, None]
         * wx[:, None, None, :]).reshape(-1, 125)
    return jnp.sum(rows[:, :125] * w, axis=1).reshape(shp)


def sample_sigma_bricks(bricks: jnp.ndarray, pos01: jnp.ndarray
                        ) -> jnp.ndarray:
    """AoS wrapper: pos01 (..., 3) in [0,1] -> sigma (...)."""
    return sample_sigma_bricks_soa(bricks, pos01[..., 0], pos01[..., 1],
                                   pos01[..., 2])


def sample_baked_sigma(sigma_grid: jnp.ndarray, pos01: jnp.ndarray
                       ) -> jnp.ndarray:
    """Trilinear lookup: pos01 (..., 3) in [0,1] -> sigma (...)."""
    R = sigma_grid.shape[0]
    p = jnp.clip(pos01, 0.0, 1.0) * R - 0.5
    i0 = jnp.clip(jnp.floor(p).astype(jnp.int32), 0, R - 2)
    f = jnp.clip(p - i0, 0.0, 1.0)
    flat = sigma_grid.reshape(-1)

    def at(dx, dy, dz):
        idx = ((i0[..., 2] + dz) * R + (i0[..., 1] + dy)) * R + (i0[..., 0] + dx)
        return jnp.take(flat, idx)

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
    c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
    c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
    c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz
