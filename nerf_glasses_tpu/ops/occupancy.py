"""Multi-mip occupancy grid: construction, lookup, and DDA empty-space skip.

Design note: the reference keeps the grid as a Morton-ordered *bitfield*
and walks it with per-thread DDA (testbed.cu:119-166, 234-315). Here it
is a dense uint8 array in plain [mip, z, y, x] layout
(8 * 128^3 = 16 MiB of device memory) so lookups are single flat gathers with no bit
math, and all DDA stepping is vectorized over rays. Morton packing is only
used at the snapshot/dump-file boundary (see io/snapshot.py, models/floaty).

Reference semantics:
  grid_to_bitfield / bitfield_max_pool     testbed.cu:119-166, 1120-1135
  mip_from_pos / mip_from_dt               testbed.cu:188-202
  cascaded_grid_idx_at / occupied_at       testbed.cu:234-264
  distance/advance_to_next_voxel           testbed.cu:293-315
  calc_dt                                  testbed.cu:230-232
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from nerf_glasses_tpu import constants as C


GRID = C.NERF_GRIDSIZE
N_MIPS = C.NERF_CASCADES


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------

def build_occupancy(density_grid: jnp.ndarray, max_cascade: int) -> jnp.ndarray:
    """density_grid: (n_cascades, 128, 128, 128) float, linear [mip,z,y,x]
    layout, values = optical thickness (density * MIN_CONE_STEPSIZE scale).

    Returns occupancy (8, 128, 128, 128) uint8 in {0,1}.

    Matches update_density_grid_mean_and_bitfield (testbed.cu:1120-1135):
    threshold = min(NERF_MIN_OPTICAL_THICKNESS, mean over mip-0 of
    max(d, 0)), then per-level max-pool into the inner half of the next mip.
    """
    n_cascades = density_grid.shape[0]
    mean0 = jnp.mean(jnp.maximum(density_grid[0], 0.0))
    thresh = jnp.minimum(jnp.float32(C.NERF_MIN_OPTICAL_THICKNESS), mean0)

    occ = density_grid > thresh  # (n_cascades, Z, Y, X) bool
    # zero out cascades beyond max_cascade (grid_to_bitfield's
    # n_nonzero_elements guard)
    if n_cascades > max_cascade + 1:
        occ = occ.at[max_cascade + 1:].set(False)

    levels = [occ[0]]
    for lvl in range(1, N_MIPS):
        own = occ[lvl] if lvl < n_cascades else jnp.zeros((GRID,) * 3, bool)
        prev = levels[lvl - 1]
        pooled = prev.reshape(64, 2, 64, 2, 64, 2).any(axis=(1, 3, 5))
        own = own.at[32:96, 32:96, 32:96].set(own[32:96, 32:96, 32:96] | pooled)
        levels.append(own)
    return jnp.stack(levels).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Lookup
# ---------------------------------------------------------------------------

def mip_from_pos(pos: jnp.ndarray, max_cascade: int) -> jnp.ndarray:
    """pos: (..., 3). Smallest mip whose [0,1]-scaled cube contains pos."""
    maxval = jnp.max(jnp.abs(pos - 0.5), axis=-1)
    _, exponent = jnp.frexp(maxval)
    return jnp.clip(exponent + 1, 0, max_cascade).astype(jnp.int32)


def mip_from_pos_soa(px, py, pz, max_cascade: int) -> jnp.ndarray:
    maxval = jnp.maximum(jnp.maximum(jnp.abs(px - 0.5), jnp.abs(py - 0.5)),
                         jnp.abs(pz - 0.5))
    _, exponent = jnp.frexp(maxval)
    return jnp.clip(exponent + 1, 0, max_cascade).astype(jnp.int32)


def mip_from_dt(dt: jnp.ndarray, pos: jnp.ndarray, max_cascade: int) -> jnp.ndarray:
    return mip_from_dt_soa(dt, pos[..., 0], pos[..., 1], pos[..., 2],
                           max_cascade)


def mip_from_dt_soa(dt, px, py, pz, max_cascade: int) -> jnp.ndarray:
    mip = mip_from_pos_soa(px, py, pz, max_cascade)
    dt = dt * (2 * GRID)
    _, exponent = jnp.frexp(dt)
    mip_dt = jnp.where(dt < 1.0, mip, jnp.minimum(jnp.maximum(exponent, mip), max_cascade))
    return mip_dt.astype(jnp.int32)


def occupied_at(occ: jnp.ndarray, pos: jnp.ndarray, mip: jnp.ndarray) -> jnp.ndarray:
    """occ: (8, G, G, G) uint8; pos (..., 3); mip (...,) int32 -> bool."""
    return occupied_at_soa(occ, pos[..., 0], pos[..., 1], pos[..., 2], mip)


def occupied_at_soa(occ: jnp.ndarray, px, py, pz, mip) -> jnp.ndarray:
    """Component-array variant: px/py/pz (...,), mip (...,) -> bool.
    All math stays on flat component arrays (no (N,3) minor dimension)."""
    mip_scale = jnp.exp2(-mip.astype(jnp.float32))

    def cell(p):
        # C-style cast (truncate toward zero), clamp — testbed.cu:240-249
        q = (p - 0.5) * mip_scale + 0.5
        return jnp.clip(jnp.trunc(q * GRID).astype(jnp.int32), 0, GRID - 1)

    flat = (((mip * GRID + cell(pz)) * GRID + cell(py)) * GRID + cell(px))
    return jnp.take(occ.reshape(-1), flat, mode="clip").astype(bool)


# ---------------------------------------------------------------------------
# Stepping
# ---------------------------------------------------------------------------

def calc_dt(t, cone_angle: float):
    if cone_angle == 0.0:
        return jnp.full_like(t, C.MIN_CONE_STEPSIZE)
    return jnp.clip(t * cone_angle, C.MIN_CONE_STEPSIZE, C.MAX_CONE_STEPSIZE)


def distance_to_next_voxel(pos, dir, idir, res):
    """DDA-like distance to the next voxel boundary. res: (...,) float."""
    p = res[..., None] * pos
    sign = jnp.sign(dir) + (dir == 0.0)  # copysign(1, 0) == 1
    tt = (jnp.floor(p + 0.5 + 0.5 * sign) - p) * idir
    t = jnp.min(tt, axis=-1)
    return jnp.maximum(t / res, 0.0)


def distance_to_next_voxel_soa(p3, d3, id3, res):
    """Component-array DDA distance: p3/d3/id3 are (px,py,pz)-style
    3-tuples of (...,) arrays; res (...,) float."""
    t = None
    for p, d, idc in zip(p3, d3, id3):
        pr = res * p
        sign = jnp.sign(d) + (d == 0.0)
        tc = (jnp.floor(pr + 0.5 + 0.5 * sign) - pr) * idc
        t = tc if t is None else jnp.minimum(t, tc)
    return jnp.maximum(t / res, 0.0)


def advance_to_next_voxel_soa(t, cone_angle: float, p3, d3, id3, res):
    """SoA advance: step t past the current (empty) voxel (see
    advance_to_next_voxel)."""
    t_target = t + distance_to_next_voxel_soa(p3, d3, id3, res)
    if cone_angle == 0.0:
        dt = C.MIN_CONE_STEPSIZE
        n = jnp.maximum(jnp.ceil((t_target - t) / dt), 1.0)
        return t + n * dt

    def body(_, tcur):
        dt = calc_dt(tcur, cone_angle)
        return jnp.where(tcur < t_target, tcur + dt, tcur)

    t1 = jax.lax.fori_loop(0, 8, body, t)
    t1 = jnp.maximum(t1, t + calc_dt(t, cone_angle))
    return t1


def advance_to_next_voxel(t, cone_angle: float, pos, dir, idir, res):
    """Step t past the current (empty) voxel, by multiples of dt.

    Regular stepping matching testbed.cu:303-315: repeatedly t += calc_dt(t)
    until t >= t_target. For cone_angle == 0 (unit-cube scenes, the
    reference's aabb_scale==1 default) this has the closed form below; for
    exponential stepping we bound the inner loop (steps are >= dt_min so
    a cap of a few iterations loses no correctness, only skips less far,
    which the outer march loop absorbs).
    """
    t_target = t + distance_to_next_voxel(pos, dir, idir, res)
    if cone_angle == 0.0:
        dt = C.MIN_CONE_STEPSIZE
        n = jnp.maximum(jnp.ceil((t_target - t) / dt), 1.0)
        return t + n * dt

    def body(_, tcur):
        dt = calc_dt(tcur, cone_angle)
        return jnp.where(tcur < t_target, tcur + dt, tcur)

    t1 = jax.lax.fori_loop(0, 8, body, t)
    # guarantee at least one step (do-while)
    t1 = jnp.maximum(t1, t + calc_dt(t, cone_angle))
    return t1


# ---------------------------------------------------------------------------
# Morton <-> linear cascade conversion (host side, snapshot interop)
# ---------------------------------------------------------------------------

def morton_cascades_to_linear(values_morton: np.ndarray) -> np.ndarray:
    """(n_cascades, 128^3) morton-ordered -> (n_cascades,128,128,128) [z,y,x].

    Reference stores the density grid morton-ordered per cascade; the grid
    cell of morton index m is at coords (x,y,z) = morton3d_invert bits.
    """
    from nerf_glasses_tpu.ops.morton import morton_order_lut
    lut = morton_order_lut(GRID)  # morton code for linear index x+G*(y+G*z)
    n = values_morton.shape[0]
    out = values_morton[:, lut]  # now in linear order, x fastest
    # flat index i = x + G*y + G^2*z reshaped C-order -> axes [z, y, x]
    return out.reshape(n, GRID, GRID, GRID)


def linear_cascades_to_morton(values_linear: np.ndarray) -> np.ndarray:
    """(n_cascades, 128, 128, 128) [z,y,x] -> (n_cascades, 128^3) morton."""
    from nerf_glasses_tpu.ops.morton import morton_order_lut
    lut = morton_order_lut(GRID)
    n = values_linear.shape[0]
    flat = values_linear.reshape(n, -1)  # x fastest
    out = np.empty_like(flat)
    out[:, lut] = flat
    return out

# ---------------------------------------------------------------------------
# Empty-space jump grid (cascade 0)
# ---------------------------------------------------------------------------

def build_skip_grid(occ: jnp.ndarray, max_level: int = 4) -> jnp.ndarray:
    """Per-voxel empty-space jump levels for cascade 0 -> (G,G,G) uint8.

    255 = occupied; otherwise the value k is the COARSEST level such that
    the aligned 2^k-voxel block containing the voxel is entirely empty
    (0..max_level). A marcher then advances to that block's boundary in
    a single step, so one uint8 gather buys a jump of up to 2^max_level
    voxels. This recovers the multi-resolution empty-space skipping the
    reference gets from its cascade mips (testbed.cu:293-315) INSIDE a
    single cascade, where every DDA probe would otherwise move one fine
    voxel. The occupancy gather is the expected dominant cost of every
    skipping loop (one (N,) random gather per iteration), so fewer,
    larger jumps should translate ~1:1 into frame time.
    """
    g = jnp.asarray(occ[0] > 0)                      # (G, G, G) [z, y, x]
    skip = jnp.zeros((C.NERF_GRIDSIZE,) * 3, jnp.uint8)
    level = g
    for k in range(1, max_level + 1):
        G = C.NERF_GRIDSIZE >> k
        level = level.reshape(G, 2, G, 2, G, 2).any(axis=(1, 3, 5))
        up = jnp.repeat(jnp.repeat(jnp.repeat(
            level, 1 << k, 0), 1 << k, 1), 1 << k, 2)
        skip = jnp.where(~up, jnp.uint8(k), skip)
    return jnp.where(g, jnp.uint8(255), skip)


def skip_level_at(skip: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Gather jump levels at cascade-0 positions (..., 3) -> (...,) uint8
    (same trunc-toward-zero indexing as occupied_at)."""
    return skip_level_at_soa(skip, pos[..., 0], pos[..., 1], pos[..., 2])


def skip_level_at_soa(skip: jnp.ndarray, px, py, pz) -> jnp.ndarray:
    """Component-array variant of skip_level_at."""
    def cell(p):
        return jnp.clip(jnp.trunc(p * GRID).astype(jnp.int32), 0, GRID - 1)

    flat = (cell(pz) * GRID + cell(py)) * GRID + cell(px)
    return jnp.take(skip.reshape(-1), flat, mode="clip")


def _dilate_chebyshev(g: jnp.ndarray) -> jnp.ndarray:
    """One 3x3x3 Chebyshev dilation of a bool grid, zero beyond edges
    (nothing is occupied outside the cascade-0 cube; rays are bounded
    separately by their aabb exit t)."""
    for axis in range(3):
        n = g.shape[axis]
        fwd = jnp.concatenate(
            [jax.lax.slice_in_dim(g, 1, n, axis=axis),
             jnp.zeros_like(jax.lax.slice_in_dim(g, 0, 1, axis=axis))],
            axis=axis)
        bwd = jnp.concatenate(
            [jnp.zeros_like(jax.lax.slice_in_dim(g, 0, 1, axis=axis)),
             jax.lax.slice_in_dim(g, 0, n - 1, axis=axis)],
            axis=axis)
        g = g | fwd | bwd
    return g


def build_dist_grid(occ: jnp.ndarray, max_dist: int = 31,
                    level: int = 0) -> jnp.ndarray:
    """Chebyshev distance (voxels) to the nearest occupied `level`
    voxel -> (G,G,G) uint8; 0 = occupied, values capped at max_dist.

    A marcher holding this grid advances per iteration to the EXIT of
    the centered (2k-1)^3 empty box around the current voxel (k = the
    gathered distance) instead of the next aligned block boundary the
    mip jump grid (build_skip_grid) offers — the same one-uint8-gather
    iteration cost, but hops that scale with the actual clearance and
    don't reset at power-of-two block edges, so a frame needs far fewer
    sequential advance iterations (expected to be the dominant
    flash-frame cost; see raymarch._dist_probe).

    Built by iterated separable dilation: after k dilations a voxel is
    marked iff its distance is <= k, so summing the unmarked indicator
    over max_dist rounds yields the capped distance. Runs as one fused
    scan at bake/scene-build time.
    """
    g = jnp.asarray(occ[level] > 0)                  # (G, G, G) [z, y, x]

    def step(carry, _):
        cur, dist = carry
        cur = _dilate_chebyshev(cur)
        return (cur, dist + (~cur).astype(jnp.uint8)), None

    dist0 = (~g).astype(jnp.uint8)                   # k = 0 term
    (_, dist), _ = jax.lax.scan(step, (g, dist0), None, length=max_dist - 1)
    return dist


def build_dist_grid_cascades(occ: jnp.ndarray, max_cascade: int,
                             max_dist: int = 31) -> jnp.ndarray:
    """Per-cascade Chebyshev clearance pyramid -> (n_casc, G, G, G)
    uint8, each level in its own cascade-local voxel units.

    Soundness of hopping a cascade-c empty ball: build_occupancy pools
    each finer level's occupancy into the inner half of the next level
    (the inner half IS the finer cascade's cube), so cascade-c emptiness
    implies no finer-cascade content inside the ball. Coarser cascades
    can still be occupied where c is empty — the marcher must clamp the
    hop so its governing mip cannot INCREASE mid-hop (see
    raymarch._dist_probe_mips)."""
    return jnp.stack([build_dist_grid(occ, max_dist, level=c)
                      for c in range(max_cascade + 1)])


def dist_at_soa(dist: jnp.ndarray, px, py, pz) -> jnp.ndarray:
    """Gather Chebyshev distances at cascade-0 positions -> (...,) uint8
    (same trunc-toward-zero indexing as occupied_at)."""
    def cell(p):
        return jnp.clip(jnp.trunc(p * GRID).astype(jnp.int32), 0, GRID - 1)

    flat = (cell(pz) * GRID + cell(py)) * GRID + cell(px)
    return jnp.take(dist.reshape(-1), flat, mode="clip")
