"""Volumetric ray marching with occupancy-grid skipping and depth-gated
mesh-surface compositing — the core renderer.

Re-design of the reference's NerfTracer pipeline
(init_rays_with_payload_kernel_nerf  testbed.cu:355-467,
 advance_pos_nerf                    testbed.cu:470-537,
 generate_next_nerf_network_inputs   testbed.cu:564-633,
 composite_kernel_nerf               testbed.cu:784-905,
 trace loop                          testbed.cu:1938-2053):

The CUDA implementation is a host-driven loop with atomic ray compaction
and per-iteration alive-counter readbacks. The translation here is
`march_frame`: ONE compiled dispatch marches a whole frame to completion.
Inside it, an outer `lax.while_loop` alternates

  1. a sort-free stable partition (cumsum-based) that permutes ray ids so
     alive rays are contiguous — the fixed-shape equivalent of
     compact_kernel_nerf's atomic compaction (testbed.cu:539-562), and
  2. a `fori_loop` over just ceil(n_alive / CHUNK) fixed-size chunks;
     each chunk gathers its ray state, runs an epoch of R rounds x K
     occupancy-gated samples (network evaluated as bf16 matmuls on
     the (CHUNK*K) batch), composites, and scatters state back.

So dead rays stop consuming FLOPs after at most one epoch, there are no
host round trips mid-frame, and all shapes are static.

Mesh-surface gating (the paper's hybrid-occlusion core): each ray may
carry (t_surface, surface_rgba) produced by the mesh pass. Semantics match
the reference exactly:
  - dead rays with a surface are revived at t = t_surface (advance_pos,
    testbed.cu:487-493)
  - marching stops at t_surface when the surface is opaque
    (testbed.cu:600-607)
  - when the march crosses t_surface, the surface color is alpha-blended
    in front-to-back order (testbed.cu:843-857)
  - rays that terminate (exit the aabb / hit an opaque surface) blend any
    unconsumed surface color weighted by remaining transmittance
    (testbed.cu:886-897).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nerf_glasses_tpu import constants as C
from nerf_glasses_tpu.config import NGPConfig
from nerf_glasses_tpu.ops import occupancy as occ_ops
from nerf_glasses_tpu.ops.bake import (sample_feat_grid,
                                       sample_feat_grid_mip,
                                       sample_sigma_bricks,
                                       sample_sigma_bricks_mip_soa)
from nerf_glasses_tpu.ops.compaction import stable_partition_ids
from nerf_glasses_tpu.ops.network import (apply_density_activation,
                                          apply_network,
                                          apply_rgb_activation,
                                          rgb_from_features)
from nerf_glasses_tpu.utils.bbox import contains_aabb, ray_intersect_aabb


@dataclasses.dataclass(frozen=True)
class MarchOptions:
    config: NGPConfig
    cone_angle: float = 0.0
    min_transmittance: float = C.DEFAULT_MIN_TRANSMITTANCE
    steps_per_round: int = C.MAX_STEPS_INBETWEEN_COMPACTION   # K
    # Empty-space DDA budget per sample slot during network rounds (small
    # gaps only; long stretches are crossed by the per-epoch advance pass
    # at occupancy-gather cost, ~60x cheaper than network samples).
    skip_iters: int = 3
    init_skip_iters: int = 16    # bounded DDA skips at ray init
    advance_iters: int = 48      # per-epoch compacted advance pass
    max_rounds: int = C.MARCH_ITER // C.MAX_STEPS_INBETWEEN_COMPACTION
    min_mip: int = 0
    jitter: bool = True
    compute_dtype: str = "bfloat16"
    # march_frame compaction parameters (not yet tuned on the GPU).
    # Paths that run the NETWORK inside the march use 4096 (bigger
    # matmul batches); the flash path (no network in the march) uses
    # 2048, set explicitly by the flash option bundles.
    chunk: int = 1 << 12         # rays per compacted chunk
    rounds_per_epoch: int = 1    # K-sample rounds between compactions
    # Baked-density fast path (ops/bake.py): sigma from a trilinear grid
    # lookup; the full network runs only for samples whose prospective
    # compositing weight exceeds sig_threshold (compacted in
    # color_subchunk batches). Requires scene["sigma"].
    use_baked_sigma: bool = False
    # scene["sigma"] stores RAW density (bake_grids log_space=True):
    # apply the density activation AFTER trilinear interpolation —
    # geometric instead of arithmetic interpolation for the exp
    # activation, which removes the half-density silhouette halo linear
    # lerp puts around every opaque/empty boundary
    baked_sigma_log: bool = False
    sig_threshold: float = 1e-3
    color_subchunk: int = 1 << 12
    # Vectorized rounds: a round's K sample positions are t + i*dt —
    # computable in one vectorized shot (single batched occupancy
    # probe, cumprod compositing) instead of K sequential gen/composite
    # scan steps of ~25 small ops each. With cone_angle == 0 dt is a
    # global constant; with cone stepping dt is per-ray, constant
    # within the round (see _march_round — slight oversampling,
    # fidelity-conservative). Off by default on the hypothesis that the
    # sequential path's cost is the occupancy gathers, which the
    # vectorized path repeats per sample while covering less distance
    # per round (not measured on the GPU).
    # Samples in unoccupied voxels get zero alpha instead of being
    # skipped; the per-epoch advance pass still jumps the long empty
    # stretches.
    vector_rounds: bool = False
    # depth of field (pixel_to_ray's aperture path, ngp_common.cuh:330-345):
    # jitter origins on a Shirley disk of radius aperture_size in the
    # camera plane, re-aiming each ray at its focus_z plane point
    aperture_size: float = 0.0
    focus_z: float = 1.0
    # Deferred shading (SNeRG-style): the march composites weights from
    # the baked sigma alone (ZERO network evals in the march loop); one
    # network eval per surviving ray at its max-weight sample happens in
    # a compacted pass at the end, scaled by the ray's accumulated NeRF
    # weight. Exact for a surface whose color is locally constant over
    # the crossing; the bench PSNR gate bounds the real deviation.
    deferred_color: bool = False
    # Per-SAMPLE color from the baked feature grid (requires
    # scene["feat"]): the significant-sample color pass samples the
    # 16-wide feature table + rgb MLP instead of the full network
    # (hash encode + density MLP). Exact per-sample compositing
    # structure (unlike deferred_color's one-eval-per-ray
    # approximation) at feature-grid quantization cost. Ignored when
    # deferred_color is set.
    feat_color: bool = False
    # Chunk size of the deferred-shade pass (None = the march chunk;
    # bigger matmul batches are the untested alternative).
    shade_chunk: int = None
    # Flash init: walk the occupancy grid at 1/lowres_factor resolution
    # (one ray per FxF pixel block), min-filter the first-hit distances
    # over a 3x3 low-res neighborhood minus a slack margin, and start
    # every full-res ray there. Cuts the per-ray DDA probe gathers to
    # ~1/F^2. Rays whose entire 3x3 low-res neighborhood sees no
    # occupancy are declared dead — a floater smaller than ~2F px
    # between low-res samples can be missed (the PSNR gate bounds this;
    # remove_floaties kills real ones). 0 = off; plain-camera path only.
    lowres_factor: int = 0
    lowres_iters: int = 64
    lowres_slack: float = 6.0 / 128.0
    # RAY-WALK coarse pass only (no scene["occ_pts"]): cull rays whose
    # entire 3x3 coarse neighborhood saw no occupancy. True = fast but
    # UNSAFE (an isolated NeRF structure thinner than ~2F px between
    # coarse samples disappears); False = safe but expensive (un-culled
    # rays all enter the first march epoch).
    # Scenes carrying "occ_pts" use the VOXEL-SPLAT init instead, which
    # culls safely by construction and ignores this flag.
    lowres_cull: bool = False
    # Voxel-splat coarse init: min-filter radius in coarse cells. The
    # cull/t_floor is conservative for content at camera distance
    # >= voxel_halfdiag * width / (2*|cam_u|*radius*F) (~0.09 NGP units
    # for 720p defaults — closer content than that would need a larger
    # radius).
    lowres_splat_radius: int = 3
    # Gate vectorized-round samples on the occupancy grid even when the
    # baked sigma grid is available (one extra (K*n)-row gather per
    # round). Without it, rays the advance budget failed to settle
    # sample the baked grid's dilated boundary shell blindly — phantom
    # silhouette alpha (measured on a grazing sphere: 37 dB / 0.22 mean
    # silhouette-band alpha error ungated vs 61 dB / 0.009 gated,
    # tests/test_flash_failures.py). Default ON.
    vector_occ_gate: bool = True
    # The advance is attacked by reducing ITERATIONS via the Chebyshev
    # distance grid below (a fused per-ray march kernel, which could
    # gather from the grids inside the kernel, is open work).
    # Advance on a distance-to-occupied grid (scene["dist"], built by
    # occupancy.build_dist_grid) instead of the mip jump grid: each
    # iteration hops the full empty Chebyshev ball radius rather than
    # one block boundary, so far fewer sequential gather iterations
    # cover the same empty span. Single-cascade fast path only.
    dist_advance: bool = False

    @property
    def cdtype(self):
        return jnp.bfloat16 if self.compute_dtype == "bfloat16" else jnp.float32


def make_scene(occ_grid, render_aabb_min, render_aabb_max,
               render_aabb_to_local, train_aabb_min, train_aabb_max) -> Dict:
    """Bundle the non-parameter scene arrays."""
    occ_dev = jnp.asarray(occ_grid, jnp.uint8)
    return {
        "occ": occ_dev,
        # single-gather multi-level empty-space jumps (cascade 0)
        "skip": occ_ops.build_skip_grid(occ_dev),
        "render_min": jnp.asarray(render_aabb_min, jnp.float32),
        "render_max": jnp.asarray(render_aabb_max, jnp.float32),
        "local": jnp.asarray(render_aabb_to_local, jnp.float32),
        "train_min": jnp.asarray(train_aabb_min, jnp.float32),
        "train_max": jnp.asarray(train_aabb_max, jnp.float32),
    }


def scene_with_extra_dims(scene: Dict, extra_dims) -> Dict:
    """Attach inference latent codes (E,) for models trained with
    n_extra_learnable_dims > 0 (testbed.cu:1614-1631)."""
    return {**scene, "extra_dims": jnp.asarray(extra_dims, jnp.float32)}


def _hash_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Cheap integer hash -> [0,1) float; replaces the reference's scrambled
    Sobol start-t jitter (random_val.cuh ld_random_val)."""
    x = x.astype(jnp.uint32)
    x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x.astype(jnp.float32) * (1.0 / 4294967296.0)


def _radical_inverse(base: int, i: int) -> float:
    """Halton radical inverse of a non-negative integer -> [0,1).
    Drives the per-sample sub-pixel offset (the stand-in for
    random_val.cuh's ld_random_pixel_offset, which the reference feeds a
    scrambled Sobol sequence). Computed on the HOST per frame — as a
    traced fori_loop it cost ~60 serialized scalar device ops."""
    i = int(i)
    f = 1.0 / base
    out = 0.0
    while i > 0:
        out += f * (i % base)
        i //= base
        f /= base
    return out


# ---------------------------------------------------------------------------
# Lens models, traced (parity with utils/lens.py's numpy versions and the
# reference's pixel_to_ray, ngp_common.cuh:277-372)
# ---------------------------------------------------------------------------

def _f_theta_dirs(uv, lens_params):
    """uv (..., 2) offsets from screen center -> camera-space dirs.
    (f_theta_undistortion, ngp_common.cuh:277-291; rays with no stable
    solution get dir (1000,0,0), putting them outside the aabb.)"""
    p = lens_params
    xpix = uv[..., 0] * p[5]
    ypix = uv[..., 1] * p[6]
    norm = jnp.sqrt(xpix * xpix + ypix * ypix)
    alpha = p[0] + norm * (p[1] + norm * (p[2] + norm * (p[3] + norm * p[4])))
    sin_a, cos_a = jnp.sin(alpha), jnp.cos(alpha)
    bad = (cos_a <= jnp.float32(np.finfo(np.float32).tiny)) | (norm == 0.0)
    s = sin_a / jnp.where(norm == 0.0, 1.0, norm)
    out = jnp.stack([s * xpix, s * ypix, cos_a], axis=-1)
    err = jnp.array([1000.0, 0.0, 0.0], jnp.float32)
    return jnp.where(bad[..., None], err, out)


def _latlong_dirs(uv):
    """uv (..., 2) in [0,1] -> unit dirs (latlong_to_dir,
    ngp_common.cuh:293-299)."""
    theta = (uv[..., 1] - 0.5) * jnp.pi
    phi = (uv[..., 0] - 0.5) * jnp.pi * 2.0
    ct = jnp.cos(theta)
    return jnp.stack([jnp.sin(phi) * ct, jnp.sin(theta),
                      jnp.cos(phi) * ct], axis=-1)


def _opencv_undistort(x, y, lens_params, iterations: int = 10):
    """Iteratively invert OpenCV radial+tangential distortion (upstream
    instant-ngp's iterative_opencv_lens_undistortion; the reference stubs
    the call site at ngp_common.cuh:369-372 — wired here)."""
    k1, k2, p1, p2 = (lens_params[0], lens_params[1],
                      lens_params[2], lens_params[3])
    xu, yu = x, y

    def body(_, carry):
        xu, yu = carry
        r2 = xu * xu + yu * yu
        radial = 1.0 + r2 * (k1 + k2 * r2)
        dx = 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
        dy = p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
        return (x - dx) / radial, (y - dy) / radial

    xu, yu = jax.lax.fori_loop(0, iterations, body, (xu, yu))
    return xu, yu


def _read_image2(grid, uv):
    """Bilinear (pos * (res-1)) sample of an (Hg, Wg, 2) grid at uv (..., 2)
    — read_image<2> semantics (ngp_common.cuh:302-332), used for the
    trained distortion map."""
    hg, wg = grid.shape[0], grid.shape[1]
    pf = jnp.stack([uv[..., 0] * (wg - 1), uv[..., 1] * (hg - 1)], -1)
    t = jnp.floor(pf).astype(jnp.int32)
    w = pf - t

    def at(dx, dy):
        xi = jnp.clip(t[..., 0] + dx, 0, wg - 1)
        yi = jnp.clip(t[..., 1] + dy, 0, hg - 1)
        return grid[yi, xi]

    return ((1 - w[..., :1]) * (1 - w[..., 1:]) * at(0, 0)
            + w[..., :1] * (1 - w[..., 1:]) * at(1, 0)
            + (1 - w[..., :1]) * w[..., 1:] * at(0, 1)
            + w[..., :1] * w[..., 1:] * at(1, 1))


def _contains_local(pos, scene):
    local_pos = pos @ scene["local"].T
    return contains_aabb(local_pos, scene["render_min"], scene["render_max"])


def _ray_exit_t(o, d, scene):
    """Per-ray render-aabb exit distance -> (N,). Inside-the-box tests in
    marching loops reduce to `t <= t_exit` (the aabb is convex and t only
    grows), replacing a per-iteration rotate+compare of the position
    (~6 ops) with one compare. Rays that miss the box entirely get -inf
    (never inside), matching contains' False."""
    ol = o @ scene["local"].T
    dl = d @ scene["local"].T
    _, tmax = ray_intersect_aabb(ol, dl, scene["render_min"],
                                 scene["render_max"])
    return jnp.where(tmax >= jnp.float32(3e38), -jnp.inf, tmax)


def _dist_probe(scene, pos, t, d):
    """One-gather Chebyshev clearance probe -> (occupied, t_advanced).

    scene["dist"] (occupancy.build_dist_grid) holds the distance in
    voxels to the nearest occupied cascade-0 voxel. The ray hops to the
    exit of the centered empty box that distance guarantees: k == 1
    degenerates to the single-voxel DDA step, k == 0 is occupied.
    Conservative (the box is empty), cone_angle == 0 only (gated by
    callers): advance quantizes to the same MIN_CONE_STEPSIZE lattice
    as the DDA probe, so only empty lattice points are ever skipped."""
    fdt = jnp.float32(C.MIN_CONE_STEPSIZE)
    G = C.NERF_GRIDSIZE
    vox = jnp.float32(1.0 / G)
    k = occ_ops.dist_at_soa(scene["dist"], pos[..., 0], pos[..., 1],
                            pos[..., 2]).astype(jnp.float32)
    occ = k == 0.0
    vi = jnp.clip(jnp.trunc(pos * G), 0.0, G - 1.0)
    kk = k[..., None]
    bound = jnp.where(d > 0.0, (vi + kk) * vox, (vi - (kk - 1.0)) * vox)
    dir_zero = d == 0.0
    tt = jnp.where(dir_zero, 1e9, (bound - pos) / jnp.where(dir_zero, 1.0, d))
    delta = jnp.maximum(jnp.min(tt, axis=-1), 0.0)
    adv = t + jnp.maximum(jnp.ceil(delta / fdt), 1.0) * fdt
    return occ, adv


def _dist_probe_mips(scene, pos, t, d, dt, opts: MarchOptions):
    """Cascade-aware Chebyshev clearance probe -> (occupied, t_advanced).

    scene["dist_mips"] (occupancy.build_dist_grid_cascades) holds, per
    cascade, the distance in cascade-local voxels to the nearest
    occupied voxel of that cascade. ONE uint8 gather at the sample's
    governing mip yields both the occupancy bit (k == 0, identical to
    occupied_at) and a hop to the exit of the guaranteed-empty
    (2k-1)^3 ball.

    Soundness: cascade-c emptiness covers all finer cascades (pooling,
    build_dist_grid_cascades), but NOT coarser ones, so the hop is
    clamped so the governing mip cannot increase mid-hop:
      - delta_cube: distance to exiting the side-2^mip cube
        (mip_from_pos can only grow past that boundary);
      - delta_dtmip: distance until cone-stepping dt crosses its next
        power of two (mip_from_dt grows there; infinite when dt sits at
        the MAX_CONE_STEPSIZE clamp or cone_angle == 0).
    Samples remain occupancy-gated at their own positions, so the
    at-least-one-dt progress step may overshoot the clamps exactly like
    the DDA probe's quantized stepping does."""
    G = C.NERF_GRIDSIZE
    occ_pyr = scene["dist_mips"]
    mip = occ_ops.mip_from_dt(dt, pos, opts.config.max_cascade)
    mip = jnp.maximum(mip, opts.min_mip)
    s = jnp.exp2(mip.astype(jnp.float32))
    q = (pos - 0.5) / s[..., None] + 0.5            # cascade-local [0,1]

    cell = jnp.clip(jnp.trunc(q * G), 0.0, G - 1.0)
    ci = cell.astype(jnp.int32)
    flat = (((mip * G + ci[..., 2]) * G + ci[..., 1]) * G + ci[..., 0])
    k = jnp.take(occ_pyr.reshape(-1), flat, mode="clip"
                 ).astype(jnp.float32)
    occ = k == 0.0

    vox = jnp.float32(1.0 / G)
    kk = k[..., None]
    bound = jnp.where(d > 0.0, (cell + kk) * vox, (cell - (kk - 1.0)) * vox)
    dl = d / s[..., None]                            # local-units direction
    dir_zero = d == 0.0
    tt = jnp.where(dir_zero, 1e9,
                   (bound - q) / jnp.where(dir_zero, 1.0, dl))
    delta_ball = jnp.maximum(jnp.min(tt, axis=-1), 0.0)

    # clamp 1: exit of the governing side-2^mip cube (centered 0.5)
    cb = jnp.where(d > 0.0, 0.5 + 0.5 * s[..., None],
                   0.5 - 0.5 * s[..., None])
    tc = jnp.where(dir_zero, 1e9,
                   (cb - pos) / jnp.where(dir_zero, 1.0, d))
    delta_cube = jnp.maximum(jnp.min(tc, axis=-1), 0.0) + vox

    # clamp 2: next dt-mip increment of the cone ladder
    if opts.cone_angle > 0.0:
        dtg = dt * (2 * G)
        _, e = jnp.frexp(dtg)
        tau_next = jnp.exp2(jnp.maximum(e, 0).astype(jnp.float32)) \
            / (2 * G * opts.cone_angle)
        tau = dt / opts.cone_angle      # == t - t_start while unclamped
        delta_dtmip = jnp.where(dt >= C.MAX_CONE_STEPSIZE - 1e-9,
                                jnp.float32(1e9),
                                jnp.maximum(tau_next - tau, 0.0) + dt)
    else:
        delta_dtmip = jnp.float32(1e9)

    delta = jnp.minimum(jnp.minimum(delta_ball, delta_cube), delta_dtmip)
    adv = _ladder_jump(t, t + jnp.maximum(delta, 0.0), opts.cone_angle)
    return occ, adv


def _ladder_jump(t, target, cone_angle: float):
    """Smallest point >= target on the stepping ladder
    t_{i+1} = t_i + calc_dt(t_i) continued from t (>= one step).

    The exact march walks this ladder through empty space one
    (bounded-loop) voxel hop at a time (occupancy.advance_to_next_voxel)
    — landing a clearance hop ON the ladder keeps the fast path's
    sample positions aligned with the exact path's, so a fidelity gate
    measures density-model error, not quadrature phase shifts. Closed
    form per regime: uniform MIN_CONE_STEPSIZE below t1 = MIN/cone,
    geometric x(1+cone) between t1 and t2 = MAX/cone, uniform MAX
    above. (fp32 pow drifts ~1e-6 relative vs iterated addition —
    sub-voxel, absorbed by the per-sample occupancy gate.)"""
    dmin = jnp.float32(C.MIN_CONE_STEPSIZE)
    if cone_angle == 0.0:
        n = jnp.maximum(jnp.ceil((target - t) / dmin), 1.0)
        return t + n * dmin
    dmax = jnp.float32(C.MAX_CONE_STEPSIZE)
    t1 = dmin / cone_angle
    t2 = dmax / cone_angle
    lg = jnp.float32(np.log1p(cone_angle))

    # regime A (t < t1): uniform dmin up to min(target, first point >= t1)
    tA_end = jnp.minimum(target, t1 + dmin)
    nA = jnp.ceil(jnp.maximum(tA_end - t, 0.0) / dmin)
    tA = t + nA * dmin
    out = jnp.where(t < t1, tA, t)
    # regime B (t1 <= out < t2, target beyond): geometric x(1+cone)
    need_b = (out < target) & (out >= t1) & (out < t2)
    ratio = jnp.maximum(jnp.minimum(target, t2 * (1.0 + cone_angle))
                        / jnp.maximum(out, 1e-30), 1.0)
    nB = jnp.ceil(jnp.log(ratio) / lg)
    tB = out * jnp.exp(nB * lg)
    out = jnp.where(need_b, tB, out)
    # regime C (out >= t2, target beyond): uniform dmax
    need_c = (out < target) & (out >= t2)
    nC = jnp.ceil((target - out) / dmax)
    out = jnp.where(need_c, out + nC * dmax, out)
    # guarantee at least one step
    return jnp.maximum(out, t + occ_ops.calc_dt(t, cone_angle))


def _skip_probe(scene, pos, t, d, idir, dt, opts: MarchOptions):
    """One-gather DDA probe -> (occupied, t_advanced).

    On single-cascade scenes the jump grid gives both the occupancy bit
    and the coarsest safely-empty block level in a single uint8 gather,
    so each skipping iteration advances to that block's boundary (up to
    16 voxels) instead of one fine voxel. Multi-cascade scenes fall back
    to the per-mip probe. With MarchOptions.dist_advance the jump grid
    is swapped for the Chebyshev clearance grid (_dist_probe), whose
    hops scale with the measured clearance instead of block size."""
    if (opts.dist_advance and opts.cone_angle == 0.0
            and opts.config.max_cascade == 0 and opts.min_mip == 0
            and "dist" in scene):
        return _dist_probe(scene, pos, t, d)
    if (opts.dist_advance and opts.config.max_cascade > 0
            and "dist_mips" in scene):
        return _dist_probe_mips(scene, pos, t, d, dt, opts)
    if opts.config.max_cascade == 0 and opts.min_mip == 0 and "skip" in scene:
        lv = occ_ops.skip_level_at(scene["skip"], pos)
        occ = lv == 255
        res = (C.NERF_GRIDSIZE >> jnp.minimum(lv, 4).astype(jnp.int32)
               ).astype(jnp.float32)
        adv = occ_ops.advance_to_next_voxel(t, opts.cone_angle, pos, d,
                                            idir, res)
        return occ, adv
    occ, mip = _occupied(scene, pos, dt, opts)
    res = (C.NERF_GRIDSIZE >> mip).astype(jnp.float32)
    adv = occ_ops.advance_to_next_voxel(t, opts.cone_angle, pos, d, idir, res)
    return occ, adv


def _occupied(scene, pos, dt, opts: MarchOptions):
    if opts.config.max_cascade == 0 and opts.min_mip == 0:
        # unit-cube scene (the reference default): single cascade, no
        # mip math needed
        mip = jnp.zeros(pos.shape[:-1], jnp.int32)
    else:
        mip = occ_ops.mip_from_dt(dt, pos, opts.config.max_cascade)
        mip = jnp.maximum(mip, opts.min_mip)
    return occ_ops.occupied_at(scene["occ"], pos, mip), mip


# ---------------------------------------------------------------------------
# Ray init (init_rays_with_payload + advance_pos_nerf)
# ---------------------------------------------------------------------------

def init_rays(scene, o, d, t_surface, surface_a, opts: MarchOptions,
              sample_index=0, ray_idx: Optional[jnp.ndarray] = None):
    """o, d: (N,3) origin (already in NGP space, +0.5 shifted) and unit dir.

    Returns (t, t_start, alive).
    """
    n = o.shape[0]
    tmin, _ = ray_intersect_aabb(o, d, scene["render_min"], scene["render_max"])
    t = jnp.maximum(tmin, 0.0) + 1e-6
    alive = contains_aabb(o + d * t[:, None], scene["render_min"],
                          scene["render_max"])

    # surface revive (advance_pos_nerf, testbed.cu:487-493)
    has_surface = t_surface > 0.0
    t = jnp.where(~alive & has_surface, t_surface, t)
    alive = alive | has_surface

    # start-t jitter
    if opts.jitter:
        if ray_idx is None:
            ray_idx = jnp.arange(n, dtype=jnp.uint32)
        seed = jnp.asarray(sample_index).astype(jnp.uint32) * jnp.uint32(2654435761)
        jit01 = _hash_u32(ray_idx * jnp.uint32(786433) + seed)
        t = t + jit01 * occ_ops.calc_dt(t, opts.cone_angle)

    idir = 1.0 / d

    # empty-space skip to the first occupied voxel (bounded DDA)
    def body(_, carry):
        t, alive, settled = carry
        pos = o + d * t[:, None]
        at_surface = has_surface & (t > t_surface)
        inside = _contains_local(pos, scene)
        dt = occ_ops.calc_dt(t, opts.cone_angle)
        occ, adv = _skip_probe(scene, pos, t, d, idir, dt, opts)

        newly_surface = ~settled & alive & at_surface
        newly_exit = ~settled & alive & ~at_surface & ~inside
        newly_hit = ~settled & alive & ~at_surface & inside & occ

        t = jnp.where(newly_surface | (newly_exit & has_surface), t_surface, t)
        alive = jnp.where(newly_exit & ~has_surface, False, alive)
        settled = settled | newly_surface | newly_exit | newly_hit | ~alive
        t = jnp.where(~settled & alive, adv, t)
        return t, alive, settled

    settled0 = ~alive
    t, alive, _ = jax.lax.fori_loop(0, opts.init_skip_iters, body,
                                    (t, alive, settled0))

    pos_t = o + d * t[:, None]
    in_mip0 = occ_ops.mip_from_pos(pos_t, opts.config.max_cascade) == 0
    t_start = jnp.where(in_mip0, t, 0.0)
    return t, t_start, alive


def lowres_t_enter(scene, o, d, opts: MarchOptions):
    """Walk rays to the first occupied voxel on occupancy gathers alone
    -> (t (N,), hit (N,) bool). The flash-init coarse pass: one ray per
    FxF pixel block; rays that neither hit nor exit within lowres_iters
    report their current t with hit=True (conservative)."""
    tmin, _ = ray_intersect_aabb(o, d, scene["render_min"],
                                 scene["render_max"])
    t = jnp.maximum(tmin, 0.0) + 1e-6
    alive = contains_aabb(o + d * t[:, None], scene["render_min"],
                          scene["render_max"])
    idir = 1.0 / d

    def body(_, carry):
        t, alive, settled = carry
        pos = o + d * t[:, None]
        inside = _contains_local(pos, scene)
        dt = occ_ops.calc_dt(t, opts.cone_angle)
        occ, adv = _skip_probe(scene, pos, t, d, idir, dt, opts)
        newly_exit = ~settled & alive & ~inside
        newly_hit = ~settled & alive & inside & occ
        alive = alive & ~newly_exit
        settled = settled | newly_hit | ~alive
        t = jnp.where(~settled & alive, adv, t)
        return t, alive, settled

    t, alive, _ = jax.lax.fori_loop(0, opts.lowres_iters, body,
                                    (t, alive, ~alive))
    return t, alive


def flash_init(scene, cam, width: int, height: int, opts: MarchOptions):
    """Flash coarse init -> (t_floor (H, W), alive (H, W) bool) for a
    plain-perspective packed camera, traced (callable inside jit).

    Two strategies:
      - VOXEL SPLAT (scene["occ_pts"] present — (M, 3) NGP-space centers
        of occupied mip-0 voxels): project every occupied voxel,
        scatter-min its camera depth into the (H/F, W/F) coarse grid,
        min-filter with radius opts.lowres_splat_radius. Every occupied
        voxel lands in the grid by construction, so the cull is
        conservative (no thin-structure dropout) at ~6 device ops.
      - RAY WALK (fallback): one occupancy DDA ray per FxF block + 3x3
        min filter (lowres_t_enter); cull only when opts.lowres_cull
        (unsafe for sub-coarse-pitch structures).
    """
    F = opts.lowres_factor
    Hl = (height + F - 1) // F
    Wl = (width + F - 1) // F
    if "occ_pts" in scene:
        pts = scene["occ_pts"]
        eye = cam[:, 3] + 0.5
        inv = jnp.linalg.inv(cam[:, :3])
        q = (pts - eye) @ inv.T          # (M, 3): (x_ndc*s, y_ndc*s, s)
        qz = q[:, 2]
        valid = qz > 1e-6
        qs = jnp.where(valid, qz, 1.0)
        u = q[:, 0] / qs * 0.5 + 0.5
        v = q[:, 1] / qs * 0.5 + 0.5
        cx = jnp.floor(u * width / F).astype(jnp.int32)
        cy = jnp.floor(v * height / F).astype(jnp.int32)
        inb = valid & (cx >= 0) & (cx < Wl) & (cy >= 0) & (cy < Hl)
        cell = jnp.where(inb, cy * Wl + cx, Hl * Wl)   # overflow slot
        # per-point conservative pad (scene["occ_pts_pad"]): voxel
        # half-diagonal, so content entering in FRONT of the center
        # still clears the floor — multi-cascade scenes splat coarse
        # cascades whose voxels are 2^c wider than lowres_slack covers
        qz_splat = (qz - scene["occ_pts_pad"] if "occ_pts_pad" in scene
                    else qz)
        tgrid = jnp.full((Hl * Wl + 1,), jnp.inf).at[cell].min(qz_splat)
        t_img = tgrid[:-1].reshape(Hl, Wl)
        R = opts.lowres_splat_radius
        K = 2 * R + 1
        p = jnp.pad(t_img, R, mode="constant", constant_values=jnp.inf)
        tmin = t_img
        for dy in range(K):            # separable would save ops; K is
            for dx in range(K):        # small and the grid is tiny
                if dy == R and dx == R:
                    continue
                tmin = jnp.minimum(tmin, p[dy:dy + Hl, dx:dx + Wl])
        alive_img = jnp.isfinite(tmin)
        tmin = jnp.where(alive_img, tmin - opts.lowres_slack, 0.0)
        return tmin, alive_img

    lx = jax.lax.broadcasted_iota(jnp.float32, (Hl, Wl), 1)
    ly = jax.lax.broadcasted_iota(jnp.float32, (Hl, Wl), 0)
    ul = (lx * F + 0.5 * F) / width * 2.0 - 1.0
    vl = (ly * F + 0.5 * F) / height * 2.0 - 1.0
    ndc = jnp.stack([ul, vl, jnp.ones((Hl, Wl))], -1).reshape(-1, 3)
    ld = ndc @ cam[:, :3].T
    ld = ld / jnp.linalg.norm(ld, axis=-1, keepdims=True)
    lo = jnp.broadcast_to(cam[:, 3] + 0.5, ld.shape)
    t_l, hit_l = lowres_t_enter(scene, lo, ld, opts)
    t_img = jnp.where(hit_l, t_l, jnp.inf).reshape(Hl, Wl)
    p9 = jnp.pad(t_img, 1, mode="edge")
    tmin9 = t_img
    for dy in range(3):
        for dx in range(3):
            tmin9 = jnp.minimum(tmin9, p9[dy:dy + Hl, dx:dx + Wl])
    alive_img = jnp.isfinite(tmin9)
    tmin9 = jnp.where(alive_img, tmin9 - opts.lowres_slack, 0.0)
    if not opts.lowres_cull:
        # safe mode: un-hit rays start at the aabb entry instead of
        # dying (see MarchOptions.lowres_cull)
        alive_img = jnp.ones_like(alive_img)
    return tmin9, alive_img


def upsample_flash_init(tmin, alive_img, width: int, height: int, F: int):
    """(H/F, W/F) coarse init -> flattened full-res (t_floor, alive)."""
    t_up = jnp.repeat(jnp.repeat(tmin, F, axis=0)[:height],
                      F, axis=1)[:, :width].reshape(-1)
    a_up = jnp.repeat(jnp.repeat(alive_img, F, axis=0)[:height],
                      F, axis=1)[:, :width].reshape(-1)
    return t_up, a_up


def _make_state(scene, o, d, surface_rgba, t_surface, opts, sample_index,
                t_floor=None, alive_mask=None):
    t0, t_start, alive0 = init_rays(scene, o, d, t_surface,
                                    surface_rgba[:, 3], opts, sample_index)
    n = o.shape[0]
    if t_floor is not None:
        # flash init: start at the conservative coarse-pass first-hit
        # distance; rays the coarse pass declared empty only survive via
        # their mesh-surface payload (and jump straight to it — there is
        # no NeRF content before t_surface for them)
        has_surface = t_surface > 0.0
        t0 = jnp.maximum(t0, jnp.where(alive_mask, t_floor,
                                       jnp.where(has_surface, t_surface,
                                                 t0)))
        alive0 = alive0 & (alive_mask | has_surface)
    return {
        # per-ray constants (ride along so compaction can gather them)
        "o": o, "d": d, "surf": surface_rgba, "t_surf": t_surface,
        "t_start": t_start,
        # mutable march state
        "t": t0,
        "rgba": jnp.zeros((n, 4), jnp.float32),
        "depth": jnp.zeros((n,), jnp.float32),
        "max_weight": jnp.zeros((n,), jnp.float32),
        "alive": alive0,
        "surf_a": jnp.where(alive0, surface_rgba[:, 3], 0.0),
        # NeRF-only weight sum (excludes surface blend weight), used by
        # the deferred shading pass; dead weight otherwise
        "wn": jnp.zeros((n,), jnp.float32),
    }


# ---------------------------------------------------------------------------
# Advance pass: move rays through empty space to the next occupied voxel
# without spending network rounds (advance_pos_nerf semantics,
# testbed.cu:470-537, applied per compaction epoch on the compacted
# chunk). Rays exiting the aabb with no pending surface die here; rays
# with a pending surface are parked at t_surface for the round logic.
# ---------------------------------------------------------------------------

def _advance_pass(st, scene, opts: MarchOptions, iters: int):
    o, d = st["o"], st["d"]
    idir = 1.0 / d
    t_surface = st["t_surf"]
    has_surface = t_surface > 0.0

    surf_live = has_surface & (st["surf_a"] > 0.0)
    t_exit = _ray_exit_t(o, d, scene)

    def body(_, carry):
        t, alive, settled = carry
        active = ~settled & alive
        pos = o + d * t[:, None]
        surf_pending = surf_live & (t >= t_surface)
        inside = t <= t_exit
        dt = occ_ops.calc_dt(t - st["t_start"], opts.cone_angle)
        occ, adv = _skip_probe(scene, pos, t, d, idir, dt, opts)
        # park at t_surface (rounds composite the surface), die on clean
        # exit, stop at occupancy
        newly_park = active & (surf_pending | (~inside & surf_live))
        newly_exit = active & ~surf_pending & ~inside & ~surf_live
        newly_hit = active & ~surf_pending & inside & occ
        t = jnp.where(newly_park, t_surface, t)
        alive = alive & ~newly_exit
        settled = settled | newly_park | newly_hit | ~alive
        t = jnp.where(~settled & alive, adv, t)
        return t, alive, settled

    t, alive, _ = jax.lax.fori_loop(
        0, iters, body, (st["t"], st["alive"], ~st["alive"]))
    return {**st, "t": t, "alive": alive}


# ---------------------------------------------------------------------------
# One K-sample round on a ray-state dict (any batch size)
# ---------------------------------------------------------------------------

def _march_round(st, params, scene, opts: MarchOptions):
    """Generate up to K samples per ray, evaluate the network, composite.
    Returns the updated state dict. Semantics per composite_kernel_nerf —
    see module docstring."""
    cfg = opts.config
    K = opts.steps_per_round
    o, d = st["o"], st["d"]
    n = o.shape[0]
    idir = 1.0 / d
    t_surface = st["t_surf"]
    surface_rgba = st["surf"]
    t_start = st["t_start"]
    has_surface = t_surface > 0.0
    train_extent = scene["train_max"] - scene["train_min"]

    def gen_step(carry, _):
        t, gen_alive, surf_a = carry

        def skip_body(_, sk):
            t, status = sk
            active = status == 0
            pos = o + d * t[:, None]
            surf_stop = has_surface & (t > t_surface) & (surf_a >= 1.0)
            inside = _contains_local(pos, scene)
            dt = occ_ops.calc_dt(t - t_start, opts.cone_angle)
            occ, adv = _skip_probe(scene, pos, t, d, idir, dt, opts)
            new_status = jnp.where(
                surf_stop, 3, jnp.where(~inside, 2, jnp.where(occ, 1, 0)))
            status = jnp.where(active, new_status, status)
            t = jnp.where(active & (status == 0), adv, t)
            return t, status

        status0 = jnp.where(gen_alive, 0, -1)
        t, status = jax.lax.fori_loop(0, opts.skip_iters, skip_body,
                                      (t, status0))

        found = status == 1
        pos = o + d * t[:, None]
        dt = occ_ops.calc_dt(t - t_start, opts.cone_angle)
        exited = status == 2
        surf_stopped = status == 3

        t_out = jnp.where(found, t + dt, jnp.where(surf_stopped, t_surface, t))
        gen_alive = gen_alive & (found | (status == 0))
        sample = {"pos": pos, "dt": dt, "valid": found, "t_sample": t}
        return (t_out, gen_alive, surf_a), (sample, exited, surf_stopped)

    t_round_start = st["t"]
    if opts.vector_rounds:
        # vectorized rounds: all K sample positions in one shot. With
        # cone_angle == 0 the step is a global constant; with cone
        # stepping (multi-cascade scenes) the round uses a per-RAY
        # constant dt from the round-start t — exponential stepping
        # quantized to the round. Within a round the exact per-sample
        # dt would grow by <= K*cone_angle (~6% at K=16, cone 1/256),
        # so the quantization slightly OVERsamples (fidelity-
        # conservative); compositing uses the dt actually stepped, so
        # the quadrature stays consistent.
        if opts.cone_angle == 0.0:
            dt_r = jnp.full((n,), occ_ops.calc_dt(jnp.zeros(()), 0.0))
        else:
            dt_r = occ_ops.calc_dt(st["t"] - t_start, opts.cone_angle)
        t_i = st["t"][None] + dt_r[None] * jnp.arange(
            K, dtype=jnp.float32)[:, None]
        pos_k = o[None] + d[None] * t_i[..., None]               # (K, n, 3)
        surf_block = (has_surface[None] & (t_i > t_surface[None])
                      & (st["surf_a"][None] >= 1.0))
        inside = t_i <= _ray_exit_t(o, d, scene)[None]
        dt_k = jnp.broadcast_to(dt_r[None], (K, n))
        if opts.use_baked_sigma and not opts.vector_occ_gate:
            # the baked grid is occupancy-masked and ~zero in empty
            # space — skip the per-sample occupancy gather entirely
            occ_k = True
        else:
            occ_k, _ = _occupied(scene, pos_k.reshape(-1, 3),
                                 dt_k.reshape(-1), opts)
            occ_k = occ_k.reshape(K, n)
        samples = {"pos": pos_k,
                   "dt": dt_k,
                   "valid": inside & occ_k & ~surf_block,
                   "t_sample": t_i}
        surf_stopped = surf_block.any(axis=0) & st["alive"]
        exited = (~inside).any(axis=0) & st["alive"] & ~surf_stopped
        t_end = jnp.where(st["alive"],
                          jnp.where(surf_stopped, t_surface,
                                    st["t"] + K * dt_r), st["t"])
    else:
        (t_end, _, _), (samples, exited_k, surfstop_k) = jax.lax.scan(
            gen_step, (st["t"], st["alive"], st["surf_a"]), None, length=K)
        exited = exited_k.any(axis=0) & st["alive"]
        surf_stopped = surfstop_k.any(axis=0) & st["alive"]
    terminated_early = exited | surf_stopped

    # --- network evaluation on the (n*K) masked batch --------------------
    pos = samples["pos"]                          # (K, n, 3)
    valid = samples["valid"] & st["alive"][None]  # (K, n)
    pos01 = (pos - scene["train_min"]) / train_extent
    pos01 = jnp.where(valid[..., None], pos01, 0.5)
    dir01 = (d + 1.0) * 0.5
    dir01_k = jnp.broadcast_to(dir01[None], (K,) + dir01.shape)

    # --- composite setup (surface blend must precede weight estimates) ---
    rgba = st["rgba"]
    comp_alive = st["alive"]
    surf_a = st["surf_a"]

    # in-march surface blend: fires once, before the round's samples, for
    # rays whose payload-t has crossed t_surface (testbed.cu:843-857)
    t_payload = jnp.where(exited, t_round_start,
                          jnp.where(surf_stopped, t_surface, t_end))
    trigger = comp_alive & has_surface & (t_payload > t_surface) & (surf_a > 0.0)
    T = 1.0 - rgba[:, 3]
    blend = jnp.concatenate(
        [surface_rgba[:, :3] * (surf_a * T)[:, None], (surf_a * T)[:, None]],
        -1)
    rgba = jnp.where(trigger[:, None], rgba + blend, rgba)
    surf_a = jnp.where(trigger, 0.0, surf_a)
    sat = trigger & (rgba[:, 3] > 0.99)
    inv_sat = jnp.where(sat, 1.0 / jnp.maximum(rgba[:, 3], 1e-9), 1.0)
    rgba = rgba * inv_sat[:, None]
    wn = st["wn"] * inv_sat if opts.deferred_color else st["wn"]
    comp_alive = comp_alive & ~sat

    if opts.use_baked_sigma:
        if cfg.max_cascade > 0:
            # cascade pyramid (bake_grids_cascades): per-sample mip
            # selection mirrors the occupancy gate's (testbed.cu:188-202)
            mip_k = occ_ops.mip_from_dt(samples["dt"], pos, cfg.max_cascade)
            sigma = sample_sigma_bricks_mip_soa(
                scene["sigma"], cfg.max_cascade + 1,
                pos[..., 0], pos[..., 1], pos[..., 2], mip_k)
        else:
            sigma = sample_sigma_bricks(scene["sigma"], pos01)  # (K, n)
        if opts.baked_sigma_log:
            sigma = apply_density_activation(
                sigma, opts.config.density_activation)
        alpha_k = jnp.where(valid, 1.0 - jnp.exp(-sigma * samples["dt"]),
                            0.0)
        # prospective weights: alpha * current T * exclusive transmittance
        T0 = jnp.where(comp_alive, 1.0 - rgba[:, 3], 0.0)       # (n,)
        cum = jnp.concatenate(
            [jnp.ones((1, n)), jnp.cumprod(1.0 - alpha_k, axis=0)[:-1]], 0)
        w_prosp = alpha_k * T0[None] * cum
        sig = valid & (w_prosp > opts.sig_threshold)

        if opts.deferred_color:
            # no color in the march: weights composite against black and
            # the deferred pass adds each ray's color at the end
            rgb_s = jnp.zeros((K, n, 3))
        else:
            total = K * n
            perm, n_sig = stable_partition_ids(sig.reshape(-1))

            SUB = min(opts.color_subchunk, total)
            n_sub = (n_sig + SUB - 1) // SUB
            pos_flat = pos01.reshape(-1, 3)
            dir_flat = dir01_k.reshape(-1, 3)
            rgb_flat = jnp.zeros((total, 3))

            use_feat = opts.feat_color and "feat" in scene

            if use_feat and cfg.max_cascade > 0:
                posraw_flat = pos.reshape(-1, 3)
                mip_flat = mip_k.reshape(-1)

            def sub_body(i, rgb_flat):
                sel = jax.lax.dynamic_slice(perm, (i * SUB,), (SUB,))
                if use_feat and cfg.max_cascade > 0:
                    feat = sample_feat_grid_mip(
                        scene["feat"], cfg.max_cascade + 1,
                        posraw_flat[sel], mip_flat[sel])
                    rgb_raw = rgb_from_features(
                        params, feat, dir_flat[sel], cfg,
                        compute_dtype=opts.cdtype,
                        extra=scene.get("extra_dims"))
                elif use_feat:
                    feat = sample_feat_grid(scene["feat"], pos_flat[sel])
                    rgb_raw = rgb_from_features(
                        params, feat, dir_flat[sel], cfg,
                        compute_dtype=opts.cdtype,
                        extra=scene.get("extra_dims"))
                else:
                    rgb_raw, _ = apply_network(
                        params, pos_flat[sel], dir_flat[sel], cfg,
                        compute_dtype=opts.cdtype,
                        extra=scene.get("extra_dims"))
                rgb_sel = apply_rgb_activation(rgb_raw, cfg.rgb_activation)
                return rgb_flat.at[sel].set(rgb_sel)

            rgb_flat = jax.lax.fori_loop(0, n_sub, sub_body, rgb_flat)
            rgb_s = rgb_flat.reshape(K, n, 3)
    else:
        rgb_raw, sigma_raw = apply_network(
            params, pos01.reshape(-1, 3), dir01_k.reshape(-1, 3), cfg,
            compute_dtype=opts.cdtype, extra=scene.get("extra_dims"))
        rgb_s = apply_rgb_activation(rgb_raw.reshape(K, n, 3),
                                     cfg.rgb_activation)
        sigma = apply_density_activation(sigma_raw.reshape(K, n),
                                         cfg.density_activation)
        alpha_k = 1.0 - jnp.exp(-sigma * samples["dt"])   # (K, n)

    if opts.vector_rounds:
        # closed-form front-to-back compositing of the round's K samples
        # (identical math to the sequential comp_step scan: w_i = alpha_i
        # * T0 * prod_{j<i}(1 - alpha_j), stop at the first sample that
        # pushes accumulated alpha past 1 - min_transmittance)
        use = comp_alive[None] & valid                         # (K, n)
        alpha_u = jnp.where(use, alpha_k, 0.0)
        T0 = 1.0 - rgba[:, 3]                                  # (n,)
        texcl = jnp.concatenate(
            [jnp.ones((1, n)), jnp.cumprod(1.0 - alpha_u, axis=0)[:-1]], 0)
        w_all = alpha_u * T0[None] * texcl                     # (K, n)
        a_cum = rgba[:, 3][None] + jnp.cumsum(w_all, axis=0)
        done_k = use & (a_cum > 1.0 - opts.min_transmittance)
        # samples after the first 'done' are never composited
        blocked = jnp.concatenate(
            [jnp.zeros((1, n), bool), jnp.cumsum(done_k, axis=0)[:-1] > 0], 0)
        w = jnp.where(blocked, 0.0, w_all)
        rgba = rgba + jnp.concatenate(
            [jnp.sum(w[..., None] * rgb_s, axis=0),
             jnp.sum(w, axis=0, keepdims=True).T], axis=-1)
        if opts.deferred_color:
            wn = wn + jnp.sum(w, axis=0)
        # depth = distance of the round's max-weight sample if it beats
        # the carried max (first occurrence, matching the sequential >)
        w_max = jnp.max(w, axis=0)
        w_arg = jnp.argmax(w, axis=0)
        t_at = jnp.take_along_axis(samples["t_sample"], w_arg[None], 0)[0]
        upd = w_max > st["max_weight"]
        max_w = jnp.where(upd, w_max, st["max_weight"])
        depth = jnp.where(upd, t_at, st["depth"])
        saturated = (done_k & ~blocked).any(axis=0)
        inv = jnp.where(saturated, 1.0 / jnp.maximum(rgba[:, 3], 1e-9), 1.0)
        rgba = rgba * inv[:, None]
        if opts.deferred_color:
            wn = wn * inv
        comp_alive = comp_alive & ~saturated
    else:
        def comp_step(carry, inp):
            rgba, wn, depth, max_w, comp_alive = carry
            s_valid, alpha, rgb, t_sample = inp
            use = comp_alive & s_valid
            T = 1.0 - rgba[:, 3]
            w = jnp.where(use, alpha * T, 0.0)
            rgba = rgba + jnp.concatenate([rgb * w[:, None], w[:, None]],
                                          axis=-1)
            if opts.deferred_color:
                wn = wn + w
            done = use & (rgba[:, 3] > 1.0 - opts.min_transmittance)
            upd = w > max_w
            max_w = jnp.where(upd, w, max_w)
            depth = jnp.where(upd & use, t_sample, depth)
            inv = jnp.where(done, 1.0 / jnp.maximum(rgba[:, 3], 1e-9), 1.0)
            rgba = rgba * inv[:, None]
            if opts.deferred_color:
                wn = wn * inv
            comp_alive = comp_alive & ~done
            return (rgba, wn, depth, max_w, comp_alive), None

        (rgba, wn, depth, max_w, comp_alive), _ = jax.lax.scan(
            comp_step,
            (rgba, wn, st["depth"], st["max_weight"], comp_alive),
            (valid, alpha_k, rgb_s, samples["t_sample"]))

    # final surface blend for terminated rays (testbed.cu:886-897)
    fin = comp_alive & terminated_early & (surf_a > 0.0)
    rem = 1.0 - rgba[:, 3:4]
    rgba = jnp.where(fin[:, None], rgba + surface_rgba * rem, rgba)
    comp_alive = comp_alive & ~terminated_early

    return {**st, "t": t_end, "rgba": rgba, "wn": wn, "depth": depth,
            "max_weight": max_w, "alive": comp_alive, "surf_a": surf_a}


def _deferred_shade(st, params, scene, opts: MarchOptions):
    """Deferred shading: one network eval per surviving ray at its
    max-weight sample (position o + d*depth), scaled by the ray's
    accumulated NeRF weight wn, added into the composited color.
    Compacted so only rays with wn > threshold pay the network.

    When the scene carries a baked feature grid (scene["feat"],
    ops/bake.py:bake_grids), the hash encode + density MLP are replaced
    by one trilinear feature lookup (8 row gathers) + the rgb MLP —
    zero hash-table traffic in the whole flash frame."""
    cfg = opts.config
    wn = st["wn"]
    n = wn.shape[0]
    perm, n_sig = stable_partition_ids(wn > 1e-4)

    CH = min(opts.shade_chunk or opts.chunk, n)
    n_chunks = (n_sig + CH - 1) // CH
    extent = scene["train_max"] - scene["train_min"]
    feat_grid = scene.get("feat")

    def body(i, rgba):
        idx = jax.lax.dynamic_slice(perm, (i * CH,), (CH,))
        o = st["o"][idx]
        d = st["d"][idx]
        t = st["depth"][idx]
        pos_raw = o + d * t[:, None]
        pos01 = jnp.clip((pos_raw - scene["train_min"]) / extent, 0.0, 1.0)
        dir01 = (d + 1.0) * 0.5
        if feat_grid is not None:
            if cfg.max_cascade > 0:
                # cascade feature pyramid: pick the shade point's mip
                # the same way the march's sampling gate does
                # (mip_from_dt at the composited depth)
                dt = occ_ops.calc_dt(t, opts.cone_angle)
                mip = occ_ops.mip_from_dt(dt, pos_raw, cfg.max_cascade)
                feat = sample_feat_grid_mip(feat_grid, cfg.max_cascade + 1,
                                            pos_raw, mip)
            else:
                feat = sample_feat_grid(feat_grid, pos01)
            rgb_raw = rgb_from_features(params, feat, dir01, cfg,
                                        compute_dtype=opts.cdtype,
                                        extra=scene.get("extra_dims"))
        else:
            rgb_raw, _ = apply_network(params, pos01, dir01, cfg,
                                       compute_dtype=opts.cdtype,
                                       extra=scene.get("extra_dims"))
        rgb = apply_rgb_activation(rgb_raw, cfg.rgb_activation)
        add = jnp.concatenate(
            [rgb * wn[idx][:, None], jnp.zeros((CH, 1))], axis=-1)
        return rgba.at[idx].add(add)

    rgba = jax.lax.fori_loop(0, n_chunks, body, st["rgba"])
    return {**st, "rgba": rgba}


def _finalize(st):
    rgba = st["rgba"]
    keep = rgba[:, 3] > 0.001   # compact_kernel_nerf's w>0.001 filter
    rgba = jnp.where(keep[:, None], rgba, 0.0)
    # depth written only when the splat alpha exceeds 0.2, else the
    # buffer keeps its cleared value 0 (shade_kernel_nerf,
    # testbed.cu:927-929; clear_frame memsets depth to 0)
    depth = jnp.where(rgba[:, 3] > 0.2, st["depth"], 0.0)
    return {"rgba": rgba, "depth": depth}


# ---------------------------------------------------------------------------
# Tile API (fixed batch, no compaction) — used by tests / small batches
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("opts",))
def march_rays(params, scene, o, d, surface_rgba, t_surface,
               opts: MarchOptions, sample_index=0):
    """March one tile of rays to completion (masked while_loop)."""
    st = _make_state(scene, o, d, surface_rgba, t_surface, opts, sample_index)
    st["round"] = jnp.int32(0)

    def cond(st):
        return jnp.any(st["alive"]) & (st["round"] < opts.max_rounds)

    def body(st):
        r = st.pop("round")
        st = _march_round(st, params, scene, opts)
        st["round"] = r + 1
        return st

    final = jax.lax.while_loop(cond, body, st)
    if opts.deferred_color and opts.use_baked_sigma:
        final = _deferred_shade(final, params, scene, opts)
    return _finalize(final)


# ---------------------------------------------------------------------------
# Frame API: single dispatch with on-device ray compaction
# ---------------------------------------------------------------------------

_MUTABLE = ("t", "rgba", "depth", "max_weight", "alive", "surf_a")
_CONST = ("o", "d", "surf", "t_surf", "t_start")


@partial(jax.jit, static_argnames=("opts",))
def march_frame(params, scene, o, d, surface_rgba, t_surface,
                opts: MarchOptions, sample_index=0):
    """March a whole frame in ONE dispatch with periodic on-device
    compaction. N must be a multiple of opts.chunk."""
    return march_frame_impl(params, scene, o, d, surface_rgba, t_surface,
                            opts, sample_index)


def march_frame_impl(params, scene, o, d, surface_rgba, t_surface,
                     opts: MarchOptions, sample_index=0,
                     chunk_raygen=None, has_surface: bool = True,
                     t_floor=None, alive_mask=None):
    """march_frame body (callable from inside a larger jit).

    chunk_raygen: optional closure (ray_idx (CH,) int32) -> (o (CH,3),
    d (CH,3)) recomputing rays from pixel ids — replaces two per-chunk
    state gathers for camera-generated rays. has_surface=False binds the
    surface payload to zeros inside each chunk instead of gathering it.
    t_floor/alive_mask: flash-init coarse-pass results (see
    MarchOptions.lowres_factor).
    """
    n = o.shape[0]
    CH = opts.chunk
    assert n % CH == 0, (n, CH)
    cone0 = opts.cone_angle == 0.0
    if cone0 and opts.config.max_cascade == 0:
        # Skip the full-N init DDA: with constant dt the per-epoch
        # advance pass performs the identical quantized stepping on the
        # compacted chunks only — the 16-iteration init walk over ALL
        # rays (dead ones included) measured ~130 ms/frame at 720p.
        opts = dataclasses.replace(opts, init_skip_iters=0)
    st = _make_state(scene, o, d, surface_rgba, t_surface, opts,
                     sample_index, t_floor=t_floor, alive_mask=alive_mask)

    # Per-chunk state traffic: every key gathered/scattered is a separate
    # gather/scatter op, and op count is expected to dominate. Keys
    # that are recomputable (o/d via chunk_raygen), constant (surface
    # payload when has_surface=False; t_start when cone==0 — it only
    # feeds calc_dt(t - t_start), constant dt), or positional (alive:
    # the partition puts alive rays first) skip the round trip.
    gather_keys = ["t", "rgba", "depth", "max_weight"]
    zero_keys = []
    if has_surface:
        gather_keys += ["surf_a", "t_surf", "surf"]
    else:
        zero_keys += ["surf_a", "t_surf"]
    if cone0:
        zero_keys += ["t_start"]
    else:
        gather_keys += ["t_start"]
    if chunk_raygen is None:
        gather_keys += ["o", "d"]
    scatter_keys = ["t", "rgba", "depth", "max_weight", "alive"] \
        + (["surf_a"] if has_surface else [])
    if opts.deferred_color:
        gather_keys += ["wn"]
        scatter_keys += ["wn"]
    else:
        zero_keys += ["wn"]

    epoch_rounds = opts.rounds_per_epoch
    max_epochs = max(1, opts.max_rounds // epoch_rounds)

    def outer_cond(carry):
        st, epoch = carry
        return jnp.any(st["alive"]) & (epoch < max_epochs)

    def outer_body(carry):
        st, epoch = carry
        # sort-free stable partition: alive ray ids first
        perm, n_alive = stable_partition_ids(st["alive"])

        n_chunks = (n_alive + CH - 1) // CH

        def chunk_body(i, st):
            idx = jax.lax.dynamic_slice(perm, (i * CH,), (CH,))
            sub = {k: st[k][idx] for k in gather_keys}
            z = jnp.zeros((CH,), jnp.float32)
            for k in zero_keys:
                sub[k] = z
            if not has_surface:
                sub["surf"] = jnp.zeros((CH, 4), jnp.float32)
            if chunk_raygen is not None:
                sub["o"], sub["d"] = chunk_raygen(idx)
            sub["alive"] = (i * CH + jnp.arange(CH, dtype=jnp.int32)
                            ) < n_alive
            # cross empty space on occupancy lookups alone, then spend
            # network rounds only on rays parked at occupied cells
            sub = _advance_pass(sub, scene, opts, opts.advance_iters)

            def round_body(_, sub):
                return _march_round(sub, params, scene, opts)

            sub = jax.lax.fori_loop(0, epoch_rounds, round_body, sub)
            for k in scatter_keys:
                st[k] = st[k].at[idx].set(sub[k])
            return st

        st = jax.lax.fori_loop(0, n_chunks, chunk_body, st)
        return st, epoch + 1

    final, _ = jax.lax.while_loop(outer_cond, outer_body,
                                  (st, jnp.int32(0)))
    if opts.deferred_color and opts.use_baked_sigma:
        final = _deferred_shade(final, params, scene, opts)
    return _finalize(final)


# ---------------------------------------------------------------------------
# Collision march (NerfTracer::collide, testbed.cu:1814-1888 +
# check_collision, testbed.cu:721-782): march each start point along a
# shared direction until the first sample with alpha > 0; record the
# distance from the origin. Points that exit the aabb report 0.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("opts",))
def collide_march(params, scene, o, d, opts: MarchOptions):
    """o: (N,3) NGP-space start points; d: (3,) unit direction.
    -> distances (N,), 0 where no collision."""
    n = o.shape[0]
    cfg = opts.config
    dv = jnp.broadcast_to(d, (n, 3))
    idir = 1.0 / dv
    train_extent = scene["train_max"] - scene["train_min"]

    def body(st):
        t, dist, alive, it = st
        pos = o + dv * t[:, None]
        inside = _contains_local(pos, scene)
        dt = occ_ops.calc_dt(t, opts.cone_angle)
        occ, mip = _occupied(scene, pos, dt, opts)
        res = (C.NERF_GRIDSIZE >> mip).astype(jnp.float32)
        adv = occ_ops.advance_to_next_voxel(t, opts.cone_angle, pos, dv,
                                            idir, res)
        pos01 = jnp.clip((pos - scene["train_min"]) / train_extent, 0.0, 1.0)
        from nerf_glasses_tpu.ops.network import density_raw
        sigma_raw = density_raw(params, pos01, cfg,
                                compute_dtype=opts.cdtype)[:, 0]
        sigma = apply_density_activation(sigma_raw, cfg.density_activation)
        alpha = 1.0 - jnp.exp(-sigma * dt)
        hit = alive & inside & occ & (alpha > 0.0)
        dist = jnp.where(hit, jnp.linalg.norm(pos - o, axis=-1), dist)
        alive = alive & inside & ~hit
        t = jnp.where(alive & ~occ, adv, jnp.where(alive, t + dt, t))
        return t, dist, alive, it + 1

    def cond(st):
        return jnp.any(st[2]) & (st[3] < C.MARCH_ITER)

    state = (jnp.zeros((n,)), jnp.zeros((n,)), jnp.ones((n,), bool),
             jnp.int32(0))
    _, dist, _, _ = jax.lax.while_loop(cond, body, state)
    return dist


# ---------------------------------------------------------------------------
# Pixel rays + full-frame rendering
# ---------------------------------------------------------------------------

def camera_rays(camera: np.ndarray, width: int, height: int):
    """Packed 3x4 camera -> (N,3) origins (+0.5 NGP shift) and unit dirs.

    NDC ray generation matching init_rays_with_payload's pixel_to_ray use
    (ngp_common.cuh:362-368): dir = cam[:,:3] @ (2u-1, 2v-1, 1); row 0 is
    the *bottom* of the image (v = +up).
    """
    cam = np.asarray(camera, np.float32)
    x = (np.arange(width, dtype=np.float32) + 0.5) / width * 2.0 - 1.0
    y = (np.arange(height, dtype=np.float32) + 0.5) / height * 2.0 - 1.0
    xx, yy = np.meshgrid(x, y)  # (H, W)
    ndc = np.stack([xx, yy, np.ones_like(xx)], axis=-1)  # (H, W, 3)
    d = ndc @ cam[:, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(cam[:, 3] + 0.5, d.shape)
    return o.reshape(-1, 3).astype(np.float32), d.reshape(-1, 3).astype(np.float32)


_FRAME_FN_CACHE = {}


def _get_frame_fn(opts: MarchOptions, width: int, height: int,
                  has_surface: bool, linear_colors: bool,
                  lens_mode: str = "perspective",
                  snap_centers: bool = False, shutter: bool = False,
                  has_dist_grid: bool = False):
    """Jitted whole-frame function: device-side ray generation + padding
    + compacting march + shade. Per frame only the 3x4 camera(s) (and the
    surface buffers, already on device from the mesh pass) move.

    Ray generation follows pixel_to_ray (ngp_common.cuh:336-399):
      - per-sample low-discrepancy sub-pixel offsets (Halton 2/3 on the
        sample index) unless snap_centers, so accumulation anti-aliases
        [deliberate deviation: the reference's perspective branch pins
        pixel centers (ngp_common.cuh:365-368, uv-based lines commented
        out); we follow upstream instant-ngp and use the offset uv];
      - lens modes: perspective (default), opencv (iterative
        undistortion), ftheta, latlong;
      - an optional trained distortion grid added to dir.xy;
      - rolling shutter: per-pixel camera lerp cam0*ray_time +
        cam1*(1-ray_time) with ray_time = rs.x + rs.y*u + rs.z*v +
        rs.w*rand (testbed.cu:398-406).
    """
    npix = width * height
    chunk = min(opts.chunk, 1 << int(np.ceil(np.log2(max(npix, 1)))))
    if chunk != opts.chunk:
        opts = dataclasses.replace(opts, chunk=chunk)
    pad = (-npix) % opts.chunk
    key = (opts, width, height, has_surface, linear_colors, lens_mode,
           snap_centers, shutter, has_dist_grid)
    fn = _FRAME_FN_CACHE.get(key)
    if fn is not None:
        return fn

    def f(params, scene, cam, cam_end, rshut, lens_params, dist_grid,
          surface_rgba, t_surface, sample_index, pix_offset):
        px = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1)
        py = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0)
        if snap_centers:
            ox = jnp.float32(0.5)
            oy = jnp.float32(0.5)
        else:
            # Halton(2,3) sub-pixel offsets, host-computed per frame
            ox = pix_offset[0]
            oy = pix_offset[1]
        u = (px + ox) / width
        v = (py + oy) / height
        uv = jnp.stack([u, v], axis=-1)

        if lens_mode == "ftheta":
            dir_cam = _f_theta_dirs(uv - 0.5, lens_params)
        elif lens_mode == "latlong":
            dir_cam = _latlong_dirs(uv)
        else:
            x = u * 2.0 - 1.0
            y = v * 2.0 - 1.0
            if lens_mode == "opencv":
                x, y = _opencv_undistort(x, y, lens_params)
            dir_cam = jnp.stack([x, y, jnp.ones((height, width))], axis=-1)
        if has_dist_grid:
            dir_cam = dir_cam.at[..., :2].add(_read_image2(dist_grid, uv))
        dir_cam = dir_cam.reshape(-1, 3)

        if shutter:
            pix = jnp.arange(npix, dtype=jnp.uint32)
            rnd = _hash_u32(pix * jnp.uint32(72239731)
                            + jnp.asarray(sample_index).astype(jnp.uint32)
                            * jnp.uint32(2654435761))
            ray_time = (rshut[0] + rshut[1] * u.reshape(-1)
                        + rshut[2] * v.reshape(-1) + rshut[3] * rnd)
            rt = ray_time[:, None, None]
            cam_px = cam[None] * rt + cam_end[None] * (1.0 - rt)  # (N,3,4)
            d = jnp.einsum("nij,nj->ni", cam_px[:, :, :3], dir_cam)
            o = cam_px[:, :, 3] + 0.5
        else:
            d = dir_cam @ cam[:, :3].T
            o = jnp.broadcast_to(cam[:, 3] + 0.5, d.shape)
        if opts.aperture_size > 0.0:
            # square -> Shirley disk of per-pixel low-discrepancy values
            pix = jnp.arange(npix, dtype=jnp.uint32)
            u = _hash_u32(pix * jnp.uint32(2654435761)
                          + jnp.uint32(sample_index)) * 2.0 - 1.0
            v = _hash_u32(pix * jnp.uint32(805459861)
                          + jnp.uint32(sample_index * 9781 + 1)) * 2.0 - 1.0
            r = jnp.where(jnp.abs(u) > jnp.abs(v), u, v)
            phi = jnp.where(
                jnp.abs(u) > jnp.abs(v), (jnp.pi / 4.0) * (v / jnp.where(
                    u == 0.0, 1.0, u)),
                (jnp.pi / 2.0) - (jnp.pi / 4.0) * (u / jnp.where(
                    v == 0.0, 1.0, v)))
            blur = opts.aperture_size * jnp.stack(
                [r * jnp.cos(phi), r * jnp.sin(phi)], -1)        # (N, 2)
            lookat = o + d * opts.focus_z
            o = o + blur[:, :1] * cam[:, 0] + blur[:, 1:2] * cam[:, 1]
            d = (lookat - o) / opts.focus_z
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        if has_surface:
            surf = surface_rgba.reshape(npix, 4)
            tsurf = t_surface.reshape(npix)
        else:
            surf = jnp.zeros((npix, 4))
            tsurf = jnp.zeros((npix,))
        if pad:
            o = jnp.concatenate([o, jnp.broadcast_to(o[-1], (pad, 3))])
            d = jnp.concatenate([d, jnp.broadcast_to(d[-1], (pad, 3))])
            surf = jnp.concatenate([surf, jnp.zeros((pad, 4))])
            tsurf = jnp.concatenate([tsurf, jnp.zeros((pad,))])

        plain_cam = (lens_mode not in ("ftheta", "latlong", "opencv")
                     and not has_dist_grid and not shutter
                     and opts.aperture_size == 0.0)
        t_floor = alive_mask = None
        if plain_cam and opts.lowres_factor > 1:
            tmin, alive_img = flash_init(scene, cam, width, height, opts)
            t_up, a_up = upsample_flash_init(tmin, alive_img, width,
                                             height, opts.lowres_factor)
            if pad:
                t_floor = jnp.concatenate([t_up, jnp.zeros((pad,))])
                alive_mask = jnp.concatenate(
                    [a_up, jnp.zeros((pad,), bool)])
            else:
                t_floor, alive_mask = t_up, a_up

        if plain_cam:
            # chunks recompute rays from pixel ids (~8 cheap vector ops)
            # instead of two per-chunk state gathers
            def chunk_raygen(idx):
                fx = (jnp.remainder(idx, width).astype(jnp.float32) + ox) \
                    / width * 2.0 - 1.0
                fy = ((idx // width).astype(jnp.float32) + oy) \
                    / height * 2.0 - 1.0
                ndc_c = jnp.stack([fx, fy, jnp.ones_like(fx)], axis=-1)
                dc = ndc_c @ cam[:, :3].T
                dc = dc / jnp.linalg.norm(dc, axis=-1, keepdims=True)
                oc = jnp.broadcast_to(cam[:, 3] + 0.5, dc.shape)
                return oc, dc
        else:
            chunk_raygen = None
        out = march_frame_impl(params, scene, o, d, surf, tsurf, opts,
                               sample_index, chunk_raygen=chunk_raygen,
                               has_surface=has_surface, t_floor=t_floor,
                               alive_mask=alive_mask)
        rgba = out["rgba"][:npix].reshape(height, width, 4)
        depth = out["depth"][:npix].reshape(height, width)
        return _shade_frame(rgba, linear_colors), depth

    fn = jax.jit(f)
    _FRAME_FN_CACHE[key] = fn
    return fn


def render_image_device(params, scene, camera, width: int, height: int,
                        opts: MarchOptions, surface_rgba=None,
                        t_surface=None, sample_index: int = 0,
                        linear_colors: bool = False,
                        lens_mode: str = "perspective", lens_params=None,
                        snap_centers: bool = False, camera_end=None,
                        rolling_shutter=None, distortion_grid=None):
    """Render a full frame entirely on device (ONE dispatch chain) ->
    (framebuffer (H,W,4) linear premultiplied, depth (H,W)) jnp arrays.

    The shade step converts accumulated radiance sRGB->linear unless
    `linear_colors` (shade_kernel_nerf, testbed.cu:907-931).

    Optional ray-gen features (see _get_frame_fn): lens_mode/lens_params,
    snap_centers (pin pixel centers, disabling per-sample AA offsets),
    camera_end + rolling_shutter (4,) for per-pixel shutter-time camera
    interpolation, distortion_grid (Hg, Wg, 2) trained distortion map.
    """
    has_surface = surface_rgba is not None
    shutter = camera_end is not None and rolling_shutter is not None
    has_dist_grid = distortion_grid is not None
    fn = _get_frame_fn(opts, width, height, has_surface, linear_colors,
                       lens_mode, snap_centers, shutter, has_dist_grid)
    if not has_surface:
        surface_rgba = jnp.zeros((1, 4))
        t_surface = jnp.zeros((1,))
    cam = jnp.asarray(camera, jnp.float32)
    cam_end = (jnp.asarray(camera_end, jnp.float32) if shutter else cam)
    rshut = jnp.asarray(rolling_shutter if shutter else np.zeros(4),
                        jnp.float32)
    lp = jnp.asarray(lens_params if lens_params is not None
                     else np.zeros(7), jnp.float32)
    dg = (jnp.asarray(distortion_grid, jnp.float32) if has_dist_grid
          else jnp.zeros((1, 1, 2)))
    si = int(sample_index) if not hasattr(sample_index, "dtype") else 0
    pix_offset = jnp.asarray([_radical_inverse(2, si + 1),
                              _radical_inverse(3, si + 1)], jnp.float32)
    return fn(params, scene, cam, cam_end, rshut, lp, dg,
              jnp.asarray(surface_rgba), jnp.asarray(t_surface),
              sample_index, pix_offset)


@partial(jax.jit, static_argnames=("linear_colors",))
def _shade_frame(rgba, linear_colors: bool):
    from nerf_glasses_tpu.ops.colors import srgb_to_linear
    if linear_colors:
        return rgba
    return jnp.concatenate(
        [srgb_to_linear(rgba[..., :3]), rgba[..., 3:]], axis=-1)


def render_image(params, scene, camera, width: int, height: int,
                 opts: MarchOptions, surface_rgba=None, t_surface=None,
                 sample_index: int = 0, linear_colors: bool = False,
                 tile_size: int = 0):
    """Host-facing wrapper: render_image_device + one fetch."""
    rgba, depth = render_image_device(
        params, scene, camera, width, height, opts, surface_rgba, t_surface,
        sample_index, linear_colors)
    return (np.asarray(rgba, np.float32), np.asarray(depth, np.float32))
