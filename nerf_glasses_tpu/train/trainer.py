"""Hash-grid NeRF training (Instant-NGP semantics).

The reference delegates training to upstream instant-ngp
(volume/train.py:17-33 drives pyngp's Testbed.frame(); the local C++ tree
keeps only hooks — SURVEY.md §2.9/§3.5). This module provides the full
loop natively:

- ray batches sampled uniformly over (image, pixel)
- occupancy-gated ray marching with per-ray stratified jitter (fixed
  max-samples-per-ray, masked — the static-shape analogue of upstream's compacted
  sample buffers)
- fused forward: hash grid -> density MLP -> SH -> rgb MLP (bf16 matmuls)
- front-to-back compositing; random background color compositing against
  premultiplied-alpha targets (upstream trains with random bg to supervise
  transparency)
- L2/Huber loss, Adam (lr 1e-3, betas 0.9/0.99, eps 1e-15, l2_reg 1e-6 on
  MLP weights — the reference's optimizer config, testbed.cu:72-79)
- every 16 steps: density-grid EMA update (decay 0.95) at sampled cells +
  occupancy bitfield rebuild (upstream's update_density_grid_nerf)

All state lives in a TrainState pytree; one jitted train_step. Multi-chip
data parallelism lives in parallel/sharding.py (shard rays, psum grads).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nerf_glasses_tpu import constants as C
from nerf_glasses_tpu.config import NGPConfig
from nerf_glasses_tpu.io.dataset import NerfDataset
from nerf_glasses_tpu.ops import occupancy as occ_ops
from nerf_glasses_tpu.ops.network import (apply_density_activation,
                                          apply_network,
                                          apply_rgb_activation,
                                          density_raw, init_params)


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    config: NGPConfig
    # 2048 rays x 48 max samples: the step cost is linear in
    # rays*samples (expected to be dominated by the hash-table gradient
    # scatter). 48 stratified samples still cover a converged ray's
    # occupied span at ~1.9x the render step size; on the bench capture
    # 48 samples reached the train.py loss contract in about as many
    # steps as 64 (544 vs 528) at a ~0.2 dB lower holdout PSNR.
    rays_per_batch: int = 1 << 11
    samples_per_ray: int = 48
    # occupancy-DDA hops in the (non-differentiable) pass that measures
    # each training ray's occupied length before stratified sampling
    march_hops: int = 128
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-15
    l2_reg: float = 1e-6
    # ExponentialDecay wrapper parity (tcnn optimizers/exponential_decay.h;
    # upstream snapshots often wrap Adam in it): lr *= decay every
    # `lr_decay_interval` steps after `lr_decay_start`.
    lr_decay: float = 1.0
    lr_decay_start: int = 0
    lr_decay_interval: int = 1000
    loss_type: str = "l2"            # "l2" | "huber" | "relative_l2"
    huber_delta: float = 0.1
    random_bg: bool = True
    density_grid_decay: float = 0.95
    grid_update_interval: int = 16
    grid_samples_per_update: int = 1 << 18
    cone_angle: float = 0.0
    compute_dtype: str = "bfloat16"
    # hash-encode trilinear-sum dtype for TRAINING network evals. The
    # f32 weighted sum over the gathered (N, 8, W) rows is a large share
    # of density_fwd; tcnn's hash tables are natively fp16, so bf16
    # interpolation is the reference's own precision class (holdout
    # PSNR was unchanged by it on the bench capture). Render paths keep
    # f32 (their encode cost is already off the flash frame entirely).
    encode_dtype: str = "bfloat16"
    # iterative OpenCV undistortion of training rays (set automatically
    # when the dataset carries k1/k2/p1/p2; upstream's
    # iterative_opencv_lens_undistortion, stubbed in the reference at
    # ngp_common.cuh:369-372)
    apply_lens_distortion: bool = False
    # --- trainable auxiliary models (instant-ngp parity) ---
    # per-image camera extrinsics refinement: axis-angle rotation +
    # translation offsets, their own Adam (upstream's per-image
    # AdamOptimizer/RotationAdamOptimizer, testbed.cu:1027-1118 /
    # adam_optimizer.h)
    optimize_extrinsics: bool = False
    extrinsics_lr: float = 1e-4
    # soft anchor pulling per-image offsets toward zero; removes the
    # gauge freedom where scene + all cameras drift together (without it
    # a single bad pose is absorbed into collective drift instead of
    # being corrected)
    extrinsics_l2_reg: float = 1e-3
    # trainable 2-channel lens-distortion raster added to camera-plane
    # ray coords (upstream's 32x32 TrainableBuffer distortion map,
    # testbed.cu:1137-1304 / trainable_buffer.cuh)
    optimize_distortion: bool = False
    distortion_resolution: int = 32
    distortion_lr: float = 1e-4
    # trainable lat-long environment map used as the training
    # background instead of random colors (upstream's envmap
    # TrainableBuffer, 4ch; rgb here)
    train_envmap: bool = False
    envmap_resolution: tuple = (32, 64)      # (height, width)
    envmap_lr: float = 1e-2
    # learning rate for the per-image latent codes (active whenever
    # config.n_extra_learnable_dims > 0)
    extra_dims_lr: float = 1e-3
    # error-map importance sampling (upstream's per-image error raster +
    # CDF ray sampling, testbed.cuh:363-372 / SURVEY.md §3.5): rays are
    # drawn proportional to a per-image error raster after a uniform
    # warmup. The raster is EMA-updated from per-ray loss each step
    # (upstream rebuilds a CDF per epoch; the EMA is the streaming,
    # static-shape equivalent).
    sample_error_map: bool = True
    error_map_resolution: int = 32
    error_map_warmup: int = 256
    error_map_beta: float = 0.1        # cell EMA rate
    error_map_floor: float = 0.2       # uniform mix-in (x mean weight)
    # per-image exposure optimization (upstream's optimize_exposure aux
    # optimizer, alongside the camera offsets): pred_rgb scales by
    # exp(exposure[img]) before the background composite; exposures are
    # re-centered to zero mean after each update (upstream normalizes
    # the mean exposure away the same way).
    optimize_exposure: bool = False
    exposure_lr: float = 1e-3
    # depth supervision (the reference dataset pipeline carries per-pixel
    # depth, nerf_loader.cu:756-856 / python_api.cu:51-69; upstream adds
    # depth_supervision_lambda * loss(ray_depth, target_depth) for pixels
    # with valid depth). -1 = auto: 1.0 when the dataset carries depth
    # images, else off. Depth targets are in NGP units.
    depth_supervision_lambda: float = -1.0
    # Transmittance-prefix sample compaction: run the full network (and
    # its hash-table gradient scatter, the dominant step cost) only on
    # samples whose exclusive transmittance exceeds compact_T_eps.
    # Transmittance is estimated by a density-only stop-grad forward
    # pass of the LIVE network (compact_sample_sel; a cheaper
    # density-grid estimate silently dropped true pre-opaque samples
    # and collapsed holdout by 14 dB — see compact_sample_sel's
    # docstring). Since T is monotone along the ray the
    # kept set is a per-ray PREFIX: empty-space samples in front keep
    # their carving gradients; only the ~zero-weight suffix behind the
    # surface drops (the same early-out the render composite applies at
    # rgba.w > 1 - min_transmittance, testbed.cu:880; upstream's
    # training loss kernel breaks at the same threshold). The compacted
    # batch is a static bucket of compact_keep_fraction * S * B sample
    # slots (rounded up to 2048); an overflowing step drops its deepest
    # samples. 0 = off. The Trainer disables compaction during occupancy
    # warmup (dense grid -> everything kept -> certain overflow).
    # Default ON at 1/3: r5 on-chip A/B (tools/ab_compaction.py) —
    # settled 7.62 vs 6.63 steps/s dense (+15%), holdout 38.80 vs
    # 38.89 dB (-0.09), contract wall 81.3 vs 93.8 s, gate open by
    # step 768 on the capture scene.
    compact_keep_fraction: float = 1.0 / 3.0
    compact_T_eps: float = 1e-5
    # Adaptive compaction gate: compaction additionally stays off until
    # the occupancy grid's occupied fraction falls below this value.
    # Rationale (tools/ab_compaction.py, measured): enabling compaction
    # right after occ warmup on a still-foggy grid (≈90% occupied at
    # the loss-contract stop) overflows the static bucket every step and
    # drops the DEEP samples — exactly the ones whose gradients carve
    # the fog — so training plateaus at fog (holdout 20.1 dB vs 38.8
    # dense). Once the grid has carved (the capture scene converges to
    # ~6% occupied), the transmittance-prefix keep set fits the bucket
    # and compaction is loss-neutral at the measured +15% step rate
    # (the live-network T estimate pays the full-batch hash gather, so
    # the lever caps well below the 2.4x the unsafe grid estimate got).
    compact_occ_frac_gate: float = 0.2

    @property
    def cdtype(self):
        return jnp.bfloat16 if self.compute_dtype == "bfloat16" else jnp.float32

    @property
    def edtype(self):
        return jnp.bfloat16 if self.encode_dtype == "bfloat16" else jnp.float32


def adam_init(params):
    zeros = jax.tree.map(jnp.zeros_like, params)
    return {"m": zeros, "v": jax.tree.map(jnp.zeros_like, params)}


def make_train_state(key, opts: TrainOptions, aabb_min, aabb_max,
                     n_images: int = 0):
    params = init_params(key, opts.config)
    n_casc = opts.config.max_cascade + 1
    grid = jnp.zeros((n_casc,) + (C.NERF_GRIDSIZE,) * 3, jnp.float32)
    aux = {}
    if opts.optimize_extrinsics:
        assert n_images > 0, "optimize_extrinsics needs the image count"
        aux["cam_rot"] = jnp.zeros((n_images, 3))
        aux["cam_trans"] = jnp.zeros((n_images, 3))
    if opts.optimize_distortion:
        R = opts.distortion_resolution
        aux["distortion"] = jnp.zeros((R, R, 2))
    if opts.train_envmap:
        he, we = opts.envmap_resolution
        aux["envmap"] = jnp.full((he, we, 3), 0.5)
    if opts.config.n_extra_learnable_dims:
        assert n_images > 0, "latent codes need the image count"
        aux["extra_dims"] = jnp.zeros(
            (n_images, opts.config.n_extra_learnable_dims))
    if opts.optimize_exposure:
        assert n_images > 0, "optimize_exposure needs the image count"
        aux["exposure"] = jnp.zeros((n_images, 3))
    extras = {}
    if opts.sample_error_map and n_images > 0:
        R = opts.error_map_resolution
        extras["error_map"] = jnp.ones((n_images, R, R))
    return {
        **extras,
        "aux": aux,
        "aux_opt": adam_init(aux),
        "params": params,
        "opt": adam_init(params),
        "step": jnp.int32(0),
        "density_grid": grid,
        "occ": jnp.ones((C.NERF_CASCADES,) + (C.NERF_GRIDSIZE,) * 3,
                        jnp.uint8),
        "rng": jax.random.PRNGKey(42),
        "aabb_min": jnp.asarray(aabb_min, jnp.float32),
        "aabb_max": jnp.asarray(aabb_max, jnp.float32),
        "loss_ema": jnp.float32(0.0),
    }


def prepare_dataset_arrays(ds: NerfDataset) -> Dict[str, jnp.ndarray]:
    """Stack dataset images/cameras into device arrays.

    LDR color space: the dataset carries linear premultiplied rgba (the
    pyngp set_image contract), but for LDR content the network is
    supervised in sRGB space — upstream converts to sRGB at image-set
    time (python_api.cu set_image -> linear_to_srgb) and both its
    compositing and its renderer's shade step treat the MLP's rgb output
    as sRGB (shade_kernel_nerf, testbed.cu:907-931). Training in linear
    while rendering assumes sRGB double-darkens every midtone (measured
    21.8 dB holdout on the capture bench before this conversion). HDR
    datasets stay linear.
    """
    assert ds.images is not None and len(ds.images) == ds.n_images
    images = np.stack(ds.images)  # (N, H, W, 4) linear premultiplied
    if not getattr(ds, "is_hdr", False):
        from nerf_glasses_tpu.ops.colors import linear_to_srgb
        a = images[..., 3:4]
        rgb = np.divide(images[..., :3], a, out=np.zeros_like(images[..., :3]),
                        where=a > 1e-8)
        rgb = np.asarray(linear_to_srgb(np.clip(rgb, 0.0, 1.0)), np.float32)
        images = np.concatenate([rgb * a, a], axis=-1)
    h, w = images.shape[1:3]
    out = {}
    depths = getattr(ds, "depth_images", None)
    if depths is not None and any(d is not None for d in depths):
        # (N, H, W) NGP-unit depth, 0 = no supervision at that pixel
        out["depths"] = jnp.asarray(np.stack(
            [np.zeros((h, w), np.float32) if d is None
             else np.asarray(d, np.float32) for d in depths]))
    fx = np.array([m.focal_length[0] for m in ds.metadata], np.float32)
    fy = np.array([m.focal_length[1] for m in ds.metadata], np.float32)
    cx = np.array([m.principal_point[0] for m in ds.metadata], np.float32) * w
    cy = np.array([m.principal_point[1] for m in ds.metadata], np.float32) * h
    dist = np.array([m.lens_params[:4] if m.lens_mode == "opencv"
                     else (0.0, 0.0, 0.0, 0.0) for m in ds.metadata],
                    np.float32)
    return {
        **out,
        "images": jnp.asarray(images),
        "xforms": jnp.asarray(ds.xforms),      # (N, 3, 4) NGP space
        "fx": jnp.asarray(fx), "fy": jnp.asarray(fy),
        "cx": jnp.asarray(cx), "cy": jnp.asarray(cy),
        "dist": jnp.asarray(dist),             # (N, 4) k1 k2 p1 p2
    }


def dataset_has_distortion(ds: NerfDataset) -> bool:
    return any(m.lens_mode == "opencv" and any(m.lens_params[:4])
               for m in ds.metadata)


# ---------------------------------------------------------------------------
# Ray sampling + marching (differentiable forward)
# ---------------------------------------------------------------------------

def _sample_pixels(rng, data, n_rays, error_map=None, step=None,
                   opts: "TrainOptions" = None):
    """-> (img (B,), px (B,), py (B,), target rgba (B,4)).

    With an error map, pixels are drawn by inverse CDF over the flat
    (image, cell) error raster (+ a uniform floor) once `step` passes
    the warmup; before that, and always without a map, sampling is
    uniform over (image, pixel)."""
    images = data["images"]
    n_img, h, w = images.shape[:3]
    k1, k2, k3, k4 = jax.random.split(rng, 4)
    img = jax.random.randint(k1, (n_rays,), 0, n_img)
    px = jax.random.randint(k2, (n_rays,), 0, w)
    py = jax.random.randint(k3, (n_rays,), 0, h)
    if error_map is not None:
        N, Rh, Rw = error_map.shape
        wts = error_map.reshape(-1)
        wts = wts + opts.error_map_floor * (jnp.mean(wts) + 1e-12)
        cdf = jnp.cumsum(wts)
        r = jax.random.uniform(k4, (n_rays,)) * cdf[-1]
        idx = jnp.clip(jnp.searchsorted(cdf, r, side="right"),
                       0, N * Rh * Rw - 1)
        img_e = idx // (Rh * Rw)
        rest = idx % (Rh * Rw)
        cy, cx = rest // Rw, rest % Rw
        # uniform sub-cell pixel (reuse k2/k3-free bits via k4 splits)
        ku, kv = jax.random.split(k4)
        ux = jax.random.uniform(ku, (n_rays,))
        uy = jax.random.uniform(kv, (n_rays,))
        px_e = jnp.minimum(((cx + ux) * (w / Rw)).astype(jnp.int32), w - 1)
        py_e = jnp.minimum(((cy + uy) * (h / Rh)).astype(jnp.int32), h - 1)
        use_em = step >= opts.error_map_warmup
        img = jnp.where(use_em, img_e, img)
        px = jnp.where(use_em, px_e, px)
        py = jnp.where(use_em, py_e, py)
    return img, px, py, images[img, py, px]


def _error_map_accum(error_map, img, px, py, per_ray_err, w, h):
    """Per-batch (sum, count) rasters of per-ray error at the map's
    resolution — psum these across chips before _error_map_apply so
    replicated state stays consistent."""
    N, Rh, Rw = error_map.shape
    cx = jnp.clip((px * Rw) // w, 0, Rw - 1)
    cy = jnp.clip((py * Rh) // h, 0, Rh - 1)
    zeros = jnp.zeros_like(error_map)
    sum_g = zeros.at[img, cy, cx].add(per_ray_err)
    cnt_g = zeros.at[img, cy, cx].add(1.0)
    return sum_g, cnt_g


def _error_map_apply(error_map, sum_g, cnt_g, beta):
    mean = sum_g / jnp.maximum(cnt_g, 1.0)
    touched = cnt_g > 0
    return jnp.where(touched, (1.0 - beta) * error_map + beta * mean,
                     error_map)


def _rotate_small(rv, v):
    """Rodrigues rotation of v (B,3) by axis-angle rv (B,3), written
    with sinc-style factors so gradients are finite at rv=0 (where the
    per-image offsets start — RotationAdamOptimizer's variable,
    adam_optimizer.h:96-159)."""
    t2 = jnp.sum(rv * rv, axis=-1, keepdims=True)
    small = t2 < 1e-8
    # clamp the large-angle branch's inputs so its (unused) gradient at
    # rv=0 stays finite — where() still differentiates both branches
    t2c = jnp.maximum(t2, 1e-8)
    theta = jnp.sqrt(t2c)
    sinc = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(theta) / theta)
    cosf = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(theta)) / t2c)
    return (v + sinc * jnp.cross(rv, v)
            + cosf * jnp.cross(rv, jnp.cross(rv, v)))


def _bilinear2d(grid, u, v):
    """Sample a (H, W, Cc) raster at continuous uv in [0,1] -> (B, Cc)."""
    H, W = grid.shape[:2]
    x = jnp.clip(u * W - 0.5, 0.0, W - 1.0)
    y = jnp.clip(v * H - 0.5, 0.0, H - 1.0)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    return ((grid[y0, x0] * (1 - fx) + grid[y0, x1] * fx) * (1 - fy)
            + (grid[y1, x0] * (1 - fx) + grid[y1, x1] * fx) * fy)


def _sample_envmap_dir(env, d):
    """Trainable lat-long envmap (H,W,3) sampled at ray dirs (B,3)
    (convention of utils/lens.dir_to_latlong)."""
    theta = jnp.arcsin(jnp.clip(d[:, 1], -1.0, 1.0))
    phi = jnp.arctan2(d[:, 0], d[:, 2])
    u = phi / (2 * jnp.pi) + 0.5
    v = theta / jnp.pi + 0.5
    return _bilinear2d(env, u, v)


def _gen_rays(data, img, px, py, aux, apply_lens_distortion: bool):
    """Pixel indices -> world rays. Differentiable w.r.t. the trainable
    aux models (per-image extrinsics offsets, distortion raster)."""
    n_rays = img.shape[0]
    h, w = data["images"].shape[1:3]
    fx = data["fx"][img]
    fy = data["fy"][img]
    xd = (px + 0.5 - data["cx"][img]) / fx
    yd = (py + 0.5 - data["cy"][img]) / fy
    if apply_lens_distortion:
        kk = data["dist"][img]
        xu, yu = xd, yd
        for _ in range(10):  # iterative OpenCV inversion
            r2 = xu * xu + yu * yu
            radial = 1.0 + r2 * (kk[:, 0] + kk[:, 1] * r2)
            dx = (2 * kk[:, 2] * xu * yu
                  + kk[:, 3] * (r2 + 2 * xu * xu))
            dy = (kk[:, 2] * (r2 + 2 * yu * yu)
                  + 2 * kk[:, 3] * xu * yu)
            xu = (xd - dx) / radial
            yu = (yd - dy) / radial
        xd, yd = xu, yu
    if "distortion" in aux:
        duv = _bilinear2d(aux["distortion"], (px + 0.5) / w, (py + 0.5) / h)
        xd = xd + duv[:, 0]
        yd = yd + duv[:, 1]
    dirs = jnp.stack([xd, yd, jnp.ones((n_rays,))], axis=-1)
    xf = data["xforms"][img]                  # (B, 3, 4)
    d = jnp.einsum("bij,bj->bi", xf[:, :, :3], dirs)
    o = xf[:, :, 3]
    if "cam_rot" in aux:
        d = _rotate_small(aux["cam_rot"][img], d)
        o = o + aux["cam_trans"][img]
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _sample_rays(rng, data, n_rays, apply_lens_distortion: bool = False):
    """-> (o (B,3), d unit (B,3), target rgba (B,4)). Convenience
    wrapper without trainable aux models."""
    img, px, py, target = _sample_pixels(rng, data, n_rays)
    o, d = _gen_rays(data, img, px, py, {}, apply_lens_distortion)
    return o, d, target


def march_training_samples(occ, o, d, rng, opts: TrainOptions,
                           aabb_min, aabb_max, max_cascade: int):
    """Occupancy-compacted stratified training samples (non-differentiable
    geometry pass). -> dict(pos (S,B,3), dt (S,B), valid (S,B)).

    Static-shape equivalent of the reference's variable-count training
    march (instant-ngp's generate_training_samples_nerf two-pass
    count-then-emit scheme): pass 1 is an occupancy-only DDA that
    measures each ray's total occupied length; pass 2 places
    `samples_per_ray` stratified samples by inverse CDF over the
    occupied segments. The sample budget therefore always covers the
    ray's FULL occupied depth — a consecutive fixed-dt march would span
    only S*STEPSIZE (~0.16 units), never reach geometry past the AABB
    entry while the occupancy grid is dense, and converge to "fog at
    the cube entry" (each camera explaining its pixels with density no
    other camera ever samples). Sampling resolution sharpens
    automatically as the occupancy grid culls empty space.
    """
    from nerf_glasses_tpu.utils.bbox import ray_intersect_aabb

    B = o.shape[0]
    S = opts.samples_per_ray
    H = opts.march_hops
    idir = 1.0 / d
    tmin, tmax = ray_intersect_aabb(o, d, aabb_min, aabb_max)
    t0 = jnp.maximum(tmin, 0.0) + 1e-6
    span = jnp.maximum(tmax - t0, 0.0)
    # Hop granularity: fine enough to resolve mip-0 voxels once the
    # grid has converged, coarse enough that H hops always cross the
    # whole AABB even when it is fully occupied (warmup).
    stride = jnp.maximum(span / H, 1.0 / C.NERF_GRIDSIZE)

    def hop(t, _):
        alive = t < tmax
        pos = o + d * t[:, None]
        dt = occ_ops.calc_dt(t, opts.cone_angle)
        mip = occ_ops.mip_from_dt(dt, pos, max_cascade)
        occp = occ_ops.occupied_at(occ, pos, mip) & alive
        res = (C.NERF_GRIDSIZE >> mip).astype(jnp.float32)
        t_skip = occ_ops.advance_to_next_voxel(t, opts.cone_angle, pos, d,
                                               idir, res)
        seg = jnp.where(occp, jnp.minimum(stride, tmax - t), 0.0)
        t_next = jnp.where(occp, t + seg, jnp.maximum(t_skip, t + 1e-6))
        return jnp.where(alive, t_next, t), (t, seg)

    _, (t_start, seg) = jax.lax.scan(hop, t0, None, length=H)   # (H, B)
    cum = jnp.cumsum(seg, axis=0)               # inclusive segment ends
    locc = cum[-1]                              # occupied length per ray
    dt_eff = jnp.where(locc > 0, locc / S, 1.0)

    u = jax.random.uniform(rng, (S, B))
    s = (jnp.arange(S)[:, None] + u) * dt_eff   # (S, B) arclengths
    h_idx = jax.vmap(lambda c, q: jnp.searchsorted(c, q, side="right"),
                     in_axes=1, out_axes=1)(cum, s)
    h_idx = jnp.minimum(h_idx, H - 1)
    cum_ex = cum - seg                          # exclusive segment starts
    t_s = (jnp.take_along_axis(t_start, h_idx, axis=0)
           + (s - jnp.take_along_axis(cum_ex, h_idx, axis=0)))
    valid = s < locc[None, :]
    dt_out = jnp.broadcast_to(dt_eff[None], (S, B))
    # t (not positions) so forward_rays can recompute pos from rays that
    # are differentiable w.r.t. the trainable camera offsets
    return {"t": t_s, "dt": jnp.where(valid, dt_out, 0.0), "valid": valid}


def compact_bucket(n_samples: int, fraction: float) -> int:
    """Static compacted-batch size: fraction of the dense sample count,
    rounded up to 2048 (few distinct compiled shapes), capped at dense."""
    b = int(np.ceil(n_samples * fraction / 2048.0)) * 2048
    return min(max(b, 2048), n_samples)


def compact_sample_sel(state, data, img, px, py, samples,
                       opts: TrainOptions):
    """Transmittance-prefix keep mask + compaction ids (non-diff).

    -> (sel (BUCKET,) int32 flat sample ids, keep (S, B) bool). See
    TrainOptions.compact_keep_fraction. Alpha for the transmittance
    estimate comes from a density-only forward pass of the LIVE network
    (stop-grad hash encode + density MLP — no SH, no color MLP), so the
    keep prefix is exactly the set of samples the dense composite would
    weight above compact_T_eps; dropping the rest changes the pixel by
    < T_eps. This mirrors upstream, which culls training samples with
    the true composited transmittance during the train-time march.

    An earlier design estimated T from the cached density grid instead.
    The grid stores the EMA'd cell MAX, which overestimates opacity
    along most rays: measured on the settled capture scene
    (tools/probe_compact_keep.py), the grid prefix silently cut ~500
    true pre-opaque samples per batch across ~5% of rays — each such
    ray trains against a composite missing its real surface — and the
    poison compounds to a 14 dB holdout collapse
    (tools/ab_compaction.py r5: 24.97 dB vs 38.89 dense)."""
    from nerf_glasses_tpu.ops.compaction import stable_partition_ids
    from nerf_glasses_tpu.ops.network import density_raw

    S, B = samples["dt"].shape
    o0, d0 = _gen_rays(data, img, px, py,
                       jax.lax.stop_gradient(state["aux"]),
                       opts.apply_lens_distortion)
    pos = o0[None] + d0[None] * samples["t"][..., None]      # (S, B, 3)
    extent = state["aabb_max"] - state["aabb_min"]
    pos01 = (pos - state["aabb_min"]) / extent
    pos01 = jnp.where(samples["valid"][..., None], pos01, 0.5)
    raw = density_raw(jax.lax.stop_gradient(state["params"]),
                      pos01.reshape(-1, 3), opts.config,
                      compute_dtype=opts.cdtype,
                      encode_dtype=opts.edtype)[:, 0]
    sigma = apply_density_activation(raw.reshape(S, B),
                                     opts.config.density_activation)
    alpha = jnp.where(samples["valid"],
                      1.0 - jnp.exp(-sigma * samples["dt"]), 0.0)
    T_ex = jnp.concatenate(
        [jnp.ones((1, B)), jnp.cumprod(1.0 - alpha, axis=0)[:-1]], axis=0)
    keep = samples["valid"] & (T_ex > opts.compact_T_eps)
    perm, _ = stable_partition_ids(keep.reshape(-1))
    bucket = compact_bucket(S * B, opts.compact_keep_fraction)
    return perm[:bucket], keep


def forward_rays(params, samples, o, d, bg, opts: TrainOptions,
                 aabb_min, aabb_max, extra=None, exposure_scale=None,
                 sel=None, keep=None):
    """Differentiable: network eval + composite -> (B, 3) rgb vs bg.
    Positions are recomputed from (o, d, t) so gradients reach the
    trainable per-image camera offsets when enabled.

    sel/keep (compact_sample_sel): evaluate the network only at the
    `sel` flat sample ids and scatter the outputs back dense; samples
    outside sel (or outside keep — sel's tail may pad with dead ids)
    composite with zero alpha."""
    cfg = opts.config
    S, B = samples["dt"].shape
    extent = aabb_max - aabb_min
    pos = o[None] + d[None] * samples["t"][..., None]
    pos01 = (pos - aabb_min) / extent
    pos01 = jnp.where(samples["valid"][..., None], pos01, 0.5)
    dir01 = (d + 1.0) * 0.5
    dir01_k = jnp.broadcast_to(dir01[None], (S,) + dir01.shape)
    if extra is not None:
        extra = jnp.broadcast_to(extra[None], (S,) + extra.shape
                                 ).reshape(S * B, -1)
    valid = samples["valid"]
    if sel is not None:
        rgb_c, sigma_c = apply_network(
            params, pos01.reshape(-1, 3)[sel], dir01_k.reshape(-1, 3)[sel],
            cfg, compute_dtype=opts.cdtype,
            extra=None if extra is None else extra[sel],
            encode_dtype=opts.edtype)
        n = S * B
        sigma_raw = jnp.zeros((n,), sigma_c.dtype).at[sel].set(sigma_c)
        rgb_raw = jnp.zeros((n, 3), rgb_c.dtype).at[sel].set(rgb_c)
        evaluated = jnp.zeros((n,), bool).at[sel].set(
            keep.reshape(-1)[sel])
        valid = valid & evaluated.reshape(S, B)
    else:
        rgb_raw, sigma_raw = apply_network(
            params, pos01.reshape(-1, 3), dir01_k.reshape(-1, 3), cfg,
            compute_dtype=opts.cdtype, extra=extra,
            encode_dtype=opts.edtype)
    rgb = apply_rgb_activation(rgb_raw.reshape(S, B, 3), cfg.rgb_activation)
    sigma = apply_density_activation(sigma_raw.reshape(S, B),
                                     cfg.density_activation)
    alpha = 1.0 - jnp.exp(-sigma * samples["dt"])
    alpha = jnp.where(valid, alpha, 0.0)

    # exclusive cumulative transmittance over samples
    one_m = 1.0 - alpha
    T = jnp.concatenate(
        [jnp.ones((1, B)), jnp.cumprod(one_m, axis=0)[:-1]], axis=0)
    w = alpha * T                                   # (S, B)
    rgb_ray = jnp.sum(w[..., None] * rgb, axis=0)   # (B, 3)
    acc = jnp.sum(w, axis=0)
    # expected ray depth (weight-averaged sample distance) for optional
    # depth supervision
    depth_ray = jnp.sum(w * samples["t"], axis=0)
    if exposure_scale is not None:
        # per-image exposure scales the scene radiance, not the
        # background composite (upstream's optimize_exposure)
        rgb_ray = rgb_ray * exposure_scale
    return rgb_ray + (1.0 - acc)[:, None] * bg, acc, depth_ray


def _loss_fn(pred, target, opts: TrainOptions):
    """Loss menu matching tcnn's losses/* (L1/L2/relative-L2/huber/mape/
    smape/log-L1) as selected by the snapshot's loss config
    (Testbed::string_to_loss_type, testbed.cu:1362-1381)."""
    diff = pred - target
    lt = opts.loss_type
    if lt == "l2":
        return jnp.mean(diff * diff)
    if lt == "l1":
        return jnp.mean(jnp.abs(diff))
    if lt == "relative_l2":
        return jnp.mean(diff * diff / (pred * pred + 1e-2))
    if lt == "mape":
        return jnp.mean(jnp.abs(diff) / (jnp.abs(target) + 1e-2))
    if lt == "smape":
        return jnp.mean(2.0 * jnp.abs(diff)
                        / (jnp.abs(target) + jnp.abs(pred) + 1e-2))
    if lt == "log_l1":
        return jnp.mean(jnp.log(1.0 + jnp.abs(diff)))
    if lt == "huber":
        a = jnp.abs(diff)
        dl = opts.huber_delta
        return jnp.mean(jnp.where(a <= dl, 0.5 * diff * diff / dl,
                                  a - 0.5 * dl))
    raise ValueError(lt)


# ---------------------------------------------------------------------------
# Adam (tcnn hyperparameters)
# ---------------------------------------------------------------------------

def _learning_rate(step, opts: TrainOptions):
    if opts.lr_decay >= 1.0:
        return opts.learning_rate
    n = jnp.maximum(step - opts.lr_decay_start, 0) // opts.lr_decay_interval
    return opts.learning_rate * opts.lr_decay ** n.astype(jnp.float32)


def adam_update(params, grads, opt, step, opts: TrainOptions):
    t = step.astype(jnp.float32) + 1.0
    b1, b2 = opts.beta1, opts.beta2
    corr = jnp.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
    lr = _learning_rate(step, opts)

    def upd(p, g, m, v, decay):
        g = g + decay * p
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        p = p - lr * corr * m / (jnp.sqrt(v) + opts.eps)
        return p, m, v

    new_p, new_m, new_v = {}, {}, {}
    for key in params:
        # l2 regularization applies to MLP weights, not the hash table
        decay = opts.l2_reg if key.endswith("mlp") else 0.0
        if isinstance(params[key], tuple):
            outs = [upd(p, g, m, v, decay) for p, g, m, v in
                    zip(params[key], grads[key], opt["m"][key], opt["v"][key])]
            new_p[key] = tuple(o[0] for o in outs)
            new_m[key] = tuple(o[1] for o in outs)
            new_v[key] = tuple(o[2] for o in outs)
        else:
            new_p[key], new_m[key], new_v[key] = upd(
                params[key], grads[key], opt["m"][key], opt["v"][key], decay)
    return new_p, {"m": new_m, "v": new_v}


# ---------------------------------------------------------------------------
# Train step + density grid maintenance
# ---------------------------------------------------------------------------

def _aux_lr(key: str, opts: TrainOptions) -> float:
    return {"cam_rot": opts.extrinsics_lr, "cam_trans": opts.extrinsics_lr,
            "distortion": opts.distortion_lr, "envmap": opts.envmap_lr,
            "extra_dims": opts.extra_dims_lr,
            "exposure": opts.exposure_lr}[key]


def _aux_adam_update(aux, grads, opt, step, opts: TrainOptions):
    """Adam for the auxiliary trainable models, each with its own lr
    (upstream keeps separate AdamOptimizer instances per model)."""
    t = step.astype(jnp.float32) + 1.0
    b1, b2 = opts.beta1, opts.beta2
    corr = jnp.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
    new_aux, new_m, new_v = {}, {}, {}
    for key in aux:
        g = grads[key]
        if key in ("cam_rot", "cam_trans"):
            g = g + opts.extrinsics_l2_reg * aux[key]
        m = b1 * opt["m"][key] + (1 - b1) * g
        v = b2 * opt["v"][key] + (1 - b2) * g * g
        new_aux[key] = aux[key] - _aux_lr(key, opts) * corr * m / (
            jnp.sqrt(v) + opts.eps)
        if key == "exposure":
            # fix the exposure/scene-brightness gauge: re-center the
            # per-image exposures to zero mean per channel
            new_aux[key] = new_aux[key] - jnp.mean(new_aux[key], axis=0,
                                                   keepdims=True)
        new_m[key], new_v[key] = m, v
    return new_aux, {"m": new_m, "v": new_v}


def _ray_batch(state, data, r1, r2, n_rays, opts: TrainOptions):
    """Sample pixels, build rays (with current aux offsets applied but
    detached) and march the non-differentiable geometry pass."""
    img, px, py, target = _sample_pixels(
        r1, data, n_rays,
        error_map=state.get("error_map"), step=state["step"], opts=opts)
    o0, d0 = _gen_rays(data, img, px, py,
                       jax.lax.stop_gradient(state["aux"]),
                       opts.apply_lens_distortion)
    samples = march_training_samples(
        state["occ"], o0, d0, r2, opts, state["aabb_min"],
        state["aabb_max"], opts.config.max_cascade)
    return img, px, py, target, samples


def _loss_and_grads(state, data, img, px, py, target, samples, bg_rand,
                    opts: TrainOptions):
    """-> ((loss, per_ray_err), (grads, aux_grads)); per_ray_err is the
    channel-mean squared residual feeding the error map."""
    sel = keep = None
    if opts.compact_keep_fraction > 0.0:
        sel, keep = compact_sample_sel(state, data, img, px, py,
                                       samples, opts)

    def loss_of(tv):
        params, aux = tv
        o, d = _gen_rays(data, img, px, py, aux, opts.apply_lens_distortion)
        bg = (_sample_envmap_dir(aux["envmap"], d)
              if opts.train_envmap else bg_rand)
        # in envmap mode the target-side composite must not carry
        # gradients, or the envmap cancels out of the residual and
        # never learns the true background
        bg_t = jax.lax.stop_gradient(bg) if opts.train_envmap else bg
        target_rgb = target[:, :3] + (1.0 - target[:, 3:4]) * bg_t
        extra = aux["extra_dims"][img] if "extra_dims" in aux else None
        exp_scale = (jnp.exp(aux["exposure"][img])
                     if "exposure" in aux else None)
        pred, _, pdepth = forward_rays(params, samples, o, d, bg, opts,
                                       state["aabb_min"], state["aabb_max"],
                                       extra=extra, exposure_scale=exp_scale,
                                       sel=sel, keep=keep)
        diff = pred - target_rgb
        per_ray_err = jax.lax.stop_gradient(jnp.mean(diff * diff, axis=-1))
        loss = _loss_fn(pred, target_rgb, opts)
        lam = opts.depth_supervision_lambda
        if lam != 0.0 and "depths" in data:
            lam = 1.0 if lam < 0.0 else lam
            # Huber on ray depth at pixels with valid (>0) depth targets
            # (upstream's depth_supervision_lambda term)
            td = data["depths"][img, py, px]
            dvalid = (td > 0.0).astype(jnp.float32)
            a = jnp.abs(pdepth - td)
            dl = opts.huber_delta
            hub = jnp.where(a <= dl, 0.5 * a * a / dl, a - 0.5 * dl)
            loss = loss + lam * (jnp.sum(hub * dvalid)
                                 / jnp.maximum(jnp.sum(dvalid), 1.0))
        return loss, per_ray_err

    return jax.value_and_grad(loss_of, has_aux=True)(
        (state["params"], state["aux"]))


def _train_step_body(state, data, opts: TrainOptions):
    """One training step (traceable; jitted as train_step, chained by
    train_chunk)."""
    rng, r1, r2, r3 = jax.random.split(state["rng"], 4)
    img, px, py, target, samples = _ray_batch(state, data, r1, r2,
                                              opts.rays_per_batch, opts)
    if opts.random_bg and not opts.train_envmap:
        bg = jax.random.uniform(r3, (opts.rays_per_batch, 3))
    else:
        bg = jnp.ones((opts.rays_per_batch, 3))
    (loss, per_ray_err), (grads, aux_grads) = _loss_and_grads(
        state, data, img, px, py, target, samples, bg, opts)
    new_params, new_opt = adam_update(state["params"], grads, state["opt"],
                                      state["step"], opts)
    new_aux, new_aux_opt = _aux_adam_update(
        state["aux"], aux_grads, state["aux_opt"], state["step"], opts)
    ema = jnp.where(state["step"] == 0, loss,
                    0.99 * state["loss_ema"] + 0.01 * loss)
    out = {**state, "params": new_params, "opt": new_opt,
           "aux": new_aux, "aux_opt": new_aux_opt,
           "step": state["step"] + 1, "rng": rng, "loss_ema": ema}
    if "error_map" in state:
        h, w = data["images"].shape[1:3]
        sum_g, cnt_g = _error_map_accum(state["error_map"], img, px, py,
                                        per_ray_err, w, h)
        out["error_map"] = _error_map_apply(state["error_map"], sum_g,
                                            cnt_g, opts.error_map_beta)
    return out, loss


@partial(jax.jit, static_argnames=("opts",), donate_argnums=(0,))
def train_step(state, data, opts: TrainOptions):
    return _train_step_body(state, data, opts)


@partial(jax.jit,
         static_argnames=("opts", "n_steps", "update_grid", "rebuild_occ"),
         donate_argnums=(0,))
def train_chunk(state, data, opts: TrainOptions, n_steps: int,
                update_grid: bool, rebuild_occ: bool):
    """n_steps training steps in ONE dispatch (+ the periodic density-
    grid update fused at the top when `update_grid`).

    A per-step host round trip would stall the device between steps
    (the reference's host-driven loop has the same sync in
    testbed.cu:1988 — here it amortizes over a whole chunk). Returns
    (state, losses (n_steps,))."""
    if update_grid:
        state = _update_density_grid_body(state, opts, rebuild_occ)

    def body(state, _):
        return _train_step_body(state, data, opts)

    state, losses = jax.lax.scan(body, state, None, length=n_steps)
    return state, losses


@partial(jax.jit, static_argnames=("opts", "rebuild_occ"),
         donate_argnums=(0,))
def update_density_grid(state, opts: TrainOptions, rebuild_occ: bool = True):
    return _update_density_grid_body(state, opts, rebuild_occ)


def _update_density_grid_body(state, opts: TrainOptions,
                              rebuild_occ: bool = True):
    """EMA decay + scatter-max of freshly queried densities at random
    cells, then rebuild the occupancy bitfield (upstream semantics:
    density_grid_decay 0.95, update every 16 steps). During warmup the
    occupancy stays all-on (`rebuild_occ=False`) while the grid
    accumulates coverage, mirroring upstream's dense updates for the
    first 256 steps."""
    cfg = opts.config
    n_casc = cfg.max_cascade + 1
    G = C.NERF_GRIDSIZE
    rng, r1a, r1b, r2 = jax.random.split(state["rng"], 4)
    M = opts.grid_samples_per_update

    casc = jax.random.randint(r1a, (M,), 0, n_casc)
    cell = jax.random.randint(r1b, (M, 3), 0, G)
    jitter = jax.random.uniform(r2, (M, 3))
    # cell -> position in the cascade's cube: cascade c spans
    # 0.5 +- 0.5 * 2^c in each axis
    half = jnp.exp2(casc.astype(jnp.float32))[:, None] * 0.5
    cell_f = (cell + jitter) / G          # [0,1) in cascade-local coords
    pos = (cell_f - 0.5) * (2.0 * half) + 0.5

    extent = state["aabb_max"] - state["aabb_min"]
    pos01 = jnp.clip((pos - state["aabb_min"]) / extent, 0.0, 1.0)
    sigma_raw = density_raw(state["params"], pos01, cfg,
                            compute_dtype=opts.cdtype,
                            encode_dtype=opts.edtype)[:, 0]
    sigma = apply_density_activation(sigma_raw, cfg.density_activation)

    grid = state["density_grid"] * opts.density_grid_decay
    flat_idx = (((casc * G + cell[:, 2]) * G + cell[:, 1]) * G + cell[:, 0])
    flat = grid.reshape(-1)
    # Grid values are OPTICAL THICKNESS (sigma * MIN_CONE_STEPSIZE), the
    # upstream convention NERF_MIN_OPTICAL_THICKNESS=0.01 thresholds
    # against (testbed.cu:110-113,158) and the scale snapshots carry.
    # Storing raw sigma here (pre-r5 bug) made build_occupancy's 0.01
    # threshold ~600x too permissive — the bitfield kept every faint fog
    # cell (slower march AND slower training) — and broke the
    # compaction transmittance estimate catastrophically (every occupied
    # cell looked opaque -> only pre-surface samples kept -> a converged
    # model DEGRADED to 14 dB when compaction engaged,
    # tools/ab_compaction.py r5 logs).
    flat = flat.at[flat_idx].max(sigma * C.MIN_CONE_STEPSIZE)
    grid = flat.reshape(grid.shape)

    occ = (occ_ops.build_occupancy(grid, cfg.max_cascade)
           if rebuild_occ else state["occ"])
    return {**state, "density_grid": grid, "occ": occ, "rng": rng}


# ---------------------------------------------------------------------------
# High-level trainer
# ---------------------------------------------------------------------------

class Trainer:
    """Stateful loop: Trainer(dataset).train_until(...) -> snapshot."""

    def __init__(self, dataset: NerfDataset, opts: TrainOptions = None,
                 seed: int = 1337):
        if opts is None:
            cfg = NGPConfig.from_snapshot_config(
                {}, dataset.aabb_scale, dataset.is_hdr)
            opts = TrainOptions(config=cfg)
        if dataset_has_distortion(dataset) and not opts.apply_lens_distortion:
            import dataclasses as _dc
            opts = _dc.replace(opts, apply_lens_distortion=True)
        self.opts = opts
        self.dataset = dataset
        self.data = prepare_dataset_arrays(dataset)
        half = 0.5 * min(1 << (C.NERF_CASCADES - 1), dataset.aabb_scale)
        self.aabb_min = np.full(3, 0.5 - half, np.float32)
        self.aabb_max = np.full(3, 0.5 + half, np.float32)
        self.state = make_train_state(jax.random.PRNGKey(seed), opts,
                                      self.aabb_min, self.aabb_max,
                                      n_images=dataset.n_images)
        self.loss = float("nan")
        # host-side mirror of state["step"] so the loop never syncs just
        # to know where it is
        self._host_step = 0
        # adaptive compaction gate state (see TrainOptions
        # .compact_occ_frac_gate); the dense variant is memoized so
        # _chunk_opts returns one of exactly two option objects (two
        # compiled variants total, and `is` checks work downstream)
        self._dense_opts = (dataclasses.replace(
            opts, compact_keep_fraction=0.0)
            if opts.compact_keep_fraction > 0.0 else opts)
        self._compact_ready = False
        self._last_compact_check = -(1 << 30)

    @property
    def step(self) -> int:
        return self._host_step

    # upstream keeps the grid dense for its first 256 training steps
    occ_warmup_steps: int = 256
    # loss-graph buffer parity (testbed.cuh:561)
    loss_history_capacity: int = 256

    # re-check the adaptive compaction gate at this step cadence (one
    # scalar device fetch per check; 256 steps ~ 16 grid updates)
    compact_check_interval: int = 256

    def _compaction_active(self, step: int) -> bool:
        """Adaptive gate: compaction turns on only once (a) occupancy
        warmup is over AND (b) the grid's occupied fraction has fallen
        under compact_occ_frac_gate (it never turns back off — the
        grid only carves further). See the field's docstring for the
        measured failure this prevents."""
        o = self.opts
        if o.compact_keep_fraction <= 0.0:
            return False
        if step < self.occ_warmup_steps:
            return False
        if self._compact_ready:
            return True
        if step - self._last_compact_check >= self.compact_check_interval:
            self._last_compact_check = step
            n_casc = o.config.max_cascade + 1
            occ = self.state["occ"][:n_casc]
            frac = float(jnp.mean((occ > 0).astype(jnp.float32)))
            if frac <= o.compact_occ_frac_gate:
                self._compact_ready = True
        return self._compact_ready

    def _chunk_opts(self, step: int) -> TrainOptions:
        """Options for the chunk starting at `step`: sample compaction
        is forced off during occupancy warmup and while the adaptive
        occupied-fraction gate is closed (_compaction_active). Two
        compiled variants total (self.opts / self._dense_opts)."""
        if (self.opts.compact_keep_fraction > 0.0
                and not self._compaction_active(step)):
            return self._dense_opts
        return self.opts

    def train(self, n_steps: int = 1, callback=None) -> float:
        """Advance n_steps. Steps are dispatched in chunks aligned to the
        density-grid cadence (train_chunk: the grid update + up to
        grid_update_interval steps fused into ONE device dispatch), and
        the losses come back in a single fetch at the end — no per-step
        host sync (a float(loss) every step would serialize the device
        on the host round trip). A per-step `callback`
        falls back to one dispatch per step."""
        if not hasattr(self, "loss_history"):
            self.loss_history = []
        interval = self.opts.grid_update_interval
        loss_chunks = []
        remaining = n_steps
        while remaining > 0:
            step = self._host_step
            update = step % interval == 0
            n = min(interval - step % interval, remaining)
            copts = self._chunk_opts(step)
            if callback is None:
                self.state, losses = train_chunk(
                    self.state, self.data, copts, n, update,
                    step >= self.occ_warmup_steps)
                loss_chunks.append(losses)
            else:
                if update:
                    self.state = update_density_grid(
                        self.state, self.opts,
                        rebuild_occ=step >= self.occ_warmup_steps)
                for i in range(n):
                    self.state, loss = train_step(self.state, self.data,
                                                  copts)
                    lf = float(loss)
                    callback(step + i + 1, lf)
                    loss_chunks.append(jnp.full((1,), lf))
            self._host_step += n
            remaining -= n
        all_losses = np.asarray(jnp.concatenate(loss_chunks), np.float32)
        self.loss = float(all_losses[-1])
        self.loss_history.extend(float(l) for l in all_losses)
        if len(self.loss_history) > self.loss_history_capacity:
            del self.loss_history[:-self.loss_history_capacity]
        return self.loss

    def train_until(self, target_loss: float = 0.00175,
                    max_steps: int = 10000, log_every: int = 100) -> float:
        """The reference train.py stop criteria (volume/train.py:11-12).
        The loss EMA is checked once per grid-update chunk, not per step
        (one host sync per chunk)."""
        interval = self.opts.grid_update_interval
        while self.step < max_steps:
            self.train(min(interval, max_steps - self.step))
            ema = float(self.state["loss_ema"])
            if log_every and (self.step % log_every < interval):
                print(f"step {self.step}: loss {self.loss:.6f} "
                      f"(ema {ema:.6f})")
            if ema < target_loss and self.step > 100:
                break
        return self.loss

    def optimized_xforms(self) -> np.ndarray:
        """Dataset camera matrices with the trained per-image extrinsics
        offsets applied (d' = R(rot_i) R_i dirs, o' = o_i + trans_i) —
        the refined cameras upstream's camera optimizer converges to."""
        xf = np.array(self.dataset.xforms, np.float32).copy()
        if "cam_rot" not in self.state["aux"]:
            return xf
        rot = np.asarray(self.state["aux"]["cam_rot"])
        trans = np.asarray(self.state["aux"]["cam_trans"])
        for i in range(len(xf)):
            theta = float(np.linalg.norm(rot[i]))
            if theta > 1e-12:
                k = rot[i] / theta
                K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                              [-k[1], k[0], 0]], np.float32)
                R = (np.eye(3, dtype=np.float32) + np.sin(theta) * K
                     + (1 - np.cos(theta)) * (K @ K))
                xf[i, :, :3] = R @ xf[i, :, :3]
            xf[i, :, 3] += trans[i]
        return xf

    def to_testbed(self):
        from nerf_glasses_tpu.models.testbed import Testbed
        tb = Testbed()
        tb.config = self.opts.config
        tb.params = jax.tree.map(lambda x: x, self.state["params"])
        tb.density_grid = np.asarray(self.state["density_grid"])
        tb.dataset = self.dataset
        from nerf_glasses_tpu.utils.bbox import BoundingBox
        tb.aabb = BoundingBox(self.aabb_min, self.aabb_max)
        tb.raw_aabb = tb.aabb.copy()
        tb.render_aabb = tb.aabb.copy()
        if not self.dataset.render_aabb.is_empty():
            tb.render_aabb = self.dataset.render_aabb.intersection(tb.aabb)
        tb.render_aabb_to_local = self.dataset.render_aabb_to_local.copy()
        tb.training_step = self.step
        tb.loss = self.loss
        if "extra_dims" in self.state["aux"]:
            # default inference latents: the first training view's codes
            # (get_inference_extra_dims' default, testbed.cu:1614-1631)
            tb.extra_dims = np.asarray(self.state["aux"]["extra_dims"][0])
        if "distortion" in self.state["aux"]:
            # trained distortion raster, applied at render when
            # render_with_lens_distortion is set (pixel_to_ray's
            # distortion_grid path, ngp_common.cuh:374-376)
            tb.distortion_map = np.asarray(self.state["aux"]["distortion"])
        tb._cone_angle = self.opts.config.cone_angle_constant
        tb.update_occupancy()
        return tb

    def save_snapshot(self, path: str):
        self.to_testbed().save_snapshot(path)

    def load_snapshot(self, path: str):
        """Resume training from an NGP-format snapshot — the reference
        flow loads a snapshot and keeps training through the same frame
        loop (pyngp Testbed.load_snapshot + frame, volume/train.py
        semantics). Restores params, the density grid (+ rebuilt
        occupancy bitfield), the step counter, and latent codes; Adam
        moments restart at zero (the snapshot format carries
        params_binary only, tcnn trainer.h:270-306).

        The snapshot's network config must equal the Trainer's — the
        compiled train graphs are shape-specialized. To resume without
        knowing the config, read it first:
            s = snap_io.load_snapshot(path)
            tr = Trainer(ds, TrainOptions(config=s.config))
            tr.load_snapshot(path)
        """
        from nerf_glasses_tpu.io import snapshot as snap_io
        from nerf_glasses_tpu.ops.network import unpack_params
        s = snap_io.load_snapshot(path)
        if s.config != self.opts.config:
            raise ValueError(
                f"snapshot config {s.config} != Trainer config "
                f"{self.opts.config}; build the Trainer with the "
                f"snapshot's config to resume")
        params = jax.tree.map(jnp.asarray,
                              unpack_params(s.params_blob, s.config))
        n_casc = self.opts.config.max_cascade + 1
        st = dict(self.state)
        st["params"] = params
        st["opt"] = adam_init(params)
        grid = jnp.asarray(np.asarray(s.density_grid, np.float32)[:n_casc])
        st["density_grid"] = grid
        st["occ"] = occ_ops.build_occupancy(grid,
                                            self.opts.config.max_cascade)
        st["step"] = jnp.int32(s.training_step)
        st["loss_ema"] = jnp.float32(s.loss or 0.0)
        if (self.opts.config.n_extra_learnable_dims
                and s.extra_dims is not None
                and "extra_dims" in st.get("aux", {})):
            aux = dict(st["aux"])
            ed = jnp.asarray(s.extra_dims, jnp.float32)
            if ed.ndim == 1:    # snapshot stores the inference code;
                ed = jnp.broadcast_to(ed, aux["extra_dims"].shape)
            if ed.shape == aux["extra_dims"].shape:
                aux["extra_dims"] = ed
                st["aux"] = aux
        self.state = st
        self._host_step = int(s.training_step)
        self.loss = float(s.loss or float("nan"))
        # adaptive compaction gate re-evaluates on the resumed grid
        self._compact_ready = False
        self._last_compact_check = -(1 << 30)
