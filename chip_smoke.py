"""Smoke run of the hybrid renderer and the trainer on one NVIDIA GPU.

    python chip_smoke.py

Drives the main path once through the entry points a user calls, at the
sizes the product runs, and checks what comes out. Phases, in order,
each printing its numbers on its own line; any failure raises and the
process exits non-zero:

  device  — require a GPU (never falls back to the CPU); print the card
            line from nvidia-smi, the JAX version, the compile-cache
            directory and the default matmul precision.
  kernel  — the tiled mesh ray-cast (the Triton kernel of
            ops/mesh_pallas.py) against the brute-force reference
            `_raycast_chunked` at 2560x1440 rays — the 2x-supersampled
            720p mesh pass — on the procedural glasses.
  render  — pynmr.NerfMeshRenderer(1280, 720) with the trained head
            snapshot and the procedural glasses: exact frame, then the
            bake(640, 384) + flash frame; PSNR of flash vs exact, depth
            gating of the mesh by the head, holdout PSNR of both paths,
            and the time of 24 chained frames (reported, not judged).
  train   — Trainer on the capture dataset: 64 steps from scratch (loss
            finite and falling), 32 steps resumed from the trained
            snapshot with sample compaction on, snapshot save + load.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Each phase is a function of its sizes, so tests rehearse them on the
CPU at tiny sizes.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "assets", "cache")
TRAINED = os.path.join(ROOT, "assets", "trained", "trained_head_v6.msgpack")

# the render phase's view: the bench's orbit on the trained head
ORBIT = ((0.4, -0.1, 0.0), (0.0, 0.0, 3.5))
RENDER_AABB = ((0.1, 0.1, 0.1), (0.9, 0.9, 0.9))


def log(phase: str, **numbers):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


def require(ok: bool, what: str):
    """Raise when a check fails (unlike `assert`, never compiled away)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse <= 0 else float(10.0 * np.log10(1.0 / mse))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(require_gpu: bool = True) -> dict:
    import jax
    from nerf_glasses_tpu.utils.compile_cache import configure_compile_cache
    from nerf_glasses_tpu.utils.meters import card_line
    backend = jax.default_backend()
    if require_gpu and backend != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU, but JAX's default backend is "
            f"{backend!r} ({jax.devices()}); refusing to run on it")
    cache = configure_compile_cache(os.path.join(CACHE, "jaxcache"))
    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    card = card_line() if backend == "gpu" else "not measured (no GPU)"
    log("device", card=repr(card), jax=jax.__version__,
        compile_cache=cache,
        matmul_precision=jax.config.jax_default_matmul_precision, **info)
    info["card"] = card
    return info


def glasses_path(glasses_kw=None) -> str:
    """glTF of the procedural glasses; `glasses_kw` (tessellation) makes
    a coarser one for rehearsals."""
    import bench_scene
    if not glasses_kw:
        return bench_scene.get_glasses_gltf(CACHE)
    path = os.path.join(CACHE, "smoke_glasses_small.gltf")
    return bench_scene.write_glasses_gltf(path, **glasses_kw)


def glasses_mesh(glasses_kw=None):
    """(MeshArrays, xforms, normal matrices) of the procedural glasses at
    the bench placement."""
    import bench_scene
    from nerf_glasses_tpu.io import gltf as gltf_io
    from nerf_glasses_tpu.ops import triangles as tri_ops
    scene = gltf_io.load(glasses_path(glasses_kw))
    scene.nodes[0].translation = np.asarray(bench_scene.GLASSES_T, np.float32)
    scene.nodes[0].scale = np.asarray(bench_scene.GLASSES_S, np.float32)
    mesh = tri_ops.build_mesh_arrays([scene])
    xf, nm = tri_ops.instance_transforms(mesh, [scene])
    return mesh, xf, nm


def orbit_camera(width: int, height: int) -> np.ndarray:
    from nerf_glasses_tpu.utils.camera import OrbitCamera
    cam = OrbitCamera()
    for step in ORBIT:
        cam.orbit(*step)
    return cam.packed(width / float(height))


def phase_kernel(width: int = 2560, height: int = 1440, raycast=None,
                 glasses_kw=None, min_id_agree: float = 0.9999,
                 atol: float = 1e-4) -> dict:
    """Tiled ray-cast vs brute force over every triangle, same rays."""
    import jax
    import jax.numpy as jnp
    from nerf_glasses_tpu.ops import triangles as tri_ops
    if raycast is None:
        from nerf_glasses_tpu.ops.mesh_pallas import raycast_tiled as raycast
    mesh, xf, nm = glasses_mesh(glasses_kw)
    cam = jnp.asarray(orbit_camera(width, height))
    wp = -(-width // tri_ops.TILE_W) * tri_ops.TILE_W
    hp = -(-height // tri_ops.TILE_H) * tri_ops.TILE_H
    block = tri_ops.TILE_W * tri_ops.TILE_H

    @jax.jit
    def both(cam, xforms, nrm_mats):
        o, d = tri_ops.tile_rays(cam, width, height, wp, hp)
        v0, e1, e2 = tri_ops.world_triangles(mesh, xforms)
        lists, counts = tri_ops._bin_triangles(
            v0, e1, e2, cam[:, 3], jnp.linalg.inv(cam[:, :3]), width,
            height, wp, hp)
        tri = jnp.concatenate([v0, e1, e2], axis=1)
        kt, ki, ku, kv = raycast(tri, o, d, lists, counts)

        def ref_block(args):
            ob, db = args
            t, i, uv = tri_ops._raycast_chunked(ob, db, v0, e1, e2, 256,
                                                cull_backfaces=True)
            return t, i, uv[:, 0], uv[:, 1]

        rt, ri, ru, rv = (a.reshape(-1) for a in jax.lax.map(
            ref_block, (o.reshape(-1, block, 3), d.reshape(-1, block, 3))))

        def shade(t, i, u, v):
            def blk(args):
                ob, db, tb, ib, ub, vb = args
                return tri_ops.shade_hits(mesh, ob, db, tb, ib,
                                          jnp.stack([ub, vb], -1), nrm_mats,
                                          [1.0, 1.0, 1.0], cam[:, 3])
            r = lambda a: a.reshape((-1, block) + a.shape[1:])  # noqa: E731
            return jax.lax.map(blk, (r(o), r(d), r(t), r(i), r(u), r(v)))

        same = ki == ri
        both_hit = (ki >= 0) & (ri >= 0)
        keep = same & both_hit
        dcol = jnp.abs(shade(kt, ki, ku, kv) - shade(rt, ri, ru, rv))
        dcol = jnp.where(keep.reshape(dcol.shape[:2])[..., None], dcol, 0.0)
        return {
            "rays": jnp.int32(o.shape[0]),
            "hits": jnp.sum(ki >= 0),
            "ref_hits": jnp.sum(ri >= 0),
            "id_mismatches": jnp.sum(~same),
            "max_dt": jnp.max(jnp.where(both_hit, jnp.abs(kt - rt), 0.0)),
            "max_du": jnp.max(jnp.where(keep, jnp.abs(ku - ru), 0.0)),
            "max_dv": jnp.max(jnp.where(keep, jnp.abs(kv - rv), 0.0)),
            "max_dcolor": jnp.max(dcol),
            "max_candidates": jnp.max(counts),
            "tiles": jnp.int32(counts.shape[0]),
        }

    out = {k: v.item() for k, v in jax.device_get(
        both(cam, jnp.asarray(xf), jnp.asarray(nm))).items()}
    out["triangles"] = mesh.n_tris
    out["id_agree"] = 1.0 - out["id_mismatches"] / out["rays"]
    log("kernel", size=f"{width}x{height}", **out)
    require(out["hits"] > 0, "the glasses are in view")
    require(out["id_agree"] >= min_id_agree,
            f"triangle ids agree on {out['id_agree']} >= {min_id_agree}")
    for k in ("max_dt", "max_du", "max_dv", "max_dcolor"):
        require(out[k] <= atol, f"{k} {out[k]} <= {atol}")
    return out


def _fidelity_frame(renderer):
    for nerf in renderer._nerfs:
        nerf.reset_accumulation()
    renderer.render_frame()
    return renderer.display_image()[..., :3]


def _time_frames(renderer, n_frames: int) -> float:
    """Seconds for n_frames chained frames over the orbit wobble the
    reference's render loop applies (volume/render.py), drained once."""
    def drain():
        return float(np.asarray(renderer._frame_buffer[0, 0, 3]))

    renderer.frame()
    renderer.orbit(0.01, 0.0, 0)
    drain()
    t0 = time.perf_counter()
    a = 0.0
    for _ in range(n_frames):
        a += 0.03
        renderer.orbit(-np.sin(a * 1.733) / 100, np.cos(a * 1.733) / 200, 0)
        renderer.frame()
    drain()
    return time.perf_counter() - t0


def phase_render(width: int = 1280, height: int = 720, bake_res: int = 640,
                 feat_res: int = 384, holdout_views: int = 2,
                 holdout_res: int = None, n_frames: int = 24,
                 glasses_kw=None, min_flash_db: float = 35.0,
                 min_holdout_db: float = 37.0, budget_db: float = 0.5,
                 gate_margin: float = 0.05, card: str = "") -> dict:
    import bench_scene
    import pynmr
    from nerf_glasses_tpu.models.testbed import Testbed

    glasses = glasses_path(glasses_kw)
    renderer = pynmr.NerfMeshRenderer(width, height)
    nerf = renderer.load_nerf(TRAINED)
    nerf.render_aabb.min = np.asarray(RENDER_AABB[0], np.float32)
    nerf.render_aabb.max = np.asarray(RENDER_AABB[1], np.float32)
    if renderer.load_mesh(glasses, t=bench_scene.GLASSES_T,
                          s=bench_scene.GLASSES_S) is None:
        raise RuntimeError(f"could not load {glasses}")
    for step in ORBIT:
        renderer.orbit(*step)
    w, h = renderer.render_width, renderer.render_height

    exact = _fidelity_frame(renderer)
    hybrid_fb = np.asarray(renderer._frame_buffer)
    cover = np.asarray(nerf._surface_rgba)[:, 3].reshape(h, w)
    t_surf = np.asarray(nerf._surface_t).reshape(h, w)
    # the head alone, same camera and sample: where the glasses lie
    # behind its depth, the hybrid frame must show the head
    nerf.set_surface_buffers(None, None, w, h)
    head_fb, head_depth = (np.asarray(a) for a in
                           nerf.render_frame_buffers(w, h, 0))
    covered = cover > 0
    opaque = head_fb[..., 3] > 0.99
    behind = covered & opaque & (t_surf > head_depth + 0.01)
    front = covered & opaque & (t_surf < head_depth - 0.01)
    # well behind the head's max-weight depth the head's own
    # transmittance is ~0, so the mesh must not show at all there
    deep = covered & opaque & (t_surf > head_depth + gate_margin)
    gate_err = np.abs(hybrid_fb[deep] - head_fb[deep]).max(-1)

    nerf.bake(bake_res, feat_resolution=feat_res)
    nerf.flash = True
    flash = _fidelity_frame(renderer)
    db_flash = psnr(flash, exact)

    cams, gts = bench_scene.holdout_ground_truth(
        res=holdout_res or bench_scene.W)
    tb = Testbed()
    tb.load_snapshot(TRAINED)
    tb.background_color = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
    res = gts[0].shape[0]

    def holdout_db():
        vals = []
        for cam, gt in zip(cams[:holdout_views], gts[:holdout_views]):
            tb.camera_matrix = np.asarray(cam, np.float32)
            vals.append(psnr(tb.render(res, res, spp=2, linear=False)
                             [..., :3], gt))
        return float(np.mean(vals))

    db_hold_exact = holdout_db()
    tb.adopt_bake(nerf)
    tb.flash = True
    db_hold_flash = holdout_db()

    secs = _time_frames(renderer, n_frames)
    out = {
        "size": f"{w}x{h}",
        "mesh_supersample": renderer.mesh_render_size_factor,
        "psnr_flash_vs_exact_db": round(db_flash, 3),
        "covered_px": int(covered.sum()), "behind_head_px": int(behind.sum()),
        "in_front_px": int(front.sum()), "deep_behind_px": int(deep.sum()),
        "deep_behind_mean_err": float(gate_err.mean()) if deep.any() else 0.0,
        "deep_behind_max_err": float(gate_err.max()) if deep.any() else 0.0,
        "holdout_exact_db": round(db_hold_exact, 3),
        "holdout_flash_db": round(db_hold_flash, 3),
        "frames": n_frames, "frame_ms": round(1000.0 * secs / n_frames, 3),
        "fps": round(n_frames / secs, 3), "render_path": nerf.last_render_path,
    }
    log("render", **out, card=repr(card))
    require(db_flash >= min_flash_db,
            f"flash vs exact {db_flash:.3f} dB >= {min_flash_db}")
    require(out["covered_px"] > 0, "the mesh pass covers some pixel")
    require(out["behind_head_px"] > 0, "some mesh pixel lies behind the head")
    require(out["deep_behind_mean_err"] <= 1e-2,
            "glasses behind the head stay hidden (mean error "
            f"{out['deep_behind_mean_err']})")
    require(db_hold_exact >= min_holdout_db,
            f"exact holdout {db_hold_exact:.3f} dB >= {min_holdout_db}")
    require(db_hold_flash >= db_hold_exact - budget_db,
            f"flash holdout {db_hold_flash:.3f} dB within {budget_db} dB "
            f"of exact {db_hold_exact:.3f}")
    return out


def phase_train(steps: int = 64, resume_steps: int = 32,
                capture_views: int = None, capture_res: int = None,
                options=None) -> dict:
    import bench_scene
    from nerf_glasses_tpu.config import NGPConfig
    from nerf_glasses_tpu.io import snapshot as snap_io
    from nerf_glasses_tpu.train.trainer import TrainOptions, Trainer

    ds = bench_scene.build_capture_dataset(
        n_views=capture_views or bench_scene.N_TRAIN,
        res=capture_res or bench_scene.W)
    opts = TrainOptions(config=NGPConfig.native_fast(), **(options or {}))
    tr = Trainer(ds, opts, seed=3)
    t0 = time.perf_counter()
    tr.train(steps)
    secs = time.perf_counter() - t0
    losses = np.asarray(tr.loss_history, np.float64)
    k = max(1, steps // 8)
    first, last = float(losses[:k].mean()), float(losses[-k:].mean())

    tr2 = Trainer(ds, opts, seed=3)
    tr2.load_snapshot(TRAINED)
    tr2.train(resume_steps)
    resumed = np.asarray(tr2.loss_history, np.float64)

    path = os.path.join(CACHE, "smoke_resumed.msgpack")
    os.makedirs(CACHE, exist_ok=True)
    tr2.save_snapshot(path)
    back = snap_io.load_snapshot(path)
    saved_step = back.training_step
    n_params = snap_io.load_snapshot(TRAINED).params_blob.size

    out = {"rays_per_batch": opts.rays_per_batch,
           "samples_per_ray": opts.samples_per_ray, "steps": steps,
           "loss_first": first, "loss_last": last,
           "scratch_s_incl_compile": round(secs, 3),
           "resumed_steps": resume_steps,
           "resumed_loss_last": float(resumed[-1]),
           "compaction_active": bool(tr2._compact_ready),
           "snapshot_step": saved_step}
    log("train", **out)
    require(bool(np.isfinite(losses).all()) and last < first,
            f"scratch loss finite and falling ({first} -> {last})")
    require(bool(np.isfinite(resumed).all()), "resumed loss finite")
    require(tr2._compact_ready, "compaction active when resumed")
    require(saved_step == tr2.step and back.params_blob.size == n_params
            and bool(np.isfinite(back.params_blob).all()),
            "the saved snapshot loads back with its step and params")
    return out


def main() -> int:
    info = phase_device()
    phase_kernel()
    phase_render(card=info["card"])
    phase_train()
    print(f"card: {info['card']}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
