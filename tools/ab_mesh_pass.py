"""A/B of the mesh pass's ray-cast on the GPU: the Triton kernel
(ops/mesh_pallas.py) against the plain-XLA tiled ray-cast
(ops/triangles.py `raycast_tiled_reference` with each tile's candidate
list cut to the largest tile count, rounded up to 256).

    python tools/ab_mesh_pass.py [--frames 20] [--sweep]

Times the whole mesh pass (`render_mesh_surface`: ray generation,
binning, ray-cast, shading, 2x2 reduce) at 1280x720 with 2x
supersampling (2560x1440 rays) on the procedural glasses, from the
smoke's orbit view, in the order kernel, XLA, XLA, kernel. `--sweep`
also times the kernel alone over its (rays per program, warps) choices.
Prints one line per leg and the card line.
"""

import argparse
import functools
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from nerf_glasses_tpu.ops import mesh_pallas as mp  # noqa: E402
from nerf_glasses_tpu.ops import triangles as tri_ops  # noqa: E402

W, H, F = 1280, 720, 2


def _timed(fn, n):
    jax.block_until_ready(fn())                       # compile + warm
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return 1000.0 * (time.perf_counter() - t0) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    info = chip_smoke.phase_device()
    cam = chip_smoke.orbit_camera(W * F, H * F)

    # the largest tile candidate count at this view bounds the XLA
    # variant's static list width
    mesh, xf, nm = chip_smoke.glasses_mesh()
    wp = -(-W * F // tri_ops.TILE_W) * tri_ops.TILE_W
    hp = -(-H * F // tri_ops.TILE_H) * tri_ops.TILE_H
    camj = jnp.asarray(cam)
    v0, e1, e2 = tri_ops.world_triangles(mesh, jnp.asarray(xf))
    lists, counts = tri_ops._bin_triangles(
        v0, e1, e2, camj[:, 3], jnp.linalg.inv(camj[:, :3]), W * F, H * F,
        wp, hp)
    counts = np.asarray(counts)
    width = int(-(-int(counts.max()) // 256) * 256)
    print(f"[ab] triangles={mesh.n_tris} tiles={counts.size} "
          f"tiles_with_candidates={int((counts > 0).sum())} "
          f"max_count={int(counts.max())} mean_count={counts.mean():.1f} "
          f"xla_list_width={width}", flush=True)

    variants = {
        "triton": mp.raycast_tiled,
        "xla": lambda tri, o, d, lists, counts: (
            tri_ops.raycast_tiled_reference(tri, o, d, lists[:, :width],
                                            counts)),
    }
    passes = {}
    original = tri_ops.tiled_raycast
    for name, fn in variants.items():
        m, _, _ = chip_smoke.glasses_mesh()     # own jit cache per variant
        tri_ops.tiled_raycast = fn
        passes[name] = functools.partial(
            tri_ops.render_mesh_surface, m, xf, nm, cam, W, H, F,
            [1.0, 1.0, 1.0])
        jax.block_until_ready(passes[name]())  # trace with this variant
    tri_ops.tiled_raycast = original

    c_t, d_t = (np.asarray(a) for a in passes["triton"]())
    c_x, d_x = (np.asarray(a) for a in passes["xla"]())
    print(f"[ab] agree max_dcolor={np.abs(c_t - c_x).max()} "
          f"max_ddepth={np.abs(d_t - d_x).max()}", flush=True)

    for name in ("triton", "xla", "xla", "triton"):
        ms = _timed(passes[name], args.frames)
        print(f"[ab] mesh_pass={name} ms={ms:.4f} frames={args.frames} "
              f"size={W * F}x{H * F}", flush=True)

    if args.sweep:
        o, d = tri_ops.tile_rays(camj, W * F, H * F, wp, hp)
        tri = jnp.concatenate([v0, e1, e2], axis=1)
        for sub in (256, 512, 1024):
            for warps in (2, 4, 8):
                f = jax.jit(functools.partial(mp.raycast_tiled, sub=sub,
                                              num_warps=warps))
                ms = _timed(lambda: f(tri, o, d, lists, jnp.asarray(counts)),
                            args.frames)
                print(f"[ab] kernel sub={sub} warps={warps} ms={ms:.4f}",
                      flush=True)
    print(f"card: {info['card']}", flush=True)


if __name__ == "__main__":
    main()
