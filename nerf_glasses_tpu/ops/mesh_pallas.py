"""Screen-tile culled mesh ray-cast (Möller-Trumbore) as a Pallas kernel
for the GPU, lowered through Triton.

Rays arrive grouped into screen tiles of BLOCK rays; each tile carries a
front-packed list of candidate triangle ids (bbox binning,
ops/triangles.py `_bin_triangles`) and its candidate count — the
analogue of the reference's OptiX acceleration-structure traversal
(optix_scene.cu). One program handles SUB rays of one tile: it reads its
tile's count, then loops over the candidates, loading each triangle's
nine world-space scalars [v0 | e1 | e2] by index from the table in
global memory (a few thousand triangles stay in L1/L2) and keeping a
running closest hit (t, id, u, v) in registers. The trip count is the
tile's own, so tiles without candidates cost one load.

The plain-XLA formulation (ops/triangles.py `_raycast_chunked`) has to
materialise (rays, triangles, 3) cross-product temporaries; here no
per-pair value leaves registers.

Back-face culling matches OPTIX_RAY_FLAG_CULL_BACK_FACING_TRIANGLES
(optix_scene.cu:144); ties on shared edges go to the lowest triangle id,
as in `_raycast_chunked`. Shading stays in XLA (ops/triangles.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

BLOCK = 8192          # rays per screen tile (ops/triangles.py TILE_W*TILE_H)
SUB = 512             # rays per program
NUM_WARPS = 4
_BIG = np.float32(1e16)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _kernel(count_ref, tri_ref, list_ref, ox_ref, oy_ref, oz_ref,
            dx_ref, dy_ref, dz_ref, t_ref, idx_ref, u_ref, v_ref):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]

    def body(j, carry):
        best_t, best_i, best_u, best_v = carry
        tri_id = list_ref[0, j]
        base = tri_id * 9
        v0x = tri_ref[base + 0]
        v0y = tri_ref[base + 1]
        v0z = tri_ref[base + 2]
        e1x = tri_ref[base + 3]
        e1y = tri_ref[base + 4]
        e1z = tri_ref[base + 5]
        e2x = tri_ref[base + 6]
        e2y = tri_ref[base + 7]
        e2z = tri_ref[base + 8]

        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        valid = det > 1e-9
        inv = 1.0 / jnp.where(valid, det, 1.0)
        tx = ox - v0x
        ty = oy - v0y
        tz = oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        # padded acceptance: rays on shared edges cannot fall through
        # the crack (same rule as _raycast_chunked)
        eps = 1e-5
        hit = (valid & (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps)
               & (t > 1e-4) & (t < best_t))
        return (jnp.where(hit, t, best_t), jnp.where(hit, tri_id, best_i),
                jnp.where(hit, u, best_u), jnp.where(hit, v, best_v))

    n = dx.shape[0]
    init = (jnp.full((n,), _BIG, jnp.float32), jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n,), jnp.float32), jnp.zeros((n,), jnp.float32))
    best_t, best_i, best_u, best_v = jax.lax.fori_loop(
        0, count_ref[0], body, init)
    t_ref[...] = best_t
    idx_ref[...] = best_i
    u_ref[...] = best_u
    v_ref[...] = best_v


@partial(jax.jit, static_argnames=("sub", "num_warps", "interpret"))
def raycast_tiled(tri_scalars: jnp.ndarray, o: jnp.ndarray, d: jnp.ndarray,
                  tile_lists: jnp.ndarray, tile_counts: jnp.ndarray,
                  sub: int = SUB, num_warps: int = NUM_WARPS,
                  interpret: bool = False):
    """tri_scalars: (T, 9) float32 world-space [v0 | e1 | e2];
    o, d: (N, 3), grouped in BLOCK-ray screen tiles;
    tile_lists: (N/BLOCK, L) int32 front-packed candidate ids;
    tile_counts: (N/BLOCK,) int32. -> (t, tri_idx, u, v) each (N,);
    misses carry t = 1e16, tri_idx = -1."""
    n = o.shape[0]
    assert n % BLOCK == 0 and BLOCK % sub == 0, (n, BLOCK, sub)
    n_tiles = n // BLOCK
    per_tile = BLOCK // sub
    # power-of-two table and list widths (padding is never read: ids
    # < T and loop bounds <= count)
    tri = tri_scalars.astype(jnp.float32).reshape(-1)
    tri = jnp.pad(tri, (0, _next_pow2(tri.shape[0]) - tri.shape[0]))
    lists = tile_lists.astype(jnp.int32)
    lists = jnp.pad(lists, ((0, 0), (0, _next_pow2(lists.shape[1])
                                     - lists.shape[1])))
    planes = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]]
    planes = [p.astype(jnp.float32) for p in planes]

    ray_spec = pl.BlockSpec((sub,), lambda i, j: (i * per_tile + j,))
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    return pl.pallas_call(
        _kernel,
        grid=(n_tiles, per_tile),
        in_specs=[pl.BlockSpec((1,), lambda i, j: (i,)),
                  pl.BlockSpec(tri.shape, lambda i, j: (0,)),
                  pl.BlockSpec((1, lists.shape[1]), lambda i, j: (i, 0))]
                 + [ray_spec] * 6,
        out_specs=[ray_spec] * 4,
        out_shape=[f32, i32, f32, f32],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        interpret=interpret,
        name="mesh_raycast_tiled",
    )(tile_counts.astype(jnp.int32), tri, lists, *planes)
