"""XLA mesh ray-caster with PBR shading — replaces the OptiX pass.

The reference traces glTF meshes with OptiX 7.4 hardware RT
(__raygen__rg / __closesthit__ch, src/optix/optix_scene.cu:120-325) at 2x
supersampling, writing sRGB color + hit distance which are then 2x2
block-reduced into the NeRF ray payloads
(copyRaytracingBuffersToNerfRays, src/nerf_mesh_renderer.cu:64-100).

Re-design: rays are grouped into screen tiles, triangles are binned to
the tiles by projected bounding box, and each tile is traced against its
own candidates only (the Triton kernel of ops/mesh_pallas.py on the GPU,
`raycast_tiled_reference` in plain XLA on the CPU). Triangles stay in
*object space* inside the compiled pass; per-instance transforms are
runtime arguments (the analogue of the reference's IAS instance
transforms, nerf_mesh_renderer.cu:1389-1452), so moving/rotating a mesh
never recompiles. Shading is vectorized arithmetic with masked per-material
texture sampling.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nerf_glasses_tpu.io.gltf import GltfMaterial, GltfNode, GltfScene
from nerf_glasses_tpu.ops.colors import linear_to_srgb
from nerf_glasses_tpu.ops.compaction import stable_partition_ids

_BIG = np.float32(1e16)
_MESH_VERSION = itertools.count()


@dataclasses.dataclass
class MeshArrays:
    """Object-space triangle soup + per-triangle attributes (jnp arrays)."""
    v0: jnp.ndarray          # (T, 3)
    e1: jnp.ndarray          # (T, 3)  v1 - v0
    e2: jnp.ndarray          # (T, 3)  v2 - v0
    n: jnp.ndarray           # (T, 3, 3) per-vertex object normals
    tan: jnp.ndarray         # (T, 3, 4) per-vertex object tangents
    uv: jnp.ndarray          # (T, 3, 2)
    mat_id: jnp.ndarray      # (T,) int32
    inst_id: jnp.ndarray     # (T,) int32 (indexes instance transforms)
    materials: List[GltfMaterial]
    nodes: List[GltfNode]    # instance i <- nodes[i] (transform source)
    # stacked per-material factors
    base_color: jnp.ndarray       # (M, 4)
    metallic: jnp.ndarray         # (M,)
    roughness: jnp.ndarray        # (M,)
    emissive: jnp.ndarray         # (M, 3)
    normal_scale: jnp.ndarray     # (M,)
    occlusion_strength: jnp.ndarray  # (M,)
    _tile_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    # monotonic build counter: jit caches that close over a MeshArrays
    # key on this instead of id() (ids are reused after GC — the same
    # hazard Testbed._scene_version fixes for scene arrays)
    version: int = 0

    @property
    def n_tris(self) -> int:
        return self.v0.shape[0]

    @property
    def n_instances(self) -> int:
        return len(self.nodes)


def _walk_nodes(scenes):
    """Yield (node, parent_transform) depth-first in a stable order."""
    def rec(node, parent):
        yield node, parent
        x = parent @ node.get_transform()
        for c in node.children:
            yield from rec(c, x)

    for scene in scenes:
        for node in scene.nodes:
            yield from rec(node, np.eye(4, dtype=np.float32))


def build_mesh_arrays(scenes) -> Optional[MeshArrays]:
    """Flatten glTF scenes into an object-space soup with instance ids."""
    v0s, e1s, e2s, ns, tans, uvs, mids, iids = [], [], [], [], [], [], [], []
    materials: List[GltfMaterial] = []
    nodes: List[GltfNode] = []

    for node, _parent in _walk_nodes(scenes):
        if node.mesh is None:
            continue
        iid = len(nodes)
        nodes.append(node)
        for prim in node.mesh.primitives:
            tri = prim.indices.reshape(-1, 3)
            v = prim.positions[tri]
            v0s.append(v[:, 0])
            e1s.append(v[:, 1] - v[:, 0])
            e2s.append(v[:, 2] - v[:, 0])
            ns.append(prim.normals[tri])
            tans.append(prim.tangents[tri])
            uvs.append(prim.texcoords[tri])
            mid = len(materials)
            materials.append(prim.material)
            mids.append(np.full(len(tri), mid, np.int32))
            iids.append(np.full(len(tri), iid, np.int32))

    if not v0s:
        return None

    j = jnp.asarray
    return MeshArrays(
        v0=j(np.concatenate(v0s), jnp.float32),
        e1=j(np.concatenate(e1s), jnp.float32),
        e2=j(np.concatenate(e2s), jnp.float32),
        n=j(np.concatenate(ns), jnp.float32),
        tan=j(np.concatenate(tans), jnp.float32),
        uv=j(np.concatenate(uvs), jnp.float32),
        mat_id=j(np.concatenate(mids)),
        inst_id=j(np.concatenate(iids)),
        materials=materials,
        nodes=nodes,
        base_color=j(np.stack([m.base_color_factor for m in materials]),
                     jnp.float32),
        metallic=j(np.array([m.metallic_factor for m in materials],
                            np.float32)),
        roughness=j(np.array([m.roughness_factor for m in materials],
                             np.float32)),
        emissive=j(np.stack([m.emissive_factor for m in materials]),
                   jnp.float32),
        normal_scale=j(np.array([m.normal_scale for m in materials],
                                np.float32)),
        occlusion_strength=j(np.array([m.occlusion_strength
                                       for m in materials], np.float32)),
        version=next(_MESH_VERSION),
    )


def instance_transforms(mesh: MeshArrays, scenes) -> Tuple[np.ndarray, np.ndarray]:
    """Current composed world transforms per instance -> (xforms (I,3,4),
    normal matrices (I,3,3))."""
    node_to_xform = {}
    for node, parent in _walk_nodes(scenes):
        node_to_xform[id(node)] = parent @ node.get_transform()
    xf = np.stack([node_to_xform[id(n)][:3, :4] for n in mesh.nodes])
    nrm = np.stack([np.linalg.inv(x[:3, :3]).T for x in xf])
    return xf.astype(np.float32), nrm.astype(np.float32)


# ---------------------------------------------------------------------------
# Intersection
# ---------------------------------------------------------------------------

def _raycast_chunked(o, d, v0, e1, e2, chunk: int, cull_backfaces: bool):
    """Möller-Trumbore over all (world-space) triangles.

    Back-face culling matches OPTIX_RAY_FLAG_CULL_BACK_FACING_TRIANGLES
    (optix_scene.cu:144). Returns (t, tri_idx, u, v)."""
    n = o.shape[0]
    n_tris = v0.shape[0]
    best_t = jnp.full((n,), _BIG)
    best_i = jnp.full((n,), -1, jnp.int32)
    best_uv = jnp.zeros((n, 2))

    n_chunks = (n_tris + chunk - 1) // chunk
    pad = n_chunks * chunk - n_tris
    if pad:
        v0 = jnp.concatenate([v0, jnp.zeros((pad, 3))])
        e1 = jnp.concatenate([e1, jnp.zeros((pad, 3))])
        e2 = jnp.concatenate([e2, jnp.zeros((pad, 3))])
    v0 = v0.reshape(n_chunks, chunk, 3)
    e1 = e1.reshape(n_chunks, chunk, 3)
    e2 = e2.reshape(n_chunks, chunk, 3)

    def body(c, carry):
        best_t, best_i, best_uv = carry
        cv0, ce1, ce2 = v0[c], e1[c], e2[c]
        pvec = jnp.cross(d[:, None, :], ce2[None])          # (N, C, 3)
        det = jnp.sum(ce1[None] * pvec, axis=-1)            # (N, C)
        if cull_backfaces:
            valid = det > 1e-9
        else:
            valid = jnp.abs(det) > 1e-9
        inv_det = 1.0 / jnp.where(valid, det, 1.0)
        tvec = o[:, None, :] - cv0[None]
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, ce1[None])
        v = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
        t = jnp.sum(ce2[None] * qvec, axis=-1) * inv_det
        # slightly padded acceptance so rays on shared triangle edges
        # cannot fall through the crack (OptiX traversal is watertight;
        # plain Möller-Trumbore is not)
        eps = 1e-5
        hit = (valid & (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps)
               & (t > 1e-4))
        t = jnp.where(hit, t, _BIG)
        arg = jnp.argmin(t, axis=-1)
        tmin = jnp.take_along_axis(t, arg[:, None], -1)[:, 0]
        umin = jnp.take_along_axis(u, arg[:, None], -1)[:, 0]
        vmin = jnp.take_along_axis(v, arg[:, None], -1)[:, 0]
        better = tmin < best_t
        best_i = jnp.where(better, c * chunk + arg.astype(jnp.int32), best_i)
        best_uv = jnp.where(better[:, None], jnp.stack([umin, vmin], -1),
                            best_uv)
        best_t = jnp.where(better, tmin, best_t)
        return best_t, best_i, best_uv

    return jax.lax.fori_loop(0, n_chunks, body, (best_t, best_i, best_uv))


# ---------------------------------------------------------------------------
# Shading (closesthit PBR, optix_scene.cu:182-325)
# ---------------------------------------------------------------------------

def _sample_texture(tex: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear, repeat wrap, normalized coords (CudaTexture semantics)."""
    h, w = tex.shape[:2]
    u = (uv[:, 0] % 1.0) * w - 0.5
    v = (uv[:, 1] % 1.0) * h - 0.5
    x0 = jnp.floor(u).astype(jnp.int32)
    y0 = jnp.floor(v).astype(jnp.int32)
    fx = (u - x0)[:, None]
    fy = (v - y0)[:, None]

    def at(x, y):
        return tex[y % h, x % w]

    return (at(x0, y0) * (1 - fx) * (1 - fy)
            + at(x0 + 1, y0) * fx * (1 - fy)
            + at(x0, y0 + 1) * (1 - fx) * fy
            + at(x0 + 1, y0 + 1) * fx * fy)


def _d_ggx(dot_nh, alpha):
    a2 = alpha * alpha
    f = (dot_nh * a2 - dot_nh) * dot_nh + 1.0
    return a2 / (f * f)


def _g_ggx(dot_nl, dot_nv, alpha):
    a2 = alpha * alpha
    lv = jnp.maximum(dot_nl, 0.0) / jnp.sqrt(a2 + (1 - a2) * dot_nv * dot_nv)
    ll = jnp.maximum(dot_nv, 0.0) / jnp.sqrt(a2 + (1 - a2) * dot_nl * dot_nl)
    return 0.5 / (lv + ll + 1e-4)


def _f_schlick(f0, u):
    return f0 + (1.0 - f0) * jnp.power(1.0 - u, 5.0)


def shade_hits(mesh: MeshArrays, o, d, t, tri, uv_bary, nrm_mats,
               light_pos, cam_eye):
    """PBR metallic-roughness shading of hit points -> linear rgb (N,3).

    nrm_mats: (I, 3, 3) instance normal matrices.
    """
    hit = tri >= 0
    tri_c = jnp.maximum(tri, 0)
    u = uv_bary[:, 0:1]
    v = uv_bary[:, 1:2]
    w0 = 1.0 - u - v

    iid = mesh.inst_id[tri_c]
    nm = nrm_mats[iid]                                     # (N, 3, 3)

    n_vert = mesh.n[tri_c]
    n_obj = w0 * n_vert[:, 0] + u * n_vert[:, 1] + v * n_vert[:, 2]
    n_geo = jnp.einsum("nij,nj->ni", nm, n_obj)
    t_vert = mesh.tan[tri_c]
    tan4 = w0 * t_vert[:, 0] + u * t_vert[:, 1] + v * t_vert[:, 2]
    tan_w = jnp.einsum("nij,nj->ni", nm, tan4[:, :3])
    uv_vert = mesh.uv[tri_c]
    uv = w0 * uv_vert[:, 0] + u * uv_vert[:, 1] + v * uv_vert[:, 2]

    mid = mesh.mat_id[tri_c]
    base = mesh.base_color[mid]
    metallic = mesh.metallic[mid]
    roughness = mesh.roughness[mid]
    emissive = mesh.emissive[mid]
    occlusion = jnp.ones_like(metallic)

    # TBN (Gram-Schmidt, optix_scene.cu:92-98)
    nrm = n_geo / jnp.maximum(jnp.linalg.norm(n_geo, axis=-1, keepdims=True),
                              1e-9)
    tng = tan_w - nrm * jnp.sum(tan_w * nrm, -1, keepdims=True)
    tng = tng / jnp.maximum(jnp.linalg.norm(tng, axis=-1, keepdims=True), 1e-9)
    btn = jnp.cross(nrm, tng) * tan4[:, 3:4]

    normal = nrm
    for i, mat in enumerate(mesh.materials):
        mmask = (mid == i)[:, None]
        if mat.base_color_texture is not None:
            texv = _sample_texture(jnp.asarray(mat.base_color_texture), uv)
            base = jnp.where(mmask, base * texv, base)
        if mat.metallic_roughness_texture is not None:
            mr = _sample_texture(
                jnp.asarray(mat.metallic_roughness_texture), uv)
            metallic = jnp.where(mmask[:, 0], metallic * mr[:, 2], metallic)
            roughness = jnp.where(mmask[:, 0], roughness * mr[:, 1], roughness)
        if mat.emissive_texture is not None:
            ev = _sample_texture(jnp.asarray(mat.emissive_texture), uv)
            emissive = jnp.where(mmask, emissive * ev[:, :3], emissive)
        if mat.normal_texture is not None:
            nt = _sample_texture(jnp.asarray(mat.normal_texture), uv)
            ns = mesh.normal_scale[mid]
            ntan = (nt[:, :3] * 2.0 - 1.0) * jnp.stack(
                [ns, ns, jnp.ones_like(metallic)], -1)
            mapped = (tng * ntan[:, 0:1] + btn * ntan[:, 1:2]
                      + nrm * ntan[:, 2:3])
            normal = jnp.where(mmask, mapped, normal)
        if mat.occlusion_texture is not None:
            ot = _sample_texture(jnp.asarray(mat.occlusion_texture), uv)
            occ_v = 1.0 + mesh.occlusion_strength[mid] * (ot[:, 0] - 1.0)
            occlusion = jnp.where(mmask[:, 0], occ_v, occlusion)

    normal = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-9)

    hit_pos = o + t[:, None] * d
    ambient = base[:, :3] * 0.2 * occlusion[:, None]

    N = normal
    V = cam_eye - hit_pos
    V = V / jnp.maximum(jnp.linalg.norm(V, axis=-1, keepdims=True), 1e-9)
    L = jnp.asarray(light_pos) - hit_pos
    L = L / jnp.maximum(jnp.linalg.norm(L, axis=-1, keepdims=True), 1e-9)
    H = V + L
    H = H / jnp.maximum(jnp.linalg.norm(H, axis=-1, keepdims=True), 1e-9)

    dot_nl = jnp.sum(N * L, -1)
    dot_nv = jnp.sum(N * V, -1)
    fd = ((1.0 - metallic[:, None]) * base[:, :3]
          * jnp.maximum(dot_nl, 0.0)[:, None])

    dot_nh = jnp.clip(jnp.sum(N * H, -1), 0.0, 1.0)
    dot_lh = jnp.clip(jnp.sum(L * H, -1), 0.0, 1.0)
    alpha = roughness * roughness
    f0 = ((0.5 * alpha)[:, None] * (1.0 - metallic[:, None])
          + base[:, :3] * metallic[:, None])
    D = _d_ggx(dot_nh, alpha)
    G = _g_ggx(dot_nl, dot_nv, alpha)
    F = _f_schlick(f0, dot_lh[:, None])
    fr = jnp.abs(D[:, None] * G[:, None] * F / np.pi)
    fr = jnp.where(((dot_nv > 0) & (dot_nl > 0))[:, None], fr, 0.0)

    rgb = ambient + fd + fr + emissive
    return jnp.where(hit[:, None], rgb, 0.0)


def shade_hits_compacted(mesh: MeshArrays, o, d, t, tri, uv_bary, nrm_mats,
                         light_pos, cam_eye, chunk: int = 1 << 15):
    """shade_hits, but only for rays that actually hit a triangle.

    Mesh coverage is typically a small screen fraction (the bench
    glasses: ~1% of 3.7M supersampled rays), so shading every ray would
    waste ~99% of the work. This compacts hit-ray ids with the same
    stable partition as the march's ray compaction and shades fixed-size
    chunks, so cost scales with hits. Returns (N, 3) rgb with zeros at
    misses."""
    n = t.shape[0]
    perm, n_hit = stable_partition_ids(tri >= 0)

    CH = min(chunk, n)
    n_chunks = (n_hit + CH - 1) // CH
    rgb = jnp.zeros((n, 3))

    def body(i, rgb):
        idx = jax.lax.dynamic_slice(perm, (i * CH,), (CH,))
        rgb_c = shade_hits(mesh, o[idx], d[idx], t[idx], tri[idx],
                           uv_bary[idx], nrm_mats, light_pos, cam_eye)
        return rgb.at[idx].set(rgb_c)

    return jax.lax.fori_loop(0, n_chunks, body, rgb)


# ---------------------------------------------------------------------------
# Full mesh pass
# ---------------------------------------------------------------------------

TILE_W, TILE_H = 128, 64  # screen tile = one raycast ray block (8192 px)


def tile_rays(cam, width: int, height: int, wp: int, hp: int):
    """Unit camera rays for a (hp, wp) tile-padded screen in tile-major
    order -> (o, d) each (n_tiles * TILE_H * TILE_W, 3). Pixel i maps to
    ndc 2(i+.5)/width - 1 regardless of the padding (__raygen__rg,
    optix_scene.cu:120-174)."""
    ntx, nty = wp // TILE_W, hp // TILE_H
    px = jax.lax.broadcasted_iota(jnp.float32, (hp, wp), 1) + 0.5
    py = jax.lax.broadcasted_iota(jnp.float32, (hp, wp), 0) + 0.5
    ndc = jnp.stack([px / width * 2.0 - 1.0,
                     py / height * 2.0 - 1.0,
                     jnp.ones((hp, wp))], axis=-1)
    d = ndc @ cam[:, :3].T
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    d_t = (d.reshape(nty, TILE_H, ntx, TILE_W, 3)
           .transpose(0, 2, 1, 3, 4).reshape(-1, 3))
    return jnp.broadcast_to(cam[:, 3], d_t.shape), d_t


def world_triangles(mesh: MeshArrays, xforms):
    """Object-space soup -> world-space (v0, e1, e2) via each triangle's
    instance transform."""
    rot = xforms[mesh.inst_id, :, :3]
    trans = xforms[mesh.inst_id, :, 3]
    v0 = jnp.einsum("tij,tj->ti", rot, mesh.v0) + trans
    e1 = jnp.einsum("tij,tj->ti", rot, mesh.e1)
    e2 = jnp.einsum("tij,tj->ti", rot, mesh.e2)
    return v0, e1, e2


def raycast_tiled_reference(tri_scalars, o, d, tile_lists, tile_counts,
                            chunk: int = 256):
    """Plain-XLA tiled ray-cast with the kernel's contract
    (ops/mesh_pallas.py `raycast_tiled`): each tile's candidate list is
    gathered (the list may be cut to the largest count), entries past
    the tile's count become degenerate triangles that never hit, and
    `_raycast_chunked` runs per tile under `lax.map`."""
    n_tiles, width = tile_lists.shape
    o_t = o.reshape(n_tiles, -1, 3)
    d_t = d.reshape(n_tiles, -1, 3)

    def one(args):
        o_, d_, ids, count = args
        ok = (jnp.arange(width) < count)[:, None]
        tri = jnp.where(ok, tri_scalars[ids], 0.0)
        t, k, uv = _raycast_chunked(o_, d_, tri[:, 0:3], tri[:, 3:6],
                                    tri[:, 6:9], min(chunk, width),
                                    cull_backfaces=True)
        idx = jnp.where(k >= 0, ids[jnp.maximum(k, 0)], -1)
        return t, idx, uv[:, 0], uv[:, 1]

    t, idx, u, v = jax.lax.map(one, (o_t, d_t, tile_lists, tile_counts))
    return t.reshape(-1), idx.reshape(-1), u.reshape(-1), v.reshape(-1)


def tiled_raycast(tri_scalars, o, d, tile_lists, tile_counts):
    """The mesh pass's ray-cast for this process's backend: the Triton
    kernel on the GPU, the plain-XLA reference on the CPU."""
    backend = jax.default_backend()
    if backend == "gpu":
        from nerf_glasses_tpu.ops.mesh_pallas import raycast_tiled
        return raycast_tiled(tri_scalars, o, d, tile_lists, tile_counts)
    if backend == "cpu":
        return raycast_tiled_reference(tri_scalars, o, d, tile_lists,
                                       tile_counts)
    raise NotImplementedError(f"no mesh ray-cast for backend {backend!r}")


def render_mesh_pass(mesh: MeshArrays, xforms, nrm_mats,
                     camera: np.ndarray, width: int, height: int,
                     light_pos, device_out: bool = False, factor: int = 1):
    """Trace + shade the mesh at (width, height) in *renderer world* space
    (no +0.5 NGP shift; __raygen__rg, optix_scene.cu:120-174): bin
    triangles to screen tiles by projected bbox, trace each tile against
    only its candidates (the analogue of the reference's OptiX IAS/GAS
    traversal), shade only the tiles that hit.

    Returns (color (H/f, W/f, 4) float32: sRGB-encoded rgb + coverage
    alpha, depth (H/f, W/f): hit distance along the unit ray, 0 on miss).

    Everything — ray generation, binning, trace, shade, un-tiling — runs
    on device in one jitted dispatch; only the 3x4 camera and instance
    transforms are uploaded per frame. `device_out` keeps the results as
    jnp arrays (the hybrid frame path feeds them straight into the
    volumetric march); otherwise both come back in one fetch. `factor`
    > 1 fuses the FxF payload block-reduce
    (copyRaytracingBuffersToNerfRays) into the same dispatch, reducing in
    tile layout before the un-tiling transpose touches device memory."""
    cam = jnp.asarray(camera, jnp.float32)
    wp = ((width + TILE_W - 1) // TILE_W) * TILE_W
    hp = ((height + TILE_H - 1) // TILE_H) * TILE_H
    fn = _get_pass_fn(mesh, width, height, wp, hp, factor)
    color, depth = fn(cam, jnp.asarray(xforms), jnp.asarray(nrm_mats),
                      jnp.asarray(light_pos, jnp.float32))
    color = color[:height // factor, :width // factor]
    depth = depth[:height // factor, :width // factor]
    if device_out:
        return color, depth
    return jax.device_get((color, depth))


def _get_pass_fn(mesh: MeshArrays, width: int, height: int, wp: int,
                 hp: int, factor: int):
    key = ("pass", width, height, wp, hp, factor)
    fn = mesh._tile_cache.get(key)
    if fn is None:
        ntx = wp // TILE_W
        nty = hp // TILE_H
        assert TILE_W % factor == 0 and TILE_H % factor == 0

        def f(cam, xforms, nrm_mats, light):
            eye = cam[:, 3]
            o_t, d_t = tile_rays(cam, width, height, wp, hp)
            v0, e1, e2 = world_triangles(mesh, xforms)
            lists, counts = _bin_triangles(v0, e1, e2, eye,
                                           jnp.linalg.inv(cam[:, :3]),
                                           width, height, wp, hp)
            tri_scalars = jnp.concatenate([v0, e1, e2], axis=1)
            t, tri, uu, vv = tiled_raycast(tri_scalars, o_t, d_t, lists,
                                           counts)

            # Shade at TILE granularity: partition the tiles by "any
            # hit", then shade whole hit tiles densely — misses inside a
            # hit tile are masked — and FxF-reduce with a direct per-tile
            # store. Hypothesis behind the design: mesh coverage is a
            # small screen share (hit tiles are <6% of tiles on the
            # glasses scene), so dense tile shading stays small, while a
            # ray-granular partition would pay a full-frame perm round
            # trip and per-ray scatter. Misses never touch a
            # full-supersample buffer.
            pix = TILE_H * TILE_W
            n_tiles = nty * ntx
            th, tw = TILE_H // factor, TILE_W // factor
            t4 = t.reshape(n_tiles, pix)
            tri4 = tri.reshape(n_tiles, pix)
            uu4 = uu.reshape(n_tiles, pix)
            vv4 = vv.reshape(n_tiles, pix)
            d4 = d_t.reshape(n_tiles, pix, 3)
            tile_hit = jnp.any(tri4 >= 0, axis=1)
            perm_t, n_t = stable_partition_ids(tile_hit)
            K = 4                               # tiles/chunk (32k rays)
            # pad so the last dynamic_slice never clamps (a clamped
            # slice would re-shade tiles -> double-counted scatter-add)
            perm_pad = jnp.concatenate(
                [perm_t, jnp.zeros((K,), perm_t.dtype)])
            n_chunks = (n_t + K - 1) // K
            inv_ff = 1.0 / float(factor * factor)
            color0 = jnp.zeros((n_tiles, th, tw, 4))
            depth0 = jnp.zeros((n_tiles, th, tw))

            def body(i, carry):
                ca, dm = carry
                tidx = jax.lax.dynamic_slice(perm_pad, (i * K,), (K,))
                # lanes past n_t are padding: mask their rays invalid
                # (their zero contribs then land harmlessly on tile 0)
                lane_ok = (i * K + jnp.arange(K, dtype=n_t.dtype)) < n_t
                tidx = jnp.where(lane_ok, tidx, 0)
                tt = t4[tidx].reshape(K * pix)
                trit = tri4[tidx].reshape(K * pix)
                valid = (trit >= 0) & jnp.repeat(lane_ok, pix)
                uv_c = jnp.stack([uu4[tidx].reshape(-1),
                                  vv4[tidx].reshape(-1)], axis=-1)
                d_c = d4[tidx].reshape(K * pix, 3)
                o_c = jnp.broadcast_to(eye, d_c.shape)
                rgb_c = shade_hits(mesh, o_c, d_c, tt, trit, uv_c,
                                   nrm_mats, light, eye)
                # sRGB encode + clamp before compositing
                # (optix_scene.cu:161-165)
                srgb = linear_to_srgb(jnp.clip(rgb_c, 0.0, 1.0))
                contrib = jnp.where(
                    valid[:, None],
                    jnp.concatenate([srgb, jnp.ones((K * pix, 1))], -1)
                    * inv_ff, 0.0)
                # FxF block reduce inside the tile, then one store/tile
                red = (contrib.reshape(K, th, factor, tw, factor, 4)
                       .sum(axis=(2, 4)))
                dmax = (jnp.where(valid, tt, 0.0)
                        .reshape(K, th, factor, tw, factor)
                        .max(axis=(2, 4)))
                ca = ca.at[tidx].add(red)
                dm = dm.at[tidx].max(dmax)
                return ca, dm

            color, depth = jax.lax.fori_loop(0, n_chunks, body,
                                             (color0, depth0))
            color = color.reshape(nty, ntx, th, tw, 4)
            depth = depth.reshape(nty, ntx, th, tw)
            # un-tile back to image layout on device
            color = (color.transpose(0, 2, 1, 3, 4)
                     .reshape(nty * th, ntx * tw, 4))
            depth = (depth.transpose(0, 2, 1, 3)
                     .reshape(nty * th, ntx * tw))
            return color, depth

        fn = jax.jit(f)
        mesh._tile_cache[key] = fn
    return fn


def render_mesh_surface(mesh: MeshArrays, xforms, nrm_mats,
                        camera: np.ndarray, width: int, height: int,
                        factor: int, light_pos):
    """Mesh pass at (width*factor, height*factor) supersampling with the
    FxF payload block-reduce fused into the same dispatch -> per-NeRF-
    pixel (surface_color (H,W,4), t_surface (H,W)) jnp arrays."""
    return render_mesh_pass(mesh, xforms, nrm_mats, camera, width * factor,
                            height * factor, light_pos, device_out=True,
                            factor=factor)


def _bin_triangles(v0, e1, e2, eye, cam3_inv, width: int, height: int,
                   wp: int, hp: int):
    """Conservative screen-space bbox binning -> (tile_lists (n_tiles, T)
    front-packed ids, counts (n_tiles,)). Triangles with any vertex at or
    behind the eye plane go to every tile. Projection uses the *logical*
    width/height (pixel i maps to ndc 2(i+.5)/width - 1 regardless of the
    tile padding)."""
    verts = jnp.stack([v0, v0 + e1, v0 + e2], axis=1)      # (T, 3, 3)
    rel = verts - eye
    ndc = jnp.einsum("ij,tvj->tvi", cam3_inv, rel)          # (T, 3v, 3)
    z = ndc[..., 2]
    behind = jnp.any(z <= 1e-6, axis=1)                     # (T,)
    zs = jnp.where(z <= 1e-6, 1.0, z)
    px = (ndc[..., 0] / zs * 0.5 + 0.5) * width
    py = (ndc[..., 1] / zs * 0.5 + 0.5) * height
    pad = 1.0
    xmin = jnp.where(behind, 0.0, px.min(1) - pad)
    xmax = jnp.where(behind, float(wp), px.max(1) + pad)
    ymin = jnp.where(behind, 0.0, py.min(1) - pad)
    ymax = jnp.where(behind, float(hp), py.max(1) + pad)

    ntx = wp // TILE_W
    nty = hp // TILE_H
    tx0 = (jnp.arange(ntx) * TILE_W).astype(jnp.float32)
    ty0 = (jnp.arange(nty) * TILE_H).astype(jnp.float32)
    ox = (xmax[None, :] >= tx0[:, None]) & \
         (xmin[None, :] <= tx0[:, None] + TILE_W)           # (ntx, T)
    oy = (ymax[None, :] >= ty0[:, None]) & \
         (ymin[None, :] <= ty0[:, None] + TILE_H)           # (nty, T)
    overlap = (oy[:, None, :] & ox[None, :, :]).reshape(ntx * nty, -1)
    counts = overlap.sum(axis=1).astype(jnp.int32)
    # front-pack overlapping triangle ids (stable sort: ids ascending)
    order = jnp.argsort(~overlap, axis=1, stable=True).astype(jnp.int32)
    return order, counts


def downsample_surface(color, depth, factor: int):
    """Block-reduce the supersampled mesh buffers into per-NeRF-pixel
    payloads: color = mean, depth = max of hit depths
    (copyRaytracingBuffersToNerfRays, nerf_mesh_renderer.cu:64-100).
    Works on numpy or jnp arrays (stays on device for jnp).
    """
    xp = jnp if isinstance(depth, jnp.ndarray) else np
    h, w = depth.shape
    hh, ww = h // factor, w // factor
    c = color.reshape(hh, factor, ww, factor, 4).mean(axis=(1, 3))
    dmax = depth.reshape(hh, factor, ww, factor).max(axis=(1, 3))
    return c.astype(xp.float32), dmax.astype(xp.float32)
