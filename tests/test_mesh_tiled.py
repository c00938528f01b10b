"""Tile-culled mesh pass and its ray-cast kernel against the brute-force
Möller-Trumbore reference (`_raycast_chunked` over every triangle)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nerf_glasses_tpu.io import gltf as gltf_io
from nerf_glasses_tpu.ops import mesh_pallas as mp
from nerf_glasses_tpu.ops import triangles as tri_ops
from nerf_glasses_tpu.ops.colors import linear_to_srgb
from tests.helpers import write_quad_gltf


def _scene_with_quads(tmp_path):
    s1 = gltf_io.load(str(write_quad_gltf(tmp_path / "q1.gltf", size=0.8)))
    s1.nodes[0].translation = np.array([0.3, 0.2, 0.0], np.float32)
    s2 = gltf_io.load(str(write_quad_gltf(tmp_path / "q2.gltf", size=0.5)))
    s2.nodes[0].translation = np.array([-0.4, -0.3, 0.5], np.float32)
    return [s1, s2]


def _camera(eye=(0.05, -0.02, 2.2)):
    cam = np.zeros((3, 4), np.float32)
    cam[:, 0] = [0.7, 0, 0]
    cam[:, 1] = [0, 0.6, 0]
    cam[:, 2] = [0, 0, -1]
    cam[:, 3] = eye
    return cam


def test_tiled_matches_bruteforce(tmp_path):
    """The whole tiled pass (binning, tiled ray-cast, tile shading,
    un-tiling) equals brute-force ray-cast + dense shading of every
    pixel in image order."""
    scenes = _scene_with_quads(tmp_path)
    mesh = tri_ops.build_mesh_arrays(scenes)
    xf, nm = tri_ops.instance_transforms(mesh, scenes)
    cam = _camera()
    W, H = 200, 150
    c_tiled, d_tiled = tri_ops.render_mesh_pass(mesh, xf, nm, cam, W, H,
                                                [1, 1, 1])

    x = (np.arange(W, dtype=np.float32) + 0.5) / W * 2.0 - 1.0
    y = (np.arange(H, dtype=np.float32) + 0.5) / H * 2.0 - 1.0
    xx, yy = np.meshgrid(x, y)
    ndc = np.stack([xx, yy, np.ones_like(xx)], -1).reshape(-1, 3)
    d = ndc @ cam[:, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(cam[:, 3], d.shape)
    v0, e1, e2 = tri_ops.world_triangles(mesh, jnp.asarray(xf))
    t, tri, uv = tri_ops._raycast_chunked(jnp.asarray(o), jnp.asarray(d),
                                          v0, e1, e2, 256, True)
    rgb = tri_ops.shade_hits(mesh, jnp.asarray(o), jnp.asarray(d), t, tri,
                             uv, jnp.asarray(nm), [1, 1, 1],
                             jnp.asarray(cam[:, 3]))
    hit = np.asarray(tri) >= 0
    c_ref = np.concatenate(
        [np.asarray(linear_to_srgb(jnp.clip(rgb, 0.0, 1.0))),
         hit[:, None].astype(np.float32)], -1).reshape(H, W, 4)
    d_ref = np.where(hit, np.asarray(t), 0.0).reshape(H, W)

    assert c_tiled.shape == (H, W, 4) and d_tiled.shape == (H, W)
    np.testing.assert_allclose(d_tiled, d_ref, atol=1e-4)
    np.testing.assert_allclose(c_tiled, c_ref, atol=1e-4)
    assert (d_ref > 0).any()  # scene actually visible


def test_binning_counts_reasonable(tmp_path):
    scenes = _scene_with_quads(tmp_path)
    mesh = tri_ops.build_mesh_arrays(scenes)
    xf, nm = tri_ops.instance_transforms(mesh, scenes)
    cam3 = np.diag([0.7, 0.6, -1.0]).astype(np.float32)
    eye = np.array([0.0, 0.0, 2.2], np.float32)
    rot = np.asarray(xf)[np.asarray(mesh.inst_id), :, :3]
    trans = np.asarray(xf)[np.asarray(mesh.inst_id), :, 3]
    v0 = np.einsum("tij,tj->ti", rot, np.asarray(mesh.v0)) + trans
    e1 = np.einsum("tij,tj->ti", rot, np.asarray(mesh.e1))
    e2 = np.einsum("tij,tj->ti", rot, np.asarray(mesh.e2))
    lists, counts = tri_ops._bin_triangles(
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
        jnp.asarray(eye), jnp.asarray(np.linalg.inv(cam3)),
        256, 128, 256, 128)
    counts = np.asarray(counts)
    # 2 tiles of 128x64 on 256x128: quads concentrated -> not all tiles
    # carry all 4 triangles
    assert counts.max() <= 4
    assert counts.min() >= 0
    assert counts.sum() > 0


# ---------------------------------------------------------------------------
# The tiled ray-cast (Triton kernel in interpret mode, and the plain-XLA
# reference) on hand-built cases, rays and lists made the way the pass
# makes them
# ---------------------------------------------------------------------------

def _tri(v0, v1, v2):
    v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
    return np.concatenate([v0, v1 - v0, v2 - v0])


def _random_tris(rng, n):
    """Small triangles in front of the camera, random winding (about half
    are back-facing and culled)."""
    c = rng.uniform([-0.8, -0.6, -0.5], [0.8, 0.6, 0.5], (n, 1, 3))
    verts = c + rng.normal(scale=0.15, size=(n, 3, 3))
    return np.stack([_tri(*v) for v in verts])


def _edge_sharing_grid(n=6, z=0.0):
    """n x n quads tiling [-0.6, 0.6]^2 as 2n^2 triangles facing the
    camera: every interior edge is shared, so many rays land on ties."""
    g = np.linspace(-0.6, 0.6, n + 1)
    tris = []
    for i in range(n):
        for j in range(n):
            a = (g[j], g[i], z)
            b = (g[j + 1], g[i], z)
            c = (g[j + 1], g[i + 1], z)
            d = (g[j], g[i + 1], z)
            tris += [_tri(a, b, c), _tri(a, c, d)]
    return np.stack(tris)


def _case(name):
    """-> (tri (T, 9), width, height, force_zero_counts)."""
    rng = np.random.default_rng(7)
    if name == "random":
        return _random_tris(rng, 64), 128, 64, False
    if name == "non_pow2_T":
        return _random_tris(rng, 37), 128, 64, False
    if name == "shared_edge_ties":
        return _edge_sharing_grid(), 128, 64, False
    if name == "behind_eye":
        # one vertex behind the eye plane: binned to every tile
        big = _tri((-2.0, -2.0, -1.0), (2.0, -2.0, -1.0), (0.0, 2.0, 4.0))
        return (np.concatenate([_random_tris(rng, 5), big[None]]),
                256, 64, False)
    if name == "empty_tile":
        # content in the left half only: the right tile gets no candidates
        tris = _random_tris(rng, 12)
        tris[:, 0] = -0.5 - np.abs(tris[:, 0])
        return tris, 256, 64, False
    if name == "count_zero":
        return _random_tris(rng, 16), 128, 64, True
    raise KeyError(name)


def _rays_and_lists(tri, width, height):
    cam = _camera(eye=(0.0, 0.0, 2.2))
    wp = -(-width // tri_ops.TILE_W) * tri_ops.TILE_W
    hp = -(-height // tri_ops.TILE_H) * tri_ops.TILE_H
    o, d = tri_ops.tile_rays(jnp.asarray(cam), width, height, wp, hp)
    t = jnp.asarray(tri)
    lists, counts = tri_ops._bin_triangles(
        t[:, 0:3], t[:, 3:6], t[:, 6:9], jnp.asarray(cam[:, 3]),
        jnp.linalg.inv(jnp.asarray(cam[:, :3])), width, height, wp, hp)
    return o, d, lists, counts


_IMPLS = {
    "triton_interpret": functools.partial(mp.raycast_tiled, interpret=True),
    "triton_interpret_sub256": functools.partial(mp.raycast_tiled, sub=256,
                                                 interpret=True),
    "xla_reference": tri_ops.raycast_tiled_reference,
}


@pytest.mark.parametrize("impl", sorted(_IMPLS))
@pytest.mark.parametrize("case", ["random", "non_pow2_T", "shared_edge_ties",
                                  "behind_eye", "empty_tile", "count_zero"])
def test_tiled_raycast_matches_bruteforce(case, impl):
    tri, width, height, zero_counts = _case(case)
    o, d, lists, counts = _rays_and_lists(tri, width, height)
    if case == "behind_eye":
        assert int(counts.min()) >= 1          # the big one is everywhere
    if case == "empty_tile":
        assert int(counts[1]) == 0 and int(counts[0]) > 0
    if zero_counts:
        counts = jnp.zeros_like(counts)

    t, idx, u, v = (np.asarray(a) for a in
                    _IMPLS[impl](jnp.asarray(tri), o, d, lists, counts))
    tj = jnp.asarray(tri)
    rt, ri, ruv = tri_ops._raycast_chunked(o, d, tj[:, 0:3], tj[:, 3:6],
                                           tj[:, 6:9], 16, True)
    rt, ri, ruv = np.asarray(rt), np.asarray(ri), np.asarray(ruv)
    if zero_counts:
        ri = np.full_like(ri, -1)
    assert t.shape == idx.shape == u.shape == v.shape == (o.shape[0],)

    np.testing.assert_array_equal(idx >= 0, ri >= 0)       # no cracks
    agree = idx == ri
    assert agree.mean() >= 0.999, agree.mean()
    both = (idx >= 0) & (ri >= 0)
    np.testing.assert_allclose(t[both], rt[both], atol=1e-4)
    np.testing.assert_allclose(u[agree & both], ruv[agree & both, 0],
                               atol=1e-4)
    np.testing.assert_allclose(v[agree & both], ruv[agree & both, 1],
                               atol=1e-4)
    assert (t[idx < 0] == np.float32(1e16)).all()
    if case in ("random", "shared_edge_ties", "behind_eye"):
        assert (idx >= 0).sum() > 100          # the case really hits


def test_triton_kernel_lowers_for_cuda():
    """The kernel lowers for the GPU from a CPU-only machine (the GPU
    compiler itself only runs on the card)."""
    n_tiles, T = 2, 37
    tri = jnp.zeros((T, 9), jnp.float32)
    o = jnp.zeros((n_tiles * mp.BLOCK, 3), jnp.float32)
    d = jnp.ones((n_tiles * mp.BLOCK, 3), jnp.float32)
    lists = jnp.zeros((n_tiles, T), jnp.int32)
    counts = jnp.zeros((n_tiles,), jnp.int32)
    text = (jax.jit(mp.raycast_tiled).trace(tri, o, d, lists, counts)
            .lower(lowering_platforms=("cuda",)).as_text())
    assert "triton" in text


def test_raycast_dispatch_by_backend(monkeypatch):
    """CPU -> plain-XLA reference; GPU -> the Triton kernel; anything else
    raises instead of silently falling back."""
    calls = []
    monkeypatch.setattr(tri_ops, "raycast_tiled_reference",
                        lambda *a: calls.append("xla"))
    monkeypatch.setattr(mp, "raycast_tiled", lambda *a: calls.append("triton"))
    args = (None,) * 5
    tri_ops.tiled_raycast(*args)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    tri_ops.tiled_raycast(*args)
    assert calls == ["xla", "triton"]
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(NotImplementedError):
        tri_ops.tiled_raycast(*args)


def test_reference_accepts_lists_cut_to_largest_count():
    """Lists cut to the largest tile count (what the mesh-pass A/B feeds
    the plain-XLA variant) give the same result as full lists."""
    tri, width, height, _ = _case("random")
    o, d, lists, counts = _rays_and_lists(tri, width, height)
    full = tri_ops.raycast_tiled_reference(jnp.asarray(tri), o, d, lists,
                                           counts)
    cut = tri_ops.raycast_tiled_reference(jnp.asarray(tri), o, d,
                                          lists[:, :int(counts.max())],
                                          counts)
    for a, b in zip(full, cut):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: the Triton kernel compiles only "
                    "for the card (interpret-mode cases above cover it here)")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "non_pow2_T", "shared_edge_ties",
                                  "behind_eye", "empty_tile", "count_zero"])
def test_compiled_kernel_matches_reference_on_gpu(gpu, case):
    tri, width, height, zero_counts = _case(case)
    o, d, lists, counts = _rays_and_lists(tri, width, height)
    if zero_counts:
        counts = jnp.zeros_like(counts)
    got = mp.raycast_tiled(jnp.asarray(tri), o, d, lists, counts)
    want = tri_ops.raycast_tiled_reference(jnp.asarray(tri), o, d, lists,
                                           counts)
    idx, ridx = np.asarray(got[1]), np.asarray(want[1])
    np.testing.assert_array_equal(idx >= 0, ridx >= 0)
    assert (idx == ridx).mean() >= 0.999
    keep = (idx == ridx) & (idx >= 0)
    for a, b in zip(got[::2], want[::2]):
        np.testing.assert_allclose(np.asarray(a)[keep], np.asarray(b)[keep],
                                   atol=1e-4)
