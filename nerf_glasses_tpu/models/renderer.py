"""NerfMeshRenderer — the hybrid NeRF + mesh orchestrator.

Headless re-design of the reference renderer
(src/nerf_mesh_renderer.cu, class NerfMeshRenderer): the GLFW/ImGui window
is not part of this build's capability contract; `frame()` advances the
camera/render state and produces the composited framebuffer in memory
(displayable via `display_image()` / `save_frame()`).

Per-frame pipeline (render_frame, nerf_mesh_renderer.cu:543-599):
  1. mesh pass at 2x supersampling -> sRGB color + hit depth
  2. 2x2 block-reduce into per-pixel (t_surface, surface_color) payloads
  3. each NeRF renders with the packed camera; payloads gate the march
  4. first NeRF's buffers are the output; additional NeRFs are merged by
     nearest-depth (combineBuffersKernel, nerf_mesh_renderer.cu:34-48)
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np

from nerf_glasses_tpu.io import gltf as gltf_io
from nerf_glasses_tpu.models.testbed import Testbed
from nerf_glasses_tpu.ops import triangles as tri_ops
from nerf_glasses_tpu.ops.colors import accumulate, tonemap_frame
from nerf_glasses_tpu.utils.camera import OrbitCamera, pack_camera

import jax.numpy as jnp


class NerfMeshRenderer:
    """Constructor mirrors NerfMeshRenderer(width, height)
    (nerf_mesh_renderer.cu:365-452); render_size_factor = 1 for the NeRF
    pass, mesh_render_size_factor = 2 (nerf_mesh_renderer.cuh:111-112)."""

    def __init__(self, width: int = 1280, height: int = 720):
        self.SCREEN_WIDTH = width
        self.SCREEN_HEIGHT = height
        self.render_size_factor = 1.0
        self.mesh_render_size_factor = 2
        self.render_width = int(width * self.render_size_factor)
        self.render_height = int(height * self.render_size_factor)

        self.camera = OrbitCamera()
        self.light_pos = np.array([1.0, 1.0, 1.0], np.float32)
        self.view_projection_mat = self._pack()

        self._nerfs: List[Testbed] = []
        self._meshes: List[gltf_io.GltfScene] = []
        self._mesh_arrays: Optional[tri_ops.MeshArrays] = None
        self._envmap: Optional[np.ndarray] = None

        self._frame_buffer = None   # (H, W, 4) linear premultiplied
        self._depth_buffer = None
        # depth visualization overlay (the reference's overlay_depth
        # render-buffer mode, render_buffer.cu:421-535)
        self.visualize_depth = False
        self.depth_overlay_alpha = 1.0
        self.depth_overlay_scale = 1.0
        self.depth_colormap = "turbo"
        self._frame_count = 0
        self._fps_t0 = time.monotonic()
        self._fps_frames = 0
        self.fps = 0.0
        self._closed = False
        from nerf_glasses_tpu.utils.meters import Ema
        self.frame_ms = Ema("time", 1000.0)   # Testbed::m_frame_ms analogue
        self.render_ms = Ema("time", 1000.0)
        # opt-in per-phase profiling: drains the device between the mesh
        # and NeRF passes (costs pipelining; keep off for production)
        self.profile = False
        self.mesh_ms = Ema("time", 1000.0)
        self.nerf_ms = Ema("time", 1000.0)
        # progressive accumulation across frames (the reference GUI's
        # static-camera refinement, render_buffer.cu:232-268): while the
        # camera holds still the composited frames average into
        # self._accum (keyed on the first NeRF's spp counter, which
        # resets on camera movement) and display_image() shows the
        # average. Measured FREE in the hybrid loop
        # (tools/profile_accum.py: on/off within timing noise — the few
        # elementwise ops overlap the next frame's dispatch).
        self.progressive_accum = True
        self._accum = None          # (H, W, 4) running spp average

    # ------------------------------------------------------------------
    # Camera
    # ------------------------------------------------------------------

    def _pack(self) -> np.ndarray:
        aspect = self.SCREEN_WIDTH / float(self.SCREEN_HEIGHT)
        return self.camera.packed(aspect)

    def update_model_view_proj(self):
        """updateModelViewProj (nerf_mesh_renderer.cu:919-939)."""
        self.view_projection_mat = self._pack()
        for nerf in self._nerfs:
            nerf.camera_matrix = self.view_projection_mat.copy()
            nerf.reset_accumulation(True)

    def orbit(self, delta_azimuth: float, delta_polar: float,
              delta_zoom: float):
        """Orbit camera around the pivot (nerf_mesh_renderer.cu:896-899);
        note the argument order quirk: orbitcam takes (polar, azimuth)."""
        self.camera.orbit(delta_azimuth, delta_polar, delta_zoom)
        self.update_model_view_proj()

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------

    def load_nerf(self, path: str, bake: bool = False,
                  bake_resolution: int = 512,
                  feat_resolution: int = 256,
                  verify_fidelity: bool = True,
                  verify_threshold_db: float = 30.0) -> Testbed:
        """loadNerf (nerf_mesh_renderer.cu:967-1000).

        `bake=True` (extension) bakes the density (+ feature, single-
        cascade) grids on load and enables the fast path — one call from
        snapshot to the ~10x render path the bench headlines. Single-
        cascade snapshots get the full flash bundle; aabb_scale > 1
        snapshots get the baked-pyramid + deferred-shade path (the flash
        vector machinery is cascade-0 only, Testbed._march_options).
        Because flash's speed bundle drops the per-sample occupancy gate,
        an arbitrary user scene gets a fidelity auto-probe at bake time
        (Testbed.verify_bake_fidelity): one low-res frame fast-vs-exact;
        below 30 dB the probe escalates (gate back on -> flash off ->
        unbake) with a warning. verify_fidelity=False skips the probe
        (e.g. when the caller runs its own PSNR gate, as bench.py
        does)."""
        name = os.path.splitext(os.path.basename(path))[0]
        nerf = Testbed(name)
        nerf.load_snapshot(path)
        nerf.set_fov(45.0)
        nerf.camera_matrix = self.view_projection_mat.copy()
        if bake:
            nerf.bake(bake_resolution, feat_resolution=feat_resolution)
            nerf.flash = True
            if verify_fidelity:
                nerf.verify_bake_fidelity(threshold_db=verify_threshold_db)
        self._nerfs.append(nerf)
        return nerf

    def load_mesh(self, path: str, t=(0.0, 0.0, 0.0), s=(1.0, 1.0, 1.0),
                  r=(1.0, 0.0, 0.0, 0.0)) -> Optional[gltf_io.GltfScene]:
        """loadMesh (nerf_mesh_renderer.cu:941-965). `r` is a quaternion in
        (w, x, y, z) order, as passed by render.py (python_api.cu:288-293
        + the glm::quat construction at nerf_mesh_renderer.cu:954)."""
        try:
            mesh = gltf_io.load(path)
        except Exception as e:  # reference logs and returns nullptr
            import traceback
            traceback.print_exc()
            return None
        mesh.nodes[0].translation = np.asarray(t, np.float32)
        mesh.nodes[0].scale = np.asarray(s, np.float32)
        mesh.nodes[0].rotation = np.asarray(r, np.float32)
        self._meshes.append(mesh)
        self._rebuild_mesh_arrays()
        return mesh

    def _rebuild_mesh_arrays(self):
        self._mesh_arrays = tri_ops.build_mesh_arrays(self._meshes)

    def clear_meshes(self):
        self._meshes.clear()
        self._mesh_arrays = None

    def clear_nerfs(self):
        self._nerfs.clear()

    def envmap(self, path: str):
        """Set a lat-long environment map used as the render background.
        (render.py:228 calls this; the reference ships no binding — the
        capability is completed here. Mapping per latlong_to_dir,
        ngp_common.cuh:292-299.)"""
        from nerf_glasses_tpu.io.images import read_image
        self._envmap = (read_image(path, "RGB").astype(np.float32)
                        / 255.0)                          # sRGB

    # ------------------------------------------------------------------
    # Frame loop
    # ------------------------------------------------------------------

    def frame(self) -> bool:
        """Process one frame (nerf_mesh_renderer.cu:499-541). Returns True
        while the renderer is 'open' (headless: always, until close())."""
        if self._closed:
            return False
        t0 = time.monotonic()
        self.render_frame()
        dt_ms = (time.monotonic() - t0) * 1000.0
        self.render_ms.update(dt_ms)
        self.frame_ms.update(dt_ms)
        self._frame_count += 1
        self._fps_frames += 1
        now = time.monotonic()
        if now - self._fps_t0 >= 1.0:
            self.fps = self._fps_frames / (now - self._fps_t0)
            self._fps_frames = 0
            self._fps_t0 = now
        return True

    def close(self):
        self._closed = True

    def render_frame(self):
        """Fully device-resident: the mesh pass output feeds the march
        without touching the host; only display_image()/save_frame()
        fetch pixels."""
        w, h = self.render_width, self.render_height

        # 1+2: mesh pass -> per-pixel surface payloads
        t_mesh0 = time.monotonic() if self.profile else 0.0
        if self._mesh_arrays is not None and self._nerfs:
            f = self.mesh_render_size_factor
            xf, nm = tri_ops.instance_transforms(self._mesh_arrays,
                                                 self._meshes)
            surf_c, surf_t = tri_ops.render_mesh_surface(
                self._mesh_arrays, xf, nm, self.view_projection_mat,
                w, h, f, self.light_pos)
            self._nerfs[0].set_surface_buffers(
                surf_c.reshape(-1, 4), surf_t.reshape(-1), w, h)
            if self.profile:
                surf_t.block_until_ready()
        elif self._nerfs:
            self._nerfs[0].set_surface_buffers(None, None, w, h)
        if self.profile:
            self.mesh_ms.update((time.monotonic() - t_mesh0) * 1000.0)

        if not self._nerfs:
            self._frame_buffer = np.zeros((h, w, 4), np.float32)
            self._depth_buffer = np.zeros((h, w), np.float32)
            return

        # 3: render each NeRF with the shared camera
        buffers = []
        for nerf in self._nerfs:
            nerf.camera_matrix = self.view_projection_mat.copy()
            fb, db = nerf.render_frame_buffers(w, h,
                                               sample_index=nerf._spp)
            nerf._spp += 1
            buffers.append((fb, db))

        # 4: combine (first NeRF's buffers + nearest-depth merge of others;
        # combineBuffersKernel, nerf_mesh_renderer.cu:34-48)
        frame, depth = buffers[0]
        for fb, db in buffers[1:]:
            closer = db < depth
            frame = jnp.where(closer[..., None], fb, frame)
            depth = jnp.where(closer, db, depth)
        if self.profile:
            t_nerf0 = time.monotonic()
            frame.block_until_ready()
            self.nerf_ms.update((time.monotonic() - t_mesh0) * 1000.0
                                - self.mesh_ms.val)
            del t_nerf0
        self._frame_buffer = frame
        self._depth_buffer = depth

        # progressive accumulation of the merged frame. The sample index
        # is the first NeRF's pre-increment spp, which reset_accumulation
        # zeroes on camera movement — so the average restarts exactly
        # when the reference's render buffer would. Toggling the flag on
        # mid-session starts a fresh average (no blend into stale/zero
        # state).
        if self.progressive_accum and self._nerfs:
            spp = self._nerfs[0]._spp - 1
            if spp <= 0 or self._accum is None:
                spp = 0
            self._accum = accumulate(
                jnp.zeros_like(frame) if spp == 0 else self._accum,
                frame, spp, self._nerfs[0].color_space)
        else:
            self._accum = None

    def stats(self) -> dict:
        """Live render statistics — the headless analogue of the
        reference's ImGui stats panel (FPS / frame-ms / VRAM,
        nerf_mesh_renderer.cu:829-874). HBM numbers come from the jax
        device's allocator; per-phase mesh/nerf times populate when
        `renderer.profile = True`."""
        from nerf_glasses_tpu.utils.meters import device_memory_stats
        mem = device_memory_stats()
        return {
            "fps": self.fps,
            "frame_ms": self.frame_ms.ema_val,
            "mesh_ms": self.mesh_ms.ema_val,
            "nerf_ms": self.nerf_ms.ema_val,
            "hbm_available": mem["available"],
            "hbm_bytes_in_use": mem["bytes_in_use"],
            "hbm_bytes_limit": mem["bytes_limit"],
            "hbm_peak_bytes_in_use": mem["peak_bytes_in_use"],
            "n_nerfs": len(self._nerfs),
            "n_meshes": len(self._meshes),
            "frame_count": self._frame_count,
            # which march path the active NeRF's last render actually
            # took (flash / baked / unbaked, with fallback annotation)
            "render_path": (getattr(self._nerfs[0], "last_render_path",
                                    None) if self._nerfs else None),
        }

    # ------------------------------------------------------------------
    # Output access
    # ------------------------------------------------------------------

    def display_image(self, tonemap: bool = True) -> np.ndarray:
        """Tonemapped composited frame -> (H, W, 4) float sRGB."""
        if self._frame_buffer is None:
            self.render_frame()
        fb = jnp.asarray(self._accum if (self.progressive_accum
                                         and self._accum is not None)
                         else self._frame_buffer)
        nerf = self._nerfs[0] if self._nerfs else None
        bg = (nerf.background_color if nerf is not None
              else np.array([1.0, 1, 1, 1], np.float32))
        if self._envmap is not None:
            bg = self._background_from_envmap()
        out = tonemap_frame(fb, nerf.exposure if nerf else 0.0, bg,
                            nerf.color_space if nerf else "linear",
                            "srgb" if tonemap else "linear",
                            nerf.tonemap_curve if nerf else "identity")
        if self.visualize_depth and self._depth_buffer is not None:
            from nerf_glasses_tpu.ops.colormaps import overlay_depth
            out = overlay_depth(out, jnp.asarray(self._depth_buffer),
                                self.depth_overlay_alpha,
                                self.depth_overlay_scale,
                                self.depth_colormap)
        return np.asarray(out, np.float32)

    def _background_from_envmap(self) -> np.ndarray:
        """Per-pixel sRGB background sampled from the lat-long envmap."""
        from nerf_glasses_tpu.ops.raymarch import camera_rays
        _, d = camera_rays(self.view_projection_mat, self.render_width,
                           self.render_height)
        theta = np.arcsin(np.clip(d[:, 1], -1.0, 1.0))
        phi = np.arctan2(d[:, 0], d[:, 2])
        v = theta / np.pi + 0.5
        u = phi / (2 * np.pi) + 0.5
        eh, ew = self._envmap.shape[:2]
        xi = np.clip((u * ew).astype(int), 0, ew - 1)
        yi = np.clip(((1.0 - v) * eh).astype(int), 0, eh - 1)
        rgb = self._envmap[yi, xi]
        rgba = np.concatenate([rgb, np.ones((len(rgb), 1), np.float32)], -1)
        return rgba.reshape(self.render_height, self.render_width, 4)

    def save_frame(self, path: str):
        from nerf_glasses_tpu.io.images import write_image
        img = self.display_image()
        arr = np.clip(img[::-1, :, :3] * 255.0, 0, 255).astype(np.uint8)
        write_image(path, arr)

    # ------------------------------------------------------------------
    # Density-grid dump / load (nerf_mesh_renderer.cu:239-358)
    # ------------------------------------------------------------------

    def dump_density_grid(self, nerf_index: int = 0) -> np.ndarray:
        """-> (8, 128, 128, 128) uint8 0/1 in [mip, z, y, x] layout with x
        fastest — byte-identical to the reference dump file format
        (x + 128*(y + 128*(z + 128*mip))). Operates on the first (active)
        NeRF by default, as the reference does
        (nerf_mesh_renderer.cu:901-917)."""
        occ = np.asarray(self._nerfs[nerf_index].occ, np.uint8)
        return (occ > 0).astype(np.uint8)

    def load_density_grid_array(self, grid: np.ndarray,
                                nerf_index: int = 0):
        import jax.numpy as jnp_
        nerf = self._nerfs[nerf_index]
        nerf.occ = jnp_.asarray(
            (np.asarray(grid).reshape(8, 128, 128, 128) > 0)
            .astype(np.uint8))
        nerf._scene_cache = None

    def dump_density_grid_file(self, filename: str):
        with open(filename, "wb") as f:
            f.write(self.dump_density_grid().tobytes())

    def load_density_grid_file(self, filename: str):
        with open(filename, "rb") as f:
            data = np.frombuffer(f.read(), np.uint8)
        self.load_density_grid_array(data)

    # ------------------------------------------------------------------
    # Floaty removal (removeFloaties, nerf_mesh_renderer.cu:901-917)
    # ------------------------------------------------------------------

    def remove_floaties(self):
        from nerf_glasses_tpu.models.floaty import remove_floaties
        t0 = time.monotonic()
        grid = self.dump_density_grid()
        cleaned, n_clusters = remove_floaties(grid)
        self.load_density_grid_array(cleaned)
        dt = (time.monotonic() - t0) * 1000.0
        # the reference printf's the cluster count + elapsed; stderr so
        # bench.py's one-JSON-line stdout contract stays clean
        print(f"{n_clusters}   {dt:.3f} ms", file=sys.stderr)

    # ------------------------------------------------------------------
    # Collide: gravity-style settling of a mesh against the NeRF
    # (NerfMeshRenderer::collide, nerf_mesh_renderer.cu:1548-1786)
    # ------------------------------------------------------------------

    def collide(self, direction, node: gltf_io.GltfNode) -> bool:
        direction = np.asarray(direction, np.float32)
        vertices = node.vertices_facing_direction(-direction)
        if len(vertices) == 0:
            return False
        nerf = self._nerfs[0]
        xform = node.get_transform()
        world = vertices @ xform[:3, :3].T + xform[:3, 3]
        ngp_pts = world + 0.5  # renderer world -> NGP cube

        centroid_local = node.centroid()
        global_centroid = xform[:3, :3] @ centroid_local + xform[:3, 3]
        gc_xz = global_centroid[[0, 2]]

        # 0: which vertices already intersect the NeRF
        alphas = nerf.alpha_at(ngp_pts)
        inter = alphas > 0.0

        if not inter.any():
            # march all vertices along `direction` to first density hit
            dists = nerf.collide_distances(ngp_pts, direction)
            shortest = float(np.min(dists))
            node.translation = (node.translation
                                + direction * shortest).astype(np.float32)
            return False

        local_pts = vertices[inter]
        global_pts = world[inter]
        g_xz = global_pts[:, [0, 2]]

        if len(local_pts) >= 3:
            hull = _graham_scan(g_xz)
            if _point_inside_hull(hull, gc_xz):
                return True  # at rest

        # tip around one or two contact points
        d_c = np.linalg.norm(g_xz - gc_xz, axis=1)
        i0 = int(np.argmin(d_c))
        first_xz = g_xz[i0]
        t1 = local_pts[i0]

        t2 = None
        best_angle = 42.0
        for i in range(len(g_xz)):
            v = g_xz[i] - first_xz
            if np.linalg.norm(v) < 0.1:
                continue
            middle = (first_xz + g_xz[i]) / 2.0
            to_centroid = gc_xz - middle
            denom = np.linalg.norm(v) * np.linalg.norm(to_centroid)
            angle = np.arccos(np.clip(np.dot(v, to_centroid)
                                      / max(denom, 1e-12), -1, 1))
            diff = abs(angle - np.pi / 2)
            proj = np.dot(gc_xz - first_xz, v) / max(np.dot(v, v), 1e-12)
            between = 0 < proj < 1
            if not between and diff > np.pi / 4:
                continue
            if diff < best_angle:
                best_angle = diff
                t2 = local_pts[i]

        if t2 is None:
            axis = np.cross(_normalize(centroid_local - t1), direction)
            node.rotate_around_axis(_normalize(axis), t1, 0.5)
            return False

        axis = _normalize(t2 - t1)
        sgn = 1.0 if np.cross(_normalize(centroid_local - t1), axis)[1] > 0 \
            else -1.0
        node.rotate_around_axis(axis, t1, sgn * 0.5)
        return False

    # ------------------------------------------------------------------
    # Camera trajectory recorder (gui(), nerf_mesh_renderer.cu:630-660)
    # ------------------------------------------------------------------

    def record_trajectory(self, distance: float = 1.1, height: float = 0.1,
                          start_angle: float = 0.5, end_angle: float = 2.5,
                          num_images: int = 10, lookat=(0.0, 0.0, 0.0),
                          out_dir: str = "."):
        """Render frames along a circular path, writing trajectory_N.jpg
        plus transform_N camera files."""
        lookat = np.asarray(lookat, np.float32)
        angle = start_angle
        idx = 1
        while angle < end_angle:
            angle += (end_angle - start_angle) / num_images
            eye = np.array([np.cos(angle) * distance, height,
                            np.sin(angle) * distance], np.float32)
            look = _normalize(lookat - eye)
            self.camera.eye = eye
            self.camera.look = look
            self.update_model_view_proj()
            self.frame()
            self.save_frame(os.path.join(out_dir, f"trajectory_{idx}.jpg"))
            with open(os.path.join(out_dir, f"transform_{idx}"), "w") as f:
                rows = [
                    "[" + ", ".join(repr(float(v)) for v in row) + "]"
                    for row in self.view_projection_mat]
                f.write("[" + ",\n".join(rows) + "]")
            idx += 1

    # reference-name aliases (pynmr camelCase quirks)
    loadNerf = load_nerf
    loadMesh = load_mesh
    removeFloaties = remove_floaties
    updateModelViewProj = update_model_view_proj
    dumpDensityGrid = dump_density_grid


def _normalize(v):
    v = np.asarray(v, np.float64)
    return (v / max(np.linalg.norm(v), 1e-12)).astype(np.float32)


def _graham_scan(points_xz: np.ndarray) -> np.ndarray:
    """2D convex hull (the reference uses Graham scan,
    nerf_mesh_renderer.cu:1615-1635)."""
    pts = [tuple(p) for p in np.asarray(points_xz, np.float64)]
    pts = sorted(set(pts))
    if len(pts) <= 2:
        return np.asarray(pts)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper = []
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1])


def _point_inside_hull(hull: np.ndarray, point: np.ndarray) -> bool:
    """Same-side test (pointInsideHull, nerf_mesh_renderer.cu:1636-1652)."""
    n = len(hull)
    if n < 3:
        return False
    sign = 0.0
    for i in range(n):
        p1 = hull[i]
        p2 = hull[(i + 1) % n]
        edge = p2 - p1
        to_p = np.asarray(point) - p1
        c = edge[0] * to_p[1] - edge[1] * to_p[0]
        if c != 0:
            if sign == 0:
                sign = np.sign(c)
            elif np.sign(c) != sign:
                return False
    return True
