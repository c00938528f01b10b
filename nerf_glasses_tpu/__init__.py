"""nerf_glasses_tpu — a JAX (XLA + Pallas) hybrid NeRF + mesh renderer.

A from-scratch re-design of the capabilities of arnerak/nerf-glasses
(CUDA/OptiX/tiny-cuda-nn) in JAX, run on an NVIDIA GPU:

- Instant-NGP hash-grid NeRF inference *and* training (JAX/XLA)
- glTF mesh ray-caster with PBR shading (tile-culled; a Pallas Triton
  kernel on the GPU replaces OptiX)
- depth-gated hybrid compositing (mesh surfaces occlude / are occluded by
  the volume at the correct depth)
- iNGP-compatible `.msgpack` snapshot load/save
- floaty removal (density-grid clustering)
- a `pynmr`-compatible Python API so the reference `volume/render.py`
  workflow runs unchanged.

Layout:
    ops/       pure functional compute (hash grid, SH, MLP, march,
               composite, triangle ray-cast) — jnp code + one Pallas kernel
    models/    stateful user-facing objects (Testbed, NerfMeshRenderer)
    io/        snapshot (MessagePack), glTF, images, NeRF dataset loaders
    train/     hash-grid NeRF training loop
    parallel/  multi-device sharding (jax.sharding.Mesh + shard_map)
    utils/     cameras, quaternions, glasses-placement math
"""

__version__ = "0.1.0"

import jax as _jax

# Full float32 for float32 matmuls. On the GPU, JAX's DEFAULT precision
# runs f32-operand matmuls in TF32 (~3 decimal digits of mantissa).
# Geometry matmuls (camera ray generation `ndc @ cam.T`, the render-aabb
# local transform `pos @ local.T`, per-image training-ray einsums,
# mesh-pass transforms) would then quantize ray directions/positions,
# which breaks the voxel DDA: rays die at sub-voxel positions and frames
# render as sparse speckle. Every heavy matmul in this package (the
# MLPs) passes bf16 operands explicitly and is unaffected by this
# setting; the f32 matmuls it upgrades are all tiny (Nx3 @ 3x3). Set it
# before any compute module is imported.
_jax.config.update("jax_default_matmul_precision", "float32")

from nerf_glasses_tpu.config import NGPConfig  # noqa: F401
