"""pynmr — drop-in compatible Python API (reference: src/python_api.cu).

The reference exposes a pybind11 module `pynmr`; this shim re-exports the
framework's objects under the same names so `volume/render.py` runs
unchanged:

    import pynmr as nmr
    renderer = nmr.NerfMeshRenderer(1280, 720)
    renderer.envmap("sky.png")          # provided here (the reference
                                        # script calls it but ships no
                                        # binding — SURVEY.md §2.2)
    nerf = renderer.load_nerf("nerf.msgpack")
    nerf.render_aabb.min = ...
    renderer.orbit(da, dp, dz)
    renderer.frame()
    im = nerf.render(W, H, linear=False)
    renderer.load_mesh(path, t=..., s=..., r=[w, x, y, z])
    renderer.remove_floaties()
"""

import enum

import numpy as np

from nerf_glasses_tpu.models.renderer import NerfMeshRenderer  # noqa: F401
from nerf_glasses_tpu.models.testbed import Testbed  # noqa: F401
from nerf_glasses_tpu.utils.bbox import BoundingBox  # noqa: F401
from nerf_glasses_tpu.io.gltf import (GltfNode, GltfScene,  # noqa: F401
                                      GltfMesh)
from nerf_glasses_tpu.io.dataset import NerfDataset  # noqa: F401


def free_temporary_memory():
    """tcnn::free_all_gpu_memory_arenas analogue: drop live jax buffers
    that are only reachable through caches."""
    import jax
    jax.clear_caches()


class LossType(enum.Enum):
    L2 = 0
    L1 = 1
    Mape = 2
    Smape = 3
    Huber = 4
    SmoothL1 = 4  # legacy alias
    LogL1 = 5
    RelativeL2 = 6


class NerfActivation(enum.Enum):
    Nothing = 0  # "None" in the reference enum
    ReLU = 1
    Logistic = 2
    Exponential = 3


class ColorSpace(enum.Enum):
    Linear = 0
    SRGB = 1


class TonemapCurve(enum.Enum):
    Identity = 0
    ACES = 1
    Hable = 2
    Reinhard = 3


class LensMode(enum.Enum):
    Perspective = 0
    OpenCV = 1
    FTheta = 2
    LatLong = 3


class GroundTruthRenderMode(enum.Enum):
    Shade = 0
    Depth = 1


def Vec3(x=0.0, y=0.0, z=0.0):
    return np.array([x, y, z], np.float32)
