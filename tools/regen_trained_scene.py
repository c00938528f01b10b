"""Regenerate the trained-scene bench snapshot cache (bench_scene
SCENE_VERSION) and print the trained-content metrics — run after any
bench_scene change so the next bench.py run starts warm.

    python tools/regen_trained_scene.py
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nerf_glasses_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache(os.path.join(ROOT, "assets", "cache", "jaxcache"))

import bench  # noqa: E402

out, picked, snap, _tb = bench.trained_holdout_and_bundle(n_views=4)
out["picked_bundle"] = picked[0]
print(json.dumps(out, indent=1), flush=True)
