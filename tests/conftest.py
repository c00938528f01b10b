"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set XLA flags before jax initializes.
"""

import os

# CPU unless the caller picks a platform (the `gpu`-marked tests run on
# the card with JAX_PLATFORMS=cuda)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from nerf_glasses_tpu.utils.compile_cache import (  # noqa: E402
    configure_compile_cache)

jax.config.update("jax_enable_x64", False)

# Persistent compile cache for the CPU suite: the big 8-device SPMD
# training graphs (sharded compacted train_chunk) take minutes to
# compile on a small machine, and caching makes every graph a one-time
# cost per machine. Keyed by HLO hash, so staleness is safe.
configure_compile_cache(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "cache", "jaxcache-cpu"))
