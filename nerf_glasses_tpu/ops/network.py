"""Composite NeRF network: hash-grid -> density MLP, SH -> rgb MLP.

Functional re-design of NerfNetwork<T>
(reference: src/ngp/nerf_network.cuh:75-135):

    density path: pos(3) --HashGrid(32)--> density MLP (64x1 hidden -> 16)
    color path:   [density_out(16), SH(dir)(16)] -> rgb MLP (64x2 -> 16)
    outputs:      rgb = rgb_out[:, :3] (pre-activation),
                  sigma = density_out[:, 0] (pre-activation)
                  (extract_density, nerf_network.cuh:128-134)

Params are a pytree dict; pack/unpack to the tcnn fp16 serialization order
density-MLP -> rgb-MLP -> hash-grid -> dir-encoding
(nerf_network.cuh:359-392) lives here for snapshot compatibility.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nerf_glasses_tpu.config import NGPConfig
from nerf_glasses_tpu.ops.hashgrid import (hash_encode, hash_encode_soa,
                                           hash_table_init)
from nerf_glasses_tpu.ops.mlp import mlp_apply, mlp_init
from nerf_glasses_tpu.ops.sh import sh_encode, sh_encode_soa

Params = Dict[str, object]


def init_params(key, config: NGPConfig, dtype=jnp.float32) -> Params:
    kd, kr, kg = jax.random.split(key, 3)
    d_shapes, r_shapes = config.mlp_shapes()
    return {
        "density_mlp": mlp_init(kd, d_shapes, dtype),
        "rgb_mlp": mlp_init(kr, r_shapes, dtype),
        "grid": hash_table_init(kg, config, dtype),
    }


def density_raw_soa(params: Params, px, py, pz, config: NGPConfig,
                    compute_dtype=jnp.bfloat16,
                    encode_dtype=jnp.float32) -> jnp.ndarray:
    """px/py/pz (N,) components in [0,1] -> density MLP output (N, 16).

    encode_dtype is the hash encode's trilinear-sum dtype. It defaults
    to float32 for exactness-sensitive callers (render fidelity
    probes); the TRAINER passes bfloat16 (TrainOptions.encode_dtype) —
    the f32 weighted sum over (N, 8, W) gathered rows is a large share
    of density_fwd at the training batch shape, and tcnn's hash tables
    are natively fp16, so bf16 interpolation is the reference's own
    precision class."""
    enc = hash_encode_soa(params["grid"], px, py, pz, config,
                          compute_dtype=encode_dtype)
    return mlp_apply(enc, params["density_mlp"], compute_dtype=compute_dtype)


def density_raw(params: Params, pos01: jnp.ndarray, config: NGPConfig,
                compute_dtype=jnp.bfloat16,
                encode_dtype=jnp.float32) -> jnp.ndarray:
    """pos01 (N,3) in [0,1] -> density MLP output (N, 16); sigma = [:, 0].

    Matches NerfNetwork::density (nerf_network.cuh:266-282).
    """
    return density_raw_soa(params, pos01[..., 0], pos01[..., 1],
                           pos01[..., 2], config, compute_dtype,
                           encode_dtype)


def apply_network_soa(params: Params, px, py, pz, dx, dy, dz,
                      config: NGPConfig, compute_dtype=jnp.bfloat16,
                      extra: jnp.ndarray = None,
                      encode_dtype=jnp.float32
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Component-array variant of apply_network (SoA hot path):
    px/py/pz (N,) in [0,1], dx/dy/dz (N,) warped directions in [0,1]
    -> (rgb_raw (N,3), sigma_raw (N,))."""
    d_out = density_raw_soa(params, px, py, pz, config, compute_dtype,
                            encode_dtype)
    rgb_out = _rgb_head(params, d_out, dx, dy, dz, config, compute_dtype,
                        extra)
    return rgb_out[..., :3].astype(jnp.float32), d_out[..., 0].astype(jnp.float32)


def _rgb_head(params: Params, d_out, dx, dy, dz, config: NGPConfig,
              compute_dtype=jnp.bfloat16, extra: jnp.ndarray = None):
    """[density-MLP output (N,16), SH(dir), extra dims, pad] -> rgb MLP
    output (N, >=3) — the color half of NerfNetwork::inference
    (nerf_network.cuh:75-135), callable on baked features too."""
    sh = sh_encode_soa(dx, dy, dz, config.sh_degree, config.sh_out_padded)
    parts = [d_out.astype(compute_dtype), sh.astype(compute_dtype)]
    E = config.n_extra_learnable_dims
    n = dx.shape[0]
    if E:
        if extra is None:
            extra = jnp.zeros((n, E))
        extra = jnp.broadcast_to(jnp.atleast_2d(extra), (n, E))
        parts.append(extra.astype(compute_dtype))
    width = sum(p.shape[-1] for p in parts)
    if width < config.rgb_in_width:
        parts.append(jnp.zeros((n, config.rgb_in_width - width),
                               compute_dtype))
    rgb_in = jnp.concatenate(parts, axis=-1)
    return mlp_apply(rgb_in, params["rgb_mlp"], compute_dtype=compute_dtype)


def rgb_from_features(params: Params, feat: jnp.ndarray, dir01: jnp.ndarray,
                      config: NGPConfig, compute_dtype=jnp.bfloat16,
                      extra: jnp.ndarray = None) -> jnp.ndarray:
    """rgb_raw (N, 3) from PRE-COMPUTED density-MLP features (N, 16) —
    the deferred-shade fast path over a baked feature grid
    (ops/bake.py:bake_grids): no hash encode, no density MLP."""
    rgb_out = _rgb_head(params, feat, dir01[..., 0], dir01[..., 1],
                        dir01[..., 2], config, compute_dtype, extra)
    return rgb_out[..., :3].astype(jnp.float32)


def apply_network(params: Params, pos01: jnp.ndarray, dir01: jnp.ndarray,
                  config: NGPConfig, compute_dtype=jnp.bfloat16,
                  extra: jnp.ndarray = None, encode_dtype=jnp.float32
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """-> (rgb_raw (N,3), sigma_raw (N,)), both pre-activation fp32.

    `extra` ((N,E) or (E,)) are the per-image learnable latent codes
    appended to the rgb input when config.n_extra_learnable_dims > 0
    (upstream's extra-dims path, testbed.cu:1614-1631); zeros when
    omitted.
    """
    return apply_network_soa(
        params, pos01[..., 0], pos01[..., 1], pos01[..., 2],
        dir01[..., 0], dir01[..., 1], dir01[..., 2], config,
        compute_dtype, extra, encode_dtype)


# ---------------------------------------------------------------------------
# Activations (testbed.cu:325-345)
# ---------------------------------------------------------------------------

def apply_density_activation(x, kind: str):
    if kind == "none":
        return x
    if kind == "relu":
        return jnp.maximum(x, 0.0)
    if kind == "logistic":
        return jax.nn.sigmoid(x)
    if kind == "exponential":
        return jnp.exp(x)
    raise ValueError(kind)


def apply_rgb_activation(x, kind: str):
    if kind == "exponential":
        return jnp.exp(jnp.clip(x, -10.0, 10.0))
    return apply_density_activation(x, kind)


# ---------------------------------------------------------------------------
# Snapshot (de)serialization: tcnn params_binary layout
# ---------------------------------------------------------------------------

def pack_params(params: Params, config: NGPConfig) -> np.ndarray:
    """Flatten to the fp16 blob order of NerfNetwork::set_params."""
    from nerf_glasses_tpu.ops.hashgrid import table_to_tcnn
    parts = []
    for w in params["density_mlp"]:
        parts.append(np.asarray(w, dtype=np.float32).reshape(-1))
    for w in params["rgb_mlp"]:
        parts.append(np.asarray(w, dtype=np.float32).reshape(-1))
    parts.append(table_to_tcnn(
        np.asarray(params["grid"], dtype=np.float32), config))
    flat = np.concatenate(parts)
    assert flat.size == config.n_params, (flat.size, config.n_params)
    return flat.astype(np.float16)


def unpack_params(blob: np.ndarray, config: NGPConfig, dtype=jnp.float32) -> Params:
    """Inverse of pack_params; blob is the fp16 (or fp32) params array."""
    flat = np.asarray(blob, dtype=np.float32)
    if flat.size != config.n_params:
        raise ValueError(
            f"params_binary has {flat.size} params, expected {config.n_params}")
    d_shapes, r_shapes = config.mlp_shapes()
    off = 0

    def take(shape):
        nonlocal off
        n = int(np.prod(shape))
        out = flat[off:off + n].reshape(shape)
        off += n
        return jnp.asarray(out, dtype=dtype)

    density = tuple(take(s) for s in d_shapes)
    rgb = tuple(take(s) for s in r_shapes)
    from nerf_glasses_tpu.ops.hashgrid import table_from_tcnn
    grid_flat = flat[off:off + config.n_grid_params]
    grid = jnp.asarray(table_from_tcnn(grid_flat, config), dtype=dtype)
    return {"density_mlp": density, "rgb_mlp": rgb, "grid": grid}
