"""FullyFusedMLP-equivalent multi-layer perceptron.

tiny-cuda-nn's FullyFusedMLP (src/fully_fused_mlp.cu:636-687) has no biases;
each layer is y = act(W @ x) with W row-major (n_out, n_in) and half
precision weights. Here the whole batch is bf16 matmuls with fp32
accumulation, which XLA hands to the GPU's tensor cores.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp


def mlp_apply(x: jnp.ndarray, weights: Sequence[jnp.ndarray],
              activation: str = "relu", compute_dtype=jnp.bfloat16) -> jnp.ndarray:
    """x: (N, n_in) -> (N, n_out_padded). Hidden activation after every
    layer except the last (output_activation=None in all reference configs).
    """
    h = x.astype(compute_dtype)
    for w in weights[:-1]:
        h = jnp.dot(h, w.T.astype(compute_dtype),
                    preferred_element_type=jnp.float32)
        if activation == "relu":
            h = jnp.maximum(h, 0.0)
        elif activation != "none":
            raise ValueError(f"unsupported activation {activation!r}")
        h = h.astype(compute_dtype)
    out = jnp.dot(h, weights[-1].T.astype(compute_dtype),
                  preferred_element_type=jnp.float32)
    return out


def mlp_init(key, shapes, dtype=jnp.float32):
    """He/Xavier-style uniform init matching tcnn (common.h
    default_rng-based xavier uniform per weight matrix)."""
    import jax
    ws = []
    for i, (n_out, n_in) in enumerate(shapes):
        key, sub = jax.random.split(key)
        scale = jnp.sqrt(6.0 / (n_in + n_out))
        ws.append(jax.random.uniform(sub, (n_out, n_in), minval=-scale,
                                     maxval=scale, dtype=dtype))
    return tuple(ws)
