"""Model configuration for the Instant-NGP NeRF network.

The configuration mirrors the snapshot's embedded network config sections
(`encoding` / `dir_encoding` / `network` / `rgb_network`) as consumed by
`Testbed::reset_network` (reference: src/ngp/testbed.cu:1137-1304) and the
tiny-cuda-nn component constructors it instantiates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from nerf_glasses_tpu import constants


def per_level_scale_for(aabb_scale: int, n_levels: int = 16, base_resolution: int = 16,
                        desired_resolution: float = 2048.0) -> float:
    """Automatic per-level scale (testbed.cu:1197-1204)."""
    return math.exp(
        math.log(desired_resolution * float(aabb_scale) / float(base_resolution))
        / (n_levels - 1)
    )


def grid_scale(level: int, log2_per_level_scale: float, base_resolution: int) -> float:
    """Grid vertex scale of a level (tiny-cuda-nn grid.h:194-198).

    The -1 makes `base_resolution` count grid *vertices* rather than cells.
    """
    return float(np.exp2(level * log2_per_level_scale) * base_resolution - 1.0)


def grid_resolution(scale: float) -> int:
    """(tiny-cuda-nn grid.h:201-203)"""
    return int(np.ceil(scale)) + 1


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class NGPConfig:
    """Flagship NeRF model configuration (iNGP defaults).

    Defaults follow the reference default network config
    (testbed.cu:68-94) combined with the standard instant-ngp snapshot
    layout (density MLP: 1 hidden layer, rgb MLP: 2 hidden layers).
    """

    # Hash-grid position encoding.
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = per_level_scale_for(1)

    # Direction encoding: spherical harmonics.
    sh_degree: int = 4

    # MLPs (FullyFusedMLP semantics: no biases, 16-aligned padded widths).
    density_neurons: int = 64
    density_hidden_layers: int = 1
    density_out: int = 16           # padded output width of the density MLP
    rgb_neurons: int = 64
    rgb_hidden_layers: int = 2
    rgb_out_padded: int = 16        # 3 rgb channels padded to 16

    # Scene
    aabb_scale: int = 1

    # Per-image learnable latent codes appended to the rgb network input
    # (upstream's n_extra_learnable_dims, testbed.cu:1614-1631
    # get_inference_extra_dims; the latents themselves are trained as an
    # aux model in train/trainer.py).
    n_extra_learnable_dims: int = 0

    # Fast variant: every level is a power-of-2 hash table of the same
    # size (coarse levels included). Constant table stride and a
    # constant AND-mask make the whole encode one uniform gather per
    # level (and a fused encode kernel straightforward). Snapshots written
    # with this variant carry {"hash": "UniformPow2"} in their encoding
    # config; tcnn-compatible snapshots (all_hash=False) use the exact
    # dense-or-hash offset table.
    all_hash: bool = False

    # Wide-row table layout: each table row is padded to 128 floats
    # (512B). Hypothesis: a row gather that moves one aligned 512-byte
    # row per lookup beats narrow-row gathers by more than the padding
    # costs, while leaving room for wider features (not measured on the
    # GPU). Storage only — snapshots keep the compact F features per
    # row. Requires all_hash.
    wide_rows: bool = False

    # Activations applied *outside* the MLPs (testbed.cu:325-345).
    density_activation: str = "exponential"
    rgb_activation: str = "logistic"        # "exponential" for HDR datasets

    # -- derived ---------------------------------------------------------
    @property
    def log2_per_level_scale(self) -> float:
        return math.log2(self.per_level_scale)

    @property
    def n_pos_features(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def sh_out_padded(self) -> int:
        # SH deg 4 -> 16 outputs, padded to the rgb net's 16-alignment.
        return _next_multiple(self.sh_degree * self.sh_degree, 16)

    @property
    def rgb_in_width(self) -> int:
        # next_multiple(dir_padded + density_padded, 16) (nerf_network.cuh:91)
        return _next_multiple(self.sh_out_padded + self.density_out
                              + self.n_extra_learnable_dims, 16)

    @property
    def max_cascade(self) -> int:
        c = 0
        while (1 << c) < self.aabb_scale:
            c += 1
        return c

    @property
    def cone_angle_constant(self) -> float:
        # testbed.cu:1115
        return 0.0 if self.aabb_scale <= 1 else 1.0 / 256.0

    def level_params(self) -> Tuple[Tuple[int, int, int], ...]:
        """Per level: (offset, hashmap_size, resolution), offsets in feature
        *rows* (multiply by n_features_per_level for scalar param offsets).

        Mirrors GridEncodingTemplated's offset table construction
        (tiny-cuda-nn grid.h:985-1018).
        """
        out = []
        offset = 0
        for lvl in range(self.n_levels):
            res = grid_resolution(grid_scale(lvl, self.log2_per_level_scale,
                                             self.base_resolution))
            if self.all_hash:
                params_in_level = 1 << self.log2_hashmap_size
            else:
                dense = res ** 3
                max_params = (2 ** 31)  # uint32 max / 2
                params_in_level = min(dense, max_params)
                params_in_level = _next_multiple(params_in_level, 8)
                params_in_level = min(params_in_level,
                                      1 << self.log2_hashmap_size)
            out.append((offset, params_in_level, res))
            offset += params_in_level
        return tuple(out)

    @property
    def n_grid_rows(self) -> int:
        lp = self.level_params()
        return lp[-1][0] + lp[-1][1]

    @property
    def n_grid_params(self) -> int:
        return self.n_grid_rows * self.n_features_per_level

    def mlp_shapes(self) -> Tuple[Tuple[Tuple[int, int], ...], Tuple[Tuple[int, int], ...]]:
        """Weight matrix shapes ([n_out, n_in], row-major) for the density and
        rgb MLPs, in serialization order (fully_fused_mlp.cu:636-687)."""
        d = [(self.density_neurons, self.n_pos_features)]
        for _ in range(self.density_hidden_layers - 1):
            d.append((self.density_neurons, self.density_neurons))
        d.append((self.density_out, self.density_neurons))

        r = [(self.rgb_neurons, self.rgb_in_width)]
        for _ in range(self.rgb_hidden_layers - 1):
            r.append((self.rgb_neurons, self.rgb_neurons))
        r.append((self.rgb_out_padded, self.rgb_neurons))
        return tuple(d), tuple(r)

    @property
    def n_params(self) -> int:
        d, r = self.mlp_shapes()
        n = sum(a * b for a, b in d) + sum(a * b for a, b in r)
        return n + self.n_grid_params

    # -- config json (snapshot sections) ---------------------------------
    def to_snapshot_config(self) -> dict:
        return {
            "encoding": {
                "otype": "HashGrid",
                "n_levels": self.n_levels,
                "n_features_per_level": self.n_features_per_level,
                "log2_hashmap_size": self.log2_hashmap_size,
                "base_resolution": self.base_resolution,
                "per_level_scale": self.per_level_scale,
                "n_pos_dims": 3,
                "interpolation": "Linear",
                **({"hash": "UniformPow2"} if self.all_hash else {}),
                **({"wide_rows": True} if self.wide_rows else {}),
            },
            "dir_encoding": {"otype": "SphericalHarmonics", "degree": self.sh_degree},
            "network": {
                "otype": "FullyFusedMLP",
                "n_neurons": self.density_neurons,
                "n_hidden_layers": self.density_hidden_layers,
                "activation": "ReLU",
                "output_activation": "None",
            },
            "rgb_network": {
                "otype": "FullyFusedMLP",
                "n_neurons": self.rgb_neurons,
                "n_hidden_layers": self.rgb_hidden_layers,
                "activation": "ReLU",
                "output_activation": "None",
            },
            "loss": {"otype": "L2"},
            **({"n_extra_learnable_dims": self.n_extra_learnable_dims}
               if self.n_extra_learnable_dims else {}),
            "optimizer": {
                "otype": "Adam",
                "learning_rate": 1e-3,
                "beta1": 0.9,
                "beta2": 0.99,
                "epsilon": 1e-15,
                "l2_reg": 1e-6,
            },
        }

    @staticmethod
    def native_fast(aabb_scale: int = 1) -> "NGPConfig":
        """Fast variant: 8 levels x 4 features (same 32-wide MLP input as
        the reference's 16x2) with uniform power-of-2 hash tables. Halves
        the gather count per sample — random gathers being the renderer's
        expected dominant cost — at near-equal quality (iNGP Tab. 2 shows
        (L, F) = (8, 4) within ~0.1-0.3 dB of (16, 2) at equal params)."""
        import math as _math
        return NGPConfig(
            n_levels=8,
            n_features_per_level=4,
            log2_hashmap_size=15,
            base_resolution=16,
            per_level_scale=_math.exp(
                _math.log(2048.0 * aabb_scale / 16.0) / 7.0),
            aabb_scale=aabb_scale,
            all_hash=True,
        )

    @staticmethod
    def native_wide(aabb_scale: int = 1) -> "NGPConfig":
        """Wide variant: 8 levels x 16 features stored in 128-float
        (512B) table rows. Same gather count as native_fast, each gather
        moving one aligned wide row, and 4x the features per level for
        quality."""
        import math as _math
        return NGPConfig(
            n_levels=8,
            n_features_per_level=16,
            log2_hashmap_size=15,
            base_resolution=16,
            per_level_scale=_math.exp(
                _math.log(2048.0 * aabb_scale / 16.0) / 7.0),
            aabb_scale=aabb_scale,
            all_hash=True,
            wide_rows=True,
        )

    @staticmethod
    def from_snapshot_config(cfg: dict, aabb_scale: int, is_hdr: bool = False) -> "NGPConfig":
        enc = cfg.get("encoding", {})
        net = cfg.get("network", {})
        rgb = cfg.get("rgb_network", {})
        dir_enc = cfg.get("dir_encoding", {})
        n_levels = int(enc.get("n_levels", 16))
        base_res = int(enc.get("base_resolution", 16))
        pls = float(enc.get("per_level_scale", 0.0))
        if pls <= 0.0:
            pls = per_level_scale_for(aabb_scale, n_levels, base_res)
        return NGPConfig(
            n_levels=n_levels,
            n_features_per_level=int(enc.get("n_features_per_level", 2)),
            log2_hashmap_size=int(enc.get("log2_hashmap_size", 19)),
            base_resolution=base_res,
            per_level_scale=pls,
            all_hash=enc.get("hash", "CoherentPrime") == "UniformPow2",
            wide_rows=bool(enc.get("wide_rows", False)),
            sh_degree=int(dir_enc.get("degree", 4)),
            density_neurons=int(net.get("n_neurons", 64)),
            density_hidden_layers=int(net.get("n_hidden_layers", 1)),
            rgb_neurons=int(rgb.get("n_neurons", 64)),
            rgb_hidden_layers=int(rgb.get("n_hidden_layers", 2)),
            aabb_scale=int(aabb_scale),
            n_extra_learnable_dims=int(cfg.get("n_extra_learnable_dims", 0)),
            density_activation="exponential",
            rgb_activation="exponential" if is_hdr else "logistic",
        )
