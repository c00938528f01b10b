"""The fast native config (all_hash uniform pow2 tables, L8xF4) must
train as well as the tcnn-layout config and round-trip snapshots."""

import numpy as np
import pytest

from nerf_glasses_tpu.config import NGPConfig
from nerf_glasses_tpu.train.trainer import TrainOptions, Trainer
from tests.test_training import make_synth_dataset


def _train(cfg, steps=200):
    opts = TrainOptions(config=cfg, rays_per_batch=1024, samples_per_ray=64,
                        grid_samples_per_update=1 << 15,
                        compute_dtype="float32")
    tr = Trainer(make_synth_dataset(), opts)
    tr.occ_warmup_steps = 64
    tr.train(steps)
    return tr


TCNN_CFG = NGPConfig(n_levels=8, log2_hashmap_size=13, base_resolution=16,
                     per_level_scale=1.61)
NATIVE_CFG = NGPConfig(n_levels=8, n_features_per_level=2,
                       log2_hashmap_size=13, base_resolution=16,
                       per_level_scale=1.61, all_hash=True)


@pytest.mark.slow
def test_native_config_trains_comparably():
    t_ref = _train(TCNN_CFG)
    t_nat = _train(NATIVE_CFG)
    ema_ref = float(t_ref.state["loss_ema"])
    ema_nat = float(t_nat.state["loss_ema"])
    assert np.isfinite(ema_nat)
    # within 2x of the tcnn-layout loss (they differ only in coarse-level
    # indexing: hashed instead of dense)
    assert ema_nat < max(ema_ref * 2.0, 0.02)


def test_native_snapshot_roundtrip(tmp_path):
    tr = _train(NATIVE_CFG, steps=50)
    snap = str(tmp_path / "native.msgpack")
    tr.save_snapshot(snap)
    from nerf_glasses_tpu.models.testbed import Testbed
    tb = Testbed()
    tb.load_snapshot(snap)
    assert tb.config.all_hash            # "hash": "UniformPow2" round-trips
    assert tb.config.n_levels == 8
    # density queries agree between trainer state and reloaded snapshot
    pts = np.random.default_rng(0).uniform(0.3, 0.7, (64, 3))
    d1 = tr.to_testbed().density_at(pts)
    d2 = tb.density_at(pts)
    np.testing.assert_allclose(d1, d2, rtol=0.05, atol=0.5)  # fp16 params


def test_native_fast_factory():
    cfg = NGPConfig.native_fast()
    assert cfg.all_hash and cfg.n_levels == 8
    assert cfg.n_features_per_level == 4
    assert cfg.n_pos_features == 32          # same MLP input width
    lp = cfg.level_params()
    assert all(size == 1 << 15 for _, size, _ in lp)