"""chip_smoke.py: refuses to run without a GPU, and its phases rehearse
on the CPU at tiny sizes (control flow and checks; the thresholds that
need the product's sizes are relaxed to what those sizes can reach)."""

import functools
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from nerf_glasses_tpu.ops import mesh_pallas as mp  # noqa: E402

SMALL_GLASSES = dict(rim_segments=16, ring=4, temple_segments=6,
                     bridge_segments=4)


def _run(script, cwd, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, script], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    assert proc.returncode != 0, proc.stdout
    assert '"ok": true' not in proc.stdout


def test_exits_nonzero_without_gpu():
    proc = _run("chip_smoke.py", ROOT)
    _no_result(proc)
    assert "needs an NVIDIA GPU" in proc.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    _no_result(_run("chip_smoke.py", str(tmp_path),
                    PYTHONPATH=str(tmp_path)))


@pytest.mark.parametrize("phase", ["device", "kernel", "render", "train"])
def test_phase_rehearsal_on_cpu(phase):
    if phase == "device":
        info = chip_smoke.phase_device(require_gpu=False)
        assert info["platform"] == "cpu" and info["count"] >= 1
        with pytest.raises(SystemExit):
            chip_smoke.phase_device()
    elif phase == "kernel":
        out = chip_smoke.phase_kernel(
            256, 128, glasses_kw=SMALL_GLASSES,
            raycast=functools.partial(mp.raycast_tiled, interpret=True))
        assert out["hits"] > 0 and out["id_agree"] >= 0.9999
    elif phase == "render":
        out = chip_smoke.phase_render(
            160, 90, bake_res=64, feat_res=32, holdout_res=64, n_frames=2,
            glasses_kw=SMALL_GLASSES, min_flash_db=25.0,
            min_holdout_db=28.0, budget_db=6.0)
        assert out["behind_head_px"] > 0 and out["in_front_px"] > 0
        assert out["render_path"] == "flash"
    else:
        out = chip_smoke.phase_train(
            8, 4, capture_views=4, capture_res=48,
            options=dict(rays_per_batch=256, samples_per_ray=16,
                         grid_samples_per_update=4096))
        assert out["compaction_active"]
    json.dumps(out if phase != "device" else info)   # printable numbers


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(tmp_path, env_set):
    """$JAX_COMPILATION_CACHE_DIR wins and nothing else is set in code;
    without it the fixed default directory is used."""
    default = tmp_path / "default"
    chosen = tmp_path / "from_env"
    code = ("import jax; from nerf_glasses_tpu.utils.compile_cache import "
            "configure_compile_cache as c; "
            f"p = c({str(default)!r}); "
            "print(p); print(jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(chosen)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    want = str(chosen if env_set else default)
    assert out == [want, want]
    assert default.exists() != env_set


def test_kernel_phase_rejects_a_wrong_raycast():
    """A ray-cast that names the wrong triangle fails the phase."""
    from nerf_glasses_tpu.ops import triangles as tri_ops

    def off_by_one(*args):
        t, idx, u, v = tri_ops.raycast_tiled_reference(*args)
        return t, idx + (idx >= 0), u, v

    with pytest.raises(RuntimeError, match="triangle ids agree"):
        chip_smoke.phase_kernel(128, 64, glasses_kw=SMALL_GLASSES,
                                raycast=off_by_one)
