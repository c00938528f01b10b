"""Time/step EMA meters (reference: Ema, ngp_common.cuh:401-446)."""

from __future__ import annotations

import time


class Ema:
    """Exponentially-decayed meter; half_life in ms (time mode) or steps."""

    TIME = "time"
    STEP = "step"

    def __init__(self, mode: str = "time", half_life: float = 1000.0):
        self.mode = mode
        self.decay = 0.5 ** (1.0 / half_life)
        self._t0 = time.monotonic()
        self._last_progress = 0
        self._val = 0.0
        self._ema = 0.0

    def _progress(self):
        if self.mode == Ema.TIME:
            return int((time.monotonic() - self._t0) * 1000.0)
        return self._last_progress + 1

    def update(self, val: float):
        cur = self._progress()
        elapsed = cur - self._last_progress
        self._last_progress = cur
        d = self.decay ** elapsed
        self._val = val
        self._ema = d * self._ema + (1.0 - d) * val

    def set(self, val: float):
        self._last_progress = self._progress()
        self._val = self._ema = val

    @property
    def val(self) -> float:
        return self._val

    @property
    def ema_val(self) -> float:
        return self._ema


def device_memory_stats(device=None) -> dict:
    """HBM usage of a jax device -> {"bytes_in_use", "bytes_limit",
    "peak_bytes_in_use", "available": bool}.

    The cudaMemGetInfo/VRAM-stats analogue of the reference's stats
    panel (nerf_mesh_renderer.cu:852-873). Backends that expose no
    allocator stats get `available` False and None byte fields rather
    than silent zeros."""
    import jax
    if device is None:
        device = jax.local_devices()[0]
    try:
        raw = device.memory_stats() or {}
    except Exception:
        raw = {}
    available = bool(raw) and any(
        raw.get(k) for k in ("bytes_in_use", "bytes_limit",
                             "peak_bytes_in_use"))
    stats = {"available": available}
    for k in ("bytes_in_use", "bytes_limit", "peak_bytes_in_use"):
        stats[k] = int(raw[k]) if available and k in raw else None
    return stats


def card_line() -> str:
    """`name, power.limit` of the first NVIDIA card, as nvidia-smi reports
    it — printed beside every device number, since a card set below its
    power limit runs slower under load."""
    import subprocess
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
