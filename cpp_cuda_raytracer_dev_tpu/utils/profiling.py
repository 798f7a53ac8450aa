"""Tracing, timing, and per-frame metrics.

The reference's observability is QueryPerformanceCounter wall timers around
scene load / sort / KD build plus a per-frame FPS HUD redrawn with VT escape
codes (``TEST_Dungeonrun/WinMain.cpp:47-48,122-151,219-235``) and
``cuda_profiler_api.h`` included for Nsight traces (``Camera.cu:5-6``).
JAX equivalents (SURVEY.md §5):

- `trace(dir)` — context manager around `jax.profiler.trace`; produces a
  profiler trace of every XLA/Pallas kernel in the region.
- `Timer` — named wall-clock phase timers with a printable report (the
  "Time to Read Tree / sort / partition" block of WinMain.cpp:122-151).
- `FrameMetrics` / `metrics_line` — the per-frame HUD numbers (frame ms,
  FPS, rays/s) as structured data instead of printf.
- `call_times` — per-call seconds, each call fenced with
  `jax.block_until_ready` (so host dispatch is included).
- `gpu_cards` — each card's name and power limit, as nvidia-smi reports
  them, to print beside every GPU number.

All timers fence with `jax.block_until_ready` when handed device values, so
a timed region measures real device work, not only its dispatch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time
from typing import Any

import jax


@contextlib.contextmanager
def trace(log_dir: str = "raytracer_trace"):
    """Profile a region into an XProf/TensorBoard trace directory."""
    with jax.profiler.trace(log_dir):
        yield log_dir


class Timer:
    """Named phase timers: ``with timer.phase("kd build"): ...``."""

    def __init__(self) -> None:
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, fence: Any = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                jax.block_until_ready(fence)
            self.phases[name] = (time.perf_counter() - t0
                                 + self.phases.get(name, 0.0))

    def report(self) -> str:
        width = max((len(k) for k in self.phases), default=0)
        return "\n".join(f"{k:<{width}}  {v * 1e3:10.2f} ms"
                         for k, v in self.phases.items())


@dataclasses.dataclass
class FrameMetrics:
    """Per-frame numbers the reference prints in its HUD
    (WinMain.cpp:226-234)."""

    frame_ms: float
    num_rays: int
    hit_rate: float = float("nan")

    @property
    def fps(self) -> float:
        return 1e3 / self.frame_ms if self.frame_ms > 0 else float("inf")

    @property
    def rays_per_sec(self) -> float:
        return self.num_rays / (self.frame_ms * 1e-3)


def metrics_line(m: FrameMetrics) -> str:
    return (f"{m.frame_ms:8.2f} ms  {m.fps:8.1f} FPS  "
            f"{m.rays_per_sec:.3e} rays/s  hit={m.hit_rate:.3f}")


def call_times(fn, *args, n: int = 5) -> list[float]:
    """Seconds of each of ``n`` calls, each fenced with
    `jax.block_until_ready` (call after warming up ``fn``: the first call
    compiles)."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def gpu_cards() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`:
    one line per card. A card set below its maximum power runs slower under
    load, so the limit goes beside every number taken on it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
