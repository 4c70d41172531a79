"""Profiling helpers (SURVEY.md §5: the accelerator equivalent of the
reference's ticks/s meter plus proper tracing).

The reference's only profiling is the printed ticks/s with REALTIME
commented out (`pi_sph_fluid.c:10,680-687`).  Here:

* ``trace(path)`` — context manager around ``jax.profiler`` producing a
  TensorBoard/Perfetto trace of whatever runs inside;
* ``throughput(fn, state, *args)`` — wall-clock particle-steps/s of a
  compiled multi-step, warmed and block_until_ready'd correctly (the only
  honest way to time dispatches through the async runtime);
* ``device_memory()`` — live/peak device memory where the backend reports
  it;
* ``device_summary()`` — the device as JAX reports it plus the card's name
  and power limit from ``nvidia-smi`` (every timing is kept beside them).
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import jax

__all__ = ["trace", "throughput", "device_memory", "device_summary",
           "gpu_name_and_power_limit", "require_gpu"]


@contextlib.contextmanager
def trace(path: str = "/tmp/sph_trace"):
    """Capture a device trace viewable in TensorBoard or Perfetto."""
    jax.profiler.start_trace(path)
    try:
        yield path
    finally:
        jax.profiler.stop_trace()


def throughput(multi_step, sim, g_trace, n_particles: int, repeats: int = 3):
    """Median particle-steps/s of ``multi_step(sim, g_trace)``.

    Compiles/warms on the first call, then times ``repeats`` dispatches.
    Returns (particle_steps_per_s, seconds_per_step).
    """
    steps = g_trace.shape[0]
    sim, _ = multi_step(sim, g_trace)
    jax.block_until_ready(jax.tree_util.tree_leaves(sim)[0])
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        sim, _ = multi_step(sim, g_trace)
        jax.block_until_ready(jax.tree_util.tree_leaves(sim)[0])
        times.append(time.perf_counter() - t0)
    times.sort()
    t = times[len(times) // 2]
    return n_particles * steps / t, t / steps


def device_memory() -> dict:
    """Per-device memory stats (bytes) where the backend exposes them."""
    out = {}
    for d in jax.devices():
        stats = getattr(d, "memory_stats", lambda: None)()
        if stats:
            out[str(d)] = {
                "bytes_in_use": stats.get("bytes_in_use"),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                "bytes_limit": stats.get("bytes_limit"),
            }
    return out


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of the first card as nvidia-smi prints it
    ("not available" where there is no nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.strip().splitlines()[0] if out.strip() else "not available"


def device_summary() -> dict:
    """platform / device_kind / count as JAX reports them, and the card."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": gpu_name_and_power_limit()}


def require_gpu() -> None:
    """Exit nonzero unless JAX's default device is a GPU: a measurement
    never falls back to the CPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {platform!r}")
