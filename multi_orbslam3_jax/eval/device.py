"""Which device a measurement ran on.

Every timed result names its device; a measurement that finds no GPU
fails instead of reporting CPU numbers under a device's name.
"""

from __future__ import annotations

import glob
import os
import subprocess
import tempfile
from typing import Dict, List, Optional


def require_gpu() -> Dict:
    """Return ``describe()`` of the JAX devices; exit non-zero unless the
    first one is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU; JAX found platform "
                         f"{dev.platform!r} ({dev.device_kind})")
    return describe()


def describe() -> Dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def parse_cards(text: str) -> List[Dict[str, str]]:
    """Parse ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` output into one dict per card."""
    cards = []
    for line in text.strip().splitlines():
        name, _, limit = line.rpartition(",")
        if name:
            cards.append({"name": name.strip(), "power_limit": limit.strip()})
    return cards


def query_cards() -> str:
    """The cards' names and power limits as nvidia-smi prints them (a
    child process, so the caller's JAX state is untouched)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def device_busy_ms(fn, *args, reps: int = 20) -> Optional[float]:
    """Device time of one ``fn(*args)`` call, from a profiler trace of
    ``reps`` calls after a warm-up: the union of every operation's
    interval on GPU 0, divided by ``reps``. None when the trace holds no
    GPU plane."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        jax.profiler.stop_trace()
        paths = glob.glob(os.path.join(d, "plugins", "profile", "*",
                                       "*.xplane.pb"))
        intervals = []
        for plane in ProfileData.from_file(paths[0]).planes:
            if plane.name.startswith("/device:GPU:0"):
                for line in plane.lines:
                    intervals += [(e.start_ns, e.start_ns + e.duration_ns)
                                  for e in line.events]
    if not intervals:
        return None
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / reps / 1e6


def peak_bytes(device_index: int = 0) -> int:
    """Peak bytes the process's arrays have held on that device so far."""
    import jax

    stats = jax.local_devices()[device_index].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))
