"""Persistent XLA compilation cache setup.

The frame pipeline compiles to a large XLA program (8 pyramid levels x
FAST/BRIEF + matching + GN stages); a cold compile takes minutes.
Enabling JAX's persistent cache makes every process after the first
start fast. Call once, early, from every entry point.

Where the cache lives:
- ``JAX_COMPILATION_CACHE_DIR``, when set, exactly (JAX reads it too);
- otherwise the fixed directory ``<checkout>/.jax_cache`` (the path is
  part of what makes a later process find the entries again).
"""

from __future__ import annotations

import hashlib
import os
import platform

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def _host_fingerprint() -> str:
    """Key the CPU backend's cache by (jax version, machine, CPU flags).

    XLA:CPU caches compiled machine code specialized to the compiling
    host's CPU features; loading an entry produced on a host with
    different features can SIGILL (observed: '+prefer-no-scatter is not
    supported on the host machine' warnings followed by segfaults when a
    cache dir was reused across environments). A per-host subdirectory
    makes cross-host reuse structurally impossible.
    """
    import jax

    parts = [jax.__version__, platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags") or line.startswith("Features"):
                    parts.append(line.strip())
                    break
    except OSError:
        parts.append(platform.processor() or "unknown")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        if jax.default_backend() == "cpu":
            path = os.path.join(path, _host_fingerprint())
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
