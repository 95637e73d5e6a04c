"""CLI helpers: SI-suffixed counts and a device banner.

The reference prints a CPU-feature banner and parses counts like "1M"
(src/main.rs:96, 168-176); here the banner reports the JAX backend and devices.
"""

from __future__ import annotations

import os

_SI = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12}


def parse_si(s: str) -> int:
    """Parse '1M', '100k', '3000000' into an int."""
    s = s.strip()
    if s and s[-1] in _SI:
        return int(float(s[:-1]) * _SI[s[-1]])
    return int(s)


def device_banner() -> str:
    import jax

    devs = jax.devices()
    kinds = {d.device_kind for d in devs}
    return (
        f"JAX {jax.__version__} backend={devs[0].platform} "
        f"devices={len(devs)} ({', '.join(sorted(kinds))})"
    )


# The compile cache's home when JAX_COMPILATION_CACHE_DIR is not set: one
# fixed directory inside the checkout (listed in .gitignore). The path is part
# of the cache key, so it never moves.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` if set, else :data:`DEFAULT_CACHE_DIR`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str | None:
    """Enable JAX's persistent compilation cache for this process.

    Called by the CLI, bench.py, chip_smoke.py and the tests. The directory
    is :func:`compile_cache_dir`; set ``MPC_IRIS_NO_COMPILE_CACHE=1`` to
    disable. Returns the cache dir or None when disabled.
    """
    if os.environ.get("MPC_IRIS_NO_COMPILE_CACHE"):
        return None
    path = compile_cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
        # Cache everything that takes >=1s to compile (skip trivial entries).
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:  # cache is an optimization; never block startup
        return None
    return path
