"""Device capability, device identity and the persistent compile cache.

`on_gpu` is the one backend predicate of the package: the routing rules
(solvers/full_ba._resolve_mode, the point-major layout build's 'auto'
choice) ask it, and nothing else compares backend names. `require_gpu` is
what measurement entry points call: a number taken without a GPU is never
reported as a device number.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

import jax

# Default compile-cache location: a fixed directory inside the checkout
# (the path is part of the cache key, so it must not move between runs).
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = _REPO_ROOT / ".jax_cache"


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU."""
    return jax.default_backend() == "gpu"


def require_gpu() -> list:
    """The GPU devices, or RuntimeError naming the missing GPU."""
    if not on_gpu():
        raise RuntimeError(
            "no GPU: JAX's default backend is "
            f"{jax.default_backend()!r} with devices {jax.devices()}; this "
            "entry point measures the GPU and has no CPU fallback"
        )
    return jax.devices()


def device_info() -> dict:
    """Platform, device kind and count as JAX reports them."""
    d = jax.devices()
    return {
        "platform": d[0].platform,
        "kind": d[0].device_kind,
        "count": len(d),
    }


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of every card, one per line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    `JAX_COMPILATION_CACHE_DIR` wins when it is set; otherwise the cache
    lives in `.jax_cache/` at the repository root (listed in .gitignore)."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        DEFAULT_CACHE_DIR
    )
    jax.config.update("jax_compilation_cache_dir", path)
    return path
