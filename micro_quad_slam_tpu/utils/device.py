"""Device set-up shared by the entry points (cli, bench.py, chip_smoke.py):
the persistent compile cache, the accelerator check, and the card's name
and power limit as nvidia-smi reports them."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

# One fixed path inside the checkout: the path is part of the cache key,
# so a directory that moved between runs would never hit.
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Keep JAX's persistent compile cache at CACHE_DIR unless
    JAX_COMPILATION_CACHE_DIR is set, in which case JAX reads the
    variable itself and nothing is set here.  Returns the directory in
    use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def require_gpu():
    """The first JAX device, which must be a GPU.  Raises RuntimeError
    otherwise: a measurement that finds no card fails, it does not fall
    back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform} "
            f"({dev.device_kind})")
    return dev


def gpu_name_and_power_limit() -> list[str]:
    """One 'name, power.limit' line per card, from nvidia-smi (a child
    process that stays off JAX).  Raises when nvidia-smi is missing or
    fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
