"""Device helpers: the compile cache, and host-CPU placement for weight
surgery.

Weight conversion runs hundreds of tiny ops (per-leaf inits, clones,
merges).  On the host each is a plain function call; on the GPU each would
be a kernel launch plus a dispatch, and the intermediate copies would take
device memory the trainer needs.  So conversions run on the host CPU
backend and trainers move the finished params to the GPU in one transfer.
The CLI keeps the CPU backend available beside the GPU for this."""

from __future__ import annotations

import contextlib
import os
import pathlib
from typing import Iterator, Optional

import jax

# the compile cache's fixed home inside the checkout (listed in .gitignore)
CHECKOUT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(
        default_dir: pathlib.Path = CHECKOUT_CACHE_DIR) -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already keeps its cache
    there and nothing is set here.  Otherwise the cache goes to the fixed
    `default_dir`: the path is part of the cache's key, so a directory
    that moved between runs would never hit."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    pathlib.Path(default_dir).mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(default_dir))
    return str(default_dir)


def host_cpu_device() -> Optional[jax.Device]:
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return None


@contextlib.contextmanager
def on_host() -> Iterator[None]:
    """Run the enclosed jax ops on the host CPU backend when available."""
    cpu = host_cpu_device()
    if cpu is None:
        yield
        return
    with jax.default_device(cpu):
        yield
