"""Multi-host (multi-process) initialization — SURVEY §2.9/§5.8.

The reference is strictly single-device (no DDP/NCCL anywhere); scaling to
several hosts is new capability in this rebuild: every process calls
`jax.distributed.initialize`, after which `jax.devices()` is the GLOBAL
device list, `parallel.mesh.make_mesh` builds a global mesh over it, and XLA
hands the GSPMD collectives to NCCL (NVLink within a host, the network
across hosts).

Engaged via environment (so every CLI entry point inherits it without
per-command flags):

    AUTOGNOTHI_DIST_COORD=host:port   coordinator address; "auto" requests
                                      cluster auto-detection (initialize()
                                      with no arguments: SLURM, Open MPI)
    AUTOGNOTHI_DIST_NPROCS=N          total process count
    AUTOGNOTHI_DIST_PROC_ID=i         this process's index in [0, N)

CPU backends additionally need a cross-process collectives implementation;
`gloo` is selected automatically (the 2-process CPU smoke test in
tests/test_distributed.py runs exactly this path).

MUST run before the JAX backend initializes (any jax.devices()/array op);
`autognothi.cli.main` calls it first thing.
"""

from __future__ import annotations

import os
from typing import Optional


def distributed_env_configured(env: Optional[dict] = None) -> bool:
    env = os.environ if env is None else env
    return bool(env.get("AUTOGNOTHI_DIST_COORD"))


def maybe_initialize_distributed(env: Optional[dict] = None) -> bool:
    """Initialize jax.distributed from AUTOGNOTHI_DIST_* env vars.

    Returns True when multi-process mode was engaged.  No-ops (False) when
    AUTOGNOTHI_DIST_COORD is unset — the default single-process path stays
    untouched.  Idempotent: a second call returns True without
    re-initializing."""
    env = os.environ if env is None else env
    coord = env.get("AUTOGNOTHI_DIST_COORD")
    if not coord:
        return False

    import jax

    if getattr(maybe_initialize_distributed, "_done", False):
        return True

    platforms = (
        jax.config.jax_platforms or env.get("JAX_PLATFORMS", "") or ""
    )
    if "cpu" in platforms or not platforms:
        # cross-process CPU collectives (all-reduce et al.) need gloo.  The
        # CLI lists the CPU backend beside the GPU (weight surgery on the
        # host), and unset platforms include it too; gloo only serves the
        # CPU backend — the GPU's collectives go through NCCL either way
        jax.config.update("jax_cpu_collectives_implementation", "gloo")

    if coord == "auto":
        jax.distributed.initialize()
    else:
        nprocs = env.get("AUTOGNOTHI_DIST_NPROCS")
        proc_id = env.get("AUTOGNOTHI_DIST_PROC_ID")
        if nprocs is None or proc_id is None:
            raise RuntimeError(
                "AUTOGNOTHI_DIST_COORD is set but "
                "AUTOGNOTHI_DIST_NPROCS/AUTOGNOTHI_DIST_PROC_ID are not — "
                "set both (total process count and this process's index), "
                "or use AUTOGNOTHI_DIST_COORD=auto under a cluster manager"
            )
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nprocs),
            process_id=int(proc_id),
        )
    maybe_initialize_distributed._done = True
    return True


def process_info() -> dict:
    """Diagnostic summary: process index/count and device visibility."""
    import jax

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
    }
