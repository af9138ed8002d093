"""Multi-host smoke test: 2 OS processes x 2 virtual CPU devices each,
coordinated via parallel.distributed.maybe_initialize_distributed (gloo
collectives), build the framework's global mesh and reduce across process
boundaries.  This is the code path a multi-host cluster engages through the
same AUTOGNOTHI_DIST_* env vars (SURVEY §2.9/§5.8)."""

import json
import socket
import subprocess
import sys
import textwrap

import pytest

CHILD = textwrap.dedent("""
    import json, os, sys
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if "host_platform_device_count" not in f]
    flags.append("--xla_force_host_platform_device_count=2")
    os.environ["XLA_FLAGS"] = " ".join(flags)
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.getcwd())

    from autognothi.parallel.distributed import (
        maybe_initialize_distributed, process_info,
    )
    assert maybe_initialize_distributed(), "env did not engage distributed"
    info = process_info()

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from autognothi.parallel.mesh import make_mesh

    mesh = make_mesh()  # global: 2 procs x 2 local = 4 devices
    sharding = NamedSharding(mesh, P("data", None))
    # per-process local shards -> one global array on the mesh
    locals_ = [
        jax.device_put(jnp.full((1, 8), float(jax.process_index() * 2 + i)),
                       d)
        for i, d in enumerate(jax.local_devices())
    ]
    g = jax.make_array_from_single_device_arrays(
        (4, 8), sharding, locals_)
    total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(g)
    info["reduced"] = float(total)

    # multi-host sharded checkpointing: every process holds only ITS shards
    # of `g` (not fully addressable), orbax saves them collectively and the
    # restore reads the assembled array back from the shared filesystem
    import pathlib
    from autognothi.pipeline.resources import (
        load_params_file, save_params,
    )
    ckpt = pathlib.Path(os.environ["AGT_TEST_CKPT_DIR"]) / "dist-epoch-0.ckpt"
    assert not g.is_fully_addressable
    try:
        save_params(ckpt, {"w": g})  # npz backend: must refuse loudly
        info["npz_guard"] = "missing"
    except ValueError as e:
        info["npz_guard"] = "ok" if "orbax" in str(e) else str(e)
    os.environ["AUTOGNOTHI_CKPT_BACKEND"] = "orbax"
    save_params(ckpt, {"w": g})
    got = load_params_file(ckpt)["w"]
    expect = np.repeat(np.arange(4.0)[:, None], 8, axis=1)
    info["ckpt_roundtrip"] = bool(np.array_equal(np.asarray(got), expect))
    print(json.dumps(info), flush=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_cpu_mesh(tmp_path):
    port = _free_port()
    procs = []
    for pid in range(2):
        import os

        env = dict(os.environ)
        env.pop("AUTOGNOTHI_CKPT_BACKEND", None)  # child starts on npz
        env.update({
            "AUTOGNOTHI_DIST_COORD": f"127.0.0.1:{port}",
            "AUTOGNOTHI_DIST_NPROCS": "2",
            "AUTOGNOTHI_DIST_PROC_ID": str(pid),
            "JAX_PLATFORMS": "cpu",
            "AGT_TEST_CKPT_DIR": str(tmp_path),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    for pid, proc in enumerate(procs):
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"proc {pid} failed:\n{err[-2000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    # devices 0..3 hold rows full of 0,1,2,3 -> sum = 8 * (0+1+2+3)
    for pid, info in enumerate(outs):
        assert info["process_index"] == pid
        assert info["process_count"] == 2
        assert info["global_devices"] == 4
        assert info["local_devices"] == 2
        assert info["reduced"] == 8.0 * 6
        assert info["npz_guard"] == "ok"
        assert info["ckpt_roundtrip"] is True
