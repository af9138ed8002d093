"""AOT export of the trained final model to a StableHLO artifact.

Deployment extension beyond the reference (whose deployment surface is the
file-based demos, the reference's scripts/run_image_explanation.py:33 and
run_text_explanation.py:22): `export_final` serializes the final
(prediction + Shapley-attribution) model — program AND trained weights —
into ONE self-contained artifact that any JAX process can load and call
without this framework, the model code, or the checkpoint files:

    python ./main.py export_final <exp> --into final.jaxexp --batch-size 8

    # later, anywhere (no autognothi needed beyond this 20-line loader):
    from autognothi.pipeline.export import load_exported
    fw = load_exported("final.jaxexp")
    probs, attr = fw(xs)          # fixed <batch, ...> input, like serve.py

Design notes:
- the artifact is a tiny container: `jax.export` blob (the program, weights
  as RUNTIME ARGUMENTS) + npz of the flat param dict.  Weights must NOT be
  baked in as constants: XLA constant-folds through them on the host, so
  the artifact would no longer run the on-device math the serving path
  runs.  With weights as arguments it computes what `pipeline/serve.py`
  computes;
- the trace is the pure-XLA path (`ops.flash_attention.xla_attention`) in
  the checkpoint's own precision: a Pallas/Triton custom call does not
  serialize for other platforms, while a StableHLO-only artifact
  cross-compiles; by default it is lowered for BOTH `cuda` and `cpu` so one
  file serves either backend;
- fixed batch, matching the serving layer's fixed-shape slab contract
  (pad the last request like `pipeline/serve.py` does);
- `--data-parallel N` exports a MESH-SHARDED program: the serving forward
  is shard_map-wrapped over an N-device `AbstractMesh(("data",))` with the
  weights replicated and the batch split along "data", and the input avals
  carry those shardings, so the serialized program records `nr_devices=N`
  and — like the live serving path — compiles with ZERO cross-device
  collectives.  An AbstractMesh needs no devices at export time: a
  single-device process can export an N-device artifact; at load time
  `load_exported` binds it to the first N local devices and fails closed
  when fewer exist.  Artifacts are DP-only BY DESIGN: every shipped final
  (ViT-B/BERT-base class) fits one device with room to spare, so pure
  replication is the collective-free,
  highest-throughput serving layout; tensor-parallel serving exists on
  the LIVE path (parallel/mesh.py Megatron specs) for models that
  outgrow a device;
- the KernelSHAP baseline's final is host-side WLS (`fw_final_host`) and
  cannot be exported — fails closed with a clear error.
"""

from __future__ import annotations

import io
import os
import pathlib
import struct
import sys
from typing import Callable, Sequence, Tuple

import numpy as np

from .env import ExpEnv
from .resources import get_recipe, load_epoch_model

DEFAULT_PLATFORMS = ("cuda", "cpu")
_MAGIC = b"AGTPEXP1"
_VENDOR = pathlib.Path(__file__).resolve().parents[1] / "_vendor"


def jax_export():
    """-> the `jax.export` module, able to (de)serialize.

    jax.export writes and reads artifacts through the `flatbuffers`
    package, which JAX does not depend on.  Where none is installed, the
    copy bundled in autognothi/_vendor (README there) is put at the end of
    sys.path, so an installed one always wins."""
    try:
        import flatbuffers  # noqa: F401
    except ImportError:
        if str(_VENDOR) not in sys.path:
            sys.path.append(str(_VENDOR))
        try:
            import flatbuffers  # noqa: F401,F811
        except ImportError as exc:
            raise ImportError(
                "jax.export (de)serialization needs the 'flatbuffers' "
                f"package, and neither an installed one nor the copy in "
                f"{_VENDOR} could be imported") from exc
    from jax import export

    return export


def _pack(program: bytes, params: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in params.items()})
    return (_MAGIC + struct.pack("<Q", len(program)) + bytes(program)
            + buf.getvalue())


def _unpack(blob: bytes):
    if blob[:8] != _MAGIC:
        raise ValueError("not an export_final artifact (bad magic)")
    n = struct.unpack("<Q", blob[8:16])[0]
    program = bytearray(blob[16:16 + n])
    with np.load(io.BytesIO(blob[16 + n:])) as z:
        params = {k: z[k] for k in z.files}
    return program, params


def build_final_export(fw_final, final_params: dict, null: np.ndarray,
                       batch_size: int,
                       platforms: Sequence[str] = DEFAULT_PLATFORMS,
                       data_parallel: int = 1):
    """Trace + serialize a serving program; shared by `export_final` and
    the multichip dryrun.  -> (jax.export.Exported, in_spec).

    `fw_final(params, xs) -> (probs, attr)` in the checkpoint's own dtypes,
    traced on the XLA path (module docstring).  `data_parallel > 1`
    shard_map-wraps the
    forward over an `AbstractMesh((N,), ("data",))` and annotates the
    avals, producing an `nr_devices=N` artifact a single-device process can
    still export (module docstring)."""
    import jax

    from ..ops.flash_attention import xla_attention

    jexport = jax_export()
    if batch_size == 0:
        # batch-polymorphic artifact: one lowering serves ANY batch.  The
        # XLA path traces cleanly with a symbolic leading dim; a sharded
        # batch needs a concrete per-shard size.
        if data_parallel > 1:
            raise SystemExit("a batch-polymorphic artifact cannot be "
                             "mesh-sharded — pass a fixed --batch-size")
        batch_dim = jexport.symbolic_shape("b")[0]
    else:
        batch_dim = batch_size
    if data_parallel > 1 and batch_size % data_parallel != 0:
        raise SystemExit(
            f"--batch-size {batch_size} is not divisible by --data-parallel "
            f"{data_parallel}: every device must get equal slab rows")

    def fw(params, xs):
        with xla_attention():
            return fw_final(params, xs)

    in_shape = (batch_dim,) + null.shape[1:]
    if data_parallel > 1:
        from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

        from ..parallel.mesh import sharded_serving_fn

        am = AbstractMesh((data_parallel,), ("data",))
        rep = NamedSharding(am, P())
        in_spec = jax.ShapeDtypeStruct(
            in_shape, null.dtype,
            sharding=NamedSharding(am, P("data", *([None] * len(null.shape[1:])))))
        param_specs = {
            k: jax.ShapeDtypeStruct(np.shape(v), np.asarray(v).dtype,
                                    sharding=rep)
            for k, v in final_params.items()
        }
        jit_fw = sharded_serving_fn(fw, am)  # already jit-wrapped
    else:
        in_spec = jax.ShapeDtypeStruct(in_shape, null.dtype)
        param_specs = {
            k: jax.ShapeDtypeStruct(np.shape(v), np.asarray(v).dtype)
            for k, v in final_params.items()
        }
        jit_fw = jax.jit(fw)

    exported = jexport.export(jit_fw, platforms=list(platforms))(
        param_specs, in_spec)
    return exported, in_spec


def export_final(env: ExpEnv, into: pathlib.Path, batch_size: int = 8,
                 platforms: Sequence[str] = DEFAULT_PLATFORMS,
                 data_parallel: int = 1) -> dict:
    """Serialize the final model at a fixed batch size; returns metadata.

    `data_parallel=N` exports a mesh-sharded artifact (module docstring):
    the program records nr_devices=N, `serve --artifact` shards each slab
    over the first N local devices, and N=1 stays the portable default.
    """
    jax_export()  # fail before training state is loaded, not after tracing
    recipe, m_config = get_recipe(env.config)
    if recipe.fw_final_host:
        raise SystemExit(
            f"net kind {env.config.net.kind!r} computes its final "
            "explanation on the host (KernelSHAP WLS) — there is no device "
            "program to export")
    _, final_params = load_epoch_model(env, recipe, "final")
    misc = recipe.load_misc(env.model_path, m_config)
    null = np.asarray(recipe.gen_null(m_config, misc))

    env.log(f"[[[ export_final: batch {batch_size}, platforms "
            f"{list(platforms)}, data_parallel={data_parallel} ]]]")
    exported, in_spec = build_final_export(
        lambda p, xs: recipe.fw_final(m_config, p, xs), final_params, null,
        batch_size, platforms=platforms, data_parallel=data_parallel)
    blob = _pack(exported.serialize(), final_params)
    into = pathlib.Path(into)
    # atomic: a kill mid-write (preemption) must never leave a truncated
    # artifact — or corrupt a previously good one — at the target path
    tmp = into.with_name(into.name + ".tmp")
    try:
        tmp.write_bytes(blob)
        os.replace(tmp, into)
    finally:
        tmp.unlink(missing_ok=True)
    meta = {
        "path": str(into),
        "bytes": len(blob),
        "batch_size": batch_size or "symbolic",
        "platforms": list(platforms),
        "in_shape": [d if isinstance(d, int) else str(d)
                     for d in in_spec.shape],
        "in_dtype": str(in_spec.dtype),
        "n_params": len(final_params),
        "nr_devices": exported.nr_devices,
    }
    env.log(f"[[[ export_final: wrote {meta['bytes']} bytes -> {into} ]]]")
    return meta


def load_exported(path: pathlib.Path) -> Callable[[np.ndarray], Tuple]:
    """Deserialize an `export_final` artifact into a callable.

    The callable takes the fixed-shape input batch and returns whatever the
    recipe's `fw_final` returns (probabilities/logits, attributions).  The
    bundled weights ride along as call arguments (see module docstring for
    why they are not constants).
    """
    import jax

    program, params = _unpack(pathlib.Path(path).read_bytes())
    exported = jax_export().deserialize(program)
    # jit the exported program with the weights as call ARGUMENTS (one
    # executable per input shape/dtype; no host constant-folding through
    # the weights — module docstring)
    pcall = jax.jit(exported.call)

    nr = exported.nr_devices
    if nr > 1:
        # mesh-sharded artifact: bind it to the first nr local devices —
        # weights replicated, slab rows split along "data" (the shardings
        # the program was exported with)
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        devices = jax.local_devices()  # process-addressable: device_put
        # below must be able to place shards from this host
        if len(devices) < nr:
            raise ValueError(
                f"this artifact was exported for {nr} devices "
                f"(--data-parallel {nr}); the current process addresses only "
                f"{len(devices)} — re-export with a smaller --data-parallel "
                "or serve on a bigger slice")
        mesh = Mesh(np.asarray(devices[:nr]), ("data",))
        rep = NamedSharding(mesh, P())

        def place_batch(xs):
            spec = P("data", *([None] * (xs.ndim - 1)))
            return jax.device_put(xs, NamedSharding(mesh, spec))

        params = {k: jax.device_put(v, rep) for k, v in params.items()}
    else:
        # single transfer up front; jit args would otherwise re-upload the
        # numpy weights on every call
        params = {k: jax.device_put(v) for k, v in params.items()}
        place_batch = lambda xs: xs  # noqa: E731

    def call(xs):
        return pcall(params, place_batch(jax.numpy.asarray(xs)))

    # self-description for callers that must match the program's fixed
    # shape (pipeline/serve.py slabs requests to exactly this batch):
    # the xs aval is the last flattened input (params dict leaves precede)
    in_aval = exported.in_avals[-1]
    call.in_shape = tuple(
        d if isinstance(d, int) else None for d in in_aval.shape)
    call.in_dtype = np.dtype(in_aval.dtype)
    call.platforms = tuple(exported.platforms)
    # serving integration points: the jitted (params, xs) entry (so callers
    # can fuse pre-processing like u8 dequant into the same executable),
    # the bundled weights (device-placed; replicated when mesh-sharded),
    # and the batch placer that shards slab rows for nr_devices > 1
    call.pcall = pcall
    call.params = params
    call.place_batch = place_batch
    call.nr_devices = nr
    return call
