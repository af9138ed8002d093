"""Device mesh construction and sharding rules.

The reference is single-device (SURVEY §2.9); all parallelism here is new
capability:

- 1-D or 2-D `jax.sharding.Mesh` over ("data", "model");
- the *coalition* axis (batch x n_mask_samples masked forwards — the
  workload's scaling dimension, train_explainer.py:153-171) shards along
  "data";
- optional Megatron-style tensor parallelism for ViT-L / BERT-L: QKV and MLP
  up-projections shard their output features, the attention/MLP down
  projections shard their input features, so each layer needs exactly one
  all-reduce per block — inserted automatically by GSPMD from these
  NamedSharding annotations, riding ICI.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..recipes.types import Params


def make_mesh(
    n_devices: Optional[int] = None, model_parallel: int = 1
) -> Mesh:
    """Mesh over ("data", "model").  model_parallel=1 -> pure data/coalition
    parallelism."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model={model_parallel}")
    if n > len(devices):
        raise ValueError(
            f"requested a {n}-device mesh but only {len(devices)} device(s) "
            "are visible — shrink the mesh or raise "
            "xla_force_host_platform_device_count")
    grid = np.asarray(devices[:n]).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, ("data", "model"))


# ---------------------------------------------------------- param shardings

_TP_OUT_FEATURES = (
    # torch-layout (out, in) weights whose OUT features shard over "model"
    "attention.self.query.weight",
    "attention.self.key.weight",
    "attention.self.value.weight",
    "intermediate.dense.weight",
)
_TP_OUT_BIAS = (
    "attention.self.query.bias",
    "attention.self.key.bias",
    "attention.self.value.bias",
    "intermediate.dense.bias",
)
_TP_IN_FEATURES = (
    # (out, in) weights whose IN features shard over "model" (row parallel)
    "attention.output.dense.weight",
    "output.dense.weight",
)


def param_pspec(name: str, ndim: int) -> P:
    """Megatron-style PartitionSpec for a flat param name (replicated when no
    rule matches).  Biases of row-parallel layers stay replicated."""
    for suffix in _TP_OUT_FEATURES:
        if name.endswith(suffix):
            return P("model", None)
    for suffix in _TP_OUT_BIAS:
        if name.endswith(suffix):
            return P("model")
    for suffix in _TP_IN_FEATURES:
        if name.endswith(suffix):
            return P(None, "model")
    return P(*([None] * ndim)) if ndim else P()


def check_shardable(items, mesh: Mesh) -> None:
    """Fail closed (ValueError naming EVERY offending weight) when a sharded
    dim does not divide its mesh axis — device_put would otherwise surface
    an opaque runtime error, and GSPMD must never pad a weight silently.
    `items`: iterable of (name, shape, spec).  Shared by shard_params and
    parallel.pipeline.split_encoder_params (one source of truth for the
    fail-closed TP contract)."""
    bad = []
    for name, shape, spec in items:
        for dim, axis in zip(shape, spec):
            if axis is not None and dim % mesh.shape[axis] != 0:
                bad.append(f"{name}: shape {tuple(shape)} cannot "
                           f"shard {spec} over {axis}={mesh.shape[axis]}")
    if bad:
        raise ValueError(
            "tensor-parallel sharding does not divide the mesh — pick a "
            "model_parallel that divides these dims:\n  " + "\n  ".join(bad))


def shard_params(params: Params, mesh: Mesh) -> Params:
    """Place a flat param dict onto the mesh per `param_pspec`.

    Fails closed via check_shardable.  Divisibility gates the flagship
    dims: hidden 768 / heads 12 / ladder 96 all divide TP in
    {2, 3, 4, 6, 12}."""
    check_shardable(
        ((name, value.shape, param_pspec(name, value.ndim))
         for name, value in params.items()), mesh)
    out: Params = {}
    for name, value in params.items():
        spec = param_pspec(name, value.ndim)
        out[name] = jax.device_put(value, NamedSharding(mesh, spec))
    return out


def replicate_params(params: Params, mesh: Mesh) -> Params:
    sharding = NamedSharding(mesh, P())
    return {k: jax.device_put(v, sharding) for k, v in params.items()}


def shard_batch(tree, mesh: Mesh):
    """Shard every array's leading (batch / coalition) axis along "data"."""

    def place(x):
        x = jnp.asarray(x)
        spec = P("data", *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(place, tree)


def setup_data_parallel():
    """Trainer helper: when >1 device is visible, return (mesh, place_params,
    place_batch); on a single device return (None, identity, identity).

    place_params replicates a flat param dict; place_batch shards every
    array's leading axis along "data" when divisible by the mesh size (falls
    back to replication for ragged final batches so the same compiled step
    still runs)."""
    n = len(jax.devices())
    if n < 2:
        identity = lambda tree: tree  # noqa: E731
        return None, identity, identity
    mesh = make_mesh(n, model_parallel=1)

    def place_params(tree):
        return replicate_params(tree, mesh) if isinstance(tree, dict) else (
            jax.device_put(tree, NamedSharding(mesh, P()))
        )

    def place_batch(tree):
        def place(x):
            x = jnp.asarray(x)
            if x.ndim and x.shape[0] % n == 0:
                spec = P("data", *([None] * (x.ndim - 1)))
            else:
                spec = P(*([None] * x.ndim))
            return jax.device_put(x, NamedSharding(mesh, spec))

        return jax.tree.map(place, tree)

    return mesh, place_params, place_batch


def _smap():
    try:
        from jax import shard_map as smap  # jax >= 0.8
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map as smap
    return smap


def sharded_serving_fn(fn, mesh: Mesh):
    """Wrap a batch-parallel serving forward `fn(params, xs) -> pytree`
    in shard_map over the "data" axis: params replicated, xs and every
    output split on their leading axis.

    WHY shard_map and not plain GSPMD jit: a pallas_call whose operands are
    GSPMD-sharded gets REPLICATED behind all-gathers (custom calls carry no
    partitioning rule).  Inside shard_map each device traces the attention
    kernel on its LOCAL batch shard, so the serving path scales with
    devices."""
    smap = _smap()

    def wrapped(params, xs):
        p_specs = jax.tree.map(lambda _: P(), params)
        x_spec = P("data", *([None] * (xs.ndim - 1)))
        outs = jax.eval_shape(fn, params, xs)
        o_specs = jax.tree.map(
            lambda s: P("data", *([None] * (len(s.shape) - 1))), outs)
        return smap(fn, mesh=mesh, in_specs=(p_specs, x_spec),
                    out_specs=o_specs, check_vma=False)(params, xs)

    return jax.jit(wrapped)


def sharded_call(fn, mesh: Mesh, in_axes, out_axes=0):
    """`fn(*args)` under shard_map over the "data" axis — the generic form
    of sharded_serving_fn for the eval-report sweeps (SURVEY §2.9: the
    whole eval family is embarrassingly parallel).

    in_axes: one entry per positional arg — an int axis to split along
    "data", or None to replicate (pytree args replicate whole).  Outputs
    are reassembled along `out_axes`; an output whose `out_axes` dim does
    not divide the mesh raises (with check_vma off, a replicated out-spec
    would silently report ONE device's shard-local value as the global
    result).  Pass out_axes=None only when every output is genuinely
    identical across shards.  Composable inside jit.  Unlike plain GSPMD jit this keeps
    pallas_call kernels per-shard (they otherwise run replicated behind
    all-gathers).  Sharded input dims must divide the mesh (see
    sharded_eval_fn for the ragged fallback)."""
    n = mesh.shape["data"]

    def axis_spec(ndim: int, axis: int) -> P:
        return P(*[("data" if i == axis else None) for i in range(ndim)])

    def call(*args):
        in_specs = tuple(
            jax.tree.map(lambda _: P(), a) if ax is None
            else axis_spec(jnp.asarray(a).ndim, ax)
            for a, ax in zip(args, in_axes)
        )
        outs = jax.eval_shape(fn, *args)

        def ospec(s):
            nd = len(s.shape)
            if out_axes is None:  # caller asserts shard-identical outputs
                return P(*([None] * nd))
            if nd <= out_axes or s.shape[out_axes] % n != 0:
                raise ValueError(
                    f"sharded_call: output shape {s.shape} cannot shard "
                    f"along axis {out_axes} over {n} devices — a replicated "
                    "out-spec under check_vma=False would silently return "
                    "one shard's local value; restructure the output or "
                    "pass out_axes=None if it is provably shard-identical"
                )
            return axis_spec(nd, out_axes)

        o_specs = jax.tree.map(ospec, outs)
        return _smap()(fn, mesh=mesh, in_specs=in_specs, out_specs=o_specs,
                       check_vma=False)(*args)

    return call


def sharded_eval_fn(fn, mesh: Optional[Mesh], in_axes, out_axes=0):
    """jit-wrapped sharded_call with a ragged-shape fallback.

    mesh None -> plain jit (single device; the kernel stays on).  With a
    mesh: batch shapes that divide it run per-shard under shard_map
    (kernel included); ragged final batches fall back to the XLA path
    (ops.flash_attention.xla_attention), computed under whatever placement
    the caller gave the operands."""
    if mesh is None:
        return jax.jit(fn)
    n = mesh.shape["data"]
    call = sharded_call(fn, mesh, in_axes, out_axes)

    from ..ops.flash_attention import xla_attention

    @jax.jit
    def wrapped(*args):
        shardable = all(
            ax is None or (jnp.asarray(a).ndim > ax
                           and jnp.asarray(a).shape[ax] % n == 0
                           and jnp.asarray(a).shape[ax] >= n)
            for a, ax in zip(args, in_axes)
        )
        if not shardable:
            with xla_attention(sharded=True):
                return fn(*args)
        return call(*args)

    return wrapped


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Edge-pad `axis` up to a multiple (static shapes for SPMD)."""
    size = arr.shape[axis]
    target = ((size + multiple - 1) // multiple) * multiple
    if target == size:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - size)
    return np.pad(arr, pad, mode="edge")
