"""Shared training machinery: optimizer construction with freeze masks,
cosine-annealed learning rates, and jit-compiled step builders.

Design decisions (compiled re-design of the reference trainers):
- Freezing is optimizer partitioning: `optax.multi_transform` routes frozen
  params to `set_to_zero`, replacing `.requires_grad = False`
  (/root/reference/utils/nnmodel.py:48-60).  Frozen params receive neither
  gradient updates nor weight decay — matching torch AdamW skipping params
  with no grad.
- LTT progressive training needs the freeze set to change *per epoch*
  without resetting Adam moments; that is a dynamic 0/1 `update_mask`
  multiplied into both gradients and updates inside the compiled step.
  KNOWN DEVIATION (experimental path only — no shipped config enables
  progressive training, here or in the reference): optax keeps ONE global
  Adam count, so a layer unfrozen at step t gets its first updates
  bias-corrected as if it had trained all along (~(1-b1^t)^-.5 smaller
  denominator -> up to ~3x larger first steps than torch, whose per-param
  state starts at step 1 on first update).  Moments themselves are zero
  for masked layers, matching torch.
- The lr schedule replicates torch CosineAnnealingLR stepped per *epoch*
  (train_classifier.py:41-43,82); the lr is a step argument so one compiled
  executable serves all epochs.
- Optimizer state is deliberately NOT checkpointed (reference behavior:
  rebuilt at resume, SURVEY §2.5).
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import signal
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..parallel.mesh import pad_to_multiple
from ..recipes.types import Params

# torch.optim.AdamW defaults — the reference never overrides them
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-2


# ------------------------------------------- preemption-safe interruption
#
# Shared clusters preempt: the scheduler sends SIGTERM and the process has
# seconds to get its state durable.  The trainers already checkpoint every
# completed epoch (resources.save_epoch_ckpt) and resume from the newest
# file, so the graceful path only has to (a) stop AT A BATCH BOUNDARY
# instead of dying mid-step and (b) never corrupt a checkpoint
# (resources.save_params writes atomically).  A mid-epoch interrupt
# abandons the partial epoch — epoch seeds are derived
# (utils/seeding.iterative_key), so the resumed run redoes it bit-identically.
# Extension: the reference has no signal handling (verified: no signal/
# SIGTERM use anywhere in /root/reference).

_SHUTDOWN = {"requested": False, "depth": 0, "prev": None}

#: exit code for "interrupted cleanly, state durable, requeue me"
#: (BSD EX_TEMPFAIL — the convention preemption-aware schedulers retry)
INTERRUPT_EXIT_CODE = 75


class TrainingInterrupted(RuntimeError):
    """Raised at a batch boundary after SIGTERM: completed epochs are
    checkpointed; rerunning the same command resumes from the newest one."""


def shutdown_requested() -> bool:
    return _SHUTDOWN["requested"]


def _restore_disposition() -> None:
    prev = _SHUTDOWN["prev"]
    if not (callable(prev) or prev in (signal.SIG_DFL, signal.SIG_IGN)):
        prev = signal.SIG_DFL
    signal.signal(signal.SIGTERM, prev)


def _sigterm_handler(signum, frame):
    if _SHUTDOWN["requested"]:
        # second TERM: give the signal back to its previous disposition so
        # a process stuck in a PYTHON loop stays killable.  (A process
        # wedged in a C-level wait never re-enters the bytecode loop, so
        # no Python handler can run there; that case always needs SIGKILL,
        # regardless of what we install.)
        _restore_disposition()
        signal.raise_signal(signal.SIGTERM)
        return
    _SHUTDOWN["requested"] = True


def graceful_training(fn):
    """Decorator: run a trainer inside graceful_scope() — SIGTERM during
    the trainer stops at a batch boundary; outside it (conversions,
    measurements) the signal keeps its normal fatal disposition."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with graceful_scope():
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def graceful_scope():
    """Scope SIGTERM-graceful handling to an epoch loop.  INSIDE the scope
    the first SIGTERM requests a batch-boundary stop (polled by
    LossDrain.push -> TrainingInterrupted) and a second one escalates to
    the previous disposition.  OUTSIDE any scope SIGTERM keeps its normal
    (usually fatal) disposition — a flag nobody polls must never make the
    process TERM-immune during conversion/measurement phases.  Re-entrant;
    no-op off the main thread (signal rules)."""
    installed = False
    try:
        if _SHUTDOWN["depth"] == 0:
            _SHUTDOWN["prev"] = signal.getsignal(signal.SIGTERM)
            signal.signal(signal.SIGTERM, _sigterm_handler)
        _SHUTDOWN["depth"] += 1
        installed = True
    except (ValueError, AttributeError, OSError):
        pass  # non-main thread / exotic platform: run without the net
    try:
        yield
    finally:
        if installed:
            _SHUTDOWN["depth"] -= 1
            if _SHUTDOWN["depth"] == 0 and signal.getsignal(
                    signal.SIGTERM) is _sigterm_handler:
                _restore_disposition()


def compute_dtype():
    """Mixed-precision training: AUTOGNOTHI_COMPUTE_DTYPE=bfloat16 casts
    float *inputs* to bf16 so the whole network computes in bf16 (fp32
    layernorm/softmax statistics and fp32 matmul accumulation are built into
    the model primitives); params and optimizer state stay fp32."""
    name = os.environ.get("AUTOGNOTHI_COMPUTE_DTYPE", "float32")
    return jnp.bfloat16 if name in ("bf16", "bfloat16") else jnp.float32


def cast_input(xs: jax.Array) -> jax.Array:
    """Apply the compute dtype to floating-point inputs (token ids pass)."""
    if jnp.issubdtype(xs.dtype, jnp.floating):
        return xs.astype(compute_dtype())
    return xs


def defer_loss_fetch() -> bool:
    """AUTOGNOTHI_DEFER_LOSS_FETCH=1 batches the per-step loss device->host
    transfers into one fetch per epoch, keeping the device queue full
    (async dispatch).  Off by default: per-batch log lines appear live,
    matching the reference's cadence exactly (the lines are identical
    either way, only *when* they print changes).  A per-step fetch makes
    the host wait for each step before it enqueues the next."""
    return os.environ.get("AUTOGNOTHI_DEFER_LOSS_FETCH") == "1"


def pad_ragged() -> bool:
    """AUTOGNOTHI_PAD_RAGGED=0 opts out of fixed-shape batch padding."""
    return os.environ.get("AUTOGNOTHI_PAD_RAGGED", "1") != "0"


def pad_batch(xs, zs, batch_size: int):
    """Edge-pad a (possibly ragged final) batch up to the configured
    `batch_size` -> (xs, zs, weights <padded> float32 marking real rows).

    The streaming loaders yield one short final batch per epoch
    (reference datasets/loader.py:119-125); without padding that shape
    retraces every jitted step.  With it, each loader compiles ONE step
    shape, and the weighted-mean losses (cross_entropy_on_probs,
    loss_logits_kl_divergence, loss_shapley) make the padded result equal
    the unpadded one — padded rows carry zero weight in both the loss value
    and the gradients (tests/test_ragged_padding.py)."""
    xs = np.asarray(xs)
    real = xs.shape[0]
    if not pad_ragged():
        weights = np.ones((real,), np.float32)
        return xs, (None if zs is None else np.asarray(zs)), weights
    xs = pad_to_multiple(xs, batch_size)
    zs_p = None if zs is None else pad_to_multiple(np.asarray(zs), batch_size)
    weights = np.zeros((xs.shape[0],), np.float32)
    weights[:real] = 1.0
    return xs, zs_p, weights


class LossDrain:
    """Per-batch device->host transfer buffer shared by all trainers.

    `push(device_vals, host_vals)` records one batch; `flush()` ends the
    epoch.  In deferred mode (`defer_loss_fetch`) all device values are
    fetched in ONE `jax.device_get` at flush time, so the device queue never
    stalls on a per-batch round trip; otherwise each batch is fetched
    immediately (live logs, reference cadence).  `emit(batch_idx,
    device_vals_np, host_vals)` runs in batch order in both modes, so
    running totals / log lines are byte-identical."""

    def __init__(self, emit: Callable[[int, tuple, tuple], None]):
        self._emit = emit
        self.deferred = defer_loss_fetch()
        self._pend: list = []
        self._count = 0

    def push(self, device_vals: tuple, host_vals: tuple = ()) -> None:
        # every trainer's batch loop passes through here — the one poll
        # point that makes SIGTERM stop at a batch boundary
        if shutdown_requested():
            raise TrainingInterrupted(
                "SIGTERM — stopped at a batch boundary; completed epochs "
                "are checkpointed, rerun the same command to resume")
        if self.deferred:
            self._pend.append((device_vals, host_vals))
        else:
            self._emit(self._count, jax.device_get(device_vals), host_vals)
        self._count += 1

    def flush(self) -> None:
        if self._pend:
            fetched = jax.device_get([d for d, _ in self._pend])
            for i, (vals, (_, host)) in enumerate(zip(fetched, self._pend)):
                self._emit(i, vals, host)
        self._pend.clear()
        self._count = 0


def maybe_enable_debug_nans() -> None:
    """JAX analogue of the reference's permanently-on
    `torch.autograd.set_detect_anomaly(True)` (train_classifier.py:50):
    NaN checking on every train op.  Opt-in via AUTOGNOTHI_DEBUG_NANS=1
    because it disables async dispatch (a large slowdown)."""
    if os.environ.get("AUTOGNOTHI_DEBUG_NANS") == "1":
        jax.config.update("jax_debug_nans", True)


def cosine_lr(base_lr: float, epoch: int, total_epochs: int) -> float:
    """torch CosineAnnealingLR value for 1-indexed `epoch` (the lr used
    *during* epoch e is the post-(e-1)-step value, eta_min=0)."""
    if total_epochs <= 0:
        return base_lr
    t = epoch - 1
    return base_lr * (1 + math.cos(math.pi * t / total_epochs)) / 2


def make_optimizer_labeled(
    params_tree: Any, labels_tree: Any
) -> Tuple[optax.GradientTransformation, Any]:
    """AdamW multi_transform over an explicit "train"/"freeze" label pytree
    matching `params_tree`'s structure — the generic core of make_optimizer
    for non-dict param containers (the pp trainer's (rest, stacked) pair)."""
    tx = optax.multi_transform(
        {
            "train": optax.inject_hyperparams(optax.adamw)(
                learning_rate=0.0,
                b1=ADAMW_BETAS[0],
                b2=ADAMW_BETAS[1],
                eps=ADAMW_EPS,
                weight_decay=ADAMW_WEIGHT_DECAY,
            ),
            "freeze": optax.set_to_zero(),
        },
        labels_tree,
    )
    return tx, tx.init(params_tree)


def make_optimizer(
    params: Params, trainable: Callable[[str], bool]
) -> Tuple[optax.GradientTransformation, Any]:
    """AdamW over the trainable subset (others frozen hard); lr injected
    per step via optax.tree_utils.tree_set."""
    labels = {k: ("train" if trainable(k) else "freeze") for k in params}
    return make_optimizer_labeled(params, labels)


def ones_mask(params: Any) -> Any:
    """All-ones update mask matching any params container (flat dict, or
    the pp trainer's (rest, stacked) pair)."""
    return jax.tree.map(lambda _: jnp.ones(()), params)


def filter_mask(params: Params, keep: Callable[[str], bool]) -> Dict[str, jax.Array]:
    return {k: jnp.ones(()) if keep(k) else jnp.zeros(()) for k in params}


def make_train_step(
    tx: optax.GradientTransformation,
    loss_fn: Callable[..., Tuple[jax.Array, Any]],
) -> Callable:
    """jit-compiled (params, opt_state, lr, update_mask, *batch) ->
    (params, opt_state, loss, aux).  `loss_fn(params, *batch) -> (loss, aux)`.
    `update_mask` is a per-param 0/1 scalar dict for dynamic freezing."""

    @jax.jit
    def step(params, opt_state, lr, update_mask, *batch):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, *batch
        )
        grads = jax.tree.map(lambda g, m: g * m, grads, update_mask)
        opt_state = optax.tree_utils.tree_set(opt_state, learning_rate=lr)
        updates, opt_state = tx.update(grads, opt_state, params)
        updates = jax.tree.map(lambda u, m: u * m, updates, update_mask)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, aux

    return step


def cross_entropy_on_probs(
    probs: jax.Array, labels: jax.Array, weights: Optional[jax.Array] = None
) -> jax.Array:
    """torch F.cross_entropy applied to the models' softmax outputs — i.e.
    log_softmax over *probabilities* (the reference's observable behavior,
    vanilla_bert.py:52,77 + train_classifier.py:136).  `weights` <batch>
    marks real rows (0 = padding): weighted mean."""
    logp = jax.nn.log_softmax(probs, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
    if weights is None:
        return jnp.mean(nll)
    w = weights.astype(nll.dtype)
    return jnp.sum(w * nll) / jnp.maximum(jnp.sum(w), 1.0)
