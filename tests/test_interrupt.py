"""Preemption-safe training (pipeline/training.py graceful shutdown +
pipeline/resources.py atomic checkpoint writes).

Shared clusters preempt with SIGTERM.  Contract under test: the first SIGTERM
stops training at the next batch boundary (TrainingInterrupted out of
LossDrain.push), every *completed* epoch is durable on disk, checkpoint
files can never be half-written (tmp + os.replace), the CLI converts the
interrupt to exit code 75 (EX_TEMPFAIL — "requeue me"), and rerunning the
same command resumes from the newest checkpoint to completion.

Extension beyond the reference (it has no signal handling anywhere);
the checkpoint naming/resume semantics it builds on are reference-parity
(/root/reference/scripts/resources.py:150-217).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tests.test_train_all_e2e import MINI_VIT_HPARAMS


@pytest.fixture(autouse=True)
def _reset_shutdown_state():
    from autognothi.pipeline import training

    saved = dict(training._SHUTDOWN)
    prev = signal.getsignal(signal.SIGTERM)
    training._SHUTDOWN.update(requested=False, depth=0, prev=None)
    yield
    training._SHUTDOWN.update(saved)
    signal.signal(signal.SIGTERM, prev)


def test_sigterm_in_scope_sets_flag_and_push_raises():
    from autognothi.pipeline.training import (
        LossDrain, TrainingInterrupted, graceful_scope, shutdown_requested,
    )

    with graceful_scope():
        with graceful_scope():  # re-entrant (pretrain -> train_classifier)
            assert not shutdown_requested()
            drain = LossDrain(lambda i, vals, host: None)
            drain.push((np.float32(1.0),))  # flows normally pre-signal

            signal.raise_signal(signal.SIGTERM)
            assert shutdown_requested()
            with pytest.raises(TrainingInterrupted, match="batch boundary"):
                drain.push((np.float32(2.0),))


def test_scope_exit_restores_disposition():
    """OUTSIDE a scope SIGTERM must keep its previous (normally fatal)
    disposition — conversion/measurement phases must never become
    TERM-immune (a flag nobody polls)."""
    from autognothi.pipeline import training
    from autognothi.pipeline.training import graceful_scope

    hits = []
    signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    with graceful_scope():
        assert signal.getsignal(signal.SIGTERM) is training._sigterm_handler
    assert signal.getsignal(signal.SIGTERM) is not training._sigterm_handler
    signal.raise_signal(signal.SIGTERM)
    assert hits == [signal.SIGTERM]  # previous handler back in force


def test_second_sigterm_escalates_to_previous_disposition():
    from autognothi.pipeline.training import graceful_scope

    hits = []
    signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    with graceful_scope():
        signal.raise_signal(signal.SIGTERM)  # graceful: flag only
        assert hits == []
        signal.raise_signal(signal.SIGTERM)  # escalation: previous handler
        assert hits == [signal.SIGTERM]


def test_atomic_ckpt_write_never_leaves_partial_file(tmp_path, monkeypatch):
    import autognothi.pipeline.resources as res

    good = {"w": np.ones((4, 4), np.float32)}
    res.save_params(tmp_path / "ok.ckpt", good)
    assert (tmp_path / "ok.ckpt").exists()
    assert not list(tmp_path.glob("*.tmp"))
    loaded = res.load_params_file(tmp_path / "ok.ckpt")
    np.testing.assert_array_equal(loaded["w"], good["w"])

    # a crash mid-write (what SIGKILL during np.savez amounts to) must not
    # produce the target file at all — the resume scan would load garbage
    def boom(f, **arrays):
        f.write(b"PK\x03\x04 partial zip header then death")
        raise RuntimeError("killed mid-write")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(RuntimeError, match="mid-write"):
        res.save_params(tmp_path / "dead.ckpt", good)
    assert not (tmp_path / "dead.ckpt").exists()
    assert not list(tmp_path.glob("*.tmp"))


def _mini_exp(tmp_path, surrogate_epochs=6):
    exp = tmp_path / "vit_mini"
    exp.mkdir()
    hp = json.loads(json.dumps(MINI_VIT_HPARAMS))
    hp["train_surrogate"]["epochs"] = surrogate_epochs
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    return exp


def test_midtrain_interrupt_keeps_completed_epochs_and_resumes(tmp_path,
                                                               monkeypatch):
    """Interrupt during epoch 2 of the surrogate: epoch 1 stays durable,
    the partial epoch leaves no file, and a rerun completes training with
    the interrupted epoch redone from its derived seed."""
    from autognothi.pipeline import train_surrogate as ts
    from autognothi.pipeline import training
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.resources import get_epoch_ckpts
    from autognothi.pipeline.train_all import train_all
    from autognothi.pipeline.training import TrainingInterrupted

    exp = _mini_exp(tmp_path, surrogate_epochs=2)
    env = ExpEnv(exp)

    real_cosine = ts.cosine_lr

    def trip_at_epoch_2(base_lr, epoch, total):
        if epoch == 2:
            training._SHUTDOWN["requested"] = True
        return real_cosine(base_lr, epoch, total)

    monkeypatch.setattr(ts, "cosine_lr", trip_at_epoch_2)
    with pytest.raises(TrainingInterrupted):
        train_all(env)

    got = get_epoch_ckpts(env.model_path, "surrogate", 2)
    assert 1 in got and 2 not in got, got  # completed epoch durable only

    monkeypatch.setattr(ts, "cosine_lr", real_cosine)
    training._SHUTDOWN["requested"] = False
    env2 = ExpEnv(exp)
    train_all(env2)  # resumes: redoes epoch 2, runs conversions to final
    got = get_epoch_ckpts(env2.model_path, "surrogate", 2)
    assert 2 in got, got
    assert (env2.model_path / "final-epoch-0.ckpt").exists()


@pytest.mark.parametrize("backend", ["npz", "orbax"])
def test_opt_state_round_trip_both_backends(tmp_path, monkeypatch, backend):
    """save_opt_state/maybe_restore_opt_state preserve an optax pytree
    bit-exactly through BOTH checkpoint backends, and fail closed when the
    rebuilt optimizer's structure no longer matches."""
    import jax
    import jax.numpy as jnp
    import optax

    pytest.importorskip("orbax.checkpoint") if backend == "orbax" else None
    from autognothi.pipeline.resources import (
        maybe_restore_opt_state, save_opt_state,
    )

    monkeypatch.setenv("AUTOGNOTHI_CKPT_OPT", "1")
    monkeypatch.setenv("AUTOGNOTHI_CKPT_BACKEND", backend)
    params = {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.ones((3,))}
    tx = optax.adamw(1e-3)
    state = tx.init(params)
    # make moments non-trivial
    grads = jax.tree.map(jnp.ones_like, params)
    _, state = tx.update(grads, state, params)

    save_opt_state(tmp_path, "surrogate", 2, state)
    template = tx.init(params)
    restored = maybe_restore_opt_state(tmp_path, "surrogate", 2, template)
    for got, want in zip(jax.tree_util.tree_leaves(restored),
                         jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    # structure drift fails closed with an actionable message
    bigger = tx.init({**params, "extra": jnp.zeros((4,))})
    with pytest.raises(ValueError, match="leaves"):
        maybe_restore_opt_state(tmp_path, "surrogate", 2, bigger)

    # knob off -> template returned untouched (reference-parity rebuild)
    monkeypatch.setenv("AUTOGNOTHI_CKPT_OPT", "0")
    assert maybe_restore_opt_state(tmp_path, "surrogate", 2,
                                   template) is template


def test_exact_resume_is_bit_identical(tmp_path, monkeypatch):
    """AUTOGNOTHI_CKPT_OPT=1: interrupt mid-epoch-3, resume, and the final
    surrogate params are BIT-IDENTICAL to an uninterrupted run — Adam
    moments reload from the .opt.ckpt instead of rebuilding from zero
    (epoch seeds/lr are already derived, so moments were the only
    divergence source)."""
    from autognothi.pipeline import train_surrogate as ts
    from autognothi.pipeline import training
    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.resources import load_params_file
    from autognothi.pipeline.train_all import train_all
    from autognothi.pipeline.training import TrainingInterrupted

    monkeypatch.setenv("AUTOGNOTHI_CKPT_OPT", "1")
    epochs = 3

    (tmp_path / "a").mkdir()
    exp_a = _mini_exp(tmp_path / "a", surrogate_epochs=epochs)
    train_all(ExpEnv(exp_a))  # uninterrupted

    (tmp_path / "b").mkdir()
    exp_b = _mini_exp(tmp_path / "b", surrogate_epochs=epochs)
    real_cosine = ts.cosine_lr

    def trip_at_final_epoch(base_lr, epoch, total):
        if epoch == epochs:
            training._SHUTDOWN["requested"] = True
        return real_cosine(base_lr, epoch, total)

    monkeypatch.setattr(ts, "cosine_lr", trip_at_final_epoch)
    with pytest.raises(TrainingInterrupted):
        train_all(ExpEnv(exp_b))
    assert (exp_b / f"surrogate-epoch-{epochs - 1}.opt.ckpt").exists()

    monkeypatch.setattr(ts, "cosine_lr", real_cosine)
    training._SHUTDOWN["requested"] = False
    train_all(ExpEnv(exp_b))  # resume: redo the final epoch exactly

    a = load_params_file(exp_a / f"surrogate-epoch-{epochs}.ckpt")
    b = load_params_file(exp_b / f"surrogate-epoch-{epochs}.ckpt")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.slow
def test_cli_sigterm_exit_code_and_resume(tmp_path):
    """Full CLI contract: SIGTERM mid-`train_surrogate` exits 75 with the
    interrupt notice; rerunning the exact same command resumes and exits 0
    with all epochs checkpointed."""
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent.parent
    exp = _mini_exp(tmp_path, surrogate_epochs=8)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"

    def run(cmd, **kw):
        # JAX_PLATFORMS=cpu in env pins the backend (the conversion verbs
        # take no --device flag)
        return subprocess.run(
            [sys.executable, "main.py", cmd, str(exp)],
            cwd=repo, env=env, capture_output=True, text=True, timeout=600,
            **kw,
        )

    assert run("conv_pretrained_classifier").returncode == 0
    assert run("train_classifier").returncode == 0
    assert run("conv_classifier_surrogate").returncode == 0

    # surrogate run with a watcher: SIGTERM lands once epoch 1 is durable
    proc = subprocess.Popen(
        [sys.executable, "main.py", "train_surrogate", str(exp)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )

    def sigterm_after_epoch_1():
        deadline = time.time() + 540
        probe = exp / "surrogate-epoch-1.ckpt"  # model_path == exp dir
        while time.time() < deadline and proc.poll() is None:
            if probe.exists():
                proc.send_signal(signal.SIGTERM)
                return
            time.sleep(0.05)

    watcher = threading.Thread(target=sigterm_after_epoch_1, daemon=True)
    watcher.start()
    _out, err = proc.communicate(timeout=600)
    watcher.join(timeout=10)
    assert proc.returncode == 75, (proc.returncode, err[-2000:])
    assert "interrupted" in err

    done = run("train_surrogate")
    assert done.returncode == 0, done.stderr[-2000:]
    ckpts = sorted(exp.glob("surrogate-epoch-*.ckpt"))
    assert (exp / "surrogate-epoch-8.ckpt").exists(), ckpts


@pytest.mark.slow
def test_cli_serve_sigterm_drains_and_exits_cleanly(tmp_path):
    """`serve` under SIGTERM: answers requests, then drains in-flight
    handlers and exits 0 (instead of resetting connections mid-flight)."""
    import pathlib
    import socket
    import urllib.request

    repo = pathlib.Path(__file__).resolve().parent.parent
    exp = tmp_path / "vit_mini"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(MINI_VIT_HPARAMS, indent=2))

    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.train_all import train_all

    train_all(ExpEnv(exp))

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "main.py", "serve", str(exp), "--port", str(port),
         "--batch-size", "2"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    try:
        deadline = time.time() + 540
        url = f"http://127.0.0.1:{port}/healthz"
        while time.time() < deadline:
            if proc.poll() is not None:
                raise AssertionError(proc.communicate()[1][-2000:])
            try:
                with urllib.request.urlopen(url, timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                time.sleep(0.2)
        else:
            raise AssertionError("server never became healthy")

        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/explain",
            data=json.dumps(
                {"images": np.zeros((1, 3, 16, 16)).tolist()}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200

        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, (proc.returncode, err[-2000:])
        assert "draining" in _out + err
    finally:
        if proc.poll() is None:
            proc.kill()
