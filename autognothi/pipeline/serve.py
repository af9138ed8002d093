"""Explanation serving: a minimal production endpoint over the final model.

Beyond the reference's file-based demos, this serves (logits, Shapley
attributions) over HTTP with jit-stable fixed-shape batching: requests are
padded up to the compiled batch size, so the server runs exactly one
executable after warmup.

    python ./main.py serve <experiment_dir> --port 8321 --batch-size 8

    POST /explain {"texts": ["..."]}            # text models
    POST /explain {"images": [[[...]]], ...}    # image models (<C, H, W>)
    POST /explain {"images_u8": [[[...]]], ...} # uint8 pixels, dequantized
                                                # on device (4x less wire +
                                                # host->device traffic)
    GET  /healthz
    GET  /statz                                 # slab-occupancy diagnostics
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .batching import MicroBatcher
from .env import ExpEnv
from .resources import get_recipe, load_epoch_model


class ExplainService:
    def __init__(self, env: ExpEnv, batch_size: int = 8,
                 window_s: float = 0.0,
                 u8_dequant: Tuple[float, float] = (1.0 / 255.0, 0.0),
                 artifact=None):
        self.env = env
        self.recipe, self.m_config = get_recipe(env.config)
        self.misc = self.recipe.load_misc(env.model_path, self.m_config)
        self.gen_input = self.recipe.gen_input(self.m_config, self.misc)
        # the model's per-row input shape: image payloads are validated
        # against it BEFORE they reach the dispatcher — a novel row shape
        # would otherwise retrace/recompile inside the single device thread
        # (stalling every request behind a compile) instead of returning a
        # 400
        self._row_shape = tuple(np.asarray(
            self.recipe.gen_null(self.m_config, self.misc)).shape[1:])

        if artifact is not None:
            # serve an `export_final` artifact: the program + weights are the
            # deployment unit — no checkpoints are read, and the device math
            # is byte-for-byte what was exported (weights ride as runtime
            # arguments precisely so this matches the live path).  Fixed-
            # batch artifacts dictate the slab size; batch-polymorphic ones
            # (--batch-size 0) keep the requested one.  A mesh-sharded
            # artifact (export_final --data-parallel N) binds to the first
            # N local devices: weights replicated, slab rows split along
            # "data" — fails closed in load_exported when fewer exist.
            from .export import load_exported

            call = load_exported(artifact)
            null = np.asarray(self.recipe.gen_null(self.m_config, self.misc))
            if tuple(call.in_shape[1:]) != self._row_shape or (
                    np.dtype(call.in_dtype) != null.dtype):
                # fail closed at startup: a mismatched artifact would serve
                # /healthz 200 while every /explain dies with an opaque
                # aval error inside the dispatcher
                raise RuntimeError(
                    f"artifact {artifact} expects rows "
                    f"{tuple(call.in_shape[1:])} {call.in_dtype}, but this "
                    f"experiment's model takes {null.shape[1:]} "
                    f"{null.dtype} — it was exported from a different "
                    "experiment/config")
            if call.in_shape[0] is not None:
                batch_size = call.in_shape[0]
            env.log(f"[[[ serving artifact {artifact}: input "
                    f"{call.in_shape} {call.in_dtype}, platforms "
                    f"{call.platforms}, devices {call.nr_devices} "
                    f"(batch {batch_size}) ]]]")
            scale, offset = u8_dequant
            # call.pcall is the exported program jitted with the weights as
            # runtime arguments; the u8 wire-format dequant traces into the
            # SAME executable, so a u8 slab costs one dispatch like the
            # checkpoint path (not 3 eager ops + an f32 intermediate)
            self._fw = lambda p, xs: call.pcall(p, xs)
            self._fw_u8 = jax.jit(lambda p, xs: call.pcall(
                p, xs.astype(call.in_dtype) * scale + offset))
            self.final_params = call.params
            self.batch_size = batch_size
            self._place_batch = call.place_batch
            self._init_batcher(window_s)
            return
        _, self.final_params = load_epoch_model(env, self.recipe, "final")

        # multi-device: replicate params, shard the request batch along
        # "data" (the same placement the trainers and eval reports use).
        # The compiled batch is rounded up to a mesh multiple so every slab
        # shards evenly — requests are padded to it anyway.
        from ..parallel.mesh import setup_data_parallel, sharded_serving_fn

        mesh, place_params, place_batch = setup_data_parallel()
        fw = lambda p, xs: self.recipe.fw_final(self.m_config, p, xs)  # noqa: E731
        # uint8 wire format: dequantize on DEVICE (server-configured affine),
        # so the host->device link carries 1 byte/pixel instead of 4
        scale, offset = u8_dequant
        fw_u8 = lambda p, xs: fw(  # noqa: E731
            p, xs.astype(jnp.float32) * scale + offset)
        if self.recipe.fw_final_host:
            # host-side final (KernelSHAP): no jit, no mesh placement —
            # including the batch placer (device_putting a slab across the
            # mesh only for host-side WLS to pull it straight back)
            self._fw, self._fw_u8 = fw, fw_u8
            mesh = None
            place_batch = lambda tree: tree  # noqa: E731
        elif mesh is not None:
            n = mesh.devices.size
            batch_size = ((batch_size + n - 1) // n) * n
            env.log(f"[[[ serving sharded over {n} devices "
                    f"(batch {batch_size}) ]]]")
            self.final_params = place_params(self.final_params)
            # shard_map (not plain GSPMD jit): the attention kernel would
            # otherwise run replicated behind all-gathers
            self._fw = sharded_serving_fn(fw, mesh)
            self._fw_u8 = sharded_serving_fn(fw_u8, mesh)
        else:
            self._fw = jax.jit(fw)
            self._fw_u8 = jax.jit(fw_u8)
        self.batch_size = batch_size
        self._place_batch = place_batch
        self._init_batcher(window_s)

    def _init_batcher(self, window_s: float) -> None:
        # cross-request dynamic batching: one dispatcher thread owns every
        # device call and packs rows from concurrent HTTP handlers into one
        # compiled slab.  window 0 still coalesces under load — while the
        # device runs a slab, new requests queue and ride the next one.
        # depth=2 pipelines the device->host result fetch (the completer
        # fetches slab N while the dispatcher launches N+1 — the fetch is
        # the synchronous part of a serving step).
        def _run_slab(slab: np.ndarray):
            # dtype-homogeneous slabs (the batcher splits on row dtype);
            # uint8 slabs run the dequantizing executable
            run = self._fw_u8 if slab.dtype == np.uint8 else self._fw
            return run(  # lazy device arrays; the completer fetches
                self.final_params, self._place_batch(jnp.asarray(slab))
            )

        self._batcher = MicroBatcher(_run_slab, self.batch_size,
                                     window_s=window_s, depth=2)

    def close(self) -> None:
        self._batcher.close()

    def warmup(self) -> None:
        null = np.repeat(
            np.asarray(self.recipe.gen_null(self.m_config, self.misc)),
            self.batch_size, axis=0,
        )
        out = self._fw(self.final_params, self._place_batch(jnp.asarray(null)))
        # fetch the result like an answer does: the server reports ready
        # only once the executable has compiled and run
        np.asarray(jax.tree.leaves(out)[0])
        if np.issubdtype(null.dtype, np.floating):
            # image models: also compile the uint8 wire-format executable
            # now — it would otherwise compile inside the single dispatcher
            # thread at the first images_u8 request, stalling ALL traffic
            # for the compile warmup exists to prevent
            u8 = np.clip(null * 255.0, 0, 255).astype(np.uint8)
            out = self._fw_u8(
                self.final_params, self._place_batch(jnp.asarray(u8)))
            np.asarray(jax.tree.leaves(out)[0])

    def explain(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if "texts" in payload:
            if isinstance(payload["texts"], str):
                # a bare string would silently explode into per-character
                # "documents" via list()
                raise ValueError("'texts' must be a list of strings")
            raw = list(payload["texts"])
            if not raw:  # gen_input cannot stack an empty batch
                return {"logits": [], "attributions": []}
            xs, _ = self.gen_input(raw, [0] * len(raw))
        elif "images" in payload:
            try:
                xs = np.asarray(payload["images"], dtype=np.float32)
            except (ValueError, TypeError) as err:
                raise ValueError(
                    "'images' must be a rectangular numeric array of shape "
                    f"<B, C, H, W> ({err})"
                ) from err
        elif "images_u8" in payload:
            # compact wire format: uint8 pixels + affine dequant, applied on
            # DEVICE (x * scale + offset) — 4x less host->device traffic
            # than f32 rows (playground/bench_serve.py)
            try:
                xs = np.asarray(payload["images_u8"], dtype=np.uint8)
            except (ValueError, TypeError) as err:
                raise ValueError(
                    "'images_u8' must be rectangular uint8 <B, C, H, W> "
                    f"({err})"
                ) from err
        else:
            raise ValueError("payload needs 'texts', 'images' or 'images_u8'")
        if xs.shape[0] == 0:
            return {"logits": [], "attributions": []}
        if "texts" not in payload and tuple(xs.shape[1:]) != self._row_shape:
            raise ValueError(
                f"image rows must be shaped {self._row_shape} "
                f"(<C, H, W> for this model); got rows {tuple(xs.shape[1:])} "
                f"from payload shape {tuple(xs.shape)}")

        # the batcher slabs/pads to the compiled batch size and coalesces
        # rows across concurrent requests; oversized requests span slabs
        logits, attr = self._batcher.submit(np.asarray(xs))
        return {
            "logits": logits.tolist(),
            "attributions": attr.tolist(),
        }


def make_server(
    service: ExplainService, host: str = "127.0.0.1", port: int = 8321
) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code: int, body: Dict[str, Any]) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/statz":
                # slab occupancy: how well concurrent traffic coalesces
                self._reply(200, service._batcher.stats())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/explain":
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except Exception as exc:  # noqa: BLE001 — malformed request
                self._reply(400, {"error": str(exc)})
                return
            try:
                self._reply(200, service.explain(payload))
            except (ValueError, json.JSONDecodeError) as exc:
                self._reply(400, {"error": str(exc)})  # client payload
            except Exception as exc:  # noqa: BLE001 — server/device fault
                self._reply(500, {"error": str(exc)})

    return ThreadingHTTPServer((host, port), Handler)


def serve(env: ExpEnv, host: str, port: int, batch_size: int,
          window_s: float = 0.0,
          u8_dequant: Tuple[float, float] = (1.0 / 255.0, 0.0),
          artifact=None) -> None:
    import signal

    service = ExplainService(env, batch_size, window_s=window_s,
                             u8_dequant=u8_dequant, artifact=artifact)
    env.log("[[[ warming up the compiled explain step... ]]]")
    service.warmup()
    server = make_server(service, host, port)

    # make server_close() actually JOIN in-flight handler threads:
    # ThreadingHTTPServer defaults daemon_threads=True, and socketserver's
    # _Threads.append SKIPS daemon threads — with the default, block_on_close
    # joins nothing and process exit kills handlers mid-response-write
    server.daemon_threads = False

    draining = {"requested": False}

    def _drain(signum, frame):
        if draining["requested"]:
            # second TERM: a wedged drain (device hang) must stay killable.
            # prev None (handler installed at C level) falls back to
            # SIG_DFL — re-raising into THIS handler would loop forever
            restored = (prev_term if callable(prev_term) or prev_term
                        in (signal.SIG_DFL, signal.SIG_IGN)
                        else signal.SIG_DFL)
            signal.signal(signal.SIGTERM, restored)
            signal.raise_signal(signal.SIGTERM)
            return
        draining["requested"] = True
        # shutdown() blocks until serve_forever's poll loop exits — it must
        # run off the main thread (the handler interrupts that very loop)
        env.log("[[[ SIGTERM — draining in-flight requests ]]]")
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        prev_term = signal.signal(signal.SIGTERM, _drain)
    except ValueError:  # not the main thread (serve_in_thread path)
        prev_term = None
    env.log(f"[[[ serving explanations on http://{host}:{port} ]]]")
    try:
        server.serve_forever()
    finally:
        # join in-flight handler threads (they may still be inside
        # batcher.submit) BEFORE the batcher they depend on goes away
        server.server_close()
        service.close()
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
    env.log("[[[ serve: drained and closed ]]]")


def serve_in_thread(
    env: ExpEnv, host: str = "127.0.0.1", port: int = 0, batch_size: int = 4,
    window_s: float = 0.0, artifact=None,
):
    """Test helper: returns (server, service, thread); port 0 picks a free one."""
    service = ExplainService(env, batch_size, window_s=window_s,
                             artifact=artifact)
    service.warmup()
    server = make_server(service, host, port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, service, thread
