"""Explanation server: end-to-end HTTP round trip over a trained final."""

import json
import pathlib
import urllib.request

import numpy as np
import pytest

from tests.test_train_all_e2e import MINI_VIT_HPARAMS


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    exp = tmp_path_factory.mktemp("serve") / "vit_mini"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(MINI_VIT_HPARAMS, indent=2))

    from autognothi.pipeline.env import ExpEnv
    from autognothi.pipeline.serve import serve_in_thread
    from autognothi.pipeline.train_all import train_all

    env = ExpEnv(exp)
    train_all(env)
    server, service, thread = serve_in_thread(env, port=0, batch_size=2)
    yield server, service
    server.shutdown()
    service.close()


def _post(server, path, payload):
    host, port = server.server_address
    req = urllib.request.Request(
        f"http://{host}:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_healthz(served):
    server, _ = served
    host, port = server.server_address
    with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok"}


def test_explain_images_round_trip(served):
    server, _ = served
    images = np.random.RandomState(0).randn(3, 3, 16, 16).tolist()
    status, body = _post(server, "/explain", {"images": images})
    assert status == 200
    logits = np.asarray(body["logits"])
    attr = np.asarray(body["attributions"])
    assert logits.shape == (3, 3)  # batch 3 (> server batch 2: chunked+padded)
    assert attr.shape == (3, 3, 4)
    np.testing.assert_allclose(logits.sum(axis=1), np.ones(3), atol=1e-4)


def test_explain_bad_payload(served):
    server, _ = served
    status, body = _post(server, "/explain", {"bogus": 1})
    assert status == 400
    assert "texts" in body["error"]


def test_explain_bare_string_texts_rejected(served):
    """A bare string must not silently explode into per-character docs."""
    server, _ = served
    status, body = _post(server, "/explain", {"texts": "great movie"})
    assert status == 400
    assert "list of strings" in body["error"]


def test_explain_empty_batch(served):
    server, _ = served
    status, body = _post(server, "/explain", {"images": []})
    assert status == 200
    assert body == {"logits": [], "attributions": []}


def test_explain_wrong_row_shape_is_400_not_a_recompile(served):
    """A novel row shape must bounce at the HTTP layer — reaching the
    dispatcher would retrace/recompile inside the single device thread
    (a stall behind a compile) instead of returning a 400."""
    server, _ = served
    # missing batch dim (<C, H, W> instead of <B, C, H, W>)
    status, body = _post(server, "/explain",
                         {"images": np.zeros((3, 16, 16)).tolist()})
    assert status == 400 and "rows must be shaped" in body["error"]
    # wrong spatial size
    status, body = _post(server, "/explain",
                         {"images": np.zeros((1, 3, 8, 8)).tolist()})
    assert status == 400 and "(3, 16, 16)" in body["error"]
    # wrong shape u8 path
    status, body = _post(
        server, "/explain",
        {"images_u8": np.zeros((1, 3, 16, 8), np.uint8).tolist()})
    assert status == 400 and "rows must be shaped" in body["error"]


def test_statz_reports_occupancy(served):
    server, service = served
    host, port = server.server_address
    # ensure at least one slab has run
    _post(server, "/explain",
          {"images": np.zeros((1, 3, 16, 16)).tolist()})
    with urllib.request.urlopen(f"http://{host}:{port}/statz",
                                timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["batch_size"] == service.batch_size
    assert stats["slabs"] >= 1 and stats["rows"] >= 1
    assert 0.0 < stats["occupancy"] <= 1.0
    assert stats["rows"] <= stats["slabs"] * stats["batch_size"]
    # end-to-end request latency distribution (recent requests)
    lat = stats["latency"]
    assert lat["count"] >= 1
    assert 0.0 < lat["p50_s"] <= lat["p95_s"] <= lat["p99_s"] <= lat["max_s"]
    assert lat["mean_s"] > 0.0


def test_explain_images_u8_wire_format(served):
    """uint8 pixels dequantize on device; result tracks the f32 path within
    quantization error of the inputs."""
    server, _ = served
    rng = np.random.RandomState(7)
    u8 = rng.randint(0, 256, size=(2, 3, 16, 16), dtype=np.uint8)
    status, body = _post(server, "/explain", {"images_u8": u8.tolist()})
    assert status == 200
    logits_u8 = np.asarray(body["logits"])
    assert logits_u8.shape == (2, 3)
    np.testing.assert_allclose(logits_u8.sum(axis=1), np.ones(2), atol=1e-4)
    # the f32 path on the dequantized pixels gives the same answer
    f32 = (u8.astype(np.float32) / 255.0).tolist()
    status, body = _post(server, "/explain", {"images": f32})
    assert status == 200
    np.testing.assert_allclose(
        logits_u8, np.asarray(body["logits"]), atol=1e-3)


def test_concurrent_requests_share_slabs(served):
    """Cross-request dynamic batching: 4 concurrent 1-image requests on a
    window>0 server coalesce into fewer device launches than requests."""
    import threading

    from autognothi.pipeline.serve import serve_in_thread

    _, service = served
    server2, service2, _ = serve_in_thread(
        service.env, port=0, batch_size=4, window_s=0.3
    )
    try:
        base = service2._batcher.slab_count
        rng = np.random.RandomState(1)
        images = [rng.randn(1, 3, 16, 16).tolist() for _ in range(4)]
        results = [None] * 4

        def post(i):
            results[i] = _post(server2, "/explain", {"images": images[i]})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i, (status, body) in enumerate(results):
            assert status == 200
            logits = np.asarray(body["logits"])
            assert logits.shape == (1, 3)
            np.testing.assert_allclose(logits.sum(axis=1), [1.0], atol=1e-4)
        # 4 rows, slab 4: full coalescing = 1 launch; allow scheduler slack
        assert service2._batcher.slab_count - base <= 3
        # no cross-request row mixups: a coalesced answer equals a solo one
        # (fw_final is per-row independent, so slab packing cannot change it)
        _, body_solo = _post(server2, "/explain", {"images": images[2]})
        np.testing.assert_allclose(
            np.asarray(results[2][1]["logits"]),
            np.asarray(body_solo["logits"]), atol=1e-5,
        )
    finally:
        server2.shutdown()
        service2.close()


def test_serve_from_export_artifact(served, tmp_path):
    # the AOT deployment artifact (export_final) plugs straight into the
    # serving layer: no checkpoints read, fixed batch dictated by the
    # program, same answers as checkpoint-backed serving
    server, service = served
    from autognothi.pipeline.export import export_final
    from autognothi.pipeline.serve import serve_in_thread

    art = tmp_path / "final.jaxexp"
    export_final(service.env, art, batch_size=2, platforms=["cpu"])
    server2, service2, _ = serve_in_thread(service.env, port=0, artifact=art)
    try:
        assert service2.batch_size == 2  # artifact dictates the slab size
        images = np.random.RandomState(1).randn(2, 3, 16, 16)
        _, ckpt_body = _post(server, "/explain", {"images": images.tolist()})
        status, art_body = _post(server2, "/explain", {"images": images.tolist()})
        assert status == 200
        np.testing.assert_allclose(
            art_body["logits"], ckpt_body["logits"], atol=1e-4)
        np.testing.assert_allclose(
            art_body["attributions"], ckpt_body["attributions"], atol=1e-4)

        # uint8 wire rows dequantize at the device boundary (the exported
        # program itself only knows the recipe's input dtype)
        u8 = (np.random.RandomState(2).rand(2, 3, 16, 16) * 255).astype(np.uint8)
        status, body = _post(server2, "/explain", {"images_u8": u8.tolist()})
        assert status == 200
        ref = service2._fw(
            service2.final_params, (u8.astype(np.float32) / 255.0))
        np.testing.assert_allclose(
            body["logits"], np.asarray(ref[0]), atol=1e-4)
    finally:
        server2.shutdown()
        service2.close()
