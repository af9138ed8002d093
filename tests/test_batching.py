"""MicroBatcher: cross-request dynamic batching for the explanation server.

Pure packing-logic tests (the device function is injected), plus a
service-level coalescing test lives in tests/test_serve.py."""

import threading
import time

import numpy as np
import pytest

from autognothi.pipeline.batching import MicroBatcher, run_concurrent


def _echo_slab(xs):
    """Deterministic per-row 'model': (row sums, rows * 2)."""
    return (xs.reshape(xs.shape[0], -1).sum(axis=1), xs * 2.0)


def _expected(xs):
    return _echo_slab(np.asarray(xs))


def make(batch=4, window=0.05, run=_echo_slab):
    return MicroBatcher(run, batch_size=batch, window_s=window)


def test_single_request_exact_batch():
    b = make(batch=3, window=0.0)
    xs = np.arange(12.0).reshape(3, 4)
    sums, dbl = b.submit(xs)
    es, ed = _expected(xs)
    np.testing.assert_allclose(sums, es)
    np.testing.assert_allclose(dbl, ed)
    assert b.slab_count == 1
    b.close()


def test_partial_batch_padding_trimmed():
    b = make(batch=8, window=0.0)
    xs = np.random.RandomState(0).randn(3, 4)
    sums, dbl = b.submit(xs)
    assert sums.shape == (3,) and dbl.shape == (3, 4)
    np.testing.assert_allclose(dbl, xs * 2.0)
    b.close()


def test_oversized_request_spans_slabs():
    b = make(batch=4, window=0.0)
    xs = np.random.RandomState(1).randn(11, 2)
    sums, dbl = b.submit(xs)
    np.testing.assert_allclose(sums, xs.sum(axis=1))
    np.testing.assert_allclose(dbl, xs * 2.0)
    assert b.slab_count == 3  # 4 + 4 + 3(padded)
    b.close()


def test_concurrent_requests_coalesce():
    calls = []

    def counting(xs):
        calls.append(xs.shape[0])
        time.sleep(0.01)  # let the queue build
        return _echo_slab(xs)

    b = make(batch=8, window=0.2, run=counting)
    reqs = [np.full((2, 3), float(i)) for i in range(8)]  # 16 rows
    results = run_concurrent(b, reqs)
    for xs, (sums, dbl) in zip(reqs, results):
        np.testing.assert_allclose(sums, xs.sum(axis=1))
        np.testing.assert_allclose(dbl, xs * 2.0)
    # 16 rows / slab 8 -> 2 full slabs if coalescing worked (8 without)
    assert b.slab_count <= 4
    b.close()


def test_mixed_row_shapes_split_into_separate_slabs():
    b = make(batch=8, window=0.05)
    small = np.ones((2, 3))
    big = np.ones((2, 5))
    r_small, r_big = run_concurrent(b, [small, big])
    assert r_small[1].shape == (2, 3)
    assert r_big[1].shape == (2, 5)
    b.close()


def test_mixed_dtypes_split_into_separate_slabs():
    """f32 and u8 rows of the same shape never share a slab (each dtype has
    its own compiled executable — serve.py's images vs images_u8)."""
    dtypes = []

    def record(xs):
        dtypes.append(xs.dtype)
        assert xs.dtype in (np.float32, np.uint8)  # no silent upcast
        return _echo_slab(xs.astype(np.float64))

    b = MicroBatcher(record, batch_size=8, window_s=0.1)
    f32 = np.ones((2, 3), np.float32)
    u8 = np.full((2, 3), 128, np.uint8)
    r_f, r_u = run_concurrent(b, [f32, u8])
    np.testing.assert_allclose(r_f[0], [3.0, 3.0])
    np.testing.assert_allclose(r_u[0], [384.0, 384.0])
    assert set(dtypes) == {np.dtype(np.float32), np.dtype(np.uint8)}
    b.close()


def test_error_propagates_to_submitter_and_batcher_survives():
    state = {"fail": True}

    def flaky(xs):
        if state["fail"]:
            raise RuntimeError("boom")
        return _echo_slab(xs)

    b = make(batch=4, window=0.0, run=flaky)
    with pytest.raises(RuntimeError, match="boom"):
        b.submit(np.ones((6, 2)))  # spans 2 slabs; fails on the first
    state["fail"] = False
    sums, dbl = b.submit(np.ones((2, 2)))  # the batcher still serves
    np.testing.assert_allclose(sums, [2.0, 2.0])
    b.close()


def test_contract_violating_outputs_fail_the_take_not_the_thread():
    """A run_slab whose outputs violate the per-output <batch, ...>
    contract (scalar here) must surface as the submitter's error and leave
    the batcher alive — at depth>1 a dead completer would eventually block
    the dispatcher on the in-flight queue and hang every later submit()."""
    state = {"bad": True}

    def contract_breaker(xs):
        if state["bad"]:
            return (np.float32(1.0),)  # 0-d: o[used:used+n] raises
        return _echo_slab(xs)

    b = MicroBatcher(contract_breaker, batch_size=2, window_s=0.0, depth=2)
    with pytest.raises(RuntimeError):
        b.submit(np.ones((2, 2)))
    state["bad"] = False
    sums, _dbl = b.submit(np.ones((2, 2)))  # completer thread still alive
    np.testing.assert_allclose(sums, [2.0, 2.0])
    b.close()


def test_occupancy_stays_valid_when_a_slab_fails():
    """Failed slabs count toward capacity like their rows do — otherwise
    /statz occupancy exceeds 1.0 after any device error."""
    state = {"fail": True}

    def flaky(xs):
        if state["fail"]:
            raise RuntimeError("boom")
        return _echo_slab(xs)

    b = make(batch=4, window=0.0, run=flaky)
    with pytest.raises(RuntimeError):
        b.submit(np.ones((4, 2)))
    state["fail"] = False
    b.submit(np.ones((4, 2)))
    stats = b.stats()
    assert stats["slabs"] == 2 and stats["rows"] == 8
    assert stats["occupancy"] <= 1.0
    b.close()


def test_window_zero_runs_immediately():
    b = make(batch=64, window=0.0)
    t0 = time.monotonic()
    b.submit(np.ones((1, 2)))
    assert time.monotonic() - t0 < 1.0
    b.close()


def test_close_rejects_new_requests():
    b = make()
    b.close()
    with pytest.raises(RuntimeError):
        b.submit(np.ones((1, 2)))


def test_pipelined_depth2_matches_inline():
    """depth=2 (completer thread pays the fetch) returns identical results,
    including a request that spans multiple slabs."""
    b = MicroBatcher(_echo_slab, batch_size=4, window_s=0.0, depth=2)
    xs = np.random.RandomState(3).randn(11, 2)
    sums, dbl = b.submit(xs)
    np.testing.assert_allclose(sums, xs.sum(axis=1))
    np.testing.assert_allclose(dbl, xs * 2.0)
    assert b.slab_count == 3
    b.close()


def test_pipelined_lazy_finalize():
    """run_slab may return lazy handles; finalize materializes them on the
    completer side (the serve.py contract for device arrays)."""
    fetched = []

    def lazy_slab(xs):
        return (lambda: xs.sum(axis=1),)  # a "future"

    def finalize(outs):
        fetched.append(True)
        return tuple(np.asarray(o()) for o in outs)

    b = MicroBatcher(lazy_slab, batch_size=2, window_s=0.0, depth=3,
                     finalize=finalize)
    (sums,) = b.submit(np.ones((5, 4)))
    np.testing.assert_allclose(sums, np.full(5, 4.0))
    assert len(fetched) == b.slab_count == 3
    b.close()


def test_pipelined_fetch_error_propagates():
    """An error surfacing at finalize (how asynchronous device errors
    appear) reaches the submitter; the batcher keeps serving."""
    state = {"fail": True}

    def finalize(outs):
        if state["fail"]:
            raise RuntimeError("fetch-boom")
        return tuple(np.asarray(o) for o in outs)

    b = MicroBatcher(_echo_slab, batch_size=4, window_s=0.0, depth=2,
                     finalize=finalize)
    with pytest.raises(RuntimeError, match="fetch-boom"):
        b.submit(np.ones((2, 2)))
    state["fail"] = False
    sums, _ = b.submit(np.ones((2, 2)))
    np.testing.assert_allclose(sums, [2.0, 2.0])
    b.close()


def test_dispatcher_survives_completer_fail_during_window_wait():
    """Regression: with depth=2 and window>0, a fetch failure in the
    completer removes the spanning request from the queue while the
    dispatcher sleeps in its coalescing window — the dispatcher must not
    index the now-empty queue, and must keep serving afterwards."""
    state = {"fail": True}

    def finalize(outs):
        if state["fail"]:
            raise RuntimeError("fetch-boom")
        return tuple(np.asarray(o) for o in outs)

    b = MicroBatcher(_echo_slab, batch_size=4, window_s=0.3, depth=2,
                     finalize=finalize)
    errors = []

    def doomed():
        try:
            b.submit(np.ones((6, 2)))  # slab 1 (4 rows) + 2 pending rows
        except RuntimeError as exc:
            errors.append(exc)

    t = threading.Thread(target=doomed)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and len(errors) == 1
    state["fail"] = False
    sums, _ = b.submit(np.ones((2, 2)))  # the dispatcher must still be alive
    np.testing.assert_allclose(sums, [2.0, 2.0])
    b.close()


def test_pipelined_concurrent_correctness():
    """Concurrent distinct-valued requests through depth=2 each get exactly
    their own rows back (no cross-request mixups under pipelining)."""
    b = MicroBatcher(_echo_slab, batch_size=8, window_s=0.05, depth=2)
    reqs = [np.full((3, 2), float(i)) for i in range(10)]
    results = run_concurrent(b, reqs)
    for xs, (sums, dbl) in zip(reqs, results):
        np.testing.assert_allclose(sums, xs.sum(axis=1))
        np.testing.assert_allclose(dbl, xs * 2.0)
    b.close()


@pytest.mark.parametrize("depth,window", [(1, 0.0), (2, 0.01), (3, 0.05)])
def test_fuzz_concurrent_mixed_traffic(depth, window):
    """Randomized soak: concurrent requests of random sizes/shapes/dtypes
    with injected slab failures — every submit must return exactly its own
    rows (identity-checked per request) or the injected error, and the
    batcher must stay serviceable throughout."""
    rng = np.random.RandomState(depth * 100 + int(window * 1000))
    fail_every = {"n": 0}

    def flaky(xs):
        fail_every["n"] += 1
        if fail_every["n"] % 7 == 0:
            raise RuntimeError("injected")
        return _echo_slab(xs.astype(np.float64))

    b = MicroBatcher(flaky, batch_size=8, window_s=window, depth=depth)
    reqs = []
    for i in range(40):
        shape = (rng.randint(1, 20), rng.choice([2, 3]))
        dtype = rng.choice([np.float32, np.uint8])
        xs = (rng.randint(0, 100, size=shape).astype(dtype)
              + (i % 50))  # per-request fingerprint in the values
        reqs.append(xs.astype(dtype))
    results, errors = [None] * len(reqs), [None] * len(reqs)

    def worker(i):
        try:
            results[i] = b.submit(reqs[i])
        except RuntimeError as exc:
            errors[i] = exc

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)  # nobody hangs
    ok = 0
    for xs, res, err in zip(reqs, results, errors):
        if err is not None:
            # wrapped per-waiter (shared-traceback race); cause preserved
            assert "injected" in str(err)
            assert str(err.__cause__) == "injected"
            continue
        sums, dbl = res
        es, ed = _echo_slab(xs.astype(np.float64))
        np.testing.assert_allclose(sums, es)  # exactly this request's rows
        np.testing.assert_allclose(dbl, ed)
        ok += 1
    assert ok > 0  # the batcher kept serving between injected failures
    b.close()


def test_fifo_order_preserved_within_slab():
    """Requests that genuinely coexist in the queue share a slab with each
    request's rows contiguous (no interleaving)."""
    seen = []
    gate = threading.Event()

    def record(xs):
        gate.wait(5)  # hold the first slab until both requests are queued
        seen.append(xs.copy())
        return _echo_slab(xs)

    b = MicroBatcher(record, batch_size=4, window_s=0.0)
    blocker = threading.Thread(target=b.submit, args=(np.zeros((1, 2)),))
    blocker.start()
    time.sleep(0.05)  # dispatcher picks the blocker up, parks in record()
    threads = [threading.Thread(target=b.submit,
                                args=(np.full((2, 2), v),))
               for v in (1.0, 2.0)]
    for t in threads:
        t.start()
    time.sleep(0.2)  # both requests enqueue while the dispatcher is parked
    gate.set()
    for t in [blocker] + threads:
        t.join(timeout=10)
    b.close()
    # the two 2-row requests coalesced into one 4-row slab...
    assert any(s.shape[0] == 4 and set(s[:, 0]) == {1.0, 2.0} for s in seen)
    # ...and every slab's rows are request-contiguous (no interleaving)
    for slab in seen:
        vals = slab[:, 0]
        runs = [v for i, v in enumerate(vals) if i == 0 or vals[i - 1] != v]
        assert len(runs) == len(set(runs))
