import numpy as np

from autognothi.utils.functional import batched, iter_fixed_batches, pad_to


def test_pad_to_edge():
    x = np.array([[1, 2], [3, 4]])
    y = pad_to(x, 4, axis=0)
    assert y.shape == (4, 2)
    np.testing.assert_array_equal(y[2], [3, 4])
    np.testing.assert_array_equal(y[3], [3, 4])


def test_batched_rechunking_alignment():
    sizes = [3, 5, 1, 7, 2]
    items = [np.full((s, 2), i, dtype=np.float32) for i, s in enumerate(sizes)]
    seen_batch_sizes = []

    def op(x):
        seen_batch_sizes.append(x.shape[0])
        return x * 10

    outs = list(batched(lambda: iter(items), lambda x: x, op, batch_size=4))
    assert len(outs) == len(items)
    for i, (out, size) in enumerate(zip(outs, sizes)):
        assert out.shape == (size, 2)
        np.testing.assert_array_equal(out, np.full((size, 2), i * 10))
    # every invocation saw the fixed batch size (jit-stable shapes)
    assert all(b == 4 for b in seen_batch_sizes)


def test_iter_fixed_batches_pads_final():
    xs = np.arange(10)
    ys = np.arange(10) * 2
    batches = list(iter_fixed_batches([xs, ys], batch_size=4))
    assert len(batches) == 3
    (bx, by), real = batches[-1]
    assert bx.shape == (4,)
    assert real == 2
    assert bx[0] == 8 and bx[1] == 9 and bx[2] == 9  # edge padded


def test_batched_zero_row_workloads_yield_empty_outputs():
    """A decorator that expands an item into ZERO workload rows still gets
    one (empty) yielded output — np.concatenate([]) used to raise; the
    torch reference yields per-item outputs for such items."""
    items = [np.ones((2, 3)), np.ones((0, 3)), np.ones((1, 3)),
             np.ones((0, 3))]

    outs = list(batched(lambda: iter(items), lambda x: x,
                        lambda x: x * 2, batch_size=4))
    assert [o.shape[0] for o in outs] == [2, 0, 1, 0]
    np.testing.assert_array_equal(outs[0], np.full((2, 3), 2.0))
    np.testing.assert_array_equal(outs[2], np.full((1, 3), 2.0))


def test_batched_all_empty_items():
    outs = list(batched(lambda: iter([np.ones((0, 3))] * 2), lambda x: x,
                        lambda x: x, batch_size=4))
    assert [o.shape[0] for o in outs] == [0, 0]
