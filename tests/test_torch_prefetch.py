"""The port's device_prefetch (tpu_reid_torch/parallel/prefetch.py) on the
five cases of tests/test_prefetch.py: order and placement, depth 0 is
synchronous, errors of the source and of `place` re-raise in the consumer,
and abandoning the generator stops the worker. Then the StreamPlacer on the
CPU: host arrays become tensors, other leaves pass as they are."""

import threading

import numpy as np
import pytest
import torch

from tpu_reid_torch.parallel.prefetch import StreamPlacer, device_prefetch


def test_prefetch_order_and_place():
    out = list(device_prefetch(range(10), lambda x: x * 2, depth=3))
    assert out == [2 * i for i in range(10)]


def test_prefetch_depth_zero_is_synchronous():
    out = list(device_prefetch(range(5), lambda x: x + 1, depth=0))
    assert out == [1, 2, 3, 4, 5]


def test_prefetch_propagates_source_error():
    def gen():
        yield 1
        raise ValueError("decode failed")

    it = device_prefetch(gen(), None)
    assert next(it) == 1
    with pytest.raises(ValueError, match="decode failed"):
        next(it)


def test_prefetch_propagates_place_error():
    def bad_place(x):
        if x == 2:
            raise RuntimeError("transfer failed")
        return x

    it = device_prefetch(range(5), bad_place)
    assert next(it) == 0
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="transfer failed"):
        list(it)


def test_prefetch_worker_stops_on_abandon():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    it = device_prefetch(gen(), None, depth=2)
    next(it)
    it.close()  # abandon mid-stream
    # the worker unblocks within its 0.1 s put timeout and stops producing
    n_after_close = len(produced)
    threading.Event().wait(0.3)
    assert len(produced) <= n_after_close + 3  # bounded by the queue depth
    assert len(produced) < 1000


@pytest.mark.parametrize("depth", [0, 2])
def test_stream_placer_on_the_cpu(depth):
    """numpy leaves become CPU tensors sharing nothing of the structure's
    shape but its values; tensors, ints and nested tuples pass through."""
    rng = np.random.RandomState(0)
    items = [(i, (rng.randn(2, 3).astype(np.float32), torch.arange(3), rng.rand(4) > 0.5))
             for i in range(4)]
    placer = StreamPlacer("cpu")
    assert placer.stream is None
    out = list(device_prefetch(iter(items), placer, depth=depth))
    assert [o[0] for o in out] == [0, 1, 2, 3]
    for (_, (a, t, v)), (_, (ga, gt, gv)) in zip(items, out):
        assert isinstance(ga, torch.Tensor) and isinstance(gv, torch.Tensor)
        np.testing.assert_array_equal(ga.numpy(), a)
        np.testing.assert_array_equal(gv.numpy(), v)
        assert gv.dtype == torch.bool and gt is t
