"""Port parity for ``io.prefetch_to_device`` (after
``tests/test_train_loop.py::TestPrefetchToDevice``, its six cases) on the
CPU, where the copies are plain: the same batches come out as from JAX's
prefetcher, in order, with the bytes counted; the producer runs at most
``depth`` batches ahead; a source error surfaces after the batches
already moved; breaking out closes the source.  Values are compared
exactly (a copy)."""
import numpy as np
import pytest
import torch

from paddle_tpu.io import prefetch_to_device as jax_prefetch
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.io import prefetch_to_device


def test_order_values_and_placement():
    batches = [(np.full((2, 4), i, "f4"), np.full((2, 1), i, "f4"))
               for i in range(5)]
    before = tio.TRAIN_H2D_BYTES.value
    out = list(prefetch_to_device(iter(batches), device="cpu", depth=2))
    want = list(jax_prefetch(iter(batches), depth=2))
    assert len(out) == len(want) == 5
    for i, ((x, y), (jx, jy)) in enumerate(zip(out, want)):
        assert torch.is_tensor(x) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), batches[i][0])
        np.testing.assert_array_equal(y.numpy(), batches[i][1])
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    # 5 batches * (32 + 8) bytes
    assert tio.TRAIN_H2D_BYTES.value - before == 5 * 40


def test_respects_device():
    """The port's counterpart of the sharding case: the batch lands on
    the requested device, whatever the leaf type and nesting."""
    batch = {"ids": np.arange(6, dtype=np.int64).reshape(2, 3),
             "pair": [torch.ones(2), np.zeros((1,), np.float32)]}
    (x,) = list(prefetch_to_device(iter([batch]), device="cpu", depth=1))
    assert x["ids"].device == torch.device("cpu")
    assert x["ids"].dtype == torch.int64
    assert isinstance(x["pair"], list) and x["pair"][0].dtype == \
        torch.float32
    np.testing.assert_array_equal(x["ids"].numpy(), batch["ids"])


def test_runs_ahead_by_depth_only():
    pulled = []

    def src():
        for i in range(8):
            pulled.append(i)
            yield np.zeros((1,), "f4")

    consumed = 0
    for _ in prefetch_to_device(src(), device="cpu", depth=3):
        consumed += 1
        assert len(pulled) <= consumed + 3
        if consumed == 4:
            break


def test_exception_after_good_batches():
    def src():
        yield np.ones((2,), "f4")
        yield np.ones((2,), "f4") * 2
        raise ValueError("torn source")

    got = []
    with pytest.raises(ValueError, match="torn source"):
        for b in prefetch_to_device(src(), device="cpu", depth=2):
            got.append(float(b.sum()))
    assert got == [2.0, 4.0]


def test_closes_source_on_break():
    closed = []

    def src():
        try:
            for _ in range(100):
                yield np.zeros((1,), "f4")
        finally:
            closed.append(True)

    gen = prefetch_to_device(src(), device="cpu", depth=2)
    next(gen)
    gen.close()
    assert closed == [True]


def test_rejects_bad_depth():
    with pytest.raises(ValueError):
        list(prefetch_to_device(iter([]), device="cpu", depth=0))
    with pytest.raises(ValueError):
        list(jax_prefetch(iter([]), depth=0))


def test_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        list(prefetch_to_device(iter([np.zeros(1)])))
