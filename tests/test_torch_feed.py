"""The double-buffered device feed of the PyTorch port
(``io.DeviceFeedIter``, the sync-free fit loop's host->device stage)
against the JAX package's (``mxnet_tpu/io.py:191``) on the CPU, each
placing with a CPU placement function: the same batches in the same
order over NDArrayIter's last-batch modes and epochs, one fetch
outstanding, ``close()`` mid-epoch handing the inner iterator back
reset, ``io.batches`` counted once per delivered batch by the wrapper,
and a bucketed batch's ``bucket_key`` / ``provide_*`` kept.  Batches
are compared exactly (the same numpy data, copied)."""
import time

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import io as jio
from mxnet_tpu_torch import io as tio

X = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
Y = np.arange(10, dtype=np.float32)


@pytest.fixture
def jax_metrics():
    was = mx.instrument.metrics_enabled()
    mx.instrument.set_metrics(True)
    yield
    mx.instrument.set_metrics(was)


def _feed(pkg, inner):
    if pkg is tmx:
        return tio.DeviceFeedIter(inner, lambda v: (
            v.handle if isinstance(v, tmx.nd.NDArray)
            else torch.as_tensor(np.asarray(v))).clone())
    return jio.DeviceFeedIter(inner, jax.device_put)


def _epochs(pkg, last, epochs=2):
    it = _feed(pkg, pkg.io.NDArrayIter(X, Y, batch_size=4,
                                       last_batch_handle=last))
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(([np.asarray(d.asnumpy()) for d in b.data],
                        [np.asarray(l.asnumpy()) for l in b.label], b.pad))
        it.reset()
    it.close()
    return out


@pytest.mark.parametrize('last', ['pad', 'discard', 'roll_over'])
def test_feed_delivers_the_same_batches_as_jax(last):
    got, want = _epochs(tmx, last), _epochs(mx, last)
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            np.testing.assert_array_equal(a, b)


class _Counting(object):
    """An NDArrayIter that counts the fetches the feed makes."""

    def __init__(self, pkg):
        self.inner = pkg.io.NDArrayIter(X, Y, batch_size=2)
        self.batch_size = 2
        self.fetches = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def next(self):
        self.fetches += 1
        return self.inner.next()

    __next__ = next

    def reset(self):
        self.inner.reset()


def _settle(feed, timeout=30.0):
    """Wait (bounded) until the feed's outstanding fetch has run."""
    deadline = time.monotonic() + timeout
    while feed._pending is not None and not feed._pending.done():
        assert time.monotonic() < deadline, 'the feed never fetched'
        time.sleep(0.001)


@pytest.mark.parametrize('pkg', [tmx, mx], ids=['torch', 'jax'])
def test_one_fetch_outstanding(pkg):
    inner = _Counting(pkg)
    feed = _feed(pkg, inner)
    _settle(feed)
    assert inner.fetches == 1           # primed, not consumed
    for k in range(1, 4):
        feed.next()
        _settle(feed)
        assert inner.fetches == k + 1   # the next one, never two ahead
    feed.close()


@pytest.mark.parametrize('pkg', [tmx, mx], ids=['torch', 'jax'])
def test_close_mid_epoch_resets_the_inner_iterator(pkg):
    inner = pkg.io.NDArrayIter(X, Y, batch_size=4)
    feed = _feed(pkg, inner)
    first = feed.next()
    feed.next()
    feed.close()
    assert inner._counts_io_batches is True
    again = inner.next()
    np.testing.assert_array_equal(again.data[0].asnumpy(),
                                  first.data[0].asnumpy())


def test_io_batches_counted_by_the_wrapper(jax_metrics):
    counts = []
    for pkg in (tmx, mx):
        pkg.instrument.reset_metrics()
        inner = pkg.io.NDArrayIter(X, Y, batch_size=4)
        feed = _feed(pkg, inner)
        n = sum(1 for _ in feed)
        _settle(feed)
        feed.close()
        counts.append((n, pkg.instrument.metrics_snapshot()['counters'].get(
            'io.batches', 0)))
        # the inner iterator counts again once the feed is closed
        inner.reset()
        inner.next()
        counts.append(pkg.instrument.metrics_snapshot()['counters'][
            'io.batches'])
    assert counts[0] == counts[2] == (3, 3)
    assert counts[1] == counts[3] == 4


def test_feed_keeps_bucket_keys_and_stages_bytes():
    tmx.instrument.reset_metrics()
    batch = tmx.io.DataBatch([tmx.nd.array(X[:4])], [tmx.nd.array(Y[:4])],
                             bucket_key=7, provide_data=[('data', (4, 3))],
                             provide_label=[('softmax_label', (4,))])

    class One(tmx.io.DataIter):
        def __init__(self):
            super().__init__()
            self.batch_size = 4
            self.done = False

        def next(self):
            if self.done:
                raise StopIteration
            self.done = True
            return batch

    feed = _feed(tmx, One())
    got = feed.next()
    assert got is not batch and got.bucket_key == 7
    assert got.provide_data == batch.provide_data
    assert got.provide_label == batch.provide_label
    assert not hasattr(got, 'ready_event')      # a CPU placement
    assert tmx.instrument.counter_value('io.h2d_prefetch_bytes') == \
        X[:4].nbytes + Y[:4].nbytes
    with pytest.raises(StopIteration):
        feed.next()
    feed.close()
