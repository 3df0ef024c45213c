"""Pinned staging of ``ImageRecordIter`` on the card (``@pytest.mark.cuda``;
it skips without a CUDA device and imports no jax, so it runs on the GPU
host: ``python -m pytest tests/test_torch_pinned_cuda.py -q -m cuda
--noconftest``).

When the device feed stages to the card, the iterator decodes into a
small pool of pinned host buffers that the feed's asynchronous copy
reads directly (``io_record._PinnedPool``).  A buffer goes back to the
pool with the event recorded after that copy, and is not written again
before the event has completed.

- The hazard is real: a buffer reused at once, its copy still queued
  behind a busy stream, is overwritten before the copy reads it.
- With its event, the same reuse waits, and the copy reads the batch.
- Through ``DeviceFeedIter``, every staged batch equals the batch the
  same iterator gives on the host (pinning off), with at most the pool's
  buffers made; closing the feed turns pinning off."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import instrument, recordio
from mxnet_tpu_torch.io_record import _PinnedPool

SPIN = 200_000_000      # GPU cycles the copy's stream is held (~0.1 s)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (pinned memory and streams)')
    was = instrument.metrics_enabled()
    instrument.set_metrics(True)        # io.pinned_buffers counts
    yield torch.device('cuda', 0)
    instrument.set_metrics(was)


def _queued_copy(buf, dev):
    """``buf`` copied to the card on a stream held busy first: the copy
    is enqueued, not run.  The copy and the event recorded after it."""
    stream = torch.cuda.Stream(dev)
    with torch.cuda.stream(stream):
        torch.cuda._sleep(SPIN)
        dst = buf.to(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return dst, event


@pytest.mark.cuda
def test_a_buffer_reused_at_once_is_overwritten(dev):
    pool = _PinnedPool((4, 3, 32, 32), 1)
    buf = pool.take()
    assert buf.is_pinned()
    buf.fill_(1.0)
    dst, event = _queued_copy(buf, dev)
    pool.give(buf)                      # no event: the hazard
    again = pool.take()
    assert again.data_ptr() == buf.data_ptr()
    assert not event.query()            # the copy has not run yet
    again.fill_(-1.0)                   # the producer's next decode
    torch.cuda.synchronize()
    assert torch.equal(dst.cpu(), torch.full(buf.shape, -1.0))


@pytest.mark.cuda
def test_the_copys_event_holds_the_buffer_back(dev):
    pool = _PinnedPool((4, 3, 32, 32), 1)
    buf = pool.take()
    buf.copy_(torch.arange(buf.numel(), dtype=torch.float32)
              .view(buf.shape))
    want = buf.clone()
    dst, event = _queued_copy(buf, dev)
    pool.give(buf, event)
    again = pool.take()                 # waits for the copy
    assert again.data_ptr() == buf.data_ptr() and event.query()
    again.fill_(-1.0)
    torch.cuda.synchronize()
    assert torch.equal(dst.cpu(), want)


def _rec(tmp_path, n=24):
    rng = np.random.default_rng(0)
    w = recordio.MXRecordIO(str(tmp_path / 'p.rec'), 'w')
    for i in range(n):
        img = rng.integers(0, 256, (48, 56, 3), dtype=np.uint8)
        w.write(recordio.pack_img(recordio.IRHeader(0, float(i), i, 0),
                                  np.sort(img, axis=1), quality=90))
    w.close()
    return str(tmp_path / 'p.rec')


@pytest.mark.cuda
def test_the_feed_stages_every_pinned_batch_as_decoded(dev, tmp_path):
    path = _rec(tmp_path)
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=4,
              rand_crop=True, rand_mirror=True, shuffle=True, seed=7,
              preprocess_threads=2, prefetch_buffer=2)
    host = [b.data[0].asnumpy() for b in tmx.io.ImageRecordIter(**kw)]
    it = tmx.io.ImageRecordIter(**kw)
    made = instrument.counter_value('io.pinned_buffers')

    def place(value):
        t = value.handle if isinstance(value, tmx.nd.NDArray) else \
            torch.as_tensor(np.asarray(value))
        return t.pin_memory().to(dev, non_blocking=True)
    for epoch in range(2):
        if epoch:
            it.reset()
        feed = tmx.io.DeviceFeedIter(it, place, device=dev)
        assert it._pool is not None
        staged = []
        for batch in feed:
            # consumed as executor_group.load_batch does: the compute
            # stream waits for the staging event, and the staged tensor
            # is recorded on it
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(batch.ready_event)
            src = batch.data[0].handle
            staged.append(src.clone())
            src.record_stream(stream)
            torch.cuda._sleep(SPIN // 20)   # a step on the card
        feed.close()
        assert it._pool is None
        if epoch == 0:
            assert len(staged) == len(host)
            for got, want in zip(staged, host):
                np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert instrument.counter_value('io.pinned_buffers') - made <= 2 * (
        kw['prefetch_buffer'] + 2 + 2)
    it.close()
