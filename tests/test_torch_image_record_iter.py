"""``io.ImageRecordIter`` of the port against the JAX package's on the CPU
(``mxnet_tpu_torch/io_record.py`` over ``csrc/host/recordio.cc``).

The port decodes with its own baseline JPEG codec, which gives libjpeg's
pixels (``tests/test_torch_recordio.py``), and keeps the JAX package's
augmenter arithmetic line for line, compiled with the same flags: the
batches are compared bit for bit (tolerance: exact), over ``.rec`` files
written by either package, with the augmenter off and with each extended
knob alone (the cases of ``tests/test_augmenter.py``), across two
shuffled epochs, with ``round_batch`` padding, ``label_width`` > 1.  The
port's own behaviours: the iowatch stages and the queue gauge, an error
of the producer (an image the codec refuses, a fault injected at
``io.read``) raised at the consumer's next batch, and a bounded close.
Every wait is bounded."""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import iowatch as jiowatch
from mxnet_tpu import recordio as jrec
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import instrument, io_record, iowatch, resilience
from mxnet_tpu_torch import recordio as trec

SIZE = 32


def _image(rng, h=None, w=None):
    h = h or int(rng.integers(40, 90))
    w = w or int(rng.integers(40, 90))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a = rng.uniform(0.03, 0.3, 3)
    img = np.stack([128 + 100 * np.sin(xx * a[0] + rng.uniform(0, 6)),
                    128 + 100 * np.cos(yy * a[1]),
                    (xx * a[2] * 20 + yy) % 256], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _write(path, pkg, n=10, seed=0, labels=None):
    rng = np.random.default_rng(seed)
    w = pkg.MXRecordIO(str(path), 'w')
    for i in range(n):
        label = float(i % 7) if labels is None else labels(i)
        w.write(pkg.pack_img(pkg.IRHeader(0, label, i, 0), _image(rng),
                             quality=95))
    w.close()
    return str(path)


@pytest.fixture(scope='module')
def recs(tmp_path_factory):
    d = tmp_path_factory.mktemp('recs')
    return {'port': _write(d / 'port.rec', trec, seed=1),
            'jax': _write(d / 'jax.rec', jrec, seed=2)}


def _epochs(pkg, path, epochs=1, **kw):
    kw.setdefault('data_shape', (3, SIZE, SIZE))
    kw.setdefault('batch_size', 4)
    kw.setdefault('preprocess_threads', 2)
    it = pkg.io.ImageRecordIter(path_imgrec=path, **kw)
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
    it.close()
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for ge, we in zip(got, want):
        assert len(ge) == len(we)
        for (gd, gl, gp), (wd, wl, wp) in zip(ge, we):
            assert gd.dtype == wd.dtype == np.float32
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
            assert gp == wp


# the cases of tests/test_augmenter.py, each extended knob alone
CASES = {
    'off': {},
    'crop-mirror-mean': dict(rand_crop=True, rand_mirror=True, mean_r=123.68,
                             mean_g=116.779, mean_b=103.939, std_r=58.4,
                             std_g=57.1, std_b=57.4),
    'rotate': dict(max_rotate_angle=30),
    'shear': dict(max_shear_ratio=0.3),
    'aspect-crop-size': dict(rand_crop=True, max_aspect_ratio=0.5,
                             min_crop_size=40, max_crop_size=80),
    'scale': dict(rand_crop=True, min_random_scale=0.533,
                  max_random_scale=1.0),
    'hsl-l': dict(random_l=80),
    'hsl-h': dict(random_h=60),
    'hsl-s': dict(random_s=50),
    'all': dict(rand_crop=True, rand_mirror=True, max_rotate_angle=20,
                max_shear_ratio=0.2, max_aspect_ratio=0.3, random_h=30,
                random_s=30, random_l=30),
}


@pytest.mark.parametrize('writer', ['port', 'jax'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_batches_equal_the_jax_packages(recs, writer, case):
    kw = dict(CASES[case], seed=5)
    _assert_same(_epochs(tmx, recs[writer], **kw),
                 _epochs(mx, recs[writer], **kw))


def test_shuffle_across_two_epochs(recs):
    kw = dict(shuffle=True, rand_crop=True, rand_mirror=True, seed=3)
    got = _epochs(tmx, recs['jax'], epochs=2, **kw)
    _assert_same(got, _epochs(mx, recs['jax'], epochs=2, **kw))
    # the second epoch is another order and other crops
    assert not np.array_equal(got[0][0][0], got[1][0][0])
    kw['shuffle_chunk_seed'] = 9
    _assert_same(_epochs(tmx, recs['jax'], epochs=2, **kw),
                 _epochs(mx, recs['jax'], epochs=2, **kw))


@pytest.mark.parametrize('round_batch', [True, False])
def test_round_batch(recs, round_batch):
    kw = dict(batch_size=4, round_batch=round_batch, seed=2)
    got = _epochs(tmx, recs['port'], **kw)
    _assert_same(got, _epochs(mx, recs['port'], **kw))
    assert [p for _, _, p in got[0]] == ([0, 0, 2] if round_batch
                                         else [0, 0])


def test_label_width(tmp_path):
    path = _write(tmp_path / 'multi.rec', trec, n=6,
                  labels=lambda i: [float(i), i + 0.5, -1.0][:1 + i % 3])
    kw = dict(label_width=3, batch_size=3, seed=1)
    got = _epochs(tmx, path, **kw)
    _assert_same(got, _epochs(mx, path, **kw))
    assert got[0][0][1].shape == (3, 3)
    it = tmx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                                **kw)
    jt = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                               **kw)
    assert it.provide_data == jt.provide_data
    assert it.provide_label == jt.provide_label
    it.close()
    jt.close()


@pytest.fixture
def planes_on():
    """iowatch on in both packages for the test, then both packages'
    plane and metrics registry as they were (later files on the worker
    must not find them on)."""
    from mxnet_tpu import instrument as jinstrument
    state = [(io, ins, io.enabled(), ins.metrics_enabled())
             for io, ins in ((iowatch, instrument),
                             (jiowatch, jinstrument))]
    for io, _, _, _ in state:
        io.set_enabled(True)
    yield
    for io, ins, on, met in state:
        io.set_enabled(on)
        ins.set_metrics(met)
        ins.reset_metrics()


def test_iowatch_stages_and_gauge(recs, planes_on):
    from mxnet_tpu import instrument as jinstrument
    stages = ('read', 'decode', 'batchify', 'prefetch_wait')
    before = {s: instrument.histogram('iowatch.stage.' + s).count
              for s in stages}
    jbefore = {s: jinstrument.histogram('iowatch.stage.' + s).count
               for s in stages}
    decoded = instrument.counter_value('io.decoded_images')
    _epochs(tmx, recs['port'], batch_size=5)
    _epochs(mx, recs['port'], batch_size=5)
    got = {s: instrument.histogram('iowatch.stage.' + s).count - before[s]
           for s in stages}
    want = {s: jinstrument.histogram('iowatch.stage.' + s).count
            - jbefore[s] for s in stages}
    # 2 batches: one read per batch plus one per record at indexing (the
    # MXRecordIO.read stage), a decode and a batchify per batch, and a
    # wait per next() including the one that ends the epoch
    assert got == want
    assert instrument.counter_value('io.decoded_images') - decoded == 10
    snap = instrument.metrics_snapshot()
    assert 'iowatch.record_queue_depth' in snap['gauges']


def test_an_image_the_codec_refuses_raises_at_the_consumer(tmp_path):
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(_image(np.random.default_rng(0))).save(
        buf, format='JPEG', progressive=True)
    w = trec.MXRecordIO(str(tmp_path / 'p.rec'), 'w')
    w.write(trec.pack(trec.IRHeader(0, 1.0, 0, 0), buf.getvalue()))
    w.close()
    it = tmx.io.ImageRecordIter(path_imgrec=str(tmp_path / 'p.rec'),
                                data_shape=(3, 8, 8), batch_size=1)
    for _ in range(2):                  # sticky until reset
        with pytest.raises(tmx.MXNetError, match='progressive'):
            it.next()
    it.close()


def test_a_fault_at_io_read_reaches_the_consumer(recs):
    resilience.set_faults('io.read:sever')
    try:
        it = tmx.io.ImageRecordIter(path_imgrec=recs['port'],
                                    data_shape=(3, 8, 8), batch_size=2)
        with pytest.raises(resilience.InjectedFault):
            it.next()
        it.close()
    finally:
        resilience.clear_faults()


def test_close_is_bounded_and_joins_the_producer(recs):
    it = tmx.io.ImageRecordIter(path_imgrec=recs['port'],
                                data_shape=(3, 16, 16), batch_size=1,
                                prefetch_buffer=1)
    t0 = time.monotonic()
    while it._queue.qsize() < 1 and time.monotonic() - t0 < 10:
        time.sleep(0.01)                # the producer blocks on a full queue
    thread = it._thread
    it.close(timeout=10)
    assert not thread.is_alive()
    assert time.monotonic() - t0 < 10
    io_record._shutdown_live_iters()    # the atexit hook: nothing left
    assert all(not (t.name == 'mxtpu-image-record' and t.is_alive())
               for t in threading.enumerate() if t is thread)


def test_pool_recycles_only_what_was_given_back():
    """The pinned pool's bookkeeping on the CPU (pinning needs a card):
    a buffer is handed out again only after it was given back, oldest
    first, and a pool with none free makes a new one."""
    pool = io_record._PinnedPool.__new__(io_record._PinnedPool)
    pool.shape, pool._free, pool._lock = (2, 3), [], threading.Lock()
    made = []
    pool._new = lambda: made.append(np.zeros(pool.shape)) or made[-1]
    a, b = pool.take(), pool.take()
    assert a is not b and len(made) == 2
    pool.give(b)
    pool.give(a)
    assert pool.take() is b and pool.take() is a and len(made) == 2
