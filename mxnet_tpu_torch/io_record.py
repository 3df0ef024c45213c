"""ImageRecordIter — the image pipeline; the port of
``mxnet_tpu/io_record.py``.

Replaces the reference's C++ iterator chain (``ImageRecordIOParser``
multi-threaded decode, ``iter_image_recordio.cc:150-370`` →
``BatchLoader`` → ``PrefetcherIter`` ``iter_prefetcher.h:50-151``):

- record parsing, JPEG decode and augmentation run in native C++ worker
  threads (``csrc/host/recordio.cc MXTPUTorchDecodeBatchEx``, its own
  baseline JPEG codec), with the JAX package's arithmetic, so the
  batches are the same;
- a python producer thread keeps ``prefetch_buffer`` batches ahead,
  mirroring the dmlc::ThreadedIter double buffering;
- staging: each batch is decoded into a host buffer of its own, and
  when the device feed (``io.DeviceFeedIter``) stages to the card it
  asks for pinned buffers (:meth:`ImageRecordIter.pin_batches`): the
  batches then come from a small pool of pinned buffers, which the
  feed's asynchronous copy reads directly, and a buffer goes back to the
  pool with the CUDA event recorded after that copy
  (``DataBatch.release``).  The producer waits on that event before it
  decodes into the buffer again, so a copy still in flight is never
  overwritten.  The JAX package stages through its pooled storage
  (``src/storage.cc``) and a copy instead.

An error in the producer (an image the codec does not take, a fault
injected at ``io.read``) reaches the consumer at its next batch.  At
exit every live producer is stopped and joined, bounded, before the
interpreter finalizes.
"""
from __future__ import annotations

import atexit
import ctypes
import queue
import threading
import weakref

import numpy as np
import torch

from . import instrument
from . import iowatch as _iowatch
from . import ndarray as nd
from . import resilience as _resilience
from ._native import recordio_lib as lib
from .base import MXNetError
from .io import DataBatch, DataIter
from .recordio import MXRecordIO, unpack

__all__ = ['ImageRecordIter']

_live_iters = weakref.WeakSet()
_EXIT_JOIN_SECS = 10.0
_ERR_LEN = 512


@atexit.register
def _shutdown_live_iters():
    """Join producer threads before interpreter teardown: a producer
    mid-decode inside the native library at exit crashes in C++ thread
    teardown.  Each join is bounded; the producers are daemons."""
    for it in list(_live_iters):
        try:
            it.close(timeout=_EXIT_JOIN_SECS)
        except Exception:       # noqa: BLE001 - exit must go on
            pass


class _PinnedPool(object):
    """Pinned host buffers of one batch shape.  :meth:`take` hands out a
    free buffer, after the CUDA event it came back with has completed,
    or a new one when none is free; :meth:`give` returns one."""

    def __init__(self, shape, count):
        self.shape = tuple(shape)
        self._free = []             # [(tensor, event or None)], oldest first
        self._lock = threading.Lock()
        for _ in range(count):
            self._free.append((self._new(), None))

    def _new(self):
        instrument.inc('io.pinned_buffers')
        return torch.empty(self.shape, dtype=torch.float32, pin_memory=True)

    def take(self):
        with self._lock:
            item = self._free.pop(0) if self._free else None
        if item is None:
            return self._new()
        buf, event = item
        if event is not None:
            event.synchronize()     # the copy that read it has completed
        return buf

    def give(self, buf, event=None):
        with self._lock:
            self._free.append((buf, event))


class ImageRecordIter(DataIter):
    """(reference ImageRecordIter registration,
    iter_image_recordio.cc:459-487; param names preserved)"""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 label_width=1, shuffle=False, shuffle_chunk_seed=0,
                 rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, mean_img=None,
                 max_random_scale=1.0, min_random_scale=1.0,
                 max_rotate_angle=0.0, max_shear_ratio=0.0,
                 max_aspect_ratio=0.0, min_crop_size=0, max_crop_size=0,
                 random_h=0.0, random_s=0.0, random_l=0.0,
                 preprocess_threads=4, prefetch_buffer=4,
                 round_batch=True, seed=0,
                 data_name='data', label_name='softmax_label', **kwargs):
        super().__init__()
        assert len(data_shape) == 3 and data_shape[0] == 3, \
            'data_shape must be (3, H, W)'
        self.path_imgrec = path_imgrec
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.label_width = label_width
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.mean = (mean_r, mean_g, mean_b)
        self.std = (std_r, std_g, std_b)
        self.scale_range = (max_random_scale, min_random_scale)
        # extended augmenters (reference image_aug_default.cc knobs,
        # same names/semantics as ImageRecordIter's params)
        self.max_rotate_angle = float(max_rotate_angle)
        self.max_shear_ratio = float(max_shear_ratio)
        self.max_aspect_ratio = float(max_aspect_ratio)
        self.min_crop_size = int(min_crop_size)
        self.max_crop_size = int(max_crop_size)
        self.random_h = float(random_h)
        self.random_s = float(random_s)
        self.random_l = float(random_l)
        self.nthreads = preprocess_threads
        self.prefetch_buffer = prefetch_buffer
        self.round_batch = round_batch
        self.seed = seed
        self.data_name = data_name
        self.label_name = label_name

        # index all records once (offsets into the .rec)
        self._records = []  # list of (bytes jpeg, label array)
        rec = MXRecordIO(path_imgrec, 'r')
        while True:
            s = rec.read()
            if s is None:
                break
            header, img = unpack(s)
            label = np.atleast_1d(np.asarray(header.label,
                                             dtype=np.float32))
            self._records.append((img, label))
        rec.close()
        if not self._records:
            raise IOError('no records in %s' % path_imgrec)

        self._rng = np.random.RandomState(shuffle_chunk_seed or seed)
        self._order = np.arange(len(self._records))
        self._epoch = 0
        self._pool = None
        self._queue = queue.Queue(maxsize=prefetch_buffer)
        self._stop = threading.Event()
        self._thread = None
        _live_iters.add(self)
        self.reset()

    @property
    def provide_data(self):
        return [(self.data_name, (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shp = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [(self.label_name, shp)]

    def pin_batches(self, device):
        """Decode into pinned host buffers for a consumer that copies to
        the card ``device`` asynchronously (``io.DeviceFeedIter``), or
        into a host array per batch again (``None``).  Such a consumer
        calls each batch's ``release(event)`` once its copy is enqueued;
        the buffer is reused once ``event`` has completed.  The pool is
        filled here, on the caller's thread, so no pinned allocation
        runs while a CUDA graph is being recorded."""
        if device is None or torch.device(device).type != 'cuda':
            self._pool = None
            return
        if self._pool is None:
            self._pool = _PinnedPool((self.batch_size,) + self.data_shape,
                                     self.prefetch_buffer + 2)

    # -- producer ----------------------------------------------------------
    def _producer(self, order, epoch_seed, stop, out_queue):
        try:
            self._produce(order, epoch_seed, stop, out_queue)
        except Exception as e:              # noqa: BLE001 - to the consumer
            self._put(out_queue, stop, ('error', e))
            return
        self._put(out_queue, stop, None)    # epoch end sentinel

    @staticmethod
    def _put(out_queue, stop, item):
        while not stop.is_set():
            try:
                out_queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _produce(self, order, epoch_seed, stop, out_queue):
        L = lib()
        c, h, w = self.data_shape
        n_total = len(order)
        cursor = 0
        batch_idx = 0
        err = ctypes.create_string_buffer(_ERR_LEN)
        while cursor < n_total and not stop.is_set():
            idx = order[cursor:cursor + self.batch_size]
            pad = 0
            if len(idx) < self.batch_size:
                if not self.round_batch:
                    break
                pad = self.batch_size - len(idx)
                idx = np.concatenate([idx, order[:pad]])
            cursor += self.batch_size

            jpegs = (ctypes.c_void_p * self.batch_size)()
            sizes = (ctypes.c_size_t * self.batch_size)()
            keepalive = []
            labels = np.zeros((self.batch_size, self.label_width),
                              np.float32)
            # the per-batch record fetch is the pipeline's 'read' stage
            # — and the io.read MXTPU_FAULTS site, so a chaos plan can
            # turn this chain input-bound on purpose
            with _iowatch.stage('read'):
                if _resilience.faults_on():
                    _resilience.fault_point('io.read')
                for i, j in enumerate(idx):
                    blob, lab = self._records[j]
                    keepalive.append(blob)
                    jpegs[i] = ctypes.cast(ctypes.c_char_p(blob),
                                           ctypes.c_void_p)
                    sizes[i] = len(blob)
                    k = min(len(lab), self.label_width)
                    labels[i, :k] = lab[:k]
            # a pinned buffer from the pool when the feed asked for one
            # (it comes back with the event of the copy that read it),
            # else a host array of this batch's own
            pool = self._pool
            pinned = pool.take() if pool is not None else None
            out = pinned.numpy() if pinned is not None else \
                np.empty((self.batch_size, c, h, w), np.float32)
            # decode span lands in this producer thread's own trace lane
            with instrument.span('io.decode_batch', cat='io'), \
                    _iowatch.stage('decode'):
                L.MXTPUTorchDecodeBatchEx(
                    jpegs, sizes, self.batch_size,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    h, w, int(self.rand_crop), int(self.rand_mirror),
                    self.mean[0], self.mean[1], self.mean[2],
                    self.std[0], self.std[1], self.std[2],
                    self.scale_range[0], self.scale_range[1],
                    self.max_rotate_angle, self.max_shear_ratio,
                    self.max_aspect_ratio, self.min_crop_size,
                    self.max_crop_size, self.random_h, self.random_s,
                    self.random_l,
                    epoch_seed + batch_idx * 7919, self.nthreads,
                    err, _ERR_LEN)
            if err.value:
                if pinned is not None:
                    pool.give(pinned)
                raise MXNetError('ImageRecordIter %s: %s' % (
                    self.path_imgrec, err.value.decode()))
            instrument.inc('io.decoded_images', self.batch_size)
            if self.label_width == 1:
                lab_out = labels[:, 0]
            else:
                lab_out = labels
            with _iowatch.stage('batchify'):
                data_nd = nd.NDArray(pinned if pinned is not None
                                     else torch.from_numpy(out))
            if not self._put(out_queue, stop,
                             (data_nd, lab_out, pad, pool, pinned)):
                if pinned is not None:
                    pool.give(pinned)
                return
            if _iowatch.enabled():
                _iowatch.set_depth('record_queue_depth', out_queue.qsize())
            batch_idx += 1

    def close(self, timeout=None):
        """Stop and join the producer (safe to call repeatedly); the
        pinned buffers of undelivered batches go back to their pool."""
        thread = self._thread
        if thread is None:
            return
        self._stop.set()
        thread.join(timeout)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, tuple) and len(item) == 5 and \
                    item[4] is not None:
                item[3].give(item[4])
        if not thread.is_alive():
            self._thread = None

    def reset(self):
        self.close()
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._queue.maxsize)
        order = self._order.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1
        self._thread = threading.Thread(
            target=self._producer,
            args=(order, self.seed + self._epoch, self._stop, self._queue),
            name='mxtpu-image-record', daemon=True)
        self._thread.start()

    def next(self):
        if _iowatch.enabled():
            _iowatch.set_depth('record_queue_depth', self._queue.qsize())
        with instrument.span('io.record_batch_wait', cat='io'), \
                _iowatch.stage('prefetch_wait'), \
                _iowatch.account('input_stall'):
            item = self._queue.get()
        if item is None or isinstance(item[0], str):
            self._queue.put(item)           # sticky until reset()
            if item is None:
                raise StopIteration
            raise item[1]
        data, label, pad, pool, pinned = item
        batch = DataBatch([data], [nd.array(label)], pad=pad)
        if pinned is not None:
            batch.release = lambda event=None: pool.give(pinned, event)
        if self._counts_io_batches:
            instrument.inc('io.batches')
            _iowatch.note_batch(batch)
        return batch

    def iter_next(self):
        try:
            self._batch = self.next()
            return True
        except StopIteration:
            return False
