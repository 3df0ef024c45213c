"""Data iterators — the port of ``mxnet_tpu/io.py``'s ``DataBatch``,
``DataIter`` and ``NDArrayIter`` (``:29-112``, ``:564-692``; reference
``python/mxnet/io.py``), with the reference's last-batch semantics
(``pad`` wraps around to the start, ``discard`` drops the tail,
``roll_over`` carries it into the next epoch), the double-buffered
device feed ``DeviceFeedIter`` (``:191-358``) of the sync-free fit loop,
``ResizeIter`` (``:114``), ``PrefetchingIter`` (``:359``), the
readers of the upstream MNIST examples, ``MNISTIter`` (idx files,
``:694``) and ``CSVIter`` (``:747``), and ``ImageRecordIter``
(``:783``, the RecordIO image pipeline of ``io_record.py``).  Each
delivered batch counts ``io.batches`` once and is noted by the
input-pipeline plane
(``iowatch.note_batch``); the time the fit thread waits for a batch is
the goodput ledger's ``input_stall``, the feed's wait also the
``feed_wait`` stage.

``PrefetchingIter`` runs one producer thread per underlying iterator
(the reference pushes its fetches on the native engine, which the port
does not have), each with at most one fetch outstanding: the reference's
double buffering.  The threads are daemons; ``close()`` stops them,
joining each with a timeout, and ``__del__`` stops them without waiting,
so an iterator abandoned mid-epoch never holds up the interpreter's exit
(the reference's ``__del__`` waits on the engine, ROADMAP Queue 3).  At
exit the producer threads still running are stopped and joined before
the interpreter finalizes: a daemon thread stopped inside a torch call
would abort the process.
"""
from __future__ import annotations

import contextlib
import queue
import struct
import sys
import threading
import weakref
from collections import OrderedDict, namedtuple
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import instrument
from . import iowatch as _iowatch
from . import ndarray as nd
from . import perfwatch as _perfwatch
from .base import MXNetError
from .ndarray import NDArray, array

__all__ = ['DataDesc', 'DataBatch', 'DataIter', 'NDArrayIter',
           'DeviceFeedIter', 'ResizeIter', 'PrefetchingIter', 'MNISTIter',
           'CSVIter', 'ImageRecordIter']

DataDesc = namedtuple('DataDesc', ['name', 'shape'])


class DataBatch(object):
    """One mini-batch (reference io.py:60)."""

    def __init__(self, data, label, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter(object):
    """Base iterator (reference io.py:81)."""

    # each delivered batch counts io.batches once: a wrapper that runs
    # ahead of its consumer (DeviceFeedIter) silences the iterators it
    # wraps and counts the batches it delivers itself
    _counts_io_batches = True

    def __init__(self):
        self.batch_size = 0

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        # time spent producing the next batch on the consuming (fit)
        # thread is input-pipeline time: the goodput ledger charges it
        # to input_stall (a no-op off the fit thread or with it off)
        with instrument.span('io.next', cat='io'), \
                _iowatch.account('input_stall'):
            if self.iter_next():
                batch = DataBatch(data=self.getdata(),
                                  label=self.getlabel(),
                                  pad=self.getpad(), index=self.getindex())
                if self._counts_io_batches:
                    instrument.inc('io.batches')
                    _iowatch.note_batch(batch)
                return batch
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass

    def provide_signature(self):
        """``{name: (shape, dtype_str)}`` over data and label: what the
        warm start captures against.  The base reads ``provide_data`` /
        ``provide_label`` and assumes float32 (``NDArrayIter`` knows its
        dtypes)."""
        sig = {}
        try:
            for name, shape in list(self.provide_data or []) + \
                    list(self.provide_label or []):
                sig[name] = (tuple(shape), 'float32')
        except (AttributeError, TypeError, ValueError):
            return {}
        return sig


class ResizeIter(DataIter):
    """``data_iter`` resized to ``size`` batches per epoch, restarting it
    when it runs out (reference io.py:138)."""

    _counts_io_batches = False      # the wrapped iterator counts

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _silence(it):
    """Turn off ``io.batches`` counting along ``it``'s delegation chain
    (``_inner`` of the readers, ``data_iter`` of the wrappers); returns
    ``[(iterator, old flag)]``."""
    out, seen = [], set()
    while it is not None and id(it) not in seen:
        seen.add(id(it))
        out.append((it, getattr(it, '_counts_io_batches', True)))
        it._counts_io_batches = False
        it = getattr(it, '_inner', None) or getattr(it, 'data_iter', None)
    return out


def _init_data(data, allow_empty, default_name):
    """``data`` (array, list of arrays or name -> array dict) as a list
    of ``(name, NDArray)``."""
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = OrderedDict([(default_name, data[0])])
        else:
            data = OrderedDict([('_%d_%s' % (i, default_name), d)
                                for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError('Input must be NDArray, numpy.ndarray, a list of '
                        'them or dict with them as values')
    out = []
    for k, v in data.items():
        if not isinstance(v, NDArray):
            try:
                v = array(v)
            except Exception:
                raise TypeError('Invalid type %s for %s, should be NDArray '
                                'or numpy.ndarray' % (type(v), k))
        out.append((k, v))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference io.py:295).  Shuffling
    draws from numpy's global generator, as the JAX package does."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle='pad', data_name='data',
                 label_name='softmax_label'):
        super().__init__()
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
            self.data = [(k, array(v.asnumpy()[self.idx], v.context))
                         for k, v in self.data]
            self.label = [(k, array(v.asnumpy()[self.idx], v.context))
                          for k, v in self.label]
        if last_batch_handle == 'discard':
            new_n = self.data[0][1].shape[0] - \
                self.data[0][1].shape[0] % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
        self.data_list = [x[1] for x in self.data] + \
            [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.data_list[0].shape[0]
        assert self.num_data >= batch_size, \
            'batch_size need to be smaller than data size.'
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [(k, tuple([self.batch_size] + list(v.shape[1:])))
                for k, v in self.data]

    @property
    def provide_label(self):
        return [(k, tuple([self.batch_size] + list(v.shape[1:])))
                for k, v in self.label]

    def provide_signature(self):
        """The batch signature with the sources' own dtypes."""
        sig = {}
        for (_, arr), (name, shape) in zip(self.data + self.label,
                                           self.provide_data +
                                           self.provide_label):
            sig[name] = (tuple(shape), str(arr.dtype).replace('torch.', ''))
        return sig

    def hard_reset(self):
        """Rewind to the first batch, ignoring ``roll_over``."""
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == 'roll_over' and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, 'DataIter needs reset.'
        if self.cursor + self.batch_size <= self.num_data:
            return [x[1][self.cursor:self.cursor + self.batch_size]
                    for x in data_source]
        # padding: wrap around to the start (iter_batchloader.h round_batch)
        pad = self.batch_size - self.num_data + self.cursor
        return [nd.concatenate([x[1][self.cursor:], x[1][:pad]])
                for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == 'pad' and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def _place_batch(batch, place_data, place_label=None):
    """One DataBatch's arrays staged with ``place_data`` (the executor
    group's ``_place_data``), counting the staged bytes as
    ``io.h2d_prefetch_bytes``."""
    place_label = place_label or place_data

    def stage(values, place):
        staged = []
        for value in values or []:
            placed = place(value)
            instrument.inc('io.h2d_prefetch_bytes',
                           placed.numel() * placed.element_size())
            staged.append(NDArray(placed))
        return staged

    # one device_stage sample per batch (data and label together)
    with _iowatch.stage('device_stage'):
        return DataBatch(stage(batch.data, place_data),
                         stage(batch.label, place_label), pad=batch.pad,
                         index=batch.index, bucket_key=batch.bucket_key,
                         provide_data=batch.provide_data,
                         provide_label=batch.provide_label)


class DeviceFeedIter(DataIter):
    """Double-buffered host->device feed (``mxnet_tpu/io.py:191``).  Wraps
    any DataIter: one worker thread pulls batch N+1 from the inner
    iterator and stages it with ``place_data`` while step N runs.  On a
    card (``device`` a CUDA device) the staging runs on the feed's own
    ``torch.cuda.Stream`` — pinned host memory, then an asynchronous copy
    — and the delivered batch carries ``ready_event``, recorded after
    the copy, which the consuming step waits on
    (``executor_group.load_batch``).  A CPU placement stages on the
    worker thread alone.

    Exactly one fetch is outstanding: the next is submitted when the
    previous batch is consumed, which bounds staging memory to two
    batches.  ``close()`` drains the worker and hands the inner iterator
    back in a clean state (resetting it only if a staged batch had to be
    discarded).  Because the feed runs one fetch ahead of the consumer,
    ``io.batches`` counting moves to this wrapper (delivered batches),
    and ``close()`` restores the inner iterators' counting flags.

    On a card, an inner iterator that can decode into pinned buffers
    (``pin_batches``, ``io_record.ImageRecordIter``) is asked to, so the
    copy reads its buffer directly; a batch that carries ``release`` gets
    it called with ``ready_event`` once the copy is enqueued, and its
    buffer is not written again before that event."""

    def __init__(self, data_iter, place_data, place_label=None, device=None):
        super().__init__()
        self.data_iter = data_iter
        self._place_data = place_data
        self._place_label = place_label or place_data
        self.batch_size = getattr(data_iter, 'batch_size', 0)
        self.current_batch = None
        self._silenced = _silence(data_iter)
        device = torch.device(device) if device is not None else None
        self._stream = torch.cuda.Stream(device) \
            if device is not None and device.type == 'cuda' else None
        self._pins = getattr(data_iter, 'pin_batches', None) \
            if self._stream is not None else None
        if self._pins is not None:
            self._pins(device)
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix='mxtpu-device-feed')
        self._pending = None
        self._exhausted = False
        self._prime()

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def _fetch(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            return None
        on_card = self._stream is not None
        with torch.cuda.stream(self._stream) if on_card else \
                contextlib.nullcontext():
            staged = _place_batch(batch, self._place_data,
                                  self._place_label)
            if on_card:
                staged.ready_event = torch.cuda.Event()
                staged.ready_event.record(self._stream)
                release = getattr(batch, 'release', None)
                if release is not None:
                    release(staged.ready_event)
        return staged

    def _prime(self):
        if self._pending is None:
            self._pending = self._pool.submit(self._fetch)

    def reset(self):
        # lazy re-prime: the first iter_next() after a reset submits the
        # fetch, so the final epoch-boundary reset steals no batch
        self._drain()
        self.data_iter.reset()
        self._exhausted = False

    def _drain(self):
        """Discard the outstanding fetch; True when a real staged batch
        was thrown away."""
        if self._pending is None:
            return False
        pending, self._pending = self._pending, None
        try:
            return pending.result() is not None
        except BaseException:
            return False

    def iter_next(self):
        if self._exhausted:             # sticky until reset()
            return False
        if self._pending is None:
            self._prime()               # first request after a reset
        # occupancy: 1 = the staged batch was already waiting (the feed
        # keeps up); 0 = the consumer outran the feed (input-bound)
        if _iowatch.enabled():
            _iowatch.set_depth('feed_ready',
                               1.0 if self._pending.done() else 0.0)
        with _perfwatch.phase('feed_wait'), \
                _iowatch.stage('feed_wait'), \
                _iowatch.account('input_stall'):
            pending, self._pending = self._pending, None
            batch = pending.result()    # re-raises producer errors
        if batch is None:
            self._exhausted = True
            return False
        self._prime()                   # overlap the NEXT fetch
        self.current_batch = batch
        return True

    def next(self):
        # the staged batch itself: bucket_key, provide_* and ready_event
        # must survive the wrap
        with instrument.span('io.next', cat='io'), \
                _iowatch.account('input_stall'):
            if self.iter_next():
                if self._counts_io_batches:
                    instrument.inc('io.batches')
                    _iowatch.note_batch(self.current_batch)
                return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad

    def close(self):
        """Drain any outstanding fetch, restore the inner iterators'
        counting flags and stop the worker.  The inner iterator is reset
        only when a staged batch was discarded (close mid-epoch)."""
        if self._drain():
            self.data_iter.reset()
        for it, old in self._silenced:
            it._counts_io_batches = old
        self._silenced = []
        if self._pins is not None:
            self._pins(None)
            self._pins = None
        self._pool.shutdown(wait=False)

    def __del__(self):
        pool = getattr(self, '_pool', None)
        if pool is not None:
            pool.shutdown(wait=False)


_LIVE = weakref.WeakSet()       # the PrefetchingIters not closed yet
_LIVE_LOCK = threading.Lock()


def _stop_prefetchers():
    """At exit, before the engine is drained (``engine.
    _shutdown_native_engine``): every open PrefetchingIter stops, so a
    fetch pushed but not run yet returns at once."""
    with _LIVE_LOCK:
        live = list(_LIVE)
    for it in live:
        it._stopped[0] = True


class PrefetchingIter(DataIter):
    """Prefetch over one or more iterators, merging their batches into one
    (reference io.py:359, C++ ``PrefetcherIter``, ``iter_prefetcher.h``).

    Each iterator has a variable of the native engine
    (``engine.native_engine``, ``mxnet_tpu/io.py:401-445``), and each of
    its fetches is pushed as an op that writes that variable: fetches
    are serialised per iterator and run in parallel across them, on the
    engine's worker threads (``MXNET_CPU_WORKER_NTHREADS``; under
    ``NaiveEngine`` on the pushing thread); the next fetch is pushed
    when the previous batch is consumed (at most one outstanding).
    ``rename_data`` / ``rename_label`` (one name -> name dict per
    iterator) rename the provided descriptors.  ``device_place`` (the
    executor group's ``_place_data``) also stages each batch onto the
    device from the worker; without it the batches stay on the host, as
    ``Module.fit``'s device feed expects.  Call :meth:`close` when done;
    ``__del__`` stops the fetches without waiting, and at exit the
    engine's hook stops every open one before it drains the engine (an
    abandoned iterator never holds up the exit)."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 device_place=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        if self.n_iter == 0:
            raise MXNetError('PrefetchingIter needs at least one iterator')
        self.iters = iters
        # n inner batches merge into one delivered batch: this wrapper
        # counts io.batches, the iterators it owns do not
        for it in iters:
            _silence(it)
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.current_batch = None
        self.next_batch = [None] * self.n_iter
        self._device_place = device_place
        self._closed = False
        # shared with the pushed fetches, which hold no reference to self
        self._stopped = [False]
        self._results = [queue.Queue() for _ in range(self.n_iter)]
        from .engine import native_engine
        self._engine = native_engine()
        self._vars = [self._engine.new_var() for _ in range(self.n_iter)]
        with _LIVE_LOCK:
            _LIVE.add(self)
        for i in range(self.n_iter):
            self._push_fetch(i)

    def _ensure_engine(self):
        """Take the engine again if ``set_engine_type`` rebuilt it (the
        old vars died with the old engine)."""
        if not self._engine.alive:
            from .engine import native_engine
            self._engine = native_engine()
            self._vars = [self._engine.new_var()
                          for _ in range(self.n_iter)]

    def _push_fetch(self, i):
        it, place = self.iters[i], self._device_place
        results, stopped = self._results[i], self._stopped

        def fetch():
            if stopped[0]:
                results.put(None)
                return
            try:
                batch = it.next()
                if place is not None:
                    batch = _place_batch(batch, place)
            except StopIteration:
                batch = None
            except BaseException as e:     # raised in the consumer
                batch = e
            results.put(batch)
        self._ensure_engine()
        self._engine.push(fetch, mutable_vars=[self._vars[i]],
                          name='prefetch_%d' % i)

    @staticmethod
    def _renamed(descs, renames):
        if renames is None:
            return sum([list(d) for d in descs], [])
        return sum([[(r[n], s) for n, s in d]
                    for r, d in zip(renames, descs)], [])

    @property
    def provide_data(self):
        return self._renamed([i.provide_data for i in self.iters],
                             self.rename_data)

    @property
    def provide_label(self):
        return self._renamed([i.provide_label for i in self.iters],
                             self.rename_label)

    def reset(self):
        """Drain each iterator's outstanding fetch, reset them all and
        start again."""
        for q in self._results:
            q.get()
        self._ensure_engine()
        for v in self._vars:
            self._engine.wait_for_var(v)
        for it in self.iters:
            it.reset()
        for i in range(self.n_iter):
            self._push_fetch(i)

    def iter_next(self):
        # every slot is drained first, so one failing iterator cannot
        # leave the others' results queued
        items = [q.get() for q in self._results]
        exc = next((x for x in items if isinstance(x, BaseException)),
                   None)
        if exc is not None:
            if self.n_iter == 1:
                # one stream: fetch a replacement so the caller can retry
                self._push_fetch(0)
            else:
                # the streams cannot be realigned: end the epoch (reset()
                # drains these sentinels and starts every stream again)
                for q in self._results:
                    q.put(None)
            raise exc
        self.next_batch = items
        if items[0] is None:
            if any(b is not None for b in items):
                raise MXNetError('PrefetchingIter: the iterators ran out '
                                 'at different batches')
            for q in self._results:         # for reset() to drain
                q.put(None)
            return False
        if any(b.pad != items[0].pad for b in items):
            raise MXNetError('PrefetchingIter: the iterators\' batches '
                             'differ in padding')
        self.current_batch = DataBatch(
            sum([b.data for b in items], []),
            sum([b.label for b in items], []), items[0].pad,
            items[0].index)
        for i in range(self.n_iter):
            self._push_fetch(i)
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad

    def close(self, timeout=10.0):
        """Stop prefetching: the fetch in flight of each iterator
        finishes, each waited for within ``timeout`` seconds, and the
        engine's variables are released.  True when all have finished."""
        if self._closed:
            return True
        self._closed = True
        self._stopped[0] = True
        with _LIVE_LOCK:
            _LIVE.discard(self)
        if not self._engine.alive:
            return True
        done = all([self._engine.wait_for_var(v, timeout)
                    for v in self._vars])
        for v in self._vars:
            self._engine.del_var(v)
        return done

    def __del__(self):
        # never waits on the engine: the pushed fetches see the stop
        # flag, and the variables are freed once they have run
        stopped = getattr(self, '_stopped', None)
        if stopped is None or getattr(self, '_closed', True):
            return
        self._closed = True
        stopped[0] = True
        try:
            if not sys.is_finalizing() and self._engine.alive:
                for v in self._vars:
                    self._engine.del_var(v)
        except Exception:                   # noqa: BLE001
            pass


def _read_idx(path):
    """An idx file (big-endian magic: two zero bytes, the type byte 0x08
    for uint8, the number of dims, then each dim) as a uint8 array."""
    import gzip
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rb') as f:
        zero, dtype, dims = struct.unpack('>HBB', f.read(4))
        if zero != 0 or dtype != 0x08:
            raise MXNetError('%s is not a uint8 idx file (magic %#06x, '
                             'type %#04x)' % (path, zero, dtype))
        shape = struct.unpack('>%dI' % dims, f.read(4 * dims))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


class MNISTIter(DataIter):
    """MNIST idx-format reader (C++ ``src/io/iter_mnist.cc:241-248``):
    images scaled to [0, 1] as float32, shaped (N, 1, 28, 28) or flat
    (N, 784) with ``flat``; labels float32; with ``shuffle`` the rows are
    permuted once by ``numpy.random.RandomState(seed)``.  The last batch
    wraps around to the start (``pad``)."""

    def __init__(self, image='train-images-idx3-ubyte',
                 label='train-labels-idx1-ubyte', batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, **kwargs):
        super().__init__()
        images = _read_idx(image).astype(np.float32) / 255.0
        labels = _read_idx(label).astype(np.float32)
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1, images.shape[1],
                                    images.shape[2])
        if shuffle:
            perm = np.random.RandomState(seed).permutation(images.shape[0])
            images, labels = images[perm], labels[perm]
        self._inner = NDArrayIter(images, labels, batch_size,
                                  shuffle=False, last_batch_handle='pad')
        self.batch_size = batch_size

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class CSVIter(DataIter):
    """CSV reader (C++ ``src/io/iter_csv.cc:131-140``): rows of
    ``data_csv`` reshaped to ``data_shape``, labels from ``label_csv``
    (zeros without one); ``round_batch`` pads the last batch by wrapping
    around, else drops it."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=128, round_batch=True,
                 **kwargs):
        super().__init__()
        data = np.loadtxt(data_csv, delimiter=',', dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=',', dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if tuple(label_shape) == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros((data.shape[0],), dtype=np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle='pad' if round_batch else 'discard')
        self.batch_size = batch_size

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


def ImageRecordIter(**kwargs):
    """RecordIO image pipeline — the native implementation lives in
    ``io_record`` (C++ RecordIO + decode, ``csrc/host/recordio.cc``)."""
    from .io_record import ImageRecordIter as _Impl
    return _Impl(**kwargs)
