"""Data iterators — the port of ``mxnet_tpu/io.py``'s ``DataBatch``,
``DataIter`` and ``NDArrayIter`` (``:29-112``, ``:564-692``; reference
``python/mxnet/io.py``), with the reference's last-batch semantics
(``pad`` wraps around to the start, ``discard`` drops the tail,
``roll_over`` carries it into the next epoch), and the double-buffered
device feed ``DeviceFeedIter`` (``:191-358``) of the sync-free fit loop.
Each delivered batch counts ``io.batches`` once.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import instrument
from . import ndarray as nd
from .ndarray import NDArray, array

__all__ = ['DataBatch', 'DataIter', 'NDArrayIter', 'DeviceFeedIter']


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
        if self.iter_next():
            batch = DataBatch(data=self.getdata(), label=self.getlabel(),
                              pad=self.getpad(), index=self.getindex())
            if self._counts_io_batches:
                instrument.inc('io.batches')
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
    and ``close()`` restores the inner iterators' counting flags."""

    def __init__(self, data_iter, place_data, place_label=None, device=None):
        super().__init__()
        self.data_iter = data_iter
        self._place_data = place_data
        self._place_label = place_label or place_data
        self.batch_size = getattr(data_iter, 'batch_size', 0)
        self.current_batch = None
        self._silenced = []
        it, seen = data_iter, set()
        while it is not None and id(it) not in seen:
            seen.add(id(it))
            self._silenced.append(
                (it, getattr(it, '_counts_io_batches', True)))
            it._counts_io_batches = False
            it = getattr(it, 'data_iter', None)
        device = torch.device(device) if device is not None else None
        self._stream = torch.cuda.Stream(device) \
            if device is not None and device.type == 'cuda' else None
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
        pending, self._pending = self._pending, None
        batch = pending.result()        # re-raises producer errors
        if batch is None:
            self._exhausted = True
            return False
        self._prime()                   # overlap the NEXT fetch
        self.current_batch = batch
        return True

    def next(self):
        # the staged batch itself: bucket_key, provide_* and ready_event
        # must survive the wrap
        if self.iter_next():
            if self._counts_io_batches:
                instrument.inc('io.batches')
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
        self._pool.shutdown(wait=False)

    def __del__(self):
        pool = getattr(self, '_pool', None)
        if pool is not None:
            pool.shutdown(wait=False)
