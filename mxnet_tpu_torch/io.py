"""Data iterators — the port of ``mxnet_tpu/io.py``'s ``DataBatch``,
``DataIter`` and ``NDArrayIter`` (``:29-112``, ``:564-692``; reference
``python/mxnet/io.py``), with the reference's last-batch semantics
(``pad`` wraps around to the start, ``discard`` drops the tail,
``roll_over`` carries it into the next epoch).  The double-buffered
``DeviceFeedIter`` is not ported: ``Module`` copies each batch to the
device when it runs the step.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from . import ndarray as nd
from .ndarray import NDArray, array

__all__ = ['DataBatch', 'DataIter', 'NDArrayIter']


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

    def __init__(self):
        self.batch_size = 0

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
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
