"""Bucketed sequence iterator — the port's copy of ``mxnet_tpu/rnn/io.py``
(reference ``python/mxnet/rnn/io.py:61``), over the port's ``nd``.  Each
batch is produced inside an ``io.next`` span, counts ``io.batches`` and
is noted by the input-pipeline plane (``iowatch.note_batch``), as in the
JAX module."""
from __future__ import annotations

import bisect
import random

import numpy as np

from .. import instrument
from .. import iowatch as _iowatch
from .. import ndarray as nd
from ..io import DataBatch, DataIter

__all__ = ['BucketSentenceIter', 'encode_sentences']


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key='\n',
                     start_label=0):
    """Encode sentences into int arrays + vocab (reference rnn/io.py:14)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                assert new_vocab, 'Unknown token %s' % word
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Bucketed iterator for variable-length sequences
    (reference rnn/io.py:61).  Sentences are padded with
    ``invalid_label`` to their bucket's length; labels are the data
    shifted by one, padded the same way.  ``reset`` shuffles the batch
    order with ``random`` and each bucket's rows with ``np.random``."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name='data', label_name='softmax_label', dtype='float32'):
        super().__init__()
        if not buckets:
            buckets = [i for i, j in enumerate(np.bincount(
                [len(s) for s in sentences])) if j >= batch_size]
        buckets.sort()
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = bisect.bisect_left(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(i, dtype=dtype) for i in self.data]
        print('WARNING: discarded %d sentences longer than the largest '
              'bucket.' % ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.nddata = []
        self.ndlabel = []
        self.major_axis = 0
        self.default_bucket_key = max(buckets)

        self.provide_data = [(data_name, (batch_size,
                                          self.default_bucket_key))]
        self.provide_label = [(label_name, (batch_size,
                                            self.default_bucket_key))]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd.array(buck, dtype=self.dtype))
            self.ndlabel.append(nd.array(label, dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        with instrument.span('io.next', cat='io'):
            i, j = self.idx[self.curr_idx]
            self.curr_idx += 1
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
            batch = DataBatch([data], [label], pad=0,
                              bucket_key=self.buckets[i],
                              provide_data=[(self.data_name, data.shape)],
                              provide_label=[(self.label_name,
                                              label.shape)])
            if self._counts_io_batches:
                instrument.inc('io.batches')
                _iowatch.note_batch(batch)
            return batch
