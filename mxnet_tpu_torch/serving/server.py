"""Model server — the port of ``mxnet_tpu/serving/server.py`` with one
replica per model.

:class:`ModelServer` holds named models, each a :class:`Predictor`
(pow2 buckets, ``pad_to_bucket=True``) behind a
:class:`~mxnet_tpu_torch.serving.batcher.DynamicBatcher`.  The replica
runs on ``cuda:dev_id`` (``gpu(0)`` by default) unless the server is
built with ``dev_type='cpu'``; with no CUDA device a GPU server raises
at ``load_model`` instead of serving on the CPU.  ``load_model`` builds
every pow2 bucket up to the batcher's cap (``Predictor.warm_buckets``),
which on the card captures each bucket's forward as a CUDA graph before
the batcher serves.

Replica fleets, the supervisor, the autoscaler, brownout, mesh replicas,
hot reload and checkpoint-prefix loading wait for a later slice.
"""
from __future__ import annotations

import re
import threading

from .. import config, instrument
from ..base import MXNetError
from ..predictor import Predictor
from .batcher import DynamicBatcher, ServerOverloadedError

__all__ = ['ModelServer', 'ModelNotFoundError', 'ServerOverloadedError']


class ModelNotFoundError(MXNetError):
    """No model with that name is loaded."""


class ModelServer(object):
    """Dynamic-batching model server over named Predictors.

    ``predict`` blocks on the response future; ``submit`` returns it.
    Per-request outputs are numpy arrays sliced to the request's rows.
    """

    def __init__(self, max_delay_ms=None, max_batch=None, max_queue=None,
                 dev_type='gpu', dev_id=0):
        self._max_delay_ms = max_delay_ms
        self._max_batch = max_batch
        self._max_queue = max_queue
        self._dev = (dev_type, dev_id)
        self._models = {}           # name -> (Predictor, DynamicBatcher)
        self._lock = threading.Lock()
        self._closed = False

    def load_model(self, name, symbol_json=None, params=None,
                   input_shapes=None):
        """Build ``name``'s Predictor on the server's device and start its
        batcher; returns the Predictor.  ``params`` is what
        :class:`Predictor` takes (a dict, e.g. from
        ``convert.params_from_numpy``, or ``.params`` bytes)."""
        if not re.fullmatch(r'[A-Za-z0-9._:-]+', str(name)):
            raise MXNetError('model name %r must match [A-Za-z0-9._:-]+'
                             % (name,))
        if symbol_json is None or params is None or input_shapes is None:
            raise MXNetError('load_model needs symbol_json=, params= and '
                             'input_shapes=')
        reserved = {'name', 'timeout', 'self'} & set(input_shapes)
        if reserved:
            raise MXNetError('input name(s) %s collide with '
                             'submit()/predict() keywords' % sorted(reserved))
        with self._lock:
            if self._closed:
                raise MXNetError('server is closed')
            if name in self._models:
                raise MXNetError('model %r already loaded' % name)
        predictor = Predictor(symbol_json, params, dict(input_shapes),
                              dev_type=self._dev[0], dev_id=self._dev[1],
                              pad_to_bucket=True)
        # every pow2 bucket the batcher can fill is built (and captured on
        # the card) before the batcher's worker thread starts
        # (mxnet_tpu/serving/server.py:381)
        predictor.warm_buckets(self._max_batch if self._max_batch
                               is not None else
                               config.get('MXTPU_SERVE_MAX_BATCH'))
        batcher = DynamicBatcher(name, self._make_execute(predictor),
                                 max_delay_ms=self._max_delay_ms,
                                 max_batch=self._max_batch,
                                 max_queue=self._max_queue,
                                 batch_inputs=predictor._batch_inputs)
        with self._lock:
            if self._closed or name in self._models:
                batcher.stop(drain=False)
                raise MXNetError('server is closed' if self._closed else
                                 'model %r already loaded' % name)
            self._models[name] = (predictor, batcher)
            instrument.set_gauge('serving.models', len(self._models))
        return predictor

    @staticmethod
    def _make_execute(predictor):
        def execute(inputs, rows):
            predictor.forward(**inputs)
            return [predictor.get_output(i)
                    for i in range(predictor.num_outputs)]
        return execute

    def _entry(self, name):
        with self._lock:
            entry = self._models.get(name)
        if entry is None:
            raise ModelNotFoundError('no model %r' % name)
        return entry

    def submit(self, name, **inputs):
        """Enqueue one request; returns a Future resolving to the list of
        per-output numpy arrays.  Raises :class:`ServerOverloadedError`
        when shedding."""
        return self._entry(name)[1].submit(inputs)

    def predict(self, name, timeout=None, **inputs):
        """Blocking :meth:`submit`."""
        if timeout is None:
            timeout = config.get('MXTPU_SERVE_REQUEST_TIMEOUT')
        return self.submit(name, **inputs).result(timeout=timeout)

    def unload_model(self, name, drain=True, timeout=None):
        """Remove ``name``; ``drain=True`` serves what is queued first."""
        with self._lock:
            entry = self._models.pop(name, None)
            instrument.set_gauge('serving.models', len(self._models))
        if entry is None:
            raise ModelNotFoundError('no model %r' % name)
        entry[1].stop(drain=drain, timeout=timeout)

    def stats(self):
        """The ``serving.*`` slice of the metrics registry."""
        snap = instrument.metrics_snapshot()
        return {kind: {k: v for k, v in vals.items()
                       if k.startswith('serving.')}
                for kind, vals in snap.items()}

    def close(self, drain=True, timeout=None):
        with self._lock:
            self._closed = True
            names = list(self._models)
        for name in names:
            self.unload_model(name, drain=drain, timeout=timeout)
