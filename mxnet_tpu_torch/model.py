"""Checkpoints and the ``FeedForward`` estimator — the port of
``mxnet_tpu/model.py`` (reference ``python/mxnet/model.py``).

A checkpoint is ``prefix-symbol.json`` plus ``prefix-%04d.params`` (the
``MXTPU001`` container, ``arg:``/``aux:`` keys), the same bytes in both
packages.  Every file commits atomically (:func:`resilience.
atomic_replace`): a crash mid-save leaves the previous checkpoint, and
:func:`find_latest_checkpoint` skips a file that does not validate.

``FeedForward`` is the legacy estimator of MXNet 0.9 examples; it trains
through ``Module.fit``.  Its ``ctx`` defaults to ``gpu(0)``, as
``Module``'s does: without a CUDA device it raises (pass ``ctx=cpu()``).
``consensus_latest_checkpoint`` needs the elastic plane's checkpoint
votes and is not ported yet.
"""
from __future__ import annotations

import glob
import logging
import os
import re
from collections import namedtuple

import numpy as np

from . import instrument
from . import io as _io
from . import ndarray as nd
from . import symbol as sym
from .context import Context, gpu
from .initializer import Uniform
from .ndarray import NDArray

__all__ = ['BatchEndParam', 'save_checkpoint', 'load_checkpoint',
           'find_latest_checkpoint', 'loadable_epochs', 'FeedForward']

BatchEndParam = namedtuple('BatchEndParams',
                           ['epoch', 'nbatch', 'eval_metric', 'locals'])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save ``prefix-symbol.json`` (unless ``symbol`` is None) and
    ``prefix-%04d.params``, each committed atomically (model.py:31);
    counts ``checkpoint.commits``."""
    from . import resilience
    if symbol is not None:
        with resilience.atomic_replace('%s-symbol.json' % prefix) as tmp:
            symbol.save(tmp)
    save_dict = {('arg:%s' % k): v for k, v in arg_params.items()}
    save_dict.update({('aux:%s' % k): v for k, v in aux_params.items()})
    param_name = '%s-%04d.params' % (prefix, epoch)
    with resilience.atomic_replace(param_name) as tmp:
        nd.save(tmp, save_dict)
    instrument.inc('checkpoint.commits')
    logging.info('Saved checkpoint to "%s"', param_name)


def _saved_epochs(prefix):
    """The epochs with a ``prefix-%04d.params`` file, ascending."""
    epochs = []
    for path in glob.glob('%s-*.params' % glob.escape(prefix)):
        m = re.match(re.escape(os.path.basename(prefix)) +
                     r'-(\d{4})\.params$', os.path.basename(path))
        if m:
            epochs.append(int(m.group(1)))
    return sorted(epochs)


def find_latest_checkpoint(prefix):
    """The highest saved epoch whose ``.params`` file validates
    (``nd.validate``), or None (model.py:62).  A truncated or corrupt
    file is skipped with a warning and counts
    ``checkpoint.corrupt_skipped``."""
    for epoch in reversed(_saved_epochs(prefix)):
        path = '%s-%04d.params' % (prefix, epoch)
        if nd.validate(path):
            return epoch
        instrument.inc('checkpoint.corrupt_skipped')
        logging.warning('skipping unloadable checkpoint "%s" '
                        '(truncated or corrupt)', path)
    return None


def loadable_epochs(prefix):
    """Every saved epoch whose ``.params`` file validates, ascending."""
    return [e for e in _saved_epochs(prefix)
            if nd.validate('%s-%04d.params' % (prefix, e))]


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint; the arrays
    on the CPU (model.py:137)."""
    symbol = sym.load('%s-symbol.json' % prefix)
    save_dict = nd.load('%s-%04d.params' % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(':', 1)
        if tp == 'arg':
            arg_params[name] = v
        if tp == 'aux':
            aux_params[name] = v
    return (symbol, arg_params, aux_params)


def _label_names(symbol, default=('softmax_label',)):
    return [n for n in symbol.list_arguments() if n.endswith('label')] \
        or list(default)


class FeedForward(object):
    """The legacy estimator (model.py:152): ``fit`` builds a ``Module``
    and runs ``Module.fit``; ``predict`` and ``score`` bind an inference
    ``Module`` over the trained parameters."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer='sgd', initializer=Uniform(0.01),
                 numpy_batch_size=128, arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0, **kwargs):
        self.symbol = symbol
        if ctx is None:
            ctx = [gpu(0)]
        elif isinstance(ctx, Context):
            ctx = [ctx]
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.argument_checked = False
        self.begin_epoch = begin_epoch
        self._module = None

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A FeedForward over a checkpoint, resuming at ``epoch``
        (model.py:206)."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    def save(self, prefix, epoch=None):
        """Checkpoint the trained parameters (model.py:196)."""
        if epoch is None:
            epoch = self.num_epoch
        assert epoch is not None
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer='sgd', initializer=Uniform(0.01), eval_data=None,
               eval_metric='acc', epoch_end_callback=None,
               batch_end_callback=None, kvstore='local', logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Construct and fit (model.py:214)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model

    def _init_iter(self, X, y, is_train):
        """A numpy ``X`` (and ``y``) as an NDArrayIter: shuffled with
        roll-over batches of at most half the rows for training
        (model.py:239)."""
        if isinstance(X, (np.ndarray, NDArray)):
            if y is None:
                if is_train:
                    raise ValueError('y must be specified when X is '
                                     'numpy.ndarray')
                y = np.zeros(X.shape[0])
            if not isinstance(y, (np.ndarray, NDArray)):
                raise TypeError('y must be ndarray when X is numpy.ndarray')
            if X.shape[0] != y.shape[0]:
                raise ValueError('The numbers of data points and labels '
                                 'not equal')
            y = y.reshape(-1) if hasattr(y, 'reshape') else y
            if is_train:
                return _io.NDArrayIter(X, y, min(X.shape[0] // 2,
                                                 self.numpy_batch_size),
                                       shuffle=is_train,
                                       last_batch_handle='roll_over')
            return _io.NDArrayIter(X, y, min(X.shape[0],
                                             self.numpy_batch_size),
                                   shuffle=False)
        if not isinstance(X, _io.DataIter):
            raise TypeError('X must be DataIter, NDArray or numpy.ndarray')
        return X

    def _init_eval_iter(self, eval_data):
        if eval_data is None:
            return eval_data
        if isinstance(eval_data, (tuple, list)) and len(eval_data) == 2:
            if eval_data[0] is not None:
                if eval_data[1] is None and \
                        isinstance(eval_data[0], _io.DataIter):
                    return eval_data[0]
                input_data = (np.array(eval_data[0])
                              if isinstance(eval_data[0], list)
                              else eval_data[0])
                input_label = (np.array(eval_data[1])
                               if isinstance(eval_data[1], list)
                               else eval_data[1])
                return self._init_iter(input_data, input_label,
                                       is_train=True)
            raise ValueError('Eval data is NONE')
        if not isinstance(eval_data, _io.DataIter):
            raise TypeError('Eval data must be DataIter or '
                            'numpy.ndarray/list pair')
        return eval_data

    def fit(self, X, y=None, eval_data=None, eval_metric='acc',
            epoch_end_callback=None, batch_end_callback=None,
            kvstore='local', logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None,
            checkpoint_prefix=None, checkpoint_period=1, auto_resume=None):
        """Train through ``Module.fit`` (model.py:262); the optimizer's
        parameters are the constructor's extra keywords.  A context list
        (``ctx=[...]``) trains one executor per context, over slices
        weighted by ``work_load_list``, through ``kvstore``."""
        from .module import Module
        data = self._init_iter(X, y, is_train=True)
        eval_data = self._init_eval_iter(eval_data)
        self._module = Module(self.symbol,
                              data_names=[data.provide_data[0][0]],
                              label_names=_label_names(self.symbol),
                              logger=logger or logging, context=self.ctx,
                              work_load_list=work_load_list)
        optimizer_params = dict(self.kwargs)
        optimizer_params['learning_rate'] = optimizer_params.pop(
            'learning_rate', 0.01)
        self._module.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         kvstore=kvstore, optimizer=self.optimizer,
                         optimizer_params=optimizer_params,
                         eval_end_callback=eval_end_callback,
                         eval_batch_end_callback=eval_batch_end_callback,
                         initializer=self.initializer,
                         arg_params=self.arg_params,
                         aux_params=self.aux_params, allow_missing=True,
                         begin_epoch=self.begin_epoch,
                         num_epoch=self.num_epoch, monitor=monitor,
                         checkpoint_prefix=checkpoint_prefix,
                         checkpoint_period=checkpoint_period,
                         auto_resume=auto_resume)
        self.arg_params, self.aux_params = self._module.get_params()

    def _inference_module(self, X, label_shapes):
        from .module import Module
        module = Module(self.symbol, data_names=[X.provide_data[0][0]],
                        label_names=_label_names(self.symbol),
                        context=self.ctx)
        module.bind(data_shapes=X.provide_data, label_shapes=label_shapes,
                    for_training=False)
        module.set_params(self.arg_params or {}, self.aux_params or {})
        return module

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs on ``X`` as numpy arrays (model.py:284)."""
        X = self._init_iter(X, None, is_train=False)
        if reset:
            X.reset()
        module = self._inference_module(X, None)
        outputs = module.predict(X, num_batch=num_batch,
                                 always_output_list=True)
        if return_data:
            raise NotImplementedError('return_data not supported')
        if len(outputs) == 1:
            return outputs[0].asnumpy()
        return [o.asnumpy() for o in outputs]

    def score(self, X, eval_metric='acc', num_batch=None,
              batch_end_callback=None, reset=True):
        """The metric's value on ``X`` (model.py:314)."""
        X = self._init_iter(X, None, is_train=False)
        if reset:
            X.reset()
        module = self._inference_module(X, X.provide_label)
        res = module.score(X, eval_metric, num_batch=num_batch,
                           batch_end_callback=batch_end_callback)
        return res[0][1]
