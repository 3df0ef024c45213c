"""The executor group of a one-device Module — the port of
``mxnet_tpu/module/executor_group.py`` without its mesh: one
:class:`~mxnet_tpu_torch.executor.Executor` on one context.  Each batch
is copied INTO the bound data and label arrays (:meth:`load_batch`),
which are the fixed inputs a captured step reads; a batch of another
shape or dtype rebinds the array (a new batch signature).
:meth:`_place_data` is the device feed's placement (``io.DeviceFeedIter``,
the JAX module's ``_device_place_fn``): pinned host staging, then a copy
to the card on the calling thread's current stream (the feed's own).

With ``shared_group`` (a bucket of a ``BucketingModule``) the executor
takes the shared group's own ``NDArray`` objects for every parameter, aux
state and gradient buffer; only its data and label inputs are its own.
The fused step updates those tensors in place, so every bucket trains
the one set of weights."""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..base import MXNetError
from ..executor import Executor
from ..ndarray import NDArray

__all__ = ['DataParallelExecutorGroup']


class DataParallelExecutorGroup(object):
    """(reference executor_group.py:69), one context."""

    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req='write'):
        if len(contexts) != 1:
            raise NotImplementedError(
                'mxnet_tpu_torch trains on one device; a context list of %d '
                'is not ported yet' % len(contexts))
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.logger = logger
        self.fixed_param_names = fixed_param_names or []
        self.grad_req_spec = grad_req
        self.shared_group = shared_group
        self.execs = []
        self.bind_exec(data_shapes, label_shapes)

    @property
    def _device(self):
        return self.contexts[0].torch_device

    @staticmethod
    def _host(value):
        """A batch value as a tensor (float64 becomes float32)."""
        t = value.handle if isinstance(value, NDArray) else \
            torch.as_tensor(np.asarray(value))
        return t.float() if t.dtype == torch.float64 else t

    def _place(self, value):
        """A tensor on the group's device (float64 becomes float32)."""
        return self._host(value).to(self._device)

    def _place_data(self, value):
        """The feed's placement: ``value`` on the group's device, through
        pinned host memory and an asynchronous copy on the current
        stream when it goes from the host to the card."""
        t = self._host(value)
        if self._device.type == 'cuda' and t.device.type == 'cpu':
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def bind_exec(self, data_shapes, label_shapes):
        self.data_shapes = [(n, tuple(s)) for n, s in data_shapes]
        self.label_shapes = [(n, tuple(s)) for n, s in label_shapes] \
            if label_shapes is not None else []
        self.data_names = [n for n, _ in self.data_shapes]
        self.label_names = [n for n, _ in self.label_shapes]
        self.batch_size = self.data_shapes[0][1][0]
        input_shapes = dict(self.data_shapes)
        input_shapes.update(dict(self.label_shapes))
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        if arg_shapes is None:
            raise MXNetError('shape inference failed for %s' % input_shapes)
        grad_req = {}
        for name in self.arg_names:
            req = 'null'
            if self.for_training:
                if name in self.param_names and \
                        name not in self.fixed_param_names:
                    req = self.grad_req_spec \
                        if isinstance(self.grad_req_spec, str) else \
                        self.grad_req_spec.get(name, 'write')
                elif name in self.data_names and self.inputs_need_grad:
                    req = 'write'
            grad_req[name] = req
        ctx = self.contexts[0]
        dev = self._device
        shared = self.shared_group.execs[0] \
            if self.shared_group is not None else None
        inputs = set(self.data_names + self.label_names)

        def own_or_shared(kind, name, shape):
            table = getattr(shared, kind, {})
            if name in inputs or name not in table:
                return NDArray(torch.zeros(shape, device=dev), ctx)
            arr = table[name]
            if arr.shape != tuple(shape):
                raise MXNetError('%s has shape %s in the shared group and '
                                 '%s here' % (name, arr.shape, tuple(shape)))
            return arr

        args, grads = {}, {}
        for name, shape in zip(self.arg_names, arg_shapes):
            args[name] = own_or_shared('arg_dict', name, shape)
            if grad_req[name] != 'null':
                grads[name] = own_or_shared('grad_dict', name, shape)
        aux = {name: own_or_shared('aux_dict', name, shape)
               for name, shape in zip(self.aux_names, aux_shapes)}
        self.execs = [Executor(self.symbol, ctx, args, grads or None,
                               grad_req, aux)]

    def reshape(self, data_shapes, label_shapes):
        """Rebind at new input shapes over the same parameter, gradient
        and aux arrays (their shapes must not change)."""
        data_shapes = [(n, tuple(s)) for n, s in data_shapes]
        label_shapes = [(n, tuple(s)) for n, s in label_shapes or []]
        if data_shapes == self.data_shapes and \
                label_shapes == self.label_shapes:
            return
        shared = self.shared_group
        self.shared_group = _Bound(self.execs[0])
        try:
            self.bind_exec(data_shapes, label_shapes or None)
        finally:
            self.shared_group = shared

    # -- params ------------------------------------------------------------
    def set_params(self, arg_params, aux_params):
        exec_ = self.execs[0]
        for name, arr in arg_params.items():
            if name in exec_.arg_dict:
                exec_.arg_dict[name]._set_data(self._place(arr).clone())
        for name, arr in (aux_params or {}).items():
            if name in exec_.aux_dict:
                exec_.aux_dict[name]._set_data(self._place(arr).clone())

    def get_params(self, arg_params, aux_params):
        """Copy the bound params out into the given dicts
        (executor_group.py:281)."""
        exec_ = self.execs[0]
        for name in self.param_names:
            if name in exec_.arg_dict:
                exec_.arg_dict[name].copyto(arg_params[name])
        for name in self.aux_names:
            if name in exec_.aux_dict:
                exec_.aux_dict[name].copyto(aux_params[name])

    # -- compute -----------------------------------------------------------
    def load_batch(self, data_batch):
        """Copy a batch's data and labels into the executor's inputs, in
        place where shape and dtype match (the copy waits for the feed's
        staging event, if the batch has one), else by rebinding them."""
        exec_ = self.execs[0]
        pairs = list(zip(self.data_shapes, data_batch.data))
        if self.label_shapes and data_batch.label:
            pairs += list(zip(self.label_shapes, data_batch.label))
        ready = getattr(data_batch, 'ready_event', None)
        stream = None
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
        with torch.no_grad():
            for (name, _), value in pairs:
                arr, src = exec_.arg_dict[name], self._host(value)
                dst = arr.handle
                if dst.shape != src.shape or dst.dtype != src.dtype:
                    arr._set_data(src.to(self._device, copy=True))
                    continue
                dst.copy_(src, non_blocking=src.is_cuda or src.is_pinned())
                if stream is not None and src.is_cuda:
                    src.record_stream(stream)

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        self.load_batch(data_batch)
        self.execs[0].forward(is_train=is_train)

    def backward(self, out_grads=None):
        assert self.for_training, \
            're-bind with for_training=True to run backward'
        self.execs[0].backward(out_grads)

    def forward_backward(self, data_batch, out_grads=None):
        self.load_batch(data_batch)
        self.execs[0].forward_backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return outs if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        grads = [self.execs[0].grad_dict[n] for n in self.data_names]
        return grads if merge_multi_context else [[g] for g in grads]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        """(executor_group.py:287)"""
        for exe in self.execs:
            mon.install(exe)


class _Bound(object):
    """A group-like holder of one executor: what ``reshape`` binds the
    new executor's parameters against."""

    def __init__(self, exec_):
        self.execs = [exec_]
