"""The executor group of a Module — the port of
``mxnet_tpu/module/executor_group.py``.

One context: one :class:`~mxnet_tpu_torch.executor.Executor`.  Each
batch is copied INTO the bound data and label arrays (:meth:`load_batch`),
which are the fixed inputs a captured step reads; a batch of another
shape or dtype rebinds the array (a new batch signature).

A context list (``Module(context=[gpu(0), gpu(0)])``): upstream MXNet's
own design, not the JAX group's one SPMD program over a ``'data'`` mesh
(``mxnet_tpu/module/executor_group.py:91-110``).  One executor per
context, bound at its slice of the batch (:func:`_split_input_slice`,
weighted by ``work_load_list``), each with its own parameter, gradient
and aux arrays on its context's device; ``Module.update`` sums the
executors' gradients through the kvstore and pulls the result back into
every executor.  BatchNorm normalises the whole batch, as the JAX
group's one program does: the executors' training forwards take turns
on threads of their own and share their batch statistics at every
BatchNorm (:class:`_GroupBatchStats`), and one ``backward`` runs through
all of them, so the summed gradient is the whole batch's.
:meth:`get_params` averages the executors' copies, as upstream does
(they are equal).
:meth:`_place_data` is the device feed's placement (``io.DeviceFeedIter``,
the JAX module's ``_device_place_fn``): pinned host staging, then a copy
to the card on the calling thread's current stream (the feed's own).

With ``shared_group`` (a bucket of a ``BucketingModule``) the executor
takes the shared group's own ``NDArray`` objects for every parameter, aux
state and gradient buffer; only its data and label inputs are its own.
The fused step updates those tensors in place, so every bucket trains
the one set of weights.

With ``mesh_plan`` (a ``parallel.mesh.ShardingPlan``: ``Module.fit(mesh=
...)``, ``mxnet_tpu/module/executor_group.py:58-123``) the group is this
rank's position of a dp×tp mesh of processes: its one executor is bound
at this rank's rows of the batch (B/dp; ``ShardingPlan.rows``), every
batch's arrays are cut to those rows as they are loaded (the tp peers
of a dp slot take the same rows), and a training forward or
backward over more than one dp rank runs with BatchNorm over the global
batch (``mesh.DpBatchStats``).  :meth:`get_outputs` all-gathers the
outputs over dp, so a metric update, ``predict`` and ``score`` see the
global batch as the JAX group's dp-sharded outputs are.  A mesh and a
context list are exclusive; a batch not divisible by dp raises."""
from __future__ import annotations

import contextlib
import logging
import threading

import numpy as np
import torch

from ..base import MXNetError
from ..executor import Executor, mirror_policy
from ..ndarray import NDArray
from ..ops import nn as _nn

__all__ = ['DataParallelExecutorGroup']


def _split_input_slice(batch_size, work_load_list):
    """Slice boundaries per context (reference executor_manager.py:15)."""
    total_work_load = sum(work_load_list)
    batch_num_list = [round(work_load * batch_size / total_work_load)
                      for work_load in work_load_list]
    batch_num_sum = sum(batch_num_list)
    if batch_num_sum < batch_size:
        batch_num_list[-1] += batch_size - batch_num_sum
    slices = []
    end = 0
    for batch_num in batch_num_list:
        begin = int(min(end, batch_size))
        end = int(min(begin + batch_num, batch_size))
        if begin >= end:
            raise ValueError('Too many slices. Some splits are empty.')
        slices.append(slice(begin, end))
    return slices


class _Abandoned(Exception):
    """A member's turn that will not come: another member failed."""


class _GroupBatchStats(object):
    """The batch statistics of a group's executors over the whole batch
    (``ops.nn.shared_batch_stats``), and the turns their training
    forwards take.

    Each executor's forward runs on a thread of its own, one at a time:
    the turn passes round the ring 0, 1, ..., n-1 at every BatchNorm.  At
    its k-th BatchNorm an executor leaves its slice's per-channel sums of
    x and x^2 (and its row count) as its part of round k and hands the
    turn on; when the turn comes back every executor has left its part,
    and each adds the parts up in executor order on its own device: the
    whole batch's E[x] and E[x^2], equal in every executor and
    differentiable through every slice.  One at a time keeps a run
    deterministic (the random draws of Dropout keep their order)."""

    def __init__(self, n):
        self.n = n
        self._cv = threading.Condition()
        self._turn = 0
        self._done = set()
        self._failed = False
        self._rounds = []
        self._next_round = [0] * n

    def wait_turn(self, i):
        with self._cv:
            self._cv.wait_for(lambda: self._turn == i or self._failed)
            if self._failed:
                raise _Abandoned()

    def _hand_on(self, i):
        """The turn to the next member that has not finished (the caller
        holds the condition)."""
        for step in range(1, self.n + 1):
            j = (i + step) % self.n
            if j not in self._done:
                self._turn = j
                break
        self._cv.notify_all()

    def moments(self, i, x32, axes):
        r = self._next_round[i]
        self._next_round[i] += 1
        count = 1
        for a in axes:
            count *= x32.shape[a]
        part = (torch.sum(x32, dim=axes), torch.sum(x32 * x32, dim=axes),
                count)
        with self._cv:
            if r == len(self._rounds):
                self._rounds.append([None] * self.n)
            self._rounds[r][i] = part
            self._hand_on(i)
        self.wait_turn(i)
        parts = self._rounds[r]
        if any(p is None for p in parts):
            raise MXNetError('the executors of a group reached different '
                             'BatchNorms')
        dev = x32.device
        s1, s2, total = parts[0][0].to(dev), parts[0][1].to(dev), parts[0][2]
        for p in parts[1:]:
            s1 = s1 + p[0].to(dev)
            s2 = s2 + p[1].to(dev)
            total += p[2]
        return s1 / total, s2 / total

    def finish(self, i):
        with self._cv:
            self._done.add(i)
            self._hand_on(i)

    def fail(self):
        with self._cv:
            self._failed = True
            self._cv.notify_all()


class DataParallelExecutorGroup(object):
    """(reference executor_group.py:69)"""

    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req='write', workload=None, mesh_plan=None):
        if mesh_plan is not None and len(contexts) > 1:
            raise MXNetError(
                'Module(context=[...]) and fit(mesh=...) are mutually '
                'exclusive device layouts — drop the context list, the '
                'mesh covers the devices')
        self.mesh_plan = mesh_plan
        self.mesh_rows = None
        if workload is None:
            workload = [1] * len(contexts)
        if len(workload) != len(contexts):
            raise MXNetError('work_load_list has %d entries for %d contexts'
                             % (len(workload), len(contexts)))
        self.workload = list(workload)
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

    def _mine(self, t):
        """``t``'s rows of this mesh rank when ``t`` is a global batch's
        array (unchanged off a mesh, and when it holds local rows)."""
        if self.mesh_rows is not None and t.ndim and \
                t.shape[0] == self.batch_size:
            return t[self.mesh_rows]
        return t

    def _place_data(self, value):
        """The feed's placement: ``value`` on the group's device, through
        pinned host memory and an asynchronous copy on the current
        stream when it goes from the host to the card.  On a mesh the
        whole batch is placed (the batch's consumers, a metric among them,
        read the global batch); :meth:`load_batch` takes this rank's
        rows."""
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
        self.slices = _split_input_slice(self.batch_size, self.workload)
        if self.mesh_plan is not None:
            self.mesh_plan.validate_batch(self.batch_size)
            self.mesh_rows = self.mesh_plan.rows(self.batch_size)
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
        self.execs = [self._bind_one(i, grad_req)
                      for i in range(len(self.contexts))]

    def _sliced(self, shapes, islice):
        if self.mesh_rows is not None:
            islice = self.mesh_rows
        elif len(self.contexts) == 1:
            return shapes
        return [(n, (islice.stop - islice.start,) + tuple(s[1:]))
                for n, s in shapes]

    def _bind_one(self, i, grad_req):
        """The executor of context ``i``, bound at its slice's shapes."""
        input_shapes = dict(self._sliced(self.data_shapes, self.slices[i]))
        input_shapes.update(dict(self._sliced(self.label_shapes,
                                              self.slices[i])))
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        if arg_shapes is None:
            raise MXNetError('shape inference failed for %s' % input_shapes)
        ctx = self.contexts[i]
        dev = ctx.torch_device
        shared = self.shared_group.execs[i] \
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
        return Executor(self.symbol, ctx, args, grads or None, grad_req, aux)

    def reshape(self, data_shapes, label_shapes):
        """Rebind at new input shapes over the same parameter, gradient
        and aux arrays (their shapes must not change)."""
        data_shapes = [(n, tuple(s)) for n, s in data_shapes]
        label_shapes = [(n, tuple(s)) for n, s in label_shapes or []]
        if data_shapes == self.data_shapes and \
                label_shapes == self.label_shapes:
            return
        shared = self.shared_group
        self.shared_group = _Bound(self.execs)
        try:
            self.bind_exec(data_shapes, label_shapes or None)
        finally:
            self.shared_group = shared

    # -- params ------------------------------------------------------------
    def set_params(self, arg_params, aux_params):
        for exec_ in self.execs:
            dev = exec_._ctx.torch_device
            for name, arr in arg_params.items():
                if name in exec_.arg_dict:
                    exec_.arg_dict[name]._set_data(
                        self._host(arr).to(dev, copy=True))
            for name, arr in (aux_params or {}).items():
                if name in exec_.aux_dict:
                    exec_.aux_dict[name]._set_data(
                        self._host(arr).to(dev, copy=True))

    def get_params(self, arg_params, aux_params):
        """Copy the bound params out into the given dicts
        (executor_group.py:281); over several executors, their mean
        (upstream ``executor_group.py`` ``get_params``; they are
        equal)."""
        for names, kind, out in ((self.param_names, 'arg_dict', arg_params),
                                 (self.aux_names, 'aux_dict', aux_params)):
            for name in names:
                block = [getattr(e, kind)[name] for e in self.execs
                         if name in getattr(e, kind)]
                if not block:
                    continue
                if len(block) == 1:
                    block[0].copyto(out[name])
                    continue
                dst = out[name].handle.device
                total = sum(b.handle.to(dst) for b in block)
                out[name]._set_data(
                    (total / len(block)).to(out[name].dtype))

    # -- compute -----------------------------------------------------------
    def load_batch(self, data_batch):
        """Copy a batch's data and labels into the executors' inputs, in
        place where shape and dtype match (the copy waits for the feed's
        staging event, if the batch has one), else by rebinding them.
        Over several executors each takes its slice of the rows."""
        pairs = list(zip(self.data_shapes, data_batch.data))
        if self.label_shapes and data_batch.label:
            pairs += list(zip(self.label_shapes, data_batch.label))
        ready = getattr(data_batch, 'ready_event', None)
        stream = None
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
        many = len(self.execs) > 1
        with torch.no_grad():
            for (name, _), value in pairs:
                whole = self._mine(self._host(value))
                slices = self.slices if not many or \
                    whole.shape[0] == self.batch_size else \
                    _split_input_slice(whole.shape[0], self.workload)
                for exec_, islice in zip(self.execs, slices):
                    src = whole[islice] if many else whole
                    arr = exec_.arg_dict[name]
                    dst = arr.handle
                    if dst.shape != src.shape or dst.dtype != src.dtype:
                        arr._set_data(src.to(exec_._ctx.torch_device,
                                             copy=True))
                        continue
                    dst.copy_(src, non_blocking=src.is_cuda or
                              src.is_pinned())
                    if stream is not None and src.is_cuda:
                        src.record_stream(stream)

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        self.load_batch(data_batch)
        self._forward_execs(is_train)

    def _forward_execs(self, is_train):
        if is_train and len(self.execs) > 1:
            self._in_turn(lambda e: e.forward(is_train=True))
            return
        with self._global_batch(is_train):
            for exec_ in self.execs:
                exec_.forward(is_train=is_train)

    def _global_batch(self, is_train=True):
        """On a mesh, a training forward's (and its backward's) BatchNorm
        statistics are the global batch's (``ShardingPlan.global_batch``)."""
        if not is_train or self.mesh_plan is None:
            return contextlib.nullcontext()
        return self.mesh_plan.global_batch()

    def _in_turn(self, run):
        """``run(executor)`` for every executor, each on a thread of its
        own, taking turns, with BatchNorm's statistics over the whole
        batch (:class:`_GroupBatchStats`); a member's error is raised
        here."""
        if mirror_policy() is not None:
            # the mirror's recompute in backward would see one slice
            raise MXNetError('MXNET_BACKWARD_DO_MIRROR is not supported '
                             'over a context list')
        stats = _GroupBatchStats(len(self.execs))
        errors = [None] * len(self.execs)
        streams = [torch.cuda.current_stream(e._ctx.torch_device)
                   if e._ctx.torch_device.type == 'cuda' else None
                   for e in self.execs]

        def member(i):
            try:
                stats.wait_turn(i)
                with _nn.shared_batch_stats(stats, i), \
                        torch.cuda.stream(streams[i]) \
                        if streams[i] is not None else \
                        contextlib.nullcontext():
                    run(self.execs[i])
            except _Abandoned:
                return
            except BaseException as e:          # noqa: BLE001
                errors[i] = e
                stats.fail()
                return
            stats.finish(i)

        threads = [threading.Thread(target=member, args=(i,), daemon=True,
                                    name='mxtpu-executor-%d' % i)
                   for i in range(len(self.execs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e

    def backward(self, out_grads=None):
        """One backward through every executor's graph (their BatchNorm
        statistics join them), each executor's gradients into its own
        ``grad_dict``."""
        assert self.for_training, \
            're-bind with for_training=True to run backward'
        if len(self.execs) == 1:
            with self._global_batch():
                self.execs[0].backward(out_grads)
            return
        execs = [e for e in self.execs if e._grad_names]
        if any(e._pending is None for e in execs):
            # no graph pending (a monitored forward, a second backward):
            # the training forwards run again, together
            for e in execs:
                e._pending = None
            self._in_turn(lambda e: e._pend() if e._grad_names else None)
        heads, stores = [], []
        for i, exec_ in enumerate(self.execs):
            if exec_._grad_names:
                h, leaves = exec_._backward_heads(
                    self._slice_grads(out_grads, i))
                heads += h
                stores.append((exec_, leaves))
        if heads:
            torch.autograd.backward([o for o, _ in heads],
                                    [g for _, g in heads])
        for exec_, leaves in stores:
            exec_._store_grads(leaves)

    def _slice_grads(self, out_grads, i):
        if out_grads is None or len(self.execs) == 1:
            return out_grads
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        dev = self.execs[i]._ctx.torch_device
        return [NDArray(g.handle[self.slices[i]].to(dev))
                for g in out_grads]

    def forward_backward(self, data_batch, out_grads=None):
        self.load_batch(data_batch)
        if len(self.execs) == 1:
            with self._global_batch():
                self.execs[0].forward_backward(out_grads)
            return
        self._forward_execs(True)
        self.backward(out_grads)

    def _merge(self, per_exec):
        """Per-executor lists of arrays, concatenated along the batch
        axis on the first context's device."""
        dev = self._device
        return [NDArray(torch.cat([a.handle.to(dev) for a in arrs]),
                        self.contexts[0])
                for arrs in zip(*per_exec)]

    def _gather_dp(self, arrays):
        """Over more than one dp rank of a mesh, ``arrays`` (this rank's
        rows) all-gathered over dp into the global batch's."""
        plan = self.mesh_plan
        if plan is None or plan.dp == 1:
            return arrays
        from ..parallel import collectives
        from ..parallel.mesh import DP_AXIS
        group = plan.mesh.group(DP_AXIS)
        return [NDArray(collectives.all_gather(a.handle, group), a.context)
                for a in arrays]

    def local_outputs(self):
        """This rank's outputs (no collective)."""
        return self.execs[0].outputs if len(self.execs) == 1 else \
            [o for e in self.execs for o in e.outputs]

    def get_outputs(self, merge_multi_context=True):
        if len(self.execs) == 1:
            outs = self._gather_dp(self.execs[0].outputs)
            return outs if merge_multi_context else [[o] for o in outs]
        per_exec = [e.outputs for e in self.execs]
        if merge_multi_context:
            return self._merge(per_exec)
        return [list(arrs) for arrs in zip(*per_exec)]

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        per_exec = [[e.grad_dict[n] for n in self.data_names]
                    for e in self.execs]
        if len(self.execs) == 1:
            grads = self._gather_dp(per_exec[0])
            return grads if merge_multi_context else [[g] for g in grads]
        if merge_multi_context:
            return self._merge(per_exec)
        return [list(arrs) for arrs in zip(*per_exec)]

    def update_metric(self, eval_metric, labels):
        """Each executor's outputs against its slice of the labels
        (upstream ``executor_group.py`` ``update_metric``)."""
        if len(self.execs) == 1:
            eval_metric.update(labels, self.get_outputs())
            return
        rows = [e.outputs[0].shape[0] for e in self.execs]
        begin = 0
        for exec_, n in zip(self.execs, rows):
            eval_metric.update([lab[begin:begin + n] for lab in labels],
                               exec_.outputs)
            begin += n

    def install_monitor(self, mon):
        """(executor_group.py:287)"""
        for exe in self.execs:
            mon.install(exe)


class _Bound(object):
    """A group-like holder of executors: what ``reshape`` binds the new
    executors' parameters against."""

    def __init__(self, execs):
        self.execs = list(execs)
