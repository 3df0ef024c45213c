"""Standalone inference API — the port of ``mxnet_tpu/predictor.py``'s
single-device ``Predictor`` (reference ``c_predict_api.h``:
MXPredCreate / SetInput / Forward / GetOutput).

Every forward runs through the step-compiler pass pipeline on the
Executor (``fuse.apply_fuse_passes``, ``MXTPU_FUSE``): under
``aggressive`` a ResNet gets its conv+BN pairs folded and its remaining
BN->relu chains lowered onto the ``fused_bn_relu`` CUDA kernel.

With ``pad_to_bucket`` each pow2 bucket has its own executor (sharing
the parameter arrays), whose inference forward runs through a CUDA graph
on the card (``Executor.enable_capture``; the graphs of one Predictor
share a memory pool): :meth:`Predictor.warm_buckets` captures every
bucket up to a batch size before the first request, a request is copied
into the bucket's pinned host staging and from there into the graph's
input on the card, and ``forward`` returns copies of the graph's
outputs, which a later forward does not overwrite.  Inferred shapes
are remembered by (symbol JSON, input shapes): another Predictor of the
same model at the same buckets (a serving replica, a reload) binds
without inferring them again.

:meth:`Predictor.reshape` rebinds at new input shapes and drops the
bucket executors and the graphs the old shapes captured; the module's
:func:`load` builds a Predictor from ``prefix-symbol.json`` and
``prefix-%04d.params``.

**Tensor-parallel serving** (``Predictor(mesh=, partition=, devices=)``,
``mxnet_tpu/predictor.py:159-395``): a dp×tp grid of positions over
``devices`` in this process (``parallel.mesh.DeviceMesh``; a device may
repeat), placed by the same ``ShardingPlan`` selection rule the sharded
fit uses, degradations recorded per tensor (:meth:`sharding_records`).
Position (d, t) holds shard t of each tp-sharded argument and a copy of
each replicated argument and of every aux state.  A request pads to the
pow2 bucket ``B >= dp`` and splits into dp slices of ``B/dp`` rows; slot
d runs its slice on position (d, 0)'s device through the pass
pipeline's program, gathering its tp peers' shards at use
(``executor.TpShards``: tp shards the parameters' storage, not the
arithmetic).  Outputs whose leading dim is the bucket are concatenated
in slot order, the others taken from slot 0.  On the card each (bucket,
mesh signature) slot forward is one CUDA graph (the gathers are copies
inside it), and slots that share a card run in turn on the caller's
stream; :meth:`warm_buckets` captures every bucket before the first
request, so the hot path takes no capture (``compile.traces``) while
``serving.sharded_aot_calls`` counts each sharded forward.
"""
from __future__ import annotations

import os
import tempfile
import threading

import numpy as np
import torch

from . import compile_cache, instrument
from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError
from .context import Context
from .ndarray import NDArray

__all__ = ['Predictor', 'load']


def _note_pad_waste(rows, bucket):
    """Rows between the real batch and its pow2 bucket are filler."""
    if bucket > rows:
        instrument.inc('serving.pad_waste_rows', bucket - rows)
    instrument.set_gauge('serving.bucket_occupancy|bucket=%d' % bucket,
                         rows / float(bucket))


def _split_params(params):
    """``{'arg:x' | 'aux:x' | 'x': value}`` -> (arg_params, aux_params)."""
    arg_params, aux_params = {}, {}
    for k, v in params.items():
        if k.startswith('arg:'):
            arg_params[k[4:]] = v
        elif k.startswith('aux:'):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


# (symbol JSON, input shapes) -> (arg shapes, aux shapes): the replicas
# and reloads of a served model bind one graph at the same buckets, and
# shape inference is most of a Predictor's host build time
_SHAPES = {}
_SHAPES_MAX = 256
_shapes_lock = threading.Lock()


def _infer_shapes(symbol, key, shapes):
    """``(arg_shapes, aux_shapes)`` of ``symbol`` at input ``shapes``
    (None when they cannot be inferred), remembered under the symbol's
    JSON ``key``."""
    k = (key, tuple(sorted(shapes.items())))
    with _shapes_lock:
        hit = _SHAPES.get(k)
    if hit is None:
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        if arg_shapes is None:
            return None
        hit = (list(arg_shapes), list(aux_shapes))
        with _shapes_lock:
            if len(_SHAPES) >= _SHAPES_MAX:
                del _SHAPES[next(iter(_SHAPES))]
            _SHAPES[k] = hit
    return hit


def _on(value, ctx):
    if isinstance(value, NDArray):
        return value.as_in_context(ctx)
    return nd.array(value, ctx)


class Predictor(object):
    """(MXPredCreate analogue)

    ``dev_type`` defaults to ``'gpu'``: the port serves on the card
    unless the caller asks for the CPU with ``dev_type='cpu'``, and with
    no CUDA device a ``'gpu'`` Predictor raises instead of running on the
    CPU.  (The JAX package's default is ``'cpu'``; the difference is
    deliberate.)  ``param_raw_bytes_or_dict`` is ``.params`` file bytes
    or a dict of NDArrays, tensors or numpy arrays keyed ``arg:name`` /
    ``aux:name`` (or bare argument names).  ``output_keys`` names the
    internal outputs to serve instead of the symbol's own
    (MXPredCreatePartialOut).
    """

    def __init__(self, symbol_json_str, param_raw_bytes_or_dict,
                 input_shapes, dev_type='gpu', dev_id=0,
                 output_keys=None, pad_to_bucket=False,
                 mesh=None, partition=None, devices=None):
        symbol = sym_mod.load_json(symbol_json_str) \
            if isinstance(symbol_json_str, str) else symbol_json_str
        if output_keys:
            # MXPredCreatePartialOut: serve the named internal outputs
            internals = symbol.get_internals()
            symbol = sym_mod.Group([
                internals[k if k.endswith('_output') else k + '_output']
                for k in output_keys])
        self._symbol = symbol
        # a served graph's Rtc kernels load from the cubin store
        compile_cache.ensure_persistent_cache()
        self._shape_key = symbol_json_str if isinstance(
            symbol_json_str, str) and not output_keys else symbol.tojson()
        self._ctx = Context(dev_type, dev_id)
        if mesh is None or devices is None:
            self._ctx.torch_device  # raises now when the device is absent
        self._plan = None

        if isinstance(param_raw_bytes_or_dict, (bytes, bytearray)):
            fd, path = tempfile.mkstemp(suffix='.params')
            try:
                with os.fdopen(fd, 'wb') as f:
                    f.write(param_raw_bytes_or_dict)
                params = nd.load(path)
            finally:
                os.unlink(path)
        else:
            params = dict(param_raw_bytes_or_dict)
        arg_params, aux_params = _split_params(params)

        self._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self._batch_inputs = self._infer_batch_inputs()
        self._out_arrays = None
        self._active_bucket = None
        self._valid_rows = None
        self._graph_pool = None
        self._staging = {}      # key -> (pinned tensor, event)
        if mesh is not None:
            # tensor-parallel serving: per-bucket slot forwards over the
            # mesh's positions, no single-device executor
            self._pad_to_bucket = True
            self._init_sharded(mesh, partition, devices, arg_params,
                               aux_params)
            return

        inferred = _infer_shapes(symbol, self._shape_key, self._input_shapes)
        if inferred is None:
            raise MXNetError('cannot infer shapes from %s' % input_shapes)
        arg_shapes, aux_shapes = inferred
        args = {}
        for name, shape in zip(symbol.list_arguments(), arg_shapes):
            if name in self._input_shapes or (
                    name not in arg_params and name.endswith('label')):
                args[name] = nd.zeros(shape, self._ctx)
            elif name in arg_params:
                args[name] = _on(arg_params[name], self._ctx)
            else:
                raise MXNetError('missing parameter %s' % name)
        aux = {name: (_on(aux_params[name], self._ctx)
                      if name in aux_params else nd.zeros(shape, self._ctx))
               for name, shape in zip(symbol.list_auxiliary_states(),
                                      aux_shapes)}
        self._executor = symbol.bind(self._ctx, args, aux_states=aux)
        # pow2 shape policy (compile_cache.pad_to_bucket): batch-axis
        # inputs pad up to the next power of two and run on a per-bucket
        # executor sharing the parameter arrays; outputs are sliced back
        self._pad_to_bucket = bool(pad_to_bucket)
        self._bucket_execs = {}

    def _infer_batch_inputs(self):
        """Inputs sharing the batch axis: leading dim equal to the
        ``data`` input's (else the most common leading dim)."""
        leading = {k: s[0] for k, s in self._input_shapes.items() if s}
        if not leading:
            return set()
        if 'data' in leading:
            batch = leading['data']
        else:
            dims = sorted(leading.values())
            batch = max(dims, key=dims.count)
        return {k for k, d in leading.items() if d == batch}

    # -- tensor-parallel serving (mesh=...) ---------------------------------

    def _init_sharded(self, mesh, partition, devices, arg_params,
                      aux_params):
        """The sharded serving state (``mxnet_tpu/predictor.py:161``): a
        dp×tp ``ShardingPlan`` over the device grid, each argument placed
        per position (degradations recorded per tensor), and an empty
        table of per-bucket slot forwards."""
        from . import fuse
        from .parallel import mesh as pmesh
        if devices is None:
            devices = pmesh.local_devices() \
                if self._ctx.device_type == 'gpu' else [self._ctx]
        plan = pmesh.ShardingPlan(
            pmesh.build_dp_tp_mesh(mesh, devices=devices),
            partition or 'auto')
        if plan.dp & (plan.dp - 1):
            raise MXNetError(
                'serving dp axis must be a power of two so pow2 request '
                'buckets stay dp-divisible, got dp=%d' % plan.dp)
        self._plan = plan
        grid = [[plan.mesh.position(d, t) for t in range(plan.tp)]
                for d in range(plan.dp)]
        for row in grid:
            for ctx in row:
                ctx.torch_device    # a 'gpu' position raises with no card
        self._ctx = grid[0][0]
        # the pass pipeline runs once: every bucket and slot runs the
        # same rewritten graph
        self._prog_symbol = fuse.apply_fuse_passes(self._symbol, False)
        inferred = _infer_shapes(self._symbol, self._shape_key,
                                 self._input_shapes)
        if inferred is None:
            raise MXNetError('cannot infer shapes from %s'
                             % self._input_shapes)
        arg_shapes, aux_shapes = inferred
        declared_batch = None
        if self._batch_inputs:
            declared_batch = self._input_shapes[
                sorted(self._batch_inputs)[0]][0]

        def placed(value, dim):
            # position (d, t)'s own copy of shard t (the whole tensor
            # when dim is None), even where positions share a device
            full = value.handle if isinstance(value, NDArray) else \
                torch.as_tensor(value)
            pieces = [full] * plan.tp if dim is None else \
                list(torch.chunk(full, plan.tp, dim))
            return [[torch.empty(pieces[t].shape, dtype=full.dtype,
                                 device=ctx.torch_device).copy_(pieces[t])
                     for t, ctx in enumerate(row)] for row in grid]

        self._params = {}       # name -> [d][t] tensors
        self._shard_dims = {}   # name -> the dim tp splits
        self._batch_labels = {}     # label args that carry the batch axis
        for name, shape in zip(self._symbol.list_arguments(), arg_shapes):
            if name in self._input_shapes:
                continue
            if name in arg_params:
                value = arg_params[name]
                if not isinstance(value, (NDArray, torch.Tensor)):
                    value = np.asarray(value)
                dim = pmesh.tp_dim(plan.param_sharding(name, shape,
                                                       value.dtype))
                self._params[name] = placed(value, dim)
                if dim is not None:
                    self._shard_dims[name] = dim
            elif name.endswith('label'):
                if shape and declared_batch is not None and \
                        shape[0] == declared_batch:
                    # batch-axis label: zeros rebuilt per bucket
                    self._batch_labels[name] = tuple(shape[1:])
                else:
                    self._params[name] = placed(
                        torch.zeros(shape, dtype=torch.float32), None)
            else:
                raise MXNetError('missing parameter %s' % name)
        # aux (BN moving stats) replicated: eval-mode reads must not
        # depend on the partition policy
        self._aux = {name: placed(aux_params[name] if name in aux_params
                                  else torch.zeros(shape), None)
                     for name, shape in zip(
                         self._symbol.list_auxiliary_states(), aux_shapes)}
        bound = set(self._params) | set(self._aux) | \
            set(self._input_shapes) | set(self._batch_labels)
        renamed = [n for n in self._prog_symbol.list_arguments()
                   + self._prog_symbol.list_auxiliary_states()
                   if n not in bound]
        if renamed:
            raise MXNetError('the pass pipeline introduced unbound '
                             'variables %s' % renamed)
        plan.note_degraded()
        self._slots = {}        # bucket signature -> its slot forwards
        self._slot_lock = threading.Lock()

    def sharding_records(self):
        """The sharding-inspector document of the serving plan: per
        tensor its spec, shard bytes and the DEGRADATION REASON when the
        requested tensor-parallel placement fell back to replicated.
        None off the sharded path."""
        return None if self._plan is None else self._plan.records_doc()

    def _bucket_shapes(self, bucket):
        """The input shapes at ``bucket`` rows (batch-axis inputs only)."""
        return {k: ((bucket,) + tuple(s[1:]) if k in self._batch_inputs
                    else s) for k, s in self._input_shapes.items()}

    def _sharded_sig(self, bucket):
        return compile_cache.sig_key(
            {k: (s, 'float32') for k, s in
             self._bucket_shapes(bucket).items()},
            mesh=self._plan.sig())

    def _bucket_entry(self, bucket):
        """The dp slot forwards serving ``bucket``, built on first use (or
        by :meth:`warm_buckets`): slot d's input buffers of ``bucket/dp``
        rows, its arguments (the tp-sharded ones as :class:`~mxnet_tpu_
        torch.executor.TpShards` gathered onto position (d, 0)) and one
        ``CapturedStep`` of the program over them, keyed by
        ``compile_cache.sig_key(..., mesh=plan.sig())``."""
        from .executor import TpShards, _build_graph_fn
        sig = self._sharded_sig(bucket)
        with self._slot_lock:
            entry = self._slots.get(sig)
            if entry is not None:
                return entry
            plan = self._plan
            per = bucket // plan.dp
            _, out_shapes, _ = self._symbol.infer_shape(
                **self._bucket_shapes(bucket))
            program = self._prog_symbol
            graph_fn = _build_graph_fn(program, False)
            slots = []
            for d in range(plan.dp):
                ctx = plan.mesh.position(d, 0)
                dev = ctx.torch_device
                inputs = {k: torch.zeros(s, device=dev) for k, s in
                          self._bucket_shapes(per).items()}
                args = dict(inputs)
                for k, tail in self._batch_labels.items():
                    args[k] = torch.zeros((per,) + tail, device=dev)
                for name, grid in self._params.items():
                    row = grid[d]
                    args[name] = TpShards(row, self._shard_dims[name], dev) \
                        if name in self._shard_dims else row[0]
                aux = {name: grid[d][0] for name, grid in self._aux.items()}
                skip = compile_cache.capture_skip_reason(
                    dev, program, is_train=False)
                if skip is None and self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                bindings = compile_cache.step_tensors(
                    inputs, [a.shards if isinstance(a, TpShards) else a
                             for a in args.values()], aux)

                def body(args=args, aux=aux):
                    with torch.no_grad():
                        return graph_fn(args, aux)[0]
                step = compile_cache.CapturedStep(
                    'serve_sharded', body, dev, bindings,
                    pool=self._graph_pool, skip=skip)
                slots.append({'ctx': ctx, 'inputs': inputs, 'step': step})
            entry = {'bucket': bucket, 'slots': slots,
                     'batch_out': [bool(s) and int(s[0]) == bucket
                                   for s in out_shapes]}
            self._slots[sig] = entry
            instrument.inc('compile.shape_buckets')
            return entry

    def warm_buckets(self, max_batch):
        """Build, and on the card capture, every bucket up to
        ``max_batch`` before the first request (``mxnet_tpu/predictor.py
        :334``): a forward of zeros records each bucket's graphs, so no
        request pays a capture.  Returns the buckets (from dp on the
        sharded path); without ``pad_to_bucket`` (or batch-axis inputs)
        none."""
        if self._plan is not None:
            buckets = []
            top = compile_cache.pad_to_bucket(max(int(max_batch), 1),
                                              minimum=self._plan.dp)
            b = self._plan.dp
            while b <= top:
                for slot in self._bucket_entry(b)['slots']:
                    if slot['step'].skip is None and \
                            not slot['step'].captured:
                        slot['step'].run()
                buckets.append(b)
                b *= 2
            return buckets
        if not (self._pad_to_bucket and self._batch_inputs):
            return []
        buckets, top = [], compile_cache.pad_to_bucket(max_batch)
        b = 1
        while b <= top:
            exe, bucket = self._bucket_executor(b)
            if exe._capture:
                cap = exe._inference_graph()
                if cap.skip is None and not cap.captured:
                    cap.run()
            buckets.append(bucket)
            b *= 2
        return buckets

    def _forward_sharded(self, kwargs):
        rows = {np.asarray(v).shape[0] for k, v in kwargs.items()
                if k in self._batch_inputs}
        if len(rows) != 1:
            raise MXNetError('sharded forward needs one row count '
                             'across the batch-axis inputs %s, got %s'
                             % (sorted(self._batch_inputs), sorted(rows)))
        rows = rows.pop()
        missing = [k for k in self._input_shapes if kwargs.get(k) is None]
        if missing:
            raise MXNetError('sharded forward needs every declared '
                             'input; missing %r' % missing[0])
        unknown = set(kwargs) - set(self._input_shapes)
        if unknown:
            raise MXNetError('unknown input(s) %s' % sorted(unknown))
        bucket = compile_cache.pad_to_bucket(rows, minimum=self._plan.dp)
        entry = self._bucket_entry(bucket)
        per = bucket // self._plan.dp
        values = {k: np.asarray(kwargs[k], np.float32)
                  for k in self._input_shapes}
        slot_outs = []
        for d, slot in enumerate(entry['slots']):
            for k, v in values.items():
                if k in self._batch_inputs:
                    part = v[d * per:(d + 1) * per]
                    self._stage(slot['inputs'][k], (bucket, d, k), part,
                                len(part))
                else:
                    self._stage(slot['inputs'][k], (bucket, d, k), v, None)
            outs = slot['step'].run()
            if slot['step'].captured:
                # the graph's outputs: the next slot's replay (one pool)
                # or the next forward overwrites them
                outs = [o.clone() for o in outs]
            slot_outs.append(outs)
        dev = self._ctx.torch_device
        merged = [torch.cat([o[j].to(dev) for o in slot_outs])
                  if batch and len(slot_outs) > 1 else out0
                  for j, (out0, batch) in enumerate(zip(slot_outs[0],
                                                        entry['batch_out']))]
        instrument.inc('serving.sharded_aot_calls')
        self._out_arrays = [NDArray(o, self._ctx) for o in merged]
        self._valid_rows = rows
        self._active_bucket = bucket
        _note_pad_waste(rows, bucket)
        return self._out_arrays

    @property
    def num_outputs(self):
        return len(self._symbol.list_outputs())

    def set_input(self, key, data):
        """(MXPredSetInput)"""
        if self._plan is not None:
            raise MXNetError('set_input is not available on the sharded '
                             '(mesh=) path: pass inputs to forward()')
        if key not in self._executor.arg_dict:
            raise MXNetError('unknown input %s' % key)
        self._executor.arg_dict[key][:] = np.asarray(data, np.float32)

    def forward(self, **kwargs):
        """(MXPredForward)"""
        if self._plan is not None:
            return self._forward_sharded(kwargs)
        if self._pad_to_bucket and kwargs:
            return self._forward_bucketed(kwargs)
        return self.forward_exact(**kwargs)

    def _bucket_executor(self, rows):
        bucket = compile_cache.pad_to_bucket(rows)
        exe = self._bucket_execs.get(bucket)
        if exe is None:
            inferred = _infer_shapes(self._symbol, self._shape_key,
                                     self._bucket_shapes(bucket))
            if inferred is None:
                raise MXNetError('Insufficient argument shapes provided.')
            exe = self._executor.rebind(*inferred)
            if self._ctx.device_type == 'gpu':
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                exe.enable_capture(self._graph_pool)
            self._bucket_execs[bucket] = exe
            instrument.inc('compile.shape_buckets')
        return exe, bucket

    def _stage(self, dst, key, value, rows):
        """Copy ``value`` (``rows`` rows of a batch-axis input, zero-padded
        to ``dst``'s rows, or a whole constant input) into the bound input
        ``dst``: on the card through the pinned staging buffer kept under
        ``key``."""
        name = key[-1]
        if tuple(value.shape[1:]) != tuple(dst.shape[1:]) or \
                (rows is None and value.shape != dst.shape):
            raise MXNetError('input %s has shape %s, the bucket wants %s'
                             % (name, value.shape, tuple(dst.shape)))
        if not dst.is_cuda:
            if rows is not None and rows != dst.shape[0]:
                value = np.concatenate([value, np.zeros(
                    (dst.shape[0] - rows,) + value.shape[1:], value.dtype)])
            dst.copy_(torch.from_numpy(np.ascontiguousarray(value)))
            return
        stage, done = self._staging.get(key, (None, None))
        if stage is None:
            stage = torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True)
        elif done is not None:
            done.synchronize()      # the last copy out of it has ended
        host = stage.numpy()
        n = value.shape[0] if rows is not None else len(host)
        host[:n] = value
        host[n:] = 0
        dst.copy_(stage, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dst.device))
        self._staging[key] = (stage, done)

    def _forward_bucketed(self, kwargs):
        rows = {np.asarray(v).shape[0] for k, v in kwargs.items()
                if k in self._batch_inputs}
        if len(rows) > 1:
            raise MXNetError('pad_to_bucket needs one row count across '
                             'the batch-axis inputs %s, got %s'
                             % (sorted(self._batch_inputs), sorted(rows)))
        if not rows:
            return self.forward_exact(**kwargs)
        rows = rows.pop()
        exe, bucket = self._bucket_executor(rows)
        for k, v in kwargs.items():
            if k not in exe.arg_dict:
                raise MXNetError('unknown input %s' % k)
            self._stage(exe.arg_dict[k].handle, (bucket, k),
                        np.asarray(v, np.float32),
                        rows if k in self._batch_inputs else None)
        outs = exe.forward(is_train=False)
        if exe._capture:
            # the graph's outputs: the next forward overwrites them
            outs = [NDArray(o.handle.clone(), o.context) for o in outs]
        self._out_arrays = outs
        self._valid_rows = rows
        self._active_bucket = bucket
        _note_pad_waste(rows, bucket)
        return self._out_arrays

    def forward_exact(self, **kwargs):
        """Forward at the EXACT bound shapes, bypassing the pow2 bucket
        policy."""
        if self._plan is not None:
            raise MXNetError('forward_exact is not available on the '
                             'sharded (mesh=) path: every sharded '
                             'forward rides a pow2-bucket AOT '
                             'executable')
        self._valid_rows = None
        self._active_bucket = None
        for k, v in kwargs.items():
            self.set_input(k, v)
        self._out_arrays = self._executor.forward(is_train=False)
        return self._out_arrays

    def get_output(self, index):
        """(MXPredGetOutput) — a host numpy copy, padded rows dropped."""
        if self._out_arrays is None:
            raise MXNetError('call forward first')
        out = self._out_arrays[index]
        if self._valid_rows is not None and out.ndim > 0 and \
                out.shape[0] == self._active_bucket:
            return NDArray(out.handle[:self._valid_rows],
                           out.context).asnumpy()
        return out.asnumpy()

    def reshape(self, input_shapes):
        """(MXPredReshape) Rebind at ``input_shapes``
        (``mxnet_tpu/predictor.py:491``): the parameters stay shared, the
        bucket executors, their captured graphs and their staging
        buffers are dropped, and the next forward builds what the new
        shapes need."""
        if self._plan is not None:
            raise MXNetError('reshape is not available on the sharded '
                             '(mesh=) path: build a new Predictor (the '
                             'bucket table is shape-keyed already)')
        self._executor = self._executor.reshape(**input_shapes)
        self._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self._bucket_execs = {}
        self._graph_pool = None
        self._staging = {}
        self._out_arrays = None
        self._valid_rows = None
        self._active_bucket = None
        self._batch_inputs = self._infer_batch_inputs()


def load(prefix, epoch, input_shapes, dev_type='gpu', dev_id=0):
    """A Predictor from checkpoint files, ``prefix-symbol.json`` and
    ``prefix-%04d.params`` (``mxnet_tpu/predictor.py:506``, the
    predict-api flow).  Like :class:`Predictor` it serves on the card
    unless ``dev_type='cpu'`` (the JAX package's default is the CPU)."""
    with open('%s-symbol.json' % prefix) as f:
        sym_json = f.read()
    params = nd.load('%s-%04d.params' % (prefix, epoch))
    return Predictor(sym_json, params, input_shapes, dev_type, dev_id)
