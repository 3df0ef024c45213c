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
``prefix-%04d.params``.  The tensor-parallel ``mesh=`` path of the JAX
Predictor is not ported.
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
                 output_keys=None, pad_to_bucket=False):
        symbol = sym_mod.load_json(symbol_json_str) \
            if isinstance(symbol_json_str, str) else symbol_json_str
        if output_keys:
            # MXPredCreatePartialOut: serve the named internal outputs
            internals = symbol.get_internals()
            symbol = sym_mod.Group([
                internals[k if k.endswith('_output') else k + '_output']
                for k in output_keys])
        self._symbol = symbol
        self._shape_key = symbol_json_str if isinstance(
            symbol_json_str, str) and not output_keys else symbol.tojson()
        self._ctx = Context(dev_type, dev_id)
        self._ctx.torch_device      # raises now when the device is absent

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
        self._graph_pool = None
        self._staging = {}      # (bucket, input) -> (pinned tensor, event)

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

    @property
    def num_outputs(self):
        return len(self._symbol.list_outputs())

    def set_input(self, key, data):
        """(MXPredSetInput)"""
        if key not in self._executor.arg_dict:
            raise MXNetError('unknown input %s' % key)
        self._executor.arg_dict[key][:] = np.asarray(data, np.float32)

    def forward(self, **kwargs):
        """(MXPredForward)"""
        if self._pad_to_bucket and kwargs:
            return self._forward_bucketed(kwargs)
        return self.forward_exact(**kwargs)

    def _bucket_executor(self, rows):
        bucket = compile_cache.pad_to_bucket(rows)
        exe = self._bucket_execs.get(bucket)
        if exe is None:
            shapes = {name: ((bucket,) + tuple(shape[1:])
                             if name in self._batch_inputs else shape)
                      for name, shape in self._input_shapes.items()}
            inferred = _infer_shapes(self._symbol, self._shape_key, shapes)
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

    def warm_buckets(self, max_batch):
        """Build, and on the card capture, the executor of every pow2
        bucket up to ``max_batch`` (``mxnet_tpu/predictor.py:334``): a
        forward of zeros records each bucket's graph, so no request pays
        a capture.  Returns the buckets; without ``pad_to_bucket`` (or
        batch-axis inputs) none."""
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

    def _stage(self, exe, bucket, name, value, rows):
        """Copy ``value`` (``rows`` rows of a batch-axis input, zero-padded
        to the bucket, or a whole constant input) into the executor's
        bound input: through the bucket's pinned staging on the card."""
        dst = exe.arg_dict[name].handle
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
        stage, done = self._staging.get((bucket, name), (None, None))
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
        self._staging[(bucket, name)] = (stage, done)

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
            self._stage(exe, bucket, k, np.asarray(v, np.float32),
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
