"""Custom Python operators — the port of ``mxnet_tpu/operator.py``.

The three generations of the reference (``python/mxnet/operator.py``):

- :class:`CustomOp` / :class:`CustomOpProp` + :func:`register`, the
  modern interface, reached through ``nd.Custom`` / ``sym.Custom(...,
  op_type=...)``;
- :class:`NDArrayOp`, callbacks over NDArrays;
- :class:`PythonOp` / :class:`NumpyOp`, callbacks over numpy arrays.

Execution.  The JAX package jits its graphs, so it wraps user code in
``jax.pure_callback`` under a ``custom_vjp`` and pays a host round trip
per call.  The port runs eagerly: ``Custom`` is a
``torch.autograd.Function``.  Its forward calls
``prop.create_operator(ctx, in_shapes, in_dtypes)`` with the node's
real :class:`~context.Context` (the reference's contract; the JAX
package passes None, so a prop meant for both must accept either), then
``op.forward(is_train, req, in_data, out_data, aux)`` with ``in_data``
NDArrays over the detached input tensors on their device: no host round
trip (``NumpyOp`` / ``PythonOp`` make theirs, by definition).  Outputs
take the first input's dtype.  Its backward calls ``op.backward(req,
out_grad, in_data, out_data, in_grad, aux)`` on the same operator, with
the outputs the forward produced.  The JAX package runs the forward
again inside its backward callback; the results agree for a
deterministic forward, but the port launches a user kernel once per
forward, not twice.  Head gradients reach the backward even when they
are zeros (the fused step seeds zero cotangents), so a
``need_top_grad=False`` loss head injects its own gradient.

A step captured on the card (``compile_cache.StagedStep``) makes the
same user calls outside autograd, between the replays of its graphs:
:func:`custom_forward` and :func:`custom_backward`, once each per step.

Shape inference never runs user code on meta tensors: input shapes come
from the prop's ``infer_shape`` (``complete_shapes``) and output shapes
and dtypes from ``infer_shape`` again (``infer_outputs``), without
``create_operator``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .base import MXNetError
from .context import context_of
from .ndarray import NDArray
from .ops.registry import register as _register_op

__all__ = ['CustomOp', 'CustomOpProp', 'register', 'NDArrayOp', 'PythonOp',
           'NumpyOp', 'get_all_registered_operators', 'custom_forward',
           'custom_backward']

_CUSTOM_OP_PROPS: Dict[str, type] = {}


class CustomOp(object):
    """Base class of a custom operator's computation (reference
    operator.py:603)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write ``src`` to ``dst`` honouring the request: 'write' and
        'inplace' replace, 'add' accumulates, 'null' skips."""
        if req == 'null':
            return
        if req in ('write', 'inplace'):
            dst[:] = src
        elif req == 'add':
            dst[:] = dst + src
        else:
            raise MXNetError('unknown request %r' % (req,))


class CustomOpProp(object):
    """Registration-time metadata of a custom operator (reference
    operator.py:648)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_outputs(self):
        return ['output']

    def list_arguments(self):
        return ['data']

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad():
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError()


def register(reg_name):
    """Register a CustomOpProp subclass under ``op_type``: after
    ``@register('myop')``, ``nd.Custom(..., op_type='myop')`` and
    ``sym.Custom(..., op_type='myop')`` dispatch to it."""
    def do_register(prop_cls):
        _CUSTOM_OP_PROPS[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_all_registered_operators():
    return list(_CUSTOM_OP_PROPS)


def _make_prop(attrs):
    """The prop of a ``Custom`` node: its kwargs ride the node's attrs
    and reach the prop as strings, as in symbol JSON."""
    op_type = attrs.get('op_type')
    if op_type not in _CUSTOM_OP_PROPS:
        raise MXNetError('custom op type %r is not registered' % op_type)
    kwargs = {k: v for k, v in attrs.items()
              if k != 'op_type' and v is not None}
    return _CUSTOM_OP_PROPS[op_type](**{k: str(v) for k, v in
                                        kwargs.items()})


def _aliases_any(t, others):
    ptr = t.untyped_storage().data_ptr()
    return any(o.untyped_storage().data_ptr() == ptr for o in others)


def _user_forward(run, inputs):
    """The user's forward on ``inputs`` (tensors): the outputs and what
    :func:`_user_backward` needs."""
    n_args = run['n_args']
    ctx = run['ctx']
    ins = [NDArray(t.detach(), ctx) for t in inputs[:n_args]]
    auxs = [NDArray(t.detach(), ctx) for t in inputs[n_args:]]
    dev = inputs[0].device
    outs = [NDArray(torch.zeros(s, dtype=run['dtype'], device=dev), ctx)
            for s in run['out_shapes']]
    run['op'].forward(run['is_train'], ['write'] * len(outs), ins, outs,
                      auxs)
    results = []
    for o, shape in zip(outs, run['out_shapes']):
        t = o.handle
        if tuple(t.shape) != tuple(shape):
            raise MXNetError('Custom %s: output of shape %s, infer_shape '
                             'said %s' % (run['op_type'],
                                          tuple(t.shape), tuple(shape)))
        # an output never aliases an input (autograd and the fused
        # step's in-place updates need distinct storage)
        results.append(t.clone() if _aliases_any(t, inputs) else t)
    return results, (ins, auxs, outs)


def _user_backward(run, saved, grads):
    """The user's backward on the same operator, with the forward's
    outputs: the gradient of every argument input."""
    ins, auxs, outs = saved
    ctx = run['ctx']
    out_grad = [NDArray(g.contiguous(), ctx) for g in grads]
    in_grad = [NDArray(torch.zeros_like(a.handle), ctx) for a in ins]
    run['op'].backward(['write'] * len(in_grad), out_grad, ins, outs,
                       in_grad, auxs)
    return [g.handle for g in in_grad]


class _CustomFunction(torch.autograd.Function):
    """The user's forward, and the user's backward on the same operator
    with the forward's outputs."""

    @staticmethod
    def forward(fctx, run, *inputs):
        results, saved = _user_forward(run, inputs)
        fctx.run = run
        fctx.saved = saved
        return tuple(results)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(fctx, *grads):
        in_grads = _user_backward(fctx.run, fctx.saved, grads)
        return (None,) + tuple(in_grads) + (None,) * len(fctx.saved[1])


def _make_run(attrs, inputs, is_train):
    prop = _make_prop(attrs)
    n_args = len(prop.list_arguments())
    in_shapes = [tuple(t.shape) for t in inputs[:n_args]]
    _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
    ctx = context_of(inputs[0].device)
    op = prop.create_operator(ctx, in_shapes,
                              [t.dtype for t in inputs[:n_args]])
    return {'op': op, 'op_type': attrs.get('op_type'), 'n_args': n_args,
            'ctx': ctx, 'is_train': bool(is_train),
            'dtype': inputs[0].dtype,
            'out_shapes': [tuple(int(d) for d in s) for s in out_shapes]}


def _custom_apply(attrs, inputs, is_train, rng):
    run = _make_run(attrs, inputs, is_train)
    return list(_CustomFunction.apply(run, *inputs)), {}


def custom_forward(attrs, inputs, is_train):
    """A ``Custom`` node's forward outside autograd, as a step captured in
    segments runs it between its graphs: ``(outputs, state)``, ``state``
    for :func:`custom_backward`.  The same user calls as the node's
    autograd form makes."""
    run = _make_run(attrs, inputs, is_train)
    outs, saved = _user_forward(run, inputs)
    return outs, (run, saved)


def custom_backward(state, grads):
    """The user's backward of a :func:`custom_forward`: one gradient per
    argument input."""
    run, saved = state
    return _user_backward(run, saved, grads)


def _custom_input_names(attrs):
    return _make_prop(attrs).list_arguments()


def _custom_aux_names(attrs):
    return _make_prop(attrs).list_auxiliary_states()


def _custom_num_outputs(attrs):
    return len(_make_prop(attrs).list_outputs())


def _custom_complete(attrs, in_shapes):
    """Input shapes the prop derives (``mxnet_tpu/operator.py:204-225``):
    all of them from known data shapes; a prop that cannot take unknown
    entries keeps what was known."""
    prop = _make_prop(attrs)
    if all(s is not None for s in in_shapes):
        completed, _, _ = prop.infer_shape([list(s) for s in in_shapes])
        return [tuple(s) for s in completed]
    if in_shapes and in_shapes[0] is not None:
        try:
            completed, _, _ = prop.infer_shape(
                [list(s) if s is not None else None for s in in_shapes])
        except MXNetError:
            raise          # deliberate prop errors must reach the user
        except (TypeError, ValueError):
            return in_shapes
        return [tuple(c) if c is not None else
                (tuple(s) if s is not None else None)
                for c, s in zip(completed, in_shapes)]
    return in_shapes


def _custom_infer_outputs(attrs, in_shapes, in_dtypes):
    prop = _make_prop(attrs)
    n_args = len(prop.list_arguments())
    _, out_shapes, _ = prop.infer_shape([list(s) for s in
                                         in_shapes[:n_args]])
    return [(tuple(int(d) for d in s), in_dtypes[0]) for s in out_shapes]


_register_op('Custom', _custom_apply,
             input_names=_custom_input_names,
             num_outputs=_custom_num_outputs,
             aux_names=_custom_aux_names,
             complete_shapes=_custom_complete,
             infer_outputs=_custom_infer_outputs,
             attr_defaults={'op_type': None},
             hint='custom')


def _register_callback_prop(op_self, prefix, make_op):
    """Register a CustomOpProp that forwards to the callback op
    ``op_self`` and builds its operator with ``make_op``; returns the
    op_type."""
    op_type = '%s%d' % (prefix, id(op_self))

    @register(op_type)
    class _Prop(CustomOpProp):
        def __init__(self, **kw):
            super().__init__(need_top_grad=op_self.need_top_grad())

        def list_arguments(self):
            return op_self.list_arguments()

        def list_outputs(self):
            return op_self.list_outputs()

        def infer_shape(self, in_shape):
            shapes = op_self.infer_shape(in_shape)
            return shapes[0], shapes[1], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return make_op()
    return op_type


class NDArrayOp(object):
    """Legacy NDArray callback op (reference operator.py:242): subclass,
    implement forward/backward over NDArrays, then ``get_symbol``."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def forward(self, in_data, out_data):
        raise NotImplementedError()

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError()

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_outputs(self):
        return ['output']

    def list_arguments(self):
        return ['data']

    def need_top_grad(self):
        return self.need_top_grad_

    def get_symbol(self, *args, **kwargs):
        op_self = self

        class _Op(CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                op_self.forward(in_data, out_data)

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                op_self.backward(out_grad, in_data, out_data, in_grad)

        from . import symbol as sym
        kwargs['op_type'] = _register_callback_prop(self, '_ndarray_op_', _Op)
        return sym.Custom(*args, **kwargs)


class PythonOp(object):
    """The oldest numpy-callback op base (reference operator.py:28)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def __call__(self, *args, **kwargs):
        return self.get_symbol(*args, **kwargs)

    def forward(self, in_data, out_data):
        raise NotImplementedError()

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError()

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_outputs(self):
        return ['output']

    def list_arguments(self):
        return ['data']

    def need_top_grad(self):
        return self.need_top_grad_

    def get_symbol(self, *args, **kwargs):
        raise NotImplementedError()


class NumpyOp(PythonOp):
    """Numpy-array custom op (reference operator.py:100): its callbacks
    get host copies, and their results are copied back."""

    def get_symbol(self, *args, **kwargs):
        op_self = self

        class _Op(CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                ins = [x.asnumpy() for x in in_data]
                outs = [x.asnumpy() for x in out_data]
                op_self.forward(ins, outs)
                for dst, src in zip(out_data, outs):
                    dst[:] = src

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                ogs = [x.asnumpy() for x in out_grad]
                ins = [x.asnumpy() for x in in_data]
                outs = [x.asnumpy() for x in out_data]
                igs = [np.array(x.asnumpy()) for x in in_grad]
                op_self.backward(ogs, ins, outs, igs)
                for dst, src in zip(in_grad, igs):
                    dst[:] = src

        from . import symbol as sym
        kwargs['op_type'] = _register_callback_prop(self, '_numpy_op_', _Op)
        return sym.Custom(*args, **kwargs)
