"""Executor — evaluation of a bound Symbol.

The port of ``mxnet_tpu/executor.py``'s forward path.  The JAX package
traces the graph once into a jitted XLA program; here the same graph
interpreter (:func:`_build_graph_fn`, ``mxnet_tpu/executor.py:42-103``)
runs eagerly, op by op, on the tensors' device.  The step-compiler pass
pipeline (``fuse.apply_fuse_passes``, ``MXTPU_FUSE``) runs once per
(executor, mode) on the symbol the interpreter walks, as
``Executor._program_symbol`` does there (``:198-212``).  This slice
ports no backward: forwards run under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import instrument
from .base import MXNetError
from .context import Context
from .ndarray import NDArray, zeros as nd_zeros
from .symbol import Symbol

__all__ = ['Executor']


def _build_graph_fn(symbol: Symbol, is_train: bool):
    """The function ``(arg_values, aux_values) -> (outputs,
    aux_updates)`` over name -> tensor dicts; ``is_train`` is fixed."""
    nodes = symbol.topo_nodes()
    out_entries = symbol._outputs

    def fn(arg_values: Dict[str, torch.Tensor],
           aux_values: Dict[str, torch.Tensor]):
        entry_vals: Dict[Tuple[int, int], torch.Tensor] = {}
        aux_updates: Dict[str, torch.Tensor] = {}
        for node in nodes:
            if node.is_variable:
                if node.name in arg_values:
                    entry_vals[(id(node), 0)] = arg_values[node.name]
                elif node.name in aux_values:
                    entry_vals[(id(node), 0)] = aux_values[node.name]
                else:
                    raise MXNetError('unbound variable %s' % node.name)
                continue
            op = node.opdef()
            ins = [entry_vals[(id(n), x)] for n, x in node.inputs]
            outs, aux_upd = op.apply(node.attrs, ins, is_train, None)
            for j, o in enumerate(outs):
                entry_vals[(id(node), j)] = o
            if aux_upd:
                # op-local aux names -> graph variable names
                n_main = len(op.input_names(node.attrs))
                aux_nms = op.aux_names(node.attrs)
                for local_name, val in aux_upd.items():
                    var_node = node.inputs[n_main + aux_nms.index(
                        local_name)][0]
                    aux_updates[var_node.name] = val
        return [entry_vals[(id(n), x)] for n, x in out_entries], aux_updates

    return fn


class Executor:
    """A bound computation (reference ``python/mxnet/executor.py``)."""

    def __init__(self, symbol: Symbol, ctx, args, aux_states=None):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_dict = self._normalize(args, self.arg_names, 'args')
        self.aux_dict = self._normalize(aux_states, self.aux_names,
                                        'aux_states', allow_none=True)
        self._fuse_cache: Dict[bool, Symbol] = {}
        self._graph_fns: Dict[bool, object] = {}
        self.outputs = []

    @staticmethod
    def _normalize(values, names, what, allow_none=False):
        if values is None:
            if allow_none:
                return {}
            raise MXNetError('%s must be provided' % what)
        if isinstance(values, dict):
            out = dict(values)
        else:
            values = list(values)
            if len(values) != len(names):
                raise MXNetError('length of %s (%d) does not match '
                                 'number of names (%d)'
                                 % (what, len(values), len(names)))
            out = {n: v for n, v in zip(names, values) if v is not None}
        for k, v in out.items():
            if not isinstance(v, NDArray):
                raise TypeError('%s[%s] must be NDArray' % (what, k))
        return out

    def _program_symbol(self, is_train):
        """The symbol the interpreter walks: the pass pipeline's output,
        computed once per (executor, mode).  With ``MXTPU_FUSE`` off it
        is the bound symbol itself."""
        key = bool(is_train)
        cached = self._fuse_cache.get(key)
        if cached is None:
            from .fuse import apply_fuse_passes
            cached = apply_fuse_passes(self._symbol, key)
            self._fuse_cache[key] = cached
        return cached

    def forward(self, is_train=False, **kwargs):
        """Run the graph; returns (and keeps in ``outputs``) one NDArray
        per output.  Keyword arguments overwrite bound arguments first.
        Training-mode forwards compute batch statistics and write the
        moving-stat updates back to the aux arrays."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError('unknown argument %s' % k)
            self.arg_dict[k][:] = v
        key = bool(is_train)
        fn = self._graph_fns.get(key)
        if fn is None:
            fn = self._graph_fns[key] = _build_graph_fn(
                self._program_symbol(key), key)
        args = {k: v.handle for k, v in self.arg_dict.items()}
        aux = {k: v.handle for k, v in self.aux_dict.items()}
        with torch.no_grad():
            outs, aux_updates = fn(args, aux)
        for name, val in aux_updates.items():
            self.aux_dict[name]._set_data(val)
        self.outputs = [NDArray(o, self._ctx) for o in outs]
        instrument.inc('executor.forwards')
        return self.outputs

    def reshape(self, **kwargs):
        """A new Executor bound at new argument shapes: arrays whose
        shape is unchanged (the parameters) are shared, the rest are
        fresh zeros."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError('Insufficient argument shapes provided.')
        new_args, new_aux = {}, {}
        for name, shape in zip(self.arg_names, arg_shapes):
            old = self.arg_dict[name]
            new_args[name] = old if shape == old.shape else \
                nd_zeros(shape, self._ctx, dtype=old.dtype)
        for name, shape in zip(self.aux_names, aux_shapes):
            old = self.aux_dict[name]
            new_aux[name] = old if shape == old.shape else \
                nd_zeros(shape, self._ctx, dtype=old.dtype)
        return Executor(self._symbol, self._ctx, new_args, new_aux)
