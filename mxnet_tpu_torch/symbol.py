"""Symbol — declarative graph construction.

The port of ``mxnet_tpu/symbol.py``: a Symbol is a list of output entries
of a DAG of :class:`Node` objects.  Composition, attribute scoping, JSON
save/load (with the legacy-JSON upgrade), ``list_arguments`` /
``list_auxiliary_states`` / ``get_internals`` / :func:`Group` and
``bind`` mirror the JAX package, so symbol JSON written by either
package loads in the other.

``infer_shape`` evaluates each op on ``meta`` tensors, where the JAX
package uses ``jax.eval_shape`` (``mxnet_tpu/symbol.py:744``): op
implementations and their shape functions cannot disagree.  An op that
runs user code (``Custom``) gives its output shapes through its
``infer_outputs`` hook instead.  As in the JAX package, a fixpoint
alternates that forward pass with a bidirectional partial-shape
constraint pass (0 = an unknown dim; outputs constrain inputs through
the elementwise ops, FullyConnected, Convolution, Concat and
SliceChannel): ``infer_shape_partial`` returns what it could infer, and
``infer_type`` runs the forward pass on (1,)-shaped stand-ins.
``eval``, ``get_children``, ``debug_str``, pickling and the module
functions ``maximum`` / ``minimum`` / ``pow`` follow the JAX package;
``grad`` raises there and here (gradients come from
``bind(args_grad=...).backward()``).
"""
from __future__ import annotations

import builtins
import json
import math
from typing import Dict, List, Optional, Tuple

import torch

from .base import MXNetError, NameManager, AttrScope, resolve_dtype
from .ops import get_op, list_ops

__all__ = ['Symbol', 'Variable', 'Group', 'load', 'load_json', 'maximum',
           'minimum', 'pow']


class Node:
    """Graph node: an operator application or a variable (op is None)."""

    __slots__ = ('op', 'name', 'attrs', 'inputs', '_extra_attr')

    def __init__(self, op: Optional[str], name: str, attrs: dict,
                 inputs: List[Tuple['Node', int]]):
        self.op = op
        self.name = name
        self.attrs = attrs          # operator parameters (typed)
        self.inputs = inputs        # list of (node, out_index)
        self._extra_attr = {}       # user attrs: ctx_group, lr_mult, ...

    @property
    def is_variable(self):
        return self.op is None

    def opdef(self):
        return get_op(self.op)

    def num_outputs(self):
        if self.is_variable:
            return 1
        return self.opdef().num_outputs(self.attrs)

    def output_names(self):
        if self.is_variable:
            return [self.name]
        outs = self.opdef().output_names(self.attrs)
        return ['%s_%s' % (self.name, o) for o in outs]

    def __getstate__(self):
        return {s: getattr(self, s) for s in self.__slots__}

    def __setstate__(self, state):
        for s in self.__slots__:
            setattr(self, s, state[s])


def _topo_order(output_entries) -> List[Node]:
    order: List[Node] = []
    visited = set()

    def visit(node):
        if id(node) in visited:
            return
        visited.add(id(node))
        for inp, _ in node.inputs:
            visit(inp)
        order.append(node)

    for node, _ in output_entries:
        visit(node)
    return order


class Symbol:
    """Symbolic multi-output expression (reference symbol.py:44-)."""

    def __init__(self, outputs: List[Tuple[Node, int]]):
        self._outputs = outputs

    # -- introspection -----------------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def topo_nodes(self) -> List[Node]:
        return _topo_order(self._outputs)

    def _arg_nodes(self) -> List[Node]:
        aux = set(self._aux_node_ids())
        return [n for n in self.topo_nodes()
                if n.is_variable and id(n) not in aux]

    def list_arguments(self) -> List[str]:
        return [n.name for n in self._arg_nodes()]

    def list_outputs(self) -> List[str]:
        return [node.output_names()[idx] for node, idx in self._outputs]

    def list_auxiliary_states(self) -> List[str]:
        aux = self._aux_node_ids()
        order = {id(n): n for n in self.topo_nodes()}
        return [order[i].name for i in aux if i in order]

    def _aux_node_ids(self):
        """ids of variable nodes feeding aux slots, in topo order."""
        out = []
        seen = set()
        for n in self.topo_nodes():
            if n.is_variable:
                continue
            op = n.opdef()
            n_main = len(op.input_names(n.attrs))
            for (inp, _idx) in n.inputs[n_main:]:
                if inp.is_variable and id(inp) not in seen:
                    seen.add(id(inp))
                    out.append(id(inp))
        return out

    def get_internals(self) -> 'Symbol':
        entries = []
        for n in self.topo_nodes():
            for i in range(n.num_outputs()):
                entries.append((n, i))
        return Symbol(entries)

    def get_children(self) -> Optional['Symbol']:
        """The inputs of the first output's node, or None for a
        variable (reference symbol.py:162)."""
        node = self._outputs[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise ValueError('cannot find output %s' % index)
            index = names.index(index)
        if isinstance(index, builtins.slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    # -- attributes --------------------------------------------------------
    def attr(self, key):
        node = self._outputs[0][0]
        val = node._extra_attr.get(key)
        if val is None and not key.startswith('__'):
            val = node._extra_attr.get('__%s__' % key)
        return val

    def _set_attr(self, **kwargs):
        node = self._outputs[0][0]
        node._extra_attr.update({k: str(v) for k, v in kwargs.items()})

    def list_attr(self):
        return dict(self._outputs[0][0]._extra_attr)

    def attr_dict(self):
        out = {}
        for n in self.topo_nodes():
            merged = {}
            if not n.is_variable:
                merged.update({k: str(v) for k, v in n.attrs.items()
                               if v is not None})
            merged.update(n._extra_attr)
            if merged:
                out[n.name] = merged
        return out

    # -- composition -------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """Re-compose: plug new inputs into this symbol's free variables."""
        s = self.__copy__()
        s._compose(*args, **kwargs)
        return s

    def _compose(self, *args, **kwargs):
        name = kwargs.pop('name', None)
        repl: Dict[int, Node] = {}
        nodes = self._arg_nodes()
        for var, sym in zip(nodes, args):
            repl[id(var)] = sym._outputs[0][0]
        for k, v in kwargs.items():
            for var in nodes:
                if var.name == k:
                    repl[id(var)] = v._outputs[0][0]
        for n in self.topo_nodes():
            n.inputs = [(repl.get(id(inp), inp), idx)
                        for inp, idx in n.inputs]
        if name:
            self._outputs[0][0].name = name

    def __copy__(self):
        mapping: Dict[int, Node] = {}
        for n in self.topo_nodes():
            if n.is_variable:
                mapping[id(n)] = n  # variables are shared
            else:
                nn = Node(n.op, n.name, dict(n.attrs),
                          [(mapping.get(id(i), i), x) for i, x in n.inputs])
                nn._extra_attr = dict(n._extra_attr)
                mapping[id(n)] = nn
        return Symbol([(mapping[id(n)], i) for n, i in self._outputs])

    def __deepcopy__(self, memo):
        return load_json(self.tojson())

    # -- arithmetic sugar (reference symbol.py __add__ etc.) ---------------
    def _binop(self, other, op_name, scalar_op):
        if isinstance(other, Symbol):
            return _apply_op(op_name, None, [self, other], {})
        return _apply_op(scalar_op, None, [self], {'scalar': float(other)})

    def __add__(self, o): return self._binop(o, '_plus', '_plus_scalar')
    def __radd__(self, o): return self.__add__(o)
    def __sub__(self, o): return self._binop(o, '_minus', '_minus_scalar')
    def __rsub__(self, o): return _apply_op('_rminus_scalar', None, [self],
                                            {'scalar': float(o)})
    def __mul__(self, o): return self._binop(o, '_mul', '_mul_scalar')
    def __rmul__(self, o): return self.__mul__(o)
    def __truediv__(self, o): return self._binop(o, '_div', '_div_scalar')
    def __rtruediv__(self, o): return _apply_op('_rdiv_scalar', None, [self],
                                                {'scalar': float(o)})
    def __pow__(self, o): return self._binop(o, '_power', '_power_scalar')
    def __neg__(self): return self.__mul__(-1.0)

    # -- shape and type inference -----------------------------------------
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from known argument
        shapes, positional (in ``list_arguments`` order) or by name; a
        shape may hold 0 for an unknown dim."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As ``infer_shape``, but what cannot be inferred is None (or
        keeps its 0 dims) instead of raising (reference symbol.py:285)."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        known: Dict[str, tuple] = {}
        for name, shape in zip(self.list_arguments(), args):
            if shape is not None:
                known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        shapes, _ = _infer(self, known, partial=partial)
        arg_shapes = [shapes.get(n) for n in self.list_arguments()]
        aux_shapes = [shapes.get(n) for n in self.list_auxiliary_states()]
        out_shapes = [shapes.get(('out', id(node), idx))
                      for node, idx in self._outputs]
        if not partial and any(s is None for s in arg_shapes + out_shapes):
            return None, None, None
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """``(arg_types, out_types, aux_types)`` (``torch.dtype``s) from
        known argument types, positional or by name (reference
        symbol.py:307)."""
        known: Dict[str, torch.dtype] = {}
        for name, t in zip(self.list_arguments(), args):
            if t is not None:
                known[name] = resolve_dtype(t)
        known.update({k: resolve_dtype(v) for k, v in kwargs.items()
                      if v is not None})
        _, dtypes = _infer(self, {}, known, partial=True,
                           dummy_shapes=True)
        return ([dtypes.get(n) for n in self.list_arguments()],
                [dtypes.get(('out', id(n), i)) for n, i in self._outputs],
                [dtypes.get(n) for n in self.list_auxiliary_states()])

    # -- serialization -----------------------------------------------------
    def tojson(self):
        nodes = self.topo_nodes()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jn = {'op': 'null' if n.is_variable else n.op,
                  'name': n.name,
                  'inputs': [[nid[id(i)], x, 0] for i, x in n.inputs]}
            attrs = {k: str(v) for k, v in (n.attrs or {}).items()
                     if v is not None}
            attrs.update(n._extra_attr)
            if attrs:
                jn['attrs'] = attrs
            jnodes.append(jn)
        arg_nodes = [i for i, n in enumerate(nodes) if n.is_variable]
        heads = [[nid[id(n)], i, 0] for n, i in self._outputs]
        return json.dumps({'nodes': jnodes, 'arg_nodes': arg_nodes,
                           'node_row_ptr': list(range(len(nodes) + 1)),
                           'heads': heads,
                           'attrs': {'mxnet_version': ['int', 903]}},
                          indent=2)

    def save(self, fname):
        with open(fname, 'w') as f:
            f.write(self.tojson())

    # -- executor entry point (executor.py) --------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req='write',
             aux_states=None):
        """An :class:`~mxnet_tpu_torch.executor.Executor` over ``args`` /
        ``args_grad`` / ``aux_states`` (dicts or lists of NDArrays);
        without ``args_grad`` it computes no gradients."""
        from .executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    def simple_bind(self, ctx, grad_req='write', type_dict=None, **kwargs):
        """Bind with argument, gradient and aux arrays allocated from the
        shapes inferred from ``kwargs``."""
        from .executor import simple_bind
        return simple_bind(self, ctx, grad_req, type_dict, **kwargs)

    def eval(self, ctx=None, **kwargs):
        """Bind ``kwargs`` (name -> NDArray) on ``ctx`` (default the
        current context) and run an inference forward; the outputs
        (reference symbol.py:365)."""
        from .context import current_context
        return self.bind(ctx or current_context(), kwargs).forward()

    def grad(self, wrt):
        raise NotImplementedError(
            'Symbol.grad: use bind(args_grad=...).backward(); gradients '
            'are taken by autograd at run time')

    def debug_str(self):
        """One line per node: its op (or Variable), name and inputs."""
        lines = []
        for n in self.topo_nodes():
            kind = 'Variable' if n.is_variable else n.op
            lines.append('%s %s inputs=[%s]' % (
                kind, n.name, ', '.join(i.name for i, _ in n.inputs)))
        return '\n'.join(lines)

    def __repr__(self):
        return '<Symbol %s>' % (self.name or self.list_outputs())


# ---------------------------------------------------------------------------
# Shape inference: forward evaluation over the graph on meta tensors
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device='meta')


# Same-shape elementwise families for the partial-shape constraint pass
# (reference nnvm InferShape fixpoint; 0 = unknown dim, mxnet convention).
_PARTIAL_ELEMWISE = {'_plus', '_minus', '_mul', '_div', '_power',
                     '_maximum', '_minimum', 'elemwise_add',
                     'elemwise_sub', 'elemwise_mul', 'elemwise_div'}
_PARTIAL_UNARY = {'Activation', 'Dropout', 'LeakyReLU', 'BatchNorm',
                  'InstanceNorm', 'relu', 'sigmoid', 'tanh', 'Cast',
                  'identity', 'BlockGrad', 'negative'}


def _pmerge(a, b):
    """Merge two partial shapes (0 = unknown); None = fully unknown."""
    if a is None:
        return tuple(b) if b is not None else None
    if b is None:
        return tuple(a)
    if len(a) != len(b):
        return tuple(a)  # rank conflict: leave to eval to diagnose
    out = []
    for x, y in zip(a, b):
        if x == 0:
            out.append(y)
        elif y == 0 or x == y:
            out.append(x)
        else:
            raise MXNetError('incompatible inferred shapes %s vs %s'
                             % (a, b))
    return tuple(out)


def _var_attr_shape(n):
    """A variable's declared shape: its ``__shape__`` attr, or the one a
    symbol JSON carried (``load_json`` keeps a variable's attributes in
    ``_extra_attr``; the JAX package's loader drops it, ROADMAP Queue
    3)."""
    extra = getattr(n, '_extra_attr', None) or {}
    sattr = n.attrs.get('__shape__') or n.attrs.get('shape') or \
        extra.get('__shape__')
    if not sattr:
        return None
    return tuple(sattr) if not isinstance(sattr, str) \
        else tuple(json.loads(sattr.replace('(', '[').replace(')', ']')))


def _infer(sym: Symbol, known_shapes: Dict[str, tuple],
           known_dtypes: Optional[Dict[str, torch.dtype]] = None,
           partial=False, dummy_shapes=False):
    """``(shapes, dtypes)`` by name (and ``('out', id(node), i)`` for the
    outputs): the JAX package's fixpoint (``mxnet_tpu/symbol.py:425``) of
    a bidirectional partial-shape constraint pass (0 = unknown dim) and a
    forward pass evaluating each op on ``meta`` tensors.  Without
    ``partial`` a node whose inputs stay unknown raises; ``dummy_shapes``
    (``infer_type``) gives unknown variables shape (1,)."""
    known_dtypes = known_dtypes or {}
    nodes = sym.topo_nodes()
    shapes: Dict[object, Optional[tuple]] = {}
    dtypes: Dict[object, object] = {}
    entry_aval: Dict[Tuple[int, int], Optional[torch.Tensor]] = {}
    # partial shapes (with 0 dims) tracked apart until complete
    pend: Dict[Tuple[int, int], tuple] = {}
    var_of_entry: Dict[Tuple[int, int], Node] = {}

    for n in nodes:
        if n.is_variable:
            shp = known_shapes.get(n.name)
            if shp is None:
                shp = _var_attr_shape(n)
            dt = known_dtypes.get(n.name) or \
                resolve_dtype(n.attrs.get('__dtype__'))
            if shp is None and dummy_shapes:
                shp = (1,)
            var_of_entry[(id(n), 0)] = n
            if shp is not None and 0 in tuple(shp):
                pend[(id(n), 0)] = tuple(shp)
                shp = None
            shapes[n.name] = shp
            dtypes[n.name] = dt
            entry_aval[(id(n), 0)] = (_meta(shp, dt) if shp is not None
                                      else None)

    def get_p(key):
        aval = entry_aval.get(key)
        if aval is not None:
            return tuple(aval.shape)
        return pend.get(key)

    def set_p(key, shp):
        """Merge a partial shape into an entry; True on a change."""
        if shp is None:
            return False
        if entry_aval.get(key) is not None:
            _pmerge(tuple(entry_aval[key].shape), shp)  # conflict check
            return False
        merged = _pmerge(pend.get(key), shp)
        if merged == pend.get(key):
            return False
        pend[key] = merged
        if 0 not in merged:
            var = var_of_entry.get(key)
            dt = (dtypes.get(var.name) if var is not None else None) \
                or torch.float32
            entry_aval[key] = _meta(merged, dt)
            if var is not None:
                shapes[var.name] = merged
                dtypes[var.name] = dt
            del pend[key]
        return True

    def constraint_pass():
        """Bidirectional partial-shape propagation for structural ops
        (the nnvm InferShape backward rules the eval pass cannot express:
        elemwise merge, FC, Convolution, Concat, SliceChannel)."""
        prog = False
        for n in nodes:
            if n.is_variable:
                continue
            a = n.attrs
            ins = [(id(i), x) for i, x in n.inputs]
            out0 = (id(n), 0)
            if n.op in _PARTIAL_ELEMWISE and len(ins) == 2:
                pa, pb = get_p(ins[0]), get_p(ins[1])
                po = get_p(out0)
                ranks = {len(p) for p in (pa, pb, po) if p is not None}
                if len(ranks) != 1:
                    continue
                rank = ranks.pop()
                pa = pa or (0,) * rank
                pb = pb or (0,) * rank
                po = po or (0,) * rank
                na, nb, no = [], [], []
                for x, y, z in zip(pa, pb, po):
                    if x > 1 and y > 1 and x != y:
                        raise MXNetError(
                            'incompatible inferred shapes %s vs %s'
                            % (pa, pb))
                    if 1 in (x, y):
                        # broadcast dim: output is the larger side and
                        # nothing back-propagates into the size-1 side
                        out_d = z or (y if x == 1 else x)
                        na.append(x)
                        nb.append(y)
                        no.append(out_d)
                    else:
                        # same-shape convention (nnvm elemwise infer):
                        # unknowns take the known value.  NB the
                        # reference's elemwise ops do NOT broadcast, so
                        # its InferShape back-propagates like this and
                        # the mirrored incomplete-infer tests require
                        # it; our runtime `_plus` family does broadcast
                        # (jnp), so a program relying on an UNKNOWN
                        # size-1 dim broadcasting must use the
                        # broadcast_* ops for partial inference to
                        # stay sound (a known 1 takes the branch
                        # above).
                        m = x or y or z
                        if z and (x or y) and z != (x or y):
                            raise MXNetError(
                                'incompatible inferred shapes %s vs '
                                'output %s' % ((pa, pb), po))
                        na.append(m)
                        nb.append(m)
                        no.append(m)
                prog |= set_p(ins[0], tuple(na))
                prog |= set_p(ins[1], tuple(nb))
                prog |= set_p(out0, tuple(no))
            elif n.op in _PARTIAL_UNARY:
                m = _pmerge(get_p(ins[0]), get_p(out0))
                prog |= set_p(ins[0], m)
                prog |= set_p(out0, m)
            elif n.op == 'FullyConnected':
                nh = int(a['num_hidden'])
                d, o = get_p(ins[0]), get_p(out0)
                batch = 0
                if o is not None and len(o) == 2:
                    batch = o[0]
                if d is not None and d[0] != 0:
                    batch = d[0]
                prog |= set_p(out0, (batch, nh))
                if d is not None:
                    prog |= set_p(ins[0], (batch,) + tuple(d[1:]))
                    in_dim = math.prod(d[1:]) if 0 not in d[1:] else 0
                    if in_dim:
                        prog |= set_p(ins[1], (nh, in_dim))
            elif n.op == 'Convolution':
                kernel = a['kernel']
                nd_sp = len(kernel)
                stride = a.get('stride') or (1,) * nd_sp
                dil = a.get('dilate') or (1,) * nd_sp
                pad = a.get('pad') or (0,) * nd_sp
                pad_hi = a.get('pad_hi') or pad
                nf = int(a['num_filter'])
                d, o = get_p(ins[0]), get_p(out0)
                if d is None and o is None:
                    continue
                rank = 2 + nd_sp
                d = d or (0,) * rank
                o = o or (0,) * rank
                batch = d[0] or o[0]
                dk = [int(di) * (int(k) - 1) + 1
                      for k, di in zip(kernel, dil)]
                osp, isp = [], []
                for j in range(nd_sp):
                    i_dim, o_dim = d[2 + j], o[2 + j]
                    p2 = int(pad[j]) + int(pad_hi[j])
                    if i_dim:
                        o_dim = o_dim or \
                            (i_dim + p2 - dk[j]) // int(stride[j]) + 1
                    elif o_dim:
                        i_dim = (o_dim - 1) * int(stride[j]) \
                            - p2 + dk[j]
                    osp.append(o_dim)
                    isp.append(i_dim)
                prog |= set_p(out0, (batch, nf) + tuple(osp))
                prog |= set_p(ins[0], (batch, d[1]) + tuple(isp))
            elif n.op == 'Concat':
                dim = int(a.get('dim', 1))
                parts = [get_p(k) for k in ins]
                o = get_p(out0)
                ranks = [len(p) for p in parts if p is not None] + \
                    ([len(o)] if o is not None else [])
                if not ranks:
                    continue
                rank = ranks[0]
                merged_other = o
                for p in parts:
                    if p is None:
                        continue
                    masked = tuple(0 if j == dim else v
                                   for j, v in enumerate(p))
                    merged_other = _pmerge(
                        merged_other if merged_other is None else
                        tuple(0 if j == dim else v
                              for j, v in enumerate(merged_other)),
                        masked)
                known_parts = [p[dim] for p in parts
                               if p is not None and p[dim] != 0]
                total = builtins.sum(known_parts) if len(known_parts) \
                    == len(parts) else (o[dim] if o is not None else 0)
                if merged_other is not None:
                    for k, p in zip(ins, parts):
                        pd = p[dim] if p is not None else 0
                        if pd == 0 and o is not None and o[dim] and \
                                len(known_parts) == len(parts) - 1:
                            pd = o[dim] - builtins.sum(known_parts)
                        prog |= set_p(k, tuple(
                            pd if j == dim else v
                            for j, v in enumerate(merged_other)))
                    prog |= set_p(out0, tuple(
                        total if j == dim else v
                        for j, v in enumerate(merged_other)))
            elif n.op == 'SliceChannel':
                k_out = int(a.get('num_outputs', 1))
                axis = int(a.get('axis', 1))
                squeeze = bool(a.get('squeeze_axis', False))
                d = get_p(ins[0])
                outs = [(id(n), j) for j in range(n.num_outputs())]
                m_out = None
                for ok in outs:
                    m_out = _pmerge(m_out, get_p(ok))
                if d is not None:
                    if axis < len(d) and d[axis]:
                        if d[axis] % k_out != 0:
                            raise MXNetError(
                                'SliceChannel: input dim %d on axis %d '
                                'is not divisible by num_outputs %d'
                                % (d[axis], axis, k_out))
                        if squeeze and d[axis] != k_out:
                            raise MXNetError(
                                'SliceChannel: squeeze_axis requires '
                                'input dim %d on axis %d to EQUAL '
                                'num_outputs %d'
                                % (d[axis], axis, k_out))
                    if squeeze:
                        o_from_in = tuple(v for j, v in enumerate(d)
                                          if j != axis)
                    else:
                        o_from_in = tuple(
                            (v // k_out if v else 0) if j == axis else v
                            for j, v in enumerate(d))
                    m_out = _pmerge(m_out, o_from_in)
                for ok in outs:
                    prog |= set_p(ok, m_out)
                if m_out is not None:
                    if squeeze:
                        i_from_out = m_out[:axis] + (k_out,) + m_out[axis:]
                    else:
                        i_from_out = tuple(
                            v * k_out if j == axis else v
                            for j, v in enumerate(m_out))
                    prog |= set_p(ins[0], i_from_out)
        return prog

    evaled = set()

    def eval_pass():
        prog = False
        for n in nodes:
            if n.is_variable or id(n) in evaled:
                continue
            op = n.opdef()
            attrs = n.attrs
            ins = [entry_aval.get((id(i), x)) for i, x in n.inputs]
            n_main = len(op.input_names(attrs))
            # parameter shapes completed from the data shapes
            if op.complete_shapes is not None:
                in_shapes = [None if t is None else tuple(t.shape)
                             for t in ins[:n_main]]
                try:
                    completed = op.complete_shapes(attrs, list(in_shapes))
                except (KeyError, TypeError):
                    completed = in_shapes
                for i, shp in enumerate(completed):
                    if shp is not None and ins[i] is None:
                        inp_node, inp_idx = n.inputs[i]
                        dt = dtypes.get(inp_node.name) \
                            if inp_node.is_variable else None
                        dt = dt or (ins[0].dtype if ins[0] is not None
                                    else torch.float32)
                        ins[i] = entry_aval[(id(inp_node), inp_idx)] = \
                            _meta(shp, dt)
                        prog = True
                        if inp_node.is_variable:
                            shapes[inp_node.name] = tuple(shp)
                            dtypes[inp_node.name] = dt
            # aux shapes: the op's aux_shape hook, else aux tracks
            # input[0]'s channel dim
            if ins[0] is not None and op.aux_names(attrs):
                hint = None
                if op.aux_shape is not None:
                    try:
                        hint = op.aux_shape(
                            attrs, [None if t is None else tuple(t.shape)
                                    for t in ins[:n_main]])
                    except (KeyError, TypeError):
                        hint = None
                for j, (inp, idx) in enumerate(n.inputs[n_main:]):
                    if ins[n_main + j] is not None:
                        continue
                    if hint is not None and j < len(hint) and \
                            hint[j] is not None:
                        shp = tuple(hint[j])
                    else:
                        d = ins[0].shape
                        shp = (d[1],) if len(d) > 1 else (d[0],)
                    ins[n_main + j] = entry_aval[(id(inp), idx)] = \
                        _meta(shp, torch.float32)
                    prog = True
                    if inp.is_variable:
                        shapes[inp.name] = shp
                        dtypes[inp.name] = torch.float32
            if any(t is None for t in ins):
                continue
            try:
                if op.infer_outputs is not None:
                    # user code (Custom) never runs on meta tensors
                    outs = [_meta(shp, dt) for shp, dt in op.infer_outputs(
                        attrs, [tuple(t.shape) for t in ins],
                        [t.dtype for t in ins])]
                else:
                    with torch.no_grad():
                        outs, _ = op.apply(attrs, ins, False, None)
            except Exception as e:
                raise MXNetError('InferShape failed at node %s (%s): %s'
                                 % (n.name, n.op, e)) from e
            evaled.add(id(n))
            for i, t in enumerate(outs):
                prev = entry_aval.get((id(n), i))
                if prev is not None and not dummy_shapes and \
                        tuple(prev.shape) != tuple(t.shape):
                    raise MXNetError(
                        'InferShape: node %s (%s) output %d: declared/'
                        'propagated shape %s conflicts with computed %s'
                        % (n.name, n.op, i, tuple(prev.shape),
                           tuple(t.shape)))
                if prev is None:
                    prog = True
                entry_aval[(id(n), i)] = t
        return prog

    # fixpoint: forward eval + bidirectional constraint propagation
    # (under dummy_shapes, infer_type's fake (1,) shapes, only the eval)
    for _ in range(builtins.max(len(nodes), 2)):
        prog = False if dummy_shapes else constraint_pass()
        prog |= eval_pass()
        if not prog:
            break

    if not partial:
        for n in nodes:
            if n.is_variable or id(n) in evaled:
                continue
            missing = [inp.name for inp, x in n.inputs
                       if entry_aval.get((id(inp), x)) is None]
            raise MXNetError('InferShape: node %s (%s) has unknown input '
                             'shapes: %s — provide them to infer_shape'
                             % (n.name, n.op, missing))
    for n, i in sym._outputs:
        t = entry_aval.get((id(n), i))
        shapes[('out', id(n), i)] = tuple(t.shape) if t is not None else None
        dtypes[('out', id(n), i)] = t.dtype if t is not None else None
    for n in nodes:
        if n.is_variable:
            t = entry_aval.get((id(n), 0))
            if t is not None:
                shapes[n.name] = tuple(t.shape)
                dtypes[n.name] = t.dtype
    return shapes, dtypes


# ---------------------------------------------------------------------------
# Construction API
# ---------------------------------------------------------------------------

def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None):
    """Create a free variable (reference symbol.py:1049)."""
    if not isinstance(name, str):
        raise TypeError('Expect a string for variable name')
    attrs = {}
    if shape is not None:
        attrs['__shape__'] = tuple(shape)
    if dtype is not None:
        attrs['__dtype__'] = dtype
    node = Node(None, name, attrs, [])
    node._extra_attr = AttrScope.current().get(attr or {})
    if lr_mult is not None:
        node._extra_attr['__lr_mult__'] = str(lr_mult)
    if wd_mult is not None:
        node._extra_attr['__wd_mult__'] = str(wd_mult)
    if init is not None:
        node._extra_attr['__init__'] = init if isinstance(init, str) \
            else init.dumps()
    return Symbol([(node, 0)])


var = Variable


def Group(symbols):
    """Concatenate symbols into a multi-output symbol (symbol.py:1078)."""
    outputs = []
    for s in symbols:
        outputs.extend(s._outputs)
    return Symbol(outputs)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# attribute names the reference hides as __key__ extra attrs
# (c_api_symbolic.cc kHiddenKeys) — legacy JSON stores them bare
_HIDDEN_KEYS = ('ctx_group', 'lr_mult', 'wd_mult', 'force_mirroring',
                'mirror_stage')


def _upgrade_node_attrs(raw_attrs):
    """Split a legacy node's raw attr dict into (op attrs, extra attrs,
    per-input-variable attrs) — the reference's UpgradeJSON_FixParsing
    (``src/nnvm/legacy_json_util.cc:30-90``)."""
    op_attrs, extra, input_attrs = {}, {}, {}
    for k, v in raw_attrs.items():
        hidden = None
        for hk in _HIDDEN_KEYS:
            if k == hk:
                hidden = ('self', hk)
                break
            if k.endswith('_' + hk):
                hidden = (k[:-(len(hk) + 1)], hk)
                break
        if hidden is not None:
            target, hk = hidden
            if target == 'self':
                extra['__%s__' % hk] = v
            else:
                input_attrs.setdefault(target, {})['__%s__' % hk] = v
        elif k.startswith('__') and k.endswith('__'):
            extra[k] = v            # already-hidden user attrs
        else:
            op_attrs[k] = v
    return op_attrs, extra, input_attrs


def load_json(json_str):
    """Parse a symbol JSON, upgrading legacy formats as the JAX package
    does: attrs under ``attr``/``param`` are accepted, bare hidden keys
    move to ``__key__`` form, and pre-0.9 nodes that omit parameter/aux
    inputs get them created as ``{node}_{arg}``."""
    data = json.loads(json_str)
    nodes: List[Node] = []
    for jn in data['nodes']:
        raw_attrs = jn.get('attrs', jn.get('attr', jn.get('param', {}))) or {}
        if jn['op'] == 'null':
            node = Node(None, jn['name'], {}, [])
            node._extra_attr = {('__%s__' % k if k in _HIDDEN_KEYS else k): v
                                for k, v in raw_attrs.items()}
        else:
            op = get_op(jn['op'])
            op_attrs, extra, input_attrs = _upgrade_node_attrs(raw_attrs)
            attrs = op.canon_attrs(op_attrs)
            inputs = [(nodes[e[0]], e[1]) for e in jn['inputs']]
            expected = op.input_names(attrs) + op.aux_names(attrs)
            for j in range(len(inputs), len(expected)):
                inputs.append((Node(None, '%s_%s' % (jn['name'],
                                                     expected[j]), {}, []),
                               0))
            for target, hidden in input_attrs.items():
                if target in expected:
                    src = inputs[expected.index(target)][0]
                    if src.is_variable:
                        src._extra_attr.update(hidden)
                        continue
                extra.update({'%s_%s' % (target, k.strip('_')): v
                              for k, v in hidden.items()})
            node = Node(jn['op'], jn['name'], attrs, inputs)
            node._extra_attr = extra
        nodes.append(node)
    heads = data.get('heads') or [[len(nodes) - 1, 0, 0]]
    return Symbol([(nodes[h[0]], h[1]) for h in heads])


def _apply_op(op_name, name, sym_inputs: List[Symbol], attrs: dict,
              named_inputs: Optional[Dict[str, Symbol]] = None):
    op = get_op(op_name)
    cattrs = op.canon_attrs({k: v for k, v in attrs.items() if v is not None})
    if 'num_args' in op.attr_defaults and sym_inputs:
        cattrs['num_args'] = len(sym_inputs)
    in_names = op.input_names(cattrs)
    aux_names = op.aux_names(cattrs)
    name = NameManager.current().get(name, op.hint)
    entries: List[Optional[Tuple[Node, int]]] = \
        [None] * (len(in_names) + len(aux_names))
    for i, s in enumerate(sym_inputs):
        entries[i] = s._outputs[0]
    if named_inputs:
        pos = {nm: i for i, nm in enumerate(in_names + aux_names)}
        for k, v in named_inputs.items():
            if k not in pos:
                raise MXNetError('unknown input %r for op %s' % (k, op_name))
            entries[pos[k]] = v._outputs[0]
    # auto-create missing parameter/aux variables: name_weight, name_bias...
    for i, e in enumerate(entries):
        if e is None:
            pname = (in_names + aux_names)[i]
            vnode = Node(None, '%s_%s' % (name, pname), {}, [])
            hint_attrs = (op.input_var_attrs(cattrs, pname)
                          if op.input_var_attrs else None) or {}
            vnode._extra_attr = AttrScope.current().get(hint_attrs)
            entries[i] = (vnode, 0)
    node = Node(op.name, name, cattrs, entries)
    node._extra_attr = AttrScope.current().get({})
    if node.num_outputs() == 1:
        return Symbol([(node, 0)])
    return Symbol([(node, i) for i in range(node.num_outputs())])


def _make_creator(op_name):
    def create(*args, **kwargs):
        name = kwargs.pop('name', None)
        attr = kwargs.pop('attr', None)
        for a in args:
            if not isinstance(a, Symbol):
                raise TypeError('positional args to sym.%s must be Symbols'
                                % op_name)
        named = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        attrs = {k: v for k, v in kwargs.items()
                 if not isinstance(v, Symbol)}
        s = _apply_op(op_name, name, list(args), attrs, named)
        if attr:
            s._set_attr(**attr)
        return s
    create.__name__ = op_name
    create.__qualname__ = op_name
    create.__doc__ = get_op(op_name).doc
    return create


for _op_name in list_ops():
    globals().setdefault(_op_name, _make_creator(_op_name))
del _op_name


def _scalar_or_broadcast(lhs, rhs, broadcast_op, scalar_op,
                         rscalar_op=None):
    """The reference's Python-level helpers (``maximum`` / ``minimum`` /
    ``pow``): a broadcast op on two symbols, a scalar op on one, a plain
    number on two numbers."""
    if isinstance(lhs, Symbol) and isinstance(rhs, Symbol):
        return _apply_op(broadcast_op, None, [lhs, rhs], {})
    if isinstance(lhs, Symbol):
        return _apply_op(scalar_op, None, [lhs], {'scalar': float(rhs)})
    if isinstance(rhs, Symbol):
        return _apply_op(rscalar_op or scalar_op, None, [rhs],
                         {'scalar': float(lhs)})
    # builtins: the module-level max/min/pow are installed ops
    return {'broadcast_maximum': builtins.max,
            'broadcast_minimum': builtins.min,
            'broadcast_power': builtins.pow}[broadcast_op](lhs, rhs)


def maximum(lhs, rhs):
    """Element-wise broadcasting maximum (reference symbol.py)."""
    return _scalar_or_broadcast(lhs, rhs, 'broadcast_maximum',
                                '_maximum_scalar')


def minimum(lhs, rhs):
    """Element-wise broadcasting minimum (reference symbol.py)."""
    return _scalar_or_broadcast(lhs, rhs, 'broadcast_minimum',
                                '_minimum_scalar')


def pow(base, exp):
    """Element-wise broadcasting power (reference symbol.py)."""
    return _scalar_or_broadcast(base, exp, 'broadcast_power',
                                '_power_scalar', '_rpower_scalar')


def __getattr__(name):
    """Resolve ops registered after import (the fused ops of fuse.py)."""
    try:
        get_op(name)
    except KeyError:
        raise AttributeError('module %r has no attribute %r'
                             % (__name__, name)) from None
    globals()[name] = _make_creator(name)
    return globals()[name]
