"""Executor — evaluation and differentiation of a bound Symbol.

The port of ``mxnet_tpu/executor.py``.  The JAX package traces the graph
once into a jitted XLA program; here the same graph interpreter
(:func:`_build_graph_fn`, ``mxnet_tpu/executor.py:42-103``) runs
eagerly, op by op, on the tensors' device.  The step-compiler pass
pipeline (``fuse.apply_fuse_passes``, ``MXTPU_FUSE``) runs once per
(executor, mode) on the symbol the interpreter walks, as
``Executor._program_symbol`` does there (``:198-212``).

Inference forwards run under ``torch.no_grad()``.  An executor with
:meth:`Executor.enable_capture` (the Predictor's bucket executors) runs
its inference forward through a CUDA graph of its graph function
(``compile_cache.CapturedStep``), recorded at its first forward and
replayed while its argument and aux arrays hold the same tensors; its
``outputs`` are then the graph's, overwritten by the next forward.  A
program with ``Custom`` nodes is cut at them (:class:`SegmentPlan`,
:func:`staged_forward`): a graph per segment, the user's forward run
eagerly between their replays.

A training forward of an executor with gradient buffers runs under
autograd, with each argument whose ``grad_req`` is not ``'null'`` as a
leaf; ``backward`` then differentiates the recorded graph with zero head
gradients — loss layers (``SoftmaxOutput``) inject their own, as in the
reference — and writes the gradients into ``grad_dict`` (``'write'``
replaces, ``'add'`` accumulates).

A monitored executor (:meth:`Executor.set_monitor_callback`, installed
by ``monitor.Monitor``) runs every forward on the ORIGINAL symbol, not
the pass pipeline's program, so taps key on the original node names
(``mxnet_tpu/executor.py:369-401``): each node output whose name matches
the pattern goes to the callback, the aux updates are applied once, and
no autograd graph is left pending.  Its ``backward`` then runs the
training forward again on the fused program, with grad, discarding that
run's aux updates, as the reference's monitored step runs its fused
``fwd_bwd``.

``MXNET_BACKWARD_DO_MIRROR`` (:func:`mirror_wrap`) wraps every
differentiated forward — this executor's, the fused train step's and the
sequence-parallel step's — in non-reentrant
``torch.utils.checkpoint``: activations are recomputed in backward
instead of kept.  The group2ctx path of the JAX executor is not ported.
"""
from __future__ import annotations

import functools
import re
from typing import Dict, Tuple

import numpy as np
import torch

from . import config, instrument
from .base import MXNetError, resolve_dtype
from .context import Context
from .ndarray import NDArray, zeros as nd_zeros
from .symbol import Symbol

__all__ = ['Executor', 'simple_bind']


def _value_of(src, x, entry_vals, arg_values, aux_values):
    if src.is_variable:
        if src.name in arg_values:
            return arg_values[src.name]
        if src.name in aux_values:
            return aux_values[src.name]
        raise MXNetError('unbound variable %s' % src.name)
    return entry_vals[(id(src), x)]


def _run_nodes(nodes, entry_vals, arg_values, aux_values, is_train, dev,
               aux_updates, monitor_re=None, monitored=None):
    """Evaluate the operator nodes ``nodes`` (topological order) into
    ``entry_vals`` ((id(node), output index) -> tensor); variables are
    read from ``arg_values`` / ``aux_values`` by name, and the aux
    updates the nodes make go into ``aux_updates`` by graph name."""
    for node in nodes:
        op = node.opdef()
        ins = [_value_of(n, x, entry_vals, arg_values, aux_values)
               for n, x in node.inputs]
        attrs = node.attrs if ins or dev is None else \
            dict(node.attrs, ctx=dev)
        try:
            outs, aux_upd = op.apply(attrs, ins, is_train, None)
        except RuntimeError as e:
            # a CUDA error under capture (a host sync) names its node;
            # other exceptions pass untouched (the mirror's recompute
            # stops early by raising one through here)
            if dev is not None and dev.type == 'cuda' and \
                    torch.cuda.is_current_stream_capturing():
                raise MXNetError(
                    'node %r (op %s) cannot run inside a CUDA graph '
                    'capture: %s' % (node.name, node.op, e)) from e
            raise
        for j, o in enumerate(outs):
            entry_vals[(id(node), j)] = o
        if monitor_re is not None:
            for j, oname in enumerate(node.output_names()):
                if monitor_re.match(oname):
                    monitored[oname] = outs[j]
        if aux_upd:
            # op-local aux names -> graph variable names
            n_main = len(op.input_names(node.attrs))
            aux_nms = op.aux_names(node.attrs)
            for local_name, val in aux_upd.items():
                var_node = node.inputs[n_main + aux_nms.index(local_name)][0]
                aux_updates[var_node.name] = val


def _device_of(arg_values, aux_values):
    # ops with no input (constants, samplers) are made on the device the
    # graph runs on
    return next((v.device for v in list(arg_values.values())
                 + list(aux_values.values())), None)


def _build_graph_fn(symbol: Symbol, is_train: bool, monitor_re=None):
    """The function ``(arg_values, aux_values) -> (outputs,
    aux_updates)`` over name -> tensor dicts; ``is_train`` is fixed.
    With ``monitor_re`` (a compiled pattern) it returns a third value:
    the node outputs whose names match, by name."""
    nodes = [n for n in symbol.topo_nodes() if not n.is_variable]
    out_entries = symbol._outputs

    def fn(arg_values: Dict[str, torch.Tensor],
           aux_values: Dict[str, torch.Tensor]):
        entry_vals: Dict[Tuple[int, int], torch.Tensor] = {}
        aux_updates: Dict[str, torch.Tensor] = {}
        monitored: Dict[str, torch.Tensor] = {}
        _run_nodes(nodes, entry_vals, arg_values, aux_values, is_train,
                   _device_of(arg_values, aux_values), aux_updates,
                   monitor_re, monitored)
        outputs = [_value_of(n, x, entry_vals, arg_values, aux_values)
                   for n, x in out_entries]
        if monitor_re is not None:
            return outputs, aux_updates, monitored
        return outputs, aux_updates

    return fn


class SegmentPlan(object):
    """A program cut at its ``Custom`` nodes, for a step captured in
    segments (``compile_cache.StagedStep``).

    ``pieces`` alternate ``('seg', nodes)`` and ``('custom', node)``,
    beginning and ending with a segment (either may be empty): segment
    ``i`` holds the operator nodes between two ``Custom`` nodes in
    topological order.  An entry ((id(node), output index)) that one
    piece makes and a later one reads, or that is a program output, is
    an *export* of its piece; a segment reads the entries it does not
    make as its ``inputs``.  The user's code runs between the segments'
    graphs, as ``jax.pure_callback`` runs it in the reference."""

    def __init__(self, symbol):
        self.symbol = symbol
        pieces, cur = [], []
        self._nodes = {id(n): n for n in symbol.topo_nodes()}
        for node in symbol.topo_nodes():
            if node.is_variable:
                continue
            if node.op == 'Custom':
                pieces += [('seg', cur), ('custom', node)]
                cur = []
            else:
                cur.append(node)
        pieces.append(('seg', cur))
        self.pieces = pieces
        piece_of = {}
        for i, (kind, x) in enumerate(pieces):
            for n in (x if kind == 'seg' else [x]):
                piece_of[id(n)] = i
        self.piece_of = piece_of
        self.outputs = list(symbol._outputs)
        self.inputs = [[] for _ in pieces]       # per segment, ordered
        self.variables = [[] for _ in pieces]    # names a segment reads
        self.exports = [[] for _ in pieces]      # ordered keys
        self.consumers = {}                      # key -> [(piece, pos)]
        for i, (kind, x) in enumerate(pieces):
            for n in (x if kind == 'seg' else [x]):
                for pos, (src, j) in enumerate(n.inputs):
                    if src.is_variable:
                        if kind == 'seg' and \
                                src.name not in self.variables[i]:
                            self.variables[i].append(src.name)
                        continue
                    key = (id(src), j)
                    owner = piece_of[id(src)]
                    if owner != i:
                        self._export(owner, key)
                        self.consumers.setdefault(key, []).append(
                            (i, pos if kind == 'custom' else None))
                        if kind == 'seg' and key not in self.inputs[i]:
                            self.inputs[i].append(key)
        for src, j in self.outputs:
            if not src.is_variable:
                self._export(piece_of[id(src)], (id(src), j))

    def _export(self, piece, key):
        if key not in self.exports[piece]:
            self.exports[piece].append(key)

    @property
    def customs(self):
        return [(i, x) for i, (k, x) in enumerate(self.pieces)
                if k == 'custom']

    def nodes(self, i):
        return self.pieces[i][1]

    def node_by_id(self, node_id):
        return self._nodes[node_id]

    def run_segment(self, i, arg_values, aux_values, inputs, is_train):
        """Segment ``i`` on ``inputs`` (key -> tensor): its exports (key ->
        tensor) and its aux updates."""
        entry_vals = dict(inputs)
        aux_updates = {}
        _run_nodes(self.nodes(i), entry_vals, arg_values, aux_values,
                   is_train, _device_of(arg_values, aux_values),
                   aux_updates)
        return {k: entry_vals[k] for k in self.exports[i]}, aux_updates


def staged_forward(plan, args, aux, is_train=False):
    """The stages of a forward through ``plan`` without gradients, over
    the fixed ``args`` / ``aux`` dicts (``args`` may be a function that
    returns the dict, called inside each stage: casts of the fixed
    tensors): a graph per non-empty segment, the user's forward of each
    ``Custom`` node between them (its outputs copied into buffers the
    next segment reads).  The last stage returns the program's
    outputs."""
    from .operator import custom_forward
    state = {}
    get_args = args if callable(args) else (lambda: args)

    def value(src, j):
        if src.is_variable:
            a = get_args()
            return a[src.name] if src.name in a else aux[src.name]
        key = (id(src), j)
        owner = plan.piece_of[id(src)]
        if plan.pieces[owner][0] == 'custom':
            return state['cin', owner][j]
        return state['seg', owner][key]

    def segment(i):
        def run():
            ins = {k: value(plan.node_by_id(k[0]), k[1])
                   for k in plan.inputs[i]}
            with torch.no_grad():
                state['seg', i], _ = plan.run_segment(i, get_args(), aux,
                                                      ins, is_train)
            return []
        return run

    def custom(i):
        node = plan.pieces[i][1]

        def run():
            ins = [value(src, j) for src, j in node.inputs]
            outs, _ = custom_forward(node.attrs, ins, is_train)
            _copy_into(state, ('cin', i), outs)
            return []
        return run

    def outputs():
        return [value(src, j) for src, j in plan.outputs]

    stages = []
    for i, (kind, x) in enumerate(plan.pieces):
        if kind == 'custom':
            stages.append(('host', custom(i)))
        elif x:
            stages.append(('graph', segment(i)))
    if stages[-1][0] == 'graph':
        seg = stages[-1][1]
        stages[-1] = ('graph', lambda: (seg(), outputs())[1])
    else:
        last = stages[-1][1]
        stages[-1] = ('host', lambda: (last(), outputs())[1])
    return stages


def _copy_into(state, slot, tensors):
    """Copy ``tensors`` into the fixed buffers ``state[slot]`` (made, outside
    any graph's pool, at the first call)."""
    bufs = state.get(slot)
    if bufs is None:
        bufs = state[slot] = [torch.empty_like(t) for t in tensors]
    with torch.no_grad():
        for b, t in zip(bufs, tensors):
            b.copy_(t)
    return bufs


def mirror_policy():
    """``MXNET_BACKWARD_MIRROR_POLICY`` when ``MXNET_BACKWARD_DO_MIRROR``
    is on ('dots' or 'nothing'), else None."""
    if not config.get('MXNET_BACKWARD_DO_MIRROR'):
        return None
    name = config.get('MXNET_BACKWARD_MIRROR_POLICY')
    if name not in ('dots', 'nothing'):
        raise MXNetError('MXNET_BACKWARD_MIRROR_POLICY must be '
                         "'dots' or 'nothing', got %r" % name)
    return name


def _saved_under_dots():
    """The aten ops whose outputs 'dots' keeps: the matmuls and the
    convolution (the JAX policy keeps ``dot_general`` and
    ``conv_general_dilated``).  A kernel's ``autograd.Function`` is not
    among them (a ``pallas_call`` is not in the JAX set either): its
    forward runs again in the recompute."""
    aten = torch.ops.aten
    return [aten.mm.default, aten.addmm.default, aten.bmm.default,
            aten.convolution.default]


def _replaying(f, generators):
    """``f`` whose second and later calls (the recompute) draw what its
    first call drew from ``generators``: their states are reset to the
    first call's for the rerun and put back after it."""
    first = []

    def run(*args):
        if not first:
            first.append([(g, g.get_state()) for g in generators])
            return f(*args)
        after = [(g, g.get_state()) for g in generators]
        for g, state in first[0]:
            g.set_state(state)
        try:
            return f(*args)
        finally:
            for g, state in after:
                g.set_state(state)
    return run


def mirror_wrap(f, generators=()):
    """Apply the ``MXNET_BACKWARD_DO_MIRROR`` memory/compute trade to a
    differentiated forward ``f`` (reference mirror pass,
    ``graph_executor.cc:199-216``; ``mxnet_tpu/executor.py:106``): each
    call runs ``f`` under non-reentrant ``torch.utils.checkpoint``, which
    keeps no activation and runs ``f`` again in backward.  Policy
    'nothing' keeps nothing; 'dots' keeps the outputs of the matmuls and
    convolutions (a selective checkpoint) and recomputes the rest.  The
    ops draw from the port's own generators, not torch's global RNG, so
    ``preserve_rng_state`` is off and ``generators`` (those ``f`` draws
    from) are replayed for the recompute.  Returns ``f`` itself when the
    mirror is off."""
    policy = mirror_policy()
    if policy is None:
        return f
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts, noop_context_fn)
    if policy == 'dots':
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _saved_under_dots())
    else:
        context_fn = noop_context_fn

    def wrapped(*args):
        instrument.inc('executor.mirrored_forwards')
        return checkpoint(_replaying(f, generators), *args,
                          use_reentrant=False, preserve_rng_state=False,
                          context_fn=context_fn)
    return wrapped


def _grad_req_map(grad_req, arg_names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    return {n: grad_req.get(n, 'null') for n in arg_names}


class Executor:
    """A bound computation (reference ``python/mxnet/executor.py``)."""

    def __init__(self, symbol: Symbol, ctx, args, args_grad=None,
                 grad_req='write', aux_states=None):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_dict = self._normalize(args, self.arg_names, 'args')
        self.aux_dict = self._normalize(aux_states, self.aux_names,
                                        'aux_states', allow_none=True)
        self.grad_dict = self._normalize(args_grad, self.arg_names,
                                         'args_grad', allow_none=True,
                                         partial_ok=True)
        self.grad_req = _grad_req_map(grad_req, self.arg_names)
        for n in self.arg_names:
            if n not in self.grad_dict:
                self.grad_req[n] = 'null'
        for n, req in self.grad_req.items():
            if req not in ('write', 'add', 'null'):
                raise MXNetError("grad_req of %s must be 'write', 'add' or "
                                 "'null', got %r" % (n, req))
        self._grad_names = [n for n in self.arg_names
                            if self.grad_req[n] != 'null']
        self._fuse_cache: Dict[bool, Symbol] = {}
        self._graph_fns: Dict[bool, object] = {}
        # (graph outputs, autograd leaves) of the last training forward,
        # consumed by backward()
        self._pending = None
        self.outputs = []
        self._capture = False
        self._capture_pool = None
        self._forward_graph = None
        self._monitor_callback = None
        self._monitor_pattern = None
        self._monitored_fns = {}
        self._draws = None          # does the training program sample
        self._recorded = set()      # manifest kinds recorded (inventory)

    @staticmethod
    def _normalize(values, names, what, allow_none=False, partial_ok=False):
        if values is None:
            if allow_none:
                return {}
            raise MXNetError('%s must be provided' % what)
        if isinstance(values, dict):
            out = dict(values)
        else:
            values = list(values)
            if len(values) != len(names) and not partial_ok:
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

    def _graph_fn(self, is_train):
        key = bool(is_train)
        fn = self._graph_fns.get(key)
        if fn is None:
            fn = self._graph_fns[key] = _build_graph_fn(
                self._program_symbol(key), key)
        return fn

    def _run_with_grad(self):
        """A training forward under autograd (and the mirror):
        ``(outputs, aux_updates, leaves)``, the leaves being the
        differentiated arguments."""
        from . import compile_cache, random
        args = {k: v.handle for k, v in self.arg_dict.items()}
        aux = {k: v.handle for k, v in self.aux_dict.items()}
        leaves = {}
        for n in self._grad_names:
            leaves[n] = args[n] = args[n].detach().requires_grad_(True)
        if self._draws is None:
            self._draws = bool(compile_cache.random_nodes(
                self._program_symbol(True)))
        gens = [random.generator(self._ctx.torch_device)] \
            if self._draws else []
        with torch.enable_grad():
            outs, aux_updates = mirror_wrap(self._graph_fn(True),
                                            gens)(args, aux)
        return outs, aux_updates, leaves

    def forward(self, is_train=False, **kwargs):
        """Run the graph; returns (and keeps in ``outputs``) one NDArray
        per output.  Keyword arguments overwrite bound arguments first.
        Training-mode forwards compute batch statistics and write the
        moving-stat updates back to the aux arrays; with gradient
        buffers bound they also record the graph ``backward`` needs."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError('unknown argument %s' % k)
            self.arg_dict[k][:] = v
        self._pending = None
        if self._monitor_callback is not None:
            return self._forward_monitored(is_train)
        self._record(is_train)
        if not is_train and self._capture:
            outs, aux_updates = self._inference_graph().run(), {}
        elif is_train and self._grad_names:
            outs, aux_updates, leaves = self._run_with_grad()
            self._pending = (outs, leaves)
        else:
            args = {k: v.handle for k, v in self.arg_dict.items()}
            aux = {k: v.handle for k, v in self.aux_dict.items()}
            with torch.no_grad():
                outs, aux_updates = self._graph_fn(is_train)(args, aux)
        for name, val in aux_updates.items():
            self.aux_dict[name]._set_data(val)
        self.outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        instrument.inc('executor.forwards')
        return self.outputs

    def _record(self, is_train):
        """File the program this forward runs in the warmup manifest, once
        per kind, as the reference's traces do: ``'fwd_bwd'`` for a
        forward with gradients, else ``'forward'`` with ``is_train`` (an
        inventory: nothing replays them)."""
        from . import compile_cache
        grad = bool(is_train and self._grad_names)
        kind = 'fwd_bwd' if grad else ('forward', bool(is_train))
        if kind in self._recorded:
            return
        self._recorded.add(kind)
        if compile_cache.ensure_persistent_cache() is None:
            return
        entry = {'kind': 'fwd_bwd' if grad else 'forward',
                 'fp': compile_cache.fingerprint(
                     self._program_symbol(is_train))}
        if not grad:
            entry['meta'] = {'is_train': bool(is_train)}
        compile_cache.record_entry(entry)

    def set_monitor_callback(self, callback, pattern=None):
        """Tap every forward: ``callback(name, NDArray)`` for each node
        output whose name matches ``pattern`` (a compiled regex; every
        output without one), as ``mxnet_tpu/executor.py:755`` does."""
        self._monitor_callback = callback
        self._monitor_pattern = pattern

    def _forward_monitored(self, is_train):
        """A forward of the ORIGINAL symbol with its matching node outputs
        handed to the monitor callback; no autograd graph is left pending
        (``backward`` runs the fused program's training forward again)."""
        pattern = self._monitor_pattern or re.compile('.*')
        key = (bool(is_train), pattern.pattern)
        fn = self._monitored_fns.get(key)
        if fn is None:
            fn = self._monitored_fns[key] = _build_graph_fn(
                self._symbol, is_train, monitor_re=pattern)
        args = {k: v.handle for k, v in self.arg_dict.items()}
        aux = {k: v.handle for k, v in self.aux_dict.items()}
        with torch.no_grad():
            outs, aux_updates, monitored = fn(args, aux)
        for name, val in aux_updates.items():
            self.aux_dict[name]._set_data(val)
        self.outputs = [NDArray(o, self._ctx) for o in outs]
        instrument.inc('executor.forwards')
        for name, val in monitored.items():
            self._monitor_callback(name, NDArray(val, self._ctx))
        return self.outputs

    def debug_str(self):
        """The bound symbol's node list (``mxnet_tpu/executor.py:804``)."""
        return self._symbol.debug_str()

    def enable_capture(self, pool=None):
        """Run inference forwards through a CUDA graph (on the card, by
        ``compile_cache.capture_skip_reason``'s rule); graphs of executors
        given one ``pool`` share its memory."""
        self._capture = True
        self._capture_pool = pool

    def _inference_graph(self):
        """The captured inference forward over the current argument and
        aux tensors (a new one when any of them was rebound)."""
        from . import compile_cache
        args = {k: v.handle for k, v in self.arg_dict.items()}
        aux = {k: v.handle for k, v in self.aux_dict.items()}
        tensors = compile_cache.step_tensors(args, aux)
        cap = self._forward_graph
        if cap is None or not cap.holds(tensors):
            program = self._program_symbol(False)
            device = self._ctx.torch_device
            skip = compile_cache.capture_skip_reason(device, program,
                                                     is_train=False)
            if compile_cache.custom_nodes(program):
                cap = compile_cache.StagedStep(
                    'forward', staged_forward(SegmentPlan(program), args,
                                              aux),
                    device, tensors, pool=self._capture_pool, skip=skip)
            else:
                fn = self._graph_fn(False)

                def body():
                    with torch.no_grad():
                        return fn(args, aux)[0]
                cap = compile_cache.CapturedStep(
                    'forward', body, device, tensors,
                    pool=self._capture_pool, skip=skip)
            self._forward_graph = cap
        return cap

    def backward(self, out_grads=None):
        """Compute gradients into ``grad_dict``.

        Unsupplied head gradients are zero — loss layers inject their own
        gradient, matching the reference where ``SoftmaxOutput``'s
        backward ignores the head gradient.  Differentiates the graph of
        the last ``forward(is_train=True)``; without one pending (a
        second backward) the training forward is run again, its aux
        updates discarded."""
        if not self._grad_names:
            return
        heads, leaves = self._backward_heads(out_grads)
        if heads:
            torch.autograd.backward([o for o, _ in heads],
                                    [g for _, g in heads])
        self._store_grads(leaves)

    def _pend(self):
        """Make sure a training forward's graph is pending (running the
        forward again, its aux updates discarded, when none is)."""
        if self._pending is None:
            outs, _, leaves = self._run_with_grad()
            self._pending = (outs, leaves)

    def _backward_heads(self, out_grads):
        """Take the pending graph: ``(heads, leaves)``, the heads being
        the (output, head gradient) pairs to differentiate."""
        if not self.outputs:
            raise MXNetError('call forward(is_train=True) before backward()')
        self._pend()
        outs, leaves = self._pending
        self._pending = None
        if out_grads is None:
            cots = [torch.zeros_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            if isinstance(out_grads, dict):
                out_grads = [out_grads[n] for n in self.output_names]
            cots = [(g.handle if isinstance(g, NDArray)
                     else torch.as_tensor(g)).to(o.device, o.dtype)
                    for g, o in zip(out_grads, outs)]
        return [(o, g) for o, g in zip(outs, cots) if o.requires_grad], \
            leaves

    def _store_grads(self, leaves):
        """Write the leaves' gradients into ``grad_dict``."""
        for name in self._grad_names:
            g = leaves[name].grad
            if g is None:       # no path from this argument to an output
                g = torch.zeros_like(leaves[name])
            dst = self.grad_dict[name]
            if self.grad_req[name] == 'add':
                dst._set_data(dst.handle + g)
            else:
                dst._set_data(g)

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self.aux_names]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values INTO the bound arrays' tensors
        (``mxnet_tpu/executor.py:763``): a captured step or forward holds
        their addresses, so they are written, never rebound."""
        for table, params, what in ((self.arg_dict, arg_params,
                                     'arguments'),
                                    (self.aux_dict, aux_params or {},
                                     'auxiliary states')):
            for name, array in params.items():
                if name in table:
                    src = array.handle if isinstance(array, NDArray) \
                        else torch.as_tensor(np.asarray(array))
                    dst = table[name].handle
                    if tuple(src.shape) != tuple(dst.shape):
                        raise MXNetError('copy_params_from: %s has shape %s, '
                                         'bound %s' % (name, tuple(src.shape),
                                                       tuple(dst.shape)))
                    with torch.no_grad():
                        dst.copy_(src)
                elif not allow_extra_params:
                    raise ValueError('Find name "%s" that is not in the %s'
                                     % (name, what))

    def forward_backward(self, out_grads=None, **kwargs):
        """``forward(is_train=True)`` then ``backward``; returns the
        outputs."""
        self.forward(is_train=True, **kwargs)
        self.backward(out_grads)
        return self.outputs

    def reshape(self, **kwargs):
        """A new Executor bound at new argument shapes: arrays whose
        shape is unchanged (the parameters and their gradients) are
        shared, the rest are fresh zeros."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError('Insufficient argument shapes provided.')
        return self.rebind(arg_shapes, aux_shapes)

    def rebind(self, arg_shapes, aux_shapes):
        """:meth:`reshape` at already inferred shapes (in ``arg_names``
        and ``aux_names`` order)."""
        new_args, new_grads, new_aux = {}, {}, {}
        for name, shape in zip(self.arg_names, arg_shapes):
            old = self.arg_dict[name]
            same = shape == old.shape
            new_args[name] = old if same else \
                nd_zeros(shape, self._ctx, dtype=old.dtype)
            if name in self.grad_dict:
                new_grads[name] = self.grad_dict[name] if same else \
                    nd_zeros(shape, self._ctx, dtype=old.dtype)
        for name, shape in zip(self.aux_names, aux_shapes):
            old = self.aux_dict[name]
            new_aux[name] = old if shape == old.shape else \
                nd_zeros(shape, self._ctx, dtype=old.dtype)
        return Executor(self._symbol, self._ctx, new_args,
                        new_grads or None, self.grad_req, new_aux)


def simple_bind(symbol: Symbol, ctx, grad_req='write', type_dict=None,
                **kwargs):
    """Allocate argument, gradient and aux arrays from the shapes
    inferred from ``kwargs`` and bind (``mxnet_tpu/executor.py:808``;
    reference ``symbol.py:788``)."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
    if arg_shapes is None:
        raise MXNetError('cannot infer shapes from %s' % kwargs)
    type_dict = type_dict or {}
    ctx = ctx if isinstance(ctx, Context) else Context(ctx)
    arg_names = symbol.list_arguments()
    req = _grad_req_map(grad_req, arg_names)
    args = {n: nd_zeros(s, ctx, dtype=resolve_dtype(type_dict.get(n)))
            for n, s in zip(arg_names, arg_shapes)}
    grads = {n: nd_zeros(s, ctx, dtype=resolve_dtype(type_dict.get(n)))
             for n, s in zip(arg_names, arg_shapes)
             if req.get(n, 'null') != 'null'}
    aux = {n: nd_zeros(s, ctx)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return Executor(symbol, ctx, args, grads or None, req, aux)
