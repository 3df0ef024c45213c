"""The fused training step — forward, backward and the optimizer update
of every parameter as one call.

The port of ``mxnet_tpu/parallel/train_step.py`` (``make_fit_step
:47-256``, ``make_sgd_momentum :34``, ``make_train_step :270-292``,
``make_eval_step :295-316``).  The JAX package traces the step
into ONE jitted XLA program with donated buffers.  Here the step body
runs the pass pipeline's graph (``MXTPU_FUSE``) under autograd with zero
head gradients (``SoftmaxOutput`` injects the loss gradient), writes the
aux updates back, and applies the functional optimizer to the f32 master
weights and the optimizer state IN PLACE — the counterpart of the JAX
step's buffer donation.  Because the body reads and writes only fixed
buffers (batch, lr tensor, parameters, aux, optimizer state, metric
accumulators), it is what a ``torch.cuda.CUDAGraph`` records:
:meth:`FitStep.capture` wraps it in a ``compile_cache.CapturedStep``
that replays it on the card (one graph per batch signature), the
counterpart of the JAX package's compiled program.  On the CPU, and
under ``NaiveEngine``, the same body runs eagerly.

Under ``MXNET_BACKWARD_DO_MIRROR`` the forward (the casts and the graph)
runs inside ``executor.mirror_wrap``: its activations are recomputed in
backward, the BN aux updates still taken once from the first run.

Under ``compute_dtype`` (bf16 mixed precision) the parameters and the
batch entries named in ``data_names`` are cast for the forward and
backward; labels, master weights and optimizer state stay f32, and the
gradients reach the f32 masters through the cast.  A batch entry the
graph reads only as an index (:func:`index_inputs`: token ids into an
``Embedding``) is never cast: bf16 holds integers exactly only up to 256
(the JAX package casts them, a recorded reference fault).

With ``health_action`` (``MXTPU_HEALTH_SENTINELS``) the body also runs
the health probe of ``mxnet_tpu/parallel/train_step.py:151-175``
(``health.py``): ``ok`` (every element of the raw outputs and the
gradients finite, before any masking), the global gradient norm in f32
and the update-to-weight ratio, folded in place into the health state
buffers.  Under ``'skip_update'`` a non-finite step is undone on the
device: the parameters, optimizer state, aux and the metric's
accumulators are copied (one flat copy per dtype) before aux is written,
and after the update every one of them is replaced by
``torch.where(ok, new, old)`` — a select, never a product with a mask (a
NaN times zero is NaN) — so a skipped step leaves them bit for bit as
they were; the metric's host instance count is held back by the step's
count on the device (``EvalMetric._hold_back``).  No host read, no
branch: a captured step does all of it in its graph.

A graph with ``Custom`` nodes is captured in segments
(:meth:`FitStep.stages`, ``compile_cache.StagedStep``): a forward graph
per segment, the user's forward and backward run eagerly between the
replays, each segment's backward a graph of its own, the update and the
metric in the last one.  Under ``MXNET_BACKWARD_DO_MIRROR`` such a step
stays one eager piece (the mirror recomputes across the user's code).

With ``shardings`` (a ``parallel.mesh.FitShardings``: ``Module.fit(
mesh=, partition=)``) over a mesh of more than one rank, the same body
runs in every rank's process on its rows of the batch: BatchNorm
normalises the global batch (``mesh.DpBatchStats`` under
``ops.nn.shared_batch_stats``, the sums all-reduced over dp inside
autograd), and the update is ``zero.ZeroUpdate``'s (the gradients
reduce-scattered over dp, this rank's part of every parameter updated
against its part of the optimizer state, the parts all-gathered over dp,
then the tp shards over tp).  Such a step stays eager, by the caller's
rule (its collectives are not captured, as ``make_sp_train_step``'s are
not); the mirror is refused over more than one dp rank (its recompute
would run the collectives again inside the backward).  Under
``skip_update`` the ranks agree on ``ok`` (one all-reduce), so a skipped
step is skipped everywhere; the probe's gradient norm is each rank's
local, pre-reduction gradient's.  A one-rank mesh (``'1x1'``) is the
unmeshed step, captured as it is.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from .. import health as _health
from .. import random
from ..compile_cache import custom_nodes, random_nodes, step_tensors
from ..executor import (SegmentPlan, _build_graph_fn, _copy_into,
                        mirror_policy, mirror_wrap, staged_forward)
from ..symbol import Symbol

__all__ = ['make_fit_step', 'make_train_step', 'make_eval_step',
           'make_sgd_momentum', 'sgd_momentum_init', 'index_inputs']

# the inputs each op reads as an index, by position
_INDEX_POSITIONS = {'Embedding': (0,), 'take': (1,), 'one_hot': (0,),
                    'pick': (1,), 'batch_take': (1,)}


def index_inputs(symbol):
    """The variables ``symbol`` reads only as an index (the ``data`` of
    ``Embedding``, the index input of ``take``, ``one_hot``, ``pick`` and
    ``batch_take``): casting them to a low precision would change which
    rows are read."""
    from ..ops.registry import get_op
    index, other = set(), set()
    for node in symbol.topo_nodes():
        if node.is_variable:
            continue
        positions = _INDEX_POSITIONS.get(get_op(node.op).name, ())
        for i, (src, _) in enumerate(node.inputs):
            if src.is_variable:
                (index if i in positions else other).add(src.name)
    return index - other


def sgd_momentum_init(params):
    return {k: torch.zeros_like(v) for k, v in params.items()}


def make_sgd_momentum(lr=0.05, momentum=0.9, wd=1e-4, rescale_grad=1.0):
    """Functional SGD + momentum (optimizer_op-inl.h semantics), in place:
    ``update(params, grads, state)``."""
    def update(params, grads, state):
        with torch.no_grad():
            for k, w in params.items():
                g = grads[k].to(w.dtype) * rescale_grad + wd * w
                state[k].mul_(momentum).sub_(lr * g)
                w.add_(state[k])
    return update


def graph_kernels(program):
    """The kernel libraries (``ops/_kernels.KERNELS`` names) a fused
    graph launches on the card."""
    from ..fuse import _tup_or
    names = set()
    for n in program.topo_nodes():
        if n.op == 'FlashAttention':
            names.add('flash_attention')
        elif n.op == '_fused_epilogue' and n.attrs.get('lower_kernel') and \
                n.attrs.get('base_op') == 'FullyConnected':
            names.add('fused_dot_epilogue')
        elif n.op == '_bn_relu':
            names.add('fused_bn_relu')
        elif n.op == '_bn_relu_conv':
            names.add('fused_scale_bias_conv3x3'
                      if _tup_or(n.attrs.get('kernel'), (1, 1)) == (3, 3)
                      else 'fused_scale_bias_dot')
    return sorted(names)


class FitStep(object):
    """The fused step :func:`make_fit_step` builds.  Calling it runs one
    step eagerly; :meth:`body` is the same step without the metric's
    host count, the part a CUDA graph records; :meth:`capture` wraps the
    body over fixed buffers in a ``compile_cache.CapturedStep``."""

    def __init__(self, symbol, functional_opt, data_names, compute_dtype,
                 metric, metric_label, health_action=None, shardings=None):
        from ..fuse import apply_fuse_passes
        self.program = apply_fuse_passes(symbol, True)
        self._graph_fn = _build_graph_fn(self.program, True)
        indices = index_inputs(symbol)
        self._data_names = tuple(n for n in data_names if n not in indices)
        self._opt = functional_opt
        self._dtype = compute_dtype
        self.metric = metric
        self.metric_label = metric_label
        self.metric_count = None    # instances the metric counts per step
        self.kernels = graph_kernels(self.program)
        self._draws = bool(random_nodes(self.program))
        self.health_action = health_action
        self.plan = SegmentPlan(self.program) \
            if custom_nodes(self.program) else None
        # a mesh of more than one rank: the ZeRO update, and BatchNorm
        # over the global batch
        self.zero = self.mesh_plan = None
        if shardings is not None and shardings.plan.multi_rank:
            from .zero import ZeroUpdate
            self.mesh_plan = shardings.plan
            self.zero = self._opt = ZeroUpdate(functional_opt,
                                               shardings.plan,
                                               shardings.params)

    def init_state(self, params):
        """The optimizer state of ``params`` (name -> tensor) this step
        updates: the functional optimizer's, or over a mesh of more than
        one rank this rank's ZeRO part of it."""
        if self.zero is not None:
            return self.zero.init(params)
        return self._opt.init(params)

    def _cast(self, v):
        return v.to(self._dtype) if self._dtype is not None and \
            v.is_floating_point() else v

    def body(self, params, frozen, aux, opt_state, batch, lr_t,
             health_state=None):
        """Forward, backward, every update, the metric's device fold and,
        with a ``health_action``, the health probe folded into
        ``health_state``; returns the outputs."""
        cast = self._cast
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}

        def forward(leaves):
            merged = {k: cast(v) for k, v in frozen.items()}
            merged.update({k: cast(v) for k, v in leaves.items()})
            merged.update({k: (cast(v) if k in self._data_names else v)
                           for k, v in batch.items()})
            return self._graph_fn(merged, aux)

        gens = [random.generator(next(iter(batch.values())).device)] \
            if self._draws else []
        with torch.enable_grad(), (
                self.mesh_plan.global_batch() if self.mesh_plan is not None
                else contextlib.nullcontext()):
            outs, aux_upd = mirror_wrap(forward, gens)(leaves)
            heads = [o for o in outs if o.requires_grad]
            if heads:
                torch.autograd.backward(
                    heads, [torch.zeros_like(o) for o in heads])
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in leaves.items()}
        outs = [o.detach() for o in outs]
        return self._finish(params, aux, opt_state, batch, lr_t,
                            health_state, outs, grads, aux_upd)

    def _finish(self, params, aux, opt_state, batch, lr_t, health_state,
                outs, grads, aux_upd):
        """What follows the backward: the probe, the aux writes, every
        update and the metric's fold; returns ``outs``."""
        probe = None
        if self.health_action is not None:
            probe = self._probe_before(params, aux, opt_state, outs, grads,
                                       batch)
        with torch.no_grad():
            for k, v in aux_upd.items():
                aux[k].copy_(v)
        self._opt.update(params, grads, opt_state, lr_t)
        if self.metric is not None:
            self.metric_count = self.metric._fold_device(
                batch[self.metric_label], outs[0])
        if probe is not None:
            self._probe_after(probe, params, health_state)
        return outs

    def _probe_before(self, params, aux, opt_state, outs, grads, batch):
        """The probe's half before any state is written: ``ok`` over the
        raw outputs and gradients, the gradient norm, and flat copies of
        what the step may have to restore (everything under
        'skip_update', else the parameters for the update ratio)."""
        with torch.no_grad():
            ok = _health.all_finite_tree((outs, grads))
            if self.zero is not None:
                # one verdict for every rank: a step is skipped everywhere
                from . import collectives
                ok = collectives.psum(torch.logical_not(ok).float()) == 0
            gnorm = _health.l2_norm_tree(grads)
            kept = list(params.values())
            if self.health_action == 'skip_update':
                kept += step_tensors(opt_state, aux)
                if self.metric is not None:
                    device = next(iter(batch.values())).device
                    kept += self.metric._accumulators(device)
            return ok, gnorm, _FlatCopy(kept)

    def _probe_after(self, probe, params, health_state):
        ok, gnorm, saved = probe
        with torch.no_grad():
            old = saved.views()[:len(params)]
            ratio = _health.update_ratio(old, list(params.values()))
            if self.health_action == 'skip_update':
                saved.restore_unless(ok)
                if self.metric is not None:
                    self.metric._hold_back(torch.logical_not(ok),
                                           self.metric_count)
            _health.fold_state(health_state, ok, gnorm, ratio)

    def __call__(self, params, frozen, aux, opt_state, batch, lr_t,
                 health_state=None):
        outs = self.body(params, frozen, aux, opt_state, batch, lr_t,
                         health_state)
        if self.metric is not None:
            self.metric._fold_count(self.metric_count)
        return outs

    def capture(self, params, frozen, aux, opt_state, batch, lr_t,
                pool=None, copy_outputs=False, name='fit_step',
                health_state=None):
        """A ``CapturedStep`` of :meth:`body` over these buffers (name ->
        tensor dicts; ``lr_t`` a 0-dim tensor the caller fills before
        each step; ``health_state`` the health buffers with a
        ``health_action``).  It records its graph on its first ``run()``,
        after that real step, and stays eager where
        ``compile_cache.capture_skip_reason`` says so.  The caller adds
        the metric's host count (:attr:`metric_count`) per step."""
        from .. import compile_cache
        device = next(iter(batch.values())).device
        if self.metric is not None:
            self.metric._accumulators(device)
            if self.health_action == 'skip_update':
                self.metric._held(device)
        skip = compile_cache.capture_skip_reason(device, self.program)
        if skip is None and self.zero is not None:
            skip = 'collectives'
            compile_cache.note_skip(name, skip)
        gens = [random.generator(device)] if skip is None and \
            compile_cache.random_nodes(self.program) else []
        bindings = compile_cache.step_tensors(params, frozen, aux, batch,
                                              opt_state, lr_t, health_state)
        if self.staged and mirror_policy() is None and self.zero is None:
            return compile_cache.StagedStep(
                name, self.stages(params, frozen, aux, opt_state, batch,
                                  lr_t, health_state),
                device, bindings, pool=pool, copy_outputs=copy_outputs,
                skip=skip, generators=gens)
        return compile_cache.CapturedStep(
            name, lambda: self.body(params, frozen, aux, opt_state, batch,
                                    lr_t, health_state),
            device, bindings, pool=pool, copy_outputs=copy_outputs,
            skip=skip, generators=gens)

    @property
    def staged(self):
        """Whether the step is captured in segments (its graph has
        ``Custom`` nodes)."""
        return self.plan is not None

    def stages(self, params, frozen, aux, opt_state, batch, lr_t,
               health_state=None):
        """:meth:`body` cut at the ``Custom`` nodes, as the stages of a
        ``compile_cache.StagedStep``: for each segment a forward graph
        (its autograd graph kept for the backward), the user's forward of
        each ``Custom`` node between them, then, in reverse, each
        segment's backward graph (``torch.autograd.grad`` over the
        segment alone) with the user's backward between them, and after
        the last backward what :meth:`_finish` does.  Adjacent graphs are
        merged into one.  Run eagerly, stage by stage, it is the same
        step as :meth:`body`.

        Every value that crosses a cut lives in a fixed buffer: a
        segment's exports and gradients in the graphs' pool (held by
        ``st`` until the next replay writes them again), a ``Custom``
        node's outputs and its input gradients in buffers made at the
        first run, outside the pool, into which the user's results are
        copied.  A gradient that reaches an entry from several consumers
        is summed, later consumers first."""
        from ..operator import custom_backward, custom_forward
        plan = self.plan
        pieces = plan.pieces
        cast = self._cast
        st = {}

        def var(name, leaves):
            if name in leaves:
                return cast(leaves[name])
            if name in params:
                return cast(params[name])
            if name in frozen:
                return cast(frozen[name])
            if name in batch:
                v = batch[name]
                return cast(v) if name in self._data_names else v
            return aux[name]

        def value(src, j):
            """The forward value of an entry (detached) or variable."""
            if src.is_variable:
                return var(src.name, {})
            owner = plan.piece_of[id(src)]
            if pieces[owner][0] == 'custom':
                return st['cin', owner][j]
            return st['f', owner][2][(id(src), j)].detach()

        def is_output(key):
            return any((id(s), j) == key for s, j in plan.outputs)

        def cotangent(owner, key, like):
            """The gradient reaching entry ``key`` of piece ``owner``:
            the zero head gradient when it is an output, and what each
            later consumer gave back."""
            parts = [torch.zeros_like(like)] if is_output(key) else []
            for piece, pos in sorted(plan.consumers.get(key, ()),
                                     reverse=True):
                if pieces[piece][0] == 'custom':
                    g = st.get(('cot', piece))
                    g = g[pos] if g is not None else None
                else:
                    g = st['g', piece][1].get(key)
                if g is not None:
                    parts.append(g)
            if not parts:
                return torch.zeros_like(like)
            total = parts[0]
            for g in parts[1:]:
                total = total + g
            return total

        def forward(i):
            names = plan.variables[i]

            def run():
                with torch.enable_grad():
                    leaves = {k: params[k].detach().requires_grad_(True)
                              for k in names if k in params}
                    ins = {}
                    for key in plan.inputs[i]:
                        t = value(plan.node_by_id(key[0]), key[1])
                        ins[key] = t.detach().requires_grad_(
                            t.is_floating_point())
                    args = {k: var(k, leaves) for k in names
                            if k not in aux}
                    exports, aux_upd = plan.run_segment(i, args, aux, ins,
                                                        True)
                st['f', i] = (leaves, ins, exports)
                st.setdefault('aux', {}).update(aux_upd)
                return []
            return run

        def backward(i):
            def run():
                leaves, ins, exports = st['f', i]
                heads, cots = [], []
                for key, t in exports.items():
                    if t.requires_grad:
                        heads.append(t)
                        cots.append(cotangent(i, key, t))
                wrt = list(leaves.values()) + \
                    [t for t in ins.values() if t.requires_grad]
                grads = [None] * len(wrt)
                if heads and wrt:
                    grads = torch.autograd.grad(heads, wrt, cots,
                                                allow_unused=True)
                n = len(leaves)
                st['g', i] = (dict(zip(leaves, grads[:n])),
                              dict(zip([k for k, t in ins.items()
                                        if t.requires_grad], grads[n:])))
                return []
            return run

        def custom_fwd(i):
            node = pieces[i][1]

            def run():
                ins = [value(src, j) for src, j in node.inputs]
                outs, state = custom_forward(node.attrs, ins, True)
                _copy_into(st, ('cin', i), outs)
                st['c', i] = state
            return run

        def custom_bwd(i):
            node = pieces[i][1]

            def run():
                outs = st['cin', i]
                grads = [cotangent(i, (id(node), j), o)
                         for j, o in enumerate(outs)]
                in_grads = custom_backward(st['c', i], grads)
                _copy_into(st, ('cot', i), in_grads)
            return run

        def finish():
            grads = {}
            for k, p in params.items():
                parts = [st['g', i][0][k] for i in range(len(pieces) - 1,
                                                         -1, -1)
                         if ('g', i) in st and st['g', i][0].get(k)
                         is not None]
                for i, node in reversed(plan.customs):
                    for pos, (src, _) in enumerate(node.inputs):
                        if src.is_variable and src.name == k and \
                                ('cot', i) in st:
                            parts.append(st['cot', i][pos])
                if not parts:
                    grads[k] = torch.zeros_like(p)
                    continue
                g = parts[0]
                for x in parts[1:]:
                    g = g + x
                grads[k] = g.to(p.dtype) if g.dtype != p.dtype else g
            outs = [value(src, j) for src, j in plan.outputs]
            return self._finish(params, aux, opt_state, batch, lr_t,
                                health_state, outs, grads,
                                st.get('aux', {}))

        stages = []
        for i, (kind, x) in enumerate(pieces):
            if kind == 'custom':
                stages.append(('host', custom_fwd(i)))
            elif x:
                stages.append(('graph', forward(i)))
        for i in range(len(pieces) - 1, -1, -1):
            kind, x = pieces[i]
            if kind == 'custom':
                stages.append(('host', custom_bwd(i)))
            elif x:
                stages.append(('graph', backward(i)))
        stages.append(('graph', finish))
        merged = []
        for kind, fn in stages:
            if merged and kind == 'graph' and merged[-1][0] == 'graph':
                merged[-1] = ('graph', _chain(merged[-1][1], fn))
            else:
                merged.append((kind, fn))
        return merged


def _chain(a, b):
    def run():
        a()
        return b()
    return run


class _FlatCopy(object):
    """Copies of ``tensors``, one flat tensor per dtype (one copy kernel
    each, not one per tensor), and the select that puts them back."""

    def __init__(self, tensors):
        self.tensors = list(tensors)
        groups = {}
        for i, t in enumerate(self.tensors):
            groups.setdefault(t.dtype, []).append(i)
        self.groups = [(idx, torch.cat([self.tensors[i].reshape(-1)
                                        for i in idx]))
                       for idx in groups.values()]

    def _split(self, idx, flat):
        parts = flat.split([self.tensors[i].numel() for i in idx])
        return [p.view(self.tensors[i].shape) for i, p in zip(idx, parts)]

    def views(self):
        """The copies, shaped as the tensors, in their order."""
        out = [None] * len(self.tensors)
        for idx, flat in self.groups:
            for i, v in zip(idx, self._split(idx, flat)):
                out[i] = v
        return out

    def restore_unless(self, ok):
        """Every tensor becomes ``torch.where(ok, now, copy)``."""
        for idx, flat in self.groups:
            now = torch.cat([self.tensors[i].reshape(-1) for i in idx])
            torch._foreach_copy_([self.tensors[i] for i in idx],
                                 self._split(idx, torch.where(ok, now,
                                                              flat)))


def make_fit_step(symbol: Symbol, functional_opt, data_names=(),
                  compute_dtype=None, metric=None, metric_label=None,
                  shardings=None, health_action=None):
    """Build the step ``step(params, frozen, aux, opt_state, batch, lr_t)
    -> outputs`` (a :class:`FitStep`): forward, backward and every
    parameter update.  ``params``, ``aux`` and ``opt_state`` are name ->
    tensor dicts updated in place; ``functional_opt`` is an
    ``optimizer.FunctionalOptimizer`` (or any object with
    ``update(params, grads, states, lr_t)``); ``lr_t`` a float or a 0-dim
    tensor.

    With ``metric`` (an ``EvalMetric`` with a device form) the step folds
    ``metric.device_fold(batch[metric_label], outputs[0])`` — deltas from
    the UNCAST label — so the fit loop never syncs on the metric.

    With ``health_action`` ('warn', 'skip_update' or 'abort') the step
    takes a ``health_state`` argument after ``lr_t`` (``health.
    HealthMonitor.device_state``) and folds the health probe into it;
    under 'skip_update' a non-finite step leaves every state it would
    write as it was (the module docstring).

    With ``shardings`` (a ``parallel.mesh.FitShardings``) over a mesh of
    more than one rank, each rank calls the step with its rows of the
    batch and the full parameters; the optimizer state is
    :meth:`FitStep.init_state`'s (this rank's ZeRO part), the update
    ``zero.ZeroUpdate``'s and BatchNorm the global batch's (the module
    docstring).  Over a one-rank mesh it is the unmeshed step."""
    if health_action is not None and \
            health_action not in _health._ACTIONS:
        raise ValueError('make_fit_step: health_action must be one of %s, '
                         'got %r' % (_health._ACTIONS, health_action))
    return FitStep(symbol, functional_opt, data_names, compute_dtype,
                   metric, metric_label, health_action, shardings)


class _PlainUpdate(object):
    """Adapter presenting a bare ``update(params, grads, state)`` callable
    as a functional optimizer (the lr is baked into the callable)."""

    def __init__(self, fn):
        self._fn = fn

    def update(self, params, grads, state, lr_t):
        return self._fn(params, grads, state)


class _StepTable(object):
    """The captured steps of one raw-API step function, keyed on the
    batch signature and the ``data_ptr`` of every parameter, aux and
    state tensor: a graph holds those addresses.  Each entry owns fixed
    batch buffers (copies of the first batch), which each later call
    refreshes in place.  Where ``compile_cache.capture_skip_reason``
    says the step stays eager, it runs on the caller's own tensors."""

    def __init__(self, name, program, is_train, make):
        self.name = name
        self.program = program
        self.is_train = is_train
        self.make = make            # make(static_batch) -> CapturedStep
        self.graphs = {}
        self._skips = {}

    def skip(self, device):
        from .. import compile_cache, engine
        key = (device, engine.get_engine_type())
        if key not in self._skips:
            reason = self._skips[key] = compile_cache.capture_skip_reason(
                device, self.program, self.is_train)
            if reason is not None:
                compile_cache.note_skip(self.name, reason)
        return self._skips[key]

    def step(self, batch, *trees):
        from .. import compile_cache
        key = (compile_cache.batch_sig(batch),
               tuple(t.data_ptr()
                     for t in compile_cache.step_tensors(*trees)))
        entry = self.graphs.get(key)
        if entry is None:
            static = {k: v.clone() for k, v in batch.items()}
            entry = self.graphs[key] = (self.make(static), static)
        else:
            with torch.no_grad():
                for k, v in batch.items():
                    entry[1][k].copy_(v, non_blocking=True)
        return entry[0]


def make_train_step(symbol: Symbol, optimizer_update, batch_names,
                    donate=True, compute_dtype=None):
    """Build ``step(params, aux, opt_state, batch, rng=None) -> (outputs,
    params, aux, opt_state)`` — the bench/raw-API entry
    (``mxnet_tpu/parallel/train_step.py:270-292``), a thin wrapper over
    :func:`make_fit_step` with no frozen params and the lr baked into
    ``optimizer_update`` (e.g. :func:`make_sgd_momentum`).

    ``batch_names`` is accepted for API stability; the batch is never
    cast (``data_names=()``), so token ids stay exact under a bf16
    ``compute_dtype``.  With ``donate`` (the default) ``params``, ``aux``
    and ``opt_state`` are updated in place and returned — the
    counterpart of the JAX step's donated buffers — and on the card the
    step is captured once per batch signature and set of parameter
    tensors (their ``data_ptr``s) and replayed while the caller passes
    the same tensors; the batch is copied into the graph's own batch
    buffers, and the outputs returned are the graph's, overwritten by
    the next call.  ``donate=False`` works on fresh copies each call, so
    it stays eager.  ``rng`` is accepted for the JAX signature; the
    ported ops draw from the device generator (``random.generator``)."""
    from .. import compile_cache
    raw = make_fit_step(symbol, _PlainUpdate(optimizer_update),
                        data_names=(), compute_dtype=compute_dtype)
    if not donate:
        compile_cache.note_skip('train_step', 'donate=False')
    table = _StepTable('train_step', raw.program, True,
                       lambda static: raw.capture(
                           state['params'], {}, state['aux'],
                           state['opt'], static, 0.0, name='train_step'))
    state = {}

    def step(params, aux, opt_state, batch, rng=None):
        if not donate:
            params, aux, opt_state = ({k: v.clone() for k, v in d.items()}
                                      for d in (params, aux, opt_state))
        if not donate or table.skip(next(iter(batch.values())).device):
            outs = raw(params, {}, aux, opt_state, batch, 0.0)
        else:
            state.update(params=params, aux=aux, opt=opt_state)
            outs = table.step(batch, params, aux, opt_state).run()
        return outs, params, aux, opt_state

    step.graphs = table.graphs
    return step


def make_eval_step(symbol: Symbol, compute_dtype=None):
    """Inference: ``step(params, aux, batch, rng=None) -> outputs``
    (``mxnet_tpu/parallel/train_step.py:295-316``), through the pass
    pipeline with ``is_train=False``; under ``compute_dtype`` the params
    and the floating batch entries are cast.  On the card it is captured
    and replayed as :func:`make_train_step`'s step is (its outputs are
    the graph's, overwritten by the next call)."""
    from .. import compile_cache
    from ..fuse import apply_fuse_passes
    program = apply_fuse_passes(symbol, False)
    graph_fn = _build_graph_fn(program, False)

    def cast(v):
        return v.to(compute_dtype) if compute_dtype is not None and \
            v.is_floating_point() else v

    def forward(params, aux, batch):
        merged = {k: cast(v) for k, v in params.items()}
        merged.update({k: cast(v) for k, v in batch.items()})
        with torch.no_grad():
            return graph_fn(merged, aux)[0]

    def make(static):
        device = next(iter(static.values())).device
        if compile_cache.custom_nodes(program):
            def args():
                merged = {k: cast(v) for k, v in state['params'].items()}
                merged.update({k: cast(v) for k, v in static.items()})
                return merged
            return compile_cache.StagedStep(
                'eval_step', staged_forward(SegmentPlan(program), args,
                                            state['aux']), device)
        return compile_cache.CapturedStep(
            'eval_step', functools.partial(forward, state['params'],
                                           state['aux'], static), device)

    table = _StepTable('eval_step', program, False, make)
    state = {}

    def step(params, aux, batch, rng=None):
        if table.skip(next(iter(batch.values())).device):
            return forward(params, aux, batch)
        state.update(params=params, aux=aux)
        return table.step(batch, params, aux).run()

    step.graphs = table.graphs
    return step
