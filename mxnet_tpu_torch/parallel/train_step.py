"""The fused training step — forward, backward and the optimizer update
of every parameter as one call.

The port of ``mxnet_tpu/parallel/train_step.py`` (``make_fit_step
:47-256``, ``make_sgd_momentum :34``, ``make_train_step :270-292``,
``make_eval_step :295-316``).  The JAX package traces the step
into ONE jitted XLA program with donated buffers; PyTorch runs eagerly,
so here the step runs the pass pipeline's graph (``MXTPU_FUSE``) under
autograd with zero head gradients (``SoftmaxOutput`` injects the loss
gradient), writes the aux updates back, and applies the functional
optimizer to the f32 master weights and the optimizer state IN PLACE —
the counterpart of the JAX step's buffer donation.

Under ``compute_dtype`` (bf16 mixed precision) the parameters and the
batch entries named in ``data_names`` are cast for the forward and
backward; labels, master weights and optimizer state stay f32, and the
gradients reach the f32 masters through the cast.  A batch entry the
graph reads only as an index (:func:`index_inputs`: token ids into an
``Embedding``) is never cast: bf16 holds integers exactly only up to 256
(the JAX package casts them, a recorded reference fault).

Not ported: shardings (a mesh), health sentinels and CUDA graphs of the
step; asking for them raises.
"""
from __future__ import annotations

import torch

from ..executor import _build_graph_fn
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


def make_fit_step(symbol: Symbol, functional_opt, data_names=(),
                  compute_dtype=None, metric=None, metric_label=None,
                  shardings=None, health_action=None):
    """Build ``step(params, frozen, aux, opt_state, batch, lr_t) ->
    outputs``: forward, backward and every parameter update.  ``params``,
    ``aux`` and ``opt_state`` are name -> tensor dicts updated in place;
    ``functional_opt`` is an ``optimizer.FunctionalOptimizer`` (or any
    object with ``update(params, grads, states, lr_t)``).

    With ``metric`` (an ``EvalMetric`` with a device form) the step folds
    ``metric.device_fold(batch[metric_label], outputs[0])`` — deltas from
    the UNCAST label — so the fit loop never syncs on the metric."""
    if shardings is not None:
        raise NotImplementedError('make_fit_step: sharded (mesh) steps are '
                                  'not ported to mxnet_tpu_torch yet')
    if health_action is not None:
        raise NotImplementedError('make_fit_step: health sentinels are not '
                                  'ported to mxnet_tpu_torch yet')
    from ..fuse import apply_fuse_passes
    program = apply_fuse_passes(symbol, True)
    graph_fn = _build_graph_fn(program, True)
    indices = index_inputs(symbol)
    data_names = tuple(n for n in data_names if n not in indices)

    def cast(v):
        return v.to(compute_dtype) if compute_dtype is not None and \
            v.is_floating_point() else v

    def step(params, frozen, aux, opt_state, batch, lr_t):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        merged = {k: cast(v) for k, v in frozen.items()}
        merged.update({k: cast(v) for k, v in leaves.items()})
        merged.update({k: (cast(v) if k in data_names else v)
                       for k, v in batch.items()})
        with torch.enable_grad():
            outs, aux_upd = graph_fn(merged, aux)
            heads = [o for o in outs if o.requires_grad]
            if heads:
                torch.autograd.backward(
                    heads, [torch.zeros_like(o) for o in heads])
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in leaves.items()}
        for k, v in aux_upd.items():
            aux[k].copy_(v)
        functional_opt.update(params, grads, opt_state, lr_t)
        outs = [o.detach() for o in outs]
        if metric is not None:
            metric.device_fold(batch[metric_label], outs[0])
        return outs

    step.kernels = graph_kernels(program)
    return step


class _PlainUpdate(object):
    """Adapter presenting a bare ``update(params, grads, state)`` callable
    as a functional optimizer (the lr is baked into the callable)."""

    def __init__(self, fn):
        self._fn = fn

    def update(self, params, grads, state, lr_t):
        return self._fn(params, grads, state)


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
    counterpart of the JAX step's donated buffers; ``donate=False`` works
    on copies and leaves the caller's tensors as they were.  ``rng`` is
    accepted for the JAX signature; the ported ops draw no random
    numbers."""
    raw = make_fit_step(symbol, _PlainUpdate(optimizer_update),
                        data_names=(), compute_dtype=compute_dtype)

    def step(params, aux, opt_state, batch, rng=None):
        if not donate:
            params, aux, opt_state = ({k: v.clone() for k, v in d.items()}
                                      for d in (params, aux, opt_state))
        outs = raw(params, {}, aux, opt_state, batch, 0.0)
        return outs, params, aux, opt_state

    return step


def make_eval_step(symbol: Symbol, compute_dtype=None):
    """Inference: ``step(params, aux, batch, rng=None) -> outputs``
    (``mxnet_tpu/parallel/train_step.py:295-316``), through the pass
    pipeline with ``is_train=False``; under ``compute_dtype`` the params
    and the floating batch entries are cast."""
    from ..fuse import apply_fuse_passes
    graph_fn = _build_graph_fn(apply_fuse_passes(symbol, False), False)

    def cast(v):
        return v.to(compute_dtype) if compute_dtype is not None and \
            v.is_floating_point() else v

    def step(params, aux, batch, rng=None):
        merged = {k: cast(v) for k, v in params.items()}
        merged.update({k: cast(v) for k, v in batch.items()})
        with torch.no_grad():
            outs, _ = graph_fn(merged, aux)
        return outs

    return step
