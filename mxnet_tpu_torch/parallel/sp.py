"""Symbol-level sequence (context) parallelism — the port of
``mxnet_tpu/parallel/sp.py`` on ``torch.distributed``.

``make_sp_train_step(symbol, mesh, ...)`` runs an MXNet-style symbol
(e.g. the transformer LM) with its SEQUENCE dimension sharded over the
ranks of ``mesh``'s ``seq_axis`` dimension: every ``FlashAttention``
node becomes ring attention (K/V blocks rotating between ranks) or
Ulysses attention (an all-to-all head swap around the flash-attention
kernel), token-wise ops run on each rank's slice, and the gradients of
replicated parameters are summed over the ranks with ``dist.all_reduce``.
The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with a
dimension named ``seq_axis``; its process group takes the place of the
JAX version's ``shard_map`` axis.  Launch one process per rank
(``torchrun``, or ``init_process_group`` with an address, world size and
rank), NCCL on the card, gloo on the CPU.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

__all__ = ['make_sp_train_step', 'shard_sp_params', 'sp_scope',
           'current_sp_axis', 'current_sp_mode']

_TLS = threading.local()


def current_sp_axis():
    """The process group of the sequence-parallel scope the graph runs
    in, or None.  ``ops.nn._flash_attention_apply`` runs ring (or
    Ulysses) attention over it when set."""
    return getattr(_TLS, 'axis', None)


def current_sp_mode():
    """'ring' (K/V rotation) or 'ulysses' (all-to-all head swap)."""
    return getattr(_TLS, 'mode', 'ring')


@contextlib.contextmanager
def sp_scope(axis, mode='ring'):
    prev = getattr(_TLS, 'axis', None)
    prev_mode = getattr(_TLS, 'mode', 'ring')
    _TLS.axis = axis
    _TLS.mode = mode
    try:
        yield
    finally:
        _TLS.axis = prev
        _TLS.mode = prev_mode


def _local(value, dim, rank, n, name):
    """Rank ``rank``'s slice of ``value`` along ``dim`` (of ``n``)."""
    if dim is None:
        return value
    size = value.shape[dim]
    if size % n:
        raise ValueError('batch entry %s: dim %d (%d) does not divide by '
                         'the %d sequence ranks' % (name, dim, size, n))
    return value.narrow(dim, rank * (size // n), size // n)


def make_sp_train_step(symbol, mesh, optimizer_update, seq_axis='seq',
                       seq_param_names=(), batch_specs=None,
                       compute_dtype=None, data_names=(), attn_mode='ring'):
    """Build ``step(params, opt_state, batch, rng=None) -> (outputs,
    params, opt_state)`` with the sequence dimension sharded over
    ``mesh[seq_axis]``.

    Args:
      symbol: loss-bearing symbol built at the LOCAL sequence length
        (``global_T // N``): every static shape in it (Reshape targets,
        positional tables) is a rank's own.  Ring attention still
        applies the GLOBAL causal mask.
      optimizer_update: in-place ``(params, grads, state)`` (e.g.
        ``make_sgd_momentum``), applied on every rank.
      seq_param_names: parameters sharded along their first axis with
        the sequence (a learned positional table); their gradients stay
        local.  All other parameters are replicated and their gradients
        summed over the ranks.
      batch_specs: {name: dim or None}: the dim of each batch entry
        sharded over the ranks (default 1, the (N, T) LM layout; None
        replicates it).
      compute_dtype: optional compute cast (bf16) of the parameters and
        of the batch entries in ``data_names``, never of labels or of an
        input the graph reads only as an index.
      attn_mode: 'ring' (any head count) or 'ulysses' (heads must divide
        by the ranks).

    ``params`` and ``opt_state`` are each rank's own, laid out by
    :func:`shard_sp_params`, and updated in place; ``batch`` holds the
    GLOBAL batch (every rank passes the same), of which the step takes
    its rank's slice.  The outputs are the rank's own rows: its block of
    the JAX step's dim-0 shard-blocked output.  As in the JAX version, no
    fuse pass runs and auxiliary states raise."""
    from .. import compile_cache, random
    from ..executor import _build_graph_fn, mirror_wrap
    from .train_step import index_inputs
    if symbol.list_auxiliary_states():
        raise NotImplementedError(
            'make_sp_train_step does not thread auxiliary state yet '
            '(BatchNorm moving stats); use stateless normalization in '
            'sequence-parallel symbols')
    if attn_mode not in ('ring', 'ulysses'):
        raise ValueError("attn_mode must be 'ring' or 'ulysses', got %r"
                         % (attn_mode,))
    # its collectives (NCCL / gloo) are not captured: the step stays
    # eager, by rule
    compile_cache.note_skip('sp_train_step', 'collectives')
    graph_fn = _build_graph_fn(symbol, True)
    draws = bool(compile_cache.random_nodes(symbol))
    group = mesh.get_group(seq_axis)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    seq_param_names = set(seq_param_names)
    data_names = set(data_names or ()) - index_inputs(symbol)
    specs = dict(batch_specs or {})

    def cast(v):
        return v.to(compute_dtype) if compute_dtype is not None and \
            v.is_floating_point() else v

    def step(params, opt_state, batch, rng=None):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}

        def forward(leaves):
            merged = {k: cast(v) for k, v in leaves.items()}
            for k, v in batch.items():
                v = _local(v, specs.get(k, 1), rank, n, k)
                merged[k] = cast(v) if k in data_names else v
            return graph_fn(merged, {})

        gens = [random.generator(next(iter(params.values())).device)] \
            if draws else []
        # the mirror's recompute runs in backward, inside the sp scope
        with torch.enable_grad(), sp_scope(group, attn_mode):
            outs, _ = mirror_wrap(forward, gens)(leaves)
            heads = [o for o in outs if o.requires_grad]
            if heads:
                torch.autograd.backward(
                    heads, [torch.zeros_like(o) for o in heads])
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in leaves.items()}
        # replicated parameters: the ranks' partial gradients summed, in
        # one flat all-reduce; sequence-sharded ones stay local
        shared = [k for k in sorted(grads) if k not in seq_param_names]
        if shared:
            flat = torch.cat([grads[k].reshape(-1) for k in shared])
            dist.all_reduce(flat, group=group)
            for k, g in zip(shared, flat.split(
                    [grads[k].numel() for k in shared])):
                grads[k] = g.view_as(grads[k])
        optimizer_update(params, grads, opt_state)
        return [o.detach() for o in outs], params, opt_state

    return step


def shard_sp_params(params, mesh, seq_axis='seq', seq_param_names=()):
    """Each rank's copy of ``params`` on the mesh's device: the
    ``seq_param_names`` sliced along dim 0 to the rank's block, the rest
    whole — the layout :func:`make_sp_train_step` expects.  Always copies
    (the step updates in place)."""
    group = mesh.get_group(seq_axis)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    device = torch.device('cuda', torch.cuda.current_device()) \
        if mesh.device_type == 'cuda' else torch.device(mesh.device_type)
    seq_param_names = set(seq_param_names)
    return {k: _local(v, 0 if k in seq_param_names else None, rank, n,
                      k).to(device, copy=True)
            for k, v in params.items()}
