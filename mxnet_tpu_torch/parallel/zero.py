"""ZeRO-style sharded data parallelism (optimizer state and update sharded
over the dp axis) — the port of ``mxnet_tpu/parallel/zero.py``.

The recipe is the JAX package's: reduce-scatter the gradients so each
dp rank owns 1/N of every parameter's update, keep the optimizer state
only for the owned part, and all-gather the updated parts back into the
replicated parameters: per step the traffic of one all-reduce, optimizer
memory divided by N.  All parameters of a dtype ride ONE fused buffer
(:func:`_layout`, the JAX package's exactly: sorted names, each parameter
padded to N·chunk and laid out as an (N, chunk) block, the blocks
concatenated along the chunk axis), so the whole model costs one
reduce-scatter and one all-gather per dtype per step, whatever the number
of tensors.

Two forms, as in the JAX package:

- :func:`make_zero_sgd_momentum` / :func:`make_zero_train_step`: the
  ``shard_map`` legs (here: each rank of the dp group calls them on its
  own rows; BatchNorm statistics stay SHARD-local, and a loss head that
  divides by the shard's batch is refused);
- :class:`ZeroUpdate`: what ``Module.fit(mesh=...)`` trains through
  (``parallel/train_step.make_fit_step(shardings=)``): the module's
  optimizer (any with a functional form) applied to this rank's part of
  the fused buffer, composed with the tp axis (a tp-sharded parameter is
  updated as this rank's tp shard, then all-gathered over tp).

Role equivalents in the reference: the kvstore updater-on-server mode
(``kvstore_dist_server.h:136-219``) also keeps ONE authoritative copy of
each weight's state; ZeRO is that idea run with collectives.
"""
from __future__ import annotations

import numpy as np
import torch

from . import collectives
from .mesh import DP_AXIS, TP_AXIS, _pick_shard_dim, tp_dim

__all__ = ['zero_state_size', 'zero_init', 'make_zero_sgd_momentum',
           'zero_partition_spec', 'zero_spec_for', 'zero_opt_init',
           'make_zero_train_step', 'ZeroUpdate']


def _layout(params, n_shards):
    """Deterministic fused-buffer layout: sorted names, per-param
    shard-chunk sizes and offsets into the (n, C) concatenation."""
    names = sorted(params)
    chunks = {}
    offsets = {}
    off = 0
    for k in names:
        size = int(np.prod(params[k].shape))
        chunk = -(-size // n_shards)  # ceil div
        chunks[k] = chunk
        offsets[k] = off
        off += chunk
    return names, chunks, offsets, off


def zero_state_size(params, n_shards):
    """Per-rank optimizer slot count: one f32 momentum lane per owned
    parameter element (the fused C of the layout)."""
    return _layout(params, n_shards)[3]


def zero_init(params, n_shards, device=None):
    """This rank's momentum shard — a single fused (C,) vector."""
    if device is None and params:
        device = next(iter(params.values())).device
    return torch.zeros((zero_state_size(params, n_shards),),
                       dtype=torch.float32, device=device)


def _to_blocks(tree, names, chunks, n_shards, dtype=torch.float32):
    rows = []
    for k in names:
        flat = tree[k].detach().to(dtype).reshape(-1)
        pad = chunks[k] * n_shards - flat.shape[0]
        rows.append(torch.nn.functional.pad(flat, (0, pad))
                    .reshape(n_shards, chunks[k]))
    return torch.cat(rows, dim=1)  # (n, C)


def _over(group, n, op, x):
    """``op(x, group)`` over an axis of ``n`` ranks (a one-rank axis, whose
    group is None, issues nothing: its result is ``x`` itself)."""
    return op(x, group) if n > 1 else x.clone()


def make_zero_sgd_momentum(group, n_shards, lr=0.05, momentum=0.9,
                           wd=1e-4, rescale_grad=1.0):
    """Sharded SGD-with-momentum update for the ranks of ``group`` (the dp
    axis's process group; the JAX package's ``axis_name``).

    ``update(params, grads, mom_shard) -> (new_params, new_mom_shard)``:
    ``params`` the replicated full parameters (equal on every rank),
    ``grads`` this rank's UNREDUCED gradients, ``mom_shard`` its fused
    (C,) momentum vector; the new parameters are again replicated
    (all-gathered)."""
    def update(params, grads, mom_shard):
        names, chunks, offsets, _ = _layout(params, n_shards)
        idx = collectives._dist().get_rank(group) if n_shards > 1 else 0
        with torch.no_grad():
            # sum across dp + keep this rank's 1/N of every param: ONE
            # reduce-scatter for the whole model
            g_blocks = _to_blocks(grads, names, chunks, n_shards)
            g_shard = _over(group, n_shards, collectives.reduce_scatter,
                            g_blocks.reshape(-1))
            p_shard = _to_blocks(params, names, chunks, n_shards)[idx]
            # the lr-folded buffer (m = mu*m - lr*g), as make_sgd_momentum
            # and the reference's sgd_mom_update
            mom = momentum * mom_shard \
                - lr * (g_shard * rescale_grad + wd * p_shard)
            p_new = p_shard + mom
            # ONE all-gather rebuilds the replicated params
            full = _over(group, n_shards, collectives.all_gather,
                         p_new).reshape(n_shards, -1)
            new_params = {}
            for k in names:
                p = params[k]
                size = int(np.prod(p.shape))
                seg = full[:, offsets[k]:offsets[k] + chunks[k]]
                new_params[k] = seg.reshape(-1)[:size].reshape(p.shape) \
                    .to(p.dtype)
        return new_params, mom

    return update


def zero_partition_spec(shape, mesh, dp_axis=DP_AXIS, base=None):
    """The inspector's ZeRO spec for ONE optimizer-state leaf: ``base``
    (the owning parameter's tp spec) plus ``dp_axis`` on the largest
    still-unsharded dp-divisible dim; ``()`` when nothing is sharded."""
    ndp = int(mesh.shape.get(dp_axis, 1))
    return zero_spec_for(shape, ndp, base=base, dp_axis=dp_axis)


def zero_spec_for(shape, ndp, base=None, dp_axis=DP_AXIS):
    """Mesh-free core of :func:`zero_partition_spec`: the per-dim axis
    tuple (empty = replicated) a leaf of ``shape`` gets when ZeRO-sharded
    over ``ndp`` data-parallel shards on top of ``base``."""
    base_spec = tuple(base) if base is not None else ()
    base_spec = base_spec + (None,) * (len(shape) - len(base_spec))
    taken = tuple(i for i, s in enumerate(base_spec) if s is not None)
    # the SAME selection rule tp placement uses (mesh._pick_shard_dim)
    best = _pick_shard_dim(shape, int(ndp), taken=taken)
    if best is None:
        return base_spec if any(s is not None for s in base_spec) else ()
    spec = list(base_spec)
    spec[best] = dp_axis
    return tuple(spec)


def zero_opt_init(params, n_shards):
    """GLOBAL optimizer state for :func:`make_zero_train_step`: an
    (n_shards, C) zero buffer, row i rank i's fused momentum vector."""
    device = next(iter(params.values())).device if params else None
    return torch.zeros((n_shards, zero_state_size(params, n_shards)),
                       dtype=torch.float32, device=device)


def make_zero_train_step(symbol, mesh, axis_name=DP_AXIS, lr=0.05,
                         momentum=0.9, wd=1e-4, rescale_grad=1.0,
                         compute_dtype=None, donate=True):
    """Fused forward/backward/ZeRO-update step over the ``axis_name``
    axis of ``mesh`` (a ``parallel.mesh.RankMesh``).

    ``step(params, aux, opt_state, batch, rng=None) -> (outputs, params,
    aux, opt_state)``, called by every rank of the axis with ITS rows of
    the batch and its row of the state (``zero_opt_init(...)[i]``, or the
    (1, C) block): the same contract as ``make_train_step``, the
    gradients reduce-scattered so each rank updates 1/N of every
    parameter with its own state, the updated parameters all-gathered
    back.  BatchNorm statistics are shard-local (each rank normalises
    its own rows, the reference's multi-GPU data parallelism); the
    moving averages are averaged over the axis so the replicas stay
    equal.  Outputs are the rank's rows.  With ``donate`` (the default)
    ``params``, ``aux`` and ``opt_state`` are updated in place."""
    from .train_step import make_fit_step, _PlainUpdate

    # loss normalization must be global: a shard-local 'batch'/'valid'
    # divisor would make the reduce-scattered gradient N times larger
    # than the same symbol through make_train_step on the full batch.
    # Use normalization='null' + rescale_grad=1/global_batch instead.
    for node in symbol.topo_nodes():
        if node.is_variable:
            continue
        norm = node.attrs.get('normalization')
        if node.op.endswith('Output') and norm in ('batch', 'valid'):
            raise ValueError(
                "make_zero_train_step: %s normalization=%r divides by "
                "the SHARD-local batch under shard_map; use "
                "normalization='null' with rescale_grad=1/global_batch"
                % (node.op, norm))

    group = mesh.group(axis_name)
    n_shards = mesh.shape[axis_name]
    zupd = make_zero_sgd_momentum(group, n_shards, lr=lr,
                                  momentum=momentum, wd=wd,
                                  rescale_grad=rescale_grad)

    def in_place(params, grads, mom):
        new_p, new_mom = zupd(params, grads, mom.reshape(-1))
        with torch.no_grad():
            for k, v in new_p.items():
                params[k].copy_(v)
            mom.copy_(new_mom.reshape(mom.shape))

    raw = make_fit_step(symbol, _PlainUpdate(in_place), data_names=(),
                        compute_dtype=compute_dtype)

    def step(params, aux, opt_state, batch, rng=None):
        if not donate:
            params = {k: v.clone() for k, v in params.items()}
            aux = {k: v.clone() for k, v in aux.items()}
            opt_state = opt_state.clone()
        outs = raw(params, {}, aux, opt_state, batch, 0.0)
        if aux and n_shards > 1:
            with torch.no_grad():
                for k, v in aux.items():
                    v.copy_(collectives.psum(v, group) / n_shards)
        return outs, params, aux, opt_state

    return step


class ZeroUpdate(object):
    """The update of a dp×tp fit step: a functional optimizer
    (``optimizer.FunctionalOptimizer``) applied to this rank's part of
    the ZeRO layout, in place.

    Each parameter's OWNED tensor is its tp shard along the dim its spec
    names (a view of the full tensor, which the forward reads), or the
    whole tensor when it is replicated over tp.  Per dtype, the owned
    tensors' gradients are laid out by :func:`_layout` over the dp axis
    and reduce-scattered (one collective), this rank's row of the owned
    parameters is updated against its row of the optimizer state (the
    state holds ``chunk`` elements per parameter: 1/dp of the owned
    tensor, 1/(dp·tp) of a tp-sharded parameter), and the updated rows
    are all-gathered over dp (one collective) into the owned tensors.
    Then the tp-sharded parameters' shards are all-gathered over tp (one
    collective) into the full tensors.  The padding lanes hold zeros and
    stay zero under every elementwise update."""

    def __init__(self, functional, plan, specs):
        self.functional = functional
        self.plan = plan
        self.dp, self.tp = plan.dp, plan.tp
        self.dp_group = plan.mesh.group(DP_AXIS)
        self.tp_group = plan.mesh.group(TP_AXIS)
        self.d = plan.mesh.index(DP_AXIS)
        self.t = plan.mesh.index(TP_AXIS)
        # name -> the dim sharded over tp (None: replicated over tp)
        self.tp_dims = {n: (tp_dim(specs.get(n)) if self.tp > 1 else None)
                        for n in functional.param_names}
        self._layouts = {}

    def owned(self, name, full):
        """The part of ``full`` this rank updates (a view)."""
        dim = self.tp_dims.get(name)
        if dim is None:
            return full
        size = full.shape[dim] // self.tp
        return full.narrow(dim, self.t * size, size)

    def _layout_for(self, params):
        """Per dtype: (names, chunks, offsets, C) over the owned shapes."""
        key = tuple((n, tuple(v.shape), v.dtype)
                    for n, v in sorted(params.items()))
        lay = self._layouts.get(key)
        if lay is None:
            by_dtype = {}
            for n, v in params.items():
                by_dtype.setdefault(v.dtype, {})[n] = self.owned(n, v)
            lay = self._layouts[key] = {
                dt: _layout(owned, self.dp) for dt, owned in
                by_dtype.items()}
        return lay

    def init(self, params):
        """This rank's optimizer state: the functional optimizer's state
        for a (chunk,) slice of each parameter."""
        shards = {}
        for dt, (names, chunks, _, _) in self._layout_for(params).items():
            for n in names:
                shards[n] = torch.zeros((chunks[n],), dtype=dt,
                                        device=params[n].device)
        return self.functional.init(shards)

    def update(self, params, grads, states, lr_t):
        """One step, in place on ``params`` (the full tensors) and
        ``states``."""
        with torch.no_grad():
            for dt, (names, chunks, offsets, _) in \
                    self._layout_for(params).items():
                owned = {n: self.owned(n, params[n]) for n in names}
                g_blocks = _to_blocks(
                    {n: self.owned(n, grads[n]) for n in names}, names,
                    chunks, self.dp, dtype=dt)
                g_row = _over(self.dp_group, self.dp,
                              collectives.reduce_scatter,
                              g_blocks.reshape(-1))
                p_row = _to_blocks(owned, names, chunks, self.dp,
                                   dtype=dt)[self.d].contiguous()
                self.functional.update(
                    {n: p_row[offsets[n]:offsets[n] + chunks[n]]
                     for n in names},
                    {n: g_row[offsets[n]:offsets[n] + chunks[n]]
                     for n in names},
                    states, lr_t)
                full = _over(self.dp_group, self.dp, collectives.all_gather,
                             p_row).view(self.dp, -1)
                for n in names:
                    size = owned[n].numel()
                    seg = full[:, offsets[n]:offsets[n] + chunks[n]]
                    owned[n].copy_(seg.reshape(-1)[:size]
                                   .view(owned[n].shape))
                self._gather_tp(params, names)

    def _gather_tp(self, params, names):
        """The tp-sharded parameters' shards, all-gathered over tp into
        the full tensors (one collective)."""
        sharded = [n for n in names if self.tp_dims.get(n) is not None]
        if not sharded:
            return
        shards = [self.owned(n, params[n]) for n in sharded]
        flat = torch.cat([s.reshape(-1) for s in shards])
        full = _over(self.tp_group, self.tp, collectives.all_gather,
                     flat).view(self.tp, -1)
        off = 0
        for n, s in zip(sharded, shards):
            k = s.numel()
            piece = full[:, off:off + k].reshape((self.tp,) + tuple(s.shape))
            dim = self.tp_dims[n]
            params[n].copy_(piece.movedim(0, dim).reshape(params[n].shape))
            off += k

    # -- the unsharded form (checkpoints) ----------------------------------
    def _leaves(self, state):
        if state is None:
            return []
        return list(state) if isinstance(state, tuple) else [state]

    def gather_states(self, params, states):
        """Every state leaf unsharded, shaped as its parameter: ``{name:
        tensor or tuple}`` (all ranks call it: two collectives per leaf
        slot and dtype)."""
        out = {}
        for dt, (names, chunks, offsets, _) in \
                self._layout_for(params).items():
            nslots = max((len(self._leaves(states[n])) for n in names),
                         default=0)
            parts = {n: [] for n in names}
            for slot in range(nslots):
                row = torch.cat([self._leaves(states[n])[slot]
                                 for n in names])
                full = _over(self.dp_group, self.dp, collectives.all_gather,
                             row).view(self.dp, -1)
                owned = {}
                for n in names:
                    shape = self.owned(n, params[n]).shape
                    size = int(np.prod(shape))
                    owned[n] = full[:, offsets[n]:offsets[n] + chunks[n]] \
                        .reshape(-1)[:size].reshape(shape)
                tp_names = [n for n in names
                            if self.tp_dims.get(n) is not None]
                if tp_names:
                    flat = torch.cat([owned[n].reshape(-1)
                                      for n in tp_names])
                    g = _over(self.tp_group, self.tp, collectives.all_gather,
                              flat).view(self.tp, -1)
                    off = 0
                    for n in tp_names:
                        k = owned[n].numel()
                        piece = g[:, off:off + k].reshape(
                            (self.tp,) + tuple(owned[n].shape))
                        owned[n] = piece.movedim(
                            0, self.tp_dims[n]).reshape(params[n].shape)
                        off += k
                for n in names:
                    parts[n].append(owned[n])
            for n in names:
                s = states[n]
                out[n] = None if s is None else (
                    tuple(parts[n]) if isinstance(s, tuple)
                    else parts[n][0])
        return out

    def scatter_state(self, name, full_param, state, entry):
        """Copy an unsharded state ``entry`` (an ``Updater.states`` value:
        a tensor/NDArray or a tuple of them, shaped as the parameter)
        into this rank's ``state`` in place."""
        from ..ndarray import NDArray
        dst = self._leaves(state)
        src = [] if entry is None else (
            list(entry) if isinstance(entry, (tuple, list)) else [entry])
        if len(dst) != len(src):
            from ..base import MXNetError
            raise MXNetError('optimizer state of %s does not match the '
                             'optimizer' % name)
        for d, e in zip(dst, src):
            e = e.handle if isinstance(e, NDArray) else torch.as_tensor(e)
            owned = self.owned(name, e.to(d.device, d.dtype)
                               .reshape(full_param.shape)).reshape(-1)
            chunk = d.shape[0]
            padded = torch.nn.functional.pad(
                owned, (0, chunk * self.dp - owned.shape[0]))
            with torch.no_grad():
                d.copy_(padded[self.d * chunk:(self.d + 1) * chunk])
