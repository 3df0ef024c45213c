"""The dp×tp mesh of the sharded fit — the port of
``mxnet_tpu/parallel/mesh.py`` (its product path, ``:66-518``).

The JAX package runs one process over all devices: a ``('dp', 'tp')``
``jax.sharding.Mesh``, ``NamedSharding`` placements, and XLA's SPMD
partitioner placing the collectives inside the compiled step.  PyTorch's
idiom is one process per device: here a mesh is a grid of RANKS of the
job (``torch.distributed``), rank (d, t) = d·tp + t, with one process
group per dp axis (the ranks of one tp position) and one per tp axis (the
ranks of one dp slot).  The step issues its own collectives on them
(``parallel/collectives.py``):

- the batch: every rank reads the same global batch and keeps rows
  [d·B/dp, (d+1)·B/dp) (:meth:`ShardingPlan.rows`); the tp peers of a dp
  slot take the same rows;
- BatchNorm normalises the global batch (:class:`DpBatchStats`: the
  per-channel sums of x and x² all-reduced over dp inside autograd);
- the gradient is reduced over dp and the update is ZeRO over dp
  (``parallel/zero.py``: one reduce-scatter and one all-gather per dtype);
- a tp-sharded parameter (``partition='auto'``/``'tp'`` or a name dict)
  is updated as this rank's shard along the dim :func:`_pick_shard_dim`
  picks, with 1/(dp·tp) of its optimizer state, and all-gathered over tp
  after the update.  The tp axis shards the STORAGE of the update, not
  the arithmetic: the tp peers run the same forward and backward (XLA
  may split the arithmetic; ROADMAP Queue 3).

The selection rules (:func:`parse_mesh_spec`, :func:`_pick_shard_dim`,
:func:`_spec_and_reason`, :func:`records_for_shapes`, the inspector's
records and reason strings) are the JAX package's, word for word, so a
plan records the same decisions in both packages.  A spec is a tuple of
axis names per dim (``()`` replicated) where the JAX package has a
``PartitionSpec``.  ``mesh='1x1'`` needs no process group and issues no
collective.
"""
from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from . import collectives

__all__ = ['DP_AXIS', 'TP_AXIS', 'RankMesh', 'parse_mesh_spec',
           'build_dp_tp_mesh', 'mesh_sig', 'partition_spec',
           'ShardingPlan', 'FitShardings', 'make_plan',
           'records_for_shapes', 'DpBatchStats']

DP_AXIS = 'dp'
TP_AXIS = 'tp'

# (dp, tp) -> (dp groups by tp position, tp groups by dp slot): made once
# per process, in the same order on every rank (new_group is collective)
_groups = {}


class RankMesh(object):
    """A ``('dp', 'tp')`` grid of the job's ranks.  ``shape`` maps axis
    name to size (the ``Mesh.shape`` of the JAX package); ``coords`` is
    this rank's (d, t); :meth:`group` the process group of this rank's
    line along an axis (None when the axis has one rank: nothing to
    issue)."""

    axis_names = (DP_AXIS, TP_AXIS)

    def __init__(self, dp, tp, rank=0, dp_groups=None, tp_groups=None):
        self.shape = {DP_AXIS: int(dp), TP_AXIS: int(tp)}
        self.rank = int(rank)
        self.coords = (self.rank // self.shape[TP_AXIS],
                       self.rank % self.shape[TP_AXIS])
        self._dp_groups = dp_groups
        self._tp_groups = tp_groups

    @property
    def size(self):
        return self.shape[DP_AXIS] * self.shape[TP_AXIS]

    def index(self, axis):
        """This rank's position along ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis):
        """The process group of this rank's ranks along ``axis`` (None
        for a one-rank axis)."""
        if self.shape[axis] == 1:
            return None
        if axis == DP_AXIS:
            return self._dp_groups[self.coords[1]]
        return self._tp_groups[self.coords[0]]

    def barrier(self):
        """Every rank of the mesh (none to wait for on one rank)."""
        if self.size > 1:
            collectives._dist().barrier()

    def __repr__(self):
        return 'RankMesh(%s, rank=%d)' % (mesh_sig(self), self.rank)


def parse_mesh_spec(spec):
    """Normalize a user mesh spec into ``{'dp': d, 'tp': t}``.

    Accepted forms (the MXTPU_MESH grammar):
      - ``'4x2'`` / ``'4,2'``  — dp×tp sizes positionally;
      - ``'8'`` / ``8``        — pure data parallelism (tp=1);
      - ``'dp=4,tp=2'``        — named axes, either may be omitted;
      - ``{'dp': 4, 'tp': 2}`` — already parsed;
      - ``(4, 2)``             — positional tuple/list.
    """
    if isinstance(spec, RankMesh):
        raise TypeError('pass a ready Mesh directly, not through '
                        'parse_mesh_spec')
    if isinstance(spec, dict):
        axes = {DP_AXIS: int(spec.get(DP_AXIS, 1)),
                TP_AXIS: int(spec.get(TP_AXIS, 1))}
        unknown = set(spec) - {DP_AXIS, TP_AXIS}
        if unknown:
            raise ValueError('unknown mesh axes %s (product path speaks '
                             'dp/tp)' % sorted(unknown))
        return axes
    if isinstance(spec, int):
        return {DP_AXIS: int(spec), TP_AXIS: 1}
    if isinstance(spec, (tuple, list)):
        vals = [int(v) for v in spec]
        if len(vals) == 1:
            vals.append(1)
        if len(vals) != 2:
            raise ValueError('mesh tuple must be (dp,) or (dp, tp), '
                             'got %r' % (spec,))
        return {DP_AXIS: vals[0], TP_AXIS: vals[1]}
    s = str(spec).strip()
    if not s:
        raise ValueError('empty mesh spec')
    if '=' in s:
        axes = {DP_AXIS: 1, TP_AXIS: 1}
        for part in s.replace(';', ',').split(','):
            part = part.strip()
            if not part:
                continue
            name, _, val = part.partition('=')
            name = name.strip().lower()
            if name not in axes:
                raise ValueError('unknown mesh axis %r in %r (dp/tp '
                                 'only)' % (name, spec))
            axes[name] = int(val)
        return axes
    for sep in ('x', 'X', ','):
        if sep in s:
            return parse_mesh_spec(tuple(
                p for p in (q.strip() for q in s.split(sep)) if p))
    return {DP_AXIS: int(s), TP_AXIS: 1}


def _make_groups(dp, tp):
    """The dp groups (one per tp position) and tp groups (one per dp
    slot) of a dp×tp job, made once per process.  Every rank makes every
    group in the same order (``new_group`` is collective over the job).
    NCCL groups when every rank holds a card of its own, else the job's
    default backend (gloo: ranks that share a card)."""
    key = (dp, tp)
    if key not in _groups:
        dist = collectives._dist()
        kw = {'backend': 'nccl'} if collectives._nccl_group is not None \
            else {}
        dp_groups = [dist.new_group([d * tp + t for d in range(dp)], **kw)
                     if dp > 1 else None for t in range(tp)]
        tp_groups = [dist.new_group([d * tp + t for t in range(tp)], **kw)
                     if tp > 1 else None for d in range(dp)]
        _groups[key] = (dp_groups, tp_groups)
    return _groups[key]


def build_dp_tp_mesh(spec) -> RankMesh:
    """A ``('dp', 'tp')`` mesh over the job's ranks: one process per
    mesh position, so dp×tp must equal the job's size (a mesh larger than
    the job raises, as the JAX package's does over too few devices; one
    smaller would leave ranks with no position).  ``'1x1'`` is this
    process alone: no group.  ``spec`` is anything
    :func:`parse_mesh_spec` takes, or a ready :class:`RankMesh`."""
    if isinstance(spec, RankMesh):
        if DP_AXIS not in spec.shape:
            raise ValueError("mesh %r has no 'dp' axis" % (spec,))
        return spec
    axes = parse_mesh_spec(spec)
    dp, tp = axes[DP_AXIS], axes[TP_AXIS]
    need = dp * tp
    if need < 1:
        raise ValueError('mesh sizes must be positive: %r' % (axes,))
    if need == 1:
        return RankMesh(1, 1)
    world = collectives.world_size()
    if need > world:
        raise ValueError(
            'mesh dp=%d x tp=%d needs %d ranks but only %d are in the job '
            '(one process per mesh position: start them with '
            'tools/launch.py -n %d or torch.multiprocessing.spawn, and '
            'join the process group before fit)' % (dp, tp, need, world,
                                                    need))
    if need < world:
        raise ValueError(
            'mesh dp=%d x tp=%d covers %d of the job\'s %d ranks: every '
            'rank must hold a mesh position' % (dp, tp, need, world))
    dp_groups, tp_groups = _make_groups(dp, tp)
    return RankMesh(dp, tp, collectives.rank(), dp_groups, tp_groups)


def mesh_sig(mesh) -> str:
    """Stable string identity of a mesh's SHAPE (axis names + sizes) —
    what compile-cache signatures and the warmup manifest key on; the
    JAX package's string for the same shape."""
    return ','.join('%s=%d' % (name, mesh.shape[name])
                    for name in mesh.axis_names)


def _pick_shard_dim(shape, size, taken=()):
    """The dimension to split over an axis of ``size``: the largest dim
    divisible by it, lowest index on ties, skipping dims already
    sharded; None when nothing fits (→ replicate)."""
    best = None
    for i, d in enumerate(shape):
        if i in taken or size <= 1 or d % size != 0 or d < size:
            continue
        if best is None or d > shape[best]:
            best = i
    return best


def _spec_and_reason(shape, tp, partition='replicated', name=None):
    """The partition DECISION for one tensor, mesh-free: returns
    ``(spec, reason)`` where ``spec`` is a per-dim tuple of axis names
    (``()`` = replicated — a sharded tensor keeps one entry per dim)
    and ``reason`` is None or the human-readable degradation record —
    why a requested 'auto'/'tp' placement fell back to replicated.  The
    single selection rule behind :func:`partition_spec`, the
    :class:`ShardingPlan` records and :func:`records_for_shapes`."""
    shape = tuple(shape)
    if partition is None or partition == 'replicated' or partition == '':
        return (), None
    if isinstance(partition, dict):
        for pat, sub in partition.items():
            if name is not None and str(pat) in str(name):
                if isinstance(sub, (tuple, list)):
                    return tuple(sub), None
                return _spec_and_reason(shape, tp, sub, name)
        # no entry names this tensor: replicated BY POLICY, not a
        # degradation
        return (), None
    if partition in ('auto', 'tp'):
        dim = _pick_shard_dim(shape, tp)
        if dim is None:
            reason = None
            if tp > 1:
                reason = ('no tp-divisible dim: shape %s has no '
                          'dimension divisible by tp=%d — replicated'
                          % (shape, tp))
            return (), reason
        spec = [None] * len(shape)
        spec[dim] = TP_AXIS
        return tuple(spec), None
    raise ValueError('unknown partition policy %r (replicated | auto | '
                     '{name-substring: spec} dict)' % (partition,))


def partition_spec(shape, mesh, partition='replicated', name=None):
    """The spec (axis name per dim, ``()`` replicated) of ONE parameter
    under the partition policy: ``'replicated'`` (pure data
    parallelism), ``'auto'``/``'tp'`` (the largest tp-divisible dim over
    tp; indivisible tensors stay replicated, the fallback recorded), or a
    ``{substring: spec}`` dict whose first matching key wins."""
    spec, _ = _spec_and_reason(shape, mesh.shape.get(TP_AXIS, 1),
                               partition, name)
    return spec


def _shard_bytes_for(shape, spec, axes, itemsize=4):
    """Per-device bytes of one tensor under ``spec`` on a mesh of
    ``axes`` (``{axis-name: size}``): each named axis divides its dim
    by the axis size."""
    n = itemsize
    for d in shape:
        n *= int(d)
    for ax in spec:
        if ax is not None:
            n //= max(1, int(axes.get(ax, 1)))
    return n


def _itemsize(dtype):
    if dtype is None:
        return 4
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    try:
        return np.dtype(dtype).itemsize
    except TypeError:
        return 4


def _dtype_str(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace('torch.', '')
    return str(np.dtype(dtype))


def tp_dim(spec):
    """The dim a spec shards over tp (None: not tp-sharded)."""
    for i, ax in enumerate(spec or ()):
        if ax == TP_AXIS:
            return i
    return None


class ShardingPlan(object):
    """The sharding vocabulary of one dp×tp fit: built once by
    ``Module._set_parallel``, consumed by the executor group (the batch
    rows) and ``make_fit_step`` (the parameter and optimizer-state
    placement).  ``records`` are the inspector's: per parameter the spec
    chosen, its per-device shard bytes, the ZeRO leaf placements and the
    degradation reason when 'auto' fell back to replicated."""

    def __init__(self, mesh, partition='replicated'):
        self.mesh = mesh
        self.partition = partition if partition else 'replicated'
        self.dp = int(mesh.shape.get(DP_AXIS, 1))
        self.tp = int(mesh.shape.get(TP_AXIS, 1))
        self.num_devices = self.dp * self.tp
        self.records = {}
        self._warned = False

    def sig(self) -> str:
        """Identity for compile-cache keys/manifest meta: mesh shape +
        partition policy (the JAX package's string)."""
        part = self.partition if isinstance(self.partition, str) \
            else ','.join('%s:%s' % (k, tuple(v) if
                                     isinstance(v, (list, tuple))
                                     else v)
                          for k, v in sorted(self.partition.items()))
        return '%s|%s' % (mesh_sig(self.mesh), part)

    @property
    def multi_rank(self):
        """Whether the mesh spans more than this process (collectives)."""
        return self.num_devices > 1

    def rows(self, batch_size):
        """This rank's rows of a global batch: [d·B/dp, (d+1)·B/dp)."""
        per = int(batch_size) // self.dp
        d = self.mesh.index(DP_AXIS)
        return slice(d * per, (d + 1) * per)

    def _shard_bytes(self, shape, spec, dtype=None):
        return _shard_bytes_for(shape, spec, self.mesh.shape,
                                _itemsize(dtype))

    def param_sharding(self, name, shape, dtype=None):
        """The spec of parameter ``name`` (recorded).  The port stores a
        spec's tp dim as this rank's shard; other axes in a user's spec
        are refused."""
        spec, reason = _spec_and_reason(tuple(shape), self.tp,
                                        self.partition, name)
        if any(ax not in (None, TP_AXIS) for ax in spec):
            raise ValueError('partition spec %r for %s: the port shards '
                             'parameters over the tp axis only'
                             % (spec, name))
        rec = self.records.setdefault(str(name), {})
        if dtype is None:
            dtype = rec.get('dtype')
        rec['shape'] = tuple(int(d) for d in shape)
        rec['spec'] = tuple(str(s) if s is not None else None
                            for s in spec) or ()
        rec['shard_bytes'] = self._shard_bytes(shape, spec, dtype)
        if dtype is not None:
            rec['dtype'] = _dtype_str(dtype)
        rec['reason'] = reason
        return spec

    def begin_opt_records(self, names):
        """Reset the recorded optimizer leaves for ``names`` (a rebuilt
        step derives them again on the same plan)."""
        for n in names:
            rec = self.records.get(str(n))
            if rec is not None:
                rec.pop('opt_leaves', None)

    def opt_leaf_sharding(self, name, shape, dtype=None):
        """The inspector's ZeRO placement of one optimizer-state leaf: the
        owning parameter's tp spec plus a dp split on the largest
        still-free dp-divisible dim (``zero.zero_partition_spec``),
        recorded with whether the dp split degraded.  (The port's update
        shards every leaf over dp through the padded fused layout,
        ``zero._layout``, whatever this records.)"""
        from .zero import zero_partition_spec
        base = partition_spec(tuple(shape), self.mesh, self.partition,
                              name=name)
        spec = zero_partition_spec(tuple(shape), self.mesh, base=base)
        rec = self.records.setdefault(str(name), {})
        leaves = rec.setdefault('opt_leaves', [])
        spec_t = tuple(str(s) if s is not None else None for s in spec)
        leaves.append({
            'shape': tuple(int(d) for d in shape),
            'spec': spec_t,
            'shard_bytes': self._shard_bytes(shape, spec, dtype),
            'zero_degraded': self.dp > 1 and DP_AXIS not in spec_t,
        })
        return spec

    def degraded_params(self):
        """``[(name, reason)]`` for every parameter whose requested
        tensor-parallel placement fell back to replicated."""
        return [(n, r['reason']) for n, r in sorted(self.records.items())
                if r.get('reason')]

    def note_degraded(self, logger=None):
        """Publish the degradation signal for this plan — ONCE per plan:
        bump ``mesh.degraded_params`` by the number of degraded
        parameters and warn naming them.  No-op when nothing degraded."""
        if self._warned:
            return
        self._warned = True
        bad = self.degraded_params()
        if not bad:
            return
        from .. import instrument
        instrument.inc('mesh.degraded_params', len(bad))
        (logger or logging).warning(
            'mxtpu mesh: %d parameter(s) could not take the requested '
            'tensor-parallel placement and were REPLICATED on mesh %s: '
            '%s — run tools/explain_sharding.py on the plan records '
            'for the per-tensor reasons', len(bad), mesh_sig(self.mesh),
            ', '.join(n for n, _ in bad[:8]) +
            (' ...' if len(bad) > 8 else ''))

    def records_doc(self):
        """The inspector records as one JSON-able document."""
        return {'schema': 'mxtpu-sharding-plan-1',
                'mesh': mesh_sig(self.mesh),
                'partition': self.partition
                if isinstance(self.partition, str)
                else {str(k): str(v) for k, v in self.partition.items()},
                'dp': self.dp, 'tp': self.tp,
                'num_devices': self.num_devices,
                'params': {n: dict(r)
                           for n, r in sorted(self.records.items())}}

    def global_batch(self):
        """The context a rank's training forward and backward run in: over
        more than one dp rank, BatchNorm's statistics and a loss head's
        divisor are the global batch's (:class:`DpBatchStats` under
        ``ops.nn.shared_batch_stats``).  The mirror is refused there: its
        recompute would run the collectives again inside the backward."""
        if self.dp == 1:
            return contextlib.nullcontext()
        from ..base import MXNetError
        from ..executor import mirror_policy
        from ..ops import nn as _nn
        if mirror_policy() is not None:
            raise MXNetError('MXNET_BACKWARD_DO_MIRROR is not supported '
                             'over more than one dp rank of a mesh')
        return _nn.shared_batch_stats(
            DpBatchStats(self.mesh.group(DP_AXIS), self.dp), 0)

    def validate_batch(self, batch_size):
        if int(batch_size) % self.dp != 0:
            raise ValueError(
                'batch size %d is not divisible by the dp mesh axis '
                '(%d): pad the batch or change MXTPU_MESH'
                % (batch_size, self.dp))


class FitShardings(object):
    """What ``make_fit_step(shardings=...)`` consumes: the plan plus the
    per-name specs of the trainable and frozen parameters and the
    per-leaf ZeRO specs of the optimizer state (the inspector's)."""

    __slots__ = ('plan', 'params', 'opt', 'frozen')

    def __init__(self, plan, params, opt, frozen=None):
        self.plan = plan
        self.params = params
        self.opt = opt
        self.frozen = frozen


def make_plan(spec, partition=None) -> ShardingPlan:
    """``(mesh spec, partition policy) -> ShardingPlan`` — the single
    entry Module/BucketingModule use."""
    return ShardingPlan(build_dp_tp_mesh(spec), partition or 'replicated')


def records_for_shapes(shapes, mesh_spec, partition=None,
                       opt_slots=1, itemsize=4):
    """Sharding-inspector records WITHOUT a mesh (no ranks needed): what
    ``Module.fit(mesh=..., partition=...)`` would decide for ``shapes``
    (``{name: shape-tuple}``), by the same rules as the live plan.
    ``opt_slots`` models the optimizer's same-shape state leaves (1 = sgd
    momentum; 2 = adam m+v) for the ZeRO column."""
    from .zero import zero_spec_for
    axes = parse_mesh_spec(mesh_spec)
    dp, tp = axes[DP_AXIS], axes[TP_AXIS]
    partition = partition or 'replicated'

    params = {}
    for name, shape in sorted(shapes.items()):
        shape = tuple(int(d) for d in shape)
        spec, reason = _spec_and_reason(shape, tp, partition, name)
        spec = tuple(str(s) if s is not None else None for s in spec)
        rec = {'shape': shape, 'spec': spec,
               'shard_bytes': _shard_bytes_for(shape, spec, axes,
                                               itemsize),
               'reason': reason, 'opt_leaves': []}
        for _ in range(max(0, int(opt_slots))):
            zspec = tuple(str(s) if s is not None else None for s in
                          zero_spec_for(shape, dp, base=spec))
            rec['opt_leaves'].append({
                'shape': shape, 'spec': zspec,
                'shard_bytes': _shard_bytes_for(shape, zspec, axes,
                                                itemsize),
                'zero_degraded': dp > 1 and DP_AXIS not in zspec})
        params[name] = rec
    return {'schema': 'mxtpu-sharding-plan-1',
            'mesh': '%s=%d,%s=%d' % (DP_AXIS, dp, TP_AXIS, tp),
            'partition': partition if isinstance(partition, str)
            else {str(k): str(v) for k, v in partition.items()},
            'dp': dp, 'tp': tp, 'num_devices': dp * tp,
            'params': params}


class DpBatchStats(object):
    """BatchNorm over the global batch of a dp×tp step: the rank group
    under ``ops.nn.shared_batch_stats``.  At every BatchNorm of the
    training forward (the fused BN ops' stats step too) each rank's
    per-channel sums of x and x² are all-reduced over the dp group in one
    collective, inside autograd (``collectives.psum_grad``: the backward
    all-reduces the incoming gradient, so each rank's backward sees the
    whole batch's); every rank holds the same number of rows, so dividing
    by dp times the local count gives the global E[x] and E[x²].  The tp
    peers of a dp slot hold the same rows and do not join.

    A loss head with ``normalization='batch'`` or ``'valid'`` reads
    :meth:`loss_rows` / :meth:`psum_count` so its divisor is the global
    batch's, not the rank's."""

    def __init__(self, group, dp):
        self.group = group
        self.dp = int(dp)

    def moments(self, index, x32, axes):
        count = 1
        for a in axes:
            count *= x32.shape[a]
        sums = torch.cat([torch.sum(x32, dim=axes),
                          torch.sum(x32 * x32, dim=axes)])
        sums = collectives.psum_grad(sums, self.group)
        total = count * self.dp
        s1, s2 = sums.chunk(2)
        return s1 / total, s2 / total

    def loss_rows(self, rows):
        """The global batch's rows of a loss head whose rank holds
        ``rows``."""
        return rows * self.dp

    def psum_count(self, x):
        """A count (a 0-dim tensor) summed over the dp group."""
        return collectives.psum(x, self.group)
