"""Collectives — the communication backend of the dist kvstores, on
``torch.distributed`` (the port of ``mxnet_tpu/parallel/collectives.py``,
whose collectives are XLA's).

:func:`init_distributed` reads the ``MXTPU_*`` contract that
``tools/launch.py`` publishes (``MXTPU_COORDINATOR``,
``MXTPU_NUM_PROCESSES``, ``MXTPU_PROCESS_ID``) and joins the job's
default group over a TCP rendezvous at the coordinator.  The default
group is gloo: it holds the barrier and every CPU collective.  When each
rank of a host holds a card of its own, an NCCL group of the same ranks
carries the CUDA collectives; ranks that share a card cannot use NCCL
(it refuses two ranks on one device), so they reduce their CUDA tensors
over gloo.  The log line of the join names the backend chosen.

The host-level helpers are what the kvstore needs: :func:`allreduce_hosts`
(one tensor), :func:`allreduce_hosts_batch` (one flat buffer, one
collective per dtype and device for a whole push group) and
:func:`host_barrier`.

The reference's in-program collectives (``psum``, ``all_gather``,
``psum_scatter``) are XLA's, placed by the SPMD partitioner inside the
compiled step.  Here they are calls on a sub-group of the job (a mesh
axis, ``parallel/mesh.py``), made by the step itself: :func:`psum` (an
all-reduce), :func:`psum_grad` (the same inside autograd: its backward
all-reduces the incoming gradient, so every rank's backward sees the whole
group's), :func:`reduce_scatter` (``dist.reduce_scatter_tensor``) and
:func:`all_gather` (``dist.all_gather_single`` where this torch has it,
else ``dist.all_gather_into_tensor``).  Ranks that share a card run them
over gloo on the CUDA tensors themselves; a build of gloo that refuses
CUDA tensors for one of them raises.  Every collective issued here, and
the batched all-reduce, is counted by the communication plane
(``commwatch.note_collective``: kind, payload bytes, group size) where
the port issues it.  ``ppermute`` stays with the pipeline, its only user.
Nothing here runs at import.
"""
from __future__ import annotations

import datetime
import logging
import socket
import time

import torch

from .. import commwatch, config

__all__ = ['init_distributed', 'is_initialized', 'rank', 'world_size',
           'allreduce_hosts', 'allreduce_hosts_batch',
           'host_barrier', 'group_size', 'psum', 'psum_grad',
           'reduce_scatter', 'all_gather', 'broadcast']

# the NCCL group of the default group's ranks, when every rank of a host
# has a card of its own (None: CUDA tensors reduce over gloo)
_nccl_group = None
_backend_name = None


def _dist():
    from .compat import require_distributed
    return require_distributed()


def is_initialized():
    from .compat import DISTRIBUTED_ERROR
    if DISTRIBUTED_ERROR is not None:
        return False
    import torch.distributed as dist
    return dist.is_initialized()


def rank():
    return _dist().get_rank() if is_initialized() else 0


def world_size():
    return _dist().get_world_size() if is_initialized() else 1


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, timeout=None):
    """Join the job (replaces ps-lite's Postoffice and the tracker's
    ``DMLC_*`` environment, reference ``tools/launch.py``).  Arguments
    default to the launcher's ``MXTPU_COORDINATOR``,
    ``MXTPU_NUM_PROCESSES`` and ``MXTPU_PROCESS_ID``.  A job of one
    process with no coordinator joins nothing (rank 0 of 1).  Returns the
    backend the CUDA collectives use: 'nccl', 'gloo', or None."""
    global _nccl_group, _backend_name
    dist = _dist()
    if dist.is_initialized():
        return _backend_name
    if coordinator_address is None:
        coordinator_address = config.get('MXTPU_COORDINATOR') or None
    if num_processes is None:
        num_processes = config.get('MXTPU_NUM_PROCESSES')
    if process_id is None:
        process_id = config.get('MXTPU_PROCESS_ID')
    if coordinator_address is None:
        if int(num_processes) > 1:
            raise RuntimeError(
                '%d processes but no coordinator: launch the workers with '
                'tools/launch.py (MXTPU_COORDINATOR)' % num_processes)
        return None
    if timeout is None:
        timeout = config.get('MXTPU_KV_BARRIER_TIMEOUT')
    dist.init_process_group(
        'gloo', init_method='tcp://%s' % coordinator_address,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout)))
    # one card per rank on every host -> NCCL for the CUDA collectives
    mine = (socket.gethostname(),
            torch.cuda.device_count() if torch.cuda.is_available() else 0)
    seats = [None] * dist.get_world_size()
    dist.all_gather_object(seats, mine)
    per_host = {}
    for host, cards in seats:
        per_host.setdefault(host, [0, cards])[0] += 1
    from .compat import nccl_missing
    own_card = all(0 < n <= cards for n, cards in per_host.values())
    if own_card and nccl_missing() is None:
        _nccl_group = dist.new_group(backend='nccl')
        _backend_name = 'nccl'
    else:
        _nccl_group = None
        _backend_name = 'gloo' if mine[1] else None
    logging.info(
        'mxnet_tpu_torch: rank %d of %d joined at %s; CPU collectives on '
        'gloo, CUDA collectives on %s', dist.get_rank(),
        dist.get_world_size(), coordinator_address,
        {'nccl': 'NCCL (one card per rank)',
         'gloo': 'gloo (ranks share a card)'}.get(_backend_name,
                                                  'none (no card)'))
    return _backend_name


def _group_for(t):
    return _nccl_group if t.is_cuda and _nccl_group is not None else None


def allreduce_hosts(x):
    """Sum a tensor across processes (the dist_sync push,
    ``kvstore_dist_server.h:179-197``: the update runs only after every
    worker's push is aggregated).  Returns a new tensor on ``x``'s
    device; ``x`` is left as it was.  One process: ``x`` itself."""
    if world_size() == 1:
        return x
    out = x.detach().clone().contiguous()
    _dist().all_reduce(out, group=_group_for(out))
    return out


def _flat_groups(tensors):
    """``(indices, flat buffer)`` for each (dtype, device) of ``tensors``:
    the one buffer a batched collective runs on."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idxs in groups.values():
        yield idxs, torch.cat([tensors[i].detach().reshape(-1)
                               for i in idxs])


def _cut(flat, tensors, idxs):
    """``(index, view of flat)`` for each of ``idxs``: the flat buffer
    cut back into ``tensors``' shapes."""
    off = 0
    for i in idxs:
        n = tensors[i].numel()
        yield i, flat[off:off + n].view(tensors[i].shape)
        off += n


def allreduce_hosts_batch(arrays, group=None):
    """Sum a LIST of tensors over ``group`` (None: every process) with one
    collective per (dtype, device) group: the group is concatenated into
    one flat buffer, reduced, and cut back.  The reference batches the
    long tail of small keys the same way (``kvstore_dist.h:277-299``,
    MXNET_KVSTORE_BIGARRAY_BOUND): a ResNet's ~160 small tensors cost one
    collective, not 160.  Returns new tensors; one rank: ``arrays``."""
    arrays = list(arrays)
    if group_size(group) == 1:
        return arrays
    out = [None] * len(arrays)
    for idxs, flat in _flat_groups(arrays):
        _issue('all-reduce', _all_reduce_op, flat, flat,
               group if group is not None else _group_for(flat),
               flat.numel() * flat.element_size())
        for i, view in _cut(flat, arrays, idxs):
            out[i] = view
    return out


def host_barrier():
    """Barrier across processes (``KVStore::Barrier``, kvstore.h)."""
    if world_size() == 1:
        return
    _dist().barrier()


# ---------------------------------------------------------------------------
# In-step collectives on a sub-group (a mesh axis)
# ---------------------------------------------------------------------------

def group_size(group):
    """Ranks in ``group`` (None: the whole job)."""
    return _dist().get_world_size(group) if is_initialized() else 1


def _issue(kind, op, out, inp, group, nbytes):
    """Run ``op(out, inp, group)``, counted and, with the communication
    plane on, timed (the card synchronised first, so the time is the
    collective's and not the compute queued before it)."""
    timing = commwatch.enabled()
    if timing:
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        t0 = time.perf_counter()
    op(out, inp, group)
    seconds = None
    if timing:
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        seconds = time.perf_counter() - t0
    commwatch.note_collective(kind, nbytes, group_size(group), seconds)
    return out


def _all_reduce_op(out, inp, group):
    _dist().all_reduce(out, group=group)


def psum(x, group=None):
    """The sum of ``x`` over the ranks of ``group`` (``lax.psum``): a new
    tensor; ``x`` is left as it was.  One rank: a copy."""
    out = x.detach().clone().contiguous()
    if group_size(group) == 1:
        return out
    return _issue('all-reduce', _all_reduce_op, out, out, group,
                  out.numel() * out.element_size())


class _PsumGrad(torch.autograd.Function):
    """An all-reduce whose backward all-reduces the incoming gradient: the
    gradient of every rank's loss through the summed value reaches each
    rank's own input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


def psum_grad(x, group=None):
    """:func:`psum` that autograd differentiates (the cross-rank sums of
    a BatchNorm over the global batch)."""
    if group_size(group) == 1:
        return x
    return _PsumGrad.apply(x, group)


def _reduce_scatter_op(out, inp, group):
    _dist().reduce_scatter_tensor(out, inp, group=group)


def reduce_scatter(x, group=None):
    """``lax.psum_scatter(tiled=True)`` over dim 0: ``x`` (n * k, ...) is
    summed over the n ranks of ``group`` and rank i keeps rows
    [i * k, (i + 1) * k) of the sum."""
    n = group_size(group)
    x = x.detach().contiguous()
    if n == 1:
        return x.clone()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return _issue('reduce-scatter', _reduce_scatter_op, out, x, group,
                  out.numel() * out.element_size())


def _all_gather_op(out, inp, group):
    fn = getattr(_dist(), 'all_gather_single', None) or \
        _dist().all_gather_into_tensor
    fn(out, inp, group=group)


def all_gather(x, group=None):
    """``lax.all_gather(tiled=True)`` over dim 0: the ranks' ``x``
    concatenated in rank order."""
    n = group_size(group)
    x = x.detach().contiguous()
    if n == 1:
        return x.clone()
    out = torch.empty((x.shape[0] * n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return _issue('all-gather', _all_gather_op, out, x, group,
                  out.numel() * out.element_size())


def broadcast(tensors, src=0, group=None):
    """Overwrite ``tensors`` with rank ``src``'s (``src`` a rank of the
    job), one flat buffer per (dtype, device)."""
    if group_size(group) == 1:
        return
    for idxs, flat in _flat_groups(tensors):
        _dist().broadcast(flat, src=src, group=group)
        with torch.no_grad():
            for i, view in _cut(flat, tensors, idxs):
                tensors[i].copy_(view)
