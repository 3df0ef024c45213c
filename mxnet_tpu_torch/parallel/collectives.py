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
:func:`host_barrier`.  The reference's in-program collectives (``psum``,
``all_gather``, ``psum_scatter``, ``ppermute``) come with the mesh, their
first caller.  Nothing here runs at import.
"""
from __future__ import annotations

import datetime
import logging
import socket

import torch

from .. import config

__all__ = ['init_distributed', 'is_initialized', 'rank', 'world_size',
           'allreduce_hosts', 'allreduce_hosts_batch',
           'host_barrier']

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


def allreduce_hosts_batch(arrays):
    """Sum a LIST of tensors across processes with one collective per
    (dtype, device) group: the group is concatenated into one flat
    buffer, reduced, and cut back.  The reference batches the long tail
    of small keys the same way (``kvstore_dist.h:277-299``,
    MXNET_KVSTORE_BIGARRAY_BOUND): a ResNet's ~160 small tensors cost one
    collective, not 160."""
    arrays = list(arrays)
    if world_size() == 1 or len(arrays) <= 1:
        return [allreduce_hosts(a) for a in arrays]
    out = [None] * len(arrays)
    groups = {}
    for i, a in enumerate(arrays):
        groups.setdefault((a.dtype, a.device), []).append(i)
    for idxs in groups.values():
        flat = torch.cat([arrays[i].detach().reshape(-1) for i in idxs])
        _dist().all_reduce(flat, group=_group_for(flat))
        off = 0
        for i in idxs:
            n = arrays[i].numel()
            out[i] = flat[off:off + n].view(arrays[i].shape)
            off += n
    return out


def host_barrier():
    """Barrier across processes (``KVStore::Barrier``, kvstore.h)."""
    if world_size() == 1:
        return
    _dist().barrier()
