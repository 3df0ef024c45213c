"""Capability probes for the parallel legs — the port of
``mxnet_tpu/parallel/compat.py``.  The reference probes jax for
``shard_map`` and for cross-process collectives on the CPU backend; the
port's collectives are ``torch.distributed``, so the probes ask torch:
is ``torch.distributed`` built in, is gloo (the CPU backend, and the one
two ranks on one card share) there, is NCCL (one rank per card) there.
Each probe returns None when the capability is present, else the reason
it is missing, so a test can skip naming it::

    from .compat import multiprocess_cpu_missing
    reason = multiprocess_cpu_missing()     # None: gloo ranks will work
"""
from __future__ import annotations

__all__ = ['DISTRIBUTED_ERROR', 'require_distributed',
           'multiprocess_cpu_missing', 'nccl_missing']


def _probe():
    try:
        import torch.distributed as dist
    except Exception as exc:  # pragma: no cover - depends on the build
        return '%s: %s' % (type(exc).__name__, exc)
    if not dist.is_available():
        return 'this torch build has no torch.distributed'
    return None


# why torch.distributed is unavailable (None when it is available)
DISTRIBUTED_ERROR = _probe()


def require_distributed():
    """``torch.distributed`` or an ImportError naming why there is none
    (the reference's ``require_shard_map``)."""
    if DISTRIBUTED_ERROR is not None:
        raise ImportError('torch.distributed is unavailable (%s); the '
                          'dist kvstores and the sp step need it'
                          % DISTRIBUTED_ERROR)
    import torch.distributed as dist
    return dist


def multiprocess_cpu_missing():
    """Why ranks of several processes cannot run collectives on the CPU
    (no gloo backend in this torch), or None when they can: the probe
    behind the dist_sync tests' skips.  Static: no group is made and no
    process forked."""
    if DISTRIBUTED_ERROR is not None:
        return DISTRIBUTED_ERROR
    import torch.distributed as dist
    if not dist.is_gloo_available():
        return 'this torch build lacks the gloo backend'
    return None


def nccl_missing():
    """Why a rank cannot reduce over NCCL here (no NCCL in this torch, or
    no CUDA device), or None when it can."""
    if DISTRIBUTED_ERROR is not None:
        return DISTRIBUTED_ERROR
    import torch
    import torch.distributed as dist
    if not dist.is_nccl_available():
        return 'this torch build lacks the NCCL backend'
    if not torch.cuda.is_available():
        return 'no CUDA device'
    return None
