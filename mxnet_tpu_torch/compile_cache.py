"""Warm start and the pow2 shape policy of ``mxnet_tpu/compile_cache.py``
(``warm_start :341``, ``pad_to_bucket :365``).

PyTorch runs eagerly, so there is no compiled program per shape to
cache: :func:`warm_start` builds each module's fused step (and, on the
card, loads the kernel libraries it launches) before the first batch,
with no persistent cache and no warmup manifest.  Whole-step capture
(one CUDA graph per bucket and batch signature) is what will fill those
in.  The serving path keeps the pow2 policy, so the port serves the same
batch shapes as the JAX package.
"""
from __future__ import annotations

__all__ = ['pad_to_bucket', 'warm_start']


def warm_start(module, eval_metric=None, data_iter=None):
    """Entry point of ``fit(warm_start=True)``: the module's
    ``_warm_start`` hook (``Module``, ``BucketingModule``).  Modules
    without the hook warm nothing.  ``data_iter`` is taken for the JAX
    signature, whose hook reads the batch dtypes from it to key compiled
    programs; an eager step has none to key."""
    hook = getattr(module, '_warm_start', None)
    if hook is not None:
        hook(eval_metric)


def pad_to_bucket(n):
    """Smallest power of two >= ``n``."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()
