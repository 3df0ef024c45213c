"""The pow2 shape policy of ``mxnet_tpu/compile_cache.py`` (``:365``).

PyTorch runs eagerly, so there is no compiled program per shape to
cache; the serving path keeps the policy anyway, so the port serves the
same batch shapes as the JAX package and a later slice can capture one
CUDA graph per bucket.
"""
from __future__ import annotations

__all__ = ['pad_to_bucket']


def pad_to_bucket(n):
    """Smallest power of two >= ``n``."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()
