"""Atomic file commits — the port of ``mxnet_tpu/resilience.py``'s
``atomic_replace`` (``:182``), through which every checkpoint file
(``-symbol.json``, ``.params``, ``.states``) is written.

The reference module's retry policies, fault injection and last-breath
hooks belong to the distributed plane and are not ported.
"""
from __future__ import annotations

import contextlib
import os
import tempfile

__all__ = ['atomic_replace']


def _process_umask():
    mask = os.umask(0)
    os.umask(mask)
    return mask


@contextlib.contextmanager
def atomic_replace(path):
    """Yield a temp path in ``path``'s directory; on a clean exit fsync
    it, ``os.replace`` it over ``path`` and fsync the directory.  The
    file either commits whole or the previous one survives: an error (or
    a kill) inside the block leaves ``path`` as it was and removes the
    temp file where it can.  The target keeps its mode (or the umask's
    default)."""
    if path.startswith('file://'):
        path = path[len('file://'):]
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d,
                               prefix=os.path.basename(path) + '.tmp.')
    os.close(fd)
    try:
        mode = os.stat(path).st_mode & 0o7777
    except OSError:
        mode = 0o666 & ~_process_umask()
    try:
        os.chmod(tmp, mode)
    except OSError:
        pass
    try:
        yield tmp
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
