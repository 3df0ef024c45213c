"""URI filesystem layer — the port's copy of ``mxnet_tpu/fs.py``, in the
role of the reference's dmlc-core URI streams (``USE_S3``/``USE_HDFS``
build flags, ``make/config.mk:136-144``,
``dmlc::Stream::Create('s3://...')``): RecordIO files, checkpoints and
NDArray blobs addressable as ``s3://``, ``hdfs://``, ``gs://``,
``http(s)://`` or plain local paths.

Remote access rides ``fsspec`` (present in the image; the concrete
protocol backends — s3fs, gcsfs, pyarrow-hdfs — are optional runtime
dependencies exactly as libs3/libhdfs were optional link deps in the
reference).  The native RecordIO reader/writer works on LOCAL files
(mmap-free sequential C IO, ``csrc/host/recordio.cc``); remote URIs are
staged through a local cache on read and uploaded on close for write —
the same spool model dmlc's S3 WriteStream used (whole-object PUT on
close).
"""
from __future__ import annotations

import os
import shutil
import tempfile

import re

_SCHEME_RE = re.compile(r'^[a-zA-Z][a-zA-Z0-9+.-]*://')


def is_remote(uri) -> bool:
    """True when ``uri`` names a non-local filesystem object (any
    ``scheme://`` except ``file://`` — s3, hdfs, gs, http(s), memory,
    ...; the set of workable schemes is fsspec's registry, exactly as
    dmlc-core's was its compiled-in stream factories)."""
    if not isinstance(uri, str):
        return False
    if uri.startswith('file://'):
        return False
    return bool(_SCHEME_RE.match(uri))


def _fsspec():
    try:
        import fsspec
    except ImportError as e:  # pragma: no cover - fsspec is in the image
        raise IOError(
            'remote URI support needs fsspec (pip install fsspec plus '
            'the protocol backend, e.g. s3fs for s3://)') from e
    return fsspec


def open_uri(uri, mode='rb'):
    """Open a local path or remote URI as a file object."""
    if not is_remote(uri):
        if isinstance(uri, str) and uri.startswith('file://'):
            uri = uri[len('file://'):]
        return open(uri, mode)
    return _fsspec().open(uri, mode).open()


def cache_dir():
    d = os.environ.get('MXTPU_FS_CACHE',
                       os.path.join(tempfile.gettempdir(),
                                    'mxtpu_fs_cache'))
    os.makedirs(d, exist_ok=True)
    return d


def localize(uri) -> str:
    """A local path holding ``uri``'s bytes: local paths pass through;
    remote objects download into the cache (keyed by URI hash +
    basename).  Freshness: when the remote filesystem reports an
    object size, a cached entry with a DIFFERENT size is re-fetched
    (an overwritten remote dataset must not train on stale bytes);
    ``MXTPU_FS_CACHE_REFRESH=1`` forces a re-download unconditionally.
    """
    if not is_remote(uri):
        return uri
    import hashlib
    key = hashlib.sha1(uri.encode()).hexdigest()[:16]
    local = os.path.join(cache_dir(),
                         '%s_%s' % (key, os.path.basename(uri) or 'obj'))
    fresh = os.path.exists(local)
    if fresh and os.environ.get('MXTPU_FS_CACHE_REFRESH') == '1':
        fresh = False
    if fresh:
        try:
            size = _fsspec().filesystem(
                uri.split('://', 1)[0]).info(uri).get('size')
            if size is not None and size != os.path.getsize(local):
                fresh = False
        except Exception:
            pass        # size unknown: keep the cached copy
    if not fresh:
        # unique tmp per download: concurrent localize() of one URI
        # from several threads must not interleave into one file
        fd, tmp = tempfile.mkstemp(dir=cache_dir(),
                                   prefix=key + '.part.')
        try:
            with open_uri(uri, 'rb') as src, \
                    os.fdopen(fd, 'wb') as dst:
                shutil.copyfileobj(src, dst, 1 << 20)
            os.replace(tmp, local)      # atomic: no torn cache entry
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
    return local


class SpooledWriter(object):
    """Write locally, upload to the remote URI on close (dmlc S3
    WriteStream semantics: the object appears atomically at close)."""

    def __init__(self, uri):
        self.uri = uri
        fd, self.local = tempfile.mkstemp(
            dir=cache_dir(), suffix='_' + (os.path.basename(uri) or 'w'))
        os.close(fd)
        self.closed = False

    def upload_and_close(self):
        if self.closed:
            return
        with open(self.local, 'rb') as src, \
                open_uri(self.uri, 'wb') as dst:
            shutil.copyfileobj(src, dst, 1 << 20)
        os.remove(self.local)
        self.closed = True
