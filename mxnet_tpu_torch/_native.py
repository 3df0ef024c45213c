"""ctypes bindings of the port's host-side native code: the dependency
engine of ``csrc/host/engine.cc`` (the port's own copy of the JAX
package's ``src/engine.cc``, reached there through
``mxnet_tpu/_native.py:97-110``) and the IO library of
``csrc/host/recordio.cc`` + ``csrc/host/jpeg.cc`` (the copy of
``src/recordio.cc``, ``mxnet_tpu/_native.py:28-90``: RecordIO, the
threaded JPEG decode-and-augment, and JPEG encode).

The libraries are host code, not kernels: each is built with ``g++`` at
first use (never at import) into ``build/mxnet_tpu_torch/``, named by a
hash of its sources and flags, and moved into place with an atomic
rename, so concurrent builds (test workers, child processes) never
load a half-written file.  Both are loaded with ``ctypes.CDLL``, which
releases the GIL around every call, so the decode threads run beside
Python.  The IO library carries its own baseline JPEG codec and links
no image library: a build that fails raises, there is no other decoder.
The pooled host storage of the reference (``src/storage.cc``) is not
part of it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ['engine_lib', 'recordio_lib', 'ENGINE_CALLBACK']

HOST_SRC = Path(__file__).resolve().parent / 'csrc' / 'host'
BUILD_DIR = Path(__file__).resolve().parents[1] / 'build' / 'mxnet_tpu_torch'
_FLAGS = ('-O2', '-std=c++17', '-fPIC', '-Wall', '-shared')
# the JAX package's flags for its IO library (mxnet_tpu/_native.py:22-23),
# so the float arithmetic of the augmenters compiles the same way
_IO_FLAGS = ('-O3', '-std=c++17', '-fPIC', '-Wall', '-shared')
_LIBS = ('-lpthread',)

# the trampoline type: one void* argument, the op's id
ENGINE_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

_lib = None
_io_lib = None
_lock = threading.Lock()


def _build(sources, flags=_FLAGS, headers=()):
    """The shared library of ``sources`` (files under ``csrc/host``, the
    first naming it), built when it is not there yet."""
    sources = (sources,) if isinstance(sources, str) else tuple(sources)
    text = b''.join((HOST_SRC / f).read_bytes()
                    for f in sources + tuple(headers))
    digest = hashlib.sha256(text + ' '.join(flags + _LIBS).encode()) \
        .hexdigest()[:16]
    path = BUILD_DIR / ('lib%s-%s.so' % (Path(sources[0]).stem, digest))
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = '%s.%d.tmp' % (path, os.getpid())
        try:
            subprocess.run(['g++', *flags,
                            *(str(HOST_SRC / f) for f in sources),
                            '-o', tmp, *_LIBS], check=True,
                           capture_output=True, text=True)
        except subprocess.CalledProcessError as e:
            raise RuntimeError('building %s failed:\n%s'
                               % (path.name, e.stderr)) from None
        os.replace(tmp, path)
    return path


def engine_lib():
    """The engine's library, built and loaded at the first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        L = ctypes.CDLL(str(_build('engine.cc')))
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        L.MXTPUTorchEngineCreate.restype = P
        L.MXTPUTorchEngineCreate.argtypes = [I, I]
        L.MXTPUTorchEngineFree.argtypes = [P]
        L.MXTPUTorchEngineFree.restype = None
        L.MXTPUTorchEngineNewVar.restype = P
        L.MXTPUTorchEngineNewVar.argtypes = [P]
        L.MXTPUTorchEngineDelVar.argtypes = [P, P]
        L.MXTPUTorchEngineDelVar.restype = None
        L.MXTPUTorchEngineVarVersion.restype = ctypes.c_uint64
        L.MXTPUTorchEngineVarVersion.argtypes = [P, P]
        L.MXTPUTorchEnginePushAsync.argtypes = [
            P, ENGINE_CALLBACK, P, ctypes.POINTER(P), I,
            ctypes.POINTER(P), I, I, ctypes.c_char_p]
        L.MXTPUTorchEnginePushAsync.restype = None
        L.MXTPUTorchEngineWaitForVar.argtypes = [P, P, LL]
        L.MXTPUTorchEngineWaitForVar.restype = I
        L.MXTPUTorchEngineWaitForAll.argtypes = [P, LL]
        L.MXTPUTorchEngineWaitForAll.restype = I
        L.MXTPUTorchEngineShutdown.argtypes = [P]
        L.MXTPUTorchEngineShutdown.restype = None
        L.MXTPUTorchEngineSetProfiling.argtypes = [P, I]
        L.MXTPUTorchEngineSetProfiling.restype = None
        L.MXTPUTorchEngineDumpProfile.restype = I
        L.MXTPUTorchEngineDumpProfile.argtypes = [P, ctypes.c_char_p]
        _lib = L
        return L


def recordio_lib():
    """The IO library (RecordIO, JPEG decode-and-augment, JPEG encode),
    built and loaded at the first call."""
    global _io_lib
    with _lock:
        if _io_lib is not None:
            return _io_lib
        L = ctypes.CDLL(str(_build(('recordio.cc', 'jpeg.cc'), _IO_FLAGS,
                                   headers=('jpeg.h',))))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        S, C = ctypes.c_size_t, ctypes.c_char_p
        L.MXTPUTorchRecordIOWriterCreate.restype = P
        L.MXTPUTorchRecordIOWriterCreate.argtypes = [C]
        L.MXTPUTorchRecordIOWriterTell.restype = ctypes.c_long
        L.MXTPUTorchRecordIOWriterTell.argtypes = [P]
        L.MXTPUTorchRecordIOWriterWrite.restype = I
        L.MXTPUTorchRecordIOWriterWrite.argtypes = [P, C, S]
        L.MXTPUTorchRecordIOWriterFree.argtypes = [P]
        L.MXTPUTorchRecordIOWriterFree.restype = None
        L.MXTPUTorchRecordIOReaderCreate.restype = P
        L.MXTPUTorchRecordIOReaderCreate.argtypes = [C]
        L.MXTPUTorchRecordIOReaderNext.restype = ctypes.POINTER(ctypes.c_char)
        L.MXTPUTorchRecordIOReaderNext.argtypes = [P, ctypes.POINTER(S)]
        L.MXTPUTorchRecordIOReaderSeek.argtypes = [P, ctypes.c_long]
        L.MXTPUTorchRecordIOReaderSeek.restype = None
        L.MXTPUTorchRecordIOReaderTell.restype = ctypes.c_long
        L.MXTPUTorchRecordIOReaderTell.argtypes = [P]
        L.MXTPUTorchRecordIOReaderFree.argtypes = [P]
        L.MXTPUTorchRecordIOReaderFree.restype = None
        L.MXTPUTorchDecodeBatchEx.restype = I
        L.MXTPUTorchDecodeBatchEx.argtypes = [
            ctypes.POINTER(P),                  # jpegs
            ctypes.POINTER(S),                  # sizes
            I,                                  # n
            ctypes.POINTER(F),                  # out
            I, I,                               # out_h, out_w
            I, I,                               # rand_crop, rand_mirror
            F, F, F,                            # mean rgb
            F, F, F,                            # std rgb
            F, F,                               # max/min random scale
            F, F,                               # max_rotate_angle, shear
            F,                                  # max_aspect_ratio
            I, I,                               # min/max_crop_size
            F, F, F,                            # random h/s/l
            ctypes.c_uint64, I,                 # seed, nthreads
            C, I]                               # err, err_len
        L.MXTPUTorchJpegInfo.restype = I
        L.MXTPUTorchJpegInfo.argtypes = [
            C, S, ctypes.POINTER(I), ctypes.POINTER(I), ctypes.POINTER(I),
            C, I]
        L.MXTPUTorchJpegDecode.restype = I
        L.MXTPUTorchJpegDecode.argtypes = [C, S, I, P, S, C, I]
        L.MXTPUTorchJpegEncode.restype = I
        L.MXTPUTorchJpegEncode.argtypes = [
            P, I, I, I, I, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(S), C, I]
        L.MXTPUTorchJpegFree.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        L.MXTPUTorchJpegFree.restype = None
        _io_lib = L
        return L
