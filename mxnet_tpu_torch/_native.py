"""ctypes binding of the port's host-side native code: the dependency
engine of ``csrc/host/engine.cc`` (the port's own copy of the JAX
package's ``src/engine.cc``, reached there through
``mxnet_tpu/_native.py:97-110``).

The library is host code, not a kernel: it is built with ``g++`` at
first use (never at import) into ``build/mxnet_tpu_torch/``, named by a
hash of its source and flags, and moved into place with an atomic
rename, so concurrent builds (test workers, child processes) never
load a half-written file.  The pooled host storage of the reference
(``src/storage.cc``) is not part of it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ['engine_lib', 'ENGINE_CALLBACK']

HOST_SRC = Path(__file__).resolve().parent / 'csrc' / 'host'
BUILD_DIR = Path(__file__).resolve().parents[1] / 'build' / 'mxnet_tpu_torch'
_FLAGS = ('-O2', '-std=c++17', '-fPIC', '-Wall', '-shared')
_LIBS = ('-lpthread',)

# the trampoline type: one void* argument, the op's id
ENGINE_CALLBACK = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

_lib = None
_lock = threading.Lock()


def _build(source):
    """The shared library of ``source`` (a file under ``csrc/host``),
    built when it is not there yet."""
    text = (HOST_SRC / source).read_bytes()
    digest = hashlib.sha256(text + ' '.join(_FLAGS + _LIBS).encode()) \
        .hexdigest()[:16]
    path = BUILD_DIR / ('lib%s-%s.so' % (Path(source).stem, digest))
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = '%s.%d.tmp' % (path, os.getpid())
        subprocess.check_call(['g++', *_FLAGS, str(HOST_SRC / source),
                               '-o', tmp, *_LIBS])
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
