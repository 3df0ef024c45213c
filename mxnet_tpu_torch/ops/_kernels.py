"""Build and load the port's hand-written CUDA kernels.

The counterpart of ``mxnet_tpu/ops/_caps.py``: where the JAX package
probes what the installed Mosaic can compile, the port compiles its
kernels itself.  Each ``csrc/*.cu`` source has a plain C entry point and
is built at first use with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/mxnet_tpu_torch/`` of the checkout, named by the hash of
its source, the shared headers (``csrc/*.cuh``) and the flags, its own
link flags included (an edited source rebuilds), then bound with
``ctypes``.  ``csrc/rtc.cu``, the NVRTC bridge of ``rtc.py``, is a
library of several entry points (``LIBRARIES``), which ``rtc.py`` binds
from :func:`library`; it links NVRTC and the CUDA driver API (libcuda
from the toolkit's stubs at link time, the installed one at run time).
Nothing here runs at import: the CPU tests import every module on hosts
without ``nvcc``.

A failed build raises :class:`KernelBuildError` with nvcc's output;
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..base import MXNetError

__all__ = ['KernelBuildError', 'build', 'load', 'library', 'error_string',
           'cuda_home', 'build_seconds', 'build_logs', 'NVCC_FLAGS',
           'KERNELS', 'LIBRARIES']

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'mxnet_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
# kernel name -> (source under csrc/, C entry point, its argtypes)
KERNELS = {
    'fused_bn_relu': ('fused_bn_relu.cu', 'mxtpu_fused_bn_relu',
                      (_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _P)),
    # x, w, scale, bias, y, M, N, K, relu, dtype, stream
    'fused_scale_bias_dot': ('fused_scale_bias_dot.cu',
                             'mxtpu_fused_scale_bias_dot',
                             (_P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _I,
                              _P)),
    # x, w, scale, bias, y, N, H, W, C, F, OH, OW, stride, relu, dtype,
    # stream
    'fused_scale_bias_conv3x3': ('fused_scale_bias_conv3x3.cu',
                                 'mxtpu_fused_scale_bias_conv3x3',
                                 (_P, _P, _P, _P, _P, _LL, _LL, _LL, _LL,
                                  _LL, _LL, _LL, _I, _I, _I, _P)),
    # x, w (N, K), bias or NULL, y, M, N, K, relu, has_clip, lo, hi,
    # dtype, stream
    'fused_dot_epilogue': ('fused_dot_epilogue.cu',
                           'mxtpu_fused_dot_epilogue',
                           (_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _F, _F,
                            _I, _P)),
    # q, k, v, o, lse, BH, Tq, Tk, D, scale, causal, dtype, stream
    'flash_attention': ('flash_attention.cu', 'mxtpu_flash_attention',
                        (_P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _F, _I, _I,
                         _P)),
}
# library name -> (source under csrc/, link libraries): a shim with several
# entry points, which its module binds from library() (rtc.py)
LIBRARIES = {'rtc': ('rtc.cu', ('-lnvrtc', '-lcuda'))}

build_seconds = {}      # kernel name -> wall seconds of its nvcc run
build_logs = {}         # kernel name -> nvcc's output (ptxas -v report)
_loaded = {}            # kernel or library name -> CDLL
_lock = threading.Lock()


class KernelBuildError(MXNetError):
    """nvcc is missing or refused a kernel source."""


def _nvcc():
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    for cand in ([os.path.join(home, 'bin', 'nvcc')] if home else []) + \
            ['/usr/local/cuda/bin/nvcc', shutil.which('nvcc')]:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError('nvcc not found (set CUDA_HOME); the CUDA '
                           'kernels build on a host with the CUDA toolkit')


def cuda_home():
    """The CUDA toolkit's root: the directory above nvcc's ``bin``."""
    return Path(_nvcc()).resolve().parents[1]


def _source(name):
    """(source under csrc/, link libraries) of a kernel or a library."""
    return LIBRARIES[name] if name in LIBRARIES else (KERNELS[name][0], ())


def _link_flags(name):
    """The link flags of ``name``: its libraries, the toolkit's lib64
    (also as the run path, where libnvrtc lives) and its stubs (libcuda
    at link time; the installed libcuda.so.1 loads at run time)."""
    libs = list(_source(name)[1])
    if not libs:
        return []
    lib64 = cuda_home() / 'lib64'
    return libs + ['-L%s' % lib64, '-L%s' % (lib64 / 'stubs'),
                   '-Xlinker', '-rpath=%s' % lib64]


def _lib_path(name):
    source, libs = _source(name)
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.read_bytes())
    h.update(' '.join(NVCC_FLAGS + libs).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / ('lib%s-%s.so' % (name, digest))


def build(names=None):
    """Compile the named kernels and libraries (default: all) that are
    not built yet, one ``nvcc`` process per source, all started together.
    Returns ``{name: library path}``; raises :class:`KernelBuildError`
    when a build fails."""
    names = list(KERNELS) + list(LIBRARIES) if names is None \
        else list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix('.%d.tmp' % os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / _source(n)[0]),
               *_link_flags(n)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.monotonic())
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        build_seconds[n] = time.monotonic() - t0
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append('%s (exit %d):\n%s' % (n, proc.returncode, out))
            continue
        # atomic rename: a concurrent loader never sees a partial library
        os.replace(tmp, paths[n])
    if failed:
        raise KernelBuildError('nvcc failed for ' + '\n'.join(failed))
    return paths


def library(name):
    """The loaded ``ctypes.CDLL`` of kernel or library ``name``, built on
    first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
            if name in KERNELS:
                fn = getattr(lib, KERNELS[name][1])
                fn.argtypes = list(KERNELS[name][2])
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def load(name):
    """The ctypes entry point of kernel ``name``, built on first use."""
    return getattr(library(name), KERNELS[name][1])


def error_string(name, err):
    """cudaGetErrorString of ``err`` as seen by kernel ``name``'s runtime."""
    return library(name).mxtpu_cuda_error_string(int(err)).decode()
