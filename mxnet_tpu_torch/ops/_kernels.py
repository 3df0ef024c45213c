"""Build and load the port's hand-written CUDA kernels.

The counterpart of ``mxnet_tpu/ops/_caps.py``: where the JAX package
probes what the installed Mosaic can compile, the port compiles its
kernels itself.  Each ``csrc/*.cu`` source has plain C entry points and
is built at first use with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/mxnet_tpu_torch/`` of the checkout, named by the hash of
its source, the shared headers (``csrc/*.cuh``) and the flags, its own
link flags included (an edited source rebuilds), then bound with
``ctypes``.  One table, ``KERNELS``, names each source, its entry points
and the libraries it links: the sm90 routes of the GEMM, convolution and
attention kernels link the CUDA driver API (``cuTensorMapEncodeTiled``,
``cuTensorMapEncodeIm2col``), ``csrc/rtc.cu`` (the NVRTC
bridge, whose entry points ``rtc.py`` binds itself from
:func:`library`) NVRTC and the driver API; ``csrc/multibox_nms.cu``
(SSD's greedy NMS, a kernel the JAX package computes in a loop) links
nothing; libcuda comes from the
toolkit's stubs at link time and the installed one at run time.
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
from typing import NamedTuple

from ..base import MXNetError

__all__ = ['KernelBuildError', 'build', 'load', 'library', 'error_string',
           'cuda_home', 'build_seconds', 'build_logs', 'NVCC_FLAGS',
           'KERNELS', 'Kernel']

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'mxnet_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float


class Kernel(NamedTuple):
    """A source under csrc/, its C entry points (name -> argtypes; the
    first is the default of :func:`load`, none for a library whose module
    binds its own) and the libraries it links."""
    source: str
    entries: dict
    libs: tuple = ()


_DRIVER = ('-lcuda',)
KERNELS = {
    'fused_bn_relu': Kernel('fused_bn_relu.cu', {
        'mxtpu_fused_bn_relu': (_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _P)}),
    'fused_scale_bias_dot': Kernel('fused_scale_bias_dot.cu', {
        # x, w (K, N), scale, bias, y, M, N, K, relu, dtype, stream
        'mxtpu_fused_scale_bias_dot': (_P, _P, _P, _P, _P, _LL, _LL, _LL,
                                       _I, _I, _P),
        # x, w (N, K), scale, bias, y, M, N, K, relu, bn, stages, grid,
        # stream
        'mxtpu_fused_scale_bias_dot_sm90': (_P, _P, _P, _P, _P, _LL, _LL,
                                            _LL, _I, _I, _I, _I, _P)},
        _DRIVER),
    'fused_scale_bias_conv3x3': Kernel('fused_scale_bias_conv3x3.cu', {
        # x, w, scale, bias, y, N, H, W, C, F, OH, OW, stride, relu,
        # dtype, stream
        'mxtpu_fused_scale_bias_conv3x3': (_P, _P, _P, _P, _P, _LL, _LL,
                                           _LL, _LL, _LL, _LL, _LL, _I, _I,
                                           _I, _P),
        # x, w (F, 9C), scale, bias, y, N, H, W, C, F, OH, OW, stride,
        # relu, bn, stages, grid, stream
        'mxtpu_fused_scale_bias_conv3x3_sm90': (_P, _P, _P, _P, _P, _LL,
                                                _LL, _LL, _LL, _LL, _LL,
                                                _LL, _I, _I, _I, _I, _I,
                                                _P)},
        _DRIVER),
    'fused_dot_epilogue': Kernel('fused_dot_epilogue.cu', {
        # x, w (N, K), bias or NULL, y, M, N, K, relu, has_clip, lo, hi,
        # dtype, stream
        'mxtpu_fused_dot_epilogue': (_P, _P, _P, _P, _LL, _LL, _LL, _I, _I,
                                     _F, _F, _I, _P),
        # ... hi, bn, stages, grid, stream
        'mxtpu_fused_dot_epilogue_sm90': (_P, _P, _P, _P, _LL, _LL, _LL,
                                          _I, _I, _F, _F, _I, _I, _I, _P)},
        _DRIVER),
    'flash_attention': Kernel('flash_attention.cu', {
        # q, k, v, o, lse, BH, Tq, Tk, D, scale, causal, dtype, stream
        'mxtpu_flash_attention': (_P, _P, _P, _P, _P, _LL, _LL, _LL, _I,
                                  _F, _I, _I, _P),
        # q, k, v, o, lse, BH, Tq, Tk, D, scale, causal, grid, stream
        'mxtpu_flash_attention_sm90': (_P, _P, _P, _P, _P, _LL, _LL, _LL,
                                       _I, _F, _I, _I, _P)},
        _DRIVER),
    'rtc': Kernel('rtc.cu', {}, ('-lnvrtc', '-lcuda')),
    'multibox_nms': Kernel('multibox_nms.cu', {
        # rows, out, workspace, batch, anchors, threshold,
        # force_suppress, stream
        'mxtpu_multibox_nms': (_P, _P, _P, _LL, _LL, _F, _I, _P)}),
}

build_seconds = {}      # kernel name -> wall seconds of its nvcc run
build_logs = {}         # kernel name -> nvcc's output (ptxas -v report),
                        # also kept beside the library as <lib>.log
_loaded = {}            # kernel name -> CDLL
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


def _link_flags(name):
    """The link flags of ``name``: its libraries, the toolkit's lib64
    (also as the run path, where libnvrtc lives) and its stubs (libcuda
    at link time; the installed libcuda.so.1 loads at run time)."""
    libs = list(KERNELS[name].libs)
    if not libs:
        return []
    lib64 = cuda_home() / 'lib64'
    return libs + ['-L%s' % lib64, '-L%s' % (lib64 / 'stubs'),
                   '-Xlinker', '-rpath=%s' % lib64]


def _lib_path(name):
    source, _, libs = KERNELS[name]
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.read_bytes())
    h.update(' '.join(NVCC_FLAGS + libs).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / ('lib%s-%s.so' % (name, digest))


def build(names=None):
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together.  Returns
    ``{name: library path}``; raises :class:`KernelBuildError` when a
    build fails."""
    names = list(KERNELS) if names is None else list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    for n in set(names) - set(todo):
        # a library built earlier: its nvcc output was kept beside it
        log = paths[n].with_suffix('.log')
        if n not in build_logs and log.exists():
            build_logs[n] = log.read_text()
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix('.%d.tmp' % os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC / KERNELS[n].source), *_link_flags(n)]
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
        paths[n].with_suffix('.log').write_text(out)
        # atomic rename: a concurrent loader never sees a partial library
        os.replace(tmp, paths[n])
    if failed:
        raise KernelBuildError('nvcc failed for ' + '\n'.join(failed))
    return paths


def library(name):
    """The loaded ``ctypes.CDLL`` of kernel ``name``, built on first use,
    its entry points bound."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.mxtpu_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mxtpu_cuda_error_string.restype = ctypes.c_char_p
            for entry, argtypes in KERNELS[name].entries.items():
                fn = getattr(lib, entry)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def load(name, entry=None):
    """The ctypes entry point ``entry`` (default: the first) of kernel
    ``name``, built on first use."""
    return getattr(library(name),
                   entry or next(iter(KERNELS[name].entries)))


def error_string(name, err):
    """cudaGetErrorString of ``err`` as seen by kernel ``name``'s runtime."""
    return library(name).mxtpu_cuda_error_string(int(err)).decode()
