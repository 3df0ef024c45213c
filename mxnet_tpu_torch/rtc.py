"""Runtime kernel compilation — ``mx.rtc.Rtc``, the port of
``mxnet_tpu/rtc.py``, rebuilt on NVRTC.

The JAX package wraps a user's body (Python source or a callable over
Pallas refs) in ``pl.pallas_call`` and ignores ``block_dims``.  The port
goes back to the reference MXNet's MXRtc (``src/common/mxrtc.cc``): a
string kernel is the BODY of a CUDA C++ ``__global__`` function, which
:meth:`Rtc.source` decorates as::

    extern "C" __global__ void <name>(const T0* <in0>, ..., T* <out0>, ...)
    { <body> }

with each ``T`` taken from that array's dtype (float32 ``float``,
float64 ``double``, float16 ``__half``, bfloat16 ``__nv_bfloat16``,
int32 ``int``, int64 ``long long``, uint8 ``unsigned char``;
``cuda_fp16.h`` / ``cuda_bf16.h`` are included only when a 16-bit type
occurs).  NVRTC compiles it for ``sm_90a`` to a CUBIN, one module per
(device, input dtypes, output dtypes) — shapes do not change the code —
loaded into the device's primary context, and :meth:`Rtc.push` launches
it through the CUDA driver API (``csrc/rtc.cu``) with ``grid_dims`` /
``block_dims`` (default ``(1, 1, 1)``), no dynamic shared memory, on
torch's current stream of the arrays' device, without synchronising.

A push is one cached launch plan: the module cache is a dict keyed by
the arguments' devices and dtypes, read without a lock (the lock guards
the compile on a miss, where the devices are checked), and the launch
is one ctypes call whose one argument is a packed launch record of plain
integers (the plan's handles, the stream, grid, block and the arguments'
device addresses).  The launch pushes the primary context only
where the calling thread has another context current or none (a thread
that never touched CUDA), so it runs on the arrays' device from any
thread, and the thread's context is left as it was.  A push can be
captured in a CUDA graph (``torch.cuda.graph``) once its plan exists.

Outputs: each output gets a fresh contiguous tensor, launched into and
then swapped into its NDArray (``_set_data``), as the JAX package swaps
in its result.  Their contents are undefined on entry, so **a kernel
must write every element of its outputs**; views of an output's old
value do not change.  Inputs are made contiguous.  Every array must be
on one CUDA device: an array on the CPU or on another device raises
:class:`MXNetError`, as does a compile error (with NVRTC's log) or a
launch error.  There is no fallback.

A Python-source string of the JAX package has no counterpart here: a
string is CUDA C++, and a Python body fails in NVRTC with its log.  The
callable form stays: ``kernel(*in_tensors, *out_tensors)`` runs once per
grid point, in row-major order, with :func:`program_id` giving the
current point (the counterpart of ``pl.program_id``); ``ref[...]``
reads and writes work on the tensors as on Pallas refs.  It runs on any
device and is the plain version the tests hold the CUDA form against.
``Rtc.launches`` counts the CUDA launches; ``instrument`` counts the
compiles (``rtc.compiles``) and their seconds (``rtc.compile_secs``).
"""
from __future__ import annotations

import ctypes
import itertools
import re
import struct
import threading
import time

import torch

from . import instrument
from .base import MXNetError
from .ndarray import NDArray

__all__ = ['Rtc', 'MXRtc', 'program_id', 'C_TYPES']

ARCH = 'sm_90a'
C_TYPES = {
    torch.float32: 'float', torch.float64: 'double',
    torch.float16: '__half', torch.bfloat16: '__nv_bfloat16',
    torch.int32: 'int', torch.int64: 'long long',
    torch.uint8: 'unsigned char',
}
_HEADERS = {torch.float16: '#include <cuda_fp16.h>',
            torch.bfloat16: '#include <cuda_bf16.h>'}
_IDENT = re.compile(r'[A-Za-z_][A-Za-z0-9_]*')
_LOG_CAP = 1 << 16

_state = threading.local()      # the callable form's grid point


def program_id(axis):
    """The current grid point's index along ``axis`` inside a callable
    kernel (0 along an axis the grid does not have)."""
    point = getattr(_state, 'point', ())
    return point[axis] if axis < len(point) else 0


def _c_identifier(kind, name):
    if not isinstance(name, str) or not _IDENT.fullmatch(name):
        raise MXNetError('Rtc %s %r is not a C identifier' % (kind, name))
    return name


def _dims(dims, what):
    """``dims`` (up to three positive ints; None or empty for none) as a
    CUDA (x, y, z), the missing trailing ones 1."""
    if type(dims) is tuple and len(dims) == 3:     # the common case, fast
        x, y, z = dims
        if type(x) is int and type(y) is int and type(z) is int and \
                x > 0 and y > 0 and z > 0:
            return dims
    if not dims:
        return (1, 1, 1)
    dims = tuple(map(int, dims))
    if len(dims) > 3 or min(dims) < 1:
        raise MXNetError('Rtc %s must be up to 3 positive ints, got %r'
                         % (what, dims))
    return dims + (1,) * (3 - len(dims))


def _device_index(name, tensors):
    """The CUDA device index all ``tensors`` lie on; raises where one lies
    on the CPU or on another device."""
    index = {t.get_device() for t in tensors}
    if len(index) == 1 and min(index) >= 0:
        return min(index)
    raise MXNetError(
        'Rtc %s: a CUDA-source kernel runs on one CUDA device; its arrays '
        'are on %s' % (name, sorted({str(t.device) for t in tensors})))


def _key(tensors):
    """A launch plan's key: each argument's device index, then its dtype.
    Shapes, grid and block change no code, so a new one compiles nothing.
    A plan is made only for arguments on one CUDA device, so a hit in the
    cache is the device check too."""
    return (*[t.get_device() for t in tensors], *[t.dtype for t in tensors])


def _record(nargs):
    """The packer of a launch record of ``nargs`` kernel arguments:
    native-endian uint64s, as ``mxtpu_rtc_launch_record`` reads them."""
    return struct.Struct('=%dQ' % (10 + nargs)).pack


def _pack(record, ctx, function, stream, grid, block, tensors):
    """One launch: the plan's context and function handles, the stream,
    grid, block, the argument count and the tensors' device addresses,
    packed by ``record`` (:func:`_record`) into one bytes object, the
    launch entry's only argument."""
    return record(ctx, function, stream, *grid, *block, len(tensors),
                  *[t.data_ptr() for t in tensors])


def _raw_stream(index):
    """The handle of torch's current stream on device ``index``.  The
    public ``torch.cuda.current_stream(index).cuda_stream`` builds a
    Stream object on every call (a few us); the private binding returns
    the handle as an int and is the one torch's own generated code
    launches with (``torch._inductor``'s ``get_raw_stream``)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _tensor(x):
    if isinstance(x, NDArray):
        return x.handle
    if isinstance(x, torch.Tensor):
        return x
    raise TypeError('Rtc.push takes NDArrays, got %s' % type(x).__name__)


class _Shim:
    """The ctypes entry points of ``csrc/rtc.cu``."""

    def __init__(self):
        from .ops import _kernels
        lib = _kernels.library('rtc')
        P, I = ctypes.c_void_p, ctypes.c_int
        self.compile = lib.mxtpu_rtc_compile
        self.compile.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.POINTER(P),
                                 ctypes.POINTER(ctypes.c_size_t),
                                 ctypes.c_char_p, ctypes.c_size_t]
        self.free_cubin = lib.mxtpu_rtc_free_cubin
        self.free_cubin.argtypes = [P]
        self.free_cubin.restype = None
        self.load = lib.mxtpu_rtc_load
        self.load.argtypes = [ctypes.c_char_p, ctypes.c_char_p, I,
                              ctypes.POINTER(P),
                              ctypes.POINTER(P), ctypes.POINTER(P)]
        # one launch record (_pack), passed as a pointer to its bytes
        self.launch_record = lib.mxtpu_rtc_launch_record
        self.launch_record.argtypes = [ctypes.c_char_p]
        self.free = lib.mxtpu_rtc_free
        self.free.argtypes = [P, P, I]
        for fn in (self.compile, self.load, self.launch_record, self.free):
            fn.restype = I
        self.cuda_error = lib.mxtpu_cuda_error_string
        self.nvrtc_error = lib.mxtpu_nvrtc_error_string
        for fn in (self.cuda_error, self.nvrtc_error):
            fn.argtypes = [I]
            fn.restype = ctypes.c_char_p
        self.include_dir = str(_kernels.cuda_home() / 'include')


_shim = []
_shim_lock = threading.Lock()


def _get_shim():
    with _shim_lock:
        if not _shim:
            _shim.append(_Shim())
        return _shim[0]


def _compile(shim, source, name):
    """The CUBIN of ``source``; raises with NVRTC's log."""
    cubin, size = ctypes.c_void_p(), ctypes.c_size_t()
    log = ctypes.create_string_buffer(_LOG_CAP)
    t0 = time.perf_counter()
    err = shim.compile(source.encode(), name.encode(), ARCH.encode(),
                       shim.include_dir.encode(), ctypes.byref(cubin),
                       ctypes.byref(size), log, _LOG_CAP)
    secs = time.perf_counter() - t0
    if err:
        raise MXNetError('Rtc %s: NVRTC failed (%s):\n%s' % (
            name, shim.nvrtc_error(err).decode(),
            log.value.decode(errors='replace')))
    try:
        data = ctypes.string_at(cubin, size.value)
    finally:
        shim.free_cubin(cubin)
    instrument.inc('rtc.compiles')
    instrument.observe_hist('rtc.compile_secs', secs)
    return data


class Rtc(object):
    """A runtime-compiled kernel (MXRtc).

    Parameters
    ----------
    name : str
        Kernel name, a C identifier (MXRtcCreate ``name``).
    inputs, outputs : list of (str, NDArray)
        Names (C identifiers for a CUDA-source kernel) and example arrays
        fixing the argument order; dtypes and shapes may differ at push
        time.
    kernel : str or callable
        The body of a CUDA ``__global__`` function (see the module
        docstring), or a callable over ``(*in_tensors, *out_tensors)``.
    """

    launches = 0        # CUDA launches of every Rtc, counted by push

    def __init__(self, name, inputs, outputs, kernel):
        self.name = _c_identifier('name', name)
        self.input_names = [n for n, _ in inputs]
        self.output_names = [n for n, _ in outputs]
        if isinstance(kernel, str):
            for n in self.input_names + self.output_names:
                _c_identifier('argument name', n)
            self._body = None
            self._kernel_source = kernel
        elif callable(kernel):
            self._body = kernel
            self._kernel_source = None
        else:
            raise TypeError('Rtc kernel must be a CUDA source string or a '
                            'callable')
        # callable: (in avals, out avals, grid) -> body, the JAX package's
        # keys; CUDA: _key -> the launch plan (_load), read without the
        # lock
        self._cache = {}
        self._record = _record(len(self.input_names)
                               + len(self.output_names))
        self._lock = threading.Lock()

    def source(self, in_dtypes, out_dtypes):
        """The decorated CUDA source for these argument dtypes."""
        if self._kernel_source is None:
            raise MXNetError('Rtc %s has a callable kernel, no CUDA source'
                             % self.name)
        dtypes = list(in_dtypes) + list(out_dtypes)
        missing = [d for d in dtypes if d not in C_TYPES]
        if missing:
            raise MXNetError('Rtc %s: no C type for %s (have %s)' % (
                self.name, missing, sorted(str(d) for d in C_TYPES)))
        headers = [h for d, h in _HEADERS.items() if d in dtypes]
        params = ['const %s* %s' % (C_TYPES[d], n)
                  for d, n in zip(in_dtypes, self.input_names)]
        params += ['%s* %s' % (C_TYPES[d], n)
                   for d, n in zip(out_dtypes, self.output_names)]
        return '%sextern "C" __global__ void %s(%s) {\n%s\n}\n' % (
            ''.join(h + '\n' for h in headers), self.name,
            ', '.join(params), self._kernel_source)

    def push(self, ins, outs, grid_dims=None, block_dims=None):
        """Run the kernel (MXRtcPush) on ``ins``, into the NDArrays
        ``outs``, over ``grid_dims`` blocks of ``block_dims`` threads."""
        if len(ins) != len(self.input_names) or \
                len(outs) != len(self.output_names):
            raise ValueError('push arity does not match kernel signature')
        xs = [_tensor(x) for x in ins]
        for o in outs:
            if not isinstance(o, NDArray):
                raise TypeError('Rtc.push outputs must be NDArrays')
        if self._body is not None:
            return self._push_callable(xs, outs, grid_dims)
        grid = _dims(grid_dims, 'grid_dims')
        block = _dims(block_dims, 'block_dims')
        olds = [o.handle for o in outs]
        key = _key(xs + olds)
        ctx, function, launch, index, _ = self._cache.get(key) or \
            self._load(key, xs, olds)
        xs = [t.contiguous() for t in xs]
        ys = [torch.empty_like(t, memory_format=torch.contiguous_format)
              for t in olds]
        err = launch(_pack(self._record, ctx, function, _raw_stream(index),
                           grid, block, xs + ys))
        if err:
            raise MXNetError('Rtc %s: launch failed: %s (CUDA error %d)' % (
                self.name, _get_shim().cuda_error(err).decode(), err))
        instrument.count_launch(Rtc)
        for dst, y in zip(outs, ys):
            dst._set_data(y)
        return outs

    def _load(self, key, xs, ys):
        """The launch plan of ``key`` for inputs ``xs`` and outputs ``ys``
        (context, function, launch entry, device index, module), compiled
        and loaded: the cache's miss path, the only one that takes the
        lock.  Raises where the arrays are not on one CUDA device."""
        index = _device_index(self.name, xs + ys)
        in_dtypes = [t.dtype for t in xs]
        out_dtypes = [t.dtype for t in ys]
        with self._lock:
            plan = self._cache.get(key)
            if plan is not None:
                return plan
            shim = _get_shim()
            cubin = _compile(shim, self.source(in_dtypes, out_dtypes),
                             self.name)
            ctx, module, function = (ctypes.c_void_p() for _ in range(3))
            err = shim.load(cubin, self.name.encode(), index,
                            ctypes.byref(ctx), ctypes.byref(module),
                            ctypes.byref(function))
            if err:
                raise MXNetError('Rtc %s: loading the module failed: %s '
                                 '(CUDA error %d)' % (
                                     self.name, shim.cuda_error(err).decode(),
                                     err))
            plan = self._cache[key] = (ctx.value, function.value,
                                       shim.launch_record, index,
                                       module.value)
            return plan

    def _push_callable(self, xs, outs, grid_dims):
        grid = tuple(int(g) for g in grid_dims) if grid_dims else ()
        key = (tuple((tuple(x.shape), x.dtype) for x in xs),
               tuple((o.shape, o.dtype) for o in outs), grid)
        body = self._cache.setdefault(key, self._body)
        # inputs are the kernel's own copies, as pallas_call's are
        refs = [x.clone() for x in xs]
        ys = [torch.zeros(o.shape, dtype=o.dtype, device=o.handle.device)
              for o in outs]
        try:
            for point in itertools.product(*(range(g) for g in grid)):
                _state.point = point
                body(*refs, *ys)
        finally:
            _state.point = ()
        for dst, y in zip(outs, ys):
            dst._set_data(y)
        return outs

    def close(self):
        """Unload this kernel's CUDA modules."""
        if self._body is not None:
            return
        with self._lock:
            for ctx, _, _, device, module in self._cache.values():
                _get_shim().free(ctx, module, device)
            self._cache.clear()


MXRtc = Rtc
