"""mx.rtc.Rtc of the PyTorch port (mirrors tests/test_rtc.py).

On the CPU: the callable form against the JAX package's (its Pallas
interpreter), the ``_cache`` keying, a grid > 1 body reading
``program_id``, the decorated CUDA source for every dtype, the refusals
(an invalid name, a CUDA-source kernel pushed on CPU arrays), and the
pure-Python parts of a push's launch plan (its key, the argument
packing, the grid/block and device checks).  The ``cuda`` cases need the
card and skip here: the reference GPU test, the compile cache, NVRTC's
log, a push from a fresh thread, on a side stream, captured in a CUDA
graph, on a new grid/block/shape (no compile), a refused launch, and the
softmax head's bodies of ``chip_smoke.py``.  On the GPU host (no jax
there, hence the JAX package is imported inside the CPU tests only):

    python -m pytest tests/test_torch_rtc.py -q -m cuda --noconftest
"""
import ctypes
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import instrument, rtc


@pytest.fixture
def jmx():
    import mxnet_tpu
    return mxnet_tpu


def _square(a_ref, o_ref):
    o_ref[...] = a_ref[...] * a_ref[...]


def test_rtc_callable_and_respecialization_match_jax(jmx):
    """tests/test_rtc.py:21-36 in both packages: a new shape is a new
    specialization (two ``_cache`` entries)."""
    res = {}
    for pkg in (tmx, jmx):
        a = pkg.nd.array(np.arange(4, dtype=np.float32))
        o = pkg.nd.zeros((4,))
        k = pkg.rtc.Rtc('sq', [('a', a)], [('o', o)], _square)
        k.push([a], [o])
        a2 = pkg.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        o2 = pkg.nd.zeros((2, 3))
        k.push([a2], [o2])
        assert len(k._cache) == 2
        k.push([a2], [o2])
        assert len(k._cache) == 2
        res[pkg] = (o.asnumpy(), o2.asnumpy())
    for t, j in zip(res[tmx], res[jmx]):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(res[tmx][1], np.arange(6.0).reshape(2, 3)
                                  ** 2)


def _grid_body(program_id):
    def body(a_ref, b_ref, o_ref):
        i, j = program_id(0), program_id(1)
        o_ref[i, j] = a_ref[i, j] * (i + 1) + b_ref[j, i] * (j + 1)
    return body


def test_rtc_grid_program_id_matches_jax(jmx):
    """A (3, 2) grid: each point writes its own element from
    ``program_id(0)`` and ``program_id(1)``, in row-major order."""
    from jax.experimental import pallas as pl
    r = np.random.RandomState(0)
    a = r.randn(3, 2).astype(np.float32)
    b = r.randn(2, 3).astype(np.float32)
    res = {}
    for pkg, pid in ((tmx, rtc.program_id), (jmx, pl.program_id)):
        o = pkg.nd.zeros((3, 2))
        k = pkg.rtc.Rtc('grid', [('a', pkg.nd.array(a)),
                                 ('b', pkg.nd.array(b))], [('o', o)],
                        _grid_body(pid))
        k.push([pkg.nd.array(a), pkg.nd.array(b)], [o], grid_dims=(3, 2))
        res[pkg] = o.asnumpy()
    # XLA may contract the multiply-add into one FMA: one rounding fewer
    np.testing.assert_allclose(res[tmx], res[jmx], rtol=1e-6, atol=1e-7)
    want = a * np.arange(1, 4)[:, None] + b.T * np.arange(1, 3)[None, :]
    # float64 reference; the float32 sum cancels to 0.02 in one element
    np.testing.assert_allclose(res[tmx], want, rtol=1e-6, atol=1e-6)
    assert rtc.program_id(0) == 0      # no grid point outside a push


def test_rtc_callable_gets_copies_and_swaps_outputs():
    a = tmx.nd.array(np.arange(3, dtype=np.float32))
    o = tmx.nd.zeros((3,))
    old = o.handle

    def body(a_ref, o_ref):
        o_ref[...] = a_ref[...] + 1
        a_ref[...] = -1           # the kernel's own copy

    tmx.rtc.Rtc('inc', [('a', a)], [('o', o)], body).push([a], [o])
    np.testing.assert_array_equal(a.asnumpy(), [0, 1, 2])
    np.testing.assert_array_equal(o.asnumpy(), [1, 2, 3])
    assert o.handle is not old and float(old.sum()) == 0.0


@pytest.mark.parametrize('dtype,ctype', [
    (torch.float32, 'float'), (torch.float64, 'double'),
    (torch.float16, '__half'), (torch.bfloat16, '__nv_bfloat16'),
    (torch.int32, 'int'), (torch.int64, 'long long'),
    (torch.uint8, 'unsigned char')])
def test_source_decorates_as_mxrtc(dtype, ctype):
    x = tmx.nd.zeros((2,))
    k = tmx.rtc.Rtc('axpy', [('x', x), ('y', x)], [('out', x)],
                    '    out[0] = x[0] + y[0];')
    src = k.source([dtype, torch.float32], [dtype])
    headers = {torch.float16: '#include <cuda_fp16.h>\n',
               torch.bfloat16: '#include <cuda_bf16.h>\n'}.get(dtype, '')
    assert src == (headers + 'extern "C" __global__ void axpy(const %s* x, '
                   'const float* y, %s* out) {\n    out[0] = x[0] + y[0];'
                   '\n}\n' % (ctype, ctype))
    both = k.source([torch.float16], [torch.bfloat16])
    assert both.startswith('#include <cuda_fp16.h>\n#include <cuda_bf16.h>')


def test_rtc_refuses_what_it_cannot_run():
    x = tmx.nd.array(np.ones(4, np.float32))
    for bad in ('1abc', 'a-b', 'my kernel', ''):
        with pytest.raises(tmx.MXNetError, match='C identifier'):
            tmx.rtc.Rtc(bad, [('x', x)], [('y', x)], 'y[0] = x[0];')
    with pytest.raises(tmx.MXNetError, match='C identifier'):
        tmx.rtc.Rtc('k', [('x.0', x)], [('y', x)], 'y[0] = 1;')
    k = tmx.rtc.Rtc('copy', [('x', x)], [('y', x)], 'y[0] = x[0];')
    with pytest.raises(tmx.MXNetError, match='no C type'):
        k.source([torch.bool], [torch.float32])
    y = tmx.nd.zeros((4,))
    before = tmx.rtc.Rtc.launches
    with pytest.raises(tmx.MXNetError, match='CUDA device'):
        k.push([x], [y])
    with pytest.raises(ValueError, match='arity'):
        k.push([x, x], [y])
    assert tmx.rtc.Rtc.launches == before
    np.testing.assert_array_equal(y.asnumpy(), 0)   # nothing ran
    assert tmx.rtc.MXRtc is tmx.rtc.Rtc


def test_dims_pad_to_three_and_refuse_bad_ones():
    assert rtc._dims(None, 'grid_dims') == (1, 1, 1)
    assert rtc._dims((), 'grid_dims') == (1, 1, 1)
    assert rtc._dims((5,), 'grid_dims') == (5, 1, 1)
    assert rtc._dims([2, 3], 'block_dims') == (2, 3, 1)
    assert rtc._dims((np.int64(4), 2.0, 3), 'grid_dims') == (4, 2, 3)
    assert all(type(d) is int for d in rtc._dims((np.int64(4),), 'g'))
    assert rtc._dims((True, 2, 3), 'g') == (1, 2, 3)
    for bad in ((1, 1, 1, 1), (0,), (4, -1)):
        with pytest.raises(tmx.MXNetError, match='block_dims'):
            rtc._dims(bad, 'block_dims')


def test_plan_key_is_device_and_dtypes_not_shapes():
    """The launch plan's key: a new shape (or grid, or block) maps to the
    plan already compiled, a new dtype to another; a CPU array's device
    index is -1, which no plan has (its miss raises, below)."""
    f32 = [torch.zeros(3, 4), torch.zeros(7)]
    assert rtc._key(f32) == (-1, -1, torch.float32, torch.float32)
    assert rtc._key([torch.zeros(9, 9), torch.zeros(2)]) == rtc._key(f32)
    assert rtc._key([torch.zeros(3, dtype=torch.float16), f32[1]]) != \
        rtc._key(f32)
    assert rtc._key(f32 + f32[:1]) != rtc._key(f32)


def test_pack_is_one_launch_record():
    """A push's one ctypes argument: context, function, stream, grid,
    block, the argument count and each argument's address, as uint64s."""
    import struct
    x = torch.arange(12.0).view(3, 4)
    ts = [x, x[1:], torch.zeros(5, dtype=torch.int64)]
    k = tmx.rtc.Rtc('pk', [('a', tmx.nd.zeros((1,))), ('b', tmx.nd.zeros(
        (1,)))], [('c', tmx.nd.zeros((1,)))], 'c[0] = a[0] + b[0];')
    rec = rtc._pack(k._record, 2 ** 63 + 5, 7, 0, (32, 1, 1), (256, 2, 1),
                    ts)
    assert isinstance(rec, bytes) and len(rec) == 8 * 13
    assert struct.unpack('=13Q', rec) == (
        2 ** 63 + 5, 7, 0, 32, 1, 1, 256, 2, 1, 3,
        *[t.data_ptr() for t in ts])
    assert ts[1].data_ptr() - ts[0].data_ptr() == 16
    with pytest.raises(struct.error):       # the kernel takes three
        rtc._pack(k._record, 1, 7, 0, (1, 1, 1), (1, 1, 1), ts + [x])


def test_device_index_refuses_the_cpu_and_mixed_devices():
    cpu = [torch.zeros(2), torch.zeros(3)]
    with pytest.raises(tmx.MXNetError, match="CUDA device.*'cpu'"):
        rtc._device_index('k', cpu)
    meta = torch.empty(2, device='meta')
    with pytest.raises(tmx.MXNetError, match='CUDA device'):
        rtc._device_index('k', cpu + [meta])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (NVRTC kernels have no CPU mode)')
    return tmx.gpu(0)


@pytest.mark.cuda
def test_reference_gpu_kernel(gpu):
    """The reference MXNet's tests/python/gpu/test_rtc.py: shared memory,
    expf, a (10, 1, 1) block."""
    x = tmx.nd.ones((10,), ctx=gpu)
    y = tmx.nd.zeros((10,), ctx=gpu)
    k = tmx.rtc.Rtc('abc', [('x', x)], [('y', y)], """
        __shared__ float s_rec[10];
        s_rec[threadIdx.x] = x[threadIdx.x];
        y[threadIdx.x] = expf(s_rec[threadIdx.x]*5.0);""")
    before = tmx.rtc.Rtc.launches
    k.push([x], [y], (1, 1, 1), (10, 1, 1))
    assert tmx.rtc.Rtc.launches == before + 1
    np.testing.assert_allclose(y.asnumpy(), np.exp(5.0), rtol=2.5e-7)
    k.close()


@pytest.mark.cuda
def test_compile_cache_per_dtype_not_per_shape(gpu):
    k = tmx.rtc.Rtc('sq_t', [('a', tmx.nd.zeros((1,)))],
                    [('o', tmx.nd.zeros((1,)))], """
        int i = blockIdx.x * blockDim.x + threadIdx.x;
        o[i] = a[i] * a[i];""")
    outs = []
    for shape, dt in (((3, 4), 'float32'), ((2, 3), 'float32'),
                      ((2, 3), 'float16')):
        a = tmx.nd.array(np.arange(np.prod(shape)).reshape(shape), ctx=gpu,
                         dtype=dt)
        o = tmx.nd.zeros(shape, ctx=gpu, dtype=dt)
        c0 = instrument.counter_value('rtc.compiles')
        k.push([a], [o], (shape[0], 1, 1), (shape[1], 1, 1))
        outs.append((instrument.counter_value('rtc.compiles') - c0,
                     o.asnumpy(), a.asnumpy() ** 2))
    assert [o[0] for o in outs] == [1, 0, 1]
    assert len(k._cache) == 2
    for _, got, want in outs:
        np.testing.assert_array_equal(got, want)
    k.close()


@pytest.mark.cuda
def test_compile_error_carries_the_log(gpu):
    x = tmx.nd.zeros((1,), ctx=gpu)
    k = tmx.rtc.Rtc('broken', [('x', x)], [('y', x)], 'y[0] = x[0] +;')
    with pytest.raises(tmx.MXNetError, match='expected an expression'):
        k.push([x], [tmx.nd.zeros((1,), ctx=gpu)])
    py = tmx.rtc.Rtc('pybody', [('x', x)], [('y', x)],
                     'y[...] = x[...] * 2')
    with pytest.raises(tmx.MXNetError, match='NVRTC'):
        py.push([x], [tmx.nd.zeros((1,), ctx=gpu)])


def _smoke():
    """``chip_smoke.py``, where the softmax head's bodies (user code of
    the Custom-head path) live; it imports numpy only at the top."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke_bodies', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _softmax_rows(rows, n, offset=0):
    """(rows, n) float32 logits on the card from a numpy seed; ``offset``
    elements into a larger buffer (a row base off 16 bytes)."""
    r = np.random.RandomState(rows + n + offset)
    x = (r.randn(rows * n + offset) * 3.0).astype(np.float32)
    label = r.randint(0, n, rows).astype(np.float32)
    base = torch.from_numpy(x).cuda()
    return base[offset:].view(rows, n), torch.from_numpy(label).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize('rows,n,offset', [
    (32, 1000, 0), (8192, 32000, 0), (64, 1001, 0), (16, 1000, 1),
    (4, 32000, 3)], ids=['path', 'lm_head', 'ragged', 'misaligned',
                          'lm_misaligned'])
def test_softmax_bodies_match_torch(gpu, rows, n, offset):
    """The head's one-read forward within chip_smoke's SOFTMAX_RTOL of
    torch.softmax in float64 (and of the three-pass body), and its float4
    backward equal to y - onehot(label), at the path's and the LM head's
    widths, a ragged width (scalar loads) and row bases off 16 bytes."""
    smoke = _smoke()
    x, label = _softmax_rows(rows, n, offset)
    assert offset or x.data_ptr() % 16 == 0
    dims = ((rows, 1, 1), (smoke.rtc_block(n), 1, 1))
    got = {}
    for bodies in ('new', 'old'):
        fwd, bwd = smoke.softmax_kernels(tmx, n, bodies)
        y, dx = tmx.nd.zeros((1,), ctx=gpu), tmx.nd.zeros((1,), ctx=gpu)
        y._set_data(torch.empty(rows, n, device='cuda'))
        dx._set_data(torch.empty(rows, n, device='cuda'))
        fwd.push([tmx.nd.NDArray(x)], [y], *dims)
        bwd.push([y, tmx.nd.NDArray(label)], [dx], *dims)
        torch.cuda.synchronize()
        got[bodies] = y.handle, dx.handle
    want = torch.softmax(x.double(), 1).float()
    onehot = (torch.arange(n, device='cuda')[None]
              == label.long()[:, None]).float()
    for bodies, (y, dx) in got.items():
        assert bool(torch.isfinite(y).all()), bodies
        rel = float(((y - want).abs() / want.abs().clamp_min(1e-37)).max())
        assert rel <= smoke.SOFTMAX_RTOL, (bodies, rel)
        assert torch.equal(dx, y - onehot), bodies
    old = got['old'][0]
    rel = float(((got['new'][0] - old).abs() / old.abs().clamp_min(1e-37))
                .max())
    assert rel <= 2 * smoke.SOFTMAX_RTOL, rel


def _square_kernel(name):
    return tmx.rtc.Rtc(name, [('a', tmx.nd.zeros((1,)))],
                       [('o', tmx.nd.zeros((1,)))], """
        int i = blockIdx.x * blockDim.x + threadIdx.x;
        o[i] = a[i] * a[i];""")


def _arange(gpu, rows, cols, scale=1.0):
    return tmx.nd.array(np.arange(rows * cols, dtype=np.float32).reshape(
        rows, cols) * scale, ctx=gpu)


@pytest.mark.cuda
def test_push_from_a_fresh_thread(gpu):
    """A push from a thread that never touched CUDA launches on the
    arrays' device; the launch entry, called where no context is current,
    pushes the primary context and leaves none current after."""
    k = _square_kernel('sq_thread')
    a, o = _arange(gpu, 3, 4), tmx.nd.zeros((3, 4), ctx=gpu)
    k.push([a], [o], (3, 1, 1), (4, 1, 1))          # the plan exists
    torch.cuda.synchronize()
    libcuda = ctypes.CDLL('libcuda.so.1')
    ctx, function, launch, _, _ = k._cache[rtc._key([a.handle, o.handle])]
    bare = torch.zeros(3, 4, device='cuda')
    torch.cuda.synchronize()
    got = {}

    def fresh():
        try:
            k.push([a], [o], (3, 1, 1), (4, 1, 1))
            torch.cuda.synchronize()
            got['push'] = o.handle.clone()
            libcuda.cuCtxSetCurrent(None)
            err = launch(rtc._pack(k._record, ctx, function, 0, (3, 1, 1),
                                   (4, 1, 1), [a.handle, bare]))
            current = ctypes.c_void_p(1)
            libcuda.cuCtxGetCurrent(ctypes.byref(current))
            got['bare'] = err, current.value
        except Exception as e:                    # noqa: BLE001 - asserted
            got['error'] = e

    t = threading.Thread(target=fresh)
    t.start()
    t.join()
    assert 'error' not in got, got.get('error')
    assert torch.equal(got['push'], a.handle * a.handle)
    assert got['bare'] == (0, None)
    torch.cuda.synchronize()
    assert torch.equal(bare, a.handle * a.handle)
    k.close()


@pytest.mark.cuda
def test_push_orders_after_work_on_a_side_stream(gpu):
    """Inside ``with torch.cuda.stream(s):`` a push launches on ``s``,
    after the work already queued there (torch's streams do not wait on
    the default stream, so a launch there would read the old input)."""
    k = _square_kernel('sq_stream')
    a, o = _arange(gpu, 4, 256), tmx.nd.zeros((4, 256), ctx=gpu)
    k.push([a], [o], (4, 1, 1), (256, 1, 1))
    torch.cuda.synchronize()
    want = (a.handle * 2) ** 2
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(100_000_000)
        a.handle.mul_(2.0)
        k.push([a], [o], (4, 1, 1), (256, 1, 1))
    s.synchronize()
    assert torch.equal(o.handle, want)
    k.close()


@pytest.mark.cuda
def test_push_captured_in_a_cuda_graph(gpu):
    """A push captured in ``torch.cuda.graph`` (its plan made before the
    capture) replays on new values copied into its static input, into the
    output it captured."""
    k = _square_kernel('sq_graph')
    a, o = _arange(gpu, 8, 128), tmx.nd.zeros((8, 128), ctx=gpu)
    k.push([a], [o], (8, 1, 1), (128, 1, 1))
    torch.cuda.synchronize()
    before = tmx.rtc.Rtc.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        k.push([a], [o], (8, 1, 1), (128, 1, 1))
    assert tmx.rtc.Rtc.launches == before + 1
    static = o.handle
    for scale in (-0.5, 3.0):
        a.handle.copy_(_arange(gpu, 8, 128, scale).handle)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, a.handle * a.handle)
    assert tmx.rtc.Rtc.launches == before + 1
    k.close()


@pytest.mark.cuda
def test_new_grid_block_or_shape_compiles_nothing(gpu):
    k = _square_kernel('sq_shapes')
    c0 = instrument.counter_value('rtc.compiles')
    for rows, cols, grid, block in ((3, 4, (3,), (4,)),
                                    (3, 4, (1, 3), (4, 1, 1)),
                                    (3, 4, (1,), (12,)),
                                    (64, 96, (64, 1, 1), (96, 1, 1)),
                                    (2, 1024, (2,), (1024,))):
        a, o = _arange(gpu, rows, cols), tmx.nd.zeros((rows, cols), ctx=gpu)
        if grid == (1, 3):      # blockIdx.x only: row 0 three times
            a = _arange(gpu, 1, 4)
            o = tmx.nd.zeros((1, 4), ctx=gpu)
        k.push([a], [o], grid, block)
        torch.cuda.synchronize()
        assert torch.equal(o.handle, a.handle * a.handle), (rows, cols)
    assert instrument.counter_value('rtc.compiles') == c0 + 1
    assert len(k._cache) == 1
    k.close()


@pytest.mark.cuda
def test_failing_launch_raises(gpu):
    """A block of 2048 threads is refused at the launch: MXNetError with
    CUDA's reason, nothing counted, and the next push runs."""
    k = _square_kernel('sq_refused')
    a, o = _arange(gpu, 2, 2048), tmx.nd.zeros((2, 2048), ctx=gpu)
    before = tmx.rtc.Rtc.launches
    with pytest.raises(tmx.MXNetError, match='launch failed'):
        k.push([a], [o], (2, 1, 1), (2048, 1, 1))
    assert tmx.rtc.Rtc.launches == before
    k.push([a], [o], (4, 1, 1), (1024, 1, 1))
    torch.cuda.synchronize()
    assert torch.equal(o.handle, a.handle * a.handle)
    assert tmx.rtc.Rtc.launches == before + 1
    k.close()
