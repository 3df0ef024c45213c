"""mx.rtc.Rtc of the PyTorch port (mirrors tests/test_rtc.py).

On the CPU: the callable form against the JAX package's (its Pallas
interpreter), the ``_cache`` keying, a grid > 1 body reading
``program_id``, the decorated CUDA source for every dtype, and the
refusals (an invalid name, a CUDA-source kernel pushed on CPU arrays).
The ``cuda`` cases need the card and skip here; on the GPU host (no jax
there, hence the JAX package is imported inside the CPU tests only):

    python -m pytest tests/test_torch_rtc.py -q -m cuda --noconftest
"""
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
