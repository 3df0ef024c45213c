"""fused_dot_epilogue in the PyTorch port (mxnet_tpu_torch/ops/fused.py)
against the JAX package's (mxnet_tpu/ops/pallas_fused.py): outputs against
``_dot_epi_reference`` and the Pallas kernel through the interpreter, and
gradients of the autograd Function against the reference's custom_vjp
(``_dot_epi_bwd``), with and without bias, relu and clip, on block-
divisible and ragged shapes.

Inputs come from numpy seeds.  Tolerances: float32 rtol 1e-5, atol 1e-5
(the same f32 epilogue; only the product's summation order differs);
bfloat16 relative error <= 2e-2 of the output's scale (the port rounds
once, after the epilogue; ``_dot_epi_reference`` rounds x @ w to bf16
before the bias add, a second rounding of at most 2^-8 of |x @ w|)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_fused as pf
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused as tf

SHAPES = [(256, 128, 64), (49, 40, 29)]     # divisible / ragged (M, K, N)
EPILOGUES = [(True, True, None), (True, False, None), (False, True, None),
             (True, True, (-0.5, 0.7)), (False, False, (-1.0, 1.0))]
EPI_IDS = ['bias-relu', 'bias', 'relu', 'bias-relu-clip', 'clip']


def _case(mkn, seed):
    m, k, n = mkn
    r = np.random.RandomState(seed)
    return (r.randn(m, k).astype(np.float32),
            (r.randn(k, n) / np.sqrt(k)).astype(np.float32),
            (r.randn(n) * 0.5).astype(np.float32))


def _torch_args(x, w, b, has_bias, dtype=torch.float32, grad=False):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(grad)
          for a in (x, w, b)]
    return ts[0], ts[1], ts[2] if has_bias else None


def _jax(x, w, b, has_bias, relu, clip, dtype, monkeypatch):
    """(interpreted kernel, _dot_epi_reference) outputs as f32 numpy."""
    jx, jw, jb = (jnp.asarray(a).astype(dtype) for a in (x, w, b))
    if not has_bias:
        jb = jnp.zeros((w.shape[1],), dtype)
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    kern = pf.fused_dot_epilogue(jx, jw, jb, relu=relu, clip=clip)
    monkeypatch.delenv('MXTPU_FORCE_PALLAS_INTERPRET')
    ref = pf._dot_epi_reference(jx, jw, jb, relu, clip)
    return (np.asarray(kern.astype(jnp.float32)),
            np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize('has_bias,relu,clip', EPILOGUES, ids=EPI_IDS)
@pytest.mark.parametrize('mkn', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_f32_matches_jax(mkn, has_bias, relu, clip, monkeypatch):
    x, w, b = _case(mkn, 1)
    got = tf.fused_dot_epilogue(*_torch_args(x, w, b, has_bias), relu=relu,
                                clip=clip)
    assert got.dtype == torch.float32 and got.shape == (mkn[0], mkn[2])
    for want in _jax(x, w, b, has_bias, relu, clip, jnp.float32,
                     monkeypatch):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = tf.fused_dot_epilogue_plain(*_torch_args(x, w, b, has_bias),
                                        relu=relu, clip=clip)
    assert torch.equal(got, plain)


@pytest.mark.parametrize('mkn', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_bf16_matches_jax(mkn, monkeypatch):
    x, w, b = _case(mkn, 2)
    got = tf.fused_dot_epilogue(*_torch_args(x, w, b, True, torch.bfloat16),
                                relu=True, clip=(-2.0, 2.0))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in _jax(x, w, b, True, True, (-2.0, 2.0), jnp.bfloat16,
                     monkeypatch):
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 2e-2


@pytest.mark.parametrize('has_bias,relu,clip', EPILOGUES, ids=EPI_IDS)
@pytest.mark.parametrize('mkn', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_gradients_match_jax_vjp(mkn, has_bias, relu, clip, monkeypatch):
    """dx, dw, dbias of the autograd Function against the JAX custom_vjp
    at a random head gradient."""
    x, w, b = _case(mkn, 3)
    g = np.random.RandomState(4).randn(mkn[0], mkn[2]).astype(np.float32)
    tx, tw, tb = _torch_args(x, w, b, has_bias, grad=True)
    y = tf.fused_dot_epilogue(tx, tw, tb, relu=relu, clip=clip)
    got = torch.autograd.grad(y, [t for t in (tx, tw, tb) if t is not None],
                              torch.from_numpy(g))
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    jb = jnp.asarray(b) if has_bias else jnp.zeros((mkn[2],), jnp.float32)
    _, vjp = jax.vjp(lambda *a: pf.fused_dot_epilogue(*a, relu=relu,
                                                      clip=clip),
                     jnp.asarray(x), jnp.asarray(w), jb)
    want = vjp(jnp.asarray(g))
    for name, a, c in zip(('dx', 'dw', 'dbias'), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_transposed_weight_view_is_read_as_it_lies():
    """The lowering passes ``weight.t()`` of an (N, K) FullyConnected
    weight: a view, same result as a contiguous (K, N) copy, and the
    gradient reaches the (N, K) weight."""
    x, w, b = _case((12, 8, 5), 5)
    wnk = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_(True)
    y = tf.fused_dot_epilogue(torch.from_numpy(x), wnk.t(),
                              torch.from_numpy(b), relu=True)
    ref = tf.fused_dot_epilogue_plain(torch.from_numpy(x),
                                      torch.from_numpy(w),
                                      torch.from_numpy(b), relu=True)
    assert torch.equal(y, ref)
    y.sum().backward()
    assert wnk.grad.shape == (5, 8)


def test_cpu_path_never_touches_kernels(monkeypatch):
    def boom(*a, **k):
        raise AssertionError('the CPU path reached the CUDA kernel loader')
    monkeypatch.setattr(tf._kernels, 'load', boom)
    before = tf.fused_dot_epilogue.launches
    tf.fused_dot_epilogue(*_torch_args(*_case((8, 4, 3), 6), True),
                          relu=True)
    assert tf.fused_dot_epilogue.launches == before


@pytest.mark.parametrize('bad', ['w_dtype', 'w_shape', 'x_1d', 'bias_len',
                                 'clip_arity'])
def test_wrapper_rejects_bad_input(bad):
    x, w, b = _torch_args(*_case((6, 4, 5), 7), True)
    clip = None
    if bad == 'w_dtype':
        w = w.double()
    elif bad == 'w_shape':
        w = torch.zeros(3, 5)
    elif bad == 'x_1d':
        x = x.reshape(-1)
    elif bad == 'bias_len':
        b = torch.zeros(4)
    elif bad == 'clip_arity':
        clip = (0.0,)
    with pytest.raises((TypeError, ValueError, MXNetError)):
        tf.fused_dot_epilogue(x, w, b, clip=clip)
