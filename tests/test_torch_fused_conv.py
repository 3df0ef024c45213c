"""fused_scale_bias_conv3x3 in the PyTorch port (mxnet_tpu_torch/ops/
fused_conv.py) against the JAX package's function — run as
tests/test_pallas_conv.py runs it on the CPU, through the Pallas
interpreter where its block rules admit the shape (C divisible by 64,
even H and W at stride 2) and through its reference elsewhere — and
against its custom_vjp; plus the fused_bn_relu backward against the JAX
custom_vjp.

Inputs come from numpy seeds.  Tolerances: float32 rtol 1e-5, atol 1e-5
(the same f32 prologue; the nine-tap sums run in another order);
bfloat16 relative error <= 0.05 of the output's scale (bench.py's bf16
kernel bound)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_conv as pc
from mxnet_tpu.ops import pallas_fused as pf
from mxnet_tpu_torch.ops import fused as tf
from mxnet_tpu_torch.ops import fused_conv as tfc


def _inputs(n, h, w, c, f, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h, w, c).astype(np.float32) * 0.5,
            rng.randn(3, 3, c, f).astype(np.float32) * 0.2,
            rng.rand(c).astype(np.float32) + 0.5,
            rng.randn(c).astype(np.float32) * 0.2)


# (n, h, w, c, f): the kernel path of the JAX function (c = 64), and odd
# sizes it takes through its reference
SHAPES = [(2, 8, 8, 64, 64), (2, 7, 9, 64, 64), (1, 5, 6, 12, 20)]


def _jax(args, stride, relu, dtype, monkeypatch):
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    ja = [jnp.asarray(a).astype(dtype) for a in args]
    out = pc.fused_scale_bias_conv3x3(*ja, stride=stride, relu=relu)
    return np.asarray(out.astype(jnp.float32))


def _rel(got, want):
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


@pytest.mark.parametrize('relu', [True, False], ids=['relu', 'affine'])
@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_f32_matches_jax(shape, stride, relu, monkeypatch):
    args = _inputs(*shape, seed=1)
    ts = [torch.from_numpy(a) for a in args]
    got = tfc.fused_scale_bias_conv3x3(*ts, stride=stride, relu=relu)
    want = _jax(args, stride, relu, jnp.float32, monkeypatch)
    assert tuple(got.shape) == want.shape
    assert tuple(got.shape[1:3]) == tfc.conv3x3_out_hw(shape[1], shape[2],
                                                       stride)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        got, tfc.fused_scale_bias_conv3x3_plain(*ts, stride, relu),
        rtol=0, atol=0)


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('shape', SHAPES[:2], ids=lambda s: 'x'.join(map(str, s)))
def test_bf16_matches_jax(shape, stride, monkeypatch):
    args = _inputs(*shape, seed=2)
    got = tfc.fused_scale_bias_conv3x3(
        *[torch.from_numpy(a).to(torch.bfloat16) for a in args],
        stride=stride)
    assert got.dtype == torch.bfloat16
    want = _jax(args, stride, True, jnp.bfloat16, monkeypatch)
    assert _rel(got.float().numpy(), want) <= 0.05


def test_halo_contributes_zero_not_relu_bias():
    """Padding applies after the prologue: with x = 0 and a positive
    bias every input pixel is relu(bias) > 0 but the halo stays 0, so a
    corner output sums 4 taps and an interior one 9."""
    x = torch.zeros(1, 4, 4, 1)
    w = torch.ones(3, 3, 1, 1)
    y = tfc.fused_scale_bias_conv3x3(x, w, torch.ones(1),
                                     torch.full((1,), 2.0))
    assert float(y[0, 0, 0, 0]) == 8.0 and float(y[0, 1, 1, 0]) == 18.0


@pytest.mark.parametrize('relu', [True, False], ids=['relu', 'affine'])
@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('shape', [(1, 6, 6, 48, 48), (2, 5, 7, 8, 6)],
                         ids=lambda s: 'x'.join(map(str, s)))
def test_gradients_match_jax_vjp(shape, stride, relu):
    """dx, dw, dscale, dbias against the JAX custom_vjp (the relu mask
    and affine pullback around the linear conv's vjp)."""
    args = _inputs(*shape, seed=3)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = tfc.fused_scale_bias_conv3x3(*ts, stride=stride, relu=relu)
    g = np.random.RandomState(4).randn(*y.shape).astype(np.float32)
    got = torch.autograd.grad(y, ts, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda *a: pc.fused_scale_bias_conv3x3(
        *a, stride=stride, relu=relu), *[jnp.asarray(a) for a in args])
    want = vjp(jnp.asarray(g))
    for name, a, b in zip(('dx', 'dw', 'dscale', 'dbias'), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_cpu_path_never_touches_kernels(monkeypatch):
    def boom(*a, **k):
        raise AssertionError('the CPU path reached the CUDA kernel loader')
    monkeypatch.setattr(tfc._kernels, 'load', boom)
    before = tfc.fused_scale_bias_conv3x3.launches
    tfc.fused_scale_bias_conv3x3(*[torch.from_numpy(a)
                                   for a in _inputs(1, 4, 4, 3, 2, 5)])
    assert tfc.fused_scale_bias_conv3x3.launches == before


@pytest.mark.parametrize('bad', ['stride', 'w_shape', 'nchw_3d', 'w_dtype'])
def test_wrapper_rejects_bad_input(bad):
    x, w, s, b = [torch.from_numpy(a) for a in _inputs(1, 4, 4, 3, 2, 6)]
    stride = 1
    if bad == 'stride':
        stride = 3
    elif bad == 'w_shape':
        w = torch.zeros(3, 3, 2, 2)
    elif bad == 'nchw_3d':
        x = x[0]
    elif bad == 'w_dtype':
        w = w.bfloat16()
    with pytest.raises((TypeError, ValueError)):
        tfc.fused_scale_bias_conv3x3(x, w, s, b, stride=stride)


@pytest.mark.parametrize('shape', [(2, 64, 8, 8), (49, 96), (3, 5, 7, 7)],
                         ids=lambda s: 'x'.join(map(str, s)))
def test_bn_relu_gradients_match_jax_vjp(shape):
    """The fused_bn_relu backward (_bn_relu_bwd) against the JAX
    custom_vjp."""
    rng = np.random.RandomState(7)
    c = shape[1]
    args = (rng.randn(*shape).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32),
            (rng.randn(c) * 0.5).astype(np.float32))
    g = rng.randn(*shape).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = torch.autograd.grad(tf.fused_bn_relu(*ts), ts, torch.from_numpy(g))
    _, vjp = jax.vjp(pf.fused_bn_relu, *[jnp.asarray(a) for a in args])
    want = vjp(jnp.asarray(g))
    for name, a, b in zip(('dx', 'dscale', 'dbias'), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
