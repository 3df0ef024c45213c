"""fused_bn_relu in the PyTorch port (mxnet_tpu_torch/ops/fused.py) against
the JAX package's fused_bn_relu — run as the JAX tests run it on the CPU,
through the Pallas interpreter — and its plain jnp reference.

Inputs come from numpy seeds.  Tolerances: float32 atol 1e-6 (the same
affine in f32 on both sides; only rounding of the multiply-add can
differ); bfloat16 one ulp of the output's bf16 value (the f32 results
can round to neighbouring bf16 values)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_fused as pf
from mxnet_tpu_torch.ops import fused as tf
from mxnet_tpu_torch.base import MXNetError

SHAPES = [
    (256, 128),            # 2-D (M, C): channel is the trailing axis
    (2, 64, 8, 8),         # NCHW, block-divisible
    (49, 96),              # ragged M: no block divides it
    (3, 40, 7, 7),         # the final 7x7 stage at batch 3
]


def _case(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[1]
    x = rng.randn(*shape).astype(np.float32)
    s = (rng.rand(c) + 0.5).astype(np.float32)
    b = rng.randn(c).astype(np.float32) * 0.5
    return x, s, b


def _jax(x, s, b, dtype, monkeypatch):
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    jx = jnp.asarray(x).astype(dtype)
    out = pf.fused_bn_relu(jx, jnp.asarray(s).astype(dtype),
                           jnp.asarray(b).astype(dtype))
    monkeypatch.delenv('MXTPU_FORCE_PALLAS_INTERPRET')
    ref = pf._bn_relu_reference(jx, jnp.asarray(s).astype(dtype),
                                jnp.asarray(b).astype(dtype))
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(ref.astype(jnp.float32)))


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_f32_matches_jax(shape, monkeypatch):
    x, s, b = _case(shape, 1)
    got = tf.fused_bn_relu(torch.from_numpy(x), torch.from_numpy(s),
                           torch.from_numpy(b)).numpy()
    kern, ref = _jax(x, s, b, jnp.float32, monkeypatch)
    np.testing.assert_allclose(got, kern, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert got.dtype == np.float32 and got.shape == shape


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_bf16_matches_jax(shape, monkeypatch):
    x, s, b = _case(shape, 2)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    st = torch.from_numpy(s).to(torch.bfloat16)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    out = tf.fused_bn_relu(xt, st, bt)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    kern, ref = _jax(x, s, b, jnp.bfloat16, monkeypatch)
    for want in (kern, ref):
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= ulp)


def test_plain_version_is_the_cpu_path():
    x, s, b = _case((4, 8, 5, 5), 3)
    args = [torch.from_numpy(a) for a in (x, s, b)]
    torch.testing.assert_close(tf.fused_bn_relu(*args),
                               tf.fused_bn_relu_plain(*args), rtol=0, atol=0)
    np.testing.assert_array_equal(
        tf.fused_bn_relu(*args).numpy(),
        np.maximum(x * s.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1), 0))


def test_cpu_tensor_never_touches_kernels(monkeypatch):
    def boom(*a, **k):
        raise AssertionError('the CPU path reached the CUDA kernel loader')
    monkeypatch.setattr(tf._kernels, 'load', boom)
    monkeypatch.setattr(tf._kernels, 'build', boom)
    before = tf.fused_bn_relu.launches
    x, s, b = _case((2, 16, 4, 4), 4)
    tf.fused_bn_relu(torch.from_numpy(x), torch.from_numpy(s),
                     torch.from_numpy(b))
    assert tf.fused_bn_relu.launches == before


@pytest.mark.parametrize('bad', ['dtype', 'scale_len', 'bias_2d', 'ndim',
                                 'noncontig', 'scale_dtype'])
def test_wrapper_rejects_bad_input(bad):
    x = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(0))
    s, b = torch.ones(8), torch.zeros(8)
    if bad == 'dtype':
        x = x.double()
    elif bad == 'scale_len':
        s = torch.ones(7)
    elif bad == 'bias_2d':
        b = torch.zeros(1, 8)
    elif bad == 'ndim':
        x = torch.randn(8)
    elif bad == 'noncontig':
        x = x.transpose(2, 3)
    elif bad == 'scale_dtype':
        s = torch.ones(8, dtype=torch.float64)
    with pytest.raises((TypeError, ValueError, MXNetError)):
        tf.fused_bn_relu(x, s, b)


# ---------------------------------------------------------------------------
# fused_scale_bias_dot against the JAX function (Pallas interpreter) and
# its custom_vjp.  Tolerances: float32 rtol 1e-5, atol 1e-6 (the same f32
# prologue; only the summation order of the product differs); bfloat16
# relative error <= 0.05 of the output's scale (bench.py's bf16 kernel
# parity bound: one bf16 rounding of inputs and output, and where no
# block divides the shape the JAX function falls back to its reference,
# whose affine runs in bf16).
# ---------------------------------------------------------------------------

DOT_SHAPES = [
    (256, 128, 64),        # every block divides: the Pallas kernel runs
    (64, 96, 160),
    (49, 40, 29),          # ragged: no block divides M, K or N
]


def _dot_case(mkn, seed):
    m, k, n = mkn
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            (rng.randn(k, n) / np.sqrt(k)).astype(np.float32),
            (rng.rand(k) + 0.5).astype(np.float32),
            (rng.randn(k) * 0.5).astype(np.float32))


def _jax_dot(args, relu, dtype, monkeypatch):
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    ja = [jnp.asarray(a).astype(dtype) for a in args]
    out = pf.fused_scale_bias_dot(*ja, relu=relu)
    return np.asarray(out.astype(jnp.float32))


def _rel(got, want):
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


@pytest.mark.parametrize('relu', [True, False], ids=['relu', 'affine'])
@pytest.mark.parametrize('mkn', DOT_SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_dot_f32_matches_jax(mkn, relu, monkeypatch):
    args = _dot_case(mkn, 5)
    got = tf.fused_scale_bias_dot(*[torch.from_numpy(a) for a in args],
                                  relu=relu)
    assert got.dtype == torch.float32 and got.shape == (mkn[0], mkn[2])
    want = _jax_dot(args, relu, jnp.float32, monkeypatch)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), tf.fused_scale_bias_dot_plain(
            *[torch.from_numpy(a) for a in args], relu=relu).numpy(),
        rtol=0, atol=0)


@pytest.mark.parametrize('mkn', DOT_SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_dot_bf16_matches_jax(mkn, monkeypatch):
    args = _dot_case(mkn, 6)
    got = tf.fused_scale_bias_dot(
        *[torch.from_numpy(a).to(torch.bfloat16) for a in args], relu=True)
    assert got.dtype == torch.bfloat16
    want = _jax_dot(args, True, jnp.bfloat16, monkeypatch)
    assert _rel(got.float().numpy(), want) <= 0.05


@pytest.mark.parametrize('relu', [True, False], ids=['relu', 'affine'])
@pytest.mark.parametrize('mkn', [(64, 96, 32), (49, 40, 29)],
                         ids=lambda s: 'x'.join(map(str, s)))
def test_dot_gradients_match_jax_vjp(mkn, relu, monkeypatch):
    """dx, dw, dscale, dbias of the autograd.Function against the JAX
    custom_vjp, at a random head gradient."""
    import jax
    args = _dot_case(mkn, 7)
    g = np.random.RandomState(8).randn(mkn[0], mkn[2]).astype(np.float32)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = tf.fused_scale_bias_dot(*ts, relu=relu)
    got = torch.autograd.grad(y, ts, torch.from_numpy(g))
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    _, vjp = jax.vjp(lambda *a: pf.fused_scale_bias_dot(*a, relu=relu),
                     *[jnp.asarray(a) for a in args])
    want = vjp(jnp.asarray(g))
    for name, a, b in zip(('dx', 'dw', 'dscale', 'dbias'), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_dot_cpu_path_never_touches_kernels(monkeypatch):
    def boom(*a, **k):
        raise AssertionError('the CPU path reached the CUDA kernel loader')
    monkeypatch.setattr(tf._kernels, 'load', boom)
    before = tf.fused_scale_bias_dot.launches
    tf.fused_scale_bias_dot(*[torch.from_numpy(a)
                              for a in _dot_case((8, 4, 3), 9)])
    assert tf.fused_scale_bias_dot.launches == before


@pytest.mark.parametrize('bad', ['w_dtype', 'w_shape', 'x_1d', 'scale_len',
                                 'w_noncontig'])
def test_dot_wrapper_rejects_bad_input(bad):
    x, w, s, b = [torch.from_numpy(a) for a in _dot_case((6, 4, 5), 10)]
    if bad == 'w_dtype':
        w = w.double()
    elif bad == 'w_shape':
        w = torch.zeros(3, 5)
    elif bad == 'x_1d':
        x = x.reshape(-1)
    elif bad == 'scale_len':
        s = torch.ones(3)
    elif bad == 'w_noncontig':
        w = torch.zeros(5, 4).t()
    with pytest.raises((TypeError, ValueError, MXNetError)):
        tf.fused_scale_bias_dot(x, w, s, b)
