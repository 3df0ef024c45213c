"""Tests of the PyTorch port that need the card: the fused_bn_relu CUDA
kernel against its plain version, and a small fused Predictor on the GPU
against the CPU.  Marked ``cuda``; they skip on a host without a CUDA
device.  On the GPU host:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.ops import fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda', 0)


def _case(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    s = (torch.rand(c, generator=g, device=dev) + 0.5).to(dtype)
    b = (torch.randn(c, generator=g, device=dev) * 0.5).to(dtype)
    return x, s, b


@pytest.mark.parametrize('shape', [(4, 64, 56, 56), (3, 2048, 7, 7),
                                   (49, 96), (5, 37, 9, 11), (1, 3, 1, 1)],
                         ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_kernel_matches_plain(shape, dtype, dev):
    x, s, b = _case(shape, dtype, dev)
    before = fused.fused_bn_relu.launches
    got = fused.fused_bn_relu(x, s, b)
    torch.cuda.synchronize()
    assert fused.fused_bn_relu.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape and got.is_cuda
    # separately rounded multiply and add: bit-identical to the plain form
    assert torch.equal(got, fused.fused_bn_relu_plain(x, s, b))


def test_unaligned_view_takes_scalar_path(dev):
    base = torch.randn(1 + 2 * 64 * 9, device=dev)
    x = base[1:].view(2, 64, 3, 3)
    s, b = torch.rand(64, device=dev) + 0.5, torch.randn(64, device=dev)
    assert torch.equal(fused.fused_bn_relu(x, s, b),
                       fused.fused_bn_relu_plain(x, s, b))


def test_kernel_rejects_what_it_cannot_take(dev):
    x, s, b = _case((2, 8, 4, 4), torch.float32, dev)
    with pytest.raises(ValueError):
        fused.fused_bn_relu(x.transpose(2, 3), s, b)
    with pytest.raises(ValueError):
        fused.fused_bn_relu(x, s.cpu(), b)
    with pytest.raises(TypeError):
        fused.fused_bn_relu(x.half(), s, b)


def _rel_err(got, want):
    """max |got - want| over max |want|: the error scaled to the output."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# f32: rtol 1e-4 of the output's scale (summation order differs from
# cuBLAS/cuDNN); bf16: 2e-2 (one bf16 rounding of the output, plus order)
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize('mkn', [(100352, 64, 256), (1568, 2048, 512),
                                 (6272, 1024, 256), (37, 40, 29),
                                 (1000, 3, 130)],
                         ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('relu', [True, False], ids=['relu', 'affine'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_scale_bias_dot_matches_plain(mkn, relu, dtype, dev):
    m, k, n = mkn
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(dtype)
    s = torch.rand(k, generator=g, device=dev) + 0.5
    b = torch.randn(k, generator=g, device=dev) * 0.5
    before = fused.fused_scale_bias_dot.launches
    got = fused.fused_scale_bias_dot(x, w, s, b, relu=relu)
    torch.cuda.synchronize()
    assert fused.fused_scale_bias_dot.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n) and got.is_cuda
    want = fused.fused_scale_bias_dot_plain(x, w, s, b, relu=relu)
    assert _rel_err(got, want) <= _TOL[dtype]


@pytest.mark.parametrize('shape', [(32, 56, 56, 64, 64, 1),
                                   (32, 56, 56, 128, 128, 2),
                                   (32, 7, 7, 512, 512, 1),
                                   (3, 9, 11, 20, 24, 2),
                                   (2, 5, 5, 7, 3, 1)],
                         ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_scale_bias_conv3x3_matches_plain(shape, dtype, dev, monkeypatch):
    from mxnet_tpu_torch.ops import fused_conv
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    n, h, wd, c, f, stride = shape
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(n, h, wd, c, generator=g, device=dev).to(dtype)
    w = (torch.randn(3, 3, c, f, generator=g, device=dev)
         / (9 * c) ** 0.5).to(dtype)
    s = torch.rand(c, generator=g, device=dev) + 0.5
    b = torch.randn(c, generator=g, device=dev) * 0.5
    for relu in (True, False):
        before = fused_conv.fused_scale_bias_conv3x3.launches
        got = fused_conv.fused_scale_bias_conv3x3(x, w, s, b, stride, relu)
        torch.cuda.synchronize()
        assert fused_conv.fused_scale_bias_conv3x3.launches == before + 1
        want = fused_conv.fused_scale_bias_conv3x3_plain(x, w, s, b, stride,
                                                         relu)
        assert got.shape == want.shape and got.dtype == dtype
        assert _rel_err(got, want) <= _TOL[dtype]


def test_fused_kernels_reject_what_they_cannot_take(dev):
    from mxnet_tpu_torch.ops import fused_conv
    x = torch.randn(4, 8, device=dev)
    w = torch.randn(8, 5, device=dev)
    s, b = torch.ones(8, device=dev), torch.zeros(8, device=dev)
    with pytest.raises(ValueError):
        fused.fused_scale_bias_dot(x, w.t().contiguous().t(), s, b)
    with pytest.raises(TypeError):
        fused.fused_scale_bias_dot(x, w.bfloat16(), s, b)
    xc = torch.randn(1, 4, 4, 8, device=dev)
    wc = torch.randn(3, 3, 8, 2, device=dev)
    with pytest.raises(ValueError):
        fused_conv.fused_scale_bias_conv3x3(xc, wc, s, b, stride=3)
    with pytest.raises(ValueError):
        fused_conv.fused_scale_bias_conv3x3(xc, wc, s.cpu(), b)


def test_small_resnet_on_gpu_matches_cpu(dev, monkeypatch):
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    sym = resnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                        filter_list=[8, 16, 32, 64, 128], num_classes=10,
                        image_shape=(3, 64, 64))
    arg, aux = convert.random_params(sym, {'data': (4, 3, 64, 64)}, 0)
    data = np.random.default_rng(1).standard_normal((4, 3, 64, 64),
                                                    dtype=np.float32)
    outs = {}
    for dt in ('gpu', 'cpu'):
        dev_s = 'cuda:0' if dt == 'gpu' else 'cpu'
        pred = tmx.Predictor(sym.tojson(),
                             convert.params_from_numpy(arg, aux, dev_s),
                             {'data': (4, 3, 64, 64)}, dev_type=dt)
        before = fused.fused_bn_relu.launches
        pred.forward(data=data)
        outs[dt] = pred.get_output(0)
        launched = fused.fused_bn_relu.launches - before
        assert launched == (5 if dt == 'gpu' else 0)
    np.testing.assert_allclose(outs['gpu'], outs['cpu'], rtol=1e-3,
                               atol=1e-6)
