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
