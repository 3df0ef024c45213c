"""The card's side of this slice (``@pytest.mark.cuda``; they skip without
a CUDA device and import no jax: ``python -m pytest
tests/test_torch_kv_cuda.py -q -m cuda --noconftest``).

- The capture the device feed's fit used to lose: 6 child processes of
  3 small MLP fits each (``tools/torch_feed_capture.py --lever``: the
  previous fit's module is cyclic garbage and a full collection runs
  inside every recording, the way the fault struck), feed on: 0 red.
  Before the repair the same children were red 6 of 6.
- A context list on one card, ``Module(context=[gpu(0), gpu(0)])`` with
  ``kvstore='local'``: a narrow ResNet v2 (f32, ``MXTPU_FUSE=aggressive``,
  TF32 off, cuDNN deterministic) against a one-context fit at the whole
  batch (the executors share their BatchNorm statistics, so the two
  compute the same step); each executor launches the training graph's
  kernels once a step."""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.ops import fused, fused_conv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA graphs, the kernels)')
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device('cuda', 0)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True


@pytest.mark.cuda
def test_feed_capture_reproduction_is_green_in_six_children(dev):
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    try:
        import torch_feed_capture
    finally:
        sys.path.pop(0)
    out = torch_feed_capture.run(children=6, fits=3, parallel=6,
                                 diagnose=False, feed=True, lever=True,
                                 root=ROOT, timeout=110)
    assert out['red'] == 0, out['runs']
    assert all(r['graph_resets_in_capture'] == 0 for r in out['runs'])


def _narrow():
    return resnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                         filter_list=[8, 16, 32, 64, 128], num_classes=10,
                         image_shape=(3, 64, 64))


@pytest.mark.cuda
def test_context_list_on_one_card_matches_one_context(dev, monkeypatch):
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    batch, steps = 8, 3
    sym = _narrow()
    arg, aux = convert.random_params(sym, {'data': (batch, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((batch * steps, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, batch * steps).astype(np.float32)
    kernels = (fused.fused_scale_bias_dot,
               fused_conv.fused_scale_bias_conv3x3, fused.fused_bn_relu)

    def fit(ctx):
        m = tmx.Module(sym, context=ctx)
        m.fit(tmx.io.NDArrayIter(x, y, batch_size=batch), num_epoch=1,
              kvstore='local', optimizer='sgd', optimizer_params=OPT,
              arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
              aux_params={k: tmx.nd.array(v) for k, v in aux.items()})
        torch.cuda.synchronize()
        return m
    before = [k.launches for k in kernels]
    m = fit([tmx.gpu(0), tmx.gpu(0)])
    per_step = [(k.launches - b) / steps for k, b in zip(kernels, before)]
    # 16 _bn_relu_conv nodes (1x1: 12, 3x3: 4) and the BN-ReLUs, per
    # executor, two executors
    assert per_step[0] > 0 and per_step[1] > 0 and per_step[2] > 0
    assert all(p % 2 == 0 for p in per_step), per_step
    got = {k: v.asnumpy() for k, v in m.get_params()[0].items()}
    one = fit(tmx.gpu(0)).get_params()[0]
    want = {k: v.asnumpy() for k, v in one.items()}
    for k in arg:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert max(float(np.abs(got[k] - arg[k]).max()) for k in arg) > 1e-3
