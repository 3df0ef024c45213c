"""The card's side of the dp×tp mesh (``@pytest.mark.cuda``; they skip
without a CUDA device and import no jax: ``python -m pytest
tests/test_torch_mesh_cuda.py -q -m cuda --noconftest``).

- ``mesh='1x1'`` on the card: the narrow ResNet v2 (bf16 compute,
  ``MXTPU_FUSE=aggressive``, cuDNN deterministic, 2 captured steps) is
  bit for bit the unmeshed fit (parameters, aux, the metric), both
  captured, at the same launches per step of #1, #4 and #2.
- Two ranks on gloo on the one card (``torch.multiprocessing.spawn``,
  ``tests/torch_mesh_ranks.py``'s 'card' suite): the narrow ResNet's f32
  fit on '2x1' against a one-process '1x1' eager fit over the same rows,
  rtol 1e-4 and atol 1e-5 (f32 sums in another order over the steps, the
  bound of tests/test_torch_train.py), every rank equal and each launching
  the one-process step's kernels."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import fused, fused_conv

import torch_mesh_ranks as R

KERNELS = (fused.fused_scale_bias_dot, fused_conv.fused_scale_bias_conv3x3,
           fused.fused_bn_relu)


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA graphs, the kernels)')
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device('cuda', 0)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True


def _fit(dtype=None, **kw):
    sym, arg, aux, x, y = R.resnet_case(tmx)
    for k in KERNELS:
        k.launches = 0
    mod = R.fit(tmx, sym, arg, aux, x, y, R.RESNET_BATCH, R.RESNET_OPT,
                module=tmx.mod.Module(sym, context=tmx.gpu(0),
                                      compute_dtype=dtype), **kw)
    torch.cuda.synchronize()
    return mod, {k.__name__: k.launches for k in KERNELS}


@pytest.mark.cuda
def test_mesh_1x1_captured_is_the_unmeshed_fit(dev):
    base, base_launches = _fit(torch.bfloat16)
    one, one_launches = _fit(torch.bfloat16, mesh='1x1', partition='auto')
    for m in (base, one):
        assert m._graphs and all(c.captured for c in m._graphs.values())
    want, got = R.params_of(base), R.params_of(one)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert one_launches == base_launches
    assert all(v > 0 for v in one_launches.values())


@pytest.mark.cuda
def test_two_ranks_on_the_card_match_one_process(dev, tmp_path):
    tmx.engine.set_engine_type('NaiveEngine')
    try:
        one, launches = _fit(mesh='1x1')
    finally:
        tmx.engine.set_engine_type('ThreadedEnginePerDevice')
    want = R.params_of(one)
    ranks = R.spawn('card', 2, str(tmp_path))
    for arrays, numbers in ranks:
        assert sorted(arrays) == sorted(want)
        for k in want:
            np.testing.assert_allclose(arrays[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
            np.testing.assert_array_equal(arrays[k], ranks[0][0][k])
        assert numbers['launches'] == launches
