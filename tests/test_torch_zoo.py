"""The model zoo of the PyTorch port against the JAX package on the CPU.

- ``models.list_models()`` is the same list in both packages, and every
  name's ``get_symbol(...).tojson()`` is the same JSON (bit-exact).
- The forwards of every image classifier against the JAX package are in
  ``tests/test_torch_zoo_forward.py``.
- Under ``MXTPU_FUSE=aggressive`` the step compiler rewrites Inception-v3,
  VGG-16 and ResNeXt-50 into the same fused graphs in both packages (the
  JAX side with its Pallas kernels interpreted, so its kernel-gated
  passes fire), with the kernel node counts the card phase expects."""
from collections import Counter

import pytest

from mxnet_tpu import fuse as jfuse
from mxnet_tpu import models as jmodels
from mxnet_tpu.base import NameManager as JNames
from mxnet_tpu_torch import fuse as tfuse
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.base import NameManager as TNames

KWARGS = {'ssd-vgg16': {'num_classes': 20},
          'ssd-vgg16-train': {'num_classes': 20},
          'lstm_lm': {'vocab_size': 100, 'num_embed': 8, 'num_hidden': 8,
                      'seq_len': 4},
          'transformer_lm': {'vocab_size': 100, 'num_embed': 16,
                             'num_heads': 2, 'num_layers': 1,
                             'seq_len': 8}}


def test_list_models_matches_jax():
    assert tmodels.list_models() == jmodels.list_models()
    for name in ('resnet-50', 'vgg16', 'inception-v3', 'ssd-vgg16',
                 'lstm_lm'):
        assert name in tmodels.list_models()


@pytest.mark.parametrize('name', jmodels.list_models())
def test_symbol_json_matches_jax(name):
    kw = KWARGS.get(name, {})
    with TNames():
        got = tmodels.get_symbol(name, **kw).tojson()
    with JNames():
        want = jmodels.get_symbol(name, **kw).tojson()
    assert got == want


def test_unknown_model_raises_as_in_jax():
    for models in (tmodels, jmodels):
        with pytest.raises(ValueError, match='unknown model'):
            models.get_symbol('resnet-51')


def _fused(fuse, sym, is_train):
    out = fuse.apply_fuse_passes(sym, is_train, 'aggressive')
    return [(n.op, n.name) for n in out.topo_nodes() if not n.is_variable]


@pytest.mark.parametrize('name,is_train,kernels', [
    ('inception-v3', True, {'_bn_relu': 84, '_bn_relu_conv': 10}),
    ('inception-v3', False, {'_conv_bn_folded': 94}),
    ('vgg16', True, {'_fused_epilogue': 15}),
    ('resnext-50', True, {'_bn_relu_conv': 16, '_bn_relu': 17})],
    ids=['inception-v3-train', 'inception-v3-infer', 'vgg16', 'resnext-50'])
def test_aggressive_fusion_matches_jax(name, is_train, kernels,
                                       monkeypatch):
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    with TNames():
        tsym = tmodels.get_symbol(name, num_classes=1000)
    with JNames():
        jsym = jmodels.get_symbol(name, num_classes=1000)
    got, want = _fused(tfuse, tsym, is_train), _fused(jfuse, jsym, is_train)
    assert got == want
    ops = Counter(op for op, _ in got)
    for op, count in kernels.items():
        assert ops[op] == count, (op, ops[op])


def test_op_registry_holds_every_jax_op():
    """Every op name of the JAX package's registry is registered in the
    port (the port adds its fused ops' names)."""
    from mxnet_tpu.ops import list_ops as jax_ops
    from mxnet_tpu_torch.ops import list_ops as torch_ops
    assert sorted(set(jax_ops()) - set(torch_ops())) == []
