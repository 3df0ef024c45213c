"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points never fall back to the CPU on their own."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import resnet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'mxnet_tpu_torch')
# an import statement naming jax, or mxnet_tpu itself (not mxnet_tpu_torch)
_FORBIDDEN = re.compile(
    r'^\s*(?:from|import)\s+(?:jax\b|mxnet_tpu(?!_torch)\b)', re.M)


def _sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, 'chip_smoke.py')


def test_import_leaves_jax_out():
    code = ('import sys, mxnet_tpu_torch, mxnet_tpu_torch.serving, '
            'mxnet_tpu_torch.models.resnet, mxnet_tpu_torch.module, '
            'mxnet_tpu_torch.parallel.train_step, '
            'mxnet_tpu_torch.ops.fused_conv, mxnet_tpu_torch.ops.attention, '
            'mxnet_tpu_torch.models.transformer_lm, '
            'mxnet_tpu_torch.operator, mxnet_tpu_torch.rtc, '
            'mxnet_tpu_torch.rnn, mxnet_tpu_torch.module.bucketing_module, '
            'mxnet_tpu_torch.parallel.ring, mxnet_tpu_torch.parallel.sp, '
            'mxnet_tpu_torch.model, mxnet_tpu_torch.resilience, '
            'mxnet_tpu_torch.ops.optim, mxnet_tpu_torch.models.lenet, '
            'mxnet_tpu_torch.module.sequential_module, '
            'mxnet_tpu_torch.module.python_module, '
            'mxnet_tpu_torch.monitor, mxnet_tpu_torch.models.alexnet, '
            'mxnet_tpu_torch.ops.rnn_op, mxnet_tpu_torch.ops.ctc, '
            'mxnet_tpu_torch.ops.vision, mxnet_tpu_torch.ops.multibox, '
            'mxnet_tpu_torch.rnn.rnn_cell, mxnet_tpu_torch.models.ssd, '
            'mxnet_tpu_torch.models.lstm_lm, mxnet_tpu_torch.models.vgg, '
            'mxnet_tpu_torch.models.inception_v3, '
            'mxnet_tpu_torch.models.inception_bn, '
            'mxnet_tpu_torch.models.googlenet, '
            'mxnet_tpu_torch.models.resnext, '
            'mxnet_tpu_torch.models.inception_resnet_v2; '
            'bad = sorted(m for m in sys.modules if m == "jax" or '
            'm.startswith("jax.") or m == "mxnet_tpu" or '
            'm.startswith("mxnet_tpu.")); print(bad); '
            'sys.exit(1 if bad else 0)')
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize('path', sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    with open(path) as f:
        src = f.read()
    assert not _FORBIDDEN.search(src), path


def test_sources_cover_every_subpackage():
    found = {os.path.relpath(os.path.dirname(p), PKG) for p in _sources()
             if p.startswith(PKG)}
    assert {'.', 'rnn', 'module', 'parallel', 'ops', 'models',
            'serving'} <= found


def test_gpu_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    sym = resnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                        filter_list=[8, 16, 32, 64, 128], num_classes=10,
                        image_shape=(3, 64, 64))
    with pytest.raises(tmx.MXNetError, match='CUDA'):
        tmx.Predictor(sym.tojson(), {}, {'data': (1, 3, 64, 64)})
    server = tmx.serving.ModelServer()
    with pytest.raises(tmx.MXNetError, match='CUDA'):
        server.load_model('m', symbol_json=sym.tojson(), params={},
                          input_shapes={'data': (1, 3, 64, 64)})
    with pytest.raises(tmx.MXNetError, match='CUDA'):
        tmx.nd.zeros((2, 2), tmx.gpu())
    with pytest.raises(tmx.MXNetError, match='CUDA'):
        tmx.Module(sym)
    with pytest.raises(tmx.MXNetError, match='CUDA'):
        tmx.mod.Module(sym, context=tmx.gpu(0))
    # FeedForward's ctx and Module.load's context default to the card too
    x = np.zeros((4, 3, 64, 64), np.float32)
    with pytest.raises(tmx.MXNetError, match='CUDA'):
        tmx.FeedForward(sym, num_epoch=1).fit(x, np.zeros(4, np.float32))
    prefix = str(tmp_path / 'ck')
    tmx.model.save_checkpoint(prefix, 1, sym,
                              {'fc1_bias': tmx.nd.zeros((10,))}, {})
    with pytest.raises(tmx.MXNetError, match='CUDA'):
        tmx.mod.Module.load(prefix, 1)
    # predictor.load serves on the card too (the JAX default is the CPU)
    with pytest.raises(tmx.MXNetError, match='CUDA'):
        tmx.predictor.load(prefix, 1, {'data': (1, 3, 64, 64)})
    gen = tmx.models.transformer_lm.sym_gen_bucketing(
        vocab_size=10, num_embed=8, num_heads=2, num_layers=1, max_seq_len=4)
    with pytest.raises(tmx.MXNetError, match='CUDA'):
        tmx.mod.BucketingModule(gen, default_bucket_key=4).bind(
            [('data', (1, 4))], [('softmax_label', (1, 4))])
    # outside a with scope, creation from no input array runs on the card
    for make in (lambda: tmx.nd.ones((2,)), lambda: tmx.nd.full((2,), 1.0),
                 lambda: tmx.nd.empty((2,)), lambda: tmx.nd.arange(3),
                 lambda: tmx.nd._ones(shape=(2,)),
                 lambda: tmx.random.uniform(shape=(2,))):
        with pytest.raises(tmx.MXNetError, match='CUDA'):
            make()
    # a CUDA-source Rtc has no CPU form: on CPU arrays it raises
    x = tmx.nd.zeros((4,))
    k = tmx.rtc.Rtc('copy', [('x', x)], [('y', x)], 'y[0] = x[0];')
    with pytest.raises(tmx.MXNetError, match='CUDA'):
        k.push([x], [tmx.nd.zeros((4,))])
