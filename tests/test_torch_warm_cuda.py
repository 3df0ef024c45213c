"""Warm starts on the card (``@pytest.mark.cuda``; they skip without a
CUDA device, and import no jax, so they run on the GPU host:
``python -m pytest tests/test_torch_warm_cuda.py -q -m cuda
--noconftest``).

- The cubin store across processes: a cold child compiles an Rtc kernel
  with NVRTC and stores its cubin under ``MXTPU_COMPILE_CACHE``; a warm
  child compiles nothing (``rtc.compiles`` 0, one ``compile.cache_hits``)
  and its outputs are bit for bit the cold child's.
- A warm start from the manifest: after a fit over 4-, 4- and 2-row
  batches has recorded both signatures, a fresh module's warm-started
  fit captures both before its first batch (``compile.warmup_traces``
  2), none on the hot path (``compile.traces`` 0); with batch-end
  callbacks that drain the metric (Speedometer) and read the
  parameters, its readings and parameters are bit for bit the cold
  fit's, and a set_params after fit stays as it was set (a set_params
  between batches drops the module's graphs, so it is not made here)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import compile_cache, instrument


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (NVRTC and CUDA graphs)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda', 0)


@pytest.fixture(autouse=True)
def _uninstalled(monkeypatch):
    for k in ('MXTPU_COMPILE_CACHE', 'MXTPU_WARM_START', 'MXTPU_FUSE'):
        monkeypatch.delenv(k, raising=False)
    compile_cache._cache_dir = compile_cache._manifest = None
    yield
    compile_cache._cache_dir = compile_cache._manifest = None


_RTC_CHILD = textwrap.dedent('''
    import json
    import numpy as np
    import torch
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import instrument
    k = tmx.rtc.Rtc('axpy_warm', [('x', tmx.nd.zeros((1,)))],
                    [('y', tmx.nd.zeros((1,)))],
                    'int i = blockIdx.x * blockDim.x + threadIdx.x;'
                    ' if (i < 1000) y[i] = 2.5f * x[i] + 1.0f;')
    x = tmx.nd.array(np.linspace(-3, 3, 1000, dtype=np.float32),
                     ctx=tmx.gpu(0))
    y = tmx.nd.zeros((1000,), ctx=tmx.gpu(0))
    k.push([x], [y], grid_dims=(4,), block_dims=(256,))
    print(json.dumps({
        'y': y.asnumpy().tobytes().hex(),
        'compiles': instrument.counter_value('rtc.compiles'),
        'hits': instrument.counter_value('compile.cache_hits'),
        'misses': instrument.counter_value('compile.cache_misses')}))
''')


@pytest.mark.cuda
def test_rtc_cubin_store_across_processes(dev, tmp_path):
    script = tmp_path / 'rtc_child.py'
    script.write_text(_RTC_CHILD)
    env = dict(os.environ, PYTHONPATH=os.getcwd(),
               MXTPU_COMPILE_CACHE=str(tmp_path / 'cache'))
    runs = []
    for _ in range(2):
        done = subprocess.run([sys.executable, str(script)], env=env,
                              capture_output=True, text=True, timeout=300)
        assert done.returncode == 0, done.stderr
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    assert (cold['compiles'], cold['hits'], cold['misses']) == (1, 0, 1)
    assert (warm['compiles'], warm['hits'], warm['misses']) == (0, 1, 0)
    assert warm['y'] == cold['y']
    assert len(os.listdir(str(tmp_path / 'cache' / 'rtc'))) == 1


class _Iter(tmx.io.DataIter):
    """Batches of 4, 4 and 2 rows: two signatures."""

    def __init__(self, x, y):
        super().__init__()
        self.x, self.y, self.i = x, y, 0
        self.batch_size = 4

    @property
    def provide_data(self):
        return [('data', (4, 6))]

    @property
    def provide_label(self):
        return [('softmax_label', (4,))]

    def reset(self):
        self.i = 0

    def next(self):
        if self.i >= len(self.x):
            raise StopIteration
        j = self.i = self.i + 4
        return tmx.io.DataBatch([tmx.nd.array(self.x[j - 4:j])],
                                [tmx.nd.array(self.y[j - 4:j])], pad=0)


def _mlp():
    net = tmx.sym.FullyConnected(tmx.sym.Variable('data'), num_hidden=16,
                                 name='fc1')
    net = tmx.sym.Activation(net, act_type='relu', name='relu1')
    net = tmx.sym.FullyConnected(net, num_hidden=5, name='fc2')
    return tmx.sym.SoftmaxOutput(net, name='softmax')


@pytest.mark.cuda
def test_warm_start_captures_the_manifest_signatures_off_the_hot_path(
        dev, tmp_path, monkeypatch):
    monkeypatch.setenv('MXTPU_COMPILE_CACHE', str(tmp_path))
    rng = np.random.RandomState(0)
    x = rng.randn(10, 6).astype(np.float32)
    y = rng.randint(0, 5, 10).astype(np.float32)
    rng = np.random.RandomState(1)
    arg = {'fc1_weight': rng.randn(16, 6).astype(np.float32) * 0.3,
           'fc1_bias': np.zeros(16, np.float32),
           'fc2_weight': rng.randn(5, 16).astype(np.float32) * 0.3,
           'fc2_bias': np.zeros(5, np.float32)}
    got, readings = [], []
    for warm in (False, True):
        traces = instrument.counter_value('compile.traces')
        warmed = instrument.counter_value('compile.warmup_traces')
        m = tmx.Module(_mlp(), context=tmx.gpu(0))
        seen = []

        def touch(param, m=m, seen=seen):
            seen.append(param.eval_metric.get_name_value())
            seen.append(sorted((k, v.asnumpy().tobytes()) for k, v in
                               m.get_params()[0].items()))
        m.fit(_Iter(x, y), num_epoch=2, optimizer='sgd',
              optimizer_params={'learning_rate': 0.1, 'momentum': 0.9},
              eval_metric='acc', warm_start=warm,
              batch_end_callback=[touch,
                                  tmx.callback.Speedometer(4, frequent=1)],
              arg_params={k: tmx.nd.array(v) for k, v in arg.items()})
        hot = instrument.counter_value('compile.traces') - traces
        off = instrument.counter_value('compile.warmup_traces') - warmed
        assert (hot, off) == ((0, 2) if warm else (2, 0)), (warm, hot, off)
        assert all(c.captured and c.replays >= 1
                   for c in m._graphs.values()) and len(m._graphs) == 2
        got.append({k: v.asnumpy() for k, v in m.get_params()[0].items()})
        readings.append(seen)
    assert readings[0] == readings[1] and len(readings[0]) == 12
    for k in got[0]:
        assert np.array_equal(got[0][k], got[1][k]), k
    new = {k: tmx.nd.array(v * 2) for k, v in arg.items()}
    m.set_params(new, {})
    torch.cuda.synchronize()
    for k, v in m.get_params()[0].items():
        assert np.array_equal(v.asnumpy(), new[k].asnumpy()), k
