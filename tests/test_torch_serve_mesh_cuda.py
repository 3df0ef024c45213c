"""Tensor-parallel serving on the card (marked ``cuda``; they skip without
a CUDA device).  On the GPU host:

    python -m pytest tests/test_torch_serve_mesh_cuda.py -q -m cuda --noconftest

A narrow ResNet v2 served by ``Predictor(mesh='1x2' | '2x1',
partition='auto', devices=[gpu(0), gpu(0)])`` behind a ``ModelServer``:
after ``warm_buckets`` every (bucket, slot) forward is a captured graph,
the hot path takes no capture (``compile.traces``), and each response is
bit for bit the unsharded Predictor's on the slot's ``B/dp`` rows (TF32
off, cuDNN deterministic).  The tp-sharded parameters stay shards: each
position holds its shard's bytes, as ``sharding_records()`` says.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import compile_cache, convert, instrument
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.serving import ModelServer

pytestmark = pytest.mark.cuda

WAIT = 120
SHAPE = (8, 3, 32, 32)


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the slot forwards replay CUDA '
                    'graphs)')
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    return torch.device('cuda', 0)


def _model():
    sym = resnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                        filter_list=[8, 16, 32, 64, 128], num_classes=10,
                        image_shape=SHAPE[1:])
    arg, aux = convert.random_params(sym, {'data': SHAPE}, seed=5)
    data = np.random.RandomState(6).randn(64, *SHAPE[1:]).astype(
        np.float32)
    return sym.tojson(), convert.params_from_numpy(arg, aux, 'cuda:0'), \
        data


@pytest.mark.parametrize('mesh', ('1x2', '2x1'))
def test_sharded_replica_bit_for_bit_with_no_hot_path_capture(dev, mesh):
    sym_json, params, data = _model()
    dp, tp = (int(v) for v in mesh.split('x'))
    sp = tmx.Predictor(sym_json, params, {'data': SHAPE}, mesh=mesh,
                       partition='auto', devices=[tmx.gpu(0)] * 2)
    ref = tmx.Predictor(sym_json, params, {'data': SHAPE},
                        pad_to_bucket=True)
    ref.warm_buckets(SHAPE[0])
    was = instrument.metrics_enabled()
    instrument.set_metrics(True)
    server = ModelServer(max_delay_ms=0, max_batch=SHAPE[0])
    try:
        server.load_model('m', predictor=sp, input_shapes={'data': SHAPE})
        steps = [s['step'] for e in sp._slots.values() for s in e['slots']]
        assert len(steps) == dp * sum(1 for b in (1, 2, 4, 8) if b >= dp)
        assert all(s.captured for s in steps)
        traces = instrument.counter_value('compile.traces')
        calls = instrument.counter_value('serving.sharded_aot_calls')
        cases = [(0, 1), (1, 4), (4, 7), (7, 15), (15, 18)]
        outs = [server.predict('m', timeout=WAIT, data=data[a:b])[0]
                for a, b in cases]
        assert instrument.counter_value('compile.traces') == traces
        assert instrument.counter_value('serving.sharded_aot_calls') == \
            calls + len(cases)
        for (a, b), got in zip(cases, outs):
            rows = b - a
            bucket = compile_cache.pad_to_bucket(rows, minimum=dp)
            per = bucket // dp
            x = np.concatenate([data[a:b], np.zeros(
                (bucket - rows,) + SHAPE[1:], np.float32)])
            want = []
            for d in range(dp):
                ref.forward(data=x[d * per:(d + 1) * per])
                want.append(ref.get_output(0))
            want = np.concatenate(want)[:rows]
            assert got.shape == (rows, 10) and np.array_equal(got, want)
        recs = sp.sharding_records()['params']
        assert any('tp' in r['spec'] for r in recs.values()) == (tp > 1)
        for name, grid in sp._params.items():
            for row in grid:
                for shard in row:
                    assert shard.is_cuda and shard.numel() * \
                        shard.element_size() == recs[name]['shard_bytes']
    finally:
        server.close(drain=False)
        instrument.set_metrics(was)
