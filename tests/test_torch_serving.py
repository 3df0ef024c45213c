"""The serving slice as a whole: a small bottleneck ResNet v2 with weights
from a numpy seed goes through the JAX package's Predictor and through
the PyTorch port's Predictor and ModelServer (MXTPU_FUSE=aggressive,
pow2 buckets), on the CPU.

Tolerance rtol 1e-4 / atol 1e-5 against the JAX package: some sixteen
conv/matmul layers sum in another order in XLA and in PyTorch's CPU
kernels.  Within the port, a server response equals a direct Predictor
forward on the same rows."""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.models import resnet as jax_resnet
from mxnet_tpu.predictor import Predictor as JaxPredictor
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.ops import fused
from mxnet_tpu_torch.serving import (DynamicBatcher, ModelServer,
                                     ServerOverloadedError)

KW = dict(units=[1, 1, 1, 1], num_stages=4,
          filter_list=[8, 16, 32, 64, 128], num_classes=10,
          image_shape=(3, 64, 64))
SHAPE = (4, 3, 64, 64)


@pytest.fixture(scope='module')
def model():
    with mx.base.NameManager():
        sym_json = jax_resnet.resnet(**KW).tojson()
    arg, aux = convert.random_params(tmx.sym.load_json(sym_json),
                                     {'data': SHAPE}, seed=7)
    data = np.random.RandomState(8).randn(*SHAPE).astype(np.float32)
    return sym_json, arg, aux, data


@pytest.fixture
def aggressive(monkeypatch):
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')


def _jax_outputs(sym_json, arg, aux, data, rows_list):
    params = {'arg:' + k: mx.nd.array(v) for k, v in arg.items()}
    params.update({'aux:' + k: mx.nd.array(v) for k, v in aux.items()})
    pred = JaxPredictor(sym_json, params, {'data': SHAPE},
                        pad_to_bucket=True)
    out = {}
    for rows in rows_list:
        pred.forward(data=data[:rows])
        out[rows] = pred.get_output(0)
    return out


def _port_predictor(sym_json, arg, aux):
    return tmx.Predictor(sym_json, convert.params_from_numpy(arg, aux, 'cpu'),
                         {'data': SHAPE}, dev_type='cpu', pad_to_bucket=True)


def test_predictor_matches_jax(model, aggressive):
    sym_json, arg, aux, data = model
    want = _jax_outputs(sym_json, arg, aux, data, (1, 3, 4))
    pred = _port_predictor(sym_json, arg, aux)
    for rows in (1, 3, 4):
        pred.forward(data=data[:rows])
        got = pred.get_output(0)
        assert got.shape == (rows, 10)
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want[rows], rtol=1e-4, atol=1e-5)
    # the fused graph ran: 5 BN->relu chains on the fused_bn_relu op
    prog = pred._bucket_execs[4]._program_symbol(False)
    ops = [n.op for n in prog.topo_nodes() if not n.is_variable]
    assert ops.count('_bn_relu') == 5 and ops.count('_conv_bn_folded') == 9


def test_predictor_params_as_bytes(model, aggressive, tmp_path):
    """The .params bytes path: written by the JAX package, served by the
    port, same outputs as the dict path."""
    sym_json, arg, aux, data = model
    path = str(tmp_path / 'm.params')
    saved = {'arg:' + k: mx.nd.array(v) for k, v in arg.items()}
    saved.update({'aux:' + k: mx.nd.array(v) for k, v in aux.items()})
    mx.nd.save(path, saved)
    with open(path, 'rb') as f:
        pred = tmx.Predictor(sym_json, f.read(), {'data': SHAPE},
                             dev_type='cpu')
    ref = _port_predictor(sym_json, arg, aux)
    got = pred.forward(data=data)[0].asnumpy()
    np.testing.assert_array_equal(got, ref.forward_exact(data=data)[0]
                                  .asnumpy())


def test_model_server_matches_predictor_and_jax(model, aggressive):
    sym_json, arg, aux, data = model
    want = _jax_outputs(sym_json, arg, aux, data, (1, 3, 4))
    direct = _port_predictor(sym_json, arg, aux)
    server = ModelServer(max_delay_ms=0.0, max_batch=4, dev_type='cpu')
    try:
        server.load_model('resnet', symbol_json=sym_json,
                          params=convert.params_from_numpy(arg, aux, 'cpu'),
                          input_shapes={'data': SHAPE})
        for rows in (1, 3, 4):
            got = server.predict('resnet', data=data[:rows])[0]
            direct.forward(data=data[:rows])
            np.testing.assert_array_equal(got, direct.get_output(0))
            np.testing.assert_allclose(got, want[rows], rtol=1e-4,
                                       atol=1e-5)
    finally:
        server.close()


def test_model_server_coalesces_into_one_bucket(model, aggressive):
    """Requests of 1 + 3 rows queued inside one delay window ride one
    flush of 4 rows; each gets its own rows back."""
    sym_json, arg, aux, data = model
    direct = _port_predictor(sym_json, arg, aux)
    server = ModelServer(max_delay_ms=500.0, max_batch=4, dev_type='cpu')
    try:
        server.load_model('resnet', symbol_json=sym_json,
                          params=convert.params_from_numpy(arg, aux, 'cpu'),
                          input_shapes={'data': SHAPE})
        f1 = server.submit('resnet', data=data[:1])
        f3 = server.submit('resnet', data=data[1:4])
        got = np.concatenate([f1.result(timeout=60)[0],
                              f3.result(timeout=60)[0]])
        assert server._entry('resnet').batcher.last_flush_rows == 4
        direct.forward(data=data)
        np.testing.assert_allclose(got, direct.get_output(0), rtol=1e-5,
                                   atol=1e-6)
        counters = server.stats()['counters']
        assert counters['serving.full_flushes'] >= 1
    finally:
        server.close()


def test_cpu_serving_launches_no_kernel(model, aggressive):
    sym_json, arg, aux, data = model
    before = fused.fused_bn_relu.launches
    _port_predictor(sym_json, arg, aux).forward(data=data[:2])
    assert fused.fused_bn_relu.launches == before


def _blocking_batcher(**kw):
    gate = threading.Event()
    calls = []

    def execute(inputs, rows):
        calls.append(rows)
        gate.wait(timeout=30)
        return [inputs['x'] * 2.0]
    return DynamicBatcher('fake', execute, batch_inputs=['x'], **kw), \
        gate, calls


def test_batcher_constant_inputs_split_flushes():
    """A per-model constant input rides along whole; requests whose
    constants differ never share a flush."""
    seen = []

    def execute(inputs, rows):
        seen.append((rows, float(inputs['k'][0])))
        return [inputs['x'] * inputs['k'][0]]
    b = DynamicBatcher('const', execute, max_delay_ms=200.0, max_batch=8,
                       batch_inputs=['x'])
    try:
        futs = [b.submit({'x': np.full((2, 1), i, np.float32),
                          'k': np.array([k], np.float32)})
                for i, k in ((1, 2.0), (2, 2.0), (3, 5.0))]
        outs = [f.result(timeout=30)[0] for f in futs]
    finally:
        assert b.stop(timeout=30)
    assert seen == [(4, 2.0), (2, 5.0)]
    np.testing.assert_array_equal(outs[0], np.full((2, 1), 2.0))
    np.testing.assert_array_equal(outs[1], np.full((2, 1), 4.0))
    np.testing.assert_array_equal(outs[2], np.full((2, 1), 15.0))


def test_batcher_sheds_past_queue_bound():
    b, gate, calls = _blocking_batcher(max_delay_ms=0.0, max_batch=8,
                                       max_queue=1)
    try:
        first = b.submit({'x': np.ones((1, 2), np.float32)})
        deadline = time.monotonic() + 30
        while not calls and time.monotonic() < deadline:
            time.sleep(0.01)        # the worker has taken the first request
        queued = b.submit({'x': np.ones((1, 2), np.float32)})
        with pytest.raises(ServerOverloadedError):
            b.submit({'x': np.ones((1, 2), np.float32)})
        gate.set()
        np.testing.assert_array_equal(first.result(timeout=30)[0],
                                      2 * np.ones((1, 2)))
        np.testing.assert_array_equal(queued.result(timeout=30)[0],
                                      2 * np.ones((1, 2)))
    finally:
        gate.set()
        assert b.stop(timeout=30)


def test_batcher_flushes_partial_batch_at_delay_deadline():
    b, gate, calls = _blocking_batcher(max_delay_ms=50.0, max_batch=64)
    gate.set()
    try:
        t0 = time.monotonic()
        out = b.submit({'x': np.arange(6, dtype=np.float32).reshape(3, 2)})
        np.testing.assert_array_equal(
            out.result(timeout=30)[0],
            2 * np.arange(6, dtype=np.float32).reshape(3, 2))
        assert time.monotonic() - t0 >= 0.045
        assert calls == [3]
    finally:
        assert b.stop(timeout=30)


def test_batcher_stop_without_drain_fails_queued():
    b, gate, calls = _blocking_batcher(max_delay_ms=0.0, max_batch=1)
    try:
        b.submit({'x': np.ones((1, 2), np.float32)})
        deadline = time.monotonic() + 30
        while not calls and time.monotonic() < deadline:
            time.sleep(0.01)
        queued = b.submit({'x': np.ones((1, 2), np.float32)})
        # the worker is still inside its flush: the stop fails the queued
        # request at once and its join times out
        assert not b.stop(drain=False, timeout=0.05)
        with pytest.raises(tmx.MXNetError):
            queued.result(timeout=30)
        gate.set()
        b._zombies[0].join(timeout=30)
        assert not b._zombies[0].is_alive()
        with pytest.raises(tmx.MXNetError):
            b.submit({'x': np.ones((1, 2), np.float32)})
    finally:
        gate.set()


# ---------------------------------------------------------------------------
# Predictor.reshape and predictor.load
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('bucketed', [False, True], ids=['exact', 'bucket'])
def test_reshape_equals_a_fresh_predictor(model, aggressive, bucketed):
    """Reshaping to 1 row, then to 3, gives what a Predictor built at each
    shape gives, bit for bit; the bucket executors of the old shapes are
    dropped and the parameter arrays stay shared."""
    sym_json, arg, aux, data = model
    params = convert.params_from_numpy(arg, aux, 'cpu')
    pred = tmx.Predictor(sym_json, params, {'data': SHAPE}, dev_type='cpu',
                         pad_to_bucket=bucketed)
    pred.forward(data=data)
    weight = pred._executor.arg_dict['fc1_weight']
    for rows in (1, 3):
        pred.reshape({'data': (rows,) + SHAPE[1:]})
        assert pred._bucket_execs == {} and pred._out_arrays is None
        assert pred._executor.arg_dict['fc1_weight'] is weight
        fresh = tmx.Predictor(sym_json, params, {'data': (rows,) + SHAPE[1:]},
                              dev_type='cpu', pad_to_bucket=bucketed)
        pred.forward(data=data[:rows])
        fresh.forward(data=data[:rows])
        got, want = pred.get_output(0), fresh.get_output(0)
        assert got.shape == (rows, 10)
        np.testing.assert_array_equal(got, want)


def test_reshape_matches_jax(model, aggressive):
    sym_json, arg, aux, data = model
    params = {'arg:' + k: mx.nd.array(v) for k, v in arg.items()}
    params.update({'aux:' + k: mx.nd.array(v) for k, v in aux.items()})
    jpred = JaxPredictor(sym_json, params, {'data': SHAPE})
    tpred = tmx.Predictor(sym_json, convert.params_from_numpy(arg, aux, 'cpu'),
                          {'data': SHAPE}, dev_type='cpu')
    for p in (jpred, tpred):
        p.reshape({'data': (2,) + SHAPE[1:]})
        p.forward(data=data[:2])
    np.testing.assert_allclose(tpred.get_output(0), jpred.get_output(0),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_load_reads_a_checkpoint_of_either_package(model, aggressive,
                                                   tmp_path, writer):
    """predictor.load(prefix, epoch, ...) over prefix-symbol.json and
    prefix-0003.params written by the port's model.save_checkpoint or by
    the JAX package's nd.save; against a Predictor built from the same
    arrays, bit for bit, and against the JAX package's load."""
    sym_json, arg, aux, data = model
    prefix = str(tmp_path / 'net')
    if writer == 'port':
        tmx.model.save_checkpoint(
            prefix, 3, tmx.sym.load_json(sym_json),
            {k: tmx.nd.array(v) for k, v in arg.items()},
            {k: tmx.nd.array(v) for k, v in aux.items()})
    else:
        with open(prefix + '-symbol.json', 'w') as f:
            f.write(sym_json)
        saved = {'arg:' + k: mx.nd.array(v) for k, v in arg.items()}
        saved.update({'aux:' + k: mx.nd.array(v) for k, v in aux.items()})
        mx.nd.save(prefix + '-0003.params', saved)
    loaded = tmx.predictor.load(prefix, 3, {'data': SHAPE}, dev_type='cpu')
    direct = tmx.Predictor(sym_json, convert.params_from_numpy(arg, aux,
                                                               'cpu'),
                           {'data': SHAPE}, dev_type='cpu')
    for p in (loaded, direct):
        p.forward(data=data)
    np.testing.assert_array_equal(loaded.get_output(0), direct.get_output(0))
    from mxnet_tpu import predictor as jax_predictor
    jpred = jax_predictor.load(prefix, 3, {'data': SHAPE})
    jpred.forward(data=data)
    np.testing.assert_allclose(loaded.get_output(0), jpred.get_output(0),
                               rtol=1e-4, atol=1e-5)
