"""The training lifecycle on the card's captured path (whole-step capture,
``compile_cache.CapturedStep``): each optimizer's captured fit step
against the same steps under ``NaiveEngine`` and through the
``Updater`` loop (``MXTPU_FUSED_FIT=0``); ``load_optimizer_states`` into
a module that holds graphs; checkpoints taken with two steps in flight.

Every test here needs a CUDA device (CUDA graphs have no CPU mode) and
skips without one; the CPU parity of the same code against the JAX
package is in tests/test_torch_optimizer.py and
tests/test_torch_checkpoint.py.  The file imports no jax, so the card's
host runs it (``python -m pytest tests/test_torch_lifecycle.py -m cuda
--noconftest``; ``chip_smoke.py``'s capture phase does).  Parameters are
held to ``chip_smoke.py``'s train-parity bound (rtol 1e-3, atol 1e-5)."""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert, engine
from mxnet_tpu_torch.models import resnet as tresnet

OPTIMIZERS = [
    ('sgd', {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}),
    ('nag', {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}),
    ('adam', {'learning_rate': 0.001, 'wd': 1e-4}),
    ('adagrad', {'learning_rate': 0.01}),
    ('rmsprop', {'learning_rate': 0.001, 'centered': True}),
]


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    for knob in ('MXTPU_ASYNC_DEPTH', 'MXTPU_DEVICE_FEED', 'MXTPU_FUSED_FIT',
                 'MXTPU_WARM_START', 'MXTPU_AUTO_RESUME'):
        monkeypatch.delenv(knob, raising=False)
    yield
    engine.set_engine_type('ThreadedEnginePerDevice')


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA graphs have no CPU mode)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda', 0)


def _case(rows=8, steps=4):
    sym = tresnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                         filter_list=[8, 16, 32, 64, 128], num_classes=10,
                         image_shape=(3, 64, 64))
    arg, aux = convert.random_params(sym, {'data': (rows, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((rows * steps, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, rows * steps).astype(np.float32)
    return sym, arg, aux, x, y


def _close(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5,
                                   err_msg='%s %s' % (what, k))


def _numpy(d):
    return {k: v.asnumpy() for k, v in d.items()}


def _launches():
    from mxnet_tpu_torch.ops import fused, fused_conv
    return {k.__name__: (k.launches, dict(k.launches_by_route))
            for k in (fused.fused_scale_bias_dot,
                      fused_conv.fused_scale_bias_conv3x3)}


def _fit(sym, arg, aux, x, y, opt, params, naive=False, dtype=None,
         rows=8, **kw):
    engine.set_engine_type('NaiveEngine' if naive else
                           'ThreadedEnginePerDevice')
    try:
        mod = tmx.Module(sym, context=tmx.gpu(0), compute_dtype=dtype)
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=rows),
                num_epoch=kw.pop('num_epoch', 1), optimizer=opt,
                optimizer_params=dict(params),
                arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
                aux_params={k: tmx.nd.array(v) for k, v in aux.items()},
                **kw)
        torch.cuda.synchronize()
    finally:
        engine.set_engine_type('ThreadedEnginePerDevice')
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize('opt,params', OPTIMIZERS,
                         ids=[o[0] for o in OPTIMIZERS])
def test_captured_optimizer_matches_eager_and_loop(dev, opt, params,
                                                   monkeypatch):
    """bf16 over f32 masters: one graph, replayed after the first step,
    the same launches per kernel and route as the eager steps (the
    narrow widths take the sm90 and wmma routes), the
    parameters (and the optimizer state) of the NaiveEngine fit.  In f32
    the captured step against the Updater loop on the update ops."""
    sym, arg, aux, x, y = _case()
    before = _launches()
    cap = _fit(sym, arg, aux, x, y, opt, params, dtype=torch.bfloat16)
    mid = _launches()
    eager = _fit(sym, arg, aux, x, y, opt, params, naive=True,
                 dtype=torch.bfloat16)
    after = _launches()
    (graph,) = cap._graphs.values()
    assert graph.captured and graph.replays == 3
    for k in before:
        assert mid[k][0] - before[k][0] == after[k][0] - mid[k][0] > 0
        for route, n in mid[k][1].items():
            assert n - before[k][1].get(route, 0) == \
                after[k][1][route] - n, (k, route)
    _close(_numpy(cap.get_params()[0]), _numpy(eager.get_params()[0]),
           opt)
    for k, s in cap._fused_opt_state.items():
        leaves = s if isinstance(s, tuple) else (s,)
        other = eager._fused_opt_state[k]
        others = other if isinstance(other, tuple) else (other,)
        for a, b in zip(leaves, others):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=k)
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    f32 = _fit(sym, arg, aux, x, y, opt, params)
    monkeypatch.setenv('MXTPU_FUSED_FIT', '0')
    loop = _fit(sym, arg, aux, x, y, opt, params)
    assert loop._fused is None and loop._updater.states
    _close(_numpy(loop.get_params()[0]), _numpy(f32.get_params()[0]),
           opt + ' loop')


@pytest.mark.cuda
def test_load_optimizer_states_into_a_captured_module(dev, tmp_path):
    """A module whose Adam step is captured loads a .states file: the
    values go into the state tensors the graph holds (the same graph is
    replayed afterwards, no recapture) and it then trains as a module
    that started eagerly from the same file."""
    sym, arg, aux, x, y = _case()
    params = {'learning_rate': 0.001}
    src = _fit(sym, arg, aux, x, y, 'adam', params, dtype=torch.bfloat16)
    fname = str(tmp_path / 'src.states')
    src.save_optimizer_states(fname)
    trained = src.get_params()

    mod = _fit(sym, arg, aux, x[:16], y[:16], 'adam', params,
               dtype=torch.bfloat16)
    (graph,) = mod._graphs.values()
    held = {k: v for k, v in mod._fused_opt_state.items()}
    traces = tmx.instrument.counter_value('compile.traces')
    mod.load_optimizer_states(fname)
    for k, v in mod._fused_opt_state.items():
        assert all(a is b for a, b in zip(v, held[k]))
        for a, b in zip(v, src._fused_opt_state[k]):
            assert torch.equal(a, b)
    # the same params, without a rebind: copy into the bound arrays
    mod._exec_group.execs[0].copy_params_from(*trained)
    counts = dict(src._optimizer._index_update_count)
    mod._optimizer._index_update_count = dict(counts)
    mod._optimizer.num_update = max(counts.values())
    replays = graph.replays
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=8), num_epoch=2,
            begin_epoch=1, optimizer='adam')
    torch.cuda.synchronize()
    assert mod._graphs and list(mod._graphs.values())[0] is graph
    assert graph.replays == replays + 4
    assert tmx.instrument.counter_value('compile.traces') == traces

    engine.set_engine_type('NaiveEngine')
    try:
        ref = tmx.Module(sym, context=tmx.gpu(0),
                         compute_dtype=torch.bfloat16)
        ref.bind([('data', (8, 3, 64, 64))], [('softmax_label', (8,))])
        ref.init_params(arg_params=trained[0], aux_params=trained[1])
        ref.init_optimizer(optimizer='adam', optimizer_params=params)
        ref.load_optimizer_states(fname)
        ref._optimizer._index_update_count = dict(counts)
        ref._optimizer.num_update = max(counts.values())
        ref.fit(tmx.io.NDArrayIter(x, y, batch_size=8), num_epoch=2,
                begin_epoch=1, optimizer='adam')
        torch.cuda.synchronize()
    finally:
        engine.set_engine_type('ThreadedEnginePerDevice')
    _close(_numpy(mod.get_params()[0]), _numpy(ref.get_params()[0]),
           'resumed')


@pytest.mark.cuda
def test_checkpoints_at_depth_two_on_the_card(dev, tmp_path, monkeypatch):
    """Two steps in flight with the device feed: the per-epoch checkpoint
    and module_checkpoint's .params and .states hold what a synchronous
    fit's hold (the window drains before they read)."""
    sym, arg, aux, x, y = _case()
    got = {}
    for depth, feed in ((2, '1'), (1, '0')):
        monkeypatch.setenv('MXTPU_ASYNC_DEPTH', str(depth))
        monkeypatch.setenv('MXTPU_DEVICE_FEED', feed)
        prefix = str(tmp_path / ('d%d' % depth))
        mod = tmx.Module(sym, context=tmx.gpu(0),
                         compute_dtype=torch.bfloat16)
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=8), num_epoch=2,
                optimizer='sgd', optimizer_params={'learning_rate': 0.05,
                                                   'momentum': 0.9},
                arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
                aux_params={k: tmx.nd.array(v) for k, v in aux.items()},
                checkpoint_prefix=prefix,
                epoch_end_callback=tmx.callback.module_checkpoint(
                    mod, prefix + '-mc', save_optimizer_states=True))
        torch.cuda.synchronize()
        files = {}
        for epoch in (1, 2):
            files[epoch] = {k: v.asnumpy() for k, v in tmx.nd.load(
                '%s-%04d.params' % (prefix, epoch)).items()}
            mc = {k: v.asnumpy() for k, v in tmx.nd.load(
                '%s-mc-%04d.params' % (prefix, epoch)).items()}
            for k in mc:
                np.testing.assert_array_equal(mc[k], files[epoch][k])
        with open(prefix + '-mc-0002.states', 'rb') as f:
            states = tmx.optimizer.loads_states(f.read())
        files['states'] = {'%d' % k: v.asnumpy() for k, v in states.items()}
        got[depth] = files
    assert os.path.exists(str(tmp_path / 'd2-symbol.json'))
    for key in (1, 2, 'states'):
        _close(got[2][key], got[1][key], 'depth 2 against 1, %s' % key)


@pytest.mark.cuda
@pytest.mark.parametrize('policy', ['nothing', 'dots'])
def test_mirrored_captured_step_matches_unmirrored(dev, policy,
                                                   monkeypatch):
    """MXNET_BACKWARD_DO_MIRROR on the captured fit step (bf16 over f32
    masters, cuDNN deterministic): the step is captured and replayed,
    #1 and #4 launch twice per step (the recompute runs their forward
    again), and the parameters equal the unmirrored run's, bit for bit
    under 'nothing' and within the train-parity bound under 'dots'."""
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    sym, arg, aux, x, y = _case()
    opt, params = OPTIMIZERS[0]
    before = _launches()
    off = _fit(sym, arg, aux, x, y, opt, params, dtype=torch.bfloat16)
    mid = _launches()
    monkeypatch.setenv('MXNET_BACKWARD_DO_MIRROR', '1')
    monkeypatch.setenv('MXNET_BACKWARD_MIRROR_POLICY', policy)
    mirrored = _fit(sym, arg, aux, x, y, opt, params, dtype=torch.bfloat16)
    after = _launches()
    (graph,) = mirrored._graphs.values()
    assert graph.captured and graph.replays == 3
    for k in before:
        assert after[k][0] - mid[k][0] == 2 * (mid[k][0] - before[k][0]), k
    got, want = _numpy(mirrored.get_params()[0]), _numpy(off.get_params()[0])
    if policy == 'nothing':
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    else:
        _close(got, want, 'dots')


@pytest.mark.cuda
def test_monitored_step_runs_no_fused_forward(dev):
    """A monitored narrow ResNet step on the card (aggressive fuse): its
    tapped forward runs the original symbol (no fused kernel), its
    backward runs the fused program's training forward again (#1, #4),
    and nothing is captured."""
    from mxnet_tpu_torch.ops import fused, fused_conv
    sym, arg, aux, x, y = _case()
    mod = tmx.Module(sym, context=tmx.gpu(0))
    it = tmx.io.NDArrayIter(x, y, batch_size=8)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
                    aux_params={k: tmx.nd.array(v) for k, v in aux.items()})
    mod.init_optimizer(optimizer_params=dict(OPTIMIZERS[0][1]))
    mon = tmx.monitor.Monitor(1, pattern='.*conv.*')
    mod.install_monitor(mon)
    batch = next(iter(it))
    d0 = fused.fused_scale_bias_dot.launches
    c0 = fused_conv.fused_scale_bias_conv3x3.launches
    mon.tic()
    mod.forward(batch, is_train=True)
    assert (fused.fused_scale_bias_dot.launches,
            fused_conv.fused_scale_bias_conv3x3.launches) == (d0, c0)
    mod.backward()
    mod.update()
    torch.cuda.synchronize()
    assert fused.fused_scale_bias_dot.launches > d0
    assert fused_conv.fused_scale_bias_conv3x3.launches > c0
    taps = mon.toc()
    assert len(taps) > 1 and mod._graphs == {} and mod._fused is None
