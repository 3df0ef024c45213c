"""MXNET_BACKWARD_DO_MIRROR in the PyTorch port (``executor.mirror_wrap``,
non-reentrant ``torch.utils.checkpoint``) on the CPU, against the port's
own unmirrored step and the JAX package's mirrored step.

- 'nothing' recomputes the whole forward: the same ops on the same
  inputs, so parameters are bit-identical to the unmirrored run.
- 'dots' keeps the matmul and convolution outputs (a selective
  checkpoint) and recomputes the rest: held within the JAX mirror test's
  own bound (tests/test_mirror.py: rtol 1e-4, atol 5e-5), as is the port
  against the JAX mirrored step.
- The recompute is counted where it happens: the aten convolutions that
  run (a TorchDispatchMode outside the checkpoint sees only the calls
  that execute, not the ones the selective checkpoint serves from its
  cache) and the forwards of a kernel's ``autograd.Function`` (its plain
  version on the CPU), which 'dots' recomputes as the JAX policy
  recomputes a ``pallas_call``.
- BN's moving statistics are applied once, Dropout's mask is the same in
  the recompute, and a policy other than 'dots'/'nothing' raises."""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu.parallel import train_step as jts
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.ops import fused, fused_conv
from mxnet_tpu_torch.parallel import train_step as tts

POLICIES = ('nothing', 'dots')


def _mirror(monkeypatch, policy):
    if policy is None:
        monkeypatch.delenv('MXNET_BACKWARD_DO_MIRROR', raising=False)
        monkeypatch.delenv('MXNET_BACKWARD_MIRROR_POLICY', raising=False)
    else:
        monkeypatch.setenv('MXNET_BACKWARD_DO_MIRROR', '1')
        monkeypatch.setenv('MXNET_BACKWARD_MIRROR_POLICY', policy)


def _lenet_case(batch=8):
    sym = jmodels.get_symbol('lenet', num_classes=10)
    dshape = (batch, 1, 28, 28)
    arg_shapes, _, _ = sym.infer_shape(data=dshape)
    rng = np.random.RandomState(0)
    params = {n: rng.normal(0, 0.05, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ('data', 'softmax_label')}
    batch = {'data': rng.rand(*dshape).astype(np.float32),
             'softmax_label': rng.randint(0, 10, batch).astype(np.float32)}
    return params, batch


def _port_lenet(monkeypatch, policy, steps=3):
    _mirror(monkeypatch, policy)
    params, batch = _lenet_case()
    sym = tmodels.get_symbol('lenet', num_classes=10)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tts.sgd_momentum_init(p)
    step = tts.make_train_step(sym, tts.make_sgd_momentum(
        lr=0.1, momentum=0.9, wd=0.0, rescale_grad=1.0),
        ('data', 'softmax_label'))
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    aux = {}
    for _ in range(steps):
        _, p, aux, state = step(p, aux, state, b)
    return {k: v.numpy() for k, v in p.items()}


def _jax_lenet(monkeypatch, policy, steps=3):
    _mirror(monkeypatch, policy)
    params, batch = _lenet_case()
    sym = jmodels.get_symbol('lenet', num_classes=10)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = jts.sgd_momentum_init(p)
    step = jts.make_train_step(sym, jts.make_sgd_momentum(
        lr=0.1, momentum=0.9, wd=0.0, rescale_grad=1.0),
        ('data', 'softmax_label'), donate=False)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    aux = {}
    for _ in range(steps):
        _, p, aux, state = step(p, aux, state, b, jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize('policy', POLICIES)
def test_mirrored_train_step_matches_unmirrored_and_jax(monkeypatch,
                                                        policy):
    """Three SGD-momentum steps of LeNet through make_train_step: 'nothing'
    bit-identical to the port's unmirrored step, 'dots' within 5e-5, and
    both within the same bound of the JAX package's mirrored step."""
    base = _port_lenet(monkeypatch, None)
    got = _port_lenet(monkeypatch, policy)
    want = _jax_lenet(monkeypatch, policy)
    for k in base:
        if policy == 'nothing':
            np.testing.assert_array_equal(got[k], base[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], base[k], rtol=1e-4,
                                       atol=5e-5, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=5e-5,
                                   err_msg=k)
        assert np.max(np.abs(got[k] - _lenet_case()[0][k])) > 1e-4, k


class _CountConvs(TorchDispatchMode):
    """Counts the aten convolutions that execute."""

    def __init__(self):
        super().__init__()
        self.convs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.convs += 1
        return func(*args, **(kwargs or {}))


def _lenet_executor():
    params, batch = _lenet_case()
    sym = tmodels.get_symbol('lenet', num_classes=10)
    args = {k: tmx.nd.array(v) for k, v in params.items()}
    args.update({k: tmx.nd.array(v) for k, v in batch.items()})
    grads = {k: tmx.nd.zeros(v.shape) for k, v in params.items()}
    return sym.bind(tmx.cpu(), args, args_grad=grads)


@pytest.mark.parametrize('policy,convs', [(None, 2), ('nothing', 4),
                                          ('dots', 2)])
def test_dots_keeps_the_convolutions(monkeypatch, policy, convs):
    """LeNet's two convolutions run once per step unmirrored, twice under
    'nothing' (the recompute) and once under 'dots' (kept), as the JAX
    test_dots_policy_saves_convs says of its FLOPs; the gradients agree
    (bit for bit under 'nothing')."""
    _mirror(monkeypatch, None)
    exe = _lenet_executor()
    exe.forward_backward()
    want = {k: v.asnumpy() for k, v in exe.grad_dict.items()}
    _mirror(monkeypatch, policy)
    exe = _lenet_executor()
    mode = _CountConvs()
    before = tmx.instrument.counter_value('executor.mirrored_forwards')
    with mode:
        exe.forward_backward()
    assert mode.convs == convs
    assert tmx.instrument.counter_value('executor.mirrored_forwards') == \
        before + (policy is not None)
    for k, v in exe.grad_dict.items():
        if policy == 'dots':
            np.testing.assert_allclose(v.asnumpy(), want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(v.asnumpy(), want[k], err_msg=k)


def _narrow_resnet():
    return tresnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                          filter_list=[8, 16, 32, 64, 128], num_classes=10,
                          image_shape=(3, 64, 64))


_DOT_PLAIN = fused.fused_scale_bias_dot_plain
_CONV_PLAIN = fused_conv.fused_scale_bias_conv3x3_plain


def _resnet_fit(monkeypatch, policy, steps=2):
    """A narrow ResNet v2 through Module.fit's fused step (aggressive
    fuse: 16 _bn_relu_conv nodes, the kernels' plain versions), counting
    the kernel Functions' forwards."""
    _mirror(monkeypatch, policy)
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    calls = {'dot': 0, 'conv': 0}

    def dot(*a, **k):
        calls['dot'] += 1
        return _DOT_PLAIN(*a, **k)

    def conv(*a, **k):
        calls['conv'] += 1
        return _CONV_PLAIN(*a, **k)
    monkeypatch.setattr(fused, 'fused_scale_bias_dot_plain', dot)
    monkeypatch.setattr(fused_conv, 'fused_scale_bias_conv3x3_plain', conv)
    sym = _narrow_resnet()
    arg, aux = convert.random_params(sym, {'data': (4, 3, 64, 64)}, 0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4 * steps, 3, 64, 64), dtype=np.float32)
    y = rng.integers(0, 10, 4 * steps).astype(np.float32)
    mod = tmx.Module(sym, context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=4), num_epoch=1,
            optimizer='sgd', optimizer_params={'learning_rate': 0.05,
                                               'momentum': 0.9},
            arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
            aux_params={k: tmx.nd.array(v) for k, v in aux.items()})
    a, x_ = mod.get_params()
    return ({k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x_.items()}, calls)


@pytest.mark.parametrize('policy', POLICIES)
def test_mirrored_fit_step_recomputes_the_kernels_once(monkeypatch,
                                                       policy):
    """Two fused fit steps of a narrow ResNet v2: each kernel Function's
    forward (#1 fused_scale_bias_dot, #4 fused_scale_bias_conv3x3) runs
    twice per step under either policy (a kernel's output is not among
    the kept matmuls), and the BN moving statistics are applied once:
    they equal the unmirrored run's, as do the parameters ('nothing' bit
    for bit, 'dots' within 5e-5)."""
    arg0, aux0, calls0 = _resnet_fit(monkeypatch, None)
    arg1, aux1, calls1 = _resnet_fit(monkeypatch, policy)
    assert calls0 == {'dot': 24, 'conv': 8}
    assert calls1 == {k: 2 * v for k, v in calls0.items()}
    for got, want in ((arg1, arg0), (aux1, aux0)):
        for k in want:
            if policy == 'nothing':
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           atol=5e-5, err_msg=k)


def _dropout_exec():
    data = tmx.sym.Variable('data')
    fc = tmx.sym.FullyConnected(data, num_hidden=16, name='fc1')
    drop = tmx.sym.Dropout(tmx.sym.Activation(fc, act_type='relu'), p=0.5,
                           name='drop')
    out = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        drop, num_hidden=4, name='fc2'), name='softmax')
    r = np.random.RandomState(3)
    args = {'data': r.randn(8, 6), 'fc1_weight': r.randn(16, 6) * 0.3,
            'fc1_bias': np.zeros(16), 'fc2_weight': r.randn(4, 16) * 0.3,
            'fc2_bias': np.zeros(4),
            'softmax_label': r.randint(0, 4, 8)}
    args = {k: tmx.nd.array(v.astype(np.float32)) for k, v in args.items()}
    grads = {k: tmx.nd.zeros(v.shape) for k, v in args.items()
             if k not in ('data', 'softmax_label')}
    return out.bind(tmx.cpu(), args, args_grad=grads)


@pytest.mark.parametrize('policy', POLICIES)
def test_mirrored_dropout_replays_its_mask(monkeypatch, policy):
    """A p=0.5 Dropout step: the recompute draws the same mask from the
    device generator (replayed, torch's global RNG is not used), so the
    mirrored gradients equal the unmirrored ones bit for bit under
    'nothing', and the generator ends where the unmirrored step left
    it."""
    runs = {}
    for pol in (None, policy):
        _mirror(monkeypatch, pol)
        tmx.random.seed(5)
        exe = _dropout_exec()
        exe.forward_backward()
        runs[pol] = ({k: v.asnumpy() for k, v in exe.grad_dict.items()},
                     tmx.random.generator('cpu').get_state())
    (want, gen0), (got, gen1) = runs[None], runs[policy]
    assert torch.equal(gen0, gen1)
    assert np.count_nonzero(want['fc1_weight']) < want['fc1_weight'].size
    for k in want:
        if policy == 'nothing':
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_mirrored_random_step_stays_eager_on_the_card(monkeypatch):
    """The capture rule: a training program that draws random numbers
    stays eager under the mirror (the recompute replays the generator's
    state, which a capture cannot read); without random nodes, or without
    the mirror, nothing changes."""
    from mxnet_tpu_torch import compile_cache, engine
    monkeypatch.setattr(compile_cache, '_graph_generators', lambda: True)
    monkeypatch.setattr(engine, 'capture_enabled', lambda: True)
    drop = _dropout_exec()._symbol
    plain = _narrow_resnet()
    _mirror(monkeypatch, 'dots')
    assert compile_cache.capture_skip_reason('cuda', drop) == \
        'random under the mirror'
    assert compile_cache.capture_skip_reason('cuda', plain) is None
    assert compile_cache.capture_skip_reason('cuda', drop,
                                             is_train=False) is None
    _mirror(monkeypatch, None)
    assert compile_cache.capture_skip_reason('cuda', drop) is None


def test_invalid_policy_raises(monkeypatch):
    _mirror(monkeypatch, 'everything')
    exe = _lenet_executor()
    with pytest.raises(tmx.MXNetError, match="'dots' or 'nothing'"):
        exe.forward(is_train=True)
    with pytest.raises(mx.MXNetError, match="'dots' or 'nothing'"):
        from mxnet_tpu.executor import mirror_wrap
        mirror_wrap(lambda: None)


# ---------------------------------------------------------------------------
# the sequence-parallel step: the recompute re-runs the ring's collectives
# in backward, on every rank alike
# ---------------------------------------------------------------------------

SP_T, SP_V = 16, 30


def _sp_worker(rank, n, root):
    from torch.distributed.device_mesh import init_device_mesh
    from mxnet_tpu_torch.parallel import sp
    dist.init_process_group('gloo', init_method='file://' + os.path.join(
        root, 'store'), world_size=n, rank=rank)
    try:
        mesh = init_device_mesh('cpu', (n,), mesh_dim_names=('seq',))
        cfg = dict(vocab_size=SP_V, num_embed=16, num_heads=2, num_layers=1)
        full = tmodels.get_symbol('transformer_lm', seq_len=SP_T, **cfg)
        shapes, _, _ = full.infer_shape(data=(2, SP_T),
                                        softmax_label=(2, SP_T))
        rng = np.random.RandomState(0)
        params = {k: torch.from_numpy(rng.normal(0, 0.05, s)
                                      .astype(np.float32))
                  for k, s in zip(full.list_arguments(), shapes)
                  if k not in ('data', 'softmax_label')}
        data = rng.randint(0, SP_V, (2, SP_T)).astype(np.float32)
        batch = {'data': torch.from_numpy(data),
                 'softmax_label': torch.from_numpy((data + 1) % SP_V)}
        out = {}
        for policy in (None,) + POLICIES:
            if policy is None:
                os.environ.pop('MXNET_BACKWARD_DO_MIRROR', None)
            else:
                os.environ['MXNET_BACKWARD_DO_MIRROR'] = '1'
                os.environ['MXNET_BACKWARD_MIRROR_POLICY'] = policy
            sym = tmodels.get_symbol('transformer_lm', seq_len=SP_T // n,
                                     **cfg)
            p = sp.shard_sp_params(params, mesh, 'seq',
                                   ('pos_embed_weight',))
            state = sp.shard_sp_params(tts.sgd_momentum_init(p), mesh, 'seq')
            step = sp.make_sp_train_step(
                sym, mesh, tts.make_sgd_momentum(lr=0.1, momentum=0.9,
                                                 wd=0.0),
                seq_axis='seq', seq_param_names=('pos_embed_weight',))
            _, p, _ = step(p, state, batch)
            for k, v in p.items():
                out['%s_%s' % (policy, k)] = v.numpy()
        np.savez(os.path.join(root, 'rank%d.npz' % rank), **out)
    finally:
        dist.destroy_process_group()


def test_mirrored_sp_step_matches_unmirrored(tmp_path):
    """Two gloo ranks, ring attention, one step: 'nothing' bit-identical
    to the unmirrored sp step on every rank, 'dots' within 5e-5."""
    mp.spawn(_sp_worker, args=(2, str(tmp_path)), nprocs=2, join=True)
    for r in range(2):
        res = dict(np.load(str(tmp_path / ('rank%d.npz' % r))))
        base = {k[len('None_'):]: v for k, v in res.items()
                if k.startswith('None_')}
        assert base
        for k, v in base.items():
            np.testing.assert_array_equal(res['nothing_' + k], v, err_msg=k)
            np.testing.assert_allclose(res['dots_' + k], v, rtol=1e-4,
                                       atol=5e-5, err_msg=k)
