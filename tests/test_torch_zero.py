"""ZeRO over the dp axis in the PyTorch port (``parallel/zero.py``)
against the JAX package's (``tests/test_zero.py``), on the CPU.

The JAX side runs here on the conftest's virtual devices; the port's on
2 and 4 gloo ranks (one ``torch.multiprocessing.spawn`` per world size,
module-scoped, ``tests/torch_mesh_ranks.py``'s 'zero' suite, jax-free).
Cases: the fused layout (``_layout``, ``zero_state_size``,
``zero_spec_for``) equal; ``make_zero_sgd_momentum`` one step and two on 2
and 4 ranks against JAX's on 4 devices and the replicated update of the
summed gradients (rtol 1e-6 and 1e-5, atol 1e-6: the JAX test's); the
``make_zero_train_step`` MLP step on 2 and 4 ranks against JAX's on 4
devices over the same batch (rtol 1e-5, atol 1e-6) and its refusal of a
shard-local loss divisor (the JAX message); each rank's resident optimizer state of a sharded fit (1/dp of
every leaf, 1/(dp·tp) of a tp-sharded one); the checkpoint of a sharded
fit: saved after 2 of 4 epochs, resumed through ``Module.load(...,
load_optimizer_states=True)``, bit for bit the uninterrupted fit, its
``.states`` loading into an unmeshed module (the unsharded format); and
``fit(checkpoint_prefix=, auto_resume=True)`` under a mesh."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.parallel import zero as jzero
from mxnet_tpu.parallel import train_step as jts
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import zero as tzero

import torch_mesh_ranks as R

WORLDS = (2, 4)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """``{n: [(arrays, numbers)] per rank}`` of the 'zero' suite."""
    saved = os.environ.get('MXTPU_FUSE')
    os.environ['MXTPU_FUSE'] = 'off'
    try:
        return {n: R.spawn('zero', n, str(tmp_path_factory.mktemp(
            'zero%d' % n))) for n in WORLDS}
    finally:
        if saved is None:
            os.environ.pop('MXTPU_FUSE', None)
        else:
            os.environ['MXTPU_FUSE'] = saved


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ('dp',))


def _shard_map():
    from mxnet_tpu.parallel.compat import shard_map, SHARD_MAP_ERROR
    if shard_map is None:
        pytest.skip('shard_map unavailable: %s' % SHARD_MAP_ERROR)
    return shard_map


@pytest.mark.parametrize('n', [1, 2, 4, 8, 3])
def test_layout_matches_jax(n):
    params = R.zero_params()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    assert tzero._layout(params, n) == jzero._layout(jp, n)
    assert tzero.zero_state_size(params, n) == jzero.zero_state_size(jp, n)
    assert tuple(tzero.zero_init(
        {k: tmx.nd.array(v).handle for k, v in params.items()}, n).shape) \
        == tuple(jzero.zero_init(jp, n).shape)
    assert tuple(tzero.zero_opt_init(
        {k: tmx.nd.array(v).handle for k, v in params.items()}, n).shape) \
        == tuple(jzero.zero_opt_init(jp, n).shape)


@pytest.mark.parametrize('shape,ndp,base', [
    ((32, 16), 4, None), ((32, 16), 4, ('tp', None)), ((7, 5), 4, None),
    ((32,), 4, None), ((8, 8), 2, (None, 'tp')), ((3, 3), 1, None)])
def test_zero_spec_matches_jax(shape, ndp, base):
    assert tzero.zero_spec_for(shape, ndp, base=base) == \
        tuple(jzero.zero_spec_for(shape, ndp, base=base))


_JAX = {}


def _jax_sgd(steps, seed):
    """JAX's make_zero_sgd_momentum on R.ZERO_DEVICES devices
    (tests/test_zero.py), and the replicated update of the summed
    gradients."""
    if steps in _JAX:
        return _JAX[steps]
    shard_map = _shard_map()
    n = R.ZERO_DEVICES
    params = {k: jnp.asarray(v) for k, v in R.zero_params().items()}
    wd = 0.0 if steps == 2 else R.ZERO_OPT['wd']
    upd = jzero.make_zero_sgd_momentum(
        'dp', n, lr=R.ZERO_OPT['lr'], momentum=R.ZERO_OPT['momentum'],
        wd=wd, rescale_grad=1.0 / n)
    grads = [{k: jnp.asarray(v) for k, v in R.zero_grads(seed + 10 * s)
              .items()} for s in range(steps)]

    def run(params, *gs):
        mom = jzero.zero_init(params, n)
        for g in gs:
            params, mom = upd(params, g, mom)
        return params

    got = shard_map(run, mesh=_mesh(n), in_specs=(P(),) + (P('dp'),) * steps,
                    out_specs=P(), check_vma=False)(params, *grads)
    ref = jts.make_sgd_momentum(lr=R.ZERO_OPT['lr'],
                                momentum=R.ZERO_OPT['momentum'], wd=wd,
                                rescale_grad=1.0 / n)
    p, st = params, jts.sgd_momentum_init(params)
    for g in grads:
        p, st = ref(p, {k: v.sum(0) for k, v in g.items()}, st)
    _JAX[steps] = ({k: np.asarray(v) for k, v in got.items()},
                   {k: np.asarray(v) for k, v in p.items()})
    return _JAX[steps]


@pytest.mark.parametrize('steps', [1, 2])
@pytest.mark.parametrize('n', WORLDS)
def test_zero_sgd_momentum_matches_jax(ranks, n, steps):
    """One step (rtol 1e-6) and two with the momentum carried (rtol
    1e-5): every rank's replicated parameters against JAX's sharded
    update on 4 devices (each rank's gradient the sum of 4/n devices')
    and the replicated update of the summed gradients; the state is the
    fused (C,) vector of n shards."""
    jax_got, replicated = _jax_sgd(steps, steps)
    rtol = 1e-6 if steps == 1 else 1e-5
    for arrays, numbers in ranks[n]:
        assert numbers['sgd%d_state_numel' % steps] == \
            tzero.zero_state_size(R.zero_params(), n)
        for k in replicated:
            got = arrays['sgd%d/%s' % (steps, k)]
            np.testing.assert_allclose(got, jax_got[k], rtol=rtol,
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(got, replicated[k], rtol=rtol,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize('n', WORLDS)
def test_zero_train_step_matches_jax(ranks, n):
    """The shard_map ZeRO step: each rank's outputs (its rows) and the
    replicated parameters against JAX's make_zero_train_step on 4
    devices over the same 16-row batch; a second step stays finite."""
    if 'step' not in _JAX:
        arg, data = R.zero_mlp_case()
        jp = {k: jnp.asarray(v) for k, v in arg.items()}
        d = R.ZERO_DEVICES
        step = jzero.make_zero_train_step(
            R.zero_mlp(mx), _mesh(d), 'dp', rescale_grad=1.0 / (4 * d),
            donate=False, **R.ZERO_OPT)
        outs, p1, _, _ = step(jp, {}, jzero.zero_opt_init(jp, d),
                              {k: jnp.asarray(v) for k, v in data.items()},
                              jax.random.PRNGKey(0))
        _JAX['step'] = (np.asarray(outs[0]),
                        {k: np.asarray(v) for k, v in p1.items()})
    outs, p1 = _JAX['step']
    per = len(outs) // n
    for rank, (arrays, numbers) in enumerate(ranks[n]):
        np.testing.assert_allclose(arrays['step/out'],
                                   outs[rank * per:(rank + 1) * per],
                                   rtol=1e-5, atol=1e-6)
        for k in p1:
            np.testing.assert_allclose(arrays['step/' + k], p1[k],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        assert numbers['step2_finite']


def test_zero_train_step_refuses_a_shard_local_divisor(ranks):
    """normalization='batch' divides by the shard's rows: refused, with
    the JAX package's message, in this process and on every rank."""
    bad = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable('data'), num_hidden=4, name='fc1'), name='softmax',
        normalization='batch')
    with pytest.raises(ValueError, match='SHARD-local') as jerr:
        jzero.make_zero_train_step(bad, _mesh(2), 'dp')
    tbad = tmx.sym.load_json(bad.tojson())
    with pytest.raises(ValueError, match='SHARD-local') as terr:
        tzero.make_zero_train_step(tbad, tmesh.RankMesh(1, 1), 'dp')
    assert str(terr.value) == str(jerr.value)
    for n in WORLDS:
        for _, numbers in ranks[n]:
            assert numbers['shard_local_refusal'] == str(jerr.value)


@pytest.mark.parametrize('n,mesh,part', [
    (n, m, p) for n in WORLDS for m, p in R.MLP_MESHES[n]])
def test_each_rank_holds_its_zero_part(ranks, n, mesh, part):
    """A rank's resident optimizer state of a sharded fit: 1/dp of every
    leaf (each chunk ceil(size/dp)), 1/(dp·tp) of a tp-sharded
    parameter's, against the unmeshed fit's leaves."""
    axes = tmesh.parse_mesh_spec(mesh)
    dp, tp = axes['dp'], axes['tp']
    arg, _ = R.mlp_params()
    for _, numbers in ranks[n]:
        got = numbers['bytes_%s_%s' % (mesh, part)]
        dims = numbers['bytes_%s_%s_tp_dims' % (mesh, part)]
        for name, value in arg.items():
            owned = value.size // (tp if dims[name] is not None else 1)
            assert got[name] == [-(-owned // dp) * 4], name
            assert (dims[name] is not None) == (part == 'auto' and tp > 1)
        if part == 'auto' and tp > 1 and dp > 1:
            assert sum(b[0] for b in got.values()) * dp * tp == \
                sum(v.nbytes for v in arg.values())


@pytest.mark.parametrize('n', WORLDS)
def test_checkpoint_round_trip_bit_for_bit(ranks, n):
    """Saved after 2 epochs (rank 0 writes the gathered, unsharded
    state), resumed through Module.load(load_optimizer_states=True) for
    epochs 2-4 on the same mesh: every rank bit for bit the uninterrupted
    4-epoch sharded fit."""
    for arrays, _ in ranks[n]:
        whole = {k[len('ckpt_whole/'):]: v for k, v in arrays.items()
                 if k.startswith('ckpt_whole/')}
        assert whole
        for k, v in whole.items():
            np.testing.assert_array_equal(arrays['ckpt_resumed/' + k], v,
                                          err_msg=k)


@pytest.mark.parametrize('n', WORLDS)
def test_sharded_states_load_unmeshed(ranks, n):
    """The .states a sharded fit wrote is the unsharded format: it loads
    into an unmeshed module, whose next two epochs match the sharded
    resumed fit (and so the uninterrupted one)."""
    pfx = ranks[n][0][1]['ckpt_prefix']
    x, y = R.mlp_data()
    mod = tmx.mod.Module.load(pfx, 2, load_optimizer_states=True,
                              context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=R.MLP_BATCH), num_epoch=4,
            begin_epoch=2, optimizer='sgd', optimizer_params=R.MLP_OPT,
            eval_metric='acc', arg_params=mod._arg_params,
            aux_params=mod._aux_params)
    got = R.params_of(mod)
    arrays = ranks[n][0][0]
    for k, v in got.items():
        np.testing.assert_allclose(v, arrays['ckpt_resumed/' + k],
                                   rtol=2e-5, atol=2e-6, err_msg=k)
    # and the momentum is there: without it the fit ends elsewhere
    cold = tmx.mod.Module.load(pfx, 2, context=tmx.cpu())
    cold.fit(tmx.io.NDArrayIter(x, y, batch_size=R.MLP_BATCH), num_epoch=4,
             begin_epoch=2, optimizer='sgd', optimizer_params=R.MLP_OPT,
             eval_metric='acc', arg_params=cold._arg_params,
             aux_params=cold._aux_params)
    far = R.params_of(cold)
    assert max(float(np.max(np.abs(far[k] - got[k]))) for k in got) > 1e-3


@pytest.mark.parametrize('n', WORLDS)
def test_auto_resume_under_mesh(ranks, n):
    """fit(checkpoint_prefix=, auto_resume=True) on a mesh: rank 0's
    newest checkpoint, broadcast, resumes every rank once; rank 0 alone
    wrote the files; the fit keeps the fused step."""
    for _, numbers in ranks[n]:
        assert numbers['auto_resumes'] == 1
        assert numbers['auto_resume_fused']
        assert numbers['auto_resume_files'] == [
            'ar%d-0001.params' % n, 'ar%d-0002.params' % n,
            'ar%d-0003.params' % n, 'ar%d-symbol.json' % n]
