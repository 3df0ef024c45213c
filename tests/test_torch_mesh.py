"""The dp×tp product path of the PyTorch port — ``Module.fit(mesh=,
partition=)`` on ``torch.distributed`` — against the JAX package's
sharded fit (``tests/test_multichip_fit.py``), on the CPU.

The JAX side runs here, on the conftest's 8 virtual devices.  The port's
side runs as ranks: one ``torch.multiprocessing.spawn`` of gloo workers
per world size (2 and 4, module-scoped), each rank one mesh position,
running ``tests/torch_mesh_ranks.py``'s 'mesh' suite (jax-free) and
saving what it got; both packages start from the same numpy parameters
and data.  Cases: the MLP over '2x1'/'1x2' (2 ranks) and '2x2' (4 ranks)
under 'replicated' and 'auto', and the narrow ResNet v2 (BatchNorm over
the global batch, ``MXTPU_FUSE=aggressive``, the JAX side's Pallas in
interpret mode) under '2x1' replicated, '1x2' and '2x2' auto, each
against JAX's fit with the same mesh at rtol 2e-5, atol 2e-6 (the JAX
test's own tolerance), every rank's parameters bit for bit equal; the
plan's inspector records equal JAX's; '1x1' bit for bit the port's
unmeshed fit (params and score); the refusals (batch not divisible by
dp, a context list, a mesh past or short of the job); dist kvstore
demotion; the mesh-change rule; a BucketingModule on a mesh."""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.parallel import mesh as jmesh
from mxnet_tpu.parallel import zero as jzero
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import zero as tzero

import torch_mesh_ranks as R

RTOL, ATOL = 2e-5, 2e-6


@pytest.fixture(scope='module', autouse=True)
def _fuse_env():
    saved = {k: os.environ.get(k) for k in
             ('MXTPU_FUSE', 'MXTPU_FORCE_PALLAS_INTERPRET')}
    os.environ['MXTPU_FUSE'] = 'aggressive'
    os.environ['MXTPU_FORCE_PALLAS_INTERPRET'] = '1'
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _spawn(n, tmp_path_factory):
    return R.spawn('mesh', n, str(tmp_path_factory.mktemp('mesh%d' % n)))


@pytest.fixture(scope='module')
def world2(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope='module')
def world4(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


def _world(request, n):
    return request.getfixturevalue('world%d' % n)


def _case(ranks, key):
    """The rank-0 arrays of ``key``, after checking every rank holds the
    same bit for bit."""
    got = [{k[len(key) + 1:]: v for k, v in arrays.items()
            if k.startswith(key + '/')} for arrays, _ in ranks]
    assert got[0], key
    for other in got[1:]:
        assert sorted(other) == sorted(got[0])
        for k in got[0]:
            np.testing.assert_array_equal(other[k], got[0][k], err_msg=k)
    return got[0]


def _assert_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


_JAX = {}


def _jax_mlp(mesh, part):
    """JAX's MLP fit on ``mesh``: (params, module, metric readings)."""
    key = ('mlp', mesh, part)
    if key not in _JAX:
        x, y = R.mlp_data()
        arg, aux = R.mlp_params()
        metric = mx.metric.create(['acc', 'ce'])
        mod = R.fit(mx, R.mlp(mx), arg, aux, x, y, R.MLP_BATCH, R.MLP_OPT,
                    num_epoch=2, mesh=mesh, partition=part,
                    eval_metric=metric)
        _JAX[key] = (R.params_of(mod), mod, R.readings(mx, mod, metric))
    return _JAX[key]


def _jax_resnet(mesh, part):
    key = ('resnet', mesh, part)
    if key not in _JAX:
        sym, arg, aux, x, y = R.resnet_case(tmx)
        mod = R.fit(mx, mx.sym.load_json(sym.tojson()), arg, aux, x, y,
                    R.RESNET_BATCH, R.RESNET_OPT, mesh=mesh, partition=part)
        _JAX[key] = (R.params_of(mod), mod)
    return _JAX[key]


MLP_CASES = [(n, m, p) for n, cases in sorted(R.MLP_MESHES.items())
             for m, p in cases]
RESNET_CASES = [(n, m, p) for n, cases in sorted(R.RESNET_MESHES.items())
                for m, p in cases]


# ---------------------------------------------------------------------------
# the vocabulary: specs, plans, records (no ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('spec', ['4x2', '4,2', '8', 8, 'dp=2,tp=4', 'tp=2',
                                  'DP=2; tp=2', (2, 2), [3], {'dp': 2},
                                  '1x1', ' 2 X 4 '])
def test_parse_mesh_spec_matches_jax(spec):
    assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)


@pytest.mark.parametrize('spec', ['pp=4', '', {'pp': 2}, (1, 2, 3)])
def test_parse_mesh_spec_refusals_match_jax(spec):
    with pytest.raises(ValueError):
        jmesh.parse_mesh_spec(spec)
    with pytest.raises(ValueError):
        tmesh.parse_mesh_spec(spec)


SHAPES = {'fc1_weight': (32, 16), 'fc1_bias': (32,), 'fc2_weight': (8, 32),
          'fc2_bias': (8,), 'odd_weight': (7, 5), 'bn_gamma': (3,),
          'conv_weight': (64, 32, 3, 3), 'embed_weight': (1000, 12)}


@pytest.mark.parametrize('mesh_spec,partition,slots', [
    ('2x1', None, 1), ('1x2', 'auto', 1), ('2x2', 'auto', 2),
    ('4x2', 'tp', 1), ('2x4', 'auto', 1), ('8', 'replicated', 2),
    ('2x2', {'fc1': ('tp', None), 'conv': 'auto'}, 1)])
def test_records_for_shapes_match_jax(mesh_spec, partition, slots):
    """The inspector's decisions, shard bytes, ZeRO columns and
    degradation reasons, word for word."""
    want = jmesh.records_for_shapes(SHAPES, mesh_spec, partition,
                                    opt_slots=slots)
    got = tmesh.records_for_shapes(SHAPES, mesh_spec, partition,
                                   opt_slots=slots)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


@pytest.mark.parametrize('shape,partition,name', [
    ((32, 16), 'replicated', None), ((32, 16), 'auto', None),
    ((8, 32), 'auto', None), ((7, 5), 'auto', None), ((7, 5), 'tp', None),
    ((32, 16), {'fc1': ('tp', None)}, 'fc1_weight'),
    ((32, 16), {'fc2': ('tp', None)}, 'fc1_weight'),
    ((64, 32, 3, 3), {'conv': 'auto'}, 'conv_weight')])
def test_partition_spec_matches_jax(shape, partition, name):
    jm = jmesh.build_dp_tp_mesh('4x2')
    tm = tmesh.RankMesh(4, 2)
    assert tmesh.partition_spec(shape, tm, partition, name) == \
        tuple(jmesh.partition_spec(shape, jm, partition, name))
    base = jmesh.partition_spec(shape, jm, partition, name)
    assert tzero.zero_partition_spec(shape, tm, base=tuple(base)) == \
        tuple(jzero.zero_partition_spec(shape, jm, base=base))


@pytest.mark.parametrize('mesh_spec,partition', [
    ('2x2', 'auto'), ('4x1', None), ('1x2', 'replicated'),
    ('2x4', {'fc1': ('tp', None), 'conv': 'auto'})])
def test_plan_sig_and_mesh_sig_match_jax(mesh_spec, partition):
    axes = tmesh.parse_mesh_spec(mesh_spec)
    tplan = tmesh.ShardingPlan(tmesh.RankMesh(axes['dp'], axes['tp']),
                               partition)
    jplan = jmesh.ShardingPlan(jmesh.build_dp_tp_mesh(mesh_spec), partition)
    assert tplan.sig() == jplan.sig()
    assert tmesh.mesh_sig(tplan.mesh) == jmesh.mesh_sig(jplan.mesh)
    assert (tplan.dp, tplan.tp, tplan.num_devices) == \
        (jplan.dp, jplan.tp, jplan.num_devices)
    for rows in (36, 32):
        if rows % jplan.dp:
            with pytest.raises(ValueError):
                jplan.validate_batch(rows)
            with pytest.raises(ValueError):
                tplan.validate_batch(rows)


def test_one_rank_mesh_needs_no_group_and_a_larger_one_needs_ranks():
    one = tmesh.build_dp_tp_mesh('1x1')
    assert one.size == 1 and one.coords == (0, 0)
    assert one.group('dp') is None and one.group('tp') is None
    with pytest.raises(ValueError, match='needs 2 ranks'):
        tmesh.build_dp_tp_mesh('2x1')
    with pytest.raises(ValueError):
        jmesh.build_dp_tp_mesh('16x2')       # 8 virtual devices


# ---------------------------------------------------------------------------
# '1x1', the refusals, the store, in this process
# ---------------------------------------------------------------------------

def _mlp_fit(**kw):
    x, y = R.mlp_data()
    arg, aux = R.mlp_params()
    return R.fit(tmx, R.mlp(tmx), arg, aux, x, y, R.MLP_BATCH, R.MLP_OPT,
                 **kw)


@pytest.mark.parametrize('model', ['mlp', 'resnet'])
def test_mesh_1x1_bit_for_bit(model):
    """'1x1' is the unmeshed fit: parameters, aux and the score bit for
    bit, no collective, the plan's sig on the step's manifest meta."""
    if model == 'mlp':
        x, y = R.mlp_data()
        sym, (arg, aux), batch, opt = R.mlp(tmx), R.mlp_params(), \
            R.MLP_BATCH, R.MLP_OPT
    else:
        sym, arg, aux, x, y = R.resnet_case(tmx)
        batch, opt = R.RESNET_BATCH, R.RESNET_OPT
    base = R.fit(tmx, sym, arg, aux, x, y, batch, opt, num_epoch=2)
    one = R.fit(tmx, sym, arg, aux, x, y, batch, opt, num_epoch=2,
                mesh='1x1', partition='auto')
    want, got = R.params_of(base), R.params_of(one)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert one._fused is not None and one._fused.zero is None
    assert one._fused_shardings is not None
    assert one._fit_meta()['mesh'] == 'dp=1,tp=1|auto'
    assert len(one._graphs) == len(base._graphs) > 0
    assert all(k[-1] == ('__mesh__', 'dp=1,tp=1|auto') for k in one._graphs)
    it = [tmx.io.NDArrayIter(x, y, batch_size=batch) for _ in range(2)]
    assert base.score(it[0], 'acc') == one.score(it[1], 'acc')


def test_mesh_and_context_list_exclusive():
    with pytest.raises(tmx.MXNetError):
        mod = tmx.mod.Module(R.mlp(tmx), context=[tmx.cpu(0), tmx.cpu(1)])
        _mlp_fit(module=mod, mesh='1x1')


def test_partition_without_a_mesh_is_ignored():
    """As in the reference: ``partition`` alone changes nothing."""
    a, b = R.params_of(_mlp_fit()), R.params_of(_mlp_fit(partition='auto'))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dist_kvstore_demoted_under_mesh():
    """A dist store passed with a mesh keeps its control plane; push and
    pull raise; the fit keeps the fused step."""
    mod = _mlp_fit(mesh='1x1', kvstore='dist_async')
    kv = mod._kvstore
    try:
        assert kv.control_plane_only and mod._fused is not None
        kv.barrier()
        with pytest.raises(tmx.MXNetError):
            kv.push(0, tmx.nd.array(np.zeros(3, np.float32)))
        with pytest.raises(tmx.MXNetError):
            kv.pull(0, out=tmx.nd.array(np.zeros(3, np.float32)))
    finally:
        kv.close()


def test_mesh_change_reinitializes_optimizer():
    """A fit without a mesh, then one with: the optimizer is set up again
    and the dist store demoted (tests/test_multichip_fit.py's rule)."""
    mod = _mlp_fit()
    assert mod.optimizer_initialized and mod._mesh_plan is None
    mod2 = _mlp_fit(module=mod, mesh='1x1', kvstore='dist_async')
    try:
        assert mod2._kvstore is not None and mod2._kvstore.control_plane_only
        assert mod2._fused is not None
    finally:
        mod2._kvstore.close()


def test_nonfused_loop_under_mesh_1x1(monkeypatch):
    """MXTPU_FUSED_FIT=0 on a mesh trains through the Updater loop, bit
    for bit the unmeshed loop at '1x1'."""
    monkeypatch.setenv('MXTPU_FUSED_FIT', '0')
    a = R.params_of(_mlp_fit())
    mod = _mlp_fit(mesh='1x1')
    assert mod._fused is None
    b = R.params_of(mod)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the ranks against JAX's sharded fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n,mesh,part', MLP_CASES)
def test_mlp_fit_matches_jax(request, n, mesh, part):
    ranks = _world(request, n)
    key = 'mlp_%s_%s' % (mesh, part)
    assert ranks[0][1][key + '_fused']
    _assert_close(_case(ranks, key), _jax_mlp(mesh, part)[0])


@pytest.mark.parametrize('n,mesh,part', MLP_CASES)
def test_mesh_metric_and_score_match_jax(request, n, mesh, part):
    """The fit's device-folded metric (each rank folds its rows, the
    drain sums over dp) and ``score`` (outputs all-gathered over dp):
    the global batch's readings on every rank, as JAX's."""
    want = _jax_mlp(mesh, part)[2]
    for _, numbers in _world(request, n):
        got = numbers['mlp_%s_%s_readings' % (mesh, part)]
        for kind in ('fit', 'score'):
            assert [k for k, _ in got[kind]] == [k for k, _ in want[kind]]
            np.testing.assert_allclose([v for _, v in got[kind]],
                                       [v for _, v in want[kind]],
                                       rtol=RTOL, atol=ATOL, err_msg=kind)


def test_metric_after_a_dp_fit_reads_without_a_collective(world2):
    """After a '2x1' fit the metric is the caller's again: on rank 0
    alone a read of it and an unmeshed fit that reuses it issue no
    collective (a dp sum left on it would wait for rank 1 until the group
    timeout); the read is the mesh fit's, and the reused metric reads as
    a fresh one over the same unmeshed fit."""
    got = world2[0][1]['metric_after_fit']
    assert got['collectives'] == []
    assert got['after'] == world2[0][1]['mlp_2x1_replicated_readings'][
        'fit']
    assert got['reused'] == got['fresh']
    assert world2[1][1]['metric_after_fit'] is None


@pytest.mark.parametrize('n', [2, 4])
def test_loop_and_health_probe_on_ranks(request, n):
    """MXTPU_FUSED_FIT=0 on '<n>x1' (the Updater loop on the rank's rows,
    the gradients all-reduced over dp) and the fused step with the
    skip_update probe (the ranks agree on ok; no step is skipped) both
    train JAX's sharded MLP fit."""
    ranks = _world(request, n)
    want = _jax_mlp('%dx1' % n, None)[0]
    assert not ranks[0][1]['loop_fused'] and ranks[0][1]['health_fused']
    for key in ('loop', 'health'):
        _assert_close(_case(ranks, key), want)


@pytest.mark.parametrize('n,mesh,part', RESNET_CASES)
def test_resnet_fit_matches_jax(request, n, mesh, part):
    """BatchNorm over the global batch: the parameters and the moving
    statistics of every rank against JAX's sharded fit."""
    ranks = _world(request, n)
    _assert_close(_case(ranks, 'resnet_%s_%s' % (mesh, part)),
                  _jax_resnet(mesh, part)[0])


@pytest.mark.parametrize('n,mesh,part', MLP_CASES)
def test_plan_records_match_jax(request, n, mesh, part):
    """The inspector records a sharded fit leaves: the same specs, shard
    bytes, ZeRO leaves and reasons as the JAX fit's plan."""
    ranks = _world(request, n)
    want = _jax_mlp(mesh, part)[1]._mesh_plan.records_doc()
    for _, numbers in ranks:
        got = numbers['mlp_%s_%s_records' % (mesh, part)]
        assert got == json.loads(json.dumps(want))


@pytest.mark.parametrize('n', [2, 4])
def test_refusals_in_ranks(request, n):
    """A batch not divisible by dp, a mesh past the job and one short of
    it raise ValueError on every rank (a one-rank mesh needs no group)."""
    for _, numbers in _world(request, n):
        assert numbers['batch_not_divisible'] == 'ValueError'
        assert numbers['mesh_past_the_world'] == 'ValueError'
        assert numbers['mesh_short_of_the_world'] == \
            ('ValueError' if n > 2 else None)


def test_bucketing_module_on_a_mesh(world2):
    """Every bucket takes the one plan; six steps over buckets 8, 4, 8 on
    '2x1' against the JAX BucketingModule on '2x1'."""
    got = _case(world2, 'bucketing')
    want = R.bucketing_run(mx, '2x1')
    _assert_close(got, want)
    unmeshed = R.bucketing_run(tmx, None)
    _assert_close(got, unmeshed)
