"""The ranks of the mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_zero.py``, ``tests/test_torch_commwatch.py``): each
test file starts one ``torch.multiprocessing.spawn`` of gloo workers per
world size, and every worker runs that file's cases (:data:`SUITES`) as
one rank of the job and saves what it got under the spawn's directory
(``<suite>_r<rank>.npz`` arrays, ``<suite>_r<rank>.json`` numbers); the
test compares them with the JAX package, which runs in the test's own
process.  This module imports neither jax nor ``mxnet_tpu`` (a spawned
child imports it, not the test file), and the test files build their
JAX-side inputs from the same functions here.  Every wait is bounded:
the process group's timeout is :data:`TIMEOUT_S`, a failed rank ends the
spawn and the spawn is killed past :data:`SPAWN_TIMEOUT_S`."""
import datetime
import json
import os

import numpy as np

TIMEOUT_S = 60              # the process group's, each collective
SPAWN_TIMEOUT_S = 300       # a spawn's ranks, all their cases

# the JAX multichip test's MLP fit (tests/test_multichip_fit.py:_fit)
MLP_OPT = {'learning_rate': 0.1, 'momentum': 0.9}
MLP_ROWS, MLP_BATCH = 128, 32
# a narrow ResNet v2 with BatchNorm (tests/test_torch_train.py's, at 32²)
RESNET_OPT = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}
RESNET_BATCH, RESNET_STEPS, IMAGE = 8, 2, (3, 32, 32)

# (mesh, partition) per world size
MLP_MESHES = {2: [('2x1', 'replicated'), ('2x1', 'auto'),
                  ('1x2', 'replicated'), ('1x2', 'auto')],
              4: [('2x2', 'replicated'), ('2x2', 'auto')]}
RESNET_MESHES = {2: [('2x1', 'replicated')], 4: [('2x2', 'auto')]}
# the communication plane's meshes: dp 2 and 4 replicated, tp sharded
COMM_MESHES = {2: [('2x1', 'replicated'), ('1x2', 'auto')],
               4: [('4x1', 'replicated'), ('2x2', 'auto')]}
# make_zero_sgd_momentum / make_zero_train_step (tests/test_zero.py's):
# the JAX side on ZERO_DEVICES devices; n ranks each take the sum of
# ZERO_DEVICES / n devices' gradients, or their rows of the batch
ZERO_OPT = dict(lr=0.1, momentum=0.9, wd=1e-3)
ZERO_DEVICES = 4


def mlp(pkg):
    net = pkg.sym.Variable('data')
    net = pkg.sym.FullyConnected(net, num_hidden=32, name='fc1')
    net = pkg.sym.Activation(net, act_type='relu', name='act1')
    net = pkg.sym.FullyConnected(net, num_hidden=8, name='fc2')
    return pkg.sym.SoftmaxOutput(net, name='softmax')


def mlp_data(rows=MLP_ROWS):
    rng = np.random.RandomState(0)
    x = rng.randn(rows, 16).astype(np.float32)
    y = (rng.rand(rows) * 8).astype(np.float32)
    return x, y


def mlp_params():
    r = np.random.RandomState(11)
    return {'fc1_weight': r.uniform(-0.3, 0.3, (32, 16)).astype(np.float32),
            'fc1_bias': r.uniform(-0.05, 0.05, 32).astype(np.float32),
            'fc2_weight': r.uniform(-0.3, 0.3, (8, 32)).astype(np.float32),
            'fc2_bias': r.uniform(-0.05, 0.05, 8).astype(np.float32)}, {}


def narrow_resnet(tmx):
    return tmx.models.resnet.resnet(
        units=[1, 1, 1, 1], num_stages=4, filter_list=[8, 16, 32, 64, 128],
        num_classes=10, image_shape=IMAGE)


def resnet_case(tmx):
    """(symbol, arg, aux, x, y) of the ResNet fits, numpy from seeds."""
    from mxnet_tpu_torch import convert
    sym = narrow_resnet(tmx)
    arg, aux = convert.random_params(sym, {'data': (RESNET_BATCH,) + IMAGE},
                                     0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((RESNET_BATCH * RESNET_STEPS,) + IMAGE,
                            dtype=np.float32)
    y = rng.integers(0, 10, RESNET_BATCH * RESNET_STEPS).astype(np.float32)
    return sym, arg, aux, x, y


def fit(pkg, sym, arg, aux, x, y, batch, opt, num_epoch=1, context=None,
        module=None, eval_metric='acc', **kw):
    """``Module.fit`` of ``pkg`` (either package) from numpy parameters."""
    mod = module or pkg.mod.Module(sym, context=context or pkg.cpu())
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=batch), num_epoch=num_epoch,
            optimizer='sgd', optimizer_params=dict(opt),
            eval_metric=eval_metric,
            arg_params={k: pkg.nd.array(v) for k, v in arg.items()},
            aux_params={k: pkg.nd.array(v) for k, v in aux.items()}, **kw)
    return mod


def params_of(mod):
    arg, aux = mod.get_params()
    out = {'arg/' + k: v.asnumpy() for k, v in arg.items()}
    out.update({'aux/' + k: v.asnumpy() for k, v in aux.items()})
    return out


def zero_params():
    """tests/test_zero.py's parameters (one pads at every N)."""
    rng = np.random.RandomState(0)
    return {'w1': rng.randn(13, 7).astype(np.float32),
            'b1': rng.randn(7).astype(np.float32),
            'w2': rng.randn(16, 16).astype(np.float32)}


def zero_grads(seed, n=ZERO_DEVICES):
    """Per-device gradients, (ZERO_DEVICES, *shape) per parameter, summed
    into ``n`` ranks' parts."""
    rng = np.random.RandomState(seed)
    per = {k: rng.randn(ZERO_DEVICES, *v.shape).astype(np.float32) * 0.1
           for k, v in zero_params().items()}
    k = ZERO_DEVICES // n
    return {name: g.reshape((n, k) + g.shape[1:]).sum(1)
            for name, g in per.items()}


def zero_mlp(pkg):
    data = pkg.sym.Variable('data')
    net = pkg.sym.FullyConnected(data, num_hidden=16, name='fc1')
    net = pkg.sym.Activation(net, act_type='relu')
    net = pkg.sym.FullyConnected(net, num_hidden=4, name='fc2')
    return pkg.sym.SoftmaxOutput(net, name='softmax')


def zero_mlp_case():
    """tests/test_zero.py's train-step case at 4 rows a device."""
    rng = np.random.RandomState(3)
    batch = 4 * ZERO_DEVICES
    params = {'fc1_weight': rng.randn(16, 8).astype(np.float32) * 0.3,
              'fc1_bias': np.zeros(16, np.float32),
              'fc2_weight': rng.randn(4, 16).astype(np.float32) * 0.3,
              'fc2_bias': np.zeros(4, np.float32)}
    data = {'data': rng.rand(batch, 8).astype(np.float32),
            'softmax_label': rng.randint(0, 4, batch).astype(np.float32)}
    return params, data


# ---------------------------------------------------------------------------
# the suites
# ---------------------------------------------------------------------------

def _raises(fn):
    try:
        fn()
    except Exception as exc:          # noqa: BLE001 - the name is the result
        return type(exc).__name__
    return None


def readings(pkg, mod, metric):
    """The fit's metric (its last epoch, drained) and a ``score`` over
    the MLP's data."""
    x, y = mlp_data()
    score = mod.score(pkg.io.NDArrayIter(x, y, batch_size=MLP_BATCH),
                      ['acc', 'ce'])
    return {k: [(name, float(v)) for name, v in got]
            for k, got in (('fit', metric.get_name_value()),
                           ('score', score))}


def suite_mesh(tmx, n, rank, arrays, numbers):
    """Module.fit over every mesh of this world (MLP and ResNet), a
    BucketingModule, and the refusals."""
    x, y = mlp_data()
    arg, aux = mlp_params()
    for mesh, part in MLP_MESHES[n]:
        metric = tmx.metric.create(['acc', 'ce'])
        mod = fit(tmx, mlp(tmx), arg, aux, x, y, MLP_BATCH, MLP_OPT,
                  num_epoch=2, mesh=mesh, partition=part,
                  eval_metric=metric)
        key = 'mlp_%s_%s' % (mesh, part)
        numbers[key + '_fused'] = mod._fused is not None
        numbers[key + '_records'] = mod._mesh_plan.records_doc()
        numbers[key + '_readings'] = readings(tmx, mod, metric)
        arrays.update({key + '/' + k: v for k, v in params_of(mod).items()})
    # the per-parameter loop, and the health probe under skip_update
    for key, env in (('loop', {'MXTPU_FUSED_FIT': '0'}),
                     ('health', {'MXTPU_HEALTH_SENTINELS': '1',
                                 'MXTPU_HEALTH_ACTION': 'skip_update'})):
        os.environ.update(env)
        try:
            mod = fit(tmx, mlp(tmx), arg, aux, x, y, MLP_BATCH, MLP_OPT,
                      num_epoch=2, mesh='%dx1' % n)
        finally:
            for k in env:
                os.environ.pop(k)
        numbers[key + '_fused'] = mod._fused is not None
        arrays.update({key + '/' + k: v for k, v in params_of(mod).items()})
    sym, arg, aux, x, y = resnet_case(tmx)
    for mesh, part in RESNET_MESHES[n]:
        mod = fit(tmx, sym, arg, aux, x, y, RESNET_BATCH, RESNET_OPT,
                  mesh=mesh, partition=part)
        key = 'resnet_%s_%s' % (mesh, part)
        arrays.update({key + '/' + k: v for k, v in params_of(mod).items()})
    if n == 2:
        numbers['metric_after_fit'] = metric_after_fit(tmx, n, rank)
    x, y = mlp_data(96)
    arg, aux = mlp_params()
    numbers['batch_not_divisible'] = _raises(lambda: fit(
        tmx, mlp(tmx), arg, aux, x, y, 33, MLP_OPT, mesh='%dx1' % n))
    numbers['mesh_past_the_world'] = _raises(lambda: fit(
        tmx, mlp(tmx), arg, aux, x, y, 32, MLP_OPT, mesh='%dx2' % n))
    numbers['mesh_short_of_the_world'] = _raises(lambda: fit(
        tmx, mlp(tmx), arg, aux, x, y, 32, MLP_OPT, mesh='%dx1' % (n // 2)))
    if n == 2:
        arrays.update({'bucketing/' + k: v
                       for k, v in bucketing_run(tmx, '2x1').items()})


def metric_after_fit(tmx, n, rank):
    """After a fit over dp the metric is the caller's again: on rank 0
    alone (the other ranks wait at a barrier) a read of it, then an
    unmeshed fit that reuses it, issue no collective.  Returns, on rank
    0, the collectives issued meanwhile, the read after the mesh fit, the
    reused metric's reading and a fresh metric's over the same unmeshed
    fit."""
    from mxnet_tpu_torch.parallel import collectives
    x, y = mlp_data()
    arg, aux = mlp_params()
    metric = tmx.metric.create(['acc', 'ce'])
    fit(tmx, mlp(tmx), arg, aux, x, y, MLP_BATCH, MLP_OPT, num_epoch=2,
        mesh='%dx1' % n, partition='replicated', eval_metric=metric)
    out = None
    if rank == 0:
        issued, plain = [], collectives._issue

        def counted(kind, *a):
            issued.append(kind)
            return plain(kind, *a)
        collectives._issue = counted
        try:
            after = metric.get_name_value()
            fit(tmx, mlp(tmx), arg, aux, x, y, MLP_BATCH, MLP_OPT,
                eval_metric=metric)
            reused = metric.get_name_value()
        finally:
            collectives._issue = plain
        fresh = tmx.metric.create(['acc', 'ce'])
        fit(tmx, mlp(tmx), arg, aux, x, y, MLP_BATCH, MLP_OPT,
            eval_metric=fresh)
        out = {'collectives': issued, 'after': after, 'reused': reused,
               'fresh': fresh.get_name_value()}
        out.update({k: [(name, float(v)) for name, v in out[k]]
                    for k in ('after', 'reused', 'fresh')})
    collectives.host_barrier()
    return out


def bucketing_sym_gen(pkg):
    """tests/test_multichip_fit.py's bucketing symbol."""
    def sym_gen(seq_len):
        data = pkg.sym.Variable('data')
        emb = pkg.sym.Embedding(data, input_dim=16, output_dim=8,
                                name='embed')
        pooled = pkg.sym.mean(emb, axis=1)
        fc = pkg.sym.FullyConnected(pooled, num_hidden=4, name='fc')
        return (pkg.sym.SoftmaxOutput(fc, name='softmax'),
                ['data'], ['softmax_label'])
    return sym_gen


def bucketing_params():
    r = np.random.RandomState(12)
    return {'embed_weight': r.uniform(-0.1, 0.1, (16, 8)).astype(np.float32),
            'fc_weight': r.uniform(-0.1, 0.1, (4, 8)).astype(np.float32),
            'fc_bias': np.zeros(4, np.float32)}


def bucketing_run(pkg, mesh):
    """tests/test_multichip_fit.py's bucketing parity case (six steps over
    buckets 8, 4, 8), from numpy parameters; returns the parameters."""
    mod = pkg.mod.BucketingModule(bucketing_sym_gen(pkg),
                                  default_bucket_key=8, context=pkg.cpu())
    if mesh:
        mod._set_parallel(mesh)
    mod.bind(data_shapes=[('data', (8, 8))],
             label_shapes=[('softmax_label', (8,))])
    mod.init_params(arg_params={k: pkg.nd.array(v)
                                for k, v in bucketing_params().items()})
    mod.init_optimizer(optimizer='sgd',
                       optimizer_params={'learning_rate': 0.1,
                                         'momentum': 0.9})
    rngb = np.random.RandomState(0)
    for step in range(6):
        seq = [8, 4, 8][step % 3]
        batch = pkg.io.DataBatch(
            [pkg.nd.array(rngb.randint(0, 16, (8, seq)).astype(np.float32))],
            [pkg.nd.array(rngb.randint(0, 4, 8).astype(np.float32))],
            bucket_key=seq, provide_data=[('data', (8, seq))],
            provide_label=[('softmax_label', (8,))])
        mod._fit_step(batch)
    plans = [m._mesh_plan for m in mod._buckets.values()]
    if mesh and (None in plans or (hasattr(mod, '_mesh_plan') and any(
            p is not mod._mesh_plan for p in plans))):
        raise AssertionError('a bucket does not carry the shared plan')
    arg, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


def suite_zero(tmx, n, rank, arrays, numbers):
    """make_zero_sgd_momentum / make_zero_train_step on n ranks, each
    rank's resident ZeRO bytes, and the checkpoint round trip and
    auto-resume of a sharded fit."""
    import torch
    from mxnet_tpu_torch.parallel import mesh as tmesh
    from mxnet_tpu_torch.parallel import zero as tzero
    mesh = tmesh.build_dp_tp_mesh('%dx1' % n)
    group = mesh.group('dp')
    params = {k: torch.from_numpy(v) for k, v in zero_params().items()}
    for steps, seed in ((1, 1), (2, 2)):
        upd = tzero.make_zero_sgd_momentum(
            group, n, rescale_grad=1.0 / ZERO_DEVICES,
            **dict(ZERO_OPT, wd=0.0 if steps == 2 else ZERO_OPT['wd']))
        p, mom = dict(params), tzero.zero_init(params, n)
        for s in range(steps):
            g = {k: torch.from_numpy(v[rank])
                 for k, v in zero_grads(seed + 10 * s, n).items()}
            p, mom = upd(p, g, mom)
        arrays.update({'sgd%d/%s' % (steps, k): v.numpy()
                       for k, v in p.items()})
        numbers['sgd%d_state_numel' % steps] = int(mom.numel())
    # the train step, this rank's rows
    arg, data = zero_mlp_case()
    per = 4 * ZERO_DEVICES // n
    rows = slice(rank * per, (rank + 1) * per)
    step = tzero.make_zero_train_step(
        zero_mlp(tmx), mesh, 'dp', rescale_grad=1.0 / (4 * ZERO_DEVICES),
        donate=False, **ZERO_OPT)
    p = {k: torch.from_numpy(v) for k, v in arg.items()}
    opt = tzero.zero_opt_init(p, n)[rank]
    batch = {k: torch.from_numpy(v[rows]) for k, v in data.items()}
    outs, p1, _, opt1 = step(p, {}, opt, batch)
    arrays['step/out'] = outs[0].numpy()
    arrays.update({'step/' + k: v.numpy() for k, v in p1.items()})
    outs, _, _, _ = step(p1, {}, opt1, batch)
    numbers['step2_finite'] = bool(np.isfinite(outs[0].numpy()).all())
    # the refusal on a shard-local loss divisor
    bad = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable('data'), num_hidden=4, name='fc1'), name='softmax',
        normalization='batch')
    try:
        tzero.make_zero_train_step(bad, mesh, 'dp')
        numbers['shard_local_refusal'] = None
    except ValueError as exc:
        numbers['shard_local_refusal'] = str(exc)
    # resident ZeRO bytes of a fit, every mesh of this world
    x, y = mlp_data()
    arg, aux = mlp_params()
    for mesh_spec, part in MLP_MESHES[n]:
        mod = fit(tmx, mlp(tmx), arg, aux, x, y, MLP_BATCH, MLP_OPT,
                  mesh=mesh_spec, partition=part)
        key = 'bytes_%s_%s' % (mesh_spec, part)
        numbers[key] = {name: [int(s.numel() * s.element_size())]
                        for name, s in mod._fused_opt_state.items()}
        numbers[key + '_tp_dims'] = mod._fused.zero.tp_dims
    checkpoint_cases(tmx, n, rank, arrays, numbers)


CKPT_MESH = {2: ('2x1', 'replicated'), 4: ('2x2', 'auto')}


def checkpoint_cases(tmx, n, rank, arrays, numbers):
    """A sharded fit saved after 2 of 4 epochs and resumed through
    Module.load(load_optimizer_states=True) against the uninterrupted
    fit; fit(checkpoint_prefix=, auto_resume=True)."""
    from mxnet_tpu_torch import instrument
    root = os.environ['MESH_TEST_ROOT']
    mesh, part = CKPT_MESH[n]
    x, y = mlp_data()
    arg, aux = mlp_params()
    whole = fit(tmx, mlp(tmx), arg, aux, x, y, MLP_BATCH, MLP_OPT,
                num_epoch=4, mesh=mesh, partition=part)
    arrays.update({'ckpt_whole/' + k: v
                   for k, v in params_of(whole).items()})
    pfx = os.path.join(root, 'ck%d' % n)
    first = fit(tmx, mlp(tmx), arg, aux, x, y, MLP_BATCH, MLP_OPT,
                num_epoch=2, mesh=mesh, partition=part)
    first.save_checkpoint(pfx, 2, save_optimizer_states=True)
    numbers['ckpt_prefix'] = pfx
    resumed = tmx.mod.Module.load(pfx, 2, load_optimizer_states=True,
                                  context=tmx.cpu())
    resumed.fit(tmx.io.NDArrayIter(x, y, batch_size=MLP_BATCH), num_epoch=4,
                begin_epoch=2, optimizer='sgd', optimizer_params=MLP_OPT,
                eval_metric='acc', arg_params=resumed._arg_params,
                aux_params=resumed._aux_params, mesh=mesh, partition=part)
    arrays.update({'ckpt_resumed/' + k: v
                   for k, v in params_of(resumed).items()})
    pfx2 = os.path.join(root, 'ar%d' % n)
    fit(tmx, mlp(tmx), arg, aux, x, y, MLP_BATCH, MLP_OPT, num_epoch=2,
        mesh=mesh, partition=part, checkpoint_prefix=pfx2)
    instrument.set_metrics(True)
    before = instrument.counter_value('checkpoint.resumes')
    mod = fit(tmx, mlp(tmx), arg, aux, x, y, MLP_BATCH, MLP_OPT,
              num_epoch=3, mesh=mesh, partition=part,
              checkpoint_prefix=pfx2, auto_resume=True)
    numbers['auto_resumes'] = instrument.counter_value(
        'checkpoint.resumes') - before
    numbers['auto_resume_fused'] = mod._fused is not None
    numbers['auto_resume_files'] = sorted(
        f for f in os.listdir(root) if f.startswith('ar%d-' % n))


def suite_comm(tmx, n, rank, arrays, numbers):
    """The communication plane over each mesh of this world's MLP fits
    (MXTPU_COMMWATCH and MXTPU_PERFWATCH on): the step's collectives, the
    per-kind totals, comm_fraction and the perfwatch row."""
    from mxnet_tpu_torch import commwatch, instrument, perfwatch
    x, y = mlp_data()
    arg, aux = mlp_params()
    for mesh, part in COMM_MESHES[n]:
        commwatch.clear_programs()
        perfwatch.clear_executables()
        instrument.reset_metrics()
        mod = fit(tmx, mlp(tmx), arg, aux, x, y, MLP_BATCH, MLP_OPT,
                  mesh=mesh, partition=part)
        snap = instrument.metrics_snapshot()
        gauges = snap['gauges']
        key = '%s_%s' % (mesh, part)
        rows = [r for r in perfwatch.executables() if r['kind'] == 'fit_step']
        numbers[key] = {
            'bytes_per_step': gauges.get('comm.bytes_per_step'),
            'comm_fraction': gauges.get('perf.comm_fraction'),
            'step_records': commwatch.step_records(),
            'programs': commwatch.programs(),
            'totals': {k: v for k, v in gauges.items()
                       if k.startswith('comm.') and '[' not in k},
            'num_devices': gauges.get('perf.num_devices'),
            'mfu': gauges.get('perf.mfu'),
            'step_flops': gauges.get('perf.step_flops'),
            'row': rows[0] if rows else None,
            'step_time_count': (snap.get('histograms') or {}).get(
                'comm.step_time', {}).get('count'),
            'fused': mod._fused is not None}


def suite_card(tmx, n, rank, arrays, numbers):
    """The narrow ResNet's f32 fit on '<n>x1' with every rank on the one
    card (gloo over CUDA tensors): parameters, launches per kernel."""
    import torch
    from mxnet_tpu_torch.ops import fused, fused_conv
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = (fused.fused_scale_bias_dot,
               fused_conv.fused_scale_bias_conv3x3, fused.fused_bn_relu)
    for k in kernels:
        k.launches = 0
    sym, arg, aux, x, y = resnet_case(tmx)
    mod = fit(tmx, sym, arg, aux, x, y, RESNET_BATCH, RESNET_OPT,
              context=tmx.gpu(0), mesh='%dx1' % n)
    arrays.update(params_of(mod))
    numbers['launches'] = {k.__name__: k.launches for k in kernels}


SUITES = {'mesh': suite_mesh, 'zero': suite_zero, 'comm': suite_comm,
          'card': suite_card}


def worker(rank, n, root, suite, env):
    """One rank: join the job (gloo, a file rendezvous under ``root``),
    run ``suite`` and save what it got."""
    os.environ.update(env)
    os.environ['MESH_TEST_ROOT'] = root
    import torch.distributed as dist
    dist.init_process_group(
        'gloo', init_method='file://' + os.path.join(root, 'store'),
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        import mxnet_tpu_torch as tmx
        arrays, numbers = {}, {}
        SUITES[suite](tmx, n, rank, arrays, numbers)
        np.savez(os.path.join(root, '%s_r%d.npz' % (suite, rank)), **arrays)
        with open(os.path.join(root, '%s_r%d.json' % (suite, rank)),
                  'w') as f:
            json.dump(numbers, f, default=str)
    finally:
        dist.destroy_process_group()


def spawn(suite, n, root, env=None):
    """Run ``suite`` on ``n`` gloo ranks, killed past SPAWN_TIMEOUT_S;
    returns each rank's (arrays, numbers)."""
    import time
    import torch.multiprocessing as mp
    base = {'MXTPU_FUSE': os.environ.get('MXTPU_FUSE', 'aggressive')}
    base.update(env or {})
    ctx = mp.spawn(worker, args=(n, root, suite, base), nprocs=n,
                   join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError('the %s ranks ran past %d s'
                               % (suite, SPAWN_TIMEOUT_S))
    out = []
    for r in range(n):
        arrays = dict(np.load(os.path.join(root, '%s_r%d.npz' % (suite, r))))
        with open(os.path.join(root, '%s_r%d.json' % (suite, r))) as f:
            out.append((arrays, json.load(f)))
    return out
