"""The port's distributed kvstores in local clusters of worker processes
started by the reference launcher (``tools/launch.py -n N --launcher
local``, the ``MXTPU_*`` contract), on the CPU over gloo.  This file is
also the worker (``python tests/test_torch_dist_kvstore.py <mode>``):

- ``sync``: ``dist_sync``'s push/pull arithmetic, exact, as
  ``tests/dist_sync_kvstore_worker.py`` checks it (single keys, a big
  key, one batched list push, the ``MXNET_KVSTORE_BIGARRAY_BOUND`` split,
  the replicated optimizer), with 2 and 3 workers;
- ``async``: ``dist_async`` with 2 workers, rank 0 hosting the server,
  every push applied on arrival (``tests/dist_async_kvstore_worker.py``);
- ``fit``: a 2-rank ``dist_sync`` ``Module.fit`` of an MLP, each rank on
  its half of every global batch of 16, against a one-process fit at
  16 rows (rtol 1e-5; the ranks' parameters bit for bit equal).

The launcher's port and the next one (the kv server's) are found free
by binding port 0; every cluster is killed past 60 s."""
import os
import signal
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)


def _free_port_pair():
    """A port the OS picked whose successor is free too (the launcher
    puts the kv server on port + 1)."""
    for _ in range(50):
        with socket.socket() as a:
            a.bind(('127.0.0.1', 0))
            port = a.getsockname()[1]
            if port >= 65535:
                continue
            with socket.socket() as b:
                try:
                    b.bind(('127.0.0.1', port + 1))
                except OSError:
                    continue
            return port
    raise RuntimeError('no free port pair')


def launch(nworkers, mode, extra_env=None, timeout=60):
    """Run this file as ``nworkers`` workers through tools/launch.py; the
    whole process group is killed past ``timeout``."""
    env = dict(os.environ)
    env.pop('MXTPU_KV_SERVER_ADDR', None)
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    env.update(extra_env or {})
    cmd = [sys.executable, os.path.join(ROOT, 'tools', 'launch.py'),
           '-n', str(nworkers), '--launcher', 'local',
           '--port', str(_free_port_pair()),
           '%s %s %s' % (sys.executable, HERE, mode)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=ROOT, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError('cluster timed out:\n' + out[-3000:])
    assert proc.returncode == 0, out[-3000:]
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _skip_without_gloo():
    import pytest
    from mxnet_tpu_torch.parallel import compat
    reason = compat.multiprocess_cpu_missing()
    if reason:
        pytest.skip(reason)


def _params(nworkers):
    import pytest
    return pytest.mark.parametrize('nworkers', nworkers)


@_params([2, 3])
def test_dist_sync_kvstore_local_cluster(nworkers):
    _skip_without_gloo()
    out = launch(nworkers, 'sync')
    for r in range(nworkers):
        assert 'dist_sync rank %d of %d OK' % (r, nworkers) in out, out


@_params([2])
def test_dist_async_kvstore_local_cluster(nworkers):
    out = launch(nworkers, 'async')
    for r in range(nworkers):
        assert 'dist_async rank %d of %d OK' % (r, nworkers) in out, out


def test_dist_sync_fit_two_ranks_equals_one_process_at_the_global_batch(
        tmp_path):
    _skip_without_gloo()
    out = launch(2, 'fit', {'KV_FIT_OUT': str(tmp_path)})
    assert 'fit rank 0 OK' in out and 'fit rank 1 OK' in out, out
    ranks = [dict(np.load(str(tmp_path / ('rank%d.npz' % r))))
             for r in range(2)]
    for k in ranks[0]:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
    want = _fit_mlp(None, 1, 0)
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0][k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_collectives_in_one_process_are_identities():
    import torch
    from mxnet_tpu_torch.parallel import collectives
    x = torch.arange(6.0)
    assert collectives.allreduce_hosts(x) is x
    got = collectives.allreduce_hosts_batch([x, x.view(2, 3)])
    assert got[0] is x and got[1].shape == (2, 3)
    collectives.host_barrier()
    assert (collectives.rank(), collectives.world_size()) == (0, 1)


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

GLOBAL_BATCH, STEPS = 16, 3


def _mlp(mx):
    net = mx.sym.FullyConnected(mx.sym.Variable('data'), num_hidden=12,
                                name='fc1')
    net = mx.sym.Activation(net, act_type='relu', name='relu1')
    net = mx.sym.FullyConnected(net, num_hidden=5, name='fc2')
    return mx.sym.SoftmaxOutput(net, name='softmax')


def _fit_mlp(kvstore, nranks, rank):
    """An MLP fit, STEPS global batches of GLOBAL_BATCH rows; this rank
    takes its contiguous part of every global batch."""
    import mxnet_tpu_torch as mx
    rng = np.random.RandomState(0)
    x = rng.randn(GLOBAL_BATCH * STEPS, 10).astype(np.float32)
    y = rng.randint(0, 5, GLOBAL_BATCH * STEPS).astype(np.float32)
    arg = {'fc1_weight': rng.randn(12, 10).astype(np.float32) * 0.3,
           'fc1_bias': rng.randn(12).astype(np.float32) * 0.1,
           'fc2_weight': rng.randn(5, 12).astype(np.float32) * 0.3,
           'fc2_bias': np.zeros(5, np.float32)}
    per = GLOBAL_BATCH // nranks
    rows = np.concatenate([np.arange(b * GLOBAL_BATCH + rank * per,
                                     b * GLOBAL_BATCH + (rank + 1) * per)
                           for b in range(STEPS)])
    m = mx.Module(_mlp(mx), context=mx.cpu())
    m.fit(mx.io.NDArrayIter(x[rows], y[rows], batch_size=per),
          num_epoch=1, kvstore=kvstore or 'local', optimizer='sgd',
          optimizer_params={'learning_rate': 0.5, 'momentum': 0.9,
                            'wd': 1e-4},
          arg_params={k: mx.nd.array(v) for k, v in arg.items()})
    return {k: v.asnumpy() for k, v in m.get_params()[0].items()}


def _worker_sync():
    import mxnet_tpu_torch as mx
    kv = mx.kv.create('dist_sync')
    rank, nworker = kv.rank, kv.num_workers
    assert nworker == int(os.environ['MXTPU_NUM_PROCESSES'])
    shape, big_shape = (3, 4), (50, 100)

    def full(s, v):
        return mx.nd.array(np.full(s, v, np.float32))
    kv.init(3, full(shape, 1))
    kv.init(99, full(big_shape, 1))
    kv.barrier()
    expected = sum(r + 1 for r in range(nworker))
    for it in range(3):
        kv.push(3, full(shape, rank + 1))
        kv.push(99, full(big_shape, (rank + 1) * 2))
        kv.barrier()
        out = mx.nd.zeros(shape)
        kv.pull(3, out=out)
        assert np.array_equal(out.asnumpy(), np.full(shape, expected)), it
        out_big = mx.nd.zeros(big_shape)
        kv.pull(99, out=out_big)
        assert np.array_equal(out_big.asnumpy(),
                              np.full(big_shape, 2 * expected)), it
    kv.barrier()
    kv.init(7, mx.nd.zeros(shape))
    kv.barrier()
    for bound in (None, '4000'):
        if bound:
            os.environ['MXNET_KVSTORE_BIGARRAY_BOUND'] = bound
        kv.push([3, 99, 7], [[full(shape, rank + 1)],
                             [full(big_shape, (rank + 1) * 2)],
                             [full(shape, (rank + 1) * 3)]])
        kv.barrier()
        outs = [mx.nd.zeros(shape), mx.nd.zeros(big_shape),
                mx.nd.zeros(shape)]
        kv.pull([3, 99, 7], out=outs)
        for got, mult in zip(outs, (1, 2, 3)):
            assert np.array_equal(got.asnumpy(),
                                  np.full(got.shape, expected * mult))
    os.environ.pop('MXNET_KVSTORE_BIGARRAY_BOUND', None)
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5, rescale_grad=1.0,
                                      wd=0.0))
    kv.init(11, full(shape, 10))
    kv.barrier()
    kv.push(11, full(shape, rank + 1))
    kv.barrier()
    out11 = mx.nd.zeros(shape)
    kv.pull(11, out=out11)
    assert np.allclose(out11.asnumpy(), 10 - 0.5 * expected)
    kv.barrier()
    print('dist_sync rank %d of %d OK (backend %s)'
          % (rank, nworker, kv.backend), flush=True)


def _worker_async():
    import mxnet_tpu_torch as mx
    kv = mx.kv.create('dist_async')
    rank, nworker = kv.rank, kv.num_workers
    assert nworker == int(os.environ['MXTPU_NUM_PROCESSES'])
    shape = (3, 4)
    kv.init(7, mx.nd.zeros(shape))
    kv.set_optimizer(mx.optimizer.Test(rescale_grad=1.0))
    iters = 5
    for _ in range(iters):
        kv.push(7, mx.nd.array(np.ones(shape, np.float32)))
    kv.barrier()
    out = mx.nd.zeros(shape)
    kv.pull(7, out=out)
    assert np.array_equal(out.asnumpy(), np.full(shape, iters * nworker))
    kv.barrier()
    assert kv.close() == 0
    print('dist_async rank %d of %d OK' % (rank, nworker), flush=True)


def _worker_fit():
    rank = int(os.environ['MXTPU_PROCESS_ID'])
    nranks = int(os.environ['MXTPU_NUM_PROCESSES'])
    params = _fit_mlp('dist_sync', nranks, rank)
    np.savez(os.path.join(os.environ['KV_FIT_OUT'], 'rank%d.npz' % rank),
             **params)
    print('fit rank %d OK' % rank, flush=True)


if __name__ == '__main__':
    sys.path.insert(0, ROOT)
    {'sync': _worker_sync, 'async': _worker_async,
     'fit': _worker_fit}[sys.argv[1]]()
