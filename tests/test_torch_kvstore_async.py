"""The port's apply-on-arrival server and client
(``mxnet_tpu_torch/kvstore_server.py``) and its ``dist_async`` store, on
the CPU: the cases of ``tests/test_kvstore_async.py``; the restart-mid-
push and kill-mid-barrier chaos cases of ``tests/test_resilience.py``
(a server child process with a backing file, killed and restarted on the
port the OS gave it); and the wire: a port client against the JAX
package's server, and a JAX client against the port's, exchange init,
push, pull and barrier with equal results.  Every port is the OS's
choice, and every wait is bounded (60 s at most)."""
import os
import pickle
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import instrument
from mxnet_tpu_torch.kvstore_server import AsyncKVClient, AsyncKVServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_pair(num_workers=1):
    server = AsyncKVServer(port=0, num_workers=num_workers)
    client = AsyncKVClient('127.0.0.1:%d' % server.port)
    return server, client


def _wait_for(pred, timeout=10.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.01)
    return pred()


def test_apply_on_arrival_accumulates():
    server, client = make_pair()
    try:
        client.init('w', np.zeros((4,), np.float32))
        client.set_optimizer_bytes(
            pickle.dumps(tmx.optimizer.Test(rescale_grad=1.0)))
        for _ in range(5):
            client.push('w', np.ones((4,), np.float32))
        client.barrier(timeout=30)
        np.testing.assert_allclose(client.pull('w'), 5.0)
        assert server.applied_pushes == 5
    finally:
        client.close()
        server.stop()


def test_push_is_non_blocking():
    """Pushes return while a slow updater is still applying them."""
    server, client = make_pair()
    applied = []

    def slow_updater(key, grad, weight):
        time.sleep(0.05)
        weight += grad
        applied.append(key)
    try:
        client.init('w', np.zeros((2,), np.float32))
        server._updater = slow_updater
        t0 = time.time()
        n = 10
        for _ in range(n):
            client.push('w', np.ones((2,), np.float32))
        assert time.time() - t0 < 0.25
        assert len(applied) < n
        client.barrier(timeout=30)      # rides behind the pushes
        assert len(applied) == n
        np.testing.assert_allclose(client.pull('w'), float(n))
    finally:
        client.close()
        server.stop()


def test_pull_sees_partial_state():
    """Overwrite on arrival without an optimizer; per-connection order."""
    server, client = make_pair()
    try:
        client.init('k', np.zeros((1,), np.float32))
        client.push('k', np.full((1,), 2.0, np.float32))
        client.push('k', np.full((1,), 3.0, np.float32))
        np.testing.assert_allclose(client.pull('k'), 3.0)
    finally:
        client.close()
        server.stop()


def test_kvstore_factory_and_type(monkeypatch):
    for k in ('MXTPU_KV_SERVER_ADDR', 'MXTPU_COORDINATOR',
              'MXTPU_PROCESS_ID', 'MXTPU_NUM_PROCESSES'):
        monkeypatch.delenv(k, raising=False)
    kv = tmx.kv.create('dist_async')
    try:
        assert kv.type == 'dist_async'
        assert kv.num_workers == 1 and kv.rank == 0
        kv.init(1, tmx.nd.array(np.ones(3, np.float32)))
        kv.set_optimizer(tmx.optimizer.Test(rescale_grad=1.0))
        kv.push(1, tmx.nd.array(np.full(3, 2.0, np.float32)))
        kv.barrier()
        out = tmx.nd.zeros((3,))
        kv.pull(1, out=out)
        np.testing.assert_allclose(out.asnumpy(), 3.0)     # 1 + 2
        with pytest.raises(Exception, match='distributed'):
            kv.save_optimizer_states('never-written')
        with pytest.raises(Exception, match='set_optimizer'):
            kv.set_updater(lambda *a: None)
        assert kv.num_dead_node() == 0
        assert isinstance(kv.telemetry(), dict)
        assert not kv.is_recovery
    finally:
        assert kv.close() == 0


def test_server_error_fails_fast():
    """A handler error (push before init) surfaces at the next rpc."""
    server, client = make_pair()
    try:
        client.push('never-inited', np.ones((2,), np.float32))
        with pytest.raises((RuntimeError, ConnectionError)):
            client.barrier(timeout=30)
    finally:
        client.close()
        server.stop()


def test_close_drains_pending_pushes():
    server, client = make_pair()
    try:
        client.init('k', np.zeros((4,), np.float32))
        for _ in range(50):
            client.push('k', np.ones((4,), np.float32))
        client.close()
        assert _wait_for(lambda: server.applied_pushes >= 50)
        assert server.applied_pushes == 50
    finally:
        server.stop()


def test_same_key_pushes_serialize():
    """Two clients on one key: every push applied exactly once."""
    server, c1 = make_pair(num_workers=1)
    c2 = AsyncKVClient('127.0.0.1:%d' % server.port)
    try:
        c1.init('k', np.zeros((8,), np.float32))
        c1.set_optimizer_bytes(pickle.dumps(tmx.optimizer.Test()))
        for _ in range(20):
            c1.push('k', np.ones((8,), np.float32))
            c2.push('k', np.ones((8,), np.float32))
        assert _wait_for(lambda: server.applied_pushes >= 40)
        assert server.applied_pushes == 40
        np.testing.assert_allclose(c1.pull('k'), 40.0)
    finally:
        c1.close()
        c2.close()
        server.stop()


def test_dead_node_detection():
    server, c1 = make_pair(num_workers=2)
    c2 = AsyncKVClient('127.0.0.1:%d' % server.port)
    try:
        c1.start_heartbeat(0, interval=0.05)
        c2.start_heartbeat(1, interval=0.05)
        time.sleep(0.2)
        assert c1.num_dead_nodes(timeout_s=0.5) == 0
        c2.stop_heartbeat()
        time.sleep(0.7)
        resp = c1._rpc(('dead', 0.5))
        assert 1 in resp[2], resp
    finally:
        c1.stop_heartbeat()
        c1.close()
        c2.close()
        server.stop()


def test_server_applies_the_port_updater_on_host_arrays():
    """The server's update is the port's SGD on CPU tensors made from the
    stored arrays: momentum state carries over pushes."""
    server, client = make_pair()
    try:
        client.init('w', np.ones((3,), np.float32))
        client.set_optimizer_bytes(pickle.dumps(tmx.optimizer.SGD(
            learning_rate=0.1, momentum=0.9, rescale_grad=1.0)))
        client.push('w', np.ones((3,), np.float32))
        client.push('w', np.ones((3,), np.float32))
        client.barrier(timeout=30)
        # v1 = -0.1, w = 0.9; v2 = 0.9 v1 - 0.1 = -0.19, w = 0.71
        np.testing.assert_allclose(client.pull('w'), 0.71, rtol=1e-6)
        assert client.pull('w').dtype == np.float32
    finally:
        client.close()
        server.stop()


# ---------------------------------------------------------------------------
# chaos: a server process killed and restarted from its backing file
# ---------------------------------------------------------------------------

_SERVER = textwrap.dedent('''
    import sys, time
    sys.path.insert(0, %r)
    from mxnet_tpu_torch.kvstore_server import AsyncKVServer
    srv = AsyncKVServer(port=int(sys.argv[1]), num_workers=1,
                        backing=sys.argv[2], sync_every=1)
    print('READY %%d' %% srv.port, flush=True)
    while True:
        time.sleep(0.1)
''' % ROOT)


def _spawn_server(port, backing, extra_env=None):
    env = dict(os.environ)
    env.update(extra_env or {})
    proc = subprocess.Popen([sys.executable, '-c', _SERVER, str(port),
                             backing], stdout=subprocess.PIPE, text=True,
                            bufsize=1, env=env, cwd=ROOT)
    out = []
    t = threading.Thread(target=lambda: out.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout=60)
    if not out or not out[0].startswith('READY'):
        proc.kill()
        raise AssertionError('kv server child did not start: %r' % out)
    return proc, int(out[0].split()[1])


def _kill9(proc):
    if proc is not None and proc.poll() is None:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)


@pytest.fixture
def metrics():
    instrument.set_metrics(True)
    yield
    instrument.set_metrics(True)


def _fast_retries(monkeypatch, rpc_timeout):
    monkeypatch.setenv('MXTPU_KV_RETRY_BASE', '0.05')
    monkeypatch.setenv('MXTPU_KV_RETRY_MAX', '0.5')
    monkeypatch.setenv('MXTPU_KV_RPC_TIMEOUT', str(rpc_timeout))
    monkeypatch.setenv('MXTPU_KV_RECONNECT_DEADLINE', '50')


def test_server_restart_mid_push_no_lost_updates(tmp_path, monkeypatch,
                                                 metrics):
    """kill -9 the server mid-push-stream, restart it from its backing
    file on the same port: sequence replay and per-client watermarks
    deliver every push exactly once."""
    _fast_retries(monkeypatch, 2.0)
    backing = str(tmp_path / 'kv_state.pkl')
    proc, port = _spawn_server(0, backing)
    client = AsyncKVClient('127.0.0.1:%d' % port, timeout=30)
    proc2 = None
    c0 = {k: instrument.counter_value(k) for k in
          ('kvstore.reconnects', 'kvstore.retries', 'kvstore.push_replays')}
    try:
        client.init('w', np.zeros(8, np.float32))
        client.set_optimizer_bytes(
            pickle.dumps(tmx.optimizer.Test(rescale_grad=1.0)))
        total = 40
        for i in range(total):
            client.push('w', np.ones(8, np.float32))
            if i == 12:
                _kill9(proc)             # mid-stream, un-acked in flight
            time.sleep(0.005)
        proc2, _ = _spawn_server(port, backing)
        client.barrier(timeout=50)       # rides behind the replay
        np.testing.assert_allclose(client.pull('w'), float(total))
        assert client.pending_pushes == 0
        for k in c0:
            assert instrument.counter_value(k) - c0[k] >= 1, k
    finally:
        client.close()
        _kill9(proc)
        _kill9(proc2)


def test_server_kill_mid_barrier_then_restart(tmp_path, monkeypatch):
    """MXTPU_FAULTS kills the server the moment a barrier arrives; the
    worker's deadline-bounded barrier re-sends after the restart and
    completes."""
    _fast_retries(monkeypatch, 1.0)
    backing = str(tmp_path / 'kv_state.pkl')
    proc, port = _spawn_server(
        0, backing, extra_env={'MXTPU_FAULTS': 'server.barrier:after:1:kill'})
    client = AsyncKVClient('127.0.0.1:%d' % port, timeout=30)
    proc2 = None
    done = []

    def do_barrier():
        client.barrier(timeout=50)
        done.append(1)

    t = threading.Thread(target=do_barrier, daemon=True)
    try:
        client.init('w', np.zeros(4, np.float32))
        t.start()
        proc.wait(timeout=50)            # the fault plan SIGKILLed it
        assert proc.returncode != 0
        proc2, _ = _spawn_server(port, backing)
        t.join(timeout=55)
        assert done, 'barrier never completed after the server restart'
        np.testing.assert_allclose(client.pull('w'), 0.0)
    finally:
        client.close()
        _kill9(proc)
        _kill9(proc2)


def test_severed_send_reconnects_and_replays(monkeypatch, metrics):
    """``MXTPU_FAULTS`` severs one ``client.send`` of a push: the client
    reconnects, replays the un-acked push, and the server's applied count
    equals the pushes sent (the chip_smoke fault run, in miniature)."""
    from mxnet_tpu_torch import resilience
    _fast_retries(monkeypatch, 2.0)
    server, client = make_pair()
    r0 = instrument.counter_value('kvstore.reconnects')
    try:
        client.init('w', np.zeros(4, np.float32))
        client.set_optimizer_bytes(
            pickle.dumps(tmx.optimizer.Test(rescale_grad=1.0)))
        resilience.set_faults('client.send.push:after:3:sever')
        for _ in range(10):
            client.push('w', np.ones(4, np.float32))
        client.barrier(timeout=50)
        np.testing.assert_allclose(client.pull('w'), 10.0)
        assert server.applied_pushes == 10
        assert instrument.counter_value('kvstore.reconnects') - r0 >= 1
    finally:
        resilience.clear_faults()
        client.close()
        server.stop()


# ---------------------------------------------------------------------------
# the wire: the two packages' clients and servers against each other
# ---------------------------------------------------------------------------

def _add(key, grad, weight):
    weight += grad


def _exchange(client):
    client.init('a', np.arange(6, dtype=np.float32).reshape(2, 3))
    client.init(7, np.zeros(4, np.float32))
    for i in range(3):
        client.push('a', np.full((2, 3), i + 1, np.float32))
        client.push(7, np.arange(4, dtype=np.float32) * (i + 1))
    client.barrier(timeout=30)
    return client.pull('a'), client.pull(7)


@pytest.mark.parametrize('server_pkg', ['jax', 'port'])
def test_wire_interop_between_the_packages(server_pkg):
    from mxnet_tpu import kvstore_server as jsrv
    from mxnet_tpu_torch import kvstore_server as tsrv
    srv_mod, cli_mod = (jsrv, tsrv) if server_pkg == 'jax' else (tsrv, jsrv)
    want = None
    for s_mod, c_mod in ((srv_mod, srv_mod), (srv_mod, cli_mod)):
        server = s_mod.AsyncKVServer(port=0, num_workers=1)
        server._updater = _add
        client = c_mod.AsyncKVClient('127.0.0.1:%d' % server.port)
        try:
            client.start_heartbeat(0, interval=0.05)
            got = _exchange(client)
            assert client.num_dead_nodes(timeout_s=5.0) == 0
            assert server.applied_pushes == 6
        finally:
            client.stop_heartbeat()
            client.close()
            server.stop()
        if want is None:
            want = got
            continue
        for w, g in zip(want, got):
            assert w.dtype == g.dtype and np.array_equal(w, g)
    np.testing.assert_array_equal(
        want[0], np.arange(6, dtype=np.float32).reshape(2, 3) + 6)
    np.testing.assert_array_equal(want[1], np.arange(4) * 6.0)
