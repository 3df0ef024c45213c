"""The port's host-side dependency engine (``engine.NativeEngine`` over
``csrc/host/engine.cc``, built with g++ at first use) and the
``PrefetchingIter`` that runs on it, on the CPU.

The cases of ``tests/test_engine.py`` (order, write serialisation,
concurrent reads, read/write ordering, a randomized stress, naive mode,
the profiler's Chrome trace, the priority lane, overlapping sets
refused, overlapping pushes from two threads) run against the port's
engine; a seeded random program of pushes gives the same per-variable
write order through both packages' engines; ``PrefetchingIter`` gives
the JAX package's batches and survives an iterator's error; and ten
child processes that abandon a ``PrefetchingIter`` mid-epoch each exit
0 within 60 s (the JAX package's exit can deadlock there).  Every wait
is bounded."""
import json
import os
import random
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import engine as j_engine
from mxnet_tpu import health as j_health
from mxnet_tpu import iowatch as j_iowatch
from mxnet_tpu import perfwatch as j_perfwatch
from mxnet_tpu_torch import engine as t_engine
from mxnet_tpu_torch import health as t_health
from mxnet_tpu_torch import iowatch as t_iowatch
from mxnet_tpu_torch import perfwatch as t_perfwatch
from mxnet_tpu_torch.engine import NativeEngine

WAIT = 30.0     # seconds: the bound of every wait on an engine here


def reset_planes():
    """Both packages' process-global plane state back to off."""
    for h in (j_health, t_health):
        h.deactivate()
        h._recorder = None
    for io in (j_iowatch, t_iowatch):
        io._ledger = None
        io._last_snapshot = None
        io.set_enabled(False)
    for pw in (j_perfwatch, t_perfwatch):
        pw.set_enabled(False)
        pw.clear_executables()
        pw.ledger_reset()
        pw._step_window.clear()
    t_perfwatch._pending.clear()


@pytest.fixture(autouse=True)
def _clean():
    reset_planes()
    yield
    reset_planes()
    t_engine.set_engine_type('ThreadedEnginePerDevice')


def _drain(eng):
    assert eng.wait_for_all(WAIT)


def test_engine_basic_order():
    eng = NativeEngine(num_workers=4)
    v = eng.new_var()
    out = []
    for i in range(50):
        eng.push(lambda i=i: out.append(i), mutable_vars=[v])
    assert eng.wait_for_var(v, WAIT)
    assert out == list(range(50))
    assert v.version == 50


def test_engine_write_serialization():
    eng = NativeEngine(num_workers=8)
    v = eng.new_var()
    state = {'x': 0}

    def bump():
        cur = state['x']
        time.sleep(0.0002)
        state['x'] = cur + 1

    for _ in range(200):
        eng.push(bump, mutable_vars=[v])
    _drain(eng)
    assert state['x'] == 200


def test_engine_concurrent_reads():
    eng = NativeEngine(num_workers=8)
    v = eng.new_var()
    inflight, peak = [0], [0]
    lock = threading.Lock()

    def read():
        with lock:
            inflight[0] += 1
            peak[0] = max(peak[0], inflight[0])
        time.sleep(0.002)
        with lock:
            inflight[0] -= 1

    for _ in range(16):
        eng.push(read, const_vars=[v])
    _drain(eng)
    assert peak[0] > 1


def test_engine_read_write_ordering():
    eng = NativeEngine(num_workers=8)
    v = eng.new_var()
    log = []
    lock = threading.Lock()

    def slow_read(tag):
        time.sleep(0.003)
        with lock:
            log.append(('r', tag))

    def write(tag):
        with lock:
            log.append(('w', tag))

    for i in range(4):
        eng.push(lambda i=i: slow_read(i), const_vars=[v])
    eng.push(lambda: write(0), mutable_vars=[v])
    for i in range(4, 8):
        eng.push(lambda i=i: slow_read(i), const_vars=[v])
    _drain(eng)
    widx = log.index(('w', 0))
    assert {t for k, t in log[:widx] if k == 'r'} == {0, 1, 2, 3}
    assert {t for k, t in log[widx + 1:] if k == 'r'} == {4, 5, 6, 7}


def test_engine_randomized_stress():
    rng = random.Random(7)
    eng = NativeEngine(num_workers=8)
    nvars = 10
    vars_ = [eng.new_var() for _ in range(nvars)]
    counters = [0] * nvars
    expected = [0] * nvars
    for _ in range(300):
        idxs = rng.sample(range(nvars), rng.randint(0, 3) + 1)
        wi, ridxs = idxs[0], idxs[1:]

        def op(wi=wi):
            counters[wi] += 1

        eng.push(op, const_vars=[vars_[r] for r in ridxs],
                 mutable_vars=[vars_[wi]])
        expected[wi] += 1
    _drain(eng)
    assert counters == expected
    assert [v.version for v in vars_] == expected


def test_engine_naive_mode():
    eng = NativeEngine(num_workers=2, naive=True)
    v = eng.new_var()
    out = []
    eng.push(lambda: out.append(1), mutable_vars=[v])
    assert out == [1]           # ran on the pushing thread, at the push
    assert v.version == 1
    _drain(eng)


def test_set_engine_type_rebuilds_the_native_engine():
    """NaiveEngine rebuilds the process's engine in naive mode (its pushes
    run at once) and switching back rebuilds the threaded one."""
    t_engine.set_engine_type('ThreadedEnginePerDevice')
    first = t_engine.native_engine()
    assert not first.naive
    t_engine.set_engine_type('NaiveEngine')
    naive = t_engine.native_engine()
    assert naive is not first and naive.naive and not first.alive
    assert not t_engine.capture_enabled()
    out = []
    naive.push(lambda: out.append(1), mutable_vars=[naive.new_var()])
    assert out == [1]
    t_engine.set_engine_type('ThreadedEnginePerDevice')
    assert not t_engine.native_engine().naive and not naive.alive


def test_engine_profiler_chrome_trace(tmp_path):
    eng = NativeEngine(num_workers=2)
    eng.set_profiling(True)
    v = eng.new_var()
    for i in range(5):
        eng.push(lambda: time.sleep(0.001), mutable_vars=[v],
                 name='stage_%d' % i)
    _drain(eng)
    path = tmp_path / 'trace.json'
    eng.dump_profile(str(path))
    events = json.loads(path.read_text())['traceEvents']
    assert len(events) >= 5
    names = {e['name'] for e in events}
    assert 'stage_0' in names and 'stage_4' in names
    assert all(e['ph'] == 'X' and e['dur'] >= 0 for e in events)


def test_engine_priority_lane():
    eng = NativeEngine(num_workers=1)
    gate = threading.Event()
    order = []
    v1, v2, v3 = eng.new_var(), eng.new_var(), eng.new_var()
    eng.push(lambda: gate.wait(5.0), mutable_vars=[v1])  # hold the worker
    eng.push(lambda: order.append('normal'), mutable_vars=[v2])
    eng.push(lambda: order.append('prio'), mutable_vars=[v3], priority=1)
    gate.set()
    _drain(eng)
    assert order == ['prio', 'normal']


def test_engine_rejects_overlapping_var_sets():
    eng = NativeEngine(num_workers=2)
    v = eng.new_var()
    with pytest.raises(ValueError):
        eng.push(lambda: None, const_vars=[v], mutable_vars=[v])
    with pytest.raises(ValueError):
        eng.push(lambda: None, mutable_vars=[v, v])
    out = []
    eng.push(lambda: out.append(1), mutable_vars=[v])
    _drain(eng)
    assert out == [1]


def test_engine_concurrent_overlapping_pushes_no_deadlock():
    eng = NativeEngine(num_workers=4)
    a, b = eng.new_var(), eng.new_var()
    count = [0]
    lock = threading.Lock()

    def bump():
        with lock:
            count[0] += 1

    def pusher(order):
        for _ in range(100):
            eng.push(bump, mutable_vars=list(order))

    threads = [threading.Thread(target=pusher, args=(o,))
               for o in ([a, b], [b, a])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    _drain(eng)             # a half-granted cycle would time out here
    assert count[0] == 200


def test_bounded_waits_and_stopped_callbacks():
    """A bounded wait returns False while an op runs and True after it;
    once callbacks are stopped no pushed function runs, yet every op
    completes (wait_for_all returns)."""
    eng = NativeEngine(num_workers=2)
    v = eng.new_var()
    gate = threading.Event()
    eng.push(lambda: gate.wait(5.0), mutable_vars=[v])
    assert not eng.wait_for_var(v, 0.05)
    gate.set()
    assert eng.wait_for_var(v, WAIT)
    eng.stop_callbacks()
    ran = []
    eng.push(lambda: ran.append(1), mutable_vars=[v])
    _drain(eng)
    assert ran == [] and v.version == 2
    eng.dispose()
    assert not eng.alive


def _random_program(seed, nvars=8, nops=200):
    rng = random.Random(seed)
    ops = []
    for k in range(nops):
        idxs = rng.sample(range(nvars), rng.randint(1, 4))
        nw = rng.randint(1, len(idxs))
        ops.append((k, idxs[:nw], idxs[nw:], rng.random() < 0.2))
    return ops


@pytest.mark.parametrize('seed', [0, 1])
def test_random_program_write_order_matches_jax(seed):
    """The same seeded program of pushes (random write and read sets,
    some ops sleeping) gives, per variable, the same order of writers in
    both packages' engines: push order."""
    ops = _random_program(seed)
    logs = {}
    for name, cls in (('jax', j_engine.NativeEngine),
                      ('torch', NativeEngine)):
        eng = cls(num_workers=6)
        vars_ = [eng.new_var() for _ in range(8)]
        log = {i: [] for i in range(8)}
        lock = threading.Lock()
        for k, writes, reads, slow in ops:
            def op(k=k, writes=writes, slow=slow):
                if slow:
                    time.sleep(0.0005)
                with lock:
                    for w in writes:
                        log[w].append(k)
            eng.push(op, const_vars=[vars_[r] for r in reads],
                     mutable_vars=[vars_[w] for w in writes])
        if name == 'torch':
            _drain(eng)
        else:
            eng.wait_for_all()
        eng.dispose()
        logs[name] = log
    assert logs['torch'] == logs['jax']
    for w, order in logs['torch'].items():
        assert order == [k for k, writes, _, _ in ops if w in writes]


def _batches(it):
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [lab.asnumpy() for lab in b.label], b.pad))
    return out


def test_prefetching_iter_gives_the_reference_batches():
    """Two iterators merged (one renamed), two epochs, against the JAX
    package's PrefetchingIter."""
    rng = np.random.RandomState(0)
    x = rng.randn(20, 3).astype(np.float32)
    z = rng.randn(20, 2).astype(np.float32)
    y = rng.randint(0, 4, 20).astype(np.float32)
    got = {}
    for pkg in (mx, tmx):
        it = pkg.io.PrefetchingIter(
            [pkg.io.NDArrayIter(x, y, batch_size=6),
             pkg.io.NDArrayIter({'z': z}, batch_size=6)],
            rename_data=[{'data': 'a'}, {'z': 'b'}])
        assert [n for n, _ in it.provide_data] == ['a', 'b']
        got[pkg] = _batches(it)
        it.reset()
        got[pkg] += _batches(it)
    assert len(got[tmx]) == len(got[mx]) == 8
    for a, b in zip(got[tmx], got[mx]):
        assert a[2] == b[2]
        for u, w in zip(a[0] + a[1], b[0] + b[1]):
            np.testing.assert_array_equal(u, w)


def test_prefetch_iter_survives_iterator_error():
    class Flaky(tmx.io.DataIter):
        def __init__(self):
            super().__init__()
            self.n = 0

        @property
        def provide_data(self):
            return [('data', (2, 2))]

        @property
        def provide_label(self):
            return [('softmax_label', (2,))]

        def reset(self):
            self.n = 0

        def next(self):
            self.n += 1
            if self.n == 2:
                raise IOError('corrupt record')
            if self.n > 4:
                raise StopIteration
            return tmx.io.DataBatch([tmx.nd.array(np.ones((2, 2)))],
                                    [tmx.nd.array(np.zeros(2))], pad=0)

    it = tmx.io.PrefetchingIter(Flaky())
    assert it.iter_next()
    with pytest.raises(IOError):
        it.iter_next()
    assert it.iter_next()
    assert it.iter_next()
    assert not it.iter_next()
    assert it.close(WAIT)


_ABANDON = textwrap.dedent('''
    import sys, time
    import numpy as np
    import mxnet_tpu_torch as tmx

    class Slow(tmx.io.NDArrayIter):
        def next(self):
            time.sleep(0.05)
            return super().next()

    x = np.zeros((64, 3), np.float32)
    its = [tmx.io.PrefetchingIter([Slow(x, batch_size=4),
                                   tmx.io.NDArrayIter({'b': x},
                                                      batch_size=4)])
           for _ in range(3)]
    for it in its:
        it.next()
    if int(sys.argv[1]) % 2:
        del its[0]              # one collected, its fetch in flight
    print('abandoned', flush=True)
''')


def test_abandoned_prefetching_iters_let_ten_processes_exit(tmp_path):
    """Ten children each abandon PrefetchingIters mid-epoch, a fetch in
    flight, and exit: every one exits 0 within 60 s."""
    script = tmp_path / 'abandon.py'
    script.write_text(_ABANDON)
    env = dict(os.environ, PYTHONPATH=os.getcwd(),
               MXNET_CPU_WORKER_NTHREADS='2')
    for wave in (range(0, 5), range(5, 10)):
        procs = [subprocess.Popen([sys.executable, str(script), str(i)],
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for i in wave]
        for p in procs:
            try:
                out, err = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
                pytest.fail('a child did not exit within 60 s')
            assert p.returncode == 0, err
            assert 'abandoned' in out
