"""The serving fleet on the card (marked ``cuda``; they skip without a
CUDA device).  On the GPU host:

    python -m pytest tests/test_torch_fleet_cuda.py -q -m cuda --noconftest

Two replicas of a narrow ResNet v2 flush on two distinct CUDA streams of
their own (never the default stream), with no device-wide synchronise on
the flush path; a replica added by ``scale_up`` captures its buckets
while the other replica replays, and every response during and after the
capture equals the single replica's response to the same rows at the
same bucket, bit for bit (TF32 off, cuDNN deterministic).  Two graphs
one thread recorded on the capture stream replay at once on two streams
and stay exact (each holds its own cuBLAS workspace).  A ``tick()``-driven
autoscaler ``scale_up`` captures a third replica under traffic with every
response exact; after ``shrink_batch`` -> ``reload_model`` ->
``restore_batch`` a full flush at the configured cap replays a graph
captured before it (the reload warmed to the cap, not the shrunk batch).
"""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import compile_cache, convert
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.serving import ModelServer

pytestmark = pytest.mark.cuda

WAIT = 120
SHAPE = (4, 3, 64, 64)


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the replicas replay CUDA graphs)')
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


def _graphs(server, name):
    return sum(1 for rep in server._entry(name).replicas
               for e in rep.predictor._bucket_execs.values()
               if e._forward_graph is not None
               and e._forward_graph.captured)


def _record_streams(pred, log):
    fwd = pred.forward

    def forward(**kw):
        log.append((id(pred), torch.cuda.current_stream().cuda_stream))
        return fwd(**kw)
    pred.forward = forward


def test_two_replicas_flush_on_their_own_streams(dev, monkeypatch):
    sym_json, params, data = _model()
    server = ModelServer(max_delay_ms=0, max_batch=2)
    try:
        server.load_model('m', symbol_json=sym_json, params=params,
                          input_shapes={'data': SHAPE}, replicas=2)
        reps = server._entry('m').replicas
        streams = [r.stream.cuda_stream for r in reps]
        default = torch.cuda.default_stream(dev).cuda_stream
        assert len(set(streams)) == 2 and default not in streams
        assert _graphs(server, 'm') == 2 * 2      # buckets 1 and 2
        log = []
        for r in reps:
            _record_streams(r.predictor, log)

        def no_sync(*a, **kw):
            raise AssertionError('torch.cuda.synchronize on the flush '
                                 'path')
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, 'synchronize', no_sync)
            server.pause('m')
            futs = [server.submit('m', data=data[2 * i:2 * i + 2])
                    for i in range(16)]
            server.resume('m')
            outs = [f.result(timeout=WAIT)[0] for f in futs]
        by_pred = {}
        for pid, s in log:
            by_pred.setdefault(pid, set()).add(s)
        own = {id(r.predictor): {r.stream.cuda_stream} for r in reps}
        # each replica flushed, and only on its own stream
        assert by_pred == own
        ref = tmx.Predictor(sym_json, params, {'data': SHAPE},
                            pad_to_bucket=True)
        ref.warm_buckets(2)
        for i, got in enumerate(outs):
            ref.forward(data=data[2 * i:2 * i + 2])
            np.testing.assert_array_equal(got, ref.get_output(0))
    finally:
        server.close(timeout=WAIT)


def test_capture_during_replays_serves_correct_responses(dev):
    sym_json, params, data = _model()
    server = ModelServer(max_delay_ms=0, max_batch=2)
    try:
        server.load_model('m', symbol_json=sym_json, params=params,
                          input_shapes={'data': SHAPE})
        # every request is 2 rows and every flush one request: bucket 2
        want = [server.predict('m', data=data[2 * i:2 * i + 2],
                               timeout=WAIT)[0] for i in range(32)]
        stop = threading.Event()
        got, errors = [], []

        def client(k):
            i = k
            while not stop.is_set():
                j = i % 32
                try:
                    got.append((j, server.predict(
                        'm', data=data[2 * j:2 * j + 2], timeout=WAIT)[0]))
                except Exception as e:     # noqa: BLE001 - reported
                    errors.append(repr(e))
                    return
                i += 4
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        n0 = len(got)
        # the new replica captures its buckets while replica 0 replays,
        # on the capture stream, which no replica is handed
        assert server.scale_up('m') == 2
        cap = compile_cache.capture_stream(dev).cuda_stream
        assert cap not in {r.stream.cuda_stream
                           for r in server._entry('m').replicas}
        during = len(got) - n0
        assert _graphs(server, 'm') == 2 * 2
        n1, t_end = len(got), time.monotonic() + WAIT
        while len(got) < n1 + 64 and not errors and \
                time.monotonic() < t_end:
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=WAIT)
        assert not errors and not any(t.is_alive() for t in threads)
        assert during > 0, 'no request was served during the capture'
        for j, out in got:
            np.testing.assert_array_equal(out, want[j])
    finally:
        server.close(timeout=WAIT)


@pytest.mark.parametrize('mkn', [(8, 2048, 1000), (4, 16384, 512)])
def test_graphs_one_thread_captured_replay_at_once_exactly(dev, mkn):
    # two replicas' graphs recorded by one thread on the capture stream,
    # replayed at once on two streams: each keeps its own cuBLAS workspace
    # (a shared one corrupts small-M, long-K GEMMs like ResNet's fc)
    m, k, n = mkn
    g = torch.Generator(device=dev).manual_seed(0)
    a = [torch.randn(m, k, device=dev, generator=g) for _ in range(2)]
    b = [torch.randn(k, n, device=dev, generator=g) for _ in range(2)]
    steps = []
    for i in range(2):
        st = compile_cache.CapturedStep(
            'gemm%d' % i, lambda i=i: [a[i] @ b[i]], dev,
            pool=torch.cuda.graph_pool_handle(), copy_outputs=True)
        st.warm_up()
        st.capture()
        steps.append(st)
    refs = [st.replay()[0].clone() for st in steps]
    bad = [torch.zeros((), dtype=torch.int64, device=dev) for _ in steps]

    def replay(i):
        s = torch.cuda.Stream(dev)
        with torch.cuda.stream(s):
            for _ in range(2000):
                bad[i] += (steps[i].replay()[0] != refs[i]).any()
        s.synchronize()
    threads = [threading.Thread(target=replay, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)
    assert [int(x) for x in bad] == [0, 0]


def _bucket_replays(server, name, bucket):
    return sum(rep.predictor._bucket_execs[bucket]._forward_graph.replays
               for rep in server._entry(name).replicas)


def test_autoscaled_scale_up_and_restore_replay_captured_graphs(dev):
    sym_json, params, data = _model()
    cap = 8
    server = ModelServer(max_delay_ms=0, max_batch=cap)
    try:
        server.load_model('m', symbol_json=sym_json, params=params,
                          input_shapes={'data': SHAPE}, replicas=2)
        buckets = cap.bit_length()
        assert _graphs(server, 'm') == 2 * buckets
        # 2-row requests, each flushed alone (bucket 2) before traffic
        want = [server.predict('m', data=data[2 * i:2 * i + 2],
                               timeout=WAIT)[0] for i in range(32)]
        sc = server.autoscale('m', slo_p99_ms=1e-6, interval_s=0,
                              up_after=1, down_after=1, min_samples=1,
                              cooldown_s=0, max_replicas=3, start=False)
        sc.async_actuation = False
        stop = threading.Event()
        got, errors = [], []

        def client(k):
            i = k
            while not stop.is_set():
                j = i % 32
                try:
                    got.append((j, server.predict(
                        'm', data=data[2 * j:2 * j + 2], timeout=WAIT)[0]))
                except Exception as e:     # noqa: BLE001 - reported
                    errors.append(repr(e))
                    return
                i += 4
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        t_end = time.monotonic() + WAIT
        while len(got) < 8 and time.monotonic() < t_end:
            time.sleep(0.01)
        n0 = len(got)
        evs = sc.tick()
        during = len(got) - n0
        assert [e['action'] for e in evs] == ['scale_up'], evs
        assert server.replica_count('m') == 3
        assert _graphs(server, 'm') == 3 * buckets
        n1, t_end = len(got), time.monotonic() + WAIT
        while len(got) < n1 + 8 and not errors and \
                time.monotonic() < t_end:
            time.sleep(0.01)
        # at max_replicas a breach shrinks the batch
        assert [e['action'] for e in sc.tick()] == ['shrink_batch']
        batcher = server._entry('m').batcher
        assert batcher.max_batch == cap // 2
        stop.set()
        for t in threads:
            t.join(timeout=WAIT)
        assert not errors and not any(t.is_alive() for t in threads)
        assert during > 0, 'no request was served during the capture'
        for j, out in got:
            np.testing.assert_array_equal(out, want[j])
        # a reload while shrunk captures every bucket up to the cap
        server.reload_model('m', symbol_json=sym_json, params=params)
        assert _graphs(server, 'm') == 3 * buckets
        sc._watches['m'].slo_p99_ms = 1e6
        for i in range(4):
            server.predict('m', data=data[2 * i:2 * i + 2], timeout=WAIT)
        assert [e['action'] for e in sc.tick()] == ['restore_batch']
        assert batcher.max_batch == cap
        before = _bucket_replays(server, 'm', cap)
        out = server.predict('m', data=data[:cap], timeout=WAIT)[0]
        assert _bucket_replays(server, 'm', cap) == before + 1
        assert _graphs(server, 'm') == 3 * buckets
        ref = tmx.Predictor(sym_json, params, {'data': SHAPE},
                            pad_to_bucket=True)
        ref.warm_buckets(cap)
        ref.forward(data=data[:cap])
        np.testing.assert_array_equal(out, ref.get_output(0))
    finally:
        server.close(timeout=WAIT)
