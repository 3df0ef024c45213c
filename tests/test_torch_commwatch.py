"""The communication-attribution plane of the PyTorch port
(``commwatch.py``) and the cross-rank hooks (``health.note_skew``, the kv
server's straggler record and client barrier) against the JAX package's,
on the CPU.

The JAX package parses its collectives out of the compiled HLO; the port
counts them where it issues them (``parallel/collectives.py``), so the
analytic model is compared, not the parser: ``wire_bytes`` (the ring
formula) and ``comm_fraction`` equal JAX's; a sharded MLP fit on 2 and 4
gloo ranks (one ``torch.multiprocessing.spawn`` per world size,
module-scoped, ``tests/torch_mesh_ranks.py``'s 'comm' suite, jax-free)
moves exactly the analytic bytes a step: one reduce-scatter and one
all-gather over dp (2·(dp−1)/dp of the padded parameter bytes) plus the
tp all-gather of the sharded parameters; ``'1x1'`` moves 0;
``comm_fraction`` stays in [0, 1]; perfwatch's row under a mesh counts
dp·tp devices and global FLOPs = per-device × devices
(``tests/test_multichip_fit.py:244``).  ``barrier_wait``,
``note_skew``'s threshold and throttle, and the kv server and client
calling them, scenario against scenario in both packages."""
import pytest

from mxnet_tpu import commwatch as jcw
from mxnet_tpu import health as jhealth
from mxnet_tpu import instrument as jinstrument
from mxnet_tpu import kvstore_server as jkvs
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import commwatch as tcw
from mxnet_tpu_torch import health as thealth
from mxnet_tpu_torch import instrument as tinstrument
from mxnet_tpu_torch import kvstore_server as tkvs
from mxnet_tpu_torch.parallel import mesh as tmesh

import torch_mesh_ranks as R
from test_torch_health import reset_planes

WORLDS = (2, 4)
KNOBS = ('MXTPU_COMMWATCH', 'MXTPU_PERFWATCH', 'MXTPU_PEAK_BW',
         'MXTPU_SKEW_WARN_PCT')


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    state = [(ins, ins.metrics_enabled()) for ins in (jinstrument,
                                                      tinstrument)]
    reset_planes()
    for cw in (jcw, tcw):
        cw.set_enabled(False)
        cw.clear_programs()
    for h in (jhealth, thealth):
        h._skew_warned.clear()
    for ins, _ in state:
        ins.reset_metrics()
        ins.set_metrics(True)
    yield
    reset_planes()
    for cw in (jcw, tcw):
        cw.set_enabled(False)
        cw.clear_programs()
    for h in (jhealth, thealth):
        h._skew_warned.clear()
    for ins, met in state:
        ins.set_metrics(met)
        ins.reset_metrics()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """``{n: [(arrays, numbers)] per rank}`` of the 'comm' suite."""
    return {n: R.spawn('comm', n, str(tmp_path_factory.mktemp('comm%d' % n)),
                       env={'MXTPU_COMMWATCH': '1', 'MXTPU_PERFWATCH': '1',
                            'MXTPU_FUSE': 'off'})
            for n in WORLDS}


# ---------------------------------------------------------------------------
# the model: wire bytes, the roofline split, the peak table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['all-reduce', 'all-gather',
                                  'reduce-scatter', 'all-to-all',
                                  'collective-permute', 'send'])
@pytest.mark.parametrize('group', [1, 2, 4, 8])
def test_wire_bytes_match_jax(kind, group):
    for nbytes in (0, 1616, 3232.0, 102_400_000):
        assert tcw.wire_bytes(kind, nbytes, group) == \
            jcw.wire_bytes(kind, nbytes, group)


@pytest.mark.parametrize('wire,flops', [(0, 1e9), (1e6, 0), (0, 0),
                                        (3232, 90112), (1e9, 1e12)])
def test_comm_fraction_matches_jax(wire, flops):
    got = tcw.comm_fraction(wire, flops, peak_flops=2e11, peak_bw=10e9)
    assert got == jcw.comm_fraction(wire, flops, peak_flops=2e11,
                                    peak_bw=10e9)
    assert 0.0 <= got <= 1.0


def test_interconnect_peak(monkeypatch, caplog):
    """The table holds the host's nominal figure and no TPU; the knob
    pins the peak; a kind not in the table falls back to the host figure
    with one warning."""
    assert set(tcw.ICI_PEAKS) == {'cpu'}
    assert tcw.interconnect_bw('cpu') == jcw.ICI_PEAKS['cpu']
    monkeypatch.setenv('MXTPU_PEAK_BW', '123e9')
    assert tcw.interconnect_bw('cpu') == 123e9
    monkeypatch.delenv('MXTPU_PEAK_BW')
    monkeypatch.setattr(tcw, '_warned_fallback_bw', False)
    with caplog.at_level('WARNING'):
        assert tcw.interconnect_bw('Some Card') == tcw.ICI_PEAKS['cpu']
        assert tcw.interconnect_bw('Some Card') == tcw.ICI_PEAKS['cpu']
    assert sum('not in the interconnect peak table' in r.message
               for r in caplog.records) == 1


def test_collectives_are_counted_per_step():
    """Each collective noted while the plane is on lands in the per-kind
    totals and in the step in flight; on_step turns the step into its
    signature's row and comm.bytes_per_step; off, nothing is kept."""
    tcw.note_collective('all-reduce', 400, 2)
    assert tcw.step_records() == []
    tcw.set_enabled(True)
    tcw.step_begin()
    tcw.note_collective('reduce-scatter', 1616, 2, 0.001)
    tcw.note_collective('all-gather', 3232, 2, 0.002)
    tcw.on_step('fit_step', 'k', 0.5, 1e6)
    g = tinstrument.metrics_snapshot()['gauges']
    assert g['comm.bytes_per_step'] == 1616 + 1616
    assert g['comm.seconds_per_step'] == pytest.approx(0.003)
    assert g['comm.reduce_scatter.count'] == 1
    assert g['comm.all_gather.wire_bytes'] == 1616
    row = tcw.program_info('fit_step', 'k')
    assert row['collectives']['all-gather']['bytes'] == 3232
    assert 0.0 < g['perf.comm_fraction'] < 1.0
    tcw.step_begin()
    tcw.on_step('fit_step', 'k', 0.5, 1e6)
    assert tinstrument.metrics_snapshot()['gauges'][
        'comm.bytes_per_step'] == 0.0


def test_barrier_wait_histogram():
    """tests/test_commwatch.py's case, in both packages."""
    for cw, ins in ((jcw, jinstrument), (tcw, tinstrument)):
        cw.barrier_wait(0.5)               # off: nothing
        cw.set_enabled(True)
        cw.barrier_wait(0.01)
        cw.barrier_wait(0.02)
        snap = ins.metrics_snapshot()
        assert snap['histograms']['comm.barrier_wait']['count'] == 2
        assert snap['counters']['comm.barriers'] == 2


def test_note_skew_threshold_and_throttle(monkeypatch):
    """The same scenario in both packages: knob off, under the threshold,
    a warning, the per-rank throttle, re-armed after the window, another
    rank."""
    laggard = {'rank': 3, 'mean_step_secs': 0.2,
               'median_step_secs': 0.1, 'pct_over_median': 100.0}
    other = dict(laggard, rank=1)
    script = [('off', 1.0, laggard, None), ('50', 0.3, laggard, None),
              ('50', 1.0, laggard, 100.0), ('50', 1.0, laggard, 101.0),
              ('50', 1.0, other, 102.0), ('50', 1.0, laggard, 131.0)]
    got = {}
    for h, ins in ((jhealth, jinstrument), (thealth, tinstrument)):
        out = []
        for knob, skew, lag, now in script:
            if knob == 'off':
                monkeypatch.delenv('MXTPU_SKEW_WARN_PCT', raising=False)
            else:
                monkeypatch.setenv('MXTPU_SKEW_WARN_PCT', knob)
            out.append(h.note_skew(skew, lag, now=now))
        out.append(ins.metrics_snapshot()['counters'].get(
            'health.skew_warnings'))
        got[h] = out
    assert got[thealth] == got[jhealth] == [False, False, True, False, True,
                                            True, 3]


def _step_time(count, total):
    return ('mv2', {'histograms': {'comm.step_time': {'count': count,
                                                      'sum': total}}})


def test_kv_server_straggler_calls_note_skew(monkeypatch):
    """A merged view naming a straggler past MXTPU_SKEW_WARN_PCT warns
    through health.note_skew, the view equal in both packages."""
    monkeypatch.setenv('MXTPU_SKEW_WARN_PCT', '50')
    views = {}
    for kvs, ins in ((jkvs, jinstrument), (tkvs, tinstrument)):
        server = kvs.AsyncKVServer(port=0, num_workers=3)
        try:
            for rank, total in ((0, 1.0), (1, 1.0), (2, 3.0)):
                server._merge_telemetry(rank, _step_time(10, total))
            view = server.telemetry_view()
        finally:
            server.stop()
        views[kvs] = view['cluster']['step_skew']
        assert view['cluster']['gauges']['cluster.step_skew'] == \
            pytest.approx(2.0)
        assert ins.metrics_snapshot()['counters'].get(
            'health.skew_warnings') == 1
    assert views[tkvs] == views[jkvs]


def test_kv_client_barrier_feeds_barrier_wait():
    """The client's barrier wait lands in comm.barrier_wait (plane on)."""
    tcw.set_enabled(True)
    server = tkvs.AsyncKVServer(port=0, num_workers=1)
    client = tkvs.AsyncKVClient('127.0.0.1:%d' % server.port)
    try:
        client.barrier(timeout=30)
        client.barrier(timeout=30)
    finally:
        client.close()
        server.stop()
    snap = tinstrument.metrics_snapshot()
    assert snap['counters']['comm.barriers'] == 2
    assert snap['histograms']['comm.barrier_wait']['count'] == 2


# ---------------------------------------------------------------------------
# a sharded fit's collectives
# ---------------------------------------------------------------------------

def _analytic(mesh, part):
    """The wire bytes of one step of the MLP's ZeRO update on ``mesh``:
    per rank, the reduce-scatter and all-gather over dp of the padded
    owned parameters, then the tp all-gather of the tp-sharded ones."""
    axes = tmesh.parse_mesh_spec(mesh)
    dp, tp = axes['dp'], axes['tp']
    arg, _ = R.mlp_params()
    padded = sharded = 0
    for name, value in arg.items():
        spec = tmesh._spec_and_reason(value.shape, tp, part, name)[0]
        owned = value.size // (tp if 'tp' in spec else 1)
        padded += -(-owned // dp) * dp * 4
        sharded += value.nbytes if 'tp' in spec else 0
    zero = tcw.wire_bytes('reduce-scatter', padded // dp, dp) + \
        tcw.wire_bytes('all-gather', padded, dp)
    return zero + tcw.wire_bytes('all-gather', sharded, tp), padded


@pytest.mark.parametrize('n,mesh,part', [
    (n, m, p) for n in WORLDS for m, p in R.COMM_MESHES[n]])
def test_sharded_step_moves_the_analytic_bytes(ranks, n, mesh, part):
    want, padded = _analytic(mesh, part)
    axes = tmesh.parse_mesh_spec(mesh)
    if part == 'replicated':
        # the ring formula over the parameter bytes
        assert want == 2.0 * (axes['dp'] - 1) / axes['dp'] * padded
    for _, numbers in ranks[n]:
        got = numbers['%s_%s' % (mesh, part)]
        assert got['fused']
        assert got['bytes_per_step'] == want
        (row,) = got['programs']
        assert row['wire_bytes_per_step'] == want
        kinds = row['collectives']
        if axes['dp'] > 1:
            assert kinds['reduce-scatter']['count'] == 1
        assert sum(k['count'] for k in kinds.values()) == \
            (2 if axes['dp'] > 1 else 0) + (1 if axes['tp'] > 1 and
                                             part == 'auto' else 0)
        assert 0.0 < got['comm_fraction'] <= 1.0
        assert got['step_time_count'] >= 2


@pytest.mark.parametrize('n,mesh,part', [
    (n, m, p) for n in WORLDS for m, p in R.COMM_MESHES[n]])
def test_perfwatch_counts_the_mesh(ranks, n, mesh, part):
    """perf.num_devices is dp·tp, the row's global FLOPs its per-device
    FLOPs times that, perf.step_flops the global, MFU in [0, 1]."""
    axes = tmesh.parse_mesh_spec(mesh)
    ndev = axes['dp'] * axes['tp']
    for _, numbers in ranks[n]:
        got = numbers['%s_%s' % (mesh, part)]
        row = got['row']
        assert got['num_devices'] == row['num_devices'] == ndev
        assert row['global_flops'] == row['flops'] * ndev
        assert got['step_flops'] == row['global_flops']
        assert 0.0 <= got['mfu'] <= 1.0


def test_one_rank_mesh_moves_nothing(monkeypatch):
    monkeypatch.setenv('MXTPU_COMMWATCH', '1')
    monkeypatch.setenv('MXTPU_FUSE', 'off')
    x, y = R.mlp_data()
    arg, aux = R.mlp_params()
    mod = R.fit(tmx, R.mlp(tmx), arg, aux, x, y, R.MLP_BATCH, R.MLP_OPT,
                mesh='1x1')
    g = tinstrument.metrics_snapshot()['gauges']
    assert mod._fused is not None
    assert g['comm.bytes_per_step'] == 0.0
    assert g['perf.comm_fraction'] == 0.0
    assert tcw.programs()[0]['collectives'] == {}
    assert g['comm.seconds_per_step'] == 0.0
