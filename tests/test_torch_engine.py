"""The engine facade of the PyTorch port (``mxnet_tpu_torch/engine.py``)
against the JAX package's (``mxnet_tpu/engine.py``) on the CPU:
``StepWindow`` at depth 1, 2 and 3 under one admit/drain sequence
publishes the same ``engine.inflight_depth`` / ``engine.inflight_peak``
gauges and ``engine.window_waits`` counter after every call, and the
``MXNET_ENGINE_TYPE`` / ``set_engine_type`` switch (NaiveEngine turns
whole-step capture off, as it turns jit off in the JAX package).  Exact
comparisons: these are counts."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu import engine as jengine
from mxnet_tpu_torch import engine as tengine

SEQUENCE = ('admit', 'admit', 'admit', 'drain', 'admit', 'admit', 'admit',
            'admit', 'drain', 'drain', 'admit')


def _trace(pkg, engine_mod, ticket, depth):
    """The window's gauges and waits after each call of SEQUENCE."""
    pkg.instrument.reset_metrics()
    window = engine_mod.StepWindow(depth)
    out = []
    for op in SEQUENCE:
        window.admit(ticket()) if op == 'admit' else window.drain()
        snap = pkg.instrument.metrics_snapshot()
        out.append((snap['gauges'].get('engine.inflight_depth'),
                    snap['gauges'].get('engine.inflight_peak'),
                    snap['counters'].get('engine.window_waits', 0)))
    return out


@pytest.fixture
def jax_metrics():
    was = mx.instrument.metrics_enabled()
    mx.instrument.set_metrics(True)
    yield
    mx.instrument.set_metrics(was)


@pytest.mark.parametrize('depth', [1, 2, 3])
def test_step_window_matches_jax(depth, jax_metrics):
    got = _trace(tmx, tengine, lambda: [torch.zeros(2)], depth)
    want = _trace(mx, jengine, lambda: [jnp.zeros(2)], depth)
    assert got == want
    assert max(p for _, p, _ in got) == min(depth, 3)


def test_step_window_ignores_no_ticket():
    tmx.instrument.reset_metrics()
    window = tengine.StepWindow(2)
    window.admit(None)
    window.drain()
    snap = tmx.instrument.metrics_snapshot()
    assert 'engine.inflight_peak' not in snap['gauges']
    assert snap['counters'].get('engine.window_waits', 0) == 0


def test_set_engine_type_switches_capture():
    assert tengine.get_engine_type() == jengine.get_engine_type() == \
        'ThreadedEnginePerDevice'
    try:
        tengine.set_engine_type('NaiveEngine')
        assert tengine.get_engine_type() == 'NaiveEngine'
        assert not tengine.capture_enabled()
        assert tmx.compile_cache.capture_skip_reason(
            torch.device('cuda', 0)) == 'NaiveEngine'
    finally:
        tengine.set_engine_type('ThreadedEnginePerDevice')
    assert tengine.capture_enabled()
    assert tmx.compile_cache.capture_skip_reason(
        torch.device('cuda', 0)) is None


def test_engine_type_from_the_environment():
    """MXNET_ENGINE_TYPE is applied at import, as in the JAX package."""
    code = ('import mxnet_tpu_torch as mx; '
            'print(mx.engine.get_engine_type(), '
            'mx.engine.capture_enabled())')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ,
                                  MXNET_ENGINE_TYPE='NaiveEngine'))
    assert out.stdout.split() == ['NaiveEngine', 'False']


def test_sync_and_waits_on_the_cpu():
    """sync returns its tree (no card work to wait for); the no-op knobs
    keep the reference's surface."""
    tree = {'a': torch.ones(3), 'b': [tmx.nd.array(np.ones(2))]}
    assert tengine.sync(tree) is tree
    tengine.wait_for_var(tree['b'][0])
    tengine.wait_for_all()
    assert tengine.set_bulk_size(16) == jengine.set_bulk_size(16) == 16
