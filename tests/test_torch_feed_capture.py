"""What keeps a recording valid beside the device feed, on the CPU.

On the card a graph being recorded was invalidated when a garbage
collection inside the recording destroyed the previous fit's graphs
(``CUDAGraph.reset``: "operation not permitted when stream is
capturing"); ``tools/torch_feed_capture.py --lever`` reproduces it.  The
invariants the repair adds, held here without a card:

- a ``CapturedStep`` dropped while a recording is under way (on this
  thread, or on another, which holds the capture lock) does not destroy
  its graph: the graph is retired and destroyed by the next
  ``compile_cache.reap_graphs``, which holds the capture lock; dropped
  outside a recording, its graph goes at once.

The fault was reproduced with the feed off as well, so the feed itself
is left as it was."""
import gc
import threading
import time

from mxnet_tpu_torch import compile_cache


class _FakeGraph(object):
    destroyed = []

    def __init__(self, name):
        self.name = name

    def __del__(self):
        _FakeGraph.destroyed.append(self.name)


def _step(name):
    cap = compile_cache.CapturedStep(name, lambda: [], 'cpu')
    cap.graph = _FakeGraph(name)
    return cap


def test_a_step_dropped_outside_a_recording_frees_its_graph_at_once():
    _FakeGraph.destroyed = []
    cap = _step('dropped')
    del cap
    assert _FakeGraph.destroyed == ['dropped']
    assert compile_cache._retired == []


def test_a_step_dropped_inside_a_recording_keeps_its_graph_until_after():
    """A recording under way on this thread (the capture lock held, the
    recording counted): the dropped step's graph is retired, and the next
    reap outside the recording destroys it."""
    _FakeGraph.destroyed = []
    with compile_cache._capture_lock:
        compile_cache._recording[0] += 1
        try:
            cap = _step('inside')
            del cap
            assert _FakeGraph.destroyed == []
        finally:
            compile_cache._recording[0] -= 1
    assert _FakeGraph.destroyed == []
    compile_cache.reap_graphs()
    assert _FakeGraph.destroyed == ['inside']


class _PlainGraph(object):
    """A graph without a Python finalizer, as ``torch.cuda.CUDAGraph``
    (its destructor is C++): the collector calls no ``__del__`` on it."""

    def __init__(self, name):
        self.name = name


def test_a_step_collected_inside_a_recording_keeps_its_graph():
    """The cyclic collector finalizes a step inside a recording: its
    graph is kept, intact, until the reap."""
    compile_cache.reap_graphs()
    cap = compile_cache.CapturedStep('cyclic', lambda: [], 'cpu')
    cap.graph = _PlainGraph('cyclic')
    cap.self_ref = cap
    del cap
    with compile_cache._capture_lock:
        compile_cache._recording[0] += 1
        try:
            gc.collect()
        finally:
            compile_cache._recording[0] -= 1
    kept = [g for g in compile_cache._retired
            if getattr(g, 'name', None) == 'cyclic']
    assert len(kept) == 1 and kept[0].name == 'cyclic'   # alive, intact
    compile_cache.reap_graphs()
    assert compile_cache._retired == []


def test_a_step_dropped_while_another_thread_records_waits_for_it():
    """The capture lock held by another thread (a recording): the graph
    of a step dropped here is retired, and the reap waits for the lock."""
    _FakeGraph.destroyed = []
    held, release = threading.Event(), threading.Event()

    def capture():
        with compile_cache._capture_lock:
            held.set()
            release.wait(10)

    t = threading.Thread(target=capture)
    t.start()
    assert held.wait(10)
    cap = _step('held')
    del cap
    assert _FakeGraph.destroyed == []           # retired, not destroyed
    reaper = threading.Thread(target=compile_cache.reap_graphs)
    reaper.start()
    time.sleep(0.2)
    assert _FakeGraph.destroyed == []           # blocked on the lock
    release.set()
    t.join(10)
    reaper.join(10)
    assert not t.is_alive() and not reaper.is_alive()
    assert _FakeGraph.destroyed == ['held']


def test_an_unrecorded_step_retires_nothing():
    before = len(compile_cache._retired)
    cap = compile_cache.CapturedStep('never', lambda: [], 'cpu')
    del cap
    assert len(compile_cache._retired) == before
