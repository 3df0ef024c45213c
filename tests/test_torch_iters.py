"""The data iterators of the PyTorch port against the JAX package's on the
CPU, batch by batch: ``ResizeIter``, ``PrefetchingIter`` (one iterator,
several merged, renamed descriptors, reset, exhaustion, a failing
iterator, teardown), ``MNISTIter`` over idx files and ``CSVIter`` over
CSV files written under ``tmp_path`` (nothing is downloaded),
``DataIter.provide_signature`` and ``NDArrayIter.provide_signature`` /
``hard_reset``; and ``Module.fit`` over a ``PrefetchingIter`` beneath the
fit loop's device feed, and over ``MNISTIter``, against the JAX fit.

Iterators move data without arithmetic, so batches are compared exactly;
fitted parameters are held to ``tests/test_torch_train.py``'s rtol 1e-4,
atol 1e-5."""
import gc
import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx

OPT = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}


def _arrays(n=10, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(n, 3).astype(np.float32),
            r.randint(0, 4, n).astype(np.float32))


def _drain(it):
    out = []
    for b in it:
        out.append(([d.asnumpy() for d in b.data],
                    [lab.asnumpy() for lab in b.label], b.pad))
    return out


def _assert_same(tb, jb):
    assert len(tb) == len(jb)
    for (td, tl, tp), (jd, jl, jp) in zip(tb, jb):
        assert tp == jp
        assert len(td) == len(jd) and len(tl) == len(jl)
        for a, b in zip(td + tl, jd + jl):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('size,reset_internal', [(7, True), (3, False)])
def test_resize_iter_matches_jax(size, reset_internal):
    """A 3-batch NDArrayIter resized to 7 (wraps twice) and to 3, two
    epochs each."""
    x, y = _arrays()
    out = {}
    for pkg in (tmx, mx):
        it = pkg.io.ResizeIter(pkg.io.NDArrayIter(x, y, batch_size=4),
                               size, reset_internal=reset_internal)
        assert it.provide_data == [('data', (4, 3))]
        out[pkg] = _drain(it)
        it.reset()
        out[pkg] += _drain(it)
    assert len(out[tmx]) == 2 * size
    _assert_same(out[tmx], out[mx])


def _two_iters(pkg):
    x, y = _arrays(12, 1)
    x2, y2 = _arrays(12, 2)
    return [pkg.io.NDArrayIter(x, y, batch_size=4),
            pkg.io.NDArrayIter({'extra': x2}, {'extra_label': y2},
                               batch_size=4)]


def _close(pkg, it):
    if pkg is tmx:
        assert it.close()
    del it
    gc.collect()


@pytest.mark.parametrize('merged', [False, True], ids=['one', 'merged'])
def test_prefetching_iter_matches_jax(merged):
    """One iterator, and two merged with renamed descriptors: the same
    descriptors and batches, two epochs, and io.batches counted once per
    delivered batch."""
    out, descs = {}, {}
    for pkg in (tmx, mx):
        iters = _two_iters(pkg) if merged else _two_iters(pkg)[:1]
        kw = {}
        if merged:
            kw = dict(rename_data=[{'data': 'a'}, {'extra': 'b'}],
                      rename_label=[{'softmax_label': 'la'},
                                    {'extra_label': 'lb'}])
        it = pkg.io.PrefetchingIter(iters, **kw)
        descs[pkg] = (it.provide_data, it.provide_label, it.batch_size)
        before = tmx.instrument.counter_value('io.batches')
        out[pkg] = _drain(it)
        if pkg is tmx:
            assert tmx.instrument.counter_value('io.batches') == before + 3
        it.reset()
        out[pkg] += _drain(it)
        _close(pkg, it)
    assert descs[tmx] == descs[mx]
    if merged:
        assert [n for n, _ in descs[tmx][0]] == ['a', 'b']
    assert len(out[tmx]) == 6
    _assert_same(out[tmx], out[mx])


class _Flaky(object):
    """Fails on its second batch, once."""

    def __init__(self, pkg):
        self.inner = pkg.io.NDArrayIter(*_arrays(12), batch_size=4)
        self.provide_data = self.inner.provide_data
        self.provide_label = self.inner.provide_label
        self.batch_size = 4
        self.calls = 0

    def next(self):
        self.calls += 1
        if self.calls == 2:
            raise ValueError('flaky read')
        return self.inner.next()

    def reset(self):
        self.inner.reset()


def test_prefetching_iter_surfaces_a_fetch_error():
    """The producer's exception reaches the consumer; one stream fetches a
    replacement, so the epoch goes on after it, as in the JAX package."""
    seen = {}
    for pkg in (tmx, mx):
        it = pkg.io.PrefetchingIter(_Flaky(pkg))
        got = [it.next().data[0].asnumpy()]
        with pytest.raises(ValueError, match='flaky'):
            it.next()
        got += [b.data[0].asnumpy() for b in it]
        seen[pkg] = got
        _close(pkg, it)
    assert len(seen[tmx]) == 3
    for a, b in zip(seen[tmx], seen[mx]):
        np.testing.assert_array_equal(a, b)


def test_abandoned_prefetching_iter_lets_the_process_exit(tmp_path):
    """An iterator abandoned mid-epoch (no close) holds up neither its
    owner nor the interpreter's exit: its threads are daemons and
    ``__del__`` never waits."""
    script = tmp_path / 'abandon.py'
    script.write_text(textwrap.dedent('''
        import numpy as np
        import mxnet_tpu_torch as tmx
        x = np.zeros((64, 3), np.float32)
        its = [tmx.io.PrefetchingIter(
                   [tmx.io.NDArrayIter(x, batch_size=4),
                    tmx.io.NDArrayIter({'b': x}, batch_size=4)])
               for _ in range(4)]
        for it in its:
            it.next()
        del its[0]
        print('abandoned')
    '''))
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    done = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert 'abandoned' in done.stdout


def test_close_joins_the_producers():
    x, _ = _arrays(16)
    it = tmx.io.PrefetchingIter([tmx.io.NDArrayIter(x, batch_size=4)])
    it.next()
    threads = [p._thread for p in it._producers]
    assert it.close(timeout=10.0)
    assert not any(t.is_alive() for t in threads)
    assert it.close()


def _write_idx(path, array, magic_type=0x08):
    with open(path, 'wb') as f:
        f.write(struct.pack('>HBB', 0, magic_type, array.ndim))
        f.write(struct.pack('>%dI' % array.ndim, *array.shape))
        f.write(array.astype(np.uint8).tobytes())


def _mnist_files(tmp_path, n=40):
    r = np.random.RandomState(7)
    img, lab = str(tmp_path / 'img-idx3-ubyte'), \
        str(tmp_path / 'lab-idx1-ubyte')
    _write_idx(img, r.randint(0, 256, (n, 28, 28)))
    _write_idx(lab, r.randint(0, 10, n))
    return img, lab


@pytest.mark.parametrize('flat,shuffle', [(False, True), (True, False)])
def test_mnist_iter_matches_jax(tmp_path, flat, shuffle):
    """40 idx images (magic 2051) with labels (2049) at batch 16: the last
    batch pads by wrapping, the shuffle is the seed's permutation."""
    img, lab = _mnist_files(tmp_path)
    out = {}
    for pkg in (tmx, mx):
        it = pkg.io.MNISTIter(image=img, label=lab, batch_size=16,
                              flat=flat, shuffle=shuffle, seed=3)
        assert it.provide_data == [
            ('data', (16, 784) if flat else (16, 1, 28, 28))]
        assert it.provide_label == [('softmax_label', (16,))]
        out[pkg] = _drain(it)
        it.reset()
        out[pkg] += _drain(it)
    assert [b[2] for b in out[tmx]] == [0, 0, 8] * 2
    assert out[tmx][0][0][0].max() <= 1.0
    _assert_same(out[tmx], out[mx])


def test_mnist_iter_rejects_a_file_of_another_type(tmp_path):
    path = str(tmp_path / 'floats-idx')
    _write_idx(path, np.zeros((4, 2, 2)), magic_type=0x0D)
    with pytest.raises(tmx.MXNetError, match='not a uint8 idx'):
        tmx.io.MNISTIter(image=path, label=path)


@pytest.mark.parametrize('round_batch', [True, False])
def test_csv_iter_matches_jax(tmp_path, round_batch):
    """A 10-row CSV of 2x3 rows with a label CSV, batch 4."""
    r = np.random.RandomState(2)
    data = np.round(r.randn(10, 6), 3).astype(np.float32)
    labels = r.randint(0, 3, 10).astype(np.float32)
    dpath, lpath = str(tmp_path / 'data.csv'), str(tmp_path / 'label.csv')
    np.savetxt(dpath, data, delimiter=',', fmt='%.3f')
    np.savetxt(lpath, labels, delimiter=',', fmt='%d')
    out = {}
    for pkg in (tmx, mx):
        it = pkg.io.CSVIter(data_csv=dpath, data_shape=(2, 3),
                            label_csv=lpath, batch_size=4,
                            round_batch=round_batch)
        assert it.provide_data == [('data', (4, 2, 3))]
        out[pkg] = _drain(it)
    assert len(out[tmx]) == (3 if round_batch else 2)
    _assert_same(out[tmx], out[mx])
    nolabel = tmx.io.CSVIter(data_csv=dpath, data_shape=(6,), batch_size=5)
    assert not np.any(next(nolabel).label[0].asnumpy())


def test_signatures_and_hard_reset_match_jax():
    """provide_signature of NDArrayIter (the sources' dtypes) and of the
    base DataIter (float32), and hard_reset rewinding a roll_over
    iterator."""
    x, y = _arrays(10)
    sigs, firsts = {}, {}
    for pkg in (tmx, mx):
        it = pkg.io.NDArrayIter(x, y.astype(np.int32), batch_size=4,
                                last_batch_handle='roll_over')
        resized = pkg.io.ResizeIter(it, 2)
        sigs[pkg] = (it.provide_signature(),
                     pkg.io.DataIter.provide_signature(resized))
        _drain(it)
        it.hard_reset()
        firsts[pkg] = it.next().data[0].asnumpy()
    assert sigs[tmx] == sigs[mx]
    assert sigs[tmx][0]['softmax_label'] == ((4,), 'int32')
    np.testing.assert_array_equal(firsts[tmx], x[:4])
    np.testing.assert_array_equal(firsts[tmx], firsts[mx])


def _mlp(pkg):
    net = pkg.sym.FullyConnected(pkg.sym.Variable('data'), num_hidden=8,
                                 name='fc1')
    net = pkg.sym.Activation(net, act_type='relu')
    net = pkg.sym.FullyConnected(net, num_hidden=4, name='fc2')
    return pkg.sym.SoftmaxOutput(net, name='softmax')


def test_fit_over_a_prefetching_iter_matches_jax(monkeypatch):
    """Module.fit over PrefetchingIter(ResizeIter(NDArrayIter)), with the
    port's device feed on top (it hands the feed host batches): two
    epochs in the same batch order as the JAX fit, so the same
    parameters."""
    monkeypatch.setenv('MXTPU_FUSE', 'off')
    monkeypatch.setenv('MXTPU_DEVICE_FEED', '1')
    r = np.random.RandomState(5)
    x = r.randn(20, 3).astype(np.float32)
    y = r.randint(0, 4, 20).astype(np.float32)
    arg = {'fc1_weight': r.randn(8, 3).astype(np.float32) * 0.5,
           'fc1_bias': np.zeros(8, np.float32),
           'fc2_weight': r.randn(4, 8).astype(np.float32) * 0.5,
           'fc2_bias': np.zeros(4, np.float32)}
    mods = {}
    for pkg in (tmx, mx):
        it = pkg.io.PrefetchingIter(pkg.io.ResizeIter(
            pkg.io.NDArrayIter(x, y, batch_size=4), 6))
        mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
        mod.fit(it, num_epoch=2, optimizer_params=OPT,
                arg_params={k: pkg.nd.array(v) for k, v in arg.items()})
        mods[pkg] = mod
        _close(pkg, it)
    ta, ja = mods[tmx].get_params()[0], mods[mx].get_params()[0]
    for k in arg:
        np.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        assert np.max(np.abs(ta[k].asnumpy() - arg[k])) > 1e-3


def test_lenet_fit_over_mnist_iter_matches_jax(tmp_path, monkeypatch):
    """The upstream MNIST example's path at a small size: LeNet
    (models/lenet.py) through Module.fit over MNISTIter, one epoch of 40
    idx images at batch 16, against the JAX package."""
    monkeypatch.setenv('MXTPU_FUSE', 'off')
    img, lab = _mnist_files(tmp_path)
    sym = tmx.models.get_symbol('lenet', num_classes=10)
    from mxnet_tpu_torch import convert
    arg, _ = convert.random_params(sym, {'data': (16, 1, 28, 28)}, 0,
                                   init='normal')
    mods = {}
    for pkg in (tmx, mx):
        mod = pkg.mod.Module(pkg.sym.load_json(sym.tojson()),
                             context=pkg.cpu())
        mod.fit(pkg.io.MNISTIter(image=img, label=lab, batch_size=16,
                                 seed=1), num_epoch=1, optimizer_params=OPT,
                arg_params={k: pkg.nd.array(v) for k, v in arg.items()})
        mods[pkg] = mod
    ta, ja = mods[tmx].get_params()[0], mods[mx].get_params()[0]
    for k in arg:
        np.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
