"""``image.py`` and ``opencv.py`` of the port against the JAX modules on
the CPU, the same numpy images and the same seeds of Python's ``random``.

``image.py`` makes the JAX module's PIL calls (decode, bilinear resize),
so its results are compared exactly.  ``opencv.resize`` is
``jax.image.resize`` (half-pixel centres, the triangle or Keys cubic
kernel widened when downsampling) written out in torch; the float sums
run in another order, so after the rounding to uint8 a sample may land
one level away: tolerance 1 level, and at most 1% of the samples off.
Everything else is exact."""
import io
import random

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as mx
from mxnet_tpu import image as jimage
from mxnet_tpu import opencv as jcv
from mxnet_tpu import recordio as jrec
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch import opencv as tcv


def _img(h=37, w=53, seed=0):
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 5.0 + r.rand() * 6),
                    128 + 90 * np.cos(yy / 7.0), (xx * 3 + yy) % 256], -1)
    return np.clip(img + r.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)


def _jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format='JPEG', quality=95, **kw)
    return buf.getvalue()


def _nd(pkg, arr):
    return pkg.nd.array(arr, dtype=arr.dtype)


def _eq(t, j):
    np.testing.assert_array_equal(np.asarray(t.asnumpy()),
                                  np.asarray(j.asnumpy()))


def _seeded(fn, seed=3):
    random.seed(seed)
    return fn()


# ---------------------------------------------------------------------------
# image.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('to_rgb,flag', [(True, 1), (False, 1), (True, 0)])
def test_imdecode(to_rgb, flag):
    blob = _jpeg(_img())
    _eq(timage.imdecode(blob, to_rgb=to_rgb, flag=flag),
        jimage.imdecode(blob, to_rgb=to_rgb, flag=flag))


def test_resize_short_fixed_center_crop_and_normalize():
    arr = _img(41, 67)
    t, j = _nd(tmx, arr), _nd(mx, arr)
    assert timage.scale_down((67, 41), (50, 50)) == \
        jimage.scale_down((67, 41), (50, 50))
    _eq(timage.resize_short(t, 24), jimage.resize_short(j, 24))
    _eq(timage.fixed_crop(t, 3, 5, 20, 17), jimage.fixed_crop(j, 3, 5, 20,
                                                              17))
    _eq(timage.fixed_crop(t, 3, 5, 20, 17, size=(11, 13)),
        jimage.fixed_crop(j, 3, 5, 20, 17, size=(11, 13)))
    tc, tr = timage.center_crop(t, (30, 30))
    jc, jr = jimage.center_crop(j, (30, 30))
    assert tr == jr
    _eq(tc, jc)
    mean, std = np.array([120.0, 110, 100]), np.array([50.0, 55, 60])
    np.testing.assert_allclose(
        timage.color_normalize(t, mean, std).asnumpy(),
        jimage.color_normalize(j, mean, std).asnumpy(), rtol=0, atol=0)


def test_random_crops_under_the_same_seed():
    arr = _img(48, 64)
    t, j = _nd(tmx, arr), _nd(mx, arr)
    for seed in range(4):
        tc, tr = _seeded(lambda: timage.random_crop(t, (24, 20)), seed)
        jc, jr = _seeded(lambda: jimage.random_crop(j, (24, 20)), seed)
        assert tr == jr
        _eq(tc, jc)
        tc, tr = _seeded(lambda: timage.random_size_crop(t, (16, 16)), seed)
        jc, jr = _seeded(lambda: jimage.random_size_crop(j, (16, 16)), seed)
        assert tr == jr
        _eq(tc, jc)


@pytest.mark.parametrize('kw', [
    dict(), dict(resize=40, rand_crop=True, rand_mirror=True),
    dict(rand_crop=True, rand_resize=True, mean=True, std=True),
    dict(mean=np.array([1.0, 2, 3]))])
def test_create_augmenter_pipelines(kw):
    arr = _img(50, 60)
    shape = (3, 32, 32)
    tl, jl = timage.CreateAugmenter(shape, **kw), \
        jimage.CreateAugmenter(shape, **kw)
    assert len(tl) == len(jl)
    random.seed(5)
    t = _nd(tmx, arr)
    for aug in tl:
        t = aug(t)
    random.seed(5)
    j = _nd(mx, arr)
    for aug in jl:
        j = aug(j)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_image_iter_over_a_rec_and_a_list(tmp_path):
    frec = str(tmp_path / 'a.rec')
    w = jrec.MXRecordIO(frec, 'w')
    lst = []
    for i in range(7):
        img = _img(40 + i, 44, i)
        w.write(jrec.pack_img(jrec.IRHeader(0, float(i % 3), i, 0), img))
        with open(tmp_path / ('%d.jpg' % i), 'wb') as f:
            f.write(_jpeg(img))
        lst.append('%d\t%d\t%d.jpg' % (i, i % 3, i))
    w.close()
    (tmp_path / 'a.lst').write_text('\n'.join(lst) + '\n')
    for kw in (dict(path_imgrec=frec),
               dict(path_imglist=str(tmp_path / 'a.lst'),
                    path_root=str(tmp_path))):
        kw.update(batch_size=3, data_shape=(3, 24, 24), shuffle=True,
                  rand_crop=True, rand_mirror=True)
        random.seed(1)
        tb = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
              for b in timage.ImageIter(**kw)]
        random.seed(1)
        jb = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
              for b in jimage.ImageIter(**kw)]
        assert len(tb) == len(jb) == 3
        for (td, tl, tp), (jd, jl, jp) in zip(tb, jb):
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tl, jl)
            assert tp == jp


# ---------------------------------------------------------------------------
# opencv.py
# ---------------------------------------------------------------------------

def test_cv_imdecode_is_bgr():
    blob = _jpeg(_img())
    _eq(tcv.imdecode(blob), jcv.imdecode(blob))
    _eq(tcv.imdecode(blob, 0), jcv.imdecode(blob, 0))


def _close(t, j):
    t, j = t.asnumpy().astype(int), np.asarray(j.asnumpy()).astype(int)
    assert t.shape == j.shape
    off = np.abs(t - j)
    assert off.max() <= 1 and (off > 0).mean() <= 0.01, \
        (off.max(), (off > 0).mean())


@pytest.mark.parametrize('interp', [tcv.INTER_NEAREST, tcv.INTER_LINEAR,
                                    tcv.INTER_CUBIC])
@pytest.mark.parametrize('size', [(20, 15), (90, 61), (53, 20), (31, 74)])
def test_cv_resize_matches_jax_image_resize(interp, size):
    arr = _img(37, 53)
    t = tcv.resize(_nd(tmx, arr), size, interp)
    j = jcv.resize(_nd(mx, arr), size, interp)
    assert t.shape == (size[1], size[0], 3) and t.asnumpy().dtype == np.uint8
    if interp == tcv.INTER_NEAREST:
        _eq(t, j)
    else:
        _close(t, j)


@pytest.mark.parametrize('border', [tcv.BORDER_CONSTANT,
                                    tcv.BORDER_REPLICATE])
def test_cv_copy_make_border(border):
    arr = _img(9, 11)
    _eq(tcv.copyMakeBorder(_nd(tmx, arr), 2, 3, 4, 1, border, value=7),
        jcv.copyMakeBorder(_nd(mx, arr), 2, 3, 4, 1, border, value=7))


def test_cv_crops_and_normalize():
    arr = _img(48, 64)
    t, j = _nd(tmx, arr), _nd(mx, arr)
    assert tcv.scale_down((64, 48), (80, 30)) == jcv.scale_down((64, 48),
                                                                (80, 30))
    _eq(tcv.fixed_crop(t, 2, 3, 30, 20), jcv.fixed_crop(j, 2, 3, 30, 20))
    _close(tcv.fixed_crop(t, 2, 3, 30, 20, size=(15, 10)),
           jcv.fixed_crop(j, 2, 3, 30, 20, size=(15, 10)))
    for seed in range(3):
        tc, tr = _seeded(lambda: tcv.random_crop(t, (20, 20)), seed)
        jc, jr = _seeded(lambda: jcv.random_crop(j, (20, 20)), seed)
        assert tr == jr
        _close(tc, jc)
        tc, tr = _seeded(lambda: tcv.random_size_crop(t, (16, 16)), seed)
        jc, jr = _seeded(lambda: jcv.random_size_crop(j, (16, 16)), seed)
        assert tr == jr
        _close(tc, jc)
    f = arr.astype(np.float32)
    tn = tcv.color_normalize(tmx.nd.array(f), tmx.nd.array([1.0, 2, 3]),
                             tmx.nd.array([2.0, 4, 8]))
    jn = jcv.color_normalize(mx.nd.array(f), mx.nd.array([1.0, 2, 3]),
                             mx.nd.array([2.0, 4, 8]))
    np.testing.assert_array_equal(tn.asnumpy(), jn.asnumpy())


def test_cv_image_list_iter(tmp_path):
    names = []
    for i in range(5):
        with open(tmp_path / ('im%d.jpg' % i), 'wb') as f:
            f.write(_jpeg(_img(40, 50, i)))
        names.append('im%d' % i)
    flist = tmp_path / 'list.txt'
    flist.write_text('\n'.join(names) + '\n')
    kw = dict(root=str(tmp_path) + '/', flist=str(flist), batch_size=2,
              size=(24, 20), mean=np.array([100.0, 110, 120], np.float32))
    random.seed(2)
    tb = [(b.data[0].asnumpy(), b.pad) for b in tcv.ImageListIter(**kw)]
    random.seed(2)
    jb = [(b.data[0].asnumpy(), b.pad) for b in jcv.ImageListIter(**kw)]
    assert [p for _, p in tb] == [p for _, p in jb] == [0, 0, 1]
    for (td, _), (jd, _) in zip(tb, jb):
        assert td.shape == jd.shape == (2, 3, 20, 24)
        assert np.abs(td - jd).max() <= 1.0
