"""Training from a ``.rec`` of JPEGs in both packages on the CPU: a narrow
ResNet v2 (ImageNet stem, 3x64x64, 10 classes) through ``Module.fit``
under ``MXTPU_FUSE=aggressive`` over each package's ``ImageRecordIter``
(shuffled, random crop and mirror, the ImageNet mean and std) on the
same small ``.rec``, which each package writes in turn.

The two iterators give the same batches bit for bit
(``tests/test_torch_image_record_iter.py``), so what differs is the
arithmetic of the fits.  Tolerance: trained parameters and BatchNorm
statistics to rtol 1e-5 (atol 1e-6) in float32 after three steps."""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import recordio as jrec
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.models import resnet as tresnet

OPT = {'learning_rate': 0.05, 'momentum': 0.9, 'wd': 1e-4}
BATCH, STEPS = 4, 3
ITER = dict(data_shape=(3, 64, 64), batch_size=BATCH, shuffle=True,
            rand_crop=True, rand_mirror=True, mean_r=123.68,
            mean_g=116.779, mean_b=103.939, std_r=58.395, std_g=57.12,
            std_b=57.375, preprocess_threads=2, seed=4)


def _image(rng):
    h, w = (int(v) for v in rng.integers(72, 110, 2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a = rng.uniform(0.02, 0.2, 3)
    img = np.stack([128 + 100 * np.sin(xx * a[0] + yy * a[1]),
                    128 + 90 * np.cos(yy * a[2]),
                    (xx * 2 + yy) % 256], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(params=['port', 'jax'])
def rec(request, tmp_path):
    """The .rec, written by the port's pack_img (its own encoder) or by
    the JAX package's (PIL)."""
    pkg = trec if request.param == 'port' else jrec
    rng = np.random.default_rng(11)
    path = str(tmp_path / 'train.rec')
    writer = pkg.MXRecordIO(path, 'w')
    for i in range(BATCH * STEPS):
        writer.write(pkg.pack_img(pkg.IRHeader(0, float(i % 10), i, 0),
                                  _image(rng), quality=95))
    writer.close()
    return path


def test_resnet_fit_over_image_record_iter_matches_jax(monkeypatch, rec):
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    tsym = tresnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                          filter_list=[8, 16, 32, 64, 128], num_classes=10,
                          image_shape=(3, 64, 64))
    arg, aux = convert.random_params(tsym, {'data': (BATCH, 3, 64, 64)}, 0)
    tm = tmx.Module(tsym, context=tmx.cpu())
    tit = tmx.io.ImageRecordIter(path_imgrec=rec, **ITER)
    tm.fit(tit, num_epoch=1, optimizer='sgd', optimizer_params=OPT,
           arg_params={k: tmx.nd.array(v) for k, v in arg.items()},
           aux_params={k: tmx.nd.array(v) for k, v in aux.items()})
    jm = mx.mod.Module(mx.sym.load_json(tsym.tojson()), context=mx.cpu())
    jit = mx.io.ImageRecordIter(path_imgrec=rec, **ITER)
    jm.fit(jit, num_epoch=1, optimizer='sgd', optimizer_params=OPT,
           arg_params={k: mx.nd.array(v) for k, v in arg.items()},
           aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    tit.close()
    jit.close()
    (ta, tx), (ja, jx) = tm.get_params(), jm.get_params()
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    moved = 0.0
    for k in ja:
        np.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        moved = max(moved, float(np.max(np.abs(ta[k].asnumpy() - arg[k]))))
    for k in jx:
        np.testing.assert_allclose(tx[k].asnumpy(), jx[k].asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert moved > 1e-3
