"""RecordIO and the JPEG codec of the port against the JAX package on the
CPU (``mxnet_tpu_torch/recordio.py``, ``csrc/host/recordio.cc``,
``csrc/host/jpeg.cc``).

- The container: the round trip, the escape of payloads holding the
  magic word, the indexed reader, multi-label ``pack``; the port's
  ``.rec``/``.idx`` bytes equal the JAX package's for the same writes,
  and each package reads what the other wrote.
- The codec: the port decodes JPEG files written by the JAX package's
  ``pack_img`` (PIL, libjpeg) to the pixels libjpeg gives, bit for bit:
  4:2:0, 4:2:2, 4:4:4, gray, odd sizes, restart markers.  Its encoder
  writes the headers libjpeg writes (quantization and Huffman tables,
  frame) and files libjpeg decodes to the port's pixels.  A progressive
  file raises, naming the reason.
- PNG through ``pack_img``/``unpack_img`` both ways, and ``nd.save`` /
  ``nd.load`` and RecordIO over a remote (``memory://``) URI through
  ``fs``.  Tolerance: exact throughout."""
import io

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as mx
from mxnet_tpu import recordio as jrec
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import recordio as trec

MAGIC = (0xced7230a).to_bytes(4, 'little')


def _smooth(h, w, seed):
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / (7 + seed % 5) + r.rand() * 6),
                    128 + 100 * np.cos(yy / (9 + seed % 3)),
                    (xx + yy) % 256], -1) + r.randn(h, w, 3) * 12
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format='JPEG', **kw)
    return buf.getvalue()


def _pil_decode(blob):
    return np.asarray(Image.open(io.BytesIO(blob)))


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------

PAYLOADS = [b'abcd' + MAGIC + b'efgh', MAGIC + MAGIC,
            b'x' * 3 + MAGIC * 2 + b'tail', b'', b'short', MAGIC,
            bytes(range(256)) * 3] + [str(i).encode() for i in range(40)]


@pytest.mark.parametrize('writer,reader', [('port', 'port'), ('port', 'jax'),
                                           ('jax', 'port')])
def test_round_trip_and_magic_escape_across_packages(tmp_path, writer,
                                                     reader):
    pkgs = {'port': trec, 'jax': jrec}
    path = str(tmp_path / 'a.rec')
    w = pkgs[writer].MXRecordIO(path, 'w')
    for p in PAYLOADS:
        w.write(p)
    w.close()
    r = pkgs[reader].MXRecordIO(path, 'r')
    assert [r.read() for _ in PAYLOADS] == PAYLOADS
    assert r.read() is None
    r.reset()
    assert r.read() == PAYLOADS[0]
    r.close()


def test_rec_and_idx_bytes_equal_the_jax_packages(tmp_path):
    for pkg, name in ((trec, 'port'), (jrec, 'jax')):
        w = pkg.MXIndexedRecordIO(str(tmp_path / (name + '.idx')),
                                  str(tmp_path / (name + '.rec')), 'w')
        for i, p in enumerate(PAYLOADS):
            w.write_idx(i, p)
        w.close()
    for ext in ('.rec', '.idx'):
        assert (tmp_path / ('port' + ext)).read_bytes() == \
            (tmp_path / ('jax' + ext)).read_bytes()


@pytest.mark.parametrize('writer,reader', [('port', 'port'), ('port', 'jax'),
                                           ('jax', 'port')])
def test_indexed_reader_across_packages(tmp_path, writer, reader):
    pkgs = {'port': trec, 'jax': jrec}
    frec, fidx = str(tmp_path / 'i.rec'), str(tmp_path / 'i.idx')
    w = pkgs[writer].MXIndexedRecordIO(fidx, frec, 'w')
    for i in range(100):
        w.write_idx(i, str(i).encode() + (MAGIC if i % 7 == 0 else b''))
    w.close()
    r = pkgs[reader].MXIndexedRecordIO(fidx, frec, 'r')
    assert r.keys == list(range(100))
    for i in [0, 57, 99, 3, 14]:
        assert r.read_idx(i) == str(i).encode() + \
            (MAGIC if i % 7 == 0 else b'')
    r.close()


@pytest.mark.parametrize('label', [3.0, [1.0, 2.0, 3.0], np.arange(7.0)])
def test_pack_unpack_match_jax(label):
    header = (0, label, 9, 2)
    blob = trec.pack(trec.IRHeader(*header), b'payload')
    assert blob == jrec.pack(jrec.IRHeader(*header), b'payload')
    th, ts = trec.unpack(blob)
    jh, js = jrec.unpack(blob)
    assert ts == js == b'payload'
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    np.testing.assert_array_equal(np.asarray(th.label), np.asarray(jh.label))


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

SIZES = [(1, 1), (1, 17), (17, 1), (2, 3), (7, 9), (16, 16), (33, 47),
         (64, 63), (97, 131)]


@pytest.mark.parametrize('subsampling', [0, 1, 2], ids=['444', '422', '420'])
@pytest.mark.parametrize('quality', [50, 95])
def test_decode_equals_libjpeg(subsampling, quality):
    for k, (h, w) in enumerate(SIZES):
        img = _smooth(h, w, k)
        blob = _pil_jpeg(img, quality=quality, subsampling=subsampling)
        np.testing.assert_array_equal(trec.jpeg_decode(blob),
                                      _pil_decode(blob), err_msg=str((h, w)))


@pytest.mark.parametrize('restart', [dict(restart_marker_blocks=1),
                                     dict(restart_marker_blocks=5),
                                     dict(restart_marker_rows=1)])
@pytest.mark.parametrize('subsampling', [0, 2], ids=['444', '420'])
def test_decode_with_restart_markers_equals_libjpeg(restart, subsampling):
    img = _smooth(77, 93, 5)
    blob = _pil_jpeg(img, quality=90, subsampling=subsampling, **restart)
    assert b'\xff\xdd' in blob
    np.testing.assert_array_equal(trec.jpeg_decode(blob), _pil_decode(blob))


def test_gray_decode_equals_libjpeg():
    for k, (h, w) in enumerate(SIZES):
        gray = _smooth(h, w, k)[:, :, 1]
        blob = _pil_jpeg(gray, quality=90)
        np.testing.assert_array_equal(trec.jpeg_decode(blob),
                                      _pil_decode(blob))
        # as RGB, the gray value replicated (libjpeg's gray -> RGB)
        np.testing.assert_array_equal(
            trec.jpeg_decode(blob, gray=False),
            np.repeat(_pil_decode(blob)[:, :, None], 3, axis=2))


@pytest.mark.parametrize('quality', [50, 75, 95])
def test_encoder_writes_libjpegs_headers_and_decodes_alike(quality):
    img = _smooth(97, 131, 3)
    port = trec.jpeg_encode(img, quality)
    pil = _pil_jpeg(img, quality=quality)
    # APP0, DQT, SOF0 and DHT: the Annex K tables under the IJG scaling
    assert port[:port.index(b'\xff\xda')] == pil[:pil.index(b'\xff\xda')]
    np.testing.assert_array_equal(trec.jpeg_decode(port), _pil_decode(port))
    # the forward DCT rounds otherwise than libjpeg's: the two files
    # decode within a level of each other on average, as far from the
    # source
    diff = np.abs(trec.jpeg_decode(port).astype(int)
                  - _pil_decode(pil).astype(int))
    assert diff.mean() < 1.0
    err_port = np.abs(trec.jpeg_decode(port).astype(int) - img).mean()
    err_pil = np.abs(_pil_decode(pil).astype(int) - img).mean()
    assert abs(err_port - err_pil) < 0.1 * err_pil


def test_pack_img_crosses_the_packages():
    img = _smooth(40, 56, 1)
    header = (0, 3.0, 7, 0)
    port = trec.pack_img(trec.IRHeader(*header), img, quality=95)
    jax_ = jrec.pack_img(jrec.IRHeader(*header), img, quality=95)
    for blob in (port, jax_):
        th, timg = trec.unpack_img(blob)
        jh, jimg = jrec.unpack_img(blob)
        assert (th.label, th.id) == (jh.label, jh.id) == (3.0, 7)
        np.testing.assert_array_equal(timg, jimg)
    gray = img[:, :, 0]
    th, timg = trec.unpack_img(trec.pack_img(trec.IRHeader(*header), gray))
    jh, jimg = jrec.unpack_img(jrec.pack_img(jrec.IRHeader(*header), gray))
    assert timg.shape == jimg.shape == gray.shape


@pytest.mark.parametrize('shape', [(13, 21), (13, 21, 3), (9, 8, 4)])
def test_png_both_ways(shape):
    img = _smooth(shape[0], shape[1], 2)
    img = img[:, :, 0] if len(shape) == 2 else \
        np.concatenate([img, img[:, :, :1]], axis=2)[:, :, :shape[2]]
    header = (0, 1.0, 2, 0)
    port = trec.pack_img(trec.IRHeader(*header), img, img_fmt='.png')
    jax_ = jrec.pack_img(jrec.IRHeader(*header), img, img_fmt='.png')
    for blob in (port, jax_):
        np.testing.assert_array_equal(trec.unpack_img(blob)[1], img)
        np.testing.assert_array_equal(jrec.unpack_img(blob)[1], img)


def test_progressive_and_bad_files_raise():
    blob = _pil_jpeg(_smooth(40, 40, 1), progressive=True)
    with pytest.raises(tmx.MXNetError, match='progressive'):
        trec.jpeg_decode(blob)
    with pytest.raises(tmx.MXNetError, match='not a JPEG'):
        trec.jpeg_decode(b'GIF89a' + bytes(64))
    with pytest.raises(tmx.MXNetError, match=r'\(H, W, 3\)'):
        trec.jpeg_encode(np.zeros((4, 4, 2), np.uint8))


# ---------------------------------------------------------------------------
# fs: remote URIs
# ---------------------------------------------------------------------------

def test_nd_save_load_over_a_remote_uri_cross_the_packages(tmp_path,
                                                           monkeypatch):
    pytest.importorskip('fsspec')
    monkeypatch.setenv('MXTPU_FS_CACHE', str(tmp_path / 'cache'))
    arrays = {'w': np.arange(12, dtype=np.float32).reshape(3, 4),
              'b': np.array([1, 2], np.int32)}
    with tmx.cpu():
        tmx.nd.save('memory://torch-port/a.params',
                    {k: tmx.nd.array(v, dtype=v.dtype)
                     for k, v in arrays.items()})
    got = mx.nd.load('memory://torch-port/a.params')
    assert tmx.nd.validate('memory://torch-port/a.params')
    mx.nd.save('memory://torch-port/b.params',
               {k: mx.nd.array(v, dtype=v.dtype) for k, v in arrays.items()})
    back = tmx.nd.load('memory://torch-port/b.params')
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].asnumpy(), v)
        np.testing.assert_array_equal(back[k].asnumpy(), v)
    assert not tmx.nd.validate('memory://torch-port/missing.params')


def test_recordio_over_a_remote_uri(tmp_path, monkeypatch):
    pytest.importorskip('fsspec')
    monkeypatch.setenv('MXTPU_FS_CACHE', str(tmp_path / 'cache'))
    uri = 'memory://torch-port/data.rec'
    w = trec.MXRecordIO(uri, 'w')
    for p in PAYLOADS[:5]:
        w.write(p)
    w.close()
    for pkg in (trec, jrec):
        r = pkg.MXRecordIO(uri, 'r')
        assert [r.read() for _ in range(5)] == PAYLOADS[:5]
        r.close()
    assert tmx.fs.is_remote(uri) and not tmx.fs.is_remote(str(tmp_path))
