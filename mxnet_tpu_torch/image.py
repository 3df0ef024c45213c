"""Python-side image utilities — the port of ``mxnet_tpu/image.py``
(reference ``python/mxnet/image.py``, the python decode/augment
pipeline; the C++ hot path lives in ``csrc/host/recordio.cc``).  PIL
replaces OpenCV, with the JAX package's calls, imported lazily inside
each function: this module is a CPU-side convenience, and the card's
input path (``io.ImageRecordIter``) does not use it.
"""
from __future__ import annotations

import io as _pyio
import os
import random

import numpy as np

from . import instrument
from . import iowatch as _iowatch
from . import ndarray as nd
from .ndarray import NDArray


def imdecode(buf, to_rgb=True, flag=1):
    """Decode an image byte buffer to an NDArray HWC uint8
    (reference image.py:imdecode over cv2.imdecode)."""
    from PIL import Image
    with _iowatch.stage('decode'):
        img = Image.open(_pyio.BytesIO(bytes(buf)))
        img = img.convert('RGB' if flag else 'L')
        arr = np.asarray(img)
        if not to_rgb and flag:
            arr = arr[:, :, ::-1]  # BGR like the cv2 default
        if not flag:
            arr = arr[:, :, None]
        return nd.array(arr.astype(np.uint8), dtype=np.uint8)


def scale_down(src_size, size):
    """(reference image.py:scale_down)"""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize shorter edge to size (reference image.py:resize_short)."""
    from PIL import Image
    with _iowatch.stage('augment'):
        arr = src.asnumpy().astype(np.uint8)
        h, w = arr.shape[:2]
        if h > w:
            new_w, new_h = size, int(size * h / w)
        else:
            new_w, new_h = int(size * w / h), size
        img = Image.fromarray(arr.squeeze() if arr.shape[-1] == 1
                              else arr)
        img = img.resize((new_w, new_h), Image.BILINEAR)
        out = np.asarray(img)
        if out.ndim == 2:
            out = out[:, :, None]
        return nd.array(out, dtype=np.uint8)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """(reference image.py:fixed_crop)"""
    with _iowatch.stage('augment'):
        out = src.asnumpy()[y0:y0 + h, x0:x0 + w]
        if size is not None and (w, h) != size:
            from PIL import Image
            img = Image.fromarray(out.astype(np.uint8).squeeze()
                                  if out.shape[-1] == 1 else
                                  out.astype(np.uint8))
            out = np.asarray(img.resize(size, Image.BILINEAR))
            if out.ndim == 2:
                out = out[:, :, None]
        return nd.array(out, dtype=np.uint8)


def random_crop(src, size, interp=2):
    """(reference image.py:random_crop)"""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """(reference image.py:center_crop)"""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    """(reference image.py:color_normalize)"""
    out = src.asnumpy().astype(np.float32)
    out = out - np.asarray(mean, np.float32)
    if std is not None:
        out = out / np.asarray(std, np.float32)
    return nd.array(out)


def random_size_crop(src, size, min_area=0.08, ratio=(3 / 4., 4 / 3.),
                     interp=2):
    """Inception-style random-area crop (reference image.py)."""
    h, w = src.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = random.uniform(min_area, 1.0) * area
        aspect = random.uniform(*ratio)
        new_w = int(round(np.sqrt(target_area * aspect)))
        new_h = int(round(np.sqrt(target_area / aspect)))
        if random.random() < 0.5:
            new_w, new_h = new_h, new_w
        if new_w <= w and new_h <= h:
            x0 = random.randint(0, w - new_w)
            y0 = random.randint(0, h - new_h)
            return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
                (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def HorizontalFlipAug(p):
    def aug(src):
        if random.random() < p:
            return nd.array(src.asnumpy()[:, ::-1], dtype=np.uint8)
        return src
    return aug


def CastAug():
    def aug(src):
        return src.astype(np.float32)
    return aug


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, **kwargs):
    """Build an augmenter list (reference image.py:CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(lambda src: resize_short(src, resize))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(lambda src: random_size_crop(src, crop_size)[0])
    elif rand_crop:
        auglist.append(lambda src: random_crop(src, crop_size)[0])
    else:
        auglist.append(lambda src: center_crop(src, crop_size)[0])
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if mean is not None or std is not None:
        if mean is True or mean is None:
            mean = np.array([123.68, 116.28, 103.53])
        if std is True or std is None:
            std = np.array([58.395, 57.12, 57.375])
        auglist.append(lambda src: color_normalize(src, mean, std))
    return auglist


class ImageIter(object):
    """Python image iterator over .lst/.rec (reference image.py:ImageIter);
    the performant path is ImageRecordIter — this one is the flexible
    python-augmenter variant."""

    _counts_io_batches = True       # not a DataIter subclass, so the
                                    # io.batches protocol flag lives here

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root='', shuffle=False,
                 aug_list=None, data_name='data',
                 label_name='softmax_label', **kwargs):
        from .io import DataIter, DataBatch
        assert path_imgrec or path_imglist
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.data_name = data_name
        self.label_name = label_name
        self.shuffle = shuffle
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **kwargs)
        self._items = []
        if path_imgrec:
            from .recordio import MXRecordIO, unpack
            rec = MXRecordIO(path_imgrec, 'r')
            while True:
                s = rec.read()
                if s is None:
                    break
                header, blob = unpack(s)
                self._items.append((float(np.atleast_1d(header.label)[0]),
                                    blob))
        else:
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split('\t')
                    if len(parts) < 3:
                        continue
                    label = float(parts[1])
                    path = os.path.join(path_root, parts[-1])
                    with open(path, 'rb') as imf:
                        self._items.append((label, imf.read()))
        self.reset()

    @property
    def provide_data(self):
        return [(self.data_name, (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [(self.label_name, (self.batch_size,))]

    def reset(self):
        self._order = list(range(len(self._items)))
        if self.shuffle:
            random.shuffle(self._order)
        self._cursor = 0

    def __iter__(self):
        return self

    def next(self):
        from .io import DataBatch
        if self._cursor >= len(self._order):
            raise StopIteration
        with instrument.span('io.next', cat='io'):
            c, h, w = self.data_shape
            data = np.zeros((self.batch_size, c, h, w), np.float32)
            label = np.zeros((self.batch_size,), np.float32)
            pad = 0
            for i in range(self.batch_size):
                if self._cursor >= len(self._order):
                    pad += 1
                    continue
                lab, blob = self._items[self._order[self._cursor]]
                self._cursor += 1
                img = imdecode(blob)
                for aug in self.auglist:
                    img = aug(img)
                arr = img.asnumpy()
                data[i] = np.transpose(arr, (2, 0, 1))
                label[i] = lab
            batch = DataBatch([nd.array(data)], [nd.array(label)],
                              pad=pad)
            if self._counts_io_batches:
                instrument.inc('io.batches')
                _iowatch.note_batch(batch)
            return batch

    __next__ = next
