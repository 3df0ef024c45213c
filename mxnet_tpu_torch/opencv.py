"""OpenCV plugin surface — the port of ``mxnet_tpu/opencv.py`` (reference
``plugin/opencv/opencv.py`` over ``plugin/opencv/cv_api.cc``).

Same function names and NDArray-in/NDArray-out contracts as the
reference plugin; the backing decode is the framework's own stack (PIL
container parsing via :mod:`image`), ``resize`` is the JAX package's
``jax.image.resize`` (half-pixel centres, a triangle or Keys cubic
kernel widened when downsampling, the weights normalised per output
sample) written out in torch, and the padding is numpy's — there is no
OpenCV dependency.  The reference plugin's images are BGR (cv2
default); this keeps that convention for parity.
"""
from __future__ import annotations

import random as _random

import numpy as np
import torch

from . import image as _image
from . import instrument
from . import iowatch as _iowatch
from . import ndarray as nd
from .io import DataBatch, DataIter
from .ndarray import NDArray

# cv2 constants accepted for API compatibility
INTER_NEAREST = 0
INTER_LINEAR = 1
INTER_CUBIC = 2
BORDER_CONSTANT = 0
BORDER_REPLICATE = 1


def imdecode(str_img, flag=1):
    """Decode an image byte buffer to an HWC uint8 NDArray in BGR
    channel order (the cv2.imdecode contract)."""
    return _image.imdecode(str_img, to_rgb=False, flag=flag)


def _weights(m, n, kernel):
    """``jax.image.resize``'s (m, n) weight matrix for one dimension
    (``compute_weight_mat``, antialiased, float32)."""
    scale = torch.tensor(n / m, dtype=torch.float32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(m, dtype=torch.float32)[:, None]) \
        .abs() / kernel_scale
    if kernel == 'cubic':       # Keys, a = -0.5
        w = ((1.5 * x - 2.5) * x) * x + 1.0
        w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
        w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    else:                       # triangle
        w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_hw(x, h, w, method):
    """``x`` (H, W, ...) resized to (h, w, ...) as ``jax.image.resize``."""
    if method == 'nearest':
        for d, n in ((0, h), (1, w)):
            m = x.shape[d]
            if m == n:
                continue
            off = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                              * m / n).long()
            x = x.index_select(d, off)
        return x
    x = x.to(torch.float32)
    if x.shape[0] != h:
        x = torch.tensordot(_weights(x.shape[0], h, method), x,
                            dims=([0], [0]))
    if x.shape[1] != w:
        x = torch.tensordot(_weights(x.shape[1], w, method), x,
                            dims=([0], [1])).movedim(0, 1)
    return x


def resize(src, size, interpolation=INTER_LINEAR):
    """Resize to ``size=(w, h)`` (cv2.resize argument order)."""
    with _iowatch.stage('augment'):
        w, h = int(size[0]), int(size[1])
        x = src.handle if isinstance(src, NDArray) else \
            torch.as_tensor(np.asarray(src))
        method = {INTER_NEAREST: 'nearest', INTER_LINEAR: 'linear',
                  INTER_CUBIC: 'cubic'}.get(int(interpolation), 'linear')
        out = _resize_hw(x, h, w, method).to(torch.float32)
        return nd.NDArray(torch.clamp(torch.round(out), 0, 255)
                          .to(x.dtype))


def copyMakeBorder(src, top, bot, left, right,
                   border_type=BORDER_CONSTANT, value=0):
    """Pad an HWC image (cv2.copyMakeBorder)."""
    with _iowatch.stage('augment'):
        x = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
        pads = ((int(top), int(bot)), (int(left), int(right)), (0, 0))
        if border_type == BORDER_REPLICATE:
            out = np.pad(x, pads, mode='edge')
        else:
            out = np.pad(x, pads, mode='constant', constant_values=value)
        return nd.array(out, dtype=out.dtype)


def scale_down(src_size, size):
    """Scale ``size`` down to fit in ``src_size`` preserving aspect
    (reference plugin/opencv/opencv.py:80)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def fixed_crop(src, x0, y0, w, h, size=None,
               interpolation=INTER_CUBIC):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = resize(out, size, interpolation)
    return out


def random_crop(src, size):
    """Random crop with aspect-preserving scale-down; returns
    (cropped, (x0, y0, w, h))."""
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = scale_down((w, h), size)
    x0 = _random.randint(0, w - new_w)
    y0 = _random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std):
    src = src - mean
    if std is not None:
        src = src / std
    return src


def random_size_crop(src, size, min_area=0.25, ratio=(3.0 / 4.0,
                                                      4.0 / 3.0)):
    """Random area+aspect crop (the Inception-style crop)."""
    h, w = src.shape[0], src.shape[1]
    area = w * h
    for _ in range(10):
        new_area = _random.uniform(min_area, 1.0) * area
        new_ratio = _random.uniform(*ratio)
        new_w = int(round((new_area * new_ratio) ** 0.5))
        new_h = int(round((new_area / new_ratio) ** 0.5))
        if _random.random() < 0.5:
            new_w, new_h = new_h, new_w
        if new_w <= w and new_h <= h:
            x0 = _random.randint(0, w - new_w)
            y0 = _random.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size)
            return out, (x0, y0, new_w, new_h)
    return random_crop(src, size)


class ImageListIter(DataIter):
    """Iterator over a file list using the plugin decode path
    (reference plugin/opencv/opencv.py:138)."""

    def __init__(self, root, flist, batch_size, size, mean=None):
        super().__init__()
        self.root = root
        with open(flist) as f:
            self.list = [line.strip() for line in f if line.strip()]
        self.cur = 0
        self.batch_size = batch_size
        self.size = size
        self.mean = nd.array(mean) if mean is not None else None

    @property
    def provide_data(self):
        return [('data', (self.batch_size, 3, self.size[1],
                          self.size[0]))]

    @property
    def provide_label(self):
        return []

    def reset(self):
        self.cur = 0

    def next(self):
        if self.cur >= len(self.list):
            raise StopIteration
        with instrument.span('io.next', cat='io'):
            batch = np.zeros((self.batch_size, self.size[1],
                              self.size[0], 3), np.float32)
            end = min(len(self.list), self.cur + self.batch_size)
            for i in range(self.cur, end):
                path = self.list[i]
                if not path.endswith(('.jpg', '.jpeg', '.png')):
                    path += '.jpg'
                with open(self.root + path, 'rb') as f:
                    img = imdecode(f.read(), 1)
                img, _ = random_crop(img, self.size)
                arr = img.asnumpy().astype(np.float32)
                if self.mean is not None:
                    arr = arr - self.mean.asnumpy()
                batch[i - self.cur] = arr
            pad = self.batch_size - (end - self.cur)
            self.cur = end
            data = nd.array(batch.transpose(0, 3, 1, 2))
            out = DataBatch([data], [], pad=pad)
            if self._counts_io_batches:
                instrument.inc('io.batches')
                _iowatch.note_batch(out)
            return out
