"""RecordIO python API — the port of ``mxnet_tpu/recordio.py`` (reference
``python/mxnet/recordio.py`` over ``MXRecordIO*`` C calls,
``c_api.cc:720-805``), backed by the native reader and writer of
``csrc/host/recordio.cc``.  The record format is the JAX package's byte
for byte, so a ``.rec``/``.idx`` pair written by either package reads in
the other.

``pack_img`` encodes JPEG with the IO library's own baseline encoder
(4:2:0, the IJG quality tables) and ``unpack_img`` decodes it with its
decoder, which gives libjpeg's pixels; the JAX package calls PIL for
both (``mxnet_tpu/recordio.py:187-208``).  PNG is written and read here
in Python over ``zlib``.  Neither needs PIL.
"""
from __future__ import annotations

import ctypes
import os
import struct
import zlib
from collections import namedtuple

import numpy as np

from . import fs
from . import iowatch as _iowatch
from ._native import recordio_lib as lib
from .base import MXNetError

__all__ = ['MXRecordIO', 'MXIndexedRecordIO', 'IRHeader', 'pack', 'unpack',
           'pack_img', 'unpack_img', 'jpeg_encode', 'jpeg_decode']


class MXRecordIO(object):
    """Sequential RecordIO reader/writer (reference recordio.py:15)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.writable = None
        self.open()

    def open(self):
        L = lib()
        # remote URIs (s3://, hdfs://, ...) stage through the local fs
        # cache: download-on-read, spool-and-upload-on-close — the
        # dmlc-core URI stream role (see fs.py)
        self._spool = None
        if self.flag == 'w':
            path = self.uri
            if fs.is_remote(self.uri):
                self._spool = fs.SpooledWriter(self.uri)
                path = self._spool.local
            self.handle = L.MXTPUTorchRecordIOWriterCreate(path.encode())
            self.writable = True
        elif self.flag == 'r':
            path = fs.localize(self.uri)
            self.handle = L.MXTPUTorchRecordIOReaderCreate(path.encode())
            self.writable = False
        else:
            raise ValueError('Invalid flag %s' % self.flag)
        if not self.handle:
            raise IOError('cannot open %s' % self.uri)
        self.is_open = True

    def __del__(self):
        self.close()

    def close(self):
        if getattr(self, 'is_open', False) and self.handle:
            L = lib()
            if self.writable:
                L.MXTPUTorchRecordIOWriterFree(self.handle)
            else:
                L.MXTPUTorchRecordIOReaderFree(self.handle)
            self.handle = None
            self.is_open = False
            if getattr(self, '_spool', None) is not None:
                self._spool.upload_and_close()
                self._spool = None

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        ret = lib().MXTPUTorchRecordIOWriterWrite(self.handle, buf, len(buf))
        if ret != 0:
            raise IOError('write failed')

    def tell(self):
        L = lib()
        if self.writable:
            return L.MXTPUTorchRecordIOWriterTell(self.handle)
        return L.MXTPUTorchRecordIOReaderTell(self.handle)

    def read(self):
        assert not self.writable
        # pipeline 'read' stage (iowatch.stage.read histogram): the raw
        # record fetch off storage — one flag check when the plane is off
        with _iowatch.stage('read'):
            size = ctypes.c_size_t()
            ptr = lib().MXTPUTorchRecordIOReaderNext(self.handle,
                                                     ctypes.byref(size))
            if not ptr:
                return None
            return ctypes.string_at(ptr, size.value)

    def seek(self, pos):
        assert not self.writable
        lib().MXTPUTorchRecordIOReaderSeek(self.handle, pos)


class MXIndexedRecordIO(MXRecordIO):
    """Indexed RecordIO with a .idx sidecar (reference recordio.py:74)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable:
            idx_path = self.idx_path
            if fs.is_remote(idx_path):
                try:
                    idx_path = fs.localize(idx_path)
                except (FileNotFoundError, IOError, OSError):
                    # missing sidecar tolerated, same as a local path
                    idx_path = ''
            if idx_path and os.path.isfile(idx_path):
                with open(idx_path) as fin:
                    for line in fin.readlines():
                        line = line.strip().split('\t')
                        key = self.key_type(line[0])
                        self.idx[key] = int(line[1])
                        self.keys.append(key)

    def close(self):
        if getattr(self, 'is_open', False) and self.writable:
            self.save_index()
        super().close()

    def save_index(self):
        with fs.open_uri(self.idx_path, 'w') as fout:
            for k in self.keys:
                fout.write('%s\t%d\n' % (str(k), self.idx[k]))

    def read_idx(self, idx):
        pos = self.idx[idx]
        self.seek(pos)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple('HEADER', ['flag', 'label', 'id', 'id2'])
_IR_FORMAT = 'IfQQ'
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack an image record (reference recordio.py:135 /
    src/io/image_recordio.h header layout)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        header = header._replace(flag=0)
        packed = struct.pack(_IR_FORMAT, header.flag, header.label,
                             header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        packed = struct.pack(_IR_FORMAT, header.flag, header.label,
                             header.id, header.id2) + label.tobytes()
    return packed + s


def unpack(s):
    """(reference recordio.py:150)"""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


# -- JPEG through the IO library --------------------------------------------

_ERR_LEN = 256


def jpeg_encode(img, quality=95):
    """JPEG bytes of an ``(H, W, 3)`` RGB or ``(H, W)`` gray uint8 image:
    baseline, 4:2:0, the IJG tables scaled to ``quality``."""
    img = np.ascontiguousarray(np.asarray(img, dtype=np.uint8))
    if img.ndim == 3 and img.shape[2] == 1:
        img = np.ascontiguousarray(img[:, :, 0])
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise MXNetError('JPEG encode takes (H, W) or (H, W, 3) images, '
                         'not %s' % (img.shape,))
    comps = 1 if img.ndim == 2 else 3
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_LEN)
    L = lib()
    if L.MXTPUTorchJpegEncode(img.ctypes.data, img.shape[1], img.shape[0],
                              comps, int(quality), ctypes.byref(out),
                              ctypes.byref(size), err, _ERR_LEN):
        raise MXNetError('JPEG encode: %s' % err.value.decode())
    try:
        return ctypes.string_at(out, size.value)
    finally:
        L.MXTPUTorchJpegFree(out)


def jpeg_decode(buf, gray=None):
    """Decode JPEG bytes: ``(H, W, 3)`` RGB, or ``(H, W)`` when the file
    has one component (``gray`` forces either).  Raises for a file the
    baseline codec does not take (progressive, say) and for corrupt data."""
    buf = bytes(buf)
    L = lib()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if L.MXTPUTorchJpegInfo(buf, len(buf), ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(c), err, _ERR_LEN):
        raise MXNetError('JPEG decode: %s' % err.value.decode())
    one = c.value == 1 if gray is None else bool(gray)
    out = np.empty((h.value, w.value) + (() if one else (3,)), np.uint8)
    if L.MXTPUTorchJpegDecode(buf, len(buf), 1 if one else 3,
                              out.ctypes.data, out.size, err, _ERR_LEN):
        raise MXNetError('JPEG decode: %s' % err.value.decode())
    return out


# -- PNG over zlib ----------------------------------------------------------

_PNG_SIG = b'\x89PNG\r\n\x1a\n'


def _png_chunk(kind, data):
    return struct.pack('>I', len(data)) + kind + data + \
        struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff)


def _png_encode(img):
    img = np.ascontiguousarray(np.asarray(img, dtype=np.uint8))
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    h, w = img.shape[:2]
    color = {2: 0, 3: {3: 2, 4: 6}.get(img.shape[-1])}.get(img.ndim)
    if color is None:
        raise MXNetError('PNG encode takes gray, RGB or RGBA images')
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (_PNG_SIG
            + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color,
                                              0, 0, 0))
            + _png_chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b'IEND', b''))


def _png_decode(buf):
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        n, = struct.unpack('>I', buf[pos:pos + 4])
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', data)
        elif kind == b'IDAT':
            idat.append(data)
        elif kind == b'IEND':
            break
    w, h, depth, color, _, _, interlace = hdr
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if depth != 8 or bpp is None or interlace:
        raise MXNetError('PNG decode takes 8-bit non-interlaced gray, '
                         'gray+alpha, RGB or RGBA files')
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8) \
        .reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 1:                                  # Sub
            line = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1)
        elif f == 2:                                # Up
            line = line + prev
        elif f in (3, 4):                           # Average, Paeth
            cur = line.copy()
            for i in range(w * bpp):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if f == 3:
                    cur[i] = (cur[i] + (a + b) // 2) & 255
                    continue
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 255
            line = cur
        line = line & 255
        out[y] = line
        prev = line
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def unpack_img(s, iscolor=-1):
    """Unpack to (header, image array): ``(H, W, 3)`` RGB, or ``(H, W)``
    for a gray file, as the JAX package's PIL path gives."""
    header, s = unpack(s)
    if s[:8] == _PNG_SIG:
        return header, _png_decode(s)
    return header, jpeg_decode(s)


def pack_img(header, img, quality=95, img_fmt='.jpg'):
    """(reference recordio.py:185)"""
    if img_fmt in ('.jpg', '.jpeg'):
        return pack(header, jpeg_encode(img, quality))
    return pack(header, _png_encode(img))
