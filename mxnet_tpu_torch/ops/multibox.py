"""SSD MultiBox operators — the port of ``mxnet_tpu/ops/multibox.py``
(reference ``example/ssd/operator/multibox_{prior,target,detection}``):
anchor generation, target assignment and detection.

All three are fixed-shape and sync-free (no ``.item()``, no
``nonzero``, no boolean-mask indexing), so an SSD forward or training
step can be captured in a CUDA graph.  The JAX ops ``vmap`` over the
batch; here the batch is a leading dimension.  The sequential parts run
as loops of fixed length: MultiBoxTarget's bipartite matching over the
label slots (the JAX ``fori_loop``), and MultiBoxDetection's greedy NMS,
which on the card is a hand-written CUDA kernel in two phases
(:func:`multibox_nms`, ``csrc/multibox_nms.cu``: IoU bitmasks over the
whole card, then a blocked scan per image; the JAX op's
``fori_loop(0, num_anchors, nms_step, rows)`` at
``mxnet_tpu/ops/multibox.py:279`` would be ~12 launches per anchor
here).  Its plain version, the JAX loop transcribed, runs on CPU tensors
and is what the tests and ``chip_smoke.py`` hold the kernel against;
:func:`nms_masks_plain` and :func:`nms_scan_plain` transcribe the
kernel's two phases, the oracle of each.

As in the reference the outputs carry no gradient, and MultiBoxTarget
stores the evident intent of the upstream threshold stage (a float
argmax) and clamps the negative count up to
``minimum_negative_samples`` then down to the anchors available (the
upstream GPU kernel's order).  MultiBoxDetection computes in float32
and returns its input's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..instrument import count_launch as _count
from . import _kernels
from .registry import register, register_simple

__all__ = ['multibox_prior', 'multibox_nms', 'multibox_nms_plain',
           'nms_masks_plain', 'nms_scan_plain']

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------

def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False):
    """(1, H*W*(num_sizes-1+num_ratios), 4) anchors in [0, 1] coords: per
    cell (row-major) one box per size at ratio 1, then ``ratios[1:]`` at
    ``sizes[0]`` (``mxnet_tpu/ops/multibox.py:36``)."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    sizes = [float(s) for s in np.atleast_1d(np.asarray(sizes, np.float64))]
    ratios = [float(r) for r in np.atleast_1d(np.asarray(ratios,
                                                         np.float64))]
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    centers_y, centers_x = torch.meshgrid(cy, cx, indexing='ij')
    half = [(s / 2.0, s / 2.0) for s in sizes]
    for r in ratios[1:]:
        sq = float(np.sqrt(r))
        half.append((sizes[0] * sq / 2.0, sizes[0] / sq / 2.0))
    # fills on the device from Python scalars: a host-to-device copy
    # (torch.tensor, or indexed assignment) cannot run inside a CUDA
    # graph capture

    def fill(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    hw = torch.stack([torch.stack([fill(hx), fill(hy)])
                      for hx, hy in half])                    # [K, 2]
    cxy = torch.stack([centers_x, centers_y], -1)[:, :, None, :]
    out = torch.cat([cxy - hw[None, None], cxy + hw[None, None]],
                    -1).reshape(1, -1, 4)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out.detach()


register_simple('MultiBoxPrior', multibox_prior,
                attr_defaults={'sizes': (1.0,), 'ratios': (1.0,),
                               'clip': False})


# ---------------------------------------------------------------------------
# shared geometry
# ---------------------------------------------------------------------------

def _iou_matrix(a, b):
    """IoU between anchors a [A, 4] and boxes b [B, L, 4] -> [B, A, L];
    0 where the union is not positive."""
    lt = torch.maximum(a[None, :, None, :2], b[:, None, :, :2])
    rb = torch.minimum(a[None, :, None, 2:], b[:, None, :, 2:])
    inter = torch.prod(torch.clamp_min(rb - lt, 0.0), -1)
    area_a = torch.prod(a[:, 2:] - a[:, :2], -1)
    area_b = torch.prod(b[..., 2:] - b[..., :2], -1)
    union = area_a[None, :, None] + area_b[:, None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def _centre_size(boxes):
    return ((boxes[..., 2] - boxes[..., 0]), (boxes[..., 3] - boxes[..., 1]),
            (boxes[..., 0] + boxes[..., 2]) * 0.5,
            (boxes[..., 1] + boxes[..., 3]) * 0.5)


def _encode_loc(anchors, gt, variances):
    """Anchor-relative (dx, dy, dlog w, dlog h) / variance; anchors
    [A, 4], gt [B, A, 4] -> [B, A, 4]."""
    vx, vy, vw, vh = variances
    aw, ah, ax, ay = _centre_size(anchors)
    gw, gh, gx, gy = _centre_size(gt)

    def safe(x):
        return torch.where(x > 0, x, 1.0)

    return torch.stack([(gx - ax) / safe(aw) / vx,
                        (gy - ay) / safe(ah) / vy,
                        torch.log(safe(gw) / safe(aw)) / vw,
                        torch.log(safe(gh) / safe(ah)) / vh], dim=-1)


def _decode_loc(anchors, loc_pred, variances, clip):
    """The inverse transform; anchors [A, 4], loc_pred [B, A, 4]."""
    vx, vy, vw, vh = variances
    aw, ah, ax, ay = _centre_size(anchors)
    ox = loc_pred[..., 0] * vx * aw + ax
    oy = loc_pred[..., 1] * vy * ah + ay
    ow = torch.exp(loc_pred[..., 2] * vw) * aw * 0.5
    oh = torch.exp(loc_pred[..., 3] * vh) * ah * 0.5
    box = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    return torch.clamp(box, 0.0, 1.0) if clip else box


def _variances(attrs):
    return tuple(float(v) for v in attrs.get('variances',
                                             (0.1, 0.1, 0.2, 0.2)))


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------

def _multibox_target(anchors, label, cls_pred, *, overlap_threshold,
                     ignore_label, negative_mining_ratio,
                     negative_mining_thresh, minimum_negative_samples,
                     variances):
    """``_target_one`` (``mxnet_tpu/ops/multibox.py:167``) over a batch:
    anchors [A, 4], label [B, L, 5+], cls_pred [B, C, A] -> (cls_target
    [B, A], loc_raw [B, A, 4], positive [B, A])."""
    b, num_labels = label.shape[0], label.shape[1]
    num_anchors = anchors.shape[0]
    dev = anchors.device
    valid = torch.cumprod((label[:, :, 0] != -1.0).to(torch.int32),
                          dim=1) > 0                             # [B, L]
    any_gt = valid.any(dim=1)
    overlaps = torch.where(valid[:, None, :],
                           _iou_matrix(anchors, label[:, :, 1:5]), -1.0)

    # bipartite matching: each step takes the best remaining pair
    a_matched = torch.zeros((b, num_anchors), dtype=torch.bool, device=dev)
    g_matched = ~valid
    match_gt = torch.full((b, num_anchors), -1, dtype=torch.int64,
                          device=dev)
    match_iou = torch.full((b, num_anchors), -1.0, dtype=overlaps.dtype,
                           device=dev)
    rows = torch.arange(b, device=dev)
    for _ in range(num_labels):
        masked = torch.where(a_matched[:, :, None] | g_matched[:, None, :],
                             NEG_INF, overlaps).reshape(b, -1)
        flat = torch.argmax(masked, dim=1)
        best_a, best_g = flat // num_labels, flat % num_labels
        val = torch.gather(masked, 1, flat[:, None])[:, 0]
        good = val > 1e-6
        a_matched[rows, best_a] = a_matched[rows, best_a] | good
        g_matched[rows, best_g] = g_matched[rows, best_g] | good
        match_gt[rows, best_a] = torch.where(good, best_g,
                                             match_gt[rows, best_a])
        match_iou[rows, best_a] = torch.where(good, val,
                                              match_iou[rows, best_a])

    best_gt = torch.argmax(overlaps, dim=2)
    best_iou = torch.amax(overlaps, dim=2)
    match_gt = torch.where(a_matched, match_gt, best_gt)
    match_iou = torch.where(a_matched, match_iou, best_iou)
    thresh_pos = (~a_matched) & (overlap_threshold > 0) & \
        (best_iou > overlap_threshold) & any_gt[:, None]
    positive = a_matched | thresh_pos
    num_positive = positive.sum(dim=1)

    if negative_mining_ratio > 0:
        prob = torch.softmax(cls_pred.float(), dim=1)
        neg_score = torch.amax(prob[:, 1:], dim=1)               # [B, A]
        cand = (~positive) & (match_iou < negative_mining_thresh) & \
            (match_iou >= 0)
        num_negative = torch.clamp(
            torch.floor(num_positive.float() * negative_mining_ratio)
            .to(torch.int64), min=int(minimum_negative_samples))
        num_negative = torch.minimum(num_negative,
                                     num_anchors - num_positive)
        key = torch.where(cand, neg_score, -float('inf'))
        order = torch.argsort(-key, dim=1, stable=True)
        rank = torch.zeros((b, num_anchors), dtype=torch.int64,
                           device=dev).scatter_(
            1, order, torch.arange(num_anchors, device=dev)
            .expand(b, num_anchors).contiguous())
        negative = cand & (rank < num_negative[:, None])
    else:
        negative = (~positive) & any_gt[:, None]

    matched = torch.gather(label, 1, match_gt[:, :, None].expand(
        b, num_anchors, label.shape[2]))
    cls_target = torch.where(
        positive, matched[:, :, 0] + 1.0,
        torch.where(negative, 0.0, float(ignore_label)))
    loc_raw = _encode_loc(anchors, matched[:, :, 1:5], variances)
    return cls_target, loc_raw, positive


def _multibox_target_apply(attrs, inputs, is_train, rng):
    anchors, label, cls_pred = inputs
    b = label.shape[0]
    if anchors.device.type == 'meta':
        a = anchors.numel() // 4
        return [anchors.new_empty((b, a * 4)), anchors.new_empty((b, a * 4)),
                anchors.new_empty((b, a))], {}
    with torch.no_grad():
        cls_target, loc_raw, positive = _multibox_target(
            anchors.reshape(-1, 4), label, cls_pred,
            overlap_threshold=float(attrs.get('overlap_threshold', 0.5)),
            ignore_label=float(attrs.get('ignore_label', -1.0)),
            negative_mining_ratio=float(
                attrs.get('negative_mining_ratio', -1.0)),
            negative_mining_thresh=float(
                attrs.get('negative_mining_thresh', 0.5)),
            minimum_negative_samples=int(
                attrs.get('minimum_negative_samples', 0)),
            variances=_variances(attrs))
        loc_mask = positive[:, :, None].expand(positive.shape + (4,)) \
            .to(anchors.dtype).reshape(b, -1)
        loc_target = torch.where(positive[:, :, None], loc_raw,
                                 0.0).reshape(b, -1)
    return [loc_target.to(anchors.dtype), loc_mask,
            cls_target.to(anchors.dtype)], {}


register('MultiBoxTarget', _multibox_target_apply,
         input_names=lambda attrs: ['anchor', 'label', 'cls_pred'],
         num_outputs=lambda attrs: 3,
         output_names=lambda attrs: ['loc_target', 'loc_mask', 'cls_target'],
         attr_defaults={'overlap_threshold': 0.5, 'ignore_label': -1.0,
                        'negative_mining_ratio': -1.0,
                        'negative_mining_thresh': 0.5,
                        'minimum_negative_samples': 0,
                        'variances': (0.1, 0.1, 0.2, 0.2)})


# ---------------------------------------------------------------------------
# the greedy NMS of MultiBoxDetection: kernel and plain version
# ---------------------------------------------------------------------------

def multibox_nms_plain(rows, nms_threshold, force_suppress):
    """The JAX op's suppression loop (``mxnet_tpu/ops/multibox.py:
    260-279``) over rows [B, A, 6] of (class_id, score, xmin, ymin, xmax,
    ymax), already ordered by descending score: for each row i in turn,
    if it is still alive (class id >= 0), every later live row of the
    same class (any class under ``force_suppress``) whose IoU with it is
    at least ``nms_threshold`` gets class id -1 (score and coordinates
    kept).  Returns a new tensor."""
    rows = rows.clone()
    num_anchors = rows.shape[1]
    later_than = torch.arange(num_anchors, device=rows.device)
    for i in range(num_anchors):
        row = rows[:, i]                                           # [B, 6]
        cls = rows[:, :, 0]
        alive = row[:, 0] >= 0
        same = cls == row[:, None, 0]
        if force_suppress:
            same = torch.ones_like(same)
        lt = torch.maximum(rows[:, :, 2:4], row[:, None, 2:4])
        rb = torch.minimum(rows[:, :, 4:6], row[:, None, 4:6])
        inter = torch.prod(torch.clamp_min(rb - lt, 0.0), -1)
        union = (torch.prod(rows[:, :, 4:6] - rows[:, :, 2:4], -1)
                 + torch.prod(row[:, 4:6] - row[:, 2:4], -1)[:, None]
                 - inter)
        pos = union > 0
        iou = torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)
        suppress = alive[:, None] & (later_than > i) & same & (cls >= 0) \
            & (iou >= nms_threshold)
        rows[:, :, 0] = torch.where(suppress, -1.0, cls)
    return rows


# the kernel's row blocks: 64 rows, a 64-bit word of mask bits each
NMS_BLOCK = 64
# the scan's two shared-memory bitmaps hold 908 words (7.3 KB each)
NMS_MAX_ANCHORS = 908 * NMS_BLOCK
# phase A's grid has the images in its y dimension
NMS_MAX_IMAGES = 65535
# bit k of a word as an int64 (bit 63 is the sign): a sum of distinct
# weights packs bits into a word without overflow
_BIT_WEIGHTS = [1 << k for k in range(63)] + [-(1 << 63)]


def nms_words(num_anchors):
    """Words a row of the kernel's masks: ceil(anchors / 64)."""
    return -(-num_anchors // NMS_BLOCK)


def nms_workspace_shape(batch, num_anchors):
    """The kernel's workspace, int64 words: per image the mask rows, the
    valid words, then 64 rows' worth holding the diagonal words a row
    block at a time (:func:`nms_masks_plain`)."""
    return (batch, num_anchors + 1 + NMS_BLOCK, nms_words(num_anchors))


def nms_masks_plain(rows, nms_threshold, force_suppress):
    """Phase A of ``csrc/multibox_nms.cu`` transcribed, over rows [B, A, 6]
    as :func:`multibox_nms_plain` takes them: the int64 words of the
    kernel's workspace, [B, A + 65, W], W = ceil(A / 64).  Bit k of word
    [b, i, cb] says that row i would suppress row j = 64 cb + k: j > i,
    both rows valid at the start (class id >= 0), the same class at the
    start (any class under ``force_suppress``) and IoU(i, j) >=
    ``nms_threshold``, the IoU computed as :func:`multibox_nms_plain`
    computes it.  Row A holds the valid words (bit k of word w: row 64 w
    + k is valid); rows A + 1 on, read as one flat run, the diagonal
    words [i, i // 64] in row order.  The words the kernel leaves
    unwritten (those of a row block with no valid row) have no bit set
    here."""
    b, a = rows.shape[:2]
    w = nms_words(a)
    dev = rows.device
    cls = rows[:, :, 0]
    valid = cls >= 0
    key = torch.where(valid, 0.0, -1.0) if force_suppress else cls
    area = torch.prod(rows[:, :, 4:6] - rows[:, :, 2:4], -1)
    col = torch.arange(a, device=dev)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int64, device=dev)

    def pack(bits):                      # [..., A] bool -> [..., W] int64
        full = torch.zeros(bits.shape[:-1] + (w * NMS_BLOCK,),
                           dtype=torch.int64, device=dev)
        full[..., :a] = bits.to(torch.int64)
        return (full.reshape(bits.shape[:-1] + (w, NMS_BLOCK))
                * weights).sum(-1)

    out = torch.zeros(nms_workspace_shape(b, a), dtype=torch.int64,
                      device=dev)
    for r0 in range(0, a, NMS_BLOCK):
        r1 = min(r0 + NMS_BLOCK, a)
        row = rows[:, r0:r1, None]                              # [B, n, 1, 6]
        lt = torch.maximum(rows[:, None, :, 2:4], row[..., 2:4])
        rb = torch.minimum(rows[:, None, :, 4:6], row[..., 4:6])
        inter = torch.prod(torch.clamp_min(rb - lt, 0.0), -1)   # [B, n, A]
        union = area[:, None, :] + area[:, r0:r1, None] - inter
        pos = union > 0
        iou = torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)
        bits = valid[:, r0:r1, None] & valid[:, None, :] \
            & (key[:, r0:r1, None] == key[:, None, :]) \
            & (col > col[r0:r1, None]) & (iou >= nms_threshold)
        out[:, r0:r1] = pack(bits)
    out[:, a] = pack(valid)
    diag = torch.zeros((b, w * NMS_BLOCK), dtype=torch.int64, device=dev)
    diag[:, :a] = out[:, col, col // NMS_BLOCK]
    out[:, a + 1:] = diag.reshape(b, NMS_BLOCK, w)
    return out


def nms_scan_plain(rows, masks):
    """Phase B of ``csrc/multibox_nms.cu`` transcribed: the blocked greedy
    scan over the words of :func:`nms_masks_plain` (or of the kernel's
    phase A).  For each row block in order, its valid rows not yet removed
    are resolved one by one (a kept row removes the later rows of its
    diagonal word; the kernel resolves them in rounds, to the same rows),
    then every kept row's words are ORed into the removed bitmap of the
    later row blocks.  Returns new rows whose removed valid
    rows have class id -1, as :func:`multibox_nms_plain` does."""
    b, a = rows.shape[:2]
    words = masks.cpu().numpy().view(np.uint64)                 # [B, A+65, W]
    w = words.shape[2]
    drop = np.zeros((b, w * NMS_BLOCK), bool)
    for img in range(b):
        m = words[img]
        removed = np.zeros(w, np.uint64)
        for rb in range(w):
            valid = int(m[a, rb])
            cand = valid & ~int(removed[rb])
            kept = 0
            while cand:
                k = (cand & -cand).bit_length() - 1
                kept |= 1 << k
                cand &= ~(int(m[rb * NMS_BLOCK + k, rb]) | (1 << k))
            if kept and rb + 1 < w:
                ks = [rb * NMS_BLOCK + k for k in range(NMS_BLOCK)
                      if kept >> k & 1]
                removed[rb + 1:] |= np.bitwise_or.reduce(m[ks, rb + 1:],
                                                         axis=0)
            gone = valid & ~kept
            drop[img, rb * NMS_BLOCK:(rb + 1) * NMS_BLOCK] = \
                [gone >> k & 1 for k in range(NMS_BLOCK)]
    drop = torch.from_numpy(drop[:, :a]).to(rows.device)
    out = rows.clone()
    out[:, :, 0] = torch.where(drop, -1.0, rows[:, :, 0])
    return out


def _check_rows(rows, name):
    if not isinstance(rows, torch.Tensor) or rows.ndim != 3 or \
            rows.shape[2] != 6:
        raise ValueError('%s: rows must be a (batch, anchors, 6) tensor'
                         % name)
    if rows.dtype != torch.float32:
        raise TypeError('%s: rows must be float32, got %s'
                        % (name, rows.dtype))
    if not rows.is_contiguous():
        raise ValueError('%s: rows must be contiguous' % name)
    if rows.device.type == 'cuda' and (
            rows.shape[1] > NMS_MAX_ANCHORS or
            rows.shape[0] > NMS_MAX_IMAGES):
        raise ValueError('%s: %d images of %d anchors; the kernel holds at '
                         'most %d images of %d' % (
                             name, rows.shape[0], rows.shape[1],
                             NMS_MAX_IMAGES, NMS_MAX_ANCHORS))
    if rows.device.type not in ('cuda', 'cpu', 'meta'):
        raise MXNetError('%s: unsupported device %s' % (name, rows.device))


def _nms_launch(rows, nms_threshold, force_suppress, ws=None):
    """Launch the kernel's two phases on card rows into new rows, with
    workspace ``ws`` (an uninitialised one if None; the check of phase A
    passes a zeroed one, so the words phase A leaves unwritten read 0).
    Returns (out, ws)."""
    b, a = rows.shape[:2]
    out = torch.empty_like(rows)
    if ws is None:
        # from the graph's pool under capture; phase A writes every word
        # phase B reads
        ws = torch.empty(nms_workspace_shape(b, a), dtype=torch.int64,
                         device=rows.device)
    if rows.numel() == 0:
        return out, ws
    fn = _kernels.load('multibox_nms')
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(), out.data_ptr(), ws.data_ptr(), b, a,
                 float(nms_threshold), int(bool(force_suppress)), stream)
    if err:
        raise MXNetError('multibox_nms: kernel launch failed: %s (CUDA '
                         'error %d)' % (_kernels.error_string(
                             'multibox_nms', err), err))
    _count(multibox_nms)
    return out, ws


def multibox_nms(rows, nms_threshold, force_suppress):
    """Greedy NMS over score-ordered detection rows [B, A, 6] (float32,
    contiguous); returns new rows whose suppressed entries have class id
    -1.  A CUDA tensor runs ``csrc/multibox_nms.cu`` (two kernels: the
    IoU masks over the card, then one scan block per image;
    ``multibox_nms.launches`` counts one a call), a CPU tensor
    :func:`multibox_nms_plain`."""
    _check_rows(rows, 'multibox_nms')
    if rows.device.type == 'cuda':
        return _nms_launch(rows, nms_threshold, force_suppress)[0]
    if rows.device.type == 'meta':
        return rows.clone()
    return multibox_nms_plain(rows, nms_threshold, force_suppress)


multibox_nms.launches = 0


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------

def detection_rows(cls_prob, loc_pred, anchors, threshold, clip,
                   variances):
    """The rows NMS runs over: cls_prob [B, C, A], loc_pred [B, A*4],
    anchors [A, 4] -> [B, A, 6] of (class_id, score, box), invalid rows
    (score below ``threshold``) -1, ordered by descending score with
    ties in anchor order and invalid rows last (``_detect_one``,
    ``mxnet_tpu/ops/multibox.py:239-256``)."""
    b = cls_prob.shape[0]
    score = torch.amax(cls_prob[:, 1:], dim=1)                   # [B, A]
    cls_id = torch.argmax(cls_prob[:, 1:], dim=1).to(torch.float32)
    valid = score >= threshold
    boxes = _decode_loc(anchors, loc_pred.reshape(b, -1, 4), variances,
                        clip)
    rows = torch.cat([torch.where(valid, cls_id, -1.0)[..., None],
                      torch.where(valid, score, -1.0)[..., None],
                      torch.where(valid[..., None], boxes, -1.0)], dim=-1)
    order = torch.argsort(-torch.where(valid, score, -float('inf')),
                          dim=1, stable=True)
    return torch.gather(rows, 1, order[..., None].expand(rows.shape))


def _multibox_detection_apply(attrs, inputs, is_train, rng):
    cls_prob, loc_pred, anchors = inputs
    b, a = cls_prob.shape[0], cls_prob.shape[2]
    if cls_prob.device.type == 'meta':
        return [cls_prob.new_empty((b, a, 6))], {}
    nms_threshold = float(attrs.get('nms_threshold', 0.5))
    with torch.no_grad():
        rows = detection_rows(cls_prob.float(), loc_pred.float(),
                              anchors.reshape(-1, 4).float(),
                              float(attrs.get('threshold', 0.01)),
                              bool(attrs.get('clip', True)),
                              _variances(attrs))
        if 0 < nms_threshold <= 1:
            rows = multibox_nms(rows, nms_threshold,
                                bool(attrs.get('force_suppress', False)))
    return [rows.to(cls_prob.dtype)], {}


register('MultiBoxDetection', _multibox_detection_apply,
         input_names=lambda attrs: ['cls_prob', 'loc_pred', 'anchor'],
         num_outputs=lambda attrs: 1,
         attr_defaults={'clip': True, 'threshold': 0.01,
                        'nms_threshold': 0.5, 'force_suppress': False,
                        'variances': (0.1, 0.1, 0.2, 0.2)})
