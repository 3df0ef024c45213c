"""Vision extras — the port of ``mxnet_tpu/ops/vision.py:21-275``:
GridGenerator, BilinearSampler, SpatialTransformer, ROIPooling,
Correlation and IdentityAttachKLSparseReg (reference
``src/operator/{grid_generator,bilinear_sampler,spatial_transformer,
roi_pooling,correlation,identity_attach_KL_sparse_reg}-inl.h``).

Plain PyTorch, as the JAX ops are plain JAX (no Pallas kernel): gathers,
masked maxima and means.  Gradients come from autograd, as the JAX ops'
come from autodiff; IdentityAttachKLSparseReg keeps the reference's
hand-written backward (a ``torch.autograd.Function`` for its
``custom_vjp``).  ``softmax_cross_entropy`` of the same JAX module lives
in ``ops/nn.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register


def _affine_grid(theta, out_h, out_w):
    """theta (N, 6) -> sampling grid (N, 2, H, W) in [-1, 1] coords, x
    then y (``vision.py:21``)."""
    n = theta.shape[0]
    dev, dt = theta.device, theta.dtype
    ys = torch.linspace(-1.0, 1.0, out_h, device=dev, dtype=dt)
    xs = torch.linspace(-1.0, 1.0, out_w, device=dev, dtype=dt)
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)])    # (3, HW)
    grid = torch.einsum('nij,jk->nik', theta.reshape(n, 2, 3), base)
    return grid.reshape(n, 2, out_h, out_w)


def _bilinear_sample(data, grid):
    """data (N, C, H, W); grid (N, 2, Ho, Wo), x = grid[:, 0], y =
    grid[:, 1] in [-1, 1]; zero outside (``vision.py:35``)."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    flat = data.reshape(n, c, h * w)

    def gather(yy, xx):
        inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        yc = torch.clamp(yy, 0, h - 1).to(torch.int64)
        xc = torch.clamp(xx, 0, w - 1).to(torch.int64)
        idx = (yc * w + xc).reshape(n, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(n, c, idx.shape[-1]))
        vals = vals.reshape((n, c) + tuple(yy.shape[1:]))
        return vals * inside[:, None].to(data.dtype)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    wx = wx[:, None]
    wy = wy[:, None]
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
            v10 * wy * (1 - wx) + v11 * wy * wx)


# ---------------------------------------------------------------------------
# GridGenerator, BilinearSampler, SpatialTransformer
# ---------------------------------------------------------------------------

def _grid_generator_apply(attrs, inputs, is_train, rng):
    data = inputs[0]
    if attrs.get('transform_type', 'affine') == 'affine':
        th, tw = tuple(attrs['target_shape'])
        return [_affine_grid(data.reshape(data.shape[0], 6), th, tw)], {}
    # 'warp': a flow field (N, 2, H, W) in pixels added to the identity
    n, _, h, w = data.shape
    ys = torch.linspace(-1.0, 1.0, h, device=data.device, dtype=data.dtype)
    xs = torch.linspace(-1.0, 1.0, w, device=data.device, dtype=data.dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    flow_x = data[:, 0] * 2.0 / max(w - 1, 1)
    flow_y = data[:, 1] * 2.0 / max(h - 1, 1)
    return [torch.stack([gx[None] + flow_x, gy[None] + flow_y], dim=1)], {}


register('GridGenerator', _grid_generator_apply,
         input_names=lambda attrs: ['data'],
         num_outputs=lambda attrs: 1,
         attr_defaults={'transform_type': 'affine', 'target_shape': (0, 0)},
         hint='gridgenerator')


def _bilinear_sampler_apply(attrs, inputs, is_train, rng):
    data, grid = inputs
    return [_bilinear_sample(data, grid)], {}


register('BilinearSampler', _bilinear_sampler_apply,
         input_names=lambda attrs: ['data', 'grid'],
         num_outputs=lambda attrs: 1,
         hint='bilinearsampler')


def _spatial_transformer_apply(attrs, inputs, is_train, rng):
    data, loc = inputs
    th, tw = tuple(attrs['target_shape'])
    grid = _affine_grid(loc.reshape(loc.shape[0], 6), th, tw)
    return [_bilinear_sample(data, grid)], {}


register('SpatialTransformer', _spatial_transformer_apply,
         input_names=lambda attrs: ['data', 'loc'],
         num_outputs=lambda attrs: 1,
         attr_defaults={'target_shape': (0, 0),
                        'transform_type': 'affine',
                        'sampler_type': 'bilinear'},
         hint='spatialtransformer')


# ---------------------------------------------------------------------------
# ROIPooling: max-pool each scaled ROI to a fixed grid
# ---------------------------------------------------------------------------

def _roi_pooling_apply(attrs, inputs, is_train, rng):
    """``vision.py:133``: bins with float boundaries (floor of the start,
    ceil of the end, at least one pixel).  The maximum over a bin's
    rectangle is taken over its columns, then its rows (the same value
    and, ties apart, the same gradient), one pooled column and row at a
    time, so no (rois, C, ph, pw, H, W) mask is built."""
    data, rois = inputs
    ph, pw = tuple(int(v) for v in attrs['pooled_size'])
    scale = float(attrs['spatial_scale'])
    _, c, h, w = data.shape
    if data.device.type == 'meta':
        return [data.new_empty((rois.shape[0], c, ph, pw))], {}
    dev = data.device
    x1 = torch.round(rois[:, 1] * scale)
    y1 = torch.round(rois[:, 2] * scale)
    x2 = torch.round(rois[:, 3] * scale)
    y2 = torch.round(rois[:, 4] * scale)
    # divided by a tensor: CUDA divides by a Python scalar as a multiply
    # by its reciprocal, which can move a bin edge across a pixel
    roi_h = torch.clamp(y2 - y1 + 1.0, min=1.0)
    roi_w = torch.clamp(x2 - x1 + 1.0, min=1.0)
    bin_h = roi_h / torch.full_like(roi_h, ph)
    bin_w = roi_w / torch.full_like(roi_w, pw)

    def bins(start, size, k, extent):
        i = torch.arange(k, dtype=torch.float32, device=dev)
        lo = torch.floor(start[:, None] + i * size[:, None])
        hi = torch.ceil(start[:, None] + (i + 1) * size[:, None])
        px = torch.arange(extent, dtype=torch.float32, device=dev)
        return (px >= lo[:, :, None]) & \
            (px < torch.maximum(hi, lo + 1)[:, :, None])  # (R, k, extent)

    in_y = bins(y1, bin_h, ph, h)
    in_x = bins(x1, bin_w, pw, w)
    img = data[rois[:, 0].to(torch.int64)]                # (R, C, H, W)
    neg = torch.finfo(data.dtype).min
    cols = [torch.amax(torch.where(in_x[:, None, None, j], img, neg), dim=3)
            for j in range(pw)]
    cols = torch.stack(cols, dim=3)                       # (R, C, H, pw)
    rows = [torch.amax(torch.where(in_y[:, None, i, :, None], cols, neg),
                       dim=2) for i in range(ph)]
    return [torch.stack(rows, dim=2)], {}                 # (R, C, ph, pw)


register('ROIPooling', _roi_pooling_apply,
         input_names=lambda attrs: ['data', 'rois'],
         num_outputs=lambda attrs: 1,
         attr_defaults={'pooled_size': (0, 0), 'spatial_scale': 1.0},
         hint='roipooling')


# ---------------------------------------------------------------------------
# Correlation (FlowNet)
# ---------------------------------------------------------------------------

def _correlation_apply(attrs, inputs, is_train, rng):
    data1, data2 = inputs
    max_disp = int(attrs.get('max_displacement', 1))
    stride2 = int(attrs.get('stride2', 1))
    pad_size = attrs.get('pad_size')
    pad = int(pad_size) if pad_size is not None else max_disp
    is_mult = bool(attrs.get('is_multiply', True))
    _, _, h, w = data1.shape
    d2p = F.pad(data2, (pad, pad, pad, pad))
    outs = []
    offsets = range(-max_disp, max_disp + 1, stride2)
    for dy in offsets:
        for dx in offsets:
            # lax.dynamic_slice clamps its start into the padded array
            y0 = min(max(pad + dy, 0), h + 2 * pad - h)
            x0 = min(max(pad + dx, 0), w + 2 * pad - w)
            shifted = d2p[:, :, y0:y0 + h, x0:x0 + w]
            if is_mult:
                outs.append(torch.mean(data1 * shifted, dim=1))
            else:
                outs.append(torch.mean(torch.abs(data1 - shifted), dim=1))
    return [torch.stack(outs, dim=1)], {}


register('Correlation', _correlation_apply,
         input_names=lambda attrs: ['data1', 'data2'],
         num_outputs=lambda attrs: 1,
         attr_defaults={'kernel_size': 1, 'max_displacement': 1,
                        'stride1': 1, 'stride2': 1, 'pad_size': None,
                        'is_multiply': True},
         hint='correlation')


# ---------------------------------------------------------------------------
# IdentityAttachKLSparseReg
# ---------------------------------------------------------------------------

class _KLSparseFn(torch.autograd.Function):
    """Identity forward; backward adds the KL sparsity penalty's gradient
    at the batch mean of the activations (``vision.py:244-268``)."""

    @staticmethod
    def forward(ctx, data, target, penalty):
        ctx.save_for_backward(torch.mean(data, dim=0))
        ctx.consts = (target, penalty)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        rho, = ctx.saved_tensors
        target, penalty = ctx.consts
        rho = torch.clamp(rho, 1e-6, 1 - 1e-6)
        kl_grad = penalty * (-target / rho + (1 - target) / (1 - rho))
        return g + kl_grad[None].to(g.dtype), None, None


def _kl_sparse_apply(attrs, inputs, is_train, rng):
    target = float(attrs.get('sparseness_target', 0.1))
    penalty = float(attrs.get('penalty', 0.001))
    momentum = float(attrs.get('momentum', 0.9))
    data, moving_avg = inputs[0], inputs[1]
    aux_updates = {}
    if is_train:
        rho_hat = torch.mean(data.detach(), dim=0)
        aux_updates = {'moving_avg': momentum * moving_avg
                       + (1 - momentum) * rho_hat}
    return [_KLSparseFn.apply(data, target, penalty)], aux_updates


register('IdentityAttachKLSparseReg', _kl_sparse_apply,
         input_names=lambda attrs: ['data'],
         num_outputs=lambda attrs: 1,
         aux_names=lambda attrs: ['moving_avg'],
         attr_defaults={'sparseness_target': 0.1, 'penalty': 0.001,
                        'momentum': 0.9},
         hint='identityattachklsparsereg')
