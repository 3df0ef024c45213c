"""Tests of the PyTorch port that need the card: each CUDA kernel against
its plain version (the sm90 routes of the GEMM, convolution and
attention kernels also at the edge cases they must get right, and
against the route each replaced), and small fused Predictor / LM train
steps on the GPU against the CPU.  Marked ``cuda``; they skip on a host
without a CUDA device.  On the GPU host:

    python -m pytest tests/test_torch_cuda.py tests/test_torch_rtc.py -q \
        -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.ops import fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda', 0)


def _case(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    s = (torch.rand(c, generator=g, device=dev) + 0.5).to(dtype)
    b = (torch.randn(c, generator=g, device=dev) * 0.5).to(dtype)
    return x, s, b


@pytest.mark.parametrize('shape', [(4, 64, 56, 56), (3, 2048, 7, 7),
                                   (49, 96), (5, 37, 9, 11), (1, 3, 1, 1)],
                         ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_kernel_matches_plain(shape, dtype, dev):
    x, s, b = _case(shape, dtype, dev)
    before = fused.fused_bn_relu.launches
    got = fused.fused_bn_relu(x, s, b)
    torch.cuda.synchronize()
    assert fused.fused_bn_relu.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape and got.is_cuda
    # separately rounded multiply and add: bit-identical to the plain form
    assert torch.equal(got, fused.fused_bn_relu_plain(x, s, b))


def test_unaligned_view_takes_scalar_path(dev):
    base = torch.randn(1 + 2 * 64 * 9, device=dev)
    x = base[1:].view(2, 64, 3, 3)
    s, b = torch.rand(64, device=dev) + 0.5, torch.randn(64, device=dev)
    assert torch.equal(fused.fused_bn_relu(x, s, b),
                       fused.fused_bn_relu_plain(x, s, b))


def test_kernel_rejects_what_it_cannot_take(dev):
    x, s, b = _case((2, 8, 4, 4), torch.float32, dev)
    with pytest.raises(ValueError):
        fused.fused_bn_relu(x.transpose(2, 3), s, b)
    with pytest.raises(ValueError):
        fused.fused_bn_relu(x, s.cpu(), b)
    with pytest.raises(TypeError):
        fused.fused_bn_relu(x.half(), s, b)


def _rel_err(got, want):
    """max |got - want| over max |want|: the error scaled to the output."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# f32: rtol 1e-4 of the output's scale (summation order differs from
# cuBLAS/cuDNN); bf16: 2e-2 (one bf16 rounding of the output, plus order)
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize('mkn', [(100352, 64, 256), (1568, 2048, 512),
                                 (6272, 1024, 256), (37, 40, 29),
                                 (1000, 3, 130)],
                         ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('relu', [True, False], ids=['relu', 'affine'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_scale_bias_dot_matches_plain(mkn, relu, dtype, dev):
    m, k, n = mkn
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(dtype)
    s = torch.rand(k, generator=g, device=dev) + 0.5
    b = torch.randn(k, generator=g, device=dev) * 0.5
    before = fused.fused_scale_bias_dot.launches
    got = fused.fused_scale_bias_dot(x, w, s, b, relu=relu)
    torch.cuda.synchronize()
    assert fused.fused_scale_bias_dot.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n) and got.is_cuda
    want = fused.fused_scale_bias_dot_plain(x, w, s, b, relu=relu)
    assert _rel_err(got, want) <= _TOL[dtype]


@pytest.mark.parametrize('shape', [(32, 56, 56, 64, 64, 1),
                                   (32, 56, 56, 128, 128, 2),
                                   (32, 7, 7, 512, 512, 1),
                                   (3, 9, 11, 20, 24, 2),
                                   (2, 5, 5, 7, 3, 1)],
                         ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_scale_bias_conv3x3_matches_plain(shape, dtype, dev, monkeypatch):
    from mxnet_tpu_torch.ops import fused_conv
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    n, h, wd, c, f, stride = shape
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(n, h, wd, c, generator=g, device=dev).to(dtype)
    w = (torch.randn(3, 3, c, f, generator=g, device=dev)
         / (9 * c) ** 0.5).to(dtype)
    s = torch.rand(c, generator=g, device=dev) + 0.5
    b = torch.randn(c, generator=g, device=dev) * 0.5
    for relu in (True, False):
        before = fused_conv.fused_scale_bias_conv3x3.launches
        got = fused_conv.fused_scale_bias_conv3x3(x, w, s, b, stride, relu)
        torch.cuda.synchronize()
        assert fused_conv.fused_scale_bias_conv3x3.launches == before + 1
        want = fused_conv.fused_scale_bias_conv3x3_plain(x, w, s, b, stride,
                                                         relu)
        assert got.shape == want.shape and got.dtype == dtype
        assert _rel_err(got, want) <= _TOL[dtype]


def test_fused_kernels_reject_what_they_cannot_take(dev):
    from mxnet_tpu_torch.ops import fused_conv
    x = torch.randn(4, 8, device=dev)
    w = torch.randn(8, 5, device=dev)
    s, b = torch.ones(8, device=dev), torch.zeros(8, device=dev)
    with pytest.raises(ValueError):
        # neither contiguous nor the transposed view of a contiguous (N, K)
        fused.fused_scale_bias_dot(x, torch.randn(8, 10, device=dev)[:, ::2],
                                   s, b)
    with pytest.raises(TypeError):
        fused.fused_scale_bias_dot(x, w.bfloat16(), s, b)
    xc = torch.randn(1, 4, 4, 8, device=dev)
    wc = torch.randn(3, 3, 8, 2, device=dev)
    with pytest.raises(ValueError):
        fused_conv.fused_scale_bias_conv3x3(xc, wc, s, b, stride=3)
    with pytest.raises(ValueError):
        fused_conv.fused_scale_bias_conv3x3(xc, wc, s.cpu(), b)


@pytest.mark.parametrize('mkn', [(8192, 512, 2048), (1001, 37, 130),
                                 (256, 64, 72)],
                         ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('epi', [(True, True, None), (False, False, None),
                                 (True, True, (-0.5, 0.7))],
                         ids=['bias-relu', 'plain-dot', 'bias-relu-clip'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_dot_epilogue_matches_plain(mkn, epi, dtype, dev, monkeypatch):
    """|got - plain| <= rtol * (|x| . |W| + |b|) elementwise, W passed as
    the transposed view of an (N, K) weight, as the fuse pass does."""
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    m, k, n = mkn
    has_bias, relu, clip = epi
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = (torch.randn(n, k, generator=g, device=dev) / k ** 0.5).to(dtype).t()
    b = torch.randn(n, generator=g, device=dev) * 0.5 if has_bias else None
    before = fused.fused_dot_epilogue.launches
    got = fused.fused_dot_epilogue(x, w, b, relu=relu, clip=clip)
    torch.cuda.synchronize()
    assert fused.fused_dot_epilogue.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n) and got.is_cuda
    want = fused.fused_dot_epilogue_plain(x, w, b, relu=relu, clip=clip)
    mag = torch.matmul(x.float().abs(), w.float().abs())
    if b is not None:
        mag = mag + b.abs()
    err = (got.float() - want.float()).abs() / mag.clamp_min(1e-30)
    assert float(err.max()) <= _TOL[dtype]


# ---------------------------------------------------------------------------
# The sm90 route of the two GEMM kernels (csrc/hopper_gemm.cuh) off the
# path: each case guards one mistake.  Tolerance: the bf16 GEMM rule
# above, |got - plain| <= 2e-2 * (|A| . |W| [+ |b|]) elementwise.
# ---------------------------------------------------------------------------

def _routed(kernel, fn):
    """fn() and the one route it launched ``kernel`` on."""
    before = dict(kernel.launches_by_route)
    out = fn()
    torch.cuda.synchronize()
    moved = {r: n - before[r] for r, n in kernel.launches_by_route.items()
             if n != before[r]}
    assert len(moved) == 1 and list(moved.values()) == [1], moved
    return out, next(iter(moved))


def _check_rows(got, want, mag, nan_row=None):
    """The GEMM rule on every row but ``nan_row``, which must be NaN in
    every element while no other row holds a NaN."""
    got, want = got.float(), want.float()
    if nan_row is not None:
        nan_rows = torch.nonzero(torch.isnan(got).any(1)).flatten()
        assert nan_rows.tolist() == [nan_row]
        assert bool(torch.isnan(got[nan_row]).all())
        keep = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
        keep[nan_row] = False
        got, want, mag = got[keep], want[keep], mag[keep]
    assert bool(torch.isfinite(got).all())
    assert float(((got - want).abs() / mag.clamp_min(1e-30)).max()) <= 2e-2


def _sm90_dot_case(dev, m, k, n, positive_bias=False, nan_row=None, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).bfloat16()
    if nan_row is not None:
        x[nan_row, k // 3] = float('nan')
    w = (torch.randn(n, k, generator=g, device=dev) / k ** 0.5) \
        .bfloat16().t()
    s = torch.rand(k, generator=g, device=dev) + 0.5
    b = torch.randn(k, generator=g, device=dev) * 0.5
    if positive_bias:
        # NaN past K: a scale or bias read there, or a padded channel
        # left at relu(bias) instead of 0, would poison Y
        buf = torch.full((2, k + 64), float('nan'), device=dev)
        buf[0, :k], buf[1, :k] = s, b.abs() + 0.1
        s, b = buf[0, :k], buf[1, :k]
    return x, w, s, b


@pytest.mark.parametrize('case', ['k72_positive_bias', 'ragged_m',
                                  'n72_bn64', 'nan_row', 'tiny_m_k'])
def test_scale_bias_dot_sm90_edge_cases(case, dev):
    m, k, n = {'k72_positive_bias': (1001, 72, 256),
               'ragged_m': (1001, 64, 256), 'n72_bn64': (256, 96, 72),
               'nan_row': (1001, 64, 256), 'tiny_m_k': (8, 24, 64)}[case]
    nan_row = 500 if case == 'nan_row' else None
    # tiny_m_k: one tile, most of its rows and K columns out of range
    x, w, s, b = _sm90_dot_case(dev, m, k, n,
                                case in ('k72_positive_bias', 'tiny_m_k'),
                                nan_row)
    if case == 'n72_bn64':
        assert fused._sm90_plan(m, n, fused._sm_count(dev))[0] == 64
    got, route = _routed(fused.fused_scale_bias_dot,
                         lambda: fused.fused_scale_bias_dot(x, w, s, b,
                                                            relu=True))
    assert route == 'sm90'
    want = fused.fused_scale_bias_dot_plain(x, w, s, b, relu=True)
    xa = torch.relu(x.float() * s + b).bfloat16()
    mag = torch.matmul(xa.float().abs(), w.float().abs())
    _check_rows(got, want, mag, nan_row)


def test_scale_bias_dot_sm90_weight_view_equals_copy(dev):
    x, w, s, b = _sm90_dot_case(dev, 25088, 128, 512)
    view, r1 = _routed(fused.fused_scale_bias_dot,
                       lambda: fused.fused_scale_bias_dot(x, w, s, b, True))
    copy, r2 = _routed(fused.fused_scale_bias_dot,
                       lambda: fused.fused_scale_bias_dot(
                           x, w.contiguous(), s, b, True))
    assert (r1, r2) == ('sm90', 'sm90') and torch.equal(view, copy)


@pytest.mark.parametrize('case', ['ragged_m', 'n72_bn64', 'clip_no_bias',
                                  'nan_row', 'tiny_m_k'])
def test_dot_epilogue_sm90_edge_cases(case, dev, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    (m, k, n), has_bias, relu, clip = {
        'ragged_m': ((1001, 512, 2048), True, True, None),
        'n72_bn64': ((256, 96, 72), False, False, None),
        'clip_no_bias': ((512, 128, 256), False, False, (-0.5, 0.7)),
        'nan_row': ((1001, 512, 2048), True, True, (0.0, 6.0)),
        'tiny_m_k': ((8, 24, 64), True, True, None)}[case]
    nan_row = 500 if case == 'nan_row' else None
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(m, k, generator=g, device=dev).bfloat16()
    if nan_row is not None:
        x[nan_row, k // 3] = float('nan')
    w = (torch.randn(n, k, generator=g, device=dev) / k ** 0.5).bfloat16().t()
    b = torch.randn(n, generator=g, device=dev) * 0.5 if has_bias else None
    got, route = _routed(fused.fused_dot_epilogue,
                         lambda: fused.fused_dot_epilogue(x, w, b, relu,
                                                          clip))
    assert route == 'sm90'
    want = fused.fused_dot_epilogue_plain(x, w, b, relu, clip)
    mag = torch.matmul(x.float().abs(), w.float().abs())
    if b is not None:
        mag = mag + b.abs()
    _check_rows(got, want, mag, nan_row)


@pytest.mark.parametrize('kernel', ['scale_bias_dot', 'dot_epilogue'])
def test_sm90_and_wmma_routes_agree_at_a_path_shape(kernel, dev,
                                                    monkeypatch):
    """Both routes, forced, at a path shape: each within the GEMM rule of
    the plain version, and of each other."""
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    if kernel == 'scale_bias_dot':
        x, w, s, b = _sm90_dot_case(dev, 6272, 1024, 256)
        run = {r: (lambda r=r: fused._dot_launch(x, w, s, b, True, r))
               for r in ('sm90', 'wmma')}
        want = fused.fused_scale_bias_dot_plain(x, w, s, b, relu=True)
        xa = torch.relu(x.float() * s + b).bfloat16()
        mag = torch.matmul(xa.float().abs(), w.float().abs())
    else:
        g = torch.Generator(device=dev).manual_seed(6)
        x = torch.randn(8192, 512, generator=g, device=dev).bfloat16()
        w = (torch.randn(2048, 512, generator=g, device=dev)
             / 512 ** 0.5).bfloat16().t()
        b = torch.randn(2048, generator=g, device=dev) * 0.5
        run = {r: (lambda r=r: fused._epi_launch(x, w, b, True, None, r))
               for r in ('sm90', 'wmma')}
        want = fused.fused_dot_epilogue_plain(x, w, b, relu=True)
        mag = torch.matmul(x.float().abs(), w.float().abs()) + b.abs()
    got = {r: fn() for r, fn in run.items()}
    torch.cuda.synchronize()
    for r in run:
        _check_rows(got[r], want, mag)
    _check_rows(got['sm90'], got['wmma'], mag)


def _attention_magnitude(q, k, v, scale, causal):
    """P @ |V| with P the plain version's probabilities: the bound an
    error in O scales with."""
    from mxnet_tpu_torch.ops import attention
    s = torch.einsum('btd,bsd->bts', q.float(), k.float()) * scale
    if causal:
        keep = attention._causal_keep(s.shape[1], s.shape[2], s.device)
        s = torch.where(keep, s, torch.full_like(s, attention.NEG_INF))
    return torch.einsum('bts,bsd->btd', torch.softmax(s, -1),
                        v.float().abs())


# bf16: P rounded to bf16 for the PV product and O rounded (3 * 2^-8 of
# P @ |V|, ops/attention.py); f32: summation order only
_ATT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize('shapes,causal', [
    (((128, 512, 64), (128, 512, 64)), True),     # the LM's path shape
    (((6, 77, 64), (6, 200, 64)), True),          # ragged, tq < tk
    (((8, 256, 64), (8, 256, 64)), False),
    (((16, 256, 128), (16, 256, 128)), True),     # D = 128
    (((4, 100, 40), (4, 100, 40)), True),         # D = 40: padded to 48
], ids=['path', 'ragged', 'noncausal', 'd128', 'd40'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_flash_attention_matches_plain(shapes, causal, dtype, dev,
                                       monkeypatch):
    from mxnet_tpu_torch.ops import attention
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    qs, ks = shapes
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(qs, generator=g, device=dev).to(dtype)
    k = torch.randn(ks, generator=g, device=dev).to(dtype)
    v = torch.randn(ks, generator=g, device=dev).to(dtype)
    scale = qs[-1] ** -0.5
    before = attention.flash_attention.launches
    o, lse = attention._launch(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    want_o, want_lse = attention.flash_attention_plain(q, k, v, scale, causal)
    assert o.dtype == dtype and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == qs[:2]
    mag = _attention_magnitude(q, k, v, scale, causal)
    err = (o.float() - want_o.float()).abs() / mag.clamp_min(1e-30)
    assert float(err.max()) <= _ATT_TOL[dtype]
    lse_err = (lse - want_lse).abs() / (1 + want_lse.abs())
    assert float(lse_err.max()) <= 1e-4


def test_flash_attention_gradients_on_card_match_cpu(dev, monkeypatch):
    """The autograd Function on the card (kernel forward, plain blockwise
    backward) against the CPU's, float32."""
    from mxnet_tpu_torch.ops import attention
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    r = np.random.RandomState(5)
    arrays = [r.randn(2, 4, 96, 32).astype(np.float32) for _ in range(4)]
    grads = {}
    for d in (dev, torch.device('cpu')):
        ts = [torch.from_numpy(a).to(d).requires_grad_(True)
              for a in arrays[:3]]
        o = attention.flash_attention(*ts, causal=True)
        grads[d.type] = [o.detach().cpu()] + [
            t.cpu() for t in torch.autograd.grad(
                o, ts, torch.from_numpy(arrays[3]).to(d))]
    for a, b in zip(grads['cuda'], grads['cpu']):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_flash_attention_rejects_head_dims_it_cannot_take(dev):
    from mxnet_tpu_torch.ops import attention
    for d in (12, 136):
        q = torch.randn(2, 16, d, device=dev)
        with pytest.raises(tmx.MXNetError, match='multiple of 8 up to 128'):
            attention.flash_attention(q, q, q)


def test_small_lm_on_gpu_matches_cpu(dev, monkeypatch):
    """One f32 make_train_step step of a narrow transformer LM on the card
    (2 flash_attention + 2 fused_dot_epilogue launches) and on the CPU."""
    from mxnet_tpu_torch.models import transformer_lm
    from mxnet_tpu_torch.ops import attention
    from mxnet_tpu_torch.parallel import train_step as ts
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    shapes = {'data': (4, 64), 'softmax_label': (4, 64)}
    sym = transformer_lm.get_symbol(vocab_size=300, num_embed=128,
                                    num_heads=4, num_layers=2, seq_len=64)
    arg, _ = convert.random_params(sym, shapes, 0, init='normal')
    toks = np.random.RandomState(1).randint(0, 300, (4, 64)).astype(
        np.float32)
    out = {}
    for d in ('cuda:0', 'cpu'):
        params = {k: torch.tensor(v, device=d) for k, v in arg.items()}
        step = ts.make_train_step(sym, ts.make_sgd_momentum(
            lr=0.01, momentum=0.9, wd=0.0, rescale_grad=1 / 256.),
            tuple(shapes))
        before = (attention.flash_attention.launches,
                  fused.fused_dot_epilogue.launches)
        _, params, _, _ = step(params, {}, ts.sgd_momentum_init(params), {
            'data': torch.from_numpy(toks).to(d),
            'softmax_label': torch.from_numpy((toks + 1) % 300).to(d)})
        launched = (attention.flash_attention.launches - before[0],
                    fused.fused_dot_epilogue.launches - before[1])
        assert launched == ((2, 2) if d != 'cpu' else (0, 0))
        out[d] = {k: v.cpu().numpy() for k, v in params.items()}
    for k in arg:
        np.testing.assert_allclose(out['cuda:0'][k], out['cpu'][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_small_resnet_on_gpu_matches_cpu(dev, monkeypatch):
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    sym = resnet.resnet(units=[1, 1, 1, 1], num_stages=4,
                        filter_list=[8, 16, 32, 64, 128], num_classes=10,
                        image_shape=(3, 64, 64))
    arg, aux = convert.random_params(sym, {'data': (4, 3, 64, 64)}, 0)
    data = np.random.default_rng(1).standard_normal((4, 3, 64, 64),
                                                    dtype=np.float32)
    outs = {}
    for dt in ('gpu', 'cpu'):
        dev_s = 'cuda:0' if dt == 'gpu' else 'cpu'
        pred = tmx.Predictor(sym.tojson(),
                             convert.params_from_numpy(arg, aux, dev_s),
                             {'data': (4, 3, 64, 64)}, dev_type=dt)
        before = fused.fused_bn_relu.launches
        pred.forward(data=data)
        outs[dt] = pred.get_output(0)
        launched = fused.fused_bn_relu.launches - before
        assert launched == (5 if dt == 'gpu' else 0)
    np.testing.assert_allclose(outs['gpu'], outs['cpu'], rtol=1e-3,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The sm90 route of fused_scale_bias_conv3x3 (TMA im2col + wgmma) and of
# flash_attention (TMA + wgmma, P in registers): edge cases, and agreement
# with the route each replaced (wmma / mma).  Conv tolerance: the GEMM
# rule, |got - plain| <= 2e-2 * conv(|relu(x s + b)|, |w|) elementwise;
# attention: O within 2e-2 of P @ |V|, lse within 1e-4 * (1 + |lse|).
# ---------------------------------------------------------------------------

def _conv_case(dev, shape, positive_bias=False, nan_pixel=None, seed=8):
    n, h, wd, c, f, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, h, wd, c, generator=g, device=dev).bfloat16()
    if nan_pixel is not None:
        x[nan_pixel + (c // 3,)] = float('nan')
    w = (torch.randn(3, 3, c, f, generator=g, device=dev)
         / (9 * c) ** 0.5).bfloat16()
    s = torch.rand(c, generator=g, device=dev) + 0.5
    b = torch.randn(c, generator=g, device=dev) * 0.5
    if positive_bias:
        # every input pixel maps to > 0: a halo row left at relu(bias)
        # instead of 0 shows in every border output
        b = b.abs() + 0.1
    return x, w, s, b


def _conv_magnitude(x, w, s, b, stride):
    import torch.nn.functional as F
    xa = torch.relu(x.float() * s + b).bfloat16().float()
    return F.conv2d(xa.abs().permute(0, 3, 1, 2),
                    w.float().abs().permute(3, 2, 0, 1), None, stride,
                    1).permute(0, 2, 3, 1)


def _covering(shape, pixel, dev):
    """(N, OH, OW) mask of the outputs whose 3x3 window covers input
    pixel (n, ih, iw)."""
    n, h, wd, _, _, stride = shape
    from mxnet_tpu_torch.ops import fused_conv
    oh, ow = fused_conv.conv3x3_out_hw(h, wd, stride)
    pn, ih, iw = pixel
    rows = (torch.arange(oh, device=dev) * stride - 1)[:, None]
    cols = (torch.arange(ow, device=dev) * stride - 1)[None, :]
    hit = (rows <= ih) & (ih <= rows + 2) & (cols <= iw) & (iw <= cols + 2)
    mask = torch.zeros(n, oh, ow, dtype=torch.bool, device=dev)
    mask[pn] = hit
    return mask


@pytest.mark.parametrize('case', ['odd_stride2', 'ragged_m', 'one_tile',
                                  'positive_bias', 'positive_bias_stride2',
                                  'nan_pixel', 'nan_pixel_stride2'])
def test_conv3x3_sm90_edge_cases(case, dev, monkeypatch):
    from mxnet_tpu_torch.ops import fused_conv
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    shape, positive_bias, nan_pixel = {
        # odd H and W at stride 2, F = 40 (a ragged BN = 64 tile); M =
        # 168 is not a multiple of 128
        'odd_stride2': ((3, 15, 13, 64, 40, 2), False, None),
        # 7 x 9 images: a 128-row tile spans two images and a ragged end
        'ragged_m': ((2, 7, 9, 64, 64, 1), False, None),
        'one_tile': ((1, 3, 5, 128, 8, 1), True, None),
        'positive_bias': ((2, 14, 14, 128, 64, 1), True, None),
        'positive_bias_stride2': ((2, 14, 15, 192, 128, 2), True, None),
        # the NaN on the left edge and on an interior pixel
        'nan_pixel': ((2, 9, 9, 64, 32, 1), False, (1, 4, 0)),
        'nan_pixel_stride2': ((2, 12, 12, 64, 32, 2), False, (0, 5, 6)),
    }[case]
    x, w, s, b = _conv_case(dev, shape, positive_bias, nan_pixel)
    stride = shape[5]
    conv = fused_conv.fused_scale_bias_conv3x3
    got, route = _routed(conv, lambda: conv(x, w, s, b, stride))
    assert route == 'sm90'
    clean = x
    if nan_pixel is not None:
        clean = torch.nan_to_num(x, nan=0.0)
    want = fused_conv.fused_scale_bias_conv3x3_plain(clean, w, s, b, stride)
    mag = _conv_magnitude(clean, w, s, b, stride)
    got = got.float()
    if nan_pixel is not None:
        mask = _covering(shape, nan_pixel, dev)
        assert bool(torch.isnan(got[mask]).all())
        assert not bool(torch.isnan(got[~mask]).any())
        got, want, mag = got[~mask], want[~mask], mag[~mask]
    assert bool(torch.isfinite(got).all())
    assert float(((got - want.float()).abs()
                  / mag.clamp_min(1e-30)).max()) <= 2e-2


@pytest.mark.parametrize('shape', [(32, 14, 14, 256, 256, 1),
                                   (32, 56, 56, 128, 128, 2)],
                         ids=lambda s: 'x'.join(map(str, s)))
def test_conv3x3_sm90_and_wmma_routes_agree_at_a_path_shape(shape, dev,
                                                            monkeypatch):
    from mxnet_tpu_torch.ops import fused_conv
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    x, w, s, b = _conv_case(dev, shape)
    stride = shape[5]
    assert fused_conv.conv_route(x, w) == 'sm90'
    got = {r: fused_conv._launch(x, w, s, b, stride, True, r)
           for r in ('sm90', 'wmma')}
    torch.cuda.synchronize()
    want = fused_conv.fused_scale_bias_conv3x3_plain(x, w, s, b, stride)
    mag = _conv_magnitude(x, w, s, b, stride)
    for r, y in list(got.items()) + [('sm90 vs wmma', got['sm90'])]:
        ref = got['wmma'] if r == 'sm90 vs wmma' else want
        err = (y.float() - ref.float()).abs() / mag.clamp_min(1e-30)
        assert float(err.max()) <= 2e-2, r


def test_conv3x3_weight_view_equals_contiguous(dev):
    """The HWIO view of an OIHW weight (what the fuse pass passes) and
    its contiguous HWIO copy: the same route and the same bits."""
    from mxnet_tpu_torch.ops import fused_conv
    x, w, s, b = _conv_case(dev, (4, 28, 28, 128, 128, 1))
    view = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    assert not view.is_contiguous()
    conv = fused_conv.fused_scale_bias_conv3x3
    a, r1 = _routed(conv, lambda: conv(x, view, s, b))
    c, r2 = _routed(conv, lambda: conv(x, w, s, b))
    assert (r1, r2) == ('sm90', 'sm90') and torch.equal(a, c)


def _flash_case(dev, bh, tq, tk, d, seed=9):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(bh, t, d, generator=g, device=dev).bfloat16()
            for t in (tq, tk, tk)]


def _check_flash(o, lse, q, k, v, scale, causal, want=None):
    from mxnet_tpu_torch.ops import attention
    want_o, want_lse = attention.flash_attention_plain(q, k, v, scale, causal)
    mag = _attention_magnitude(q, k, v, scale, causal)
    ref = want_o if want is None else want
    assert bool(torch.isfinite(o.float()).all())
    err = (o.float() - ref.float()).abs() / mag.clamp_min(1e-30)
    assert float(err.max()) <= 2e-2
    assert float(((lse - want_lse).abs()
                  / (1 + want_lse.abs())).max()) <= 1e-4


@pytest.mark.parametrize('case', ['ragged_causal', 'ragged_noncausal',
                                  'd128', 'bh1', 'short'])
def test_flash_attention_sm90_edge_cases(case, dev, monkeypatch):
    from mxnet_tpu_torch.ops import attention
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    bh, tq, tk, d, causal = {
        # Tq != Tk, neither a multiple of the 128-row tiles: the causal
        # diagonal crosses tiles at an offset of 400
        'ragged_causal': (4, 300, 700, 64, True),
        'ragged_noncausal': (4, 300, 700, 64, False),
        'd128': (8, 512, 512, 128, True),
        'bh1': (1, 512, 512, 64, True),
        # one tile, most rows and keys out of range
        'short': (3, 5, 9, 64, True),
    }[case]
    q, k, v = _flash_case(dev, bh, tq, tk, d)
    scale = d ** -0.5
    (o, lse), route = _routed(attention.flash_attention,
                              lambda: attention._launch(q, k, v, scale,
                                                        causal))
    assert route == 'sm90'
    _check_flash(o, lse, q, k, v, scale, causal)


def test_flash_attention_sm90_and_mma_routes_agree(dev, monkeypatch):
    """Both bf16 routes, forced, at the LM's path shape: each against the
    plain version, and the sm90 route against the mma route."""
    from mxnet_tpu_torch.ops import attention
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    q, k, v = _flash_case(dev, 128, 512, 512, 64)
    scale = 64 ** -0.5
    assert attention.attention_route(
        q.dtype, 64, [t.data_ptr() for t in (q, k, v)]) == 'sm90'
    got = {r: attention._launch(q, k, v, scale, True, r)
           for r in ('sm90', 'mma')}
    torch.cuda.synchronize()
    for r in got:
        _check_flash(*got[r], q, k, v, scale, True)
    _check_flash(*got['sm90'], q, k, v, scale, True, want=got['mma'][0])


# ---------------------------------------------------------------------------
# The bucketed LM's shapes (mod.BucketingModule over sym_gen_bucketing,
# float32): T = 200 and 320 leave ragged 128-row query and key tiles, the
# causal mask aligned at the bottom right with Tq == Tk
# ---------------------------------------------------------------------------

BUCKETS = (128, 200, 320, 512)


@pytest.mark.parametrize('t', BUCKETS)
def test_flash_attention_at_the_bucket_shapes(t, dev, monkeypatch):
    """[128, T, 64] causal, float32 (the simt route), against the plain
    version under the f32 rule above."""
    from mxnet_tpu_torch.ops import attention
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    g = torch.Generator(device=dev).manual_seed(t)
    q, k, v = (torch.randn(128, t, 64, generator=g, device=dev)
               for _ in range(3))
    before = dict(attention.flash_attention.launches_by_route)
    o, lse = attention._launch(q, k, v, 0.125, True)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches_by_route['simt'] == \
        before['simt'] + 1
    want_o, want_lse = attention.flash_attention_plain(q, k, v, 0.125, True)
    mag = _attention_magnitude(q, k, v, 0.125, True)
    err = (o - want_o).abs() / mag.clamp_min(1e-30)
    assert float(err.max()) <= _ATT_TOL[torch.float32]
    assert float(((lse - want_lse).abs() / (1 + want_lse.abs())).max()) \
        <= 1e-4


@pytest.mark.parametrize('t', BUCKETS)
def test_dot_epilogue_at_the_bucket_shapes(t, dev, monkeypatch):
    """(16 T, 512, 2048) with bias and relu, float32 (the simt route)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    g = torch.Generator(device=dev).manual_seed(t)
    x = torch.randn(16 * t, 512, generator=g, device=dev)
    w = (torch.randn(2048, 512, generator=g, device=dev) / 512 ** 0.5).t()
    b = torch.randn(2048, generator=g, device=dev) * 0.5
    before = dict(fused.fused_dot_epilogue.launches_by_route)
    got = fused.fused_dot_epilogue(x, w, b, relu=True)
    torch.cuda.synchronize()
    assert fused.fused_dot_epilogue.launches_by_route['simt'] == \
        before['simt'] + 1
    want = fused.fused_dot_epilogue_plain(x, w, b, relu=True)
    mag = torch.matmul(x.abs(), w.abs()) + b.abs()
    err = (got - want).abs() / mag.clamp_min(1e-30)
    assert float(err.max()) <= _TOL[torch.float32]


def test_embedding_ids_outside_the_vocabulary_on_the_card(dev):
    """-1 wraps to the last row, V and -V-1 give NaN rows, with no
    device assert (the context stays usable)."""
    from mxnet_tpu_torch.ops.registry import get_op
    w = torch.arange(12, dtype=torch.float32, device=dev).reshape(4, 3)
    ids = torch.tensor([-1.0, 0.0, 4.0, -5.0, 2.7], device=dev)
    out = get_op('Embedding').apply({'input_dim': 4, 'output_dim': 3},
                                    [ids, w], False, None)[0][0]
    want = get_op('Embedding').apply({'input_dim': 4, 'output_dim': 3},
                                     [ids.cpu(), w.cpu()], False,
                                     None)[0][0]
    torch.testing.assert_close(out.cpu(), want, equal_nan=True)
    assert torch.isnan(out[2:4]).all() and torch.equal(out[0], w[3])
    assert float(torch.ones(1, device=dev).sum()) == 1.0


def test_bucketing_module_on_gpu_matches_cpu(dev, monkeypatch):
    """Two fused steps of a narrow bucketed LM (buckets 200 then 128,
    padded with -1) on the card and on the CPU, float32, TF32 off."""
    from mxnet_tpu_torch.models import transformer_lm
    monkeypatch.setenv('MXTPU_FUSE', 'aggressive')
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    gen = transformer_lm.sym_gen_bucketing(vocab_size=300, num_embed=64,
                                           num_heads=1, num_layers=1,
                                           max_seq_len=256)
    arg, _ = convert.random_params(
        gen(256)[0], {'data': (2, 256), 'softmax_label': (2, 256)}, 0,
        init='normal')
    rng = np.random.RandomState(1)
    batches = []
    for t in (200, 128):
        toks = rng.randint(0, 300, (2, t)).astype(np.float32)
        toks[1, t // 2:] = -1
        labels = np.full_like(toks, -1)
        labels[:, :-1] = toks[:, 1:]
        batches.append((t, toks, labels))
    params = {}
    for ctx in (tmx.gpu(0), tmx.cpu()):
        mod = tmx.mod.BucketingModule(gen, default_bucket_key=256,
                                      context=ctx)
        mod.bind([('data', (2, 256))], [('softmax_label', (2, 256))])
        mod.init_params(arg_params={k: tmx.nd.array(v)
                                    for k, v in arg.items()})
        mod.init_optimizer(optimizer='sgd', optimizer_params={
            'learning_rate': 0.05, 'momentum': 0.9})
        for t, toks, labels in batches:
            mod._fit_step(tmx.io.DataBatch(
                [tmx.nd.array(toks)], [tmx.nd.array(labels)], bucket_key=t,
                provide_data=[('data', (2, t))],
                provide_label=[('softmax_label', (2, t))]),
                tmx.metric.create('acc'))
        params[ctx.device_type] = {k: v.asnumpy() for k, v in
                                   mod.get_params()[0].items()}
    for k in arg:
        np.testing.assert_allclose(params['gpu'][k], params['cpu'][k],
                                   rtol=1e-3, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# multibox_nms: SSD's greedy NMS (csrc/multibox_nms.cu)
# ---------------------------------------------------------------------------

def _nms_rows(dev, batch, hw, classes=21, ties=False, seed=0):
    from mxnet_tpu_torch.ops import multibox as mb
    g = torch.Generator(device=dev).manual_seed(seed)
    anchors = mb.multibox_prior(torch.zeros(1, 1, hw, hw, device=dev),
                                sizes=(0.1, 0.141), ratios=(1, 2, 0.5),
                                clip=True)[0]
    a = anchors.shape[0]
    logits = torch.randn(batch, classes, a, generator=g, device=dev) * 2
    if ties:
        logits[:, :, 1::2] = logits[:, :, 0:a - 1:2]
    prob = torch.softmax(logits, 1)
    loc = torch.randn(batch, a * 4, generator=g, device=dev) * 0.3
    return mb.detection_rows(prob, loc, anchors, 0.01, True,
                             (0.1, 0.1, 0.2, 0.2))


@pytest.mark.parametrize('force', [True, False], ids=['force', 'per_class'])
@pytest.mark.parametrize('case', ['ssd_300', 'ties', 'large'])
def test_multibox_nms_matches_plain(case, force, dev):
    """Row for row against the plain loop: SSD's 300 x 300 anchor count
    (7308 as 38 x 38 x 5 + ...; here 38 x 38 x 4 = 5776 rows a image, 8
    images), exact score ties (the stable order decides), and 19600 rows
    (307 mask words a row, 48 MB of workspace an image)."""
    from mxnet_tpu_torch.ops import multibox as mb
    hw = {'ssd_300': 38, 'ties': 20, 'large': 70}[case]
    rows = _nms_rows(dev, 8 if case != 'large' else 2, hw,
                     ties=case == 'ties')
    before = mb.multibox_nms.launches
    got = mb.multibox_nms(rows, 0.45, force)
    torch.cuda.synchronize()
    assert mb.multibox_nms.launches == before + 1
    want = mb.multibox_nms_plain(rows, 0.45, force)
    assert torch.equal(got, want)
    assert 0 < int((got[..., 0] >= 0).sum()) < int((rows[..., 0] >= 0)
                                                   .sum())
    # the input rows are untouched
    assert torch.equal(rows, _nms_rows(dev, rows.shape[0], hw,
                                       ties=case == 'ties'))


def _nms_edge_rows(case, a=200, batch=2, seed=4):
    """Score-ordered rows over ``a`` random anchors (numpy-seeded, made on
    the CPU): ``ties`` repeats every other anchor's logits; ``unordered``
    shuffles the rows (-1 rows among valid ones, scores out of order);
    ``all_invalid`` has no score above its threshold; ``threshold_1``
    pairs identical boxes (IoU exactly 1)."""
    from mxnet_tpu_torch.ops import multibox as mb
    rng = np.random.default_rng(seed)
    centre = rng.random((a, 2))
    side = rng.uniform(0.05, 0.4, (a, 2))
    if case == 'threshold_1':
        centre[1::2], side[1::2] = centre[0:a - 1:2], side[0:a - 1:2]
    anchors = np.concatenate([centre - side / 2, centre + side / 2],
                             1).clip(0, 1).astype(np.float32)
    logits = rng.standard_normal((batch, 5, a)) * 2
    if case == 'ties':
        logits[:, :, 1::2] = logits[:, :, 0:a - 1:2]
    prob = torch.softmax(torch.from_numpy(logits.astype(np.float32)), 1)
    loc = torch.from_numpy((rng.standard_normal((batch, a * 4)) * 0.3)
                           .astype(np.float32))
    if case == 'threshold_1':
        loc.zero_()
    rows = mb.detection_rows(
        prob, loc, torch.from_numpy(anchors),
        {'all_invalid': 1.5, 'unordered': 0.3}.get(case, 0.01), True,
        (0.1, 0.1, 0.2, 0.2))
    if case == 'unordered':
        rows = rows[:, torch.from_numpy(rng.permutation(a))].contiguous()
    return rows


def _phase_a_words(rows, thr, force):
    """Phase A's words from one call of the kernel into a zeroed workspace
    (phase B only reads them; the words phase A leaves unwritten read 0,
    as in :func:`nms_masks_plain`)."""
    from mxnet_tpu_torch.ops import multibox as mb
    ws = torch.zeros(mb.nms_workspace_shape(*rows.shape[:2]),
                     dtype=torch.int64, device=rows.device)
    return mb._nms_launch(rows, thr, force, ws=ws)[1]


@pytest.mark.parametrize('force', [True, False], ids=['force', 'per_class'])
@pytest.mark.parametrize('case', ['a1', 'a63', 'a64', 'a65', 'ties',
                                  'unordered', 'all_invalid', 'threshold_1'])
def test_multibox_nms_edge_cases_match_plain(case, force, dev):
    """Anchor counts around the 64-row blocks and the edge cases of the
    two-phase design, row for row against the plain loop; phase A's
    words against :func:`nms_masks_plain`'s, every word."""
    from mxnet_tpu_torch.ops import multibox as mb
    host = _nms_edge_rows(case, a={'a1': 1, 'a63': 63, 'a64': 64,
                                  'a65': 65}.get(case, 200))
    thr = 1.0 if case == 'threshold_1' else 0.45
    rows = host.to(dev)
    got = mb.multibox_nms(rows, thr, force)
    words = _phase_a_words(rows, thr, force)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), mb.multibox_nms_plain(host, thr, force))
    assert torch.equal(words.cpu(), mb.nms_masks_plain(host, thr, force))
    assert torch.equal(words, mb.nms_masks_plain(rows, thr, force))


@pytest.mark.parametrize('force', [True, False], ids=['force', 'per_class'])
def test_multibox_nms_phase_a_words_match_plain(force, dev):
    """Phase A's words at SSD's anchor count on the card against the plain
    transcription run on the same card rows, and the plain scan over the
    kernel's words against the kernel's rows."""
    from mxnet_tpu_torch.ops import multibox as mb
    rows = _nms_rows(dev, 4, 38)
    words = _phase_a_words(rows, 0.45, force)
    want = mb.nms_masks_plain(rows, 0.45, force)
    assert torch.equal(words, want)
    assert torch.equal(mb.nms_scan_plain(rows, words).cpu(),
                       mb.multibox_nms(rows, 0.45, force).cpu())


def test_multibox_nms_captured_replay_equals_eager(dev):
    """The op captured in a CUDA graph (its workspace from the graph's
    pool, both kernels on the capture stream): replays over new rows
    equal eager calls on them, bit for bit."""
    from mxnet_tpu_torch.ops import multibox as mb
    first, second = _nms_rows(dev, 4, 38), _nms_rows(dev, 4, 38, seed=1)
    static = first.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mb.multibox_nms(static, 0.45, True)        # builds, warms
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mb.multibox_nms(static, 0.45, True)
    for rows in (second, first):
        static.copy_(rows)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, mb.multibox_nms(rows, 0.45, True))
    assert not torch.equal(mb.multibox_nms(first, 0.45, True),
                           mb.multibox_nms(second, 0.45, True))


def test_multibox_nms_rejects_what_it_cannot_take(dev):
    from mxnet_tpu_torch.ops import multibox as mb
    with pytest.raises(ValueError, match='at most'):
        mb.multibox_nms(torch.zeros(1, mb.NMS_MAX_ANCHORS + 1, 6,
                                    device=dev), 0.5, True)
    # past the images phase A's grid y dimension holds (1.5 MB of rows)
    with pytest.raises(ValueError, match='at most'):
        mb.multibox_nms(torch.zeros(mb.NMS_MAX_IMAGES + 1, 1, 6,
                                    device=dev), 0.5, True)
    with pytest.raises(TypeError):
        mb.multibox_nms(torch.zeros(1, 8, 6, device=dev,
                                    dtype=torch.bfloat16), 0.5, True)


def test_multibox_detection_op_on_card_matches_cpu(dev):
    """The MultiBoxDetection op on card tensors (the kernel) against the
    same op on the CPU (the plain loop), from the same probabilities and
    zero offsets (the boxes are the anchors on both devices)."""
    from mxnet_tpu_torch.ops import get_op
    from mxnet_tpu_torch.ops import multibox as mb
    anchors = mb.multibox_prior(torch.zeros(1, 1, 19, 19), sizes=(0.2, 0.3),
                                ratios=(1, 2, 0.5), clip=True)
    a = anchors.shape[1]
    prob = torch.softmax(torch.randn(4, 21, a, generator=torch.Generator()
                                     .manual_seed(3)) * 2, 1)
    loc = torch.zeros(4, a * 4)
    op = get_op('MultiBoxDetection')
    attrs = op.canon_attrs({'nms_threshold': 0.5, 'force_suppress': False})
    host = op.apply(attrs, [prob, loc, anchors], False, None)[0][0]
    before = mb.multibox_nms.launches
    card = op.apply(attrs, [prob.to(dev), loc.to(dev), anchors.to(dev)],
                    False, None)[0][0]
    assert mb.multibox_nms.launches == before + 1
    assert torch.equal(card.cpu(), host)


def test_scalar_ops_and_multibox_prior_capture(dev):
    """Ops that make a tensor from a Python scalar (``_maximum_scalar``,
    ``clip``'s bounds, ``MultiBoxPrior``'s box sizes) fill it on the
    device: a host-to-device copy cannot run inside a CUDA graph
    capture."""
    from mxnet_tpu_torch.ops import get_op
    mx_op, prior = get_op('_maximum_scalar'), get_op('MultiBoxPrior')
    clip = get_op('clip')
    x = torch.randn(4, 8, 5, 5, device=dev)

    def body():
        y = mx_op.apply(mx_op.canon_attrs({'scalar': 0.25}), [x], False,
                        None)[0][0]
        a = prior.apply(prior.canon_attrs({'sizes': (0.2, 0.3),
                                           'ratios': (1, 2, 0.5)}),
                        [x], False, None)[0][0]
        c = clip.apply(clip.canon_attrs({'a_min': -0.5, 'a_max': 0.5}),
                       [x], False, None)[0][0]
        return y, a, c

    want = body()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = body()
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
