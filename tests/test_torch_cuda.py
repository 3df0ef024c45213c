"""Tests of the PyTorch port that need the card: each CUDA kernel against
its plain version (the GEMM kernels' sm90 route also at the edge cases it
must get right), and small fused Predictor / LM train steps on the GPU
against the CPU.  Marked ``cuda``; they skip on a host without a CUDA
device.  On the GPU host:

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
