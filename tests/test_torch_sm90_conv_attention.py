"""The sm90 routes of fused_scale_bias_conv3x3 and flash_attention, on the
CPU: which calls take them (``conv3x3_route``, ``attention_route``), the
tile plan the conv wrapper passes to the kernel (``_sm90_plan``), the
(F, 9C) weight it builds, and a CPU model of the conv kernel's implicit
GEMM — the tap-major K order, rows gathered per tap with out-of-range
pixels read as zeros (TMA's im2col fill), the prologue on every row and
the halo rows set back to 0 after it — held against the JAX package's
``_pallas_conv`` (in Pallas interpret mode where its block rules admit
the shape, its reference elsewhere).  The kernels themselves run only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: float32 rtol 1e-5, atol 1e-5 against JAX (the same f32
prologue; the nine-tap sums run in another order); bfloat16 relative
error <= 0.05 of the output's scale (bench.py's bf16 kernel bound)."""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import pallas_conv as pc
from mxnet_tpu_torch import models
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.ops import attention, fused, fused_conv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the path-shape readers of the smoke test)

# (N, H, W, C, F, stride) -> launches per step of fused_scale_bias_conv3x3
# in the aggressive ResNet-50 v2 training graph at 32 rows, with the sm90
# tile width the plan gives each on a 132-SM H100
CONV_PATH = {
    (32, 56, 56, 64, 64, 1): (3, 64),
    (32, 56, 56, 128, 128, 2): (1, 128),
    (32, 28, 28, 128, 128, 1): (3, 128),
    (32, 28, 28, 256, 256, 2): (1, 128),
    (32, 14, 14, 256, 256, 1): (5, 128),
    (32, 14, 14, 512, 512, 2): (1, 64),
    (32, 7, 7, 512, 512, 1): (2, 64)}
# (BH, Tq, Tk, D, causal, scale) -> launches per step of flash_attention
# in the transformer LM's aggressive training graph at 16 x 512 tokens
LM_FLASH = {(128, 512, 512, 64, True, 0.125): 6}
H100_SMS = 132


def _conv_args(shape, dtype=torch.bfloat16, x_offset=0, oihw_view=True):
    """x NHWC and w HWIO as the path passes them (w the HWIO view of a
    contiguous OIHW weight); ``x_offset`` shifts x's base by elements."""
    n, h, wd, c, f, _ = shape
    x = torch.empty(n * h * wd * c + x_offset,
                    dtype=dtype)[x_offset:].view(n, h, wd, c)
    w = torch.empty(f, c, 3, 3, dtype=dtype).permute(2, 3, 1, 0)
    return x, (w if oihw_view else w.contiguous())


def test_path_shapes_are_read_from_the_fused_graphs():
    sym = resnet.get_symbol(num_classes=1000, num_layers=50,
                            image_shape=chip_smoke.IMAGE)
    _, convs, _ = chip_smoke.train_kernel_shapes(tmx, sym, chip_smoke.BATCH)
    assert dict(convs) == {k: v[0] for k, v in CONV_PATH.items()}
    assert sum(convs.values()) == 16
    _, atts = chip_smoke.lm_kernel_shapes(
        tmx, chip_smoke.lm_symbol(models), chip_smoke.LM_BATCH,
        chip_smoke.LM['seq_len'])
    assert dict(atts) == LM_FLASH


@pytest.mark.parametrize('shape', sorted(CONV_PATH),
                         ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('oihw_view', [True, False],
                         ids=['oihw_view', 'hwio'])
def test_conv_path_shapes_take_sm90(shape, oihw_view):
    x, w = _conv_args(shape, oihw_view=oihw_view)
    assert fused_conv.conv_route(x, w) == 'sm90'
    assert fused_conv.conv_route(x.float(), w.float()) == 'simt'


@pytest.mark.parametrize('shape', sorted(CONV_PATH),
                         ids=lambda s: 'x'.join(map(str, s)))
def test_conv_sm90_plan_at_the_path_shapes(shape):
    """The tile plan of each path shape: the widths of the reckoning
    (BN 64 / 128 / 128 / 128 / 128 / 64 / 64), legal stages, one block
    per SM at most."""
    n, h, wd, _, f, stride = shape
    oh, ow = fused_conv.conv3x3_out_hw(h, wd, stride)
    m = n * oh * ow
    bn, stages, grid = fused._sm90_plan(m, f, H100_SMS)
    assert bn == CONV_PATH[shape][1]
    assert stages >= 2 and fused._sm90_smem(bn, stages) <= \
        fused.SM90_SMEM_LIMIT
    assert grid == min(H100_SMS, -(-m // 128) * -(-f // bn))


@pytest.mark.parametrize('case,want', [
    ('c24_f40', 'wmma'),        # C not a multiple of 64: no one-tap K step
    ('c64_f36', 'wmma'),        # F off the multiples of 8
    ('c64_f40', 'sm90'),        # a ragged BN = 64 tile is fine
    ('c192', 'sm90'),
    ('x_misaligned', 'wmma'),   # x's base 2 bytes off 16
    ('f32', 'simt'),
    ('f64', TypeError),
])
def test_conv_route_off_the_path(case, want):
    shape = {'c24_f40': (3, 15, 13, 24, 40, 2),
             'c64_f36': (2, 8, 8, 64, 36, 1),
             'c64_f40': (3, 15, 13, 64, 40, 2),
             'c192': (2, 14, 15, 192, 128, 2)}.get(case, (2, 8, 8, 64, 64, 1))
    dtype = {'f32': torch.float32, 'f64': torch.float64}.get(
        case, torch.bfloat16)
    x, w = _conv_args(shape, dtype, x_offset=1 if case == 'x_misaligned'
                      else 0)
    if isinstance(want, type):
        with pytest.raises(want):
            fused_conv.conv_route(x, w)
    else:
        assert fused_conv.conv_route(x, w) == want


def test_conv3x3_route_is_a_pure_rule():
    bf = torch.bfloat16
    assert fused_conv.conv3x3_route(bf, 64, 64, (0, 16, 32)) == 'sm90'
    assert fused_conv.conv3x3_route(bf, 512, 512, ()) == 'sm90'
    assert fused_conv.conv3x3_route(bf, 96, 64, (0,)) == 'wmma'
    assert fused_conv.conv3x3_route(bf, 64, 12, (0,)) == 'wmma'
    assert fused_conv.conv3x3_route(bf, 64, 64, (0, 8)) == 'wmma'
    assert fused_conv.conv3x3_route(torch.float32, 64, 64, (8,)) == 'simt'
    with pytest.raises(TypeError):
        fused_conv.conv3x3_route(torch.float16, 64, 64, ())


def test_conv3x3_weight_fk_is_tap_major():
    """Row f, column (3 dy + dx) C + c of the (F, 9C) matrix is
    w[dy, dx, c, f], from an HWIO tensor and from the HWIO view of an
    OIHW one alike."""
    rng = np.random.RandomState(3)
    c, f = 5, 7
    w = torch.from_numpy(rng.randn(3, 3, c, f).astype(np.float32))
    view = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    for hwio in (w, view):
        wfk = fused_conv.conv3x3_weight_fk(hwio)
        assert wfk.shape == (f, 9 * c) and wfk.is_contiguous()
        for dy in range(3):
            for dx in range(3):
                tap = 3 * dy + dx
                assert torch.equal(wfk[:, tap * c:(tap + 1) * c],
                                   w[dy, dx].t())


def _implicit_gemm(x, w, scale, bias, stride, relu=True):
    """A CPU model of the sm90 kernel's arithmetic: A (M, 9C) built tap by
    tap — for tap (dy, dx) row m = (n, oh, ow) holds input pixel
    (oh s - 1 + dy, ow s - 1 + dx), read as zeros outside the image (the
    im2col box's fill), then the prologue (the affine in f32, relu,
    rounded to x's dtype) on every row, then the halo rows written back
    to 0 -- times the (F, 9C) weight the wrapper builds, accumulated in
    f32 and stored in x's dtype."""
    n, h, wd, c = x.shape
    f = w.shape[3]
    oh, ow = fused_conv.conv3x3_out_hw(h, wd, stride)
    m = torch.arange(n * oh * ow)
    img, pix = m // (oh * ow), m % (oh * ow)
    ih0, iw0 = (pix // ow) * stride - 1, (pix % ow) * stride - 1
    taps = []
    for tap in range(9):
        ih, iw = ih0 + tap // 3, iw0 + tap % 3
        inside = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < wd)
        rows = torch.zeros(m.numel(), c, dtype=x.dtype)
        rows[inside] = x[img[inside], ih[inside], iw[inside]]
        act = rows.float() * scale.float() + bias.float()
        if relu:
            act = torch.relu(act)
        act = act.to(x.dtype)
        act[~inside] = 0
        taps.append(act)
    a = torch.cat(taps, dim=1).float()
    b = fused_conv.conv3x3_weight_fk(w).float()
    return (a @ b.t()).to(x.dtype).reshape(n, oh, ow, f)


def _model_inputs(shape, seed):
    """Numpy inputs with a positive bias: every pixel's prologue is > 0,
    so a halo row left at relu(bias) would show in every border output."""
    n, h, wd, c, f = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h, wd, c).astype(np.float32) * 0.5,
            rng.randn(3, 3, c, f).astype(np.float32) * 0.2,
            rng.rand(c).astype(np.float32) + 0.5,
            np.abs(rng.randn(c)).astype(np.float32) * 0.2 + 0.1)


def _jax(args, stride, relu, dtype, monkeypatch):
    monkeypatch.setenv('MXTPU_FORCE_PALLAS_INTERPRET', '1')
    ja = [jnp.asarray(a).astype(dtype) for a in args]
    out = pc.fused_scale_bias_conv3x3(*ja, stride=stride, relu=relu)
    return np.asarray(out.astype(jnp.float32))


# (n, h, w, c, f), stride: odd H and W at stride 1 and even at stride 2
# (the Pallas kernel in interpret mode), odd at stride 2 (the JAX
# reference: the Pallas kernel's stride-2 taps need even sizes)
MODEL_CASES = [((2, 7, 9, 64, 64), 1), ((2, 8, 8, 64, 64), 2),
               ((2, 7, 9, 64, 64), 2), ((1, 5, 3, 128, 16), 1)]


@pytest.mark.parametrize('relu', [True, False], ids=['relu', 'affine'])
@pytest.mark.parametrize('shape,stride', MODEL_CASES,
                         ids=lambda v: 'x'.join(map(str, v))
                         if isinstance(v, tuple) else 's%d' % v)
def test_implicit_gemm_model_matches_jax_f32(shape, stride, relu,
                                             monkeypatch):
    args = _model_inputs(shape, seed=11)
    ts = [torch.from_numpy(a) for a in args]
    got = _implicit_gemm(*ts, stride, relu)
    want = _jax(args, stride, relu, jnp.float32, monkeypatch)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(),
        fused_conv.fused_scale_bias_conv3x3_plain(*ts, stride, relu).numpy(),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('shape,stride', MODEL_CASES[:3],
                         ids=lambda v: 'x'.join(map(str, v))
                         if isinstance(v, tuple) else 's%d' % v)
def test_implicit_gemm_model_matches_jax_bf16(shape, stride, monkeypatch):
    args = _model_inputs(shape, seed=12)
    got = _implicit_gemm(
        *[torch.from_numpy(a).to(torch.bfloat16) for a in args], stride)
    assert got.dtype == torch.bfloat16
    want = _jax(args, stride, True, jnp.bfloat16, monkeypatch)
    err = np.max(np.abs(got.float().numpy() - want))
    assert err / np.max(np.abs(want)) <= 0.05


def test_implicit_gemm_model_keeps_the_halo_at_zero():
    """x = 0 and bias 2 (relu(bias) = 2 everywhere): a corner output sums
    4 live taps, an edge 6 and an interior 9, at stride 1 and 2."""
    for stride, want in ((1, [[8, 12, 8], [12, 18, 12], [8, 12, 8]]),
                         (2, [[8, 12], [12, 18]])):
        x = torch.zeros(1, 3, 3, 1) if stride == 1 else \
            torch.zeros(1, 4, 4, 1)
        y = _implicit_gemm(x, torch.ones(3, 3, 1, 1), torch.ones(1),
                           torch.full((1,), 2.0), stride)
        assert y[0, :, :, 0].tolist() == want


def test_fused_graph_passes_the_conv_weight_view(monkeypatch):
    """The 3x3 lowering hands the kernel the HWIO view of the OIHW weight
    (no copy of its own: the launch makes the one its route reads)."""
    seen = []
    orig = fused_conv.fused_scale_bias_conv3x3

    def spy(x, w, scale, bias, stride=1, relu=True):
        seen.append((w.is_contiguous(), w.permute(3, 2, 0, 1).is_contiguous(),
                     tuple(w.shape)))
        return orig(x, w, scale, bias, stride, relu)

    from mxnet_tpu_torch import fuse
    rng = np.random.RandomState(7)
    data = torch.from_numpy(rng.randn(2, 8, 6, 6).astype(np.float32))
    ins = [data, torch.ones(8), torch.zeros(8),
           torch.from_numpy(rng.randn(16, 8, 3, 3).astype(np.float32)),
           torch.zeros(8), torch.ones(8)]
    attrs = {'kernel': (3, 3), 'stride': (2, 2), 'pad': (1, 1),
             'num_filter': 16, 'eps': 1e-5, 'fix_gamma': False}
    monkeypatch.setattr(fuse, 'fused_scale_bias_conv3x3', spy)
    (y,), _ = fuse._bn_relu_conv_apply(attrs, ins, True, None)
    assert seen == [(False, True, (3, 3, 8, 16))]
    assert y.shape == (2, 16, 3, 3)


def test_conv_weight_layouts_give_the_same_bits():
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(2, 5, 5, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 8, 4).astype(np.float32))
    s = torch.from_numpy(rng.rand(8).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.randn(8).astype(np.float32))
    view = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
    assert torch.equal(fused_conv.fused_scale_bias_conv3x3(x, view, s, b),
                       fused_conv.fused_scale_bias_conv3x3(x, w, s, b))
    with pytest.raises(ValueError, match='HWIO'):
        # neither contiguous HWIO nor the HWIO view of contiguous OIHW
        fused_conv.fused_scale_bias_conv3x3(
            x, w.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2), s, b)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

def _qkvo(bh, tq, tk, d, dtype=torch.bfloat16, offset=0):
    q = torch.empty(bh * tq * d + offset, dtype=dtype)[offset:] \
        .view(bh, tq, d)
    k = torch.empty(bh, tk, d, dtype=dtype)
    return [t.data_ptr() for t in (q, k, k, q)]


def test_lm_path_shape_takes_sm90():
    (bh, tq, tk, d, _, _), = LM_FLASH
    assert attention.attention_route(torch.bfloat16, d,
                                     _qkvo(bh, tq, tk, d)) == 'sm90'
    assert attention.attention_route(torch.float32, d,
                                     _qkvo(bh, tq, tk, d, torch.float32)) \
        == 'simt'


@pytest.mark.parametrize('d,offset,want', [
    (64, 0, 'sm90'), (128, 0, 'sm90'),
    (72, 0, 'mma'),              # not whole 64-column TMA boxes
    (40, 0, 'mma'), (32, 0, 'mma'),
    (64, 1, 'mma'),              # q's base 2 bytes off 16
])
def test_attention_route_off_the_path(d, offset, want):
    assert attention.attention_route(
        torch.bfloat16, d, _qkvo(4, 300, 700, d, offset=offset)) == want


def test_attention_route_is_a_pure_rule():
    assert attention.attention_route(torch.bfloat16, 64, ()) == 'sm90'
    assert attention.attention_route(torch.bfloat16, 128, (16, 32)) == 'sm90'
    assert attention.attention_route(torch.bfloat16, 64, (16, 40)) == 'mma'
    assert attention.attention_route(torch.float32, 72, (3,)) == 'simt'
    with pytest.raises(TypeError):
        attention.attention_route(torch.float16, 64, ())


def test_launches_by_route_counts_only_card_launches():
    conv = fused_conv.fused_scale_bias_conv3x3
    assert set(conv.launches_by_route) == set(fused.ROUTES)
    assert set(attention.flash_attention.launches_by_route) == \
        set(attention.ROUTES) == {'sm90', 'mma', 'simt'}
    before = (dict(conv.launches_by_route),
              dict(attention.flash_attention.launches_by_route))
    x, w = torch.ones(1, 4, 4, 64), torch.ones(3, 3, 64, 8)
    conv(x, w, torch.ones(64), torch.zeros(64))
    q = torch.ones(2, 8, 64)
    attention.flash_attention(q, q, q, causal=True)
    assert (conv.launches_by_route,
            attention.flash_attention.launches_by_route) == before
