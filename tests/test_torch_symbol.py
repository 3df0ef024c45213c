"""Symbol JSON and .params interchange between the JAX package and the
PyTorch port: ResNet-50 v2 symbol JSON written by mxnet_tpu loads in the
port with the same arguments, aux states and inferred shapes, and
round-trips; .params files written by either package load in the other
unchanged."""
import json

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import resnet as jax_resnet
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import resnet as torch_resnet


@pytest.fixture(scope='module')
def resnet50_json():
    return jax_resnet.get_symbol(num_classes=1000, num_layers=50).tojson()


def test_resnet50_json_loads_with_same_surface(resnet50_json):
    js = mx.sym.load_json(resnet50_json)
    ts = tmx.sym.load_json(resnet50_json)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()
    assert len(ts.get_internals().list_outputs()) == \
        len(js.get_internals().list_outputs())


def test_resnet50_infer_shape_matches(resnet50_json):
    js = mx.sym.load_json(resnet50_json)
    ts = tmx.sym.load_json(resnet50_json)
    want = js.infer_shape(data=(2, 3, 224, 224))
    got = ts.infer_shape(data=(2, 3, 224, 224))
    assert got == tuple(want)
    assert got[1] == [(2, 1000)]


def test_resnet50_json_round_trips(resnet50_json):
    ts = tmx.sym.load_json(resnet50_json)
    # port -> JSON -> port, and port JSON -> JAX package
    again = tmx.sym.load_json(ts.tojson())
    assert again.tojson() == ts.tojson()
    back = mx.sym.load_json(ts.tojson())
    assert back.list_arguments() == ts.list_arguments()
    assert back.list_auxiliary_states() == ts.list_auxiliary_states()
    assert json.loads(ts.tojson()) == json.loads(resnet50_json)


def test_ported_model_builds_the_same_graph():
    """models/resnet.py of the port builds the JAX package's graph."""
    kw = dict(units=[1, 1, 1, 1], num_stages=4,
              filter_list=[8, 16, 32, 64, 128], num_classes=10,
              image_shape=(3, 64, 64))
    # fresh name scopes: auto-named nodes (pooling0, _plus0, ...) count
    # per scope
    with tmx.base.NameManager():
        got = json.loads(torch_resnet.resnet(**kw).tojson())
    with mx.base.NameManager():
        want = json.loads(jax_resnet.resnet(**kw).tojson())
    assert got == want


def _params(seed):
    r = np.random.RandomState(seed)
    return {'arg:fc_weight': r.randn(4, 3).astype(np.float32),
            'arg:fc_bias': r.randn(4).astype(np.float32),
            'aux:bn_moving_var': r.rand(5).astype(np.float32),
            'arg:ids': np.arange(6, dtype=np.int32).reshape(2, 3)}


def test_params_from_jax_load_in_port(tmp_path):
    src = _params(0)
    path = str(tmp_path / 'jax.params')
    mx.nd.save(path, {k: mx.nd.array(v, dtype=v.dtype)
                      for k, v in src.items()})
    got = convert.load_params(path)
    assert sorted(got) == sorted(src)
    for k, v in src.items():
        assert got[k].asnumpy().dtype == v.dtype
        np.testing.assert_array_equal(got[k].asnumpy(), v)


def test_params_from_port_load_in_jax(tmp_path):
    src = _params(1)
    tpath, jpath = str(tmp_path / 'port.params'), str(tmp_path / 'j.params')
    tmx.nd.save(tpath, {k: tmx.nd.array(v, dtype=v.dtype)
                        for k, v in src.items()})
    got = mx.nd.load(tpath)
    for k, v in src.items():
        np.testing.assert_array_equal(got[k].asnumpy(), v)
    # same container, byte for byte
    mx.nd.save(jpath, {k: mx.nd.array(v, dtype=v.dtype)
                       for k, v in src.items()})
    with open(tpath, 'rb') as a, open(jpath, 'rb') as b:
        assert a.read() == b.read()


def test_params_from_numpy_places_and_prefixes():
    src = _params(2)
    arg = {k[4:]: v for k, v in src.items() if k.startswith('arg:')}
    aux = {k[4:]: v for k, v in src.items() if k.startswith('aux:')}
    out = convert.params_from_numpy(arg, aux, 'cpu')
    assert sorted(out) == sorted(src)
    for k, v in src.items():
        assert out[k].context == tmx.cpu()
        np.testing.assert_array_equal(out[k].asnumpy(), v)


LEGACY_JSON = json.dumps({
    # pre-0.9 style: params under 'param', a bare hidden key, and an FC
    # whose weight/bias variables are not stored
    'nodes': [
        {'op': 'null', 'name': 'data', 'inputs': []},
        {'op': 'FullyConnected', 'name': 'fc',
         'param': {'num_hidden': '4', 'lr_mult': '2',
                   'weight_wd_mult': '0.5'},
         'inputs': [[0, 0]]},
        {'op': 'Activation', 'name': 'act', 'attr': {'act_type': 'relu'},
         'inputs': [[1, 0]]}],
    'arg_nodes': [0], 'heads': [[2, 0]]})


def test_legacy_json_upgrade_matches_jax():
    t = tmx.sym.load_json(LEGACY_JSON)
    j = mx.sym.load_json(LEGACY_JSON)
    assert t.list_arguments() == j.list_arguments() == \
        ['data', 'fc_weight', 'fc_bias']
    assert t.attr_dict() == j.attr_dict()
    assert t.infer_shape(data=(2, 3)) == tuple(j.infer_shape(data=(2, 3)))
    assert json.loads(t.tojson()) == json.loads(j.tojson())


def test_compose_and_attrs_match_jax():
    """Composition (plugging a symbol into free variables) and attribute
    scoping build the same graph and attrs in both packages."""
    def build(pkg):
        with pkg.base.NameManager(), pkg.base.AttrScope(ctx_group='dev1'):
            data = pkg.sym.Variable('data', lr_mult=2)
            head = pkg.sym.FullyConnected(pkg.sym.Variable('x'),
                                          num_hidden=4, name='fc')
            body = pkg.sym.Activation(data, act_type='relu', name='act')
            net = head(x=body, name='fc2')
            net._set_attr(mood='calm')
        return net
    t, j = build(tmx), build(mx)
    assert t.list_arguments() == j.list_arguments() == \
        ['data', 'fc_weight', 'fc_bias']
    assert t.attr_dict() == j.attr_dict()
    assert t.attr('mood') == j.attr('mood') == 'calm'
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert json.loads(t.tojson()) == json.loads(j.tojson())


# ---------------------------------------------------------------------------
# Symbol features: partial shape inference, types, eval, children,
# debug_str, pickling, maximum / minimum / pow
# ---------------------------------------------------------------------------

def _partial_cases(pkg):
    """(symbol, known shapes) pairs that need the constraint pass or stay
    partly unknown."""
    s = pkg.sym
    data = s.Variable('data')
    fc = s.FullyConnected(data, num_hidden=8, name='fc')
    a, b = s.Variable('a'), s.Variable('b')
    conv = s.Convolution(s.Variable('img'), kernel=(3, 3), num_filter=4,
                         pad=(1, 1), name='conv')
    cat = s.Concat(s.Variable('x'), s.Variable('y'), dim=1, name='cat')
    split = s.SliceChannel(s.Variable('z'), num_outputs=2, axis=1,
                           name='split')
    two = s.FullyConnected(s.Variable('u') + s.Variable('v'), num_hidden=3,
                           name='two')
    return [
        (fc, {'data': (0, 5)}),
        (fc, {}),
        (a + b, {'a': (2, 3)}),
        (s.Activation(a * b, act_type='relu'), {'b': (4, 0)}),
        (conv, {'img': (0, 2, 6, 6)}),
        (cat, {'x': (2, 3), 'y': (2, 5)}),
        (s.Group([split[0], split[1]]), {'z': (2, 6)}),
        (two, {'u': (5, 7)}),
    ]


@pytest.mark.parametrize('case', range(8))
def test_infer_shape_partial_matches_jax(case):
    """infer_shape_partial through the constraint pass (elementwise
    merges, FullyConnected, Convolution, Concat, SliceChannel) and with
    inputs left unknown: the same (arg, out, aux) shapes as the JAX
    package, and infer_shape's answer alike (None or raising)."""
    tsym, known = _partial_cases(tmx)[case]
    jsym, _ = _partial_cases(mx)[case]
    assert tsym.infer_shape_partial(**known) == \
        jsym.infer_shape_partial(**known)
    try:
        want = jsym.infer_shape(**known)
    except mx.MXNetError:
        with pytest.raises(tmx.MXNetError):
            tsym.infer_shape(**known)
    else:
        assert tsym.infer_shape(**known) == want


def test_infer_shape_completes_a_zero_dim_from_an_output():
    """An unknown input dim (0) filled through an elementwise op from the
    other operand, in both packages."""
    for pkg in (tmx, mx):
        a, b = pkg.sym.Variable('a'), pkg.sym.Variable('b')
        args, outs, _ = (a + b).infer_shape(a=(0, 4), b=(3, 4))
        assert args == [(3, 4), (3, 4)] and outs == [(3, 4)]


def _type_name(t):
    return None if t is None else str(t).replace('torch.', '').replace(
        "<class 'numpy.", '').replace("'>", '')


@pytest.mark.parametrize('dtype', ['float32', 'float16'])
def test_infer_type_matches_jax(dtype):
    names = {}
    for pkg in (tmx, mx):
        net = pkg.sym.FullyConnected(pkg.sym.Variable('data'), num_hidden=4,
                                     name='fc')
        net = pkg.sym.SoftmaxOutput(pkg.sym.Activation(net,
                                                       act_type='relu'))
        names[pkg] = [[_type_name(t) for t in ts]
                      for ts in net.infer_type(data=dtype)]
    assert names[tmx] == names[mx]
    assert names[tmx][0][0] == dtype


def test_eval_children_debug_str_match_jax():
    r = np.random.RandomState(0)
    x, y = r.randn(2, 3).astype(np.float32), r.randn(2, 3).astype(np.float32)
    res = {}
    for pkg in (tmx, mx):
        a, b = pkg.sym.Variable('a'), pkg.sym.Variable('b')
        net = pkg.sym.Activation(pkg.sym._plus(pkg.sym._mul(a, b,
                                                            name='prod'),
                                               a, name='sum'),
                                 act_type='tanh', name='act')
        out = net.eval(ctx=pkg.cpu(), a=pkg.nd.array(x), b=pkg.nd.array(y))
        kids = net.get_children()
        res[pkg] = (out[0].asnumpy(), kids.list_outputs(),
                    a.get_children(), net.debug_str())
    np.testing.assert_allclose(res[tmx][0], res[mx][0], rtol=1e-6)
    np.testing.assert_allclose(res[tmx][0], np.tanh(x * y + x), rtol=1e-6)
    assert res[tmx][1] == res[mx][1] and res[tmx][2] is None
    assert res[tmx][3] == res[mx][3]
    assert 'Activation act inputs=[' in res[tmx][3]
    with pytest.raises(NotImplementedError):
        tmx.sym.Variable('a').grad(['a'])


def test_symbols_pickle_and_deepcopy():
    import copy
    import pickle
    net = torch_resnet.get_symbol(num_classes=10, num_layers=20,
                                  image_shape=(3, 32, 32))
    for other in (pickle.loads(pickle.dumps(net)), copy.deepcopy(net)):
        assert other.tojson() == net.tojson()
        assert other.infer_shape(data=(2, 3, 32, 32)) == \
            net.infer_shape(data=(2, 3, 32, 32))
    deep = copy.deepcopy(net)
    deep.get_internals()[3]._outputs[0][0].name = 'renamed'
    assert 'renamed' not in net.tojson()


@pytest.mark.parametrize('fn', ['maximum', 'minimum', 'pow'])
def test_module_maximum_minimum_pow_match_jax(fn):
    r = np.random.RandomState(1)
    x = (r.rand(2, 3) + 0.5).astype(np.float32)
    y = (r.rand(1, 3) + 0.5).astype(np.float32)
    outs = {}
    for pkg in (tmx, mx):
        f = getattr(pkg.sym, fn)
        a, b = pkg.sym.Variable('a'), pkg.sym.Variable('b')
        args = {'a': pkg.nd.array(x), 'b': pkg.nd.array(y)}
        outs[pkg] = [s.eval(ctx=pkg.cpu(), **{k: v for k, v in args.items()
                                              if k in s.list_arguments()}
                            )[0].asnumpy()
                     for s in (f(a, b), f(a, 1.2), f(0.9, a))]
        outs[pkg].append(f(2.0, 3.0))
    for t, j in zip(outs[tmx], outs[mx]):
        np.testing.assert_allclose(t, j, rtol=1e-6)
