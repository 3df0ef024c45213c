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
