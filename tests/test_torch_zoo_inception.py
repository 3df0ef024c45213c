"""Forwards of the port's Inception family against the JAX package on
the CPU, as ``tests/test_torch_zoo_forward.py`` runs the other image
classifiers (the same rule and tolerances: rtol 1e-4, atol 1e-5, rows
summing to 1): Inception-BN at 224 x 224 (``tests/test_models.py``'s
size), Inception-ResNet-v2 (``tests/test_model_zoo_extra.py``'s) and
Inception-v3 at 299 x 299, its published input and the smallest its
``infer_shape`` accepts."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import models as jmodels
from mxnet_tpu.base import NameManager as JNames
from mxnet_tpu.executor import _build_graph_fn as jax_graph
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.base import NameManager as TNames
from mxnet_tpu_torch.executor import _build_graph_fn as torch_graph


def forward_case(name, dshape, kw):
    """The port's and the JAX package's class probabilities."""
    # fresh NameManagers: auto-named nodes (and so parameter names) count
    # per process
    with TNames():
        sym = tmodels.get_symbol(name, num_classes=10, **kw)
    with JNames():
        jsym = jmodels.get_symbol(name, num_classes=10, **kw)
    arg, aux = convert.random_params(sym, {'data': dshape}, 0)
    data = np.random.RandomState(1).rand(*dshape).astype(np.float32)
    label = np.zeros(dshape[0], np.float32)
    targs = {k: torch.from_numpy(v) for k, v in arg.items()}
    targs.update(data=torch.from_numpy(data),
                 softmax_label=torch.from_numpy(label))
    with torch.no_grad():
        tout, _ = torch_graph(sym, False)(
            targs, {k: torch.from_numpy(v) for k, v in aux.items()})
    jargs = {k: jnp.asarray(v) for k, v in arg.items()}
    jargs.update(data=jnp.asarray(data), softmax_label=jnp.asarray(label))
    jout, _ = jax_graph(jsym, False)(
        jargs, {k: jnp.asarray(v) for k, v in aux.items()},
        jax.random.PRNGKey(0))
    got, want = tout[0].numpy(), np.asarray(jout[0])
    assert got.shape == want.shape == (dshape[0], 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize('name,dshape', [
    ('inception-bn', (1, 3, 224, 224)),
    ('inception-resnet-v2', (1, 3, 299, 299)),
    ('inception-v3', (1, 3, 299, 299))])
def test_forward_matches_jax(name, dshape):
    forward_case(name, dshape, {})
