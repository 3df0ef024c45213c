"""Forwards of the PyTorch port's image classifiers against the JAX
package on the CPU, from the same numpy parameters
(``convert.random_params``, He-scaled) and images, at the sizes the
reference's own tests use (``tests/test_models.py``,
``tests/test_model_zoo_extra.py``).  VGG at 32 x 32 and Inception-v3 at
299 x 299 are the smallest sizes their ``infer_shape`` accepts (VGG's
five pools reach 1 x 1; Inception-v3's stem and reductions need 299, its
published input).  GoogLeNet runs at 256 x 256 where the reference's
test uses 224: the JAX package's graph there ends in a 0 x 0 pool (a
reference fault, ROADMAP Queue 3: the JAX package softmaxes the
classifier's bias alone, torch refuses an empty pool), and 256 is the
smallest size that keeps it 1 x 1.  Probabilities through a whole network are long sums: rtol 1e-4,
atol 1e-5, and the rows sum to 1.  The Inception family, the slowest on
one CPU worker, is in ``tests/test_torch_zoo_inception.py``."""
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


FORWARD = [
    ('mlp', (2, 784), {}),
    ('lenet', (2, 1, 28, 28), {}),
    ('resnet-18', (1, 3, 224, 224), {}),
    ('googlenet', (2, 3, 256, 256), {}),
    ('resnext-50', (2, 3, 64, 64), {}),
    ('resnext', (2, 3, 32, 32), {'num_layers': 20,
                                 'image_shape': (3, 32, 32)}),
    ('vgg16', (2, 3, 32, 32), {}),
    ('vgg', (2, 3, 32, 32), {'num_layers': 11, 'batch_norm': True}),
]


@pytest.mark.parametrize('name,dshape,kw', FORWARD,
                         ids=[f[0] + ('-bn' if f[2].get('batch_norm')
                                      else '') for f in FORWARD])
def test_forward_matches_jax(name, dshape, kw):
    forward_case(name, dshape, kw)
