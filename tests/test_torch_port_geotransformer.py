"""One GeoTransformer train step of the port against the JAX package's
``make_value_and_grad`` on the CPU, with the tolerances of
``test_torch_port_variants_train.py``.

The JAX package's gradient is NaN for this family: its structure embedding
differentiates ``sqrt`` and ``arctan2`` at the zero-length pair vectors of
the diagonal, and on stage 2 the points are the vote layer's differentiable
shifts. The port stops the gradient at the embedding's indices, as upstream
GeoTransformer does. The comparison runs JAX with the same stop (the
embedding's points through ``lax.stop_gradient``, patched in this test
only); another test pins the unpatched JAX gradient as NaN.
"""

import jax
import numpy as np
import pytest

from rdmnet_tpu.nn import geotransformer as jax_geo
from test_torch_port_variants import VARIANTS
from test_torch_port_variants_train import check_gradients, check_losses, run_step


@pytest.fixture(scope="module")
def run():
    cls = jax_geo.GeometricStructureEmbedding
    call = cls.__call__
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "__call__",
                   lambda self, points, valid=None: call(self, jax.lax.stop_gradient(points), valid))
        return run_step(VARIANTS["geotransformer"])


def test_losses_match_jax(run):
    check_losses(run)


def test_gradients_match_jax(run):
    check_gradients(run)


def test_jax_gradient_is_nan_port_finite():
    unpatched = run_step(VARIANTS["geotransformer"])
    assert np.isnan(unpatched["jmetrics"]["grad_norm"])
    assert np.isfinite(unpatched["tmetrics"]["grad_norm"]) and unpatched["tmetrics"]["grad_norm"] > 0
