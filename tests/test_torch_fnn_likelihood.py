"""The port's FNN and regression likelihood/prior against ptnn's.

Same inputs, made with numpy, through ptnn.models.fnn / ptnn.ops.likelihood
and their ptnn_torch counterparts, on random (C, W) batches and on Sunspot.
Float32 on both sides; rtol 1e-5 (summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptnn.data import load_regression
from ptnn.models import fnn as jfnn
from ptnn.ops import likelihood as jlik
from ptnn_torch.models import fnn as tfnn
from ptnn_torch.ops import likelihood as tlik

torch.set_num_threads(1)

RTOL = 1e-5
TOPOS = [(4, 10, 1), (3, 5, 2)]


def _x(rng, c, topo, n):
    w = rng.normal(size=(c, tfnn.w_size(topo))).astype(np.float32)
    x = rng.normal(size=(n, topo[0])).astype(np.float32)
    return w, x


@pytest.mark.parametrize("topo", TOPOS)
def test_unpack_and_w_size_match(rng, topo):
    assert tfnn.w_size(topo) == jfnn.w_size(topo)
    w, _x0 = _x(rng, 3, topo, 1)
    for ci in range(3):
        jp = jfnn.unpack(jnp.asarray(w[ci]), topo)
        tp = tfnn.unpack(torch.from_numpy(w[ci]), topo)
        for name in ("w1", "b1", "w2", "b2"):
            np.testing.assert_array_equal(
                getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), name
            )
    # the batched view of a (C, W) array is the per-chain view stacked
    tb = tfnn.unpack(torch.from_numpy(w), topo)
    np.testing.assert_array_equal(
        tb.w1[1].numpy(), np.asarray(jfnn.unpack(jnp.asarray(w[1]), topo).w1)
    )


@pytest.mark.parametrize("topo", TOPOS)
def test_forward_matches(rng, topo):
    w, x = _x(rng, 7, topo, 33)
    ref = np.asarray(jax.vmap(lambda wi: jfnn.forward(wi, jnp.asarray(x), topo))(
        jnp.asarray(w)))
    got = tfnn.batched_forward(torch.from_numpy(w), torch.from_numpy(x), topo)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-7)
    one = tfnn.forward(torch.from_numpy(w[2]), torch.from_numpy(x), topo)
    np.testing.assert_allclose(one.numpy(), ref[2], rtol=RTOL, atol=1e-7)


def test_regression_eval_and_prior_on_sunspot(rng):
    topo = (4, 10, 1)
    prob = load_regression("Sunspot")
    x = prob.train[:, :4].astype(np.float32)
    y = prob.train[:, 4].astype(np.float32)
    w = rng.normal(size=(9, 61)).astype(np.float32)
    tau = np.exp(rng.normal(size=9) - 2.0).astype(np.float32)

    fx = np.array(jax.vmap(lambda wi: jfnn.forward(wi, jnp.asarray(x), topo))(
        jnp.asarray(w)))[:, :, 0]
    ref = jax.vmap(lambda f, t: jlik.regression_eval_from_fx(
        f, jnp.asarray(y), t))(jnp.asarray(fx), jnp.asarray(tau))
    got = tlik.regression_eval_from_fx(
        torch.from_numpy(fx), torch.from_numpy(y), torch.from_numpy(tau))
    np.testing.assert_allclose(got.loglik.numpy(), np.asarray(ref.loglik),
                               rtol=RTOL)
    np.testing.assert_allclose(got.rmse.numpy(), np.asarray(ref.rmse),
                               rtol=RTOL)

    for dim_fn in ("dim", "topo"):
        if dim_fn == "dim":
            refp = jax.vmap(lambda wi, t: jlik.regression_log_prior_dim(
                wi, t, 52, 25.0, 0.5, 0.1))(jnp.asarray(w), jnp.asarray(tau))
            gotp = tlik.regression_log_prior_dim(
                torch.from_numpy(w), torch.from_numpy(tau), 52, 25.0, 0.5, 0.1)
        else:
            refp = jax.vmap(lambda wi, t: jlik.regression_log_prior(
                wi, t, topo))(jnp.asarray(w), jnp.asarray(tau))
            gotp = tlik.regression_log_prior(
                torch.from_numpy(w), torch.from_numpy(tau), topo)
        np.testing.assert_allclose(gotp.numpy(), np.asarray(refp), rtol=RTOL)
    # the reference's dimension term: (I*H + H + 2), not the 61 parameters
    assert tlik.prior_dim_regression(topo) == 52
