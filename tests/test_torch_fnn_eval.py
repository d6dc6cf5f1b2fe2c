"""The port's chain-batched FNN eval (``ptnn_torch.ops.fnn_eval``) against
ptnn's Pallas eval kernel (``pallas_eval.fnn_eval_pallas``, interpret mode)
and against ``ptnn.ops.likelihood`` (the per-step sampler's XLA eval), on
the same numpy-seeded weights and rows, at chain counts that are not a
multiple of 128.

ll is held to rtol 2e-5 of the size of its cancelling terms (regression:
``n/2 |log 2 pi tau|`` + ``SSE / (2 tau)``; classification: its own size),
atol 1e-4. Regression rmse within rtol 1e-5. Classification rmse and acc
are exact functions of the first argmax: equal, bit for bit, on every chain
with no row whose argmax a 1e-5 move of the logits flips
(``block_step.argmax_fragile``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptnn.ops import likelihood as jlik
from ptnn.ops import pallas_eval
from ptnn_torch.data import load_classification
from ptnn_torch.models import fnn
from ptnn_torch.ops import block_step, fnn_eval

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("c", [5, 13])
def test_regression_eval_matches_ptnn(rng, c):
    topo = (4, 10, 1)
    n = 29
    w = rng.standard_normal((c, fnn.w_size(topo))).astype(np.float32)
    x = rng.random((n, 4)).astype(np.float32)
    y = rng.random(n).astype(np.float32)
    tau = (rng.random(c) * 0.2 + 0.01).astype(np.float32)
    before = fnn_eval.launches
    ll, rmse, acc = fnn_eval.fnn_eval(_t(w), _t(x), _t(y), _t(tau), topo,
                                      "regression")
    assert fnn_eval.launches == before
    k_ll, k_rmse, _ = pallas_eval.fnn_eval_pallas(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(y).reshape(-1, 1), jnp.asarray(tau), topo, "regression",
        interpret=True)
    ref = jax.jit(jax.vmap(jlik.regression_eval,
                           in_axes=(0, None, None, 0, None)),
                  static_argnums=4)(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(y), jnp.asarray(tau),
        topo)
    sse = np.asarray(ref.rmse, np.float64) ** 2 * n
    terms = 0.5 * n * np.abs(np.log(2 * np.pi * tau)) + 0.5 * sse / tau
    for want_ll, want_rmse in ((k_ll, k_rmse), (ref.loglik, ref.rmse)):
        assert np.all(np.abs(ll.numpy() - np.asarray(want_ll))
                      <= 1e-4 + 2e-5 * terms)
        np.testing.assert_allclose(rmse.numpy(), np.asarray(want_rmse),
                                   rtol=1e-5, atol=1e-7)
    assert not acc.any()


@pytest.mark.parametrize("c", [6, 13])
def test_classification_eval_matches_ptnn(rng, c):
    prob = load_classification("iris")
    topo = (4, 12, 3)
    w = rng.standard_normal((c, fnn.w_size(topo))).astype(np.float32)
    for rows in (prob.train, prob.test):
        x = rows[:, :4].astype(np.float32)
        y = rows[:, 4].astype(np.float32)
        ll, rmse, acc = fnn_eval.fnn_eval(_t(w), _t(x), _t(y), None, topo,
                                          "classification")
        t = jax.nn.one_hot(jnp.asarray(y, jnp.int32), 3)
        k_ll, k_rmse, k_acc = pallas_eval.fnn_eval_pallas(
            jnp.asarray(w), jnp.asarray(x), jnp.asarray(y), t,
            jnp.ones((c,), jnp.float32), topo, "classification",
            interpret=True)
        # jitted, as in the sampler: XLA folds the means into products
        ref = jax.jit(jax.vmap(jlik.classification_eval,
                               in_axes=(0, None, None, None)),
                      static_argnums=3)(
            jnp.asarray(w), jnp.asarray(x), jnp.asarray(y), topo)
        sure = ~block_step.argmax_fragile(_t(w), _t(x), topo).numpy()
        assert sure.sum() >= c - 1
        for want in ((k_ll, k_rmse, k_acc), (ref.loglik, ref.rmse, ref.acc)):
            want_ll = np.asarray(want[0])
            assert np.all(np.abs(ll.numpy() - want_ll)
                          <= 1e-4 + 2e-5 * np.abs(want_ll))
        # the XLA eval's metrics: bit for bit (the folded 1/n constants);
        # the Pallas kernel divides, within a float rounding of them
        np.testing.assert_array_equal(rmse.numpy()[sure],
                                      np.asarray(ref.rmse)[sure])
        np.testing.assert_array_equal(acc.numpy()[sure],
                                      np.asarray(ref.acc)[sure])
        np.testing.assert_allclose(rmse.numpy()[sure],
                                   np.asarray(k_rmse)[sure], rtol=1e-6)
        np.testing.assert_allclose(acc.numpy()[sure],
                                   np.asarray(k_acc)[sure], rtol=1e-6)
        assert 0.0 < acc.max() <= 100.0


def test_eval_gates():
    w, x, y = torch.zeros((3, 61)), torch.zeros((5, 4)), torch.zeros(5)
    with pytest.raises(ValueError, match="unknown task"):
        fnn_eval.fnn_eval(w, x, y, None, (4, 10, 1), "ranking")
    with pytest.raises(ValueError, match="one device type"):
        fnn_eval.fnn_eval(w.to("meta"), x, y, torch.ones(3), (4, 10, 1),
                          "regression")
    # the kernel's shared memory: weights plus a transposed 128-row tile
    assert fnn_eval.smem_bytes((34, 50, 2)) == 4 * (1852 + 35 * 128)
