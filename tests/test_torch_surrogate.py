"""The port's surrogate module (``ptnn_torch.surrogate``) against ptnn's
(``ptnn.surrogate``) on the same numpy inputs, made from a seed.

Features, the projection's shape and scale, ``push`` and ``push_masked`` in
both layouts across a ring wrap (exact), the quadratic fit (predictions and
r-squared within rtol 1e-4 of their size; theta only as far as the gram's
conditioning allows, so it is held through its predictions), the analytic
gradient against autograd, the MLP family over a few Adam iterations
(within 5e-5) and over the full 300 by in-buffer MSE, and ``init_for``'s
buffer guard with a model spec's real ``w_size``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import surrogate as jsurr
from ptnn_torch import surrogate as tsurr

torch.set_num_threads(1)

F_RTOL, F_ATOL = 1e-5, 1e-5  # elementwise functions of the same inputs
P_RTOL = 1e-4  # predictions and r2, relative to their size


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _state_j(st):
    return jax.device_get(st)._asdict()


def _assert_state_eq(got, want):
    """A port state against ptnn's, every field exact."""
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(v),
                                      err_msg=k)


def _buffer(rng, b, z, n_valid, lead=()):
    """A ring of ``n_valid`` rows around a random point, their ll a noisy
    quadratic of them (so the fit is determined and good)."""
    centre = rng.standard_normal(z)
    w = (centre + 0.3 * rng.standard_normal(lead + (b, z))).astype(np.float32)
    q = rng.standard_normal(z)
    ll = (-50.0 + w @ q - 2.0 * np.sum((w - centre) ** 2, axis=-1)
          + 0.01 * rng.standard_normal(lead + (b,))).astype(np.float32)
    valid = np.arange(b) < n_valid
    w = np.where(valid[:, None], w, 0.0).astype(np.float32)
    ll = np.where(valid, ll, 0.0).astype(np.float32)
    return w, ll


def test_features_and_projection(rng):
    w = rng.standard_normal((6, 9)).astype(np.float32)
    proj = rng.standard_normal((5, 9)).astype(np.float32)
    np.testing.assert_allclose(tsurr.features(_t(w), _t(proj)).numpy(),
                               np.asarray(jsurr.features(_j(w), _j(proj))),
                               rtol=F_RTOL, atol=F_ATOL)
    assert tsurr.feature_dim(9, 5) == jsurr.feature_dim(9, 5) == 24
    p = tsurr.make_projection(62, 64)
    # the port's own draws (ptnn's threefry stream cannot be reproduced):
    # the shape, dtype and scale of ptnn's, the same on every call
    pj = np.asarray(jsurr.make_projection(jax.random.PRNGKey(0x5A6A), 62, 64))
    assert p.shape == pj.shape and p.dtype == torch.float32
    assert torch.equal(p, tsurr.make_projection(62, 64))
    assert abs(float(p.std()) - pj.std()) < 0.01


@pytest.mark.parametrize("per_chain", [False, True])
def test_push_and_masked_push_wrap_the_ring(per_chain, rng):
    c, z = 4, 3
    b = 3 if per_chain else 12
    lead = c if per_chain else None
    js = jsurr.init(b, z, 2, num_chains=lead)
    ts = tsurr.init(b, z, 2, num_chains=lead)
    _assert_state_eq(ts, _state_j(js))
    for k in range(7):
        w = rng.standard_normal((c, z)).astype(np.float32)
        ll = rng.standard_normal(c).astype(np.float32)
        if k % 3 == 2:
            valid = bool(k % 2)
            js = jsurr.push_masked(js, _j(w), _j(ll), jnp.asarray(valid))
            # a host bool and a device bool give the same state
            dev = tsurr.push_masked(ts, _t(w), _t(ll), torch.tensor(valid))
            ts = tsurr.push_masked(ts, _t(w), _t(ll), valid)
            for f in ("buf_w", "buf_ll", "count", "ptr"):
                assert torch.equal(getattr(dev, f), getattr(ts, f)), f
        else:
            js = jsurr.push(js, _j(w), _j(ll))
            ts = tsurr.push(ts, _t(w), _t(ll))
        _assert_state_eq(ts, _state_j(js))
    assert int(ts.count) == b  # saturated: the ring wrapped


@pytest.mark.parametrize("per_chain", [False, True])
def test_quadratic_fit_and_prediction(per_chain, rng):
    z, n_proj, c = 5, 4, 3
    d = jsurr.feature_dim(z, n_proj)
    lead = (c,) if per_chain else ()
    b = 60
    w, ll = _buffer(rng, b, z, 50, lead)
    proj = (rng.standard_normal((n_proj, z)) / np.sqrt(z)).astype(np.float32)
    j0 = jsurr.init(b, z, n_proj, num_chains=c if per_chain else None)
    j0 = j0._replace(buf_w=_j(w), buf_ll=_j(ll), count=jnp.asarray(50, jnp.int32))
    t0 = tsurr.init(b, z, n_proj, num_chains=c if per_chain else None)
    t0 = t0.replace(buf_w=_t(w), buf_ll=_t(ll),
                    count=torch.tensor(50, dtype=torch.int32))
    jf = jsurr.fit(j0, _j(proj), 1e-3, 0.7)
    tf = tsurr.fit(t0, _t(proj), 1e-3, 0.7)
    assert bool(jf.fitted) and bool(tf.fitted)
    # held through what the sampler reads: r2 and predictions
    np.testing.assert_allclose(tsurr.r_squared(tf, _t(proj)).numpy(),
                               np.asarray(jsurr.r_squared(jf, _j(proj))),
                               rtol=0, atol=1e-5)
    q = rng.standard_normal((c, z)).astype(np.float32) * 0.3 + w[..., 0, :]
    got = tsurr.predict(tf, _t(proj), _t(q)).numpy()
    want = np.asarray(jsurr.predict(jf, _j(proj), _j(q)))
    np.testing.assert_allclose(got, want, rtol=P_RTOL)
    g_t = tsurr.grad_predict(tf, _t(proj), _t(q)).numpy()
    g_j = np.asarray(jsurr.grad_predict(jf, _j(proj), _j(q)))
    np.testing.assert_allclose(g_t, g_j, rtol=1e-3,
                               atol=1e-3 * np.abs(g_j).max())
    # too few rows: theta unchanged, not fitted (count < D)
    few = tsurr.fit(t0.replace(count=torch.tensor(d - 1, dtype=torch.int32)),
                    _t(proj))
    assert not bool(few.fitted) and torch.equal(few.theta, t0.theta)


@pytest.mark.parametrize("family", ["quadratic", "mlp"])
@pytest.mark.parametrize("per_chain", [False, True])
def test_analytic_gradient_is_autograd_s(family, per_chain, rng):
    z, c, hidden, n_proj = 6, 4, 5, 3
    proj = _t(rng.standard_normal((n_proj, z)) / np.sqrt(z))
    if family == "mlp":
        dim = tsurr.mlp_dim(z, hidden)
    else:
        dim = tsurr.feature_dim(z, n_proj)
    shape = (c, dim) if per_chain else (dim,)
    theta = _t(0.3 * rng.standard_normal(shape))
    if family == "mlp":  # a positive sig
        _a, _b, _v, _c, _mu, sig, _ym, ysig = tsurr._mlp_unpack(theta, z,
                                                                 hidden)
        sig.copy_(1.0 + torch.rand(sig.shape))
        ysig.copy_(torch.tensor(2.0))
        pred = lambda q: tsurr.mlp_predict(theta, q, hidden)
        grad = tsurr.mlp_grad(theta, _t(q0 := rng.standard_normal((c, z))),
                              hidden)
        jg = jsurr.mlp_grad(_j(theta), _j(q0), hidden)
        np.testing.assert_allclose(grad.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5)
    else:
        st = tsurr.init(4, z, n_proj, num_chains=c if per_chain else None)
        st = st.replace(theta=theta)
        pred = lambda q: tsurr.predict(st, proj, q)
        grad = tsurr.grad_predict(st, proj, _t(q0 := rng.standard_normal(
            (c, z))))
    q = _t(q0).requires_grad_(True)
    (auto,) = torch.autograd.grad(pred(q).sum(), q)
    np.testing.assert_allclose(grad.numpy(), auto.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("per_chain", [False, True])
def test_mlp_family_matches_ptnn(per_chain, rng):
    """A few Adam iterations within 1e-5; 300 by the in-buffer MSE, which
    both packages bring to within 5 % of each other."""
    z, hidden, c, b = 5, 4, 2, 48
    lead = (c,) if per_chain else ()
    w, ll = _buffer(rng, b, z, 40, lead)
    theta0 = np.stack([np.asarray(jsurr.mlp_init_theta(
        jax.random.PRNGKey(k), z, hidden)) for k in range(c)])
    if not per_chain:
        theta0 = theta0[0]
    count = 40
    for steps in (3, 300):
        jt, jr2 = (jax.vmap(lambda bw, bl, th: jsurr._mlp_fit_rows(
            bw, bl, jnp.asarray(count), th, hidden, steps, 1e-2))
            if per_chain else
            (lambda bw, bl, th: jsurr._mlp_fit_rows(
                bw, bl, jnp.asarray(count), th, hidden, steps, 1e-2)))(
            _j(w), _j(ll), _j(theta0))
        tt, tr2 = tsurr._mlp_fit_rows(_t(w), _t(ll), torch.tensor(count),
                                      _t(theta0), hidden, steps, 1e-2)
        if steps == 3:
            # Adam's step m / sqrt(s) is O(1) whatever the gradient's size,
            # so a parameter whose gradient is at rounding level moves by a
            # few 1e-5 differently in the two packages
            np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                                       atol=5e-5)
            np.testing.assert_allclose(tr2.numpy(), np.asarray(jr2),
                                       rtol=1e-5, atol=1e-5)
        else:
            mse_t, mse_j = 1.0 - tr2.numpy(), 1.0 - np.asarray(jr2)
            assert np.all(mse_t < 0.5) and np.all(mse_j < 0.5)
            np.testing.assert_allclose(mse_t, mse_j, rtol=0.05, atol=1e-3)
        # predictions of the fitted nets at the buffer's rows agree
        q = w[..., :c, :] if per_chain else w[:c]
        q = q[:, 0, :] if per_chain else q
        pt = tsurr.mlp_predict(tt, _t(q), hidden).numpy()
        pj = np.asarray(jsurr.mlp_predict(jt, _j(q), hidden))
        np.testing.assert_allclose(pt, pj, rtol=1e-5 if steps == 3 else 1e-2)
    # the gate: count below the activation rows keeps theta
    st = tsurr.init(b, z, 1, num_chains=c if per_chain else None).replace(
        buf_w=_t(w), buf_ll=_t(ll), theta=_t(theta0),
        count=torch.tensor(tsurr.mlp_min_rows(z, hidden) - 1,
                           dtype=torch.int32))
    out = tsurr.mlp_fit(st, hidden, 5, 1e-2, 0.0)
    assert not bool(out.fitted) and torch.equal(out.theta, st.theta)


@pytest.mark.parametrize("family,scope", [("quadratic", "global"),
                                          ("quadratic", "per_chain"),
                                          ("mlp", "global"),
                                          ("mlp", "per_chain")])
def test_init_for_matches_ptnn_layout_and_guard(family, scope):
    kw = dict(task="regression", topology=(4, 10, 1), num_samples=6 * 50,
              num_chains=6, use_surrogate=True, surrogate_family=family,
              surrogate_scope=scope, surrogate_buffer=200, surrogate_proj=8,
              surrogate_hidden=4)
    jcfg = ptnn.PTConfig(**kw).validate()
    tcfg = ptnn_torch.PTConfig(**kw).validate()
    j = _state_j(jsurr.init_for(jcfg, 61))
    t = tsurr.init_for(tcfg, 61)
    for k, v in j.items():
        got = getattr(t, k)
        assert tuple(got.shape) == np.asarray(v).shape, k
        assert got.numpy().dtype == np.asarray(v).dtype, k
        if k != "theta":
            np.testing.assert_array_equal(got.numpy(), np.asarray(v), err_msg=k)
    # a model spec's real w_size raises where the topology's passed
    with pytest.raises(ValueError, match="w_size=1000") as e:
        jsurr.init_for(jcfg, 1000)
    with pytest.raises(ValueError, match="w_size=1000") as e2:
        tsurr.init_for(tcfg, 1000)
    assert str(e.value) == str(e2.value)


def test_family_for_and_r_squared_gate(rng):
    z, n_proj = 4, 2
    w, ll = _buffer(rng, 30, z, 30)
    proj = _t(rng.standard_normal((n_proj, z)) / 2.0)
    cfg = ptnn_torch.PTConfig(task="regression", topology=(4, 10, 1),
                              num_samples=4 * 20, num_chains=4,
                              surrogate_min_r2=0.7)
    st = tsurr.init(30, z, n_proj).replace(
        buf_w=_t(w), buf_ll=_t(ll), count=torch.tensor(30, dtype=torch.int32))
    fam = tsurr.family_for(cfg)
    good = fam.fit(st, proj)
    assert bool(good.fitted) and float(tsurr.r_squared(good, proj)) > 0.9
    # pure noise: the fit is not trusted
    noisy = st.replace(buf_ll=_t(rng.standard_normal(30)))
    assert not bool(fam.fit(noisy, proj).fitted)
    mlp = tsurr.family_for(dataclasses.replace(cfg, surrogate_family="mlp"))
    assert mlp.predict is not fam.predict
