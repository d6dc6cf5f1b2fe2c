"""The port's ladder evidence (``ptnn_torch.ops.evidence``) against ptnn's.

Every function on the same NumPy inputs, rtol 1e-5: ``from_samples``
(duplicate betas pooled, the beta = 0 column of a T = inf rung),
``_window`` (the tempered phase's second half, canonical runs, the checks),
``from_traces`` (prior-anchored, and the corrected path floored at the
reference's freeze, Welford and static) and ``from_result``'s closed-form
anchor of a corrected path (the diagonal family by Welford and static, the
full-covariance family), on the same traces and final reference; the
analytic Gaussian case of ptnn's tests/test_evidence.py:18; and a port run's
``ll_cur`` invariant (its last row is the final state's ll,
tests/test_evidence.py:47). The command lines' ``evidence.txt`` against
ptnn's: ``tests/test_torch_experiments.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn.ops import evidence as jevidence
from ptnn_torch import convert
from ptnn_torch.data import load_classification
from ptnn_torch.ops import evidence

torch.set_num_threads(1)

RTOL = 1e-5


def _assert_estimates_match(got, want):
    for k in ("log_z_ti", "log_z_ss", "log_z0", "log_z_abs_ti",
              "log_z_abs_ss"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(got.betas, want.betas, rtol=RTOL)
    np.testing.assert_allclose(got.mean_ll, want.mean_ll, rtol=RTOL)
    assert got.n_samples == want.n_samples
    assert tuple(got.window) == tuple(want.window)
    assert got.anchored == want.anchored


SAMPLE_CASES = {
    "geometric": np.array([1.0, 1.5, 2.2, 3.4, 5.0]),
    "beta0_rung": np.array([1.0, 1.3, 2.0, 4.0, np.inf]),
    "two_ladders": np.array([1.0, 2.0, 4.0, 1.0, 2.0, 4.0]),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_from_samples_matches_ptnn(case):
    temps = SAMPLE_CASES[case]
    rng = np.random.default_rng(4)
    ll = (rng.standard_normal((300, len(temps))) * 3.0
          + 40.0 / temps.clip(max=1e9))
    _assert_estimates_match(evidence.from_samples(ll, temps, (3, 9), -2.5),
                            jevidence.from_samples(ll, temps, (3, 9), -2.5))
    with pytest.raises(ValueError, match="2 rungs"):
        evidence.from_samples(ll[:, :1], temps[:1])


def test_stepping_stone_matches_analytic_gaussian():
    """ptnn's tests/test_evidence.py:18 on the port: Gaussian draws whose
    stepping-stone ratios and TI integrand are closed-form."""
    rng = np.random.default_rng(0)
    betas = np.array([0.2, 0.45, 0.7, 1.0])
    mu = 10.0 * betas - 3.0
    s2 = 0.25
    ll = mu[None, :] + np.sqrt(s2) * rng.standard_normal((200_000, 4))
    est = evidence.from_samples(ll, 1.0 / betas)
    db = np.diff(betas)
    assert abs(est.log_z_ss - float(np.sum(db * mu[:-1] + 0.5 * db**2 * s2))
               ) < 0.01
    assert abs(est.log_z_ti - float(np.sum(db * (mu[1:] + mu[:-1]) / 2))
               ) < 0.01


def _cfgs(**kw):
    base = dict(task="regression", topology=(4, 10, 1), num_samples=8 * 200,
                num_chains=8, maxtemp=5.0, swap_interval=5, swap_offset=0,
                swap_style="even_odd", swap_payload="untempered",
                swap_rule="metropolis", record_ll_state=True)
    base.update(kw)
    return (ptnn.PTConfig(**base).validate(),
            ptnn_torch.PTConfig(**base).validate())


VR = dict(pt_phase_frac=2.0, variational_reference=True,
          vr_hot_infinite=True)
WINDOW_CASES = {
    "two_phase": ({}, None),
    "canonical": (dict(pt_phase_frac=2.0), None),
    "given": ({}, (10, 90)),
    "vr_welford": (VR, None),
    "vr_static": (dict(VR, vr_mode="static"), None),
    "vr_given": (VR, (50, 120)),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_from_traces_matches_ptnn(case):
    kw, window = WINDOW_CASES[case]
    jcfg, tcfg = _cfgs(**kw)
    rng = np.random.default_rng(5)
    s, c = tcfg.samples_per_chain, tcfg.num_chains
    temps = ptnn_torch.ops.ladder.build_temperatures(tcfg)
    traces = {"ll_cur": rng.standard_normal((s, c)).astype(np.float32) * 5
              - 300.0}
    if tcfg.variational_reference:
        traces["vr_corr_cur"] = (rng.standard_normal((s, c)) * 40).astype(
            np.float32)
    assert evidence._window(tcfg, s, window) == jevidence._window(
        jcfg, s, window)
    _assert_estimates_match(
        evidence.from_traces(traces, temps, tcfg, window, 7.0),
        jevidence.from_traces(traces, temps, jcfg, window, 7.0))
    with pytest.raises(ValueError, match="window"):
        evidence.from_traces(traces, temps, tcfg, (0, 5))
    with pytest.raises(ValueError, match="record_ll_state"):
        evidence.from_traces({"ll": traces["ll_cur"]}, temps, tcfg)


ANCHOR_CASES = {
    "welford": dict(VR),
    "welford_inflated": dict(VR, vr_var_inflation=1.5),
    "static_diag": dict(VR, vr_mode="static"),
    "static_full_cov": dict(VR, vr_mode="static", vr_family="full_cov"),
}


@pytest.mark.parametrize("case", sorted(ANCHOR_CASES))
def test_from_result_anchor_matches_ptnn(case):
    """The closed-form log Z(0) of the final reference, and the corrected
    estimates, on one result's traces and state seen by both packages."""
    jcfg, tcfg = _cfgs(**ANCHOR_CASES[case])
    rng = np.random.default_rng(6)
    s, c, z = tcfg.samples_per_chain, tcfg.num_chains, 62
    temps = ptnn_torch.ops.ladder.build_temperatures(tcfg)
    assert np.isinf(temps[-1])
    traces = {"ll_cur": (rng.standard_normal((s, c)) * 5 - 300.0).astype(
        np.float32),
        "vr_corr_cur": (rng.standard_normal((s, c)) * 40).astype(np.float32)}
    a = rng.standard_normal((z, z)) * 0.05
    st = dict(vr_m2=(rng.random(z) * 30).astype(np.float32),
              vr_chol=(np.tril(a) + np.eye(z)).astype(np.float32))
    jres = types.SimpleNamespace(config=jcfg, traces=traces,
                                 temperatures=temps,
                                 final_state=types.SimpleNamespace(**st))
    tres = types.SimpleNamespace(config=tcfg, traces=traces,
                                 temperatures=temps,
                                 final_state=types.SimpleNamespace(**{
                                     k: torch.from_numpy(v)
                                     for k, v in st.items()}))
    got, want = evidence.from_result(tres), jevidence.from_result(jres)
    assert got.anchored and want.anchored
    _assert_estimates_match(got, want)
    plain = types.SimpleNamespace(**dict(vars(tres), traces={
        "ll_cur": traces["ll_cur"]}))
    assert not evidence.from_result(plain).anchored


def test_ll_cur_follows_the_state():
    """ptnn's tests/test_evidence.py:47 on a port run: the last ll_cur row
    is the final state's ll (post-MH, post-swap), and the estimate runs."""
    prob = load_classification("iris")
    cfg = dataclasses.replace(
        ptnn_torch.classification_preset(prob.topology, num_samples=8 * 100,
                                         canonical=True),
        num_chains=8, maxtemp=20.0, swap_interval=10, record_w=False,
        record_ll_state=True).validate()
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=0, device="cpu")
    np.testing.assert_array_equal(res.traces["ll_cur"][-1],
                                  convert.chain_state_to_numpy(
                                      res.final_state)["ll"])
    est = evidence.from_result(res)
    assert np.isfinite(est.log_z_ti) and np.isfinite(est.log_z_ss)
    assert not est.anchored
    assert est.window == evidence._window(cfg, 100, None) == (49, 100)
