"""Serving a finished run: the port's ``predict`` (``load_posterior``,
``prior_draws``, ``posterior_predict`` with the conditional full predictive,
the command line), ``ops.ic`` and ``ops.calibrate`` against ptnn's.

Deterministic functions are held on the same inputs: ``load_posterior`` on
a tree written by ptnn's ``results`` (the same draws, the same config),
``pointwise_log_lik`` at rtol 1e-5 (its forward runs in PyTorch; a
regression entry on the size of its draw's terms),
``waic``, ``psis_loo``, ``compare`` and every calibration metric at rtol
1e-6 on the same matrices, and the command line's output file at the
precision it prints. The random draws (the port's ``torch.Generator``,
ptnn's NumPy generator) are held in distribution at fixed seeds:
``prior_draws``' moments, and the conditional band per test point, within
five standard errors of the estimates compared.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import predict as jpredict
from ptnn import results as jresults
from ptnn import sampler as jsampler
from ptnn.data import load_classification, load_regression
from ptnn.ops import calibrate as jcal
from ptnn.ops import ic as jic
from ptnn_torch import predict
from ptnn_torch.ops import calibrate, ic

torch.set_num_threads(1)


def _port(jcfg):
    return ptnn_torch.PTConfig(**dataclasses.asdict(jcfg)).validate()


def _ptnn_tree(tmp_path, name, **kw):
    """A short port run written by ptnn's ``results`` (record_w on)."""
    prob = (load_regression(name) if name == "Sunspot"
            else load_classification(name))
    if name == "Sunspot":
        jcfg = ptnn.regression_preset(num_samples=8 * 30, num_chains=8,
                                      use_langevin_gradients=False)
    else:
        jcfg = ptnn.classification_preset((4, 12, 3), num_samples=8 * 30,
                                          num_chains=8)
    jcfg = dataclasses.replace(jcfg, record_w=True, swap_interval=5,
                               **kw).validate()
    res = ptnn_torch.sample(_port(jcfg), prob.train, prob.test, seed=2,
                            device="cpu")
    jres = jsampler.SampleResult(
        traces=res.traces, final_state=None, temperatures=res.temperatures,
        accept_ratio_per_chain=res.accept_ratio_per_chain,
        swap_percent=res.swap_percent,
        langevin_ratio_per_chain=res.langevin_ratio_per_chain,
        elapsed_s=res.elapsed_s, chain_steps_per_sec=res.chain_steps_per_sec,
        config=jcfg, pair_swap_accept=res.pair_swap_accept)
    path = jresults.versioned_dir(str(tmp_path), name)
    jresults.write_artifacts(jres, path, name, plots=False)
    return path, jcfg, prob


@pytest.mark.parametrize("name,kw", [
    ("Sunspot", {}), ("iris", {}),
    ("Sunspot", dict(n_ladders=2, record_w_chains=2))])
def test_load_posterior_matches_ptnn(name, kw, tmp_path):
    path, jcfg, _ = _ptnn_tree(tmp_path, name, **kw)
    for args in (dict(), dict(chains="all"), dict(thin=3, burn_in=0.2)):
        got, tcfg = predict.load_posterior(path, **args)
        want, wcfg = jpredict.load_posterior(path, **args)
        np.testing.assert_array_equal(got, want)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(wcfg)
    if kw.get("n_ladders"):  # both ladders' cold files pooled
        assert got.shape[0] == 2 * len(range(max(int(30 * 0.2), 1), 30, 3))


def test_pointwise_log_lik_matches_ptnn():
    rng = np.random.default_rng(11)
    iris = load_classification("iris")
    ccfg = ptnn.classification_preset((4, 12, 3), num_samples=1000)
    draws = rng.normal(size=(300, 99)).astype(np.float32)
    got = ic.pointwise_log_lik(_port(ccfg), draws, iris.train[:, :4],
                               iris.train[:, 4], batch=128, device="cpu")
    want = jic.pointwise_log_lik(ccfg, draws, iris.train[:, :4],
                                 iris.train[:, 4], batch=128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    sun = load_regression("Sunspot")
    rcfg = ptnn.regression_preset(num_samples=800, num_chains=8)
    rdraws = rng.normal(scale=0.5, size=(200, 61)).astype(np.float32)
    xtr, ytr = sun.train[:, :4], sun.train[:, 4]
    xte, yte = sun.test[:, :4], sun.test[:, 4]
    for kw in (dict(), dict(cond=(xtr, ytr)), dict(eta="sample", seed=3),
               dict(eta=rng.normal(-4.0, 0.2, size=200))):
        x, y = (xte, yte) if "cond" in kw else (xtr, ytr)
        got = ic.pointwise_log_lik(_port(rcfg), rdraws, x, y, device="cpu",
                                   **kw)
        want = jic.pointwise_log_lik(rcfg, rdraws, x, y, **kw)
        # a regression entry is a difference of terms shared by the draw's
        # row (the density's constant and log scale): rtol on their size
        size = np.abs(want).max(axis=1, keepdims=True)
        assert np.all(np.abs(got - want) <= 1e-5 * (np.abs(want) + size))


def test_criteria_and_calibration_match_ptnn():
    rng = np.random.default_rng(5)
    ll = rng.normal(-1.0, 0.4, size=(500, 40))
    ll[:, 3] -= 6.0 * rng.uniform(size=500) ** 8  # a heavy tail for PSIS
    for f in ("waic", "psis_loo"):
        got, want = getattr(ic, f)(ll), getattr(jic, f)(ll)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=f"{f} {k}")
    z = rng.pareto(2.5, size=300)
    np.testing.assert_allclose(ic.gpdfit(z), jic.gpdfit(z), rtol=1e-6)
    table = {"a": ic.psis_loo(ll), "b": ic.psis_loo(ll + 0.01 * rng.normal(
        size=ll.shape))}
    assert ic.compare(table) == jic.compare(table)
    y = rng.normal(size=60)
    samples = y[None, :] + rng.normal(size=(400, 60))
    lo, hi = np.percentile(samples, [5, 95], axis=0)
    assert calibrate.coverage(y, lo, hi) == jcal.coverage(y, lo, hi)
    for k, v in jcal.crps(samples, y).items():
        np.testing.assert_allclose(calibrate.crps(samples, y)[k], v,
                                   rtol=1e-6)
    assert calibrate.ppc(samples, y) == jcal.ppc(samples, y)
    probs = rng.dirichlet(np.ones(3), size=80)
    labels = rng.integers(0, 3, size=80)
    for k, v in jcal.ece(probs, labels).items():
        np.testing.assert_allclose(calibrate.ece(probs, labels)[k], v,
                                   rtol=1e-6)
    np.testing.assert_allclose(calibrate.brier(probs, labels),
                               jcal.brier(probs, labels), rtol=1e-6)


def test_prior_draws_match_ptnn_in_distribution():
    """n x W = 4000 x 61 draws a side: mean within 5 standard errors of 0,
    standard deviation within 5 of sqrt(sigma_sq) (its standard error
    sigma / sqrt(2 n W)), for both packages at two seeds."""
    cfg = ptnn.regression_preset(num_samples=800, num_chains=8)
    sd = np.sqrt(cfg.sigma_sq)
    n, w = 4000, 61
    for seed in (0, 1):
        got = predict.prior_draws(_port(cfg), n, seed=seed, device="cpu")
        want = jpredict.prior_draws(cfg, n, seed=seed)
        assert got.shape == want.shape == (n, w)
        assert got.dtype == want.dtype == np.float32
        for d in (got, want):
            assert abs(d.mean()) < 5 * sd / np.sqrt(n * w)
            assert abs(d.std() - sd) < 5 * sd / np.sqrt(2 * n * w)
    a = predict.prior_draws(_port(cfg), 10, seed=3, device="cpu")
    np.testing.assert_array_equal(
        a, predict.prior_draws(_port(cfg), 10, seed=3, device="cpu"))
    assert not np.array_equal(
        a, predict.prior_draws(_port(cfg), 10, seed=4, device="cpu"))


def test_conditional_band_matches_ptnn_in_distribution():
    """The full predictive of the same 2000 draws on Sunspot's test rows:
    the epistemic mean is the same function of the draws (rtol 1e-5); per
    point, the two predictive stds differ by at most five standard errors
    of their difference (sqrt(2) times std / sqrt(2 M)) and the 5 % / 95 %
    bounds by five times sqrt(2) std / sqrt(M) scaled by the quantile's
    density factor (sqrt(p (1 - p)) / phi(z_p) = 2.11 for a normal);
    averaged over the 198 points, the band width within 1 %."""
    rng = np.random.default_rng(8)
    sun = load_regression("Sunspot")
    cfg = ptnn.regression_preset(num_samples=800, num_chains=8)
    m = 2000
    draws = (rng.normal(scale=0.3, size=(1, 61))
             + rng.normal(scale=0.05, size=(m, 61))).astype(np.float32)
    x, cond = sun.test[:, :4], (sun.train[:, :4], sun.train[:, 4])
    got = predict.posterior_predict(_port(cfg), draws, x, device="cpu",
                                    noise="conditional", cond=cond, seed=1,
                                    return_samples=True)
    want = jpredict.posterior_predict(cfg, draws, x, noise="conditional",
                                      cond=cond, seed=1, return_samples=True)
    assert got["samples"].shape == want["samples"].shape == (m, x.shape[0])
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=1e-5,
                               atol=1e-6)
    sd = want["std"]
    se = np.sqrt(2.0) * sd / np.sqrt(m)  # of a difference of two estimates
    assert np.all(np.abs(got["std"] - sd) <= 5 * se / np.sqrt(2.0))
    for k in ("low", "high"):
        assert np.all(np.abs(got[k] - want[k]) <= 5 * 2.11 * se)
    width = lambda r: np.mean(r["high"] - r["low"])
    assert abs(width(got) / width(want) - 1.0) < 0.01
    # seeded: the same seed gives the same band
    again = predict.posterior_predict(_port(cfg), draws, x, device="cpu",
                                      noise="conditional", cond=cond, seed=1)
    np.testing.assert_array_equal(again["low"], got["low"])
    with pytest.raises(ValueError, match="cond"):
        predict.posterior_predict(_port(cfg), draws, x, device="cpu",
                                  noise="conditional")
    with pytest.raises(ValueError, match="noise"):
        predict.posterior_predict(_port(cfg), draws, x, device="cpu",
                                  noise="full")


@pytest.mark.parametrize("name", ["Sunspot", "iris"])
def test_predict_cli_matches_ptnn(name, tmp_path, monkeypatch, capsys):
    """``python -m ptnn_torch.predict --run DIR --problem NAME --calibrate
    --ic --out FILE`` on a tree both packages serve: the output file
    matches ptnn's at its printed precision, the deterministic lines
    (RMSE / accuracy, WAIC, PSIS-LOO, test lppd, ECE / Brier) read ptnn's
    numbers."""
    monkeypatch.setenv("PTNN_DEVICE", "cpu")
    path, _, _ = _ptnn_tree(tmp_path / "runs", name)
    args = ["--run", path, "--problem", name, "--calibrate", "--ic"]
    predict.main(args + ["--out", str(tmp_path / "port.txt")])
    got = capsys.readouterr().out.splitlines()
    jpredict.main(args + ["--out", str(tmp_path / "ptnn.txt")])
    want = capsys.readouterr().out.splitlines()
    a, b = (np.loadtxt(tmp_path / f) for f in ("port.txt", "ptnn.txt"))
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6)
    deterministic = ("WAIC", "PSIS-LOO", "test lppd")
    if name == "iris":
        np.testing.assert_array_equal(a[:, 0], b[:, 0])  # labels
        deterministic += ("calibration",)
    assert got[0] == want[0]  # draws, inputs, RMSE(mean) / accuracy
    for g, w in zip(got, want):
        if g.startswith(deterministic):
            assert g == w
    assert got[-1] == f"wrote {tmp_path / 'port.txt'}"
    assert len(got) == len(want)
    if name == "Sunspot":
        assert any(g.startswith("calibration (test): 5-95 band coverage")
                   for g in got)
