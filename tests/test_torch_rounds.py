"""The port's round-based reference adaptation (``ptnn_torch.rounds``)
against ptnn's.

``round_budgets`` and ``format_history`` on the same inputs; ``run_rounds``
(two rounds) with round 0 started from ptnn's initial state and every
round fed ptnn's draws for its seed (``test_torch_tuning.replay_sample``):
the per-round history (swap %, barrier, round trips, regeneration %, test
metric, fit draws), the re-spaced ladder and the fitted reference (mu, var,
chol) equal ptnn's at the run tolerance, on Lazer with the full-covariance
family (z = (w, eta)) and iris with the diagonal one
(tests/test_rounds.py:298-335); the gates and the ``w_size >= 40``
warning word for word.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import rounds as jrounds
from ptnn.data import load_classification, load_regression
from ptnn_torch import rounds
from test_torch_precond_per_step import held
from test_torch_tuning import replay_sample

torch.set_num_threads(1)

RTOL = 2e-4


@pytest.mark.parametrize("args", [(1600, 4, 100), (1600, 3, 500),
                                  (64, 3, 256), (40, 2, 256), (333, 5, 7)])
def test_round_budgets_match_ptnn(args):
    assert rounds.round_budgets(*args) == jrounds.round_budgets(*args)
    with pytest.raises(ValueError, match="n_rounds"):
        rounds.round_budgets(100, 0)


def test_format_history_matches_ptnn():
    recs = [dict(round_index=r, samples_per_chain=40 << r,
                 temperatures=np.array([1.0, 2.0, np.inf]),
                 swap_percent=51.234 - r, pair_reject=np.array([0.2, 0.3]),
                 barrier=0.5 + r, round_trips_per_kstep=1.25 * r,
                 regen_accept_percent=float("nan") if r == 0 else 100.0,
                 test_metric=0.0312 / (r + 1), fit_draws=20 if r < 2 else 0)
            for r in range(3)]
    assert rounds.format_history([rounds.RoundRecord(**r) for r in recs]) \
        == jrounds.format_history([jrounds.RoundRecord(**r) for r in recs])


def static_cfg(**kw):
    """ptnn's tests/test_rounds.py ``_static_cfg`` at 8 chains, 80 samples
    a chain in the final round."""
    base = dict(task="regression", topology=(4, 5, 1), num_samples=8 * 80,
                num_chains=8, maxtemp=5.0, swap_interval=10, swap_offset=0,
                swap_payload="untempered", swap_rule="metropolis",
                swap_style="even_odd", pt_phase_frac=2.0,
                variational_reference=True, vr_mode="static",
                vr_family="full_cov", vr_hot_infinite=True, chunk_steps=20)
    base.update(kw)
    return base


ROUND_CASES = {
    "lazer_full_cov": (static_cfg(), "Lazer", {}),
    "iris_diag": (static_cfg(task="classification", topology=(4, 6, 3),
                             vr_family="diag", step_eta=0.2), "iris",
                  dict(retune_ladder=False, warm_start=False)),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_run_rounds_matches_ptnn(case, monkeypatch):
    kw, name, extra = ROUND_CASES[case]
    prob = (load_regression(name) if name == "Lazer"
            else load_classification(name))
    want = jrounds.run_rounds(ptnn.PTConfig(**kw).validate(), prob.train,
                              prob.test, seed=1, n_rounds=2,
                              min_round_samples=40, **extra)
    replay_sample(monkeypatch)
    got = rounds.run_rounds(ptnn_torch.PTConfig(**kw).validate(), prob.train,
                            prob.test, seed=1, n_rounds=2,
                            min_round_samples=40, device="cpu", **extra)
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        for k in ("round_index", "samples_per_chain", "swap_percent",
                  "round_trips_per_kstep", "fit_draws"):
            assert getattr(g, k) == getattr(w, k), k
        np.testing.assert_array_equal(np.isnan(g.regen_accept_percent),
                                      np.isnan(w.regen_accept_percent))
        if not np.isnan(w.regen_accept_percent):
            assert g.regen_accept_percent == w.regen_accept_percent == 100.0
        np.testing.assert_allclose(g.temperatures, w.temperatures, rtol=RTOL)
        np.testing.assert_allclose(g.pair_reject, w.pair_reject, rtol=RTOL,
                                   atol=1e-5)
        np.testing.assert_allclose(g.barrier, w.barrier, rtol=RTOL)
        np.testing.assert_allclose(g.test_metric, w.test_metric, rtol=RTOL)
    assert (got.chol is None) == (want.chol is None)
    for k in ("mu", "var", "chol"):
        a, b = getattr(got, k), getattr(want, k)
        if b is not None:
            assert held(a, b, np.abs(b).max(), rtol=1e-3).all(), k
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    assert rounds.format_history(got.history).count("\n") == 3


def test_run_rounds_gates_and_warning():
    prob = load_regression("Lazer")
    cfg = ptnn_torch.PTConfig(**static_cfg(vr_mode="welford",
                                           vr_family="diag")).validate()
    with pytest.raises(ValueError, match="static"):
        rounds.run_rounds(cfg, prob.train, prob.test, device="cpu")
    wide = static_cfg(topology=(4, 10, 1), num_samples=8 * 8)
    msgs = []
    for mod, pkg in ((rounds, ptnn_torch), (jrounds, ptnn)):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            mod.run_rounds(pkg.PTConfig(**wide).validate(), prob.train,
                           prob.test, n_rounds=1, min_round_samples=8,
                           **({"device": "cpu"} if mod is rounds else {}))
        msgs.append([str(w.message) for w in seen
                     if "w_size=61" in str(w.message)])
    assert msgs[0] == msgs[1] and len(msgs[0]) == 1
