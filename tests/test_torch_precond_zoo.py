"""The per-step preconditioned family on the model zoo, and what rides on
it: the function-space R-hat, the fused gate's fallback, the CNN's command
line.

The small Bayesian CNN of tests/test_torch_zoo_step.py
(``digits_spec(channels=(4,), hidden=16)``, the port's with the fused eval)
on 128 / 64 digits rows, 8 chains = 2 ladders x 4 rungs: one step of each
proposal against ptnn's jitted step on ptnn's state and draws, and 40-step
runs against ``ptnn.sample``, held as tests/test_torch_precond_per_step.py
holds the FNN (its tolerances and margin). The value-and-grad of a zoo spec
is autograd over ``spec.forward``; the test rows' eval goes through the
spec's ``batched_forward`` (the conv stage's plain version on the CPU). The
same two comparisons for the MLP: (4, 16, 8, 1) tanh on Sunspot (the
regression value-and-grad, -SSE/2 of the first output) and (4, 16, 8, 3)
relu on iris, each with the FNN's configuration of that file.

``ops.ess.function_space_rhat`` against ptnn's on the same draws (the FNN
and the CNN, seeds as (draws, W) and (draws, R, W)); an Ionosphere-shaped
fused MALA config (w 1852, refused by the fused gate's shared-memory rule)
falls back with ptnn's warning and runs per step; ``cnn_digits --mala`` and
``--hmc`` run a tiny job on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn.data import load_classification, load_digits
from ptnn.models import cnn as jcnn
from ptnn.models import mlp as jmlp
from ptnn.ops import ess as jess
from ptnn_torch import fused as tfused
from ptnn_torch.experiments import cnn_digits
from ptnn_torch.models import cnn, mlp
from ptnn_torch.ops import conv_stage, ess
from test_torch_precond_per_step import (PROBLEMS, PROPOSALS, _run_both,
                                         assert_runs_match, one_step_case)

torch.set_num_threads(1)


def _cnn(**kw):
    """tests/test_cnn.py's classification preset at 8 x 40, maxtemp 3, as
    bench.py's ``_cls_variants`` sets the family up (2 ladders, even-odd
    metropolis swaps of untempered energies every 10)."""
    cfg = ptnn.classification_preset((64, 16, 10), num_samples=8 * 40,
                                     num_chains=8, maxtemp=3.0)
    base = dict(cfg.__dict__, n_ladders=2, adapt_rate=0.1,
                swap_style="even_odd", swap_interval=10,
                swap_rule="metropolis", swap_payload="untempered",
                precond_start_frac=0.3, record_w=True, track_replicas=True,
                chunk_steps=20)
    base.update(kw)
    return base


def _specs():
    return (jcnn.digits_spec(channels=(4,), hidden=16),
            cnn.digits_spec(channels=(4,), hidden=16, fused_eval=True))


def _rows():
    p = load_digits(0)
    return p.train[:128], p.test[:64]


@pytest.mark.parametrize("proposal", sorted(PROPOSALS))
def test_cnn_one_step_matches_ptnn(proposal):
    jspec, tspec = _specs()
    before = conv_stage.launches
    one_step_case(_cnn, lambda: load_digits(0), proposal, seed=5,
                  jspec=jspec, tspec=tspec, rows=_rows())
    assert conv_stage.launches == before  # CPU tensors: the plain version


@pytest.mark.parametrize("proposal", sorted(PROPOSALS))
def test_cnn_run_matches_ptnn(proposal):
    jspec, tspec = _specs()
    got, ref, margin, n_train = _run_both(_cnn(**PROPOSALS[proposal]), None,
                                          seed=2, jspec=jspec, tspec=tspec,
                                          rows=_rows())
    assert_runs_match(got, ref, margin, n_train)


# the MLP on each task: (ptnn's spec, the port's spec), on PROBLEMS' data
MLPS = {
    "Sunspot": ((4, 16, 8, 1), dict(task="regression", act="tanh")),
    "iris": ((4, 16, 8, 3), dict(act="relu")),
}


def _mlp_specs(problem):
    sizes, kw = MLPS[problem]
    return jmlp.spec(sizes, **kw), mlp.spec(sizes, **kw)


@pytest.mark.parametrize("proposal", sorted(PROPOSALS))
@pytest.mark.parametrize("problem", sorted(MLPS))
def test_mlp_one_step_matches_ptnn(problem, proposal):
    make, load = PROBLEMS[problem]
    jspec, tspec = _mlp_specs(problem)
    one_step_case(make, load, proposal, seed=5, jspec=jspec, tspec=tspec)


@pytest.mark.parametrize("proposal", sorted(PROPOSALS))
@pytest.mark.parametrize("problem", sorted(MLPS))
def test_mlp_run_matches_ptnn(problem, proposal):
    make, load = PROBLEMS[problem]
    jspec, tspec = _mlp_specs(problem)
    got, ref, margin, n_train = _run_both(make(**PROPOSALS[proposal]),
                                          load(), seed=2, jspec=jspec,
                                          tspec=tspec)
    assert_runs_match(got, ref, margin, n_train)


@pytest.mark.parametrize("model", ["fnn", "cnn"])
def test_function_space_rhat_matches_ptnn(model, monkeypatch):
    """The same draws through both: two seeds of (draws, W) and two of
    (draws, R, W) (thinned along the draw axis, then pooled). The
    statistic ranks the forward's outputs, so the two float32 forwards
    give the same value unless two outputs tie within their rounding:
    held to 1e-6."""
    monkeypatch.setattr(ess, "FS_BATCH", 97)  # several forwards a seed
    rng = np.random.default_rng(8)
    if model == "fnn":
        prob = load_classification("iris")
        cfg = ptnn_torch.classification_preset((4, 12, 3), 1000)
        jcfg = ptnn.classification_preset((4, 12, 3), 1000)
        jspec = tspec = None
        w_size, scale = 99, 1.0
    else:
        prob = load_digits(0)
        cfg = ptnn_torch.classification_preset((64, 16, 10), 1000)
        jcfg = ptnn.classification_preset((64, 16, 10), 1000)
        jspec, tspec = _specs()
        w_size, scale = tspec.w_size, 0.3
    base = rng.normal(size=w_size) * scale
    # seeds that agree in law (a shared centre) and one that drifts
    flat = [(base + rng.normal(size=(300, w_size)) * scale * 0.2
             ).astype(np.float32) for _ in range(2)]
    reps = [(base + rng.normal(size=(120, 4, w_size)) * scale * 0.2
             + 0.02 * k * np.arange(120)[:, None, None] / 120
             ).astype(np.float32) for k in range(2)]
    for colds in (flat, reps):
        want = jess.function_space_rhat(colds, prob.test, jcfg, spec=jspec)
        got = ess.function_space_rhat(colds, prob.test, cfg, spec=tspec,
                                      device="cpu")
        assert abs(got - want) <= 1e-6 * want, (got, want)
        assert want > 1.0


def test_ionosphere_fused_mala_falls_back_and_runs():
    """bench.py's Ionosphere arm (``_cls_variants``' mala_fused_16x4,
    fused_step=True) at 8 chains x 20: the fused gate refuses its working
    set (w 1852) by ptnn's VMEM budget, so sample warns as ptnn does and
    the per-step sampler runs it, the same run as fused_step=False."""
    prob = load_classification("Ionosphere")
    base = ptnn_torch.classification_preset((34, 50, 2), num_samples=8 * 20,
                                            num_chains=8, maxtemp=5.0)
    cfg = dataclasses.replace(
        base, proposal="precond_mala", n_ladders=2, adapt_rate=0.1,
        swap_style="even_odd", swap_interval=10, swap_rule="metropolis",
        swap_payload="untempered", warmstart_frac=0.1,
        precond_start_frac=0.3, record_w=True, record_w_chains=2,
        track_replicas=True, chunk_steps=1000, fused_step=True).validate()
    n_tr, n_te = prob.train.shape[0], prob.test.shape[0]
    assert "VMEM budget" in tfused.runtime_reason(cfg, n_tr, n_te)
    with pytest.warns(UserWarning, match="falling back"):
        res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=1,
                                device="cpu")
    per_step = ptnn_torch.sample(
        dataclasses.replace(cfg, fused_step=False).validate(), prob.train,
        prob.test, seed=1, device="cpu")
    for k in res.traces:
        np.testing.assert_array_equal(res.traces[k], per_step.traces[k],
                                      err_msg=k)
    assert res.traces["w"].shape == (20, 2, 1852)
    assert 0.0 < res.accept_ratio_per_chain.mean() <= 100.0
    assert np.isfinite(res.traces["ll"]).all()


@pytest.mark.parametrize("flags, proposal", [
    (["--mala"], "precond_mala"), (["--hmc", "2"], "hmc")])
def test_cnn_digits_gradient_samplers_run(tmp_path, monkeypatch, capsys,
                                          flags, proposal):
    """``python -m ptnn_torch.experiments.cnn_digits --mala`` / ``--hmc
    L`` at 4 chains x 6 steps on 40 / 20 digits rows on the CPU: ptnn's configuration (Langevin
    and step adaptation off, hmc_leapfrog L), its summary line and its
    artifact tree."""
    monkeypatch.setenv("PTNN_DEVICE", "cpu")
    full = ptnn_torch.data.load_digits(0)
    monkeypatch.setattr(cnn_digits, "load_digits", lambda seed: dataclasses
                        .replace(full, train=full.train[:40],
                                 test=full.test[:20]))
    out = tmp_path / "cnn"
    cnn_digits.main(["--chains", "4", "--steps", "6", "--swap-interval",
                     "3", "--adapt", "--warmstart-frac", "0.2",
                     "--precond-start", "0.4", "--out", str(out)] + flags)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[digits] chains=4 test_acc mean=")
    with open(out / "digits_0" / "config.json") as f:
        written = json.load(f)
    assert written["proposal"] == proposal
    assert not written["use_langevin_gradients"]
    assert not written["adapt_step_size"]
    assert written["hmc_leapfrog"] == (2 if proposal == "hmc" else 8)
    acc = np.loadtxt(out / "digits_0" / "predictions" /
                     "acc_test_chain_1.0.txt")
    assert acc.shape == (6,) and np.isfinite(acc).all()
