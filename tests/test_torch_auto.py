"""The port's one-call pipeline (``ptnn_torch.auto``) against ptnn's.

``auto_config`` from the same pilot result (a ``TuneResult`` with the
barrier ptnn's pilot measured for each row of ``results/auto_study.md``,
injected into both packages) builds the same pilot, the same production
config (every field, ``fused_step`` included: the port's fused gate decides
as ptnn's) and the same decision trail (the execution line names the
port's kernels), for both targets, the digits CNN's model spec among them.
``auto_sample`` runs the whole pipeline on a small budget on the CPU, writes
the report and a tree that ``predict`` serves, and reports None round trips
when no replica was tracked (ptnn reads 0.0 there); the command line runs.

``PYTHONPATH=.:tests python tests/test_torch_auto.py DATASET TARGET
SEED...`` runs ptnn's own ``auto_config`` (its pilot: 8 x 8-rung
ladders, 2000 steps a chain, two rounds, per step) on the CPU and prints one
JSON line a seed: the barrier, the ladder shape and the execution chosen,
the spread that widens ``chip_smoke.py``'s auto bands.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ptnn import auto as jauto
from ptnn import tuning as jtuning
from ptnn.data import load as jload
from ptnn.models import cnn as jcnn
from ptnn_torch import auto as tauto
from ptnn_torch import tuning as ttuning
from ptnn_torch.models import cnn as tcnn

torch.set_num_threads(1)

# results/auto_study.md: dataset, target, the pilot's barrier, model
ROWS = {
    "Sunspot-quality": ("Sunspot", "quality", 3.664, None),
    "Lazer-quality": ("Lazer", "quality", 4.251, None),
    "iris-speed": ("iris", "speed", 2.737, None),
    "iris-quality": ("iris", "quality", 2.737, None),
    "digits-cnn-speed": ("digits", "speed", 6.316, "cnn"),
}
# the shapes auto_study.md records for them (ladders, rungs)
SHAPES = {"Sunspot-quality": (7, 9), "Lazer-quality": (6, 10),
          "iris-speed": (9, 7), "iris-quality": (9, 7),
          "digits-cnn-speed": (4, 14)}


def tune_of(mod, barrier, maxtemp, seed=0):
    """A pilot result in ``mod``'s types: an 8-rung geometric ladder whose
    rejection profile sums to ``barrier``, unevenly (made from a seed)."""
    rng = np.random.default_rng(seed)
    temps = np.geomspace(1.0, maxtemp, 8)
    rej = rng.uniform(0.5, 1.5, 7)
    rej = rej * barrier / rej.sum()
    rnd = mod.TuneRound(temperatures=temps, pair_reject=rej,
                        barrier=float(rej.sum()), swap_percent=50.0)
    return mod.TuneResult(temperatures=temps, history=[rnd],
                          barrier=float(rej.sum()),
                          suggested_num_chains=mod.suggest_num_chains(
                              float(rej.sum())))


@pytest.mark.parametrize("row", list(ROWS))
def test_auto_config_matches_ptnn(row, monkeypatch):
    name, target, barrier, model = ROWS[row]
    prob = jload(name)
    maxtemp = 5.0 if prob.task == "regression" else 10.0
    pilots = {}

    def fake(mod, key):
        result = tune_of(mod, barrier, maxtemp)

        def tune_ladder(cfg, *a, **k):
            pilots[key] = cfg
            return result

        return tune_ladder

    monkeypatch.setattr(jtuning, "tune_ladder", fake(jtuning, "ptnn"))
    monkeypatch.setattr(ttuning, "tune_ladder", fake(ttuning, "port"))
    jspec = jcnn.digits_spec() if model else None
    tspec = tcnn.digits_spec() if model else None
    jcfg, _jt, jd = jauto.auto_config(prob.train, prob.test, prob.task,
                                      target=target, model_spec=jspec)
    tcfg, tt, td = tauto.auto_config(prob.train, prob.test, prob.task,
                                     target=target, model_spec=tspec,
                                     device="cpu")
    assert dataclasses.asdict(pilots["port"]) == dataclasses.asdict(
        pilots["ptnn"])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.n_ladders, tcfg.rungs_per_ladder) == SHAPES[row]
    assert list(td) == list(jd)
    for k, v in jd.items():
        if k == "execution":
            # the same decision; the port names its CUDA kernels
            assert td[k].startswith("fused") == v.startswith("fused")
            assert td[k].startswith("fused") == jcfg.fused_step
        elif k not in ("proposal", "ensemble", "execution"):
            assert td[k] == v, k
    assert tt.barrier == pytest.approx(barrier)
    # the fused rows take the kernels the issue's plan names
    if row in ("Sunspot-quality", "Lazer-quality", "iris-speed",
               "iris-quality"):
        assert tcfg.fused_step, td["execution"]
    if model:
        assert "reference FNN" in td["execution"]


def test_posterior_trace_budget_and_refusals(monkeypatch):
    prob = jload("Sunspot")
    tune = tune_of(ttuning, 3.664, 5.0)
    monkeypatch.setattr(ttuning, "tune_ladder", lambda *a, **k: tune)
    cfg, _, d = tauto.auto_config(prob.train, prob.test, "regression",
                                  steps_per_chain=400_000, device="cpu")
    assert not cfg.record_w and d["posterior_trace"].startswith("SKIPPED")
    with pytest.raises(ValueError, match="target"):
        tauto.auto_config(prob.train, prob.test, "regression", target="x")
    with pytest.raises(ValueError, match="chain budget"):
        tauto.auto_config(prob.train, prob.test, "regression",
                          chain_budget=3)
    assert tauto.infer_topology(prob.train, prob.test, "regression",
                                None) == (4, 10, 1)
    iris = jload("iris")
    assert tauto.infer_topology(iris.train, iris.test, "classification",
                                None) == jauto.infer_topology(
        iris.train, iris.test, "classification", None) == (4, 10, 3)


def _small(**kw):
    return dict(chain_budget=8, steps_per_chain=60, pilot_steps_per_chain=40,
                tune_rounds=1, replicate=2, device="cpu", **kw)


def test_auto_sample_small_budget_serves(tmp_path):
    prob = jload("iris")
    out = str(tmp_path / "auto")
    rep = tauto.auto_sample(prob.train, prob.test, "classification",
                            target="speed", out=out, name="iris", **_small())
    cfg = rep.config
    assert cfg.proposal == "precond_mala" and cfg.n_ladders >= 1
    assert rep.seeds == (0, 1) and len(rep.per_seed_cold) == 2
    assert 0.0 <= rep.test_cold_mean <= 100.0
    assert rep.roundtrips_per_kstep is not None
    assert rep.rhat_cold_max is not None and np.isfinite(rep.rhat_cold_max)
    assert rep.ece is not None and rep.elpd_loo is not None
    text = open(os.path.join(out, "auto_report.txt")).read()
    assert "auto-configured PT" in text and "decisions:" in text
    run = os.path.join(out, "iris_0")
    assert os.path.exists(os.path.join(run, "config.json"))
    from ptnn_torch import predict

    draws, cfg2 = predict.load_posterior(run)[:2]
    served = predict.posterior_predict(cfg2, draws, prob.test[:, :4],
                                       device="cpu")
    assert served["probs"].shape == (prob.test.shape[0], 3)


def test_round_trips_are_none_when_no_replica_is_tracked(monkeypatch):
    """ptnn's auto reports 0.0 round trips when no run tracked its replicas
    (ptnn/auto.py:601); the port reports None, and says so."""
    prob = jload("Sunspot")
    real = tauto.auto_config

    def untracked(*a, **k):
        cfg, tune, d = real(*a, **k)
        return dataclasses.replace(cfg, track_replicas=False), tune, d

    monkeypatch.setattr(tauto, "auto_config", untracked)
    rep = tauto.auto_sample(prob.train, prob.test, "regression",
                            target="speed", **_small())
    assert rep.roundtrips_per_kstep is None
    assert "round trips not tracked" in rep.describe()


def test_command_line_runs(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PTNN_DEVICE", "cpu")
    monkeypatch.setattr(tauto, "auto_config", _short_pilot(tauto.auto_config))
    tauto.main(["iris", "--target", "speed", "--chains", "8", "--steps",
                "40", "--replicate", "2", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "auto-configured PT" in out and "total wall-clock" in out
    assert os.path.exists(tmp_path / "auto_report.txt")
    assert os.path.isdir(tmp_path / "iris_0")


def _short_pilot(real):
    """``auto_config`` with a 40-step, one-round pilot (the command line's
    is 2 x 2000 steps a chain)."""

    def fn(*a, **k):
        return real(*a, **dict(k, pilot_steps_per_chain=40, tune_rounds=1))

    return fn


def pilot_reference(name: str, target: str, seed: int) -> dict:
    """ptnn's auto_config on the CPU: its pilot's barrier and decisions."""
    prob = jload(name)
    cfg, tune, d = jauto.auto_config(prob.train, prob.test, prob.task,
                                     target=target, seed=seed)
    return dict(dataset=name, target=target, seed=seed,
                barrier=float(tune.barrier), ladders=cfg.n_ladders,
                rungs=cfg.rungs_per_ladder, fused=bool(cfg.fused_step))


if __name__ == "__main__":
    import json
    import sys

    for s in sys.argv[3:]:
        print(json.dumps(pilot_reference(sys.argv[1], sys.argv[2], int(s))),
              flush=True)
