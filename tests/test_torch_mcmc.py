"""The port's single-chain sampler (``ptnn_torch.mcmc``,
``experiments.single_chain``) against ptnn's.

``single_chain_config`` gives ptnn's config; a ``record_fx`` single-chain
run (Sunspot Langevin and random walk, iris random walk; 40 steps) from
ptnn's initial state with ptnn's draws keeps ptnn's accept decisions and
its posterior-predictive traces ``fx_train`` / ``fx_test`` (regression at
rtol 2e-4, classification's predicted classes exactly), and
``predictive_bands`` of the two results agree
(tests/test_components.py:116-140). The command line runs on the CPU.

``python tests/test_torch_mcmc.py SEED ...`` runs ptnn's
``single_chain_config("regression", (4, 10, 1), samples=10_000)`` on
Sunspot on the CPU, one line a seed: the source of ``chip_smoke.py``'s
bands for the port's single-chain runs.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import ptnn
from ptnn import mcmc as jmcmc
from ptnn.data import load_classification, load_regression
from ptnn_torch import convert, mcmc, sampler
from ptnn_torch.experiments import single_chain
from test_torch_precond_per_step import held
from test_torch_vref import _np_state, ptnn_start, vr_noise_fn

torch.set_num_threads(1)

CASES = {
    "sunspot_lg": ("regression", (4, 10, 1), {}, "Sunspot"),
    "sunspot_rw": ("regression", (4, 10, 1),
                   dict(use_langevin_gradients=False), "Sunspot"),
    "iris_rw": ("classification", (4, 12, 3),
                dict(use_langevin_gradients=False), "iris"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_record_fx_single_chain_matches_ptnn(case):
    task, topo, kw, name = CASES[case]
    prob = (load_regression(name) if task == "regression"
            else load_classification(name))
    jcfg = jmcmc.single_chain_config(task, topo, samples=40, **kw)
    tcfg = mcmc.single_chain_config(task, topo, samples=40, **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _data, st0, k_run = ptnn_start(jcfg, prob.train, prob.test, seed=4)
    ref = ptnn.sample(jcfg, prob.train, prob.test, seed=4, init_state=st0)
    got = sampler.sample(tcfg, prob.train, prob.test, seed=4, device="cpu",
                         init_state=convert.chain_state_from_numpy(
                             _np_state(st0)),
                         noise_fn=vr_noise_fn(k_run, tcfg))
    assert set(got.traces) == set(ref.traces)
    np.testing.assert_array_equal(got.traces["accept_count"],
                                  ref.traces["accept_count"])
    assert 0 < got.accept_ratio_per_chain[0] < 100
    for split in ("train", "test"):
        a, b = got.traces[f"fx_{split}"], ref.traces[f"fx_{split}"]
        assert a.shape == b.shape == (40, 1, getattr(
            prob, split).shape[0])
        if task == "classification":
            np.testing.assert_array_equal(a, b)
        else:
            assert held(a, b).all(), split
        ga, gb = mcmc.predictive_bands(got, split), \
            jmcmc.predictive_bands(ref, split)
        for k in ("mean", "low", "high"):
            assert held(ga[k], gb[k]).all(), (split, k)
        assert (ga["low"] <= ga["high"]).all()


def test_single_chain_command_line(tmp_path, monkeypatch, capsys):
    """``python -m ptnn_torch.experiments.single_chain`` at a tiny budget
    on the CPU prints ptnn's line; its flags are ptnn's."""
    monkeypatch.setenv("PTNN_DEVICE", "cpu")
    single_chain.main(["--problem", "Sunspot", "--samples", "20",
                       "--no-langevin", "--out", str(tmp_path)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[Sunspot] single-chain accept%=")
    assert line.endswith(str(tmp_path / "Sunspot"))
    assert vars(single_chain.build_parser().parse_args([])) == dict(
        problem="Sunspot", samples=50_000, lr=0.01, langevin=True,
        l_prob=0.5, seed=0, out="results/single_chain")


def single_chain_reference(seed: int, samples: int = 10_000) -> dict:
    """ptnn's single-chain Langevin sampler on Sunspot at ``samples``: its
    accept %, the post-burn-in mean test RMSE, and the share of test
    targets inside ``predictive_bands``' 5-95 % band."""
    prob = load_regression("Sunspot")
    cfg = jmcmc.single_chain_config("regression", (4, 10, 1),
                                    samples=samples)
    res = jmcmc.run_single_chain(cfg, prob.train, prob.test, seed=seed)
    return single_chain_stats(res, prob.test[:, 4], jmcmc.predictive_bands)


def single_chain_stats(res, y_test, bands_fn) -> dict:
    burn = int(res.config.samples_per_chain * res.config.burn_in)
    b = bands_fn(res, "test")
    inside = float(np.mean((y_test >= b["low"]) & (y_test <= b["high"])))
    return dict(accept=float(res.accept_ratio_per_chain[0]),
                rmse=float(np.mean(res.traces["rmse_test"][burn:, 0])),
                inside=100.0 * inside)


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    for s in sys.argv[1:]:
        print("single-chain seed", s, json.dumps(
            single_chain_reference(int(s))), flush=True)
