"""The port's ladder tuning (``ptnn_torch.tuning``) against ptnn's.

``suggest_num_chains`` on the same barriers; ``tune_ladder`` (two feedback
rounds) with each pilot of the port started from ptnn's initial state for
its seed and fed ptnn's draws (``test_torch_vref.vr_noise_fn``): the
per-round ladders, rejection profiles, barriers and swap percentages and the
tuned ladder equal ptnn's at the run tolerance (rtol 2e-4), on the
corrected-path ladder of ``scripts/evidence_model_selection.py`` (the T =
inf rung kept as an endpoint) and on replicated ladders, whose profiles
pool (tests/test_ladder_tuning.py:203).

``python tests/test_torch_tuning.py HIDDEN SEED ...`` runs ptnn's
model-selection procedure (``scripts/evidence_model_selection.py:80-118``)
on the CPU for one hidden size, one line a seed: the source of
``chip_smoke.py``'s bands for the port's run of it.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import kernel as jkernel
from ptnn import sampler as jsampler
from ptnn import tuning as jtuning
from ptnn.data import load_regression
from ptnn_torch import convert, sampler, tuning
from test_torch_vref import _np_state, vr_noise_fn

torch.set_num_threads(1)

RTOL = 2e-4


@pytest.mark.parametrize("barrier,target", [(0.0, 0.5), (3.7, 0.5),
                                            (12.0, 0.3), (1.0, 0.9)])
def test_suggest_num_chains_matches_ptnn(barrier, target):
    assert tuning.suggest_num_chains(barrier, target) == \
        jtuning.suggest_num_chains(barrier, target)
    with pytest.raises(ValueError, match="target_reject"):
        tuning.suggest_num_chains(barrier, 1.0)


def replay_sample(monkeypatch):
    """The port's ``sampler.sample`` fed ptnn's draws for the seed, and its
    ``sampler.init_chains`` (a fresh initial state) ptnn's initial state for
    the seed."""
    real = sampler.sample

    def init_chains(cfg, data, seed, spec=None):
        jcfg = ptnn.PTConfig(**dataclasses.asdict(cfg)).validate()
        rows = [np.concatenate([x.numpy(), y.numpy()[:, None]], axis=1)
                for x, y in ((data.x_train, data.y_train),
                             (data.x_test, data.y_test))]
        jdata = jsampler.make_dataset(jcfg, *rows)
        k_init, _ = jax.random.split(jax.random.PRNGKey(seed))
        return convert.chain_state_from_numpy(
            _np_state(jkernel.init_state(k_init, jcfg, jdata)))

    def sample(cfg, train, test, seed=0, device="cuda", **kw):
        jcfg = ptnn.PTConfig(**dataclasses.asdict(cfg)).validate()
        _k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
        return real(cfg, train, test, seed=seed, device="cpu",
                    noise_fn=vr_noise_fn(k_run, jcfg), **kw)

    monkeypatch.setattr(sampler, "init_chains", init_chains)
    monkeypatch.setattr(sampler, "sample", sample)


def selection_cfg(hidden, num_samples, chains=16):
    """``scripts/evidence_model_selection.py``'s ``vr_cfg``."""
    return dict(task="regression", topology=(4, hidden, 1),
                num_samples=num_samples, num_chains=chains, maxtemp=20.0,
                swap_interval=4, swap_offset=0, swap_style="even_odd",
                swap_payload="untempered", swap_rule="metropolis",
                pt_phase_frac=2.0, variational_reference=True,
                vr_hot_infinite=True, record_w=True, record_w_chains=1,
                record_ll_state=True, chunk_steps=200)


TUNE_CASES = {
    # the model-selection ladder at 8 chains x 60, pilots of 40
    "vr_hidden2": (selection_cfg(2, 8 * 60, 8), 8 * 40, (0,)),
    # two ladders of four rungs, two pilot seeds: the profiles pool
    "two_ladders": (dict(task="regression", topology=(4, 10, 1),
                         num_samples=8 * 40, num_chains=8, n_ladders=2,
                         maxtemp=5.0, swap_interval=5, swap_offset=0,
                         swap_style="even_odd", swap_payload="untempered",
                         swap_rule="metropolis"), None, (1, 2)),
}


@pytest.mark.parametrize("case", sorted(TUNE_CASES))
def test_tune_ladder_matches_ptnn(case, monkeypatch):
    kw, pilot, seeds = TUNE_CASES[case]
    prob = load_regression("Sunspot")
    want = jtuning.tune_ladder(ptnn.PTConfig(**kw).validate(), prob.train,
                               prob.test, rounds=2, seeds=seeds,
                               pilot_samples=pilot)
    replay_sample(monkeypatch)
    got = tuning.tune_ladder(ptnn_torch.PTConfig(**kw).validate(),
                             prob.train, prob.test, rounds=2, seeds=seeds,
                             pilot_samples=pilot, device="cpu")
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g.temperatures, w.temperatures, rtol=RTOL)
        np.testing.assert_allclose(g.pair_reject, w.pair_reject, rtol=RTOL,
                                   atol=1e-5)
        np.testing.assert_allclose(g.barrier, w.barrier, rtol=RTOL)
        assert g.swap_percent == w.swap_percent
    np.testing.assert_allclose(got.temperatures, want.temperatures,
                               rtol=RTOL)
    k = ptnn_torch.PTConfig(**kw).validate().rungs_per_ladder
    assert got.temperatures.shape == (k,) and got.temperatures[0] == 1.0
    assert np.isinf(got.temperatures[-1]) == np.isinf(want.temperatures[-1])
    assert got.suggested_num_chains == want.suggested_num_chains
    with pytest.raises(ValueError, match="3 chains"):
        tuning.tune_ladder(dataclasses.replace(
            ptnn_torch.PTConfig(**kw), num_chains=2, n_ladders=1),
            prob.train, prob.test, device="cpu")


def model_selection_reference(hidden: int, seeds, steps: int = 1600):
    """ptnn's procedure of ``scripts/evidence_model_selection.py`` for one
    hidden size: the VR ladder tuned (two rounds, pilots of steps / 2),
    then a run a seed: the absolute log Z (stepping stone), the PSIS-LOO
    elpd of the cold draws on the train rows, the cold test RMSE at the
    end, and the tuned ladder's barrier."""
    from ptnn.ops import evidence, ic

    prob = load_regression("Sunspot")
    cfg = ptnn.PTConfig(**selection_cfg(hidden, 16 * steps)).validate()
    tuned = jtuning.tune_ladder(cfg, prob.train, prob.test, rounds=2,
                                pilot_samples=16 * max(steps // 2, 200))
    cfg_t = dataclasses.replace(cfg, custom_ladder=tuple(
        float(t) for t in tuned.temperatures)).validate()
    x_tr, y_tr = prob.train[:, :4], prob.train[:, 4]
    out = []
    for seed in seeds:
        res = ptnn.sample(cfg_t, prob.train, prob.test, seed=seed)
        est = evidence.from_result(res)
        w_tr = np.asarray(res.traces["w"])[:, 0, :]
        start = max(int(w_tr.shape[0] * cfg_t.burn_in), 1)
        draws = w_tr[start::max((w_tr.shape[0] - start) // 1000, 1)]
        loo = ic.psis_loo(ic.pointwise_log_lik(cfg_t, draws, x_tr, y_tr))
        out.append(dict(hidden=hidden, seed=seed, log_z_ss=est.log_z_abs_ss,
                        elpd_loo=float(loo["elpd_loo"]),
                        rmse=float(res.traces["rmse_test"][-1, 0]),
                        barrier=tuned.barrier))
    return out


def barrier_reference(hidden: int, pilot_seed: int, steps: int = 1600):
    """The barrier of ptnn's tuned model-selection ladder with the pilots
    at ``pilot_seed`` (the script's are at 0): the spread of the port's
    own tuning, whose pilots draw other noise."""
    prob = load_regression("Sunspot")
    cfg = ptnn.PTConfig(**selection_cfg(hidden, 16 * steps)).validate()
    return jtuning.tune_ladder(cfg, prob.train, prob.test, rounds=2,
                               seeds=(pilot_seed,),
                               pilot_samples=16 * max(steps // 2, 200)
                               ).barrier


if __name__ == "__main__":
    # python tests/test_torch_tuning.py HIDDEN SEED ...: one line a seed;
    # python tests/test_torch_tuning.py barrier HIDDEN PILOT_SEED ...
    import sys

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "barrier":
        for s in sys.argv[3:]:
            print(json.dumps(dict(hidden=int(sys.argv[2]), pilot_seed=int(s),
                                  barrier=barrier_reference(int(sys.argv[2]),
                                                            int(s)))),
                  flush=True)
    else:
        for row in model_selection_reference(int(sys.argv[1]),
                                             [int(s) for s in sys.argv[2:]]):
            print(json.dumps(row), flush=True)
