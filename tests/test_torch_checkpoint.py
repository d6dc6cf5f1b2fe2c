"""Checkpoints of the port (``ptnn_torch.checkpoint``,
``sample(checkpoint_path=..., checkpoint_every=...)``).

A run stopped after a checkpoint and run again on the same path resumes at
the checkpoint's step with its traces and ends bit for bit where a run that
was never stopped ends: every trace, counter and state tensor. A checkpoint
of another seed or config is not loaded; a fused config with a checkpoint
falls back to the per-step sampler with ptnn's warning; the fingerprint is
ptnn's for the same fields; ``cnn_digits --checkpoint`` runs and resumes.
The variational reference's state (its moments or fitted reference, the
Cholesky factor, the regeneration counters) and the posterior-predictive
carries ride the checkpoint: a static full-covariance run and a Welford run
with ``record_fx`` resume bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import checkpoint as jckpt
from ptnn_torch import checkpoint, convert, kernel, sampler
from ptnn_torch.data import load_classification, load_digits, load_regression
from ptnn_torch.models import cnn

torch.set_num_threads(1)


class Stop(Exception):
    pass


def _stopping(noise_fn, at):
    """The noise of ``noise_fn`` until the chunk that starts at ``at``."""
    def fn(start, length, c, w):
        if start >= at:
            raise Stop(start)
        return noise_fn(start, length, c, w)

    return fn


def _lg(**kw):
    base = dict(
        task="regression", topology=(4, 10, 1), num_samples=8 * 40,
        num_chains=8, maxtemp=5.0, swap_interval=10, swap_offset=0,
        swap_payload="tempered_times_T", use_langevin_gradients=True,
        drift_mode="pallas", record_w=True, track_replicas=True,
        chunk_steps=4)
    return ptnn_torch.PTConfig(**dict(base, **kw)).validate()


def _iris_mala(**kw):
    base = ptnn_torch.classification_preset((4, 12, 3), num_samples=8 * 40,
                                            num_chains=8)
    return dataclasses.replace(
        base, proposal="precond_mala", swap_interval=10, n_ladders=2,
        swap_style="even_odd", warmstart_frac=0.1, precond_start_frac=0.3,
        adapt_rate=0.1, step_w=0.3, chunk_steps=6, record_thin=2,
        **kw).validate()


VR = dict(swap_interval=5, swap_style="even_odd", swap_payload="untempered",
          swap_rule="metropolis", pt_phase_frac=2.0,
          variational_reference=True, vr_hot_infinite=True,
          record_ll_state=True, record_eta=True)


def _vr_static_full_cov():
    """The rounds' static full-covariance reference on the random walk
    (tests/test_rounds.py:235), swaps every 5 with the hot rung
    regenerated; chunks of 4."""
    return _lg(use_langevin_gradients=False, vr_mode="static",
               vr_family="full_cov", **VR)


def _vr_welford_fx():
    """lg_pallas on the Welford reference with the posterior-predictive
    traces (tests/test_vref.py:205): the fit accumulates from step 5 and
    freezes at 19, across the stop."""
    return _lg(record_fx=True, **VR)


def _fitted(cfg, data):
    """A static reference fitted to draws around a random point."""
    from ptnn_torch.ops import vref

    st = sampler.init_chains(cfg, data, 4)
    rng = np.random.default_rng(9)
    z = st.vr_mean.shape[0]
    draws = rng.standard_normal(z) + 0.2 * rng.standard_normal((300, z))
    return kernel.set_static_reference(st, cfg, *vref.fit_gaussian(
        draws, cfg.vr_family))


CASES = {
    # Sunspot lg_pallas: the switch at 24 inside the run, chunks of 4
    "sunspot_lg": (_lg, load_regression, "Sunspot", 21),
    # iris per-step MALA, thinned by 2: chunks of 6 (12 after the switch)
    "iris_mala_thinned": (_iris_mala, load_classification, "iris", 30),
    # the variational reference: its state (vr_*, n_regen_*) and traces
    "sunspot_vr_static_full_cov": (_vr_static_full_cov, load_regression,
                                   "Sunspot", 21),
    "sunspot_vr_welford_fx": (_vr_welford_fx, load_regression, "Sunspot",
                              13),
}


def _assert_same_run(got, want):
    assert set(got.traces) == set(want.traces)
    for k, v in want.traces.items():
        np.testing.assert_array_equal(got.traces[k], v, err_msg=k)
    a = convert.chain_state_to_numpy(got.final_state)
    b = convert.chain_state_to_numpy(want.final_state)
    for k in a:
        if b[k] is None:
            assert a[k] is None, k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(got.accept_ratio_per_chain,
                                  want.accept_ratio_per_chain)
    assert got.swap_percent == want.swap_percent


@pytest.mark.parametrize("case", list(CASES))
def test_stopped_run_resumes_bit_for_bit(case, tmp_path):
    make, load, name, stop_at = CASES[case]
    cfg = make()
    prob = load(name)
    path = str(tmp_path / "run.npz")
    init = None
    if cfg.variational_reference and cfg.vr_mode == "static":
        init = _fitted(cfg, sampler.make_dataset(cfg, prob.train, prob.test,
                                                 "cpu"))
    want = ptnn_torch.sample(cfg, prob.train, prob.test, seed=4,
                             device="cpu", init_state=init)
    noise = sampler.step_noise(4, torch.device("cpu"),
                               kernel.step_noise_names(cfg))
    with pytest.raises(Stop):
        sampler.sample_per_step(cfg, prob.train, prob.test, seed=4,
                                device="cpu", init_state=init,
                                noise_fn=_stopping(noise, stop_at),
                                checkpoint_path=path, checkpoint_every=2)
    spec = kernel.default_spec(cfg).name
    state, done, traces = checkpoint.load(path, cfg, 4, spec)
    assert 0 < done < cfg.n_steps
    assert traces["ll"].shape[0] < want.traces["ll"].shape[0] - 1
    assert not os.path.exists(path + ".tmp")
    got = ptnn_torch.sample(cfg, prob.train, prob.test, seed=4, device="cpu",
                            init_state=init, checkpoint_path=path,
                            checkpoint_every=2)
    _assert_same_run(got, want)
    if cfg.variational_reference:
        assert got.vr_regen_proposed == want.vr_regen_proposed > 0
        assert state.vr_mean is not None and state.n_regen_proposed > 0
    # the finished run's checkpoint holds every step: a third call resumes
    # at the end and returns the same run
    assert checkpoint.load(path, cfg, 4, spec)[1] == cfg.n_steps
    again = ptnn_torch.sample(cfg, prob.train, prob.test, seed=4,
                              device="cpu", checkpoint_path=path)
    _assert_same_run(again, want)


def test_checkpoint_of_another_run_is_not_loaded(tmp_path):
    cfg = _lg(num_samples=8 * 10)
    prob = load_regression("Sunspot")
    path = str(tmp_path / "ck.npz")
    spec = kernel.default_spec(cfg).name
    assert checkpoint.load(path, cfg, 0, spec) is None  # no file
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=0, device="cpu",
                            checkpoint_path=path)
    assert checkpoint.load(path, cfg, 0, spec)[1] == cfg.n_steps
    for other in ((cfg, 1, spec),
                  (dataclasses.replace(cfg, maxtemp=4.0), 0, spec),
                  (cfg, 0, "mlp(64, 32, 10)-tanh")):
        assert checkpoint.load(path, *other) is None
    # a run of another seed on the same path starts afresh
    fresh = ptnn_torch.sample(cfg, prob.train, prob.test, seed=1,
                              device="cpu", checkpoint_path=path)
    plain = ptnn_torch.sample(cfg, prob.train, prob.test, seed=1,
                              device="cpu")
    _assert_same_run(fresh, plain)
    assert not np.array_equal(fresh.traces["w"], res.traces["w"])


def test_fused_config_with_checkpoint_falls_back(tmp_path):
    prob = load_regression("Sunspot")
    cfg = _lg(use_langevin_gradients=False, fused_step=True,
              num_samples=8 * 12)
    with pytest.warns(UserWarning, match="falling back to the per-step "
                      "sampler .fused_step does not checkpoint"):
        got = ptnn_torch.sample(cfg, prob.train, prob.test, seed=2,
                                device="cpu",
                                checkpoint_path=str(tmp_path / "f.npz"))
    per_step = ptnn_torch.sample(dataclasses.replace(cfg, fused_step=False),
                                 prob.train, prob.test, seed=2, device="cpu")
    _assert_same_run(got, per_step)


@pytest.mark.parametrize("make,spec_name", [
    (lambda: ptnn.regression_preset(num_samples=800, num_chains=8), ""),
    (lambda: ptnn.classification_preset((4, 12, 3), num_samples=1000,
                                        num_chains=10), "fnn(4, 12, 3)-x"),
    (lambda: dataclasses.replace(
        ptnn.regression_preset(num_samples=640, num_chains=64,
                               use_langevin_gradients=False),
        proposal="hmc", hmc_adapt_traj=True, n_ladders=16,
        swap_style="even_odd", record_thin=7, track_replicas=False),
     "cnn8x8c(8, 16)"),
])
def test_fingerprint_is_ptnn_s(make, spec_name):
    jcfg = make().validate()
    tcfg = ptnn_torch.PTConfig(**dataclasses.asdict(jcfg)).validate()
    for seed in (0, 3):
        assert (checkpoint.config_fingerprint(tcfg, seed, spec_name)
                == jckpt.config_fingerprint(jcfg, seed, spec_name))
    assert (checkpoint.config_fingerprint(tcfg, 0, spec_name)
            != checkpoint.config_fingerprint(tcfg, 1, spec_name))


def test_cnn_digits_checkpoint_runs_and_resumes(tmp_path, monkeypatch,
                                                capsys):
    from ptnn_torch.experiments import cnn_digits

    monkeypatch.setenv("PTNN_DEVICE", "cpu")
    full = load_digits
    monkeypatch.setattr(
        cnn_digits, "load_digits",
        lambda seed: dataclasses.replace(full(seed), train=full(seed).train[:40],
                                         test=full(seed).test[:20]))
    ck = tmp_path / "cnn.npz"
    argv = ["--chains", "4", "--steps", "12", "--swap-interval", "5",
            "--chunk-steps", "4", "--checkpoint", str(ck), "--out",
            str(tmp_path / "cnn")]
    cnn_digits.main(argv)
    first = capsys.readouterr().out.strip().splitlines()[-1]
    assert ck.is_file()
    cnn_digits.main(argv)  # resumes at the end: the same run
    second = capsys.readouterr().out.strip().splitlines()[-1]
    strip = lambda line: line.split(" (")[0]
    assert strip(first) == strip(second)
    a = np.loadtxt(tmp_path / "cnn" / "digits_0" / "accept_list.txt")
    b = np.loadtxt(tmp_path / "cnn" / "digits_1" / "accept_list.txt")
    np.testing.assert_array_equal(a, b)
    spec = cnn.digits_spec()
    assert checkpoint.load(str(ck), _cnn_cfg_of(tmp_path), 0,
                           spec.name)[1] == 11


def _cnn_cfg_of(tmp_path):
    import json

    with open(tmp_path / "cnn" / "digits_0" / "config.json") as f:
        return ptnn_torch.config.from_json_dict(json.load(f))
