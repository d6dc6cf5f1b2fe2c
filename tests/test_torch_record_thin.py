"""``record_thin > 1`` in the port against ptnn's, both samplers.

Per step (``ptnn/sampler.py:219-223``): each chunk of ``_pick_chunk`` steps,
split at the temper switch, keeps its rows at local positions ``thin-1,
2*thin-1, ...``. Fused (``ptnn/fused.py:699-820``): each group of
``ceil(chunk_steps / k_max)`` blocks keeps its executed rows at those
positions, by a gather when ``thin < k_max`` and by one row a block into a
buffer when ``thin >= k_max``. The cases use chunk lengths that are not
multiples of ``thin`` on both sides of the temper switch.

Each run starts from ptnn's initial state and replays ptnn's noise
(``test_torch_step.ptnn_noise_fn``, ``test_torch_fused_driver._ptnn_noise_fn``):
the kept rows equal ``ptnn.sample(..., record_thin=t)``'s, counters
exactly and floats at the tolerances of the unthinned comparisons, and
``results.summarize`` gives ptnn's summary of the same thinned traces. The
port's thinned rows are also the port's unthinned rows at ptnn's positions,
bit for bit, and the final state is the same.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import fused as jfused
from ptnn import kernel as jkernel
from ptnn import results as jresults
from ptnn import sampler as jsampler
from ptnn.data import load_classification, load_regression
from ptnn_torch import convert, results
from ptnn_torch import fused as tfused
from ptnn_torch import sampler as tsampler
from ptnn_torch.models import fnn
from test_torch_fused_driver import (ATOL, RTOL, _assert_runs_match, _kw,
                                     _precond_kw, _ptnn_noise_fn)
from test_torch_step import (_assert_ll_close, _assert_states_match,
                             _iris_legacy, _sunspot_lg, ptnn_noise_fn)

torch.set_num_threads(1)


def _per_step_rows(cfg):
    """Trace row (1-based, after the init row) of every kept step, as ptnn
    keeps them, and the chunk lengths."""
    n, switch = cfg.n_steps, cfg.temper_switch_step
    segments = [(0, switch), (switch, n)] if 0 < switch < n else [(0, n)]
    rows, lengths = [], []
    for a, b in segments:
        chunk = tsampler._pick_chunk(b - a, max(1, min(cfg.chunk_steps, n)))
        for lo in range(a, b, chunk):
            steps = list(range(lo, min(lo + chunk, b)))
            lengths.append(len(steps))
            rows += [s + 1 for s in steps[cfg.record_thin - 1::cfg.record_thin]]
    return rows, lengths


def _fused_rows(cfg, plan, k_max):
    rows, lengths = [], []
    group = max(1, int(np.ceil(cfg.chunk_steps / k_max)))
    for seg in plan:
        for gi in range(0, len(seg), group):
            steps = [s + p for (s, ln, _f) in seg[gi:gi + group]
                     for p in range(ln)]
            lengths.append(len(steps))
            rows += [s + 1 for s in steps[cfg.record_thin - 1::cfg.record_thin]]
    return rows, lengths


def _as_ptnn_result(res, jcfg):
    return jsampler.SampleResult(
        traces=res.traces, final_state=None, temperatures=res.temperatures,
        accept_ratio_per_chain=res.accept_ratio_per_chain,
        swap_percent=res.swap_percent,
        langevin_ratio_per_chain=res.langevin_ratio_per_chain,
        elapsed_s=res.elapsed_s, chain_steps_per_sec=res.chain_steps_per_sec,
        config=jcfg, pair_swap_accept=res.pair_swap_accept)


def _summaries_agree(got, ref, jcfg, name, rtol=RTOL, atol=ATOL):
    """The port's summary of its thinned run is ptnn's summary of the same
    traces, field for field, and close to ptnn's summary of its own run."""
    for cold in (False, True):
        mine = results.summarize(got, name, cold_only=cold)
        theirs = jresults.summarize(_as_ptnn_result(got, jcfg), name,
                                    cold_only=cold)
        assert vars(mine) == vars(theirs)
        want = jresults.summarize(ref, name, cold_only=cold)
        for k in ("train_mean", "train_std", "test_mean", "test_std",
                  "train_best", "test_best", "swap_perc", "accept_per"):
            np.testing.assert_allclose(getattr(mine, k), getattr(want, k),
                                       rtol=rtol, atol=atol, err_msg=k)


PER_STEP_CASES = {
    # Sunspot lg_pallas at 8 chains: chunks of 6 and 5 steps around the
    # switch at 24, thin 4
    "sunspot_lg": (_sunspot_lg, dict(chunk_steps=6), 4, "Sunspot"),
    # iris RW per step: chunks of 12 and 5 steps, thin 5
    "iris_rw": (_iris_legacy, dict(use_langevin_gradients=False,
                                   qratio="reference", chunk_steps=7), 5,
                "iris"),
}


@pytest.mark.parametrize("case", list(PER_STEP_CASES))
def test_per_step_thinned_rows_match_ptnn(case):
    make, extra, thin, name = PER_STEP_CASES[case]
    prob = (load_regression(name) if name == "Sunspot"
            else load_classification(name))
    kw = make(**extra, track_replicas=False, record_thin=thin)
    jcfg = ptnn.PTConfig(**kw).validate()
    tcfg = ptnn_torch.PTConfig(**kw).validate()
    rows, lengths = _per_step_rows(tcfg)
    assert 0 < tcfg.temper_switch_step < tcfg.n_steps
    assert any(ln % thin for ln in lengths), lengths
    seed = 5
    data = jsampler.make_dataset(jcfg, prob.train, prob.test)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    st0 = jkernel.init_state(k_init, jcfg, data)
    st0_np = {k: (None if v is None else np.asarray(v))
              for k, v in jax.device_get(st0)._asdict().items()}
    ref = ptnn.sample(jcfg, prob.train, prob.test, seed=seed, init_state=st0)
    got = ptnn_torch.sample(tcfg, prob.train, prob.test, seed=seed,
                            device="cpu",
                            init_state=convert.chain_state_from_numpy(st0_np),
                            noise_fn=ptnn_noise_fn(k_run))
    assert set(got.traces) == set(ref.traces)
    assert got.traces["ll"].shape[0] == len(rows) + 1
    for k, v in ref.traces.items():
        assert got.traces[k].shape == v.shape, k
    exact = ["accept_count"] + (["acc_train", "acc_test"]
                                if tcfg.task == "classification" else [])
    for k in exact:
        np.testing.assert_array_equal(got.traces[k], ref.traces[k],
                                      err_msg=k)
    for k in ("rmse_train", "rmse_test", "w"):
        np.testing.assert_allclose(got.traces[k], ref.traces[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    _assert_ll_close(got.traces["ll"], ref.traces["ll"], tcfg, prob,
                     got.temperatures[None, :])
    assert got.swap_percent == ref.swap_percent
    np.testing.assert_array_equal(got.accept_ratio_per_chain,
                                  ref.accept_ratio_per_chain)
    _assert_states_match(got.final_state, ref.final_state, tcfg)
    _summaries_agree(got, ref, jcfg, name)
    # the port's unthinned run on the same noise: the same rows, bit for bit
    full = ptnn_torch.sample(dataclasses.replace(tcfg, record_thin=1),
                             prob.train, prob.test, seed=seed, device="cpu",
                             init_state=convert.chain_state_from_numpy(st0_np),
                             noise_fn=ptnn_noise_fn(k_run))
    for k, v in got.traces.items():
        np.testing.assert_array_equal(v[1:], full.traces[k][rows], err_msg=k)
    torch.testing.assert_close(got.final_state.w, full.final_state.w,
                               rtol=0, atol=0)


FUSED_CASES = {
    # Sunspot rw_fused: blocks of up to 11 steps (k_max), groups of 3
    "rw_gather": (dict(chunk_steps=25), 3),
    "rw_sparse_at_k_max": (dict(chunk_steps=25), 11),
    "rw_sparse": (dict(chunk_steps=25), 13),
    "mala_gather": (dict(proposal="precond_mala", chunk_steps=15), 4),
    "chees_sparse": (dict(proposal="hmc", hmc_leapfrog=4, hmc_adapt_traj=True,
                          step_w=0.01, chunk_steps=15), 11),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_thinned_rows_match_ptnn(case):
    extra, thin = FUSED_CASES[case]
    prob = load_regression("Sunspot")
    if "proposal" in extra:
        kw = _precond_kw(**extra)
    else:
        kw = _kw(**extra)
    kw.update(track_replicas=False, record_thin=thin)
    jcfg = ptnn.PTConfig(**kw).validate()
    tcfg = ptnn_torch.PTConfig(**kw).validate()
    plan = tfused.block_plan(tcfg)
    assert plan == jfused.block_plan(jcfg)
    k_max = max(ln for seg in plan for (_s, ln, _f) in seg)
    assert (thin >= k_max) == ("sparse" in case)
    rows, lengths = _fused_rows(tcfg, plan, k_max)
    assert any(ln % thin for ln in lengths), lengths
    assert 0 < tcfg.temper_switch_step < tcfg.n_steps
    seed = 6
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    data = jsampler.make_dataset(jcfg, prob.train, prob.test)
    st0 = jkernel.init_state(k_init, jcfg, data)
    st0_np = {k: (None if v is None else np.asarray(v))
              for k, v in jax.device_get(st0)._asdict().items()}
    w_size = fnn.w_size(tcfg.topology)
    noise = lambda: _ptnn_noise_fn(k_run, -(-w_size // 8) * 8, 128, w_size)
    ref = jfused.sample_fused(jcfg, prob.train, prob.test, seed=seed,
                              init_state=st0)
    got = tfused.sample_fused(
        tcfg, prob.train, prob.test, seed=seed, device="cpu",
        init_state=convert.chain_state_from_numpy(st0_np), noise_fn=noise())
    assert got.traces["ll"].shape[0] == len(rows) + 1
    precond = tcfg.proposal != "reference"
    state_floats = (("log_step_w", "log_step_eta", "pc_mean", "pc_m2")
                    if precond else ())
    rtol, atol = (5e-4, 5e-5) if precond else (RTOL, ATOL)
    _assert_runs_match(got, ref, rtol, atol, state_floats)
    _summaries_agree(got, ref, jcfg, "Sunspot", rtol, atol)
    full = tfused.sample_fused(
        dataclasses.replace(tcfg, record_thin=1), prob.train, prob.test,
        seed=seed, device="cpu",
        init_state=convert.chain_state_from_numpy(st0_np), noise_fn=noise())
    for k, v in got.traces.items():
        np.testing.assert_array_equal(v[1:], full.traces[k][rows], err_msg=k)
    torch.testing.assert_close(got.final_state.w, full.final_state.w,
                               rtol=0, atol=0)


def test_thinner_regimes_keep_ptnn_positions():
    """``keep_flat`` and ``posdest`` select the same rows as ptnn's
    ``_keep_flat`` / ``_posdest`` (which count padded block slots) on
    groups with ragged and empty tails."""
    for lengths, thin in (([10, 10, 7], 3), ([10, 10, 7], 10), ([4], 7),
                          ([10, 3, 10, 10], 13), ([5, 5], 1 + 5)):
        k_max = max(lengths)
        flat = [bi * k_max + p for bi, ln in enumerate(lengths)
                for p in range(ln)]
        want = flat[thin - 1::thin]
        executed = np.asarray(flat)
        np.testing.assert_array_equal(
            executed[tfused.keep_flat(lengths, thin)], want)
        if thin >= k_max:
            pd, n_keep = tfused.posdest(lengths, thin)
            assert n_keep == len(want)
            got = sorted(int(bi * k_max + p) for bi, (p, dst) in enumerate(pd)
                         if dst >= 0)
            assert got == want
            assert [int(d) for d in pd[:, 1] if d >= 0] == list(range(n_keep))


def test_per_step_thinned_vr_and_fx_rows_match_ptnn():
    """The variational reference's traces (``ll_cur``, ``vr_corr_cur``)
    and the posterior-predictive ones (``fx_train``, ``fx_test``) thin like
    the others: a Sunspot VR random walk with ``record_fx`` at thin 3,
    chunks of 7, from ptnn's state with ptnn's draws, keeps ptnn's rows
    (counters exactly, floats at the run tolerance), and they are the
    port's unthinned rows at ptnn's positions, bit for bit."""
    from test_torch_vref import (_np_state, ptnn_start, sunspot_vr,
                                 vr_noise_fn)

    prob = load_regression("Sunspot")
    kw = sunspot_vr(track_replicas=False, record_fx=True, chunk_steps=7,
                    record_thin=3)
    jcfg = ptnn.PTConfig(**kw).validate()
    tcfg = ptnn_torch.PTConfig(**kw).validate()
    rows, lengths = _per_step_rows(tcfg)
    assert any(ln % 3 for ln in lengths), lengths
    _data, st0, k_run = ptnn_start(jcfg, prob.train, prob.test, seed=5)
    ref = ptnn.sample(jcfg, prob.train, prob.test, seed=5, init_state=st0)

    def run(cfg):
        return ptnn_torch.sample(
            cfg, prob.train, prob.test, seed=5, device="cpu",
            init_state=convert.chain_state_from_numpy(_np_state(st0)),
            noise_fn=vr_noise_fn(k_run, cfg))

    got = run(tcfg)
    assert set(got.traces) == set(ref.traces) >= {
        "ll_cur", "vr_corr_cur", "fx_train", "fx_test"}
    assert got.traces["ll"].shape[0] == len(rows) + 1
    np.testing.assert_array_equal(got.traces["accept_count"],
                                  ref.traces["accept_count"])
    for k in ("rmse_test", "fx_train", "fx_test", "w"):
        np.testing.assert_allclose(got.traces[k], ref.traces[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    _assert_ll_close(got.traces["ll_cur"], ref.traces["ll_cur"], tcfg, prob,
                     np.ones_like(got.temperatures)[None, :])
    want = ref.traces["vr_corr_cur"]
    assert np.all(np.abs(got.traces["vr_corr_cur"] - want)
                  <= ATOL + RTOL * np.abs(want))
    assert got.vr_regen_proposed == ref.vr_regen_proposed > 0
    full = run(dataclasses.replace(tcfg, record_thin=1))
    for k, v in got.traces.items():
        np.testing.assert_array_equal(v[1:], full.traces[k][rows], err_msg=k)
