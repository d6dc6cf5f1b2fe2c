"""The port's fused sampler against ptnn.fused.

``block_plan`` must equal ptnn's. The slice as a whole: the port's
``sample_fused`` on the CPU (plain block version) against ptnn's (Pallas
kernel in interpret mode) on Sunspot, started from ptnn's initial state
(through ``convert.chain_state_from_numpy``) and fed ptnn's own noise
(``jax.random`` from the run key, folded with each block's start, split as
ptnn.fused's ``block_body`` splits it) through ``noise_fn``. Accept counts,
replica identities and swap counts match exactly; float traces and the
final state within rtol 2e-4, atol 2e-5 (tests/test_pallas_step.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import fused as jfused
from ptnn import kernel as jkernel
from ptnn import sampler as jsampler
from ptnn.data import load_regression
from ptnn_torch import convert
from ptnn_torch import fused as tfused
from ptnn_torch.ops import block_step

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


def _kw(**kw):
    base = dict(task="regression", topology=(4, 10, 1), num_samples=8 * 100,
                num_chains=8, maxtemp=5.0, swap_interval=10, swap_offset=0,
                swap_payload="tempered_times_T",
                use_langevin_gradients=False, record_w=True,
                track_replicas=True, fused_step=True)
    base.update(kw)
    return base


PLAN_CASES = [
    _kw(),  # switch at step 60 inside the run
    _kw(num_samples=8 * 500, swap_interval=100),
    _kw(num_samples=8 * 1001, swap_interval=300),  # non-integral switch
    _kw(num_samples=8 * 700, swap_interval=0),  # no swaps: cut at 128
    _kw(num_samples=64 * 5000, num_chains=64, swap_interval=100),  # bench
    _kw(num_samples=8 * 400, swap_interval=25, swap_offset=1),
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_block_plan_matches_ptnn(case):
    kw = PLAN_CASES[case]
    jcfg = ptnn.PTConfig(**kw).validate()
    tcfg = ptnn_torch.PTConfig(**kw).validate()
    for k_cap in (128, 7):
        assert tfused.block_plan(tcfg, k_cap) == jfused.block_plan(jcfg, k_cap)
    for i in range(min(tcfg.n_steps, 400)):
        assert tfused._swap_due_host(tcfg, i) == jfused._swap_due_host(jcfg, i)


def test_fused_reason_scope():
    assert tfused.fused_reason(ptnn_torch.PTConfig(**_kw())) is None
    for bad in (dict(task="classification", topology=(4, 5, 3)),
                dict(proposal="precond_mala"),
                dict(record_thin=2, track_replicas=False)):
        cfg = ptnn_torch.PTConfig(**_kw(**bad)).validate()
        assert tfused.fused_reason(cfg) is not None
        with pytest.raises(ValueError, match="fused sampler runs"):
            tfused.sample_fused(cfg, np.zeros((4, 5)), np.zeros((4, 5)),
                                device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ptnn_torch.sample(ptnn_torch.PTConfig(**_kw(fused_step=False)),
                          np.zeros((4, 5)), np.zeros((4, 5)), device="cpu")


def _ptnn_noise_fn(k_run, p_pad, c_pad, w_size):
    """ptnn.fused._Fused.block_body's noise for the block at ``start``,
    cut to the port's chains-major (K, C, W) layout."""
    row_mask = (jnp.arange(p_pad) < w_size).astype(jnp.float32)[:, None]

    def noise_fn(start, k_max, c, w):
        kb = jax.random.fold_in(k_run, start)
        kp, ke, ku, _kue, ks = jax.random.split(kb, 5)
        nw = jax.random.normal(kp, (k_max, p_pad, c_pad), jnp.float32) * row_mask
        ne = jax.random.normal(ke, (k_max, c_pad), jnp.float32)
        u = jax.random.uniform(ku, (k_max, c_pad), jnp.float32)
        us = jax.random.uniform(ks, (c - 1,), jnp.float32)  # swap.py:91
        t = lambda a: torch.from_numpy(np.array(a))
        return (t(np.asarray(nw)[:, :w, :c].transpose(0, 2, 1)),
                t(np.asarray(ne)[:, :c]), t(np.asarray(u)[:, :c]), t(us))

    return noise_fn


def test_sample_fused_matches_ptnn_on_sunspot():
    seed = 2
    prob = load_regression("Sunspot")
    jcfg = ptnn.PTConfig(**_kw()).validate()
    tcfg = ptnn_torch.PTConfig(**_kw()).validate()
    assert 0 < jcfg.temper_switch_step < jcfg.n_steps
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    data = jsampler.make_dataset(jcfg, prob.train, prob.test)
    st0 = jkernel.init_state(k_init, jcfg, data)
    ref = jfused.sample_fused(jcfg, prob.train, prob.test, seed=seed,
                              init_state=st0)

    st0_np = {k: (None if v is None else np.asarray(v))
              for k, v in jax.device_get(st0)._asdict().items()}
    before = block_step.launches
    got = tfused.sample_fused(
        tcfg, prob.train, prob.test, seed=seed, device="cpu",
        init_state=convert.chain_state_from_numpy(st0_np),
        noise_fn=_ptnn_noise_fn(k_run, 64, 128, 61),
    )
    assert block_step.launches == before

    assert set(got.traces) == set(ref.traces)
    for k, v in ref.traces.items():
        assert got.traces[k].shape == v.shape, k
    np.testing.assert_array_equal(got.traces["accept_count"],
                                  ref.traces["accept_count"])
    np.testing.assert_array_equal(got.traces["replica"],
                                  ref.traces["replica"])
    assert got.swap_percent == ref.swap_percent
    assert 0.0 < got.swap_percent < 100.0
    np.testing.assert_array_equal(got.accept_ratio_per_chain,
                                  ref.accept_ratio_per_chain)
    for k in ("ll", "rmse_train", "rmse_test", "acc_train", "acc_test", "w"):
        np.testing.assert_allclose(got.traces[k], ref.traces[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got.pair_swap_accept, ref.pair_swap_accept,
                               rtol=RTOL, atol=ATOL)

    fin = convert.chain_state_to_numpy(got.final_state)
    jfin = ref.final_state._asdict()
    for k in ("n_accept", "replica_id", "pair_prop_count", "n_swap_accepted",
              "n_swap_proposed"):
        np.testing.assert_array_equal(fin[k], np.asarray(jfin[k]), err_msg=k)
    for k in ("w", "w_last", "eta", "ll", "prior", "rmse_train", "rmse_test",
              "pair_accept_sum"):
        np.testing.assert_allclose(fin[k], np.asarray(jfin[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_throughput_runner_reps_repeat_on_cpu():
    prob = load_regression("Sunspot")
    cfg = ptnn_torch.PTConfig(**_kw(num_samples=8 * 40)).validate()
    rep = ptnn_torch.throughput_runner(cfg, prob.train, prob.test, seed=1,
                                       device="cpu")
    a, b = rep(), rep()
    assert a["chains"] == 8.0 and a["steps"] == float(cfg.n_steps)
    # the same initial state and noise every rep: the same chain
    assert a["accept_pct"] == b["accept_pct"]
    assert a["swap_pct"] == b["swap_pct"]
    assert a["trace_means"] == b["trace_means"]
    assert 0.0 < a["accept_pct"] < 100.0
