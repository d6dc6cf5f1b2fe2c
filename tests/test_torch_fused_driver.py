"""The port's fused sampler against ptnn.fused.

``block_plan`` must equal ptnn's. The slice as a whole: the port's
``sample_fused`` on the CPU (plain block versions) against ptnn's (Pallas
kernels in interpret mode) on Sunspot and on iris, started from ptnn's
initial state (through ``convert.chain_state_from_numpy``) and fed ptnn's
own noise (``jax.random`` from the run key, folded with each block's start,
split as ptnn.fused's ``block_body`` splits it) through ``noise_fn``, for
the random-walk, preconditioned-MALA and HMC/ChEES proposals. Accept counts,
replica identities, swap counts and traj_len match exactly, and on iris the
accuracy traces; float traces and the final state within rtol 2e-4, atol
2e-5 for the random walk and rtol 5e-4, atol 5e-5 for MALA and HMC
(tests/test_pallas_step.py).
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
from ptnn.data import load_classification, load_regression
from ptnn_torch import convert
from ptnn_torch import fused as tfused
from ptnn_torch.models import fnn
from ptnn_torch.ops import block_step, precond_cls_step, precond_step

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
    for ok in (dict(task="classification", topology=(4, 5, 3)),
               dict(task="classification", topology=(4, 5, 3),
                    proposal="precond_mala")):
        assert tfused.fused_reason(ptnn_torch.PTConfig(**_kw(**ok))) is None
    for bad in (dict(topology=(4, 5, 2)),
                dict(record_thin=2, track_replicas=False),
                # ptnn's 160-chain ChEES refusal: one panel cannot hold it
                dict(proposal="hmc", hmc_adapt_traj=True, num_chains=160,
                     num_samples=160 * 100, n_ladders=40)):
        cfg = ptnn_torch.PTConfig(**_kw(**bad)).validate()
        assert tfused.fused_reason(cfg) is not None
        if bad.get("num_chains") == 160:
            assert "128-lane" in tfused.fused_reason(cfg)
        with pytest.raises(ValueError, match="fused sampler runs"):
            tfused.sample_fused(cfg, np.zeros((4, 5)), np.zeros((4, 5)),
                                device="cpu")
    # the working-set gate: a net whose block does not fit a Hopper block's
    # shared memory (Ionosphere's w_size 1852 under MALA) is refused
    iono = ptnn_torch.PTConfig(**_kw(task="classification",
                                     topology=(34, 50, 2),
                                     proposal="precond_mala")).validate()
    assert "shared memory" in tfused.working_set_reason(iono, 245, 106)
    assert tfused.working_set_reason(
        ptnn_torch.PTConfig(**_kw(task="classification", topology=(4, 12, 3),
                                  proposal="hmc", hmc_adapt_traj=True,
                                  n_ladders=2)).validate(), 105, 45) is None
    with pytest.raises(ValueError, match="shared memory"):
        tfused.sample_fused(iono, np.zeros((245, 36)), np.zeros((106, 36)),
                            device="cpu")
    # the per-step sampler runs what the fused one refuses: the reference
    # proposal and the preconditioned family
    from ptnn_torch import kernel

    for proposal in ("precond_rw", "precond_mala", "hmc", "pcn"):
        cfg = ptnn_torch.PTConfig(**_kw(fused_step=False,
                                        proposal=proposal)).validate()
        assert kernel.step_reason(cfg) is None


def test_topology_the_kernels_lack_falls_back_on_every_device():
    """Cancer's (9, 12, 2) net. The RW kernels take every topology (a
    fixed-shape classification kernel is built for it), so a fused RW
    config runs fused, with no warning, on the CPU (the plain version) as
    on the card. No MALA or HMC kernel is built for it, so those fall back
    to the per-step sampler with ptnn's warning on every device, which runs
    them; the fused sampler refuses them alike."""
    import dataclasses
    import warnings

    prob = ptnn_torch.data.load_classification("Cancer")
    assert prob.topology == (9, 12, 2)
    rw = dataclasses.replace(
        ptnn_torch.classification_preset((9, 12, 2), num_samples=8 * 6,
                                         num_chains=8),
        fused_step=True).validate()
    n_tr, n_te = prob.train.shape[0], prob.test.shape[0]
    assert tfused.runtime_reason(rw, n_tr, n_te) is None
    assert block_step.cls_variant(rw.topology) == "fixed"
    before = (block_step.launches, block_step.cls_launches)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no "falling back"
        res = ptnn_torch.sample(rw, prob.train, prob.test, device="cpu")
    assert res.traces["acc_test"].shape == (6, 8)
    assert (block_step.launches, block_step.cls_launches) == before
    # the fused sampler's own run: the same chain, so sample took it
    fused_res = tfused.sample_fused(rw, prob.train, prob.test, device="cpu")
    np.testing.assert_array_equal(res.traces["accept_count"],
                                  fused_res.traces["accept_count"])
    np.testing.assert_array_equal(res.traces["ll"], fused_res.traces["ll"])
    for proposal in ("precond_mala", "hmc"):
        cfg = dataclasses.replace(rw, proposal=proposal).validate()
        assert tfused.fused_reason(cfg) is None
        assert tfused.working_set_reason(cfg, n_tr, n_te) is None
        assert "built for" in tfused.runtime_reason(cfg, n_tr, n_te)
        with pytest.warns(UserWarning, match="falling back"):
            res = ptnn_torch.sample(cfg, prob.train, prob.test, device="cpu")
        assert res.traces["acc_test"].shape == (6, 8)
        assert np.isfinite(res.traces["ll"]).all()
        with pytest.raises(ValueError, match="built for"):
            tfused.sample_fused(cfg, prob.train, prob.test, device="cpu")
    # the topologies the kernels are built for pass the gate
    for cfg in (ptnn_torch.PTConfig(**_kw()),
                ptnn_torch.PTConfig(**_kw(proposal="precond_mala"))):
        assert tfused.topology_reason(cfg.validate()) is None
    for topo in ((4, 7, 1), (9, 12, 2), (4, 7, 3)):  # RW takes any
        task = "regression" if topo[2] == 1 else "classification"
        assert tfused.topology_reason(ptnn_torch.PTConfig(**_kw(
            task=task, topology=topo)).validate()) is None


def _ptnn_noise_fn(k_run, p_pad, c_pad, w_size):
    """ptnn.fused._Fused.block_body's noise for the block at ``start``,
    cut to the port's chains-major layout: ``kp, ke, ku, kue, ks =
    split(fold_in(k_run, start), 5)``, u_jit from ``fold_in(kb, 101)`` and
    u_traj = vdc_u(start + k)."""
    row_mask = (jnp.arange(p_pad) < w_size).astype(jnp.float32)[:, None]

    def noise_fn(start, k_max, c, w):
        kb = jax.random.fold_in(k_run, start)
        kp, ke, ku, kue, ks = jax.random.split(kb, 5)
        kc = lambda key: np.asarray(
            jax.random.uniform(key, (k_max, c_pad), jnp.float32))[:, :c]
        nw = jax.random.normal(kp, (k_max, p_pad, c_pad), jnp.float32) * row_mask
        ne = jax.random.normal(ke, (k_max, c_pad), jnp.float32)
        ut = jkernel.vdc_u(start + jnp.arange(k_max, dtype=jnp.int32))
        t = lambda a: torch.from_numpy(np.array(a))
        return dict(
            w=t(np.asarray(nw)[:, :w, :c].transpose(0, 2, 1)),
            eta=t(np.asarray(ne)[:, :c]), u=t(kc(ku)), u_eta=t(kc(kue)),
            u_jit=t(kc(jax.random.fold_in(kb, 101))), u_traj=t(ut),
            u_swap=t(jax.random.uniform(ks, (c - 1,), jnp.float32)),
        )

    return noise_fn


def _run_both(kw, seed, prob=None):
    prob = prob if prob is not None else load_regression("Sunspot")
    jcfg = ptnn.PTConfig(**kw).validate()
    tcfg = ptnn_torch.PTConfig(**kw).validate()
    assert tfused.block_plan(tcfg) == jfused.block_plan(jcfg)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    data = jsampler.make_dataset(jcfg, prob.train, prob.test)
    st0 = jkernel.init_state(k_init, jcfg, data)
    ref = jfused.sample_fused(jcfg, prob.train, prob.test, seed=seed,
                              init_state=st0)
    st0_np = {k: (None if v is None else np.asarray(v))
              for k, v in jax.device_get(st0)._asdict().items()}
    before = (block_step.launches, block_step.cls_launches,
              dict(precond_step.launches), dict(precond_cls_step.launches))
    w_size = fnn.w_size(tcfg.topology)
    got = tfused.sample_fused(
        tcfg, prob.train, prob.test, seed=seed, device="cpu",
        init_state=convert.chain_state_from_numpy(st0_np),
        noise_fn=_ptnn_noise_fn(k_run, -(-w_size // 8) * 8, 128, w_size),
    )
    assert (block_step.launches, block_step.cls_launches,
            precond_step.launches, precond_cls_step.launches) == before
    return got, ref


def _assert_runs_match(got, ref, rtol, atol, state_floats, ll_terms=None):
    """``ll_terms``: the size of the terms whose difference ll is (the
    regression default ``n_tr / T`` on Sunspot); classification's ll is a
    sum of negative terms, held on its own size (0 here)."""
    assert set(got.traces) == set(ref.traces)
    for k, v in ref.traces.items():
        assert got.traces[k].shape == v.shape, k
    cls = got.config.task == "classification"
    exact = ("accept_count", "replica", "traj_len")
    if cls:
        exact += ("acc_train", "acc_test")
    for k in exact:
        if k in ref.traces:
            np.testing.assert_array_equal(got.traces[k], ref.traces[k],
                                          err_msg=k)
    assert got.swap_percent == ref.swap_percent
    assert 0.0 < got.swap_percent < 100.0
    np.testing.assert_array_equal(got.accept_ratio_per_chain,
                                  ref.accept_ratio_per_chain)
    for k in ("rmse_train", "rmse_test", "acc_train", "acc_test", "w"):
        np.testing.assert_allclose(got.traces[k], ref.traces[k], rtol=rtol,
                                   atol=atol, err_msg=k)
    # ll is the difference of two terms of size >= n_tr / T that cancel
    # (the normalizer and SSE / 2 tau); its rtol applies to that size
    if ll_terms is None:
        ll_terms = load_regression("Sunspot").train.shape[0]
    scale = np.abs(ref.traces["ll"]) + ll_terms / got.temperatures[None, :]
    diff = np.abs(got.traces["ll"].astype(np.float64) - ref.traces["ll"])
    assert np.all(diff <= atol + rtol * scale), float(diff.max())
    np.testing.assert_allclose(got.pair_swap_accept, ref.pair_swap_accept,
                               rtol=rtol, atol=atol)
    fin = convert.chain_state_to_numpy(got.final_state)
    jfin = ref.final_state._asdict()
    for k in ("n_accept", "replica_id", "pair_prop_count", "n_swap_accepted",
              "n_swap_proposed"):
        np.testing.assert_array_equal(fin[k], np.asarray(jfin[k]), err_msg=k)
    for k in ("w", "w_last", "eta", "ll", "prior", "rmse_train", "rmse_test",
              "acc_train", "acc_test", "pair_accept_sum") + state_floats:
        np.testing.assert_allclose(fin[k], np.asarray(jfin[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_sample_fused_matches_ptnn_on_sunspot():
    got, ref = _run_both(_kw(), seed=2)
    assert 0 < got.config.temper_switch_step < got.config.n_steps
    _assert_runs_match(got, ref, RTOL, ATOL, ())


def _precond_kw(**kw):
    """bench.py's mala_16x4 / chees16_16x4 shape at 2 ladders of 4 rungs,
    40 steps: warm start to 4, preconditioner from 12, adaptation to 19,
    the temper switch at 24, DEO swaps after 10, 20 and 30. Gradient
    samplers amplify float32 rounding: over longer runs this port and ptnn
    drift apart as far as either drifts from a float64 run of the same
    chain, until a decision flips."""
    return _kw(num_samples=8 * 40, n_ladders=2, swap_style="even_odd",
               adapt_rate=0.1, warmstart_frac=0.1, precond_start_frac=0.3,
               record_w_chains=2, **kw)


@pytest.mark.parametrize("proposal", ["precond_mala", "chees"])
def test_precond_sample_fused_matches_ptnn_on_sunspot(proposal):
    if proposal == "chees":
        kw = _precond_kw(proposal="hmc", hmc_leapfrog=4, hmc_adapt_traj=True,
                         step_w=0.01)
    else:
        kw = _precond_kw(proposal="precond_mala")
    got, ref = _run_both(kw, seed=3)
    state_floats = ("log_step_w", "log_step_eta", "pc_mean", "pc_m2")
    if proposal == "chees":
        state_floats += ("log_traj", "chees_m1", "chees_v2")
        tl = got.traces["traj_len"][1:]
        assert tl.min() >= 1 and tl.max() <= 4 and len(np.unique(tl)) > 1
    assert got.traces["w"].shape == (got.config.samples_per_chain, 2, 61)
    _assert_runs_match(got, ref, 5e-4, 5e-5, state_floats)
    # g_like is the gradient of -SSE/2 at w. Near the mode it moves ~30x
    # faster than w, so each run's cache is held to the gradient at its
    # own final w (which agree above), and the port's gradient function to
    # ptnn's cache at ptnn's w.
    prob = load_regression("Sunspot")
    x = torch.from_numpy(prob.train[:, :4].astype(np.float32))
    y = torch.from_numpy(prob.train[:, 4].astype(np.float32))
    jfin = ref.final_state._asdict()
    for w, g_like in ((got.final_state.w, got.final_state.g_like),
                      (torch.from_numpy(np.array(jfin["w"])),
                       torch.from_numpy(np.array(jfin["g_like"])))):
        g = fnn.neg_half_sse_grad(w, x, y, (4, 10, 1))[1]
        torch.testing.assert_close(g_like, g, rtol=5e-4,
                                   atol=5e-5 * float(g.abs().max()))


def _cls_kw(**kw):
    """bench.py's classification variants (``_cls_variants``) on iris at 2
    ladders of 4 rungs, 40 steps: untempered Metropolis DEO swaps after
    steps 9, 19, 29, 39 (swap_offset 1), warm start to 4, preconditioner
    from 12, adaptation to 19, the temper switch at 24."""
    base = dict(task="classification", topology=(4, 12, 3),
                num_samples=8 * 40, num_chains=8, maxtemp=5.0,
                swap_interval=10, swap_offset=1, swap_rule="metropolis",
                swap_payload="untempered", n_ladders=2,
                swap_style="even_odd", adapt_rate=0.1, record_w=True,
                record_w_chains=2, track_replicas=True, fused_step=True)
    base.update(kw)
    return base


@pytest.mark.parametrize("proposal", ["reference", "precond_mala", "chees"])
def test_cls_sample_fused_matches_ptnn_on_iris(proposal):
    if proposal == "reference":
        kw = _cls_kw(step_w=0.05)
    elif proposal == "chees":
        kw = _cls_kw(proposal="hmc", hmc_leapfrog=4, hmc_adapt_traj=True,
                     step_w=0.05, warmstart_frac=0.1, precond_start_frac=0.3)
    else:
        kw = _cls_kw(proposal="precond_mala", step_w=0.3, warmstart_frac=0.1,
                     precond_start_frac=0.3)
    got, ref = _run_both(kw, seed=4, prob=load_classification("iris"))
    state_floats = ()
    if proposal != "reference":
        state_floats += ("log_step_w", "pc_mean", "pc_m2")
    if proposal == "chees":
        state_floats += ("log_traj", "chees_m1", "chees_v2")
        tl = got.traces["traj_len"][1:]
        assert tl.min() >= 1 and tl.max() <= 4 and len(np.unique(tl)) > 1
    assert got.traces["w"].shape == (got.config.samples_per_chain, 2, 99)
    rtol, atol = (RTOL, ATOL) if proposal == "reference" else (5e-4, 5e-5)
    _assert_runs_match(got, ref, rtol, atol, state_floats, ll_terms=0.0)
    acc = got.accept_ratio_per_chain
    assert acc.min() < 100.0 and acc.max() > 0.0


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


def iris_rw_preset_reference(seed: int = 0) -> dict:
    """ptnn's fused sampler on the iris RW preset that ``chip_smoke.py``
    runs on the card (``classification_preset((4, 12, 3), 50_000)``,
    fused), on the CPU, beside the port's plain versions on the CPU with
    the same config and seed: the statistics its bands are set around."""
    prob = load_classification("iris")
    cfg = ptnn.classification_preset((4, 12, 3), num_samples=50_000)
    kw = {**cfg.__dict__, "fused_step": True, "record_w": True}
    out = {}
    for name, res in (
            ("ptnn", jfused.sample_fused(ptnn.PTConfig(**kw).validate(),
                                         prob.train, prob.test, seed=seed)),
            ("port", ptnn_torch.sample(ptnn_torch.PTConfig(**kw).validate(),
                                       prob.train, prob.test, seed=seed,
                                       device="cpu"))):
        s = cfg.samples_per_chain
        out[name] = dict(
            cold_test_acc=float(np.mean(res.traces["acc_test"][s // 2:, 0])),
            mean_accept=float(np.mean(res.accept_ratio_per_chain)),
            swap=float(res.swap_percent))
    return out


def iris_flagship_reference(seed: int = 1) -> dict:
    """ptnn's fused sampler on iris chees16_fused_16x4 (bench.py's
    ``_cls_variants``) on the CPU: the served cold accuracy with the cold
    draws thinned along the draw axis before the 16 replicas are pooled (as
    ``chip_smoke.py`` computes it), bench.py's own (whose stride over the
    pooled rows keeps replica 0 alone), the per-draw cold accuracy, accept,
    swap and round trips per ladder per 1k steps."""
    import bench
    from ptnn import predict as jpredict
    from ptnn.ops import roundtrip as jroundtrip

    prob = load_classification("iris")
    cfg = bench._cls_variants((4, 12, 3), 8000)["chees16_fused_16x4"]
    res = jfused.sample_fused(cfg, prob.train, prob.test, seed=seed)
    b = cfg.samples_per_chain // 2
    cold = np.asarray(res.traces["w"][b:])
    y = prob.test[:, 4].astype(np.int64)

    def served(pool):
        pred = jpredict.posterior_predict(cfg, pool, prob.test[:, :4])
        return float(np.mean(pred["label"] == y)) * 100.0

    r = cold.shape[1]
    pool = cold.reshape(-1, cold.shape[-1])
    rt = jroundtrip.roundtrip_stats(res.traces["replica"],
                                    n_ladders=cfg.n_ladders)
    return dict(
        served_draw_thinned=served(
            cold[::max(1, cold.shape[0] // (2000 // r))].reshape(
                -1, cold.shape[-1])),
        served_bench_stride=served(pool[::max(1, pool.shape[0] // 2000)]),
        served_all_draws=served(pool),
        per_draw=float(np.mean(res.traces["acc_test"][
            b:, ::cfg.rungs_per_ladder])),
        mean_accept=float(np.mean(res.accept_ratio_per_chain)),
        swap=float(res.swap_percent),
        trips_per_ladder=rt.rate_per_kstep / cfg.n_ladders,
    )


if __name__ == "__main__":
    # python tests/test_torch_fused_driver.py rw|flagship [seed ...]: the
    # iris reference runs on the CPU
    import sys

    what = sys.argv[1] if len(sys.argv) > 1 else "rw"
    fn = iris_flagship_reference if what == "flagship" else \
        iris_rw_preset_reference
    for seed in [int(a) for a in sys.argv[2:]] or [0]:
        print(what, seed, fn(seed), flush=True)
