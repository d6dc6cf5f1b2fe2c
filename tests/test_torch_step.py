"""The port's per-step sampler against ptnn's (``make_step_fn`` with the
reference proposal, ``ptnn.sample(fused_step=False)``).

One step: the port's ``StepFn.step`` and ptnn's scanned ``step`` take the
same state (ptnn's, through ``convert.chain_state_from_numpy``) and the same
draws (ptnn's own: ``split(fold_in(k_run, i), 6)``, fed to the port through
the per-step noise contract). Langevin with the "reference" and the
"ldpt_legacy" q-ratio, and Langevin off; regression (Sunspot) and
classification (iris). Accept, Langevin and swap counters match exactly,
floats within rtol 2e-4, atol 2e-5 (ll on the size of its cancelling terms;
the drift epochs inside run in another summation order). The q-ratio
``diff_prop`` is held to one computed from ptnn's own drift and formulas.

Whole runs, 40 steps: Sunspot LG (``lg_pallas`` at 8 chains, swap every 10)
and iris legacy LG (``classification_preset(legacy_lg=True)`` at 8 chains,
swap every 10 instead of the preset's 0 at this budget), both from ptnn's
initial state with ptnn's noise; accept counts, Langevin counts, swap counts
and replica ids exact, traces within the same tolerances.

``python tests/test_torch_step.py lg|iono [seed ...]`` runs ptnn's per-step
sampler on the CPU at the full configurations ``chip_smoke.py`` runs on the
card (``lg_pallas`` 64 x 5000; Ionosphere legacy LG 10 x 5000): the source
of its bands.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import kernel as jkernel
from ptnn import sampler as jsampler
from ptnn.data import load_classification, load_regression
from ptnn.ops import drift as jdrift
from ptnn_torch import convert, kernel
from ptnn_torch import fused as tfused
from ptnn_torch.ops import drift, fnn_eval
from ptnn_torch.sampler import make_dataset

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


def ptnn_noise_fn(k_run):
    """The per-step noise contract filled with ptnn's draws: step i's keys
    are ``split(fold_in(k_run, i), 6)`` (ptnn/kernel.py:1262,
    ptnn/sampler.py:103-108)."""

    def one(key, c, w):
        kp, kl, ke, ku, ks, _ksu = jax.random.split(key, 6)
        return dict(w=jax.random.normal(kp, (c, w), jnp.float32),
                    l=jax.random.uniform(kl, (c,)),
                    eta=jax.random.normal(ke, (c,)),
                    u=jax.random.uniform(ku, (c,)),
                    u_swap=jax.random.uniform(ks, (c - 1,), jnp.float32))

    def noise_fn(start, length, c, w):
        keys = jsampler._step_keys(k_run, jnp.asarray(start), length)
        out = jax.vmap(lambda k: one(k, c, w))(keys)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    return noise_fn


def _sunspot_lg(**kw):
    """bench.py's lg_pallas at 8 chains: Sunspot (4, 10, 1), maxtemp 5,
    tempered_times_T payloads, Langevin 0.5 at lr 0.01, the reference
    q-ratio, drift_mode "pallas"."""
    base = dict(task="regression", topology=(4, 10, 1), num_samples=8 * 40,
                num_chains=8, maxtemp=5.0, swap_interval=10, swap_offset=0,
                swap_payload="tempered_times_T", use_langevin_gradients=True,
                drift_mode="pallas", record_w=True, track_replicas=True)
    base.update(kw)
    return base


def _iris_legacy(**kw):
    """classification_preset((4, 12, 3), legacy_lg=True) at 8 x 40, swaps
    every 10 (the preset's int(0.02 * 320 / 8) is 0)."""
    cfg = ptnn.classification_preset((4, 12, 3), num_samples=8 * 40,
                                     num_chains=8, legacy_lg=True)
    base = dict(cfg.__dict__, swap_interval=10, record_w=True,
                track_replicas=True)
    base.update(kw)
    return base


def _configs(kw):
    return (ptnn.PTConfig(**kw).validate(),
            ptnn_torch.PTConfig(**kw).validate())


def _both_states(jcfg, tcfg, prob, seed):
    data = jsampler.make_dataset(jcfg, prob.train, prob.test)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    st0 = jkernel.init_state(k_init, jcfg, data)
    np_state = {k: (None if v is None else np.asarray(v))
                for k, v in jax.device_get(st0)._asdict().items()}
    return data, st0, convert.chain_state_from_numpy(np_state), k_run


STEP_CASES = {
    "lg_reference": (_sunspot_lg, {}, "Sunspot"),
    "lg_legacy": (_sunspot_lg, dict(qratio="ldpt_legacy"), "Sunspot"),
    "rw": (_sunspot_lg, dict(use_langevin_gradients=False, record_eta=True),
           "Sunspot"),
    "rw_adapt": (_sunspot_lg, dict(use_langevin_gradients=False,
                                   adapt_step_size=True), "Sunspot"),
    "cls_legacy": (_iris_legacy, {}, "iris"),
    "cls_reference": (_iris_legacy, dict(qratio="reference",
                                         swap_payload="tempered"), "iris"),
    "cls_rw": (_iris_legacy, dict(use_langevin_gradients=False,
                                  qratio="reference"), "iris"),
}


def _load(name):
    if name == "Sunspot":
        return load_regression(name)
    return load_classification(name)


def _ptnn_diff_prop(jcfg, data, w, noise, temps, i):
    """The q-ratio of ptnn/kernel.py:997-1037 from ptnn's own drift."""
    epoch = jax.vmap(lambda wi: jdrift.sgd_epoch_sequential(
        wi, data.x_train, data.t_train, jcfg.topology, jcfg.learn_rate))
    step_w = jcfg.step_w
    nw = jnp.asarray(noise["w"].numpy()) * step_w
    use_l = jnp.asarray(noise["l"].numpy()) < jcfg.langevin_prob
    w_gd = epoch(w)
    w_prop = jnp.where(use_l[:, None], w_gd + nw, w + nw)
    w_prop_gd = epoch(w_prop)
    at = jnp.where(i < jcfg.temper_switch_step, temps, 1.0)
    ss_rev = jnp.sum(jnp.square(w - w_prop_gd), axis=-1)
    ss_fwd = jnp.sum(jnp.square(w_prop - w_gd), axis=-1)
    if jcfg.qratio == "reference":
        sq = step_w * step_w
        ratio = (-0.5 * ss_rev / sq - -0.5 * ss_fwd / sq) / at
    else:
        log_norm = -0.5 * w.shape[1] * jnp.log(2.0 * jnp.pi * step_w)
        arg = (jnp.exp(jnp.minimum(log_norm - 0.5 * ss_rev / step_w, 80.0))
               - (log_norm - 0.5 * ss_fwd / step_w))
        ratio = jnp.where(arg > 0.0, jnp.log(jnp.maximum(arg, 1e-30)),
                          -jnp.inf) / at
    return np.asarray(jnp.where(use_l, ratio, 0.0)), np.asarray(w_prop)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_one_step_matches_ptnn(case):
    make, extra, name = STEP_CASES[case]
    prob = _load(name)
    jcfg, tcfg = _configs(make(**extra))
    data, st0, tst, k_run = _both_states(jcfg, tcfg, prob, seed=5)
    temps_np = jsampler.build_temperatures(jcfg)
    jtemps = jnp.asarray(temps_np, jnp.float32)
    jstep = jax.jit(jkernel.make_step_fn(jcfg, data, jtemps))
    tdata = make_dataset(tcfg, prob.train, prob.test, "cpu")
    fn = kernel.make_step_fn(tcfg, tdata, torch.from_numpy(
        np.asarray(temps_np, np.float32)))
    noise_fn = ptnn_noise_fn(k_run)
    # a step before the swap event, then the step that ends in it
    i0 = next(i for i in range(1, 40) if kernel.swap_due(tcfg, i)) - 1
    launches = (drift.launches, fnn_eval.launches)
    jst = st0
    for i in (i0, i0 + 1):
        noise = {k: v[0] for k, v in noise_fn(i, 1, 8, fn.spec.w_size).items()}
        if tcfg.use_langevin_gradients:
            want, w_prop = _ptnn_diff_prop(jcfg, data, jst.w, noise, jtemps, i)
            at = fn.temps if i < tcfg.temper_switch_step else fn.ones
            got_w, got, n_l = fn._propose(tst, noise, at)
            np.testing.assert_allclose(got_w.numpy(), w_prop, rtol=RTOL,
                                       atol=ATOL)
            # the ratio: differences of two sums of squares of size ~1/T
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-2)
            assert np.array_equal(n_l.numpy() - tst.n_langevin.numpy(),
                                  noise["l"].numpy() < tcfg.langevin_prob)
        key = jax.random.fold_in(k_run, i)
        jst, jtr = jstep(jst, (jnp.asarray(i, jnp.int32), key))
        tst, ttr = fn.step(tst, i, noise)
        assert set(ttr) == set(jtr), (set(ttr), set(jtr))
        _assert_states_match(tst, jst, tcfg)
        for k in ("accept_count", "replica"):
            np.testing.assert_array_equal(ttr[k].numpy(), np.asarray(jtr[k]))
        for k in ("rmse_train", "rmse_test", "acc_train", "acc_test", "w",
                  "eta"):
            if k in jtr:
                np.testing.assert_allclose(ttr[k].numpy(), np.asarray(jtr[k]),
                                           rtol=RTOL, atol=ATOL, err_msg=k)
        _assert_ll_close(ttr["ll"].numpy(), np.asarray(jtr["ll"]),
                         tcfg, prob, fn.temps.numpy())
    assert int(tst.n_swap_proposed) > 0
    assert (drift.launches, fnn_eval.launches) == launches


def _assert_ll_close(got, want, cfg, prob, temps):
    """ll is the difference of two terms of size >= n_tr / T (regression);
    the multinomial ll is held on its own size."""
    terms = prob.train.shape[0] / temps if cfg.task == "regression" else 0.0
    diff = np.abs(got.astype(np.float64) - want)
    assert np.all(diff <= ATOL + RTOL * (np.abs(want) + terms)), diff.max()


def _assert_states_match(tst, jst, cfg):
    fin = convert.chain_state_to_numpy(tst)
    j = jst._asdict()
    for k in ("n_accept", "n_langevin", "n_swap_accepted", "n_swap_proposed",
              "pair_prop_count", "replica_id"):
        if fin[k] is not None:
            np.testing.assert_array_equal(fin[k], np.asarray(j[k]), err_msg=k)
    for k in ("w", "w_last", "eta", "prior", "rmse_train", "rmse_test",
              "acc_train", "acc_test", "pair_accept_sum", "log_step_w"):
        if fin[k] is not None:
            np.testing.assert_allclose(fin[k], np.asarray(j[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def _run_both(kw, prob, seed):
    jcfg, tcfg = _configs(kw)
    data, st0, tst, k_run = _both_states(jcfg, tcfg, prob, seed)
    ref = ptnn.sample(jcfg, prob.train, prob.test, seed=seed, init_state=st0)
    launches = (drift.launches, fnn_eval.launches)
    got = ptnn_torch.sample(tcfg, prob.train, prob.test, seed=seed,
                            device="cpu", init_state=tst,
                            noise_fn=ptnn_noise_fn(k_run))
    assert (drift.launches, fnn_eval.launches) == launches
    return got, ref


def _assert_runs_match(got, ref):
    cfg = got.config
    assert set(got.traces) == set(ref.traces)
    for k, v in ref.traces.items():
        assert got.traces[k].shape == v.shape, k
    exact = ["accept_count", "replica"]
    if cfg.task == "classification":
        exact += ["acc_train", "acc_test"]
    for k in exact:
        np.testing.assert_array_equal(got.traces[k], ref.traces[k],
                                      err_msg=k)
    np.testing.assert_array_equal(got.accept_ratio_per_chain,
                                  ref.accept_ratio_per_chain)
    np.testing.assert_array_equal(got.langevin_ratio_per_chain,
                                  ref.langevin_ratio_per_chain)
    assert got.swap_percent == ref.swap_percent
    assert 0.0 < got.swap_percent < 100.0
    for k in ("rmse_train", "rmse_test", "acc_train", "acc_test", "w"):
        np.testing.assert_allclose(got.traces[k], ref.traces[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    prob = _load("Sunspot" if cfg.task == "regression" else "iris")
    _assert_ll_close(got.traces["ll"], ref.traces["ll"], cfg, prob,
                     got.temperatures[None, :])
    _assert_states_match(got.final_state, ref.final_state, cfg)


def test_sunspot_lg_run_matches_ptnn():
    got, ref = _run_both(_sunspot_lg(), load_regression("Sunspot"), seed=2)
    cfg = got.config
    assert 0 < cfg.temper_switch_step < cfg.n_steps
    lr = got.langevin_ratio_per_chain
    assert 0.0 < lr.min() and lr.max() < 100.0
    _assert_runs_match(got, ref)


def test_iris_legacy_lg_run_matches_ptnn():
    got, ref = _run_both(_iris_legacy(), load_classification("iris"), seed=3)
    _assert_runs_match(got, ref)
    acc = got.accept_ratio_per_chain
    assert acc.min() < 100.0


def test_fused_langevin_config_is_refused_and_others_fall_back():
    """fused_step with Langevin gradients fails validation, as in ptnn; a
    fused config the fused path cannot run (three regression outputs)
    warns and runs per-step."""
    kw = _sunspot_lg(fused_step=True)
    with pytest.raises(ValueError, match="fused_step"):
        ptnn_torch.PTConfig(**kw).validate()
    with pytest.raises(ValueError, match="fused_step"):
        ptnn.PTConfig(**kw).validate()
    prob = load_classification("iris")
    cfg = ptnn_torch.PTConfig(**_iris_legacy(
        use_langevin_gradients=False, qratio="reference", fused_step=True,
        num_samples=8 * 6)).validate()
    # a regression net with three outputs: the fused gate refuses it
    bad = dataclasses.replace(cfg, task="regression", topology=(4, 5, 3))
    assert "one output" in tfused.runtime_reason(bad, 10, 10)
    with pytest.raises(NotImplementedError, match="more than one output"):
        with pytest.warns(UserWarning, match="falling back"):
            ptnn_torch.sample(bad, prob.train, prob.test, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = ptnn_torch.sample(cfg, prob.train, prob.test, device="cpu")
    assert res.traces["acc_test"].shape == (6, 8)


@pytest.mark.parametrize("feature", [
    dict(proposal="sgld", use_langevin_gradients=False, sg_batch=16,
         swap_payload="untempered", swap_rule="metropolis",
         stale_likelihood_after_swap=False, pt_phase_frac=1.0),
    dict(record_fx=True),
    dict(record_ll_state=True), dict(record_thin=2, track_replicas=False),
    dict(adapt_step_size=True), dict(eval_dtype="bfloat16"),
])
def test_per_step_refuses_what_is_not_ported(feature):
    prob = load_regression("Sunspot")
    cfg = ptnn_torch.PTConfig(**_sunspot_lg(**feature)).validate()
    name = next(iter(feature))
    with pytest.raises(NotImplementedError, match="not yet ported") as e:
        ptnn_torch.sample(cfg, prob.train, prob.test, device="cpu")
    assert name.split("_")[0] in str(e.value)


def test_throughput_runner_per_step_reps_repeat():
    prob = load_regression("Sunspot")
    cfg = ptnn_torch.PTConfig(**_sunspot_lg(num_samples=8 * 12)).validate()
    rep = ptnn_torch.throughput_runner(cfg, prob.train, prob.test, seed=1,
                                       device="cpu")
    a, b = rep(), rep()
    assert a["steps"] == 11.0 and a["chains"] == 8.0
    assert a["trace_means"] == b["trace_means"]
    assert a["accept_pct"] == b["accept_pct"] and 0 < a["accept_pct"] < 100
    assert 0.0 < a["langevin_pct"] < 100.0


def test_default_noise_depends_on_chunk_start_only():
    """A step's default noise depends on its absolute index alone: the same
    steps drawn as another chunk, or across a page boundary, are the same
    numbers."""
    from ptnn_torch.sampler import page_steps, step_noise

    fn = step_noise(3, "cpu", kernel.step_noise_names(
        ptnn_torch.PTConfig(**_sunspot_lg()).validate()))
    a, b = fn(40, 5, 8, 61), fn(40, 5, 8, 61)
    assert set(a) == {"w", "u", "u_swap", "l", "eta"}
    assert a["w"].shape == (5, 8, 61) and a["u_swap"].shape == (5, 7)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(fn(0, 5, 8, 61)["u"], a["u"])
    p = page_steps(8, 61)
    wide = fn(37, p + 9, 8, 61)  # three pages
    for k in a:
        assert torch.equal(wide[k][3:8], a[k])
        assert torch.equal(wide[k][p - 37:p - 37 + 4], fn(p, 4, 8, 61)[k])
    # a page holds at most 64 MB of w-noise, whatever the chunking
    assert page_steps(256, 3658) * 256 * 3658 * 4 <= 64 * 2**20


def _digits_mlp():
    from ptnn_torch.data import load_digits

    kw = dict(ptnn_torch.classification_preset(
        (64, 16, 10), num_samples=8 * 40, num_chains=8, maxtemp=3.0,
        use_langevin_gradients=True, learn_rate=0.02).__dict__,
        swap_interval=10, record_w=True, track_replicas=True)
    prob = load_digits(0)
    return kw, prob.train[:96], prob.test[:48], ptnn_torch.mlp.spec(
        (64, 16, 12, 10))


@pytest.mark.parametrize("model", ["sunspot_lg", "digits_mlp"])
def test_default_noise_is_invariant_to_chunking(model):
    """8 chains x 40 steps with chunk_steps 7 and 40 give the same traces
    and counters (ptnn's tests/test_precond.py:80-83 holds its own sampler
    to this)."""
    if model == "sunspot_lg":
        prob = load_regression("Sunspot")
        kw, train, test, spec = _sunspot_lg(), prob.train, prob.test, None
    else:
        kw, train, test, spec = _digits_mlp()
    runs = [ptnn_torch.sample(
        ptnn_torch.PTConfig(**dict(kw, chunk_steps=chunk)).validate(), train,
        test, seed=4, device="cpu", model_spec=spec) for chunk in (7, 40)]
    a, b = runs
    assert set(a.traces) == set(b.traces)
    for k in a.traces:
        np.testing.assert_array_equal(a.traces[k], b.traces[k], err_msg=k)
    np.testing.assert_array_equal(a.accept_ratio_per_chain,
                                  b.accept_ratio_per_chain)
    np.testing.assert_array_equal(a.langevin_ratio_per_chain,
                                  b.langevin_ratio_per_chain)
    assert a.swap_percent == b.swap_percent
    assert 0 < a.accept_ratio_per_chain.mean() < 100


# ---------------------------------------------------------------------------
# ptnn's per-step sampler on the CPU at the configurations chip_smoke.py runs
# on the card: the reference for its bands.


def lg_pallas_reference(seed: int = 0) -> dict:
    """bench.py's ``_variants(64, 5000, full=True)["lg_pallas"]``."""
    import bench

    prob = load_regression("Sunspot")
    cfg = bench._variants(64, 5000, full=True)["lg_pallas"]
    res = ptnn.sample(cfg, prob.train, prob.test, seed=seed)
    s = cfg.samples_per_chain
    return dict(
        cold_rmse_second_half=float(np.mean(res.traces["rmse_test"][s // 2:,
                                                                    0])),
        cold_rmse_final=float(res.traces["rmse_test"][-1, 0]),
        cold_accept=float(res.accept_ratio_per_chain[0]),
        mean_accept=float(np.mean(res.accept_ratio_per_chain)),
        swap=float(res.swap_percent),
        langevin=float(np.mean(res.langevin_ratio_per_chain)),
        seconds=res.elapsed_s)


def ionosphere_reference(seed: int = 0) -> dict:
    """The reference's PT_EvalSwapLG Ionosphere row as scripts/cls_bands.py
    builds it (legacy LG, 10 x 5000, record_w off), drift_mode "pallas"."""
    prob = load_classification("Ionosphere")
    cfg = dataclasses.replace(
        ptnn.classification_preset(prob.topology, num_samples=50_000,
                                   legacy_lg=True),
        record_w=False, drift_mode="pallas").validate()
    res = ptnn.sample(cfg, prob.train, prob.test, seed=seed)
    cold = int(cfg.samples_per_chain * cfg.burn_in) - 1
    return dict(
        test_mean=float(np.mean(res.traces["acc_test"][cold:, :])),
        cold_accept=float(res.accept_ratio_per_chain[0]),
        mean_accept=float(np.mean(res.accept_ratio_per_chain)),
        swap=float(res.swap_percent),
        langevin=float(np.mean(res.langevin_ratio_per_chain)),
        seconds=res.elapsed_s)


if __name__ == "__main__":
    import sys

    what = sys.argv[1] if len(sys.argv) > 1 else "lg"
    fn = ionosphere_reference if what == "iono" else lg_pallas_reference
    for seed in [int(a) for a in sys.argv[2:]] or [0]:
        print(what, seed, fn(seed), flush=True)
