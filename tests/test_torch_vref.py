"""The port's variational reference (``ptnn_torch.ops.vref``, the VR wiring
of ``kernel.StepFn`` and ``kernel.PrecondStepFn``) against ptnn's.

Functions: every function of ``ops.vref`` on the same NumPy inputs, rtol
1e-5 (``fit_gaussian``, ``schedule``, ``frozen_count``, ``log_z0`` and
``log_z0_chol`` are host NumPy in both).

One step: ptnn's jitted step runs from its own initial state (with a static
reference injected by ``set_static_reference`` where the config asks for
one) and at the steps that cover the schedule (before the correction
activates, Welford accumulation, swap events with the hot rung's
regeneration, the freeze at burn-in) the port's step takes ptnn's state and
ptnn's draws (``vr_noise_fn``: the swap key split ``ks, kr = split(ks)``,
the regeneration's ``kq, ka = split(kr)``). RW, LG, precond_mala and HMC;
the diagonal family by Welford and static, the full-covariance family
static; regression (z = (w, eta)) and classification. Counters (the
regeneration's too) exactly, floats within rtol 2e-4 outside the 1e-5
decision margin, as ``tests/test_torch_precond_per_step.py`` holds them.

Whole runs, 40 steps, 8 chains on the T = inf ladder: Sunspot, Lazer and
iris, Welford and static, held as ``test_torch_precond_per_step`` holds its
runs (exact up to the first decision within 1e-5 of flipping), with the
regeneration counts equal and ``ll_cur`` / ``vr_corr_cur`` at the run
tolerance; the port's ptnn properties (the beta = 0 regeneration accepts
every proposal; before activation a Welford run is the plain run bit for
bit).
"""

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
from ptnn.ops import vref as jvref
from ptnn_torch import convert, kernel, sampler
from ptnn_torch.ops import drift, fnn_eval, vref
from test_torch_precond_per_step import (MARGIN, assert_runs_match,
                                         compare_step, held)

torch.set_num_threads(1)

F_RTOL = 1e-5


def vr_noise_fn(k_run, cfg):
    """The per-step noise contract filled with ptnn's draws for ``cfg``:
    the reference proposal's ``split(key, 6)`` (ptnn/kernel.py:1262) or the
    preconditioned family's ``split(key, 5)`` (:1718, HMC ``kp, kj =
    split(kp)``); under the regenerating reference ``ks, kr = split(ks)``
    (:1053) and ``kq, ka = split(kr)`` (:921)."""
    precond = cfg.proposal in kernel.PRECOND
    regen = cfg.variational_reference and cfg.vr_regen
    reg = cfg.task == "regression"

    def one(key, c, w):
        out = {}
        if precond:
            kp, ke, ku, kue, ks = jax.random.split(key, 5)
            if cfg.proposal == "hmc":
                kp, kj = jax.random.split(kp)
                out["jit"] = jax.random.uniform(kj, (c,))
            out["u_eta"] = jax.random.uniform(kue, (c,))
        else:
            kp, kl, ke, ku, ks, _ksu = jax.random.split(key, 6)
            out["l"] = jax.random.uniform(kl, (c,))
        out.update(w=jax.random.normal(kp, (c, w), jnp.float32),
                   eta=jax.random.normal(ke, (c,)),
                   u=jax.random.uniform(ku, (c,)))
        if regen:
            ks, kr = jax.random.split(ks)
            kq, ka = jax.random.split(kr)
            out["vr_z"] = jax.random.normal(kq, (w + int(reg),), jnp.float32)
            out["u_regen"] = jax.random.uniform(ka, ())
        out["u_swap"] = jax.random.uniform(ks, (c - 1,), jnp.float32)
        return out

    def noise_fn(start, length, c, w):
        keys = jsampler._step_keys(k_run, jnp.asarray(start), length)
        out = jax.vmap(lambda k: one(k, c, w))(keys)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    return noise_fn


# ---------------------------------------------------------------------------
# ops.vref against ptnn.ops.vref


def _rng_inputs(seed=0, n=5, z=7):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, z)).astype(np.float32)
    mu = rng.standard_normal(z).astype(np.float32)
    var = (0.1 + rng.random(z)).astype(np.float32)
    draws = rng.standard_normal((64, z)) @ rng.standard_normal((z, z)) * 0.3
    _mu, _var, chol = jvref.fit_gaussian(draws)
    return w, mu, var, chol


def _close(got, want, rtol=F_RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=1e-6)


T = torch.from_numpy

FUNCTIONS = {
    "welford_variance": lambda w, mu, var, chol: (
        vref.welford_variance(T(var * 30), 12.0, 1.5),
        jvref.welford_variance(var * 30, 12.0, 1.5)),
    "log_q_quad": lambda w, mu, var, chol: (
        vref.log_q_quad(T(w), T(mu), T(var)), jvref.log_q_quad(w, mu, var)),
    "correction": lambda w, mu, var, chol: (
        vref.correction(T(w), T(mu), T(var), 25.0),
        jvref.correction(w, mu, var, 25.0)),
    "grad_correction": lambda w, mu, var, chol: (
        vref.grad_correction(T(w), T(mu), T(var), 25.0),
        jvref.grad_correction(w, mu, var, 25.0)),
    "welford_update": lambda w, mu, var, chol: (
        torch.stack(vref.welford_update(T(mu), T(var), T(w[0]), 5.0, True)),
        np.stack(jvref.welford_update(mu, var, w[0], jnp.float32(5.0),
                                      jnp.asarray(True)))),
    "welford_update_frozen": lambda w, mu, var, chol: (
        torch.stack(vref.welford_update(T(mu), T(var), T(w[0]), 5.0, False)),
        np.stack(jvref.welford_update(mu, var, w[0], jnp.float32(5.0),
                                      jnp.asarray(False)))),
    "log_q_chol": lambda w, mu, var, chol: (
        vref.log_q_chol(T(w), T(mu), T(chol)),
        jvref.log_q_chol(w, mu, chol)),
    "grad_logq_chol": lambda w, mu, var, chol: (
        vref.grad_logq_chol(T(w), T(mu), T(chol)),
        jvref.grad_logq_chol(w, mu, chol)),
    "sample_q": lambda w, mu, var, chol: (
        vref.sample_q(T(mu), T(var), z=T(np.array(jax.random.normal(
            jax.random.PRNGKey(3), mu.shape)))),
        jvref.sample_q(jax.random.PRNGKey(3), mu, var)),
    "sample_q_chol": lambda w, mu, var, chol: (
        vref.sample_q_chol(T(mu), T(chol), z=T(np.array(jax.random.normal(
            jax.random.PRNGKey(4), mu.shape)))),
        jvref.sample_q_chol(jax.random.PRNGKey(4), mu, chol)),
    "schedule": lambda w, mu, var, chol: (
        np.asarray(vref.schedule(5000, 0.25, 0.5, 0.1)),
        np.asarray(jvref.schedule(5000, 0.25, 0.5, 0.1))),
    "frozen_count": lambda w, mu, var, chol: (
        np.asarray([vref.frozen_count(4000, 0.3, 0.5, 0.0)]),
        np.asarray([jvref.frozen_count(4000, 0.3, 0.5, 0.0)])),
    "log_z0": lambda w, mu, var, chol: (
        np.asarray([vref.log_z0(var, 62, 25.0)]),
        np.asarray([jvref.log_z0(var, 62, 25.0)])),
    "log_z0_chol": lambda w, mu, var, chol: (
        np.asarray([vref.log_z0_chol(chol, 62, 25.0)]),
        np.asarray([jvref.log_z0_chol(chol, 62, 25.0)])),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_function_matches_ptnn(name):
    got, want = FUNCTIONS[name](*_rng_inputs())
    _close(got, want)


@pytest.mark.parametrize("family", ["diag", "full_cov"])
def test_fit_gaussian_matches_ptnn(family):
    rng = np.random.default_rng(1)
    draws = rng.standard_normal((50, 6)) @ rng.standard_normal((6, 6))
    for got, want in zip(vref.fit_gaussian(draws, family, 0.2, 1.3),
                         jvref.fit_gaussian(draws, family, 0.2, 1.3)):
        if want is None:
            assert got is None
        else:
            assert got.dtype == want.dtype == np.float32
            _close(got, want)
    assert vref.VAR_FLOOR == jvref.VAR_FLOOR
    with pytest.raises(ValueError, match="family"):
        vref.fit_gaussian(draws, "low_rank")
    with pytest.raises(ValueError, match="draws"):
        vref.fit_gaussian(draws[:1])


# ---------------------------------------------------------------------------
# the configurations


def sunspot_vr(**kw):
    """8 chains x 40 on the T = inf ladder of the regression command line's
    --vref (metropolis swaps of untempered energies, even-odd, the canonical
    schedule), swaps every 5 steps; Welford: the correction from step 10,
    accumulation from 5, the freeze at 19."""
    base = dict(task="regression", topology=(4, 10, 1), num_samples=8 * 40,
                num_chains=8, maxtemp=5.0, swap_interval=5, swap_offset=0,
                swap_style="even_odd", swap_payload="untempered",
                swap_rule="metropolis", pt_phase_frac=2.0,
                variational_reference=True, vr_hot_infinite=True,
                record_w=True, record_eta=True, record_ll_state=True,
                track_replicas=True, chunk_steps=20)
    base.update(kw)
    return base


def iris_vr(**kw):
    """The classification command line's --vref on iris (the canonical
    preset) at 8 x 40, swaps every 5."""
    cfg = ptnn.classification_preset((4, 12, 3), num_samples=8 * 40,
                                     num_chains=8, canonical=True)
    base = dict(cfg.__dict__, swap_interval=5, swap_style="even_odd",
                swap_payload="untempered", swap_rule="metropolis",
                variational_reference=True, vr_hot_infinite=True,
                record_w=True, record_ll_state=True, track_replicas=True,
                chunk_steps=20)
    base.update(kw)
    return base


STATIC = dict(vr_mode="static")
FULL = dict(vr_mode="static", vr_family="full_cov")
MALA = dict(proposal="precond_mala", warmstart_frac=0.1, adapt_rate=0.1,
            precond_start_frac=0.3, step_w=0.01)
HMC = dict(proposal="hmc", hmc_leapfrog=3, step_w=0.01, warmstart_frac=0.1,
           adapt_rate=0.1, precond_start_frac=0.3)
LG = dict(use_langevin_gradients=True, drift_mode="pallas")
PROBLEMS = {"Sunspot": lambda: load_regression("Sunspot"),
            "Lazer": lambda: load_regression("Lazer"),
            "iris": lambda: load_classification("iris")}


def _configs(kw):
    return (ptnn.PTConfig(**kw).validate(),
            ptnn_torch.PTConfig(**kw).validate())


def _np_state(jst):
    return {k: (None if v is None else np.asarray(v))
            for k, v in jax.device_get(jst)._asdict().items()}


def static_reference(cfg, w_size, seed=11):
    """A fitted reference for a static run: ``fit_gaussian`` of draws around
    a random point with a spread a chain would have."""
    zdim = w_size + int(cfg.task == "regression")
    rng = np.random.default_rng(seed)
    centre = rng.standard_normal(zdim)
    draws = centre + 0.3 * rng.standard_normal((200, zdim)) @ (
        np.eye(zdim) + 0.1 * rng.standard_normal((zdim, zdim)))
    return jvref.fit_gaussian(draws, cfg.vr_family)


def ptnn_start(jcfg, train, test, seed):
    """ptnn's initial state for ``seed`` (with the static reference
    injected) and its run key."""
    data = jsampler.make_dataset(jcfg, train, test)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    jst = jkernel.init_state(k_init, jcfg, data)
    if jcfg.variational_reference and jcfg.vr_mode == "static":
        jst = jkernel.set_static_reference(
            jst, jcfg, *static_reference(jcfg, jst.w.shape[1]))
    return data, jst, k_run


VR_EXACT = ("n_regen_accepted", "n_regen_proposed", "n_langevin")
VR_FLOATS = ("vr_mean", "vr_m2", "vr_chol")


def compare_vr(new_t, ttr, new_j, jtr, ok, swapped):
    """The VR fields and traces beyond ``compare_step``'s."""
    fin, j = convert.chain_state_to_numpy(new_t), _np_state(new_j)
    for k in VR_EXACT:
        if fin[k] is not None:
            np.testing.assert_array_equal(fin[k], j[k], err_msg=k)
    for k in VR_FLOATS:
        if fin[k] is not None:
            assert held(fin[k], j[k], np.abs(j[k]).max()).all(), k
    if "vr_corr_cur" in jtr:
        # a log-q sum over Z coordinates, held on its own size
        got, want = ttr["vr_corr_cur"].numpy(), np.asarray(jtr["vr_corr_cur"])
        rows = slice(None) if swapped else ok
        assert held(got[rows], want[rows], np.abs(want[rows])).all()


STEP_CASES = {
    "rw_welford": (sunspot_vr, {}, "Sunspot"),
    "lg_welford": (sunspot_vr, LG, "Sunspot"),
    "rw_static_full_cov": (sunspot_vr, FULL, "Sunspot"),
    "mala_welford": (sunspot_vr, MALA, "Sunspot"),
    "mala_static_full_cov": (sunspot_vr, dict(MALA, **FULL), "Sunspot"),
    "hmc_static_diag": (sunspot_vr, dict(HMC, **STATIC), "Sunspot"),
    "hmc_static_full_cov": (sunspot_vr, dict(HMC, **FULL), "Sunspot"),
    "iris_rw_welford": (iris_vr, {}, "iris"),
    "iris_mala_static_full_cov": (iris_vr, dict(MALA, **FULL), "iris"),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_one_vr_step_matches_ptnn(case):
    make, extra, name = STEP_CASES[case]
    jcfg, tcfg = _configs(make(**extra))
    prob = PROBLEMS[name]()
    data, jst, k_run = ptnn_start(jcfg, prob.train, prob.test, seed=5)
    temps_np = np.asarray(jsampler.build_temperatures(jcfg), np.float32)
    assert np.isinf(temps_np[-1])
    jstep = jax.jit(jkernel.make_step_fn(jcfg, data, jnp.asarray(temps_np)))
    tdata = sampler.make_dataset(tcfg, prob.train, prob.test, "cpu")
    fn = kernel.make_step_fn(tcfg, tdata, torch.from_numpy(temps_np))
    fn.diagnostics = True
    noise_fn = vr_noise_fn(k_run, tcfg)
    n_tr = prob.train.shape[0]
    terms = np.full(tcfg.num_chains, float(n_tr)) \
        if tcfg.task == "regression" else np.zeros(tcfg.num_chains)
    # before the activation, the first accumulating step, swap events with
    # regeneration around the activation, the freeze and after it
    steps = [3, 5, 9, 10, 14, 18, 19, 24]
    launches = (drift.launches, fnn_eval.launches)
    left_out = 0
    for i in range(steps[-1] + 1):
        new_j, jtr = jstep(jst, (jnp.asarray(i, jnp.int32),
                                 jax.random.fold_in(k_run, i)))
        if i in steps:
            tst = convert.chain_state_from_numpy(_np_state(jst))
            noise = {k: v[0] for k, v in noise_fn(
                i, 1, tcfg.num_chains, fn.spec.w_size).items()}
            new_t, ttr = fn.step(tst, i, noise)
            ok = ttr.pop("margin").numpy() >= MARGIN
            swapped = kernel.swap_due(tcfg, i)
            if swapped and not ok.all():
                left_out += tcfg.num_chains
                jst = new_j
                continue
            left_out += int((~ok).sum())
            compare_step(new_t, ttr, new_j, jtr, ok, terms, swapped)
            compare_vr(new_t, ttr, new_j, jtr, ok, swapped)
        jst = new_j
    assert (drift.launches, fnn_eval.launches) == launches
    assert int(new_t.n_regen_proposed) > 0
    assert left_out <= len(steps), left_out


def run_both(kw, prob, seed):
    """ptnn.sample and the port's per-step run from ptnn's initial state
    with ptnn's draws; the port's step reports its margins."""
    jcfg, tcfg = _configs(kw)
    _data, st0, k_run = ptnn_start(jcfg, prob.train, prob.test, seed)
    ref = ptnn.sample(jcfg, prob.train, prob.test, seed=seed, init_state=st0)
    eng = sampler._per_step(tcfg, prob.train, prob.test, "cpu")
    eng.step_fn.diagnostics = True
    chunks = []
    state = eng.run(convert.chain_state_from_numpy(_np_state(st0)),
                    vr_noise_fn(k_run, tcfg),
                    lambda tr: chunks.append(
                        {k: v.numpy() for k, v in tr.items()}))
    traces = {k: np.concatenate([ch[k] for ch in chunks]) for k in chunks[0]}
    margin = traces.pop("margin")
    got = sampler.make_result(tcfg, traces, state, eng.temps_host, 1.0)
    return got, ref, margin


RUN_CASES = {
    "sunspot_rw_welford": (sunspot_vr, {}, "Sunspot"),
    "sunspot_lg_welford": (sunspot_vr, LG, "Sunspot"),
    "sunspot_mala_static_full_cov": (sunspot_vr, dict(MALA, **FULL),
                                     "Sunspot"),
    "lazer_rw_static_diag": (sunspot_vr, STATIC, "Lazer"),
    "lazer_hmc_welford": (sunspot_vr, HMC, "Lazer"),
    "iris_rw_welford": (iris_vr, {}, "iris"),
    "iris_rw_static_full_cov": (iris_vr, FULL, "iris"),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_vr_run_matches_ptnn(case):
    make, extra, name = RUN_CASES[case]
    prob = PROBLEMS[name]()
    got, ref, margin = run_both(make(**extra), prob, seed=2)
    n = got.config.n_steps
    assert_runs_match(got, ref, margin, prob.train.shape[0])
    close = np.nonzero((margin < MARGIN).any(axis=1))[0]
    k0 = int(close[0]) if len(close) else n
    rows = slice(0, k0 + 1)
    if k0 == n:
        assert got.vr_regen_proposed == ref.vr_regen_proposed > 0
        assert got.vr_regen_accept_pct == ref.vr_regen_accept_pct
    # the hot rung's traces too (T = inf: every division meets inf)
    terms = prob.train.shape[0] if got.config.task == "regression" else 0.0
    assert held(got.traces["ll_cur"][rows], ref.traces["ll_cur"][rows],
                terms).all()
    want = ref.traces["vr_corr_cur"][rows]
    assert held(got.traces["vr_corr_cur"][rows], want, np.abs(want)).all()
    assert np.isfinite(got.traces["ll_cur"]).all()


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_beta0_regeneration_accepts_every_proposal(task):
    """ptnn's tests/test_vref.py:140: at beta = 0 the regeneration ratio
    cancels to 1, so every active proposal is accepted, on the port's own
    noise; the hot rung's traces stay finite."""
    if task == "regression":
        kw, prob = sunspot_vr(num_samples=8 * 60), load_regression("Sunspot")
    else:
        kw, prob = iris_vr(num_samples=8 * 60), load_classification("iris")
    cfg = ptnn_torch.PTConfig(**kw).validate()
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=1, device="cpu")
    assert res.vr_regen_proposed > 0
    assert res.vr_regen_accept_pct == 100.0
    assert np.isinf(res.temperatures[-1])
    for k in ("ll", "ll_cur", "vr_corr_cur"):
        assert np.isfinite(res.traces[k]).all(), k


def test_welford_run_is_the_plain_run_before_activation():
    """ptnn's tests/test_vref.py:114: before vr_start the corrected path is
    the plain path: the traces of a Welford run and of the same config
    without the reference agree bit for bit up to the activation step (the
    same noise, the regeneration's draws unused before the first active
    swap)."""
    prob = load_regression("Sunspot")
    kw = sunspot_vr(vr_hot_infinite=False, maxtemp=5.0)
    plain = dict(kw, variational_reference=False, record_ll_state=False)
    vr = ptnn_torch.PTConfig(**kw).validate()
    noise = sampler.step_noise(3, "cpu", kernel.step_noise_names(vr))
    a = ptnn_torch.sample(vr, prob.train, prob.test, seed=3, device="cpu",
                          noise_fn=noise)
    b = ptnn_torch.sample(ptnn_torch.PTConfig(**plain).validate(),
                          prob.train, prob.test, seed=3, device="cpu",
                          noise_fn=noise)
    start = vref.schedule(vr.samples_per_chain, vr.vr_start_frac, vr.burn_in,
                          vr.warmstart_frac)[0]
    # trace row i + 1 is step i: rows up to start hold steps before it
    for k in ("ll", "w", "eta", "accept_count", "replica"):
        np.testing.assert_array_equal(a.traces[k][:start + 1],
                                      b.traces[k][:start + 1], err_msg=k)
    assert not np.array_equal(a.traces["ll"], b.traces["ll"])


def test_set_static_reference_gates():
    """ptnn's tests/test_rounds.py:167: the shapes and the family are
    checked."""
    prob = load_regression("Sunspot")
    cfg = ptnn_torch.PTConfig(**sunspot_vr(**FULL)).validate()
    data = sampler.make_dataset(cfg, prob.train, prob.test, "cpu")
    st = kernel.init_state(cfg, data, generator=torch.Generator())
    assert st.vr_chol.shape == (62, 62) and st.vr_m2.shape == (62,)
    mu, var, chol = static_reference(cfg, 61)
    out = kernel.set_static_reference(st, cfg, mu, var, chol)
    assert torch.equal(out.vr_chol, torch.from_numpy(chol))
    with pytest.raises(ValueError, match="chol factor"):
        kernel.set_static_reference(st, cfg, mu, var)
    with pytest.raises(ValueError, match="z-dim"):
        kernel.set_static_reference(st, cfg, mu[:-1], var[:-1], chol)
    diag = ptnn_torch.PTConfig(**sunspot_vr(**STATIC)).validate()
    with pytest.raises(ValueError, match="'diag'"):
        kernel.set_static_reference(st, diag, mu, var, chol)
    welford = ptnn_torch.PTConfig(**sunspot_vr()).validate()
    with pytest.raises(ValueError, match="static"):
        kernel.set_static_reference(st, welford, mu, var)
