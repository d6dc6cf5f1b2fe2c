"""The port's per-step preconditioned family against ptnn's
(``make_step_fn`` with ``precond_rw``, ``precond_mala``, ``hmc`` with and
without ChEES, ``pcn``; ``ptnn.sample(fused_step=False)``).

One step: ptnn's jitted step runs a short trajectory from its own initial
state, and at the steps that cover the warm start, the preconditioner's
start, the swap events, the end of burn-in and the temper switch the port's
``PrecondStepFn.step`` takes ptnn's state before the step
(``convert.chain_state_from_numpy``) and ptnn's draws for it
(``split(fold_in(k_run, i), 5)``, HMC ``kp, kj = split(kp)``, fed through
the per-step noise contract). Integer counters, replica ids and the ChEES
trajectory lengths match exactly; floats within rtol 2e-4, atol 2e-5 (ll
on the size of its cancelling terms, as tests/test_torch_step.py holds it,
g_like on the size of the chain's largest entry);
decisions exactly, outside a 1e-5 margin: a chain whose w or eta decision
(or ChEES leapfrog count) lies within 1e-5 of flipping is left out of that
step's comparison, which the test reports and bounds.

Whole runs, 40 steps, 2 ladders of 4 rungs, from ptnn's initial state with
ptnn's draws: exact up to the first step where some decision lies within
the margin (the port's ``diagnostics`` margin), as
tests/test_torch_zoo_step.py holds the model zoo: counters, replica ids and
leapfrog counts exactly, the metrics within rtol 2e-4 (classification's
in 99 % of the entries: a drifted state may flip a near-tied argmax), the
ll of every
accepted proposal (and of every proposal of ``precond_rw`` and ``pcn``)
within rtol 2e-4 of its terms, the w trace within 1e-3 of each chain's
largest weight (a gradient step amplifies the rounding that parts the two
runs).

ptnn's own properties, on the port: chunk invariance
(tests/test_precond.py:77-88, tests/test_chees.py:144), the preconditioner
freezing after burn-in (test_precond.py:107), the gradient cache equal to
the gradient at w after every step (test_precond.py:90,
test_hmc.py:113), energy conservation at a small step (test_hmc.py:72),
full-length ChEES trajectories equal plain HMC (test_chees.py:75) and the
pCN hot rung sampling the prior (test_pcn.py:68). The FNN's hand-written
backprops against autograd.
"""

import dataclasses
import math

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
from ptnn_torch import convert, kernel, sampler
from ptnn_torch.models import fnn
from ptnn_torch.ops import drift, fnn_eval

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
MARGIN = 1e-5
RUN_W_RTOL = 1e-3

# the five members of the family; HMC at 3 leapfrog steps keeps ptnn's
# compile short
PROPOSALS = {
    "precond_rw": dict(proposal="precond_rw"),
    "precond_mala": dict(proposal="precond_mala", warmstart_frac=0.1),
    "hmc": dict(proposal="hmc", hmc_leapfrog=3, step_w=0.01,
                warmstart_frac=0.1),
    "chees": dict(proposal="hmc", hmc_leapfrog=3, hmc_adapt_traj=True,
                  step_w=0.01, warmstart_frac=0.1),
    "pcn": dict(proposal="pcn"),
}


def ptnn_precond_noise_fn(k_run, hmc):
    """The per-step noise contract filled with ptnn's draws for the
    preconditioned step: ``kp, ke, ku, kue, ks = split(fold_in(k_run, i),
    5)`` (ptnn/kernel.py:1718), HMC ``kp, kj = split(kp)`` (:1747)."""

    def one(key, c, w):
        kp, ke, ku, kue, ks = jax.random.split(key, 5)
        out = {}
        if hmc:
            kp, kj = jax.random.split(kp)
            out["jit"] = jax.random.uniform(kj, (c,))
        out.update(w=jax.random.normal(kp, (c, w), jnp.float32),
                   eta=jax.random.normal(ke, (c,)),
                   u=jax.random.uniform(ku, (c,)),
                   u_eta=jax.random.uniform(kue, (c,)),
                   u_swap=jax.random.uniform(ks, (c - 1,), jnp.float32))
        return out

    def noise_fn(start, length, c, w):
        keys = jsampler._step_keys(k_run, jnp.asarray(start), length)
        out = jax.vmap(lambda k: one(k, c, w))(keys)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    return noise_fn


def _sunspot(**kw):
    """8 chains = 2 ladders x 4 rungs, 40 samples a chain: warm start to
    step 4, preconditioner from 12, burn-in to 19, swaps (even-odd) every
    10, the temper switch at 24."""
    base = dict(task="regression", topology=(4, 10, 1), num_samples=8 * 40,
                num_chains=8, n_ladders=2, maxtemp=5.0, swap_interval=10,
                swap_offset=0, swap_payload="tempered_times_T",
                swap_style="even_odd", adapt_rate=0.1,
                precond_start_frac=0.3, record_w=True, record_eta=True,
                track_replicas=True, chunk_steps=20)
    base.update(kw)
    return base


def _iris(**kw):
    """bench.py's ``_cls_variants`` at 8 chains x 40 (metropolis swaps of
    untempered energies)."""
    cfg = ptnn.classification_preset((4, 12, 3), num_samples=8 * 40,
                                     num_chains=8, maxtemp=5.0)
    base = dict(cfg.__dict__, n_ladders=2, adapt_rate=0.1,
                swap_style="even_odd", swap_interval=10,
                swap_rule="metropolis", swap_payload="untempered",
                precond_start_frac=0.3, record_w=True, track_replicas=True,
                chunk_steps=20)
    base.update(kw)
    return base


PROBLEMS = {
    "Sunspot": (_sunspot, lambda: load_regression("Sunspot")),
    "iris": (_iris, lambda: load_classification("iris")),
}


def _configs(kw):
    return (ptnn.PTConfig(**kw).validate(),
            ptnn_torch.PTConfig(**kw).validate())


def _np_state(jst):
    return {k: (None if v is None else np.asarray(v))
            for k, v in jax.device_get(jst)._asdict().items()}


def check_steps(cfg):
    """Steps of a 40-sample run that cover each phase: the warm start's
    first and last, the first adapting step, the preconditioner's start,
    a swap event, the last adapting step, burn-in's end, the second swap
    event and the first step after the temper switch."""
    s = cfg.samples_per_chain
    warm = int(s * cfg.warmstart_frac)
    pc = int(s * cfg.precond_start_frac)
    burn = int(s * cfg.burn_in) - 1
    steps = {0, warm - 1, warm, pc, 10, burn - 1, burn, 20,
             cfg.temper_switch_step}
    return sorted(i for i in steps if 0 <= i < cfg.n_steps)


def held(got, want, scale=0.0, rtol=RTOL):
    """|got - want| <= ATOL + rtol (|want| + scale), elementwise."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want) <= ATOL + rtol * (np.abs(want) + scale)


EXACT = ("n_accept", "n_swap_accepted", "n_swap_proposed", "pair_prop_count",
         "replica_id")
FLOATS = ("w", "w_last", "eta", "prior", "rmse_train", "rmse_test",
          "acc_train", "acc_test", "log_step_w", "g_like", "pc_mean", "pc_m2",
          "log_step_eta", "log_traj", "chees_m1", "chees_v2")


def compare_step(tst, ttr, jst, jtr, ok, terms, swapped):
    """The port's state and trace after one step against ptnn's, on the
    chains in ``ok``; the swap event's fields on all chains when it ran
    (its permutation depends on every chain)."""
    fin, j = convert.chain_state_to_numpy(tst), _np_state(jst)
    for k in EXACT:
        if fin[k] is None:
            continue
        if fin[k].ndim == 0 or swapped:
            np.testing.assert_array_equal(fin[k], j[k], err_msg=k)
        else:
            np.testing.assert_array_equal(fin[k][ok], j[k][ok], err_msg=k)
    for k in FLOATS:
        if fin[k] is not None:
            # a gradient entry is a sum over the rows that can cancel far
            # below its terms: g_like is held on the chain's largest entry
            scale = (np.abs(j[k][ok]).max(axis=1, keepdims=True)
                     if k == "g_like" else 0.0)
            assert held(fin[k][ok], j[k][ok], scale).all(), (k, np.abs(
                fin[k][ok] - j[k][ok]).max())
    assert held(fin["ll"][ok], j["ll"][ok], terms[ok]).all()
    assert set(ttr) == set(jtr), (set(ttr), set(jtr))
    for k in ("accept_count", "replica", "traj_len"):
        if k in jtr:
            np.testing.assert_array_equal(ttr[k].numpy()[ok],
                                          np.asarray(jtr[k])[ok], err_msg=k)
    for k in ("rmse_train", "rmse_test", "acc_train", "acc_test", "w",
              "eta"):
        if k in jtr:
            a, b = ttr[k].numpy(), np.asarray(jtr[k])
            rows = ok[:a.shape[0]] if a.shape[0] < ok.shape[0] else ok
            assert held(a[rows], b[rows]).all(), k
    assert held(ttr["ll"].numpy()[ok], np.asarray(jtr["ll"])[ok],
                terms[ok]).all()


def one_step_case(make, load, proposal, seed, jspec=None, tspec=None,
                  rows=None):
    """Runs ptnn's jitted step over ``check_steps``' range and holds the
    port's step to it at each checked step; returns the number of
    (step, chain) pairs left out for their margin."""
    kw = make(**PROPOSALS[proposal])
    jcfg, tcfg = _configs(kw)
    prob = load()
    train, test = rows if rows is not None else (prob.train, prob.test)
    data = jsampler.make_dataset(jcfg, train, test)
    temps_np = np.asarray(jsampler.build_temperatures(jcfg), np.float32)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    jst = jkernel.init_state(k_init, jcfg, data, jspec)
    jstep = jax.jit(jkernel.make_step_fn(jcfg, data, jnp.asarray(temps_np),
                                         jspec))
    tdata = sampler.make_dataset(tcfg, train, test, "cpu")
    fn = kernel.make_step_fn(tcfg, tdata, torch.from_numpy(temps_np), tspec)
    assert isinstance(fn, kernel.PrecondStepFn)
    fn.diagnostics = True
    # the port's init_state at ptnn's weights: ptnn's ll, prior, g_like
    st0 = convert.chain_state_from_numpy(_np_state(jst))
    mine = kernel.init_state(tcfg, tdata, init_w=st0.w,
                             init_eta=None if tcfg.task == "classification"
                             else st0.eta, spec=tspec)
    terms = (train.shape[0] / temps_np if tcfg.task == "regression"
             else np.zeros_like(temps_np))
    for k in ("prior", "eta", "log_step_w", "log_step_eta", "log_traj"):
        a = getattr(mine, k)
        if a is not None:
            assert held(a.numpy(), getattr(st0, k).numpy()).all(), k
    assert held(mine.ll.numpy(), st0.ll.numpy(), train.shape[0]).all()
    if st0.g_like is not None:
        scale = np.abs(st0.g_like.numpy()).max(axis=1, keepdims=True)
        assert held(mine.g_like.numpy(), st0.g_like.numpy(), scale).all()
    noise_fn = ptnn_precond_noise_fn(k_run, tcfg.proposal == "hmc")
    steps = check_steps(tcfg)
    left_out = 0
    launches = (drift.launches, fnn_eval.launches)
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
        jst = new_j
    assert (drift.launches, fnn_eval.launches) == launches
    # at most one chain of eight left out at a checked step, on average
    assert left_out <= len(steps), left_out
    return left_out


@pytest.mark.parametrize("proposal", sorted(PROPOSALS))
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_one_step_matches_ptnn(problem, proposal):
    make, load = PROBLEMS[problem]
    one_step_case(make, load, proposal, seed=5)


def _run_both(kw, prob, seed, jspec=None, tspec=None, rows=None):
    """ptnn.sample(fused_step=False) and the port's per-step run from
    ptnn's initial state with ptnn's draws; the port's step reports its
    margins."""
    jcfg, tcfg = _configs(kw)
    train, test = rows if rows is not None else (prob.train, prob.test)
    data = jsampler.make_dataset(jcfg, train, test)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    st0 = jkernel.init_state(k_init, jcfg, data, jspec)
    ref = ptnn.sample(jcfg, train, test, seed=seed, init_state=st0,
                      model_spec=jspec)
    eng = sampler._per_step(tcfg, train, test, "cpu", tspec)
    eng.step_fn.diagnostics = True
    chunks = []
    state = eng.run(convert.chain_state_from_numpy(_np_state(st0)),
                    ptnn_precond_noise_fn(k_run, tcfg.proposal == "hmc"),
                    lambda tr: chunks.append(
                        {k: v.numpy() for k, v in tr.items()}))
    traces = {k: np.concatenate([ch[k] for ch in chunks]) for k in chunks[0]}
    margin = traces.pop("margin")
    got = sampler.make_result(tcfg, traces, state, eng.temps_host, 1.0)
    return got, ref, margin, train.shape[0]


def assert_runs_match(got, ref, margin, n_train):
    """Exact up to the first step whose decisions lie within the margin;
    the final counters too when no decision did."""
    cfg = got.config
    n = cfg.n_steps
    assert set(got.traces) == set(ref.traces)
    for k, v in ref.traces.items():
        assert got.traces[k].shape == v.shape, k
    close = np.nonzero((margin < MARGIN).any(axis=1))[0]
    k0 = int(close[0]) if len(close) else n
    assert k0 >= n // 2, (k0, margin.min(axis=1))
    rows = slice(0, k0 + 1)  # trace row i + 1 is step i
    for k in ("accept_count", "replica", "traj_len"):
        if k in ref.traces:
            np.testing.assert_array_equal(got.traces[k][rows],
                                          ref.traces[k][rows], err_msg=k)
    for k in ("rmse_train", "rmse_test", "acc_train", "acc_test", "eta"):
        if k not in ref.traces:
            continue
        ok = held(got.traces[k][rows], ref.traces[k][rows])
        if cfg.task == "classification":
            # the drifted states' outputs may flip an argmax that ties
            # within their distance: at most 1 % of the entries
            assert ok.mean() >= 0.99, (k, ok.mean())
        else:
            assert ok.all(), k
    # the two runs' states part by each step's rounding, amplified by the
    # gradient steps (ROADMAP Queue 3, "A limit of exact replay"): up to
    # 4e-4 of a chain's largest weight by step 40 on the CNN
    w, w_ref = got.traces["w"][rows], ref.traces["w"][rows]
    scale = np.abs(w_ref).max(axis=2, keepdims=True)
    assert held(w, w_ref, scale, rtol=RUN_W_RTOL).all()
    # the ll of each accepted proposal, which became the chain's state; a
    # rejected gradient proposal amplifies its start's rounding (MALA's
    # drift sig^2 m g / 2 with m up to 1e4, HMC's trajectory) and its ll is
    # only held finite: the MH test that rejected it lay outside the margin
    accepted = np.diff(ref.traces["accept_count"], axis=0, append=np.asarray(
        ref.final_state.n_accept)[None]) > 0
    terms = (n_train / got.temperatures[None, :]
             if cfg.task == "regression" else 0.0)
    ll_ok = held(got.traces["ll"], ref.traces["ll"],
                 np.broadcast_to(terms, accepted.shape))
    assert (ll_ok | ~accepted)[rows].all()
    if cfg.proposal in ("precond_rw", "pcn"):
        assert ll_ok[rows].all()
    assert np.isfinite(got.traces["ll"]).all()
    if k0 == n:
        np.testing.assert_array_equal(got.accept_ratio_per_chain,
                                      ref.accept_ratio_per_chain)
        assert got.swap_percent == ref.swap_percent
        fin, j = got.final_state, ref.final_state
        for k in ("n_swap_accepted", "n_swap_proposed", "replica_id"):
            np.testing.assert_array_equal(getattr(fin, k).numpy(),
                                          np.asarray(getattr(j, k)))
    assert int(got.final_state.n_swap_proposed) > 0
    assert 0.0 < got.accept_ratio_per_chain.mean() <= 100.0


@pytest.mark.parametrize("proposal", sorted(PROPOSALS))
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_run_matches_ptnn(problem, proposal):
    make, load = PROBLEMS[problem]
    kw = make(**PROPOSALS[proposal])
    got, ref, margin, n_train = _run_both(kw, load(), seed=2)
    cfg = got.config
    assert 0 < cfg.temper_switch_step < cfg.n_steps
    assert_runs_match(got, ref, margin, n_train)
    if proposal == "chees":
        tl = got.traces["traj_len"][1:]
        assert tl.min() >= 1 and tl.max() <= cfg.hmc_leapfrog


# ---------------------------------------------------------------------------
# ptnn's own properties of the family, on the port.


def _sample(kw, seed, prob=None, **extra):
    prob = prob or load_regression("Sunspot")
    cfg = ptnn_torch.PTConfig(**dict(kw, **extra)).validate()
    return ptnn_torch.sample(cfg, prob.train, prob.test, seed=seed,
                             device="cpu")


@pytest.mark.parametrize("proposal", ["precond_rw", "precond_mala", "chees",
                                      "pcn"])
def test_chunk_invariance(proposal):
    """tests/test_precond.py:77-88 and tests/test_chees.py:144: the same
    traces whatever ``chunk_steps`` (the default noise is drawn by page
    of steps, the carried state crosses chunk boundaries exactly)."""
    kw = _sunspot(**PROPOSALS[proposal], num_samples=8 * 80)
    a = _sample(kw, 3, chunk_steps=79)
    b = _sample(kw, 3, chunk_steps=13)
    assert set(a.traces) == set(b.traces)
    for k in a.traces:
        np.testing.assert_array_equal(a.traces[k], b.traces[k], err_msg=k)
    for k in ("w", "g_like", "pc_m2", "log_step_w", "log_traj"):
        x, y = getattr(a.final_state, k), getattr(b.final_state, k)
        assert (x is None and y is None) or torch.equal(x, y), k


def _walk(cfg, prob, seed, visit):
    """The per-step engine's steps one at a time with the default noise
    (and the temper switch's recompute), calling ``visit(i, state)`` after
    each step."""
    eng = sampler._per_step(cfg, prob.train, prob.test, "cpu")
    state = sampler.init_chains(cfg, eng.data, seed, eng.step_fn.spec)
    noise_fn = sampler.step_noise(seed, "cpu", kernel.step_noise_names(cfg))
    fn = eng.step_fn
    for i in range(cfg.n_steps):
        if i == cfg.temper_switch_step:
            state = fn.recompute_ll(state)
        noise = {k: v[0] for k, v in noise_fn(i, 1, cfg.num_chains,
                                               fn.spec.w_size).items()}
        state, _ = fn.step(state, i, noise)
        visit(i, state, fn)
    return state


@pytest.mark.parametrize("proposal", ["precond_mala", "chees"])
def test_preconditioner_freezes_after_burn_in(proposal):
    """tests/test_precond.py:107: pc_mean, pc_m2, log_step_w, log_step_eta
    (and ChEES's log_traj and moments) stop changing at burn-in's end while
    w keeps moving."""
    cfg = ptnn_torch.PTConfig(**_sunspot(**PROPOSALS[proposal],
                                         num_samples=8 * 60)).validate()
    burn_end = int(cfg.samples_per_chain * cfg.burn_in) - 1
    frozen = ("pc_mean", "pc_m2", "log_step_w", "log_step_eta", "log_traj",
              "chees_m1", "chees_v2")
    seen = {}

    def visit(i, st, fn):
        if i == burn_end:
            seen["at"] = {k: getattr(st, k) for k in frozen
                          if getattr(st, k) is not None}
            seen["w"] = st.w.clone()

    last = _walk(cfg, load_regression("Sunspot"), 1, visit)
    for k, v in seen["at"].items():
        assert torch.equal(getattr(last, k), v), k
    assert not torch.equal(last.w, seen["w"])
    assert float(last.pc_m2.mean()) > 0.0


@pytest.mark.parametrize("proposal", ["precond_mala", "hmc", "chees"])
def test_gradient_cache_equals_the_gradient_at_w(proposal):
    """tests/test_precond.py:90, tests/test_hmc.py:113: after every step
    (accepts, rejects, trajectory ends, swaps, the temper switch, eta
    moves) the carried g_like is the gradient at the carried w."""
    cfg = ptnn_torch.PTConfig(**_sunspot(**PROPOSALS[proposal],
                                         num_samples=8 * 40)).validate()

    def visit(i, st, fn):
        g = fn.vg(st.w)[1]
        np.testing.assert_allclose(g.numpy(), st.g_like.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"step {i}")

    _walk(cfg, load_regression("Sunspot"), 1, visit)


def test_energy_conservation_at_a_small_step():
    """tests/test_hmc.py:72: at a tiny frozen step the leapfrog's energy
    error is O(eps^2) and every trajectory is accepted, which pins the
    sign and scale of both kinetic-energy terms and the update order."""
    kw = dict(task="regression", topology=(4, 10, 1), num_samples=8 * 100,
              num_chains=8, maxtemp=5.0, swap_interval=0, swap_offset=0,
              swap_payload="tempered_times_T", proposal="hmc",
              hmc_leapfrog=8, step_w=1e-4, adapt_rate=0.0, chunk_steps=100)
    res = _sample(kw, 0)
    assert res.accept_ratio_per_chain.min() >= 99.0


def test_full_length_chees_trajectories_equal_plain_hmc():
    """tests/test_chees.py:75: with log_traj so high that every chain runs
    the full hmc_leapfrog steps, one ChEES step is the plain HMC step bit
    for bit (the carry-through mask is the identity on running chains)."""
    prob = load_regression("Sunspot")
    kw = _sunspot(**PROPOSALS["chees"])
    cfg_c = ptnn_torch.PTConfig(**kw).validate()
    cfg_p = dataclasses.replace(cfg_c, hmc_adapt_traj=False).validate()
    data = sampler.make_dataset(cfg_c, prob.train, prob.test, "cpu")
    temps = torch.as_tensor(jsampler.build_temperatures(cfg_c),
                            dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    st_c = kernel.init_state(cfg_c, data, generator=gen)
    st_p = kernel.init_state(cfg_p, data, init_w=st_c.w, init_eta=st_c.eta)
    st_c = st_c.replace(log_traj=torch.full_like(st_c.log_traj, 20.0))
    noise = {k: v[0] for k, v in sampler.step_noise(
        7, "cpu", kernel.step_noise_names(cfg_c))(
            5, 1, 8, st_c.w.shape[1]).items()}
    i = 5  # past the warm start: the trajectory runs
    new_c, tr_c = kernel.make_step_fn(cfg_c, data, temps).step(st_c, i, noise)
    new_p, _ = kernel.make_step_fn(cfg_p, data, temps).step(st_p, i, noise)
    for k in ("w", "ll", "g_like", "n_accept"):
        assert torch.equal(getattr(new_c, k), getattr(new_p, k)), k
    assert (tr_c["traj_len"] == cfg_c.hmc_leapfrog).all()


def test_pcn_hot_rung_samples_the_prior():
    """tests/test_pcn.py:68: at an infinite-temperature rung the pCN ratio
    is exactly 0, every proposal is accepted, rho adapts to its cap 1 and
    the draws are IID N(0, sigma_sq): mean, variance, lag-1
    autocorrelation."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 2))
    y = (x[:, 0] > 0).astype(float)
    rows = np.concatenate([x, y[:, None]], axis=1)
    cfg = ptnn_torch.PTConfig(
        task="classification", topology=(2, 2, 2), num_samples=2 * 3000,
        num_chains=2, maxtemp=1e8, custom_ladder=(1.0, float("inf")),
        swap_interval=10**6, swap_offset=0, proposal="pcn", step_w=0.5,
        pt_phase_frac=2.0, record_w=True, record_w_chains=0,
        chunk_steps=1000).validate()
    res = ptnn_torch.sample(cfg, rows, rows, seed=1, device="cpu")
    d = res.traces["w"][:, 1, :]
    d = d[d.shape[0] // 2:]
    n_steps = cfg.samples_per_chain - 1
    assert int(res.final_state.n_accept[1]) == n_steps
    assert float(torch.exp(res.final_state.log_step_w[1])) >= 1.0
    var = d.var(axis=0)
    assert abs(float(var.mean()) / 25.0 - 1.0) < 0.05
    assert np.all(np.abs(var / 25.0 - 1.0) < 0.25)
    assert np.max(np.abs(d.mean(axis=0))) < 0.6
    a = d[:-1] - d[:-1].mean(0)
    b = d[1:] - d[1:].mean(0)
    acf1 = (a * b).sum(0) / np.sqrt((a * a).sum(0) * (b * b).sum(0))
    assert np.max(np.abs(acf1)) < 0.1
    assert int(res.final_state.n_accept[0]) < n_steps


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_fnn_hand_backprop_matches_autograd(task):
    """The value-and-grad of the reference FNN (``fnn.neg_half_sse_grad``,
    ``fnn.multinomial_ll_grad``) against autograd through the forward, in
    float64 so that the comparison sees the backprop's formulas, not
    rounding: agreement to 1e-10."""
    rng = np.random.default_rng(11)
    if task == "regression":
        topo, prob = (4, 10, 1), load_regression("Sunspot")
    else:
        topo, prob = (4, 12, 3), load_classification("iris")
    i = topo[0]
    x = torch.as_tensor(prob.train[:, :i], dtype=torch.float64)
    y = torch.as_tensor(prob.train[:, i], dtype=torch.float64)
    w = torch.as_tensor(rng.normal(size=(6, fnn.w_size(topo))),
                        dtype=torch.float64)
    wg = w.clone().requires_grad_(True)
    out = fnn.batched_forward(wg, x, topo)
    if task == "regression":
        val, g = fnn.neg_half_sse_grad(w, x, y, topo)
        want = -0.5 * torch.sum(torch.square(y - out[:, :, 0]), dim=-1)
    else:
        val, g, out_hand = fnn.multinomial_ll_grad(w, x, y, topo)
        logp = fnn.log_class_probs(out)
        want = torch.gather(logp, -1, y.to(torch.int64).expand(
            logp.shape[:-1])[..., None])[..., 0].sum(-1)
        np.testing.assert_allclose(out_hand.numpy(), out.detach().numpy(),
                                   rtol=1e-12)
    (g_auto,) = torch.autograd.grad(want.sum(), wg)
    np.testing.assert_allclose(val.numpy(), want.detach().numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), g_auto.numpy(), rtol=1e-10,
                               atol=1e-10)


def test_like_value_and_grad_honours_the_chain_microbatch():
    """``drift_chain_microbatch`` splits the chains into sequential chunks
    (ptnn/kernel.py:318-329): the same values and gradients."""
    prob = load_classification("iris")
    cfg = ptnn_torch.PTConfig(**_iris(proposal="precond_mala")).validate()
    data = sampler.make_dataset(cfg, prob.train, prob.test, "cpu")
    spec = kernel.default_spec(cfg)
    w = torch.randn((8, spec.w_size), generator=torch.Generator()
                    .manual_seed(2))
    (v1, a1), g1 = kernel.like_value_and_grad(cfg, spec, data)(w)
    cfg4 = dataclasses.replace(cfg, drift_chain_microbatch=4)
    (v4, a4), g4 = kernel.like_value_and_grad(cfg4, spec, data)(w)
    for p, q in ((v1, v4), (a1, a4), (g1, g4)):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert math.isfinite(float(v1.sum()))
