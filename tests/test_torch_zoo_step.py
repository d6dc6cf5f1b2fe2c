"""The port's per-step sampler on the model zoo against ptnn's.

Whole runs of 8 chains x 40 steps from ptnn's initial state with ptnn's own
per-step noise (``split(fold_in(k_run, i), 6)``, fed through the per-step
noise contract): the Bayesian CNN ``digits_spec(channels=(4,), hidden=16)``
with and without ``fused_eval`` and a deep MLP on 128 / 64 digits rows (the
configurations of ``tests/test_cnn.py``), an MLP with ``adapt_step_size``
and Langevin gradients (the drift rate tied to each chain's step), and a
tanh MLP on Sunspot (regression).

The gradient drift enters the MH ratio through differences of sums of
squares divided by step_w^2, which amplifies float32 rounding to about 1e-3
in log space, so a decision with |u - mh_prob| under MARGIN may flip between
two float32 implementations and the runs part ways from there. The port's
step reports that margin (``StepFn.diagnostics``): up to the first step
where some chain's margin is under MARGIN (at least half the run) the accept
counts, the Langevin choices and the replica ids are exact, accuracies and
rmse within rtol 2e-4, and the proposal ll within rtol 1e-4 of its size (of
its cancelling terms for regression); when no decision was that close, the
final counters and the swap percentage are exact too.

``PYTHONPATH=. python tests/test_torch_zoo_step.py cnn <chains> <steps> [seed
...]`` runs ptnn's per-step sampler on the CPU at ``cnn_digits``'s default
configuration on all digits rows: the source of ``chip_smoke.py``'s CNN
bands.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import kernel as jkernel
from ptnn import sampler as jsampler
from ptnn.data import load_digits, load_regression
from ptnn.models import cnn as jcnn
from ptnn.models import mlp as jmlp
from ptnn_torch import convert, kernel, sampler
from ptnn_torch.models import api, cnn, mlp
from ptnn_torch.ops import conv_stage, fnn_eval

torch.set_num_threads(1)

MARGIN = 2e-4
RTOL, ATOL = 2e-4, 2e-5


def ptnn_noise_fn(k_run):
    """The per-step noise contract filled with ptnn's draws: step i's keys
    are ``split(fold_in(k_run, i), 6)`` (ptnn/kernel.py:1262)."""

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


def _digits_cfg(**kw):
    """tests/test_cnn.py's CNN run: the classification preset at 8 x 40,
    maxtemp 3, Langevin gradients at lr 0.02, swaps every 10."""
    cfg = ptnn.classification_preset(
        (64, 16, 10), num_samples=8 * 40, num_chains=8, maxtemp=3.0,
        use_langevin_gradients=True, learn_rate=0.02)
    base = dict(cfg.__dict__, swap_interval=10, record_w=False,
                chunk_steps=20, track_replicas=True)
    base.update(kw)
    return base


def _sunspot_cfg(**kw):
    cfg = ptnn.regression_preset(
        num_samples=8 * 40, num_chains=8, maxtemp=3.0,
        use_langevin_gradients=True, learn_rate=5e-5)
    base = dict(cfg.__dict__, swap_interval=10, step_w=0.01, record_w=False,
                chunk_steps=20, track_replicas=True)
    base.update(kw)
    return base


def _digits_rows():
    p = load_digits(0)
    return p.train[:128], p.test[:64]


def _sunspot_rows():
    p = load_regression("Sunspot")
    return p.train, p.test


CASES = {
    "cnn": (_digits_cfg, {}, _digits_rows,
            lambda m: m.digits_spec(channels=(4,), hidden=16)),
    "cnn_fused": (_digits_cfg, {}, _digits_rows,
                  lambda m: m.digits_spec(channels=(4,), hidden=16,
                                          fused_eval=True)),
    "mlp": (_digits_cfg, dict(learn_rate=5e-5, step_w=0.01), _digits_rows,
            "mlp_cls"),
    "mlp_adapt": (_digits_cfg, dict(adapt_step_size=True, step_w=0.01,
                                    use_langevin_gradients=True),
                  _digits_rows, "mlp_cls"),
    "mlp_rw": (_digits_cfg, dict(use_langevin_gradients=False),
               _digits_rows, "mlp_cls"),
    "mlp_regression": (_sunspot_cfg, {}, _sunspot_rows, "mlp_reg"),
    # the posterior-predictive traces on a zoo spec (the plain forward)
    "mlp_fx": (_digits_cfg, dict(learn_rate=5e-5, step_w=0.01,
                                 record_fx=True), _digits_rows, "mlp_cls"),
}


def _specs(which):
    if which == "mlp_cls":
        return (jmlp.spec((64, 32, 16, 10), act="relu"),
                mlp.spec((64, 32, 16, 10), act="relu"))
    if which == "mlp_reg":
        return (jmlp.spec((4, 16, 8, 1), task="regression", act="tanh"),
                mlp.spec((4, 16, 8, 1), task="regression", act="tanh"))
    return which(jcnn), which(cnn)


def _run_both(case, seed):
    make, extra, rows, which = CASES[case]
    kw = make(**extra)
    jcfg = ptnn.PTConfig(**kw).validate()
    tcfg = ptnn_torch.PTConfig(**kw).validate()
    jspec, tspec = _specs(which)
    train, test = rows()
    data = jsampler.make_dataset(jcfg, train, test)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    st0 = jkernel.init_state(k_init, jcfg, data, jspec)
    np_state = {k: (None if v is None else np.asarray(v))
                for k, v in jax.device_get(st0)._asdict().items()}
    tst = convert.chain_state_from_numpy(np_state)
    ref = ptnn.sample(jcfg, train, test, seed=seed, init_state=st0,
                      model_spec=jspec)
    # the port, with its step reporting each decision's margin
    launches = (conv_stage.launches, fnn_eval.launches)
    eng = sampler._per_step(tcfg, train, test, "cpu", tspec)
    eng.step_fn.diagnostics = True
    chunks = []
    state = eng.run(tst, ptnn_noise_fn(k_run), lambda tr: chunks.append(
        {k: v.numpy() for k, v in tr.items()}))
    assert (conv_stage.launches, fnn_eval.launches) == launches
    traces = {k: np.concatenate([ch[k] for ch in chunks]) for k in chunks[0]}
    margin = traces.pop("margin")
    got = sampler.make_result(tcfg, traces, state, eng.temps_host, 1.0)
    # the port's init_state at ptnn's weights gives ptnn's ll and prior
    mine = kernel.init_state(tcfg, eng.data, init_w=tst.w,
                             init_eta=None if tcfg.task == "classification"
                             else tst.eta, spec=tspec)
    for k in ("ll", "prior", "eta"):
        np.testing.assert_allclose(getattr(mine, k).numpy(), np_state[k],
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    return got, ref, margin


def _ll_terms(cfg, n_train, temps):
    return n_train / temps if cfg.task == "regression" else 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_zoo_run_matches_ptnn(case):
    got, ref, margin = _run_both(case, seed=4)
    cfg = got.config
    n = cfg.n_steps
    assert set(got.traces) == set(ref.traces)
    for k, v in ref.traces.items():
        assert got.traces[k].shape == v.shape, k
    close = np.nonzero((margin < MARGIN).any(axis=1))[0]
    # rows are offset by the init row: trace row i + 1 is step i
    k0 = int(close[0]) if len(close) else n
    assert k0 >= n // 2, (k0, margin.min(axis=1))
    rows = slice(0, k0 + 1)
    np.testing.assert_array_equal(got.traces["accept_count"][rows],
                                  ref.traces["accept_count"][rows])
    np.testing.assert_array_equal(got.traces["replica"][rows],
                                  ref.traces["replica"][rows])
    for k in ("rmse_train", "rmse_test", "acc_train", "acc_test"):
        np.testing.assert_allclose(got.traces[k][rows], ref.traces[k][rows],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for k in ("fx_train", "fx_test"):
        if k in ref.traces:
            # predicted classes: a near-tied argmax may flip between the
            # two packages' outputs, in at most 1 % of the entries
            same = got.traces[k][rows] == ref.traces[k][rows]
            assert same.mean() >= 0.99, (k, same.mean())
    n_train = 128 if cfg.task == "classification" else 298
    want = ref.traces["ll"][rows]
    diff = np.abs(got.traces["ll"][rows].astype(np.float64) - want)
    terms = _ll_terms(cfg, n_train, got.temperatures[None, :])
    assert np.all(diff <= ATOL + 1e-4 * (np.abs(want) + terms)), diff.max()
    assert np.isfinite(got.traces["ll"]).all()
    if cfg.use_langevin_gradients:
        lr = got.langevin_ratio_per_chain
        assert 0.0 < lr.min() and lr.max() < 100.0
    if k0 == n:
        np.testing.assert_array_equal(got.accept_ratio_per_chain,
                                      ref.accept_ratio_per_chain)
        np.testing.assert_array_equal(got.langevin_ratio_per_chain,
                                      ref.langevin_ratio_per_chain)
        assert got.swap_percent == ref.swap_percent
        fin, j = got.final_state, ref.final_state
        for k in ("n_swap_accepted", "n_swap_proposed", "replica_id"):
            np.testing.assert_array_equal(getattr(fin, k).numpy(),
                                          np.asarray(getattr(j, k)))
        np.testing.assert_allclose(fin.w.numpy(), np.asarray(j.w), rtol=RTOL,
                                   atol=ATOL)
        if cfg.adapt_step_size:
            np.testing.assert_allclose(fin.log_step_w.numpy(),
                                       np.asarray(j.log_step_w), rtol=RTOL,
                                       atol=ATOL)
    assert int(got.final_state.n_swap_proposed) > 0
    acc = got.accept_ratio_per_chain
    assert 0.0 < acc.mean() < 100.0


def test_fused_eval_runs_the_fused_forward(monkeypatch):
    """``fused_eval=True`` routes every eval (two a step, init_state's and
    the temper switch's) through ``batched_forward_fused``; the drift keeps
    the plain forward."""
    calls = []
    real = cnn.batched_forward_fused
    monkeypatch.setattr(cnn, "batched_forward_fused",
                        lambda *a: calls.append(1) or real(*a))
    train, test = _digits_rows()
    cfg = ptnn_torch.PTConfig(**_digits_cfg(num_samples=8 * 10)).validate()
    spec = cnn.digits_spec(channels=(4,), hidden=16, fused_eval=True)
    res = ptnn_torch.sample(cfg, train[:32], test[:16], device="cpu",
                            model_spec=spec)
    n = cfg.n_steps
    assert 0 < cfg.temper_switch_step < n
    assert len(calls) == 2 * n + 2
    assert res.traces["acc_test"].shape == (10, 8)


def test_reference_fnn_is_unchanged_by_the_spec_route():
    """The reference FNN through an explicit spec is the default run, bit
    for bit, and its evals are ``ops.fnn_eval``'s."""
    prob = load_regression("Sunspot")
    cfg = ptnn_torch.PTConfig(
        task="regression", topology=(4, 10, 1), num_samples=8 * 20,
        num_chains=8, maxtemp=5.0, swap_interval=5, swap_offset=0,
        swap_payload="tempered_times_T", use_langevin_gradients=True,
        drift_mode="pallas", record_w=True).validate()
    a = ptnn_torch.sample(cfg, prob.train, prob.test, seed=3, device="cpu")
    spec = api.fnn_spec(cfg.topology, cfg.drift_mode)
    b = ptnn_torch.sample(cfg, prob.train, prob.test, seed=3, device="cpu",
                          model_spec=spec)
    for k in a.traces:
        np.testing.assert_array_equal(a.traces[k], b.traces[k], err_msg=k)
    data = sampler.make_dataset(cfg, prob.train, prob.test, "cpu")
    w = torch.from_numpy(a.traces["w"][-1])
    tau = torch.full((8,), 0.05)
    want = fnn_eval.fnn_eval(w, data.x_train, data.y_train, tau,
                             cfg.topology, cfg.task)
    got = kernel.spec_eval(cfg, spec, w, data.x_train, data.y_train, tau)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_zoo_specs_never_take_the_fused_path():
    train, test = _digits_rows()
    cfg = ptnn_torch.PTConfig(**_digits_cfg(
        num_samples=8 * 6, use_langevin_gradients=False,
        fused_step=True)).validate()
    with pytest.warns(UserWarning, match="reference FNN spec"):
        res = ptnn_torch.sample(cfg, train[:16], test[:8], device="cpu",
                                model_spec=mlp.spec((64, 8, 10)))
    assert res.traces["ll"].shape == (6, 8)


def test_zoo_refusals_name_the_feature():
    """bfloat16 evals run on a zoo spec since they were ported (its own
    forward in bfloat16, the likelihood in float32; held to ptnn's in
    tests/test_torch_bf16_eval.py); ``record_fx``
    runs there (since it was ported), its traces the plain forward's
    predicted classes at each chain's last accepted proposal (its run
    against ptnn's: ``test_zoo_run_matches_ptnn[mlp_fx]``); the FNN's
    ``adapt_step_size`` with Langevin gradients runs since its drift takes
    a rate a chain (its run against ptnn's:
    ``tests/test_torch_step.py::test_sunspot_lg_adapt_step_size_run_matches_ptnn``)."""
    train, test = _digits_rows()
    spec = mlp.spec((64, 8, 10))
    cfg = ptnn_torch.PTConfig(**_digits_cfg(
        eval_dtype="bfloat16")).validate()
    assert kernel.step_reason(cfg, spec) is None
    res = ptnn_torch.sample(cfg, train[:16], test[:8], device="cpu",
                            model_spec=spec)
    assert np.isfinite(res.traces["ll"]).all()
    cfg = ptnn_torch.PTConfig(**_digits_cfg(record_fx=True)).validate()
    res = ptnn_torch.sample(cfg, train[:16], test[:8], device="cpu",
                            model_spec=spec)
    fin = res.final_state
    moved = fin.n_accept.numpy() > 0
    assert moved.any()
    for split, rows in (("train", train[:16]), ("test", test[:8])):
        fx = res.traces[f"fx_{split}"]
        assert fx.shape == (cfg.samples_per_chain, 8, rows.shape[0])
        want = kernel.spec_fx(cfg, spec, fin.w_last, torch.from_numpy(
            rows[:, :64].astype(np.float32))).numpy()
        np.testing.assert_array_equal(fx[-1][moved], want[moved])
    # the FNN's drift takes a rate a chain: adapt + Langevin runs, each
    # chain at its own adapted step
    cfg = ptnn_torch.PTConfig(**_digits_cfg(adapt_step_size=True)).validate()
    res = ptnn_torch.sample(cfg, train[:16], test[:8], device="cpu")
    lsw = res.final_state.log_step_w.numpy()
    assert np.isfinite(res.traces["ll"]).all() and np.ptp(lsw) > 0


def test_throughput_runner_takes_a_model_spec():
    train, test = _digits_rows()
    cfg = ptnn_torch.PTConfig(**_digits_cfg(num_samples=8 * 8)).validate()
    rep = ptnn_torch.throughput_runner(
        cfg, train[:32], test[:16], seed=1, device="cpu",
        model_spec=cnn.digits_spec(channels=(4,), hidden=16, fused_eval=True))
    a, b = rep(), rep()
    assert a["steps"] == 7.0 and a["chains"] == 8.0
    assert a["trace_means"] == b["trace_means"]
    assert 0.0 < a["langevin_pct"] < 100.0


# ---------------------------------------------------------------------------
# ptnn's per-step sampler on the CPU at the CNN configuration chip_smoke.py
# runs on the card: the reference for its bands.


def cnn_digits_reference(seed: int = 0, chains: int = 64,
                         steps: int = 300) -> dict:
    """``python -m ptnn.experiments.cnn_digits``'s default configuration
    (maxtemp 5, step_w 0.01, learn_rate step_w^2 / 2, Langevin gradients,
    swaps every 100, record_w off) on all 1257 / 540 digits rows of
    ``load_digits(0)``."""
    prob = load_digits(0)
    step_w = 0.01
    cfg = dataclasses.replace(
        ptnn.classification_preset(prob.topology, num_samples=chains * steps,
                                   num_chains=chains, maxtemp=5.0,
                                   use_langevin_gradients=True,
                                   learn_rate=step_w * step_w / 2.0),
        swap_interval=100, step_w=step_w, record_w=False,
        chunk_steps=min(500, steps)).validate()
    res = ptnn.sample(cfg, prob.train, prob.test, seed=seed,
                      model_spec=jcnn.digits_spec())
    s = cfg.samples_per_chain
    acc = res.traces["acc_test"][s // 2:]
    return dict(accept=float(np.mean(res.accept_ratio_per_chain)),
                swap=float(res.swap_percent),
                langevin=float(np.mean(res.langevin_ratio_per_chain)),
                ladder_acc=float(np.mean(acc)),
                cold_acc=float(np.mean(acc[:, 0])),
                cold_acc_final=float(res.traces["acc_test"][-1, 0]),
                seconds=res.elapsed_s)


if __name__ == "__main__":
    import sys

    chains, steps = int(sys.argv[2]), int(sys.argv[3])
    for seed in [int(a) for a in sys.argv[4:]] or [0]:
        print(sys.argv[1], chains, steps, seed,
              cnn_digits_reference(seed, chains, steps), flush=True)
