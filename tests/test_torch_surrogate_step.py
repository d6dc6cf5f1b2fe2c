"""The port's surrogate modes on the per-step sampler against ptnn's.

Whole runs of 8 chains (16 for the CNN) x 60 steps, chunks of 10, the
surrogate's warm-up over the first 20 % and ``surrogate_prob`` 0.5, from
ptnn's initial state (its ring and fit included) with ptnn's own draws:
step i's keys are ``split(fold_in(k_run, i), 6)`` (anchored) or ``7``
(delayed acceptance), the boundary closures' ``fold_in(fold_in(k_run,
0x7FFFFFFF), b)`` (ptnn/kernel.py:1262,1411, ptnn/sampler.py:183-208), and
ptnn's projection passed in (``convert.surrogate_proj_from_numpy``). Cases:
anchored, delayed acceptance with RW and with MALA inner moves, per-rung
fits, the MLP family, iris, and a small Bayesian CNN (whose real w_size
sizes the ring).

Up to the first step where some decision (the MH test, a segment's closure
test: the port's ``diagnostics`` margin) lies within MARGIN of flipping,
the accept counts and replica ids are exact, rmse / accuracy within rtol
2e-4, the proposal ll within rtol 2e-4 of its size; the surrogate branch of
every step is the one the step's "u_surr", the warm-up and the fit's trust
give (``surrogate`` trace); when no decision was that close, the segment
counts (``da_segments``), each chain's closure acceptances, the final
counters and the fit's trust are exact too. Every run's evals and drifts
are counted against the plan its decisions give: one eval a true step, a
closure and a refit, two drifts a true Langevin step and none
on a delayed-acceptance surrogate step. A delayed-acceptance run stopped in
the middle of a segment resumes bit for bit, and the surrogate's refusals
(``throughput_run``) are ptnn's.

``PYTHONPATH=.:tests python tests/test_torch_surrogate_step.py ARM SEED...``
runs ptnn's per-step sampler on the CPU at ``chip_smoke.py``'s surrogate
arm ARM (``chip_smoke.SURR_ARMS``: scripts/bench_modes.py's configuration)
and prints one JSON line a seed (``chip_smoke.surrogate_stats``): the
source of the smoke's bands.
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
from ptnn import surrogate as jsurr
from ptnn.data import load_classification, load_digits, load_regression
from ptnn.models import cnn as jcnn
from ptnn_torch import checkpoint, convert, kernel, sampler
from ptnn_torch.models import cnn

torch.set_num_threads(1)

MARGIN = 1e-5
RTOL, ATOL = 2e-4, 2e-5


def surrogate_noise_fn(k_run, da):
    """The per-step noise contract filled with ptnn's draws, and ``close(b,
    c)``, the uniforms of a segment closed at boundary b."""
    n_keys = 7 if da else 6

    def one(key, c, w):
        keys = jax.random.split(key, n_keys)
        kp, kl, ke, ku, ks, ksu = keys[:6]
        out = dict(w=jax.random.normal(kp, (c, w), jnp.float32),
                   l=jax.random.uniform(kl, (c,)),
                   eta=jax.random.normal(ke, (c,)),
                   u=jax.random.uniform(ku, (c,)),
                   u_swap=jax.random.uniform(ks, (c - 1,), jnp.float32),
                   u_surr=jax.random.uniform(ksu, ()))
        if da:
            out["u_seg"] = jax.random.uniform(keys[6], (c,))
        return out

    def noise_fn(start, length, c, w):
        keys = jsampler._step_keys(k_run, jnp.asarray(start), length)
        out = jax.vmap(lambda k: one(k, c, w))(keys)
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    k_close = jax.random.fold_in(k_run, 0x7FFFFFFF)

    def close(b, c):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(k_close, b), (c,))))

    noise_fn.close = close
    return noise_fn


SURR = dict(use_surrogate=True, surrogate_prob=0.5, surrogate_warmup_frac=0.2,
            surrogate_proj=4, chunk_steps=10, record_w=True,
            track_replicas=True)
DA = dict(SURR, surrogate_mode="delayed_acceptance")


def _sunspot(**kw):
    """Sunspot RW per step, 8 chains x 60 steps, maxtemp 3, swaps every 10,
    restore-likelihood swaps (delayed acceptance requires them)."""
    base = dict(task="regression", topology=(4, 10, 1), num_samples=8 * 61,
                num_chains=8, maxtemp=3.0, swap_interval=10, swap_offset=0,
                swap_payload="tempered_times_T",
                stale_likelihood_after_swap=False, surrogate_buffer=200)
    base.update(kw)
    return base


def _iris(**kw):
    cfg = ptnn.classification_preset((4, 12, 3), num_samples=8 * 61,
                                     num_chains=8)
    base = dict(cfg.__dict__, swap_interval=10,
                stale_likelihood_after_swap=False, surrogate_buffer=240)
    base.update(kw)
    return base


def _digits(**kw):
    """The digits CNN's classification preset at 16 x 60; its topology
    (64, 1, 10) passes the config's buffer check, the spec's real w_size
    sizes the ring."""
    cfg = ptnn.classification_preset((64, 1, 10), num_samples=16 * 61,
                                     num_chains=16, maxtemp=3.0)
    base = dict(cfg.__dict__, swap_interval=10,
                stale_likelihood_after_swap=False, surrogate_buffer=320)
    base.update(kw)
    return base


def _sunspot_rows():
    p = load_regression("Sunspot")
    return p.train, p.test


def _iris_rows():
    p = load_classification("iris")
    return p.train, p.test


def _digits_rows():
    p = load_digits(0)
    return p.train[:128], p.test[:64]


CASES = {
    "anchored": (_sunspot, SURR, _sunspot_rows, None),
    "anchored_langevin": (_sunspot, dict(SURR, use_langevin_gradients=True),
                          _sunspot_rows, None),
    "da_rw": (_sunspot, DA, _sunspot_rows, None),
    "da_mala": (_sunspot, dict(DA, surrogate_inner="mala"), _sunspot_rows,
                None),
    "da_langevin": (_sunspot, dict(DA, use_langevin_gradients=True),
                    _sunspot_rows, None),
    # per-rung fits need D rows a chain: the (4, 2, 1) network's 31, with
    # a ridge that conditions a gram of about as many rows as features
    "da_per_chain": (_sunspot, dict(DA, topology=(4, 2, 1),
                                    surrogate_scope="per_chain",
                                    surrogate_proj=2, surrogate_buffer=32,
                                    surrogate_ridge=0.05),
                     _sunspot_rows, None),
    "da_mlp": (_sunspot, dict(DA, surrogate_family="mlp", surrogate_hidden=4,
                              surrogate_fit_steps=60, surrogate_min_r2=0.3),
               _sunspot_rows, None),
    "da_iris": (_iris, DA, _iris_rows, None),
    "da_cnn": (_digits, dict(DA, surrogate_proj=2), _digits_rows,
               lambda m: m.digits_spec(channels=(1,), hidden=2)),
}


def _np(v):
    if v is None:
        return None
    if hasattr(v, "_asdict"):
        return {k: np.asarray(x) for k, x in v._asdict().items()}
    return np.asarray(v)


class Counts:
    """Counts the step's evals (a call of ``spec_eval_pair``: one launch on
    the card; ``spec_eval``: init's and the refits' train rows) and
    drifts."""

    def __init__(self, monkeypatch):
        self.pair = self.single = self.drift = 0
        pair, single, drift = (kernel.spec_eval_pair, kernel.spec_eval,
                               kernel.StepFn._drift)

        self.inside = False

        def count_pair(*a, **k):
            self.pair += 1
            self.inside = True  # a zoo spec's pair is two spec_evals
            try:
                return pair(*a, **k)
            finally:
                self.inside = False

        def count_single(*a, **k):
            self.single += not self.inside
            return single(*a, **k)

        def count_drift(fn, *a, **k):
            self.drift += 1
            return drift(fn, *a, **k)

        monkeypatch.setattr(kernel, "spec_eval_pair", count_pair)
        monkeypatch.setattr(kernel, "spec_eval", count_single)
        monkeypatch.setattr(kernel.StepFn, "_drift", count_drift)


def run_both(case, seed, monkeypatch):
    make, extra, rows, which = CASES[case]
    kw = make(**extra)
    jcfg = ptnn.PTConfig(**kw).validate()
    tcfg = ptnn_torch.PTConfig(**kw).validate()
    jspec = tspec = None
    if which is not None:
        jspec, tspec = which(jcnn), which(cnn)
    train, test = rows()
    data = jsampler.make_dataset(jcfg, train, test)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    st0 = jkernel.init_state(k_init, jcfg, data, jspec)
    w_size = st0.w.shape[1]
    proj = np.asarray(jsurr.make_projection(
        jax.random.PRNGKey(0x5A6A), w_size + 1, jcfg.surrogate_proj))
    ref = ptnn.sample(jcfg, train, test, seed=seed, init_state=st0,
                      model_spec=jspec)
    np_state = {k: _np(v) for k, v in jax.device_get(st0)._asdict().items()}
    counts = Counts(monkeypatch)
    eng = sampler._per_step(tcfg, train, test, "cpu", tspec,
                            convert.surrogate_proj_from_numpy(proj))
    eng.step_fn.diagnostics = True
    chunks = []
    noise = surrogate_noise_fn(k_run, tcfg.surrogate_mode
                               == "delayed_acceptance")
    state = eng.run(convert.chain_state_from_numpy(np_state), noise,
                    lambda tr: chunks.append(
                        {k: v.numpy() for k, v in tr.items()}),
                    close_fn=noise.close)
    traces = {k: np.concatenate([ch[k] for ch in chunks]) for k in chunks[0]}
    diag = dict(margin=traces.pop("margin"), surrogate=traces.pop("surrogate"),
                u_surr=noise(0, tcfg.n_steps, tcfg.num_chains,
                             w_size)["u_surr"].numpy())
    got = sampler.make_result(tcfg, traces, state, eng.temps_host, 1.0)
    return got, ref, diag, counts, train.shape[0]


def held(got, want, scale=0.0, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want) <= ATOL + rtol * (np.abs(want) + scale)


def chunk_starts(cfg):
    """The sampler's chunk starts: each segment (split at the temper
    switch) in chunks of ``_pick_chunk``."""
    n, switch = cfg.n_steps, cfg.temper_switch_step
    segs = [(0, switch), (switch, n)] if 0 < switch < n else [(0, n)]
    out = []
    for a, b in segs:
        chunk = sampler._pick_chunk(b - a, min(cfg.chunk_steps, n))
        out += list(range(a, b, chunk))
    return out


def plan(cfg, use):
    """The evals and drifts of a run from a given state, as its decisions
    give them: one eval a true step, a refit's re-anchor (every chunk but
    the first) and, under delayed acceptance, a closure (the first true
    step after a surrogate step, a refit after one, the run's end after
    one); two drifts a Langevin step, a true one under delayed
    acceptance."""
    n = cfg.n_steps
    da = cfg.surrogate_mode == "delayed_acceptance"
    true = ~use
    starts = chunk_starts(cfg)[1:]
    closes = sum(1 for i in range(1, n) if true[i] and use[i - 1]
                 and i not in starts)
    closes += sum(1 for b in starts if use[b - 1]) + int(use[n - 1])
    evals = int(true.sum()) + (closes if da else 0) + len(starts)
    lg = 2 if cfg.use_langevin_gradients else 0
    drifts = lg * (int(true.sum()) if da else n)
    return evals, drifts


def assert_runs_match(got, ref, diag, counts, n_train):
    cfg = got.config
    n = cfg.n_steps
    use = diag["surrogate"].astype(bool)
    assert use.shape == (n,)
    # the branch is the one the draws, the warm-up and the trust give
    warm = int(n * cfg.surrogate_warmup_frac)
    allowed = (np.arange(n) >= warm) & (diag["u_surr"] < np.float32(
        cfg.surrogate_prob))
    if cfg.surrogate_mode == "delayed_acceptance":
        allowed &= ~np.array([kernel.swap_due(cfg, i) for i in range(n)])
    assert not np.any(use & ~allowed)
    assert use.sum() >= 5, "the surrogate never took a step"
    chunks = np.searchsorted(chunk_starts(cfg), np.arange(n), side="right")
    for k in np.unique(chunks[use]):
        # within a trusted chunk, every allowed step takes the surrogate
        assert np.array_equal(use[chunks == k], allowed[chunks == k])
    evals, drifts = plan(cfg, use)
    assert (counts.pair + counts.single, counts.drift) == (evals, drifts)
    assert set(got.traces) == set(ref.traces)
    for k, v in ref.traces.items():
        assert got.traces[k].shape == v.shape, k
    close = np.nonzero((diag["margin"] < MARGIN).any(axis=1))[0]
    k0 = int(close[0]) if len(close) else n
    assert k0 >= n // 2, (k0, diag["margin"].min(axis=1))
    rows = slice(0, k0 + 1)  # trace row i + 1 is step i
    for k in ("accept_count", "replica"):
        np.testing.assert_array_equal(got.traces[k][rows],
                                      ref.traces[k][rows], err_msg=k)
    for k in ("rmse_train", "rmse_test", "acc_train", "acc_test", "w"):
        assert held(got.traces[k][rows], ref.traces[k][rows]).all(), k
    terms = (n_train / got.temperatures[None, :]
             if cfg.task == "regression" else 0.0)
    ll = held(got.traces["ll"], ref.traces["ll"],
              np.broadcast_to(terms, got.traces["ll"].shape))
    assert ll[rows].all()
    if k0 == n:
        np.testing.assert_array_equal(got.accept_ratio_per_chain,
                                      ref.accept_ratio_per_chain)
        assert got.swap_percent == ref.swap_percent
        assert got.da_segments == ref.da_segments
        if ref.da_accept_per_chain is not None:
            np.testing.assert_array_equal(got.da_accept_per_chain,
                                          ref.da_accept_per_chain)
        fin, j = got.final_state, ref.final_state
        assert bool(fin.surr.fitted) == bool(j.surr.fitted)
        np.testing.assert_array_equal(fin.surr.count.numpy(),
                                      np.asarray(j.surr.count))
        np.testing.assert_array_equal(fin.surr.ptr.numpy(),
                                      np.asarray(j.surr.ptr))
    if cfg.surrogate_mode == "delayed_acceptance":
        assert got.da_segments > 0 and not bool(got.final_state.da.active)
        assert got.da_segments == int(np.sum(use[1:] & ~use[:-1]) + use[0])


@pytest.mark.parametrize("case", list(CASES))
def test_surrogate_run_matches_ptnn(case, monkeypatch):
    got, ref, diag, counts, n_train = run_both(case, seed=2,
                                               monkeypatch=monkeypatch)
    assert_runs_match(got, ref, diag, counts, n_train)


def test_da_final_ll_is_the_true_ll():
    """ptnn's exactness invariant (tests/test_surrogate_da.py:72-87): after
    the run (its last segment closed) every chain's carried ll is the true
    ll of its weights."""
    kw = _sunspot(**DA)
    cfg = ptnn_torch.PTConfig(**kw).validate()
    train, test = _sunspot_rows()
    res = ptnn_torch.sample(cfg, train, test, seed=0, device="cpu")
    assert res.da_segments > 0
    st = res.final_state
    data = sampler.make_dataset(cfg, train, test, "cpu")
    true = kernel.train_loglik(cfg, st.w, st.eta, data)
    np.testing.assert_allclose(st.ll.numpy(), true.numpy(), rtol=1e-4,
                               atol=1e-3)


class Stop(Exception):
    pass


def test_da_resumes_bit_for_bit_in_a_segment(tmp_path):
    """A delayed-acceptance run stopped after a checkpoint saved with a
    segment open resumes in it and ends where an uninterrupted run ends:
    every trace and state tensor, the ring, the fit and the segment."""
    kw = _sunspot(**dict(DA, surrogate_prob=0.9, chunk_steps=5,
                         surrogate_inner="mala"))
    cfg = ptnn_torch.PTConfig(**kw).validate()
    train, test = _sunspot_rows()
    want = ptnn_torch.sample(cfg, train, test, seed=4, device="cpu")
    noise = sampler.step_noise(4, torch.device("cpu"),
                               kernel.step_noise_names(cfg))
    path = str(tmp_path / "run.npz")
    saved = []

    def stopping(start, length, c, w):
        # stop at the first chunk after a checkpoint saved mid-segment
        if saved and saved[-1]:
            raise Stop(start)
        return noise(start, length, c, w)

    orig = checkpoint.save

    def spy(p, state, done, *a, **k):
        orig(p, state, done, *a, **k)
        saved.append(bool(state.da.active) and done < cfg.n_steps)

    import ptnn_torch.checkpoint as ckmod
    ckmod.save = spy
    try:
        with pytest.raises(Stop):
            sampler.sample_per_step(cfg, train, test, seed=4, device="cpu",
                                    noise_fn=stopping, checkpoint_path=path,
                                    checkpoint_every=1)
    finally:
        ckmod.save = orig
    state, done, _tr = checkpoint.load(path, cfg, 4,
                                       kernel.default_spec(cfg).name)
    assert 0 < done < cfg.n_steps and bool(state.da.active)
    got = ptnn_torch.sample(cfg, train, test, seed=4, device="cpu",
                            checkpoint_path=path, checkpoint_every=1)
    assert set(got.traces) == set(want.traces)
    for k, v in want.traces.items():
        np.testing.assert_array_equal(got.traces[k], v, err_msg=k)
    a = convert.chain_state_to_numpy(got.final_state)
    b = convert.chain_state_to_numpy(want.final_state)
    for k in a:
        if isinstance(b[k], dict):
            for f in b[k]:
                np.testing.assert_array_equal(a[k][f], b[k][f],
                                              err_msg=f"{k}.{f}")
        elif b[k] is None:
            assert a[k] is None, k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got.da_segments == want.da_segments > 0


def test_surrogate_refusals_are_ptnn_s():
    train, test = _sunspot_rows()
    kw = _sunspot(**DA)
    cfg = ptnn_torch.PTConfig(**kw).validate()
    with pytest.raises(ValueError, match="never refits the surrogate"):
        ptnn_torch.throughput_run(cfg, train, test, device="cpu")
    assert kernel.step_reason(cfg) is None
    for bad in (dict(stale_likelihood_after_swap=True),
                dict(surrogate_buffer=16)):
        for pkg in (ptnn, ptnn_torch):
            with pytest.raises(ValueError):
                pkg.PTConfig(**dict(kw, **bad)).validate()
    # a model spec's real w_size is checked against the buffer at init
    spec = cnn.digits_spec(channels=(4,), hidden=16)
    small = ptnn_torch.PTConfig(**_digits(**DA)).validate()
    rows = _digits_rows()
    with pytest.raises(ValueError, match="w_size"):
        ptnn_torch.sample(small, *rows, device="cpu", model_spec=spec)


def arm_reference(arm: str, seed: int) -> dict:
    """ptnn's run of ``chip_smoke``'s surrogate arm on the CPU."""
    import chip_smoke

    cfg = chip_smoke.surrogate_cfg(arm)
    prob = load_regression("Sunspot")
    jcfg = ptnn.PTConfig(**dataclasses.asdict(cfg)).validate()
    res = ptnn.sample(jcfg, prob.train, prob.test, seed=seed)
    return dict(arm=arm, seed=seed, **chip_smoke.surrogate_stats(res))


if __name__ == "__main__":
    import json
    import sys

    for s in sys.argv[2:]:
        print(json.dumps(arm_reference(sys.argv[1], int(s))), flush=True)
