"""Replica-exchange SGLD on the port's per-step sampler against ptnn's
(``proposal="sgld"``: ptnn's ``step_sgld``, PAPERS.md arXiv 2301.01898,
2010.01084).

One step: the port's ``SgldStepFn.step`` and ptnn's ``step_sgld`` take the
same state (ptnn's, through ``convert.chain_state_from_numpy``) and ptnn's
own draws (``kb, kn, ke, ks = split(fold_in(k_run, i), 4)``: the minibatch
``permutation(kb, N)[:B]``, the moves' normals, the swap's uniforms, and
under the corrected swap ``kb2, ks2 = split(ks)``), for regression
(Sunspot, (4, 10, 1)) and classification (iris, (4, 12, 3)), each swap mode,
the corrected one with and without SVRG anchors, and a zoo spec (an MLP,
autograd over its forward). Three steps: the anchor refresh at step 0, a
plain move, the swap event at step 2. Floats within rtol 2e-4 and atol
2e-5 (ll on the size of its terms), counters exact.

Whole runs, 40 steps, from ptnn's initial state on ptnn's draws
(``ptnn.sample(fused_step=False)``): swap counts and replica ids exact up to
the first swap decision within 1e-5 of flipping (``diagnostics``), traces
within the same tolerances. Then ptnn's invariants (tests/test_sgld.py)
held on the port: B = N makes the corrected energy the exact full-data ll
(with and without anchors); exact-mode metrics are piecewise constant
between swap events; replicated ladders keep their pair mask; the hot rung
of a ``sg_lr_scale="temperature"`` run equals a plain run at the scaled
step bit for bit; a stopped run resumes bit for bit (anchors included); and
the configuration's gates. The default noise draws each page's minibatches
in one op, a prefix of a uniform permutation (B = N: every row).

``PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/test_torch_sgld.py ARM
SEED...`` runs ptnn's sampler on the CPU at ``chip_smoke.py``'s sgld arm ARM
(``chip_smoke.SGLD_ARMS``: scripts/sgld_lr_scale_study.py's configuration)
and prints one JSON line a seed (``chip_smoke.sgld_stats``); ARM ``cnn``
runs ptnn's ``cnn_digits`` command line with ``chip_smoke.SGLD_CNN_ARGS``
and prints its last line's figures. The source of the smoke's bands.
"""

import dataclasses
import os

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
from ptnn.models import mlp as jmlp
from ptnn_torch import checkpoint, convert, kernel, sampler
from ptnn_torch.models import mlp
from ptnn_torch.ops import fnn_eval

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
MARGIN = 1e-5


def sgld_noise_fn(k_run, cfg, n_train):
    """The sgld noise contract filled with ptnn's draws: step i's keys are
    ``split(fold_in(k_run, i), 4)`` (ptnn/kernel.py:2317-2318), the
    corrected swap's ``split(ks)`` (:2263)."""
    bsz = min(cfg.sg_batch, n_train)

    def one(key, c, w):
        kb, kn, ke, ks = jax.random.split(key, 4)
        out = dict(batch=jax.random.permutation(kb, n_train)[:bsz],
                   w=jax.random.normal(kn, (c, w), jnp.float32))
        if cfg.task == "regression":
            out["eta"] = jax.random.normal(ke, (c,), jnp.float32)
        if cfg.sg_swap == "corrected":
            kb2, ks = jax.random.split(ks)
            out["batch_swap"] = jax.random.permutation(kb2, n_train)[:bsz]
        out["u_swap"] = jax.random.uniform(ks, (c - 1,), jnp.float32)
        return out

    def noise_fn(start, length, c, w):
        keys = jsampler._step_keys(k_run, jnp.asarray(start), length)
        out = jax.vmap(lambda k: one(k, c, w))(keys)
        got = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
        for k in ("batch", "batch_swap"):
            if k in got:
                got[k] = got[k].to(torch.int64)
        return got

    return noise_fn


def _kw(**kw):
    """tests/test_sgld.py's ``_sgld_cfg``: Sunspot, 8 chains, untempered
    metropolis even/odd swaps, the canonical schedule, B = 32."""
    base = dict(task="regression", topology=(4, 10, 1), num_samples=8 * 40,
                num_chains=8, maxtemp=5.0, swap_interval=20, swap_offset=0,
                swap_payload="untempered", swap_rule="metropolis",
                swap_style="even_odd", pt_phase_frac=2.0, proposal="sgld",
                sg_batch=32, sg_step=2e-5, record_w=False, chunk_steps=200)
    base.update(kw)
    return base


def _iris_kw(**kw):
    base = dict(task="classification", topology=(4, 12, 3), num_chains=4,
                num_samples=4 * 40, maxtemp=10.0, sg_step=1e-4)
    return _kw(**dict(base, **kw))


def _load(cfg):
    if cfg.task == "regression":
        return load_regression("Sunspot")
    return load_classification("iris")


STEP_CASES = {
    "reg_exact": _kw(),
    "reg_corrected": _kw(sg_swap="corrected"),
    "reg_corrected_vr": _kw(sg_swap="corrected", sg_vr=True,
                            sg_anchor_interval=2, sg_lr_scale="temperature"),
    "cls_exact": _iris_kw(),
    "cls_corrected": _iris_kw(sg_swap="corrected"),
    "cls_corrected_vr": _iris_kw(sg_swap="corrected", sg_vr=True,
                                 sg_anchor_interval=2),
    "mlp_corrected_vr": _iris_kw(sg_swap="corrected", sg_vr=True,
                                 sg_anchor_interval=2),
}


def _specs(case):
    if case.startswith("mlp"):
        return (jmlp.spec((4, 8, 3), act="tanh"),
                mlp.spec((4, 8, 3), act="tanh"))
    return None, None


def _start(kw, prob, seed, jspec=None):
    """Both packages' configs, ptnn's initial state (and the port's copy of
    it), ptnn's run key and dataset."""
    jcfg = ptnn.PTConfig(**kw).validate()
    tcfg = ptnn_torch.PTConfig(**kw).validate()
    data = jsampler.make_dataset(jcfg, prob.train, prob.test)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    st0 = jkernel.init_state(k_init, jcfg, data, jspec)
    np_state = {k: (None if v is None else np.asarray(v))
                for k, v in jax.device_get(st0)._asdict().items()}
    return jcfg, tcfg, data, st0, convert.chain_state_from_numpy(np_state), \
        k_run


def _assert_ll_close(got, want, cfg, n_train, temps):
    """ll is the difference of two terms of size >= n / T (regression);
    the multinomial ll is held on its own size."""
    terms = n_train / temps if cfg.task == "regression" else 0.0
    diff = np.abs(np.asarray(got, np.float64) - want)
    assert np.all(diff <= ATOL + RTOL * (np.abs(want) + terms)), diff.max()


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_one_step_matches_ptnn(case):
    kw = dict(STEP_CASES[case], swap_interval=2)
    jspec, tspec = _specs(case)
    jcfg, tcfg, data, jst, tst, k_run = _start(kw, _load(
        ptnn_torch.PTConfig(**kw)), seed=5, jspec=jspec)
    prob = _load(tcfg)
    temps_np = jsampler.build_temperatures(jcfg)
    jstep = jax.jit(jkernel.make_step_fn(jcfg, data,
                                         jnp.asarray(temps_np, jnp.float32),
                                         spec=jspec))
    tdata = sampler.make_dataset(tcfg, prob.train, prob.test, "cpu")
    fn = kernel.make_step_fn(tcfg, tdata, torch.from_numpy(
        np.asarray(temps_np, np.float32)), tspec)
    assert isinstance(fn, kernel.SgldStepFn)
    n = prob.train.shape[0]
    noise_fn = sgld_noise_fn(k_run, tcfg, n)
    before = fnn_eval.launches
    c = tcfg.num_chains
    for i in range(3):
        noise = {k: v[0] for k, v in noise_fn(i, 1, c, fn.spec.w_size).items()}
        jst, jtr = jstep(jst, (jnp.asarray(i, jnp.int32),
                               jax.random.fold_in(k_run, i)))
        tst, ttr = fn.step(tst, i, noise)
        assert set(ttr) == set(jtr), (set(ttr), set(jtr))
        fin, j = convert.chain_state_to_numpy(tst), jst._asdict()
        for k in ("n_accept", "n_langevin", "n_swap_accepted",
                  "n_swap_proposed", "pair_prop_count"):
            np.testing.assert_array_equal(fin[k], np.asarray(j[k]), err_msg=k)
        for k in ("w", "w_last", "eta", "prior", "rmse_train", "rmse_test",
                  "acc_train", "acc_test", "pair_accept_sum", "sg_anchor_w",
                  "sg_anchor_eta"):
            if j[k] is None:
                assert fin[k] is None, k
                continue
            np.testing.assert_allclose(fin[k], np.asarray(j[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k} at {i}")
        for k in ("ll", "sg_anchor_full"):
            if j[k] is not None:
                _assert_ll_close(fin[k], np.asarray(j[k]), tcfg, n, temps_np)
        np.testing.assert_array_equal(ttr["accept_count"].numpy(),
                                      np.asarray(jtr["accept_count"]))
        for k in ("rmse_train", "rmse_test", "acc_train", "acc_test"):
            np.testing.assert_allclose(ttr[k].numpy(), np.asarray(jtr[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    assert int(tst.n_swap_proposed) > 0 and int(tst.n_accept[0]) == 3
    assert fnn_eval.launches == before  # CPU tensors: the plain versions


RUN_CASES = {
    # the study's arm at 8 chains: corrected swaps with anchors every 10
    "sunspot_corrected_vr": _kw(sg_swap="corrected", sg_vr=True,
                                sg_anchor_interval=10, swap_interval=5,
                                track_replicas=True, record_w=True,
                                chunk_steps=15),
    "iris_exact": _iris_kw(swap_interval=5, track_replicas=True,
                           record_eta=True, chunk_steps=40),
}


def _run_both(kw, seed):
    prob = _load(ptnn_torch.PTConfig(**kw))
    jcfg, tcfg, _data, st0, tst, k_run = _start(kw, prob, seed)
    ref = ptnn.sample(jcfg, prob.train, prob.test, seed=seed, init_state=st0)
    eng = sampler._per_step(tcfg, prob.train, prob.test, "cpu")
    eng.step_fn.diagnostics = True
    chunks = []
    state = eng.run(tst, sgld_noise_fn(k_run, tcfg, prob.train.shape[0]),
                    lambda tr: chunks.append({k: v.numpy()
                                              for k, v in tr.items()}))
    traces = {k: np.concatenate([ch[k] for ch in chunks]) for k in chunks[0]}
    margin = traces.pop("margin")
    got = sampler.make_result(tcfg, traces, state, eng.temps_host, 1.0)
    return got, ref, margin, prob


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_matches_ptnn(case):
    got, ref, margin, prob = _run_both(RUN_CASES[case], seed=3)
    cfg = got.config
    n = cfg.n_steps
    assert set(got.traces) == set(ref.traces)
    for k, v in ref.traces.items():
        assert got.traces[k].shape == v.shape, k
    close = np.nonzero((margin < MARGIN).any(axis=1))[0]
    k0 = int(close[0]) if len(close) else n  # trace row k0 + 1 is step k0
    assert k0 >= n // 2, (k0, margin.min(axis=1))
    rows = slice(0, k0 + 1)
    for k in ("accept_count", "replica"):
        np.testing.assert_array_equal(got.traces[k][rows],
                                      ref.traces[k][rows], err_msg=k)
    for k in ("rmse_train", "rmse_test", "acc_train", "acc_test", "w",
              "eta"):
        if k in ref.traces:
            np.testing.assert_allclose(got.traces[k][rows],
                                       ref.traces[k][rows], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    _assert_ll_close(got.traces["ll"][rows], ref.traces["ll"][rows], cfg,
                     prob.train.shape[0], got.temperatures[None, :])
    np.testing.assert_array_equal(got.accept_ratio_per_chain,
                                  ref.accept_ratio_per_chain)
    if k0 == n:
        assert got.swap_percent == ref.swap_percent
        for k in ("n_swap_accepted", "n_swap_proposed", "replica_id"):
            np.testing.assert_array_equal(
                getattr(got.final_state, k).numpy(),
                np.asarray(getattr(ref.final_state, k)), err_msg=k)
    assert 0.0 < got.swap_percent < 100.0


# ---------------------------------------------------------------------------
# ptnn's invariants (tests/test_sgld.py), on the port


@pytest.mark.parametrize("vr", [False, True])
def test_full_batch_corrected_energy_is_exact(vr):
    """sg_batch >= N: the minibatch is every row, so the corrected swap's
    energy is the full-data ll, recomputed here from the w trace at a swap
    row; with anchors the centred estimator telescopes to it whatever the
    anchor's age (refreshed every 13 steps, not swap-aligned)."""
    extra = dict(sg_vr=True, sg_anchor_interval=13) if vr else {}
    cfg = ptnn_torch.PTConfig(**_iris_kw(
        num_samples=4 * 60, sg_batch=10 ** 6, sg_swap="corrected",
        record_w=True, track_replicas=True, chunk_steps=30,
        **extra)).validate()
    prob = load_classification("iris")
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=1, device="cpu")
    data = sampler.make_dataset(cfg, prob.train, prob.test, "cpu")
    rid = res.traces["replica"]
    # row r of the trace is step r - 1: swaps at steps 20, 40 -> rows 21,
    # 41; the w trace is the step's move, before the swap, the ll after it
    for r in (21, 41):
        w = torch.from_numpy(res.traces["w"][r])
        want = kernel.train_loglik(cfg, w, torch.zeros(4), data).numpy()
        perm = [int(np.nonzero(rid[r - 1] == k)[0][0]) for k in rid[r]]
        np.testing.assert_allclose(res.traces["ll"][r], want[perm],
                                   rtol=1e-5, atol=5e-2 if vr else 1e-2)
    assert int(res.final_state.n_swap_accepted) > 0


def test_full_batch_noise_is_every_row():
    """The default noise's minibatch at B = N is a permutation of every
    train row; at B < N distinct rows, a prefix of one."""
    fn = sampler.step_noise(2, "cpu", ("batch",), (150, 150))
    b = fn(0, 3, 4, 10)["batch"]
    assert b.dtype == torch.int64 and b.shape == (3, 150)
    for row in b:
        assert torch.equal(torch.sort(row).values, torch.arange(150))
    small = sampler.step_noise(2, "cpu", ("batch",), (150, 32))(0, 3, 4, 10)
    assert small["batch"].shape == (3, 32)
    assert all(len(set(r.tolist())) == 32 for r in small["batch"])
    assert torch.equal(small["batch"], b[:, :32])


def test_exact_mode_piecewise_constant_metrics():
    """sg_swap="exact": the carried metrics refresh only at the swap
    events, so rmse_test is constant between them, and every move counts
    as accepted."""
    cfg = ptnn_torch.PTConfig(**_kw(num_samples=8 * 80)).validate()
    prob = load_regression("Sunspot")
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=0, device="cpu")
    r = res.traces["rmse_test"][:, 0]
    seg = r[22:40]  # strictly inside one inter-swap window
    assert np.all(seg == seg[0])
    assert len(np.unique(r[21::20])) == len(r[21::20])
    assert np.all(res.accept_ratio_per_chain > 98.0)
    np.testing.assert_array_equal(res.final_state.n_langevin.numpy(),
                                  np.full(8, cfg.n_steps))


@pytest.mark.parametrize("mode", ["exact", "corrected"])
def test_sgld_respects_replicated_ladders(mode):
    """Swap pairs never cross a ladder boundary in either swap mode."""
    cfg = ptnn_torch.PTConfig(**_kw(
        n_ladders=2, track_replicas=True, sg_swap=mode, num_samples=8 * 120,
        swap_interval=5)).validate()
    prob = load_regression("Sunspot")
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=4, device="cpu")
    k = cfg.rungs_per_ladder
    rid = res.traces["replica"]
    np.testing.assert_array_equal(
        rid // k, np.broadcast_to(np.arange(cfg.num_chains) // k, rid.shape))
    assert int(res.final_state.n_swap_accepted) > 0


def test_lr_scale_hot_rung_is_plain_run_at_scaled_step():
    """With swaps off the chains are independent and draw the same noise
    in both runs, so the T = 2 rung at sg_step s under "temperature"
    equals the same rung at 2 s under "none" bit for bit; the cold rungs
    differ."""
    kw = dict(num_samples=2 * 60, num_chains=2, maxtemp=2.0,
              custom_ladder=(1.0, 2.0), swap_interval=1000, record_w=True,
              chunk_steps=60)
    prob = load_regression("Sunspot")
    scaled = ptnn_torch.sample(ptnn_torch.PTConfig(**_kw(
        sg_lr_scale="temperature", sg_step=2e-5, **kw)).validate(),
        prob.train, prob.test, seed=2, device="cpu")
    plain2x = ptnn_torch.sample(ptnn_torch.PTConfig(**_kw(
        sg_step=4e-5, **kw)).validate(), prob.train, prob.test, seed=2,
        device="cpu")
    w_s, w_p = scaled.traces["w"], plain2x.traces["w"]
    np.testing.assert_array_equal(w_s[:, 1, :], w_p[:, 1, :])
    assert np.any(w_s[1:, 0, :] != w_p[1:, 0, :])


class Stop(Exception):
    pass


@pytest.mark.parametrize("vr", [False, True])
def test_checkpoint_resume_identical(vr, tmp_path):
    """A run stopped after a checkpoint resumes bit for bit: every trace
    and state tensor, the anchors included."""
    extra = dict(sg_swap="corrected", sg_vr=True,
                 sg_anchor_interval=7) if vr else {}
    cfg = ptnn_torch.PTConfig(**_kw(num_samples=8 * 60, chunk_steps=10,
                                    swap_interval=5, **extra)).validate()
    prob = load_regression("Sunspot")
    want = ptnn_torch.sample(cfg, prob.train, prob.test, seed=7, device="cpu")
    noise = sampler.step_noise(7, torch.device("cpu"),
                               kernel.step_noise_names(cfg), (298, 32))

    def stopping(start, length, c, w):
        if start >= 40:
            raise Stop(start)
        return noise(start, length, c, w)

    path = str(tmp_path / "sg.npz")
    with pytest.raises(Stop):
        sampler.sample_per_step(cfg, prob.train, prob.test, seed=7,
                                device="cpu", noise_fn=stopping,
                                checkpoint_path=path, checkpoint_every=2)
    state, done, _tr = checkpoint.load(path, cfg, 7,
                                       kernel.default_spec(cfg).name)
    assert 0 < done < cfg.n_steps and os.path.exists(path)
    assert (state.sg_anchor_w is not None) == vr
    got = ptnn_torch.sample(cfg, prob.train, prob.test, seed=7, device="cpu",
                            checkpoint_path=path, checkpoint_every=2)
    for k, v in want.traces.items():
        np.testing.assert_array_equal(got.traces[k], v, err_msg=k)
    a = convert.chain_state_to_numpy(got.final_state)
    b = convert.chain_state_to_numpy(want.final_state)
    for k in a:
        if b[k] is None:
            assert a[k] is None, k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw,match", [
    (dict(sg_batch=0), "sg_batch"),
    (dict(sg_step=0.0), "sg_step"),
    (dict(swap_payload="tempered", swap_rule="half_exp"), "untempered"),
    (dict(pt_phase_frac=0.6), "canonical"),
    (dict(stale_likelihood_after_swap=True), "restore-likelihood"),
    (dict(sg_swap="bogus"), "sg_swap"),
    (dict(use_langevin_gradients=True), "use_langevin_gradients"),
    (dict(variational_reference=True, vr_start_frac=0.25),
     "variational_reference"),
    (dict(sg_vr=True, sg_anchor_interval=100), "sg_vr reduces the CORRECTED"),
    (dict(sg_swap="corrected", sg_vr=True), "sg_anchor_interval"),
    (dict(sg_lr_scale="bogus"), "sg_lr_scale"),
])
def test_validation_gates(kw, match):
    """The configuration's gates refuse what ptnn's refuse, in its words;
    what they let through, the per-step sampler runs (``step_reason``)."""
    with pytest.raises(ValueError, match=match):
        ptnn.PTConfig(**_kw(**kw)).validate()
    with pytest.raises(ValueError, match=match):
        ptnn_torch.PTConfig(**_kw(**kw)).validate()


@pytest.mark.parametrize("kw", [
    dict(), dict(sg_swap="corrected"),
    dict(sg_swap="corrected", sg_vr=True, sg_anchor_interval=20),
    dict(sg_lr_scale="temperature"),
    dict(sg_swap="corrected", sg_vr=True, sg_anchor_interval=20,
         sg_lr_scale="temperature")])
def test_step_reason_runs_every_sgld_config(kw):
    cfg = ptnn_torch.PTConfig(**_kw(**kw)).validate()
    assert kernel.step_reason(cfg) is None
    assert kernel.grid_reason(cfg) is not None  # grids of sgld: item 11


def arm_reference(arm: str, seed: int) -> dict:
    """ptnn's run of ``chip_smoke``'s sgld arm on the CPU, or of its
    ``cnn_digits`` command line (``arm == "cnn"``)."""
    import chip_smoke

    if arm == "cnn":
        import contextlib
        import io
        import tempfile

        from ptnn.experiments import cnn_digits

        out = io.StringIO()
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(out):
            cnn_digits.main(chip_smoke.SGLD_CNN_ARGS
                            + ["--seed", str(seed), "--out", tmp])
        line = out.getvalue().strip().splitlines()[-1]
        return dict(arm=arm, seed=seed, **chip_smoke.digits_line(line))
    cfg = chip_smoke.sgld_cfg(arm)
    prob = load_regression("Sunspot")
    jcfg = ptnn.PTConfig(**dataclasses.asdict(cfg)).validate()
    res = ptnn.sample(jcfg, prob.train, prob.test, seed=seed)
    return dict(arm=arm, seed=seed, **chip_smoke.sgld_stats(res))


if __name__ == "__main__":
    import json
    import sys

    for s in sys.argv[2:]:
        print(json.dumps(arm_reference(sys.argv[1], int(s))), flush=True)
