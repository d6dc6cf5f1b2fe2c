"""The port's sweeps (``ptnn_torch.sweeps``) against ptnn's
(``ptnn.sweeps``), on ptnn's per-cell initial states and draws.

ptnn vmaps a grid's cells; the port lays them side by side on the chain
axis of one per-step run. Given ptnn's per-cell state (``init_state``
of cell k from ``split(key_k)[0]``) and ptnn's per-cell step draws
(``split(fold_in(split(key_k)[1], i), 6)``, concatenated on the chain axis
with one filler uniform for the pair across each cell boundary), the port's
grid is ptnn's grid: accept and swap percentages equal, the train and test
statistics (post-burn-in mean, std, best) within rtol 2e-4, atol 2e-5.
Cases: ``dataset_grid`` on Sunspot and ACFinance x the three modes (row
padding, per-chain Langevin probability and rate), ``classification_grid``
on iris and Cancer x seeds (0, 1) in RW and in legacy LG (the topology
envelope: zero features, class mask, parameter mask), and two or three
cells of ``seed_sweep``, ``maxtemp_sweep``, ``swap_interval_sweep`` (one
cell that never swaps) and ``lprob_sweep``. A grid cell also equals the
port's own single per-step run of its seed, and the port refuses what ptnn
refuses on a padded dataset.

``python tests/test_torch_sweeps.py regression|cls-rw|cls-lg SEED...``
runs ptnn's grid on the CPU at the configurations ``chip_smoke.py`` runs on
the card (``dataset_grid`` at grid_parity's 21 cells x 10 chains and
10,000 samples; ``classification_grid``'s small bucket, 15 cells x 10
chains, 5,000 samples) and prints each seed's per-cell statistics as one
JSON line: the source of the smoke's bands.
"""

import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import kernel as jkernel
from ptnn import sweeps as jsweeps
from ptnn.data import load_classification, load_regression
from ptnn.sampler import make_dataset as jmake_dataset
from ptnn_torch import convert, kernel, sampler, sweeps

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
STATS = ("test_mean", "test_std", "test_best", "train_mean", "train_std",
         "train_best")
# the chip smoke's grids (scripts/grid_parity.py, scripts/cls_grid.py small
# bucket), at the smoke's depths
REG_NAMES = ("Lazer", "Sunspot", "Mackey", "Lorenz", "Rossler", "Henon",
             "ACFinance")
CLS_SMALL = ("iris", "Ionosphere", "Cancer")
REG_SAMPLES, CLS_SAMPLES = 10_000, 5_000


def _np_tree(st):
    return {k: (None if v is None else np.asarray(v))
            for k, v in jax.device_get(st)._asdict().items()}


def ptnn_grid_start(jcfg, keys, data_batch=None, data=None):
    """ptnn's per-cell initial states (``init_one`` of ptnn/sweeps.py),
    the cells flattened onto the chain axis, as the port's ``ChainState``;
    the swap counters stay one a cell."""
    if data_batch is None:
        st = jax.vmap(lambda k: jkernel.init_state(
            jax.random.split(k)[0], jcfg, data))(keys)
    else:
        axes = jkernel.Dataset(
            x_train=0, y_train=0, t_train=0, x_test=0, y_test=0,
            mask_train=None if data_batch.mask_train is None else 0,
            mask_test=None if data_batch.mask_test is None else 0,
            class_mask=None if data_batch.class_mask is None else 0,
            w_mask=None if data_batch.w_mask is None else 0)
        st = jax.vmap(lambda d, k: jkernel.init_state(
            jax.random.split(k)[0], jcfg, d), in_axes=(axes, 0))(
                data_batch, keys)
    flat = {}
    for k, v in _np_tree(st).items():
        if v is not None and v.ndim >= 2:
            v = v.reshape((-1,) + v.shape[2:])
        flat[k] = v
    return convert.chain_state_from_numpy(flat)


def ptnn_grid_noise(keys):
    """The per-step noise contract at the grid's chain count, filled with
    ptnn's per-cell draws: cell k's step i keys are ``split(fold_in(
    split(key_k)[1], i), 6)``."""
    k_runs = [jax.random.split(k)[1] for k in keys]

    def one(key, c, w):
        kp, kl, ke, ku, ks, _ksu = jax.random.split(key, 6)
        return dict(w=jax.random.normal(kp, (c, w), jnp.float32),
                    l=jax.random.uniform(kl, (c,)),
                    eta=jax.random.normal(ke, (c,)),
                    u=jax.random.uniform(ku, (c,)),
                    u_swap=jax.random.uniform(ks, (c - 1,), jnp.float32))

    @functools.lru_cache(maxsize=None)
    def draws(cpc, w):
        step = jax.vmap(lambda kr, i: one(jax.random.fold_in(kr, i), cpc, w),
                        in_axes=(None, 0))
        return jax.jit(jax.vmap(step, in_axes=(0, None)))

    def noise_fn(start, length, c, w):
        cpc = c // len(k_runs)
        idx = start + jnp.arange(length)
        out = draws(cpc, w)(jnp.stack(k_runs), idx)
        parts = [{k: np.array(v[g]) for k, v in out.items()}
                 for g in range(len(k_runs))]
        out = {}
        for name in parts[0]:
            if name == "u_swap":
                fill = np.ones((length, 1), np.float32)
                cols = []
                for p in parts:
                    cols += [p[name], fill]
                out[name] = np.concatenate(cols[:-1], axis=1)
            else:
                out[name] = np.concatenate([p[name] for p in parts], axis=1)
        return {k: torch.from_numpy(v) for k, v in out.items()}

    return noise_fn


def ptnn_reg_batch(jcfg, names, modes):
    """ptnn's padded, stacked regression cells (ptnn/sweeps.py
    ``dataset_grid``)."""
    probs = [load_regression(n) for n in names]
    n_tr = max(p.train.shape[0] for p in probs)
    n_te = max(p.test.shape[0] for p in probs)

    def pad(a, n):
        return jnp.pad(a, ((0, n - a.shape[0]),) + ((0, 0),) * (a.ndim - 1))

    def mask(a, n):
        return jnp.pad(jnp.ones((a.shape[0],), jnp.float32),
                       (0, n - a.shape[0]))

    cells = []
    for p in probs:
        d = jmake_dataset(jcfg, p.train, p.test)
        cells.append(jkernel.Dataset(
            x_train=pad(d.x_train, n_tr), y_train=pad(d.y_train, n_tr),
            t_train=pad(d.t_train, n_tr), x_test=pad(d.x_test, n_te),
            y_test=pad(d.y_test, n_te), mask_train=mask(d.x_train, n_tr),
            mask_test=mask(d.x_test, n_te)))
    order = [names.index(n) for n in names for _m in modes]
    return jax.tree_util.tree_map(lambda *l: jnp.stack(l),
                                  *[cells[i] for i in order])


def ptnn_cls_batch(jcfg, names, seeds):
    """ptnn's envelope-padded, stacked classification cells (ptnn/
    sweeps.py ``classification_grid``; ``jcfg.topology`` the envelope)."""
    probs = [load_classification(n, seed=0) for n in names]
    env = jcfg.topology
    n_tr = max(p.train.shape[0] for p in probs)
    n_te = max(p.test.shape[0] for p in probs)

    def pad(a, n, cols=None):
        spec = [(0, n - a.shape[0])]
        if a.ndim > 1:
            spec.append((0, 0) if cols is None else (0, cols - a.shape[1]))
        return jnp.pad(a, spec)

    def rmask(a, n):
        return jnp.pad(jnp.ones((a.shape[0],), jnp.float32),
                       (0, n - a.shape[0]))

    cells = []
    for p in probs:
        d = jmake_dataset(dataclasses.replace(jcfg, topology=p.topology),
                          p.train, p.test)
        cm = np.zeros(env[2], np.float32)
        cm[:p.topology[2]] = 1.0
        cells.append(jkernel.Dataset(
            x_train=pad(d.x_train, n_tr, env[0]), y_train=pad(d.y_train, n_tr),
            t_train=pad(d.t_train, n_tr, env[2]),
            x_test=pad(d.x_test, n_te, env[0]), y_test=pad(d.y_test, n_te),
            mask_train=rmask(d.x_train, n_tr), mask_test=rmask(d.x_test, n_te),
            class_mask=jnp.asarray(cm),
            w_mask=jnp.asarray(jsweeps.envelope_w_mask(p.topology, env))))
    order = [names.index(n) for n in names for _s in seeds]
    return jax.tree_util.tree_map(lambda *l: jnp.stack(l),
                                  *[cells[i] for i in order])


def assert_grids_match(got, ref):
    """Accept and swap percentages equal, the statistics within
    tolerance."""
    np.testing.assert_array_equal(got["accept_pct"], ref["accept_pct"])
    np.testing.assert_array_equal(got["swap_pct"], ref["swap_pct"])
    for k in STATS:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _reg_cfg(samples=4 * 40, chains=4, **kw):
    base = dict(num_samples=samples, num_chains=chains, maxtemp=5.0)
    cfgs = (ptnn.regression_preset(**base), ptnn_torch.regression_preset(
        **base))
    # drift_unroll 1: ptnn's scan of the epoch compiles in a fraction of
    # the time, and the rows update in the same order
    kw = dict(swap_interval=10, chunk_steps=100, drift_unroll=1, **kw)
    return tuple(dataclasses.replace(c, **kw).validate() for c in cfgs)


def _cls_cfgs(legacy, samples=4 * 40, chains=4, **kw):
    cfgs = (ptnn.classification_preset((1, 1, 1), num_samples=samples,
                                       num_chains=chains, legacy_lg=legacy),
            ptnn_torch.classification_preset(
                (1, 1, 1), num_samples=samples, num_chains=chains,
                legacy_lg=legacy))
    kw = dict(swap_interval=10, chunk_steps=100, drift_unroll=1, **kw)
    return tuple(dataclasses.replace(c, **kw) for c in cfgs)


def test_dataset_grid_matches_ptnn():
    """Sunspot (298 rows) and ACFinance (238, padded to 298) x RW,
    LG-0.01, LG-0.1 at 4 chains x 40 samples: six cells, one run."""
    jcfg, tcfg = _reg_cfg()
    names, modes = ["Sunspot", "ACFinance"], ("rw", "lg001", "lg01")
    ref = jsweeps.dataset_grid(jcfg, names, modes=modes, seed=3)
    keys = jax.random.split(jax.random.PRNGKey(3), len(names) * len(modes))
    jg = dataclasses.replace(jcfg, use_langevin_gradients=True)
    start = ptnn_grid_start(jg, keys, ptnn_reg_batch(jg, names, modes))
    got = sweeps.dataset_grid(tcfg, names, modes=modes, seed=3, device="cpu",
                              init_state=start, noise_fn=ptnn_grid_noise(keys))
    assert got["cells"] == ref["cells"]
    assert_grids_match(got, ref)
    assert (got["swap_pct"] > 0).all()


@pytest.mark.parametrize("legacy", [False, True], ids=["rw", "legacy_lg"])
def test_classification_grid_matches_ptnn(legacy):
    """iris (4, 12, 3) and Cancer (9, 12, 2) in the (9, 12, 3) envelope x
    seeds (0, 1), RW and legacy LG: the padded parameters stay 0."""
    # no temper switch (the regression grid holds it): one compile of
    # ptnn's scan
    jcfg, tcfg = _cls_cfgs(legacy, samples=4 * 30, pt_phase_frac=2.0)
    names, seeds = ["iris", "Cancer"], (0, 1)
    ref = jsweeps.classification_grid(jcfg, names, seeds=seeds)
    env = (9, 12, 3)
    je = dataclasses.replace(jcfg, topology=env, record_w=False).validate()
    keys = jnp.stack([jax.random.PRNGKey(s) for _n in names for s in seeds])
    start = ptnn_grid_start(je, keys, ptnn_cls_batch(je, names, seeds))
    got = sweeps.classification_grid(tcfg, names, seeds=seeds, device="cpu",
                                     init_state=start,
                                     noise_fn=ptnn_grid_noise(keys))
    assert got["cells"] == ref["cells"]
    assert_grids_match(got, ref)


@pytest.mark.parametrize("sweep", ["seed", "maxtemp", "swap_interval",
                                   "lprob"])
def test_hyperparameter_sweeps_match_ptnn(sweep):
    """Cells on one shared dataset (Sunspot): seeds, ladders, intervals
    (one cell never swaps) and Langevin probabilities as per-cell values."""
    prob = load_regression("Sunspot")
    lg = sweep == "lprob"
    # no temper switch: one chunk, one compile of ptnn's scan
    jcfg, tcfg = _reg_cfg(samples=4 * 24, use_langevin_gradients=lg,
                          pt_phase_frac=2.0)
    args = dict(seed=[0, 5], maxtemp=[2.0, 5.0, 8.0],
                swap_interval=[5, 0, 13], lprob=[0.2, 0.8])[sweep]
    jfn = getattr(jsweeps, f"{sweep}_sweep")
    tfn = getattr(sweeps, f"{sweep}_sweep")
    if sweep == "seed":
        keys = jnp.stack([jax.random.PRNGKey(s) for s in args])
        ref = jfn(jcfg, args, prob.train, prob.test)
        kw = {}
    else:
        keys = jax.random.split(jax.random.PRNGKey(1), len(args))
        ref = jfn(jcfg, args, prob.train, prob.test, seed=1)
        kw = dict(seed=1)
    jg = dataclasses.replace(jcfg, use_langevin_gradients=lg or
                             jcfg.use_langevin_gradients)
    start = ptnn_grid_start(jg, keys, data=jmake_dataset(jg, prob.train,
                                                         prob.test))
    got = tfn(tcfg, args, prob.train, prob.test, device="cpu",
              init_state=start, noise_fn=ptnn_grid_noise(keys), **kw)
    assert_grids_match(got, ref)
    if sweep == "swap_interval":
        assert got["swap_pct"][1] == 0.0 and got["swap_pct"][0] > 0


def test_grid_cell_is_its_own_single_run():
    """The Sunspot lg01 cell of a dataset grid against the port's single
    per-step run of that cell's seed at lg01's probability and rate: the
    same draws (``sampler.grid_noise``, ``init_grid``), the same accept
    count, the same statistics."""
    _jcfg, tcfg = _reg_cfg(samples=4 * 30)
    names, modes = ["Sunspot", "ACFinance"], ("rw", "lg01")
    got = sweeps.dataset_grid(tcfg, names, modes=modes, seed=7, device="cpu")
    k = got["cells"].index(("Sunspot", "lg01"))
    seed = sweeps.cell_seeds(7, len(got["cells"]))[k]
    lp, lr = sweeps.REGRESSION_MODES["lg01"]
    one = dataclasses.replace(tcfg, use_langevin_gradients=True,
                              langevin_prob=lp, learn_rate=lr).validate()
    prob = load_regression("Sunspot")
    res = ptnn_torch.sample(one, prob.train, prob.test, seed=seed,
                            device="cpu")
    assert got["accept_pct"][k] == pytest.approx(
        float(np.mean(res.accept_ratio_per_chain)), abs=1e-9)
    assert got["swap_pct"][k] == pytest.approx(res.swap_percent, abs=1e-9)
    burn = int(one.samples_per_chain * one.burn_in)
    kept = res.traces["rmse_test"][burn:]
    np.testing.assert_allclose(got["test_mean"][k], kept.mean(), rtol=RTOL)
    np.testing.assert_allclose(got["test_best"][k], kept.min(), rtol=RTOL)


def test_grid_refuses_what_ptnn_refuses():
    """A padded grid under another proposal raises ptnn's "reference
    proposal" error (tests/test_cls_grid.py), as do a parameter mask on
    regression and the Pallas drift on masked rows; a grid feature the
    port has not ported raises NotImplementedError naming it."""
    _j, tcfg = _cls_cfgs(False)
    bad = dataclasses.replace(tcfg, proposal="precond_rw")
    with pytest.raises(ValueError, match="reference proposal"):
        sweeps.classification_grid(bad, ["iris", "Cancer"], seeds=[0],
                                   device="cpu")
    _j, reg = _reg_cfg(drift_mode="pallas")
    with pytest.raises(ValueError, match="no row/parameter-mask support"):
        sweeps.dataset_grid(reg, ["Sunspot", "ACFinance"], modes=("rw",),
                            device="cpu")
    prob = load_regression("Sunspot")
    _j, reg = _reg_cfg()
    data = sampler.make_grid_dataset(
        reg, [(prob.train, prob.test, (4, 10, 1))], "cpu")
    data.w_mask = torch.ones((1, 61))
    temps = torch.ones(4)
    with pytest.raises(ValueError, match="parameter masks target"):
        kernel.make_step_fn(reg, data, temps)
    with pytest.raises(NotImplementedError, match="proposal='hmc'"):
        sweeps.seed_sweep(dataclasses.replace(reg, proposal="hmc",
                                              use_langevin_gradients=False),
                          [0, 1], prob.train, prob.test, device="cpu")


def _band_run(kind, seeds):
    """ptnn's grid at the chip smoke's configuration: regression, one run a
    seed (each cell its own key); classification, one run whose cells are
    the sets x ``seeds`` (each a replicate of its set)."""
    import time

    for seed in (seeds if kind == "regression" else [None]):
        t0 = time.time()
        if kind == "regression":
            cfg = dataclasses.replace(
                ptnn.regression_preset(num_samples=REG_SAMPLES, maxtemp=5.0,
                                       num_chains=10, swap_ratio=0.01),
                chunk_steps=1000)
            out = jsweeps.dataset_grid(cfg, list(REG_NAMES), seed=seed)
        else:
            cfg = dataclasses.replace(
                ptnn.classification_preset((1, 1, 1), num_samples=CLS_SAMPLES,
                                           legacy_lg=kind == "cls-lg"),
                chunk_steps=500, drift_mode="sequential")
            out = jsweeps.classification_grid(cfg, list(CLS_SMALL),
                                              seeds=seeds)
        yield {"kind": kind, "seed": seed, "wall_s": time.time() - t0,
               "cells": [list(map(str, c)) for c in out["cells"]],
               **{k: np.asarray(out[k]).tolist()
                  for k in ("test_mean", "accept_pct", "swap_pct")}}


if __name__ == "__main__":
    for line in _band_run(sys.argv[1], [int(s) for s in sys.argv[2:]]):
        print(json.dumps(line), flush=True)
