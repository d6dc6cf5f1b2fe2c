"""The MALA and HMC/ChEES blocks at every FNN topology ptnn fuses.

* Gate parity: ``ptnn_torch.fused.runtime_reason`` admits a fused MALA /
  HMC config exactly where ``ptnn.fused.runtime_reason(..., record_w=True)``
  does (the check ptnn's ``sample_fused`` runs), for every bundled
  classification set at its own network and at the one ``auto`` infers
  (hidden = max(10, n_in)), and for Sunspot at (4, H, 1), H in {2, 6, 10,
  20, 32, 64}; ChEES on and off, ``record_w`` True and False.
* Plans: the launch plans (pure Python) lay out every config the grid
  admits: a fixed-shape route for the instantiated networks, the generic
  route (``precond_step.gen_layout``) for the others, inside a Hopper
  block's shared memory.
* The plain versions against ptnn's Pallas kernels in interpret mode, at
  the widths the generic routes run: the classification MALA and HMC
  blocks at Cancer's (9, 12, 2) and the regression ones at (5, 20, 1), on
  seeded numpy inputs; counts exact, floats within rtol 5e-4, atol 5e-5
  (tests/test_pallas_step.py's tolerances for the gradient blocks).
* A fused run on Cancer's rows (8 chains x 40 steps, MALA and ChEES)
  against ``ptnn.fused.sample_fused`` on ptnn's initial state and noise:
  accept and swap counts and replicas exactly equal.

``python tests/test_torch_precond_widths.py ARM [fused] SEED...`` runs
ptnn's per-step sampler (with ``fused``, its fused sampler) on the CPU at
``chip_smoke.py``'s configurations of the generic routes (ARM:
cancer-mala, cancer-chees, sunspot20-mala, sunspot20-chees; 64 chains x
4000 steps), one JSON line a seed: the bands' reference.
"""

import dataclasses
import functools
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import fused as jfused
from ptnn.data import CLASSIFICATION_TOPOLOGIES
from ptnn.data import load as jload
from ptnn.ops import pallas_step as ps
from ptnn_torch import fused as tfused
from ptnn_torch.auto import infer_topology
from ptnn_torch.models import fnn
from ptnn_torch.ops import (block_step, likelihood, precond_cls_step,
                            precond_step)
from test_torch_cls_step import _assert_match as _cls_assert_match
from test_torch_cls_step import _data as _cls_data
from test_torch_cls_step import _noise as _cls_noise
from test_torch_cls_step import _precond_scal
from test_torch_cls_step import _run_port as _cls_run_port
from test_torch_cls_step import _run_ptnn as _cls_run_ptnn
from test_torch_cls_step import _state as _cls_state
from test_torch_cls_step import _temps
from test_torch_fused_driver import _assert_runs_match, _cls_kw, _run_both

torch.set_num_threads(1)

RTOL, ATOL = 5e-4, 5e-5
K = 12  # the block length of the plain-versus-Pallas cases
HIDDEN = (2, 6, 10, 20, 32, 64)  # Sunspot (4, H, 1)
CANCER = (9, 12, 2)
SMEM = precond_step._SMEM_LIMIT
PROPOSALS = [("precond_mala", False), ("hmc", False), ("hmc", True)]


@functools.lru_cache(maxsize=None)
def _rows(name):
    """(n_tr, n_te, n_in, n_out) of a bundled set, from ptnn's loader."""
    prob = jload(name)
    topo = infer_topology(prob.train, prob.test,
                          "regression" if name == "Sunspot"
                          else "classification", None)
    return prob.train.shape[0], prob.test.shape[0], topo[0], topo[2]


def _grid():
    """(set, topology) of the parity grid: each classification set at its
    own network and at auto's, Sunspot at (4, H, 1)."""
    out = []
    for name, topo in CLASSIFICATION_TOPOLOGIES.items():
        _tr, _te, n_in, n_out = _rows(name)
        auto = (n_in, max(10, n_in), n_out)
        out += [(name, tuple(topo))] + ([(name, auto)] if auto != topo
                                        else [])
    return out + [("Sunspot", (4, h, 1)) for h in HIDDEN]


def _kw(topo, proposal, chees, record_w, chains=64):
    """bench.py's 16 x 4 ensemble shape at ``topo`` (``_cls_variants`` /
    the regression mala_fused_16x4 and chees16_fused_16x4)."""
    kw = dict(task="classification" if topo[2] > 1 else "regression",
              topology=topo, num_samples=chains * 100, num_chains=chains,
              maxtemp=5.0, proposal=proposal, n_ladders=chains // 4,
              adapt_rate=0.1, swap_style="even_odd", swap_interval=10,
              warmstart_frac=0.1, precond_start_frac=0.3, record_w=record_w,
              record_w_chains=chains // 4 if record_w else 0,
              track_replicas=True, fused_step=True)
    if proposal == "hmc":
        kw.update(hmc_leapfrog=16, hmc_adapt_traj=chees, step_w=0.01)
    return kw


@pytest.mark.parametrize("record_w", [True, False])
@pytest.mark.parametrize("proposal, chees", PROPOSALS)
def test_gate_admits_exactly_what_ptnn_fuses(proposal, chees, record_w):
    admitted = refused = 0
    for name, topo in _grid():
        n_tr, n_te, _i, _o = _rows(name)
        kw = _kw(topo, proposal, chees, record_w)
        jcfg = ptnn.PTConfig(**kw).validate()
        tcfg = ptnn_torch.PTConfig(**kw).validate()
        x_tr, x_te = np.zeros((n_tr, 1)), np.zeros((n_te, 1))
        want = jfused.runtime_reason(jcfg, x_tr, x_te, record_w=True)
        got = tfused.runtime_reason(tcfg, n_tr, n_te)
        assert (got is None) == (want is None), (name, topo, got, want)
        if got is None:
            admitted += 1
        else:
            refused += 1
            assert "VMEM budget" in got, (name, topo, got)
    # iris, Cancer and TicTac at auto's network, and Sunspot's H <= 64,
    # fuse; Ionosphere, TicTac (9, 25, 2) and the large sets do not
    assert admitted == 5 + len(HIDDEN) and refused > 10


def _fake_card(smem_per_sm=233472, sms=132, warps_per_sm=64):
    """Occupancy of an H100-like card for the pure-Python plans: blocks an
    SM by shared memory (one block an SM past half of it) and warps."""
    def blocks_per_sm(threads, smem):
        return max(0, min(smem_per_sm // max(smem, 1),
                          warps_per_sm // (threads // 32)))

    def fits(threads, smem, cluster):
        return sms * blocks_per_sm(threads, smem) // cluster

    def coop(threads, smem):
        return sms * blocks_per_sm(threads, smem)

    return fits, coop


@pytest.mark.parametrize("chains", [64, 256, 1024])
def test_plans_fit_every_admitted_topology(chains):
    fits, coop = _fake_card()
    seen = set()
    for name, topo in _grid():
        n_tr, n_te, _i, _o = _rows(name)
        rows = n_tr + n_te
        for proposal, chees in PROPOSALS:
            cfg = ptnn_torch.PTConfig(**_kw(topo, proposal, chees, True,
                                            chains)).validate()
            if tfused.runtime_reason(cfg, n_tr, n_te) is not None:
                continue
            cls = topo[2] > 1
            fixed = topo in (precond_cls_step.TOPOLOGIES if cls
                             else precond_step.TOPOLOGIES)
            panel = (precond_step.panel_layout(chains, 4)[0] if chees
                     else 0)
            if proposal == "precond_mala":
                plan = (precond_cls_step.mala_launch_plan(chains, rows, topo,
                                                          132) if cls else
                        precond_step.mala_launch_plan(chains, rows, 132,
                                                      topo))
            elif fixed and cls:
                plan = precond_cls_step.launch_plan(
                    chains, panel, rows, topo,
                    fits=lambda wpc, s, c: fits(256, s, c),
                    coop=lambda wpc, s: coop(256, s))
            elif fixed:
                continue  # the (4, 10, 1) HMC kernel: hmc_layout's rule
            else:
                plan = precond_step.gen_hmc_plan(chains, panel, rows, topo,
                                                 132, fits, coop)
            assert plan.variant == ("fixed" if fixed else "generic")
            assert plan.smem <= SMEM, (name, topo, plan)
            assert plan.per_block * plan.blocks >= chains
            assert plan.per_block * plan.wpc <= plan.warps
            if chees:
                assert plan.route in ("cluster", "grid")
            if not fixed:
                lay = precond_step.gen_layout(
                    "hmc" if proposal == "hmc" else "mala", rows, topo)
                assert (plan.warps, plan.vectors) == (lay.warps, lay.vectors)
                seen.add((name, topo, lay.vectors))
    # Cancer's networks keep their vectors in shared memory; Sunspot's
    # widest in device memory
    assert ("Cancer", CANCER, "shared") in seen
    assert ("Sunspot", (4, 64, 1), "device") in seen


def test_gen_layout_gives_up_only_where_one_warp_does_not_fit():
    lay = precond_step.gen_layout("hmc", 496, (4, 64, 1))
    assert lay.vectors == "device" and lay.smem <= SMEM
    assert precond_step.gen_layout("mala", 699, CANCER) == (
        8, "shared", precond_step.gen_smem_bytes(699, CANCER, "mala", 8,
                                                 "shared"))
    # rows that alone pass a block's shared memory
    with pytest.raises(ValueError, match="no Hopper plan"):
        precond_step.gen_layout("mala", 60_000, CANCER)
    cfg = ptnn_torch.PTConfig(**_kw(CANCER, "precond_mala", False,
                                    True)).validate()
    # ptnn's gate refuses such rows first; the plan's reason stands behind it
    assert "VMEM budget" in tfused.working_set_reason(cfg, 59_000, 1000)
    assert tfused.working_set_reason(cfg, 489, 210) is None


# --- the plain versions against Pallas at the generic routes' widths ------


@pytest.mark.parametrize("kind, chees", [("mala", False), ("hmc", False),
                                         ("hmc", True)])
def test_cls_blocks_match_pallas_at_cancer_width(rng, kind, chees):
    c = 6  # 2 ladders of 3 rungs: one panel
    data = _cls_data(rng, ntr=41, nte=19, topo=CANCER)
    step = 1.0 if kind == "mala" else 0.5
    state = _cls_state(rng, c, data, step, precond=True, chees=chees,
                       topo=CANCER)
    noise = _cls_noise(rng, c, hmc=kind == "hmc", w=fnn.w_size(CANCER))
    at = _temps(c, 3)
    start, length = 2, 11  # crosses warm_end 5, pc_start 8, burn_end 11
    scal = _precond_scal(hmc=kind == "hmc", chees=chees)
    ref = _cls_run_ptnn(kind, data, state, noise, at, start, length, scal,
                        True, topo=CANCER)
    got = _cls_run_port(kind, data, state, noise, at, start, length, scal,
                        True, topo=CANCER)
    na = got[0]["n_accept"]
    assert 3 * c <= na.sum() < length * c, na  # forced warm accepts + rejects
    _cls_assert_match(got, ref, length, RTOL, ATOL)
    if chees:
        tl = got[1]["traj_len"][:length]
        assert len(np.unique(tl)) > 1


REG = (5, 20, 1)


def _reg_inputs(rng, c, topo, hmc, chees, step):
    """Numpy data, state (the true ll, prior and g_like at (w, eta)), noise
    and temperatures (three rungs) at the regression network ``topo``."""
    n_in, w_size = topo[0], fnn.w_size(topo)
    x_tr = rng.normal(size=(37, n_in)).astype(np.float32)
    y_tr = rng.normal(size=(37,)).astype(np.float32)
    x_te = rng.normal(size=(23, n_in)).astype(np.float32)
    y_te = rng.normal(size=(23,)).astype(np.float32)
    w = (rng.normal(size=(c, w_size)) * 0.5).astype(np.float32)
    eta = (rng.normal(size=(c,)) * 0.3).astype(np.float32)
    tw, teta = torch.from_numpy(w), torch.from_numpy(eta)
    fx = fnn.batched_forward(tw, torch.from_numpy(x_tr), topo)[:, :, 0]
    tau = torch.exp(teta)
    ll = likelihood.regression_eval_from_fx(fx, torch.from_numpy(y_tr), tau)
    prior = likelihood.regression_log_prior(tw, tau, topo)
    g_like = fnn.neg_half_sse_grad(tw, torch.from_numpy(x_tr),
                                   torch.from_numpy(y_tr), topo)[1]
    z = lambda: np.zeros(c, np.float32)
    state = dict(
        w=w, w_last=np.ones_like(w), g_like=g_like.numpy(),
        pc_mean=np.zeros_like(w), pc_m2=np.zeros_like(w), eta=eta,
        ll=ll.loglik.numpy(), prior=prior.numpy(), rmse_train=z(),
        rmse_test=z(), n_accept=np.zeros(c, np.int32),
        log_step_w=np.full(c, math.log(step), np.float32),
        log_step_eta=np.full(c, math.log(0.2), np.float32))
    if chees:
        state.update(log_traj=np.full(c, math.log(2 * step), np.float32),
                     chees_m1=z(), chees_v2=z())
    f = lambda a: np.asarray(a, np.float32)
    noise = dict(w=f(rng.normal(size=(K, c, w_size))),
                 eta=f(rng.normal(size=(K, c))),
                 u=f(rng.uniform(size=(K, c))),
                 u_eta=f(rng.uniform(size=(K, c))))
    if hmc:
        noise["u_jit"] = f(rng.uniform(size=(K, c)))
        noise["u_traj"] = f(rng.uniform(size=(K,)))
    return (x_tr, y_tr, x_te, y_te), state, noise, _temps(c, 3)


def _reg_run_ptnn(hmc, data, state, noise, at, start, length, scal, topo):
    """ptnn's regression MALA / HMC kernel in interpret mode on its padded
    (P, C) planes."""
    c, w_size = state["w"].shape
    lanes = ps.LANES
    c_pad, p_pad = -(-c // lanes) * lanes, -(-w_size // 8) * 8

    def pc(a):
        out = np.zeros((p_pad, c_pad), a.dtype)
        out[:w_size, :c] = a.T
        return jnp.asarray(out)

    def c1(a, fill=0):
        out = np.full((1, c_pad), fill, a.dtype)
        out[0, :c] = a
        return jnp.asarray(out)

    def kc(a, fill=1.0):
        out = np.full((K, c_pad), fill, np.float32)
        out[:, :c] = a
        return jnp.asarray(out)

    jstate = {k: (pc(v) if v.ndim == 2 else c1(v)) for k, v in state.items()}
    if hmc and "log_traj" not in state:
        for k in ("log_traj", "chees_m1", "chees_v2"):
            jstate[k] = c1(np.zeros(c, np.float32))
    nw = np.zeros((K, p_pad, c_pad), np.float32)
    nw[:, :w_size, :c] = noise["w"].transpose(0, 2, 1)
    args = [jnp.asarray(nw), kc(noise["eta"], 0.0), kc(noise["u"]),
            kc(noise["u_eta"])]
    jdata = ps.prep_data(*[jnp.asarray(a) for a in data])
    if hmc:
        ut = np.broadcast_to(noise["u_traj"][:, None], (K, c_pad))
        rs = (ps.rung_sum_matrix(c, scal["rungs"], c_pad) if scal["chees"]
              else jnp.zeros((lanes, lanes), jnp.float32))
        new, tr = ps.fused_hmc_block_impl(
            jstate, *args, kc(noise["u_jit"]), jnp.asarray(ut), rs, start,
            length, jdata, c1(at, 1.0), topo, scal, record_w=True,
            interpret=True)
    else:
        new, tr = ps.fused_mala_block_impl(
            jstate, *args, start, length, jdata, c1(at, 1.0), topo, scal,
            record_w=True, interpret=True)
    out_state = {}
    for k in state:
        v = np.asarray(new[k])
        out_state[k] = v[:w_size, :c].T if state[k].ndim == 2 else v[0, :c]
    out_tr = {k: np.asarray(v)[:, :c] for k, v in tr.items() if k != "w"}
    out_tr["w"] = np.asarray(tr["w"])[:, :w_size, :c].transpose(0, 2, 1)
    return out_state, out_tr


def _reg_run_port(hmc, data, state, noise, at, start, length, scal, topo):
    t = lambda a: torch.from_numpy(np.array(a))
    fn = (precond_step.hmc_block_reference if hmc
          else precond_step.mala_block_reference)
    new, tr = fn({k: t(v) for k, v in state.items()},
                 {k: t(v) for k, v in noise.items()}, start, length,
                 block_step.prep_data(*map(t, data)), t(at), topo, scal,
                 record_w=True)
    return ({k: v.numpy() for k, v in new.items()},
            {k: v.numpy() for k, v in tr.items()})


@pytest.mark.parametrize("kind, chees", [("mala", False), ("hmc", False),
                                         ("hmc", True)])
def test_reg_blocks_match_pallas_at_width_20(rng, kind, chees):
    c, hmc = 6, kind == "hmc"
    data, state, noise, at = _reg_inputs(rng, c, REG, hmc, chees,
                                         0.5 if hmc else 0.6)
    start, length = 2, 11
    scal = _precond_scal(hmc=hmc, chees=chees)
    ref = _reg_run_ptnn(hmc, data, state, noise, at, start, length, scal, REG)
    got = _reg_run_port(hmc, data, state, noise, at, start, length, scal, REG)
    (gs, gt), (rs, rt) = got, ref
    na = gs["n_accept"]
    assert 3 * c <= na.sum() < length * c, na
    assert set(gs) == set(rs)
    np.testing.assert_array_equal(gs["n_accept"], rs["n_accept"])
    np.testing.assert_array_equal(gt["accept_count"], rt["accept_count"])
    for k in gs:
        if k != "n_accept":
            np.testing.assert_allclose(gs[k], rs[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    for k in ("ll", "rmse_train", "rmse_test", "w"):
        np.testing.assert_allclose(gt[k], rt[k], rtol=RTOL, atol=ATOL,
                                   err_msg="trace " + k)
    if hmc:
        np.testing.assert_array_equal(gt["traj_len"][:length],
                                      rt["traj_len"][:length])
        if chees:
            assert len(np.unique(gt["traj_len"][:length])) > 1


# --- a fused run on Cancer's rows ------------------------------------------


@pytest.mark.parametrize("proposal", ["precond_mala", "chees"])
def test_cancer_sample_fused_matches_ptnn(proposal):
    """The port's fused sampler on Cancer (9, 12, 2), 8 chains x 40 steps
    (plain block versions on the CPU) against ptnn's (Pallas interpret), on
    ptnn's initial state and noise: the test of
    test_torch_fused_driver.py's iris runs, at the width the generic route
    takes on the card."""
    if proposal == "chees":
        kw = _cls_kw(topology=CANCER, proposal="hmc", hmc_leapfrog=4,
                     hmc_adapt_traj=True, step_w=0.05, warmstart_frac=0.1,
                     precond_start_frac=0.3)
    else:
        kw = _cls_kw(topology=CANCER, proposal="precond_mala", step_w=0.3,
                     warmstart_frac=0.1, precond_start_frac=0.3)
    prob = ptnn.data.load_classification("Cancer")
    tcfg = ptnn_torch.PTConfig(**kw).validate()
    assert tfused.runtime_reason(tcfg, *map(len, (prob.train,
                                                  prob.test))) is None
    got, ref = _run_both(kw, seed=4, prob=prob)
    state_floats = ("log_step_w", "pc_mean", "pc_m2")
    if proposal == "chees":
        state_floats += ("log_traj", "chees_m1", "chees_v2")
        tl = got.traces["traj_len"][1:]
        assert tl.min() >= 1 and tl.max() <= 4 and len(np.unique(tl)) > 1
    assert got.traces["w"].shape == (40, 2, fnn.w_size(CANCER))
    _assert_runs_match(got, ref, RTOL, ATOL, state_floats, ll_terms=0.0)
    acc = got.accept_ratio_per_chain
    assert acc.min() < 100.0 and acc.max() > 0.0


# --- the bands' reference ---------------------------------------------------


def reference_cfg(arm: str, samples: int = 4000):
    """ptnn's per-step twin of chip_smoke.py's generic-route arm ``arm``:
    bench.py's _cls_variants at Cancer's (9, 12, 2) (cancer-mala,
    cancer-chees: mala_fused_16x4, chees16_fused_16x4) or the regression
    mala_fused_16x4 / chees16_fused_16x4 shape on Sunspot at (4, 20, 1)
    (sunspot20-*), 64 chains x ``samples``, fused_step False; and the
    problem."""
    where, prop = arm.split("-")
    chees = prop == "chees"
    if where == "cancer":
        import bench

        cfg = bench._cls_variants(CANCER, samples)[
            "chees16_fused_16x4" if chees else "mala_fused_16x4"]
        prob = ptnn.data.load_classification("Cancer")
    else:
        kw = _kw((4, 20, 1), "hmc" if chees else "precond_mala", chees,
                 False)
        kw.update(num_samples=64 * samples, swap_payload="tempered_times_T",
                  swap_offset=0)
        cfg = ptnn.PTConfig(**kw)
        prob = ptnn.data.load_regression("Sunspot")
    return dataclasses.replace(cfg, fused_step=False).validate(), prob


def reference_stats(arm: str, seed: int, samples: int = 4000,
                    fused: bool = False) -> dict:
    """One seed of ptnn's per-step sampler (``fused``: its fused sampler)
    at ``reference_cfg(arm)``: the cold rungs' mean test accuracy (or RMSE)
    over the second half, mean accept %, swap % and round trips per ladder
    per 1k steps."""
    from ptnn.ops import roundtrip

    cfg, prob = reference_cfg(arm, samples)
    if fused:
        cfg = dataclasses.replace(cfg, fused_step=True).validate()
        res = jfused.sample_fused(cfg, prob.train, prob.test, seed=seed)
    else:
        res = ptnn.sample(cfg, prob.train, prob.test, seed=seed)
    s = cfg.samples_per_chain
    cold = np.arange(0, cfg.num_chains, cfg.rungs_per_ladder)
    key = "acc_test" if cfg.task == "classification" else "rmse_test"
    rt = roundtrip.roundtrip_stats(np.asarray(res.traces["replica"]),
                                   n_ladders=cfg.n_ladders)
    return dict(arm=arm, fused=fused, seed=seed,
                metric=float(np.mean(np.asarray(res.traces[key])[s // 2:,
                                                                  cold])),
                accept=float(np.mean(res.accept_ratio_per_chain)),
                swap=float(res.swap_percent),
                trips=float(rt.rate_per_kstep / cfg.n_ladders))


if __name__ == "__main__":
    # PYTHONPATH=.:tests JAX_PLATFORMS=cpu python
    # tests/test_torch_precond_widths.py ARM [fused] SEED...
    import sys

    fused = sys.argv[2:3] == ["fused"]
    for s in sys.argv[2 + fused:]:
        print(json.dumps(reference_stats(sys.argv[1], int(s), fused=fused)),
              flush=True)
