"""The CUDA block kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/*_block.cu, the
regression kernels on random rows and the classification ones on iris);
without one they skip. Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

Accept counters (and HMC's traj_len) must match on every chain whose
decision margins exceed 1e-5 (at most 1% of chains may fall under them;
under ChEES a chain under a margin takes every replica of its (panel, rung)
with it, since it feeds their rung sums). RW floats within rtol 1e-4, atol
1e-5; MALA/HMC floats within rtol 1e-3, atol 1e-4, vectors on the scale of
the chain's vector, the Adam moment on |m1| + sqrt(v2), and g_like against
the gradient at the kernel's own w (chip_smoke.py states why). ll's rtol
applies to the size of the terms that cancel in it (the plain versions'
``diagnostics=True``). Regression MALA/HMC floats and classification HMC
floats may exceed that tolerance by WITNESS_R times the plain version's own
distance from a float64 run of it on the same inputs, in the same chain
(chip_smoke.py's WITNESS_R).
"""

import math

import numpy as np
import pytest
import torch

import ptnn_torch
import ptnn_torch.data
from ptnn_torch import fused, kernel
from ptnn_torch.models import fnn
from ptnn_torch.models import cnn
from ptnn_torch.ops import (block_step, conv_stage, likelihood,
                            precond_cls_step, precond_step)
from ptnn_torch.sampler import make_dataset

torch.set_num_threads(1)

TOPO = (4, 10, 1)
RTOL, ATOL, MARGIN = 1e-4, 1e-5, 1e-5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    return torch.device("cuda")


def _inputs(device, c, k, adapt, seed=3, topo=TOPO):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    n_in = topo[0]
    x_tr, y_tr = f(rng.normal(size=(37, n_in))), f(rng.uniform(size=37))
    x_te, y_te = f(rng.normal(size=(23, n_in))), f(rng.uniform(size=23))
    w = f(rng.normal(size=(c, fnn.w_size(topo))))
    eta = f(rng.normal(size=c) * 0.3 - 2.0)
    fx = fnn.batched_forward(w, x_tr, topo)[:, :, 0]
    tau = torch.exp(eta)
    state = dict(
        w=w, w_last=torch.ones_like(w), eta=eta,
        ll=likelihood.regression_eval_from_fx(fx, y_tr, tau).loglik,
        prior=likelihood.regression_log_prior(w, tau, topo),
        rmse_train=torch.zeros_like(eta), rmse_test=torch.zeros_like(eta),
        n_accept=torch.zeros(c, dtype=torch.int32, device=device),
        log_step_w=f(math.log(0.025) + 0.2 * rng.normal(size=c)),
    )
    noise = (f(rng.normal(size=(k, c, fnn.w_size(topo)))),
             f(rng.normal(size=(k, c))), f(rng.uniform(size=(k, c))))
    scal = dict(step_w=0.025, step_eta=0.2, sigma_sq=25.0, nu_1=0.0,
                nu_2=0.0, adapt=adapt, adapt_rate=0.1, adapt_target=0.234,
                burn_end=7, task_cls=False)
    data = block_step.prep_data(x_tr, y_tr, x_te, y_te)
    return state, noise, data, f(np.geomspace(1.0, 4.0, c)), scal


@pytest.mark.cuda
@pytest.mark.parametrize("c, topo", [(130, TOPO), (64, TOPO),
                                     (130, (3, 7, 1))])
@pytest.mark.parametrize("adapt", [False, True])
def test_rw_block_kernel_matches_plain_version(cuda, adapt, c, topo):
    """A ragged chain count (4 warps a chain on the H100), the Sunspot
    path's 64 chains (8 warps) with the fixed-shape kernel, and a network
    the repository does not bundle with the generic kernel, which the
    launch must take."""
    k, length = 12, 9  # dead rows at the end
    state, noise, data, at, scal = _inputs(cuda, c, k, adapt, topo=topo)
    args = (state, *noise, 2, length, data, at, topo, scal)
    before = block_step.launches
    kinds = dict(block_step.variant_launches)
    new_k, tr_k = block_step.fused_rw_block(*args, record_w=True)
    assert block_step.launches == before + 1
    taken = [v for v in kinds if block_step.variant_launches[v] != kinds[v]]
    assert taken == [block_step.variant(topo)]
    assert taken == ["fixed" if topo == TOPO else "generic"]
    new_r, tr_r = block_step.rw_block_reference(*args, record_w=True,
                                                diagnostics=True)
    torch.cuda.synchronize()
    ok = tr_r["margin"] > MARGIN
    assert int((~ok).sum()) <= 0.01 * c + 1
    assert torch.equal(new_k["n_accept"][ok], new_r["n_accept"][ok])
    assert torch.equal(tr_k["accept_count"][:, ok], tr_r["accept_count"][:, ok])
    for name in ("w", "w_last", "eta", "prior", "rmse_train", "rmse_test",
                 "log_step_w"):
        torch.testing.assert_close(new_k[name][ok], new_r[name][ok],
                                   rtol=RTOL, atol=ATOL)
    for name in ("rmse_train", "rmse_test", "w"):
        torch.testing.assert_close(tr_k[name][:, ok], tr_r[name][:, ok],
                                   rtol=RTOL, atol=ATOL)
    for got, ref, scale in ((new_k["ll"], new_r["ll"], tr_r["ll_scale_final"]),
                            (tr_k["ll"], tr_r["ll"], tr_r["ll_scale"])):
        diff = (got - ref).abs()[..., ok]
        assert bool((diff <= ATOL + RTOL * scale[..., ok]).all())


@pytest.mark.cuda
def test_rw_block_kernel_rejects_what_it_cannot_take(cuda):
    state, noise, data, at, scal = _inputs(cuda, 8, 4, False)
    with pytest.raises(ValueError, match="dtype"):
        block_step.fused_rw_block(dict(state, eta=state["eta"].double()),
                                  *noise, 0, 4, data, at, TOPO, scal)
    with pytest.raises(ValueError, match="one device type"):
        block_step.fused_rw_block(state, noise[0].cpu(), *noise[1:], 0, 4,
                                  data, at, TOPO, scal)


P_RTOL, P_ATOL = 1e-3, 1e-4
WITNESS_R = 4.0  # the float64 witness of the MALA/HMC comparisons


def _precond_inputs(device, c, proposal, k=12, start=0, seed=5, **kw):
    """A precond state from init_state at N(0, 1) weights on random rows
    (37 train, 23 test), noise, and the block scalars with the warm start
    to 3, the preconditioner from 6 and adaptation to 9."""
    rng = np.random.default_rng(seed)
    kw.setdefault("step_w", 0.1)  # both samplers reject some proposals
    rows = lambda n: np.concatenate(
        [rng.normal(size=(n, 4)), rng.uniform(size=(n, 1))], 1)
    train, test = rows(37), rows(23)
    cfg = ptnn_torch.PTConfig(
        task="regression", topology=TOPO, num_samples=c * 100, num_chains=c,
        proposal=proposal, n_ladders=kw.pop("n_ladders", 1),
        swap_style="even_odd", swap_interval=10, warmstart_frac=0.1,
        precond_start_frac=0.3, adapt_rate=0.1, fused_step=True,
        **kw).validate()
    ds = make_dataset(cfg, train, test, device)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    st = kernel.init_state(cfg, ds, init_w=f(rng.normal(size=(c, 61))))
    state = fused._to_kernel_state(st, cfg)
    noise = dict(w=f(rng.normal(size=(k, c, 61))), eta=f(rng.normal(size=(k, c))),
                 u=f(rng.uniform(size=(k, c))), u_eta=f(rng.uniform(size=(k, c))))
    if proposal == "hmc":
        noise["u_jit"] = f(rng.uniform(size=(k, c)))
        noise["u_traj"] = kernel.vdc_u(torch.arange(start, start + k,
                                                    device=device))
    scal = dict(fused._scalars(cfg), warm_end=3, pc_start=6, burn_end=9)
    data = block_step.prep_data(ds.x_train, ds.y_train, ds.x_test, ds.y_test)
    temps = np.geomspace(1.0, 4.0, cfg.rungs_per_ladder)
    at = f(np.tile(temps, cfg.n_ladders))
    return (state, noise, start, k, data, at, TOPO, scal), cfg


def _upcast(tree):
    return {n: v.double() if torch.is_tensor(v) and v.is_floating_point()
            else v for n, v in tree.items()}


def _check_precond(hmc, args, cfg):
    kern = precond_step.fused_hmc_block if hmc else precond_step.fused_mala_block
    plain = (precond_step.hmc_block_reference if hmc
             else precond_step.mala_block_reference)
    name = "hmc_block" if hmc else "mala_block"
    before = precond_step.launches[name]
    new_k, tr_k = kern(*args, record_w=True)
    assert precond_step.launches[name] == before + 1
    new_r, tr_r = plain(*args, record_w=True, diagnostics=True)
    state, noise, start, k, data, at, topo, scal = args
    new_d, tr_d = plain(_upcast(state), _upcast(noise), start, k,
                        _upcast(data), at.double(), topo, scal, record_w=True)
    torch.cuda.synchronize()
    c = cfg.num_chains
    close = (tr_r["margin"] <= MARGIN) | (tr_r["traj_margin"] <= MARGIN)
    # the chains whose float64 run took the float32 run's decisions
    same = new_d["n_accept"] == new_r["n_accept"]
    for n in ("accept_count", "traj_len"):
        if n in tr_r:
            same &= (tr_d[n] == tr_r[n]).all(dim=0)
    if hmc and scal["chees"]:
        panel = scal["rungs"] * scal["n_ladders"]
        idx = torch.arange(c, device=close.device)
        group = (idx // panel) * scal["rungs"] + idx % scal["rungs"]
        close = torch.isin(group, group[close])
        same = ~torch.isin(group, group[~same])
    ok = ~close
    # 1 % of the chains, or one chain or ChEES group at these small counts
    group_size = scal["n_ladders"] if hmc and scal["chees"] else 1
    assert int(close.sum()) <= max(0.01 * c, group_size)
    assert 0 < int(new_r["n_accept"].sum()) < args[3] * c
    assert torch.equal(new_k["n_accept"][ok], new_r["n_accept"][ok])
    for n in ("accept_count", "traj_len"):
        if n in tr_r:
            assert torch.equal(tr_k[n][:, ok], tr_r[n][:, ok]), n

    def close_enough(got, ref, wit, scale, axis):
        """Within the tolerance plus WITNESS_R times the plain version's
        largest distance from float64 in the chain (chip_smoke.py)."""
        shape = [1] * got.dim()
        shape[axis] = c
        d = torch.zeros_like(got)
        if wit is not None:
            gap = (ref - wit).abs().movedim(axis, 0).reshape(c, -1)
            d = (gap.amax(dim=1) * same).reshape(shape).to(got.dtype)
        keep = ok.reshape(shape).expand_as(got)
        allowed = P_ATOL + P_RTOL * scale.abs() + WITNESS_R * d
        return bool(((got - ref).abs() <= allowed)[keep].all())

    vec = lambda v: v.abs().amax(dim=-1, keepdim=True).expand_as(v)
    for n, v in new_r.items():
        if n in ("n_accept", "ll"):
            continue
        scale, wit = (vec(v) if v.dim() == 2 else v), new_d[n]
        if n == "chees_m1":
            scale = v.abs() + new_r["chees_v2"].abs().sqrt()
        if n == "g_like":  # the gradient at the kernel's own w
            v = fnn.neg_half_sse_grad(new_k["w"], data["x_tr"], data["y_tr"],
                                      TOPO)[1]
            scale, wit = vec(v), None
        assert close_enough(new_k[n], v, wit, scale, 0), n
    for n in ("rmse_train", "rmse_test", "w"):
        ref = tr_r[n]
        scale = vec(ref) if n == "w" else ref
        assert close_enough(tr_k[n], ref, tr_d[n], scale, 1), n
    assert close_enough(new_k["ll"], new_r["ll"], new_d["ll"],
                        tr_r["ll_scale_final"], 0)
    assert close_enough(tr_k["ll"], tr_r["ll"], tr_d["ll"], tr_r["ll_scale"],
                        1)
    return new_k, tr_k


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [64, 130, 1024])
def test_mala_block_kernel_matches_plain_version(cuda, chains):
    """The Sunspot path's 64 chains, a ragged count and 1024, every phase,
    each at the warps a chain the card's plan gives
    (``precond_step.card_mala_plan``: on the H100 8 at 64 and 130 chains,
    1 at 1024), which the launch must take."""
    args, cfg = _precond_inputs(cuda, chains, "precond_mala", start=1)
    plan = precond_step.card_mala_plan(cuda, chains, 60)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan == precond_step.mala_launch_plan(chains, 60, sms)
    wpcs = dict(precond_step.mala_wpcs)
    _check_precond(False, args, cfg)
    taken = [w for w in wpcs if precond_step.mala_wpcs[w] != wpcs[w]]
    assert taken == [plan.wpc]


@pytest.mark.cuda
@pytest.mark.parametrize("chains, chees", [(130, False), (96, True),
                                           (100, True), (52, True),
                                           (256, True)])
def test_hmc_block_kernel_matches_plain_version(cuda, chains, chees):
    """ChEES on one panel of 24 four-rung ladders (12 blocks of 8 chains),
    on one of 25 and one of 13 (13 and 7 blocks, the last one half empty)
    and on two panels of 32 (16 blocks each); without ChEES a ragged count.
    Whichever exchange route the card takes (``precond_step.hmc_route``) is
    the one tested."""
    kw = dict(hmc_leapfrog=8, hmc_adapt_traj=chees)
    if chees:
        kw["n_ladders"] = chains // 4
    args, cfg = _precond_inputs(cuda, chains, "hmc", start=1, **kw)
    routes = dict(precond_step.hmc_routes)
    new_k, tr_k = _check_precond(True, args, cfg)
    taken = [r for r in routes if precond_step.hmc_routes[r] != routes[r]]
    assert len(taken) == 1 and (taken[0] == "plain") == (not chees)
    tl = tr_k["traj_len"]
    assert float(tl.min()) >= 1.0 and float(tl.max()) <= 8.0
    if chees:
        assert len(torch.unique(tl)) > 1
        assert not torch.equal(new_k["log_traj"], args[0]["log_traj"])


@pytest.mark.cuda
def test_precond_kernels_reject_what_they_cannot_take(cuda):
    args, _cfg = _precond_inputs(cuda, 8, "precond_mala", k=4)
    state, noise = args[0], args[1]
    with pytest.raises(ValueError, match="dtype"):
        precond_step.fused_mala_block(dict(state, eta=state["eta"].double()),
                                      noise, *args[2:])
    with pytest.raises(ValueError, match="one device type"):
        precond_step.fused_mala_block(state, dict(noise, u=noise["u"].cpu()),
                                      *args[2:])
    with pytest.raises(ValueError, match="topolog"):
        precond_step.fused_mala_block(state, noise, *args[2:6], (4, 9, 1),
                                      args[7])


# ---------------------------------------------------------------------------
# The classification kernels (rw_cls_block.cu, mala_cls_block.cu,
# hmc_cls_block.cu) on iris, (4, 12, 3). acc and rmse are exact functions of
# the argmax: they must match exactly wherever the carried value came from
# a proposal whose every row keeps its argmax through a 1e-5 move of the
# logits (block_step.argmax_fragile); at most 1 % of the entries may not.

CLS_TOPO = (4, 12, 3)


def _cls_inputs(device, c, proposal, k=12, start=0, seed=9, name="iris",
                topo=None, **kw):
    """init_state at N(0, 1) weights on the bundled set ``name`` (all its
    rows; ``topo`` overrides its network), noise, per-chain jittered
    scales, and the block scalars (MALA/HMC: warm start to 3,
    preconditioner from 6, adaptation to 9)."""
    rng = np.random.default_rng(seed)
    prob = ptnn_torch.data.load_classification(name)
    topo = tuple(topo or prob.topology)
    w_dim = fnn.w_size(topo)
    n_lad = kw.pop("n_ladders", 1)
    cfg = ptnn_torch.PTConfig(
        task="classification", topology=topo, num_samples=c * 100,
        num_chains=c, proposal=proposal, n_ladders=n_lad,
        swap_style="even_odd", swap_interval=10,
        warmstart_frac=0.0 if proposal == "reference" else 0.1,
        precond_start_frac=0.0 if proposal == "reference" else 0.3,
        adapt_rate=0.1, fused_step=True, **kw).validate()
    ds = make_dataset(cfg, prob.train, prob.test, device)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    st = kernel.init_state(cfg, ds, init_w=f(rng.normal(size=(c, w_dim))))
    state = fused._to_kernel_state(st, cfg)
    state["log_step_w"] = f(np.log(cfg.step_w) + 0.3 * rng.normal(size=c))
    noise = dict(w=f(rng.normal(size=(k, c, w_dim))),
                 u=f(rng.uniform(size=(k, c))),
                 u_jit=f(rng.uniform(size=(k, c))),
                 u_traj=kernel.vdc_u(torch.arange(start, start + k,
                                                  device=device)))
    scal = fused._scalars(cfg)
    if proposal != "reference":
        scal.update(warm_end=3, pc_start=6, burn_end=9)
    data = block_step.prep_data(ds.x_train, ds.y_train, ds.x_test, ds.y_test,
                                n_classes=topo[2])
    temps = np.geomspace(1.0, 4.0, cfg.rungs_per_ladder)
    at = f(np.tile(temps, cfg.n_ladders))
    return state, noise, start, k, data, at, scal, cfg


def _check_cls(kind, state, noise, start, k, data, at, scal, cfg, length):
    topo = tuple(cfg.topology)
    if kind == "rw":
        args = (state, noise["w"], None, noise["u"], start, length, data, at,
                topo, scal)
        before = block_step.cls_launches
        new_k, tr_k = block_step.fused_rw_block(*args, record_w=True)
        assert block_step.cls_launches == before + 1
        new_r, tr_r = block_step.rw_block_reference(*args, record_w=True,
                                                    diagnostics=True)
        # the chains whose decisions the plain version's float32 rounding
        # takes count as close; in each the kernel decides as the float64
        # run, outside that run's margin
        decided, off, run_d = block_step.rw_cls_witness(
            state, noise["w"], noise["u"], start, length, data, at, topo,
            scal, (new_k, tr_k), (new_r, tr_r), MARGIN)
        assert not bool(off.any())
        tr_r["traj_margin"] = torch.full_like(tr_r["margin"], math.inf)
        rtol, atol = RTOL, ATOL
    else:
        hmc = kind == "hmc"
        name = "hmc_cls_block" if hmc else "mala_cls_block"
        nz = dict(noise)
        if not hmc:
            del nz["u_jit"], nz["u_traj"]
        args = (state, nz, start, length, data, at, CLS_TOPO, scal)
        kern = (precond_cls_step.fused_hmc_cls_block if hmc
                else precond_cls_step.fused_mala_cls_block)
        plain = (precond_cls_step.hmc_cls_block_reference if hmc
                 else precond_cls_step.mala_cls_block_reference)
        before = precond_cls_step.launches[name]
        new_k, tr_k = kern(*args, record_w=True)
        assert precond_cls_step.launches[name] == before + 1
        new_r, tr_r = plain(*args, record_w=True, diagnostics=True)
        rtol, atol = P_RTOL, P_ATOL
    c = cfg.num_chains
    # HMC's float64 witness (chip_smoke.py's WITNESS_R): the chains whose
    # float64 run took the float32 run's decisions, and that run's values;
    # also RW's on the networks of RW_CLS_UNHELD, whose |ll| of 1e3-1e4
    # lets the plain version's float32 rounding move an adapting chain's
    # step, and so its weights, past the tolerance
    new_d = tr_d = None
    same = torch.ones(c, dtype=torch.bool, device=at.device)
    if kind == "rw" and topo in block_step.RW_CLS_UNHELD:
        (new_d, tr_d), same = run_d, ~decided
    if kind == "hmc":
        new_d, tr_d = plain(_upcast(state), _upcast(nz), start, length,
                            _upcast(data), at.double(), CLS_TOPO, scal,
                            record_w=True)
        same = new_d["n_accept"] == new_r["n_accept"]
        for n in ("accept_count", "traj_len"):
            same &= (tr_d[n] == tr_r[n]).all(dim=0)
    torch.cuda.synchronize()
    close = (tr_r["margin"] <= MARGIN) | (tr_r["traj_margin"] <= MARGIN)
    if kind == "rw":
        close |= decided
    group_size = 1
    if kind == "hmc" and scal["chees"]:
        panel = scal["rungs"] * scal["n_ladders"]
        idx = torch.arange(c, device=close.device)
        group = (idx // panel) * scal["rungs"] + idx % scal["rungs"]
        close = torch.isin(group, group[close])
        same = ~torch.isin(group, group[~same])
        group_size = scal["n_ladders"]
    ok = ~close
    assert int(close.sum()) <= max(0.01 * c, group_size)
    assert 0 < int(new_r["n_accept"].sum()) < length * c
    assert torch.equal(new_k["n_accept"][ok], new_r["n_accept"][ok])
    for n in ("accept_count", "traj_len"):
        if n in tr_r:
            assert torch.equal(tr_k[n][:, ok], tr_r[n][:, ok]), n
    # the argmax metrics: exact where their source is not fragile
    sure = ok & ~tr_r["argmax_fragile_final"]
    t_sure = ok[None, :] & ~tr_r["argmax_fragile"]
    if kind == "rw":  # also exact at the kernel's own weights
        bad, frag, drift = block_step.rw_cls_own_weights(
            state, (new_k, tr_k), (new_r, tr_r), data, topo)
        assert bad == 0
        t_sure &= ~(frag | drift)[:-1]
        sure &= ~(frag | drift)[-1]
    # a network whose fragile share the 1 % cannot hold runs per-step
    if kind != "rw" or topo not in block_step.RW_CLS_UNHELD:
        assert int((~t_sure[:, ok]).sum()) <= 0.01 * t_sure[:, ok].numel()
    else:
        assert fused.topology_reason(cfg) is not None
    for n in ("acc_train", "acc_test", "rmse_train", "rmse_test"):
        assert torch.equal(new_k[n][sure], new_r[n][sure]), n
        assert torch.equal(tr_k[n][t_sure], tr_r[n][t_sure]), n
    vec = lambda v: v.abs().amax(dim=-1, keepdim=True).expand_as(v)

    def witness(ref, wit, axis):
        """WITNESS_R times the plain version's largest distance from float64
        in each chain (0 without a witness)."""
        if wit is None:
            return torch.zeros_like(ref)
        shape = [1] * ref.dim()
        shape[axis] = c
        gap = (ref - wit).abs().movedim(axis, 0).reshape(c, -1).amax(dim=1)
        return WITNESS_R * (gap * same).reshape(shape).to(ref.dtype)

    for n, v in new_r.items():
        if n in ("n_accept", "acc_train", "acc_test", "rmse_train",
                 "rmse_test"):
            continue
        scale = vec(v) if v.dim() == 2 else v.abs()
        wit = None if new_d is None else new_d[n]
        if n == "chees_m1":
            scale = v.abs() + new_r["chees_v2"].abs().sqrt()
        if n == "g_like":  # the gradient at the kernel's own w: no witness
            v = fnn.multinomial_ll_grad(new_k["w"], data["x_tr"],
                                        data["yi_tr"], topo)[1]
            scale, wit = vec(v), None
        allowed = atol + rtol * scale + witness(v, wit, 0)
        assert bool(((new_k[n] - v).abs() <= allowed)[ok].all()), n
    for n in ("ll", "w"):
        ref = tr_r[n]
        scale = vec(ref) if n == "w" else ref.abs()
        allowed = atol + rtol * scale + witness(
            ref, None if tr_d is None else tr_d[n], 1)
        assert bool(((tr_k[n] - ref).abs() <= allowed)[:, ok].all()), n
    return new_k, tr_k


# the RW kernel's networks, with the kernel that runs them: the four
# fixed-shape ones on their data sets, winequality-red's and abalone's on
# their rows (block_step.RW_CLS_UNHELD: held to all but the 1 % of fragile
# trace entries) and one the repository does not bundle, on iris's rows
RW_CLS_NETS = [("iris", None, "fixed"), ("Cancer", None, "fixed"),
               ("TicTac", None, "fixed"), ("Ionosphere", None, "fixed"),
               ("winequality-red", None, "generic"),
               ("abalone", None, "generic"),
               ("iris", (4, 7, 3), "generic")]


def _rw_cls_inputs(device, c, name, topo, adapt, k=100):
    """The RW block's inputs at a step scale that rejects some proposals
    and accepts others on every network (Ionosphere's 1852 weights take a
    smaller one); blocks of K = 100, as the path's, so that the fragile
    argmaxes' 1 % is a share of several hundred entries at 10 chains."""
    step = 0.005 if name == "Ionosphere" else 0.025
    *args, cfg = _cls_inputs(device, c, "reference", k=k, name=name,
                             topo=topo, step_w=step, adapt_step_size=adapt)
    args[-1] = dict(args[-1], adapt=adapt, burn_end=60)
    return args, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("name, topo, kind", RW_CLS_NETS)
@pytest.mark.parametrize("chains", [10, 130, 1000])
@pytest.mark.parametrize("adapt", [False, True])
def test_rw_cls_block_kernel_matches_plain_version(cuda, adapt, chains, name,
                                                   topo, kind):
    """Each fixed-shape network at the warps a chain the card's plan gives
    (``block_step.card_rw_cls_plan``) and three others by the generic
    kernel, which the launch must take; the preset's 10 chains, a ragged
    count and 1000."""
    args, cfg = _rw_cls_inputs(cuda, chains, name, topo, adapt)
    assert block_step.cls_variant(cfg.topology) == kind
    rows = args[4]["n_tr"] + args[4]["n_te"]
    plan = block_step.card_rw_cls_plan(cuda, chains, rows)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan == block_step.rw_cls_launch_plan(chains, rows, sms)
    kinds = dict(block_step.cls_variant_launches)
    warps = dict(block_step.rw_cls_warps)
    _check_cls("rw", *args, cfg, length=90)
    taken = [v for v in kinds if block_step.cls_variant_launches[v] != kinds[v]]
    assert taken == [kind]
    ran = {w: n - warps.get(w, 0) for w, n in block_step.rw_cls_warps.items()
           if n != warps.get(w, 0)}
    assert ran == ({plan.warps: 1} if kind == "fixed" else {})


@pytest.mark.cuda
@pytest.mark.parametrize("name, topo", [("Cancer", None), ("iris", (4, 7, 3))])
def test_rw_cls_zero_length_block_changes_nothing(cuda, name, topo):
    (state, noise, start, k, data, at, scal), cfg = _rw_cls_inputs(
        cuda, 10, name, topo, True)
    new, tr = block_step.fused_rw_block(state, noise["w"], None, noise["u"],
                                        start, 0, data, at, cfg.topology,
                                        scal, record_w=True)
    torch.cuda.synchronize()
    for n, v in state.items():
        assert torch.equal(new[n], v), n
    for n, carried in (("ll", "ll"), ("rmse_train", "rmse_train"),
                       ("acc_test", "acc_test"), ("accept_count", "n_accept")):
        assert torch.equal(tr[n], state[carried][None].expand_as(tr[n])), n
    assert torch.equal(tr["w"], state["w_last"][None].expand_as(tr["w"]))


@pytest.mark.cuda
def test_rw_cls_kernel_rejects_only_an_oversized_working_set(cuda):
    """Any topology runs (the generic kernel beyond the fixed-shape ones);
    a working set over a Hopper block's shared memory and a wrong width
    are refused."""
    (state, noise, start, k, data, at, scal), cfg = _rw_cls_inputs(
        cuda, 8, "iris", (4, 11, 3), False, k=4)
    before = block_step.cls_variant_launches["generic"]
    block_step.fused_rw_block(state, noise["w"], None, noise["u"], 0, 4, data,
                              at, cfg.topology, scal)
    assert block_step.cls_variant_launches["generic"] == before + 1
    with pytest.raises(ValueError, match="does not fit topology"):
        block_step.fused_rw_block(state, noise["w"], None, noise["u"], 0, 4,
                                  data, at, (4, 12, 3), scal)
    reps = block_step._SMEM_LIMIT // (4 * 5 * data["n_tr"]) + 1  # 5 floats a row
    big = block_step.prep_data(data["x_tr"].repeat(reps, 1),
                               data["y_tr"].repeat(reps), data["x_te"],
                               data["y_te"], n_classes=3)
    with pytest.raises(ValueError, match="shared memory"):
        block_step.fused_rw_block(state, noise["w"], None, noise["u"], 0, 4,
                                  big, at, cfg.topology, scal)


@pytest.mark.cuda
@pytest.mark.parametrize("chains", [130, 64, 1024])
def test_mala_cls_block_kernel_matches_plain_version(cuda, chains):
    """A ragged count, the iris path's 64 chains and 1024, each at the warps
    a chain the card's plan gives (``precond_cls_step.card_mala_plan``: on
    the H100 4 at 64 and 130 chains, 1 at 1024), which the launch must
    take."""
    *args, cfg = _cls_inputs(cuda, chains, "precond_mala", start=1,
                             step_w=0.3)
    plan = precond_cls_step.card_mala_plan(cuda, chains, 150)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan == precond_cls_step.mala_launch_plan(chains, 150, CLS_TOPO,
                                                     sms)
    wpcs = dict(precond_cls_step.mala_cls_wpcs)
    _check_cls("mala", *args, cfg, length=12)
    taken = [w for w in wpcs if precond_cls_step.mala_cls_wpcs[w] != wpcs[w]]
    assert taken == [plan.wpc]


@pytest.mark.cuda
@pytest.mark.parametrize("chains, chees", [(130, False), (64, True),
                                           (256, True), (52, True),
                                           (1024, False)])
def test_hmc_cls_block_kernel_matches_plain_version(cuda, chains, chees):
    """ChEES on one panel of 16 four-rung ladders (32 blocks of 2 chains at
    4 warps a chain), on two panels of 32 and on one of 13 (26 blocks, the
    last one half empty); without ChEES a ragged count and 1024 chains.
    Whichever launch the card's occupancy gives
    (``precond_cls_step.card_plan``) is the one tested. The 1024 chains
    take chip_smoke.py's step (0.1): at 0.3 a few of them are chaotic, the
    plain version itself leaving the tolerance when its inputs move by one
    part in 1e7, and any summation order (this kernel's and the one it
    replaced alike) then parts from it."""
    step = 0.1 if chains == 1024 else 0.3
    kw = dict(hmc_leapfrog=8, hmc_adapt_traj=chees, step_w=step)
    if chees:
        kw["n_ladders"] = chains // 4
    *args, cfg = _cls_inputs(cuda, chains, "hmc", start=1, **kw)
    routes = dict(precond_cls_step.hmc_cls_routes)
    new_k, tr_k = _check_cls("hmc", *args, cfg, length=12)
    taken = [r for r in routes if precond_cls_step.hmc_cls_routes[r] != routes[r]]
    assert len(taken) == 1 and (taken[0] == "plain") == (not chees)
    tl = tr_k["traj_len"]
    assert float(tl.min()) >= 1.0 and float(tl.max()) <= 8.0
    if chees:
        assert len(torch.unique(tl)) > 1
        assert not torch.equal(new_k["log_traj"], args[0]["log_traj"])


@pytest.mark.cuda
def test_cls_kernels_reject_other_topologies(cuda):
    """The MALA and HMC kernels are built for iris's (4, 12, 3) alone."""
    *args, cfg = _cls_inputs(cuda, 8, "precond_mala", k=4)
    state, noise = args[0], dict(args[1])
    del noise["u_jit"], noise["u_traj"]
    with pytest.raises(ValueError, match="topolog"):
        precond_cls_step.fused_mala_cls_block(state, noise, 0, 4, args[4],
                                              args[5], (4, 11, 3), args[6])
    *args, cfg = _cls_inputs(cuda, 8, "hmc", k=4, hmc_leapfrog=4)
    with pytest.raises(ValueError, match="topolog"):
        precond_cls_step.fused_hmc_cls_block(args[0], args[1], 0, 4, args[4],
                                             args[5], (4, 11, 3), args[6])


# ---------------------------------------------------------------------------
# The per-step sampler's kernels: the drift epoch (drift_epoch.cu) and the
# FNN eval (fnn_eval.cu). The drift's weights are held on the scale of each
# chain's vector (an epoch is hundreds of dependent row updates summed in
# another order); the eval's ll on the size of its cancelling terms, rmse
# within rtol 1e-4, and classification acc/rmse exactly where no row's
# argmax is fragile.

from ptnn_torch.ops import drift as drift_ops  # noqa: E402
from ptnn_torch.ops import fnn_eval as eval_ops  # noqa: E402


def _rows(rng, device, n, topo, task):
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    x = f(rng.normal(size=(n, topo[0])))
    if task == "classification":
        y = f(rng.integers(0, topo[2], size=n))
    else:
        y = f(rng.uniform(size=n))
    return x, y


# every instantiation of the register kernel (10 chains on 64 rows), the
# main paths' widths, and two topologies outside the register table that the
# generic kernel runs
DRIFT_CASES = [
    ((4, 10, 1), 67, 298, 1), ((4, 12, 3), 10, 105, 2),
    ((34, 50, 2), 10, 245, 1),
    ((16, 30, 10), 5, 1500, 1),  # three row tiles
] + [(topo, 10, 64, 1) for topo in sorted(drift_ops.reg_layouts())] + [
    ((5, 20, 3), 9, 64, 2), ((3, 100, 1), 6, 64, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("topo,c,n,depth", DRIFT_CASES)
def test_drift_kernel_matches_plain_version(cuda, topo, c, n, depth):
    task = "regression" if topo[2] == 1 else "classification"
    rng = np.random.default_rng(17)
    x, y = _rows(rng, cuda, n, topo, task)
    t = drift_ops.make_targets(y, topo[2], task)
    w = torch.as_tensor(rng.normal(size=(c, fnn.w_size(topo))) * 0.5,
                        dtype=torch.float32, device=cuda)
    kind = drift_ops.variant(topo)[0]
    before = drift_ops.launches, drift_ops.variant_launches[kind]
    got = drift_ops.sgd_epoch(w, x, t, topo, 0.01, mode="sequential",
                              depth=depth)
    assert (drift_ops.launches,
            drift_ops.variant_launches[kind]) == (before[0] + 1, before[1] + 1)
    want = drift_ops.sgd_epoch_sequential(w, x, t, topo, 0.01, depth)
    torch.cuda.synchronize()
    scale = want.abs().amax(dim=-1, keepdim=True)
    assert bool(((got - want).abs() <= 1e-5 + 1e-4 * scale).all())
    assert float((got - w).abs().max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("topo,task,c,n,n_te", [
    ((4, 10, 1), "regression", 64, 298, 198),
    ((4, 12, 3), "classification", 13, 105, 45),
    ((34, 50, 2), "classification", 10, 245, 109),
    ((16, 30, 10), "classification", 10, 7494, 3498),  # PenDigit
    ((5, 40, 4), "classification", 3, 70, 1),  # the generic layout
])
def test_eval_kernel_matches_plain_version(cuda, topo, task, c, n, n_te):
    """One set and the pair (train and test rows), one launch each, against
    the plain versions: ll on the size of its cancelling terms, regression
    rmse within rtol 1e-4, classification acc and rmse exactly where no
    row's argmax is fragile."""
    rng = np.random.default_rng(19)
    x, y = _rows(rng, cuda, n, topo, task)
    xt, yt = _rows(rng, cuda, n_te, topo, task)
    w = torch.as_tensor(rng.normal(size=(c, fnn.w_size(topo))),
                        dtype=torch.float32, device=cuda)
    tau = torch.as_tensor(rng.uniform(0.01, 0.2, size=c), dtype=torch.float32,
                          device=cuda)
    calls = [
        (lambda: (eval_ops.fnn_eval(w, x, y, tau, topo, task),),
         lambda: (eval_ops.fnn_eval_reference(w, x, y, tau, topo, task),),
         ((x, y),)),
        (lambda: eval_ops.fnn_eval_pair(w, x, y, xt, yt, tau, topo, task),
         lambda: eval_ops.fnn_eval_pair_reference(w, x, y, xt, yt, tau, topo,
                                                  task),
         ((x, y), (xt, yt)))]
    for kern, plain, sets in calls:
        before = eval_ops.launches
        got = kern()
        assert eval_ops.launches == before + 1
        want = plain()
        torch.cuda.synchronize()
        for (ll, rmse, acc), (r_ll, r_rmse, r_acc), (xs, _ys) in zip(
                got, want, sets):
            rows = xs.shape[0]
            if task == "regression":
                terms = 0.5 * rows * torch.log(2 * math.pi * tau).abs() \
                    + 0.5 * rows * r_rmse ** 2 / tau
                torch.testing.assert_close(rmse, r_rmse, rtol=1e-4, atol=1e-6)
                assert not bool(acc.any())
            else:
                terms = r_ll.abs()
                sure = ~block_step.argmax_fragile(w, xs, topo)
                assert torch.equal(acc[sure], r_acc[sure])
                assert torch.equal(rmse[sure], r_rmse[sure])
            assert bool(((ll - r_ll).abs() <= 1e-4 + 1e-4 * terms).all())


@pytest.mark.cuda
def test_per_step_kernels_reject_what_they_cannot_take(cuda):
    w = torch.zeros((3, 61), device=cuda)
    x, t = torch.zeros((5, 4), device=cuda), torch.zeros((5, 1), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        drift_ops.sgd_epoch(w.double(), x, t, (4, 10, 1), 0.1)
    with pytest.raises(ValueError, match="shape"):
        eval_ops.fnn_eval(w, x, t, torch.ones(3, device=cuda), (4, 10, 1),
                          "regression")


@pytest.mark.cuda
@pytest.mark.parametrize("c,n,hw,in_ch,out_ch", [
    (3, 19, 8, 1, 8), (130, 8, 8, 1, 8), (4, 6, 8, 3, 8), (5, 7, 8, 2, 6),
    (9, 5, 28, 1, 8), (256, 77, 8, 1, 4), (256, 1257, 8, 1, 8),
    (256, 540, 8, 1, 8)])
def test_conv_kernel_matches_plain_version(cuda, c, n, hw, in_ch, out_ch):
    """csrc/conv1_relu_pool.cu against F.conv2d + relu + avg_pool2d (TF32
    off): the digits shapes (256 chains x 1257 and 540 images) and ragged
    chain groups and image tiles of the fixed-shape kernel; on the generic
    kernel several input channels, an output width that is no multiple of 4
    (the scalar stores), the MNIST side. atol 1e-5: the kernel's
    multiply-adds contract into FMAs."""
    rng = np.random.default_rng(c + n)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    w1 = f(rng.normal(size=(c, 3, 3, in_ch, out_ch)) * 0.3)
    b1 = f(rng.normal(size=(c, out_ch)) * 0.1)
    x = f(rng.uniform(size=(n, hw * hw * in_ch)))
    before = conv_stage.launches, conv_stage.fixed_launches
    got = conv_stage.conv1_relu_pool(x, w1, b1, hw, in_ch, out_ch)
    torch.cuda.synchronize()
    fixed = (hw, in_ch, out_ch) == conv_stage.fixed_shape()
    assert (conv_stage.launches, conv_stage.fixed_launches) == (
        before[0] + 1, before[1] + fixed)
    want = conv_stage.conv1_relu_pool_reference(x, w1, b1, hw, in_ch, out_ch)
    assert got.shape == (c, n, hw // 2, hw // 2, out_ch)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5)


@pytest.mark.cuda
def test_fused_cnn_forward_matches_plain_forward(cuda):
    cfg = cnn.CnnConfig(image_hw=8, n_classes=10)
    rng = np.random.default_rng(5)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    ws = f(rng.normal(size=(37, cnn.w_size(cfg))) * 0.2)
    x = f(rng.uniform(size=(23, 64)))
    before = conv_stage.launches
    got = cnn.batched_forward_fused(ws, x, cfg)
    assert conv_stage.launches == before + 1
    torch.testing.assert_close(got, cnn.forward(ws, x, cfg), rtol=0.0,
                               atol=1e-4)


@pytest.mark.cuda
def test_conv_kernel_rejects_what_it_cannot_take(cuda):
    f = lambda *s: torch.zeros(s, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="3x3 kernels only"):
        conv_stage.conv1_relu_pool(f(2, 64), f(3, 5, 5, 1, 8), f(3, 8), 8)
    with pytest.raises(ValueError, match="even image side"):
        conv_stage.conv1_relu_pool(f(2, 49), f(3, 3, 3, 1, 8), f(3, 8), 7)
    with pytest.raises(ValueError, match="x has shape"):
        conv_stage.conv1_relu_pool(f(2, 60), f(3, 3, 3, 1, 8), f(3, 8), 8)
    with pytest.raises(ValueError, match="one device type"):
        conv_stage.conv1_relu_pool(f(2, 64).cpu(), f(3, 3, 3, 1, 8), f(3, 8),
                                   8)
    with pytest.raises(ValueError, match="no backward"):
        conv_stage.conv1_relu_pool(f(2, 64), f(3, 3, 3, 1, 8).requires_grad_(),
                                   f(3, 8), 8)
    with pytest.raises(ValueError, match="shared memory"):
        conv_stage.conv1_relu_pool(f(1, 400 * 400), f(3, 3, 3, 1, 8), f(3, 8),
                                   400)
