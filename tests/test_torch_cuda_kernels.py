"""The CUDA block kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/*_block.cu);
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
``diagnostics=True``).
"""

import math

import numpy as np
import pytest
import torch

import ptnn_torch
from ptnn_torch import fused, kernel
from ptnn_torch.models import fnn
from ptnn_torch.ops import block_step, likelihood, precond_step
from ptnn_torch.sampler import make_dataset

torch.set_num_threads(1)

TOPO = (4, 10, 1)
RTOL, ATOL, MARGIN = 1e-4, 1e-5, 1e-5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda is not available)")
    return torch.device("cuda")


def _inputs(device, c, k, adapt, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    x_tr, y_tr = f(rng.normal(size=(37, 4))), f(rng.uniform(size=37))
    x_te, y_te = f(rng.normal(size=(23, 4))), f(rng.uniform(size=23))
    w = f(rng.normal(size=(c, fnn.w_size(TOPO))))
    eta = f(rng.normal(size=c) * 0.3 - 2.0)
    fx = fnn.batched_forward(w, x_tr, TOPO)[:, :, 0]
    tau = torch.exp(eta)
    state = dict(
        w=w, w_last=torch.ones_like(w), eta=eta,
        ll=likelihood.regression_eval_from_fx(fx, y_tr, tau).loglik,
        prior=likelihood.regression_log_prior(w, tau, TOPO),
        rmse_train=torch.zeros_like(eta), rmse_test=torch.zeros_like(eta),
        n_accept=torch.zeros(c, dtype=torch.int32, device=device),
        log_step_w=f(math.log(0.025) + 0.2 * rng.normal(size=c)),
    )
    noise = (f(rng.normal(size=(k, c, fnn.w_size(TOPO)))),
             f(rng.normal(size=(k, c))), f(rng.uniform(size=(k, c))))
    scal = dict(step_w=0.025, step_eta=0.2, sigma_sq=25.0, nu_1=0.0,
                nu_2=0.0, adapt=adapt, adapt_rate=0.1, adapt_target=0.234,
                burn_end=7, task_cls=False)
    data = block_step.prep_data(x_tr, y_tr, x_te, y_te)
    return state, noise, data, f(np.geomspace(1.0, 4.0, c)), scal


@pytest.mark.cuda
@pytest.mark.parametrize("adapt", [False, True])
def test_rw_block_kernel_matches_plain_version(cuda, adapt):
    c, k, length = 130, 12, 9  # a ragged chain count; dead rows at the end
    state, noise, data, at, scal = _inputs(cuda, c, k, adapt)
    args = (state, *noise, 2, length, data, at, TOPO, scal)
    before = block_step.launches
    new_k, tr_k = block_step.fused_rw_block(*args, record_w=True)
    assert block_step.launches == before + 1
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


def _check_precond(hmc, args, cfg):
    kern = precond_step.fused_hmc_block if hmc else precond_step.fused_mala_block
    plain = (precond_step.hmc_block_reference if hmc
             else precond_step.mala_block_reference)
    name = "hmc_block" if hmc else "mala_block"
    before = precond_step.launches[name]
    new_k, tr_k = kern(*args, record_w=True)
    assert precond_step.launches[name] == before + 1
    new_r, tr_r = plain(*args, record_w=True, diagnostics=True)
    torch.cuda.synchronize()
    scal, c = args[-1], cfg.num_chains
    close = (tr_r["margin"] <= MARGIN) | (tr_r["traj_margin"] <= MARGIN)
    if hmc and scal["chees"]:
        panel = scal["rungs"] * scal["n_ladders"]
        idx = torch.arange(c, device=close.device)
        group = (idx // panel) * scal["rungs"] + idx % scal["rungs"]
        close = torch.isin(group, group[close])
    ok = ~close
    # 1 % of the chains, or one chain or ChEES group at these small counts
    group_size = scal["n_ladders"] if hmc and scal["chees"] else 1
    assert int(close.sum()) <= max(0.01 * c, group_size)
    assert 0 < int(new_r["n_accept"].sum()) < args[3] * c
    assert torch.equal(new_k["n_accept"][ok], new_r["n_accept"][ok])
    for n in ("accept_count", "traj_len"):
        if n in tr_r:
            assert torch.equal(tr_k[n][:, ok], tr_r[n][:, ok]), n
    vec = lambda v: v.abs().amax(dim=-1, keepdim=True).expand_as(v)
    for n, v in new_r.items():
        if n in ("n_accept", "ll"):
            continue
        scale = vec(v) if v.dim() == 2 else v.abs()
        if n == "chees_m1":
            scale = v.abs() + new_r["chees_v2"].abs().sqrt()
        if n == "g_like":  # the gradient at the kernel's own w
            v = fnn.neg_half_sse_grad(new_k["w"], args[4]["x_tr"],
                                      args[4]["y_tr"], TOPO)[1]
            scale = vec(v)
        diff = (new_k[n] - v).abs()[ok]
        assert bool((diff <= P_ATOL + P_RTOL * scale[ok]).all()), n
    for n in ("rmse_train", "rmse_test", "w"):
        ref = tr_r[n][:, ok]
        scale = vec(ref) if n == "w" else ref.abs()
        assert bool(((tr_k[n][:, ok] - ref).abs()
                     <= P_ATOL + P_RTOL * scale).all()), n
    for got, ref, sc in ((new_k["ll"], new_r["ll"], tr_r["ll_scale_final"]),
                         (tr_k["ll"], tr_r["ll"], tr_r["ll_scale"])):
        diff = (got - ref).abs()[..., ok]
        assert bool((diff <= P_ATOL + P_RTOL * sc[..., ok]).all())
    return new_k, tr_k


@pytest.mark.cuda
def test_mala_block_kernel_matches_plain_version(cuda):
    args, cfg = _precond_inputs(cuda, 130, "precond_mala", start=1)
    _check_precond(False, args, cfg)  # ragged chain count; every phase


@pytest.mark.cuda
@pytest.mark.parametrize("chains, chees", [(130, False), (96, True),
                                           (256, True)])
def test_hmc_block_kernel_matches_plain_version(cuda, chains, chees):
    """ChEES on one panel of 24 four-rung ladders (a cluster of 6 blocks)
    and on two panels of 32 (clusters of 8); without ChEES a ragged
    count."""
    kw = dict(hmc_leapfrog=8, hmc_adapt_traj=chees)
    if chees:
        kw["n_ladders"] = chains // 4
    args, cfg = _precond_inputs(cuda, chains, "hmc", start=1, **kw)
    new_k, tr_k = _check_precond(True, args, cfg)
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
