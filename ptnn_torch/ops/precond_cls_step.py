"""Fused blocks of preconditioned MALA and HMC steps for every chain,
classification.

Counterpart of ``ptnn/ops/pallas_step.py``'s ``_mala_cls_block_kernel`` /
``fused_mala_cls_block_impl`` and ``_hmc_cls_block_kernel`` /
``fused_hmc_cls_block_impl``: the regression blocks of ``precond_step``
without the eta block, on the multinomial likelihood. One call runs K steps
for all chains with pregenerated noise and uniforms, so it is a
deterministic function of its inputs. Per step, one Metropolis-Hastings
block on w:

* a diagonal preconditioner ``m`` from the Welford buffers (as
  ``precond_step``); the tempered posterior gradient ``g = g_like / T - w /
  sigma^2`` from the cached ``g_like``, the gradient of the multinomial ll
  (``models.fnn.multinomial_ll_grad``): no tau, the likelihood has no noise
  parameter;
* MALA: ``w' = w + sig^2 m g / 2 + sig sqrt(m) z`` with the Gaussian
  reverse-kernel q-ratio; HMC: leapfrog under the mass matrix ``diag(1/m)``
  with the jittered step and, under ChEES, each chain's own leapfrog count
  ``clip(ceil(exp(log_traj) u_traj / eps), 1, leapfrog)``; the proposal's
  ll and train metrics are the last leapfrog step's;
* the warm start ``w + warmstart_step g / rms(g)``, accepted whatever the
  ratio, until ``warm_end`` (HMC runs no trajectory then);
* the prior ``-w_size/2 log sigma^2 - |w'|^2 / (2 sigma^2)``;
  ``log_mh = (ll' - ll) / T + (prior' - prior) + q-ratio`` (or the kinetic
  energy difference), where ll is UNTEMPERED: carried and recorded so;
* write-on-accept rmse (of the first-argmax class index) and accuracy
  carries on train and test, ``accept_count`` before the decision, w rows
  that follow ``w_last``, HMC's ``traj_len`` (0 on dead steps);
* while ``warm_end <= i < burn_end``: Welford accumulation of w,
  Robbins-Monro ``log_step_w``, and under ChEES Adam on ``log_traj`` from
  the rung means of its PANEL (``precond_step.panel_layout``);
* eta passes through untouched. Steps ``k >= length`` decide nothing; the
  scales (and ``log_traj``) are still clipped, as ``ptnn`` does.

Layout: chains-major, no padding, as ``precond_step``.

``fused_mala_cls_block`` / ``fused_hmc_cls_block`` launch the CUDA kernels
(``csrc/mala_cls_block.cu``, ``csrc/hmc_cls_block.cu``) on CUDA tensors and
run the plain versions on CPU tensors only.

CUDA layout: both kernels spread each chain's rows over WPC warps (4, 2 or
1) of a 256-thread block (``csrc/cls_chain.cuh``). ``mala_launch_plan``
picks the MALA kernel's WPC from the card's SM count; ``launch_plan`` picks
the HMC kernel's WPC and, under ChEES, the route of the panels' exchange
(one thread-block cluster a panel, or a cooperative grid) from the card's
occupancy. ``hmc_cls_routes`` counts the HMC launches by route,
``mala_cls_wpcs`` the MALA launches by warps a chain. Those are the
fixed-shape instantiations of ``TOPOLOGIES``; any other network takes both
kernels' generic route (``csrc/gen_chain.cuh``, ``precond_step.gen_layout``:
its shape at run time, a block of 8 warps down to 1, each warp's vectors
in shared or device memory), which the same plans pick;
``variant_launches`` counts the launches by route.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, NamedTuple

import torch

from ptnn_torch.models import fnn
from ptnn_torch.ops import _build
from ptnn_torch.ops.block_step import (_check, argmax_fragile, cls_eval,
                                       cls_metrics, cls_prior_const, inv_rows,
                                       sm_count)
from ptnn_torch.ops.precond_step import (PANEL, _LOG_HI, _LOG_LO_W, _LOG09,
                                         _LOG0999, _LOG_TRAJ_LO, _SMEM_LIMIT,
                                         HmcPlan, MalaPlan, _clip_traj,
                                         _dispatch, _precond_diag,
                                         card_gen_hmc_plan, gen_device_vectors,
                                         gen_dims, gen_layout, gen_mala_plan,
                                         gen_shape, rung_sum, warp_plan)

launches = {"mala_cls_block": 0, "hmc_cls_block": 0}  # CUDA launches
ROUTES = ("plain", "cluster", "grid")  # ROUTE_* of csrc/hmc_cls_block.cu
hmc_cls_routes = {r: 0 for r in ROUTES}  # hmc_cls_block launches by route
WPCS = (4, 2, 1)  # warps a chain the fixed kernels take, largest first
# mala_cls_block launches by warps a chain (the generic route's up to 8)
mala_cls_wpcs = {w: 0 for w in (8,) + WPCS}
# launches of each kernel by variant: a fixed network of TOPOLOGIES, or the
# generic route (csrc/gen_chain.cuh) for any other (I, H, O)
variant_launches = {k: {"fixed": 0, "generic": 0} for k in launches}


def _hmc(name: str) -> int:
    """A constant of csrc/hmc_cls_block.cu: HMC_CLS_THREADS (threads a
    block), HMC_CLS_MAX_CLUSTER (blocks a panel's cluster may have)."""
    return _build.cu_define("hmc_cls_block.cu", name)


def _part() -> int:
    """CLS_PART of csrc/cls_chain.cuh: floats after the gradient in a
    warp's partial slot."""
    return _build.cu_define("cls_chain.cuh", "CLS_PART")


def _mala_warps() -> int:
    """Warps a block of the MALA kernel (MALA_CLS_THREADS / 32 of
    csrc/mala_cls_block.cu)."""
    return _build.cu_define("mala_cls_block.cu", "MALA_CLS_THREADS") // 32


# the (I, H, O) of the fixed-shape instantiations (CLS_PRECOND_CASES of
# csrc/cls_common.cuh): iris's bundled network, and the (4, 10, 3) that
# ptnn_torch.auto infers for iris (hidden = max(10, n_in)); every other
# network takes the generic route
TOPOLOGIES = ((4, 12, 3), (4, 10, 3))

Tensors = Dict[str, torch.Tensor]


def _block_reference(hmc: bool, state: Tensors, noise: Tensors, start: int,
                     length: int, data: dict, adapttemp: torch.Tensor, topo,
                     scal: dict, record_w: bool, diagnostics: bool):
    k_max, c, w_size = noise["w"].shape
    sq, rate = scal["sigma_sq"], scal["adapt_rate"]
    warm_end, burn_end = scal["warm_end"], scal["burn_end"]
    target = scal["hmc_target"] if hmc else scal["mala_target"]
    chees = hmc and bool(scal["chees"])
    leap = int(scal["leapfrog"]) if hmc else 0
    if chees:
        rungs = int(scal["rungs"])
        panel = rungs * int(scal["n_ladders"])
        n_lad = float(scal["n_ladders"])
    prior_const = cls_prior_const(topo, sq)
    at = adapttemp
    atc = at[:, None]
    s = dict(state)
    w, wl, gl = s["w"], s["w_last"], s["g_like"]
    pm, p2 = s["pc_mean"], s["pc_m2"]
    ll, pr = s["ll"], s["prior"]
    rtr, rte, na = s["rmse_train"], s["rmse_test"], s["n_accept"]
    atr, ate = s["acc_train"], s["acc_test"]
    lsw = s["log_step_w"]
    lt, m1, v2 = s.get("log_traj"), s.get("chees_m1"), s.get("chees_v2")
    fl = dict(dtype=w.dtype, device=w.device)
    kc = lambda: torch.empty((k_max, c), **fl)
    t_ll, t_rtr, t_rte, t_atr, t_ate = kc(), kc(), kc(), kc(), kc()
    t_na = torch.empty((k_max, c), dtype=torch.int32, device=w.device)
    t_tl = torch.zeros((k_max, c), **fl) if hmc else None
    t_w = torch.empty((k_max,) + tuple(w.shape), **fl) if record_w else None
    inf = lambda: torch.full((c,), math.inf, **fl)
    margin, traj_margin = inf(), inf()
    fragile = torch.zeros((c,), dtype=torch.bool, device=w.device)
    t_fragile = torch.zeros((k_max, c), dtype=torch.bool, device=w.device)
    x_tr, yi_tr = data["x_tr"], data["yi_tr"]

    for k in range(k_max):
        i = start + k
        live = k < length
        warm = i < warm_end
        sig = torch.exp(lsw)
        if hmc:
            eps = sig
            if scal["eps_jitter"] > 0.0:
                eps = sig * (1.0 + scal["eps_jitter"]
                             * (2.0 * noise["u_jit"][k] - 1.0))
        if not live:
            t_ll[k] = ll
            t_rtr[k], t_rte[k], t_atr[k], t_ate[k], t_na[k] = (
                rtr, rte, atr, ate, na)
            t_fragile[k] = fragile
            if record_w:
                t_w[k] = wl
            lsw = torch.clamp(lsw, _LOG_LO_W, _LOG_HI)
            if chees:
                lt = _clip_traj(lt, eps, leap)
            continue
        m = _precond_diag(p2, i, scal, w_size)
        g_cur = gl / atc - w / sq
        # --- the w block ----------------------------------------------------
        if hmc:
            if chees:
                u_t = noise["u_traj"][k]
                tau_traj = torch.exp(lt) * u_t
                ratio = tau_traj / eps
                l_steps = torch.clamp(torch.ceil(ratio), 1.0, float(leap))
                if diagnostics and leap > 1:
                    near = torch.clamp(torch.round(ratio), 1.0, leap - 1.0)
                    traj_margin = torch.minimum(traj_margin,
                                                torch.abs(ratio - near))
            else:
                l_steps = torch.full((c,), float(leap), **fl)
            epsw = eps[:, None]
            p0 = noise["w"][k] / torch.sqrt(m)
            k_init = 0.5 * torch.sum(m * p0 * p0, dim=-1)
            w_c, p_c, g_c, glr_c = w, p0, g_cur, gl
            zero = torch.zeros_like(ll)
            ll_c, rtr_c, atr_c = zero, zero, zero
            n_leap = 0 if warm else int(l_steps.max())
            for n in range(n_leap):
                p_half = p_c + 0.5 * epsw * g_c
                w_n = w_c + epsw * m * p_half
                ll_n, gl_n, out_n = fnn.multinomial_ll_grad(w_n, x_tr, yi_tr,
                                                            topo)
                g_n = gl_n / atc - w_n / sq
                p_n = p_half + 0.5 * epsw * g_n
                # each chain stops at its own count
                upd = float(n) < l_steps
                u2 = upd[:, None]
                w_c = torch.where(u2, w_n, w_c)
                p_c = torch.where(u2, p_n, p_c)
                g_c = torch.where(u2, g_n, g_c)
                glr_c = torch.where(u2, gl_n, glr_c)
                rtr_n, atr_n = cls_metrics(out_n, yi_tr)
                ll_c = torch.where(upd, ll_n, ll_c)
                rtr_c = torch.where(upd, rtr_n, rtr_c)
                atr_c = torch.where(upd, atr_n, atr_c)
            k_end = 0.5 * torch.sum(m * p_c * p_c, dim=-1)
            w_prop = w_c
        else:
            sig2m = (sig * sig)[:, None] * m
            mean_fwd = w + 0.5 * sig2m * g_cur
            w_prop = mean_fwd + sig[:, None] * torch.sqrt(m) * noise["w"][k]
        if warm:
            g_rms = torch.sqrt(torch.sum(g_cur * g_cur, dim=-1,
                                         keepdim=True) / float(w_size))
            w_prop = w + scal["warmstart_step"] * g_cur / torch.clamp(
                g_rms, min=1e-12)
        ssq = torch.sum(w_prop * w_prop, dim=-1)
        pr_prop = prior_const - ssq / (2.0 * sq)
        if hmc and not warm:  # the last leapfrog step evaluated w_prop
            ll_prop, g_rows, rtr_p, atr_p = ll_c, glr_c, rtr_c, atr_c
        else:
            ll_prop, g_rows, out_p = fnn.multinomial_ll_grad(w_prop, x_tr,
                                                             yi_tr, topo)
            rtr_p, atr_p = cls_metrics(out_p, yi_tr)
        _ll, rte_p, ate_p = cls_eval(w_prop, data["x_te"], data["yi_te"],
                                     topo)
        if hmc:
            diff = k_init - k_end
        else:
            g_prop = g_rows / atc - w_prop / sq
            mean_rev = w_prop + 0.5 * sig2m * g_prop
            d_fwd, d_rev = w_prop - mean_fwd, w - mean_rev
            diff = (torch.sum(d_fwd * d_fwd / m, dim=-1)
                    - torch.sum(d_rev * d_rev / m, dim=-1)) / (2.0 * sig * sig)
        log_mh = (ll_prop - ll) / at + (pr_prop - pr) + diff
        a = torch.exp(torch.clamp(log_mh, max=0.0))
        u = noise["u"][k]
        accept = (u < a) | warm
        if diagnostics:
            if not warm:
                margin = torch.minimum(margin, torch.abs(u - a))
            fragile = torch.where(accept, argmax_fragile(w_prop, x_tr, topo)
                                  | argmax_fragile(w_prop, data["x_te"], topo),
                                  fragile)
        t_ll[k] = ll_prop
        rtr = torch.where(accept, rtr_p, rtr)
        rte = torch.where(accept, rte_p, rte)
        atr = torch.where(accept, atr_p, atr)
        ate = torch.where(accept, ate_p, ate)
        t_rtr[k], t_rte[k], t_atr[k], t_ate[k], t_na[k] = (
            rtr, rte, atr, ate, na)
        t_fragile[k] = fragile
        if hmc:
            t_tl[k] = l_steps
        w_old = w
        acc2 = accept[:, None]
        w = torch.where(acc2, w_prop, w)
        wl = torch.where(acc2, w_prop, wl)
        if record_w:
            t_w[k] = wl
        ll = torch.where(accept, ll_prop, ll)
        pr = torch.where(accept, pr_prop, pr)
        gl = torch.where(acc2, g_rows, gl)
        na = na + accept.to(torch.int32)
        adapting = warm_end <= i < burn_end
        # --- ChEES: Adam on log_traj from the panel's rung means -------------
        if chees:
            if adapting:
                dxp = w_prop - rung_sum(w_prop, panel, rungs) / n_lad
                dx = w_old - rung_sum(w_old, panel, rungs) / n_lad
                dsq = (torch.sum(m * dxp * dxp, dim=-1)
                       - torch.sum(m * dx * dx, dim=-1))
                inner = torch.sum(dxp * p_c, dim=-1)
                g_ch = a * dsq * inner * u_t
                wsum = torch.clamp(rung_sum(a, panel, rungs), min=1e-6)
                g_log = rung_sum(g_ch, panel, rungs) / wsum * tau_traj
                t_ad = float(max(min(i, burn_end) - warm_end, 0) + 1)
                m1 = 0.9 * m1 + 0.1 * g_log
                v2 = 0.999 * v2 + 0.001 * g_log * g_log
                bc1 = 1.0 - math.exp(t_ad * _LOG09)
                bc2 = 1.0 - math.exp(t_ad * _LOG0999)
                lt = lt + scal["chees_rate"] * (m1 / bc1) / (
                    torch.sqrt(v2 / bc2) + 1e-8)
            lt = _clip_traj(lt, eps, leap)
        # --- Welford accumulation and the Robbins-Monro w scale --------------
        if adapting:
            cnt_new = float(max(min(i + 1, burn_end) - warm_end, 1))
            delta = w - pm
            pm = pm + delta / cnt_new
            p2 = p2 + delta * (w - pm)
            lsw = lsw + rate * (a - target)
        lsw = torch.clamp(lsw, _LOG_LO_W, _LOG_HI)

    new = dict(w=w, w_last=wl, g_like=gl, pc_mean=pm, pc_m2=p2,
               eta=state["eta"], ll=ll, prior=pr, rmse_train=rtr,
               rmse_test=rte, acc_train=atr, acc_test=ate, n_accept=na,
               log_step_w=lsw)
    if lt is not None:
        new.update(log_traj=lt, chees_m1=m1, chees_v2=v2)
    traces = dict(ll=t_ll, rmse_train=t_rtr, rmse_test=t_rte,
                  acc_train=t_atr, acc_test=t_ate, accept_count=t_na)
    if hmc:
        traces["traj_len"] = t_tl
    if record_w:
        traces["w"] = t_w
    if diagnostics:
        traces.update(margin=margin, traj_margin=traj_margin,
                      argmax_fragile=t_fragile, argmax_fragile_final=fragile)
    return new, traces


def mala_cls_block_reference(state: Tensors, noise: Tensors, start: int,
                             length: int, data: dict,
                             adapttemp: torch.Tensor, topo, scal: dict,
                             record_w: bool = True,
                             diagnostics: bool = False):
    """The plain PyTorch version of ``fused_mala_cls_block``, on any device,
    in the dtype of its inputs.

    ``diagnostics=True`` adds ``margin`` (C,), the smallest ``|u - a|``
    past the warm start over the live steps; ``traj_margin`` (C,), inf
    here; and ``argmax_fragile`` (K, C) / ``argmax_fragile_final`` (C,)
    bool, whether the rmse and acc carried at that step (at the end) come
    from a proposal with a row whose argmax rounding could flip
    (``block_step.argmax_fragile``). ll is a sum of negative terms: its rounding lives on
    ``|ll|``.
    """
    return _block_reference(False, state, noise, start, length, data,
                            adapttemp, topo, scal, record_w, diagnostics)


def hmc_cls_block_reference(state: Tensors, noise: Tensors, start: int,
                            length: int, data: dict, adapttemp: torch.Tensor,
                            topo, scal: dict, record_w: bool = True,
                            diagnostics: bool = False):
    """The plain PyTorch version of ``fused_hmc_cls_block``; diagnostics as
    ``mala_cls_block_reference``, and under ChEES ``traj_margin`` (C,) is
    the smallest distance of ``tau_traj / eps`` to an integer at which the
    clipped leapfrog count changes, over the live steps."""
    return _block_reference(True, state, noise, start, length, data,
                            adapttemp, topo, scal, record_w, diagnostics)


# ---------------------------------------------------------------------------
# The CUDA launch.

_IN_VEC = ("w", "w_last", "g_like", "pc_mean", "pc_m2")
_IN_C = ("ll", "prior", "rmse_train", "rmse_test", "acc_train", "acc_test",
         "log_step_w")
_CHEES_C = ("log_traj", "chees_m1", "chees_v2")


class ClsPrecondParams(ctypes.Structure):
    """Mirror of ``struct ClsPrecondParams`` in csrc/cls_common.cuh (same
    field order)."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "rows", "at", "w", "w_last", "g_like", "pc_mean", "pc_m2", "ll",
            "prior", "rmse_tr", "rmse_te", "acc_tr", "acc_te", "n_accept",
            "log_step_w", "log_traj", "chees_m1", "chees_v2", "noise_w", "u",
            "u_jit", "u_traj",
            "o_w", "o_w_last", "o_g_like", "o_pc_mean", "o_pc_m2", "o_ll",
            "o_prior", "o_rmse_tr", "o_rmse_te", "o_acc_tr", "o_acc_te",
            "o_n_accept", "o_log_step_w", "o_log_traj", "o_chees_m1",
            "o_chees_v2", "t_ll", "t_rmse_tr", "t_rmse_te", "t_acc_tr",
            "t_acc_te", "t_accept", "t_traj_len", "t_w",
        )
    ] + [
        (name, ctypes.c_int)
        for name in (
            "n_tr", "n_te", "chains", "k_max", "start", "length", "pc_start",
            "warm_end", "burn_end", "leapfrog", "chees", "rungs", "panel",
        )
    ] + [
        (name, ctypes.c_float)
        for name in (
            "sigma_sq", "adapt_rate", "target", "warmstart_step",
            "precond_power", "eps_jitter", "chees_rate", "n_ladders_f",
            "prior_const", "inv_n_tr", "inv_n_te", "acc_n_tr", "acc_n_te",
            "w_size_f", "log_lo_w",
            "log_hi", "log_traj_lo", "log09", "log0999",
        )
    ]


def _chain_smem_floats(n_rows: int, topo, warps: int) -> int:
    """Shared memory of a block of ``warps`` warps in the layout of
    csrc/cls_chain.cuh, in floats: the data rows (padded to 16 bytes); per
    warp a broadcast slot of ``vec`` floats (w_size rounded up to 32) and a
    32-row tile of backprop records of ``2H + O + I + 1`` fields at an odd
    stride; per warp two parities of its partial slot (``vec`` + CLS_PART
    floats)."""
    n_in, n_hid, n_out = topo
    vec = 32 * -(-fnn.w_size(topo) // 32)
    stride = (2 * n_hid + n_out + n_in + 1) | 1
    rows = (n_rows * (n_in + 1) + 3) // 4 * 4
    return rows + warps * (vec + 32 * stride + 2 * (vec + _part()))


def hmc_smem_bytes(n_rows: int, topo, chees: bool, wpc: int) -> int:
    """Dynamic shared memory of one block of the HMC kernel at ``wpc`` warps
    a chain. A fixed network: the layout of csrc/cls_chain.cuh and, under
    ChEES, per chain, two parities of the cluster route's exchange slot
    (w', w_old and two scalars). Any other: the generic route's block
    (``precond_step.gen_layout``), without the cluster route's slots."""
    if tuple(topo) not in TOPOLOGIES:
        return gen_layout("hmc", n_rows, topo).smem
    vec = 32 * -(-fnn.w_size(topo) // 32)
    warps = _hmc("HMC_CLS_THREADS") // 32
    floats = _chain_smem_floats(n_rows, topo, warps)
    if chees:
        floats += warps // wpc * 2 * (2 * vec + 4)
    return 4 * floats


def mala_smem_bytes(n_rows: int, topo) -> int:
    """Dynamic shared memory of one block of the MALA kernel: the layout of
    csrc/cls_chain.cuh, whatever the warps a chain, for a fixed network;
    the generic route's block for any other."""
    if tuple(topo) not in TOPOLOGIES:
        return gen_layout("mala", n_rows, topo).smem
    return 4 * _chain_smem_floats(n_rows, topo, _mala_warps())


def mala_launch_plan(chains: int, n_rows: int, topo, sms: int) -> MalaPlan:
    """The MALA kernel's launch for ``chains`` chains on ``n_rows`` data
    rows, on a card of ``sms`` SMs (pure Python): ``precond_step.warp_plan``'s
    rule, the largest WPC whose blocks fit one wave of the card, one block
    an SM; past that, WPC 1 in waves. A network not in TOPOLOGIES takes
    the generic route (``precond_step.gen_mala_plan``)."""
    if tuple(topo) not in TOPOLOGIES:
        return gen_mala_plan(chains, n_rows, topo, sms)
    return warp_plan(chains, _mala_warps(), sms, WPCS,
                     mala_smem_bytes(n_rows, topo))


def card_mala_plan(device, chains: int, n_rows: int,
                   topo=TOPOLOGIES[0]) -> MalaPlan:
    """``mala_launch_plan`` with the SM count of the card ``device``."""
    return mala_launch_plan(chains, n_rows, topo, sm_count(device))


def launch_plan(chains: int, panel: int, n_rows: int, topo,
                fits: Callable[[int, int, int], int],
                coop: Callable[[int, int], int]) -> HmcPlan:
    """The HMC kernel's launch for ``chains`` chains on ``n_rows`` data
    rows of a fixed network; ``panel`` > 0 under ChEES (the chains whose rung sums one
    exchange couples), 0 without. ``fits(wpc, smem, cluster)`` is how many
    clusters of ``cluster`` blocks the card holds at once, ``coop(wpc,
    smem)`` how many blocks of the grid route (the card's occupancy
    queries; tests give numbers).

    Without ChEES nothing is exchanged: the largest WPC. Under ChEES, the
    largest WPC at which every panel's exchange runs on the card at once,
    by ``precond_step``'s rule: one cluster a panel when every panel's
    cluster fits at once, else the cooperative grid when all its blocks fit;
    if no WPC allows either, clusters in waves at one warp a chain. A panel
    must tile the chains and, past one panel, cover whole blocks."""
    warps, most = _hmc("HMC_CLS_THREADS") // 32, _hmc("HMC_CLS_MAX_CLUSTER")
    if not panel:
        wpc = WPCS[0]
        per = warps // wpc
        return HmcPlan(wpc, per, -(-chains // per), 1, "plain",
                          hmc_smem_bytes(n_rows, topo, False, wpc),
                          "no ChEES: no exchange")
    if chains % panel or (panel != chains and panel != PANEL):
        raise ValueError(f"ChEES panel of {panel} chains does not tile "
                         f"{chains} chains")
    n_panels = chains // panel
    for wpc in WPCS:
        per = warps // wpc
        blocks, cluster = -(-chains // per), -(-panel // per)
        if n_panels > 1 and panel % per:
            continue
        smem = hmc_smem_bytes(n_rows, topo, True, wpc)
        if cluster <= most:
            n_fit = fits(wpc, smem, cluster)
            if n_fit >= n_panels:
                return HmcPlan(wpc, per, blocks, cluster, "cluster", smem,
                                  f"WPC {wpc}: {n_fit} clusters of "
                                  f"{cluster} blocks fit at once, {n_panels} "
                                  f"panels")
        n_coop = coop(wpc, smem)
        if blocks <= n_coop:
            return HmcPlan(wpc, per, blocks, cluster, "grid", smem,
                              f"WPC {wpc}: all {blocks} blocks fit "
                              f"at once ({n_coop})")
    per = warps
    blocks, cluster = -(-chains // per), -(-panel // per)
    smem = hmc_smem_bytes(n_rows, topo, True, 1)
    if cluster <= most and fits(1, smem, cluster) >= 1:
        return HmcPlan(1, per, blocks, cluster, "cluster", smem,
                          f"WPC 1: {n_panels} clusters of {cluster} "
                          f"blocks in waves")
    raise ValueError(f"a ChEES panel of {panel} chains fits neither one "
                     f"cluster of {most} blocks nor the card at once")


@functools.lru_cache(maxsize=None)
def _card_plan(device_index: int, chains: int, panel: int, n_rows: int,
               topo) -> HmcPlan:
    def query(fn, *args):
        lib = _build.build("hmc_cls_block").lib
        out = ctypes.c_int(0)
        err = getattr(lib, fn)(*args, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"{fn} failed: {_build.error_string(lib, err)}")
        return out.value

    return launch_plan(
        chains, panel, n_rows, topo,
        fits=lambda wpc, smem, cluster: query(
            "ptnn_hmc_cls_max_active_clusters", wpc, topo[1], smem, cluster),
        coop=lambda wpc, smem: query("ptnn_hmc_cls_coop_blocks", wpc,
                                     topo[1], smem))


def card_plan(device, chains: int, panel: int, n_rows: int,
              topo=TOPOLOGIES[0]) -> HmcPlan:
    """``launch_plan`` with the occupancy of the card ``device``; a network
    not in TOPOLOGIES takes the generic route
    (``precond_step.gen_hmc_plan``)."""
    if tuple(topo) not in TOPOLOGIES:
        return card_gen_hmc_plan("hmc_cls_block", "ptnn_hmc_cls_gen", device,
                                 chains, panel, n_rows, topo)
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        return _card_plan(index, chains, panel, n_rows, tuple(topo))


def _launch_cuda(name: str, state: Tensors, noise: Tensors, start: int,
                 length: int, data: dict, adapttemp: torch.Tensor, topo,
                 scal: dict, record_w: bool):
    hmc = name == "hmc_cls_block"
    chees = hmc and bool(scal["chees"])
    dev = noise["w"].device
    k_max, c, w_dim = noise["w"].shape
    n_in = topo[0]
    n_tr, n_te = int(data["n_tr"]), int(data["n_te"])
    if w_dim != fnn.w_size(topo):
        raise ValueError(f"noise width {w_dim} does not fit topology {topo}")
    if not 0 <= int(length) <= k_max:
        raise ValueError(f"length {length} outside [0, {k_max}]")
    rungs = panel = 1
    if chees:
        rungs = int(scal["rungs"])
        panel = rungs * int(scal["n_ladders"])
    if hmc:
        if int(scal["leapfrog"]) < 1:
            raise ValueError(f"leapfrog {scal['leapfrog']} < 1")
        plan = card_plan(dev, c, panel if chees else 0, n_tr + n_te, topo)
    else:
        plan = card_mala_plan(dev, c, n_tr + n_te, topo)
    smem = plan.smem
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"{n_tr}+{n_te} data rows need {smem} bytes of shared memory per "
            f"block; a Hopper block has {_SMEM_LIMIT}"
        )
    f32, i32 = torch.float32, torch.int32
    _check(data["rows"], "rows", (n_tr + n_te, n_in + 1), f32, dev)
    _check(adapttemp, "adapttemp", (c,), f32, dev)
    for key in ("u",) + (("u_jit",) if hmc else ()):
        _check(noise[key], "noise " + key, (k_max, c), f32, dev)
    if chees:
        _check(noise["u_traj"], "noise u_traj", (k_max,), f32, dev)
    for key in _IN_VEC:
        _check(state[key], key, (c, w_dim), f32, dev)
    for key in _IN_C + (_CHEES_C if chees else ()):
        _check(state[key], key, (c,), f32, dev)
    _check(state["n_accept"], "n_accept", (c,), i32, dev)
    lib = _build.build(name).lib

    keys = _IN_VEC + _IN_C + ("n_accept",) + (_CHEES_C if chees else ())
    new = {k: torch.empty_like(state[k]) for k in keys}
    kc = lambda dt=f32: torch.empty((k_max, c), dtype=dt, device=dev)
    tr = dict(ll=kc(), rmse_train=kc(), rmse_test=kc(), acc_train=kc(),
              acc_test=kc(), accept_count=kc(i32))
    if hmc:
        tr["traj_len"] = kc()
    if record_w:
        tr["w"] = torch.empty((k_max, c, w_dim), dtype=f32, device=dev)
    p = lambda t: None if t is None else t.data_ptr()
    g = lambda d, k: p(d.get(k))
    sq = float(scal["sigma_sq"])
    target = scal["hmc_target"] if hmc else scal["mala_target"]
    params = ClsPrecondParams(
        rows=p(data["rows"]), at=p(adapttemp),
        w=p(state["w"]), w_last=p(state["w_last"]),
        g_like=p(state["g_like"]), pc_mean=p(state["pc_mean"]),
        pc_m2=p(state["pc_m2"]), ll=p(state["ll"]), prior=p(state["prior"]),
        rmse_tr=p(state["rmse_train"]), rmse_te=p(state["rmse_test"]),
        acc_tr=p(state["acc_train"]), acc_te=p(state["acc_test"]),
        n_accept=p(state["n_accept"]), log_step_w=p(state["log_step_w"]),
        log_traj=g(state, "log_traj") if chees else None,
        chees_m1=g(state, "chees_m1") if chees else None,
        chees_v2=g(state, "chees_v2") if chees else None,
        noise_w=p(noise["w"]), u=p(noise["u"]),
        u_jit=g(noise, "u_jit") if hmc else None,
        u_traj=g(noise, "u_traj") if chees else None,
        o_w=p(new["w"]), o_w_last=p(new["w_last"]),
        o_g_like=p(new["g_like"]), o_pc_mean=p(new["pc_mean"]),
        o_pc_m2=p(new["pc_m2"]), o_ll=p(new["ll"]), o_prior=p(new["prior"]),
        o_rmse_tr=p(new["rmse_train"]), o_rmse_te=p(new["rmse_test"]),
        o_acc_tr=p(new["acc_train"]), o_acc_te=p(new["acc_test"]),
        o_n_accept=p(new["n_accept"]), o_log_step_w=p(new["log_step_w"]),
        o_log_traj=g(new, "log_traj"), o_chees_m1=g(new, "chees_m1"),
        o_chees_v2=g(new, "chees_v2"),
        t_ll=p(tr["ll"]), t_rmse_tr=p(tr["rmse_train"]),
        t_rmse_te=p(tr["rmse_test"]), t_acc_tr=p(tr["acc_train"]),
        t_acc_te=p(tr["acc_test"]), t_accept=p(tr["accept_count"]),
        t_traj_len=g(tr, "traj_len"), t_w=g(tr, "w"),
        n_tr=n_tr, n_te=n_te, chains=c, k_max=k_max, start=int(start),
        length=int(length), pc_start=int(scal["pc_start"]),
        warm_end=int(scal["warm_end"]), burn_end=int(scal["burn_end"]),
        leapfrog=int(scal["leapfrog"]) if hmc else 0, chees=int(chees),
        rungs=rungs, panel=panel,
        sigma_sq=sq, adapt_rate=float(scal["adapt_rate"]),
        target=float(target), warmstart_step=float(scal["warmstart_step"]),
        precond_power=float(scal["precond_power"]),
        eps_jitter=float(scal["eps_jitter"]) if hmc else 0.0,
        chees_rate=float(scal["chees_rate"]) if chees else 0.0,
        n_ladders_f=float(scal["n_ladders"]) if chees else 1.0,
        prior_const=cls_prior_const(topo, sq), inv_n_tr=inv_rows(n_tr),
        inv_n_te=inv_rows(n_te), acc_n_tr=inv_rows(n_tr, 100.0),
        acc_n_te=inv_rows(n_te, 100.0), w_size_f=float(w_dim),
        log_lo_w=_LOG_LO_W,
        log_hi=_LOG_HI, log_traj_lo=_LOG_TRAJ_LO, log09=_LOG09,
        log0999=_LOG0999,
    )
    fixed = plan.variant == "fixed"
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if not fixed:
            kind = "hmc" if hmc else "mala"
            shape = gen_shape(topo, plan, kind)
            vdev = gen_device_vectors(plan, kind, topo, dev)
        if hmc:
            exch = None
            if plan.route == "grid":  # (C, 2, EX) slots in device memory
                vec = gen_dims(topo)[0]
                exch = torch.empty((c, 2, 2 * vec + 4), dtype=f32, device=dev)
            if fixed:
                err = lib.ptnn_hmc_cls_block(
                    ctypes.byref(params), p(exch), smem, plan.wpc, topo[1],
                    plan.cluster, ROUTES.index(plan.route), stream)
            else:
                err = lib.ptnn_hmc_cls_gen(
                    ctypes.byref(params), ctypes.byref(shape), p(exch),
                    p(vdev), smem, plan.cluster, ROUTES.index(plan.route),
                    stream)
        elif fixed:
            err = lib.ptnn_mala_cls_block(ctypes.byref(params), smem,
                                          plan.wpc, topo[1], stream)
        else:
            err = lib.ptnn_mala_cls_gen(ctypes.byref(params),
                                        ctypes.byref(shape), p(vdev), smem,
                                        stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {_build.error_string(lib, err)}"
        )
    launches[name] += 1
    variant_launches[name][plan.variant] += 1
    if hmc:
        hmc_cls_routes[plan.route] += 1
    else:
        mala_cls_wpcs[plan.wpc] += 1
    new["eta"] = state["eta"]  # passed through: classification has no eta
    if hmc and not chees:  # passed through, as ptnn's kernel does
        for key in _CHEES_C:
            if key in state:
                new[key] = state[key]
    return new, tr


def fused_mala_cls_block(state: Tensors, noise: Tensors, start: int,
                         length: int, data: dict, adapttemp: torch.Tensor,
                         topo, scal: dict, record_w: bool = True):
    """One K-step preconditioned-MALA block for all chains, classification
    -> ``(new_state, traces)``.

    ``state`` holds w, w_last, g_like, pc_mean, pc_m2 (C, W), eta, ll,
    prior, rmse_train, rmse_test, acc_train, acc_test, log_step_w (C,)
    float32 and n_accept (C,) int32. ``noise`` holds "w" (K, C, W) and "u"
    (K, C). ``scal`` holds sigma_sq, adapt_rate, mala_target,
    warmstart_step, precond_power, pc_start, warm_end and burn_end. ``data``
    is ``block_step.prep_data(..., n_classes=O)``. Traces: (K, C) "ll",
    "rmse_train", "rmse_test", "acc_train", "acc_test", "accept_count",
    plus "w" (K, C, W) when ``record_w``. CUDA tensors launch the kernel;
    CPU tensors take the plain version.
    """
    return _dispatch("mala_cls_block", mala_cls_block_reference, state,
                     noise, start, length, data, adapttemp, topo, scal,
                     record_w, _launch_cuda)


def fused_hmc_cls_block(state: Tensors, noise: Tensors, start: int,
                        length: int, data: dict, adapttemp: torch.Tensor,
                        topo, scal: dict, record_w: bool = True):
    """One K-step preconditioned-HMC block for all chains, classification.

    As ``fused_mala_cls_block``, and: ``state`` adds log_traj, chees_m1,
    chees_v2 (C,) under ChEES; ``noise`` adds "u_jit" (K, C) and, under
    ChEES, "u_traj" (K,); ``scal`` has hmc_target in place of mala_target
    and adds leapfrog, eps_jitter, chees, chees_rate, n_ladders (replicas
    per rung in a panel) and rungs. Traces add "traj_len" (K, C).
    """
    return _dispatch("hmc_cls_block", hmc_cls_block_reference, state, noise,
                     start, length, data, adapttemp, topo, scal, record_w,
                     _launch_cuda)
