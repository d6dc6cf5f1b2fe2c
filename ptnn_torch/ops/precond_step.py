"""Fused blocks of preconditioned MALA and HMC steps for every chain
(regression).

Counterpart of the gradient part of ``ptnn/ops/pallas_step.py``
(``_mala_block_kernel`` / ``fused_mala_block_impl``, ``_hmc_block_kernel`` /
``fused_hmc_block_impl``, ``rung_sum_matrix``). One call runs K steps for all
chains with pregenerated noise and uniforms, so it is a deterministic
function of its inputs. Each step is two Metropolis-within-Gibbs blocks:

* **the w block.** A diagonal preconditioner ``m`` from the Welford
  buffers (``var = pc_m2 / cnt`` over the mean variance, clipped to
  [1e-4, 1e4], identity before ``pc_start``); the tempered posterior gradient
  ``g = g_like / (tau T) - w / sigma^2`` from the cached ``g_like``, the
  gradient of -SSE/2 (``models.fnn.neg_half_sse_grad``).
  - MALA: ``w' = w + sig^2 m g / 2 + sig sqrt(m) z`` with the exact
    Gaussian reverse-kernel q-ratio.
  - HMC: momentum ``p = z / sqrt(m)``, leapfrog under the mass matrix
    ``diag(1/m)`` with step ``eps = sig (1 + jitter (2 u_jit - 1))``, and
    the kinetic-energy difference in the MH ratio. Under ChEES each chain
    runs ``l = clip(ceil(exp(log_traj) u_traj / eps), 1, leapfrog)``
    leapfrog steps, else ``leapfrog``.
  - Until ``warm_end`` the proposal is the deterministic warm start
    ``w + warmstart_step g / rms(g)`` and is accepted whatever the ratio;
    no trajectory runs then.
  - Accepting takes the proposal's SSE and gradient: ``g_like`` is cached.
* **the eta block**: a random walk on eta with its own Robbins-Monro scale
  ``log_step_eta`` (target 0.44), whose likelihood is recovered from the
  carried ll without touching the data.
* **adaptation** while ``warm_end <= i < burn_end``: Welford accumulation
  of w, Robbins-Monro ``log_step_w += rate (a - target)``, and under ChEES
  Adam on ``log_traj`` from the acceptance-weighted ChEES criterion, whose
  rung means pool the replicas of each rung within a PANEL.
* **the panel.** A panel is all chains when C <= 128, else each run of 128
  consecutive chains, which then holds ``n_ladders = 128 / K`` complete
  ladders. It is semantics, not layout: ``ptnn`` pools within a 128-lane
  block, and the port keeps that.
* trace rows as the RW block: the TEMPERED proposal ll, write-on-accept rmse
  carries, ``accept_count`` before the decision, optional w rows that
  follow ``w_last``; HMC adds ``traj_len``, the leapfrog count of the step
  (0 on dead steps). Steps ``k >= length`` decide nothing; ``ptnn``'s
  kernels still clip the scales on them (and ``log_traj`` to
  ``log(eps leapfrog)``), and so does the port.

Layout: chains-major, no padding. State (C, W) and (C,), noise ``w``
(K, C, W), per-chain noise and uniforms (K, C), ``u_traj`` (K,), trace rows
(K, C), w trace (K, C, W).

``fused_mala_block`` / ``fused_hmc_block`` launch the CUDA kernels
(``csrc/mala_block.cu``, ``csrc/hmc_block.cu``) on CUDA tensors and run the
plain versions, ``mala_block_reference`` / ``hmc_block_reference``, on CPU
tensors only.

CUDA layout: the MALA kernel spreads one chain's rows over WPC warps (8, 4,
2 or 1) of a 256-thread block (``csrc/reg_chain.cuh``); ``mala_launch_plan``
picks WPC from the card's SM count by the rule ``warp_plan`` states, which
the iris MALA kernel shares, and ``mala_wpcs`` counts the launches by WPC.
The HMC kernel runs one warp per chain, ``HMC_WARPS`` (8) chains a block,
read from the source (``_build.cu_define``). Under ChEES a panel's blocks
exchange rung sums (``hmc_layout``, ``exchange_reads``) by one of two routes
(``hmc_route``): one thread-block cluster a panel, or a cooperative launch
of the whole grid with the exchange slots in device memory. ``hmc_routes``
counts the launches of each. Those are the fixed (4, 10, 1) instantiations;
any other (I, H, 1) takes both kernels' generic route
(``csrc/gen_chain.cuh``: ``gen_layout``, ``gen_mala_plan``,
``gen_hmc_plan``), and ``variant_launches`` counts the launches by route.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ptnn_torch.models import fnn
from ptnn_torch.ops import _build, likelihood
from ptnn_torch.ops.block_step import _check, _prior_const, sm_count

launches = {"mala_block": 0, "hmc_block": 0}  # CUDA launches per kernel
ROUTES = ("plain", "cluster", "grid")  # ROUTE_* of csrc/hmc_block.cu
hmc_routes = {r: 0 for r in ROUTES}  # hmc_block launches by route
MALA_WPCS = (8, 4, 2, 1)  # warps a chain of mala_block.cu, largest first
mala_wpcs = {w: 0 for w in MALA_WPCS}  # mala_block launches by warps a chain
# launches of each kernel by variant: the fixed (4, 10, 1) network, or the
# generic route (csrc/gen_chain.cuh) for any other (I, H, 1)
variant_launches = {k: {"fixed": 0, "generic": 0} for k in launches}

ETA_TARGET_ACCEPT = 0.44  # 1-D random-walk optimum (ptnn's convention)
PANEL = 128  # ChEES pools rung replicas within runs of this many chains
_LOG_LO_W, _LOG_LO_ETA, _LOG_HI = math.log(1e-6), math.log(1e-4), math.log(10.0)
_LOG_TRAJ_LO = math.log(1e-4)
_LOG09, _LOG0999 = math.log(0.9), math.log(0.999)

_SMEM_LIMIT = 232448
TOPOLOGIES = ((4, 10, 1),)  # the (I, H, 1) the CUDA kernels instantiate

Tensors = Dict[str, torch.Tensor]


def _common(name: str) -> int:
    """A constant of csrc/precond_common.cuh, read from the source at first
    use: VEC (floats a vector slot)."""
    return _build.cu_define("precond_common.cuh", name)


def _mala_warps() -> int:
    """Warps a block of the MALA kernel (MALA_THREADS / 32 of
    csrc/mala_block.cu)."""
    return _build.cu_define("mala_block.cu", "MALA_THREADS") // 32


def _hmc(name: str) -> int:
    """A constant of csrc/hmc_block.cu: HMC_WARPS (chains a block),
    HMC_MAX_CLUSTER (blocks a panel's cluster may have)."""
    return _build.cu_define("hmc_block.cu", name)


def _ex_floats() -> int:
    """Floats of one parity of a chain's ChEES exchange slot: w', w_old and
    two scalars (EX_FLOATS of csrc/hmc_block.cu)."""
    return 2 * _common("VEC") + 4


def panel_layout(num_chains: int, rungs: int) -> Tuple[int, int]:
    """``(panel, n_ladders)`` of the ChEES rung sums: the panel is all
    chains when C <= 128, else 128 chains holding 128 / K ladders (as
    ``ptnn/fused.py:414-428``)."""
    panel = num_chains if num_chains <= PANEL else PANEL
    if num_chains % panel or panel % rungs:
        raise ValueError(
            f"ChEES needs complete ladders per {PANEL}-lane panel: "
            f"{num_chains} chains of {rungs} rungs do not tile"
        )
    return panel, panel // rungs


def hmc_layout(num_chains: int, panel: int = 0) -> Tuple[int, int]:
    """``(blocks, cluster)`` of an HMC launch: ceil(C / HMC_WARPS) blocks;
    under ChEES (``panel`` > 0) the blocks of a panel, ceil(panel /
    HMC_WARPS), exchange its rung sums (one cluster each on the cluster
    route). A panel that does not tile the chains, or whose blocks a chain
    of another panel would share, is refused."""
    warps, most = _hmc("HMC_WARPS"), _hmc("HMC_MAX_CLUSTER")
    blocks = -(-num_chains // warps)
    if not panel:
        return blocks, 1
    if num_chains % panel or (panel != num_chains and panel != PANEL):
        raise ValueError(f"ChEES panel of {panel} chains does not tile "
                         f"{num_chains} chains")
    cluster = -(-panel // warps)
    if cluster > most or (num_chains > panel and panel % warps):
        raise ValueError(f"a ChEES panel of {panel} chains does not fit "
                         f"one cluster of {most} blocks")
    return blocks, cluster


def exchange_reads(num_chains: int, rungs: int) -> np.ndarray:
    """(C, n_ladders) chain indices whose exchange slots each chain sums in
    the HMC kernel under ChEES, in its order: ``rung0 + t * rungs`` with
    ``rung0`` the first replica of the chain's rung in its panel."""
    panel, n_lad = panel_layout(num_chains, rungs)
    c = np.arange(num_chains)
    rung0 = (c // panel) * panel + (c % panel) % rungs
    return rung0[:, None] + rungs * np.arange(n_lad)[None, :]


def rung_sum(x: torch.Tensor, panel: int, rungs: int) -> torch.Tensor:
    """Per (panel, rung) sum of ``x`` (C, ...) over the panel's replicas of
    the rung, broadcast back to every chain: ``x @ rung_sum_matrix`` of
    ``ptnn`` (chain = ladder * K + rung within the panel)."""
    c = x.shape[0]
    xr = x.reshape((c // panel, panel // rungs, rungs) + tuple(x.shape[1:]))
    return xr.sum(dim=1, keepdim=True).expand_as(xr).reshape(x.shape)


def _precond_diag(p2, i, scal, w_size):
    """The diagonal preconditioner ``m`` (C, W) at step ``i``."""
    cnt = float(max(min(i, scal["burn_end"]) - scal["warm_end"], 1))
    var = p2 / cnt
    mean_var = torch.sum(var, dim=-1, keepdim=True) / float(w_size)
    m = torch.clamp(var / torch.clamp(mean_var, min=1e-30), 1e-4, 1e4)
    if scal["precond_power"] != 1.0:
        m = torch.pow(m, scal["precond_power"])
    if i < scal["pc_start"]:
        m = torch.ones_like(m)
    return m


def _clip_traj(lt, eps, leap):
    """``clip(lt, log 1e-4, log(eps leapfrog))``, the upper bound winning
    as in ``jnp.clip``."""
    return torch.minimum(torch.clamp(lt, min=_LOG_TRAJ_LO),
                         torch.log(eps * float(leap)))


def eta_move(eta, ll, log_step_eta, z, n_tr, at, nu1, nu2, vr_term=None):
    """The regression eta block's random-walk proposal and its likelihood,
    recovered from the carried ``ll`` without a data pass (ptnn's float32
    order); returns (eta', ll at eta', the prior's change, MH probability).
    ``vr_term(eta', dprior)``, where given, adds the variational reference's
    share to the log ratio. Shared by the fused blocks' plain version and
    the per-step sampler."""
    eta_prop = eta + torch.exp(log_step_eta) * z
    val_cur = (ll + 0.5 * n_tr * (likelihood._LOG_2PI + eta)) * torch.exp(eta)
    ll_eta = (-0.5 * n_tr) * (likelihood._LOG_2PI + eta_prop) \
        + val_cur * torch.exp(-eta_prop)
    # the prior's tau terms: -(1 + nu_1) log tau^2 - nu_2 / tau^2
    dprior = -(1.0 + nu1) * (eta_prop - eta) - nu2 * (
        torch.exp(-eta_prop) - torch.exp(-eta))
    log_mh = (ll_eta - ll) / at + dprior
    if vr_term is not None:
        log_mh = log_mh + vr_term(eta_prop, dprior)
    prob = torch.exp(torch.clamp(log_mh, max=0.0))
    return eta_prop, ll_eta, dprior, prob


def adapt_w(mean, m2, log_step_w, w, prob, i, warm_end, burn_end, rate,
            target):
    """One adapting step (``warm_end <= i < burn_end``): Welford
    accumulation of the post-decision ``w`` into (mean, m2) and
    Robbins-Monro on ``log_step_w`` towards ``target`` acceptance; the
    caller clips the scale."""
    cnt = float(max(min(i + 1, burn_end) - warm_end, 1))
    delta = w - mean
    mean = mean + delta / cnt
    m2 = m2 + delta * (w - mean)
    return mean, m2, log_step_w + rate * (prob - target)


def chees_adam(log_traj, m1, v2, w_prop, w_old, m, p_end, prob, u_traj,
               tau_traj, rung_sum_fn, n_lad, bc1, bc2, rate):
    """ChEES's Adam step on ``log_traj`` (Hoffman et al. 2021, eq. 8,
    adapted to tempering): each chain's criterion from rung means over the
    ``n_lad`` replicas of its rung, weighted by its acceptance probability
    and pooled over the rung; ``rung_sum_fn(x)`` is each chain's rung sum
    of ``x`` (the caller's chain layout), ``bc1`` / ``bc2`` the Adam bias
    corrections in the caller's arithmetic. Returns (log_traj, m1, v2)
    before the clip."""
    dxp = w_prop - rung_sum_fn(w_prop) / n_lad
    dx = w_old - rung_sum_fn(w_old) / n_lad
    dsq = torch.sum(m * dxp * dxp, dim=-1) - torch.sum(m * dx * dx, dim=-1)
    inner = torch.sum(dxp * p_end, dim=-1)
    g_ch = prob * dsq * inner * u_traj
    wsum = torch.clamp(rung_sum_fn(prob), min=1e-6)
    g_log = rung_sum_fn(g_ch) / wsum * tau_traj
    m1 = 0.9 * m1 + 0.1 * g_log
    v2 = 0.999 * v2 + 0.001 * g_log * g_log
    log_traj = log_traj + rate * (m1 / bc1) / (torch.sqrt(v2 / bc2) + 1e-8)
    return log_traj, m1, v2


def _sse(w, x, y, topo):
    fx = fnn.batched_forward(w, x, topo)[:, :, 0]
    return torch.sum(torch.square(y - fx), dim=-1)


def _block_reference(hmc: bool, state: Tensors, noise: Tensors, start: int,
                     length: int, data: dict, adapttemp: torch.Tensor, topo,
                     scal: dict, record_w: bool, diagnostics: bool):
    k_max, c, w_size = noise["w"].shape
    n_tr, n_te = data["n_tr"], data["n_te"]
    sq, nu1, nu2 = scal["sigma_sq"], scal["nu_1"], scal["nu_2"]
    rate = scal["adapt_rate"]
    warm_end, burn_end = scal["warm_end"], scal["burn_end"]
    target = scal["hmc_target"] if hmc else scal["mala_target"]
    chees = hmc and bool(scal["chees"])
    leap = int(scal["leapfrog"]) if hmc else 0
    if chees:
        rungs = int(scal["rungs"])
        panel = rungs * int(scal["n_ladders"])
        n_lad = float(scal["n_ladders"])
    prior_const = _prior_const(topo, sq)
    ll_c = -0.5 * n_tr
    at = adapttemp
    s = dict(state)
    w, wl, gl = s["w"], s["w_last"], s["g_like"]
    pm, p2 = s["pc_mean"], s["pc_m2"]
    eta, ll, pr = s["eta"], s["ll"], s["prior"]
    rtr, rte, na = s["rmse_train"], s["rmse_test"], s["n_accept"]
    lsw, lse = s["log_step_w"], s["log_step_eta"]
    lt, m1, v2 = s.get("log_traj"), s.get("chees_m1"), s.get("chees_v2")
    fl = dict(dtype=w.dtype, device=w.device)
    t_ll = torch.empty((k_max, c), **fl)
    t_rtr = torch.empty((k_max, c), **fl)
    t_rte = torch.empty((k_max, c), **fl)
    t_na = torch.empty((k_max, c), dtype=torch.int32, device=w.device)
    t_tl = torch.zeros((k_max, c), **fl) if hmc else None
    t_w = torch.empty((k_max,) + tuple(w.shape), **fl) if record_w else None
    margin = torch.full((c,), math.inf, **fl)
    traj_margin = torch.full((c,), math.inf, **fl)
    scale = torch.abs(ll)  # the carried ll's term scale (an input: exact)
    t_scale = torch.empty((k_max, c), **fl)
    x_tr, y_tr = data["x_tr"], data["y_tr"]

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
            t_ll[k] = ll / at
            t_scale[k] = scale / at
            t_rtr[k], t_rte[k], t_na[k] = rtr, rte, na
            if record_w:
                t_w[k] = wl
            lse = torch.clamp(lse, _LOG_LO_ETA, _LOG_HI)
            lsw = torch.clamp(lsw, _LOG_LO_W, _LOG_HI)
            if chees:
                lt = _clip_traj(lt, eps, leap)
            continue
        m = _precond_diag(p2, i, scal, w_size)
        tau = torch.exp(eta)
        tat = (tau * at)[:, None]
        g_cur = gl / tat - w / sq
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
            w_c, p_c, g_c = w, p0, g_cur
            sse_c, glr_c = torch.zeros_like(ll), gl
            n_leap = 0 if warm else int(l_steps.max())
            for n in range(n_leap):
                p_half = p_c + 0.5 * epsw * g_c
                w_n = w_c + epsw * m * p_half
                val_n, gl_n = fnn.neg_half_sse_grad(w_n, x_tr, y_tr, topo)
                g_n = gl_n / tat - w_n / sq
                p_n = p_half + 0.5 * epsw * g_n
                # each chain stops at its own count
                upd = float(n) < l_steps
                w_c = torch.where(upd[:, None], w_n, w_c)
                p_c = torch.where(upd[:, None], p_n, p_c)
                g_c = torch.where(upd[:, None], g_n, g_c)
                sse_c = torch.where(upd, -2.0 * val_n, sse_c)
                glr_c = torch.where(upd[:, None], gl_n, glr_c)
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
        pr_prop = prior_const - ssq / (2.0 * sq) - (1.0 + nu1) * eta - nu2 / tau
        if hmc and not warm:  # the last leapfrog step evaluated w_prop
            sse_tr, g_rows = sse_c, glr_c
        else:
            val, g_rows = fnn.neg_half_sse_grad(w_prop, x_tr, y_tr, topo)
            sse_tr = -2.0 * val
        sse_te = _sse(w_prop, data["x_te"], data["y_te"], topo)
        ll_norm = ll_c * (likelihood._LOG_2PI + eta)
        ll_prop = ll_norm - 0.5 * sse_tr / tau
        if hmc:
            diff = k_init - k_end
        else:
            g_prop = g_rows / tat - w_prop / sq
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
            scale_prop = torch.abs(ll_norm) + torch.abs(0.5 * sse_tr / tau)
            t_scale[k] = scale_prop / at
            scale = torch.where(accept, scale_prop, scale)
        t_ll[k] = ll_prop / at
        rtr = torch.where(accept, torch.sqrt(sse_tr / n_tr), rtr)
        rte = torch.where(accept, torch.sqrt(sse_te / n_te), rte)
        t_rtr[k], t_rte[k], t_na[k] = rtr, rte, na
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
        # --- the eta block (dataset-free) -----------------------------------
        eta_prop, ll_eta, dprior, mh_e = eta_move(
            eta, ll, lse, noise["eta"][k], n_tr, at, nu1, nu2)
        acc_e = noise["u_eta"][k] < mh_e
        if diagnostics:
            margin = torch.minimum(margin, torch.abs(noise["u_eta"][k] - mh_e))
            half_norm = 0.5 * n_tr * (likelihood._LOG_2PI + eta)
            scale_eta = (torch.abs(ll_c * (likelihood._LOG_2PI + eta_prop))
                         + (scale + torch.abs(half_norm))
                         * torch.exp(eta - eta_prop))
            scale = torch.where(acc_e, scale_eta, scale)
        eta = torch.where(acc_e, eta_prop, eta)
        ll = torch.where(acc_e, ll_eta, ll)
        pr = pr + torch.where(acc_e, dprior, torch.zeros_like(dprior))
        if i < burn_end:
            lse = lse + rate * (mh_e - ETA_TARGET_ACCEPT)
        lse = torch.clamp(lse, _LOG_LO_ETA, _LOG_HI)
        adapting = warm_end <= i < burn_end
        # --- ChEES: Adam on log_traj from the panel's rung means -------------
        if chees:
            if adapting:
                t_ad = float(max(min(i, burn_end) - warm_end, 0) + 1)
                lt, m1, v2 = chees_adam(
                    lt, m1, v2, w_prop, w_old, m, p_c, a, u_t, tau_traj,
                    lambda x: rung_sum(x, panel, rungs), n_lad,
                    1.0 - math.exp(t_ad * _LOG09),
                    1.0 - math.exp(t_ad * _LOG0999), scal["chees_rate"])
            lt = _clip_traj(lt, eps, leap)
        # --- Welford accumulation and the Robbins-Monro w scale --------------
        if adapting:
            pm, p2, lsw = adapt_w(pm, p2, lsw, w, a, i, warm_end, burn_end,
                                  rate, target)
        lsw = torch.clamp(lsw, _LOG_LO_W, _LOG_HI)

    new = dict(w=w, w_last=wl, g_like=gl, pc_mean=pm, pc_m2=p2, eta=eta,
               ll=ll, prior=pr, rmse_train=rtr, rmse_test=rte, n_accept=na,
               log_step_w=lsw, log_step_eta=lse)
    if lt is not None:
        new.update(log_traj=lt, chees_m1=m1, chees_v2=v2)
    traces = dict(ll=t_ll, rmse_train=t_rtr, rmse_test=t_rte, accept_count=t_na)
    if hmc:
        traces["traj_len"] = t_tl
    if record_w:
        traces["w"] = t_w
    if diagnostics:
        traces.update(margin=margin, traj_margin=traj_margin,
                      ll_scale=t_scale, ll_scale_final=scale)
    return new, traces


def mala_block_reference(state: Tensors, noise: Tensors, start: int,
                         length: int, data: dict, adapttemp: torch.Tensor,
                         topo, scal: dict, record_w: bool = True,
                         diagnostics: bool = False):
    """The plain PyTorch version of ``fused_mala_block``, on any device, in
    the dtype of its inputs.

    ``diagnostics=True`` adds ``margin`` (C,), the smallest ``|u - a|`` of
    the w block (past the warm start) and of the eta block over the live
    steps; ``traj_margin`` (C,), inf here; and ``ll_scale`` (K, C) /
    ``ll_scale_final`` (C,), the size of the terms that cancel in each
    recorded ll and in the carried one (through both blocks).
    """
    return _block_reference(False, state, noise, start, length, data,
                            adapttemp, topo, scal, record_w, diagnostics)


def hmc_block_reference(state: Tensors, noise: Tensors, start: int,
                        length: int, data: dict, adapttemp: torch.Tensor,
                        topo, scal: dict, record_w: bool = True,
                        diagnostics: bool = False):
    """The plain PyTorch version of ``fused_hmc_block``; diagnostics as
    ``mala_block_reference``, and under ChEES ``traj_margin`` (C,) is the
    smallest distance of ``tau_traj / eps`` to an integer at which the
    clipped leapfrog count changes, over the live steps."""
    return _block_reference(True, state, noise, start, length, data,
                            adapttemp, topo, scal, record_w, diagnostics)


# ---------------------------------------------------------------------------
# The CUDA launch.

_IN_VEC = ("w", "w_last", "g_like", "pc_mean", "pc_m2")
_IN_C = ("eta", "ll", "prior", "rmse_train", "rmse_test", "log_step_w",
         "log_step_eta")
_CHEES_C = ("log_traj", "chees_m1", "chees_v2")


class PrecondParams(ctypes.Structure):
    """Mirror of ``struct PrecondParams`` in csrc/precond_common.cuh (same
    field order)."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "rows", "at", "w", "w_last", "g_like", "pc_mean", "pc_m2", "eta",
            "ll", "prior", "rmse_tr", "rmse_te", "n_accept", "log_step_w",
            "log_step_eta", "log_traj", "chees_m1", "chees_v2", "noise_w",
            "noise_eta", "u", "u_eta", "u_jit", "u_traj",
            "o_w", "o_w_last", "o_g_like", "o_pc_mean", "o_pc_m2", "o_eta",
            "o_ll", "o_prior", "o_rmse_tr", "o_rmse_te", "o_n_accept",
            "o_log_step_w", "o_log_step_eta", "o_log_traj", "o_chees_m1",
            "o_chees_v2", "t_ll", "t_rmse_tr", "t_rmse_te", "t_accept",
            "t_traj_len", "t_w", "exch",
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
            "sigma_sq", "one_plus_nu1", "nu2", "adapt_rate", "target",
            "eta_target", "warmstart_step", "precond_power", "eps_jitter",
            "chees_rate", "n_ladders_f", "prior_const", "ll_const", "log_2pi",
            "n_tr_f", "n_te_f", "w_size_f", "log_lo_w", "log_lo_eta",
            "log_hi", "log_traj_lo", "log09", "log0999",
        )
    ]


def smem_bytes(n_rows: int, n_in: int, chees: bool, hmc: bool = False) -> int:
    """Dynamic shared memory of one CUDA block, the data rows (padded to 16
    bytes) and then: for MALA, whatever the warps a chain, per warp a
    broadcast slot and two parities of its partial slot (64 floats each);
    for HMC (``hmc``), six 64-float vectors per chain and, under ChEES, two
    parities of the exchange slots (w', w_old and two scalars) per chain."""
    rows = (n_rows * (n_in + 1) + 3) // 4 * 4
    if not hmc:
        return 4 * (rows + _mala_warps() * 3 * _common("VEC"))
    per_chain = 6 * _common("VEC") + (2 * _ex_floats() if chees else 0)
    return 4 * (rows + _hmc("HMC_WARPS") * per_chain)


class MalaPlan(NamedTuple):
    """One launch of a MALA kernel (regression or classification): ``wpc``
    warps a chain, ``per_block`` chains a block, ``blocks``, ``smem`` bytes
    a block, ``why``; ``variant`` "fixed" (a compile-time network, the
    chain's vectors in registers) or "generic" (``gen_layout``: ``warps``
    warps a block, the vectors in "shared" or "device" memory)."""
    wpc: int
    per_block: int
    blocks: int
    smem: int
    why: str
    variant: str = "fixed"
    warps: int = 8
    vectors: str = "registers"


class HmcPlan(NamedTuple):
    """One launch of an HMC kernel: ``wpc`` warps a chain, ``per_block``
    chains a block, ``blocks``, ``cluster`` blocks a panel (1 without
    ChEES), ``route`` (one of ROUTES), ``smem`` bytes a block, ``why``;
    ``variant``, ``warps`` and ``vectors`` as ``MalaPlan``'s."""
    wpc: int
    per_block: int
    blocks: int
    cluster: int
    route: str
    smem: int
    why: str
    variant: str = "fixed"
    warps: int = 8
    vectors: str = "registers"


def warp_plan(chains: int, warps: int, sms: int, wpcs: Sequence[int],
              smem: int) -> MalaPlan:
    """The launch of a kernel that spreads a chain's rows over WPC of a
    block's ``warps`` warps, for ``chains`` chains on a card of ``sms`` SMs
    (pure Python): the largest of ``wpcs`` whose blocks fit one wave of the
    card, one block an SM (a block takes the SM's registers); past that,
    one warp a chain in waves. More warps a chain shorten each evaluation;
    more than one wave would run the blocks one after the other. Every
    MALA kernel takes this rule."""
    for wpc in wpcs:
        per = warps // wpc
        blocks = -(-chains // per)
        if blocks <= sms:
            return MalaPlan(wpc, per, blocks, smem,
                            f"WPC {wpc}: {blocks} blocks fit one wave of "
                            f"{sms} SMs")
    blocks = -(-chains // warps)
    return MalaPlan(1, warps, blocks, smem,
                    f"WPC 1: {blocks} blocks in waves over {sms} SMs")


# --- the generic route (csrc/gen_chain.cuh): any (I, H, O) -----------------

GEN_WARPS = (8, 4, 2, 1)  # warps a block of a generic kernel, largest first
GEN_VECTORS = {"mala": 7, "hmc": 9}  # a warp's vectors outside its eval slot


def gen_dims(topo) -> Tuple[int, int]:
    """(VEC, STRIDE) of the generic route: a chain vector's floats (w_size
    rounded up to 32; lane l owns entries l, l + 32, ...) and the odd
    stride of a row's backprop record [s (H), dh (H), d2 (O), x (I), 1]."""
    n_in, n_hid, n_out = (int(d) for d in topo)
    vec = 32 * -(-fnn.w_size(topo) // 32)
    return vec, (2 * n_hid + n_out + n_in + 1) | 1


def gen_smem_bytes(n_rows: int, topo, kind: str, warps: int, vectors: str,
                   ex_chains: int = 0) -> int:
    """Dynamic shared memory of one block of a generic kernel: the data rows
    (padded to 16 bytes); per warp its evaluation slot (VEC floats), a
    32-row record tile (32 x STRIDE) and, with ``vectors`` "shared", its
    GEN_VECTORS[kind] vectors; per warp two parities of its partial slot
    (VEC + GEN_PART floats); and, for the ChEES cluster route, two parities
    of ``ex_chains`` chains' exchange slots (w', w_old, two scalars)."""
    vec, stride = gen_dims(topo)
    rows = (n_rows * (int(topo[0]) + 1) + 3) // 4 * 4
    own = GEN_VECTORS[kind] * vec if vectors == "shared" else 0
    part = _build.cu_define("gen_chain.cuh", "GEN_PART")
    return 4 * (rows + warps * (vec + 32 * stride + own + 2 * (vec + part))
                + ex_chains * 2 * (2 * vec + 4))


class GenLayout(NamedTuple):
    """Where a generic kernel keeps a block's warps' state: ``warps`` warps
    a block, the vectors in ``vectors`` ("shared" or "device") memory,
    ``smem`` bytes a block without ChEES slots."""
    warps: int
    vectors: str
    smem: int


def gen_layout(kind: str, n_rows: int, topo) -> GenLayout:
    """The generic kernel's layout for ``kind`` ("mala" or "hmc") on
    ``n_rows`` data rows of ``topo`` (pure Python): eight warps with their
    vectors in shared memory when that fits a Hopper block, else the
    vectors in device memory (each warp its own slots, through L1) with the
    most warps, eight down to one, whose record tiles fit beside the rows.
    Raises ValueError where not even one warp fits: no Hopper plan."""
    cands = [(GEN_WARPS[0], "shared")] + [(w, "device") for w in GEN_WARPS]
    for warps, where in cands:
        smem = gen_smem_bytes(n_rows, topo, kind, warps, where)
        if smem <= _SMEM_LIMIT:
            return GenLayout(warps, where, smem)
    raise ValueError(
        f"no Hopper plan fits {kind} at {tuple(topo)} on {n_rows} rows: the "
        f"rows, one warp's record tile and its slots need {smem} bytes of "
        f"shared memory; a Hopper block has {_SMEM_LIMIT}")


def gen_mala_plan(chains: int, n_rows: int, topo, sms: int) -> MalaPlan:
    """The generic MALA launch (pure Python): ``gen_layout``'s block,
    ``warp_plan``'s rule over the warps a chain that divide it."""
    lay = gen_layout("mala", n_rows, topo)
    wpcs = [w for w in GEN_WARPS if w <= lay.warps]
    return warp_plan(chains, lay.warps, sms, wpcs, lay.smem)._replace(
        variant="generic", warps=lay.warps, vectors=lay.vectors)


def gen_hmc_plan(chains: int, panel: int, n_rows: int, topo, sms: int,
                 fits: Callable[[int, int, int], int],
                 coop: Callable[[int, int], int]) -> HmcPlan:
    """The generic HMC launch (pure Python, given the card's occupancy:
    ``fits(threads, smem, cluster)`` clusters of ``cluster`` blocks at
    once, ``coop(threads, smem)`` blocks of the grid route at once).
    Without ChEES (``panel`` 0), ``warp_plan``'s rule. Under ChEES, the
    largest WPC at which every panel's exchange runs at once: one cluster a
    panel when the slots fit beside the block and every panel's cluster
    fits at once, else the cooperative grid when all its blocks fit; else
    clusters in waves at one warp a chain. A panel must tile the chains
    and, past one panel, cover whole blocks."""
    lay = gen_layout("hmc", n_rows, topo)
    wpcs = [w for w in GEN_WARPS if w <= lay.warps]
    gen = dict(variant="generic", warps=lay.warps, vectors=lay.vectors)
    if not panel:
        m = warp_plan(chains, lay.warps, sms, wpcs, lay.smem)
        return HmcPlan(m.wpc, m.per_block, m.blocks, 1, "plain", m.smem,
                       "no ChEES: no exchange; " + m.why, **gen)
    if chains % panel or (panel != chains and panel != PANEL):
        raise ValueError(f"ChEES panel of {panel} chains does not tile "
                         f"{chains} chains")
    most, threads = _hmc("HMC_MAX_CLUSTER"), 32 * lay.warps
    n_panels = chains // panel

    def cluster_smem(per):
        return gen_smem_bytes(n_rows, topo, "hmc", lay.warps, lay.vectors,
                              ex_chains=per)

    for wpc in wpcs:
        per = lay.warps // wpc
        blocks, cluster = -(-chains // per), -(-panel // per)
        if n_panels > 1 and panel % per:
            continue
        smem = cluster_smem(per)
        if cluster <= most and smem <= _SMEM_LIMIT:
            n_fit = fits(threads, smem, cluster)
            if n_fit >= n_panels:
                return HmcPlan(wpc, per, blocks, cluster, "cluster", smem,
                               f"WPC {wpc}: {n_fit} clusters of {cluster} "
                               f"blocks fit at once, {n_panels} panels",
                               **gen)
        n_coop = coop(threads, lay.smem)
        if blocks <= n_coop:
            return HmcPlan(wpc, per, blocks, cluster, "grid", lay.smem,
                           f"WPC {wpc}: all {blocks} blocks fit at once "
                           f"({n_coop})", **gen)
    per = lay.warps
    blocks, cluster = -(-chains // per), -(-panel // per)
    smem = cluster_smem(per)
    if (cluster <= most and smem <= _SMEM_LIMIT
            and fits(threads, smem, cluster) >= 1):
        return HmcPlan(1, per, blocks, cluster, "cluster", smem,
                       f"WPC 1: {n_panels} clusters of {cluster} blocks in "
                       f"waves", **gen)
    raise ValueError(f"a ChEES panel of {panel} chains fits neither one "
                     f"cluster of {most} blocks nor the card at once")


@functools.lru_cache(maxsize=None)
def _gen_occupancy(lib_name: str, prefix: str, device_index: int,
                   what: str, threads: int, smem: int, cluster: int) -> int:
    lib = _build.build(lib_name).lib
    out = ctypes.c_int(0)
    if what == "clusters":
        err = getattr(lib, f"{prefix}_max_active_clusters")(
            threads, smem, cluster, ctypes.byref(out))
    else:
        err = getattr(lib, f"{prefix}_coop_blocks")(threads, smem,
                                                    ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{prefix} occupancy query failed: "
                           f"{_build.error_string(lib, err)}")
    return out.value


def card_gen_hmc_plan(lib_name: str, prefix: str, device, chains: int,
                      panel: int, n_rows: int, topo) -> HmcPlan:
    """``gen_hmc_plan`` with the SM count and occupancy of the card
    ``device``, from the generic kernel of ``lib_name`` (its queries
    ``<prefix>_max_active_clusters`` and ``<prefix>_coop_blocks``)."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        return gen_hmc_plan(
            chains, panel, n_rows, topo, sm_count(dev),
            fits=lambda t, s, c: _gen_occupancy(lib_name, prefix, index,
                                                "clusters", t, s, c),
            coop=lambda t, s: _gen_occupancy(lib_name, prefix, index, "coop",
                                             t, s, 0))


class GenShape(ctypes.Structure):
    """Mirror of ``struct GenShape`` in csrc/gen_chain.cuh (same field
    order): the network and the generic kernel's layout of a launch."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "ni", "nh", "no", "w", "vec", "stride", "warps", "wpc", "nv",
        "vec_dev")]


def gen_shape(topo, plan, kind: str) -> GenShape:
    """The ``GenShape`` of a generic launch of ``plan`` at ``topo``."""
    vec, stride = gen_dims(topo)
    return GenShape(ni=int(topo[0]), nh=int(topo[1]), no=int(topo[2]),
                    w=fnn.w_size(topo), vec=vec, stride=stride,
                    warps=plan.warps, wpc=plan.wpc, nv=GEN_VECTORS[kind],
                    vec_dev=int(plan.vectors == "device"))


def gen_device_vectors(plan, kind: str, topo, device):
    """The device-memory vector slots of a generic launch whose plan keeps
    them there (blocks x warps x GEN_VECTORS[kind] x VEC floats), else
    None."""
    if plan.vectors != "device":
        return None
    vec = gen_dims(topo)[0]
    return torch.empty((plan.blocks * plan.warps * GEN_VECTORS[kind] * vec,),
                       dtype=torch.float32, device=device)


def mala_launch_plan(chains: int, n_rows: int, sms: int,
                     topo=TOPOLOGIES[0]) -> MalaPlan:
    """The regression MALA kernel's launch for ``chains`` chains on
    ``n_rows`` data rows, on a card of ``sms`` SMs (pure Python;
    ``warp_plan``'s rule): the fixed (4, 10, 1) kernel, or the generic
    route for any other ``topo`` (``gen_mala_plan``)."""
    if tuple(topo) not in TOPOLOGIES:
        return gen_mala_plan(chains, n_rows, topo, sms)
    return warp_plan(chains, _mala_warps(), sms, MALA_WPCS,
                     smem_bytes(n_rows, TOPOLOGIES[0][0], False))


def card_mala_plan(device, chains: int, n_rows: int,
                   topo=TOPOLOGIES[0]) -> MalaPlan:
    """``mala_launch_plan`` with the SM count of the card ``device``."""
    return mala_launch_plan(chains, n_rows, sm_count(device), topo)


def card_hmc_plan(device, chains: int, panel: int, n_rows: int,
                  topo) -> HmcPlan:
    """The regression HMC launch on the card ``device``: the fixed (4, 10,
    1) kernel (``hmc_layout``, ``hmc_route``: 8 chains a block, one warp
    each), or the generic route (``gen_hmc_plan``)."""
    if tuple(topo) in TOPOLOGIES:
        blocks, cluster = hmc_layout(chains, panel)
        smem = smem_bytes(n_rows, topo[0], bool(panel), True)
        route, why = hmc_route(device, smem, cluster, hmc_layout(chains)[0],
                               bool(panel))
        return HmcPlan(1, _hmc("HMC_WARPS"), blocks, cluster, route, smem,
                       why, warps=_hmc("HMC_WARPS"), vectors="shared")
    return card_gen_hmc_plan("hmc_block", "ptnn_hmc_gen", device, chains,
                             panel, n_rows, topo)


@functools.lru_cache(maxsize=None)
def _route_of(device_index: int, smem: int, cluster: int,
              blocks: int) -> Tuple[str, str]:
    lib = _build.build("hmc_block").lib
    n_panels = blocks // cluster
    fits = ctypes.c_int(0)
    err = lib.ptnn_hmc_max_active_clusters(smem, cluster, ctypes.byref(fits))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"{_build.error_string(lib, err)}")
    if fits.value >= n_panels:
        return "cluster", (f"{fits.value} clusters of {cluster} blocks fit "
                           f"at once, {n_panels} panels")
    coop = ctypes.c_int(0)
    err = lib.ptnn_hmc_coop_blocks(smem, ctypes.byref(coop))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: "
                           f"{_build.error_string(lib, err)}")
    if blocks <= coop.value:
        return "grid", (f"only {fits.value} clusters of {cluster} blocks fit "
                        f"at once for {n_panels} panels; all {blocks} blocks "
                        f"fit ({coop.value})")
    return "cluster", (f"{fits.value} clusters of {cluster} blocks fit at "
                       f"once for {n_panels} panels, and the grid of "
                       f"{blocks} blocks does not ({coop.value}): clusters "
                       f"in waves")


def hmc_route(device, smem: int, cluster: int, blocks: int,
              chees: bool = True) -> Tuple[str, str]:
    """(route, why) of an HMC launch on the card ``device``: "plain"
    without ChEES; "cluster" when every panel's cluster fits on the card at
    once (cudaOccupancyMaxActiveClusters); else "grid", a cooperative launch,
    when the whole grid fits; else clusters in waves."""
    if not chees:
        return "plain", "no ChEES: no exchange"
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        return _route_of(index, smem, cluster, blocks)


def _launch_cuda(name: str, state: Tensors, noise: Tensors, start: int,
                 length: int, data: dict, adapttemp: torch.Tensor, topo,
                 scal: dict, record_w: bool):
    hmc = name == "hmc_block"
    chees = hmc and bool(scal["chees"])
    lib = _build.build(name).lib
    dev = noise["w"].device
    k_max, c, w_dim = noise["w"].shape
    n_in, n_hid, n_out = topo
    n_tr, n_te = int(data["n_tr"]), int(data["n_te"])
    if n_out != 1:
        raise ValueError(f"the CUDA {name} kernel is regression: one output, "
                         f"not {tuple(topo)}")
    if w_dim != fnn.w_size(topo):
        raise ValueError(f"noise width {w_dim} does not fit topology {topo}")
    if not 0 <= int(length) <= k_max:
        raise ValueError(f"length {length} outside [0, {k_max}]")
    fixed = tuple(topo) in TOPOLOGIES
    if fixed:
        smem = smem_bytes(n_tr + n_te, n_in, chees, hmc)
        if smem > _SMEM_LIMIT:
            raise ValueError(
                f"{n_tr}+{n_te} data rows need {smem} bytes of shared memory "
                f"per block; a Hopper block has {_SMEM_LIMIT}")
    rungs = panel = 1
    if chees:
        rungs = int(scal["rungs"])
        panel = rungs * int(scal["n_ladders"])
    if hmc:
        plan = card_hmc_plan(dev, c, panel if chees else 0, n_tr + n_te,
                             topo)
    else:
        plan = card_mala_plan(dev, c, n_tr + n_te, topo)
    smem, cluster, route = plan.smem, getattr(plan, "cluster", 1), None
    f32, i32 = torch.float32, torch.int32
    _check(data["rows"], "rows", (n_tr + n_te, n_in + 1), f32, dev)
    _check(adapttemp, "adapttemp", (c,), f32, dev)
    for key in ("eta", "u", "u_eta") + (("u_jit",) if hmc else ()):
        _check(noise[key], "noise " + key, (k_max, c), f32, dev)
    if chees:
        _check(noise["u_traj"], "noise u_traj", (k_max,), f32, dev)
    for key in _IN_VEC:
        _check(state[key], key, (c, w_dim), f32, dev)
    for key in _IN_C + (_CHEES_C if chees else ()):
        _check(state[key], key, (c,), f32, dev)
    _check(state["n_accept"], "n_accept", (c,), i32, dev)

    keys = _IN_VEC + _IN_C + ("n_accept",) + (_CHEES_C if chees else ())
    new = {k: torch.empty_like(state[k]) for k in keys}
    kc = lambda dt=f32: torch.empty((k_max, c), dtype=dt, device=dev)
    tr = dict(ll=kc(), rmse_train=kc(), rmse_test=kc(), accept_count=kc(i32))
    if hmc:
        tr["traj_len"] = kc()
    if record_w:
        tr["w"] = torch.empty((k_max, c, w_dim), dtype=f32, device=dev)
    exch = None
    if hmc:
        route = plan.route
        if route == "grid":  # (C, 2, EX) slots in device memory
            ex = _ex_floats() if fixed else 2 * gen_dims(topo)[0] + 4
            exch = torch.empty((c, 2, ex), dtype=f32, device=dev)
    p = lambda t: None if t is None else t.data_ptr()
    g = lambda d, k: p(d.get(k))
    sq = float(scal["sigma_sq"])
    target = scal["hmc_target"] if hmc else scal["mala_target"]
    params = PrecondParams(
        rows=p(data["rows"]), at=p(adapttemp),
        w=p(state["w"]), w_last=p(state["w_last"]),
        g_like=p(state["g_like"]), pc_mean=p(state["pc_mean"]),
        pc_m2=p(state["pc_m2"]), eta=p(state["eta"]), ll=p(state["ll"]),
        prior=p(state["prior"]), rmse_tr=p(state["rmse_train"]),
        rmse_te=p(state["rmse_test"]), n_accept=p(state["n_accept"]),
        log_step_w=p(state["log_step_w"]),
        log_step_eta=p(state["log_step_eta"]),
        log_traj=g(state, "log_traj") if chees else None,
        chees_m1=g(state, "chees_m1") if chees else None,
        chees_v2=g(state, "chees_v2") if chees else None,
        noise_w=p(noise["w"]), noise_eta=p(noise["eta"]), u=p(noise["u"]),
        u_eta=p(noise["u_eta"]), u_jit=g(noise, "u_jit") if hmc else None,
        u_traj=g(noise, "u_traj") if chees else None,
        o_w=p(new["w"]), o_w_last=p(new["w_last"]),
        o_g_like=p(new["g_like"]), o_pc_mean=p(new["pc_mean"]),
        o_pc_m2=p(new["pc_m2"]), o_eta=p(new["eta"]), o_ll=p(new["ll"]),
        o_prior=p(new["prior"]), o_rmse_tr=p(new["rmse_train"]),
        o_rmse_te=p(new["rmse_test"]), o_n_accept=p(new["n_accept"]),
        o_log_step_w=p(new["log_step_w"]),
        o_log_step_eta=p(new["log_step_eta"]),
        o_log_traj=g(new, "log_traj"), o_chees_m1=g(new, "chees_m1"),
        o_chees_v2=g(new, "chees_v2"),
        t_ll=p(tr["ll"]), t_rmse_tr=p(tr["rmse_train"]),
        t_rmse_te=p(tr["rmse_test"]), t_accept=p(tr["accept_count"]),
        t_traj_len=g(tr, "traj_len"), t_w=g(tr, "w"), exch=p(exch),
        n_tr=n_tr, n_te=n_te, chains=c, k_max=k_max, start=int(start),
        length=int(length), pc_start=int(scal["pc_start"]),
        warm_end=int(scal["warm_end"]), burn_end=int(scal["burn_end"]),
        leapfrog=int(scal["leapfrog"]) if hmc else 0, chees=int(chees),
        rungs=rungs, panel=panel,
        sigma_sq=sq, one_plus_nu1=1.0 + float(scal["nu_1"]),
        nu2=float(scal["nu_2"]), adapt_rate=float(scal["adapt_rate"]),
        target=float(target), eta_target=ETA_TARGET_ACCEPT,
        warmstart_step=float(scal["warmstart_step"]),
        precond_power=float(scal["precond_power"]),
        eps_jitter=float(scal["eps_jitter"]) if hmc else 0.0,
        chees_rate=float(scal["chees_rate"]) if chees else 0.0,
        n_ladders_f=float(scal["n_ladders"]) if chees else 1.0,
        prior_const=_prior_const(topo, sq), ll_const=-0.5 * n_tr,
        log_2pi=likelihood._LOG_2PI, n_tr_f=float(n_tr), n_te_f=float(n_te),
        w_size_f=float(w_dim), log_lo_w=_LOG_LO_W, log_lo_eta=_LOG_LO_ETA,
        log_hi=_LOG_HI, log_traj_lo=_LOG_TRAJ_LO, log09=_LOG09,
        log0999=_LOG0999,
    )
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if not fixed:
            kind = "hmc" if hmc else "mala"
            shape = gen_shape(topo, plan, kind)
            vdev = gen_device_vectors(plan, kind, topo, dev)
        if hmc and fixed:
            err = lib.ptnn_hmc_block(ctypes.byref(params), smem, cluster,
                                     ROUTES.index(route), stream)
        elif hmc:
            err = lib.ptnn_hmc_gen(ctypes.byref(params), ctypes.byref(shape),
                                   p(vdev), smem, cluster,
                                   ROUTES.index(route), stream)
        elif fixed:
            err = lib.ptnn_mala_block(ctypes.byref(params), smem, plan.wpc,
                                      stream)
        else:
            err = lib.ptnn_mala_gen(ctypes.byref(params), ctypes.byref(shape),
                                    p(vdev), smem, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {_build.error_string(lib, err)}"
        )
    launches[name] += 1
    variant_launches[name][plan.variant] += 1
    if hmc:
        hmc_routes[route] += 1
    else:
        mala_wpcs[plan.wpc] += 1
    if hmc and not chees:  # passed through, as ptnn's kernel does
        for key in _CHEES_C:
            if key in state:
                new[key] = state[key]
    return new, tr


def _dispatch(name, reference, state, noise, start, length, data, adapttemp,
              topo, scal, record_w, launch=None):
    """CPU tensors to ``reference``, CUDA tensors to ``launch`` (this
    module's ``_launch_cuda`` by default), mixed ones raise."""
    tensors = [adapttemp, data["rows"]] + list(noise.values()) + [
        v for v in state.values() if v is not None]
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return reference(state, noise, start, length, data, adapttemp, topo,
                         scal, record_w)
    if kinds == {"cuda"}:
        return (launch or _launch_cuda)(name, state, noise, start, length,
                                        data, adapttemp, topo, scal, record_w)
    raise ValueError(f"fused_{name} needs all tensors on one device type, "
                     f"got {sorted(kinds)}")


def fused_mala_block(state: Tensors, noise: Tensors, start: int, length: int,
                     data: dict, adapttemp: torch.Tensor, topo, scal: dict,
                     record_w: bool = True):
    """One K-step preconditioned-MALA block for all chains ->
    ``(new_state, traces)``.

    ``state`` holds w, w_last, g_like, pc_mean, pc_m2 (C, W), eta, ll,
    prior, rmse_train, rmse_test, log_step_w, log_step_eta (C,) float32 and
    n_accept (C,) int32. ``noise`` holds "w" (K, C, W) and "eta", "u",
    "u_eta" (K, C). ``scal`` holds sigma_sq, nu_1, nu_2, adapt_rate,
    mala_target, warmstart_step, precond_power, pc_start, warm_end and
    burn_end (``ptnn``'s names). Traces: (K, C) "ll", "rmse_train",
    "rmse_test", "accept_count", plus "w" (K, C, W) when ``record_w``. CUDA
    tensors launch the kernel; CPU tensors take the plain version.
    """
    return _dispatch("mala_block", mala_block_reference, state, noise, start,
                     length, data, adapttemp, topo, scal, record_w)


def fused_hmc_block(state: Tensors, noise: Tensors, start: int, length: int,
                    data: dict, adapttemp: torch.Tensor, topo, scal: dict,
                    record_w: bool = True):
    """One K-step preconditioned-HMC block for all chains.

    As ``fused_mala_block``, and: ``state`` adds log_traj, chees_m1,
    chees_v2 (C,) under ChEES; ``noise`` adds "u_jit" (K, C) and, under
    ChEES, "u_traj" (K,) (``kernel.vdc_u`` of the absolute step);
    ``scal`` has hmc_target in place of mala_target and adds leapfrog,
    eps_jitter, chees, chees_rate, n_ladders (replicas per rung in a panel)
    and rungs. Traces add "traj_len" (K, C).
    """
    return _dispatch("hmc_block", hmc_block_reference, state, noise, start,
                     length, data, adapttemp, topo, scal, record_w)
