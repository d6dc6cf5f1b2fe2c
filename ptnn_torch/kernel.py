"""Chain state, initialisation, the swap event and the temper-switch recompute.

Port of the part of ``ptnn/kernel.py`` that the fused samplers run:
``ChainState`` (only the fields those paths read), ``Dataset``,
``init_state`` (regression and classification, with the preconditioned
MALA/HMC branch), ``swap_due``, ``vdc_u``, and the ``do_swap`` and
``recompute_ll`` closures of ``make_step_fn``, here plain functions. The
per-step ``step`` and ``step_precond`` are not ported yet.

Semantics kept from ``ptnn``: the chain carries its UNTEMPERED train
log-likelihood and divides by the adaptive temperature at decision time;
``w_last`` and the rmse/acc carries are write-on-accept trace carries; a swap
moves (w, eta), and (ll, prior) too unless ``stale_likelihood_after_swap``.
Classification has no noise parameter: eta is zeros and passes through.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ptnn_torch.config import PTConfig
from ptnn_torch.models import fnn
from ptnn_torch.ops import likelihood
from ptnn_torch.parallel import swap as swap_mod


@dataclasses.dataclass
class ChainState:
    """Live sampler state for all chains (leading axis = chains)."""

    w: torch.Tensor  # (C, W) current weights
    eta: torch.Tensor  # (C,) log noise variance
    ll: torch.Tensor  # (C,) untempered train log-likelihood of w
    prior: torch.Tensor  # (C,) log prior of (w, eta)
    w_last: torch.Tensor  # (C, W) last accepted proposal (trace carry)
    rmse_train: torch.Tensor  # (C,) trace carry
    rmse_test: torch.Tensor  # (C,) trace carry
    acc_train: torch.Tensor  # (C,) trace carry, percent (0 for regression)
    acc_test: torch.Tensor  # (C,) trace carry
    log_step_w: Optional[torch.Tensor]  # (C,) or None unless adapt_step_size
    #                                     or a precond_mala/hmc proposal
    # preconditioned MALA/HMC state (None otherwise). g_like is the gradient
    # of the likelihood term at w (-SSE/2, or the multinomial ll) and travels
    # with w on swaps; the Welford buffers and the scales stay with the rung.
    g_like: Optional[torch.Tensor]  # (C, W)
    pc_mean: Optional[torch.Tensor]  # (C, W) Welford running mean of w
    pc_m2: Optional[torch.Tensor]  # (C, W) Welford sum of squared deviations
    log_step_eta: Optional[torch.Tensor]  # (C,) adapted eta RW scale
    #                                       (regression only)
    # ChEES trajectory-length state (None unless hmc_adapt_traj), rung-tied
    log_traj: Optional[torch.Tensor]  # (C,)
    chees_m1: Optional[torch.Tensor]  # (C,) Adam first moment
    chees_v2: Optional[torch.Tensor]  # (C,) Adam second moment
    replica_id: Optional[torch.Tensor]  # (C,) int32 or None unless tracked
    pair_accept_sum: torch.Tensor  # (C,) f32, entry C-1 unused
    pair_prop_count: torch.Tensor  # (C,) int32, entry C-1 unused
    n_accept: torch.Tensor  # (C,) int32
    n_swap_accepted: torch.Tensor  # () int32
    n_swap_proposed: torch.Tensor  # () int32

    def replace(self, **kw) -> "ChainState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "ChainState":
        return ChainState(**{
            k: None if v is None else v.to(device)
            for k, v in vars(self).items()
        })


@dataclasses.dataclass
class Dataset:
    x_train: torch.Tensor  # (N, I) float32
    y_train: torch.Tensor  # (N,)
    x_test: torch.Tensor
    y_test: torch.Tensor


def swap_due(cfg: PTConfig, i: int) -> bool:
    """Whether a replica-exchange sweep runs after step ``i``."""
    si = cfg.swap_interval
    if si <= 0 or si > cfg.n_steps:
        return False
    k = i + cfg.swap_offset
    return k % si == 0 and k > 0


def _reg_eval(cfg: PTConfig, w, x, y, tau):
    fx = fnn.batched_forward(w, x, cfg.topology)[:, :, 0]
    return likelihood.regression_eval_from_fx(fx, y, tau)


def train_loglik(cfg: PTConfig, w: torch.Tensor, eta: torch.Tensor,
                 data: Dataset) -> torch.Tensor:
    """The untempered train log-likelihood of every chain at (w, eta)."""
    if cfg.task == "regression":
        return _reg_eval(cfg, w, data.x_train, data.y_train,
                         torch.exp(eta)).loglik
    return likelihood.classification_eval(w, data.x_train, data.y_train,
                                          cfg.topology).loglik


def vdc_u(i) -> torch.Tensor:
    """Van der Corput base-2 point in (0, 1) for step index ``i`` (int or
    integer array), as float32: ``ptnn.kernel.vdc_u``, the ChEES trajectory
    jitter. The bit reversal runs in int64 masked to 32 bits (the CPU build
    of torch has no shifts on uint32)."""
    x = (torch.as_tensor(i, dtype=torch.int64) + 1) & 0xFFFFFFFF
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                        (8, 0x00FF00FF)):
        x = ((x & mask) << shift) | ((x >> shift) & mask)
    x = ((x << 16) | (x >> 16)) & 0xFFFFFFFF
    # uint32 -> float32 rounds to nearest, as jnp's astype does
    return x.to(torch.float32) / 4294967296.0


def init_state(
    cfg: PTConfig,
    data: Dataset,
    generator: Optional[torch.Generator] = None,
    init_w: Optional[torch.Tensor] = None,
    init_eta: Optional[torch.Tensor] = None,
) -> ChainState:
    """Initial state: standard-normal weights (from ``generator``, or
    ``init_w``), and ll/prior computed at that point. Regression: eta = log
    of the population variance of the initial residuals (or ``init_eta``);
    classification: eta = 0, the multinomial ll and the prior with
    dimension term w_size."""
    cls = cfg.task == "classification"
    dev = data.x_train.device
    c, w_dim = cfg.num_chains, fnn.w_size(cfg.topology)
    if init_w is None:
        w = torch.randn((c, w_dim), generator=generator, device=dev,
                        dtype=torch.float32)
    else:
        w = torch.as_tensor(init_w, dtype=torch.float32, device=dev)
        if tuple(w.shape) != (c, w_dim):
            raise ValueError(f"init_w shape {tuple(w.shape)} != {(c, w_dim)}")
    if cls:
        eta = torch.zeros((c,), dtype=torch.float32, device=dev)
        ll = train_loglik(cfg, w, eta, data)
        prior = likelihood.classification_log_prior(w, cfg.topology,
                                                    cfg.sigma_sq)
    else:
        pred = fnn.batched_forward(w, data.x_train, cfg.topology)[:, :, 0]
        resid = pred - data.y_train[None, :]
        eta = torch.log(torch.var(resid, dim=1, correction=0))
        if init_eta is not None:
            eta = torch.as_tensor(init_eta, dtype=torch.float32, device=dev)
            if tuple(eta.shape) != (c,):
                raise ValueError(
                    f"init_eta shape {tuple(eta.shape)} != {(c,)}")
        tau = torch.exp(eta)
        ll = _reg_eval(cfg, w, data.x_train, data.y_train, tau).loglik
        prior = likelihood.regression_log_prior(
            w, tau, cfg.topology, cfg.sigma_sq, cfg.nu_1, cfg.nu_2
        )

    def zeros(dtype=torch.float32):
        return torch.zeros((c,), dtype=dtype, device=dev)

    precond = cfg.proposal in ("precond_mala", "hmc")
    log_step_w = None
    if cfg.adapt_step_size or precond:
        log_step_w = torch.full((c,), math.log(cfg.step_w),
                                dtype=torch.float32, device=dev)
    g_like = pc_mean = pc_m2 = log_step_eta = None
    if precond:
        pc_mean = torch.zeros_like(w)
        pc_m2 = torch.zeros_like(w)
        if cls:
            g_like = fnn.multinomial_ll_grad(w, data.x_train, data.y_train,
                                             cfg.topology)[1]
        else:
            log_step_eta = torch.full((c,), math.log(cfg.step_eta),
                                      dtype=torch.float32, device=dev)
            g_like = fnn.neg_half_sse_grad(w, data.x_train, data.y_train,
                                           cfg.topology)[1]
    log_traj = chees_m1 = chees_v2 = None
    if cfg.proposal == "hmc" and cfg.hmc_adapt_traj:
        # half the static bound: with the vdc jitter (mean 1/2) the realized
        # L starts near hmc_leapfrog / 4 and ChEES moves it from there
        log_traj = torch.full(
            (c,), math.log(0.5 * cfg.hmc_leapfrog * cfg.step_w),
            dtype=torch.float32, device=dev)
        chees_m1 = zeros()
        chees_v2 = zeros()
    replica_id = None
    if cfg.track_replicas:
        replica_id = torch.arange(c, dtype=torch.int32, device=dev)
    return ChainState(
        w=w,
        eta=eta,
        ll=ll,
        prior=prior,
        w_last=torch.ones_like(w),  # the reference's pos_w rows start at 1
        rmse_train=zeros(),
        rmse_test=zeros(),
        acc_train=zeros(),
        acc_test=zeros(),
        log_step_w=log_step_w,
        g_like=g_like,
        pc_mean=pc_mean,
        pc_m2=pc_m2,
        log_step_eta=log_step_eta,
        log_traj=log_traj,
        chees_m1=chees_m1,
        chees_v2=chees_v2,
        replica_id=replica_id,
        pair_accept_sum=zeros(),
        pair_prop_count=zeros(torch.int32),
        n_accept=zeros(torch.int32),
        n_swap_accepted=torch.zeros((), dtype=torch.int32, device=dev),
        n_swap_proposed=torch.zeros((), dtype=torch.int32, device=dev),
    )


def adapttemp_at(cfg: PTConfig, temps: torch.Tensor, i: int) -> torch.Tensor:
    """The chains' temperatures at step ``i``: the ladder before the temper
    switch, 1 from it on."""
    if i < cfg.temper_switch_step:
        return temps
    return torch.ones_like(temps)


def do_swap(
    cfg: PTConfig,
    state: ChainState,
    temps: torch.Tensor,
    i: int,
    us: torch.Tensor,
    pair_mask: Optional[torch.Tensor] = None,
) -> ChainState:
    """One replica-exchange event after step ``i`` with uniforms ``us``
    (C-1,). ``pair_mask`` comes from ``swap.pair_mask`` for replicated
    ladders."""
    adapttemp = adapttemp_at(cfg, temps, i)
    if cfg.swap_payload == "tempered":
        payload = state.ll / adapttemp
    elif cfg.swap_payload == "tempered_times_T":
        payload = (state.ll / adapttemp) * temps
    else:  # untempered
        payload = state.ll
    if cfg.swap_style == "even_odd":
        res = swap_mod.disjoint_pair_permutation(
            payload, us, rule=cfg.swap_rule, betas=1.0 / adapttemp,
            parity=(i // cfg.swap_interval) % 2, pair_mask=pair_mask,
        )
    else:
        res = swap_mod.sweep_permutation(
            payload, us, rule=cfg.swap_rule, betas=1.0 / adapttemp,
            pair_mask=pair_mask,
        )
    w, eta = swap_mod.apply_permutation(res.perm, state.w, state.eta)
    if cfg.stale_likelihood_after_swap:
        ll, prior = state.ll, state.prior
    else:
        ll, prior = swap_mod.apply_permutation(res.perm, state.ll, state.prior)
    pad = lambda a: torch.nn.functional.pad(a, (0, 1))
    out = state.replace(
        w=w,
        eta=eta,
        ll=ll,
        prior=prior,
        n_swap_accepted=state.n_swap_accepted + res.n_accepted,
        n_swap_proposed=state.n_swap_proposed + res.n_proposed,
        pair_accept_sum=state.pair_accept_sum
        + pad(res.pair_accept.to(torch.float32)),
        pair_prop_count=state.pair_prop_count
        + pad(res.pair_active.to(torch.int32)),
    )
    if state.g_like is not None:
        # a function of w alone: it travels with the configuration, while
        # the preconditioner and the scales stay with the rung
        (g_like,) = swap_mod.apply_permutation(res.perm, state.g_like)
        out = out.replace(g_like=g_like)
    if state.replica_id is not None:
        (rid,) = swap_mod.apply_permutation(res.perm, state.replica_id)
        out = out.replace(replica_id=rid)
    return out


def recompute_ll(cfg: PTConfig, state: ChainState,
                 data: Dataset) -> ChainState:
    """Refresh the carried log-likelihood from the current (w, eta), with
    the accepted eta; the reference does this once, at the temper switch."""
    return state.replace(ll=train_loglik(cfg, state.w, state.eta, data))
