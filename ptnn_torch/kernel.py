"""Chain state, initialisation, the per-step MH steps, the swap event and
the temper-switch recompute.

Port of ``ptnn/kernel.py``: ``ChainState`` (the fields the ported paths
read), ``Dataset``, ``init_state`` (regression and classification, with the
preconditioned family's state), ``like_value_and_grad``, ``swap_due``,
``vdc_u``, the ``do_swap`` and ``recompute_ll`` closures of
``make_step_fn`` as plain functions, and ``make_step_fn``: ``StepFn`` for
the reference proposal (the per-step random walk with the optional
Langevin-gradient drift and its q-ratio, "reference" or "ldpt_legacy"), and
``PrecondStepFn`` for the preconditioned family (``precond_rw``,
``precond_mala``, ``hmc`` with and without ChEES, ``pcn``: ptnn's
``step_precond``).

Every evaluation of the network on data (``train_loglik``,
``init_state``'s ll, ``recompute_ll``) goes through ``spec_eval``, the
step's train and test evals through ``spec_eval_pair``, and the drift
through the model spec's ``drift``. For the reference FNN those are
``ops.fnn_eval.fnn_eval``, ``ops.fnn_eval.fnn_eval_pair`` (one launch for
both row sets) and ``ops.drift.sgd_epoch``, on the card the two
hand-written kernels. Any
other spec (``models.mlp``, ``models.cnn``) evaluates with its
``batched_forward`` where it has one (the CNN's hand-written stage 1), else
its ``forward``, then ``log_probs`` and the likelihood of
``ops.likelihood``; on the card and on the CPU alike (``ptnn`` takes
``batched_forward`` only on a TPU). The gradient proposals take the
likelihood's value and gradient from ``like_value_and_grad``: the FNN's
hand-written backprops, autograd over ``spec.forward`` for the zoo.

Semantics kept from ``ptnn``: the chain carries its UNTEMPERED train
log-likelihood and divides by the adaptive temperature at decision time;
``w_last`` and the rmse/acc carries are write-on-accept trace carries; a swap
moves (w, eta), and (ll, prior) too unless ``stale_likelihood_after_swap``.
Classification has no noise parameter: eta is zeros and passes through.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ptnn_torch.config import PTConfig
from ptnn_torch.models import api as model_api
from ptnn_torch.models import fnn
from ptnn_torch.ops import likelihood, precond_step
from ptnn_torch.ops.block_step import _LOG_STEP_HI, _LOG_STEP_LO
from ptnn_torch.ops.fnn_eval import fnn_eval, fnn_eval_pair
from ptnn_torch.ops.precision import full_float32
from ptnn_torch.parallel import swap as swap_mod


# the preconditioned family (ptnn's ``step_precond``), and its members that
# take the likelihood's gradient
PRECOND = ("precond_rw", "precond_mala", "hmc", "pcn")
GRAD_PROPOSALS = ("precond_mala", "hmc")


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
    #                                     or a preconditioned proposal
    # preconditioned family's state (None otherwise). g_like (precond_mala,
    # hmc) is the gradient of the likelihood term at w (-SSE/2, or the
    # multinomial ll) and travels with w on swaps; the Welford buffers and
    # the scales stay with the rung.
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
    n_langevin: torch.Tensor  # (C,) int32 Langevin proposals made
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
    t_train: Optional[torch.Tensor] = None  # (N, O) delta-rule targets


def swap_due(cfg: PTConfig, i: int) -> bool:
    """Whether a replica-exchange sweep runs after step ``i``."""
    si = cfg.swap_interval
    if si <= 0 or si > cfg.n_steps:
        return False
    k = i + cfg.swap_offset
    return k % si == 0 and k > 0


def default_spec(cfg: PTConfig) -> model_api.ModelSpec:
    """The reference FNN of ``cfg.topology`` with ``cfg.drift_mode``."""
    return model_api.fnn_spec(cfg.topology, cfg.drift_mode)


def spec_eval(cfg: PTConfig, spec: model_api.ModelSpec, w: torch.Tensor,
              x: torch.Tensor, y: torch.Tensor,
              tau: Optional[torch.Tensor]):
    """Every chain's untempered (ll, rmse, acc), each (C,), on the rows
    (x, y): ``_batched_evals`` of ptnn/kernel.py. ``tau`` (C,) is the noise
    variance (regression)."""
    if spec.fnn_topology is not None:
        return fnn_eval(w, x, y, tau, spec.fnn_topology, cfg.task)
    out = (spec.batched_forward or spec.forward)(w, x)
    if cfg.task == "regression":
        ev = likelihood.regression_eval_from_fx(out[:, :, 0], y, tau)
        return ev.loglik, ev.rmse, torch.zeros_like(ev.rmse)
    ev = likelihood.classification_eval_from_logp(spec.log_probs(out), out, y)
    return ev.loglik, ev.rmse, ev.acc


def spec_eval_pair(cfg: PTConfig, spec: model_api.ModelSpec,
                   w: torch.Tensor, x_tr: torch.Tensor, y_tr: torch.Tensor,
                   x_te: torch.Tensor, y_te: torch.Tensor,
                   tau: Optional[torch.Tensor]):
    """``spec_eval`` on the train rows and on the test rows: the reference
    FNN evaluates both in one call (one kernel launch on the card), any
    other spec in two."""
    if spec.fnn_topology is not None:
        return fnn_eval_pair(w, x_tr, y_tr, x_te, y_te, tau,
                             spec.fnn_topology, cfg.task)
    return (spec_eval(cfg, spec, w, x_tr, y_tr, tau),
            spec_eval(cfg, spec, w, x_te, y_te, tau))


def train_loglik(cfg: PTConfig, w: torch.Tensor, eta: torch.Tensor,
                 data: Dataset,
                 spec: Optional[model_api.ModelSpec] = None) -> torch.Tensor:
    """The untempered train log-likelihood of every chain at (w, eta)."""
    return spec_eval(cfg, spec or default_spec(cfg), w, data.x_train,
                     data.y_train, torch.exp(eta))[0]


def recorded_chains(cfg: PTConfig) -> slice:
    """The chains whose w (and eta) rows are traced (``record_w_chains``):
    all, the first k, or under replicated ladders the first k cold rungs."""
    k = cfg.record_w_chains
    if k <= 0:
        return slice(None)
    if cfg.n_ladders > 1:
        return slice(0, k * cfg.rungs_per_ladder, cfg.rungs_per_ladder)
    return slice(0, k)


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


ValueAndGrad = Callable[[torch.Tensor],
                        Tuple[Tuple[torch.Tensor, Optional[torch.Tensor]],
                              torch.Tensor]]


def like_value_and_grad(cfg: PTConfig, spec: model_api.ModelSpec,
                        data: Dataset) -> ValueAndGrad:
    """ptnn's ``_like_value_and_grad``: ``fn(w (C, W)) -> ((val, aux), g)``.
    ``val`` (C,) is the temperature- and tau-free likelihood term, -SSE/2
    for regression and the multinomial log-likelihood for classification;
    ``aux`` the raw outputs (C, N, O) the classification metrics need (None
    for the FNN's regression, whose metrics come from ``val``); ``g`` (C, W)
    is d val / d w. The reference FNN takes its hand-written backprops
    (``fnn.neg_half_sse_grad``, ``fnn.multinomial_ll_grad``), any other
    spec autograd over ``spec.forward`` in full float32 (ptnn runs at
    ``Precision.HIGHEST``). With ``drift_chain_microbatch`` > 1 the chains
    go in that many sequential chunks, as the drift does."""
    x, y = data.x_train, data.y_train
    reg = cfg.task == "regression"
    topo = spec.fnn_topology

    def one(w):
        if topo is not None:
            if reg:
                val, g = fnn.neg_half_sse_grad(w, x, y, topo)
                return (val, None), g
            val, g, out = fnn.multinomial_ll_grad(w, x, y, topo)
            return (val, out), g
        with torch.enable_grad(), full_float32():
            wg = w.detach().requires_grad_(True)
            out = spec.forward(wg, x)
            if reg:
                val = -0.5 * torch.sum(torch.square(y - out[:, :, 0]), dim=-1)
            else:
                logp = spec.log_probs(out)
                idx = y.to(torch.int64).expand(logp.shape[:-1])[..., None]
                val = torch.sum(torch.gather(logp, -1, idx)[..., 0], dim=-1)
            (g,) = torch.autograd.grad(val.sum(), wg)
        return (val.detach(), out.detach()), g

    mb = cfg.drift_chain_microbatch
    if mb <= 1:
        return one

    def chunked(w):
        parts = [one(wk) for wk in w.chunk(mb)]
        cat = lambda xs: None if xs[0] is None else torch.cat(xs)
        return ((cat([p[0][0] for p in parts]), cat([p[0][1] for p in parts])),
                cat([p[1] for p in parts]))

    return chunked


def init_state(
    cfg: PTConfig,
    data: Dataset,
    generator: Optional[torch.Generator] = None,
    init_w: Optional[torch.Tensor] = None,
    init_eta: Optional[torch.Tensor] = None,
    spec: Optional[model_api.ModelSpec] = None,
) -> ChainState:
    """Initial state: standard-normal weights (from ``generator``, or
    ``init_w``), and ll/prior computed at that point. Regression: eta = log
    of the population variance of the initial residuals (or ``init_eta``);
    classification: eta = 0, the multinomial ll and the prior with
    dimension term w_size. ``spec`` defaults to the reference FNN."""
    cls = cfg.task == "classification"
    dev = data.x_train.device
    spec = spec or default_spec(cfg)
    precond = cfg.proposal in PRECOND
    c, w_dim = cfg.num_chains, spec.w_size
    if init_w is None:
        w = torch.randn((c, w_dim), generator=generator, device=dev,
                        dtype=torch.float32)
    else:
        w = torch.as_tensor(init_w, dtype=torch.float32, device=dev)
        if tuple(w.shape) != (c, w_dim):
            raise ValueError(f"init_w shape {tuple(w.shape)} != {(c, w_dim)}")
    if cls:
        eta = torch.zeros((c,), dtype=torch.float32, device=dev)
        ll = train_loglik(cfg, w, eta, data, spec)
        prior = likelihood.classification_log_prior_dim(
            w, spec.prior_dim_classification, cfg.sigma_sq)
    else:
        pred = spec.forward(w, data.x_train)[:, :, 0]
        resid = pred - data.y_train[None, :]
        eta = torch.log(torch.var(resid, dim=1, correction=0))
        if init_eta is not None:
            eta = torch.as_tensor(init_eta, dtype=torch.float32, device=dev)
            if tuple(eta.shape) != (c,):
                raise ValueError(
                    f"init_eta shape {tuple(eta.shape)} != {(c,)}")
        tau = torch.exp(eta)
        ll = train_loglik(cfg, w, eta, data, spec)
        prior = likelihood.regression_log_prior_dim(
            w, tau, spec.prior_dim_regression, cfg.sigma_sq, cfg.nu_1,
            cfg.nu_2)

    def zeros(dtype=torch.float32):
        return torch.zeros((c,), dtype=dtype, device=dev)

    log_step_w = None
    if cfg.adapt_step_size or precond:
        log_step_w = torch.full((c,), math.log(cfg.step_w),
                                dtype=torch.float32, device=dev)
    g_like = pc_mean = pc_m2 = log_step_eta = None
    if precond:
        pc_mean = torch.zeros_like(w)
        pc_m2 = torch.zeros_like(w)
        if not cls:
            log_step_eta = torch.full((c,), math.log(cfg.step_eta),
                                      dtype=torch.float32, device=dev)
        if cfg.proposal in GRAD_PROPOSALS:
            g_like = like_value_and_grad(cfg, spec, data)(w)[1]
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
        n_langevin=zeros(torch.int32),
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


def recompute_ll(cfg: PTConfig, state: ChainState, data: Dataset,
                 spec: Optional[model_api.ModelSpec] = None) -> ChainState:
    """Refresh the carried log-likelihood from the current (w, eta), with
    the accepted eta; the reference does this once, at the temper switch."""
    return state.replace(ll=train_loglik(cfg, state.w, state.eta, data, spec))


# ---------------------------------------------------------------------------
# The per-step sampler's step (ptnn/kernel.py make_step_fn, proposal
# "reference").

Noise = Dict[str, torch.Tensor]


def step_reason(cfg: PTConfig,
                spec: Optional[model_api.ModelSpec] = None) -> Optional[str]:
    """The feature of ``cfg`` the per-step sampler does not run yet on
    ``spec`` (default: the reference FNN); None: it runs ``cfg``."""
    if cfg.proposal == "sgld":
        return ("proposal='sgld' (the model zoo's stochastic-gradient "
                "proposals)")
    for flag in ("use_surrogate", "variational_reference", "record_fx",
                 "record_ll_state"):
        if getattr(cfg, flag):
            return flag
    if cfg.record_thin != 1:
        return "record_thin > 1"
    if cfg.eval_dtype != "float32":
        return f"eval_dtype={cfg.eval_dtype!r}"
    if cfg.adapt_step_size and cfg.use_langevin_gradients and not (
            spec is not None and spec.drift_per_chain_rate):
        return ("adapt_step_size with Langevin gradients (the drift rate "
                "tied to each chain's adapted step) on a drift that takes "
                "one rate")
    if cfg.task == "regression" and cfg.topology[2] != 1:
        return "regression with more than one output"
    return None


def step_noise_names(cfg: PTConfig) -> Tuple[str, ...]:
    """The per-step noise a run of ``cfg`` reads: "w" normal (C, W), "u"
    uniform (C,) for the MH test, "u_swap" uniform (C-1,) for the swap
    event; "l" uniform (C,), the Langevin choice, with Langevin gradients;
    "eta" normal (C,) for regression. The preconditioned family: "w" is
    the proposal's (pCN: the prior draw's, HMC: the momentum's) standard
    normal; regression adds "u_eta" uniform (C,) for the eta block's test;
    HMC with a step jitter "jit" uniform (C,). ptnn draws them from
    ``kp, ke, ku, kue, ks = split(key, 5)`` (HMC: ``kp, kj = split(kp)``):
    w, eta, u, u_eta, u_swap, and jit from kj."""
    names = ("w", "u", "u_swap")
    if cfg.use_langevin_gradients:
        names += ("l",)
    if cfg.task == "regression":
        names += ("eta",)
        if cfg.proposal in PRECOND:
            names += ("u_eta",)
    if cfg.proposal == "hmc" and cfg.hmc_eps_jitter > 0.0:
        names += ("jit",)
    return names


class StepFn:
    """ptnn's ``make_step_fn`` for the reference proposal: ``step(state, i,
    noise) -> (state, trace)`` advances every chain by one MH step (and the
    swap event after it when ``swap_due(cfg, i)``); ``recompute_ll``.
    ``noise`` holds this step's draws (``step_noise_names``). With
    ``diagnostics`` set, the trace also carries "margin", |u - mh_prob|:
    how far each chain's decision was from flipping."""

    def __init__(self, cfg: PTConfig, data: Dataset, temps: torch.Tensor,
                 spec: model_api.ModelSpec):
        reason = step_reason(cfg, spec)
        if reason is not None:
            raise NotImplementedError(
                f"ptnn_torch's per-step sampler does not run {reason}: not "
                f"yet ported")
        if cfg.use_langevin_gradients and data.t_train is None:
            raise ValueError("Langevin gradients need data.t_train")
        self.cfg, self.data, self.temps, self.spec = cfg, data, temps, spec
        self.cls = cfg.task == "classification"
        self.diagnostics = False
        self.ones = torch.ones_like(temps)
        self.rec = recorded_chains(cfg)
        self.pair_mask = swap_mod.pair_mask(cfg.num_chains,
                                            cfg.rungs_per_ladder,
                                            temps.device)
        self.burn_end = int(cfg.samples_per_chain * cfg.burn_in) - 1
        # the ldpt_legacy ratio's MVN normaliser with COVARIANCE step_w, in
        # float32 as ptnn forms it
        self.log_norm = torch.tensor(-0.5 * spec.w_size, dtype=torch.float32) \
            * torch.log(torch.tensor(2.0 * np.pi * cfg.step_w,
                                     dtype=torch.float32))
        self.log_norm = self.log_norm.to(temps.device)

    def _prior(self, w, tau):
        """The log prior of (w, tau) for every chain (tau: regression's
        noise variance)."""
        cfg, spec = self.cfg, self.spec
        if self.cls:
            return likelihood.classification_log_prior_dim(
                w, spec.prior_dim_classification, cfg.sigma_sq)
        return likelihood.regression_log_prior_dim(
            w, tau, spec.prior_dim_regression, cfg.sigma_sq, cfg.nu_1,
            cfg.nu_2)

    def _drift(self, w: torch.Tensor, lrate: model_api.Rate) -> torch.Tensor:
        """The spec's drift of every chain, in ``drift_chain_microbatch``
        sequential chunks of chains: the chains are independent, so the
        numbers are the whole batch's, and a gradient drift keeps the
        activations of one chunk at a time."""
        d, mb = self.data, self.cfg.drift_chain_microbatch
        if mb <= 1:
            return self.spec.drift(w, d.x_train, d.t_train, lrate)
        rates = (lrate.chunk(mb) if isinstance(lrate, torch.Tensor)
                 else [lrate] * mb)
        return torch.cat([self.spec.drift(wk, d.x_train, d.t_train, lk)
                          for wk, lk in zip(w.chunk(mb), rates)])

    def _propose(self, state: ChainState, noise: Noise, at: torch.Tensor):
        """Weight proposal, q-ratio correction and Langevin counter
        (ptnn/kernel.py:979-1038)."""
        cfg = self.cfg
        if cfg.adapt_step_size:
            sw = torch.exp(state.log_step_w)[:, None]
            sq = (sw * sw)[:, 0]
        else:
            sw = cfg.step_w
            sq = cfg.step_w * cfg.step_w
        nw = noise["w"] * sw
        if not cfg.use_langevin_gradients:
            return state.w + nw, torch.zeros_like(state.ll), state.n_langevin
        use_l = noise["l"] < cfg.langevin_prob
        # with step-size adaptation the drift scale is tied to each chain's
        # adapted step (MALA: drift = (sigma^2 / 2) grad log pi) and
        # cfg.learn_rate is ignored (ptnn/kernel.py:688-707)
        lrate = (0.5 * torch.exp(2.0 * state.log_step_w)
                 if cfg.adapt_step_size else cfg.learn_rate)

        def drift(w):
            return self._drift(w, lrate)

        w_gd = drift(state.w)
        w_prop = torch.where(use_l[:, None], w_gd + nw, state.w + nw)
        w_prop_gd = drift(w_prop)
        ss_rev = torch.sum(torch.square(state.w - w_prop_gd), dim=-1)
        ss_fwd = torch.sum(torch.square(w_prop - w_gd), dim=-1)
        if cfg.qratio == "reference":
            # the simplified log q-ratio of pt_classification.py:340-351
            first = -0.5 * ss_rev / sq
            second = -0.5 * ss_fwd / sq
            ratio = (first - second) / at
        else:
            # "ldpt_legacy": log(pdf1 - log(pdf2)) with covariance step_w;
            # pdf1 overflowing is clamped at e^80 (accept), a non-positive
            # argument rejects
            log_pdf1 = self.log_norm - 0.5 * ss_rev / cfg.step_w
            log_pdf2 = self.log_norm - 0.5 * ss_fwd / cfg.step_w
            arg = torch.exp(torch.clamp(log_pdf1, max=80.0)) - log_pdf2
            legacy = torch.where(arg > 0.0,
                                 torch.log(torch.clamp(arg, min=1e-30)),
                                 -math.inf)
            ratio = legacy / at
        diff = torch.where(use_l, ratio, 0.0)
        return w_prop, diff, state.n_langevin + use_l.to(torch.int32)

    def step(self, state: ChainState, i: int,
             noise: Noise) -> Tuple[ChainState, Dict[str, torch.Tensor]]:
        """ptnn/kernel.py:1260-1393 for the reference proposal."""
        cfg, d, spec = self.cfg, self.data, self.spec
        at = self.temps if i < cfg.temper_switch_step else self.ones
        w_prop, diff_prop, n_langevin = self._propose(state, noise, at)
        if self.cls:
            eta_prop = state.eta
            tau_prop = None
        else:
            eta_prop = state.eta + cfg.step_eta * noise["eta"]
            tau_prop = torch.exp(eta_prop)
        prior_prop = self._prior(w_prop, tau_prop)
        (ll_prop, rmse_tr, acc_tr), (_ll, rmse_te, acc_te) = spec_eval_pair(
            cfg, spec, w_prop, d.x_train, d.y_train, d.x_test, d.y_test,
            tau_prop)
        log_mh = (ll_prop - state.ll) / at + (prior_prop - state.prior) \
            + diff_prop
        mh_prob = torch.exp(torch.clamp(log_mh, max=0.0))
        accept = noise["u"] < mh_prob
        acc_w = accept[:, None]

        def carry(new, old):
            return torch.where(accept, new, old)

        trace = {
            # regression records the TEMPERED proposal ll, classification
            # the untempered one
            "ll": ll_prop if self.cls else ll_prop / at,
            "rmse_train": carry(rmse_tr, state.rmse_train),
            "rmse_test": carry(rmse_te, state.rmse_test),
            "acc_train": carry(acc_tr, state.acc_train),
            "acc_test": carry(acc_te, state.acc_test),
            # the count BEFORE this step's decision
            "accept_count": state.n_accept,
        }
        new = state.replace(
            w=torch.where(acc_w, w_prop, state.w),
            eta=carry(eta_prop, state.eta),
            ll=carry(ll_prop, state.ll),
            prior=carry(prior_prop, state.prior),
            w_last=torch.where(acc_w, w_prop, state.w_last),
            rmse_train=trace["rmse_train"],
            rmse_test=trace["rmse_test"],
            acc_train=trace["acc_train"],
            acc_test=trace["acc_test"],
            n_accept=state.n_accept + accept.to(torch.int32),
            n_langevin=n_langevin,
        )
        if cfg.adapt_step_size:
            # Robbins-Monro toward the target acceptance until burn-in
            delta = cfg.adapt_rate * (mh_prob - cfg.adapt_target_accept)
            lsw = state.log_step_w + (delta if i < self.burn_end else 0.0)
            new = new.replace(log_step_w=torch.clamp(lsw, _LOG_STEP_LO,
                                                     _LOG_STEP_HI))
        if self.diagnostics:
            trace["margin"] = torch.abs(noise["u"] - mh_prob)
        if cfg.record_w:
            trace["w"] = new.w_last[self.rec]
        if cfg.record_eta and not self.cls:
            trace["eta"] = new.eta[self.rec]
        if swap_due(cfg, i):
            new = do_swap(cfg, new, self.temps, i, noise["u_swap"],
                          self.pair_mask)
        if cfg.track_replicas:
            trace["replica"] = new.replica_id
        return new, trace

    def recompute_ll(self, state: ChainState) -> ChainState:
        return recompute_ll(self.cfg, state, self.data, self.spec)


class PrecondStepFn(StepFn):
    """ptnn's ``step_precond`` (ptnn/kernel.py:1616-2150): one step of the
    preconditioned family for every chain, two Metropolis-within-Gibbs
    blocks and the adaptation, then the swap event when it is due.

    * **the w block** at fixed eta, with the diagonal preconditioner ``m``
      from the Welford buffers (``ops.precond_step._precond_diag``) and the
      tempered posterior gradient ``g = g_like / (tau T) - w / sigma^2``
      from the cached ``g_like``:
      - ``precond_rw``: ``w' = w + sig sqrt(m) z``; ``precond_mala`` adds
        ``sig^2 m g / 2`` and the exact reverse-kernel q-ratio;
      - ``hmc``: momentum ``z / sqrt(m)``, ``hmc_leapfrog`` leapfrog steps
        under ``diag(1/m)`` at ``eps = sig (1 + jitter (2 jit - 1))``, the
        kinetic-energy difference in the ratio; under ChEES each chain's
        trajectory ends after ``clip(ceil(exp(log_traj) vdc_u(i) / eps), 1,
        leapfrog)`` steps and is carried through the rest, so every chain
        pays ``hmc_leapfrog`` gradient evaluations, as ptnn's scan does;
      - ``pcn``: ``w' = sqrt(1 - rho^2) w + rho sigma z`` with ``rho =
        min(sig, 1)``, its q-ratio the negated prior difference.
      Until ``warm_end`` (gradient proposals) the proposal is the warm start
      ``w + warmstart_step g / rms(g)``, accepted whatever the ratio, with
      its likelihood and gradient evaluated there. ptnn runs the HMC
      trajectory in those steps too and discards it; here it does not run.
    * **the metrics**: gradient proposals take the train ll and metrics
      from the value-and-grad and evaluate the test rows (``spec_eval``,
      one ``fnn_eval`` launch for the FNN); ``precond_rw`` and ``pcn``
      evaluate both row sets (``spec_eval_pair``).
    * **the eta block** (regression): a random walk on eta with its own
      scale ``log_step_eta``, its likelihood recovered from the carried ll.
    * **adaptation** while ``warm_end <= i < burn_end``: Welford, Robbins-
      Monro on ``log_step_w`` (toward the proposal's target) and
      ``log_step_eta`` (0.44; until burn_end), and under ChEES Adam on
      ``log_traj`` from the acceptance-weighted criterion with rung means
      over the ``n_ladders`` replicas of each rung.

    With ``diagnostics`` set, the trace carries "margin": each chain's
    distance from a flipped outcome, the smallest of |u - a| of the w and
    eta blocks and, under ChEES, the distance of ``tau_traj / eps`` from a
    leapfrog-count boundary."""

    def __init__(self, cfg: PTConfig, data: Dataset, temps: torch.Tensor,
                 spec: model_api.ModelSpec):
        super().__init__(cfg, data, temps, spec)
        p = cfg.proposal
        self.is_mala, self.is_hmc, self.is_pcn = (
            p == "precond_mala", p == "hmc", p == "pcn")
        self.grad = p in GRAD_PROPOSALS
        self.chees = self.is_hmc and cfg.hmc_adapt_traj
        s = cfg.samples_per_chain
        self.warm_end = int(s * cfg.warmstart_frac) if self.grad else 0
        self.target = (cfg.hmc_target_accept if self.is_hmc else
                       cfg.mala_target_accept if self.is_mala else
                       cfg.adapt_target_accept)
        self.n_train = data.y_train.shape[0]
        # the keys ops.precond_step._precond_diag reads
        self.scal = dict(burn_end=self.burn_end, warm_end=self.warm_end,
                         pc_start=int(s * cfg.precond_start_frac),
                         precond_power=cfg.precond_power)
        self.vg = like_value_and_grad(cfg, spec, data) if self.grad else None

    def _g_post(self, g_like, w, tau, at):
        """The tempered posterior gradient from the likelihood term's."""
        g = g_like if self.cls else g_like / tau[:, None]
        return g / at[:, None] - w / self.cfg.sigma_sq

    def _leapfrog(self, state, m, g_cur, tau, at, epsw, l_steps, p0):
        """``hmc_leapfrog`` leapfrog steps from (w, p0); a chain whose
        trajectory has ended (ChEES, ``n >= l_steps``) carries through.
        Returns (w', p', g_like', val', aux')."""
        w_c, p_c, g_c, gl_c = state.w, p0, g_cur, state.g_like
        v_c = a_c = None
        for n in range(self.cfg.hmc_leapfrog):
            p_half = p_c + 0.5 * epsw * g_c
            w_n = w_c + epsw * m * p_half
            (v_n, a_n), gl_n = self.vg(w_n)
            g_n = self._g_post(gl_n, w_n, tau, at)
            p_n = p_half + 0.5 * epsw * g_n
            if l_steps is not None:
                upd = n < l_steps
                uw = upd[:, None]
                w_n = torch.where(uw, w_n, w_c)
                p_n = torch.where(uw, p_n, p_c)
                g_n = torch.where(uw, g_n, g_c)
                gl_n = torch.where(uw, gl_n, gl_c)
                if n:  # the first step moves every chain (l_steps >= 1)
                    v_n = torch.where(upd, v_n, v_c)
                    if a_n is not None:
                        a_n = torch.where(upd[:, None, None], a_n, a_c)
            w_c, p_c, g_c, gl_c, v_c, a_c = w_n, p_n, g_n, gl_n, v_n, a_n
        return w_c, p_c, gl_c, v_c, a_c

    def _train_metrics(self, val, aux, eta, tau, w_prop):
        """The proposal's (ll, rmse_train, acc_train) from the value-and-
        grad, and (rmse_test, acc_test) from one eval of the test rows."""
        d = self.data
        _ll, rmse_te, acc_te = spec_eval(self.cfg, self.spec, w_prop,
                                         d.x_test, d.y_test,
                                         None if self.cls else tau)
        if not self.cls:
            ll = (-0.5 * self.n_train) * (likelihood._LOG_2PI + eta) \
                + val / tau
            rmse_tr = torch.sqrt(-2.0 * val / self.n_train)
            zero = torch.zeros_like(val)
            return ll, rmse_tr, zero, rmse_te, zero
        pred = fnn.predict_class(aux).to(torch.float32)
        yf = d.y_train[None, :]
        rmse_tr = torch.sqrt(torch.mean(torch.square(pred - yf), dim=-1))
        acc_tr = 100.0 * torch.mean((pred == yf).to(torch.float32), dim=-1)
        return val, rmse_tr, acc_tr, rmse_te, acc_te

    def step(self, state: ChainState, i: int,
             noise: Noise) -> Tuple[ChainState, Dict[str, torch.Tensor]]:
        cfg, d = self.cfg, self.data
        at = self.temps if i < cfg.temper_switch_step else self.ones
        warm = i < self.warm_end
        adapting = self.warm_end <= i < self.burn_end
        sig = torch.exp(state.log_step_w)
        m = precond_step._precond_diag(state.pc_m2, i, self.scal,
                                       self.spec.w_size)
        tau = torch.exp(state.eta)
        margin = None
        if self.grad:
            g_cur = self._g_post(state.g_like, state.w, tau, at)
        if self.is_hmc:
            eps = sig
            if cfg.hmc_eps_jitter > 0.0:
                eps = eps * (1.0 + cfg.hmc_eps_jitter
                             * (2.0 * noise["jit"] - 1.0))
            l_steps = None
            if self.chees:
                u_traj = vdc_u(i).to(sig.device)
                tau_traj = torch.exp(state.log_traj) * u_traj
                steps = tau_traj / eps
                l_steps = torch.clamp(torch.ceil(steps), 1.0,
                                      float(cfg.hmc_leapfrog)).to(torch.int32)
                inside = (steps > 1.0) & (steps < cfg.hmc_leapfrog)
                margin = torch.where(inside,
                                     torch.abs(steps - torch.round(steps)),
                                     math.inf)
            p0 = noise["w"] / torch.sqrt(m)
            k_init = 0.5 * torch.sum(m * torch.square(p0), dim=-1)
            if not warm:
                w_prop, p_end, g_like_prop, val, aux = self._leapfrog(
                    state, m, g_cur, tau, at, eps[:, None], l_steps, p0)
                diff = k_init - 0.5 * torch.sum(m * torch.square(p_end),
                                                dim=-1)
            else:  # the forced warm-start move below: no ratio is read
                diff = torch.zeros_like(sig)
        elif self.is_pcn:
            rho = torch.clamp(sig, max=1.0)[:, None]
            xi = math.sqrt(cfg.sigma_sq) * noise["w"]
            w_prop = torch.sqrt(1.0 - rho * rho) * state.w + rho * xi
        else:
            nz = noise["w"] * sig[:, None] * torch.sqrt(m)
            if self.is_mala:
                sig2m = (sig * sig)[:, None] * m
                mean_fwd = state.w + 0.5 * sig2m * g_cur
            else:
                mean_fwd = state.w
            w_prop = mean_fwd + nz
        if warm:
            # deterministic warm start: RMS-normalised gradient ascent on the
            # tempered log posterior, accepted whatever the ratio
            g_rms = torch.sqrt(torch.mean(torch.square(g_cur), dim=-1,
                                          keepdim=True))
            w_prop = state.w + cfg.warmstart_step * g_cur \
                / torch.clamp(g_rms, min=1e-12)
        prior_prop = self._prior(w_prop, tau)
        if self.grad:
            if self.is_mala or warm:
                (val, aux), g_like_prop = self.vg(w_prop)
            ll_prop, rmse_tr, acc_tr, rmse_te, acc_te = self._train_metrics(
                val, aux, state.eta, tau, w_prop)
            if self.is_mala:
                g_prop = self._g_post(g_like_prop, w_prop, tau, at)
                mean_rev = w_prop + 0.5 * sig2m * g_prop
                diff = (torch.sum(torch.square(w_prop - mean_fwd) / m, dim=-1)
                        - torch.sum(torch.square(state.w - mean_rev) / m,
                                    dim=-1)) / (2.0 * sig * sig)
        else:
            (ll_prop, rmse_tr, acc_tr), (_ll, rmse_te, acc_te) = \
                spec_eval_pair(cfg, self.spec, w_prop, d.x_train, d.y_train,
                               d.x_test, d.y_test, None if self.cls else tau)
            if self.is_pcn:
                # log q(w|w') - log q(w'|w): the negated Gaussian prior
                # difference, so the ratio is the tempered likelihood's
                diff = (torch.sum(torch.square(w_prop), dim=-1)
                        - torch.sum(torch.square(state.w), dim=-1)) \
                    / (2.0 * cfg.sigma_sq)
            else:
                diff = torch.zeros_like(sig)

        log_mh = (ll_prop - state.ll) / at + (prior_prop - state.prior) + diff
        mh_prob = torch.exp(torch.clamp(log_mh, max=0.0))
        accept = noise["u"] < mh_prob
        if warm:
            accept = torch.ones_like(accept)
        elif self.diagnostics:
            m_w = torch.abs(noise["u"] - mh_prob)
            margin = m_w if margin is None else torch.minimum(margin, m_w)
        acc_w = accept[:, None]

        def carry(new, old):
            return torch.where(accept, new, old)

        trace = {
            # regression records the TEMPERED proposal ll, classification
            # the untempered one
            "ll": ll_prop if self.cls else ll_prop / at,
            "rmse_train": carry(rmse_tr, state.rmse_train),
            "rmse_test": carry(rmse_te, state.rmse_test),
            "acc_train": carry(acc_tr, state.acc_train),
            "acc_test": carry(acc_te, state.acc_test),
            "accept_count": state.n_accept,
        }
        new = state.replace(
            w=torch.where(acc_w, w_prop, state.w),
            ll=carry(ll_prop, state.ll),
            prior=carry(prior_prop, state.prior),
            w_last=torch.where(acc_w, w_prop, state.w_last),
            rmse_train=trace["rmse_train"],
            rmse_test=trace["rmse_test"],
            acc_train=trace["acc_train"],
            acc_test=trace["acc_test"],
            n_accept=state.n_accept + accept.to(torch.int32),
        )
        if self.grad:
            new = new.replace(g_like=torch.where(acc_w, g_like_prop,
                                                 state.g_like))
        if cfg.record_w:
            trace["w"] = new.w_last[self.rec]
        if cfg.record_eta and not self.cls:
            # the post-w-block, pre-eta-block eta, paired with this row's w
            trace["eta"] = new.eta[self.rec]
        if not self.cls:
            new, m_e = self._eta_block(state, new, i, at, noise)
            if self.diagnostics:
                margin = m_e if margin is None else torch.minimum(margin, m_e)
        new = self._adapt(state, new, i, adapting, mh_prob)
        if self.chees:
            new = self._chees(state, new, i, adapting, mh_prob, m, w_prop,
                              None if warm else p_end, u_traj, tau_traj, eps)
            trace["traj_len"] = l_steps.to(torch.float32)
        if self.diagnostics:
            trace["margin"] = (margin if margin is not None
                               else torch.full_like(sig, math.inf))
        if swap_due(cfg, i):
            new = do_swap(cfg, new, self.temps, i, noise["u_swap"],
                          self.pair_mask)
        if cfg.track_replicas:
            trace["replica"] = new.replica_id
        return new, trace

    def _eta_block(self, state, new, i, at, noise):
        """The regression eta block: a random walk on eta, its likelihood
        recovered from the carried ll without a data pass, its scale adapted
        until burn-in ends. Returns the state and each chain's
        |u_eta - a|."""
        cfg = self.cfg
        eta_prop, ll_eta, dprior, prob = precond_step.eta_move(
            state.eta, new.ll, state.log_step_eta, noise["eta"], self.n_train,
            at, cfg.nu_1, cfg.nu_2)
        acc = noise["u_eta"] < prob
        lse = state.log_step_eta
        if i < self.burn_end:
            lse = lse + cfg.adapt_rate * (prob
                                          - precond_step.ETA_TARGET_ACCEPT)
        new = new.replace(
            eta=torch.where(acc, eta_prop, state.eta),
            ll=torch.where(acc, ll_eta, new.ll),
            prior=new.prior + torch.where(acc, dprior, 0.0),
            log_step_eta=torch.clamp(lse, precond_step._LOG_LO_ETA,
                                     precond_step._LOG_HI))
        return new, torch.abs(noise["u_eta"] - prob)

    def _adapt(self, state, new, i, adapting, mh_prob):
        """Welford accumulation of the post-decision w and Robbins-Monro on
        the w block's scale, both between the warm start's end and burn-in's
        end."""
        lsw = state.log_step_w
        mean, m2 = state.pc_mean, state.pc_m2
        if adapting:
            mean, m2, lsw = precond_step.adapt_w(
                mean, m2, lsw, new.w, mh_prob, i, self.warm_end,
                self.burn_end, self.cfg.adapt_rate, self.target)
        return new.replace(
            log_step_w=torch.clamp(lsw, precond_step._LOG_LO_W,
                                   precond_step._LOG_HI),
            pc_mean=mean, pc_m2=m2)

    def _chees(self, state, new, i, adapting, mh_prob, m, w_prop, p_end,
               u_traj, tau_traj, eps):
        """ChEES's Adam step on ``log_traj`` over rung means of the
        ladder-major chains (chain = ladder * rungs + rung), then the clip
        to what the static bound can realise."""
        cfg = self.cfg
        m1, v2, lt = state.chees_m1, state.chees_v2, state.log_traj
        if adapting:
            k = cfg.rungs_per_ladder
            t_ad = torch.tensor(
                float(max(min(i, self.burn_end) - self.warm_end, 0)) + 1.0,
                dtype=torch.float32, device=lt.device)
            lt, m1, v2 = precond_step.chees_adam(
                lt, m1, v2, w_prop, state.w, m, p_end, mh_prob, u_traj,
                tau_traj, lambda x: precond_step.rung_sum(x, cfg.num_chains,
                                                          k),
                float(cfg.n_ladders), 1.0 - 0.9**t_ad, 1.0 - 0.999**t_ad,
                cfg.chees_rate)
        return new.replace(
            log_traj=precond_step._clip_traj(lt, eps, cfg.hmc_leapfrog),
            chees_m1=m1, chees_v2=v2)


def make_step_fn(cfg: PTConfig, data: Dataset, temps: torch.Tensor,
                 spec: Optional[model_api.ModelSpec] = None) -> StepFn:
    """The per-step sampler's step for ``cfg``: ``PrecondStepFn`` for the
    preconditioned family, else ``StepFn`` (the reference proposal, with or
    without Langevin gradients); ``spec`` defaults to the reference FNN
    with ``cfg.drift_mode``. Raises NotImplementedError naming a feature
    that is not ported (``step_reason``)."""
    spec = spec or default_spec(cfg)
    if cfg.proposal in PRECOND:
        return PrecondStepFn(cfg, data, temps, spec)
    return StepFn(cfg, data, temps, spec)
