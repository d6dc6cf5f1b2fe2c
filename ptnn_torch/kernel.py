"""Chain state, initialisation, the per-step MH step, the swap event and the
temper-switch recompute.

Port of ``ptnn/kernel.py``: ``ChainState`` (the fields the ported paths
read), ``Dataset``, ``init_state`` (regression and classification, with the
preconditioned MALA/HMC branch), ``swap_due``, ``vdc_u``, the ``do_swap``
and ``recompute_ll`` closures of ``make_step_fn`` as plain functions, and
``make_step_fn`` for the reference proposal: the per-step random walk with
the optional Langevin-gradient drift and its q-ratio ("reference" or
"ldpt_legacy"). ``step_precond`` (the per-step precond family) is not
ported yet.

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
``batched_forward`` only on a TPU).

Semantics kept from ``ptnn``: the chain carries its UNTEMPERED train
log-likelihood and divides by the adaptive temperature at decision time;
``w_last`` and the rmse/acc carries are write-on-accept trace carries; a swap
moves (w, eta), and (ll, prior) too unless ``stale_likelihood_after_swap``.
Classification has no noise parameter: eta is zeros and passes through.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ptnn_torch.config import PTConfig
from ptnn_torch.models import api as model_api
from ptnn_torch.models import fnn
from ptnn_torch.ops import likelihood
from ptnn_torch.ops.block_step import _LOG_STEP_HI, _LOG_STEP_LO
from ptnn_torch.ops.fnn_eval import fnn_eval, fnn_eval_pair
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
    precond = cfg.proposal in ("precond_mala", "hmc")
    if precond and spec.fnn_topology is None:
        raise NotImplementedError(
            f"ptnn_torch runs proposal={cfg.proposal!r} on the reference FNN "
            f"only, not on {spec.name}: not yet ported")
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
    if cfg.proposal != "reference":
        return f"proposal={cfg.proposal!r} (the per-step precond family)"
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
    "eta" normal (C,) for regression."""
    names = ("w", "u", "u_swap")
    if cfg.use_langevin_gradients:
        names += ("l",)
    if cfg.task == "regression":
        names += ("eta",)
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
            prior_prop = likelihood.classification_log_prior_dim(
                w_prop, spec.prior_dim_classification, cfg.sigma_sq)
        else:
            eta_prop = state.eta + cfg.step_eta * noise["eta"]
            tau_prop = torch.exp(eta_prop)
            prior_prop = likelihood.regression_log_prior_dim(
                w_prop, tau_prop, spec.prior_dim_regression, cfg.sigma_sq,
                cfg.nu_1, cfg.nu_2)
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


def make_step_fn(cfg: PTConfig, data: Dataset, temps: torch.Tensor,
                 spec: Optional[model_api.ModelSpec] = None) -> StepFn:
    """The per-step sampler's step for ``cfg`` (reference proposal, with or
    without Langevin gradients); ``spec`` defaults to the reference FNN
    with ``cfg.drift_mode``. Raises NotImplementedError naming a feature
    that is not ported (``step_reason``)."""
    return StepFn(cfg, data, temps, spec or default_spec(cfg))
