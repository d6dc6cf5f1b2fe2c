"""Chain state, initialisation, the per-step MH steps, the swap event and
the temper-switch recompute.

Port of ``ptnn/kernel.py``: ``ChainState`` (the fields the ported paths
read), ``Dataset``, ``init_state`` (regression and classification, with the
preconditioned family's state), ``like_value_and_grad``, ``swap_due``,
``vdc_u``, the ``do_swap`` and ``recompute_ll`` closures of
``make_step_fn`` as plain functions, and ``make_step_fn``: ``StepFn`` for
the reference proposal (the per-step random walk with the optional
Langevin-gradient drift and its q-ratio, "reference" or "ldpt_legacy"),
``PrecondStepFn`` for the preconditioned family (``precond_rw``,
``precond_mala``, ``hmc`` with and without ChEES, ``pcn``: ptnn's
``step_precond``), and ``SgldStepFn`` for replica-exchange SGLD (ptnn's
``step_sgld``: minibatch Langevin moves, exact or variance-corrected swaps,
SVRG anchors). Both run the variational-reference path
(``variational_reference``: ``VRef``, the corrected MH term, swap energy
and gradient, the Welford fit and the hot rung's regeneration), the
posterior-predictive carries (``record_fx``) and the state likelihood
traces (``record_ll_state``); ``set_static_reference`` injects a fitted
reference. ``StepFn`` also runs the surrogate modes (``use_surrogate``:
``Surrogate``, ptnn's anchored ``step`` and delayed-acceptance
``step_da`` with ``DAState``, ``close_segment``, ``refit_surrogate``,
``refit_anchor``), each step's branch decided on the host, and a sweep's
cells side by side on the chain axis (``Grid``: ptnn's vmapped cells with
their traced overrides; the padded ``Dataset`` with ptnn's masks,
``mask_reason`` for what ptnn refuses on it).

Every evaluation of the network on data (``train_loglik``,
``init_state``'s ll, ``recompute_ll``) goes through ``spec_eval``, the
step's train and test evals through ``spec_eval_pair``, and the drift
through the model spec's ``drift``. For the reference FNN those are
``ops.fnn_eval.fnn_eval``, ``ops.fnn_eval.fnn_eval_pair`` (one launch for
both row sets) and ``ops.drift.sgd_epoch``, on the card the two
hand-written kernels; under ``eval_dtype="bfloat16"`` the evals take a
plain bfloat16 forward (``eval_forward``) and no eval kernel. Any
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

from ptnn_torch import surrogate as surrogate_mod
from ptnn_torch.config import PTConfig
from ptnn_torch.models import api as model_api
from ptnn_torch.models import fnn
from ptnn_torch.ops import likelihood, precond_step, vref
from ptnn_torch.ops.block_step import _LOG_STEP_HI, _LOG_STEP_LO
from ptnn_torch.ops.fnn_eval import fnn_eval, fnn_eval_pair
from ptnn_torch.ops.precision import full_float32
from ptnn_torch.parallel import swap as swap_mod


# the preconditioned family (ptnn's ``step_precond``), and its members that
# take the likelihood's gradient
PRECOND = ("precond_rw", "precond_mala", "hmc", "pcn")
GRAD_PROPOSALS = ("precond_mala", "hmc")


@dataclasses.dataclass
class DAState:
    """Delayed-acceptance segment bookkeeping (``surrogate_mode=
    "delayed_acceptance"``). A segment is a maximal run of consecutive
    surrogate steps: the chain moves by inner MH against the surrogate
    target, and the whole segment is one composite proposal that a single
    true-likelihood Metropolis test accepts or reverts when it closes, the
    ratio ``[pi(w_K) s(w_0)] / [pi(w_0) s(w_K)]`` (Christen & Fox 2005). The
    surrogate decision is global a step, so ``active`` is a scalar."""

    anchor_w: torch.Tensor  # (C, W) segment-start weights
    anchor_eta: torch.Tensor  # (C,)
    anchor_prior: torch.Tensor  # (C,)
    anchor_llsurr: torch.Tensor  # (C,) surrogate ll at the anchor
    ll_surr: torch.Tensor  # (C,) surrogate ll at the current (w, eta)
    active: torch.Tensor  # () bool: a segment is open
    n_seg: torch.Tensor  # () int32: segments opened
    n_seg_accepted: torch.Tensor  # (C,) int32: segment corrections accepted

    def replace(self, **kw) -> "DAState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "DAState":
        return DAState(**{k: v.to(device) for k, v in vars(self).items()})


def init_da_state(num_chains: int, w_size: int, device="cpu") -> DAState:
    f32 = dict(dtype=torch.float32, device=device)
    c = num_chains
    return DAState(
        anchor_w=torch.zeros((c, w_size), **f32),
        anchor_eta=torch.zeros((c,), **f32),
        anchor_prior=torch.zeros((c,), **f32),
        anchor_llsurr=torch.zeros((c,), **f32),
        ll_surr=torch.zeros((c,), **f32),
        active=torch.zeros((), dtype=torch.bool, device=device),
        n_seg=torch.zeros((), dtype=torch.int32, device=device),
        n_seg_accepted=torch.zeros((c,), dtype=torch.int32, device=device),
    )


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
    # posterior-predictive carries (None unless record_fx): the last
    # accepted proposal's predictions, write-on-accept like rmse
    fx_train: Optional[torch.Tensor] = None  # (C, N_train)
    fx_test: Optional[torch.Tensor] = None  # (C, N_test)
    # the variational reference (None unless variational_reference; ops/
    # vref.py): the cold chain's Welford moments of z = (w, eta) for
    # regression, w for classification; under vr_mode "static" vr_m2 IS the
    # variance; vr_chol the lower Cholesky factor of the full-covariance
    # family; the hot rung's regeneration counters
    vr_mean: Optional[torch.Tensor] = None  # (Z,)
    vr_m2: Optional[torch.Tensor] = None  # (Z,)
    vr_chol: Optional[torch.Tensor] = None  # (Z, Z) lower, or None
    n_regen_accepted: Optional[torch.Tensor] = None  # () int32
    n_regen_proposed: Optional[torch.Tensor] = None  # () int32
    # the surrogate's ring and fit (None unless use_surrogate) and the
    # delayed-acceptance segment (None unless surrogate_mode is
    # "delayed_acceptance")
    surr: Optional[surrogate_mod.SurrogateState] = None
    da: Optional[DAState] = None
    # sgld's SVRG control-variate anchors for the corrected swap test (None
    # unless proposal "sgld" with sg_vr): the coordinates and the full-data
    # untempered ll of each chain at its last anchor refresh; they travel
    # with (w, eta) on swaps
    sg_anchor_w: Optional[torch.Tensor] = None  # (C, W)
    sg_anchor_eta: Optional[torch.Tensor] = None  # (C,)
    sg_anchor_full: Optional[torch.Tensor] = None  # (C,)

    def replace(self, **kw) -> "ChainState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "ChainState":
        return ChainState(**{
            k: None if v is None else v.to(device)
            for k, v in vars(self).items()
        })


@dataclasses.dataclass
class Dataset:
    """The problem's rows on the device. A grid of runs
    (``ptnn_torch.sweeps``, ptnn's ``Dataset`` with a leading cell axis)
    gives each cell its own rows: x (G, N, I), y (G, N), t (G, N, O),
    padded to the grid's largest set, with ptnn's {0, 1} masks: the row
    validity ``mask_train`` / ``mask_test`` (G, N), the valid rows first;
    ``class_mask`` (G, O), the real classes first, whose padded columns
    leave the softmax and the argmax; ``w_mask`` (G, W), the parameters of
    each cell's own network in the envelope, pinned at 0 (init, proposal
    noise and every drift update). The kernels take the counts the masks
    give (``rows_train``, ``rows_test``, ``classes``: (G,) int32, set on
    construction, which checks that the padding trails)."""

    x_train: torch.Tensor  # (N, I) float32, or (G, N, I)
    y_train: torch.Tensor  # (N,), or (G, N)
    x_test: torch.Tensor
    y_test: torch.Tensor
    t_train: Optional[torch.Tensor] = None  # (N, O) delta-rule targets
    mask_train: Optional[torch.Tensor] = None  # (G, N) float32 {0, 1}
    mask_test: Optional[torch.Tensor] = None
    class_mask: Optional[torch.Tensor] = None  # (G, O)
    w_mask: Optional[torch.Tensor] = None  # (G, W)
    rows_train: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                           init=False)
    rows_test: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                          init=False)
    classes: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        init=False)

    def __post_init__(self):
        def count(mask, what):
            if mask is None:
                return None
            m = mask.reshape(-1, mask.shape[-1])
            n = m.sum(-1).to(torch.int32)
            lead = (torch.arange(m.shape[-1], device=m.device)[None, :]
                    < n[:, None]).to(m.dtype)
            if not torch.equal(m, lead):
                raise ValueError(f"{what}: the valid entries of each cell "
                                 f"must come first (the padding trails)")
            return n
        self.rows_train = count(self.mask_train, "mask_train")
        self.rows_test = count(self.mask_test, "mask_test")
        self.classes = count(self.class_mask, "class_mask")

    @property
    def cells(self) -> int:
        """Cells with rows of their own (1: one dataset for every chain)."""
        return self.x_train.shape[0] if self.x_train.dim() == 3 else 1

    @property
    def masked(self) -> bool:
        """Whether the rows or the parameters are padded (ptnn's masks)."""
        return (self.mask_train is not None or self.w_mask is not None
                or self.class_mask is not None)

    def chain_w_mask(self, chains: int) -> Optional[torch.Tensor]:
        """``w_mask`` repeated to the chains, (C, W), or None."""
        if self.w_mask is None:
            return None
        wm = self.w_mask if self.w_mask.dim() == 2 else self.w_mask[None]
        return wm.repeat_interleave(chains // wm.shape[0], dim=0)


def swap_due(cfg: PTConfig, i: int, si: Optional[int] = None) -> bool:
    """Whether a replica-exchange sweep runs after step ``i``, at the
    interval ``si`` (default ``cfg.swap_interval``; a grid's cell has its
    own)."""
    si = cfg.swap_interval if si is None else int(si)
    if si <= 0 or si > cfg.n_steps:
        return False
    k = i + cfg.swap_offset
    return k % si == 0 and k > 0


def default_spec(cfg: PTConfig) -> model_api.ModelSpec:
    """The reference FNN of ``cfg.topology`` with ``cfg.drift_mode``."""
    return model_api.fnn_spec(cfg.topology, cfg.drift_mode)


def _fnn_only(spec: model_api.ModelSpec, x: torch.Tensor, grid) -> None:
    if spec.fnn_topology is None and (x.dim() == 3 or grid):
        raise ValueError("a grid's per-cell rows and masks are evaluated by "
                         "the reference FNN only (ptnn_torch.sweeps)")


def eval_forward(cfg: PTConfig, spec: model_api.ModelSpec, w: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """The chain-batched forward of the evals, (C, N, O) float32 (ptnn's
    ``fwd_b``): under ``eval_dtype="bfloat16"`` the spec's plain forward on
    w and x cast to bfloat16 (a bfloat16 ``torch.matmul``; ptnn keeps its
    Pallas evals off this mode, and so does the port: no hand-written eval
    runs), its outputs back in float32, so that every likelihood reduction
    and decision stays float32; else ``batched_forward`` where the spec has
    one, else ``forward``. ptnn's bfloat16 FNN also lowers its products to
    ``Precision.DEFAULT``, which on the CPU changes nothing; the drift and
    the gradients stay float32."""
    if cfg.eval_dtype == "bfloat16":
        bf = torch.bfloat16
        return spec.forward(w.to(bf), x.to(bf)).to(torch.float32)
    return (spec.batched_forward or spec.forward)(w, x)


def _fnn_kernel(cfg: PTConfig, spec: model_api.ModelSpec) -> bool:
    """Whether the evals take ``ops.fnn_eval`` (the eval kernel on the
    card): the reference FNN in float32."""
    return spec.fnn_topology is not None and cfg.eval_dtype == "float32"


def spec_eval(cfg: PTConfig, spec: model_api.ModelSpec, w: torch.Tensor,
              x: torch.Tensor, y: torch.Tensor,
              tau: Optional[torch.Tensor],
              rows: Optional[torch.Tensor] = None,
              classes: Optional[torch.Tensor] = None):
    """Every chain's untempered (ll, rmse, acc), each (C,), on the rows
    (x, y): ``_batched_evals`` of ptnn/kernel.py. ``tau`` (C,) is the noise
    variance (regression); a grid's ``rows`` and ``classes`` are the
    ``Dataset``'s counts (``ops.fnn_eval``). Under ``eval_dtype=
    "bfloat16"`` every spec takes ``eval_forward``'s bfloat16 forward."""
    if _fnn_kernel(cfg, spec):
        return fnn_eval(w, x, y, tau, spec.fnn_topology, cfg.task, rows,
                        classes)
    _fnn_only(spec, x, rows is not None or classes is not None)
    out = eval_forward(cfg, spec, w, x)
    if cfg.task == "regression":
        ev = likelihood.regression_eval_from_fx(out[:, :, 0], y, tau)
        return ev.loglik, ev.rmse, torch.zeros_like(ev.rmse)
    ev = likelihood.classification_eval_from_logp(spec.log_probs(out), out, y)
    return ev.loglik, ev.rmse, ev.acc


def spec_eval_pair(cfg: PTConfig, spec: model_api.ModelSpec,
                   w: torch.Tensor, x_tr: torch.Tensor, y_tr: torch.Tensor,
                   x_te: torch.Tensor, y_te: torch.Tensor,
                   tau: Optional[torch.Tensor],
                   data: Optional["Dataset"] = None):
    """``spec_eval`` on the train rows and on the test rows: the reference
    FNN evaluates both in one call (one kernel launch on the card), any
    other spec (and bfloat16 evals) in two. ``data`` gives a grid's
    counts."""
    if _fnn_kernel(cfg, spec):
        counts = ((None,) * 3 if data is None else
                  (data.rows_train, data.rows_test, data.classes))
        return fnn_eval_pair(w, x_tr, y_tr, x_te, y_te, tau,
                             spec.fnn_topology, cfg.task, *counts)
    _fnn_only(spec, x_tr, data is not None and data.masked)
    return (spec_eval(cfg, spec, w, x_tr, y_tr, tau),
            spec_eval(cfg, spec, w, x_te, y_te, tau))


def train_loglik(cfg: PTConfig, w: torch.Tensor, eta: torch.Tensor,
                 data: Dataset,
                 spec: Optional[model_api.ModelSpec] = None) -> torch.Tensor:
    """The untempered train log-likelihood of every chain at (w, eta)."""
    return spec_eval(cfg, spec or default_spec(cfg), w, data.x_train,
                     data.y_train, torch.exp(eta), data.rows_train,
                     data.classes)[0]


def prior_dim_classification(spec: model_api.ModelSpec, data: Dataset,
                             chains: int):
    """The classification prior's dimension term: ``w_size``, or under a
    grid's parameter mask each chain's count of real parameters, (C,)
    float32 (ptnn/kernel.py:272-279; masked parameters stay 0 and add
    nothing to sum w^2)."""
    wm = data.chain_w_mask(chains)
    return spec.prior_dim_classification if wm is None else wm.sum(-1)


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


def value_and_grad_rows(cfg: PTConfig, spec: model_api.ModelSpec,
                        w: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """``((val, aux), g)`` of ``like_value_and_grad`` on the rows (x, y):
    -SSE/2 (regression) or the multinomial ll (classification) of every
    chain, (C,), the raw outputs (None for the FNN's regression) and d val
    / d w (C, W). The reference FNN takes its hand-written backprops, any
    other spec autograd over ``spec.forward`` in full float32."""
    reg = cfg.task == "regression"
    topo = spec.fnn_topology
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


def like_value_and_grad(cfg: PTConfig, spec: model_api.ModelSpec,
                        data: Dataset) -> ValueAndGrad:
    """ptnn's ``_like_value_and_grad``: ``fn(w (C, W)) -> ((val, aux), g)``.
    ``val`` (C,) is the temperature- and tau-free likelihood term, -SSE/2
    for regression and the multinomial log-likelihood for classification;
    ``aux`` the raw outputs (C, N, O) the classification metrics need (None
    for the FNN's regression, whose metrics come from ``val``); ``g`` (C, W)
    is d val / d w (``value_and_grad_rows`` on the train rows: the FNN's
    hand-written backprops, autograd over ``spec.forward`` for any other
    spec, in full float32 as ptnn runs at ``Precision.HIGHEST``). With
    ``drift_chain_microbatch`` > 1 the chains go in that many sequential
    chunks, as the drift does."""
    x, y = data.x_train, data.y_train

    def one(w):
        return value_and_grad_rows(cfg, spec, w, x, y)

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
    cells: Optional[int] = None,
) -> ChainState:
    """Initial state: standard-normal weights (from ``generator``, or
    ``init_w``), and ll/prior computed at that point. Regression: eta = log
    of the population variance of the initial residuals (or ``init_eta``);
    classification: eta = 0, the multinomial ll and the prior with
    dimension term w_size. ``spec`` defaults to the reference FNN.

    ``cells``: a grid of that many runs of ``cfg.num_chains`` chains,
    cell-major (``ptnn_torch.sweeps``): the swap counters count per cell,
    (G,); the weights are multiplied by the data's ``w_mask``, and each
    cell's eta is its residual variance over its own valid rows."""
    cls = cfg.task == "classification"
    dev = data.x_train.device
    spec = spec or default_spec(cfg)
    precond = cfg.proposal in PRECOND
    c, w_dim = cfg.num_chains * (cells or 1), spec.w_size
    if data.cells not in (1, c // cfg.num_chains):
        raise ValueError(f"{data.cells} cells of rows for "
                         f"{c // cfg.num_chains} cells of chains")
    if init_w is None:
        w = torch.randn((c, w_dim), generator=generator, device=dev,
                        dtype=torch.float32)
    else:
        w = torch.as_tensor(init_w, dtype=torch.float32, device=dev)
        if tuple(w.shape) != (c, w_dim):
            raise ValueError(f"init_w shape {tuple(w.shape)} != {(c, w_dim)}")
    wm = data.chain_w_mask(c)
    if wm is not None:
        w = w * wm
    if cls:
        eta = torch.zeros((c,), dtype=torch.float32, device=dev)
        ll = train_loglik(cfg, w, eta, data, spec)
        prior = likelihood.classification_log_prior_dim(
            w, prior_dim_classification(spec, data, c), cfg.sigma_sq)
    else:
        eta = _init_eta(spec, w, data)
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
    fx_train = fx_test = None
    if cfg.record_fx:
        fx_train = torch.zeros((c, data.x_train.shape[0]),
                               dtype=torch.float32, device=dev)
        fx_test = torch.zeros((c, data.x_test.shape[0]), dtype=torch.float32,
                              device=dev)
    vr = {}
    if cfg.variational_reference:
        # z = (w, eta) for regression: eta is anchored by the likelihood and
        # must be covered by q (see VRef)
        zdim = w_dim + (0 if cls else 1)
        f32 = dict(dtype=torch.float32, device=dev)
        vr = dict(
            vr_mean=torch.zeros((zdim,), **f32),
            # static: the variance (a standard normal q until
            # set_static_reference); welford: the M2 accumulator
            vr_m2=(torch.ones((zdim,), **f32) if cfg.vr_mode == "static"
                   else torch.zeros((zdim,), **f32)),
            vr_chol=(torch.eye(zdim, **f32) if cfg.vr_family == "full_cov"
                     else None),
            n_regen_accepted=torch.zeros((), dtype=torch.int32, device=dev),
            n_regen_proposed=torch.zeros((), dtype=torch.int32, device=dev))
    surr = da = None
    if cfg.use_surrogate:
        surr = surrogate_mod.init_for(cfg, w_dim, dev)
        if cfg.surrogate_mode == "delayed_acceptance":
            da = init_da_state(c, w_dim, dev)
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
        n_swap_accepted=torch.zeros(() if cells is None else (cells,),
                                    dtype=torch.int32, device=dev),
        n_swap_proposed=torch.zeros(() if cells is None else (cells,),
                                    dtype=torch.int32, device=dev),
        fx_train=fx_train,
        fx_test=fx_test,
        surr=surr,
        da=da,
        **vr,
        **_sg_anchors(cfg, w, eta, ll),
    )


def _sg_anchors(cfg: PTConfig, w: torch.Tensor, eta: torch.Tensor,
                ll: torch.Tensor) -> Dict[str, torch.Tensor]:
    """sgld's SVRG anchors at init: the initial (w, eta, ll) under
    ``sg_vr``, else none."""
    if cfg.proposal != "sgld" or not cfg.sg_vr:
        return {}
    return dict(sg_anchor_w=w.clone(), sg_anchor_eta=eta.clone(),
                sg_anchor_full=ll.clone())


def _init_eta(spec: model_api.ModelSpec, w: torch.Tensor,
              data: Dataset) -> torch.Tensor:
    """Regression's initial eta: the log of the population variance of
    each chain's residuals at ``w``; on a grid, each cell's over its own
    valid rows, so that a cell starts as its own single run does."""
    if data.x_train.dim() == 2 and data.rows_train is None:
        pred = spec.forward(w, data.x_train)[:, :, 0]
        resid = pred - data.y_train[None, :]
        return torch.log(torch.var(resid, dim=1, correction=0))
    g = data.cells
    cpc = w.shape[0] // g
    n = data.x_train.shape[-2]
    rows = ([n] * g if data.rows_train is None
            else data.rows_train.tolist())
    parts = []
    for k in range(g):
        x = data.x_train[k] if data.x_train.dim() == 3 else data.x_train
        y = data.y_train[k] if data.y_train.dim() == 2 else data.y_train
        pred = spec.forward(w[k * cpc:(k + 1) * cpc], x[:rows[k]])[:, :, 0]
        resid = pred - y[None, :rows[k]]
        parts.append(torch.log(torch.var(resid, dim=1, correction=0)))
    return torch.cat(parts)


def set_static_reference(state: ChainState, cfg: PTConfig, mu, var,
                         chol=None) -> ChainState:
    """Inject an externally fitted static reference (``vr_mode="static"``)
    into an initial state: ``mu`` / ``var`` (Z,), and ``chol`` (Z, Z) lower
    for ``vr_family="full_cov"`` (``ops.vref.fit_gaussian``'s output). The
    rounds driver calls this between rounds."""
    if cfg.vr_mode != "static":
        raise ValueError("set_static_reference requires vr_mode='static'")
    dev = state.vr_mean.device
    mu = torch.as_tensor(np.asarray(mu, np.float32), device=dev)
    var = torch.as_tensor(np.asarray(var, np.float32), device=dev)
    if mu.shape != state.vr_mean.shape or var.shape != state.vr_m2.shape:
        raise ValueError(f"reference shape {tuple(mu.shape)}/"
                         f"{tuple(var.shape)} != state z-dim "
                         f"{tuple(state.vr_mean.shape)}")
    out = state.replace(vr_mean=mu, vr_m2=var)
    if cfg.vr_family == "full_cov":
        if chol is None:
            raise ValueError("vr_family='full_cov' needs the chol factor")
        chol = torch.as_tensor(np.asarray(chol, np.float32), device=dev)
        if chol.shape != state.vr_chol.shape:
            raise ValueError(f"chol shape {tuple(chol.shape)} != "
                             f"{tuple(state.vr_chol.shape)}")
        out = out.replace(vr_chol=chol)
    elif chol is not None:
        raise ValueError("chol supplied but vr_family is 'diag'")
    return out


def adapttemp_at(cfg: PTConfig, temps: torch.Tensor, i: int) -> torch.Tensor:
    """The chains' temperatures at step ``i``: the ladder before the temper
    switch, 1 from it on."""
    if i < cfg.temper_switch_step:
        return temps
    return torch.ones_like(temps)


class VRef:
    """The variational reference of ptnn's ``make_step_fn`` (ptnn/kernel.py
    :778-977) for one run: path log pi_beta = log prior + beta LL + (1 -
    beta) corr, corr(z) = log q(z) - log p_ref(z), with q fitted to the cold
    chain's z = (w, eta) (regression) or w (classification). z must cover
    eta: at beta = 0 the likelihood vanishes, and an eta left to its bare,
    monotone prior runs off, after which the top pair never swaps.

    Under ``vr_mode="welford"`` q is Welford-fitted to the post-swap cold
    chain between ``accum_start`` and ``burn_end`` and frozen after, the
    correction active from ``start``; under "static" it is the injected
    reference, active from step 0. Step indices are host integers, so the
    schedule's gates are host branches."""

    def __init__(self, cfg: PTConfig, spec: model_api.ModelSpec,
                 data: Dataset, temps: torch.Tensor):
        self.cfg, self.spec, self.data = cfg, spec, data
        self.reg = cfg.task == "regression"
        self.w_dim = spec.w_size
        self.static = cfg.vr_mode == "static"
        self.full_cov = cfg.vr_family == "full_cov"
        if self.static:
            self.start = self.accum_start = self.burn_end = 0
        else:
            self.start, self.accum_start, self.burn_end = vref.schedule(
                cfg.samples_per_chain, cfg.vr_start_frac, cfg.burn_in,
                cfg.warmstart_frac)
        # VR forbids the temper switch: the hot rung's beta is fixed
        self.beta_hot = 1.0 / temps[-1]
        self.n_rows = data.y_train.shape[0]
        self.vg = like_value_and_grad(cfg, spec, data)

    def z(self, w, eta):
        """Reference coordinates: eta appended for regression."""
        if not self.reg:
            return w
        return torch.cat([w, eta[..., None]], dim=-1)

    def stats(self, st: ChainState, i: int):
        """(mu, var) of q as of step ``i``."""
        if self.static:
            return st.vr_mean, torch.clamp(st.vr_m2, min=vref.VAR_FLOOR)
        cnt = float(max(min(i, self.burn_end) - self.accum_start, 1))
        return st.vr_mean, vref.welford_variance(st.vr_m2, cnt,
                                                 self.cfg.vr_var_inflation)

    def logq(self, st: ChainState, i: int, z):
        if self.full_cov:
            return vref.log_q_chol(z, st.vr_mean, st.vr_chol)
        mu, var = self.stats(st, i)
        return vref.log_q_quad(z, mu, var)

    def logp_ref(self, w, eta):
        """The z-coordinates' own prior terms, which corr replaces: the
        Gaussian w-part and, for regression, -(1 + nu1) eta - nu2 e^-eta."""
        cfg = self.cfg
        lp = -0.5 * torch.sum(torch.square(w), dim=-1) / cfg.sigma_sq
        if self.reg:
            lp = lp - (1.0 + cfg.nu_1) * eta - cfg.nu_2 * torch.exp(-eta)
        return lp

    def corr(self, st: ChainState, i: int, w, eta):
        """corr(z) = log q(z) - log p_ref(z), zero before activation."""
        if i < self.start:
            return torch.zeros(w.shape[:-1], dtype=w.dtype, device=w.device)
        return self.logq(st, i, self.z(w, eta)) - self.logp_ref(w, eta)

    def grad_w(self, st: ChainState, i: int, w, eta):
        """d corr / d w at fixed eta: the full-covariance family couples
        w and eta, the diagonal one's w-gradient is eta-free."""
        cfg = self.cfg
        if self.full_cov:
            gz = vref.grad_logq_chol(self.z(w, eta), st.vr_mean, st.vr_chol)
            return gz[..., :w.shape[-1]] + w / cfg.sigma_sq
        mu, var = self.stats(st, i)
        return vref.grad_correction(w, mu[:w.shape[-1]], var[:w.shape[-1]],
                                    cfg.sigma_sq)

    def eta_term(self, st: ChainState, i: int, w, eta, at):
        """The eta block's share of the correction, ``vr_term(eta',
        dprior)`` for ``precond_step.eta_move``: (1 - beta) (dlog q_eta -
        dlog p_eta), dlog p_eta being the prior's change."""
        if i < self.start:
            return None

        def term(eta_prop, dprior):
            if self.full_cov:
                dlogq = self.logq(st, i, self.z(w, eta_prop)) \
                    - self.logq(st, i, self.z(w, eta))
            else:
                mu, var = self.stats(st, i)
                mu_e, var_e = mu[self.w_dim], var[self.w_dim]
                dlogq = -0.5 * (torch.square(eta_prop - mu_e)
                                - torch.square(eta - mu_e)) / var_e
            return (1.0 - 1.0 / at) * (dlogq - dprior)

        return term

    def update(self, st: ChainState, new: ChainState, i: int) -> ChainState:
        """Fold the post-step, post-swap cold chain's z into the Welford
        moments between accum_start and burn_end; a no-op when static."""
        if self.static:
            return new
        live = self.accum_start <= i < self.burn_end
        if not live:
            return new
        cnt = float(max(min(i + 1, self.burn_end) - self.accum_start, 1))
        mean, m2 = vref.welford_update(st.vr_mean, st.vr_m2,
                                       self.z(new.w[0], new.eta[0]), cnt,
                                       True)
        return new.replace(vr_mean=mean, vr_m2=m2)

    def _single(self, w, grad: bool):
        """The likelihood term of one configuration (-SSE/2, or the
        multinomial ll) by the plain forward, and its gradient when
        ``grad``: no eval kernel runs."""
        if grad:
            (val, _aux), g = self.vg(w[None])
            return val[0], g[0]
        d, spec = self.data, self.spec
        out = spec.forward(w[None], d.x_train)
        if self.reg:
            return -0.5 * torch.sum(torch.square(d.y_train - out[0, :, 0])), \
                None
        logp = spec.log_probs(out)[0]
        idx = d.y_train.to(torch.int64)[:, None]
        return torch.sum(torch.gather(logp, -1, idx)[:, 0]), None

    def regen(self, st: ChainState, i: int, zn, u):
        """The hot rung's independence proposal z' ~ q (w and, regression,
        eta jointly; ``zn`` its standard normal, ``u`` the test's uniform),
        after the swap event. Its ratio dprior + beta dLL + (1 - beta) dcorr
        + log q(z) - log q(z') cancels to beta (dlog p_ref + dLL - dlog q)
        and is formed so: every log q term carries beta, so at beta = 0 the
        acceptance is 1 whatever the (floored, up to 1e8) log q values.
        Returns the state and |u - acceptance| (None before activation)."""
        cfg, wd = self.cfg, self.w_dim
        zn = zn[:wd + int(self.reg)]
        if self.full_cov:
            z_new = vref.sample_q_chol(st.vr_mean, st.vr_chol, z=zn)
        else:
            mu, var = self.stats(st, i)
            z_new = vref.sample_q(mu, var, z=zn)
        if self.reg:
            w_new, eta_new = z_new[:wd], z_new[wd]
        else:
            w_new, eta_new = z_new, st.eta[-1]
        w_cur, eta_cur = st.w[-1], st.eta[-1]
        val_new, g_new = self._single(w_new, st.g_like is not None)
        if self.reg:
            ll_new = (-0.5 * self.n_rows) * (likelihood._LOG_2PI + eta_new) \
                + val_new * torch.exp(-eta_new)
            prior_new = likelihood.regression_log_prior_dim(
                w_new[None], torch.exp(eta_new)[None],
                self.spec.prior_dim_regression, cfg.sigma_sq, cfg.nu_1,
                cfg.nu_2)[0]
        else:
            ll_new = val_new
            prior_new = likelihood.classification_log_prior_dim(
                w_new[None], self.spec.prior_dim_classification,
                cfg.sigma_sq)[0]
        dlogp_ref = self.logp_ref(w_new, eta_new) \
            - self.logp_ref(w_cur, eta_cur)
        dlogq = self.logq(st, i, z_new) \
            - self.logq(st, i, self.z(w_cur, eta_cur))
        log_r = self.beta_hot * (dlogp_ref + (ll_new - st.ll[-1]) - dlogq)
        active = i >= self.start
        prob = torch.exp(torch.clamp(log_r, max=0.0))
        acc = (u < prob) & active

        def last(x, new):
            x = x.clone()
            x[-1] = torch.where(acc, new, x[-1])
            return x

        out = st.replace(
            w=last(st.w, w_new), eta=last(st.eta, eta_new),
            ll=last(st.ll, ll_new), prior=last(st.prior, prior_new),
            w_last=last(st.w_last, w_new),
            n_regen_accepted=st.n_regen_accepted + acc.to(torch.int32),
            n_regen_proposed=st.n_regen_proposed + int(active))
        if g_new is not None:
            out = out.replace(g_like=last(st.g_like, g_new))
        return out, (torch.abs(u - prob) if active else None)


def do_swap(
    cfg: PTConfig,
    state: ChainState,
    temps: torch.Tensor,
    i: int,
    us: torch.Tensor,
    pair_mask: Optional[torch.Tensor] = None,
    vr: Optional[VRef] = None,
    cells: Optional[int] = None,
    parity=None,
    pair_penalty: Optional[torch.Tensor] = None,
    result: bool = False,
):
    """One replica-exchange event after step ``i`` with uniforms ``us``
    (C-1,). ``pair_mask`` comes from ``swap.pair_mask`` for replicated
    ladders. Under the variational reference ``vr`` the swap energy is E =
    LL - corr, exact for the corrected path. A grid (``cells``) counts its
    swaps per cell, (G,), and its pairs take the ``parity`` of the even/odd
    sweep that ``Grid.swap_plan`` gives them (default: ``(i //
    swap_interval) % 2``). ``pair_penalty`` (C-1,) lowers each pair's
    metropolis exponent (sgld's corrected swap). With ``result`` the sweep's
    ``SwapResult`` comes back beside the state."""
    adapttemp = adapttemp_at(cfg, temps, i)
    if vr is not None:
        payload = state.ll - vr.corr(state, i, state.w, state.eta)
    elif cfg.swap_payload == "tempered":
        payload = state.ll / adapttemp
    elif cfg.swap_payload == "tempered_times_T":
        payload = (state.ll / adapttemp) * temps
    else:  # untempered
        payload = state.ll
    if cfg.swap_style == "even_odd":
        res = swap_mod.disjoint_pair_permutation(
            payload, us, rule=cfg.swap_rule, betas=1.0 / adapttemp,
            parity=((i // cfg.swap_interval) % 2 if parity is None
                    else parity),
            pair_penalty=pair_penalty,
            pair_mask=pair_mask,
        )
    else:
        res = swap_mod.sweep_permutation(
            payload, us, rule=cfg.swap_rule, betas=1.0 / adapttemp,
            pair_penalty=pair_penalty, pair_mask=pair_mask,
        )
    w, eta = swap_mod.apply_permutation(res.perm, state.w, state.eta)
    if cfg.stale_likelihood_after_swap:
        ll, prior = state.ll, state.prior
    else:
        ll, prior = swap_mod.apply_permutation(res.perm, state.ll, state.prior)
    pad = lambda a: torch.nn.functional.pad(a, (0, 1))
    n_acc, n_prop = res.n_accepted, res.n_proposed
    if cells is not None:
        # pair k lies in cell k // (C / G); the pairs across a boundary are
        # never proposed
        def per_cell(v):
            return pad(v.to(torch.int32)).view(cells, -1).sum(
                1, dtype=torch.int32)
        n_acc, n_prop = per_cell(res.pair_swapped), per_cell(res.pair_active)
    out = state.replace(
        w=w,
        eta=eta,
        ll=ll,
        prior=prior,
        n_swap_accepted=state.n_swap_accepted + n_acc,
        n_swap_proposed=state.n_swap_proposed + n_prop,
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
    if state.sg_anchor_w is not None:
        # the control variate describes the travelling configuration
        a_w, a_e, a_f = swap_mod.apply_permutation(
            res.perm, state.sg_anchor_w, state.sg_anchor_eta,
            state.sg_anchor_full)
        out = out.replace(sg_anchor_w=a_w, sg_anchor_eta=a_e,
                          sg_anchor_full=a_f)
    return (out, res) if result else out


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
    spec = spec or default_spec(cfg)
    if cfg.adapt_step_size and cfg.use_langevin_gradients \
            and spec.adapt_ties_drift and not spec.drift_per_chain_rate:
        return ("adapt_step_size with Langevin gradients (the drift rate "
                "tied to each chain's adapted step) on a drift that takes "
                "one rate")
    if cfg.task == "regression" and cfg.topology[2] != 1:
        return "regression with more than one output"
    return None


def mask_reason(cfg: PTConfig, data: Dataset) -> Optional[str]:
    """What ptnn refuses on a padded (masked) dataset, in ptnn's words
    (ptnn/kernel.py:643-670, 708-712); None: ``cfg`` runs on it."""
    has_mask = data.mask_train is not None or data.class_mask is not None
    has_w_mask = data.w_mask is not None
    if (has_mask or has_w_mask) and (cfg.proposal != "reference"
                                     or cfg.use_surrogate):
        return ("masked (padded) datasets support the reference proposal "
                "machinery only (sweeps.dataset_grid / classification_grid "
                "scope)")
    if has_w_mask and cfg.task == "regression":
        return ("parameter masks target the classification envelope grid; "
                "the regression sets share one topology (and the regression "
                "prior's dimension term is not the parameter count, so a "
                "traced mask-sum would be wrong there)")
    if has_w_mask and cfg.record_fx:
        return ("record_fx with an envelope-padded classification dataset "
                "would trace per-row predictions of padded rows; run grids "
                "with record_fx=False")
    if cfg.variational_reference and (has_mask or has_w_mask):
        return ("variational_reference is not supported under "
                "envelope-padded (masked) datasets: the fitted q would "
                "couple padded coordinates")
    if (has_mask or has_w_mask) and cfg.use_langevin_gradients \
            and cfg.drift_mode == "pallas":
        return ("the Pallas drift kernel has no row/parameter-mask support; "
                "use drift_mode='sequential' or 'batch' with padded "
                "datasets")
    return None


def grid_reason(cfg: PTConfig) -> Optional[str]:
    """The feature of ``cfg`` a grid of runs (``Grid``) does not run yet;
    None: it runs ``cfg``."""
    if cfg.proposal != "reference":
        return f"proposal={cfg.proposal!r}"
    if cfg.use_surrogate:
        return "use_surrogate"
    if cfg.variational_reference:
        return "variational_reference"
    if cfg.drift_chain_microbatch > 1:
        return "drift_chain_microbatch > 1"
    if cfg.eval_dtype != "float32":
        return f"eval_dtype={cfg.eval_dtype!r}"
    return None


def plan_reason(cfg: PTConfig, spec: model_api.ModelSpec,
                data: Dataset) -> Optional[str]:
    """What the hand-written kernels cannot lay out for ``cfg`` on ``data``,
    naming the limit (``ops.drift.plan``, ``ops.fnn_eval.launch_plan``:
    pure Python, so that a run is refused alike on every device); None:
    both fit."""
    topo = spec.fnn_topology
    if topo is None:
        return None
    from ptnn_torch.ops import drift as drift_mod
    from ptnn_torch.ops import fnn_eval as eval_mod

    try:
        if cfg.use_langevin_gradients and cfg.drift_mode != "batch":
            drift_mod.plan(cfg.num_chains, data.x_train.shape[-2], 1, topo)
        if _fnn_kernel(cfg, spec):
            eval_mod.launch_plan(cfg.num_chains, (data.x_train.shape[-2],
                                                  data.x_test.shape[-2]), topo)
    except ValueError as e:
        return str(e)
    return None


@dataclasses.dataclass
class Grid:
    """A sweep's cells on the chain axis (ptnn's vmapped cells,
    ptnn/sweeps.py): ``cells`` runs of ``cfg.num_chains`` chains each,
    cell-major, each on its own ladder (the step's ``temps``), and, where
    given, ptnn's traced overrides: ``swap_interval`` one host int a cell
    (its own swap events and even/odd parity; a cell with an interval <= 0
    or past the run never swaps), ``langevin_prob`` and ``learn_rate``
    float32 (C,), one a chain. Cells never swap with each other."""

    cells: int
    swap_interval: Optional[Tuple[int, ...]] = None
    langevin_prob: Optional[torch.Tensor] = None
    learn_rate: Optional[torch.Tensor] = None


def step_noise_names(cfg: PTConfig) -> Tuple[str, ...]:
    """The per-step noise a run of ``cfg`` reads: "w" normal (C, W), "u"
    uniform (C,) for the MH test, "u_swap" uniform (C-1,) for the swap
    event; "l" uniform (C,), the Langevin choice, with Langevin gradients;
    "eta" normal (C,) for regression. The preconditioned family: "w" is
    the proposal's (pCN: the prior draw's, HMC: the momentum's) standard
    normal; regression adds "u_eta" uniform (C,) for the eta block's test;
    HMC with a step jitter "jit" uniform (C,). ptnn draws them from
    ``kp, ke, ku, kue, ks = split(key, 5)`` (HMC: ``kp, kj = split(kp)``):
    w, eta, u, u_eta, u_swap, and jit from kj. The variational reference's
    hot-rung regeneration (``vr_regen``) reads "vr_z" normal (W+1,), of
    which classification takes the first W, and "u_regen" uniform (), drawn
    every step; ptnn splits its swap key, ``ks, kr = split(ks)``, and
    draws u_swap from the first, vr_z and u_regen from ``kq, ka =
    split(kr)``. The surrogate modes (``use_surrogate``) add "u_surr"
    uniform (), the step's surrogate decision, and delayed acceptance
    "u_seg" uniform (C,), the test of the segment a step closes; ptnn draws
    them from ``ksu`` of ``split(key, 6)`` (anchored) and ``ksu, kseg`` of
    ``split(key, 7)`` (delayed acceptance: kp, kl, ke, ku, ks, ksu, kseg).
    A segment closed at a chunk boundary or at the run's end reads the
    sampler's ``close_noise`` draw of that boundary instead. sgld reads "w"
    normal (C, W), "eta" normal (C,) (regression), "u_swap", and "batch"
    int64 (B,): the step's minibatch, B = min(sg_batch, N) row indices, a
    prefix of a uniform permutation of the train rows (B = N: every row);
    under ``sg_swap="corrected"`` also "batch_swap", the swap event's own
    minibatch. ptnn draws them from ``kb, kn, ke, ks = split(key, 4)``:
    batch = ``permutation(kb, N)[:B]``, w, eta, and u_swap from ks, or
    under the corrected swap batch_swap and u_swap from ``kb2, ks2 =
    split(ks)``."""
    if cfg.proposal == "sgld":
        names = ("w", "u_swap", "batch")
        if cfg.task == "regression":
            names += ("eta",)
        if cfg.sg_swap == "corrected":
            names += ("batch_swap",)
        return names
    names = ("w", "u", "u_swap")
    if cfg.use_langevin_gradients:
        names += ("l",)
    if cfg.task == "regression":
        names += ("eta",)
        if cfg.proposal in PRECOND:
            names += ("u_eta",)
    if cfg.proposal == "hmc" and cfg.hmc_eps_jitter > 0.0:
        names += ("jit",)
    if cfg.variational_reference and cfg.vr_regen:
        names += ("vr_z", "u_regen")
    if cfg.use_surrogate:
        names += ("u_surr",)
        if cfg.surrogate_mode == "delayed_acceptance":
            names += ("u_seg",)
    return names


def spec_fx(cfg: PTConfig, spec: model_api.ModelSpec, w: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """Every chain's predictions on the rows ``x`` by the plain forward
    (``record_fx``; bfloat16 evals: ``eval_forward``'s, as ptnn traces its
    evals' outputs): the output (regression), the predicted class index as
    float32 (classification)."""
    out = (eval_forward(cfg, spec, w, x) if cfg.eval_dtype == "bfloat16"
           else spec.forward(w, x))
    if cfg.task == "regression":
        return out[:, :, 0]
    return fnn.predict_class(out).to(torch.float32)


class Surrogate:
    """The surrogate modes' share of a run (ptnn/kernel.py:1150-1197): the
    projection, the family, and the host's copy of the two flags a step's
    decision reads, so that the step knows its branch without a copy from
    the device: ``fitted`` changes only at a refit and is read once a chunk
    (``sync``); ``active``, whether a segment is open, is the previous
    step's decision, tracked here. A step takes the surrogate when ``i >=
    warmup_end``, the fit is trusted and its "u_surr" < ``surrogate_prob``
    (float32, as ptnn compares), and under delayed acceptance no swap
    follows it. ``proj`` defaults to ``surrogate.make_projection``'s."""

    def __init__(self, cfg: PTConfig, w_size: int, device,
                 proj: Optional[torch.Tensor] = None):
        self.cfg = cfg
        if proj is None:
            proj = surrogate_mod.make_projection(w_size + 1,
                                                 cfg.surrogate_proj, device)
        self.proj = torch.as_tensor(proj, dtype=torch.float32, device=device)
        self.fam = surrogate_mod.family_for(cfg)
        self.warmup_end = int(cfg.n_steps * cfg.surrogate_warmup_frac)
        self.prob = float(np.float32(cfg.surrogate_prob))
        self.da = cfg.surrogate_mode == "delayed_acceptance"
        self.fitted: Optional[bool] = None
        self.active: Optional[bool] = None
        self.taken = 0  # surrogate steps decided, on the host

    def sync(self, state: ChainState) -> None:
        """Read ``fitted`` (and ``active``) from the state: one copy."""
        flags = [state.surr.fitted] + ([state.da.active] if self.da else [])
        vals = torch.stack(flags).tolist()
        self.fitted = bool(vals[0])
        self.active = bool(vals[1]) if self.da else False

    def decide(self, state: ChainState, i: int, u: torch.Tensor) -> bool:
        """Whether step ``i`` is a surrogate step; ``u`` is its "u_surr"
        (the sampler brings a chunk's to the host at once)."""
        if self.fitted is None:
            self.sync(state)
        use = i >= self.warmup_end and self.fitted and float(u) < self.prob
        use = use and not (self.da and swap_due(self.cfg, i))
        self.taken += use
        return use

    @staticmethod
    def z(w: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
        return torch.cat([w, eta[:, None]], dim=1)

    def ll(self, surr, w, eta) -> torch.Tensor:
        """The surrogate ll at (w, eta), (C,)."""
        return self.fam.predict(surr, self.proj, self.z(w, eta))

    def grad(self, surr, w, eta) -> torch.Tensor:
        """Its analytic gradient in z = (w, eta), (C, W + 1)."""
        return self.fam.grad_predict(surr, self.proj, self.z(w, eta))


class StepFn:
    """ptnn's ``make_step_fn`` for the reference proposal: ``step(state, i,
    noise) -> (state, trace)`` advances every chain by one MH step (and the
    swap event after it when ``swap_due(cfg, i)``); ``recompute_ll``.
    ``noise`` holds this step's draws (``step_noise_names``). With
    ``diagnostics`` set, the trace also carries "margin", |u - mh_prob|:
    how far each chain's decision was from flipping (the hot rung's also
    from its regeneration's)."""

    def __init__(self, cfg: PTConfig, data: Dataset, temps: torch.Tensor,
                 spec: model_api.ModelSpec,
                 surrogate_proj: Optional[torch.Tensor] = None,
                 grid: Optional[Grid] = None):
        reason = step_reason(cfg, spec)
        if reason is not None:
            raise NotImplementedError(
                f"ptnn_torch's per-step sampler does not run {reason}: not "
                f"yet ported")
        reason = mask_reason(cfg, data) or plan_reason(cfg, spec, data)
        if reason is not None:
            raise ValueError(reason)
        if cfg.use_langevin_gradients and data.t_train is None:
            raise ValueError("Langevin gradients need data.t_train")
        if grid is None and data.cells > 1:
            grid = Grid(data.cells)
        if grid is not None:
            reason = grid_reason(cfg)
            if reason is not None:
                raise NotImplementedError(
                    f"ptnn_torch's grid of runs does not run {reason}: not "
                    f"yet ported")
            if data.cells not in (1, grid.cells):
                raise ValueError(f"{data.cells} cells of rows for a grid of "
                                 f"{grid.cells} cells")
        if (grid is not None or data.masked) and spec.fnn_topology is None:
            _fnn_only(spec, data.x_train, True)
        self.cfg, self.data, self.temps, self.spec = cfg, data, temps, spec
        self.grid = grid
        self.chains = temps.shape[0]
        self.cls = cfg.task == "classification"
        self.diagnostics = False
        self.ones = torch.ones_like(temps)
        self.rec = recorded_chains(cfg)
        self.pair_mask = swap_mod.pair_mask(cfg.num_chains,
                                            cfg.rungs_per_ladder,
                                            temps.device)
        self._swap_plans: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.burn_end = int(cfg.samples_per_chain * cfg.burn_in) - 1
        # ptnn's traced overrides, one a chain, else the config's
        self.lprob = cfg.langevin_prob
        self.lrate = cfg.learn_rate
        if grid is not None and grid.langevin_prob is not None:
            self.lprob = grid.langevin_prob
        if grid is not None and grid.learn_rate is not None:
            self.lrate = grid.learn_rate
        # a grid's parameter mask (C, W) and the prior's and the legacy
        # ratio's dimension: each chain's count of real parameters
        self.w_mask = data.chain_w_mask(self.chains)
        self.prior_dim = prior_dim_classification(spec, data, self.chains)
        dim = (torch.tensor(float(spec.w_size), dtype=torch.float32)
               if self.w_mask is None else self.w_mask.sum(-1).cpu())
        # the ldpt_legacy ratio's MVN normaliser with COVARIANCE step_w, in
        # float32 as ptnn forms it
        self.log_norm = -0.5 * dim \
            * torch.log(torch.tensor(2.0 * np.pi * cfg.step_w,
                                     dtype=torch.float32))
        self.log_norm = self.log_norm.to(temps.device)
        self.vr = (VRef(cfg, spec, data, temps)
                   if cfg.variational_reference else None)
        self.surr = (Surrogate(cfg, spec.w_size, temps.device, surrogate_proj)
                     if cfg.use_surrogate else None)
        # sgld's minibatch (train rows, rows a batch): the "batch" noise
        self.batch_shape: Optional[Tuple[int, int]] = None

    def _prior(self, w, tau):
        """The log prior of (w, tau) for every chain (tau: regression's
        noise variance)."""
        cfg, spec = self.cfg, self.spec
        if self.cls:
            return likelihood.classification_log_prior_dim(
                w, self.prior_dim, cfg.sigma_sq)
        return likelihood.regression_log_prior_dim(
            w, tau, spec.prior_dim_regression, cfg.sigma_sq, cfg.nu_1,
            cfg.nu_2)

    def _drift(self, w: torch.Tensor, lrate: model_api.Rate) -> torch.Tensor:
        """The spec's drift of every chain, in ``drift_chain_microbatch``
        sequential chunks of chains: the chains are independent, so the
        numbers are the whole batch's, and a gradient drift keeps the
        activations of one chunk at a time."""
        d, mb = self.data, self.cfg.drift_chain_microbatch
        kw = {}
        if d.masked:
            kw = dict(rows=d.rows_train, w_mask=d.w_mask)
        if mb <= 1:
            return self.spec.drift(w, d.x_train, d.t_train, lrate, **kw)
        rates = (lrate.chunk(mb) if isinstance(lrate, torch.Tensor)
                 else [lrate] * mb)
        return torch.cat([self.spec.drift(wk, d.x_train, d.t_train, lk,
                                          **kw)
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
        if self.w_mask is not None:
            # a masked parameter never moves: no noise, no drift (masked in
            # the epoch), so its q-ratio terms are 0 too
            nw = nw * self.w_mask
        if not cfg.use_langevin_gradients:
            return state.w + nw, torch.zeros_like(state.ll), state.n_langevin
        use_l = noise["l"] < self.lprob
        # with step-size adaptation the drift scale is tied to each chain's
        # adapted step (MALA: drift = (sigma^2 / 2) grad log pi) and
        # the learning rate is ignored (ptnn/kernel.py:688-707), where the
        # spec ties them (``adapt_ties_drift``)
        lrate = (0.5 * torch.exp(2.0 * state.log_step_w)
                 if cfg.adapt_step_size and self.spec.adapt_ties_drift
                 else self.lrate)

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
        """ptnn/kernel.py:1260-1393 for the reference proposal; under
        ``surrogate_mode="delayed_acceptance"`` ptnn's ``step_da``
        (``_step_da``). In the anchored mode a surrogate step (``Surrogate.
        decide``) takes the proposal's likelihood from the surrogate and
        launches no eval; a true step pushes its (proposal, ll) pair."""
        sg = self.surr
        if sg is not None and sg.da:
            return self._step_da(state, i, noise)
        at = self.temps if i < self.cfg.temper_switch_step else self.ones
        use = sg is not None and sg.decide(state, i, noise["u_surr"])
        new, trace, mh_prob, w_prop, eta_prop, ll_prop = self._true_step(
            state, i, noise, at, use_surr=use)
        if sg is not None and not use:
            new = new.replace(surr=surrogate_mod.push(
                state.surr, sg.z(w_prop, eta_prop), ll_prop))
        new = self._adapt_step(state, new, i, mh_prob)
        if self.diagnostics:
            trace["margin"] = torch.abs(noise["u"] - mh_prob)
            if sg is not None:
                trace["surrogate"] = torch.tensor(use)
        if self.cfg.record_eta and not self.cls:
            trace["eta"] = new.eta[self.rec]
        return self._finish(state, new, trace, i, noise)

    def _true_step(self, state, i, noise, at, use_surr=False):
        """The MH step on the proposal (ptnn's step body, and step_da's
        ``_true_core``): the proposal's likelihood and metrics from one eval
        of both row sets, or, with ``use_surr``, its likelihood from the
        surrogate and the metrics carried. Returns (state, trace, mh_prob,
        w_prop, eta_prop, ll_prop)."""
        cfg, d, spec = self.cfg, self.data, self.spec
        w_prop, diff_prop, n_langevin = self._propose(state, noise, at)
        if self.cls:
            eta_prop = state.eta
            tau_prop = None
        else:
            eta_prop = state.eta + cfg.step_eta * noise["eta"]
            tau_prop = torch.exp(eta_prop)
        prior_prop = self._prior(w_prop, tau_prop)
        fx = None
        if use_surr:
            # no dataset pass: the metrics keep their last values
            ll_prop = self.surr.ll(state.surr, w_prop, eta_prop)
            rmse_tr, acc_tr = state.rmse_train, state.acc_train
            rmse_te, acc_te = state.rmse_test, state.acc_test
            if cfg.record_fx:
                fx = (state.fx_train, state.fx_test)
        else:
            (ll_prop, rmse_tr, acc_tr), (_ll, rmse_te, acc_te) = \
                spec_eval_pair(cfg, spec, w_prop, d.x_train, d.y_train,
                               d.x_test, d.y_test, tau_prop, d)
        log_mh = (ll_prop - state.ll) / at + (prior_prop - state.prior) \
            + diff_prop
        if self.vr is not None:
            # (1 - beta)(corr(z') - corr(z)): the step proposes w and eta
            log_mh = log_mh + (1.0 - 1.0 / at) * (
                self.vr.corr(state, i, w_prop, eta_prop)
                - self.vr.corr(state, i, state.w, state.eta))
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
        new = self._fx(state, new, trace, accept, w_prop, fx)
        if cfg.record_w:
            trace["w"] = new.w_last[self.rec]
        return new, trace, mh_prob, w_prop, eta_prop, ll_prop

    def _adapt_step(self, state, new, i, mh_prob):
        """``adapt_step_size``: Robbins-Monro toward the target acceptance
        until burn-in."""
        cfg = self.cfg
        if not cfg.adapt_step_size:
            return new
        delta = cfg.adapt_rate * (mh_prob - cfg.adapt_target_accept)
        lsw = state.log_step_w + (delta if i < self.burn_end else 0.0)
        return new.replace(log_step_w=torch.clamp(lsw, _LOG_STEP_LO,
                                                  _LOG_STEP_HI))

    def _step_da(self, state, i, noise):
        """ptnn's ``step_da`` (ptnn/kernel.py:1395-1600): one of three
        steps, as the host decides. A surrogate step (``_surr_inner``)
        extends the open segment, or opens one, with an inner move against
        the surrogate target, launching no drift and no eval; the first true
        step after a segment closes it (``_close_core``: one eval) and then
        takes a true step from the corrected state; otherwise a plain true
        step. Swap steps are true steps (``Surrogate.decide``). The ring
        takes the closure's row, then the true step's."""
        sg = self.surr
        at = self.temps if i < self.cfg.temper_switch_step else self.ones
        use = sg.decide(state, i, noise["u_surr"])
        margin = None
        if use:
            new, trace, mh_prob = self._surr_inner(state, noise, at)
        else:
            st, rows = state, []
            if sg.active:
                st, row, p_close = self._close_core(state, i, noise["u_seg"])
                rows.append(row)
                margin = torch.abs(noise["u_seg"] - p_close)
            new, trace, mh_prob, w_prop, eta_prop, ll_prop = \
                self._true_step(st, i, noise, at)
            rows.append((sg.z(w_prop, eta_prop), ll_prop))
            surr = state.surr
            for z, ll in rows:
                surr = surrogate_mod.push(surr, z, ll)
            new = new.replace(surr=surr)
        sg.active = use
        new = self._adapt_step(state, new, i, mh_prob)
        if self.diagnostics:
            m = torch.abs(noise["u"] - mh_prob)
            trace["margin"] = m if margin is None else torch.minimum(m,
                                                                     margin)
            trace["surrogate"] = torch.tensor(use)
        return self._finish(state, new, trace, i, noise)

    def _surr_inner(self, st, noise, at):
        """A surrogate step of delayed acceptance: a segment opens at the
        current state (its anchor) unless one is open; the inner proposal is
        a random walk, or (``surrogate_inner="mala"``) MALA on the analytic
        surrogate gradient with its q-ratio, tested against the surrogate
        target. The carried ll, ``w_last`` and the metrics stay at the
        anchor's until the segment closes."""
        cfg, sg = self.cfg, self.surr
        da = st.da
        if sg.active:
            ll_surr_cur = da.ll_surr
        else:
            ll_surr_cur = sg.ll(st.surr, st.w, st.eta)
            da = da.replace(anchor_w=st.w, anchor_eta=st.eta,
                            anchor_prior=st.prior,
                            anchor_llsurr=ll_surr_cur, n_seg=da.n_seg + 1)
        if cfg.adapt_step_size:
            sw = torch.exp(st.log_step_w)[:, None]
        else:
            sw = torch.full((cfg.num_chains, 1), cfg.step_w,
                            dtype=torch.float32, device=st.w.device)
        nw = noise["w"] * sw
        eta_prop = st.eta if self.cls else st.eta + cfg.step_eta * noise["eta"]
        diff_q = torch.zeros_like(st.ll)
        if cfg.surrogate_inner == "mala":
            wd = self.spec.w_size
            half = 0.5 * sw * sw
            g_cur = sg.grad(st.surr, st.w, st.eta)[:, :wd] / at[:, None]
            mean_fwd = st.w + half * g_cur
            w_prop = mean_fwd + nw
            g_prop = sg.grad(st.surr, w_prop, eta_prop)[:, :wd] / at[:, None]
            mean_rev = w_prop + half * g_prop
            diff_q = (torch.sum(torch.square(w_prop - mean_fwd), dim=-1)
                      - torch.sum(torch.square(st.w - mean_rev), dim=-1)) \
                / (2.0 * sw[:, 0] * sw[:, 0])
        else:
            w_prop = st.w + nw
        prior_prop = self._prior(w_prop, None if self.cls
                                 else torch.exp(eta_prop))
        ll_surr_prop = sg.ll(st.surr, w_prop, eta_prop)
        log_mh = (ll_surr_prop - ll_surr_cur) / at \
            + (prior_prop - st.prior) + diff_q
        mh_prob = torch.exp(torch.clamp(log_mh, max=0.0))
        accept = noise["u"] < mh_prob
        trace = {
            "ll": ll_surr_prop if self.cls else ll_surr_prop / at,
            "rmse_train": st.rmse_train,
            "rmse_test": st.rmse_test,
            "acc_train": st.acc_train,
            "acc_test": st.acc_test,
            "accept_count": st.n_accept,
        }
        if cfg.record_fx:
            trace["fx_train"] = st.fx_train
            trace["fx_test"] = st.fx_test
        if cfg.record_w:
            trace["w"] = st.w_last[self.rec]
        new = st.replace(
            w=torch.where(accept[:, None], w_prop, st.w),
            eta=torch.where(accept, eta_prop, st.eta),
            prior=torch.where(accept, prior_prop, st.prior),
            n_accept=st.n_accept + accept.to(torch.int32),
            da=da.replace(ll_surr=torch.where(accept, ll_surr_prop,
                                              ll_surr_cur),
                          active=torch.ones_like(da.active)),
        )
        return new, trace, mh_prob

    def _close_core(self, st, i, u):
        """The exact correction of the open segment (ptnn/kernel.py
        :1199-1248): one true evaluation at the segment's end (one eval
        launch for both row sets) and a Metropolis test of
        ``[pi(w_K) s(w_0)] / [pi(w_0) s(w_K)]``; the priors cancel. On
        reject the chain returns to the anchor. Returns the state, the true
        (z, ll) row for the ring, and each chain's acceptance probability."""
        cfg, d, da = self.cfg, self.data, st.da
        at = self.temps if i < cfg.temper_switch_step else self.ones
        tau = None if self.cls else torch.exp(st.eta)
        (ll_true, rmse_tr, acc_tr), (_ll, rmse_te, acc_te) = spec_eval_pair(
            cfg, self.spec, st.w, d.x_train, d.y_train, d.x_test, d.y_test,
            tau)
        log_corr = ((ll_true - st.ll) - (da.ll_surr - da.anchor_llsurr)) / at
        prob = torch.exp(torch.clamp(log_corr, max=0.0))
        acc = u < prob
        accw = acc[:, None]
        new = st.replace(
            w=torch.where(accw, st.w, da.anchor_w),
            eta=torch.where(acc, st.eta, da.anchor_eta),
            ll=torch.where(acc, ll_true, st.ll),
            prior=torch.where(acc, st.prior, da.anchor_prior),
            w_last=torch.where(accw, st.w, st.w_last),
            rmse_train=torch.where(acc, rmse_tr, st.rmse_train),
            rmse_test=torch.where(acc, rmse_te, st.rmse_test),
            acc_train=torch.where(acc, acc_tr, st.acc_train),
            acc_test=torch.where(acc, acc_te, st.acc_test),
            da=da.replace(active=torch.zeros_like(da.active),
                          n_seg_accepted=da.n_seg_accepted
                          + acc.to(torch.int32)),
        )
        if cfg.record_fx:
            new = new.replace(
                fx_train=torch.where(accw, spec_fx(cfg, self.spec, st.w,
                                                   d.x_train), st.fx_train),
                fx_test=torch.where(accw, spec_fx(cfg, self.spec, st.w,
                                                  d.x_test), st.fx_test))
        return new, (self.surr.z(st.w, st.eta), ll_true), prob

    def close_segment(self, state: ChainState, i: int,
                      u: torch.Tensor) -> ChainState:
        """The boundary closure (chunk refits, the run's end): nothing when
        no segment is open, else the correction with the uniforms ``u``
        (C,) and its true row pushed."""
        sg = self.surr
        if sg.active is None:
            sg.sync(state)
        if not sg.active:
            return state
        new, (z, ll), _p = self._close_core(state, i, u)
        sg.active = False
        return new.replace(surr=surrogate_mod.push(new.surr, z, ll))

    def refit_surrogate(self, state: ChainState) -> ChainState:
        """Refit the surrogate on its ring (plain PyTorch: a batched
        Cholesky solve, or the MLP's Adam loop)."""
        return state.replace(surr=self.surr.fam.fit(state.surr,
                                                    self.surr.proj))

    def refit_anchor(self, state: ChainState, done: int,
                     u_close: Callable[[], torch.Tensor]) -> ChainState:
        """At the start of a chunk after ``done`` steps (ptnn/sampler.py
        :182-209): close an open segment (delayed acceptance; ``u_close()``
        gives its uniforms), refit, and re-anchor every chain's carried ll
        with a true evaluation, which also stands in for the temper
        switch's recompute. Then ``fitted`` is read to the host, once a
        chunk."""
        if self.surr.da:
            if self.surr.active is None:
                self.surr.sync(state)
            if self.surr.active:
                state = self.close_segment(state, max(done - 1, 0),
                                           u_close())
        state = self.recompute_ll(self.refit_surrogate(state))
        self.surr.sync(state)
        return state

    def _fx(self, state, new, trace, accept, w_prop, fx=None):
        """``record_fx``: the proposal's predictions on both row sets (the
        plain forward, or ``fx`` given), carried on accept and traced."""
        if not self.cfg.record_fx:
            return new
        d = self.data
        if fx is None:
            fx = (spec_fx(self.cfg, self.spec, w_prop, d.x_train),
                  spec_fx(self.cfg, self.spec, w_prop, d.x_test))
        acc_w = accept[:, None]
        new = new.replace(
            fx_train=torch.where(acc_w, fx[0], state.fx_train),
            fx_test=torch.where(acc_w, fx[1], state.fx_test))
        trace["fx_train"] = new.fx_train
        trace["fx_test"] = new.fx_test
        return new

    def _finish(self, state, new, trace, i, noise):
        """The swap event when due (the hot rung regenerated after it under
        the variational reference), the reference's Welford fold, and the
        state traces: ll_cur, the post-swap untempered ll of each rung, and
        vr_corr_cur, its path correction with the statistics as of step
        i + 1 (``record_ll_state``); the replica ids."""
        cfg, vr = self.cfg, self.vr
        if self.grid is not None:
            new = self._grid_swap(new, i, noise["u_swap"])
        elif swap_due(cfg, i):
            new = do_swap(cfg, new, self.temps, i, noise["u_swap"],
                          self.pair_mask, vr)
            if vr is not None and cfg.vr_regen:
                # the fresh draw flows toward the cold end from the next
                # event on
                new, m_r = vr.regen(new, i, noise["vr_z"], noise["u_regen"])
                if self.diagnostics and m_r is not None:
                    m = trace["margin"].clone()
                    m[-1] = torch.minimum(m[-1], m_r)
                    trace["margin"] = m
        if vr is not None:
            new = vr.update(state, new, i)
        if cfg.record_ll_state:
            trace["ll_cur"] = new.ll
            if vr is not None:
                trace["vr_corr_cur"] = vr.corr(new, i + 1, new.w, new.eta)
        if cfg.track_replicas:
            trace["replica"] = new.replica_id
        return new, trace

    def _grid_swap(self, new: ChainState, i: int,
                   us: torch.Tensor) -> ChainState:
        """A grid's swap event after step ``i``: each cell whose interval
        is due sweeps its own pairs, at its own even/odd parity ``(i //
        si) % 2`` (``us`` holds one uniform a pair, the pairs across a cell
        boundary never proposed); the others stay. The pair mask and the
        pairs' parities are built once for each pattern of due cells."""
        cfg, grid = self.cfg, self.grid
        sis = grid.swap_interval or (cfg.swap_interval,) * grid.cells
        due = tuple(swap_due(cfg, i, si) for si in sis)
        if not any(due):
            return new
        par = tuple((i // si) % 2 if d else 0 for si, d in zip(sis, due))
        plan = self._swap_plans.get((due, par))
        if plan is None:
            cpc = self.chains // grid.cells
            k = np.arange(self.chains - 1)
            cell = k // cpc
            mask = ((k + 1) % cpc != 0) & np.asarray(due)[cell]
            if cfg.n_ladders > 1:
                mask &= (k + 1) % cfg.rungs_per_ladder != 0
            # pair k is pair k - cell * cpc of its cell
            parity = (np.asarray(par)[cell] + cell * cpc) % 2
            dev = self.temps.device
            plan = (torch.as_tensor(mask, device=dev),
                    torch.as_tensor(parity, device=dev))
            self._swap_plans[(due, par)] = plan
        return do_swap(cfg, new, self.temps, i, us, plan[0], None,
                       grid.cells, plan[1])

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

    def _g_post(self, g_like, w, tau, at, vr_at=None):
        """The tempered posterior gradient from the likelihood term's; under
        the variational reference, ``vr_at = (state, i, eta)`` adds (1 -
        beta) d corr / d w from the state's reference at step i (once
        active), at the block's fixed eta."""
        g = g_like if self.cls else g_like / tau[:, None]
        out = g / at[:, None] - w / self.cfg.sigma_sq
        if vr_at is not None and vr_at[1] >= self.vr.start:
            gc = self.vr.grad_w(vr_at[0], vr_at[1], w, vr_at[2])
            out = out + (1.0 - 1.0 / at)[:, None] * gc
        return out

    def _leapfrog(self, state, m, g_cur, tau, at, epsw, l_steps, p0,
                  vr_at=None):
        """``hmc_leapfrog`` leapfrog steps from (w, p0); a chain whose
        trajectory has ended (ChEES, ``n >= l_steps``) carries through.
        Returns (w', p', g_like', val', aux')."""
        w_c, p_c, g_c, gl_c = state.w, p0, g_cur, state.g_like
        v_c = a_c = None
        for n in range(self.cfg.hmc_leapfrog):
            p_half = p_c + 0.5 * epsw * g_c
            w_n = w_c + epsw * m * p_half
            (v_n, a_n), gl_n = self.vg(w_n)
            g_n = self._g_post(gl_n, w_n, tau, at, vr_at)
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
        # eta is fixed through the w block, so the current eta holds at
        # every gradient evaluation along the trajectory
        vr_at = (state, i, state.eta) if self.vr is not None else None
        if self.grad:
            g_cur = self._g_post(state.g_like, state.w, tau, at, vr_at)
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
                    state, m, g_cur, tau, at, eps[:, None], l_steps, p0,
                    vr_at)
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
                g_prop = self._g_post(g_like_prop, w_prop, tau, at, vr_at)
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
        if self.vr is not None:
            # eta is fixed in this block: its share cancels
            log_mh = log_mh + (1.0 - 1.0 / at) * (
                self.vr.corr(state, i, w_prop, state.eta)
                - self.vr.corr(state, i, state.w, state.eta))
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
        new = self._fx(state, new, trace, accept, w_prop)
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
        return self._finish(state, new, trace, i, noise)

    def _eta_block(self, state, new, i, at, noise):
        """The regression eta block: a random walk on eta, its likelihood
        recovered from the carried ll without a data pass, its scale adapted
        until burn-in ends. Returns the state and each chain's
        |u_eta - a|."""
        cfg = self.cfg
        vr_term = (None if self.vr is None else
                   self.vr.eta_term(state, i, new.w, state.eta, at))
        eta_prop, ll_eta, dprior, prob = precond_step.eta_move(
            state.eta, new.ll, state.log_step_eta, noise["eta"], self.n_train,
            at, cfg.nu_1, cfg.nu_2, vr_term)
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


class SgldStepFn(StepFn):
    """ptnn's ``step_sgld`` (ptnn/kernel.py:2159-2413): replica-exchange
    stochastic-gradient Langevin dynamics (PAPERS.md arXiv 2301.01898,
    2010.01084). Each step every rung takes one unadjusted Euler-Maruyama
    move on its tempered posterior, with the likelihood's gradient from the
    step's shared minibatch ("batch", B rows) scaled by N / B:

        grad = beta (N / B) g_l - w / sigma^2,
        w' = w + eps grad / 2 + sqrt(eps) z,

    g_l the gradient of -SSE/2 over tau (regression) or of the multinomial
    ll, and for regression an eta move alike with ptnn's minibatch dll and
    the prior's dpr. ``eps`` is a rung's: ``sg_step``, or ``sg_step T_k``
    under ``sg_lr_scale="temperature"``. No MH test: every move counts as
    accepted (and as a Langevin move). The minibatch value and gradient are
    plain PyTorch (the FNN's hand-written backprops, autograd over a zoo
    spec's forward), as ptnn leaves them to XLA; the kernels run in the
    full-data evals:

    * SVRG anchors (``sg_vr``): every ``sg_anchor_interval`` steps, before
      any swap of the step, each chain's (w, eta) and its full-data train
      ll (one ``spec_eval``) become its anchor;
    * the exact swap (``sg_swap="exact"``): at a swap event the train ll,
      the metrics and the prior are refreshed from one evaluation of both
      row sets (``spec_eval_pair``: one ``fnn_eval_pair`` launch), then the
      sweep;
    * the corrected swap: a fresh minibatch ("batch_swap") gives each
      chain's per-example ll terms c (C, B), centred by the anchors' under
      ``sg_vr``; the energy is (N / B) sum c (plus the anchor's full ll),
      and each pair's exponent drops ``(d beta)^2 var_pair / 2``,
      ``var_pair = N^2 / B var(c_k+1 - c_k)``; the test rows are evaluated
      exactly (``spec_eval``), the train metrics from the minibatch.

    With ``diagnostics`` the trace carries "margin": |u_swap - a| of each
    proposed pair k at entry k (inf elsewhere)."""

    def __init__(self, cfg: PTConfig, data: Dataset, temps: torch.Tensor,
                 spec: model_api.ModelSpec):
        super().__init__(cfg, data, temps, spec)
        n = data.y_train.shape[0]
        self.n_train = n
        self.bsz = min(cfg.sg_batch, n)
        self.batch_shape = (n, self.bsz)
        self.scale = n / self.bsz
        self.betas = 1.0 / temps  # the canonical schedule: no temper switch
        if cfg.sg_lr_scale == "temperature":
            self.eps_c = cfg.sg_step * temps
        else:
            self.eps_c = cfg.sg_step * torch.ones_like(temps)
        self.eps = self.eps_c[:, None]

    def _per_example(self, w: torch.Tensor, xb: torch.Tensor,
                     yb: torch.Tensor) -> torch.Tensor:
        """Each chain's per-example likelihood terms on a minibatch, (C, B):
        -(y - fx)^2 / 2 (tau-free, regression) or log p(y | x)."""
        out = self.spec.forward(w, xb)
        if not self.cls:
            return -0.5 * torch.square(yb - out[:, :, 0])
        logp = self.spec.log_probs(out)
        idx = yb.to(torch.int64).expand(logp.shape[:-1])[..., None]
        return torch.gather(logp, -1, idx)[..., 0]

    def step(self, state: ChainState, i: int,
             noise: Noise) -> Tuple[ChainState, Dict[str, torch.Tensor]]:
        cfg, d = self.cfg, self.data
        idx = noise["batch"]
        xb, yb = d.x_train[idx], d.y_train[idx]
        (val, _aux), g = value_and_grad_rows(cfg, self.spec, state.w, xb, yb)
        if self.cls:
            gl, eta_new = g, state.eta
        else:
            inv_tau = torch.exp(-state.eta)
            gl = g * inv_tau[:, None]
        grad_post = self.betas[:, None] * self.scale * gl \
            - state.w / cfg.sigma_sq
        w_new = state.w + 0.5 * self.eps * grad_post \
            + torch.sqrt(self.eps) * noise["w"]
        if not self.cls:
            # d log pi_beta / d eta with the minibatch SSE (val = -SSE_b/2)
            dll = -0.5 * self.n_train - self.scale * val * inv_tau
            dpr = -(1.0 + cfg.nu_1) + cfg.nu_2 * inv_tau
            eta_new = state.eta + 0.5 * self.eps_c * (self.betas * dll + dpr) \
                + torch.sqrt(self.eps_c) * noise["eta"]
        new = state.replace(w=w_new, eta=eta_new, w_last=w_new,
                            n_accept=state.n_accept + 1,
                            n_langevin=state.n_langevin + 1)
        if cfg.sg_vr and i % max(cfg.sg_anchor_interval, 1) == 0:
            tau = None if self.cls else torch.exp(new.eta)
            ll = spec_eval(cfg, self.spec, new.w, d.x_train, d.y_train,
                           tau)[0]
            new = new.replace(sg_anchor_w=new.w, sg_anchor_eta=new.eta,
                              sg_anchor_full=ll)
        margin = None
        if swap_due(cfg, i):
            if cfg.sg_swap == "exact":
                new = self._refresh_full(new)
                pen = None
            else:
                new, pen = self._corrected_energy(new, noise["batch_swap"])
            new, res = do_swap(cfg, new, self.temps, i, noise["u_swap"],
                               self.pair_mask, pair_penalty=pen, result=True)
            if self.diagnostics:
                margin = torch.where(res.pair_active,
                                     torch.abs(noise["u_swap"]
                                               - res.pair_accept), math.inf)
        trace = {
            "ll": new.ll,
            "rmse_train": new.rmse_train,
            "rmse_test": new.rmse_test,
            "acc_train": new.acc_train,
            "acc_test": new.acc_test,
            "accept_count": state.n_accept,
        }
        if cfg.record_w:
            trace["w"] = new.w_last[self.rec]
        if cfg.record_eta and not self.cls:
            trace["eta"] = new.eta[self.rec]
        if cfg.record_ll_state:
            trace["ll_cur"] = new.ll
        if cfg.track_replicas:
            trace["replica"] = new.replica_id
        if self.diagnostics:
            m = torch.full_like(state.ll, math.inf)
            if margin is not None:
                m[:-1] = margin
            trace["margin"] = m
        return new, trace

    def _refresh_full(self, s: ChainState) -> ChainState:
        """The exact swap's full-data energy, metrics and prior."""
        d = self.data
        tau = None if self.cls else torch.exp(s.eta)
        (ll, rmse_tr, acc_tr), (_ll, rmse_te, acc_te) = spec_eval_pair(
            self.cfg, self.spec, s.w, d.x_train, d.y_train, d.x_test,
            d.y_test, tau)
        if not self.cls:
            acc_tr, acc_te = s.acc_train, s.acc_test
        return s.replace(ll=ll, prior=self._prior(s.w, tau),
                         rmse_train=rmse_tr, rmse_test=rmse_te,
                         acc_train=acc_tr, acc_test=acc_te)

    def _corrected_energy(self, s: ChainState, idx: torch.Tensor):
        """The corrected swap's minibatch energies (SVRG-centred under
        ``sg_vr``), exact test metrics and prior, minibatch train metrics,
        and each pair's variance penalty (C-1,)."""
        cfg, d = self.cfg, self.data
        xb, yb = d.x_train[idx], d.y_train[idx]
        per = self._per_example(s.w, xb, yb)  # (C, B)
        tau = None if self.cls else torch.exp(s.eta)
        _ll, rmse_te, acc_te = spec_eval(cfg, self.spec, s.w, d.x_test,
                                         d.y_test, tau)
        if self.cls:
            cb = per
            rmse_tr = s.rmse_train
            pred = fnn.predict_class(self.spec.forward(s.w, xb))
            hit = (pred == yb.to(torch.int64)[None, :]).to(torch.float32)
            acc_tr = 100.0 * torch.mean(hit, dim=-1)
        else:
            cb = -0.5 * (likelihood._LOG_2PI + s.eta)[:, None] \
                + per * torch.exp(-s.eta)[:, None]
            rmse_tr = torch.sqrt(-2.0 * torch.mean(per, dim=-1))
            acc_tr, acc_te = s.acc_train, s.acc_test
        if cfg.sg_vr:
            per_a = self._per_example(s.sg_anchor_w, xb, yb)
            if self.cls:
                cb_a = per_a
            else:
                eta_a = s.sg_anchor_eta[:, None]
                cb_a = -0.5 * (likelihood._LOG_2PI + eta_a) \
                    + per_a * torch.exp(-eta_a)
            cb = cb - cb_a
            ll_hat = self.scale * torch.sum(cb, dim=-1) + s.sg_anchor_full
        else:
            ll_hat = self.scale * torch.sum(cb, dim=-1)
        diff = cb[1:] - cb[:-1]  # (C-1, B)
        var_pair = (float(self.n_train) ** 2 / self.bsz) \
            * torch.var(diff, dim=-1, correction=0)
        dbeta = self.betas[:-1] - self.betas[1:]
        pen = 0.5 * torch.square(dbeta) * var_pair
        s = s.replace(ll=ll_hat, prior=self._prior(s.w, tau),
                      rmse_train=rmse_tr, rmse_test=rmse_te,
                      acc_train=acc_tr, acc_test=acc_te)
        return s, pen


def make_step_fn(cfg: PTConfig, data: Dataset, temps: torch.Tensor,
                 spec: Optional[model_api.ModelSpec] = None,
                 surrogate_proj: Optional[torch.Tensor] = None,
                 grid: Optional[Grid] = None) -> StepFn:
    """The per-step sampler's step for ``cfg``: ``SgldStepFn`` for
    ``proposal="sgld"``, ``PrecondStepFn`` for the preconditioned family,
    else ``StepFn`` (the reference proposal, with or without Langevin
    gradients); ``spec`` defaults to the reference FNN with
    ``cfg.drift_mode``; ``grid`` runs a sweep's cells at once. Raises
    NotImplementedError naming a feature that is not ported
    (``step_reason``, ``grid_reason``) and ValueError for what ptnn refuses
    on a padded dataset (``mask_reason``) or the kernels cannot lay out
    (``plan_reason``)."""
    spec = spec or default_spec(cfg)
    if grid is None and cfg.proposal == "sgld":
        return SgldStepFn(cfg, data, temps, spec)
    if cfg.proposal in PRECOND and grid is None:
        return PrecondStepFn(cfg, data, temps, spec)
    return StepFn(cfg, data, temps, spec, surrogate_proj, grid)
