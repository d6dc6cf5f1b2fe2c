"""Surrogate-assisted parallel tempering (port of ``ptnn/surrogate.py``).

A surrogate of the untempered train log-likelihood stands in for the
full-dataset evaluation on some steps:

* the quadratic family ``ll(z) ~ theta . phi(z)`` with ``phi(z) = [1, z,
  z^2, (P z)^2]`` over z = (w, eta) and a fixed Gaussian projection ``P``,
  ridge-fitted by normal equations on standardised features;
* the MLP family, one tanh hidden layer trained by warm-started full-batch
  Adam on the same rows.

Training pairs are the (proposal, true ll) evaluations the sampler makes
anyway, collected in a ring buffer. Every chunk boundary refits the
surrogate and re-anchors each chain's carried likelihood with a true
evaluation (``sampler``). Two scopes (``PTConfig.surrogate_scope``):
"global", one theta and one ring for the whole ladder, and "per_chain", one
theta and one ring per rung, fitted as one batched solve (or one batched
Adam loop). Two modes (``surrogate_mode``) use it (``kernel.StepFn``):
"anchored", approximate, and "delayed_acceptance", exact: consecutive
surrogate steps form one composite proposal that a single true-likelihood
Metropolis test accepts or reverts when the segment closes.

Everything here is plain PyTorch on tensors, as ptnn's is XLA outside any
Pallas kernel; products run in full float32 (``ptnn`` asks for
``Precision.HIGHEST``). The projection and the MLP's initial weights come
from ``torch.Generator``s seeded with ptnn's key constants (0x5A6A, 0x5A6B)
on the CPU, so every device gets the same values; ptnn draws them by
threefry, so the tests pass ptnn's arrays in through ``convert``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from ptnn_torch.ops.precision import full_float32

PROJ_SEED = 0x5A6A  # the projection's generator (ptnn's PRNGKey(0x5A6A))
MLP_SEED = 0x5A6B  # the MLP's initial weights (ptnn's PRNGKey(0x5A6B))


@dataclasses.dataclass
class SurrogateState:
    """Ring buffer and fitted coefficients. Two layouts, told apart by rank:

    * global:    buf_w (B, Z),     buf_ll (B,),     theta (D,)
    * per_chain: buf_w (C, B', Z), buf_ll (C, B'),  theta (C, D)

    ``count`` / ``ptr`` are int32 scalars in both layouts: chains push in
    lockstep, one row a chain a true evaluation, so per-chain rings share
    one pointer."""

    buf_w: torch.Tensor
    buf_ll: torch.Tensor
    count: torch.Tensor  # () int32, rows written so far (saturates at B)
    ptr: torch.Tensor  # () int32, the ring pointer
    theta: torch.Tensor
    fitted: torch.Tensor  # () bool

    def replace(self, **kw) -> "SurrogateState":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "SurrogateState":
        return SurrogateState(**{k: v.to(device)
                                 for k, v in vars(self).items()})


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with full_float32():
        return torch.matmul(a, b)


def feature_dim(w_size: int, n_proj: int) -> int:
    return 1 + 2 * w_size + n_proj


def make_projection(w_size: int, n_proj: int, device="cpu",
                    seed: int = PROJ_SEED) -> torch.Tensor:
    """The fixed Gaussian projection (n_proj, w_size) / sqrt(w_size), drawn
    on the CPU from a generator seeded with ``seed``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    p = torch.randn((n_proj, w_size), generator=gen, dtype=torch.float32)
    return (p / torch.sqrt(torch.tensor(float(w_size)))).to(device)


def features(w: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """phi(w) for a batch: (..., N, W) -> (..., N, D)."""
    pw = _mm(w, proj.T)
    ones = torch.ones(w.shape[:-1] + (1,), dtype=w.dtype, device=w.device)
    return torch.cat([ones, w, w * w, pw * pw], dim=-1)


def init_for(cfg, w_size: int, device="cpu") -> SurrogateState:
    """The surrogate state of a config. Global scope: the buffer rounded up
    to a multiple of the chain count (a block push never wraps mid-write);
    per-chain scope: ``surrogate_buffer`` rows per chain. Features span
    z = (w, eta). Checks the buffer against the feature dimension with the
    REAL ``w_size``: ``PTConfig.validate`` sees the topology's, which
    understates it for a model spec (CNN, MLP)."""
    c = cfg.num_chains
    zdim = w_size + 1
    if cfg.surrogate_family == "mlp":
        fdim = mlp_min_rows(zdim, cfg.surrogate_hidden)
        what = f"MLP activation row count {fdim}"
        knob = "lower surrogate_hidden"
    else:
        fdim = feature_dim(zdim, cfg.surrogate_proj)
        what = f"feature dimension {fdim}"
        knob = "lower surrogate_proj"
    if cfg.surrogate_scope == "per_chain":
        if cfg.surrogate_buffer < fdim:
            raise ValueError(
                f"surrogate_buffer={cfg.surrogate_buffer} (per-chain rows) "
                f"is below the surrogate {what} for the model's "
                f"w_size={w_size}: the per-chain fits would never activate. "
                f"Raise surrogate_buffer to >= {fdim} or {knob}.")
        return _init_family(cfg, cfg.surrogate_buffer, zdim, c, device)
    buf = ((cfg.surrogate_buffer + c - 1) // c) * c
    if buf < fdim:
        raise ValueError(
            f"surrogate_buffer={cfg.surrogate_buffer} (rounded to {buf}) is "
            f"below the surrogate {what} for the model's w_size={w_size}: "
            f"the fit would never activate. Raise surrogate_buffer to >= "
            f"{fdim} or {knob}.")
    return _init_family(cfg, buf, zdim, None, device)


def _init_family(cfg, buffer_size: int, zdim: int,
                 num_chains: Optional[int] = None,
                 device="cpu") -> SurrogateState:
    st = init(buffer_size, zdim, cfg.surrogate_proj, num_chains, device)
    if cfg.surrogate_family != "mlp":
        return st
    # a fixed generator, independent of the run seed, so every driver
    # builds the same state; per chain, one draw after another
    gen = torch.Generator(device="cpu")
    gen.manual_seed(MLP_SEED)
    if num_chains is None:
        theta = mlp_init_theta(gen, zdim, cfg.surrogate_hidden)
    else:
        theta = torch.stack([mlp_init_theta(gen, zdim, cfg.surrogate_hidden)
                             for _ in range(num_chains)])
    return st.replace(theta=theta.to(device))


def init(buffer_size: int, w_size: int, n_proj: int,
         num_chains: Optional[int] = None, device="cpu") -> SurrogateState:
    """Global layout by default, per-chain when ``num_chains`` is given
    (``buffer_size`` rows a chain); the quadratic family's theta."""
    d = feature_dim(w_size, n_proj)
    lead = () if num_chains is None else (num_chains,)
    f32 = dict(dtype=torch.float32, device=device)
    return SurrogateState(
        buf_w=torch.zeros(lead + (buffer_size, w_size), **f32),
        buf_ll=torch.zeros(lead + (buffer_size,), **f32),
        count=torch.zeros((), dtype=torch.int32, device=device),
        ptr=torch.zeros((), dtype=torch.int32, device=device),
        theta=torch.zeros(lead + (d,), **f32),
        fitted=torch.zeros((), dtype=torch.bool, device=device),
    )


def _rows(state: SurrogateState) -> int:
    return state.buf_w.shape[-2]


def push(state: SurrogateState, w: torch.Tensor,
         ll: torch.Tensor) -> SurrogateState:
    """Append a (C, Z) block of pairs. Global layout: C consecutive rows
    from the pointer (the buffer is a multiple of C, so a block never
    wraps); per-chain: one row of each chain's ring at the shared pointer.
    The pointer stays on the device: no host copy."""
    b = _rows(state)
    if state.buf_w.ndim == 3:
        idx = state.ptr.to(torch.int64).view(1)
        buf_w = state.buf_w.index_copy(1, idx, w[:, None, :])
        buf_ll = state.buf_ll.index_copy(1, idx, ll[:, None])
        adv = 1
    else:
        c = w.shape[0]
        idx = state.ptr.to(torch.int64) + torch.arange(c, device=w.device)
        buf_w = state.buf_w.index_copy(0, idx, w)
        buf_ll = state.buf_ll.index_copy(0, idx, ll)
        adv = c
    return state.replace(
        buf_w=buf_w, buf_ll=buf_ll,
        ptr=((state.ptr + adv) % b).to(torch.int32),
        count=torch.clamp(state.count + adv, max=b).to(torch.int32))


def push_masked(state: SurrogateState, z: torch.Tensor, ll: torch.Tensor,
                valid: Union[bool, torch.Tensor]) -> SurrogateState:
    """``push`` when ``valid``, else the state unchanged. A host bool
    decides on the host (the sampler knows every step's branch); a device
    bool blends the rows back and advances by 0, as ptnn's masked write."""
    if not isinstance(valid, torch.Tensor):
        return push(state, z, ll) if valid else state
    pushed = push(state, z, ll)
    return state.replace(
        buf_w=torch.where(valid, pushed.buf_w, state.buf_w),
        buf_ll=torch.where(valid, pushed.buf_ll, state.buf_ll),
        ptr=torch.where(valid, pushed.ptr, state.ptr),
        count=torch.where(valid, pushed.count, state.count))


def _valid(b: int, count: torch.Tensor) -> torch.Tensor:
    return (torch.arange(b, device=count.device) < count).to(torch.float32)


def _fit_rows(buf_w: torch.Tensor, buf_ll: torch.Tensor,
              count: torch.Tensor, proj: torch.Tensor,
              ridge: float) -> torch.Tensor:
    """The ridge normal equations over the valid rows of each buffer
    (leading axes batch) -> theta. The solve runs on STANDARDISED features
    (each column centred and scaled over the valid rows, the ridge scaled
    to the standardised gram, whose diagonal is ~n), folded back to the raw
    features' coefficients: a single rung's autocorrelated rows make the raw
    gram too ill-conditioned for a float32 Cholesky."""
    b = buf_w.shape[-2]
    valid = _valid(b, count)
    n = torch.clamp(valid.sum(), min=1.0)
    phi = features(buf_w, proj)
    vc = valid[:, None]
    mu = torch.sum(phi * vc, dim=-2) / n
    var = torch.sum(torch.square(phi - mu[..., None, :]) * vc, dim=-2) / n
    sig = torch.sqrt(torch.clamp(var, min=1e-12))
    phi_s = (phi - mu[..., None, :]) / sig[..., None, :] * vc
    y_mean = torch.sum(buf_ll * valid, dim=-1) / n
    y_c = (buf_ll - y_mean[..., None]) * valid
    d = phi.shape[-1]
    eye = torch.eye(d, dtype=torch.float32, device=buf_w.device)
    gram = _mm(phi_s.transpose(-1, -2), phi_s) + (ridge * n) * eye
    rhs = _mm(phi_s.transpose(-1, -2), y_c[..., None])
    chol = torch.linalg.cholesky(gram)
    theta_s = torch.cholesky_solve(rhs, chol)[..., 0]
    theta = theta_s / sig
    # feature 0 is the constant: its centred column is zero, so the
    # intercept goes there
    intercept = y_mean - torch.sum(theta_s * (mu / sig), dim=-1)
    theta = theta.clone()
    theta[..., 0] = theta[..., 0] + intercept
    return theta


def fit(state: SurrogateState, proj: torch.Tensor, ridge: float = 1e-3,
        min_r2: float = 0.7) -> SurrogateState:
    """The ridge fit over the valid rows (per-chain: every rung's in one
    batched solve). ``fitted`` holds while the buffer has at least D rows
    and the in-buffer r-squared clears ``min_r2`` on EVERY rung: the step's
    decision is ladder-global, so one untrustworthy rung falls the whole
    ladder back to true evaluations."""
    theta = _fit_rows(state.buf_w, state.buf_ll, state.count, proj, ridge)
    d = theta.shape[-1]
    ok = state.count >= d
    cand = state.replace(theta=torch.where(ok, theta, state.theta))
    good = ok & (torch.min(r_squared(cand, proj)) >= min_r2)
    return cand.replace(fitted=good)


def predict(state: SurrogateState, proj: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """Surrogate log-likelihood of a (C, Z) block -> (C,); per-chain theta
    applies rung i's coefficients to row i."""
    phi = features(w, proj)
    if state.theta.ndim == 2:
        return torch.sum(phi * state.theta, dim=-1)
    return _mm(phi, state.theta)


def grad_predict(state: SurrogateState, proj: torch.Tensor,
                 z: torch.Tensor) -> torch.Tensor:
    """The analytic gradient of the surrogate ll, (C, Z) -> (C, Z):
    ``theta_z + 2 theta_z2 * z + 2 P^T ((P z) * theta_p)``."""
    zdim = z.shape[1]
    t_z = state.theta[..., 1:1 + zdim]
    t_z2 = state.theta[..., 1 + zdim:1 + 2 * zdim]
    t_p = state.theta[..., 1 + 2 * zdim:]
    pz = _mm(z, proj.T)
    cross = _mm(pz * t_p, proj)
    return t_z + 2.0 * t_z2 * z + 2.0 * cross


# ---------------------------------------------------------------------------
# The MLP family (surrogate_family="mlp"): ll_hat(z) = y_sig * (v . tanh(A zs
# + b) + c) + y_mu with zs = (z - mu) / sig, every parameter flattened into
# theta so the state's layout, checkpoints and the per-chain scope are the
# quadratic family's.


def mlp_dim(zdim: int, hidden: int) -> int:
    """theta layout: [A (H*Z), b (H), v (H), c (1), mu (Z), sig (Z), y_mu
    (1), y_sig (1)]."""
    return hidden * zdim + 2 * hidden + 2 * zdim + 3


def _mlp_unpack(theta: torch.Tensor, zdim: int, hidden: int):
    """The parts of theta (leading axes batch): A (..., H, Z), b, v (...,
    H), c (...), mu, sig (..., Z), y_mu, y_sig (...)."""
    o = 0
    lead = theta.shape[:-1]
    a = theta[..., o:o + hidden * zdim].reshape(lead + (hidden, zdim))
    o += hidden * zdim
    b = theta[..., o:o + hidden]
    o += hidden
    v = theta[..., o:o + hidden]
    o += hidden
    c = theta[..., o]
    o += 1
    mu = theta[..., o:o + zdim]
    o += zdim
    sig = theta[..., o:o + zdim]
    o += zdim
    return a, b, v, c, mu, sig, theta[..., o], theta[..., o + 1]


def mlp_init_theta(gen: torch.Generator, zdim: int,
                   hidden: int) -> torch.Tensor:
    """The initial net: A ~ N(0, 1/Z), v ~ 0.1 N(0, 1/H), the rest zero,
    sig and y_sig one (on the CPU, from ``gen``)."""
    a = torch.randn((hidden, zdim), generator=gen) / math.sqrt(zdim)
    v = 0.1 * torch.randn((hidden,), generator=gen) / math.sqrt(hidden)
    z = lambda n: torch.zeros((n,), dtype=torch.float32)
    o = lambda n: torch.ones((n,), dtype=torch.float32)
    return torch.cat([a.reshape(-1), z(hidden), v, z(1), z(zdim), o(zdim),
                      z(1), o(1)])


def _mlp_hidden(a, b, zs):
    """tanh(zs A^T + b): zs (..., N, Z) -> (..., N, H)."""
    return torch.tanh(_mm(zs, a.transpose(-1, -2)) + b[..., None, :])


def mlp_predict(theta: torch.Tensor, z: torch.Tensor,
                hidden: int) -> torch.Tensor:
    """Surrogate ll of a (C, Z) block -> (C,); a per-chain theta (C, D)
    routes rung i's net to row i."""
    zdim = z.shape[1]
    a, b, v, c, mu, sig, y_mu, y_sig = _mlp_unpack(theta, zdim, hidden)
    if theta.ndim == 2:
        zs = ((z - mu) / sig)[:, None, :]  # one row a chain
        h = _mlp_hidden(a, b, zs)[:, 0, :]
        return y_sig * (torch.sum(h * v, dim=-1) + c) + y_mu
    h = _mlp_hidden(a, b, (z - mu) / sig)
    return y_sig * (_mm(h, v) + c) + y_mu


def mlp_grad(theta: torch.Tensor, z: torch.Tensor,
             hidden: int) -> torch.Tensor:
    """The analytic d ll_hat / dz of a (C, Z) block -> (C, Z):
    y_sig * A^T (v * (1 - h^2)) / sig."""
    zdim = z.shape[1]
    a, b, v, _c, mu, sig, _y_mu, y_sig = _mlp_unpack(theta, zdim, hidden)
    if theta.ndim == 2:
        h = _mlp_hidden(a, b, ((z - mu) / sig)[:, None, :])[:, 0, :]
        g = _mm(((v * (1.0 - h * h)))[:, None, :], a)[:, 0, :]
        return y_sig[:, None] * g / sig
    h = _mlp_hidden(a, b, (z - mu) / sig)
    return y_sig * _mm(v * (1.0 - h * h), a) / sig


def _mlp_fit_rows(buf_w: torch.Tensor, buf_ll: torch.Tensor,
                  count: torch.Tensor, theta0: torch.Tensor, hidden: int,
                  steps: int, lr: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warm-started full-batch Adam on each buffer (leading axes batch) ->
    (theta, r2). The standardisation is recomputed from the valid rows at
    every refit; the net starts from the previous fit's weights and trains
    ``steps`` iterations. The loss's gradient is written out by hand (the
    net has one hidden layer), batched over the leading axes."""
    b, zdim = buf_w.shape[-2:]
    valid = _valid(b, count)
    n = torch.clamp(valid.sum(), min=1.0)
    vc = valid[:, None]
    mu = torch.sum(buf_w * vc, dim=-2) / n
    var = torch.sum(torch.square(buf_w - mu[..., None, :]) * vc, dim=-2) / n
    sig = torch.sqrt(torch.clamp(var, min=1e-12))
    y_mu = torch.sum(buf_ll * valid, dim=-1) / n
    y_var = torch.sum(torch.square(buf_ll - y_mu[..., None]) * valid,
                      dim=-1) / n
    y_sig = torch.sqrt(torch.clamp(y_var, min=1e-12))
    zs = (buf_w - mu[..., None, :]) / sig[..., None, :]
    ys = (buf_ll - y_mu[..., None]) / y_sig[..., None]

    a, bb, v, c, *_ = _mlp_unpack(theta0, zdim, hidden)
    params = [a.clone(), bb.clone(), v.clone(), c.clone()]
    m = [torch.zeros_like(p) for p in params]
    s = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8

    def forward(p):
        h = _mlp_hidden(p[0], p[1], zs)
        return h, _mm(h, p[2][..., None])[..., 0] + p[3][..., None]

    for t in range(steps):
        h, pred = forward(params)
        r = 2.0 * (pred - ys) * valid / n  # d loss / d pred
        dpre = (r[..., None] * params[2][..., None, :]) * (1.0 - h * h)
        grads = [_mm(dpre.transpose(-1, -2), zs), torch.sum(dpre, dim=-2),
                 _mm(h.transpose(-1, -2), r[..., None])[..., 0],
                 torch.sum(r, dim=-1)]
        # the bias correction in float32, as ptnn forms it
        tf = torch.tensor(float(t) + 1.0)
        step = float(torch.tensor(lr) * (torch.sqrt(1.0 - torch.tensor(b2)
                                                     ** tf)
                                          / (1.0 - torch.tensor(b1) ** tf)))
        for k, g in enumerate(grads):
            m[k] = b1 * m[k] + (1 - b1) * g
            s[k] = b2 * s[k] + (1 - b2) * g * g
            params[k] = params[k] - step * m[k] / (torch.sqrt(s[k]) + eps)
    _h, pred = forward(params)
    resid = (pred - ys) * valid
    r2 = 1.0 - torch.sum(torch.square(resid), dim=-1) / torch.clamp(
        torch.sum(torch.square(ys * valid), dim=-1), min=1e-9)
    a1, b1_, v1, c1 = params
    lead = a1.shape[:-2]
    theta = torch.cat([a1.reshape(lead + (-1,)), b1_, v1, c1[..., None], mu,
                       sig, y_mu[..., None], y_sig[..., None]], dim=-1)
    return theta, r2


def mlp_min_rows(zdim: int, hidden: int) -> int:
    """Rows before an MLP fit may activate: a few a hidden unit plus the
    input dimension (a net generalises below its parameter count)."""
    return 4 * hidden + 2 * zdim


def mlp_fit(state: SurrogateState, hidden: int, steps: int, lr: float,
            min_r2: float) -> SurrogateState:
    """Refit the MLP family on the ring(s); per-chain trains every rung's
    net in one batched Adam loop. The quadratic family's gate: enough rows,
    and EVERY rung's in-buffer r2 above ``min_r2``."""
    min_rows = mlp_min_rows(state.buf_w.shape[-1], hidden)
    theta, r2 = _mlp_fit_rows(state.buf_w, state.buf_ll, state.count,
                              state.theta, hidden, steps, lr)
    ok = state.count >= min_rows
    good = ok & (torch.min(r2) >= min_r2)
    return state.replace(theta=torch.where(ok, theta, state.theta),
                         fitted=good)


class Family(NamedTuple):
    """The resolved family: predict / grad_predict take (state, proj, z),
    fit takes (state, proj); the MLP family ignores ``proj``."""

    predict: Callable
    grad_predict: Callable
    fit: Callable


def family_for(cfg) -> Family:
    """``PTConfig.surrogate_family`` resolved to its (predict, grad, fit)."""
    if cfg.surrogate_family == "mlp":
        hidden = cfg.surrogate_hidden
        return Family(
            predict=lambda st, proj, z: mlp_predict(st.theta, z, hidden),
            grad_predict=lambda st, proj, z: mlp_grad(st.theta, z, hidden),
            fit=lambda st, proj: mlp_fit(st, hidden, cfg.surrogate_fit_steps,
                                         cfg.surrogate_fit_lr,
                                         cfg.surrogate_min_r2),
        )
    return Family(
        predict=predict,
        grad_predict=grad_predict,
        fit=lambda st, proj: fit(st, proj, cfg.surrogate_ridge,
                                 cfg.surrogate_min_r2),
    )


def _r2_rows(buf_w: torch.Tensor, buf_ll: torch.Tensor, count: torch.Tensor,
             theta: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    b = buf_w.shape[-2]
    valid = _valid(b, count)
    pred = _mm(features(buf_w, proj), theta[..., None])[..., 0]
    resid = (pred - buf_ll) * valid
    n = torch.clamp(count.to(torch.float32), min=1.0)
    mean = torch.sum(buf_ll * valid, dim=-1) / n
    tot = torch.sum(torch.square((buf_ll - mean[..., None]) * valid), dim=-1)
    return 1.0 - torch.sum(torch.square(resid), dim=-1) / torch.clamp(
        tot, min=1e-9)


def r_squared(state: SurrogateState, proj: torch.Tensor) -> torch.Tensor:
    """In-buffer goodness of fit: a scalar (global), (C,) a rung
    (per-chain)."""
    return _r2_rows(state.buf_w, state.buf_ll, state.count, state.theta,
                    proj)
