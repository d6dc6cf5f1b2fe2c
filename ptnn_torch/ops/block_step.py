"""A fused block of random-walk MH steps for every chain.

Counterpart of the RW part of ``ptnn/ops/pallas_step.py``
(``_rw_block_kernel``, ``fused_rw_block_impl``, ``prep_data``), both
branches. One call runs K steps of the reference random-walk sampler for all
chains with pregenerated noise and uniforms, so it is a deterministic
function of its inputs:

* regression: proposal ``w' = w + step * nw[k]`` (``step = exp(log_step_w)``
  when adapting, else ``step_w``) and ``eta' = eta + step_eta * ne[k]``;
  Gaussian likelihood ``ll' = -n/2 (log 2 pi + eta') - sse / (2 tau')`` on
  the train rows, test SSE for the rmse trace, and the regression prior;
* classification (``scal["task_cls"]``): a w-only proposal, eta carried
  untouched; the multinomial likelihood ``sum_n log softmax(out_n)[y_n]``
  over the sigmoid outputs, the prior ``-w_size/2 log sigma^2 - |w'|^2 /
  (2 sigma^2)``; rmse over the predicted class index (first argmax) and
  accuracy in percent, on train and test;
* ``log_mh = (ll' - ll) / T + (prior' - prior)``, accept iff
  ``u < exp(min(log_mh, 0))`` and ``k < length``;
* trace rows: the proposal ll, TEMPERED (``ll' / T``) for regression and
  UNTEMPERED for classification; rmse (and acc) carries written on accept;
  ``accept_count`` BEFORE the step's decision; optional w rows that follow
  ``w_last``; Robbins-Monro ``log_step_w += rate (a - target)`` while
  ``start + k < burn_end``, clipped to [log 1e-5, log 10];
* steps ``k >= length`` decide nothing and write the carries into their
  trace rows, as ``ptnn`` does; the samplers never read those rows.

Layout: chains-major. State (C, W) and (C,), noise (K, C, W) and (K, C),
uniforms and trace rows (K, C), w trace (K, C, W). No padding.

``fused_rw_block`` runs a CUDA kernel on CUDA tensors (``csrc/rw_block.cu``
for regression, ``csrc/rw_cls_block.cu`` for classification) and the plain
version, ``rw_block_reference``, on CPU tensors only. Each file has two
kernels: a fixed-shape kernel, at the warps a chain its launch plan gives,
for the bundled (I, H, 1) networks (``variant``, ``rw_launch_plan``) or the
classification networks of ``cls_fixed_topologies`` (``cls_variant``,
``rw_cls_launch_plan``), and a generic one for any other network whose
block fits shared memory; ``variant_launches`` and
``cls_variant_launches`` say which ran, ``rw_cls_warps`` at which warps.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ptnn_torch.models import fnn
from ptnn_torch.ops import likelihood

launches = 0  # launches of csrc/rw_block.cu (the plain version counts none)
variant_launches = {"fixed": 0, "generic": 0}  # which rw_block kernel ran
cls_launches = 0  # launches of csrc/rw_cls_block.cu
cls_variant_launches = {"fixed": 0, "generic": 0}  # which rw_cls_block kernel
rw_cls_warps: Dict[int, int] = {}  # fixed-kernel launches by warps a chain

_STATE_F32 = ("eta", "ll", "prior", "rmse_train", "rmse_test", "log_step_w")
_CLS_F32 = ("ll", "prior", "rmse_train", "rmse_test", "acc_train", "acc_test",
            "log_step_w")
_LOG_STEP_LO = math.log(1e-5)
_LOG_STEP_HI = math.log(10.0)
# threads a block of the generic kernels: THREADS in csrc/rw_block.cu and
# RW_THREADS in csrc/rw_cls_block.cu
_THREADS = 128
RW_WARPS = (8, 4)  # warps a chain the regression fixed-shape kernel is built for
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
# bundled classification networks at which the comparison of the RW kernel
# with its plain version cannot hold acc and rmse: on the set's rows their
# argmaxes are fragile (near-ties among many sigmoid outputs) in about or
# more than the 1 % of trace entries that comparison may leave unchecked.
# winequality-red's 10 outputs on 1599 rows (about 1 %), abalone's 29 on
# 4177 (about 5 % in the plain version alone). Their fused configs run
# per-step (fused.topology_reason).
RW_CLS_UNHELD = ((11, 50, 10), (8, 30, 29))


def prep_data(x_tr, y_tr, x_te, y_te, n_classes: int = 0) -> dict:
    """Device-ready data: the four float32 tensors plus ``rows``, the train
    then test rows packed as ``[x..., y]`` (N_tr + N_te, I + 1) for the
    kernels' shared-memory copy. Classification (``n_classes > 0``) keeps
    the class index as the float y, which the kernels read as an integer,
    and adds the int64 labels ``yi_tr`` / ``yi_te`` for the plain
    versions."""
    f = lambda a: torch.as_tensor(a, dtype=torch.float32).contiguous()
    x_tr, y_tr, x_te, y_te = f(x_tr), f(y_tr), f(x_te), f(y_te)
    rows = torch.cat([torch.cat([x_tr, y_tr[:, None]], 1),
                      torch.cat([x_te, y_te[:, None]], 1)]).contiguous()
    out = dict(x_tr=x_tr, y_tr=y_tr, x_te=x_te, y_te=y_te, rows=rows,
               n_tr=x_tr.shape[0], n_te=x_te.shape[0], n_classes=n_classes)
    if n_classes > 0:
        out.update(yi_tr=y_tr.to(torch.int64), yi_te=y_te.to(torch.int64))
    return out


def _prior_const(topo, sigma_sq: float) -> float:
    return -0.5 * likelihood.prior_dim_regression(topo) * math.log(sigma_sq)


def cls_prior_const(topo, sigma_sq: float) -> float:
    return -0.5 * fnn.w_size(topo) * math.log(sigma_sq)


def cls_eval(w: torch.Tensor, x: torch.Tensor, yi: torch.Tensor, topo):
    """The classification forward of every chain, as the kernels compute
    it: w (C, W), x (N, I), int64 labels yi (N,) -> ``(ll, rmse, acc)``,
    each (C,): the multinomial ll, the rmse of the first-argmax class index
    and the accuracy ``100 * matches / N``."""
    out = fnn.batched_forward(w, x, topo)  # (C, N, O)
    ll = torch.gather(fnn.log_class_probs(out), -1,
                      yi.expand(out.shape[:-1])[..., None])[..., 0].sum(-1)
    rmse, acc = cls_metrics(out, yi)
    return ll, rmse, acc


ARGMAX_DZ = 1e-5  # logit move the argmax must survive (rounding: ~1e-6)


def argmax_fragile(w: torch.Tensor, x: torch.Tensor, topo,
                   dz: float = ARGMAX_DZ) -> torch.Tensor:
    """(C,) bool: whether moving the two largest output logits of some row
    of x by ``dz`` in opposite directions changes that row's first argmax of
    the float32 sigmoid outputs. Near saturation many logits round to the
    same output and the tie goes to the first class, so the logit gap alone
    does not say; this perturbs and compares. Two float32 forwards that sum
    in different orders differ by ~1e-6 in a logit, so rmse and accuracy
    evaluated where no row is fragile are the same in both."""
    p = fnn.unpack(w, topo)
    hid = torch.sigmoid(torch.matmul(x, p.w1) - p.b1[:, None, :])
    z = torch.matmul(hid, p.w2) - p.b2[:, None, :]  # (C, N, O) logits
    top2 = torch.topk(torch.sigmoid(z), 2, dim=-1)
    za, zb = torch.gather(z, -1, top2.indices).unbind(-1)
    a_first = top2.indices[..., 0] < top2.indices[..., 1]

    def a_wins(ya, yb):
        sa, sb = torch.sigmoid(ya), torch.sigmoid(yb)
        return (sa > sb) | ((sa == sb) & a_first)

    base = a_wins(za, zb)
    moved = (a_wins(za - dz, zb + dz) != base) | (a_wins(za + dz, zb - dz)
                                                   != base)
    return moved.any(dim=-1)


def rw_cls_witness(state, noise_w, u_mh, start, length, data, adapttemp,
                   topo, scal, kernel, plain, margin: float):
    """The float64 witness of a comparison of the classification RW kernel
    with its plain version on the same inputs: ``kernel`` and ``plain`` are
    their ``(new_state, traces)``. Runs the plain version in float64 on
    those inputs, with the w trace, and returns ``(apart, off, run)``:
    ``run`` that run's ``(new_state, traces)``, and two (C,) bool masks:
    ``apart``,
    the chains whose float32 and float64 plain runs decide apart, so that
    float32 rounding takes a decision (an adapting chain moves its step with
    every acceptance probability, so rounding, amplified, can flip a
    decision whose |u - a| is well above the margin) and any other float32
    summation order may take either side; ``off``, those of them in which
    the kernel's decisions differ from the float64 run's although that run's
    |u - a| stays above ``margin`` throughout."""
    up = lambda d: {n: v.double() if torch.is_tensor(v)
                    and v.is_floating_point() else v for n, v in d.items()}
    wit = rw_block_reference(up(state), noise_w.double(), None,
                             u_mh.double(), start, length, up(data),
                             adapttemp.double(), topo, scal, record_w=True,
                             diagnostics=True)

    def apart_from(run):
        return ((run[0]["n_accept"] != wit[0]["n_accept"])
                | (run[1]["accept_count"] != wit[1]["accept_count"]).any(0))

    apart = apart_from(plain)
    return (apart, apart & apart_from(kernel) & (wit[1]["margin"] > margin),
            wit)


def rw_cls_own_weights(state, kernel, plain, data, topo):
    """The classification RW kernel's acc and rmse against the plain
    evaluation (``cls_eval``) at the kernel's own carried weights, for the
    entries carried from a proposal of the block: ``kernel`` and ``plain``
    are the two versions' ``(new_state, traces)`` with the w trace. Returns
    ``(bad, fragile, drift)``: the number of entries that differ where no
    row's argmax at the kernel's weights is fragile (``argmax_fragile``);
    and two (K + 1, C) bool masks, the last row the final state's: the
    entries whose argmax is fragile at the kernel's weights, and those whose
    plain evaluation differs between the kernel's and the plain version's
    weights (under step adaptation a chain's weights drift from the plain
    version's within the float tolerance, which can move a logit by more
    than ``ARGMAX_DZ``)."""
    (new_k, tr_k), (new_r, tr_r) = kernel, plain
    sets = ((data["x_tr"], data["yi_tr"], "train"),
            (data["x_te"], data["yi_te"], "test"))
    count = torch.cat([tr_k["accept_count"], new_k["n_accept"][None]])
    moved = count[1:] > state["n_accept"][None]  # carried from this block
    moved = torch.cat([moved, moved[-1:]])  # the final state: the last row's
    w_k = torch.cat([tr_k["w"], new_k["w_last"][None]])
    w_r = torch.cat([tr_r["w"], new_r["w_last"][None]])
    got = {n: torch.cat([tr_k[n], new_k[n][None]])
           for s in ("train", "test") for n in (f"acc_{s}", f"rmse_{s}")}
    fragile, drift, bad = torch.zeros_like(moved), torch.zeros_like(moved), 0
    for t in range(w_k.shape[0]):
        for x, _yi, _s in sets:
            fragile[t] |= argmax_fragile(w_k[t], x, topo)
        for x, yi, s in sets:
            _ll, rmse, acc = cls_eval(w_k[t], x, yi, topo)
            _ll, rmse_r, acc_r = cls_eval(w_r[t], x, yi, topo)
            drift[t] |= (acc != acc_r) | (rmse != rmse_r)
            for n, v in ((f"acc_{s}", acc), (f"rmse_{s}", rmse)):
                bad += int(((got[n][t] != v) & moved[t] & ~fragile[t]).sum())
    return bad, fragile & moved, drift & moved


def inv_rows(n: int, num: float = 1.0) -> float:
    """``num * (1 / n)`` with both steps rounded to float32. The metrics
    multiply by it, as ptnn's kernels do once XLA has folded their
    ``100 * x / n`` and ``x / n`` into a product with a constant."""
    return float(np.float32(num) * (np.float32(1.0) / np.float32(n)))


def cls_metrics(out: torch.Tensor, yi: torch.Tensor):
    """(rmse, acc) of the first-argmax prediction of outputs (C, N, O):
    ``sqrt(sum err^2 / N)`` and ``100 matches / N``. The sums are of small
    integers, so they are exact and the metrics bit-exact functions of the
    argmax."""
    n = out.shape[-2]
    pred = fnn.predict_class(out)
    err = (pred - yi).to(out.dtype)
    rmse = torch.sqrt(torch.sum(err * err, dim=-1) * inv_rows(n))
    acc = torch.sum((pred == yi).to(out.dtype), dim=-1) * inv_rows(n, 100.0)
    return rmse, acc


def rw_block_reference(
    state: Dict[str, torch.Tensor],
    noise_w: torch.Tensor,
    noise_eta: Optional[torch.Tensor],
    u_mh: torch.Tensor,
    start: int,
    length: int,
    data: dict,
    adapttemp: torch.Tensor,
    topo,
    scal: dict,
    record_w: bool = True,
    diagnostics: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The plain PyTorch version of ``fused_rw_block``, on any device, in
    the dtype of its inputs.

    ``diagnostics=True`` adds to the traces what a comparison with another
    implementation needs: ``margin`` (C,), the smallest ``|u - a|`` over
    the live steps (how close a chain came to a decision that rounding
    could flip); ``ll_scale`` (K, C) and ``ll_scale_final`` (C,), the size
    on which float rounding of each recorded ll and of the carried one lives
    (regression: ``(|n/2 (log 2 pi + eta')| + |sse'/(2 tau')|) / T``, the
    two terms that cancel; classification: ``|ll|``, a sum of negative
    terms). Classification adds ``argmax_fragile`` (K, C) and
    ``argmax_fragile_final`` (C,) bool: whether the rmse and acc carried at
    that step (at the end) come from a proposal with a row whose argmax
    rounding could flip (``argmax_fragile``). Elsewhere they are exact
    functions of the weights, and an argmax flip changes no decision.
    """
    cls = bool(scal.get("task_cls", False))
    k_max, c, _w = noise_w.shape
    n_tr, n_te = data["n_tr"], data["n_te"]
    sigma_sq, adapt = scal["sigma_sq"], bool(scal["adapt"])
    prior_const = (cls_prior_const(topo, sigma_sq) if cls
                   else _prior_const(topo, sigma_sq))
    w, wl = state["w"], state["w_last"]
    eta, ll, pr = state["eta"], state["ll"], state["prior"]
    rtr, rte, na = state["rmse_train"], state["rmse_test"], state["n_accept"]
    atr, ate = state.get("acc_train"), state.get("acc_test")
    lsw = state["log_step_w"]
    at = adapttemp
    fl = dict(dtype=w.dtype, device=w.device)
    kc = lambda: torch.empty((k_max, c), **fl)
    t_ll, t_rtr, t_rte, t_atr, t_ate = kc(), kc(), kc(), kc(), kc()
    t_na = torch.empty((k_max, c), dtype=torch.int32, device=w.device)
    t_w = torch.empty((k_max,) + tuple(w.shape), **fl) if record_w else None
    margin = torch.full((c,), math.inf, **fl)
    fragile = torch.zeros((c,), dtype=torch.bool, device=w.device)
    t_fragile = torch.zeros((k_max, c), dtype=torch.bool, device=w.device)
    scale = torch.abs(ll)  # the carried ll's term scale (an input: exact)
    t_scale = torch.empty((k_max, c), **fl)
    rec = (lambda v: v) if cls else (lambda v: v / at)  # the recorded ll

    def sse(wp, x, y):
        fx = fnn.batched_forward(wp, x, topo)[:, :, 0]
        return torch.sum(torch.square(y - fx), dim=-1)

    for k in range(k_max):
        live = k < length
        if live:
            step = torch.exp(lsw)[:, None] if adapt else scal["step_w"]
            w_prop = w + step * noise_w[k]
            ssq = torch.sum(w_prop * w_prop, dim=-1)
            if cls:
                eta_prop = eta
                pr_prop = prior_const - ssq / (2.0 * sigma_sq)
                ll_prop, rtr_p, atr_p = cls_eval(
                    w_prop, data["x_tr"], data["yi_tr"], topo)
                _ll, rte_p, ate_p = cls_eval(
                    w_prop, data["x_te"], data["yi_te"], topo)
                scale_prop = torch.abs(ll_prop)
            else:
                eta_prop = eta + scal["step_eta"] * noise_eta[k]
                tau = torch.exp(eta_prop)
                pr_prop = (
                    prior_const
                    - ssq / (2.0 * sigma_sq)
                    - (1.0 + scal["nu_1"]) * eta_prop
                    - scal["nu_2"] / tau
                )
                sse_tr = sse(w_prop, data["x_tr"], data["y_tr"])
                sse_te = sse(w_prop, data["x_te"], data["y_te"])
                ll_norm = -0.5 * n_tr * (likelihood._LOG_2PI + eta_prop)
                ll_prop = ll_norm - 0.5 * sse_tr / tau
                rtr_p = torch.sqrt(sse_tr / n_tr)
                rte_p = torch.sqrt(sse_te / n_te)
                scale_prop = torch.abs(ll_norm) + torch.abs(0.5 * sse_tr / tau)
            log_mh = (ll_prop - ll) / at + (pr_prop - pr)
            a = torch.exp(torch.clamp(log_mh, max=0.0))
            accept = u_mh[k] < a
            if diagnostics:
                margin = torch.minimum(margin, torch.abs(u_mh[k] - a))
                t_scale[k] = rec(scale_prop)
                scale = torch.where(accept, scale_prop, scale)
                if cls:
                    fragile = torch.where(accept, argmax_fragile(
                        w_prop, data["x_tr"], topo) | argmax_fragile(
                        w_prop, data["x_te"], topo), fragile)
            t_ll[k] = rec(ll_prop)
            rtr = torch.where(accept, rtr_p, rtr)
            rte = torch.where(accept, rte_p, rte)
            if cls:
                atr = torch.where(accept, atr_p, atr)
                ate = torch.where(accept, ate_p, ate)
        else:
            t_ll[k] = rec(ll)
            t_scale[k] = rec(scale)
        t_rtr[k] = rtr
        t_rte[k] = rte
        if cls:
            t_atr[k], t_ate[k] = atr, ate
            t_fragile[k] = fragile
        t_na[k] = na
        if live:
            w = torch.where(accept[:, None], w_prop, w)
            wl = torch.where(accept[:, None], w_prop, wl)
            eta = torch.where(accept, eta_prop, eta)
            ll = torch.where(accept, ll_prop, ll)
            pr = torch.where(accept, pr_prop, pr)
            na = na + accept.to(torch.int32)
        if record_w:
            t_w[k] = wl
        if adapt:
            if live and start + k < scal["burn_end"]:
                lsw = lsw + scal["adapt_rate"] * (a - scal["adapt_target"])
            lsw = torch.clamp(lsw, _LOG_STEP_LO, _LOG_STEP_HI)
    new_state = dict(w=w, w_last=wl, eta=eta, ll=ll, prior=pr, rmse_train=rtr,
                     rmse_test=rte, n_accept=na, log_step_w=lsw)
    traces = dict(ll=t_ll, rmse_train=t_rtr, rmse_test=t_rte, accept_count=t_na)
    if cls:
        new_state.update(acc_train=atr, acc_test=ate)
        traces.update(acc_train=t_atr, acc_test=t_ate)
    if record_w:
        traces["w"] = t_w
    if diagnostics:
        traces.update(margin=margin, ll_scale=t_scale, ll_scale_final=scale)
        if cls:
            traces.update(argmax_fragile=t_fragile,
                          argmax_fragile_final=fragile)
    return new_state, traces


class _RwParams(ctypes.Structure):
    """Mirror of ``struct RwParams`` in csrc/rw_block.cu (same field order)."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "rows", "at", "w", "w_last", "eta", "ll", "prior", "rmse_tr",
            "rmse_te", "n_accept", "log_step", "noise_w", "noise_eta", "u",
            "o_w", "o_w_last", "o_eta", "o_ll", "o_prior", "o_rmse_tr",
            "o_rmse_te", "o_n_accept", "o_log_step", "t_ll", "t_rmse_tr",
            "t_rmse_te", "t_accept", "t_w",
        )
    ] + [
        (name, ctypes.c_int)
        for name in (
            "n_tr", "n_te", "n_in", "n_hid", "chains", "w_size", "k_max",
            "start", "length", "adapt", "burn_end",
        )
    ] + [
        (name, ctypes.c_float)
        for name in (
            "step_w", "step_eta", "prior_const", "two_sigma_sq",
            "one_plus_nu1", "nu2", "ll_const", "log_2pi", "adapt_rate",
            "adapt_target", "log_step_lo", "log_step_hi", "n_tr_f", "n_te_f",
        )
    ]


@functools.lru_cache(maxsize=None)
def fixed_topologies() -> Tuple[Tuple[int, int, int], ...]:
    """The (I, H, 1) networks csrc/rw_block.cu's fixed-shape kernel is built
    for: the lines of csrc/fnn_layouts.cuh with one output."""
    from ptnn_torch.ops import _build

    return tuple((i, h, 1) for i, h, o, *_ in
                 _build.cu_rows("fnn_layouts.cuh", "FNN_LAYOUTS") if o == 1)


def variant(topo) -> str:
    """The regression kernel that runs ``topo``: "fixed" (compile-time
    shapes) for a bundled network, else "generic"."""
    return "fixed" if tuple(topo) in fixed_topologies() else "generic"


class RwPlan(NamedTuple):
    """One launch of a fixed-shape RW kernel: ``warps`` a chain,
    ``blocks`` (one a chain), ``why``."""
    warps: int
    blocks: int
    why: str


def rw_launch_plan(chains: int, sms: int) -> RwPlan:
    """The fixed-shape kernel's warps a chain for ``chains`` chains on a
    card of ``sms`` SMs (pure Python): 8 while the grid fits one wave of one
    block an SM, so that the card's idle SMs shorten each step; else 4, so
    that several blocks share an SM."""
    if chains <= sms:
        return RwPlan(8, chains, f"8 warps: {chains} blocks fit one wave of "
                                 f"{sms} SMs")
    return RwPlan(4, chains, f"4 warps: {chains} blocks exceed one wave of "
                             f"{sms} SMs")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def sm_count(device) -> int:
    """The SM count of the card ``device``, which the launch plans take."""
    dev = torch.device(device)
    return _sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device())


def card_rw_plan(device, chains: int) -> RwPlan:
    """``rw_launch_plan`` with the SM count of the card ``device``."""
    return rw_launch_plan(chains, sm_count(device))


def smem_bytes(n_rows: int, topo, warps: int = _THREADS // 32) -> int:
    """Dynamic shared memory of one block of the regression kernel that
    runs ``topo``. Generic: the data rows, three weight vectors (current,
    last accepted, proposal) and the reduction slots. Fixed-shape, at
    ``warps`` warps: the data rows (padded to 16 bytes), two weight slots
    and two noise slots of w_size + 2 floats padded to 16 bytes, and two
    parities of a 4-float partial slot per warp."""
    n_in, w = topo[0], fnn.w_size(topo)
    if variant(topo) == "generic":
        return 4 * (n_rows * (n_in + 1) + 3 * w + 3 * (_THREADS // 32))
    slot = -(-(w + 2) // 4) * 4
    return 4 * (-(-n_rows * (n_in + 1) // 4) * 4 + 4 * slot + 2 * warps * 4)


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_cuda(state, noise_w, noise_eta, u_mh, start, length, data,
                 adapttemp, topo, scal, record_w):
    global launches
    from ptnn_torch.ops import _build

    lib = _build.build("rw_block").lib
    dev = noise_w.device
    k_max, c, w_dim = noise_w.shape
    n_in, n_hid, n_out = topo
    n_tr, n_te = int(data["n_tr"]), int(data["n_te"])
    if n_out != 1 or w_dim != fnn.w_size(topo):
        raise ValueError(f"noise width {w_dim} does not fit topology {topo}")
    if not 0 <= int(length) <= k_max:
        raise ValueError(f"length {length} outside [0, {k_max}]")
    kind = variant(topo)
    warps = (card_rw_plan(dev, c).warps if kind == "fixed"
             else _THREADS // 32)
    smem = smem_bytes(n_tr + n_te, topo, warps)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"{n_tr}+{n_te} data rows need {smem} bytes of shared memory per "
            f"block; a Hopper block has {_SMEM_LIMIT}"
        )
    f32, i32 = torch.float32, torch.int32
    _check(data["rows"], "rows", (n_tr + n_te, n_in + 1), f32, dev)
    _check(adapttemp, "adapttemp", (c,), f32, dev)
    _check(noise_eta, "noise_eta", (k_max, c), f32, dev)
    _check(u_mh, "u_mh", (k_max, c), f32, dev)
    for name in ("w", "w_last"):
        _check(state[name], name, (c, w_dim), f32, dev)
    for name in _STATE_F32:
        _check(state[name], name, (c,), f32, dev)
    _check(state["n_accept"], "n_accept", (c,), i32, dev)

    new = {k: torch.empty_like(state[k]) for k in ("w", "w_last", "n_accept")
           + _STATE_F32}
    tr = dict(
        ll=torch.empty((k_max, c), dtype=f32, device=dev),
        rmse_train=torch.empty((k_max, c), dtype=f32, device=dev),
        rmse_test=torch.empty((k_max, c), dtype=f32, device=dev),
        accept_count=torch.empty((k_max, c), dtype=i32, device=dev),
    )
    if record_w:
        tr["w"] = torch.empty((k_max, c, w_dim), dtype=f32, device=dev)
    p = lambda t: t.data_ptr()
    sigma_sq = float(scal["sigma_sq"])
    params = _RwParams(
        rows=p(data["rows"]), at=p(adapttemp), w=p(state["w"]),
        w_last=p(state["w_last"]), eta=p(state["eta"]), ll=p(state["ll"]),
        prior=p(state["prior"]), rmse_tr=p(state["rmse_train"]),
        rmse_te=p(state["rmse_test"]), n_accept=p(state["n_accept"]),
        log_step=p(state["log_step_w"]), noise_w=p(noise_w),
        noise_eta=p(noise_eta), u=p(u_mh),
        o_w=p(new["w"]), o_w_last=p(new["w_last"]), o_eta=p(new["eta"]),
        o_ll=p(new["ll"]), o_prior=p(new["prior"]),
        o_rmse_tr=p(new["rmse_train"]), o_rmse_te=p(new["rmse_test"]),
        o_n_accept=p(new["n_accept"]), o_log_step=p(new["log_step_w"]),
        t_ll=p(tr["ll"]), t_rmse_tr=p(tr["rmse_train"]),
        t_rmse_te=p(tr["rmse_test"]), t_accept=p(tr["accept_count"]),
        t_w=p(tr["w"]) if record_w else None,
        n_tr=n_tr, n_te=n_te, n_in=n_in, n_hid=n_hid, chains=c, w_size=w_dim,
        k_max=k_max, start=int(start), length=int(length),
        adapt=int(bool(scal["adapt"])), burn_end=int(scal["burn_end"]),
        step_w=float(scal["step_w"]), step_eta=float(scal["step_eta"]),
        prior_const=_prior_const(topo, sigma_sq),
        two_sigma_sq=2.0 * sigma_sq, one_plus_nu1=1.0 + float(scal["nu_1"]),
        nu2=float(scal["nu_2"]), ll_const=-0.5 * n_tr,
        log_2pi=likelihood._LOG_2PI, adapt_rate=float(scal["adapt_rate"]),
        adapt_target=float(scal["adapt_target"]),
        log_step_lo=_LOG_STEP_LO, log_step_hi=_LOG_STEP_HI,
        n_tr_f=float(n_tr), n_te_f=float(n_te),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ptnn_rw_block(ctypes.byref(params), smem,
                                int(kind == "fixed"), warps,
                                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"rw_block launch failed: {_build.error_string(lib, err)}"
        )
    launches += 1
    variant_launches[kind] += 1
    return new, tr


class _ClsRwParams(ctypes.Structure):
    """Mirror of ``struct ClsRwParams`` in csrc/rw_cls_block.cu (same field
    order)."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "rows", "at", "w", "w_last", "ll", "prior", "rmse_tr", "rmse_te",
            "acc_tr", "acc_te", "n_accept", "log_step", "noise_w", "u",
            "o_w", "o_w_last", "o_ll", "o_prior", "o_rmse_tr", "o_rmse_te",
            "o_acc_tr", "o_acc_te", "o_n_accept", "o_log_step", "t_ll",
            "t_rmse_tr", "t_rmse_te", "t_acc_tr", "t_acc_te", "t_accept",
            "t_w",
        )
    ] + [
        (name, ctypes.c_int)
        for name in ("n_tr", "n_te", "n_in", "n_hid", "n_out", "w_size",
                     "chains", "k_max", "start", "length", "adapt",
                     "burn_end")
    ] + [
        (name, ctypes.c_float)
        for name in ("step_w", "adapt_rate", "adapt_target", "log_step_lo",
                     "log_step_hi", "inv_n_tr", "inv_n_te", "acc_n_tr",
                     "acc_n_te")
    ] + [(name, ctypes.c_double)
         for name in ("prior_const", "inv_two_sigma_sq")]


@functools.lru_cache(maxsize=None)
def cls_fixed_topologies() -> Tuple[Tuple[int, int, int], ...]:
    """The (I, H, O) networks csrc/rw_cls_block.cu's fixed-shape kernel is
    built for (its RW_CLS_FIXED table): the classification sets ptnn fuses."""
    from ptnn_torch.ops import _build

    return _build.cu_rows("rw_cls_block.cu", "RW_CLS_FIXED")


@functools.lru_cache(maxsize=None)
def cls_warps() -> Tuple[int, ...]:
    """The warps a chain the classification fixed-shape kernel is built for
    (RW_CLS_WARPS), in increasing order."""
    from ptnn_torch.ops import _build

    return tuple(sorted(w for (w,) in _build.cu_rows("rw_cls_block.cu",
                                                     "RW_CLS_WARPS")))


def cls_variant(topo) -> str:
    """The classification kernel that runs ``topo``: "fixed" (compile-time
    shapes) for a network of ``cls_fixed_topologies``, else "generic"."""
    return "fixed" if tuple(topo) in cls_fixed_topologies() else "generic"


def rw_cls_launch_plan(chains: int, n_rows: int, sms: int) -> RwPlan:
    """The classification fixed-shape kernel's warps a chain for ``chains``
    chains of ``n_rows`` data rows on a card of ``sms`` SMs (pure Python):
    while the grid fits one wave of one block an SM, the fewest warps that
    give every row a thread of its own (at most the largest built), so that
    no thread runs a second row; else the fewest built, so that several
    blocks share an SM."""
    built = cls_warps()
    if chains <= sms:
        need = -(-n_rows // 32)
        warps = next((w for w in built if w >= need), built[-1])
        return RwPlan(warps, chains, f"{warps} warps: {chains} blocks fit one "
                                     f"wave of {sms} SMs; {n_rows} rows")
    return RwPlan(built[0], chains, f"{built[0]} warps: {chains} blocks exceed "
                                    f"one wave of {sms} SMs")


def card_rw_cls_plan(device, chains: int, n_rows: int) -> RwPlan:
    """``rw_cls_launch_plan`` with the SM count of the card ``device``."""
    return rw_cls_launch_plan(chains, n_rows, sm_count(device))


def cls_smem_bytes(n_rows: int, topo, kind: str, warps: int = 0) -> int:
    """Dynamic shared memory of one block of the classification kernel
    ``kind`` for ``topo``. Both have an 8-float partial slot per warp (two
    float64 sums and four float32 ones). Generic: with the data rows, three
    weight vectors (current, last accepted, proposal) and a column of hidden
    and output activations per thread. Fixed-shape, at ``warps`` warps:
    with the data rows (padded to 16 bytes) and the proposal's slot in the
    padded layout (W1, B1 and W2's columns in rows of H rounded up to 4,
    then B2 in 4 floats)."""
    n_in, n_hid, n_out = topo
    if kind == "generic":
        return 4 * (n_rows * (n_in + 1) + 3 * fnn.w_size(topo)
                    + 8 * (_THREADS // 32) + (n_hid + n_out) * _THREADS)
    slot = (n_in + 1 + n_out) * (-(-n_hid // 4) * 4) + -(-n_out // 4) * 4
    return 4 * (-(-n_rows * (n_in + 1) // 4) * 4 + slot + warps * 8)


def _launch_cls_cuda(state, noise_w, u_mh, start, length, data, adapttemp,
                     topo, scal, record_w):
    global cls_launches
    from ptnn_torch.ops import _build

    dev = noise_w.device
    k_max, c, w_dim = noise_w.shape
    n_in, n_hid, n_out = topo
    n_tr, n_te = int(data["n_tr"]), int(data["n_te"])
    if w_dim != fnn.w_size(topo):
        raise ValueError(f"noise width {w_dim} does not fit topology {topo}")
    if not 0 <= int(length) <= k_max:
        raise ValueError(f"length {length} outside [0, {k_max}]")
    kind = cls_variant(topo)
    warps = (card_rw_cls_plan(dev, c, n_tr + n_te).warps if kind == "fixed"
             else _THREADS // 32)
    smem = cls_smem_bytes(n_tr + n_te, topo, kind, warps)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"{n_tr}+{n_te} data rows of topology {tuple(topo)} need {smem} "
            f"bytes of shared memory per block; a Hopper block has "
            f"{_SMEM_LIMIT}"
        )
    f32, i32 = torch.float32, torch.int32
    _check(data["rows"], "rows", (n_tr + n_te, n_in + 1), f32, dev)
    _check(adapttemp, "adapttemp", (c,), f32, dev)
    _check(u_mh, "u_mh", (k_max, c), f32, dev)
    for name in ("w", "w_last"):
        _check(state[name], name, (c, w_dim), f32, dev)
    for name in _CLS_F32:
        _check(state[name], name, (c,), f32, dev)
    _check(state["n_accept"], "n_accept", (c,), i32, dev)
    lib = _build.build("rw_cls_block").lib

    new = {k: torch.empty_like(state[k])
           for k in ("w", "w_last", "n_accept") + _CLS_F32}
    kc = lambda dt=f32: torch.empty((k_max, c), dtype=dt, device=dev)
    tr = dict(ll=kc(), rmse_train=kc(), rmse_test=kc(), acc_train=kc(),
              acc_test=kc(), accept_count=kc(i32))
    if record_w:
        tr["w"] = torch.empty((k_max, c, w_dim), dtype=f32, device=dev)
    p = lambda t: t.data_ptr()
    sigma_sq = float(scal["sigma_sq"])
    params = _ClsRwParams(
        rows=p(data["rows"]), at=p(adapttemp), w=p(state["w"]),
        w_last=p(state["w_last"]), ll=p(state["ll"]), prior=p(state["prior"]),
        rmse_tr=p(state["rmse_train"]), rmse_te=p(state["rmse_test"]),
        acc_tr=p(state["acc_train"]), acc_te=p(state["acc_test"]),
        n_accept=p(state["n_accept"]), log_step=p(state["log_step_w"]),
        noise_w=p(noise_w), u=p(u_mh),
        o_w=p(new["w"]), o_w_last=p(new["w_last"]), o_ll=p(new["ll"]),
        o_prior=p(new["prior"]), o_rmse_tr=p(new["rmse_train"]),
        o_rmse_te=p(new["rmse_test"]), o_acc_tr=p(new["acc_train"]),
        o_acc_te=p(new["acc_test"]), o_n_accept=p(new["n_accept"]),
        o_log_step=p(new["log_step_w"]),
        t_ll=p(tr["ll"]), t_rmse_tr=p(tr["rmse_train"]),
        t_rmse_te=p(tr["rmse_test"]), t_acc_tr=p(tr["acc_train"]),
        t_acc_te=p(tr["acc_test"]), t_accept=p(tr["accept_count"]),
        t_w=p(tr["w"]) if record_w else None,
        n_tr=n_tr, n_te=n_te, n_in=n_in, n_hid=n_hid, n_out=n_out,
        w_size=w_dim, chains=c, k_max=k_max, start=int(start),
        length=int(length), adapt=int(bool(scal["adapt"])),
        burn_end=int(scal["burn_end"]), step_w=float(scal["step_w"]),
        prior_const=cls_prior_const(topo, sigma_sq),
        inv_two_sigma_sq=1.0 / (2.0 * sigma_sq),
        adapt_rate=float(scal["adapt_rate"]),
        adapt_target=float(scal["adapt_target"]),
        log_step_lo=_LOG_STEP_LO, log_step_hi=_LOG_STEP_HI,
        inv_n_tr=inv_rows(n_tr), inv_n_te=inv_rows(n_te),
        acc_n_tr=inv_rows(n_tr, 100.0), acc_n_te=inv_rows(n_te, 100.0),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ptnn_rw_cls_block(ctypes.byref(params), smem,
                                    int(kind == "fixed"), warps,
                                    ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"rw_cls_block launch failed: {_build.error_string(lib, err)}"
        )
    cls_launches += 1
    cls_variant_launches[kind] += 1
    if kind == "fixed":
        rw_cls_warps[warps] = rw_cls_warps.get(warps, 0) + 1
    new["eta"] = state["eta"]  # passed through: classification has no eta
    return new, tr


def fused_rw_block(
    state: Dict[str, torch.Tensor],
    noise_w: torch.Tensor,
    noise_eta: Optional[torch.Tensor],
    u_mh: torch.Tensor,
    start: int,
    length: int,
    data: dict,
    adapttemp: torch.Tensor,
    topo,
    scal: dict,
    record_w: bool = True,
):
    """One K-step RW block for all chains -> ``(new_state, traces)``.

    ``state`` holds w, w_last (C, W), eta, ll, prior, rmse_train,
    rmse_test, log_step_w (C,) float32 and n_accept (C,) int32, and for
    classification acc_train, acc_test (C,); ``scal`` holds step_w,
    step_eta, sigma_sq, nu_1, nu_2, adapt, adapt_rate, adapt_target,
    burn_end and task_cls. Classification reads no ``noise_eta`` (None is
    fine) and passes eta through. Traces are (K, C) rows "ll",
    "rmse_train", "rmse_test", "accept_count" (and "acc_train", "acc_test"
    for classification), plus "w" (K, C, W) when ``record_w``. CUDA tensors
    launch the kernel; CPU tensors take the plain version.
    """
    cls = bool(scal.get("task_cls", False))
    tensors = [noise_w, u_mh, adapttemp, data["rows"]] + [
        v for v in state.values()
    ] + ([] if noise_eta is None else [noise_eta])
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return rw_block_reference(state, noise_w, noise_eta, u_mh, start,
                                  length, data, adapttemp, topo, scal,
                                  record_w)
    if kinds == {"cuda"}:
        if cls:
            return _launch_cls_cuda(state, noise_w, u_mh, start, length, data,
                                    adapttemp, topo, scal, record_w)
        return _launch_cuda(state, noise_w, noise_eta, u_mh, start, length,
                            data, adapttemp, topo, scal, record_w)
    raise ValueError(f"fused_rw_block needs all tensors on one device type, "
                     f"got {sorted(kinds)}")
