"""The chain-batched FNN evaluation: forward, log-likelihood and metrics.

Port of ``ptnn/ops/pallas_eval.py`` (``fnn_eval_pallas``), the evaluation
the per-step sampler runs on every proposal, on the train and on the test
rows, every step. ``fnn_eval(w, x, y, tau, topo, task) -> (ll, rmse, acc)``,
each (C,), untempered:

* regression: ``ll = -n/2 (log 2 pi + log tau) - SSE / (2 tau)`` of the
  first output, ``rmse = sqrt(SSE / n)``, acc 0;
* classification: the multinomial ``ll = sum_n log softmax(out_n)[y_n]``
  over the SIGMOID outputs, the first-argmax prediction (a later class wins
  only if strictly larger), ``rmse`` of the predicted class index and
  ``acc`` in percent.

``fnn_eval_pair`` evaluates the same weights on two row sets (train and
test) in one launch. The metrics multiply by ``block_step.inv_rows``, the
float32 constants XLA folds ptnn's means into, so the accuracy traces match
ptnn's bit for bit. CUDA tensors launch the hand-written kernel
``csrc/fnn_eval.cu`` (one thread-block cluster per chain and row set, laid
out by ``launch_plan`` for any width: fewer row groups, the weights read
from device memory, the inputs staged a tile at a time, the outputs in
chunks of 32, as the block's shared memory asks); CPU tensors run
``fnn_eval_reference``. A CUDA tensor never takes the plain version.

A grid of runs (``ptnn_torch.sweeps``) evaluates every cell in the same
launch: the chains are cell-major, x (G, N, I) and y (G, N) give each cell
its own rows, ``rows`` (G,) int32 its count of valid rows (the padding
trails; ptnn's ``mask_*``) and ``classes`` (G,) int32 its count of real
classes (the padded class columns trail; ptnn's ``class_mask``). With
``rows`` the metrics are ptnn's masked ones: a padded row adds nothing and
rmse and acc divide by the count (``100 * matches / n``, a true division,
as ptnn's traced count makes it); the padded class columns take -1e9
before the log-softmax and the argmax.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ptnn_torch.models import fnn
from ptnn_torch.models.fnn import Topology
from ptnn_torch.ops import block_step, likelihood
from ptnn_torch.ops.block_step import _SMEM_LIMIT, _check

launches = 0  # launches of csrc/fnn_eval.cu (the plain version counts none)

_MAX_OUT = 32  # MAX_OUT of csrc/fnn_eval.cu: outputs a chunk
_MAX_CLUSTER = 8  # MAX_CLUSTER: blocks of a (chain, set) cluster
_MAX_WARPS = 16  # MAX_WARPS: warps a block
# the bytes of a block's shared memory its dynamic share leaves to the
# kernel's static one (SetView, 80 bytes in ptxas' report), with room
_STATIC_SMEM = 1024
_TILE = 32  # TILE: rows of a row group a pass, one a lane

Eval = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Rows = Optional[torch.Tensor]


def _grid_reference(w, x, y, tau, topo, task, rows, classes) -> Eval:
    """The plain version on a grid: each cell's chains on its own rows,
    with ptnn's masked likelihood and metrics where ``rows`` is given."""
    from ptnn_torch.ops.drift import row_mask

    if x.dim() == 2:
        x, y = x[None], y[None]
    g, n = x.shape[0], x.shape[-2]
    cpc = w.shape[0] // g
    cls = task == "classification"
    parts = []
    for k in range(g):
        sl = slice(k * cpc, (k + 1) * cpc)
        mask = None if rows is None else row_mask(rows[k:k + 1], n)[0]
        out = fnn.batched_forward(w[sl], x[k], topo)
        if not cls:
            fx = out[:, :, 0]
            if mask is None:
                parts.append(fnn_eval_reference(w[sl], x[k], y[k], tau[sl],
                                                topo, task))
                continue
            ev = likelihood.regression_eval_from_fx(fx, y[k], tau[sl], mask)
            parts.append((ev.loglik, ev.rmse, torch.zeros_like(ev.loglik)))
            continue
        if classes is not None:
            real = torch.arange(out.shape[-1], device=out.device) < classes[k]
            out = torch.where(real, out, -1e9)
        logp = fnn.log_class_probs(out)
        if mask is None:
            yi = y[k].to(torch.int64)
            ll = torch.gather(logp, -1, yi.expand(out.shape[:-1])[..., None]
                              )[..., 0].sum(-1)
            parts.append((ll,) + tuple(block_step.cls_metrics(out, yi)))
            continue
        ev = likelihood.classification_eval_from_logp(logp, out, y[k], mask)
        parts.append((ev.loglik, ev.rmse, ev.acc))
    return tuple(torch.cat([p[j] for p in parts]) for j in range(3))


def fnn_eval_reference(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                       tau: Optional[torch.Tensor], topo: Topology,
                       task: str, rows: Rows = None,
                       classes: Rows = None) -> Eval:
    """The plain PyTorch version of ``fnn_eval``, on any device."""
    if x.dim() == 3 or rows is not None or classes is not None:
        return _grid_reference(w, x, y, tau, topo, task, rows, classes)
    n = x.shape[0]
    if task == "classification":
        return block_step.cls_eval(w, x, y.to(torch.int64), topo)
    fx = fnn.batched_forward(w, x, topo)[:, :, 0]
    ll = likelihood.regression_eval_from_fx(fx, y, tau).loglik
    rmse = torch.sqrt(torch.sum(torch.square(fx - y), dim=-1)
                      * block_step.inv_rows(n))
    return ll, rmse, torch.zeros_like(ll)


def fnn_eval_pair_reference(w: torch.Tensor, x_tr: torch.Tensor,
                            y_tr: torch.Tensor, x_te: torch.Tensor,
                            y_te: torch.Tensor, tau: Optional[torch.Tensor],
                            topo: Topology, task: str, rows_tr: Rows = None,
                            rows_te: Rows = None,
                            classes: Rows = None) -> Tuple[Eval, Eval]:
    """The plain PyTorch version of ``fnn_eval_pair``: two
    ``fnn_eval_reference`` calls."""
    return (fnn_eval_reference(w, x_tr, y_tr, tau, topo, task, rows_tr,
                               classes),
            fnn_eval_reference(w, x_te, y_te, tau, topo, task, rows_te,
                               classes))


@functools.lru_cache(maxsize=None)
def layouts() -> dict:
    """{(I, H, O): HPW} of the compile-time instantiations (the table
    FNN_LAYOUTS of csrc/fnn_layouts.cuh, read from the source)."""
    from ptnn_torch.ops import _build

    return {row[:3]: row[4]
            for row in _build.cu_rows("fnn_layouts.cuh", "FNN_LAYOUTS")}


def smem_floats(topo: Topology, row_groups: int, hid_groups: int,
                w_smem: bool = True, in_tile: Optional[int] = None,
                out_chunk: Optional[int] = None) -> int:
    """Dynamic shared memory of one block in floats (``eval_smem_floats``
    of csrc/fnn_eval.cu): the chain's weights rounded up to 4 (unless they
    stay in device memory), the staged rows (``in_tile`` inputs, default
    all) and their targets, two parities of the warps' output shares
    (``out_chunk`` outputs, default all), the row groups' sums and the
    block's."""
    n_in, _n_hid, n_out = topo
    w = fnn.w_size(topo)
    rows = _TILE * row_groups
    it = n_in if in_tile is None else in_tile
    oc = n_out if out_chunk is None else out_chunk
    return (((w + 3) // 4 * 4 if w_smem else 0) + it * (rows + 1) + rows
            + 2 * row_groups * hid_groups * oc * _TILE + 4 * row_groups + 4)


class EvalPlan(NamedTuple):
    """One launch of the eval kernel: ``cluster`` blocks a (chain, set),
    ``tile_rows`` the rows a block takes in each set, ``row_groups`` x
    ``hid_groups`` warps a block (a pass takes 32 rows a row group; the
    warps of a row group split the hidden units, ``hid_per_warp`` at a
    time), ``blocks`` in the grid and ``smem`` bytes a block; the wide
    routes of the generic instantiation: ``w_global`` (the weights read
    from device memory), ``in_tile`` inputs staged at a time and
    ``out_chunk`` outputs a chunk."""
    cluster: int
    tile_rows: Tuple[int, ...]
    row_groups: int
    hid_groups: int
    hid_per_warp: int
    blocks: int
    smem: int
    w_global: bool
    in_tile: int
    out_chunk: int


def launch_plan(chains: int, n_rows: Sequence[int], topo: Topology) -> EvalPlan:
    """The kernel's launch for ``chains`` chains on row sets of ``n_rows``
    rows (one count per set, one or two sets). Pure Python.

    A (chain, set) takes one cluster of T blocks, one for each 32 rows of
    the largest set, at most 8; block ``rank`` takes rows ``[rank R, (rank
    + 1) R)`` of each set, R = ceil(n / T) for that set. A row group has HG
    = ceil(H / HPW) warps (HPW from FNN_LAYOUTS, else GEN_HPW, at most
    MAX_WARPS warps, GEN_WARPS for the generic instantiation, the warps
    then looping over the units); a block has as many row groups as make
    one pass of its largest tile, within those warps, fewer while the block
    does not fit a Hopper block's shared memory (less the kernel's static
    share). Past that (the generic instantiation):
    the weights read from device memory, the row groups again from the most
    down to one; then one row group with the inputs staged ``in_tile`` at a
    time. Outputs past MAX_OUT go in chunks of MAX_OUT."""
    n_rows = tuple(int(n) for n in n_rows)
    if not 1 <= len(n_rows) <= 2 or min(n_rows) < 1 or chains < 1:
        raise ValueError(f"{chains} chains on row sets {n_rows}: needs one or "
                         f"two non-empty sets and at least one chain")
    topo = tuple(int(d) for d in topo)
    n_in, n_hid, n_out = topo
    cluster = min(_MAX_CLUSTER, -(-max(n_rows) // _TILE))
    tiles = tuple(-(-n // cluster) for n in n_rows)
    oc = min(n_out, _MAX_OUT)
    limit = _SMEM_LIMIT - _STATIC_SMEM  # the dynamic share's bytes

    def made(hpw, warps, rg, w_smem, it):
        hg = min(warps, -(-n_hid // hpw))
        return EvalPlan(cluster, tiles, rg, hg, hpw,
                        chains * len(n_rows) * cluster,
                        4 * smem_floats(topo, rg, hg, w_smem, it, oc),
                        not w_smem, it, oc)

    def row_groups(hpw, warps):  # the most: one pass of the largest tile
        hg = min(warps, -(-n_hid // hpw))
        return range(max(1, min(-(-max(tiles) // _TILE), warps // hg)), 0, -1)

    fixed = layouts().get(topo)
    if fixed is not None:  # the compile-time instantiation: staged only
        for rg in row_groups(fixed, _MAX_WARPS):
            plan = made(fixed, _MAX_WARPS, rg, True, n_in)
            if plan.smem <= limit:
                return plan
    from ptnn_torch.ops import _build

    hpw = _build.cu_define("fnn_eval.cu", "GEN_HPW")
    warps = _build.cu_define("fnn_eval.cu", "GEN_WARPS")
    for w_smem in (True, False):
        for rg in row_groups(hpw, warps):
            plan = made(hpw, warps, rg, w_smem, n_in)
            if plan.smem <= limit:
                return plan
    hg = min(warps, -(-n_hid // hpw))
    it = (limit // 4 - smem_floats(topo, 1, hg, False, 0, oc)) // (_TILE + 1)
    if it < 1:
        raise ValueError(f"topology {topo}: one row group's output shares "
                         f"pass a Hopper block's {_SMEM_LIMIT} bytes")
    return made(hpw, warps, 1, False, min(it, n_in))


_plan = functools.lru_cache(maxsize=64)(launch_plan)


class _EvalSet(ctypes.Structure):
    """Mirror of ``struct EvalSet`` in csrc/fnn_eval.cu (same field
    order)."""

    _fields_ = [
        (name, ctypes.c_void_p) for name in ("x", "y", "cell_rows")
    ] + [
        (name, ctypes.c_longlong) for name in ("x_cell", "y_cell")
    ] + [
        (name, ctypes.c_void_p) for name in ("ll", "rmse", "acc")
    ] + [
        (name, ctypes.c_int) for name in ("n_rows", "tile_rows")
    ] + [
        (name, ctypes.c_float) for name in ("ll_const", "inv_n", "acc_n")
    ]


class _EvalParams(ctypes.Structure):
    """Mirror of ``struct EvalParams`` in csrc/fnn_eval.cu (same field
    order)."""

    _fields_ = [
        ("w", ctypes.c_void_p), ("tau", ctypes.c_void_p),
        ("cell_classes", ctypes.c_void_p), ("set", _EvalSet * 2),
    ] + [
        (name, ctypes.c_int)
        for name in ("chains", "n_sets", "n_in", "n_hid", "n_out", "task_cls",
                     "chains_per_cell", "cluster", "row_groups",
                     "hid_groups", "w_global", "in_tile", "out_chunk")
    ] + [("log_2pi", ctypes.c_float)]


def _launch_cuda(w, sets, tau, topo, task,
                 classes: Rows = None) -> Tuple[Eval, ...]:
    """One launch over the row sets ``sets`` = ((x, y, rows), ...)."""
    global launches
    from ptnn_torch.ops import _build

    n_in, n_hid, n_out = topo
    c = w.shape[0]
    dev = w.device
    cls = task == "classification"
    g = sets[0][0].shape[0] if sets[0][0].dim() == 3 else 1
    if c < 1 or min(x.shape[-2] for x, _y, _r in sets) < 1:
        raise ValueError(f"chains {c} and rows "
                         f"{[x.shape[-2] for x, _y, _r in sets]} must be "
                         f"positive")
    if c % g:
        raise ValueError(f"{c} chains do not split evenly over {g} cells")
    _check(w, "w", (c, fnn.w_size(topo)), torch.float32, dev)
    for x, y, rows in sets:
        lead = (g,) if x.dim() == 3 else ()
        n = x.shape[-2]
        _check(x, "x", lead + (n, n_in), torch.float32, dev)
        _check(y, "y", lead + (n,), torch.float32, dev)
        if rows is not None:
            _check(rows, "rows", (g,), torch.int32, dev)
    if classes is not None:
        _check(classes, "classes", (g,), torch.int32, dev)
    if not cls:
        _check(tau, "tau", (c,), torch.float32, dev)
    plan = _plan(c, tuple(x.shape[-2] for x, _y, _r in sets), tuple(topo))
    lib = _build.build("fnn_eval").lib
    outs, c_sets = [], (_EvalSet * 2)()
    for k, ((x, y, rows), tile) in enumerate(zip(sets, plan.tile_rows)):
        n = x.shape[-2]
        ll, rmse, acc = (torch.empty((c,), dtype=torch.float32, device=dev)
                         for _ in range(3))
        outs.append((ll, rmse, acc))
        per_cell = x.dim() == 3
        c_sets[k] = _EvalSet(
            x=x.data_ptr(), y=y.data_ptr(),
            cell_rows=None if rows is None else rows.data_ptr(),
            x_cell=n * n_in if per_cell else 0, y_cell=n if per_cell else 0,
            ll=ll.data_ptr(), rmse=rmse.data_ptr(), acc=acc.data_ptr(),
            n_rows=n,
            tile_rows=tile, ll_const=-0.5 * n,
            inv_n=block_step.inv_rows(n),
            acc_n=block_step.inv_rows(n, 100.0))
    params = _EvalParams(
        w=w.data_ptr(), tau=None if cls else tau.data_ptr(),
        cell_classes=None if classes is None else classes.data_ptr(),
        set=c_sets, chains=c, n_sets=len(sets), n_in=n_in, n_hid=n_hid,
        n_out=n_out, task_cls=int(cls), chains_per_cell=c // g,
        cluster=plan.cluster, row_groups=plan.row_groups,
        hid_groups=plan.hid_groups, w_global=int(plan.w_global),
        in_tile=plan.in_tile, out_chunk=plan.out_chunk,
        log_2pi=likelihood._LOG_2PI)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ptnn_fnn_eval(ctypes.byref(params), plan.smem,
                                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"fnn_eval launch failed: {_build.error_string(lib, err)}")
    launches += 1
    return tuple(outs)


def _device_kind(task: str, tensors) -> str:
    if task not in ("regression", "classification"):
        raise ValueError(f"unknown task {task!r}")
    kinds = {a.device.type for a in tensors}
    if kinds in ({"cpu"}, {"cuda"}):
        return kinds.pop()
    raise ValueError(f"fnn_eval needs all tensors on one device type, got "
                     f"{sorted(kinds)}")


def fnn_eval(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             tau: Optional[torch.Tensor], topo: Topology, task: str,
             rows: Rows = None, classes: Rows = None) -> Eval:
    """Every chain's (ll, rmse, acc) on the rows (x, y): w (C, W), x (N, I),
    y (N,) float32 (class indices as floats), tau (C,) the noise variance
    (regression; None or ignored for classification); a grid's x (G, N, I),
    y (G, N), ``rows`` and ``classes`` as in the module docstring. CUDA
    tensors launch the kernel, CPU tensors run the plain version."""
    tensors = [w, x, y] + ([tau] if task == "regression" else [])
    if _device_kind(task, tensors) == "cpu":
        return fnn_eval_reference(w, x, y, tau, topo, task, rows, classes)
    return _launch_cuda(w, ((x, y, rows),), tau, topo, task, classes)[0]


def fnn_eval_pair(w: torch.Tensor, x_tr: torch.Tensor, y_tr: torch.Tensor,
                  x_te: torch.Tensor, y_te: torch.Tensor,
                  tau: Optional[torch.Tensor], topo: Topology,
                  task: str, rows_tr: Rows = None, rows_te: Rows = None,
                  classes: Rows = None) -> Tuple[Eval, Eval]:
    """``fnn_eval`` on the train rows and on the test rows of the same
    weights: ((ll, rmse, acc) of the train rows, the same of the test
    rows). CUDA tensors launch the kernel once for both sets, CPU tensors
    run the plain version twice."""
    tensors = [w, x_tr, y_tr, x_te, y_te] + (
        [tau] if task == "regression" else [])
    if _device_kind(task, tensors) == "cpu":
        return fnn_eval_pair_reference(w, x_tr, y_tr, x_te, y_te, tau, topo,
                                       task, rows_tr, rows_te, classes)
    tr, te = _launch_cuda(w, ((x_tr, y_tr, rows_tr), (x_te, y_te, rows_te)),
                          tau, topo, task, classes)
    return tr, te
