"""Langevin-gradient drift: epochs of delta-rule SGD over the dataset.

Port of ``ptnn/ops/drift.py`` and of the chain-batched epoch of
``ptnn/ops/pallas_drift.py``. The reference's Langevin proposal drifts the
weights by one epoch of *per-sample* SGD with the delta rule
(``Network.langevin_gradient``, pt_classification.py:114-132). For one row
``(x, t)``, with ``t`` the one-hot label (classification) or the target
column (regression):

    hid = sigmoid(x @ W1 - B1);  out = sigmoid(hid @ W2 - B2)
    out_delta = (t - out) * out * (1 - out)
    hid_delta = (W2 @ out_delta) * hid * (1 - hid)     # W2 before the update
    W2 += lr * outer(hid, out_delta);   B2 += lr * -out_delta
    W1 += lr * outer(x, hid_delta);     B1 += lr * -hid_delta

(biases are subtracted in the forward pass, so they move by ``-lr * delta``).

* ``sgd_epoch_sequential``: the rows in dataset order, each update seen by
  the next row; ``depth`` epochs run row ``k % N`` at step ``k``. The plain
  version is a loop over rows, batched over chains.
* ``sgd_epoch_batch``: every row's update at the initial weights, summed (the
  fast, MH-corrected deviation of ptnn's ``batch`` mode): a few matrix
  products, left to ``torch.matmul`` in full float32.
* ``sgd_epoch``: the dispatcher by ``drift_mode``. "sequential" and "pallas"
  are the same epoch in ptnn; on CUDA tensors both launch the hand-written
  kernel ``csrc/drift_epoch.cu``, on CPU tensors both run the plain version.
  A CUDA tensor never takes the plain version: it launches or raises.

``csrc/drift_epoch.cu`` has two kernels, picked by topology (``variant``),
never by failure: the register kernel for the topologies of the
``FNN_LAYOUTS`` table of ``csrc/fnn_layouts.cuh`` (every network the
repository bundles), with a
lane group of G lanes per chain and the weights in registers; the generic
kernel (one warp per chain) for any other topology, of any width: ``plan``
(pure Python) gives it WARPS chains a block with their weights in shared
memory where they fit, fewer chains a block down to one where they do not,
and where one chain's weights do not fit a block, weights in device memory
(the output buffer, updated in place). ``launches`` counts both kernels;
``variant_launches`` says which ran, ``route_launches`` how the generic
kernel held its weights.

Weights are chains-major flat vectors (C, W) in the codec of
``models/fnn.py``; x (N, I), t (N, O) float32. A grid of runs
(``ptnn_torch.sweeps``, ptnn's masked epochs) passes a rate a chain (C,),
each cell's rows x (G, N, I), t (G, N, O) with the chains cell-major,
``rows`` (G,) int32, each cell's valid rows (the padding after them, whose
updates scale by 0: the kernel skips them), and ``w_mask`` (G, W) {0, 1},
which multiplies every per-row update.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import Mapping, NamedTuple, Optional, Tuple, Union

import torch

from ptnn_torch.models import fnn
from ptnn_torch.models.fnn import Topology
from ptnn_torch.ops import _build
from ptnn_torch.ops.block_step import _SMEM_LIMIT, _check

launches = 0  # launches of csrc/drift_epoch.cu (the plain version counts none)
variant_launches = {"register": 0, "generic": 0}  # which kernel they ran
route_launches = {"registers": 0, "shared": 0, "global": 0}  # the weights'

Rate = Union[float, torch.Tensor]  # one learning rate, or one a chain (C,)
MODES = ("sequential", "pallas", "batch")
_SOURCE = "drift_epoch.cu"
_TILE_FLOATS = 16384  # rows staged per tile: at most 64 KB of (x, t)


def _define(name: str) -> int:
    """A layout constant of csrc/drift_epoch.cu, read from the source at
    first use: WARPS (the generic kernel's most chains a block), HPL (its
    hidden units a lane in a chunk of the forward), REG_THREADS (the
    register kernel's threads a block)."""
    return _build.cu_define(_SOURCE, name)


@functools.lru_cache(maxsize=None)
def reg_layouts() -> Mapping[Tuple[int, int, int], int]:
    """The topologies the register kernel is instantiated for, each with its
    lane-group size G, from the ``FNN_LAYOUTS`` table of
    csrc/fnn_layouts.cuh (read once)."""
    rows = _build.cu_rows("fnn_layouts.cuh", "FNN_LAYOUTS")
    return types.MappingProxyType({r[:3]: r[3] for r in rows})


def variant(topo: Topology) -> Tuple[str, Optional[int]]:
    """The kernel a CUDA epoch of ``topo`` launches: ("register", G) for a
    topology of the register table, else ("generic", None)."""
    g = reg_layouts().get(tuple(topo))
    if g is not None:
        return "register", g
    return "generic", None


def make_targets(y: torch.Tensor, n_out: int, task: str) -> torch.Tensor:
    """Per-row delta-rule targets: the one-hot label (classification) or
    the target column (regression), float32 (N, O)."""
    if task == "classification":
        return torch.nn.functional.one_hot(y.to(torch.int64),
                                           n_out).to(torch.float32)
    return y.reshape(-1, 1).to(torch.float32)


def per_chain(a: torch.Tensor, chains: int) -> torch.Tensor:
    """A per-cell array (G, ...) repeated to the chains (C, ...), cell-major:
    chain c belongs to cell ``c // (C // G)``."""
    return a.repeat_interleave(chains // a.shape[0], dim=0)


def row_mask(rows: torch.Tensor, n: int) -> torch.Tensor:
    """The {0, 1} float32 row validity (G, n) of cells with ``rows`` (G,)
    valid rows first, the padding after them (ptnn's ``mask_*``)."""
    idx = torch.arange(n, device=rows.device)
    return (idx[None, :] < rows[:, None]).to(torch.float32)


def _cells(w: torch.Tensor, x: torch.Tensor) -> int:
    """The grid's cells: x (G, N, I) holds each cell's rows, and the
    chains (C, W) split evenly over them; 1 for a dataset (N, I) that every
    chain shares."""
    if x.dim() == 2:
        return 1
    g, c = x.shape[0], w.shape[0]
    if c % g:
        raise ValueError(f"{c} chains do not split evenly over {g} cells")
    return g


def _lead(v, nd: int):
    """A per-chain (C,) factor shaped to broadcast over (C, ...) of ``nd``
    dimensions; a float or a 0-d tensor as it is."""
    if isinstance(v, torch.Tensor) and v.dim() == 1:
        return v.reshape(v.shape + (1,) * (nd - 1))
    return v


def sgd_epoch_sequential(w: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                         topo: Topology, lrate: Rate, depth: int = 1,
                         rows: Optional[torch.Tensor] = None,
                         w_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """``depth`` epochs of per-row SGD in dataset order for every chain: w
    (C, W) -> (C, W). The plain version, on any device, in the order and
    with the rounding of ptnn's scan (``_delta_updates``).

    The grid's arguments (ptnn's ``mask`` / ``w_mask``): ``lrate`` is one
    float or a (C,) rate a chain; x (G, N, I) and t (G, N, O) give each
    cell its own rows; ``rows`` (G,) counts each cell's valid rows, the
    padding after them, whose updates are scaled by exactly 0; ``w_mask``
    (W,) or (G, W) {0, 1} multiplies every per-row update, so a masked
    parameter never leaves its initial 0 and a padded hidden unit never
    reaches a real output mid-epoch."""
    p = fnn.unpack(w, topo)
    w1, b1 = p.w1.clone(), p.b1.clone()  # (C, I, H), (C, H)
    w2, b2 = p.w2.clone(), p.b2.clone()  # (C, H, O), (C, O)
    c, n = w.shape[0], x.shape[-2]
    cells = x.dim() == 3
    if cells:
        _cells(w, x)
        x, t = per_chain(x, c), per_chain(t, c)  # (C, N, I), (C, N, O)
    m = None
    if rows is not None:
        m = per_chain(row_mask(rows, n), c) if cells else row_mask(rows, n)[0]
    mp = None
    if w_mask is not None:
        wm = per_chain(w_mask, c) if w_mask.dim() == 2 else w_mask
        mp = fnn.unpack(wm, topo)
    for k in range(n * depth):
        r = k % n
        if cells:
            xi, ti = x[:, r], t[:, r]  # (C, I), (C, O)
            hid = torch.sigmoid(torch.matmul(xi[:, None, :], w1)[:, 0, :] - b1)
            xw = xi[:, :, None]
        else:
            xi, ti = x[r], t[r]
            hid = torch.sigmoid(torch.matmul(xi, w1) - b1)  # (C, H)
            xw = xi[None, :, None]
        out = torch.sigmoid(torch.matmul(hid[:, None, :], w2)[:, 0, :] - b2)
        od = (ti - out) * out * (1.0 - out)  # (C, O)
        hd = torch.matmul(w2, od[:, :, None])[:, :, 0] * hid * (1.0 - hid)
        dw2, db2 = hid[:, :, None] * od[:, None, :], -od
        dw1, db1 = xw * hd[:, None, :], -hd
        if mp is not None:
            dw1, db1, dw2, db2 = dw1 * mp.w1, db1 * mp.b1, dw2 * mp.w2, \
                db2 * mp.b2
        lm = lrate
        if m is not None:
            lm = lrate * (m[:, r] if cells else m[r])
        w2 += _lead(lm, 3) * dw2
        b2 += _lead(lm, 2) * db2
        w1 += _lead(lm, 3) * dw1
        b1 += _lead(lm, 2) * db1
    return fnn.pack(fnn.FnnParams(w1=w1, b1=b1, w2=w2, b2=b2))


def sgd_epoch_batch(w: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                    topo: Topology, lrate: Rate,
                    rows: Optional[torch.Tensor] = None,
                    w_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every row's delta-rule update evaluated at ``w`` and summed: w (C, W)
    -> (C, W). The grid's arguments as in ``sgd_epoch_sequential``: a
    padded row's output delta is scaled by 0 (the hidden delta inherits
    it), and ``w_mask`` multiplies the result (every update is taken at the
    initial weights, where a padded unit reaches no real output)."""
    c = w.shape[0]
    g = _cells(w, x)
    p = fnn.unpack(w, topo)
    if x.dim() == 3:
        # (G, chains a cell, ...) against each cell's rows (G, 1, N, .)
        p = fnn.FnnParams(*(a.reshape((g, c // g) + a.shape[1:]) for a in p))
        x, t = x[:, None], t[:, None]
        if isinstance(lrate, torch.Tensor) and lrate.dim() == 1:
            lrate = lrate.reshape(g, c // g)
    lead = p.b1.dim()  # 2 (shared rows), 3 (per cell)
    hid = torch.sigmoid(torch.matmul(x, p.w1) - p.b1[..., None, :])
    out = torch.sigmoid(torch.matmul(hid, p.w2) - p.b2[..., None, :])
    od = (t - out) * out * (1.0 - out)  # (..., N, O)
    if rows is not None:
        m = row_mask(rows, x.shape[-2])
        od = od * (m[:, None, :, None] if lead == 3 else m[0, :, None])
    hd = torch.matmul(od, p.w2.transpose(-1, -2)) * hid * (1.0 - hid)
    lr2 = lrate
    if isinstance(lrate, torch.Tensor) and lrate.dim() >= 1:
        lr2 = lrate[..., None]
    lr3 = lr2[..., None] if isinstance(lr2, torch.Tensor) else lr2
    nxt = fnn.pack(fnn.FnnParams(
        w1=p.w1 + lr3 * torch.matmul(x.transpose(-1, -2), hd),
        b1=p.b1 - lr2 * torch.sum(hd, dim=-2),
        w2=p.w2 + lr3 * torch.matmul(hid.transpose(-1, -2), od),
        b2=p.b2 - lr2 * torch.sum(od, dim=-2),
    )).reshape(c, -1)
    if w_mask is not None:
        nxt = nxt * (per_chain(w_mask, c) if w_mask.dim() == 2 else w_mask)
    return nxt


class _DriftParams(ctypes.Structure):
    """Mirror of ``struct DriftParams`` in csrc/drift_epoch.cu (same field
    order)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "w", "x", "t", "o_w", "lrates", "cell_rows", "w_mask")] + [
        (name, ctypes.c_longlong) for name in ("x_cell", "t_cell")
    ] + [
        (name, ctypes.c_int)
        for name in ("chains", "n_rows", "n_in", "n_hid", "n_out", "depth",
                     "tile_rows", "cells", "chains_per_cell", "warps",
                     "w_global")
    ] + [("lrate", ctypes.c_float)]


def tile_rows(n_rows: int, depth: int, n_in: int, n_out: int) -> int:
    """Rows (x and t) staged in shared memory at a time, at most 64 KB."""
    return max(1, min(n_rows * depth, _TILE_FLOATS // (n_in + n_out)))


class DriftPlan(NamedTuple):
    """One launch of the drift kernel: ``kind`` ("register" or "generic"),
    ``chains_per_block``, where a chain's weights live (``weights``:
    "registers", "shared" or "global", the generic kernel's working copy in
    device memory), ``tile_rows`` staged at a time, ``blocks`` and
    ``smem`` bytes a block."""
    kind: str
    chains_per_block: int
    weights: str
    tile_rows: int
    blocks: int
    smem: int


def plan(chains: int, n_rows: int, depth: int, topo: Topology,
         masked: bool = False, cells: int = 1) -> DriftPlan:
    """The launch of an epoch of ``chains`` chains in ``cells`` cells over
    ``n_rows`` rows, ``depth`` times. Pure Python.

    The register kernel stages a tile of rows (and a masked grid's mask)
    beside its weights in registers, ``REG_THREADS / G`` chains a block.
    The generic kernel stages for each chain of a block its weights and its
    row's hidden activations and output deltas (W + H + O floats), and a
    tile of rows: WARPS chains a block, fewer down to one while that does
    not fit, then one chain with a shorter tile; where one chain's weights
    do not fit beside a single row, they stay in device memory (the mask
    too) and the block stages the rest, WARPS chains down to one with the
    tile shortened to fit. Raises ValueError only where one row and one
    chain's activations (I + O + H + O floats) pass a Hopper block's
    shared memory."""
    i, h, o = (int(d) for d in topo)
    w = fnn.w_size((i, h, o))
    kind, g = variant((i, h, o))
    tile = tile_rows(n_rows, depth, i, o)
    cap = _SMEM_LIMIT // 4  # floats a block
    cpc = chains // cells

    def made(cpb, where, t, floats):
        return DriftPlan(kind, cpb, where, t, cells * -(-cpc // cpb),
                         4 * floats)

    if kind == "register":
        cpb = _define("REG_THREADS") // g
        return made(cpb, "registers", tile,
                    tile * (i + o) + (w if masked else 0))
    per = h + o  # a chain's staged activations
    mask = w if masked else 0
    for cpb in range(_define("WARPS"), 0, -1):
        floats = tile * (i + o) + mask + cpb * (w + per)
        if floats <= cap:
            return made(cpb, "shared", tile, floats)
    short = (cap - mask - w - per) // (i + o)
    if short >= 1:
        return made(1, "shared", short,
                    short * (i + o) + mask + w + per)
    for cpb in range(_define("WARPS"), 0, -1):
        t = min(tile, (cap - cpb * per) // (i + o))
        if t >= 1:
            return made(cpb, "global", t, t * (i + o) + cpb * per)
    raise ValueError(
        f"topology {(i, h, o)}: the drift kernel stages a row and one "
        f"chain's hidden activations and output deltas, {i + o + per} "
        f"floats ({4 * (i + o + per)} bytes); a Hopper block has "
        f"{_SMEM_LIMIT}")


def smem_bytes(n_rows: int, depth: int, topo: Topology,
               masked: bool = False) -> int:
    """Dynamic shared memory of one block at WARPS chains (``plan``'s)."""
    return plan(_define("WARPS"), n_rows, depth, topo, masked).smem


def _launch_cuda(w, x, t, topo, lrate, depth, rows=None, w_mask=None):
    global launches

    n_in, n_hid, n_out = topo
    c, n = w.shape[0], x.shape[-2]
    dev = w.device
    kind = variant(topo)[0]
    g = _cells(w, x)
    if depth < 1 or n < 1 or n * depth >= 2**31:
        raise ValueError(f"depth {depth} and rows {n} must be positive, "
                         f"their product under 2^31")
    _check(w, "w", (c, fnn.w_size(topo)), torch.float32, dev)
    lead = (g,) if x.dim() == 3 else ()
    _check(x, "x", lead + (n, n_in), torch.float32, dev)
    _check(t, "t", lead + (n, n_out), torch.float32, dev)
    lrates = None
    if isinstance(lrate, torch.Tensor):
        lrates = lrate
        _check(lrates, "lrate", (c,), torch.float32, dev)
    elif not isinstance(lrate, (int, float)):
        raise ValueError("the drift kernel takes a float rate or a (C,) "
                         "float32 tensor")
    if rows is not None:
        _check(rows, "rows", (g,), torch.int32, dev)
    if w_mask is not None:
        if w_mask.dim() == 1:
            w_mask = w_mask.expand(g, -1).contiguous()
        _check(w_mask, "w_mask", (g, fnn.w_size(topo)), torch.float32, dev)
    lay = plan(c, n, depth, topo, w_mask is not None, g)
    lib = _build.build("drift_epoch").lib
    out = torch.empty_like(w)
    ptr = lambda a: None if a is None else a.data_ptr()
    params = _DriftParams(
        w=w.data_ptr(), x=x.data_ptr(), t=t.data_ptr(), o_w=out.data_ptr(),
        lrates=ptr(lrates), cell_rows=ptr(rows), w_mask=ptr(w_mask),
        x_cell=n * n_in if lead else 0, t_cell=n * n_out if lead else 0,
        chains=c, n_rows=n, n_in=n_in, n_hid=n_hid, n_out=n_out, depth=depth,
        tile_rows=lay.tile_rows, cells=g, chains_per_cell=c // g,
        warps=lay.chains_per_block, w_global=int(lay.weights == "global"),
        lrate=0.0 if lrates is not None else float(lrate),
    )
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if kind == "register":
            err = lib.ptnn_drift_epoch_reg(ctypes.byref(params), lay.smem,
                                           stream)
        else:
            err = lib.ptnn_drift_epoch(ctypes.byref(params), lay.smem, stream)
    if err != 0:
        raise RuntimeError(
            f"drift_epoch launch failed: {_build.error_string(lib, err)}")
    launches += 1
    variant_launches[kind] += 1
    route_launches[lay.weights] += 1
    return out


def sgd_epoch(w: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
              topo: Topology, lrate: Rate, mode: str = "sequential",
              depth: int = 1, rows: Optional[torch.Tensor] = None,
              w_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Langevin drift of every chain: ``depth`` epochs of ``mode``
    ("sequential" and "pallas": the per-row epoch; "batch": the summed
    update), with the grid's arguments of ``sgd_epoch_sequential``. CUDA
    tensors launch the drift kernel for the per-row epoch; CPU tensors run
    the plain version."""
    if mode == "batch":
        for _ in range(depth):
            w = sgd_epoch_batch(w, x, t, topo, lrate, rows, w_mask)
        return w
    if mode not in MODES:
        raise ValueError(f"unknown drift mode {mode!r}")
    kinds = {a.device.type for a in (w, x, t)}
    if kinds == {"cpu"}:
        return sgd_epoch_sequential(w, x, t, topo, lrate, depth, rows,
                                    w_mask)
    if kinds == {"cuda"}:
        return _launch_cuda(w, x, t, topo, lrate, depth, rows, w_mask)
    raise ValueError(f"sgd_epoch needs all tensors on one device type, got "
                     f"{sorted(kinds)}")
