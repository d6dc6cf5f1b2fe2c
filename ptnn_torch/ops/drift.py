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
kernel (one warp per chain, the weights in shared memory) for any other
topology with at most ``32 * HPL`` hidden units. ``launches`` counts both;
``variant_launches`` says which ran.

Weights are chains-major flat vectors (C, W) in the codec of
``models/fnn.py``; x (N, I), t (N, O) float32.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import Mapping, Optional, Tuple

import torch

from ptnn_torch.models import fnn
from ptnn_torch.models.fnn import Topology
from ptnn_torch.ops import _build
from ptnn_torch.ops.block_step import _SMEM_LIMIT, _check

launches = 0  # launches of csrc/drift_epoch.cu (the plain version counts none)
variant_launches = {"register": 0, "generic": 0}  # which kernel they ran

MODES = ("sequential", "pallas", "batch")
_SOURCE = "drift_epoch.cu"
_TILE_FLOATS = 16384  # rows staged per tile: at most 64 KB of (x, t)


def _define(name: str) -> int:
    """A layout constant of csrc/drift_epoch.cu, read from the source at
    first use: WARPS (the generic kernel's chains a block), HPL (its hidden
    units a lane, n_hid <= 32 HPL), REG_THREADS (the register kernel's
    threads a block)."""
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
    topology of the register table, else ("generic", None) for at most
    ``32 * HPL`` hidden units; anything else raises."""
    topo = tuple(topo)
    g = reg_layouts().get(topo)
    if g is not None:
        return "register", g
    if topo[1] > 32 * _define("HPL"):
        raise ValueError(f"the drift kernel takes at most "
                         f"{32 * _define('HPL')} hidden units, not {topo[1]}")
    return "generic", None


def make_targets(y: torch.Tensor, n_out: int, task: str) -> torch.Tensor:
    """Per-row delta-rule targets: the one-hot label (classification) or
    the target column (regression), float32 (N, O)."""
    if task == "classification":
        return torch.nn.functional.one_hot(y.to(torch.int64),
                                           n_out).to(torch.float32)
    return y.reshape(-1, 1).to(torch.float32)


def sgd_epoch_sequential(w: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                         topo: Topology, lrate: float,
                         depth: int = 1) -> torch.Tensor:
    """``depth`` epochs of per-row SGD in dataset order for every chain: w
    (C, W) -> (C, W). The plain version, on any device, in the order and
    with the rounding of ptnn's scan (``_delta_updates``)."""
    p = fnn.unpack(w, topo)
    w1, b1 = p.w1.clone(), p.b1.clone()  # (C, I, H), (C, H)
    w2, b2 = p.w2.clone(), p.b2.clone()  # (C, H, O), (C, O)
    n = x.shape[0]
    for k in range(n * depth):
        xi, ti = x[k % n], t[k % n]
        hid = torch.sigmoid(torch.matmul(xi, w1) - b1)  # (C, H)
        out = torch.sigmoid(torch.matmul(hid[:, None, :], w2)[:, 0, :] - b2)
        od = (ti - out) * out * (1.0 - out)  # (C, O)
        hd = torch.matmul(w2, od[:, :, None])[:, :, 0] * hid * (1.0 - hid)
        w2 += lrate * (hid[:, :, None] * od[:, None, :])
        b2 += lrate * -od
        w1 += lrate * (xi[None, :, None] * hd[:, None, :])
        b1 += lrate * -hd
    return fnn.pack(fnn.FnnParams(w1=w1, b1=b1, w2=w2, b2=b2))


def sgd_epoch_batch(w: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                    topo: Topology, lrate: float) -> torch.Tensor:
    """Every row's delta-rule update evaluated at ``w`` and summed: w (C, W)
    -> (C, W)."""
    p = fnn.unpack(w, topo)
    hid = torch.sigmoid(torch.matmul(x, p.w1) - p.b1[:, None, :])  # (C, N, H)
    out = torch.sigmoid(torch.matmul(hid, p.w2) - p.b2[:, None, :])  # (C, N, O)
    od = (t - out) * out * (1.0 - out)
    hd = torch.matmul(od, p.w2.transpose(-1, -2)) * hid * (1.0 - hid)
    return fnn.pack(fnn.FnnParams(
        w1=p.w1 + lrate * torch.matmul(x.T, hd),
        b1=p.b1 - lrate * torch.sum(hd, dim=1),
        w2=p.w2 + lrate * torch.matmul(hid.transpose(-1, -2), od),
        b2=p.b2 - lrate * torch.sum(od, dim=1),
    ))


class _DriftParams(ctypes.Structure):
    """Mirror of ``struct DriftParams`` in csrc/drift_epoch.cu (same field
    order)."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("w", "x", "t", "o_w")] + [
        (name, ctypes.c_int)
        for name in ("chains", "n_rows", "n_in", "n_hid", "n_out", "depth",
                     "tile_rows")
    ] + [("lrate", ctypes.c_float)]


def tile_rows(n_rows: int, depth: int, n_in: int, n_out: int) -> int:
    """Rows (x and t) staged in shared memory at a time."""
    return max(1, min(n_rows * depth, _TILE_FLOATS // (n_in + n_out)))


def smem_bytes(n_rows: int, depth: int, topo: Topology) -> int:
    """Dynamic shared memory of one block: a tile of rows and, for the
    generic kernel, one weight vector per chain of the block (the register
    kernel keeps its weights in registers)."""
    i, _h, o = topo
    tile = tile_rows(n_rows, depth, i, o) * (i + o)
    if variant(topo)[0] == "generic":
        tile += _define("WARPS") * fnn.w_size(topo)
    return 4 * tile


def _launch_cuda(w, x, t, topo, lrate, depth):
    global launches

    n_in, n_hid, n_out = topo
    c, n = w.shape[0], x.shape[0]
    dev = w.device
    kind = variant(topo)[0]
    if not isinstance(lrate, (int, float)):
        raise ValueError("the drift kernel takes one float learning rate")
    if depth < 1 or n < 1:
        raise ValueError(f"depth {depth} and rows {n} must be positive")
    _check(w, "w", (c, fnn.w_size(topo)), torch.float32, dev)
    _check(x, "x", (n, n_in), torch.float32, dev)
    _check(t, "t", (n, n_out), torch.float32, dev)
    smem = smem_bytes(n, depth, topo)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"topology {tuple(topo)} needs {smem} bytes of shared "
                         f"memory per block; a Hopper block has {_SMEM_LIMIT}")
    lib = _build.build("drift_epoch").lib
    out = torch.empty_like(w)
    params = _DriftParams(
        w=w.data_ptr(), x=x.data_ptr(), t=t.data_ptr(), o_w=out.data_ptr(),
        chains=c, n_rows=n, n_in=n_in, n_hid=n_hid, n_out=n_out, depth=depth,
        tile_rows=tile_rows(n, depth, n_in, n_out), lrate=float(lrate),
    )
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if kind == "register":
            err = lib.ptnn_drift_epoch_reg(ctypes.byref(params), smem, stream)
        else:
            err = lib.ptnn_drift_epoch(ctypes.byref(params), smem, stream)
    if err != 0:
        raise RuntimeError(
            f"drift_epoch launch failed: {_build.error_string(lib, err)}")
    launches += 1
    variant_launches[kind] += 1
    return out


def sgd_epoch(w: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
              topo: Topology, lrate: float, mode: str = "sequential",
              depth: int = 1) -> torch.Tensor:
    """The Langevin drift of every chain: ``depth`` epochs of ``mode``
    ("sequential" and "pallas": the per-row epoch; "batch": the summed
    update). CUDA tensors launch the drift kernel for the per-row epoch;
    CPU tensors run the plain version."""
    if mode == "batch":
        for _ in range(depth):
            w = sgd_epoch_batch(w, x, t, topo, lrate)
        return w
    if mode not in MODES:
        raise ValueError(f"unknown drift mode {mode!r}")
    kinds = {a.device.type for a in (w, x, t)}
    if kinds == {"cpu"}:
        return sgd_epoch_sequential(w, x, t, topo, lrate, depth)
    if kinds == {"cuda"}:
        return _launch_cuda(w, x, t, topo, lrate, depth)
    raise ValueError(f"sgd_epoch needs all tensors on one device type, got "
                     f"{sorted(kinds)}")
