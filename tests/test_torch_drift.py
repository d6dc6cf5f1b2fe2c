"""The port's Langevin drift (``ptnn_torch.ops.drift``) against ptnn's.

The plain per-row epoch ``sgd_epoch_sequential`` (what the CUDA kernel
``csrc/drift_epoch.cu`` computes, and what runs on CPU tensors) against
``jax.vmap(ptnn.ops.drift.sgd_epoch_sequential)`` and against ptnn's Pallas
kernel (``pallas_drift.sgd_epoch_sequential_pallas``) in interpret mode, on
the same numpy-seeded weights and rows: (4, 10, 1) regression and
(4, 12, 3) classification at depth 1 and 2, and an epoch over more than
768 rows, which ptnn splits into row blocks and the port runs in one pass.
Tolerance rtol 2e-4, atol 2e-6 (ptnn's own tests/test_pallas_drift.py):
the sums run in another order. ``sgd_epoch_batch`` and ``make_targets``
against ptnn's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptnn.ops import drift as jdrift
from ptnn.ops import pallas_drift
from ptnn_torch.models import fnn
from ptnn_torch.models.api import fnn_spec
from ptnn_torch.ops import drift

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-6


def _inputs(rng, topo, task, c, n, scale=1.0):
    w = (rng.standard_normal((c, fnn.w_size(topo))) * scale).astype(np.float32)
    x = rng.random((n, topo[0])).astype(np.float32)
    if task == "classification":
        y = rng.integers(0, topo[2], n).astype(np.float32)
    else:
        y = rng.random(n).astype(np.float32)
    return w, x, y


def _ptnn_scan(w, x, t, topo, lr, depth):
    for _ in range(depth):
        w = jax.vmap(lambda wi: jdrift.sgd_epoch_sequential(
            wi, x, t, topo, lr))(w)
    return np.asarray(w)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("topo,task", [((4, 10, 1), "regression"),
                                       ((4, 12, 3), "classification")])
def test_sequential_epoch_matches_ptnn(rng, topo, task, depth):
    w, x, y = _inputs(rng, topo, task, c=7, n=17)
    t = jdrift.make_targets(jnp.asarray(y), topo[2], task)
    tt = drift.make_targets(torch.from_numpy(y), topo[2], task)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(t))
    before = drift.launches
    got = drift.sgd_epoch(torch.from_numpy(w), torch.from_numpy(x), tt, topo,
                          0.1, mode="pallas", depth=depth).numpy()
    assert drift.launches == before  # CPU tensors: the plain version
    scan = _ptnn_scan(jnp.asarray(w), jnp.asarray(x), t, topo, 0.1, depth)
    kern = pallas_drift.sgd_epoch_sequential_pallas(
        jnp.asarray(w), jnp.asarray(x), t, topo, 0.1, depth=depth,
        interpret=True)
    np.testing.assert_allclose(got, scan, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=RTOL, atol=ATOL)
    # the epoch moved the weights
    assert np.abs(got - w).max() > 1e-3


def test_epoch_past_the_tpu_row_split_is_one_pass(rng):
    """800 rows: ptnn's kernel runs a 768-row block and a 32-row remainder
    per epoch; the port's epoch is one pass in dataset order."""
    topo = (4, 6, 3)
    w, x, y = _inputs(rng, topo, "classification", c=5, n=800, scale=0.2)
    t = jdrift.make_targets(jnp.asarray(y), 3, "classification")
    for depth in (1, 2):
        got = drift.sgd_epoch_sequential(
            torch.from_numpy(w), torch.from_numpy(x),
            torch.from_numpy(np.array(t)), topo, 0.05, depth=depth).numpy()
        kern = pallas_drift.sgd_epoch_sequential_pallas(
            jnp.asarray(w), jnp.asarray(x), t, topo, 0.05, depth=depth,
            interpret=True)
        np.testing.assert_allclose(got, np.asarray(kern), rtol=RTOL,
                                   atol=ATOL, err_msg=f"depth={depth}")


@pytest.mark.parametrize("topo,task", [((4, 10, 1), "regression"),
                                       ((4, 12, 3), "classification")])
def test_batch_epoch_matches_ptnn(rng, topo, task):
    w, x, y = _inputs(rng, topo, task, c=6, n=23)
    t = jdrift.make_targets(jnp.asarray(y), topo[2], task)
    want = jax.vmap(lambda wi: jdrift.sgd_epoch_batch(
        wi, jnp.asarray(x), t, topo, 0.05))(jnp.asarray(w))
    spec = fnn_spec(topo, "batch")
    got = spec.drift(torch.from_numpy(w), torch.from_numpy(x),
                     torch.from_numpy(np.array(t)), 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_dispatcher_and_kernel_gates():
    w = torch.zeros((3, 61))
    x, t = torch.zeros((5, 4)), torch.zeros((5, 1))
    with pytest.raises(ValueError, match="unknown drift mode"):
        drift.sgd_epoch(w, x, t, (4, 10, 1), 0.1, mode="scan")
    with pytest.raises(ValueError, match="one device type"):
        drift.sgd_epoch(w.to("meta"), x, t, (4, 10, 1), 0.1)
    with pytest.raises(ValueError, match="unknown drift mode"):
        fnn_spec((4, 10, 1), "scan")
    # every dataset of the repo fits one block: PenDigit's 7494 rows stream
    # through 64 KB tiles, Ionosphere's weights (w 1852) x 4 chains fit
    assert drift.tile_rows(7494, 1, 16, 10) == 630
    for topo, n in (((16, 30, 10), 7494), ((34, 50, 2), 245),
                    ((51, 50, 2), 28831), ((4, 10, 1), 298)):
        assert drift.smem_bytes(n, 2, topo) <= drift._SMEM_LIMIT


def test_kernel_layouts_follow_the_source():
    """The register kernel's column of the table (csrc/fnn_layouts.cuh
    FNN_LAYOUTS, read by ``reg_layouts``) covers every bundled network with one lane-group
    size each, under the rules the source states: G a power of two up to 32,
    128 / G chains a block, and the measured pick (one hidden unit a lane,
    or a whole warp for H > 32). Every other topology with at most 32 * HPL
    hidden units goes to the generic kernel, larger ones are refused, and
    only the generic kernel keeps weights in shared memory."""
    from ptnn_torch import data
    from ptnn_torch.ops import _build

    lay = drift.reg_layouts()
    bundled = set(data.CLASSIFICATION_TOPOLOGIES.values()) | {
        data.REGRESSION_TOPOLOGY}
    assert bundled == set(lay)
    assert len(_build.cu_rows("fnn_layouts.cuh", "FNN_LAYOUTS")) == len(
        lay)  # one row a topology
    warps, reg_threads = drift._define("WARPS"), drift._define("REG_THREADS")
    assert warps == _build.cu_define("drift_epoch.cu", "WARPS") == 4
    assert drift._define("HPL") == 4 and reg_threads == 128
    for topo, g in lay.items():
        assert g & (g - 1) == 0 and 1 <= g <= 32
        assert reg_threads % g == 0  # 128 / G chains a block
        assert g == min(32, 1 << (topo[1] - 1).bit_length())
        assert drift.variant(topo) == ("register", g)
        i, _h, o = topo
        assert drift.smem_bytes(300, 1, topo) == 4 * 300 * (i + o)
    for topo in ((5, 20, 3), (3, 128, 1)):
        assert drift.variant(topo) == ("generic", None)
        assert drift.smem_bytes(300, 1, topo) == 4 * (
            300 * (topo[0] + topo[2]) + warps * fnn.w_size(topo))
    with pytest.raises(ValueError, match="at most 128 hidden"):
        drift.variant((3, 129, 1))
    # the CPU path ignores the layout: the plain version, no launch
    w, x, y = _inputs(np.random.default_rng(0), (5, 20, 3), "classification",
                      c=3, n=9)
    t = drift.make_targets(torch.from_numpy(y), 3, "classification")
    before = drift.launches, dict(drift.variant_launches)
    drift.sgd_epoch(torch.from_numpy(w), torch.from_numpy(x), t, (5, 20, 3),
                    0.1)
    assert (drift.launches, drift.variant_launches) == before
