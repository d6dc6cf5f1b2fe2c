"""The port's chain-batched FNN eval (``ptnn_torch.ops.fnn_eval``) against
ptnn's Pallas eval kernel (``pallas_eval.fnn_eval_pallas``, interpret mode)
and against ``ptnn.ops.likelihood`` (the per-step sampler's XLA eval), on
the same numpy-seeded weights and rows, at chain counts that are not a
multiple of 128.

ll is held to rtol 2e-5 of the size of its cancelling terms (regression:
``n/2 |log 2 pi tau|`` + ``SSE / (2 tau)``; classification: its own size),
atol 1e-4. Regression rmse within rtol 1e-5. Classification rmse and acc
are exact functions of the first argmax: equal, bit for bit, on every chain
with no row whose argmax a 1e-5 move of the logits flips
(``block_step.argmax_fragile``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptnn.ops import likelihood as jlik
from ptnn.ops import pallas_eval
from ptnn_torch.data import load_classification
from ptnn_torch.models import fnn
from ptnn_torch.ops import block_step, fnn_eval

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("c", [5, 13])
def test_regression_eval_matches_ptnn(rng, c):
    topo = (4, 10, 1)
    n = 29
    w = rng.standard_normal((c, fnn.w_size(topo))).astype(np.float32)
    x = rng.random((n, 4)).astype(np.float32)
    y = rng.random(n).astype(np.float32)
    tau = (rng.random(c) * 0.2 + 0.01).astype(np.float32)
    before = fnn_eval.launches
    ll, rmse, acc = fnn_eval.fnn_eval(_t(w), _t(x), _t(y), _t(tau), topo,
                                      "regression")
    assert fnn_eval.launches == before
    k_ll, k_rmse, _ = pallas_eval.fnn_eval_pallas(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(y).reshape(-1, 1), jnp.asarray(tau), topo, "regression",
        interpret=True)
    ref = jax.jit(jax.vmap(jlik.regression_eval,
                           in_axes=(0, None, None, 0, None)),
                  static_argnums=4)(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(y), jnp.asarray(tau),
        topo)
    sse = np.asarray(ref.rmse, np.float64) ** 2 * n
    terms = 0.5 * n * np.abs(np.log(2 * np.pi * tau)) + 0.5 * sse / tau
    for want_ll, want_rmse in ((k_ll, k_rmse), (ref.loglik, ref.rmse)):
        assert np.all(np.abs(ll.numpy() - np.asarray(want_ll))
                      <= 1e-4 + 2e-5 * terms)
        np.testing.assert_allclose(rmse.numpy(), np.asarray(want_rmse),
                                   rtol=1e-5, atol=1e-7)
    assert not acc.any()


@pytest.mark.parametrize("c", [6, 13])
def test_classification_eval_matches_ptnn(rng, c):
    prob = load_classification("iris")
    topo = (4, 12, 3)
    w = rng.standard_normal((c, fnn.w_size(topo))).astype(np.float32)
    for rows in (prob.train, prob.test):
        x = rows[:, :4].astype(np.float32)
        y = rows[:, 4].astype(np.float32)
        ll, rmse, acc = fnn_eval.fnn_eval(_t(w), _t(x), _t(y), None, topo,
                                          "classification")
        t = jax.nn.one_hot(jnp.asarray(y, jnp.int32), 3)
        k_ll, k_rmse, k_acc = pallas_eval.fnn_eval_pallas(
            jnp.asarray(w), jnp.asarray(x), jnp.asarray(y), t,
            jnp.ones((c,), jnp.float32), topo, "classification",
            interpret=True)
        # jitted, as in the sampler: XLA folds the means into products
        ref = jax.jit(jax.vmap(jlik.classification_eval,
                               in_axes=(0, None, None, None)),
                      static_argnums=3)(
            jnp.asarray(w), jnp.asarray(x), jnp.asarray(y), topo)
        sure = ~block_step.argmax_fragile(_t(w), _t(x), topo).numpy()
        assert sure.sum() >= c - 1
        for want in ((k_ll, k_rmse, k_acc), (ref.loglik, ref.rmse, ref.acc)):
            want_ll = np.asarray(want[0])
            assert np.all(np.abs(ll.numpy() - want_ll)
                          <= 1e-4 + 2e-5 * np.abs(want_ll))
        # the XLA eval's metrics: bit for bit (the folded 1/n constants);
        # the Pallas kernel divides, within a float rounding of them
        np.testing.assert_array_equal(rmse.numpy()[sure],
                                      np.asarray(ref.rmse)[sure])
        np.testing.assert_array_equal(acc.numpy()[sure],
                                      np.asarray(ref.acc)[sure])
        np.testing.assert_allclose(rmse.numpy()[sure],
                                   np.asarray(k_rmse)[sure], rtol=1e-6)
        np.testing.assert_allclose(acc.numpy()[sure],
                                   np.asarray(k_acc)[sure], rtol=1e-6)
        assert 0.0 < acc.max() <= 100.0


def test_eval_gates():
    w, x, y = torch.zeros((3, 61)), torch.zeros((5, 4)), torch.zeros(5)
    with pytest.raises(ValueError, match="unknown task"):
        fnn_eval.fnn_eval(w, x, y, None, (4, 10, 1), "ranking")
    with pytest.raises(ValueError, match="one device type"):
        fnn_eval.fnn_eval(w.to("meta"), x, y, torch.ones(3), (4, 10, 1),
                          "regression")
    with pytest.raises(ValueError, match="one device type"):
        fnn_eval.fnn_eval_pair(w, x, y, x.to("meta"), y, torch.ones(3),
                               (4, 10, 1), "regression")
    # the kernel's shared memory: weights, a 32-row tile at stride 33 with
    # its targets, two parities of the 10 warps' output shares, the sums
    plan = fnn_eval.launch_plan(10, (245, 109), (34, 50, 2))
    assert (plan.row_groups, plan.hid_groups) == (1, 10)
    assert plan.smem == 4 * (1852 + 34 * 33 + 32 + 2 * 10 * 2 * 32 + 4 + 4)


# the pair on two row sets: (topology, task, chains, train rows, test rows)
PAIR_CASES = [((4, 10, 1), "regression", 13, 37, 23),
              ((34, 50, 2), "classification", 6, 45, 19),
              ((4, 12, 3), "classification", 7, 105, 45)]


@pytest.mark.parametrize("topo,task,c,n_tr,n_te", PAIR_CASES)
def test_eval_pair_matches_ptnn_on_both_row_sets(rng, topo, task, c, n_tr,
                                                  n_te):
    """The pair's plain version against ptnn's Pallas eval (interpret mode)
    called once for the train rows and once for the test rows, to this
    file's tolerances; the pair launches nothing on the CPU."""
    w = (rng.standard_normal((c, fnn.w_size(topo))) * 0.5).astype(np.float32)
    tau = (rng.random(c) * 0.2 + 0.01).astype(np.float32)
    sets = []
    for n in (n_tr, n_te):
        x = rng.standard_normal((n, topo[0])).astype(np.float32)
        if task == "regression":
            y = rng.random(n).astype(np.float32)
        else:
            y = rng.integers(0, topo[2], n).astype(np.float32)
        sets.append((x, y))
    before = fnn_eval.launches
    got = fnn_eval.fnn_eval_pair(_t(w), _t(sets[0][0]), _t(sets[0][1]),
                                 _t(sets[1][0]), _t(sets[1][1]), _t(tau),
                                 topo, task)
    assert fnn_eval.launches == before
    for (ll, rmse, acc), (x, y) in zip(got, sets):
        targets = (jnp.asarray(y).reshape(-1, 1) if task == "regression" else
                   jax.nn.one_hot(jnp.asarray(y, jnp.int32), topo[2]))
        k_ll, k_rmse, k_acc = (np.asarray(a) for a in
                               pallas_eval.fnn_eval_pallas(
                                   jnp.asarray(w), jnp.asarray(x),
                                   jnp.asarray(y), targets, jnp.asarray(tau),
                                   topo, task, interpret=True))
        if task == "regression":
            n = x.shape[0]
            sse = k_rmse.astype(np.float64) ** 2 * n
            terms = 0.5 * n * np.abs(np.log(2 * np.pi * tau)) + 0.5 * sse / tau
            np.testing.assert_allclose(rmse.numpy(), k_rmse, rtol=1e-5,
                                       atol=1e-7)
            assert not acc.any()
        else:
            terms = np.abs(k_ll)
            sure = ~block_step.argmax_fragile(_t(w), _t(x), topo).numpy()
            assert sure.sum() >= c - 1
            np.testing.assert_allclose(rmse.numpy()[sure], k_rmse[sure],
                                       rtol=1e-6)
            np.testing.assert_allclose(acc.numpy()[sure], k_acc[sure],
                                       rtol=1e-6)
        assert np.all(np.abs(ll.numpy() - k_ll) <= 1e-4 + 2e-5 * terms)
        # and the single-set entry on the same rows gives the same bits
        one = fnn_eval.fnn_eval(_t(w), _t(x), _t(y), _t(tau), topo, task)
        for a, b in zip((ll, rmse, acc), one):
            assert torch.equal(a, b)


# (chains, row sets, topology) at the bundled sizes: Sunspot's pair,
# Ionosphere's pair and its train rows alone, iris's pair, PenDigit's train
# rows, a one-row set, and a network without a compile-time layout
PLAN_CASES = [(64, (298, 198), (4, 10, 1)), (10, (245, 109), (34, 50, 2)),
              (10, (245,), (34, 50, 2)), (64, (105, 45), (4, 12, 3)),
              (10, (7494,), (16, 30, 10)), (3, (1,), (4, 10, 1)),
              (1024, (1, 40), (4, 12, 3)), (5, (77, 300), (7, 40, 4))]


@pytest.mark.parametrize("chains,n_rows,topo", PLAN_CASES)
def test_launch_plan_covers_every_row_once(chains, n_rows, topo):
    """Every (chain, set) has one cluster of T <= 8 blocks; the blocks' row
    tiles [rank R, (rank + 1) R) cover every row of each set exactly once;
    the warps cover every hidden unit; shared memory fits a Hopper block."""
    plan = fnn_eval.launch_plan(chains, n_rows, topo)
    assert 1 <= plan.cluster <= 8
    assert plan.blocks == chains * len(n_rows) * plan.cluster
    assert len(plan.tile_rows) == len(n_rows)
    for n, tile in zip(n_rows, plan.tile_rows):
        hits = np.zeros(n, dtype=int)
        for rank in range(plan.cluster):
            lo = min(n, rank * tile)
            hits[lo:min(n, lo + tile)] += 1
        np.testing.assert_array_equal(hits, np.ones(n, dtype=int))
    # at least one pass of 32 rows for each block of the largest set
    assert plan.cluster == min(8, -(-max(n_rows) // 32))
    # a bundled network's units a warp from FNN_LAYOUTS, else the generic 4
    assert plan.hid_per_warp == fnn_eval.layouts().get(tuple(topo), 4)
    hg, rg, hpw = plan.hid_groups, plan.row_groups, plan.hid_per_warp
    # the warps a block: MAX_WARPS, GEN_WARPS for the generic instantiation
    from ptnn_torch.ops import _build

    cap = (16 if tuple(topo) in fnn_eval.layouts()
           else _build.cu_define("fnn_eval.cu", "GEN_WARPS"))
    assert hg * hpw >= topo[1] and (hg - 1) * hpw < topo[1]  # every unit
    assert rg * hg <= cap
    # one pass over a block's largest tile, where the warps allow it
    assert rg * 32 >= max(plan.tile_rows) or (rg + 1) * hg > cap
    assert plan.smem <= block_step._SMEM_LIMIT
    assert plan.smem == 4 * fnn_eval.smem_floats(topo, rg, hg)


def test_eval_layouts_cover_the_bundled_networks():
    """Every network the repository bundles has a compile-time eval layout
    (the HPW column of csrc/fnn_layouts.cuh FNN_LAYOUTS, one row a
    network), whose warps a row group stay within MAX_WARPS; a row set must
    be non-empty and there are one or two."""
    from ptnn_torch import data
    from ptnn_torch.ops import _build

    bundled = set(data.CLASSIFICATION_TOPOLOGIES.values()) | {
        data.REGRESSION_TOPOLOGY}
    lay = fnn_eval.layouts()
    assert set(lay) == bundled
    assert len(_build.cu_rows("fnn_layouts.cuh", "FNN_LAYOUTS")) == len(lay)
    for (_i, h, _o), hpw in lay.items():
        assert 1 <= hpw and -(-h // hpw) <= fnn_eval._MAX_WARPS
    with pytest.raises(ValueError, match="non-empty"):
        fnn_eval.launch_plan(4, (0,), (4, 10, 1))
    with pytest.raises(ValueError, match="non-empty"):
        fnn_eval.launch_plan(4, (5, 5, 5), (4, 10, 1))


# the wide networks (ROADMAP Queue 3, F1): (chains, row sets, topology, the
# plan's route: weights in device memory, inputs a tile, outputs a chunk)
WIDE_PLANS = [(64, (298, 198), (4, 200, 1), (False, 4, 1)),
              (64, (1000, 200), (784, 16, 10), (False, 784, 10)),
              (16, (300, 100), (16, 20, 40), (False, 16, 32)),
              (8, (200, 50), (784, 80, 10), (True, 784, 10)),
              (4, (100, 40), (3000, 8, 3), (True, 1740, 3))]


@pytest.mark.parametrize("chains,n_rows,topo,route", WIDE_PLANS)
def test_launch_plan_fits_any_width(chains, n_rows, topo, route):
    """``launch_plan`` lays out any width: fewer row groups where the rows
    do not fit beside the weights, the weights read from device memory
    where they do not fit even so, the inputs staged a tile at a time
    where one row group's rows do not fit either, and outputs past 32 in
    chunks of 32. Every row, hidden unit, input and output is covered once
    and the block fits a Hopper block's shared memory."""
    plan = fnn_eval.launch_plan(chains, n_rows, topo)
    assert (plan.w_global, plan.in_tile, plan.out_chunk) == route
    n_in, n_hid, n_out = topo
    for n, tile in zip(n_rows, plan.tile_rows):
        hits = np.zeros(n, dtype=int)
        for rank in range(plan.cluster):
            lo = min(n, rank * tile)
            hits[lo:min(n, lo + tile)] += 1
        np.testing.assert_array_equal(hits, np.ones(n, dtype=int))
    hg, hpw = plan.hid_groups, plan.hid_per_warp
    from ptnn_torch.ops import _build

    gen_warps = _build.cu_define("fnn_eval.cu", "GEN_WARPS")
    # the warps loop over chunks of hg * hpw units where they cannot take
    # them all at once
    assert hg * hpw >= n_hid or hg == gen_warps
    assert plan.row_groups * hg <= gen_warps
    for what, size, chunk in (("inputs", n_in, plan.in_tile),
                              ("outputs", n_out, plan.out_chunk)):
        k = -(-size // chunk)
        assert 1 <= chunk <= size and (k - 1) * chunk < size <= k * chunk, \
            what
    assert plan.out_chunk <= fnn_eval._MAX_OUT
    # the dynamic share leaves the kernel's static one its room
    assert plan.smem <= block_step._SMEM_LIMIT - fnn_eval._STATIC_SMEM
    assert plan.smem == 4 * fnn_eval.smem_floats(
        topo, plan.row_groups, hg, not plan.w_global, plan.in_tile,
        plan.out_chunk)


def test_forty_class_eval_matches_ptnn(rng):
    """A 40-class network (the eval's outputs past one chunk of 32 on the
    card): the plain eval against ptnn's XLA eval, ll on its size, rmse
    and acc exact outside fragile argmaxes."""
    topo = (16, 20, 40)
    c = 5
    w = (rng.standard_normal((c, fnn.w_size(topo))) * 0.5).astype(np.float32)
    x = rng.random((60, 16)).astype(np.float32)
    y = rng.integers(0, 40, 60).astype(np.float32)
    ll, rmse, acc = fnn_eval.fnn_eval(_t(w), _t(x), _t(y), None, topo,
                                      "classification")
    ref = jax.jit(jax.vmap(jlik.classification_eval,
                           in_axes=(0, None, None, None)),
                  static_argnums=3)(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(y), topo)
    want = np.asarray(ref.loglik)
    assert np.all(np.abs(ll.numpy() - want) <= 1e-4 + 2e-5 * np.abs(want))
    sure = ~block_step.argmax_fragile(_t(w), _t(x), topo).numpy()
    assert sure.sum() >= c - 1
    np.testing.assert_array_equal(acc.numpy()[sure],
                                  np.asarray(ref.acc)[sure])
    np.testing.assert_array_equal(rmse.numpy()[sure],
                                  np.asarray(ref.rmse)[sure])
