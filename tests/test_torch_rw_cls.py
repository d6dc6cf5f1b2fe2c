"""The classification RW block on every topology the JAX package fuses.

The port's fused sampler on the CPU (the plain block version) against
``ptnn.fused.sample_fused`` (the Pallas kernel in interpret mode) on the
full Cancer and TicTac data, 40 steps from ptnn's initial state on ptnn's
own noise (``test_torch_fused_driver._run_both``): accept counts, replicas,
swaps and acc traces exact, every other float within rtol 2e-4, atol 2e-5,
ll on its own size. Also, in pure Python: which of the ten bundled
classification sets the port's fused sampler runs, the launch plan of
csrc/rw_cls_block.cu's fixed-shape kernel and the shared memory of both of
its kernels.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import ptnn_torch
from ptnn.data import load_classification
from ptnn_torch import data as tdata
from ptnn_torch import fused as tfused
from ptnn_torch.models import fnn
from ptnn_torch.ops import block_step
from test_torch_fused_driver import ATOL, RTOL, _assert_runs_match, _cls_kw, \
    _run_both


@pytest.mark.parametrize("name", ["Cancer", "TicTac"])
def test_cls_rw_sample_fused_matches_ptnn(name):
    prob = load_classification(name)
    kw = _cls_kw(topology=prob.topology, step_w=0.05)
    got, ref = _run_both(kw, seed=4, prob=prob)
    w = fnn.w_size(prob.topology)
    assert got.traces["w"].shape == (got.config.samples_per_chain, 2, w)
    _assert_runs_match(got, ref, RTOL, ATOL, (), ll_terms=0.0)
    acc = got.accept_ratio_per_chain
    assert acc.min() < 100.0 and acc.max() > 0.0


# the port's fused dispatch at the classification RW preset's 10 chains:
# None (fused) or the shared-memory reason; a fixed-shape or the generic
# kernel
DISPATCH = {
    "iris": "fixed",
    "Ionosphere": "fixed",  # whatever record_w is (unlike ptnn's gate)
    "Cancer": "fixed",
    "TicTac": "fixed",
    # their argmax ties: block_step.RW_CLS_UNHELD
    "winequality-red": "not held",
    "abalone": "not held",
    "bank-additional": "shared memory",
    "PenDigit": "shared memory",
    "chess": "shared memory",
    "winequality-white": "shared memory",
}


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_rw_dispatch_of_the_bundled_classification_sets(name):
    topo = tdata.CLASSIFICATION_TOPOLOGIES[name]
    prob = tdata.load_classification(name)
    n_tr, n_te = prob.train.shape[0], prob.test.shape[0]
    base = dataclasses.replace(ptnn_torch.classification_preset(topo, 50_000),
                               fused_step=True).validate()
    assert base.num_chains == 10
    want = DISPATCH[name]
    for record_w in (False, True):
        cfg = dataclasses.replace(base, record_w=record_w).validate()
        reason = tfused.runtime_reason(cfg, n_tr, n_te)
        if want == "shared memory":
            assert "shared memory" in reason
        elif want == "not held":
            assert "not held against its plain version" in reason
        else:
            assert reason is None
            assert block_step.cls_variant(topo) == want
    # MALA and HMC keep their kernels' one topology
    for proposal in ("precond_mala", "hmc"):
        reason = tfused.runtime_reason(
            dataclasses.replace(base, proposal=proposal).validate(), n_tr,
            n_te)
        if name == "iris":
            assert reason is None
        elif name in ("Cancer", "TicTac"):
            assert "built for" in reason
        else:
            assert reason is not None


def test_rw_cls_fixed_tables():
    """The fixed-shape networks are the four that ptnn fuses on the bundled
    sets; the warps a chain are read from the same source."""
    assert block_step.cls_fixed_topologies() == (
        (4, 12, 3), (9, 12, 2), (9, 25, 2), (34, 50, 2))
    assert block_step.cls_warps() == (4, 8, 16)
    assert block_step.cls_variant((4, 12, 3)) == "fixed"
    assert block_step.cls_variant([34, 50, 2]) == "fixed"
    for topo in ((4, 7, 3), (11, 50, 10), (8, 30, 29), (4, 12, 2)):
        assert block_step.cls_variant(topo) == "generic"


@pytest.mark.parametrize("chains, rows, sms, warps", [
    (10, 150, 132, 8),     # iris: no thread runs a second row
    (10, 699, 132, 16),    # Cancer: the most built
    (10, 958, 132, 16),    # TicTac
    (10, 354, 132, 16),    # Ionosphere
    (10, 128, 132, 4),     # four warps cover 128 rows
    (132, 150, 132, 8),    # one wave exactly
    (133, 150, 132, 4),    # beyond one wave: the fewest
    (1000, 958, 132, 4),
    (1024, 150, 132, 4),
])
def test_rw_cls_launch_plan(chains, rows, sms, warps):
    plan = block_step.rw_cls_launch_plan(chains, rows, sms)
    assert (plan.warps, plan.blocks) == (warps, chains)
    assert f"{warps} warps" in plan.why


@pytest.mark.parametrize("topo, rows, kind, warps, floats", [
    # rows padded to 4, a slot of (I + 1 + O) x round4(H) + 4, NW x 8
    ((4, 12, 3), 150, "fixed", 8, 752 + (8 * 12 + 4) + 64),
    ((34, 50, 2), 354, "fixed", 16, 12392 + (37 * 52 + 4) + 128),
    ((9, 25, 2), 958, "fixed", 4, 9580 + (12 * 28 + 4) + 32),
    # rows, 3 W, 8 x 4 partials, (H + O) x 128 scratch
    ((11, 50, 10), 1599, "generic", 0, 19188 + 3 * 1110 + 32 + 60 * 128),
    ((4, 12, 3), 150, "generic", 0, 750 + 3 * 99 + 32 + 15 * 128),
])
def test_cls_smem_bytes(topo, rows, kind, warps, floats):
    assert block_step.cls_smem_bytes(rows, topo, kind, warps) == 4 * floats


def test_working_set_takes_the_larger_kernel():
    cfg = dataclasses.replace(
        ptnn_torch.classification_preset((8, 30, 29), 50_000),
        fused_step=True).validate()
    need = block_step.cls_smem_bytes(4177, (8, 30, 29), "generic")
    assert need > max(block_step.cls_smem_bytes(4177, (8, 30, 29), "fixed", w)
                      for w in block_step.cls_warps())
    assert need <= block_step._SMEM_LIMIT
    assert tfused.working_set_reason(cfg, 2923, 1254) is None
    # a few more rows than the generic kernel's shared memory takes
    extra = (block_step._SMEM_LIMIT - need) // (4 * 9) + 1
    assert "shared memory" in tfused.working_set_reason(cfg, 2923 + extra,
                                                        1254)


def test_ptxas_report_reads_spills_and_the_stack_frame():
    """chip_smoke.py's build phase fails on a stack frame of the RW
    classification kernels, which local memory without spills also has."""
    from ptnn_torch.ops import _build

    log = """ptxas info    : Compiling entry function '_Z3fooi' for 'sm_90a'
ptxas info    : Function properties for _Z3fooi
    256 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 256 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z3bari' for 'sm_90a'
ptxas info    : Function properties for _Z3bari
    16 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
"""
    assert _build.ptxas_report(log) == [
        _build.PtxasEntry("_Z3fooi", 128, 0, 0, 256),
        _build.PtxasEntry("_Z3bari", 255, 12, 16, 16)]


def _block(name, topo, c, length=90, seed=9):
    """One adapting RW block of K = 100 steps on all rows of the bundled set
    ``name`` at N(0, 1) weights, as the CUDA tests feed the kernel (their
    inputs on the CPU), by the plain version with diagnostics and the
    w trace: ``(args, (new_state, traces))``."""
    from test_torch_cuda_kernels import _cls_inputs

    step = 0.005 if name == "Ionosphere" else 0.025
    state, noise, start, _k, data, at, scal, cfg = _cls_inputs(
        "cpu", c, "reference", k=100, seed=seed, name=name, topo=topo,
        step_w=step, adapt_step_size=True)
    scal = dict(scal, adapt=True, burn_end=60)
    args = (state, noise["w"], None, noise["u"], start, length, data, at,
            tuple(cfg.topology), scal)
    return args, block_step.rw_block_reference(*args, record_w=True,
                                               diagnostics=True)


def _witness_args(args):
    state, noise_w, _eta, u, start, length, data, at, topo, scal = args
    return state, noise_w, u, start, length, data, at, topo, scal


@pytest.mark.parametrize("name, topo", [("Cancer", None),
                                        ("iris", (4, 7, 3))])
def test_rw_cls_comparison_helpers_catch_a_wrong_kernel(name, topo):
    """The comparison's float64 witness and its check at the kernel's own
    weights (``block_step.rw_cls_witness``, ``rw_cls_own_weights``) pass
    the plain version held against itself, and flag a kernel that takes
    another decision or carries another accuracy."""
    args, plain = _block(name, topo, 12)
    state, data, topo = args[0], args[6], args[8]
    apart, off, _run = block_step.rw_cls_witness(*_witness_args(args),
                                                 plain, plain, 1e-5)
    assert not bool(off.any()) and int(apart.sum()) <= 1
    bad, fragile, drift = block_step.rw_cls_own_weights(state, plain, plain,
                                                        data, topo)
    assert bad == 0 and not bool(drift.any())
    assert fragile.shape == (101, 12)
    new, tr = plain
    # a chain that accepted in the block and has no fragile argmax
    moved = (new["n_accept"] > state["n_accept"]) & ~fragile[-1]
    chain = int(torch.nonzero(moved)[0])
    wrong_new = dict(new, acc_test=new["acc_test"].clone())
    wrong_new["acc_test"][chain] += 1.0
    bad, _f, _d = block_step.rw_cls_own_weights(state, (wrong_new, tr),
                                                plain, data, topo)
    assert bad == 1
    # versions whose decisions all differ from the float64 run's: every
    # chain decides apart, and the kernel is flagged wherever the float64
    # run's margin exceeds the one given
    shifted = (new, dict(tr, accept_count=tr["accept_count"] + 1))
    apart, off, _run = block_step.rw_cls_witness(*_witness_args(args),
                                                 shifted, shifted, 0.0)
    assert bool(apart.all()) and bool(off.all())
    _apart, off, _run = block_step.rw_cls_witness(*_witness_args(args),
                                                  shifted, shifted, math.inf)
    assert not bool(off.any())


def test_abalone_argmax_ties_exceed_the_comparisons_share():
    """Why abalone's RW configs run per-step (``block_step.RW_CLS_UNHELD``):
    on its 4177 rows the plain float32 version's own proposals have a
    fragile first argmax (two of its 29 sigmoid outputs that a 1e-5 logit
    move reorders, ``block_step.argmax_fragile``) in more than the 1 % of
    trace entries that the kernel comparison may leave unchecked, whatever
    the kernel. winequality-red's 10 outputs on 1599 rows stay under it
    here, in the plain version alone; with the entries fragile at the
    kernel's own weights its comparison on the card reaches the 1 %, so it
    runs per-step too."""
    share = {}
    for name in ("abalone", "winequality-red"):
        _args, (_new, tr) = _block(name, None, 10)
        share[name] = float(tr["argmax_fragile"][:90].float().mean())
    assert share["abalone"] > 0.01 > share["winequality-red"], share
    assert block_step.RW_CLS_UNHELD == tuple(
        tdata.CLASSIFICATION_TOPOLOGIES[n] for n in ("winequality-red",
                                                     "abalone"))


def rw_preset_reference(name: str, seed: int = 0) -> dict:
    """ptnn's per-step sampler on the classification RW preset of the bundled
    set ``name`` (``classification_preset(topology, 50_000)``: 10 chains x
    5000, swap every 100; record_w off), on the CPU: the statistics that
    ``chip_smoke.py``'s bands for the preset are set around. ``test_mean``
    is ``scripts/cls_grid.py``'s (``ptnn.sweeps.seed_sweep``): acc_test
    over every chain from row ``samples * burn_in - 1`` on."""
    import ptnn

    prob = load_classification(name)
    cfg = dataclasses.replace(
        ptnn.classification_preset(prob.topology, num_samples=50_000),
        record_w=False).validate()
    res = ptnn.sample(cfg, prob.train, prob.test, seed=seed)
    first = int(cfg.samples_per_chain * cfg.burn_in) - 1
    return dict(test_mean=float(np.mean(res.traces["acc_test"][first:, :])),
                mean_accept=float(np.mean(res.accept_ratio_per_chain)),
                swap=float(res.swap_percent), seconds=res.elapsed_s)


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_rw_cls.py NAME
    # [seed ...]
    import sys

    name = sys.argv[1] if len(sys.argv) > 1 else "TicTac"
    for seed in [int(a) for a in sys.argv[2:]] or [0]:
        print(name, seed, rw_preset_reference(name, seed), flush=True)
