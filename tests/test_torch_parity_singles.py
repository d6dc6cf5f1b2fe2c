"""The parity runners of many single runs on the port
(``python -m ptnn_torch.experiments.parity singles|bands``) against ptnn's
``scripts/parity.py`` and ``scripts/cls_bands.py``, loaded by path and left
as they are.

``run_reg`` and ``run_cls`` against ptnn's, each on ptnn's initial state
and draws (``init_state`` from ``split(PRNGKey(0))[0]``, the steps'
``split(fold_in(k_run, i), 6)``: ``test_torch_step.ptnn_noise_fn``): Sunspot
RW at 200 samples (swaps every 5, ``run_reg``'s ``swap_int``) and LG lr 0.1
at 100 (swaps every 2), iris RW at 1000 (the preset's swaps every 2) and
legacy LG at 500 (swaps every step), PenDigit legacy LG at 20 (2 steps of
the sequential drift over its 7494 train rows). Accept and swap counts exact, ``summarize``'s statistics
within rtol 2e-4, atol 2e-5.

``singles``: the document at one step a run, its headers, prose and row
order those of ptnn's ``main`` (run with its runs replaced by canned
rows), the file written equal to what was printed; a run that raises
leaves the rows before it on disk and the command exits non-zero.
``bands``: the rows of ``cls_bands.band`` (its runs replaced by canned
outputs) equal the port's from the same outputs, the big-set LG route's
reduction included; the ±2σ flag at its edges and at the 1e-9 floor; a
five-run big cell (Cancer) equal to the five-cell ``seed_sweep`` of its
configuration in accepts and swaps.

``python tests/test_torch_parity_singles.py MODE SET SEED...`` runs ptnn's
``seed_sweep`` on the CPU (``JAX_PLATFORMS=cpu``) at ``chip_smoke.py``'s
classification configuration of a single run (``parity.cls_single_cfg`` at
``chip_smoke.PARITY_CLS_SAMPLES``; MODE rw or lg), one call whose cells are
the given seeds, and prints the per-cell statistics as one JSON line: the
source of the smoke's bands.
"""

import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import ptnn
from ptnn import sampler as jsampler
from ptnn import sweeps as jsweeps
from ptnn.data import load_classification, load_regression
from ptnn_torch import convert, sweeps
from ptnn_torch.experiments import parity
from test_torch_step import ptnn_noise_fn

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
ROOT = Path(__file__).resolve().parent.parent
STATS = ("train_mean", "train_std", "train_best", "test_mean", "test_std",
         "test_best")


def _script(name):
    """scripts/NAME.py as a module of its own, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"_ptnn_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ptnn_parity():
    return _script("parity")


@pytest.fixture(scope="module")
def ptnn_bands():
    return _script("cls_bands")


def _ptnn_start(jcfg, prob, seed=0):
    """ptnn's initial state of ``sample(seed=seed)``, converted, and its run
    key."""
    from ptnn import kernel as jkernel

    data = jsampler.make_dataset(jcfg, prob.train, prob.test)
    k_init, k_run = jax.random.split(jax.random.PRNGKey(seed))
    st0 = jkernel.init_state(k_init, jcfg, data)
    np_state = {k: (None if v is None else np.asarray(v))
                for k, v in jax.device_get(st0)._asdict().items()}
    return convert.chain_state_from_numpy(np_state), k_run


def _noise_fn(k_run, rows=128):
    """``ptnn_noise_fn`` drawn ``rows`` steps at a time and cut to the
    chunk: a step's draws depend on its index alone, so a chunk's are the
    first rows of a longer draw, and every chunk of a network reuses one
    compile."""
    draw = ptnn_noise_fn(k_run)

    def noise_fn(start, length, c, w):
        assert length <= rows
        return {k: v[:length] for k, v in draw(start, rows, c, w).items()}

    return noise_fn


RUN_CASES = {
    "sunspot-rw": ("reg", dict(name="Sunspot", lg=False, lr=0.1,
                               samples=200, swap_int=5)),
    "sunspot-lg01": ("reg", dict(name="Sunspot", lg=True, lr=0.1,
                                 samples=100, swap_int=2)),
    "iris-rw": ("cls", dict(name="iris", lg=False, samples=1000)),
    "iris-legacy-lg": ("cls", dict(name="iris", lg=True, samples=500,
                                   legacy=True)),
    "pendigit-legacy-lg": ("cls", dict(name="PenDigit", lg=True, samples=20,
                                       legacy=True)),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_single_run_matches_ptnn_script(case, ptnn_parity):
    kind, kw = RUN_CASES[case]
    want_s, want = getattr(ptnn_parity, "run_" + kind)(**kw)
    prob = (load_regression(kw["name"]) if kind == "reg"
            else load_classification(kw["name"], seed=0))
    init, k_run = _ptnn_start(want.config, prob)
    got_s, got = getattr(parity, "run_" + kind)(
        **kw, device="cpu", init_state=init, noise_fn=_noise_fn(k_run))
    cfg = got.config
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want.config)
    if kind == "cls":
        assert cfg.topology == prob.topology
        assert cfg.drift_mode == "sequential"
    np.testing.assert_array_equal(got.traces["accept_count"],
                                  want.traces["accept_count"])
    assert got.swap_percent == want.swap_percent
    if case != "pendigit-legacy-lg":
        assert 0.0 < got.swap_percent < 100.0
    assert got_s.accept_per == want_s.accept_per
    assert got_s.swap_perc == want_s.swap_perc
    for k in STATS:
        np.testing.assert_allclose(getattr(got_s, k), getattr(want_s, k),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for k in ("problem", "num_samples", "maxtemp", "swap_interval",
              "proposal_col", "learn_rate"):
        assert getattr(got_s, k) == getattr(want_s, k), k
    assert got_s.time_min > 0.0


def _canned_summary(name, i):
    return types.SimpleNamespace(
        test_mean=0.01 * i, test_best=0.001 * i, swap_perc=10.0 + i,
        accept_per=20.0 + i, time_min=0.5, name=name)


def _skeleton(lines):
    """A document's headers and prose as they stand, each row as its first
    cell, the sample budgets and the device left out."""
    out = []
    for line in lines[1:]:
        if line.startswith("Full-budget runs"):
            out.append("intro")
        elif line.startswith("| ") and not line.startswith(
                ("| dataset", "| maxtemp", "| swap interval", "| l_prob")):
            out.append("row " + line.split("|")[1].strip())
        else:
            out.append(re.sub(r"\(\d+ samples", "(N samples", line))
    return out


def test_singles_document_follows_ptnn_script(ptnn_parity, tmp_path,
                                              capsys, monkeypatch):
    """The port's ``singles`` at one step a run against the document of
    ptnn's ``main`` (its runs canned: the rows' layout is the runs'
    business, held above)."""
    calls = []

    def canned(name, *a, **kw):
        calls.append(name)
        return _canned_summary(name, len(calls)), None

    ref_out = tmp_path / "ref.md"
    with mock.patch.object(ptnn_parity, "run_reg", canned), \
            mock.patch.object(ptnn_parity, "run_cls", canned), \
            mock.patch.object(sys, "argv",
                              ["parity.py", "--out", str(ref_out)]):
        ptnn_parity.main()
    ref = ref_out.read_text().splitlines()
    capsys.readouterr()
    monkeypatch.setenv("PTNN_DEVICE", "cpu")
    out = tmp_path / "port.md"
    seen = []
    parity.main(["singles", "--samples-reg", "20", "--samples-cls", "20",
                 "--out", str(out)])
    printed = capsys.readouterr().out
    text = out.read_text()
    assert printed == text
    lines = text.splitlines()
    assert lines[0] == ("# PARITY — ptnn_torch vs reference committed "
                        "baselines")
    assert "(20 regression / 20 classification samples, 10 chains) on the " \
           "CPU." in lines[2]
    assert _skeleton(lines) == _skeleton(ref)
    assert sum(s.startswith("row ") for s in _skeleton(lines)) == 46
    # every row's run, in order, through the hook
    parity.singles(20, 20, ("sweeps",), None, "cpu",
                   on_row=lambda t, k, cfg, s, res: seen.append(
                       (t, k, cfg.maxtemp, cfg.swap_interval,
                        cfg.langevin_prob)))
    assert [s[:2] for s in seen] == (
        [("maxtemp", m) for m in (2, 4, 6, 8, 10)]
        + [("swap-interval", i) for i in (100, 200, 400, 800)]
        + [("lprob", p) for p in (0.1, 0.3, 0.5, 0.8)])
    assert seen[1][2] == 4.0 and seen[5][3] == 100 and seen[-1][4] == 0.8


def test_singles_run_that_raises_exits_nonzero_and_keeps_rows(tmp_path):
    """The third regression run raises: the command exits non-zero, the
    file holds the header and the two rows before it."""
    out = tmp_path / "p.md"
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from ptnn_torch.experiments import parity\n"
        "real, n = parity.run_single, [0]\n"
        "def run(*a, **kw):\n"
        "    n[0] += 1\n"
        "    if n[0] == 3:\n"
        "        raise RuntimeError('the card fell over')\n"
        "    return real(*a, **kw)\n"
        "parity.run_single = run\n"
        "parity.main(['singles', '--samples-reg', '20', '--sections', "
        f"'reg', '--out', {str(out)!r}])\n")
    env = dict(os.environ, PTNN_DEVICE="cpu")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode != 0
    assert "the card fell over" in proc.stderr
    lines = out.read_text().splitlines()
    rows = [ln for ln in lines if ln.startswith(("| Lazer", "| Sunspot",
                                                  "| Mackey"))]
    assert [r.split("|")[1].strip() for r in rows] == ["Lazer", "Sunspot"]
    assert lines[-1].startswith("| Sunspot")
    assert proc.stdout.splitlines()[-1] == lines[-1]


def _canned_grid(rng, n=5):
    return dict(test_mean=rng.uniform(40, 90, n), test_best=rng.uniform(90,
                                                                        100, n),
                swap_pct=rng.uniform(10, 60, n),
                accept_pct=rng.uniform(50, 95, n))


def _canned_run(rng, spc=5000, chains=10):
    acc = rng.uniform(0, 100, (spc, chains))
    n_acc = rng.integers(0, spc, chains)
    return types.SimpleNamespace(
        traces={"acc_test": acc}, swap_percent=float(rng.uniform(0, 100)),
        accept_ratio_per_chain=100.0 * n_acc / spc,
        final_state=types.SimpleNamespace(n_accept=torch.as_tensor(n_acc)))


@pytest.mark.parametrize("name,legacy", [("iris", False), ("chess", False),
                                         ("Ionosphere", True),
                                         ("Cancer", True), ("PenDigit", True)])
def test_band_rows_follow_cls_bands(name, legacy, ptnn_bands, rng):
    """cls_bands.band's row from canned outputs (a seed_sweep's, or five
    single runs' on the big-set LG route) against the port's row of the
    same outputs: equal, the reduction of the five runs included."""
    big = legacy and name in parity.BAND_BIG
    assert big == (legacy and name in ptnn_bands.BIG)
    grid = _canned_grid(rng)
    runs = [_canned_run(rng) for _ in range(5)]
    it = iter(runs)
    with mock.patch.object(ptnn_bands.sweeps, "seed_sweep",
                           lambda *a, **kw: grid), \
            mock.patch.object(ptnn_bands.ptnn, "sample",
                              lambda *a, **kw: next(it)), \
            mock.patch.object(ptnn_bands.time, "time", lambda: 0.0):
        want = ptnn_bands.band(name, legacy)
    prob = load_classification(name, seed=0)
    cfg = parity.band_cfg(name, prob.topology, legacy)
    out = parity.band_runs(runs, cfg) if big else grid
    assert parity.band_row(name, legacy, out, 0.0) == want
    assert cfg.drift_mode == ("pallas" if big else "sequential")
    assert cfg.chunk_steps == (250 if big else 3000)
    assert cfg.topology == prob.topology


def test_band_flag_edges(ptnn_bands, rng):
    """The flag at 2 sigma and at the 1e-9 floor of a sigma of 0, in the
    port's rows and in cls_bands.band's from the same outputs."""
    assert parity.ref_flag(50.0, 49.0, 0.5) == ""
    assert parity.ref_flag(50.0, 51.0, 0.5) == ""
    assert parity.ref_flag(50.0, 51.0 + 1e-6, 0.5) != ""
    assert parity.ref_flag(50.0, 50.0, 0.0) == ""
    assert parity.ref_flag(50.0, 50.0 + 1.5e-9, 0.0) == ""
    assert parity.ref_flag(50.0, 50.0 + 3e-9, 0.0) == " **ref outside ±2σ**"
    ref_m, ref_b = parity.REF_CLS["rw"]["iris"]
    flagged = []
    for shift in (0.0, 1.5e-9, 3e-9, 1.0):
        grid = dict(test_mean=np.full(5, ref_m + shift),
                    test_best=np.full(5, ref_b - shift),
                    swap_pct=np.full(5, 30.0), accept_pct=np.full(5, 90.0))
        with mock.patch.object(ptnn_bands.sweeps, "seed_sweep",
                               lambda *a, **kw: grid), \
                mock.patch.object(ptnn_bands.time, "time", lambda: 0.0):
            want = ptnn_bands.band("iris", False)
        got = parity.band_row("iris", False, grid, 0.0)
        assert got == want
        flagged.append(got.count("**ref outside ±2σ**"))
    assert flagged == [0, 0, 2, 2]


def test_five_run_big_cell_matches_seed_sweep_counts(capsys):
    """``bands --mode lg`` on Cancer: five single runs on the sequential
    drift, each run's accepts and swap % those of its cell of the five-cell
    ``seed_sweep`` of the same configuration."""
    samples = 10 * 50
    cells = []
    lines = parity.bands(["Cancer"], "lg", samples, device="cpu",
                         on_cell=lambda n, c, w: cells.append(c))
    assert capsys.readouterr().out.splitlines() == lines
    assert lines[1] == ("| dataset | test acc mean ours±σ / ref | max "
                        "ours±σ / ref | swap% | accept% | wall min |")
    assert lines[3].startswith("| Cancer | ")
    prob = load_classification("Cancer", seed=0)
    cfg = parity.band_cfg("Cancer", prob.topology, True, samples)
    assert cfg.swap_interval == 1 and cfg.drift_mode == "pallas"
    grid = sweeps.seed_sweep(cfg, list(parity.BAND_SEEDS), prob.train,
                             prob.test, device="cpu")
    (cell,) = cells
    spc, chains = cfg.samples_per_chain, cfg.num_chains
    got = np.rint(grid["accept_pct"] * spc * chains / 100.0).astype(int)
    np.testing.assert_array_equal(cell["accepts"], got)
    np.testing.assert_array_equal(cell["swap_pct"], grid["swap_pct"])
    assert (cell["swap_pct"] > 0).all()



def band_run(mode, name, seeds):
    """ptnn's ``seed_sweep`` at chip_smoke.py's configuration of a
    classification single run: the per-cell statistics."""
    import time

    import chip_smoke

    prob = load_classification(name, seed=0)
    cfg = parity.cls_single_cfg(name, prob.topology, mode == "lg",
                                samples=chip_smoke.PARITY_CLS_SAMPLES,
                                legacy=mode == "lg")
    jcfg = ptnn.PTConfig(**dataclasses.asdict(cfg)).validate()
    t0 = time.time()
    out = jsweeps.seed_sweep(jcfg, list(seeds), prob.train, prob.test)
    return {"mode": mode, "set": name, "cells": list(seeds),
            "wall_s": time.time() - t0,
            **{k: np.asarray(out[k]).tolist()
               for k in ("test_mean", "accept_pct", "swap_pct")}}


if __name__ == "__main__":
    print(json.dumps(band_run(sys.argv[1], sys.argv[2],
                              [int(s) for s in sys.argv[3:]])), flush=True)
