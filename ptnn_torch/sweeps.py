"""Hyperparameter sweeps and dataset grids as one run (port of
``ptnn/sweeps.py``).

ptnn runs a sweep's cells as ``jax.vmap`` over a leading cell axis. Here the
cells sit side by side on the chain axis of one per-step run, cell-major
(``kernel.Grid``): a grid of G cells of ``cfg.num_chains`` chains steps as
one run of G x ``num_chains`` chains, so every step is one drift launch per
drift and one eval-pair launch for the whole grid. A cell's values ride as
data, as ptnn's traced overrides do: its ladder (the step's temperatures),
its swap interval (host ints: its own swap events and even/odd parity;
cells never swap with each other), its Langevin probability and drift rate
(float32, one a chain), and in ``dataset_grid`` / ``classification_grid``
its own rows, padded to the grid's largest set with ptnn's masks
(``sampler.make_grid_dataset``; the kernels take each cell's row and class
counts and its parameter mask).

Each cell draws from its own stream (``sampler.grid_noise``,
``sampler.init_grid``): the stream of the single run of the cell's seed, so
a cell is its own single per-step run. ``seed_sweep`` and
``classification_grid`` give cell k the seed of its row; the others derive
cell k's seed from ``(seed, 4, k)`` (``sampler.seed_of``), where ptnn splits
its key. ``init_state=`` (the whole grid's state) and ``noise_fn=`` (the
per-step noise contract at the grid's chain count) replace them, as
``sample`` takes them: with ptnn's per-cell draws the port replays ptnn's
grid.

No traces are kept: the post-burn-in sums, squared sums and best values of
the train and test metric accumulate on the device, a chunk at a time, in
float32 in step order as ptnn's scan carry does; the host reads them once,
at the end. The run goes in ``cfg.chunk_steps`` chunks and recomputes the
likelihood at the temper switch (``sampler._PerStep``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ptnn_torch import kernel, sampler
from ptnn_torch.config import PTConfig
from ptnn_torch.kernel import ChainState, Dataset
from ptnn_torch.ops import ladder
from ptnn_torch.sampler import envelope_w_mask  # noqa: F401  (ptnn's name)

REGRESSION_MODES: Dict[str, Tuple[float, float]] = {
    # mode -> (langevin_prob, learn_rate): the three Compare_Benchmark
    # proposal families (Res_RW / Res_LG001 / Res_LG01 master files)
    "rw": (0.0, 0.1),
    "lg001": (0.5, 0.01),
    "lg01": (0.5, 0.1),
}


def cell_seeds(seed: int, n: int) -> list:
    """The seeds of ``n`` cells derived from one run seed (where ptnn
    splits ``PRNGKey(seed)``)."""
    return [sampler.seed_of(seed, 4, k) for k in range(n)]


def _grid_cfg(cfg: PTConfig, **kw) -> PTConfig:
    return dataclasses.replace(cfg, record_w=False, record_fx=False,
                               record_thin=1, **kw).validate()


def seed_sweep(cfg: PTConfig, seeds: Sequence[int], train: np.ndarray,
               test: np.ndarray, device: Any = "cuda",
               init_state: Optional[ChainState] = None,
               noise_fn=None) -> Dict[str, np.ndarray]:
    """Independent replications of one config, one cell a seed: the
    run-to-run spread (mean and std over seeds) in one run."""
    cfg = _grid_cfg(cfg)
    temps = ladder.build_temperatures(cfg)
    return _run_grid(cfg, [temps] * len(seeds), [int(s) for s in seeds],
                     train, test, device=device, init_state=init_state,
                     noise_fn=noise_fn)


def maxtemp_sweep(cfg: PTConfig, maxtemps: Sequence[float],
                  train: np.ndarray, test: np.ndarray, seed: int = 0,
                  device: Any = "cuda",
                  init_state: Optional[ChainState] = None,
                  noise_fn=None) -> Dict[str, np.ndarray]:
    """One PT run per maxtemp, each on its own ladder, all in one run."""
    cfg = _grid_cfg(cfg)
    temps = [ladder.build_temperatures(dataclasses.replace(cfg,
                                                           maxtemp=float(m)))
             for m in maxtemps]
    return _run_grid(cfg, temps, cell_seeds(seed, len(maxtemps)), train, test,
                     device=device, init_state=init_state, noise_fn=noise_fn)


def swap_interval_sweep(cfg: PTConfig, intervals: Sequence[int],
                        train: np.ndarray, test: np.ndarray, seed: int = 0,
                        device: Any = "cuda",
                        init_state: Optional[ChainState] = None,
                        noise_fn=None) -> Dict[str, np.ndarray]:
    """The reference's Res_SwapInterval sweep: each cell swaps at its own
    interval (an interval <= 0 or past the run never swaps)."""
    cfg = _grid_cfg(cfg)
    temps = ladder.build_temperatures(cfg)
    n = len(intervals)
    return _run_grid(cfg, [temps] * n, cell_seeds(seed, n), train, test,
                     si_batch=[int(v) for v in intervals], device=device,
                     init_state=init_state, noise_fn=noise_fn)


def lprob_sweep(cfg: PTConfig, lprobs: Sequence[float], train: np.ndarray,
                test: np.ndarray, seed: int = 0, device: Any = "cuda",
                init_state: Optional[ChainState] = None,
                noise_fn=None) -> Dict[str, np.ndarray]:
    """The reference's Langevin-probability sweep: every cell pays the
    drift (the choice is a per-chain threshold), so the l_prob = 0 cell
    costs what l_prob = 1 costs."""
    cfg = _grid_cfg(cfg, use_langevin_gradients=True)
    temps = ladder.build_temperatures(cfg)
    n = len(lprobs)
    return _run_grid(cfg, [temps] * n, cell_seeds(seed, n), train, test,
                     lp_batch=list(lprobs), device=device,
                     init_state=init_state, noise_fn=noise_fn)


def dataset_grid(cfg: PTConfig, names: Sequence[str],
                 modes: Sequence[str] = ("rw", "lg001", "lg01"),
                 seed: int = 0, device: Any = "cuda",
                 init_state: Optional[ChainState] = None,
                 noise_fn=None) -> Dict[str, Any]:
    """BASELINE.json config 4: the regression series x {RW, LG-0.01,
    LG-0.1} in one run. The series are padded to the longest one's rows
    with row masks (a padded row adds nothing to the likelihood, the rmse
    or the drift); the modes ride the per-chain Langevin probability and
    rate, and every cell pays the drift. ``cells``: the (dataset, mode)
    pair of each cell, dataset-major."""
    from ptnn_torch.data import load_regression

    cfg = _grid_cfg(cfg, use_langevin_gradients=True)
    probs = {n: load_regression(n) for n in names}
    cells = [(n, m) for n in names for m in modes]
    data = sampler.make_grid_dataset(
        cfg, [(probs[n].train, probs[n].test, cfg.topology)
              for n, _m in cells], torch.device(device))
    temps = ladder.build_temperatures(cfg)
    out = _run_grid(
        cfg, [temps] * len(cells), cell_seeds(seed, len(cells)), None, None,
        lp_batch=[REGRESSION_MODES[m][0] for _n, m in cells],
        lr_batch=[REGRESSION_MODES[m][1] for _n, m in cells], data=data,
        device=device, init_state=init_state, noise_fn=noise_fn)
    out["cells"] = cells
    return out


def classification_grid(cfg: PTConfig, names: Sequence[str],
                        seeds: Sequence[int] = (0,), device: Any = "cuda",
                        init_state: Optional[ChainState] = None,
                        noise_fn=None) -> Dict[str, Any]:
    """The classification sets (and seeds) of one parity table in one run:
    each cell's network embedded in the topology envelope (the largest
    features, hidden units and classes; ``cfg.topology`` is replaced by
    it), with zero feature columns, the padded classes out of the softmax
    (``class_mask``) and the parameters outside the cell's own network
    pinned at 0 (``envelope_w_mask``). ``cells``: (dataset, seed),
    dataset-major."""
    from ptnn_torch.data import load_classification

    probs = {n: load_classification(n, seed=0) for n in names}
    env = tuple(max(p.topology[k] for p in probs.values()) for k in range(3))
    cfg = _grid_cfg(cfg, topology=env)
    cells = [(n, s) for n in names for s in seeds]
    data = sampler.make_grid_dataset(
        cfg, [(probs[n].train, probs[n].test, probs[n].topology)
              for n, _s in cells], torch.device(device), envelope=True)
    temps = ladder.build_temperatures(cfg)
    out = _run_grid(cfg, [temps] * len(cells), [int(s) for _n, s in cells],
                    None, None, data=data, device=device,
                    init_state=init_state, noise_fn=noise_fn)
    out["cells"] = cells
    return out


class _Accumulator:
    """The post-burn-in statistics of every cell on the device (ptnn's scan
    carry): sums and squared sums of the train and test metric, float32,
    added step by step in step order; the best values; the count of
    values. ``add`` is ``_PerStep.run``'s ``on_chunk``."""

    def __init__(self, cfg: PTConfig, cells: int, device):
        self.reg = cfg.task == "regression"
        self.names = (("rmse_train", "rmse_test") if self.reg
                      else ("acc_train", "acc_test"))
        self.keep_from = int(cfg.samples_per_chain * cfg.burn_in) - 1
        self.cells = cells
        f32 = dict(dtype=torch.float32, device=device)
        self.sum = torch.zeros((2, cells), **f32)
        self.sq = torch.zeros((2, cells), **f32)
        self.best = torch.full((2, cells), np.inf if self.reg else -np.inf,
                               **f32)
        self.count = 0
        self.done = 0

    def add(self, rows: Dict[str, torch.Tensor]) -> None:
        length = rows[self.names[0]].shape[0]
        lo = max(self.keep_from - self.done, 0)
        self.done += length
        if lo >= length:
            return
        v = torch.stack([rows[n][lo:] for n in self.names])  # (2, L, C)
        v = v.reshape(2, v.shape[1], self.cells, -1)
        # each step's cell sum chain after chain, then the running sums step
        # after step, in float32 as ptnn's scan carry rounds them (a
        # cumsum would accumulate in float64 on the CPU)
        x = torch.stack([v, v * v])  # (2 sum | square, 2, L, G, cpc)
        step = x[..., 0]
        for j in range(1, x.shape[-1]):
            step = step + x[..., j]
        run = torch.stack([self.sum, self.sq])
        for k in range(step.shape[2]):
            run = run + step[:, :, k]
        self.sum, self.sq = run[0], run[1]
        best = v.amin((1, 3)) if self.reg else v.amax((1, 3))
        self.best = (torch.minimum if self.reg else torch.maximum)(self.best,
                                                                   best)
        self.count += v.shape[1] * v.shape[3]


def _run_grid(cfg: PTConfig, temps_batch, seeds, train, test,
              si_batch=None, lp_batch=None, lr_batch=None,
              data: Optional[Dataset] = None, device: Any = "cuda",
              init_state: Optional[ChainState] = None,
              noise_fn=None) -> Dict[str, np.ndarray]:
    """The grid's run: the cells of ``temps_batch`` (one ladder a cell)
    and ``seeds`` (one stream a cell) on the chain axis, with the per-cell
    swap intervals ``si_batch``, Langevin probabilities ``lp_batch`` and
    drift rates ``lr_batch`` where given, on the shared rows (``train``,
    ``test``) or a grid's ``data``. Returns ptnn's per-cell arrays."""
    dev = torch.device(device)
    n_cells, cpc = len(seeds), cfg.num_chains
    if data is None:
        data = sampler.make_dataset(cfg, train, test, dev)
    temps_host = np.asarray(temps_batch, np.float32).reshape(-1)
    temps = torch.as_tensor(temps_host, device=dev)

    def per_chain(vals):
        if vals is None:
            return None
        return torch.as_tensor(np.repeat(np.asarray(vals, np.float32), cpc),
                               device=dev)

    grid = kernel.Grid(
        n_cells,
        swap_interval=None if si_batch is None else tuple(si_batch),
        langevin_prob=per_chain(lp_batch), learn_rate=per_chain(lr_batch))
    spec = kernel.default_spec(cfg)
    step_fn = kernel.make_step_fn(cfg, data, temps, spec, grid=grid)
    state = (init_state if init_state is not None
             else sampler.init_grid(cfg, data, seeds, spec))
    if noise_fn is None:
        noise_fn = sampler.grid_noise(seeds, dev,
                                      kernel.step_noise_names(cfg), cpc)
    eng = sampler._PerStep(cfg, dev, data, temps_host, step_fn)
    acc = _Accumulator(cfg, n_cells, dev)
    state = eng.run(state, noise_fn, acc.add)
    sums, sqs, best = (a.cpu().numpy() for a in (acc.sum, acc.sq, acc.best))
    cnt = np.float32(max(acc.count, 1))
    mean = sums / cnt
    std = np.sqrt(np.maximum(sqs / cnt - mean ** 2, np.float32(0.0)))
    n_acc = state.n_accept.cpu().numpy().reshape(n_cells, cpc)
    n_prop = state.n_swap_proposed.cpu().numpy()
    n_swap = state.n_swap_accepted.cpu().numpy()
    return {
        "test_mean": mean[1], "test_std": std[1], "test_best": best[1],
        "train_mean": mean[0], "train_std": std[0], "train_best": best[0],
        "accept_pct": np.mean(n_acc, axis=1) * 100.0 / cfg.samples_per_chain,
        "swap_pct": np.where(n_prop > 0,
                             100.0 * n_swap / np.maximum(n_prop, 1), 0.0),
    }
