"""Posterior-predictive serving: load a finished run, predict on new inputs
(port of ``ptnn/predict.py``).

* ``load_posterior(run_dir)`` reads the ``posterior/pos_w`` artifacts and
  the run's ``config.json`` back into a ``(draws, w_size)`` matrix: the cold
  chain (every ladder's) by default, burn-in dropped, optional thinning;
* ``prior_draws(cfg, n)`` draws weights from the prior N(0, sigma_sq I) for
  prior-predictive checks, from an explicit ``torch.Generator``;
* ``posterior_predict(cfg, draws, x)`` evaluates the network for every
  posterior weight draw at once, the draw axis a batch axis, in chunks of
  ``batch`` draws, and reduces. Classification: ``probs`` (N, K), the
  posterior-mean class probabilities (softmax over the sigmoid outputs),
  ``label`` (N,) their first argmax and ``entropy`` (N,) in nats: the
  served predictor the iris quality gate (96.76 %) reads. Regression:
  ``mean`` (N,) and the percentile band ``low`` / ``high`` and ``std`` of
  the network outputs across draws (the epistemic band) or, with
  ``noise="conditional"``, of the full predictive (tau^2 drawn per weight
  draw from its conditional InvGamma posterior given ``cond``, the training
  rows, and observation noise added), with the ``(M, N)`` predictive draws
  under ``return_samples``;
* ``python -m ptnn_torch.predict --run DIR --problem NAME`` is the command
  line: it serves the problem's test (or train) split, or a file of feature
  rows (``--x``), and scores the posterior with ``--calibrate``
  (``ops.calibrate``) and ``--ic`` (``ops.ic``: WAIC, PSIS-LOO, test lppd).

``spec=`` serves draws of a model of the zoo (``models.cnn.digits_spec()``,
``models.mlp.spec(...)``): a run sampled with ``model_spec=`` passes the same
spec here, as in ptnn.

Plain PyTorch on ``device`` ("cuda" unless the caller asks for the CPU; the
command line reads ``PTNN_DEVICE``): ptnn computes this in XLA, outside any
Pallas kernel. The random draws come from a ``torch.Generator`` seeded with
``seed``, so they agree with ptnn's NumPy draws in distribution, not value.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ptnn_torch.config import PTConfig, from_json_dict
from ptnn_torch.models.api import ModelSpec
from ptnn_torch.ops.precision import full_float32


def load_posterior(
    run_dir: str,
    chains: str = "cold",
    burn_in: Optional[float] = None,
    thin: int = 1,
) -> Tuple[np.ndarray, Optional[PTConfig]]:
    """Read ``<run_dir>/posterior/pos_w`` back into ``(draws, w_size)``.

    ``chains``: "cold" (every file at the lowest temperature: one per
    ladder, pooled) or "all" (every rung). Burn-in defaults to the run
    config's fraction (0.5 without a ``config.json``); row 0 (the init row
    of ones) is always dropped."""
    cfg = None
    cfg_path = os.path.join(run_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = from_json_dict(json.load(f))
    pos_dir = os.path.join(run_dir, "posterior", "pos_w")
    if not os.path.isdir(pos_dir):
        raise FileNotFoundError(
            f"{pos_dir} not found: the run must be written with record_w=True"
        )

    def temp_of(f: str) -> float:
        # chain_<T>.txt, or chain_<T>_l<r>.txt under replicated ladders
        return float(f[len("chain_"):-len(".txt")].split("_l")[0])

    files = sorted((temp_of(f), f) for f in os.listdir(pos_dir)
                   if f.startswith("chain_") and f.endswith(".txt"))
    if not files:
        raise FileNotFoundError(f"no chain_<T>.txt traces under {pos_dir}")
    if chains == "cold":
        files = [fc for fc in files if fc[0] == files[0][0]]
    elif chains != "all":
        raise ValueError("chains must be 'cold' or 'all'")
    b = burn_in if burn_in is not None else (cfg.burn_in if cfg else 0.5)
    draws = []
    for _, fname in files:
        w = np.atleast_2d(np.loadtxt(os.path.join(pos_dir, fname)))
        start = max(int(w.shape[0] * b), 1)  # always drop the init row
        draws.append(w[start::max(thin, 1)])
    return np.concatenate(draws, axis=0), cfg


def prior_draws(cfg: PTConfig, n: int, seed: int = 0,
                spec: Optional[ModelSpec] = None,
                device: Any = "cuda") -> np.ndarray:
    """``(n, w_size)`` float32 weight draws from the prior N(0, sigma_sq I)
    (ops/likelihood.py), for prior-predictive checks, from a
    ``torch.Generator`` on ``device`` seeded with ``seed``. The regression
    tau^2 prior is improper at the reference defaults (nu_1 = nu_2 = 0), so
    prior-predictive bands are epistemic-only unless the config sets a
    proper InvGamma."""
    from ptnn_torch import kernel

    spec = spec if spec is not None else kernel.default_spec(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    w = torch.randn((n, spec.w_size), generator=gen, dtype=torch.float64,
                    device=device) * np.sqrt(cfg.sigma_sq)
    return w.to(torch.float32).cpu().numpy()


def _outputs(cfg: PTConfig, spec: ModelSpec, draws: np.ndarray,
             x: np.ndarray, batch: int, device) -> torch.Tensor:
    """Class probabilities (M, N, K) or network outputs (M, N) of every
    draw on ``device``."""
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    outs = []
    with torch.no_grad(), full_float32():
        for i in range(0, draws.shape[0], max(batch, 1)):
            out = spec.forward(torch.as_tensor(draws[i:i + batch],
                                               device=device), xt)
            outs.append(torch.exp(spec.log_probs(out))
                        if cfg.task == "classification" else out[..., 0])
    return torch.cat(outs)


def posterior_predict(
    cfg: PTConfig,
    draws: np.ndarray,
    x: np.ndarray,
    lo: float = 5.0,
    hi: float = 95.0,
    batch: int = 512,
    device: Any = "cuda",
    spec: Optional[ModelSpec] = None,
    noise: Optional[str] = None,
    cond: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    seed: int = 0,
    return_samples: bool = False,
) -> Dict[str, np.ndarray]:
    """Posterior-predictive summary on inputs ``x`` (N, I) from weight
    ``draws`` (M, w_size) of the reference FNN of ``cfg.topology``, or of
    ``spec``; NumPy arrays out, as ptnn's. ``noise="conditional"``
    (regression) needs ``cond=(x_train, y_train)``; ``seed`` seeds its
    draws."""
    from ptnn_torch import kernel

    spec = spec if spec is not None else kernel.default_spec(cfg)
    draws = np.ascontiguousarray(draws, np.float32)
    if draws.ndim != 2 or draws.shape[1] != spec.w_size:
        raise ValueError(
            f"draws must be (M, {spec.w_size}) for "
            f"{spec.name}; got {draws.shape}")
    out = _outputs(cfg, spec, draws, x, batch, device)
    if cfg.task == "classification":
        probs = out.mean(dim=0)
        ent = -torch.sum(probs * torch.log(torch.clamp(probs, min=1e-12)),
                         dim=-1)
        probs_np = probs.cpu().numpy()
        return {"probs": probs_np, "label": probs_np.argmax(axis=-1),
                "entropy": ent.cpu().numpy()}
    y_rep = out
    if noise == "conditional":
        if cond is None:
            raise ValueError(
                "noise='conditional' needs cond=(x_train, y_train): the data "
                "the sampler conditioned tau^2 on")
        fc = _outputs(cfg, spec, draws, cond[0], batch, device).double()
        yc = torch.as_tensor(np.asarray(cond[1], np.float64), device=device)
        a = cfg.nu_1 + 0.5 * yc.shape[0]
        b = cfg.nu_2 + 0.5 * torch.sum(torch.square(yc[None, :] - fc), dim=1)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        # tau^2 ~ InvGamma(a, b)  <=>  tau^2 = b / Gamma(a, 1)
        gamma = torch._standard_gamma(torch.full_like(b, a), generator=gen)
        tau = torch.sqrt(b / gamma).to(torch.float32)
        y_rep = out + tau[:, None] * torch.randn(
            out.shape, generator=gen, dtype=out.dtype, device=out.device)
    elif noise is not None:
        raise ValueError("noise must be None or 'conditional'")
    q = torch.tensor([lo / 100.0, hi / 100.0], dtype=out.dtype,
                     device=out.device)
    band = torch.quantile(y_rep, q, dim=0)
    res = {"mean": out.mean(dim=0).cpu().numpy(),
           "low": band[0].cpu().numpy(), "high": band[1].cpu().numpy(),
           "std": y_rep.std(dim=0, correction=0).cpu().numpy()}
    if return_samples:
        res["samples"] = y_rep.cpu().numpy()
    return res


def x_cols(cfg: PTConfig) -> int:
    """Feature-column count of a raw data row for this config's topology."""
    return cfg.topology[0]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Serve posterior predictions from a finished run's "
        "artifacts")
    p.add_argument("--run", required=True,
                   help="artifact dir (e.g. results/regression/Sunspot_0)")
    p.add_argument("--problem",
                   help="bundled dataset name (for --split inputs)")
    p.add_argument("--split", choices=("train", "test"), default="test")
    p.add_argument("--x", help="file of raw feature rows (np.loadtxt) "
                   "instead of --problem")
    p.add_argument("--chains", choices=("cold", "all"), default="cold")
    p.add_argument("--thin", type=int, default=1)
    p.add_argument("--out", help="write predictions (np.savetxt) here")
    p.add_argument(
        "--prior", type=int, default=0, metavar="N",
        help="serve N draws from the PRIOR instead of the run's posterior "
        "(prior-predictive checks; the run dir still supplies the "
        "architecture via config.json)",
    )
    p.add_argument(
        "--calibrate", action="store_true",
        help="score the posterior as a distributional forecast on the "
        "chosen split: full-predictive band coverage + CRPS (regression) "
        "or ECE + Brier (classification) - ops/calibrate.py",
    )
    p.add_argument(
        "--ic", action="store_true",
        help="report WAIC + PSIS-LOO on the training split (and the test-"
        "set log predictive density) from the loaded draws - ops/ic.py",
    )
    return p


def main(argv=None) -> None:
    """The command line of ``ptnn/predict.py`` (its flags and its lines),
    on ``PTNN_DEVICE`` (default "cuda")."""
    from ptnn_torch.data import load

    args = build_parser().parse_args(argv)
    device = os.environ.get("PTNN_DEVICE", "cuda")
    if args.prior:
        # prior-predictive mode: the run dir supplies only the architecture
        cfg_path = os.path.join(args.run, "config.json")
        if not os.path.exists(cfg_path):
            raise SystemExit("--prior needs a run dir with config.json")
        with open(cfg_path) as f:
            cfg = from_json_dict(json.load(f))
        draws = prior_draws(cfg, args.prior, device=device)
    else:
        draws, cfg = load_posterior(args.run, chains=args.chains,
                                    thin=args.thin)
    if cfg is None:
        raise SystemExit(
            "run has no config.json: call "
            "ptnn_torch.predict.posterior_predict with an explicit PTConfig")
    nx = x_cols(cfg)
    if args.x:
        x = np.atleast_2d(np.loadtxt(args.x))
        y = None
    else:
        if not args.problem:
            raise SystemExit("pass --problem (bundled dataset) or --x FILE")
        prob = load(args.problem)
        data = prob.train if args.split == "train" else prob.test
        # [features..., label]: one label column (class index or target)
        x, y = data[:, :nx], data[:, nx]
    pred = posterior_predict(cfg, draws, x, device=device)
    if cfg.task == "regression":
        line = (
            f"{draws.shape[0]} draws -> {x.shape[0]} inputs: "
            f"predictive mean in [{pred['mean'].min():.4f}, "
            f"{pred['mean'].max():.4f}], mean band width "
            f"{np.mean(pred['high'] - pred['low']):.4f}"
        )
        if y is not None:
            rmse = float(np.sqrt(np.mean((pred["mean"] - y) ** 2)))
            line += f", RMSE(mean) {rmse:.4f}"
        cols = np.stack(
            [pred["mean"], pred["low"], pred["high"], pred["std"]], axis=1)
    else:
        line = (
            f"{draws.shape[0]} draws -> {x.shape[0]} inputs: "
            f"mean predictive entropy {pred['entropy'].mean():.4f} nats"
        )
        if y is not None:
            acc = float(np.mean(pred["label"] == y.astype(np.int64)))
            line += f", accuracy(mean probs) {acc * 100:.2f}%"
        cols = np.concatenate(
            [pred["label"][:, None], pred["entropy"][:, None], pred["probs"]],
            axis=1)
    print(line)
    if args.calibrate:
        if y is None:
            raise SystemExit("--calibrate needs targets (use --problem)")
        from ptnn_torch.ops import calibrate

        if cfg.task == "regression":
            full = posterior_predict(
                cfg, draws, x, device=device, noise="conditional",
                cond=(prob.train[:, :nx], prob.train[:, nx]),
                return_samples=True)
            cov_e = calibrate.coverage(y, pred["low"], pred["high"])
            cov_f = calibrate.coverage(y, full["low"], full["high"])
            cr = calibrate.crps(full["samples"], y)
            print(
                f"calibration ({args.split}): 5-95 band coverage "
                f"{cov_f * 100:.1f}% (target 90; epistemic-only band: "
                f"{cov_e * 100:.1f}%), CRPS {cr['mean']:.4f}, "
                f"mean full-band width "
                f"{np.mean(full['high'] - full['low']):.4f}"
            )
            pv = calibrate.ppc(full["samples"], y)
            print("posterior-predictive checks (p~0.5 healthy): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in pv.items()))
        else:
            yl = y.astype(np.int64)
            e = calibrate.ece(pred["probs"], yl)
            br = calibrate.brier(pred["probs"], yl)
            print(f"calibration ({args.split}): ECE {e['ece']:.4f}, "
                  f"Brier {br:.4f} over {yl.shape[0]} rows")
    if args.ic:
        if not args.problem:
            raise SystemExit("--ic needs --problem (train/test splits)")
        from ptnn_torch.ops import ic

        prob = load(args.problem)
        x_tr, y_tr = prob.train[:, :nx], prob.train[:, nx]
        x_te, y_te = prob.test[:, :nx], prob.test[:, nx]
        ll_tr = ic.pointwise_log_lik(cfg, draws, x_tr, y_tr, device=device)
        w, lo = ic.waic(ll_tr), ic.psis_loo(ll_tr)
        bad = int(np.sum(lo["pareto_k"] > 0.7))
        print(f"WAIC: elpd {w['elpd_waic']:.2f} (se {w['se']:.2f}), "
              f"p_waic {w['p_waic']:.2f}")
        print(f"PSIS-LOO: elpd {lo['elpd_loo']:.2f} (se {lo['se']:.2f}), "
              f"p_loo {lo['p_loo']:.2f}, "
              f"{bad}/{len(lo['pareto_k'])} points with Pareto k > 0.7")
        ll_te = ic.pointwise_log_lik(cfg, draws, x_te, y_te,
                                     cond=(x_tr, y_tr), device=device)
        lppd_te = ic.waic(ll_te)["lppd"]
        print(f"test lppd: {lppd_te:.2f} over {x_te.shape[0]} rows "
              f"({lppd_te / x_te.shape[0]:.4f}/row)")
    if args.out:
        np.savetxt(args.out, cols, fmt="%1.6f")
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
