"""One-call auto-configured parallel tempering (port of ``ptnn/auto.py``):
``ptnn_torch.auto.auto_sample``.

The reference makes its user pick about ten coupled hyperparameters by hand
(chain count, maxtemp, swap interval, proposal, step sizes, budget). This
module decides them from the framework's own measurements:

1. **Pilot -> communication barrier.** A short replicated-ladder
   preconditioned-MALA pilot measures the per-pair expected swap rejection;
   ``tuning.tune_ladder`` re-spaces the rungs at equal barrier increments
   (Syed et al. 2021).
2. **Barrier -> ladder size.** ``tuning.suggest_num_chains`` turns the
   barrier into the rung count; the pilot's profile is interpolated onto it
   (``ops.ladder.barrier_tuned_temperatures(n_out=...)``).
3. **Chain budget -> replicated ensemble.** The rest of the budget becomes
   R independent tuned ladders (``PTConfig.n_ladders``), R cold chains
   whose ESS adds.
4. **Objective -> proposal.** ``target="quality"`` picks ChEES-adapted HMC,
   ``target="speed"`` preconditioned MALA; both take the fused CUDA block
   kernels when the port's fused gate admits the config
   (``fused.runtime_reason``, recorded in ``decisions["execution"]``).
5. **Replication gate.** The final run is S independently seeded runs;
   the report carries the cross-seed function-space split-R-hat of the cold
   posterior, pooled cold ESS/s and the replicas' round-trip rate (None
   when no replica was tracked).

Every decision lands in ``AutoReport.decisions`` with the measurement that
drove it. Every entry point runs on ``device`` (default "cuda"; the command
line reads ``PTNN_DEVICE``).

CLI: ``python -m ptnn_torch.auto Sunspot --target quality --out DIR``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ptnn_torch import tuning
from ptnn_torch.config import PTConfig
from ptnn_torch.ops import ess as ess_mod
from ptnn_torch.ops import ladder as ladder_mod
from ptnn_torch.ops import roundtrip as rt_mod


@dataclasses.dataclass
class AutoReport:
    """Everything ``auto_sample`` decided and measured."""

    config: PTConfig  # the production config actually run
    tune: tuning.TuneResult  # the pilot's history
    decisions: Dict[str, str]  # choice -> the measurement behind it
    # the cross-seed function-space R-hat of the cold posterior (None when
    # replicate < 2 or the posterior trace was skipped); a model spec's
    # forward for the zoo
    rhat_cold_max: Optional[float]
    verdict: str  # "mixed" | "marginal" | "metastable" | ...
    test_pooled_mean: float  # every chain after burn-in, mean over seeds
    test_pooled_std: float
    test_cold_mean: float  # the cold rungs only, over seeds
    test_cold_std: float
    chain_steps_per_sec: float  # median over seeds
    # ESS of the R pooled cold chains x the per-chain draw rate; None when
    # the posterior trace was skipped
    pooled_cold_ess_per_sec: Optional[float]
    ess_draws: int  # post-burn-in draws behind the ESS (per seed)
    # replica transport, mean over seeds; None when no replica was tracked
    roundtrips_per_kstep: Optional[float]
    swap_percent: float
    accept_percent: float
    elapsed_s: float  # sampling wall (pilot excluded)
    seeds: Tuple[int, ...]
    per_seed_cold: Tuple[float, ...]  # cold test metric per seed
    # serving scores from the last seed's pooled cold draws (None when the
    # trace was skipped or a model spec is in play)
    elpd_loo: Optional[float] = None
    loo_bad_k_frac: Optional[float] = None
    coverage_90: Optional[float] = None
    crps: Optional[float] = None
    ece: Optional[float] = None
    brier: Optional[float] = None

    def describe(self) -> str:
        cfg = self.config
        is_reg = cfg.task == "regression"
        metric = "test RMSE" if is_reg else "test acc %"
        trips = ("transport: round trips not tracked"
                 if self.roundtrips_per_kstep is None else
                 f"transport: {self.roundtrips_per_kstep:.1f} round trips/1k"
                 " steps")
        lines = [
            f"auto-configured PT: {cfg.num_chains} chains = "
            f"{cfg.n_ladders} ladder(s) x {cfg.rungs_per_ladder} rungs, "
            f"proposal={cfg.proposal}"
            + (" +ChEES" if cfg.hmc_adapt_traj else "")
            + (", fused blocks" if cfg.fused_step else ""),
            f"  cold {metric}: {self.test_cold_mean:.4f} "
            f"+- {self.test_cold_std:.4f} over {len(self.seeds)} seeds "
            f"(pooled: {self.test_pooled_mean:.4f})",
            (f"  cross-seed split-R-hat {self.rhat_cold_max:.3f} "
             f"({self.verdict})"
             + (" — point estimates replicable, weight-space posterior "
                "not mixed at this budget; the per-seed bands above are "
                "the honest uncertainty" if self.verdict == "metastable"
                else ""))
            if self.rhat_cold_max is not None
            else "  (single seed or no posterior trace: no replication "
                 "gate)",
            f"  {self.chain_steps_per_sec:,.0f} chain-steps/s"
            + (f", {self.pooled_cold_ess_per_sec:,.0f} pooled cold ESS/s "
               f"({self.ess_draws} draws x {cfg.n_ladders} cold chains)"
               if self.pooled_cold_ess_per_sec is not None
               else " (posterior trace skipped: see decisions)"),
            f"  {trips}, swap {self.swap_percent:.1f}%, accept "
            f"{self.accept_percent:.1f}%",
        ]
        if self.elpd_loo is not None:
            score = (f"  predictive score: elpd_loo {self.elpd_loo:.1f} "
                     f"(Pareto k>0.7 on {self.loo_bad_k_frac * 100:.0f}% of "
                     "points)")
            if self.coverage_90 is not None:
                score += (f", 5-95 band coverage {self.coverage_90 * 100:.1f}"
                          f"%, CRPS {self.crps:.4f}")
            if self.ece is not None:
                score += f", ECE {self.ece:.3f}, Brier {self.brier:.3f}"
            lines.append(score)
        lines.append("  decisions:")
        lines += [f"    {k}: {v}" for k, v in self.decisions.items()]
        return "\n".join(lines)


def infer_topology(train: np.ndarray, test: np.ndarray, task: str,
                   hidden: Optional[int]) -> Tuple[int, int, int]:
    """(n_in, hidden, n_out) from the reference row format ``[features...,
    label]``; ``hidden`` defaults to max(10, n_in)."""
    n_in = train.shape[1] - 1
    if n_in < 1:
        raise ValueError("need at least one feature column + a label column")
    if task == "regression":
        n_out = 1
    else:
        labels = np.concatenate([train[:, n_in], test[:, n_in]])
        if not np.allclose(labels, np.round(labels)):
            raise ValueError("classification labels must be integral")
        n_out = int(np.max(labels)) + 1
        if n_out < 2:
            raise ValueError("classification needs at least 2 classes")
    return (n_in, hidden if hidden is not None else max(10, n_in), n_out)


def _flagship_knobs(cfg: PTConfig, proposal: str, chees: bool) -> PTConfig:
    """The flagship sampler settings (bench.py's mala / chees16_16x4): DEO
    swaps every 10 steps under the Metropolis rule on untempered payloads,
    the Welford preconditioner, the normalized-gradient warm start."""
    extra = {}
    if proposal == "hmc":
        extra = dict(hmc_leapfrog=16 if chees else 8, hmc_adapt_traj=chees,
                     step_w=0.01)
    return dataclasses.replace(
        cfg, proposal=proposal, adapt_rate=0.1, swap_style="even_odd",
        swap_interval=10, swap_rule="metropolis", swap_payload="untempered",
        warmstart_frac=0.1, precond_start_frac=0.3, **extra)


def execution_reason(cfg: PTConfig, n_tr: int, n_te: int,
                     model_spec=None) -> Optional[str]:
    """Why ``cfg`` would not run fused (None: it takes the fused blocks):
    the port's fused gate, ``fused.runtime_reason`` (``fused_reason``,
    ``working_set_reason``, ``topology_reason``), for the reference FNN."""
    from ptnn_torch import fused

    if model_spec is not None:
        return "fused_step supports the reference FNN spec"
    try:  # validate() refuses statically unsupported fused configs
        cfg_f = dataclasses.replace(cfg, fused_step=True).validate()
    except ValueError as e:
        return str(e)
    return fused.runtime_reason(cfg_f, n_tr, n_te)


def auto_config(
    train: np.ndarray,
    test: np.ndarray,
    task: str,
    *,
    hidden: Optional[int] = None,
    chain_budget: int = 64,
    steps_per_chain: int = 8000,
    target: str = "quality",
    maxtemp: Optional[float] = None,
    pilot_steps_per_chain: int = 2000,
    tune_rounds: int = 2,
    seed: int = 0,
    mesh=None,
    model_spec=None,
    device: Any = "cuda",
) -> Tuple[PTConfig, tuning.TuneResult, Dict[str, str]]:
    """Measure, then decide: the production config, the pilot's history
    and the decision trail; the pilot runs on ``device``."""
    if task not in ("regression", "classification"):
        raise ValueError("task must be 'regression' or 'classification'")
    if target not in ("quality", "speed"):
        raise ValueError("target must be 'quality' or 'speed'")
    if chain_budget < 4:
        raise ValueError("auto needs a chain budget of at least 4")
    if mesh is not None:
        raise NotImplementedError("auto(mesh=...): the port runs on one "
                                  "device (ROADMAP Queue 1 item 14)")
    decisions: Dict[str, str] = {}
    topology = infer_topology(train, test, task, hidden)
    decisions["topology"] = (
        f"{topology} (n_in/n_out from data columns; hidden "
        + ("user-specified)" if hidden is not None else "= max(10, n_in))"))
    if model_spec is not None:
        decisions["topology"] = (
            f"model_spec '{model_spec.name}' ({model_spec.w_size} params); "
            f"data columns {topology[0]}/{topology[2]}")
    mt = maxtemp if maxtemp is not None else (
        5.0 if task == "regression" else 10.0)
    decisions["maxtemp"] = (
        f"{mt} (user-specified endpoint)" if maxtemp is not None
        else f"{mt} (reference sweep convention for {task}; interior rungs "
        "are re-spaced by the measured barrier anyway)")

    # the pilot: K0 rungs, the rest of the budget as replicas, each
    # measuring the same (K0 - 1)-pair profile
    k0 = min(8, chain_budget)
    r0 = max(1, chain_budget // k0)
    pilot = _flagship_knobs(
        PTConfig(task=task, topology=topology,
                 num_samples=k0 * r0 * pilot_steps_per_chain,
                 num_chains=k0 * r0, n_ladders=r0, maxtemp=mt, swap_offset=0,
                 record_w=False),
        proposal="precond_mala", chees=False).validate()
    tune = tuning.tune_ladder(pilot, train, test, rounds=tune_rounds,
                              seeds=(seed,), model_spec=model_spec,
                              device=device)
    decisions["pilot"] = (
        f"{r0} x {k0}-rung ladders, {pilot_steps_per_chain} steps/chain, "
        f"{tune_rounds} feedback round(s); measured barrier "
        f"Lambda = {tune.barrier:.3f}")

    k_star = int(np.clip(tune.suggested_num_chains, 2, chain_budget))
    n_ladders = max(1, chain_budget // k_star)
    num_chains = n_ladders * k_star
    last = tune.history[-1]
    tuned = ladder_mod.barrier_tuned_temperatures(
        last.temperatures, last.pair_reject, n_out=k_star)
    decisions["ladder"] = (
        f"{k_star} rungs/ladder (barrier {tune.barrier:.3f} / 0.5 target "
        f"rejection per link, Syed et al. 2021), re-spaced at equal "
        f"barrier increments from the pilot profile")
    decisions["ensemble"] = (
        f"{n_ladders} independent ladder(s) = {num_chains} chains from the "
        f"budget of {chain_budget} (R cold chains' ESS adds)")

    chees = target == "quality" and n_ladders >= 2
    proposal = "hmc" if target == "quality" else "precond_mala"
    decisions["proposal"] = (
        "ChEES-adapted HMC (the quality flagship: no trajectory length to "
        "choose)" if chees
        else ("preconditioned HMC, fixed L=8 (quality target but <2 "
              "replicas: ChEES needs cross-replica expectations)"
              if proposal == "hmc"
              else "preconditioned MALA (the ESS/s flagship)"))

    # the posterior trace: (steps, R cold, w_size) float32 on the host,
    # skipped past 256 MiB
    w_size = (model_spec.w_size if model_spec is not None
              else int(np.prod(topology[:2]) + topology[1] * topology[2]
                       + topology[1] + topology[2]))
    w_bytes = 4 * w_size * n_ladders * steps_per_chain
    record_w = w_bytes <= 256 * 2**20
    decisions["posterior_trace"] = (
        f"cold-rung pos_w recorded ({w_bytes / 2**20:.0f} MiB host fetch)"
        if record_w
        else (f"SKIPPED: {w_size} params x {n_ladders} cold chains x "
              f"{steps_per_chain} steps = {w_bytes / 2**20:.0f} MiB exceeds "
              "the 256 MiB fetch budget; ESS/R-hat unavailable (scalar "
              "metrics only). Shorten steps_per_chain or reduce ladders to "
              "re-enable."))

    cfg = _flagship_knobs(
        PTConfig(
            task=task, topology=topology,
            num_samples=num_chains * steps_per_chain, num_chains=num_chains,
            n_ladders=n_ladders, maxtemp=mt,
            custom_ladder=tuple(float(t) for t in tuned), swap_offset=0,
            # canonical PT: the tuned profile assumes the rungs keep their
            # temperatures all run
            pt_phase_frac=2.0, record_w=record_w,
            record_w_chains=n_ladders if record_w else 0,
            track_replicas=True),
        proposal=proposal, chees=chees).validate()

    reason = execution_reason(cfg, train.shape[0], test.shape[0], model_spec)
    if reason is None:
        cfg = dataclasses.replace(cfg, fused_step=True).validate()
        decisions["execution"] = (
            "fused CUDA blocks (one kernel launch per DEO interval)")
    else:
        decisions["execution"] = f"per-step sampler ({reason})"
    return cfg, tune, decisions


def auto_sample(
    train: np.ndarray,
    test: np.ndarray,
    task: str,
    *,
    replicate: int = 3,
    seed: int = 0,
    mesh=None,
    model_spec=None,
    out: Optional[str] = None,
    name: str = "auto",
    escalate: int = 0,
    device: Any = "cuda",
    **config_kw,
) -> AutoReport:
    """``auto_config``, then ``replicate`` independently seeded runs of the
    config; the report of quality, effective-sample economics, transport
    and the cross-seed gate. ``out`` also writes ``auto_report.txt`` and
    the last seed's artifact tree (``python -m ptnn_torch.predict --run
    <out>/<name>_0`` serves it). ``escalate=K``: while the function-space
    R-hat fails 1.01, double the step budget (``record_thin`` with it, so
    the trace rows stay flat; ``track_replicas`` off) up to K times; a
    still-failing gate reads ``budget-capped``. Round trips come from the
    base-budget runs, None when none tracked its replicas."""
    from ptnn_torch import results as results_mod
    from ptnn_torch import sampler as sampler_mod

    cfg, tune, decisions = auto_config(
        train, test, task, seed=seed, mesh=mesh, model_spec=model_spec,
        device=device, **config_kw)
    is_reg = task == "regression"
    key = "rmse_test" if is_reg else "acc_test"
    seeds = tuple(range(seed, seed + max(1, replicate)))

    def _replications(cfg):
        cold_idx = np.arange(0, cfg.num_chains, cfg.rungs_per_ladder)
        colds, pooled, cold_m, sps, trips = [], [], [], [], []
        swap_pct, acc_pct, elapsed = [], [], 0.0
        res = None
        for s in seeds:
            res = sampler_mod.sample(cfg, train, test, seed=s, device=device,
                                     model_spec=model_spec)
            # burn-in from the RECORDED rows (record_thin strides them)
            b = int(res.traces[key].shape[0] * cfg.burn_in)
            if cfg.record_w:
                colds.append(np.asarray(res.traces["w"][b:, :, :]))
            pooled.append(float(np.mean(res.traces[key][b:, :])))
            cold_m.append(float(np.mean(res.traces[key][b:, cold_idx])))
            sps.append(res.chain_steps_per_sec)
            if cfg.track_replicas:
                trips.append(rt_mod.roundtrip_stats(
                    res.traces["replica"],
                    n_ladders=cfg.n_ladders).rate_per_kstep)
            swap_pct.append(res.swap_percent)
            acc_pct.append(float(np.mean(res.accept_ratio_per_chain)))
            elapsed += res.elapsed_s
        return dict(colds=colds, pooled=pooled, cold_m=cold_m, sps=sps,
                    trips=trips, swap_pct=swap_pct, acc_pct=acc_pct,
                    elapsed=elapsed, res=res)

    def _gate(colds, cfg):
        # function-space and pooled: every recorded cold draw's predictions
        # at 16 test inputs, R-hat across seeds
        return ess_mod.function_space_rhat(colds, test, cfg, spec=model_spec,
                                           device=device)

    m = _replications(cfg)
    rhat = None
    if m["colds"] and len(seeds) >= 2:
        rhat = _gate(m["colds"], cfg)
    base_trips = list(m["trips"])
    attempts = 0
    capped = False
    while rhat is not None and rhat >= 1.01 and attempts < max(0, escalate):
        attempts += 1
        new_cfg = dataclasses.replace(
            cfg, num_samples=cfg.num_samples * 2,
            record_thin=cfg.record_thin * 2, track_replicas=False).validate()
        decisions[f"escalation_{attempts}"] = (
            f"fn-space R-hat {rhat:.3f} >= 1.01 at {cfg.samples_per_chain} "
            f"steps/chain -> doubling to {new_cfg.samples_per_chain} "
            f"(record_thin={new_cfg.record_thin} keeps trace rows and the "
            "host fetch flat)")
        cfg = new_cfg
        m = _replications(cfg)
        rhat = _gate(m["colds"], cfg) if m["colds"] else None
    if rhat is not None and rhat >= 1.01 and escalate > 0:
        capped = True
    colds, pooled, cold_m = m["colds"], m["pooled"], m["cold_m"]
    sps, swap_pct, acc_pct = m["sps"], m["swap_pct"], m["acc_pct"]
    trips = base_trips if base_trips else m["trips"]
    elapsed, res = m["elapsed"], m["res"]

    sps_med = float(np.median(sps))
    ess_s = None
    draws = 0
    verdict = "unreplicated"
    if colds:
        ess = float(np.median([ess_mod.pooled_multi_ess(c, max_params=16)
                               for c in colds]))
        draws = colds[0].shape[0]
        ess_s = (ess / (draws * cfg.record_thin)) * (sps_med / cfg.num_chains)
        if len(seeds) >= 2:
            verdict = ("mixed" if rhat < 1.01
                       else ("marginal" if rhat < 1.1 else "metastable"))
            if capped:
                verdict += (f" (budget-capped: gate still failing after "
                            f"{attempts} escalation(s) to "
                            f"{cfg.samples_per_chain} steps/chain)")
            elif attempts:
                verdict += f" (after {attempts} budget escalation(s))"
    elif len(seeds) >= 2:
        verdict = "unavailable (posterior trace skipped)"

    elpd = badk = cov = crps_v = ece_v = brier_v = None
    if colds and model_spec is None:
        from ptnn_torch import predict as predict_mod
        from ptnn_torch.ops import calibrate as cal_mod
        from ptnn_torch.ops import ic as ic_mod

        nx = cfg.topology[0]
        x_tr, y_tr = train[:, :nx], train[:, nx]
        x_te, y_te = test[:, :nx], test[:, nx]
        dr = colds[-1].reshape(-1, colds[-1].shape[-1])
        dr = dr[::max(dr.shape[0] // 1000, 1)]
        lo = ic_mod.psis_loo(ic_mod.pointwise_log_lik(cfg, dr, x_tr, y_tr,
                                                      device=device))
        elpd = float(lo["elpd_loo"])
        badk = float(np.mean(lo["pareto_k"] > 0.7))
        if is_reg:
            full = predict_mod.posterior_predict(
                cfg, dr, x_te, noise="conditional", cond=(x_tr, y_tr),
                return_samples=True, device=device)
            cov = cal_mod.coverage(y_te, full["low"], full["high"])
            crps_v = cal_mod.crps(full["samples"], y_te)["mean"]
        else:
            pr = predict_mod.posterior_predict(cfg, dr, x_te, device=device)
            yl = y_te.astype(np.int64)
            ece_v = cal_mod.ece(pr["probs"], yl)["ece"]
            brier_v = cal_mod.brier(pr["probs"], yl)
        decisions["predictive_score"] = (
            f"PSIS-LOO + calibration on {dr.shape[0]} pooled cold draws "
            "(last seed; ops/ic.py, ops/calibrate.py)")
    elif colds:
        decisions["predictive_score"] = (
            "skipped: custom model_spec (pointwise log-lik builder covers "
            "the reference FNN family)")

    report = AutoReport(
        config=cfg, tune=tune, decisions=decisions, rhat_cold_max=rhat,
        verdict=verdict,
        test_pooled_mean=float(np.mean(pooled)),
        test_pooled_std=float(np.std(pooled)),
        test_cold_mean=float(np.mean(cold_m)),
        test_cold_std=float(np.std(cold_m)),
        chain_steps_per_sec=sps_med,
        pooled_cold_ess_per_sec=None if ess_s is None else float(ess_s),
        ess_draws=draws,
        # None, not 0.0, when no run tracked its replicas
        roundtrips_per_kstep=float(np.mean(trips)) if trips else None,
        swap_percent=float(np.mean(swap_pct)),
        accept_percent=float(np.mean(acc_pct)),
        elapsed_s=elapsed, seeds=seeds, per_seed_cold=tuple(cold_m),
        elpd_loo=elpd, loo_bad_k_frac=badk, coverage_90=cov, crps=crps_v,
        ece=ece_v, brier=brier_v)
    if out:
        os.makedirs(out, exist_ok=True)
        run_dir = results_mod.versioned_dir(out, name)
        results_mod.write_artifacts(res, run_dir, name, plots=False)
        with open(os.path.join(out, "auto_report.txt"), "w") as f:
            f.write(report.describe() + "\n")
            f.write("# per-seed cold test metric: "
                    + " ".join(f"{v:.5f}" for v in report.per_seed_cold)
                    + "\n# tuned ladder: "
                    + " ".join(f"{t:.4f}" for t in cfg.custom_ladder)
                    + f"\n# artifacts (last seed): {run_dir}\n")
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    from ptnn_torch import data as data_mod

    p = argparse.ArgumentParser(
        description="Auto-configured PT sampling of a bundled dataset (on "
        "the GPU; PTNN_DEVICE=cpu runs the plain versions on the CPU)")
    p.add_argument("dataset", help="bundled set, e.g. Sunspot or iris")
    p.add_argument("--target", choices=("quality", "speed"), default="quality")
    p.add_argument("--chains", type=int, default=64, help="chain budget")
    p.add_argument("--steps", type=int, default=8000, help="steps per chain")
    p.add_argument("--replicate", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--model", choices=("fnn", "cnn", "mlp"), default="fnn",
                   help="cnn: the Bayesian CNN spec (digits/mnist data); "
                   "mlp: a deep MLP stack (--mlp-hidden)")
    p.add_argument("--mlp-hidden", type=int, nargs="+", default=[32, 16],
                   help="hidden-layer sizes for --model mlp")
    p.add_argument("--escalate", type=int, default=0, metavar="K",
                   help="double the step budget while the cross-seed "
                   "function-space R-hat fails 1.01, up to K times")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    prob = data_mod.load(a.dataset, seed=a.seed)
    spec = None
    if a.model == "cnn":
        from ptnn_torch.models import cnn

        spec = (cnn.mnist_spec() if prob.topology[0] == 784
                else cnn.digits_spec())
    elif a.model == "mlp":
        from ptnn_torch.models import mlp

        n_in, _, n_out = infer_topology(prob.train, prob.test, prob.task,
                                        None)
        spec = mlp.spec((n_in, *a.mlp_hidden,
                         n_out if prob.task == "classification" else 1),
                        task=prob.task)
    t0 = time.time()
    report = auto_sample(
        prob.train, prob.test, prob.task, chain_budget=a.chains,
        steps_per_chain=a.steps, target=a.target, replicate=a.replicate,
        seed=a.seed, hidden=a.hidden, model_spec=spec, out=a.out,
        name=prob.name, escalate=a.escalate,
        device=os.environ.get("PTNN_DEVICE", "cuda"))
    print(report.describe())
    print(f"total wall-clock (pilot + {a.replicate} runs): "
          f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
