"""Fused-block samplers (port of ``ptnn/fused.py``).

The run is cut at its replica-exchange events and at the temper switch
(``block_plan``). Every inter-swap interval is one call of a block function,
which on the card is one launch of a CUDA block kernel:

* ``proposal="reference"``: ``ops.block_step.fused_rw_block`` (both tasks);
* ``proposal="precond_mala"``: ``ops.precond_step.fused_mala_block``, or
  for classification ``ops.precond_cls_step.fused_mala_cls_block``;
* ``proposal="hmc"`` (with or without ChEES): ``fused_hmc_block`` /
  ``fused_hmc_cls_block``.

Between blocks run the swap event (``kernel.do_swap``) and, once, at the
temper switch, ``kernel.recompute_ll``.

Noise is drawn per block by ``noise_fn(start, k_max, c, w) -> dict``: "w"
(k_max, c, w), "u" (k_max, c), "u_swap" (c-1,), for regression "eta"
(k_max, c) and for its MALA and HMC "u_eta" (k_max, c), for HMC "u_jit"
(k_max, c) and "u_traj" (k_max,), the van der Corput jitter
``kernel.vdc_u(start + k)`` (``noise_names``). The default draws from a
``torch.Generator`` seeded from ``seed`` on the run's device. ``ptnn``
derives its noise from ``jax.random`` keys instead, so runs of the two
packages agree in distribution, and exactly when ``ptnn``'s noise is fed in
through ``noise_fn``.

Scope (``fused_reason``): the reference random-walk, preconditioned-MALA
and HMC/ChEES proposals, regression and classification, float32, every
trace row kept, one device; (``topology_reason``) a network the CUDA block
kernels are built for; and (``working_set_reason``) a network and dataset
whose block fits the kernel's shared memory.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ptnn_torch import kernel
from ptnn_torch.config import PTConfig
from ptnn_torch.models import fnn
from ptnn_torch.ops import block_step, ladder, precond_cls_step, precond_step
from ptnn_torch.parallel import swap as swap_mod
from ptnn_torch.sampler import (SampleResult, init_chains, make_dataset,
                                make_result, seed_of, synchronize,
                                throughput_rep, trace_sums)

K_CAP = 128  # longest block: a longer swap interval is cut into pieces

Noise = Dict[str, torch.Tensor]
NoiseFn = Callable[[int, int, int, int], Noise]


def fused_reason(cfg: PTConfig) -> Optional[str]:
    """Why this port's fused sampler cannot run ``cfg`` (None: it can)."""
    if cfg.task == "regression" and cfg.topology[2] != 1:
        return "regression with one output only"
    if cfg.use_langevin_gradients or cfg.proposal not in (
            "reference", "precond_mala", "hmc"):
        return ("the reference random-walk, precond_mala and hmc proposals "
                "only (ptnn fuses no other proposal, nor Langevin gradients)")
    if cfg.proposal == "hmc" and cfg.hmc_adapt_traj:
        # ptnn/fused.py:72-96 without the mesh
        try:
            precond_step.panel_layout(cfg.num_chains, cfg.rungs_per_ladder)
        except ValueError as e:
            return f"fused {e}"
    if cfg.use_surrogate or cfg.variational_reference:
        return "no surrogate or variational-reference modes"
    if cfg.record_fx or cfg.record_ll_state:
        return "no fx/ll_cur traces"
    if cfg.eval_dtype != "float32":
        return "float32 only"
    if cfg.record_thin != 1:
        return "record_thin=1 only (thinned traces are not yet ported)"
    return None


def topology_reason(cfg: PTConfig) -> Optional[str]:
    """Why the CUDA block kernel of ``cfg``'s proposal is not built for its
    FNN topology (None: it is), on every device, so that a configuration
    runs or falls back alike on the CPU and on the card. The random walk
    takes any topology (a fixed-shape kernel for the bundled networks, a
    generic one for the others) but the classification networks its
    comparison with the plain version cannot hold
    (``block_step.RW_CLS_UNHELD``); the MALA and HMC kernels are
    instantiated for the topologies their modules list."""
    topo = tuple(cfg.topology)
    if cfg.proposal == "reference":
        if cfg.task == "classification" and topo in block_step.RW_CLS_UNHELD:
            return (f"the CUDA classification RW block kernel is not held "
                    f"against its plain version at {topo}: its argmax ties "
                    f"exceed the comparison's 1 % of trace entries")
        return None
    built = (precond_cls_step.TOPOLOGIES if cfg.task == "classification"
             else precond_step.TOPOLOGIES)
    if topo in built:
        return None
    return (f"the CUDA {cfg.task} {cfg.proposal} block kernel is built for "
            f"topologies {built}, not {topo}")


def working_set_reason(cfg: PTConfig, n_tr: int, n_te: int) -> Optional[str]:
    """Why a block of ``cfg`` on ``n_tr`` + ``n_te`` rows does not fit the
    CUDA kernel's shared memory (None: it does), on every device, so that a
    configuration runs or is refused alike on the CPU and on the card."""
    n_in, _hid, _out = cfg.topology
    w = fnn.w_size(cfg.topology)
    rows = n_tr + n_te
    chees = cfg.proposal == "hmc" and cfg.hmc_adapt_traj
    if cfg.task == "classification":
        if cfg.proposal == "reference":  # the larger of the two kernels'
            need = max([block_step.cls_smem_bytes(rows, cfg.topology,
                                                  "generic")]
                       + [block_step.cls_smem_bytes(rows, cfg.topology,
                                                    "fixed", warps)
                          for warps in block_step.cls_warps()])
        elif cfg.proposal == "hmc":  # the largest of the launch plan's layouts
            need = max(precond_cls_step.hmc_smem_bytes(rows, cfg.topology,
                                                       chees, wpc)
                       for wpc in precond_cls_step.WPCS)
        else:
            need = precond_cls_step.mala_smem_bytes(rows, cfg.topology)
    elif cfg.proposal == "reference":
        need = max(block_step.smem_bytes(rows, cfg.topology, warps)
                   for warps in block_step.RW_WARPS)
    else:
        need = precond_step.smem_bytes(rows, n_in, chees,
                                       hmc=cfg.proposal == "hmc")
    if need > precond_step._SMEM_LIMIT:
        return (f"the block working set (w_size {w}, {n_tr}+{n_te} rows) "
                f"needs {need} bytes of shared memory; a Hopper block has "
                f"{precond_step._SMEM_LIMIT}")
    return None


_swap_due_host = kernel.swap_due  # the plan is built on the host


def block_plan(
    cfg: PTConfig, k_cap: int = K_CAP
) -> List[List[Tuple[int, int, bool]]]:
    """Per segment (split at the temper switch), the ``(start, length,
    swap_after)`` blocks covering it, each at most ``k_cap`` steps and
    ending at a swap event iff ``swap_after``."""
    n = cfg.n_steps
    switch = cfg.temper_switch_step
    seg_bounds = [(0, switch), (switch, n)] if 0 < switch < n else [(0, n)]
    segments = []
    for a, b in seg_bounds:
        points = [a]
        for i in range(a, b):
            if _swap_due_host(cfg, i) and i + 1 < b:
                points.append(i + 1)
        points.append(b)
        blocks = []
        for lo, hi in zip(points, points[1:]):
            # only the last piece of a long interval may end at a swap event
            cur = lo
            while hi - cur > k_cap:
                blocks.append((cur, k_cap, False))
                cur += k_cap
            blocks.append((cur, hi - cur, _swap_due_host(cfg, hi - 1)))
        segments.append(blocks)
    return segments


_PRECOND_VEC = ("g_like", "pc_mean", "pc_m2")
_CHEES = ("log_traj", "chees_m1", "chees_v2")
_ACC = ("acc_train", "acc_test")


def _to_kernel_state(st: kernel.ChainState, cfg: PTConfig) -> Dict[str, Any]:
    """The block functions' state dict: classification adds the accuracy
    carries and has no eta scale."""
    cls = cfg.task == "classification"
    out = dict(w=st.w, w_last=st.w_last, eta=st.eta, ll=st.ll,
               prior=st.prior, rmse_train=st.rmse_train,
               rmse_test=st.rmse_test, n_accept=st.n_accept)
    if cls:
        out.update(acc_train=st.acc_train, acc_test=st.acc_test)
    if cfg.proposal == "reference":
        out["log_step_w"] = (st.log_step_w if cfg.adapt_step_size
                             else torch.zeros_like(st.eta))
        return out
    out["log_step_w"] = st.log_step_w
    if not cls:
        out["log_step_eta"] = st.log_step_eta
    for name in _PRECOND_VEC:
        out[name] = getattr(st, name)
    if st.log_traj is not None:
        for name in _CHEES:
            out[name] = getattr(st, name)
    return out


def _from_kernel_state(st: kernel.ChainState, ks: Dict[str, torch.Tensor],
                       cfg: PTConfig) -> kernel.ChainState:
    cls = cfg.task == "classification"
    names = ["w", "w_last", "eta", "ll", "prior", "rmse_train", "rmse_test",
             "n_accept"] + (list(_ACC) if cls else [])
    if cfg.proposal != "reference":
        names += ["log_step_w", *_PRECOND_VEC]
        if not cls:
            names.append("log_step_eta")
        if st.log_traj is not None:
            names += list(_CHEES)
    elif cfg.adapt_step_size:
        names.append("log_step_w")
    return st.replace(**{name: ks[name] for name in names})


def noise_names(cfg: PTConfig) -> Tuple[str, ...]:
    """The keys a block of ``cfg``'s proposal reads from ``noise_fn``:
    "w", "u" and "u_swap"; regression adds "eta", and "u_eta" for its
    MALA/HMC eta block; HMC adds "u_jit" and "u_traj"."""
    names = ("w", "u", "u_swap")
    if cfg.task == "regression":
        names += ("eta",)
        if cfg.proposal in ("precond_mala", "hmc"):
            names += ("u_eta",)
    if cfg.proposal == "hmc":
        names += ("u_jit", "u_traj")
    return names


def torch_noise(seed: int, device, names=("w", "eta", "u", "u_swap")
                ) -> NoiseFn:
    """The default noise: a ``torch.Generator`` on ``device`` seeded from
    (seed, block start), so a block's noise depends on where it starts and
    not on what ran before it (as ``ptnn``'s ``fold_in(key, start)``).
    ``names`` says which entries to draw (``noise_names``)."""
    gen = torch.Generator(device=device)

    def noise_fn(start: int, k_max: int, c: int, w: int) -> Noise:
        gen.manual_seed(seed_of(seed, 1, start))
        f32 = dict(dtype=torch.float32, device=device, generator=gen)
        draw = dict(
            w=lambda: torch.randn((k_max, c, w), **f32),
            eta=lambda: torch.randn((k_max, c), **f32),
            u=lambda: torch.rand((k_max, c), **f32),
            u_eta=lambda: torch.rand((k_max, c), **f32),
            u_jit=lambda: torch.rand((k_max, c), **f32),
            u_swap=lambda: torch.rand((max(c - 1, 0),), **f32),
            u_traj=lambda: kernel.vdc_u(
                torch.arange(start, start + k_max, device=device)),
        )
        return {name: draw[name]() for name in names}

    return noise_fn


@dataclasses.dataclass
class _Engine:
    cfg: PTConfig
    device: torch.device
    data: kernel.Dataset
    kdata: dict
    temps_host: np.ndarray
    temps: torch.Tensor
    plan: List[List[Tuple[int, int, bool]]]
    k_max: int
    scal: dict
    record_w: bool
    pair_mask: Optional[torch.Tensor]

    def init_state(self, seed: int) -> kernel.ChainState:
        return init_chains(self.cfg, self.data, seed)

    def block_body(self, st: kernel.ChainState, start: int, length: int,
                   swap_flag: bool, noise: Noise):
        """One fused block, then the swap event when ``swap_flag``.
        Returns the new state and the block's ``length`` trace rows."""
        cfg = self.cfg
        adapttemp = kernel.adapttemp_at(cfg, self.temps, start)
        kst = _to_kernel_state(st, cfg)
        args = (start, length, self.kdata, adapttemp, cfg.topology,
                self.scal)
        cls = cfg.task == "classification"
        if cfg.proposal == "reference":
            ksd, traces = block_step.fused_rw_block(
                kst, noise["w"], noise.get("eta"), noise["u"], *args,
                record_w=self.record_w)
        else:
            block = {
                ("hmc", False): precond_step.fused_hmc_block,
                ("hmc", True): precond_cls_step.fused_hmc_cls_block,
                ("precond_mala", False): precond_step.fused_mala_block,
                ("precond_mala", True): precond_cls_step.fused_mala_cls_block,
            }[(cfg.proposal, cls)]
            ksd, traces = block(kst, noise, *args, record_w=self.record_w)
        st2 = _from_kernel_state(st, ksd, cfg)
        st3 = st2
        if swap_flag:
            st3 = kernel.do_swap(cfg, st2, self.temps, start + length - 1,
                                 noise["u_swap"], self.pair_mask)
        names = ["ll", "rmse_train", "rmse_test", "accept_count"]
        if cls:
            names += list(_ACC)
        if cfg.proposal == "hmc" and cfg.hmc_adapt_traj:
            names.append("traj_len")
        out = {k: traces[k][:length] for k in names}
        if self.record_w:
            out["w"] = traces["w"][:length, kernel.recorded_chains(cfg)]
        if cfg.track_replicas:
            reps = st.replica_id[None, :].repeat(length, 1)
            # the swap-boundary step records the post-swap identities
            reps[length - 1] = st3.replica_id
            out["replica"] = reps
        return st3, out

    def run(self, state: kernel.ChainState, noise_fn: NoiseFn,
            on_block: Callable[[Dict[str, torch.Tensor]], None]):
        """Every segment and block of the plan, in order."""
        c, w = self.cfg.num_chains, fnn.w_size(self.cfg.topology)
        for si, seg in enumerate(self.plan):
            if si > 0:
                state = kernel.recompute_ll(self.cfg, state, self.data)
            for start, length, flag in seg:
                noise = noise_fn(start, self.k_max, c, w)
                state, out = self.block_body(state, start, length, flag, noise)
                on_block(out)
        return state


def _scalars(cfg: PTConfig) -> dict:
    """The block function's scalars: the ``scal`` dicts of
    ``ptnn/fused.py:386-440``, with the ChEES panel rule of ``:414-430``."""
    samples = cfg.samples_per_chain
    burn_end = int(samples * cfg.burn_in) - 1
    if cfg.proposal == "reference":
        return dict(
            step_w=cfg.step_w, step_eta=cfg.step_eta, sigma_sq=cfg.sigma_sq,
            nu_1=cfg.nu_1, nu_2=cfg.nu_2, adapt=cfg.adapt_step_size,
            adapt_rate=cfg.adapt_rate, adapt_target=cfg.adapt_target_accept,
            burn_end=burn_end, task_cls=cfg.task == "classification",
        )
    scal = dict(
        sigma_sq=cfg.sigma_sq, nu_1=cfg.nu_1, nu_2=cfg.nu_2,
        adapt_rate=cfg.adapt_rate, warmstart_step=cfg.warmstart_step,
        precond_power=cfg.precond_power,
        pc_start=int(samples * cfg.precond_start_frac),
        warm_end=int(samples * cfg.warmstart_frac), burn_end=burn_end,
    )
    if cfg.proposal == "precond_mala":
        scal["mala_target"] = cfg.mala_target_accept
        return scal
    scal.update(
        hmc_target=cfg.hmc_target_accept, leapfrog=cfg.hmc_leapfrog,
        eps_jitter=cfg.hmc_eps_jitter, chees=cfg.hmc_adapt_traj,
        chees_rate=cfg.chees_rate, rungs=cfg.rungs_per_ladder,
        n_ladders=cfg.n_ladders,
    )
    if cfg.hmc_adapt_traj:
        # every panel of 128 chains holds complete ladders; the rung sums
        # pool its own 128 / K replicas
        scal["n_ladders"] = precond_step.panel_layout(
            cfg.num_chains, cfg.rungs_per_ladder)[1]
    return scal


def runtime_reason(cfg: PTConfig, n_tr: int, n_te: int) -> Optional[str]:
    """Why the fused sampler cannot run ``cfg`` on ``n_tr`` + ``n_te`` rows
    (None: it can); ``sampler.sample`` then falls back to the per-step
    sampler."""
    return (fused_reason(cfg) or working_set_reason(cfg, n_tr, n_te)
            or topology_reason(cfg))


def _engine(cfg: PTConfig, train, test, device, record_w: bool) -> _Engine:
    reason = fused_reason(cfg)
    if reason is not None:
        raise ValueError(f"ptnn_torch's fused sampler runs {reason}")
    reason = (working_set_reason(cfg, train.shape[0], test.shape[0])
              or topology_reason(cfg))
    if reason is not None:
        raise ValueError(f"ptnn_torch's fused sampler cannot run this: "
                         f"{reason}")
    device = torch.device(device)
    data = make_dataset(cfg, train, test, device)
    n_classes = cfg.topology[2] if cfg.task == "classification" else 0
    temps_host = ladder.build_temperatures(cfg)
    plan = block_plan(cfg)
    return _Engine(
        cfg=cfg,
        device=device,
        data=data,
        kdata=block_step.prep_data(data.x_train, data.y_train, data.x_test,
                                   data.y_test, n_classes),
        temps_host=temps_host,
        temps=torch.as_tensor(temps_host, dtype=torch.float32, device=device),
        plan=plan,
        k_max=max(ln for seg in plan for (_s, ln, _f) in seg),
        scal=_scalars(cfg),
        record_w=record_w,
        pair_mask=swap_mod.pair_mask(cfg.num_chains, cfg.rungs_per_ladder,
                                     device),
    )


def sample_fused(
    cfg: PTConfig,
    train: np.ndarray,
    test: np.ndarray,
    seed: int = 0,
    device: Any = "cuda",
    init_state: Optional[kernel.ChainState] = None,
    noise_fn: Optional[NoiseFn] = None,
) -> SampleResult:
    """Fused-block sampler; the traces and counters of ``ptnn``'s."""
    cfg.validate()
    eng = _engine(cfg, train, test, device, record_w=cfg.record_w)
    state = init_state if init_state is not None else eng.init_state(seed)
    if noise_fn is None:
        noise_fn = torch_noise(seed, eng.device, noise_names(cfg))

    blocks: List[Dict[str, torch.Tensor]] = []
    t0 = time.perf_counter()
    state = eng.run(state, noise_fn, blocks.append)
    traces = {k: torch.cat([b[k] for b in blocks]).cpu().numpy()
              for k in blocks[0]}
    synchronize(eng.device)
    elapsed = time.perf_counter() - t0

    if cfg.task == "regression":  # regression carries no accuracy
        for name in _ACC:
            traces[name] = np.zeros((cfg.n_steps, cfg.num_chains), np.float32)
    return make_result(cfg, traces, state, eng.temps_host, elapsed)


def throughput_build_fused(
    cfg: PTConfig,
    train,
    test,
    seed: int = 0,
    device: Any = "cuda",
    noise_fn: Optional[NoiseFn] = None,
):
    """Benchmark protocol: build, run once as warm-up, and return a zero-arg
    callable that runs one timed rep from the same initial state (and, with
    a ``noise_fn`` that depends on the block start alone, the same noise).
    Traces are reduced to their sums on the device, not fetched."""
    cfg2 = dataclasses.replace(cfg, record_w=False).validate()
    eng = _engine(cfg2, train, test, device, record_w=False)
    state0 = eng.init_state(seed)
    if noise_fn is None:
        noise_fn = torch_noise(seed, eng.device, noise_names(cfg2))

    def run():
        sums: Dict[str, torch.Tensor] = {}
        return eng.run(state0, noise_fn, trace_sums(sums)), sums

    return throughput_rep(cfg2, run, eng.device)
