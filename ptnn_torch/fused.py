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

``cfg.record_thin > 1`` keeps every ``record_thin``-th executed row of a
group of ``ceil(chunk_steps / k_max)`` blocks, as ptnn's scan chunks do
(``Thinner``): the group's rows gathered on the device when ``record_thin``
is below the longest block, else at most one row a block written into a
small preallocated device buffer, so that a long group never holds its
whole trace.

Scope (``fused_reason``): the reference random-walk, preconditioned-MALA
and HMC/ChEES proposals, regression and classification, float32, one
device; (``working_set_reason``) for MALA and HMC a network and dataset
that ptnn's own gate fuses (``vmem_k_cap``), and for every proposal a block
with a Hopper plan (the rows and the kernel's slots fit shared memory); and
(``topology_reason``) for the random walk, a network its comparison with
the plain version holds.
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
        return "fused_step is float32-only"  # ptnn/fused.py:106's words
    return None


_VMEM_BUDGET = 12 * 2**20  # ptnn's per-core VMEM working-set cap
_K_MIN = 8  # ptnn's shortest block worth fusing
_LANES = 128  # ptnn's chain lanes


def vmem_k_cap(cfg: PTConfig, n_tr: int, n_te: int) -> int:
    """The longest block ptnn's gate lets a fused MALA / HMC config of
    ``cfg`` run on ``n_tr`` + ``n_te`` rows: the port's copy of
    ``ptnn/fused.py:128-151`` (``_k_cap``, its VMEM working-set model),
    evaluated with ``record_w=True`` as ptnn's ``sample_fused`` runs it; 0
    when the working set does not fit even at 8 steps."""
    pad8 = lambda n: (int(n) + 7) // 8 * 8
    n_hid = cfg.topology[1]
    p_pad = pad8(fnn.w_size(cfg.topology))
    n_cls = cfg.topology[2] if cfg.task == "classification" else 0
    per_k = 4 * _LANES * (p_pad + 8 + p_pad)
    live = max(4, n_cls + 4)
    if n_cls > 0:  # the hidden sigmoid and per-class delta planes
        live += n_hid + n_cls
    state_planes = 26 if cfg.proposal == "hmc" else 18
    fixed = 4 * _LANES * (live * (pad8(n_tr) + pad8(n_te))
                          + state_planes * p_pad)
    if fixed + _K_MIN * per_k > _VMEM_BUDGET:
        return 0
    return min(128, (_VMEM_BUDGET - fixed) // per_k)


def topology_reason(cfg: PTConfig) -> Optional[str]:
    """Why the port's block kernel of ``cfg``'s proposal is not held at its
    FNN topology (None: it is), on every device, so that a configuration
    runs or falls back alike on the CPU and on the card. The random walk
    takes any topology (a fixed-shape kernel for the bundled networks, a
    generic one for the others) but the classification networks its
    comparison with the plain version cannot hold
    (``block_step.RW_CLS_UNHELD``). The MALA and HMC kernels take any
    topology: a fixed-shape route for the networks of
    ``precond_step.TOPOLOGIES`` / ``precond_cls_step.TOPOLOGIES`` and a
    generic one for any other."""
    topo = tuple(cfg.topology)
    if (cfg.proposal == "reference" and cfg.task == "classification"
            and topo in block_step.RW_CLS_UNHELD):
        return (f"the CUDA classification RW block kernel is not held "
                f"against its plain version at {topo}: its argmax ties "
                f"exceed the comparison's 1 % of trace entries")
    return None


def working_set_reason(cfg: PTConfig, n_tr: int, n_te: int) -> Optional[str]:
    """Why a block of ``cfg`` on ``n_tr`` + ``n_te`` rows is refused for its
    working set (None: it is not), on every device, so that a
    configuration runs or falls back alike on the CPU and on the card.
    MALA and HMC run wherever ptnn's own gate fuses them (``vmem_k_cap`` at
    least 8, ptnn's VMEM working-set model); then, as the random walk, a
    block must have a Hopper plan: the rows and the kernel's slots fit a
    block's shared memory. At a network without a fixed-shape route the
    MALA and HMC kernels take the generic route's layout
    (``precond_step.gen_layout``: the vectors in device memory and fewer
    warps a block before it gives up)."""
    n_in, _hid, _out = cfg.topology
    w = fnn.w_size(cfg.topology)
    rows = n_tr + n_te
    chees = cfg.proposal == "hmc" and cfg.hmc_adapt_traj
    cls = cfg.task == "classification"
    fixed = tuple(cfg.topology) in (precond_cls_step.TOPOLOGIES if cls
                                    else precond_step.TOPOLOGIES)
    if (cfg.proposal != "reference"
            and vmem_k_cap(cfg, n_tr, n_te) < _K_MIN):
        return (f"block working set exceeds the VMEM budget (w_size {w}, "
                f"{n_tr}+{n_te} rows) — compute-bound; the per-step sampler "
                f"is the right tool (ptnn's gate)")
    if cfg.proposal != "reference" and not fixed:
        kind = "hmc" if cfg.proposal == "hmc" else "mala"
        try:
            precond_step.gen_layout(kind, rows, cfg.topology)
        except ValueError as e:
            return str(e)
        return None
    if cls:
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


def thin_groups(plan: List[List[Tuple[int, int, bool]]], k_max: int,
                chunk_steps: int) -> List[List[int]]:
    """The lengths of the blocks of each group ptnn scans as one chunk:
    each segment's blocks in runs of ``ceil(chunk_steps / k_max)``
    (ptnn/fused.py:698, 791-794)."""
    group = max(1, int(np.ceil(chunk_steps / k_max)))
    return [[ln for (_s, ln, _f) in seg[gi:gi + group]]
            for seg in plan for gi in range(0, len(seg), group)]


def keep_flat(lengths: List[int], thin: int) -> np.ndarray:
    """The kept rows of a group, as positions among its executed rows:
    ``thin-1, 2*thin-1, ...`` (ptnn's ``_keep_flat`` without the padding
    rows the port's blocks do not have)."""
    return np.arange(thin - 1, sum(lengths), thin)


def posdest(lengths: List[int], thin: int) -> Tuple[np.ndarray, int]:
    """(blocks, 2) [local row, buffer row] (-1: the block keeps nothing)
    and the kept count of a group, for ``thin`` at least the longest block
    (one kept row a block at most): ptnn's ``_posdest``."""
    pd = np.full((len(lengths), 2), -1, np.int64)
    q = 0
    for bi, ln in enumerate(lengths):
        for p in range(ln):
            if q % thin == thin - 1:
                pd[bi] = (p, q // thin)
            q += 1
    return pd, q // thin


class Thinner:
    """``on_block`` for ``record_thin > 1``: keeps each group's rows at
    ptnn's positions on the device and hands the group's kept rows to
    ``emit``. Gather regime (``thin < k_max``): the group's block traces
    are held until its last block, then gathered at ``keep_flat``. Sparse
    regime (``thin >= k_max``): each block writes its one kept row, if
    any, into a buffer of the group's kept count (``posdest``)."""

    def __init__(self, cfg: PTConfig, plan, k_max: int,
                 emit: Callable[[Dict[str, torch.Tensor]], None]):
        self.thin = cfg.record_thin
        self.sparse = self.thin >= k_max
        self.groups = thin_groups(plan, k_max, cfg.chunk_steps)
        self.emit = emit
        self.gi = 0  # group of the next block
        self.bi = 0  # its index in the group
        self.held: List[Dict[str, torch.Tensor]] = []
        self.buf: Optional[Dict[str, torch.Tensor]] = None
        self.pd: Optional[np.ndarray] = None  # the group's posdest rows

    def __call__(self, out: Dict[str, torch.Tensor]) -> None:
        lengths = self.groups[self.gi]
        if self.sparse:
            if self.buf is None:  # the group's first block
                self.pd, n_keep = posdest(lengths, self.thin)
                self.buf = {k: v.new_empty((n_keep,) + v.shape[1:])
                            for k, v in out.items()}
            p, dest = self.pd[self.bi]
            if dest >= 0:
                for k, v in out.items():
                    self.buf[k][dest] = v[p]
        else:
            self.held.append(out)
        self.bi += 1
        if self.bi < len(lengths):
            return
        if self.sparse:
            self.emit(self.buf)
        else:
            idx = torch.as_tensor(keep_flat(lengths, self.thin),
                                  device=out["ll"].device)
            self.emit({k: torch.cat([h[k] for h in self.held])[idx]
                       for k in out})
        self.gi, self.bi, self.held, self.buf = self.gi + 1, 0, [], None


def sample_fused(
    cfg: PTConfig,
    train: np.ndarray,
    test: np.ndarray,
    seed: int = 0,
    device: Any = "cuda",
    init_state: Optional[kernel.ChainState] = None,
    noise_fn: Optional[NoiseFn] = None,
) -> SampleResult:
    """Fused-block sampler; the traces and counters of ``ptnn``'s, thinned
    as ptnn's when ``cfg.record_thin > 1`` (``Thinner``)."""
    cfg.validate()
    eng = _engine(cfg, train, test, device, record_w=cfg.record_w)
    state = init_state if init_state is not None else eng.init_state(seed)
    if noise_fn is None:
        noise_fn = torch_noise(seed, eng.device, noise_names(cfg))

    blocks: List[Dict[str, torch.Tensor]] = []
    on_block = (blocks.append if cfg.record_thin == 1
                else Thinner(cfg, eng.plan, eng.k_max, blocks.append))
    t0 = time.perf_counter()
    state = eng.run(state, noise_fn, on_block)
    synchronize(eng.device)
    t_fetch = time.perf_counter()
    traces = {k: torch.cat([b[k] for b in blocks]).cpu().numpy()
              for k in blocks[0]}
    fetch_s = time.perf_counter() - t_fetch
    elapsed = time.perf_counter() - t0

    if cfg.task == "regression":  # regression carries no accuracy
        rows = traces["ll"].shape[0]
        for name in _ACC:
            traces[name] = np.zeros((rows, cfg.num_chains), np.float32)
    return make_result(cfg, traces, state, eng.temps_host, elapsed, fetch_s)


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
