"""Sampling entry points (port of ``ptnn/sampler.py``).

``sample`` and ``throughput_runner`` run the fused-block sampler
(``ptnn_torch.fused``) when ``cfg.fused_step`` is set and the fused path can
run ``cfg`` (``fused.runtime_reason``); otherwise, with a warning for a
fused config, the per-step sampler here: the reference proposal, with or
without the Langevin-gradient drift, and the preconditioned family
(``precond_rw``, ``precond_mala``, ``hmc`` with or without ChEES, ``pcn``). ``model_spec`` names the model
(``models.cnn.digits_spec()``, ``models.mlp.spec(...)``; default: the
reference FNN of ``cfg.topology``); a spec that is not the reference FNN
never takes the fused path. Every entry point takes an explicit ``device``;
on "cuda" the hand-written kernels run on the card, on "cpu" their plain
versions run.

The per-step run is split at the temper switch, with the reference's
one-time ``recompute_ll`` between the two segments, and each segment into
chunks of about ``cfg.chunk_steps`` steps (``_pick_chunk``). Each chunk's
traces stay on the device until the chunk ends. Noise is drawn per chunk by
``noise_fn(start, length, c, w) -> dict`` of (length, ...) tensors:
"w" (L, C, W) normal, "u" (L, C) uniform, "u_swap" (L, C-1) uniform, with
Langevin "l" (L, C) uniform, for regression "eta" (L, C) normal, and for
the preconditioned family "u_eta" (L, C) (regression) and "jit" (L, C)
(HMC) uniform (``kernel.step_noise_names``). The default (``step_noise``) draws pages of
steps from a ``torch.Generator`` on the run's device seeded from (seed, page
index), so a step's noise does not depend on ``chunk_steps``. ``ptnn``
derives each step's noise from ``split(fold_in(k_run, i), 6)`` (the
preconditioned family: 5) instead, so
runs of the two packages agree in distribution, and exactly when ptnn's
draws are fed in through ``noise_fn`` (``tests/test_torch_step.py``).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ptnn_torch import kernel
from ptnn_torch.config import PTConfig
from ptnn_torch.kernel import ChainState, Dataset
from ptnn_torch.models import api as model_api
from ptnn_torch.ops import drift, ladder

Noise = Dict[str, torch.Tensor]
NoiseFn = Callable[[int, int, int, int], Noise]


@dataclass
class SampleResult:
    """Host-side result of a PT run (the fields of ``ptnn.SampleResult``).

    Trace arrays have shape (samples_per_chain, num_chains, ...) with row 0
    the reference's init row (w ones, ll -100, replica ids in order);
    "acc_train" / "acc_test" are the accuracy traces (zeros for
    regression).
    """

    traces: Dict[str, np.ndarray]
    final_state: ChainState  # tensors on the CPU
    temperatures: np.ndarray
    accept_ratio_per_chain: np.ndarray  # percent, per chain
    swap_percent: float
    langevin_ratio_per_chain: np.ndarray
    elapsed_s: float
    chain_steps_per_sec: float
    config: PTConfig = field(repr=False, default=None)
    da_segments: int = 0
    da_accept_per_chain: Optional[np.ndarray] = None
    pair_swap_accept: Optional[np.ndarray] = None
    vr_regen_accept_pct: Optional[float] = None
    vr_regen_proposed: int = 0


def make_dataset(cfg: PTConfig, train, test, device) -> Dataset:
    """Split raw ``[features..., label]`` rows into float32 tensors (the
    class index of a classification row stays a float32, as ptnn keeps it)
    and the delta-rule targets of the train rows."""
    i, _h, o = cfg.topology

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                               device=device)

    y_tr = t(train[:, i])
    return Dataset(x_train=t(train[:, :i]), y_train=y_tr,
                   x_test=t(test[:, :i]), y_test=t(test[:, i]),
                   t_train=drift.make_targets(y_tr, o, cfg.task))


def seed_of(*words: int) -> int:
    """A generator seed from integer words (run seed, stream, start)."""
    seq = np.random.SeedSequence(list(words))
    return int(seq.generate_state(1, np.uint64)[0])


def init_chains(cfg: PTConfig, data: Dataset, seed: int,
                spec: Optional[model_api.ModelSpec] = None) -> ChainState:
    """``kernel.init_state`` from a generator seeded from ``seed``."""
    gen = torch.Generator(device=data.x_train.device)
    gen.manual_seed(seed_of(seed, 0))
    return kernel.init_state(cfg, data, generator=gen, spec=spec)


def merge_rows(traces: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Prepend ptnn's init row 0 to (n_steps, C, ...) traces: w ones, ll
    -100, replica ids in order, zeros elsewhere."""
    merged = {}
    for name, arr in traces.items():
        if name == "w":
            row0 = np.ones((1,) + arr.shape[1:], arr.dtype)
        elif name == "ll":
            row0 = np.full((1,) + arr.shape[1:], -100.0, arr.dtype)
        elif name == "replica":
            row0 = np.arange(arr.shape[1], dtype=arr.dtype)[None, :]
        else:
            row0 = np.zeros((1,) + arr.shape[1:], arr.dtype)
        merged[name] = np.concatenate([row0, arr], axis=0)
    return merged


def make_result(cfg: PTConfig, traces: Dict[str, np.ndarray],
                state: ChainState, temps_host: np.ndarray,
                elapsed: float) -> SampleResult:
    """The ``SampleResult`` of a finished run: merged traces, the final
    state on the CPU, and ptnn's percentages."""
    final = state.to("cpu")
    samples = cfg.samples_per_chain
    n_prop = int(final.n_swap_proposed)
    return SampleResult(
        traces=merge_rows(traces),
        final_state=final,
        temperatures=np.asarray(temps_host),
        accept_ratio_per_chain=final.n_accept.numpy() * 100.0 / samples,
        swap_percent=(
            100.0 * int(final.n_swap_accepted) / n_prop if n_prop else 0.0
        ),
        langevin_ratio_per_chain=final.n_langevin.numpy() * 100.0 / samples,
        elapsed_s=elapsed,
        chain_steps_per_sec=cfg.n_steps * cfg.num_chains / elapsed,
        config=cfg,
        pair_swap_accept=final.pair_accept_sum.numpy()[:-1]
        / np.maximum(final.pair_prop_count.numpy()[:-1], 1),
    )


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def throughput_rep(cfg: PTConfig, run: Callable, device: torch.device):
    """The benchmark protocol around ``run() -> (final state, trace sums on
    the device)``: run it once as warm-up and return a zero-arg callable
    that times one rep."""
    run()
    synchronize(device)
    n, c = cfg.n_steps, cfg.num_chains

    def one_rep() -> Dict[str, Any]:
        t0 = time.perf_counter()
        st, sums = run()
        synchronize(device)
        dt = time.perf_counter() - t0
        n_prop = int(st.n_swap_proposed)
        return {
            "trace_means": {k: float(v) / (n * c) for k, v in sums.items()},
            "elapsed_s": dt,
            "steps": float(n),
            "chains": float(c),
            "chain_steps_per_sec": n * c / dt,
            "accept_pct": float(st.n_accept.float().mean())
            * 100.0 / cfg.samples_per_chain,
            "langevin_pct": float(st.n_langevin.float().mean())
            * 100.0 / cfg.samples_per_chain,
            "swap_pct": 100.0 * int(st.n_swap_accepted) / n_prop
            if n_prop else 0.0,
            "final_rmse_test_cold": float(st.rmse_test[0]),
            "final_acc_test_cold": float(st.acc_test[0]),
        }

    return one_rep


def trace_sums(sums: Dict[str, torch.Tensor]):
    """An ``on_chunk`` that adds each trace's float64 sum into ``sums`` on
    the device."""
    def reduce(out: Dict[str, torch.Tensor]) -> None:
        for k, v in out.items():
            s = v.sum(dtype=torch.float64)
            sums[k] = sums[k] + s if k in sums else s

    return reduce


# ---------------------------------------------------------------------------
# The per-step sampler.


def _pick_chunk(n_steps: int, target: int) -> int:
    """Largest divisor of ``n_steps`` not exceeding ~2x the target
    (ptnn/sampler.py:86-100)."""
    best = 1
    for d in range(1, int(n_steps**0.5) + 1):
        if n_steps % d == 0:
            for cand in (d, n_steps // d):
                if best < cand <= 2 * target:
                    best = cand
    if best < max(1, target // 8):
        return target
    return best


PAGE_STEPS = 256  # steps of per-step noise drawn at a time
PAGE_FLOATS = 16 * 2**20  # at most 64 MB of w-noise in a page


def page_steps(c: int, w: int) -> int:
    """Steps in one page of the per-step noise: ``PAGE_STEPS``, fewer where
    a page of (steps, C, W) w-noise would pass ``PAGE_FLOATS``. A function
    of the run's widths only, never of ``chunk_steps``."""
    return max(1, min(PAGE_STEPS, PAGE_FLOATS // max(c * w, 1)))


def step_noise(seed: int, device, names) -> NoiseFn:
    """The per-step sampler's default noise, drawing ``names``
    (``kernel.step_noise_names``). It is drawn in pages of ``page_steps``
    steps, page p from a ``torch.Generator`` on ``device`` seeded from
    (seed, 2, p), and a chunk takes the slices of the pages it covers, so a
    step's noise depends on its absolute index alone: results are invariant
    to chunking, as ptnn's per-step keys make them. The last page drawn is
    kept for the next chunk."""
    gen = torch.Generator(device=device)
    cache: Dict[int, Noise] = {}

    def page(p: int, steps: int, c: int, w: int) -> Noise:
        if p not in cache:
            gen.manual_seed(seed_of(seed, 2, p))
            f32 = dict(dtype=torch.float32, device=device, generator=gen)
            draw = dict(
                w=lambda: torch.randn((steps, c, w), **f32),
                l=lambda: torch.rand((steps, c), **f32),
                eta=lambda: torch.randn((steps, c), **f32),
                u=lambda: torch.rand((steps, c), **f32),
                u_eta=lambda: torch.rand((steps, c), **f32),
                jit=lambda: torch.rand((steps, c), **f32),
                u_swap=lambda: torch.rand((steps, max(c - 1, 0)), **f32),
            )
            cache.clear()
            cache[p] = {name: draw[name]() for name in names}
        return cache[p]

    def noise_fn(start: int, length: int, c: int, w: int) -> Noise:
        steps = page_steps(c, w)
        parts = []
        for p in range(start // steps, (start + length - 1) // steps + 1):
            lo = max(start - p * steps, 0)
            hi = min(start + length - p * steps, steps)
            parts.append({k: v[lo:hi] for k, v in page(p, steps, c, w).items()})
        if len(parts) == 1:
            return parts[0]
        return {k: torch.cat([part[k] for part in parts]) for k in parts[0]}

    return noise_fn


@dataclasses.dataclass
class _PerStep:
    cfg: PTConfig
    device: torch.device
    data: Dataset
    temps_host: np.ndarray
    step_fn: kernel.StepFn

    def run(self, state: ChainState, noise_fn: NoiseFn,
            on_chunk: Callable[[Dict[str, torch.Tensor]], None]) -> ChainState:
        """Both segments (ptnn/sampler.py:233-322), chunk by chunk; each
        chunk's traces (length, C, ...) go to ``on_chunk``."""
        cfg, fn = self.cfg, self.step_fn
        n, switch = cfg.n_steps, cfg.temper_switch_step
        segments = [(0, switch), (switch, n)] if 0 < switch < n else [(0, n)]
        target = max(1, min(cfg.chunk_steps, n))
        c, w = cfg.num_chains, fn.spec.w_size
        for si, (a, b) in enumerate(segments):
            if si > 0:
                state = fn.recompute_ll(state)
            chunk = _pick_chunk(b - a, target)
            done = a
            while done < b:
                length = min(chunk, b - done)
                noise = noise_fn(done, length, c, w)
                rows: List[Dict[str, torch.Tensor]] = []
                for k in range(length):
                    state, trace = fn.step(
                        state, done + k, {m: v[k] for m, v in noise.items()})
                    rows.append(trace)
                on_chunk({m: torch.stack([r[m] for r in rows])
                          for m in rows[0]})
                done += length
        return state


def _per_step(cfg: PTConfig, train, test, device,
              model_spec: Optional[model_api.ModelSpec] = None) -> _PerStep:
    device = torch.device(device)
    data = make_dataset(cfg, train, test, device)
    temps_host = ladder.build_temperatures(cfg)
    temps = torch.as_tensor(temps_host, dtype=torch.float32, device=device)
    return _PerStep(cfg, device, data, temps_host,
                    kernel.make_step_fn(cfg, data, temps, model_spec))


def sample_per_step(
    cfg: PTConfig,
    train: np.ndarray,
    test: np.ndarray,
    seed: int = 0,
    device: Any = "cuda",
    init_state: Optional[ChainState] = None,
    noise_fn: Optional[NoiseFn] = None,
    model_spec: Optional[model_api.ModelSpec] = None,
) -> SampleResult:
    """The per-step sampler; the traces and counters of ptnn's."""
    eng = _per_step(cfg, train, test, device, model_spec)
    state = (init_state if init_state is not None
             else init_chains(cfg, eng.data, seed, eng.step_fn.spec))
    if noise_fn is None:
        noise_fn = step_noise(seed, eng.device, kernel.step_noise_names(cfg))
    chunks: List[Dict[str, np.ndarray]] = []
    t0 = time.perf_counter()
    state = eng.run(state, noise_fn, lambda tr: chunks.append(
        {k: v.cpu().numpy() for k, v in tr.items()}))
    synchronize(eng.device)
    elapsed = time.perf_counter() - t0
    traces = {k: np.concatenate([ch[k] for ch in chunks]) for k in chunks[0]}
    return make_result(cfg, traces, state, eng.temps_host, elapsed)


def throughput_build_per_step(
        cfg: PTConfig, train, test, seed: int = 0, device: Any = "cuda",
        noise_fn: Optional[NoiseFn] = None,
        model_spec: Optional[model_api.ModelSpec] = None):
    """Benchmark protocol of the per-step sampler: ``record_w`` off, traces
    reduced to their sums on the device, every rep from the same initial
    state (and, with the default noise, the same noise)."""
    cfg2 = dataclasses.replace(cfg, record_w=False).validate()
    eng = _per_step(cfg2, train, test, device, model_spec)
    state0 = init_chains(cfg2, eng.data, seed, eng.step_fn.spec)
    if noise_fn is None:
        noise_fn = step_noise(seed, eng.device,
                              kernel.step_noise_names(cfg2))

    def run():
        sums: Dict[str, torch.Tensor] = {}
        return eng.run(state0, noise_fn, trace_sums(sums)), sums

    return throughput_rep(cfg2, run, eng.device)


def _fused_or_warn(cfg: PTConfig, train, test, model_spec=None) -> bool:
    """Whether ``cfg`` takes the fused path; a fused config the fused path
    cannot run falls back to the per-step sampler with a warning."""
    if not cfg.fused_step:
        return False
    from ptnn_torch import fused

    reason = fused.runtime_reason(cfg, train.shape[0], test.shape[0])
    if model_spec is not None and model_spec.fnn_topology is None:
        reason = "fused_step supports the reference FNN spec"
    if reason is None:
        return True
    warnings.warn(f"fused_step: falling back to the per-step sampler "
                  f"({reason})")
    return False


def sample(
    cfg: PTConfig,
    train: np.ndarray,
    test: np.ndarray,
    seed: int = 0,
    device: Any = "cuda",
    init_state: Optional[ChainState] = None,
    noise_fn=None,
    model_spec: Optional[model_api.ModelSpec] = None,
) -> SampleResult:
    """Run the PT sampler and return its traces and counters. ``noise_fn``
    follows the contract of the path that runs (``fused`` or per-step)."""
    cfg.validate()
    if _fused_or_warn(cfg, train, test, model_spec):
        from ptnn_torch import fused

        return fused.sample_fused(cfg, train, test, seed=seed, device=device,
                                  init_state=init_state, noise_fn=noise_fn)
    return sample_per_step(cfg, train, test, seed=seed, device=device,
                           init_state=init_state, noise_fn=noise_fn,
                           model_spec=model_spec)


def throughput_runner(
    cfg: PTConfig,
    train: np.ndarray,
    test: np.ndarray,
    seed: int = 0,
    device: Any = "cuda",
    model_spec: Optional[model_api.ModelSpec] = None,
):
    """Build a benchmark run, run it once as warm-up, and return a zero-arg
    callable that executes one timed rep."""
    cfg = cfg.validate()
    if _fused_or_warn(cfg, train, test, model_spec):
        from ptnn_torch import fused

        return fused.throughput_build_fused(cfg, train, test, seed=seed,
                                            device=device)
    return throughput_build_per_step(cfg, train, test, seed=seed,
                                     device=device, model_spec=model_spec)


def throughput_run(
    cfg: PTConfig,
    train: np.ndarray,
    test: np.ndarray,
    seed: int = 0,
    mesh=None,
    model_spec: Optional[model_api.ModelSpec] = None,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """ptnn's benchmark call: one warm-up pass that is not timed, then one
    timed run from the same initial state; returns ``throughput_runner``'s
    dict (the keys of ptnn's, and ``langevin_pct``,
    ``final_acc_test_cold``)."""
    if mesh is not None:
        raise NotImplementedError("throughput_run(mesh=...): the port runs "
                                  "on one device (ROADMAP Queue 1 item 14)")
    return throughput_runner(cfg, train, test, seed=seed, device=device,
                             model_spec=model_spec)()
