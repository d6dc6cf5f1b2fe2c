"""Sampling entry points (port of ``ptnn/sampler.py``).

``sample`` and ``throughput_runner`` run the fused-block sampler
(``ptnn_torch.fused``) when ``cfg.fused_step`` is set and the fused path can
run ``cfg`` (``fused.runtime_reason``); otherwise, with a warning for a
fused config, the per-step sampler here: the reference proposal, with or
without the Langevin-gradient drift, the preconditioned family
(``precond_rw``, ``precond_mala``, ``hmc`` with or without ChEES, ``pcn``)
and replica-exchange SGLD (``sgld``). ``model_spec`` names the model
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
Langevin "l" (L, C) uniform, for regression "eta" (L, C) normal, for
the preconditioned family "u_eta" (L, C) (regression) and "jit" (L, C)
(HMC) uniform, and for the variational reference's regeneration "vr_z"
(L, W+1) normal and "u_regen" (L,) uniform; sgld's "batch" (L, B) int64
minibatch rows (``kernel.step_noise_names``). The default (``step_noise``)
draws pages of steps from a ``torch.Generator`` on the run's device seeded
from (seed, page index), so a step's noise does not depend on
``chunk_steps``. ``ptnn``
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
    # host seconds spent copying the kept trace rows from the device, after
    # the device had finished them (the port's own; ptnn has no such field)
    fetch_s: float = 0.0
    # steps the surrogate took in place of a true evaluation (the port's
    # own: its host decides each step's branch)
    surrogate_steps: int = 0


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


def envelope_w_mask(small, env) -> np.ndarray:
    """{0, 1} float32 parameter mask embedding a ``small = (i, h, o)`` FNN
    in the ``env = (I, H, O)`` envelope, in the flat layout ``[W1, W2, B1,
    B2]``: ptnn's ``sweeps.envelope_w_mask``. A padded hidden unit keeps
    zero outgoing weights, so its sigmoid(0) never reaches a real output,
    and the padded class columns leave the softmax by ``class_mask``."""
    i, h, o = small
    ei, eh, eo = env
    w1 = np.zeros((ei, eh), np.float32)
    w1[:i, :h] = 1.0
    w2 = np.zeros((eh, eo), np.float32)
    w2[:h, :o] = 1.0
    b1 = np.zeros(eh, np.float32)
    b1[:h] = 1.0
    b2 = np.zeros(eo, np.float32)
    b2[:o] = 1.0
    return np.concatenate([w1.ravel(), w2.ravel(), b1, b2])


def make_grid_dataset(cfg: PTConfig, cells, device,
                      envelope: bool = False) -> Dataset:
    """A grid's rows: one ``(train, test, topology)`` a cell, each made by
    ``make_dataset`` at the cell's own topology, then padded to the largest
    set's rows (zero rows after the valid ones, ``mask_train`` /
    ``mask_test``) and, with ``envelope``, to ``cfg.topology``'s columns
    (zero features; the one-hot targets' padded classes out of the softmax
    by ``class_mask``; ``w_mask`` pinning the parameters outside the cell's
    own network at 0): ptnn's ``sweeps.dataset_grid`` and
    ``classification_grid`` padding, a leading cell axis on every array."""
    n_tr = max(tr.shape[0] for tr, _te, _topo in cells)
    n_te = max(te.shape[0] for _tr, te, _topo in cells)
    env = tuple(cfg.topology)
    parts = []
    for train, test, topo in cells:
        d = make_dataset(dataclasses.replace(cfg, topology=tuple(topo)),
                         train, test, device)

        def pad(a, n, cols=None):
            spec = [0, 0] * (a.dim() - 1) + [0, n - a.shape[0]]
            if cols is not None:
                spec[0:2] = [0, cols - a.shape[1]]
            return torch.nn.functional.pad(a, spec)

        def mask(a, n):
            m = torch.zeros((n,), dtype=torch.float32, device=device)
            m[:a.shape[0]] = 1.0
            return m

        part = dict(
            x_train=pad(d.x_train, n_tr, env[0] if envelope else None),
            y_train=pad(d.y_train, n_tr),
            t_train=pad(d.t_train, n_tr, env[2] if envelope else None),
            x_test=pad(d.x_test, n_te, env[0] if envelope else None),
            y_test=pad(d.y_test, n_te),
            mask_train=mask(d.x_train, n_tr), mask_test=mask(d.x_test, n_te))
        if envelope:
            cm = torch.zeros((env[2],), dtype=torch.float32, device=device)
            cm[:topo[2]] = 1.0
            part["class_mask"] = cm
            part["w_mask"] = torch.as_tensor(envelope_w_mask(topo, env),
                                             device=device)
        parts.append(part)
    return Dataset(**{k: torch.stack([p[k] for p in parts])
                      for k in parts[0]})


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


def init_grid(cfg: PTConfig, data: Dataset, seeds,
              spec: Optional[model_api.ModelSpec] = None) -> ChainState:
    """A grid's initial state, one cell a seed: cell k's weights are the
    draws of ``init_chains`` for ``seeds[k]`` (a generator seeded from
    it), so a cell starts where the single run of its seed starts; then
    ``kernel.init_state`` over the whole grid (one evaluation)."""
    dev = data.x_train.device
    spec = spec or kernel.default_spec(cfg)
    ws = []
    for s in seeds:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed_of(s, 0))
        ws.append(torch.randn((cfg.num_chains, spec.w_size), generator=gen,
                              device=dev, dtype=torch.float32))
    return kernel.init_state(cfg, data, init_w=torch.cat(ws), spec=spec,
                             cells=len(seeds))


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
                elapsed: float, fetch_s: float = 0.0,
                surrogate_steps: int = 0) -> SampleResult:
    """The ``SampleResult`` of a finished run: merged traces, the final
    state on the CPU, and ptnn's percentages."""
    final = state.to("cpu")
    samples = cfg.samples_per_chain
    n_prop = int(final.n_swap_proposed)
    regen_pct, regen_prop = None, 0
    if final.n_regen_proposed is not None:
        # the hot rung's regeneration acceptance (ptnn/sampler.py:378-383)
        regen_prop = int(final.n_regen_proposed)
        regen_pct = 100.0 * int(final.n_regen_accepted) / max(regen_prop, 1)
    da_segments, da_accept = 0, None
    if final.da is not None:
        # segments opened, and each chain's share of them accepted at close
        da_segments = int(final.da.n_seg)
        da_accept = final.da.n_seg_accepted.numpy() * 100.0 / max(
            da_segments, 1)
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
        da_segments=da_segments,
        da_accept_per_chain=da_accept,
        pair_swap_accept=final.pair_accept_sum.numpy()[:-1]
        / np.maximum(final.pair_prop_count.numpy()[:-1], 1),
        vr_regen_accept_pct=regen_pct,
        vr_regen_proposed=regen_prop,
        fetch_s=fetch_s,
        surrogate_steps=surrogate_steps,
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


def page_steps(c: int, w: int, n: int = 0) -> int:
    """Steps in one page of the per-step noise: ``PAGE_STEPS``, fewer where
    a page of (steps, C, W) w-noise, or of (steps, N) keys of sgld's
    minibatch permutations, would pass ``PAGE_FLOATS``. A function of the
    run's widths only, never of ``chunk_steps``."""
    return max(1, min(PAGE_STEPS, PAGE_FLOATS // max(c * w, n, 1)))


def _batches(steps: int, batch, gen: torch.Generator, device) -> torch.Tensor:
    """sgld's minibatches of a page, (steps, B) int64: each step's B = ``batch
    [1]`` row indices, a prefix of a uniform permutation of the ``batch[0]``
    train rows (the order of uniform keys), drawn in one sort."""
    n, b = batch
    keys = torch.rand((steps, n), dtype=torch.float32, device=device,
                      generator=gen)
    return torch.argsort(keys, dim=1)[:, :b]


def step_noise(seed: int, device, names,
               batch: Optional[tuple] = None) -> NoiseFn:
    """The per-step sampler's default noise, drawing ``names``
    (``kernel.step_noise_names``); sgld's "batch" and "batch_swap" need
    ``batch`` = (train rows N, rows a batch B). It is drawn in pages of
    ``page_steps`` steps, page p from a ``torch.Generator`` on ``device``
    seeded from (seed, 2, p), each name of a page in one device op, and a
    chunk takes the slices of the pages it covers, so a step's noise
    depends on its absolute index alone: results are invariant to chunking,
    as ptnn's per-step keys make them. The last page drawn is kept for the
    next chunk."""
    gen = torch.Generator(device=device)
    cache: Dict[int, Noise] = {}
    n_rows = 0 if batch is None else batch[0]

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
                vr_z=lambda: torch.randn((steps, w + 1), **f32),
                u_regen=lambda: torch.rand((steps,), **f32),
                u_surr=lambda: torch.rand((steps,), **f32),
                u_seg=lambda: torch.rand((steps, c), **f32),
                batch=lambda: _batches(steps, batch, gen, device),
                batch_swap=lambda: _batches(steps, batch, gen, device),
            )
            cache.clear()
            cache[p] = {name: draw[name]() for name in names}
        return cache[p]

    def noise_fn(start: int, length: int, c: int, w: int) -> Noise:
        steps = page_steps(c, w, n_rows)
        parts = []
        for p in range(start // steps, (start + length - 1) // steps + 1):
            lo = max(start - p * steps, 0)
            hi = min(start + length - p * steps, steps)
            parts.append({k: v[lo:hi] for k, v in page(p, steps, c, w).items()})
        if len(parts) == 1:
            return parts[0]
        return {k: torch.cat([part[k] for part in parts]) for k in parts[0]}

    return noise_fn


# the per-step draws of one chain each (C, ...); the others are the step's
# own (vr_z, u_regen, u_surr) or its pairs' (u_swap)
CHAIN_NOISE = ("w", "l", "eta", "u", "u_eta", "jit", "u_seg")


def grid_noise(seeds, device, names, chains_per_cell: int) -> NoiseFn:
    """A grid's noise, one stream a cell: cell k draws what the single run
    of ``seeds[k]`` draws (``step_noise``), the cells side by side on the
    chain axis, and "u_swap" with one filler uniform (1.0, never below an
    acceptance) for the pair across each cell boundary, which is never
    proposed."""
    streams = [step_noise(s, device, names) for s in seeds]

    def noise_fn(start: int, length: int, c: int, w: int) -> Noise:
        parts = [f(start, length, chains_per_cell, w) for f in streams]
        out = {}
        for name in parts[0]:
            if name == "u_swap":
                fill = torch.ones((length, 1), dtype=torch.float32,
                                  device=device)
                cols = []
                for p in parts:
                    cols += [p[name], fill]
                out[name] = torch.cat(cols[:-1], dim=1)
            elif name in CHAIN_NOISE:
                out[name] = torch.cat([p[name] for p in parts], dim=1)
            else:
                raise ValueError(f"a grid draws no {name!r}")
        return out

    return noise_fn


CloseFn = Callable[[int, int], torch.Tensor]


def close_noise(seed: int, device) -> CloseFn:
    """The uniforms (C,) of a delayed-acceptance segment closed at a chunk
    boundary: ``fn(b, c)`` for the boundary after ``b`` steps (the run's
    end is ``b = n_steps + 1``, as ptnn keys its ``fold_in(k_close, b)``),
    drawn on the CPU from a generator seeded by (seed, 3, b), so they
    depend on the boundary alone and are the same on every device."""

    def fn(b: int, c: int) -> torch.Tensor:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed_of(seed, 3, b))
        return torch.rand((c,), generator=gen).to(device)

    return fn


def thin_rows(rows: List[Dict[str, torch.Tensor]],
              thin: int) -> Dict[str, torch.Tensor]:
    """A chunk's trace rows stacked, keeping local positions ``thin-1,
    2*thin-1, ...`` (``cfg.record_thin``, ptnn/sampler.py:219-223): on the
    device, before any host copy; a chunk shorter than ``thin`` keeps none."""
    kept = rows[thin - 1::thin]
    if not kept:
        return {m: v[None][:0] for m, v in rows[0].items()}
    return {m: torch.stack([r[m] for r in kept]) for m in kept[0]}


@dataclasses.dataclass
class _PerStep:
    cfg: PTConfig
    device: torch.device
    data: Dataset
    temps_host: np.ndarray
    step_fn: kernel.StepFn

    def run(self, state: ChainState, noise_fn: NoiseFn,
            on_chunk: Callable[[Dict[str, torch.Tensor]], None],
            start: int = 0,
            on_boundary: Optional[Callable[[ChainState, int], None]] = None,
            close_fn: Optional[CloseFn] = None,
            ) -> ChainState:
        """Both segments (ptnn/sampler.py:233-330), chunk by chunk, from
        step ``start`` (a chunk boundary: where a checkpoint was saved);
        each chunk's kept trace rows go to ``on_chunk`` and then the state
        and the steps done to ``on_boundary``. The surrogate modes refit
        and re-anchor at the start of every chunk after the first (in place
        of the temper switch's recompute), a delayed-acceptance segment
        still open first closed with ``close_fn``'s uniforms of that
        boundary, and once more at the run's end; a chunk's "u_surr" draws
        come to the host at once."""
        cfg, fn = self.cfg, self.step_fn
        n, switch = cfg.n_steps, cfg.temper_switch_step
        segments = [(0, switch), (switch, n)] if 0 < switch < n else [(0, n)]
        target = max(1, min(cfg.chunk_steps, n))
        c, w = fn.chains, fn.spec.w_size
        surr = fn.surr
        if surr is not None:
            surr.fitted = surr.active = None  # read from this run's state
            surr.taken = 0
        for si, (a, b) in enumerate(segments):
            if start >= b:
                continue
            done = max(a, start)
            if si > 0 and done == a and surr is None:
                state = fn.recompute_ll(state)
            chunk = _pick_chunk(b - a, target)
            while done < b:
                if surr is not None and done > 0:
                    state = fn.refit_anchor(state, done,
                                            lambda: close_fn(done, c))
                length = min(chunk, b - done)
                noise = noise_fn(done, length, c, w)
                if "u_surr" in noise:
                    noise = dict(noise, u_surr=noise["u_surr"].cpu())
                rows: List[Dict[str, torch.Tensor]] = []
                for k in range(length):
                    state, trace = fn.step(
                        state, done + k, {m: v[k] for m, v in noise.items()})
                    rows.append(trace)
                on_chunk(thin_rows(rows, cfg.record_thin))
                done += length
                if on_boundary is not None:
                    on_boundary(state, done)
        if surr is not None and surr.da:
            # a run must not end mid-segment: the final state is a true
            # posterior sample with its true ll
            state = fn.close_segment(state, n - 1, close_fn(n + 1, c))
        return state


def _per_step(cfg: PTConfig, train, test, device,
              model_spec: Optional[model_api.ModelSpec] = None,
              surrogate_proj=None) -> _PerStep:
    device = torch.device(device)
    data = make_dataset(cfg, train, test, device)
    temps_host = ladder.build_temperatures(cfg)
    temps = torch.as_tensor(temps_host, dtype=torch.float32, device=device)
    return _PerStep(cfg, device, data, temps_host,
                    kernel.make_step_fn(cfg, data, temps, model_spec,
                                        surrogate_proj))


def sample_per_step(
    cfg: PTConfig,
    train: np.ndarray,
    test: np.ndarray,
    seed: int = 0,
    device: Any = "cuda",
    init_state: Optional[ChainState] = None,
    noise_fn: Optional[NoiseFn] = None,
    model_spec: Optional[model_api.ModelSpec] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 4,
) -> SampleResult:
    """The per-step sampler; the traces and counters of ptnn's. With
    ``checkpoint_path`` the run saves a checkpoint every
    ``checkpoint_every`` chunks and at its end, and resumes from a matching
    one (same config, seed and model) at its step with its traces
    (ptnn/sampler.py:242-322). A delayed-acceptance segment closed at a
    chunk boundary takes ``close_noise``'s uniforms."""
    from ptnn_torch import checkpoint as ckpt

    eng = _per_step(cfg, train, test, device, model_spec)
    spec_name = eng.step_fn.spec.name
    state = (init_state if init_state is not None
             else init_chains(cfg, eng.data, seed, eng.step_fn.spec))
    if noise_fn is None:
        noise_fn = step_noise(seed, eng.device, kernel.step_noise_names(cfg),
                              eng.step_fn.batch_shape)
    chunks: List[Dict[str, np.ndarray]] = []
    resume_at = 0
    if checkpoint_path is not None:
        loaded = ckpt.load(checkpoint_path, cfg, seed, spec_name, eng.device)
        if loaded is not None:
            state, resume_at, ck_traces = loaded
            if ck_traces:
                chunks.append(ck_traces)
    fetch = [0.0]

    def fetch_chunk(tr: Dict[str, torch.Tensor]) -> None:
        synchronize(eng.device)
        t = time.perf_counter()
        chunks.append({k: v.cpu().numpy() for k, v in tr.items()})
        fetch[0] += time.perf_counter() - t

    def merged() -> Dict[str, np.ndarray]:
        return {k: np.concatenate([ch[k] for ch in chunks])
                for k in chunks[0]}

    since = [0]

    def boundary(st: ChainState, done: int) -> None:
        since[0] += 1
        if since[0] >= checkpoint_every:
            ckpt.save(checkpoint_path, st, done, merged(), cfg, seed,
                      spec_name)
            since[0] = 0

    t0 = time.perf_counter()
    state = eng.run(state, noise_fn, fetch_chunk, start=resume_at,
                    on_boundary=boundary if checkpoint_path else None,
                    close_fn=close_noise(seed, eng.device))
    synchronize(eng.device)
    if checkpoint_path is not None:
        ckpt.save(checkpoint_path, state, cfg.n_steps, merged(), cfg, seed,
                  spec_name)
    elapsed = time.perf_counter() - t0
    surr = eng.step_fn.surr
    return make_result(cfg, merged(), state, eng.temps_host, elapsed,
                       fetch[0], surr.taken if surr is not None else 0)


def throughput_build_per_step(
        cfg: PTConfig, train, test, seed: int = 0, device: Any = "cuda",
        noise_fn: Optional[NoiseFn] = None,
        model_spec: Optional[model_api.ModelSpec] = None):
    """Benchmark protocol of the per-step sampler: ``record_w`` off, traces
    reduced to their sums on the device, every rep from the same initial
    state (and, with the default noise, the same noise)."""
    if cfg.use_surrogate:
        raise ValueError(
            "throughput_run never refits the surrogate (no chunk boundaries);"
            " benchmark surrogate configs through sample()")
    cfg2 = dataclasses.replace(cfg, record_w=False).validate()
    eng = _per_step(cfg2, train, test, device, model_spec)
    state0 = init_chains(cfg2, eng.data, seed, eng.step_fn.spec)
    if noise_fn is None:
        noise_fn = step_noise(seed, eng.device,
                              kernel.step_noise_names(cfg2),
                              eng.step_fn.batch_shape)

    def run():
        sums: Dict[str, torch.Tensor] = {}
        return eng.run(state0, noise_fn, trace_sums(sums)), sums

    return throughput_rep(cfg2, run, eng.device)


def _fused_or_warn(cfg: PTConfig, train, test, model_spec=None,
                   checkpoint: bool = False) -> bool:
    """Whether ``cfg`` takes the fused path; a fused config the fused path
    cannot run (or a checkpointed run) falls back to the per-step sampler
    with a warning."""
    if not cfg.fused_step:
        return False
    from ptnn_torch import fused

    reason = fused.runtime_reason(cfg, train.shape[0], test.shape[0])
    if model_spec is not None and model_spec.fnn_topology is None:
        reason = "fused_step supports the reference FNN spec"
    if checkpoint:  # ptnn/sampler.py:140-147
        reason = ("fused_step does not checkpoint (chunk boundaries are "
                  "swap-aligned, not step-aligned)")
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
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 4,
) -> SampleResult:
    """Run the PT sampler and return its traces and counters. ``noise_fn``
    follows the contract of the path that runs (``fused`` or per-step).
    ``checkpoint_path``: the per-step sampler checkpoints every
    ``checkpoint_every`` chunks and resumes bit-identically from a matching
    checkpoint (``sample_per_step``); a fused config falls back to it."""
    cfg.validate()
    if _fused_or_warn(cfg, train, test, model_spec,
                      checkpoint=checkpoint_path is not None):
        from ptnn_torch import fused

        return fused.sample_fused(cfg, train, test, seed=seed, device=device,
                                  init_state=init_state, noise_fn=noise_fn)
    return sample_per_step(cfg, train, test, seed=seed, device=device,
                           init_state=init_state, noise_fn=noise_fn,
                           model_spec=model_spec,
                           checkpoint_path=checkpoint_path,
                           checkpoint_every=checkpoint_every)


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
