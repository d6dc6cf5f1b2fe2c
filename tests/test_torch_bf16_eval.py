"""The bfloat16 eval (``eval_dtype="bfloat16"``) on the port's per-step
sampler against ptnn's.

ptnn casts w and x to bfloat16 for the evals' forward, returns float32
outputs and keeps every likelihood reduction, the prior, the MH decision
and the drift in float32 (ptnn/kernel.py:217-242); it keeps the mode off its
Pallas evals and off the fused path. The port's ``kernel.eval_forward``
does the same with a plain bfloat16 forward, for the reference FNN and any
zoo spec, and launches no float32 eval kernel in its place. Held here: the
forward against ptnn's bfloat16 forward (tests/test_bf16_eval.py's atol
2e-2); a sampler run in bfloat16 statistically within that file's bounds
of the float32 run; the fused gate's refusal in ptnn's words; the evals of
the FNN, train, test and both, taking no float32 eval; a zoo spec and the
bench arms running.

``PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/test_torch_bf16_eval.py
ARM SEED...`` runs ptnn's sampler on the CPU at ``chip_smoke.py``'s bf16 arm
ARM (``chip_smoke.BF16_ARMS``: scripts/bench_modes.py's ``bf16_eval`` and
``da_mala_bf16``) and prints one JSON line a seed
(``chip_smoke.surrogate_stats``): the source of the smoke's bands.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptnn
import ptnn_torch
from ptnn import fused as jfused
from ptnn.data import load_regression
from ptnn.models import fnn as jfnn
from ptnn_torch import fused, kernel
from ptnn_torch.models import api, fnn, mlp
from ptnn_torch.ops import fnn_eval

torch.set_num_threads(1)


def _cfg(**kw):
    """tests/test_bf16_eval.py's configuration: Sunspot, 8 chains, maxtemp
    3, swaps every 30, the random walk, chunks of 100."""
    base = dict(task="regression", topology=(4, 10, 1), num_samples=8 * 600,
                num_chains=8, maxtemp=3.0, swap_interval=30, swap_offset=0,
                swap_payload="tempered_times_T",
                use_langevin_gradients=False, chunk_steps=100,
                eval_dtype="bfloat16")
    base.update(kw)
    return ptnn_torch.PTConfig(**base).validate()


@pytest.mark.parametrize("topo", [(4, 10, 1), (4, 12, 3)])
def test_bf16_forward_close_to_ptnn(rng, topo):
    """The evals' forward under bfloat16 against ptnn's bfloat16 forward
    (``Precision.DEFAULT``) and against float32, at bfloat16's rounding
    (atol 2e-2, tests/test_bf16_eval.py:42)."""
    w = rng.standard_normal((3, fnn.w_size(topo))).astype(np.float32)
    x = rng.standard_normal((64, topo[0])).astype(np.float32)
    task = "regression" if topo[2] == 1 else "classification"
    cfg = _cfg(task=task, topology=topo)
    got = kernel.eval_forward(cfg, kernel.default_spec(cfg),
                              torch.from_numpy(w), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 64, topo[2])
    for c in range(3):
        bf = jfnn.forward(jnp.asarray(w[c]).astype(jnp.bfloat16),
                          jnp.asarray(x).astype(jnp.bfloat16), topo,
                          precision=jax.lax.Precision.DEFAULT
                          ).astype(jnp.float32)
        f32 = jfnn.forward(jnp.asarray(w[c]), jnp.asarray(x), topo)
        np.testing.assert_allclose(got[c].numpy(), np.asarray(bf), atol=2e-2)
        np.testing.assert_allclose(got[c].numpy(), np.asarray(f32),
                                   atol=2e-2)
    # float32 evals keep the float32 forward
    f32cfg = dataclasses.replace(cfg, eval_dtype="float32")
    full = kernel.eval_forward(f32cfg, kernel.default_spec(f32cfg),
                               torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(full.numpy(), fnn.batched_forward(
        torch.from_numpy(w), torch.from_numpy(x), topo).numpy())


def test_bf16_sampler_matches_f32_statistically():
    """The bfloat16-eval run reaches the float32 run's cold-chain fit, its
    likelihood level within the bfloat16 error's scale
    (tests/test_bf16_eval.py's bounds), every ll finite."""
    prob = load_regression("Sunspot")
    cfg = _cfg()
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=0, device="cpu")
    base = ptnn_torch.sample(dataclasses.replace(cfg, eval_dtype="float32"),
                             prob.train, prob.test, seed=0, device="cpu")
    assert np.isfinite(res.traces["ll"][1:]).all()
    r_bf = float(res.traces["rmse_test"][-1, 0])
    r_f32 = float(base.traces["rmse_test"][-1, 0])
    assert r_bf < 0.2 and r_f32 < 0.2, (r_bf, r_f32)
    tail_bf = res.traces["ll"][-100:, 0].mean()
    tail_f32 = base.traces["ll"][-100:, 0].mean()
    assert abs(tail_bf - tail_f32) < 0.15 * abs(tail_f32) + 20.0, (
        tail_bf, tail_f32)
    # the same noise, another eval: the runs part
    assert not np.array_equal(res.traces["ll"], base.traces["ll"])


def test_bf16_fused_gate_refuses_in_ptnn_words():
    """A fused bfloat16 config fails ``validate`` in both packages with
    ptnn's words, and the port's fused gate names it alike
    (ptnn/fused.py:106)."""
    kw = dict(task="regression", topology=(4, 10, 1), num_samples=8 * 60,
              num_chains=8, swap_interval=10, fused_step=True,
              eval_dtype="bfloat16")
    for pkg in (ptnn, ptnn_torch):
        with pytest.raises(ValueError, match="fused_step is float32-only"):
            pkg.PTConfig(**kw).validate()
    cfg = ptnn_torch.PTConfig(**dict(kw, fused_step=False))
    jcfg = ptnn.PTConfig(**dict(kw, fused_step=False))
    assert fused.fused_reason(cfg) == jfused.fused_reason(jcfg) \
        == "fused_step is float32-only"


def test_bf16_evals_take_no_float32_eval(monkeypatch):
    """Under bfloat16 ``spec_eval`` and ``spec_eval_pair`` never reach the
    float32 eval (its wrappers replaced by ones that raise), and give the
    likelihood of the bfloat16 forward; in float32 they take it."""
    prob = load_regression("Sunspot")
    cfg = _cfg()
    data = ptnn_torch.make_dataset(cfg, prob.train, prob.test, "cpu")
    spec = kernel.default_spec(cfg)
    gen = torch.Generator().manual_seed(3)
    w = torch.randn((8, spec.w_size), generator=gen)
    tau = torch.full((8,), 0.05)

    def refuse(*a, **k):
        raise AssertionError("a float32 eval under bfloat16")

    calls = []
    real = kernel.fnn_eval
    monkeypatch.setattr(kernel, "fnn_eval", refuse)
    monkeypatch.setattr(kernel, "fnn_eval_pair", refuse)
    ll, rmse, acc = kernel.spec_eval(cfg, spec, w, data.x_train,
                                     data.y_train, tau)
    (ll2, _r, _a), (_l, rmse_te, _b) = kernel.spec_eval_pair(
        cfg, spec, w, data.x_train, data.y_train, data.x_test, data.y_test,
        tau)
    assert torch.equal(ll, ll2) and not acc.any()
    fx = kernel.eval_forward(cfg, spec, w, data.x_train)[:, :, 0]
    want = torch.sqrt(torch.mean(torch.square(fx - data.y_train), dim=-1))
    np.testing.assert_allclose(rmse.numpy(), want.numpy(), rtol=1e-6)
    f_ll, f_rmse, _ = fnn_eval.fnn_eval(w, data.x_train, data.y_train, tau,
                                        (4, 10, 1), "regression")
    assert not torch.equal(ll, f_ll)  # bfloat16 rounding, not float32's
    np.testing.assert_allclose(rmse.numpy(), f_rmse.numpy(), atol=2e-2)
    monkeypatch.setattr(kernel, "fnn_eval",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kernel.spec_eval(dataclasses.replace(cfg, eval_dtype="float32"), spec, w,
                     data.x_train, data.y_train, tau)
    assert calls == [1]


@pytest.mark.parametrize("arm", ["bf16_eval", "da_mala_bf16"])
def test_bench_arms_run(arm):
    """scripts/bench_modes.py's two bfloat16 arms (``chip_smoke.BF16_ARMS``)
    at 8 chains x 40 steps: Langevin gradients (the drift in float32), and
    delayed acceptance with MALA inner moves; finite, and every ported
    feature of them runs (``step_reason``)."""
    import chip_smoke

    cfg = chip_smoke.bf16_cfg(arm, chains=8, samples=40, chunk_steps=10,
                              surrogate_buffer=256, surrogate_proj=8)
    assert kernel.step_reason(cfg) is None and cfg.eval_dtype == "bfloat16"
    prob = load_regression("Sunspot")
    res = ptnn_torch.sample(cfg, prob.train, prob.test, seed=1, device="cpu")
    assert np.isfinite(res.traces["ll"]).all()
    assert np.isfinite(res.traces["rmse_test"]).all()
    assert 0.0 < res.accept_ratio_per_chain.mean() <= 100.0


def test_bf16_zoo_spec_runs():
    """A zoo spec under bfloat16: its own forward in bfloat16, the
    likelihood in float32 (ptnn's ``fwd_b`` around ``spec.forward``)."""
    from ptnn_torch.data import load_digits

    prob = load_digits(0)
    cfg = ptnn_torch.classification_preset(
        (64, 16, 10), num_samples=8 * 6, num_chains=8, maxtemp=3.0,
        use_langevin_gradients=True, learn_rate=0.02)
    cfg = dataclasses.replace(cfg, swap_interval=3, record_w=False,
                              eval_dtype="bfloat16").validate()
    spec = mlp.spec((64, 8, 10))
    assert kernel.step_reason(cfg, spec) is None
    res = ptnn_torch.sample(cfg, prob.train[:32], prob.test[:16],
                            device="cpu", model_spec=spec)
    assert np.isfinite(res.traces["ll"]).all()
    w = res.final_state.w
    out = kernel.eval_forward(cfg, spec, w, torch.from_numpy(
        prob.test[:16, :64].astype(np.float32)))
    assert out.dtype == torch.float32
    assert isinstance(spec, api.ModelSpec)


def arm_reference(arm: str, seed: int) -> dict:
    """ptnn's run of ``chip_smoke``'s bf16 arm on the CPU."""
    import chip_smoke

    cfg = chip_smoke.bf16_cfg(arm)
    prob = load_regression("Sunspot")
    jcfg = ptnn.PTConfig(**dataclasses.asdict(cfg)).validate()
    res = ptnn.sample(jcfg, prob.train, prob.test, seed=seed)
    return dict(arm=arm, seed=seed, **chip_smoke.surrogate_stats(res))


if __name__ == "__main__":
    import json
    import sys

    for s in sys.argv[2:]:
        print(json.dumps(arm_reference(sys.argv[1], int(s))), flush=True)
