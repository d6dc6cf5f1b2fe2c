"""ptnn_torch: parallel-tempering MCMC for Bayesian neural networks on
PyTorch and CUDA, a port of the JAX package ``ptnn`` beside it.

Two samplers run today, for regression and classification:

* the fused samplers (``fused_step=True``): the reference random walk,
  preconditioned MALA and preconditioned HMC with ChEES; each inter-swap
  interval is one launch of a hand-written CUDA block kernel
  (``csrc/rw_block.cu``, ``mala_block.cu``, ``hmc_block.cu`` and their
  classification twins ``rw_cls_block.cu``, ``mala_cls_block.cu``,
  ``hmc_cls_block.cu``);
* the per-step sampler (``fused_step=False``, and the fallback for fused
  configs the fused path cannot run): the reference proposal with or
  without the paper's Langevin-gradient drift (``qratio`` "reference" or
  "ldpt_legacy"), and the preconditioned family (``precond_rw``,
  ``precond_mala``, ``hmc`` with or without ChEES, ``pcn``). Each step
  launches the drift kernel (``csrc/drift_epoch.cu``, twice with Langevin
  gradients) and the FNN eval kernel (``csrc/fnn_eval.cu``, once for the
  train and the test rows; the test rows alone under MALA and HMC, whose
  train likelihood comes with its gradient). With
  ``model_spec=`` it runs the model zoo instead: ``models.mlp.spec`` (a deep
  MLP) and ``models.cnn.spec`` (the Bayesian CNN), whose drift is a gradient
  step by autograd (``grad_drift``) and, for ``cnn.digits_spec(fused_eval=
  True)``, whose eval's first stage is ``csrc/conv1_relu_pool.cu``.
  ``python -m ptnn_torch.experiments.cnn_digits`` is the CNN's driver and
  ``results`` writes a run's artifact tree.

Both keep every ``record_thin``-th trace row when asked. The per-step
sampler checkpoints (``checkpoint``: ``sample(checkpoint_path=...)``) and
resumes bit-identically. ``python -m ptnn_torch.experiments.regression`` and
``.classification`` are the paper's command lines (``experiments.runner``),
and ``python -m ptnn_torch.predict`` serves a finished run, with WAIC /
PSIS-LOO (``ops.ic``) and calibration scores (``ops.calibrate``).

The per-step sampler runs the variational-reference path
(``variational_reference``, ``ops.vref``: the corrected tempering path, the
T = inf rung regenerated IID), records the per-rung state likelihood
(``record_ll_state``) that ``ops.evidence`` integrates into the ladder's
(absolute, on a corrected path) log evidence, and the posterior-predictive
traces (``record_fx``). ``tuning.tune_ladder`` re-spaces a ladder at equal
communication-barrier increments from pilot runs, ``rounds.run_rounds``
adapts a static reference over rounds, and ``mcmc`` is the single-chain
sampler with its uncertainty bands (``python -m
ptnn_torch.experiments.single_chain``).

Surrogate-assisted PT runs on the per-step sampler (``use_surrogate``,
``surrogate``: a quadratic ridge or a one-hidden-layer MLP surrogate of the
train likelihood, fitted globally or per rung on a ring of true
evaluations, refitted at every chunk boundary): the anchored mode takes a
step's likelihood from the surrogate and skips its eval launch, exact
delayed acceptance runs surrogate segments without the eval or the drift
and corrects each with one true-likelihood test. ``auto`` is the one-call
pipeline (``python -m ptnn_torch.auto``): a pilot's communication barrier
sizes and spaces the ladder, the chain budget becomes replicated ladders,
the target picks ChEES-HMC or preconditioned MALA on the fused kernels
where the fused gate admits them, and seeded replications report the
cross-seed function-space R-hat.

The kernels are built with ``nvcc`` for Hopper at first use. On CPU tensors
the same functions run their plain PyTorch versions. The served predictor
is ``predict.posterior_predict``. The package imports ``torch`` and never
``jax``, and keeps its own copies of ptnn's NumPy modules (``config``,
``data``, ``ops.ladder``, ``ops.roundtrip``, ``ops.ess``,
``ops.calibrate``, the NumPy half of ``ops.ic``).
"""

from ptnn_torch.config import (PTConfig, classification_preset,
                               regression_preset)
from ptnn_torch import (checkpoint, data, mcmc, results, rounds, sweeps,
                        tuning)
from ptnn_torch.kernel import ChainState, Dataset, init_state, make_step_fn
from ptnn_torch.models import cnn, mlp
from ptnn_torch.models.api import ModelSpec, fnn_spec, grad_drift
from ptnn_torch.sampler import (SampleResult, make_dataset, sample,
                                throughput_run, throughput_runner)

__all__ = [
    "PTConfig",
    "classification_preset",
    "regression_preset",
    "ModelSpec",
    "fnn_spec",
    "grad_drift",
    "cnn",
    "mlp",
    "checkpoint",
    "data",
    "mcmc",
    "results",
    "rounds",
    "sweeps",
    "tuning",
    "ChainState",
    "Dataset",
    "init_state",
    "make_step_fn",
    "SampleResult",
    "make_dataset",
    "sample",
    "throughput_run",
    "throughput_runner",
    "auto",
]


def __getattr__(name):
    # ``auto`` is a ``python -m`` entry point: importing it with the package
    # would make runpy warn that it pre-exists in sys.modules, so it loads
    # on first access
    if name == "auto":
        import importlib

        return importlib.import_module("ptnn_torch.auto")
    raise AttributeError(f"module 'ptnn_torch' has no attribute {name!r}")

# ptnn's exports the port does not have yet, with the ROADMAP item that
# brings each (tests/test_torch_import.py holds ptnn.__all__ to this set
# and __all__ together)
NOT_PORTED = {
    "profiling": "Queue 1 item 15: jax.profiler's wrapper, not to be ported",
}
