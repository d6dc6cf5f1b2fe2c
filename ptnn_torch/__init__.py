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

The kernels are built with ``nvcc`` for Hopper at first use. On CPU tensors
the same functions run their plain PyTorch versions. The served predictor
is ``predict.posterior_predict``. The package imports ``torch`` and never
``jax``, and keeps its own copies of ptnn's NumPy modules (``config``,
``data``, ``ops.ladder``, ``ops.roundtrip``, ``ops.ess``).
"""

from ptnn_torch.config import (PTConfig, classification_preset,
                               regression_preset)
from ptnn_torch import data, results
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
    "data",
    "results",
    "ChainState",
    "Dataset",
    "init_state",
    "make_step_fn",
    "SampleResult",
    "make_dataset",
    "sample",
    "throughput_run",
    "throughput_runner",
]

# ptnn's exports the port does not have yet, with the ROADMAP item that
# brings each (tests/test_torch_import.py holds ptnn.__all__ to this set
# and __all__ together)
NOT_PORTED = {
    "checkpoint": "Queue 1 item 10: bit-exact checkpoints",
    "mcmc": "Queue 1 item 10: the single-chain samplers",
    "profiling": "Queue 1 item 15: jax.profiler's wrapper, not to be ported",
    "sweeps": "Queue 1 item 13: sweeps",
    "tuning": "Queue 1 item 13: ladder tuning",
}
