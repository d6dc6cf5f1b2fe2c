"""ptnn_torch: parallel-tempering MCMC for Bayesian neural networks on
PyTorch and CUDA, a port of the JAX package ``ptnn`` beside it.

What runs today are the fused samplers, for regression and classification:
the reference random walk, preconditioned MALA and preconditioned HMC with
ChEES. Each inter-swap interval is one launch of a hand-written CUDA block
kernel (``csrc/rw_block.cu``, ``mala_block.cu``, ``hmc_block.cu`` and their
classification twins ``rw_cls_block.cu``, ``mala_cls_block.cu``,
``hmc_cls_block.cu``), built with ``nvcc`` for Hopper at first use. On CPU
tensors the same functions run their plain PyTorch versions. The served
predictor is ``predict.posterior_predict``. The package imports ``torch``
and never ``jax``, and keeps its own copies of ptnn's NumPy modules
(``config``, ``data``, ``ops.ladder``, ``ops.roundtrip``, ``ops.ess``).
"""

from ptnn_torch.config import (PTConfig, classification_preset,
                               regression_preset)
from ptnn_torch.sampler import SampleResult, sample, throughput_runner

__all__ = [
    "PTConfig",
    "classification_preset",
    "regression_preset",
    "SampleResult",
    "sample",
    "throughput_runner",
]
