"""ptnn_torch: parallel-tempering MCMC for Bayesian neural networks on
PyTorch and CUDA, a port of the JAX package ``ptnn`` beside it.

What runs today are the fused regression samplers: the reference random
walk, preconditioned MALA and preconditioned HMC with ChEES. Each
inter-swap interval is one launch of a hand-written CUDA block kernel
(``csrc/rw_block.cu``, ``mala_block.cu``, ``hmc_block.cu``), built with
``nvcc`` for Hopper at first use. On CPU tensors the same functions run
their plain PyTorch versions. The package imports ``torch`` and never
``jax``.
"""

from ptnn_torch.config import PTConfig, regression_preset
from ptnn_torch.sampler import SampleResult, sample, throughput_runner

__all__ = [
    "PTConfig",
    "regression_preset",
    "SampleResult",
    "sample",
    "throughput_runner",
]
