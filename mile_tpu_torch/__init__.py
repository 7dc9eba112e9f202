"""MILE in PyTorch for NVIDIA Hopper: the port of ``mile_tpu``.

Bayesian deep learning via ensemble MCMC: warm-start a deep ensemble, tune
and run MCLMC chains from its members, evaluate the posterior predictive.
The package mirrors ``mile_tpu``'s sub-packages and module names; it
imports ``torch``, numpy and yaml, never JAX or ``mile_tpu``. The two
kernels of the MCLMC step are hand-written CUDA (``csrc/isokinetic.cu``),
built with nvcc at first use.
"""
__version__ = '0.1.0'
