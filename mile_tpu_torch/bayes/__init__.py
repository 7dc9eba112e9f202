"""Priors and the flat-parameter posterior (counterpart of ``mile_tpu.bayes``)."""
from mile_tpu_torch.bayes.posterior import BayesianModel  # noqa: F401
from mile_tpu_torch.bayes.priors import Prior  # noqa: F401
