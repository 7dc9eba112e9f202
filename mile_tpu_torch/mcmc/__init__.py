"""MCMC core (counterpart of ``mile_tpu.mcmc``): MCLMC, HMC and NUTS over
chain batches, their integrators, adaptation and diagnostics."""
from mile_tpu_torch.mcmc import hmc, mclmc, nuts  # noqa: F401
from mile_tpu_torch.mcmc.diagnostics import (  # noqa: F401
    autocovariance,
    effective_sample_size,
    potential_scale_reduction,
)
from mile_tpu_torch.mcmc.integrators import (  # noqa: F401
    EuclideanState,
    IntegratorState,
    isokinetic_leapfrog,
    isokinetic_mclachlan,
    velocity_verlet,
)
