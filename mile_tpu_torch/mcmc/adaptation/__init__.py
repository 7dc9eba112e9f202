"""Sampler adaptation (counterpart of ``mile_tpu.mcmc.adaptation``)."""
