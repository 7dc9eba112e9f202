"""MCMC core (counterpart of ``mile_tpu.mcmc``; MCLMC so far)."""
