"""Warmstart, sampling runtime, checkpoints and the orchestrator
(counterpart of ``mile_tpu.train``)."""
