"""Metrics and posterior-predictive evaluation (counterpart of
``mile_tpu.inference``)."""
