"""Hand-written CUDA kernels and their plain PyTorch versions
(counterpart of ``mile_tpu.ops``)."""
