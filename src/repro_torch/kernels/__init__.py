"""Hand-written CUDA kernels of the port (sources in ``../csrc``), their
plain PyTorch versions, and the wrappers that pick between them by the
tensor's device."""
