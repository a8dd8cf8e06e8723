"""PyTorch/CUDA port of the FastSwitch reproduction.

Mirrors ``src/repro`` path for path (each module names its JAX
counterpart) and imports neither ``jax`` nor any ``repro`` module.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on a CPU
tensor every hand-written kernel's wrapper takes its plain PyTorch
version, on a CUDA tensor it launches the kernel built from ``csrc/``.
"""
