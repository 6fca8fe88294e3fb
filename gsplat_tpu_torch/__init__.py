"""PyTorch + CUDA port of ``gsplat_tpu``'s forward render path.

The JAX package ``gsplat_tpu`` is the reference; each module here keeps the
name of its counterpart there. Plain tensor code is PyTorch; the three
Pallas kernels on the forward render path (segment expand, tile sort,
forward rasterizer) are hand-written CUDA C++ for Hopper under ``csrc/``,
built with ``nvcc`` at first use (``kernels/_build.py``). On a CPU tensor
every kernel wrapper runs its plain PyTorch version instead.

Importing this package imports neither ``jax`` nor ``gsplat_tpu``.
"""
