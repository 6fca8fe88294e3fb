"""PyTorch + CUDA port of ``gsplat_tpu``: the forward render, the training
step and the trainer loop on one camera.

The JAX package ``gsplat_tpu`` is the reference; each module here keeps the
name of its counterpart there. Plain tensor code is PyTorch; the Pallas
kernels of the reference (segment expand, radix sort, forward and backward
rasterizers, segment sum) are hand-written CUDA C++ for Hopper under
``csrc/``, built with ``nvcc`` at first use (``kernels/_build.py``). On a
CPU tensor every kernel wrapper runs its plain PyTorch version instead.
The host side (config, COLMAP, PLY, images, checkpoints) is numpy; the
entry points (``train.trainer.Trainer``, ``cli.main``) run on the card
unless given ``device="cpu"``.

Importing this package imports neither ``jax``, ``gsplat_tpu``, ``yaml``
nor ``PIL``.
"""
