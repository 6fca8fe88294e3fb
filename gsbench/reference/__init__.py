"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy (SciPy's kd-tree for the trainer's initial
scales). It imports nothing of ``gsplat_tpu_torch``, ``gsplat_tpu`` or
``jax``, and takes nothing the program made: it works its cameras, its
start state, its binning and its images out again from what the benchmark
hands both sides (the seed's scene, the poses, the ground truths).

It follows the semantics of the measured step in its default packed mode:
pair attributes rounded as the packed stream carries them (f16
tile-relative u, v, bf16 conic and opacity, e5s9 colour), the per-pair
gradient rows carried as packed words, everything else in float32. The
formulas are a frozen copy of the program's plain path as it stood when
the benchmark was written (``packing.py``, ``kernels/rasterize.py``'s
plain versions, ``ops/binning.py``, ``ops/projection.py``,
``ops/covariance.py``, ``ops/sh.py``, ``ops/loss.py``, ``ops/adam.py``),
so a later change to the program cannot move the yardstick. Where the
plain path loops over every tile, the copy skips the tiles whose pixels
have all terminated (exact: such tiles change no output), so that the
reference fits a run's time at a million Gaussians.

``low=True`` computes the per-Gaussian chain in bfloat16: the precision
control that a correct comparison must reject.
"""
