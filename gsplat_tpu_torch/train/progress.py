"""stderr progress bar (port of ``gsplat_tpu/train/progress.py``):
percent done, iteration, loss, number of Gaussians, elapsed seconds."""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, total: int, width: int = 30, stream=None):
        self.total = total
        self.width = width
        self.start = time.time()
        self.stream = stream or sys.stderr

    def update(self, iteration: int, loss: float, num_gaussians: int):
        frac = (iteration + 1) / max(self.total, 1)
        filled = int(self.width * frac)
        bar = "#" * filled + "-" * (self.width - filled)
        elapsed = time.time() - self.start
        self.stream.write(
            f"\r[{bar}] {100 * frac:5.1f}% iter {iteration + 1}/{self.total} "
            f"loss {loss:.5f} gaussians {num_gaussians} {elapsed:6.1f}s"
        )
        self.stream.flush()

    def finish(self):
        self.stream.write("\n")
        self.stream.flush()
