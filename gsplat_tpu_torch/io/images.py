"""Ground-truth images: decode, encode and a prefetching loader (port of
``gsplat_tpu/io/images.py``).

A background thread decodes images (PIL, RGB float32 / 255) and starts
their copy to the device: into pinned host memory, then a ``non_blocking``
copy, so the transfer overlaps the train step. Images are drawn at random
with replacement, draw ``k`` from ``random.Random(seed * 1_000_003 + k)``
as in the reference, so the port samples the same image sequence. PIL is
imported only when an image is decoded or encoded. Traced (spans of
``utils/profiling.py``): ``loader.decode`` on the thread, one an image,
its parent the span that made the loader; ``loader.wait`` and
``loader.close`` on the caller's.
"""

from __future__ import annotations

import queue
import random
import threading

import numpy as np
import torch

from ..utils import profiling


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]."""
    from PIL import Image as PILImage

    with PILImage.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return arr


def save_image(path, arr: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an image file (PNG by suffix)."""
    from PIL import Image as PILImage

    PILImage.fromarray(np.asarray(arr, dtype=np.uint8)).save(path)


class AsyncImageLoader:
    """Prefetches (image_index, device tensor) pairs on a background thread."""

    def __init__(
        self,
        paths: list[str],
        device: torch.device | str,
        seed: int = 0,
        prefetch: int = 2,
        start: int = 0,
        stride: int = 1,
    ):
        """``start`` is the draw counter to resume from (the training
        iteration): draw k depends only on (seed, k), so a resumed run
        samples the image sequence an uninterrupted run would. The loader
        takes draws start, start + stride, ...: rank r of a data-parallel
        batch of B takes draw r of each batch with ``start = k * B + r``,
        ``stride = B`` and decodes no other rank's images."""
        self._paths = paths
        self._device = torch.device(device)
        self._seed = seed
        self._seq = start
        self._stride = stride
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._parent = profiling.current_span()  # the decode spans' parent
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _next_index(self) -> int:
        k = self._seq
        self._seq += self._stride
        return random.Random(self._seed * 1_000_003 + k).randint(0, len(self._paths) - 1)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
        if self._device.type != "cuda":
            return host.to(self._device)
        return host.pin_memory().to(self._device, non_blocking=True)

    def _loop(self):
        while not self._stop.is_set():
            idx = -1
            try:
                with profiling.span("loader.decode", parent=self._parent):
                    idx = self._next_index()
                    item = self._to_device(load_image(self._paths[idx]))
            except Exception as e:  # noqa: BLE001 — surfaced by next(): a
                # dead producer thread would deadlock the training loop.
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put((idx, item), timeout=0.5)
                    break
                except queue.Full:
                    continue

    def next(self):
        with profiling.span("loader.wait"):
            idx, item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return idx, item

    def close(self):
        with profiling.span("loader.close"):
            self._stop.set()
            # Drain so the producer can leave a blocking put.
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
