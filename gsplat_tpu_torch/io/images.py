"""Ground-truth images: decode, encode and a prefetching loader (port of
``gsplat_tpu/io/images.py``).

A background thread decodes images (PIL, RGB float32 / 255) and starts
their copy to the device: into pinned host memory, then a ``non_blocking``
copy, so the transfer overlaps the train step. Images are drawn at random
with replacement, draw ``k`` from ``random.Random(seed * 1_000_003 + k)``
as in the reference, so the port samples the same image sequence. PIL is
imported only when an image is decoded or encoded.

A loader given a ``DecodedImages`` keeps each decoded device tensor under
its path: a later draw of the path takes the same tensor, bit for bit
what a decode would give, with no decode and no copy, so each image is
decoded once (in order of first draws) for the life of the cache. The
cache holds every image or none: at its first insert it compares the
decoded set's bytes (the first image's bytes times the paths it may hold)
with a quarter of the memory free on the image's device, and above that
it turns itself off, and the loader decodes every draw.

Traced (``utils/profiling.py``): spans ``loader.decode`` on the thread,
one a decoded image, its parent the span that made the loader;
``loader.wait`` and ``loader.close`` on the caller's. Counters
``loader.hits`` and ``loader.misses``, one a draw the caller takes: a hit
came from the cache, a miss was decoded.
"""

from __future__ import annotations

import os
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


def _free_bytes(device: torch.device) -> int:
    """Bytes free on ``device``: the card's free memory, or the host's
    available pages for a CPU device."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


class DecodedImages:
    """Decoded images by path, as a loader put them on the device, for as
    long as their owner lives; shared by every loader the owner makes (a
    thread each, so inserts hold a lock). ``n_paths``, the number of paths
    it may hold, bounds it as the module's docstring says."""

    def __init__(self, n_paths: int):
        self._n_paths = n_paths
        self._images: dict[str, torch.Tensor] = {}
        self._on: bool | None = None  # decided at the first insert
        self._lock = threading.Lock()

    def get(self, path: str) -> torch.Tensor | None:
        return self._images.get(path)

    def put(self, path: str, image: torch.Tensor) -> None:
        with self._lock:
            if self._on is None:
                need = image.nelement() * image.element_size() * self._n_paths
                self._on = need <= _free_bytes(image.device) // 4
            if self._on:
                self._images[path] = image


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
        cache: DecodedImages | None = None,
    ):
        """``start`` is the draw counter to resume from (the training
        iteration): draw k depends only on (seed, k), so a resumed run
        samples the image sequence an uninterrupted run would. The loader
        takes draws start, start + stride, ...: rank r of a data-parallel
        batch of B takes draw r of each batch with ``start = k * B + r``,
        ``stride = B`` and decodes no other rank's images. With ``cache``
        a draw takes its path's tensor from there, or decodes it and puts
        it there; a tensor handed out may be handed out again, so no
        caller writes it."""
        self._paths = paths
        self._cache = cache
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
                idx = self._next_index()
                path = self._paths[idx]
                item = self._cache.get(path) if self._cache is not None else None
                hit = item is not None
                if not hit:
                    with profiling.span("loader.decode", parent=self._parent):
                        item = self._to_device(load_image(path))
                    if self._cache is not None:
                        self._cache.put(path, item)
            except Exception as e:  # noqa: BLE001 — surfaced by next(): a
                # dead producer thread would deadlock the training loop.
                item, hit = e, False
            while not self._stop.is_set():
                try:
                    self._q.put((idx, item, hit), timeout=0.5)
                    break
                except queue.Full:
                    continue

    def next(self):
        with profiling.span("loader.wait"):
            idx, item, hit = self._q.get()
        if isinstance(item, Exception):
            raise item
        profiling.count("loader.hits" if hit else "loader.misses")
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
