"""Garden-scale stability run (port of ``scripts/train_at_scale.py``).

A stand-in for training Mip-NeRF 360's garden at a quarter of its size
(1296x840): a synthetic scene at that resolution with a long schedule.
``tools/synthetic.py`` renders 24 views of 6,000 true Gaussians; a fresh
model starts from a 20,000-point cloud (jitter 0.1) and trains through the
whole ``Trainer`` towards ``max_gaussians`` 2,000,000: density steps every
100 iterations after 300 until ``iters - 300`` (growing the capacity
when the Gaussians outgrow it), the opacity reset of ``reset_opacity_start`` 900 and
``reset_opacity_interval`` 1500 (it fires at 1500), an SH band every 500
up to 3, eval and image dumps every 500. Reports the eval PSNR before and
after, iterations a second, the capacities the state passed through and
each density step's counts, then writes a PLY and a checkpoint.

Usage: python -m gsplat_tpu_torch.tools.train_at_scale [iters] [width height] [--out DIR]

From its 20,000 points the state stays within its first capacity bucket
(32,768) on this scene; ``run(n_points=2000)`` grows it through 4,096,
8,192 and 16,384.

Runs on the card (``main(argv, device="cpu")`` on the CPU). Writes into a
temporary directory that is removed at the end, or into ``--out DIR``,
which is kept.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BASE_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "base.yaml"


def scale_config(iters: int, output_dir: str | Path):
    """``configs/base.yaml`` with the reference script's overrides."""
    from ..config import parse_config

    return dataclasses.replace(
        parse_config(BASE_CONFIG),
        dataset_path="scene", downsample_factor=1,
        num_iters=iters, max_gaussians=2_000_000,
        print_interval=500, test_eval_interval=500,
        adaptive_control_start=300, adaptive_control_interval=100,
        adaptive_control_end=max(iters - 300, 301),
        reset_opacity_start=900, reset_opacity_interval=1500,
        reset_opacity_end=max(iters - 300, 901),
        add_sh_band_interval=500, max_sh_band=3,
        use_background=False, output_dir=str(output_dir),
        test_split_ratio=8, seed=11, strict_reference=False,
    )


@dataclasses.dataclass
class DensityRecord:
    iteration: int
    pruned: int
    cloned: int
    split: int
    new_total: int
    applied: bool
    capacity_before: int
    capacity_after: int
    ms: float  # the step with its growth and Morton sort, device synchronized


@dataclasses.dataclass
class ScaleRunResult:
    iters: int
    width: int
    height: int
    wall_s: float  # Trainer.train, device synchronized
    psnr_init: float
    psnr_final: float
    gaussians_init: int
    gaussians_final: int
    l_max: int
    capacities: list  # the initial capacity, then each one the state grew to
    density: list  # DensityRecord of each density step
    ply: Path
    checkpoint: Path
    # to go on from: the trainer and the Gaussians it was built from
    trainer: object = dataclasses.field(default=None, repr=False)
    gaussians: object = dataclasses.field(default=None, repr=False)

    @property
    def it_per_s(self) -> float:
        return self.iters / self.wall_s

    def summary(self) -> dict:
        """The reference script's RESULT fields (its ``pair_cap_final``
        has no counterpart), plus the capacities and density steps."""
        return dict(
            iters=self.iters, wall_s=self.wall_s, it_per_s=self.it_per_s,
            psnr_init=self.psnr_init, psnr_final=self.psnr_final,
            gaussians_final=self.gaussians_final, l_max=self.l_max,
            resolution=f"{self.width}x{self.height}", gaussians_init=self.gaussians_init,
            capacities=self.capacities,
            density=[[d.iteration, d.pruned, d.cloned, d.split, d.new_total, d.applied,
                      d.capacity_after] for d in self.density],
        )


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def record_density(trainer) -> tuple[list, list]:
    """Record each of ``trainer``'s density steps as it trains.

    Returns (capacities, density): the initial capacity, then each one
    the state grows to, and a ``DensityRecord`` of each step, appended as
    the steps run. ``del trainer._density_step`` stops the recording."""
    device = trainer.device
    capacities = [trainer.state.capacity]
    density = []
    real_density = trainer._density_step

    def density_step():
        before = trainer.state.capacity
        _synchronize(device)
        t = time.perf_counter()
        info = real_density()
        _synchronize(device)
        after = trainer.state.capacity
        if after != before:
            capacities.append(after)
        density.append(DensityRecord(
            iteration=trainer.iter, pruned=info.num_pruned, cloned=info.num_cloned,
            split=info.num_split, new_total=info.new_total, applied=info.applied,
            capacity_before=before, capacity_after=after,
            ms=1e3 * (time.perf_counter() - t)))
        return info

    trainer._density_step = density_step
    return capacities, density


def run(iters: int = 2000, width: int = 1296, height: int = 840, *, root: str | Path,
        device: torch.device | str = "cuda", n_views: int = 24, n_gaussians: int = 6000,
        n_points: int = 20000, overrides: dict | None = None, verbose: bool = False,
        log=print) -> ScaleRunResult:
    """Write the dataset under ``root``, train ``iters`` iterations and
    write ``root/final.ply`` and ``root/final.npz``. ``overrides``: config
    fields to set after ``scale_config``'s (a shorter schedule)."""
    from ..io.colmap import read_cameras_binary, read_images_binary, read_points3d_binary
    from ..train.init import initialize_gaussians
    from ..train.state import num_active
    from ..train.trainer import Trainer, require_device
    from .synthetic import write_synthetic_dataset

    device = require_device(device)
    root = Path(root)
    t0 = time.perf_counter()
    write_synthetic_dataset(
        root, name="scene", n_views=n_views, width=width, height=height,
        n_gaussians=n_gaussians, n_points=n_points, point_jitter=0.1, device=device,
    )
    log(f"dataset written in {time.perf_counter() - t0:.1f}s")
    cfg = dataclasses.replace(scale_config(iters, root / "out"), **(overrides or {}))

    sparse = root / "scene" / "sparse" / "0"
    cameras = read_cameras_binary(sparse / "cameras.bin", 1)
    images = read_images_binary(sparse / "images.bin", str(root / "scene") + "/", 1)
    points = read_points3d_binary(sparse / "points3D.bin")
    xyz = np.stack([p.xyz for p in points.values()])
    rgb = np.stack([p.rgb for p in points.values()])
    g = initialize_gaussians(xyz, rgb, cfg)
    trainer = Trainer(cfg, g, images, cameras, device=device)

    capacities, density = record_density(trainer)
    p0 = trainer.evaluate(verbose=False)
    log(f"init: {g.num} gaussians, PSNR {p0:.2f} dB, capacity {trainer.state.capacity}")
    try:
        _synchronize(device)
        t0 = time.perf_counter()
        trainer.train(verbose=verbose)
        _synchronize(device)
        dt = time.perf_counter() - t0
    finally:
        del trainer._density_step
    p1 = trainer.evaluate(verbose=False)
    alive = num_active(trainer.state)
    ply, ck = root / "final.ply", root / "final.npz"
    trainer.save_to_ply(ply)
    trainer.save_checkpoint(ck)
    res = ScaleRunResult(
        iters=iters, width=width, height=height, wall_s=dt, psnr_init=p0, psnr_final=p1,
        gaussians_init=g.num, gaussians_final=alive, l_max=trainer.l_max,
        capacities=capacities, density=density, ply=ply, checkpoint=ck, trainer=trainer,
        gaussians=g)
    log(f"after {iters} iters ({dt:.1f}s, {res.it_per_s:.2f} it/s): PSNR {p1:.2f} dB, "
        f"{alive} gaussians, capacities {capacities}, l_max={trainer.l_max}")
    return res


def main(argv=None, device: torch.device | str = "cuda") -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m gsplat_tpu_torch.tools.train_at_scale",
                                description="Train a garden-scale synthetic scene.")
    p.add_argument("iters", type=int, nargs="?", default=2000)
    p.add_argument("size", type=int, nargs="*", metavar="W H", default=[1296, 840])
    p.add_argument("--out", help="write here and keep it (default: a temporary directory)")
    args = p.parse_args(argv)
    if len(args.size) != 2:
        p.error("give both width and height")
    with contextlib.ExitStack() as stack:
        root = args.out or stack.enter_context(tempfile.TemporaryDirectory(
            prefix="gsplat_scale_"))
        print(f"dataset dir: {root}")
        res = run(args.iters, *args.size, root=root, device=device, verbose=True)
        print("RESULT " + json.dumps(res.summary()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
