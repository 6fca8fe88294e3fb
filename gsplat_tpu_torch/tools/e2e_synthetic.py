"""End-to-end convergence run on a synthetic scene (port of
``scripts/e2e_synthetic.py``).

Renders 16 views (384x256) of a 1,200-Gaussian ground-truth scene with
``tools/synthetic.py``, then trains a fresh model from a jittered
4,000-point cloud through the whole ``Trainer`` (density control, SH
bands, PLY export) and checks that the eval PSNR rises by more than 6 dB:
a stand-in for a captured dataset such as Mip-NeRF 360's garden.

Usage: python -m gsplat_tpu_torch.tools.e2e_synthetic [iters] [--out DIR]

Runs on the card (``main(argv, device="cpu")`` on the CPU). Writes into a
temporary directory that is removed at the end, or into ``--out DIR``,
which is kept.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import tempfile
import time
from pathlib import Path

import torch

BASE_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "base.yaml"
MIN_GAIN_DB = 6.0


@dataclasses.dataclass
class E2EResult:
    iters: int
    psnr_before: float
    psnr_after: float
    seconds: float  # the Trainer.train call, device synchronized
    initial_gaussians: int
    final_gaussians: int
    l_max: int
    ply_bytes: int
    trainer: object = dataclasses.field(default=None, repr=False)  # to train on

    @property
    def gain_db(self) -> float:
        return self.psnr_after - self.psnr_before

    @property
    def iters_per_s(self) -> float:
        return self.iters / self.seconds


def e2e_config(iters: int, output_dir: str | Path):
    """``configs/base.yaml`` with the recipe's schedule: density steps from
    150 every 100 until ``iters - 100``, no opacity reset, an SH band every
    200 up to 2, no background, every 8th view held out."""
    from ..config import parse_config

    return dataclasses.replace(
        parse_config(BASE_CONFIG),
        dataset_path="scene", downsample_factor=1,
        num_iters=iters, max_gaussians=200_000,
        print_interval=10 ** 9, test_eval_interval=10 ** 9,
        adaptive_control_start=150, adaptive_control_interval=100,
        adaptive_control_end=max(iters - 100, 151),
        reset_opacity_start=10 ** 9, reset_opacity_interval=10 ** 9,
        reset_opacity_end=10 ** 9,
        add_sh_band_interval=200, max_sh_band=2,
        use_background=False, output_dir=str(output_dir),
        test_split_ratio=8, seed=3, strict_reference=False,
    )


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(iters: int = 600, *, root: str | Path, device: torch.device | str = "cuda",
        n_views: int = 16, width: int = 384, height: int = 256, n_gaussians: int = 1200,
        n_points: int = 4000, timers=None, log=print) -> E2EResult:
    """Write the dataset under ``root``, train ``iters`` iterations and
    export ``root/final.ply``. ``timers``: a ``utils.profiling.StageTimers``
    that times each stage (dataset, init, trainer, evaluate, train,
    save_ply)."""
    from ..train.init import initialize_gaussians
    from ..train.state import num_active
    from ..train.trainer import Trainer, require_device
    from .synthetic import write_synthetic_dataset

    device = require_device(device)
    root = Path(root)

    def stage(name):
        if timers is None:
            return contextlib.nullcontext()
        return timers.stage(name)

    with stage("dataset"):
        scene = write_synthetic_dataset(
            root, name="scene", n_views=n_views, width=width, height=height,
            n_gaussians=n_gaussians, n_points=n_points, device=device,
        )
        _synchronize(device)
    log(f"GT views rendered to {root / 'scene'}")
    cfg = e2e_config(iters, root / "out")
    with stage("init"):
        gaussians = initialize_gaussians(scene.points_xyz, scene.points_rgb, cfg)
    with stage("trainer"):
        trainer = Trainer(cfg, gaussians, scene.images, scene.cameras, device=device)
    with stage("evaluate"):
        p0 = trainer.evaluate(verbose=False)
    log(f"init: {gaussians.num} gaussians, eval PSNR {p0:.2f} dB")
    with stage("train"):
        _synchronize(device)
        t0 = time.perf_counter()
        trainer.train(verbose=False)
        _synchronize(device)
        dt = time.perf_counter() - t0
    with stage("evaluate"):
        p1 = trainer.evaluate(verbose=False)
    alive = num_active(trainer.state)
    log(f"after {iters} iters ({dt:.1f}s, {iters / dt:.1f} it/s): eval PSNR {p1:.2f} dB, "
        f"{alive} gaussians, l_max={trainer.l_max}")
    ply = root / "final.ply"
    with stage("save_ply"):
        trainer.save_to_ply(ply)
    log(f"PLY saved: {ply.stat().st_size} bytes")
    return E2EResult(iters=iters, psnr_before=p0, psnr_after=p1, seconds=dt,
                     initial_gaussians=gaussians.num, final_gaussians=alive,
                     l_max=trainer.l_max, ply_bytes=ply.stat().st_size, trainer=trainer)


def main(argv=None, device: torch.device | str = "cuda") -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m gsplat_tpu_torch.tools.e2e_synthetic",
                                description="Train a synthetic scene end to end.")
    p.add_argument("iters", type=int, nargs="?", default=600)
    p.add_argument("--out", help="write here and keep it (default: a temporary directory)")
    args = p.parse_args(argv)
    with contextlib.ExitStack() as stack:
        root = args.out or stack.enter_context(tempfile.TemporaryDirectory(
            prefix="gsplat_e2e_"))
        res = run(args.iters, root=root, device=device)
    if res.gain_db <= MIN_GAIN_DB:
        print(f"insufficient convergence: {res.psnr_before:.2f} -> {res.psnr_after:.2f} dB",
              file=sys.stderr)
        return 1
    print("E2E CONVERGENCE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
