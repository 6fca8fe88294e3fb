"""CLI entry point (port of ``gsplat_tpu/cli.py``):
``python -m gsplat_tpu_torch.cli <config.yaml> <dataset_root>``.

Parses the config, reads the three COLMAP ``.bin`` files from
``<dataset_root>/<dataset_path>/sparse/0/``, initializes Gaussians from the
SfM points (points3D.bin through the native parser of ``io/native.py``,
built at first use), trains, and writes ``<output_dir>/checkpoint.npz`` and
``<output_dir>/trained.ply``. Same flags as the reference: ``--resume
ckpt.npz``, ``--max-iters N``, ``--mip`` (Mip-Splatting, as the config's
``mip_splatting: true``; the PLY then carries ``filter_3D``) and ``--dp N`` (a batch of N cameras a
step) or ``--tp N`` (each step's camera split into N strips of tile rows),
which start N local ranks, one process each, as the reference's one
command uses N local devices: on the card rank r runs on ``cuda:r`` over
NCCL (fewer cards than ranks raises); with ``device="cpu"`` the ranks run
on the CPU over gloo. Rank 0 prints and writes. Runs on the card;
``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

USAGE = ("Usage: python -m gsplat_tpu_torch.cli <config.yaml> <dataset_root> "
         "[--resume ckpt.npz] [--dp N] [--tp N] [--max-iters N] [--mip]")


def main(argv: list[str] | None = None, device: torch.device | str = "cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    def usage() -> int:
        print(USAGE, file=sys.stderr)
        return 1

    def take_flag(name: str, cast):
        """Pop '--name value' from argv: (value or None, error or None)."""
        if name not in argv:
            return None, None
        i = argv.index(name)
        if i + 1 >= len(argv):
            return None, f"{name} needs a value"
        try:
            val = cast(argv[i + 1])
        except ValueError:
            return None, f"{name} got non-{cast.__name__} {argv[i + 1]!r}"
        del argv[i : i + 2]
        return val, None

    vals = {"--mip": "--mip" in argv}
    if vals["--mip"]:
        argv.remove("--mip")
    for name, cast in (("--resume", str), ("--dp", int), ("--tp", int),
                       ("--max-iters", int)):
        vals[name], err = take_flag(name, cast)
        if err is not None:
            print(f"error: {err}", file=sys.stderr)
            return usage()
    dp, tp = vals["--dp"] or 0, vals["--tp"] or 0
    if dp > 1 and tp > 1:
        print("error: --dp and --tp are mutually exclusive", file=sys.stderr)
        return usage()
    if len(argv) != 2:
        return usage()
    world = max(dp, tp)
    if world <= 1:
        return _run(argv, vals, device)
    from .parallel.launch import spawn

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on "
                               "the CPU")
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"{world} ranks exceed the available CUDA devices "
                               f"({torch.cuda.device_count()}): one a rank")
    backend = "nccl" if device.type == "cuda" else "gloo"
    codes = spawn(_rank_main, world, (argv, vals, device.type), backend=backend)
    return max(codes)


def _rank_main(rank: int, argv: list[str], vals: dict, device_type: str) -> int:
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    return _run(argv, vals, device, rank)


def _run(argv: list[str], vals: dict, device, rank: int = 0) -> int:
    """Read, initialize, train and write, as rank ``rank`` of ``--dp``/
    ``--tp`` ranks (or alone)."""
    say = print if rank == 0 else (lambda *a, **k: None)
    from .config import parse_config, parse_mip
    from .io import native
    from .io.colmap import read_cameras_binary, read_images_binary
    from .train.init import initialize_gaussians
    from .train.trainer import Trainer

    config = parse_config(argv[0])
    mip = vals["--mip"] or parse_mip(argv[0])
    root = Path(argv[1]) / config.dataset_path
    sparse = root / "sparse" / "0"

    say(f"Loading COLMAP reconstruction from {sparse} ...")
    cameras = read_cameras_binary(sparse / "cameras.bin", config.downsample_factor)
    images = read_images_binary(sparse / "images.bin", str(root) + "/",
                                config.downsample_factor)
    xyz, rgb, _, _ = native.parse_points3d(sparse / "points3D.bin")
    say(f"  {len(cameras)} cameras, {len(images)} images, {xyz.shape[0]} points")
    t0 = time.time()
    gaussians = initialize_gaussians(xyz, rgb, config)
    say(f"Initialized {gaussians.num} gaussians in {time.time() - t0:.2f}s")

    trainer = Trainer(config, gaussians, images, cameras, device=device,
                      dp=vals["--dp"] or 0, tp=vals["--tp"] or 0, mip=mip)
    if vals["--resume"] is not None:
        trainer.load_checkpoint(vals["--resume"])
        say(f"Resumed from {vals['--resume']} at iteration {trainer.iter}")
    trainer.train(max_iters=vals["--max-iters"], verbose=rank == 0)
    if rank != 0:
        return 0
    out = Path(config.output_dir)
    ck = out / "checkpoint.npz"
    trainer.save_checkpoint(ck)
    print(f"Saved checkpoint to {ck}")
    out.mkdir(parents=True, exist_ok=True)
    trainer.save_to_ply(out / "trained.ply")
    print(f"Saved PLY to {out / 'trained.ply'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
