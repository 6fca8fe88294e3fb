"""Multi-view training on a photo (port of ``scripts/train_real_plane.py``).

Runs configs/base.yaml's whole schedule (density control, opacity resets,
SH growth, background cycling), scaled to ``iters``, on a real-texture
dataset (``tools/real_plane.py``): a photo texture-mapped onto one plane
(``plane``) or three occluding layers (``layers``), ground truth from
exact numpy projective warping, independent of the splat renderer. Eval
is a true held-out split: the test views are taken out of the train list
(the reference trainer's split keeps them in it).

Usage: python -m gsplat_tpu_torch.tools.train_real_plane [iters] [views] [WxH]
           [plane|layers] [thresh_mul] [--photo PATH] [--out DIR]

``thresh_mul`` multiplies ``uv_grad_threshold``: below 1 it densifies
harder (``layers`` at 0.4 is ``tools/quality_gate.py``'s dense recipe).
Writes ``RESULT_SCALE.json`` and the dataset under ``--out``, or under a
temporary directory removed at the end. Runs on the card
(``main(argv, device="cpu")`` on the CPU). ``quality_gate`` and
``extended_run`` train through ``write_scene`` and ``train_holdout``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

BASE_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "base.yaml"


def recipe_config(iters: int, thresh_mul: float, dataset_path: str,
                  output_dir: str | Path, seed: int | None = None):
    """configs/base.yaml with the script's overrides: its schedule scaled
    by ``iters / num_iters``, ``uv_grad_threshold`` x ``thresh_mul``."""
    from ..config import parse_config

    base = parse_config(BASE_CONFIG)
    frac = iters / base.num_iters

    def s(v):
        return max(1, int(v * frac))

    cfg = dataclasses.replace(
        base,
        dataset_path=dataset_path, downsample_factor=1,
        num_iters=iters, print_interval=max(1, iters // 60),
        test_eval_interval=max(50, iters // 10), test_split_ratio=8,
        adaptive_control_start=s(500), adaptive_control_end=s(5000),
        adaptive_control_interval=max(20, s(100)),
        reset_opacity_start=s(1050), reset_opacity_end=s(5000),
        reset_opacity_interval=s(3000),
        use_background_end=s(2000),
        add_sh_band_interval=max(2, s(1000)),
        output_dir=str(output_dir), strict_reference=False,
        **({} if seed is None else {"seed": seed}),
    )
    return dataclasses.replace(cfg, uv_grad_threshold=cfg.uv_grad_threshold * thresh_mul)


def holdout(trainer) -> None:
    """A true held-out split: the test views leave the train list."""
    test_names = {im.name for im in trainer.test_images}
    trainer.train_images = [im for im in trainer.train_images if im.name not in test_names]


def write_scene(layout: str, root: str | Path, photo: str | Path, views: int, width: int,
                height: int, log=print):
    """The ``plane`` or ``layers`` dataset of ``photo`` under ``root``.
    Returns (scene, the photo's ``real_plane.photo_record``, seconds)."""
    from . import real_plane

    texture = real_plane.photo_record(photo)
    writer = (real_plane.write_real_layers_dataset if layout == "layers"
              else real_plane.write_real_plane_dataset)
    t0 = time.perf_counter()
    scene = writer(root, photo_path=str(photo), n_views=views, width=width, height=height)
    dt = time.perf_counter() - t0
    log(f"dataset: {layout} {views} views {width}x{height} in {dt:.1f}s (texture "
        f"{texture['width']}x{texture['height']}, sha256 {texture['sha256'][:16]})")
    return scene, texture, dt


def train_holdout(cfg, scene, *, device: torch.device | str = "cuda",
                  max_iters: int | None = None, verbose: bool = False, log=print) -> dict:
    """Train ``cfg`` on ``scene`` with the held-out split, recording each
    density step. Returns the run's measurements: the split, the held-out
    PSNR before and after, seconds (device synchronized), iterations a
    second, Gaussians, ``l_max``, the capacities the state passed through,
    the density steps (``train_at_scale.DensityRecord`` fields) and the
    peak allocated MiB (None on the CPU)."""
    from ..train.init import initialize_gaussians
    from ..train.state import num_active
    from ..train.trainer import Trainer, require_device
    from .train_at_scale import _synchronize, record_density

    device = require_device(device)
    g = initialize_gaussians(scene.points_xyz, scene.points_rgb, cfg)
    log(f"init: {g.num} gaussians")
    tr = Trainer(cfg, g, scene.images, scene.cameras, device=device)
    holdout(tr)
    log(f"split: {len(tr.train_images)} train / {len(tr.test_images)} held-out test views")
    psnr_init = tr.evaluate(verbose=False)
    capacities, density = record_density(tr)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        _synchronize(device)
        t0 = time.perf_counter()
        tr.train(max_iters=max_iters, verbose=verbose)
        _synchronize(device)
        dt = time.perf_counter() - t0
    finally:
        del tr._density_step
    peak = torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda" else None
    psnr = tr.evaluate(verbose=False)
    n_alive = num_active(tr.state)
    log(f"trained {tr.iter} iterations in {dt:.1f}s ({tr.iter / dt:.2f} it/s): held-out "
        f"PSNR {psnr_init:.2f} -> {psnr:.2f} dB, {g.num} -> {n_alive} gaussians, "
        f"capacities {capacities}")
    return dict(
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        train_views=[Path(im.name).name for im in tr.train_images],
        test_views=[Path(im.name).name for im in tr.test_images],
        iterations=tr.iter, train_seconds=dt, iters_per_second=tr.iter / dt,
        initial_gaussians=int(g.num), final_gaussians=n_alive, l_max=tr.l_max,
        eval_psnr_db_heldout_init=psnr_init, eval_psnr_db_heldout=psnr,
        capacities=capacities, density=[dataclasses.asdict(d) for d in density],
        peak_mib=peak,
    )


def run(iters: int = 3000, views: int = 24, size: tuple = (648, 420), layout: str = "plane",
        thresh_mul: float = 1.0, *, photo: str | Path, out: str | Path,
        device: torch.device | str = "cuda", verbose: bool = False, log=print) -> dict:
    """Write the dataset under ``out`` and train the scaled schedule on it.
    Returns the script's ``RESULT_SCALE.json`` fields (``device`` in place
    of ``backend``) with the texture, the dataset's seconds and
    ``train_holdout``'s measurements."""
    w, h = size
    root = Path(out) / f"real{layout}_run"
    scene, texture, dataset_s = write_scene(layout, root, photo, views, w, h, log=log)
    cfg = recipe_config(iters, thresh_mul, scene.name, root / "out")
    res = train_holdout(cfg, scene, device=device, verbose=verbose, log=log)
    return dict(
        dataset={"layout": layout, "views": views, "width": w, "height": h,
                 "train_views": len(res["train_views"]),
                 "held_out_test_views": len(res["test_views"])},
        schedule={"num_iters": iters, "uv_grad_threshold": cfg.uv_grad_threshold,
                  "adaptive_control": [cfg.adaptive_control_start, cfg.adaptive_control_end,
                                       cfg.adaptive_control_interval],
                  "reset_opacity_interval": cfg.reset_opacity_interval,
                  "add_sh_band_interval": cfg.add_sh_band_interval},
        texture=texture, texture_sha256=texture["sha256"], dataset_seconds=dataset_s,
        **res,
    )


def main(argv=None, device: torch.device | str = "cuda") -> int:
    import argparse

    from .real_plane import REFERENCE_PHOTO

    p = argparse.ArgumentParser(prog="python -m gsplat_tpu_torch.tools.train_real_plane",
                                description="Train the base schedule on a photo dataset.")
    p.add_argument("iters", type=int, nargs="?", default=3000)
    p.add_argument("views", type=int, nargs="?", default=24)
    p.add_argument("size", nargs="?", default="648x420", metavar="WxH")
    p.add_argument("layout", nargs="?", default="plane", choices=("plane", "layers"))
    p.add_argument("thresh_mul", type=float, nargs="?", default=1.0)
    p.add_argument("--photo", default=REFERENCE_PHOTO)
    p.add_argument("--out", help="write here and keep it (default: a temporary directory)")
    args = p.parse_args(argv)
    w, h = (int(x) for x in args.size.split("x"))
    with contextlib.ExitStack() as stack:
        out = Path(args.out or stack.enter_context(tempfile.TemporaryDirectory(
            prefix="gsplat_real_plane_")))
        res = run(args.iters, args.views, (w, h), args.layout, args.thresh_mul,
                  photo=args.photo, out=out, device=device, verbose=True)
        print(f"RESULT layout={args.layout} iters={args.iters} views={args.views} "
              f"size={w}x{h} train_s={res['train_seconds']:.0f} "
              f"it_s={res['iters_per_second']:.2f} final_gaussians={res['final_gaussians']} "
              f"eval_psnr={res['eval_psnr_db_heldout']:.2f}")
        path = out / "RESULT_SCALE.json"
        path.write_text(json.dumps(res, indent=1))
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
