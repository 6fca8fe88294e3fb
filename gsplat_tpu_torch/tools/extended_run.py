"""The extended schedule end to end (port of ``scripts/extended_run.py``).

configs/extended.yaml verbatim, read by the port's ``parse_config``:
30,000 iterations, SH grown to band 3 (a band every 1,000), opacity
resets every 3,000 up to 15,000, density steps from 500 to 15,000 every
100. Only the dataset, output and eval plumbing and the densify threshold
multiplier are overridden. Dataset: the real-texture ``layers`` scene
(``tools/real_plane.py``), held-out eval (``train_real_plane.holdout``).

Usage: python -m gsplat_tpu_torch.tools.extended_run [WxH] [views] [thresh_mul]
           [--photo PATH] [--out DIR]

Writes ``RESULT_EXTENDED.json`` and the dataset under ``--out``, or under
a temporary directory removed at the end. Runs on the card
(``main(argv, device="cpu")`` on the CPU). ``run(max_iters=)`` stops the
loop early (``Trainer.train(max_iters=)``), for tests; the config and its
checks stay extended.yaml's. The 30,000 iterations get no run in
chip_smoke.py: its CPU tests and the dense 7,000-iteration recipe
(``quality_gate``), which trains through the same ``train_holdout``, hold
it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import torch

EXTENDED_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "extended.yaml"


def extended_config(dataset_path: str, output_dir: str | Path, thresh_mul: float = 1.0):
    """configs/extended.yaml with the script's overrides and checks."""
    from ..config import parse_config

    cfg = parse_config(EXTENDED_CONFIG)
    cfg = dataclasses.replace(
        cfg,
        dataset_path=dataset_path, downsample_factor=1,
        print_interval=500, test_eval_interval=3000, test_split_ratio=8,
        output_dir=str(output_dir), strict_reference=False, seed=0,
        uv_grad_threshold=cfg.uv_grad_threshold * thresh_mul,
    )
    if not (cfg.num_iters == 30000 and cfg.max_sh_band == 3
            and cfg.adaptive_control_end == 15000 and cfg.reset_opacity_end == 15000):
        raise ValueError(f"{EXTENDED_CONFIG} is not the extended schedule")
    return cfg


def run(size: tuple = (648, 420), views: int = 32, thresh_mul: float = 1.0, *,
        photo: str | Path, out: str | Path, device: torch.device | str = "cuda",
        max_iters: int | None = None, verbose: bool = False, log=print) -> dict:
    """Write the layers dataset under ``out`` and train extended.yaml on
    it (up to ``max_iters`` if given). Returns the script's result fields
    (``device`` in place of ``backend``) with the texture, the dataset's
    seconds and ``train_real_plane.train_holdout``'s measurements."""
    from .train_real_plane import train_holdout, write_scene

    w, h = size
    root = Path(out) / "extended_run"
    scene, texture, dataset_s = write_scene("layers", root, photo, views, w, h, log=log)
    cfg = extended_config(scene.name, root / "out", thresh_mul)
    res = train_holdout(cfg, scene, device=device, max_iters=max_iters, verbose=verbose,
                        log=log)
    return dict(
        schedule="configs/extended.yaml (verbatim spans)",
        dataset={"layout": "layers", "views": views, "width": w, "height": h},
        num_iters=cfg.num_iters, max_sh_band_reached=res["l_max"],
        uv_grad_threshold=cfg.uv_grad_threshold, wall_s=res["train_seconds"],
        texture=texture, texture_sha256=texture["sha256"], dataset_seconds=dataset_s,
        **res,
    )


def main(argv=None, device: torch.device | str = "cuda") -> int:
    import argparse

    from .real_plane import REFERENCE_PHOTO

    p = argparse.ArgumentParser(prog="python -m gsplat_tpu_torch.tools.extended_run",
                                description="Train configs/extended.yaml on a photo dataset.")
    p.add_argument("size", nargs="?", default="648x420", metavar="WxH")
    p.add_argument("views", type=int, nargs="?", default=32)
    p.add_argument("thresh_mul", type=float, nargs="?", default=1.0)
    p.add_argument("--photo", default=REFERENCE_PHOTO)
    p.add_argument("--out", help="write here and keep it (default: a temporary directory)")
    args = p.parse_args(argv)
    w, h = (int(x) for x in args.size.split("x"))
    with contextlib.ExitStack() as stack:
        out = Path(args.out or stack.enter_context(tempfile.TemporaryDirectory(
            prefix="gsplat_extended_")))
        res = run((w, h), args.views, args.thresh_mul, photo=args.photo, out=out,
                  device=device, verbose=True)
        print(json.dumps(res))
        path = out / "RESULT_EXTENDED.json"
        path.write_text(json.dumps(res, indent=1))
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
