"""Seeded quality gate on a photo (port of ``scripts/quality_gate.py``).

The recipe is fixed: the real-texture ``layers`` dataset
(``tools/real_plane.py``), 32 views at 1296x840, 7,000 iterations of
configs/base.yaml's schedule (``train_real_plane.recipe_config``) with
``uv_grad_threshold`` x0.4, seed 0, held-out eval
(``train_real_plane.holdout``).

``gate`` holds the held-out PSNR against the best prior
``RESULT_QUALITY_r*.json`` under the output directory that was made on
the same texture (equal ``texture_sha256``). Without one, the baseline is
the JAX package's ``RESULT_SCALE_DENSE.json`` (28.881 dB, measured on the
reference photo) when the photo is ``real_plane.REFERENCE_PHOTO``, else
none. A drop of more than PSNR_REGRESSION_DB fails the gate and ``main``
exits 1.

Usage: python -m gsplat_tpu_torch.tools.quality_gate [round_number] [iters]
           [--photo PATH] [--out DIR]

``round_number`` defaults to the next free ``rNN`` under ``--out``;
``iters`` defaults to 7,000, and a run of any other length (a smoke test
of the harness) never writes a gate artifact. Without ``--out`` it writes
into a temporary directory removed at the end (so no prior result is
found there). Runs on the card (``main(argv, device="cpu")`` on the CPU).
"""

from __future__ import annotations

import contextlib
import json
import re
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
PSNR_REGRESSION_DB = 0.3
# The JAX package's dense run on the reference photo (a TPU run).
FALLBACK_RESULT = REPO / "RESULT_SCALE_DENSE.json"

# Fixed recipe (not tuned per run: that is the point of the gate).
VIEWS = 32
W, H = 1296, 840
ITERS = 7000
THRESH_MUL = 0.4
SEED = 0


def _results(out_dir: Path):
    """(round number, path) of each ``RESULT_QUALITY_rNN.json`` there."""
    for p in sorted(Path(out_dir).glob("RESULT_QUALITY_r*.json")):
        m = re.fullmatch(r"RESULT_QUALITY_r(\d+)\.json", p.name)
        if m:
            yield int(m.group(1)), p


def prior_best_psnr(out_dir: str | Path, sha256: str, photo: str | Path) -> tuple:
    """(best prior held-out PSNR, its source) among the results under
    ``out_dir`` made on the texture ``sha256``; else the fallback."""
    best, src = None, ""
    for _, p in _results(out_dir):
        try:
            prior = json.loads(p.read_text())
        except (OSError, ValueError):
            continue
        v = prior.get("eval_psnr_db_heldout")
        if prior.get("texture_sha256") == sha256 and v is not None and (
                best is None or v > best):
            best, src = float(v), p.name
    if best is not None:
        return best, src
    from .real_plane import REFERENCE_PHOTO

    if Path(photo).resolve() == Path(REFERENCE_PHOTO).resolve():
        return (float(json.loads(FALLBACK_RESULT.read_text())["eval_psnr_db_heldout"]),
                FALLBACK_RESULT.name)
    return 0.0, "none"


def next_round_slot(out_dir: str | Path) -> int:
    rounds = [r for r, _ in _results(out_dir)]
    return max(rounds) + 1 if rounds else 5


def gate(result: dict, out_dir: str | Path) -> tuple:
    """(ok, best, source): ``result``'s held-out PSNR against the best
    prior result of its texture under ``out_dir``."""
    best, src = prior_best_psnr(out_dir, result["texture_sha256"], result["texture"]["path"])
    return result["eval_psnr_db_heldout"] >= best - PSNR_REGRESSION_DB, best, src


def run(iters: int = ITERS, *, photo: str | Path, out: str | Path,
        device: torch.device | str = "cuda", verbose: bool = False, log=print) -> dict:
    """Write the recipe's dataset under ``out`` and train it. Returns the
    script's result fields without the gate's (``device`` in place of
    ``backend``), the texture, the dataset's seconds and
    ``train_real_plane.train_holdout``'s measurements."""
    from .train_real_plane import recipe_config, train_holdout, write_scene

    root = Path(out) / "quality_gate_run"
    scene, texture, dataset_s = write_scene("layers", root, photo, VIEWS, W, H, log=log)
    cfg = recipe_config(iters, THRESH_MUL, scene.name, root / "out", seed=SEED)
    res = train_holdout(cfg, scene, device=device, verbose=verbose, log=log)
    return dict(
        recipe={"layout": "layers", "views": VIEWS, "width": W, "height": H,
                "num_iters": iters, "uv_grad_threshold": cfg.uv_grad_threshold,
                "seed": SEED},
        wall_s=res["train_seconds"], texture=texture, texture_sha256=texture["sha256"],
        dataset_seconds=dataset_s, **res,
    )


def main(argv=None, device: torch.device | str = "cuda") -> int:
    import argparse

    from .real_plane import REFERENCE_PHOTO

    p = argparse.ArgumentParser(prog="python -m gsplat_tpu_torch.tools.quality_gate",
                                description="Train the fixed dense recipe and gate its PSNR.")
    p.add_argument("round_number", type=int, nargs="?")
    p.add_argument("iters", type=int, nargs="?", default=ITERS)
    p.add_argument("--photo", default=REFERENCE_PHOTO)
    p.add_argument("--out", help="write here and keep it (default: a temporary directory)")
    args = p.parse_args(argv)
    with contextlib.ExitStack() as stack:
        out = Path(args.out or stack.enter_context(tempfile.TemporaryDirectory(
            prefix="gsplat_quality_gate_")))
        rnd = args.round_number if args.round_number is not None else next_round_slot(out)
        res = run(args.iters, photo=args.photo, out=out, device=device, verbose=True)
        ok, best, src = gate(res, out)
        res.update(prior_best_psnr_db=best, prior_best_source=src,
                   regression_gate_db=PSNR_REGRESSION_DB, gate_ok=bool(ok))
        if args.iters == ITERS:
            path = out / f"RESULT_QUALITY_r{rnd:02d}.json"
            path.write_text(json.dumps(res, indent=1))
            print(f"wrote {path}")
        print(json.dumps(res))
        psnr = res["eval_psnr_db_heldout"]
        if not ok:
            print(f"QUALITY GATE FAILED: {psnr:.2f} dB < prior best {best:.2f} ({src}) - "
                  f"{PSNR_REGRESSION_DB}", file=sys.stderr)
            return 1
        print(f"QUALITY GATE OK: {psnr:.2f} dB (prior best {best:.2f}, {src})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
