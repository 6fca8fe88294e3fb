"""Single-image overfit on a photo (port of ``scripts/overfit_real.py``).

One camera looks at the photo itself: N Gaussians (10,000 by default)
seeded on a plane in front of it, coloured by the photo, SH degree 3
active from the start, no density control, a fixed camera, and
the train step on the photo as the target (``get_train_step`` at the
script's pair cap: a CUDA graph on the card). Overfitting one photo
exercises real image statistics (texture, edges, exposure) that a
self-rendered synthetic target cannot. Reports the PSNR every 200
iterations and at the end, the pairs, and ms a step.

Usage: python -m gsplat_tpu_torch.tools.overfit_real [iters] [n_gaussians]
           [--photo PATH] [--out DIR]

The script's ``StepStatics`` (its pair cap ``round_pair_cap(30 N)``, the
row cap derived from it) without ``chunk`` (the port picks its own
blocking).
Runs on the card (``main(argv, device="cpu")`` on the CPU). Writes
``RESULT_OVERFIT.json`` under ``--out`` when it is given, else nothing.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPORT_EVERY = 200


def overfit_setup(gt_np: np.ndarray, n: int, iters: int):
    """The script's start for a (H, W, 3) photo: (GaussianData, camera
    matrices, StepStatics), its numpy draws in its order (seed 0)."""
    from ..ops.camera import build_camera_matrices
    from ..train.init import GaussianData
    from ..train.state import round_pair_cap
    from ..train.step import StepStatics

    H, W = gt_np.shape[:2]
    N = n
    rng = np.random.default_rng(0)
    # Gaussians seeded on a plane in front of the camera, coloured by the
    # image (an SfM-free start for a single-view overfit).
    z0 = 4.0
    focal = W * 0.9
    xs = rng.uniform(0, W, N)
    ys = rng.uniform(0, H, N)
    xyz = np.stack(
        [
            (xs - W / 2) / focal * z0,
            (ys - H / 2) / focal * z0,
            np.full(N, z0) + rng.normal(0, 0.05, N),
        ],
        axis=1,
    ).astype(np.float32)
    C0 = 0.28209479177387814
    rgb0 = gt_np[np.clip(ys.astype(int), 0, H - 1), np.clip(xs.astype(int), 0, W - 1)]
    g = GaussianData(
        xyz=xyz,
        rgb=((rgb0 - 0.5) / C0).astype(np.float32),
        opacity=np.full(N, 0.0, np.float32),
        scale=np.log(np.full((N, 3), 2.0 * z0 / focal * (10_000 / N) ** 0.5)).astype(
            np.float32),
        quaternion=np.concatenate([np.ones((N, 1)), np.zeros((N, 3))], axis=1).astype(
            np.float32),
    )
    cm = build_camera_matrices(np.array([1.0, 0, 0, 0]), np.zeros(3), W, H, focal, focal)
    st = StepStatics(
        width=W, height=H, tile=16, l_max=3,
        focal_x=cm.focal_x, focal_y=cm.focal_y,
        tan_fovx=cm.tan_fovx, tan_fovy=cm.tan_fovy,
        near_thresh=0.3, mh_dist=3.0, cull_padding=100, ssim_frac=0.2,
        base_lr=1e-3, xyz_lr_init=0.16, xyz_lr_final=0.0016,
        quat_lr=1.0, scale_lr=5.0, opacity_lr=25.0, rgb_lr=2.5, sh_lr=0.125,
        scene_extent=1.0, num_iters=max(iters, 1), pair_cap=round_pair_cap(30 * N),
    )
    return g, cm, st


def run(iters: int = 2000, n: int = 10_000, *, photo: str | Path,
        device: torch.device | str = "cuda", log=print) -> dict:
    """Overfit ``n`` Gaussians to ``photo`` for ``iters`` steps. Returns
    the (iteration, loss, PSNR, pairs) of every REPORT_EVERY-th step and
    the last, every step's loss, ms a step (CUDA events on the card, the
    host clock on the CPU, both around the whole loop), the peak
    allocated MiB (None on the CPU) and the texture's record."""
    from ..io.images import load_image
    from ..train.state import round_capacity, state_from_gaussians
    from ..train.step import get_train_step
    from ..train.trainer import require_device
    from .real_plane import photo_record

    device = require_device(device)
    texture = photo_record(photo)
    gt_np = load_image(str(photo))
    H, W = gt_np.shape[:2]
    log(f"photo {photo}: {W}x{H}, sha256 {texture['sha256'][:16]}")
    g, cm, st = overfit_setup(gt_np, n, iters)
    state = state_from_gaussians(g, device, n_cap=round_capacity(n))
    gt = torch.as_tensor(gt_np, device=device)
    view, proj, campos = (torch.as_tensor(x, device=device)
                          for x in (cm.view, cm.proj, cm.campos))
    step = get_train_step(st)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        start.record()
    t0 = time.perf_counter()
    losses, reports = [], []
    for i in range(iters):
        state, m = step(state, view, proj, campos, gt, 0.0, i)
        losses.append(m.loss)
        if i % REPORT_EVERY == 0 or i == iters - 1:
            reports.append((i, float(m.loss), float(m.psnr), int(m.num_pairs)))
            log(f"iter {i:5d} loss {reports[-1][1]:.4f} PSNR {reports[-1][2]:6.2f} pairs "
                f"{reports[-1][3]} ({time.perf_counter() - t0:.0f}s)")
            if int(m.overflow) > st.pair_cap:
                log("  (pair overflow: results undercount)")
    if cuda:
        end.record()
        end.synchronize()
        total_ms = start.elapsed_time(end)
    else:
        total_ms = 1e3 * (time.perf_counter() - t0)
    log(f"final PSNR on the photo: {reports[-1][2]:.2f} dB")
    return dict(
        device=torch.cuda.get_device_name(device) if cuda else "cpu",
        iters=iters, gaussians=n, width=W, height=H, capacity=state.capacity,
        texture=texture, texture_sha256=texture["sha256"], reports=reports,
        losses=torch.stack(losses).cpu().tolist() if losses else [],
        psnr_final=reports[-1][2] if reports else None,
        ms_per_step=total_ms / max(iters, 1),
        peak_mib=torch.cuda.max_memory_allocated(device) / 2**20 if cuda else None,
    )


def main(argv=None, device: torch.device | str = "cuda") -> int:
    import argparse

    from .real_plane import REFERENCE_PHOTO

    p = argparse.ArgumentParser(prog="python -m gsplat_tpu_torch.tools.overfit_real",
                                description="Overfit Gaussians to one photo.")
    p.add_argument("iters", type=int, nargs="?", default=2000)
    p.add_argument("n_gaussians", type=int, nargs="?", default=10_000)
    p.add_argument("--photo", default=REFERENCE_PHOTO)
    p.add_argument("--out", help="write RESULT_OVERFIT.json here")
    args = p.parse_args(argv)
    res = run(args.iters, args.n_gaussians, photo=args.photo, device=device)
    print(f"{res['ms_per_step']:.3f} ms a step over {res['iters']} steps")
    if args.out:
        path = Path(args.out) / "RESULT_OVERFIT.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(res, indent=1))
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
