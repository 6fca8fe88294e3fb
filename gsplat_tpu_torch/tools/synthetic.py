"""Synthetic COLMAP dataset generator (port of
``gsplat_tpu/tools/synthetic.py``).

Writes a dataset in the layout the CLI reads
(``<root>/<name>/sparse/0/{cameras,images,points3D}.bin`` and
``images[_f]/`` PNGs), its ground-truth views rendered by the port's
``render_image`` from a procedurally generated Gaussian scene on the
device it is given.

Usage:
  python -m gsplat_tpu_torch.tools.synthetic <out_root> [--views N] [--size WxH]
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..io import images as image_io
from ..io.colmap import (
    Camera, Image, Point3D, rotmat_to_qvec, write_cameras_binary, write_images_binary,
    write_points3d_binary,
)
from ..ops.camera import build_camera_matrices
from ..train.init import GaussianData
from ..train.state import state_from_gaussians
from ..train.step import StepStatics, render_image
from ..train.trainer import require_device


@dataclasses.dataclass
class SyntheticScene:
    root: Path  # dataset root (contains <name>/sparse/0)
    name: str
    cameras: dict
    images: dict
    points_xyz: np.ndarray
    points_rgb: np.ndarray
    true_gaussians: GaussianData


def ring_cameras(n_views: int, width: int, height: int, radius: float = 6.0):
    """Cameras on a ring looking at the origin. Returns (cameras, images)."""
    f = width * 0.9
    cameras = {
        1: Camera(
            id=1, model="PINHOLE", width=width, height=height,
            params=np.array([f, f, width / 2, height / 2], np.float64),
        )
    }
    images = {}
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        cpos = np.array([
            radius * np.sin(ang),
            0.15 * radius * np.sin(2 * ang),
            -radius * np.cos(ang),
        ])
        fwd = -cpos / np.linalg.norm(cpos)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        upv = np.cross(fwd, right)
        R = np.stack([right, upv, fwd], axis=0)  # world -> camera rows
        t = -R @ cpos
        images[i + 1] = Image(
            id=i + 1, qvec=rotmat_to_qvec(R), tvec=t, camera_id=1,
            name=f"view_{i:03d}.png",
            xys=np.zeros((0, 2)), point3d_ids=np.zeros(0, np.int64),
        )
    return cameras, images


def make_true_scene(n: int, seed: int = 7) -> GaussianData:
    """A colourful Gaussian blob cluster around the origin."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * [1.6, 1.0, 1.6]
    rgb = ((rng.uniform(0.1, 0.9, (n, 3)) - 0.5) / 0.28209479).astype(np.float32)
    return GaussianData(
        xyz=xyz,
        rgb=rgb,
        opacity=rng.uniform(1.0, 3.0, n).astype(np.float32),
        scale=np.log(rng.uniform(0.05, 0.2, (n, 3))).astype(np.float32),
        quaternion=np.concatenate(
            [np.ones((n, 1)), 0.3 * rng.normal(size=(n, 3))], 1
        ).astype(np.float32),
    )


def write_synthetic_dataset(
    out_root: str | Path,
    name: str = "synthetic",
    n_views: int = 16,
    width: int = 384,
    height: int = 256,
    n_gaussians: int = 1200,
    n_points: int = 4000,
    point_jitter: float = 0.15,
    downsample_factor: int = 1,
    seed: int = 7,
    device: torch.device | str = "cuda",
) -> SyntheticScene:
    """Write the dataset, rendering on ``device``; returns the scene's
    metadata, its ``Image`` records carrying full image paths."""
    device = require_device(device)
    rng = np.random.default_rng(seed)
    cameras, images = ring_cameras(n_views, width, height)
    true = make_true_scene(n_gaussians, seed=seed)

    root = Path(out_root) / name
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)
    subdir = f"images_{downsample_factor}" if downsample_factor > 1 else "images"
    img_dir = root / subdir
    img_dir.mkdir(parents=True, exist_ok=True)

    params = state_from_gaussians(true, device).params
    cam = cameras[1]
    for im in images.values():
        cm = build_camera_matrices(
            im.qvec, im.tvec, cam.width, cam.height, cam.focal_x, cam.focal_y
        )
        st = StepStatics(
            width=cam.width, height=cam.height, tile=16, l_max=0,
            focal_x=cm.focal_x, focal_y=cm.focal_y,
            tan_fovx=cm.tan_fovx, tan_fovy=cm.tan_fovy,
            near_thresh=0.3, mh_dist=3.0, cull_padding=100, ssim_frac=0.2,
            base_lr=1e-3, xyz_lr_init=0.16, xyz_lr_final=0.0016,
            quat_lr=1.0, scale_lr=5.0, opacity_lr=25.0, rgb_lr=2.5,
            sh_lr=0.125, scene_extent=2.0, num_iters=1,
        )
        img, _ = render_image(params, cm.view, cm.proj, cm.campos, 0.0, st)
        arr = np.clip(img.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
        image_io.save_image(img_dir / im.name, arr)

    # SfM-like point cloud: a jittered subsample of the true centres.
    sel = rng.choice(true.num, size=n_points, replace=True)
    pts_xyz = (
        true.xyz[sel] + rng.normal(size=(n_points, 3)).astype(np.float32) * point_jitter
    ).astype(np.float64)
    pts_rgb = np.clip((true.rgb[sel] * 0.28209479 + 0.5) * 255, 0, 255).astype(np.uint8)
    points = {
        i + 1: Point3D(
            id=i + 1, xyz=pts_xyz[i], rgb=pts_rgb[i], error=0.5,
            image_ids=np.zeros(0, np.int32), point2d_idxs=np.zeros(0, np.int32),
        )
        for i in range(n_points)
    }

    write_cameras_binary(cameras, sparse / "cameras.bin")
    write_images_binary(images, sparse / "images.bin")
    write_points3d_binary(points, sparse / "points3D.bin")
    # The binary writer keeps bare names; the returned records carry full
    # paths, ready for the Trainer.
    for im in images.values():
        im.name = str(img_dir / im.name)
    return SyntheticScene(
        root=Path(out_root), name=name, cameras=cameras, images=images,
        points_xyz=pts_xyz, points_rgb=pts_rgb, true_gaussians=true,
    )


def main(argv=None, device: torch.device | str = "cuda") -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_root")
    p.add_argument("--name", default="synthetic")
    p.add_argument("--views", type=int, default=16)
    p.add_argument("--size", default="384x256")
    p.add_argument("--gaussians", type=int, default=1200)
    p.add_argument("--points", type=int, default=4000)
    args = p.parse_args(argv)
    w, h = (int(x) for x in args.size.split("x"))
    scene = write_synthetic_dataset(
        args.out_root, name=args.name, n_views=args.views, width=w, height=h,
        n_gaussians=args.gaussians, n_points=args.points, device=device,
    )
    print(f"wrote {args.views} views to {scene.root / scene.name}")
    return 0


if __name__ == "__main__":
    main()
