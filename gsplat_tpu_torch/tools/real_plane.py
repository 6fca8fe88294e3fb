"""Multi-view real-texture datasets: photos on textured planes (port of
``gsplat_tpu/tools/real_plane.py``, numpy as there).

A photo is texture-mapped onto planes in 3D, and each view's ground truth
comes from exact projective texture mapping: numpy ray-plane
intersection and bilinear sampling, independent of the splatting
renderer (unlike ``tools/synthetic.py``, whose ground truth the renderer
makes itself). Training against it exercises real image statistics and
true multi-view consistency: parallax, foreshortening, fine texture seen
from several angles.

Two scene layouts:
- ``plane`` (``write_real_plane_dataset``): the photo on one z = 0 plane,
  exactly representable by flat Gaussians, so converged PSNR is a clean
  quality signal.
- ``layers`` (``write_real_layers_dataset``): three occluding textured
  rectangles at different depths and orientations: depth-sorted
  compositing, occlusion boundaries and parallax between layers.

The layout is the CLI's (``<root>/<name>/sparse/0/*.bin`` and
``images/``), written with the port's ``io/colmap.py`` writers and
``io/images.save_image``. The texture is ``photo_path`` (PIL reads it;
PIL is imported only here): by default ``REFERENCE_PHOTO``, the reference
photo where the repository keeps its assets.

Usage:
  python -m gsplat_tpu_torch.tools.real_plane <out_root> [--views N]
      [--size WxH] [--layout plane|layers] [--photo PATH]
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..io import images as image_io
from ..io.colmap import (
    Camera, Image, Point3D, qvec_to_rotmat, rotmat_to_qvec, write_cameras_binary,
    write_images_binary, write_points3d_binary,
)

REFERENCE_PHOTO = str(Path(__file__).resolve().parents[2] / "assets" / "overview.jpg")
# Views rendered at once by the dataset writers (a 1296x840 view, 2x
# supersampled, holds several float64 arrays of 4.4M rays while it renders).
WRITER_THREADS = 8


def photo_record(photo_path: str | Path) -> dict:
    """What identifies a texture in a result: its path, the sha256 and
    size of its bytes, and its pixel size. Raises ``FileNotFoundError``
    naming the path when there is no such file."""
    path = Path(photo_path)
    if not path.is_file():
        raise FileNotFoundError(f"photo not found: {path}")
    data = path.read_bytes()
    from PIL import Image as PILImage

    with PILImage.open(path) as im:
        width, height = im.size
    return dict(path=str(path), sha256=hashlib.sha256(data).hexdigest(), bytes=len(data),
                width=width, height=height)


@dataclasses.dataclass
class RealPlaneScene:
    root: Path
    name: str
    cameras: dict
    images: dict
    points_xyz: np.ndarray
    points_rgb: np.ndarray
    texture: np.ndarray  # (th, tw, 3) float32 in [0, 1]
    half_extent: tuple  # (ax, ay) world half-extents of the plane


def _cap_cameras(n_views: int, width: int, height: int, radius: float,
                 max_tilt: float = 0.55, seed: int = 3):
    """Cameras on a spherical cap on the -z side, looking at the origin.

    Deterministic golden-angle spiral over the cap so views spread evenly
    in azimuth and tilt (tilt up to ``max_tilt`` rad off the plane
    normal) — enough obliquity for real foreshortening, not so much that
    the plane is edge-on."""
    f = width * 1.1
    cameras = {
        1: Camera(
            id=1, model="PINHOLE", width=width, height=height,
            params=np.array([f, f, width / 2, height / 2], np.float64),
        )
    }
    rng = np.random.default_rng(seed)
    images = {}
    golden = np.pi * (3.0 - np.sqrt(5.0))
    for i in range(n_views):
        frac = (i + 0.5) / n_views
        tilt = max_tilt * np.sqrt(frac)
        az = golden * i + rng.uniform(0, 0.2)
        cpos = radius * np.array([
            np.sin(tilt) * np.cos(az),
            np.sin(tilt) * np.sin(az),
            -np.cos(tilt),
        ])
        fwd = -cpos / np.linalg.norm(cpos)  # camera +z looks at origin
        up = np.array([0.0, -1.0, 0.0])
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


def _bilinear(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear texture sample; (u, v) in pixel coordinates."""
    th, tw = tex.shape[:2]
    u0 = np.clip(np.floor(u).astype(np.int64), 0, tw - 2)
    v0 = np.clip(np.floor(v).astype(np.int64), 0, th - 2)
    fu = np.clip(u - u0, 0.0, 1.0)[..., None]
    fv = np.clip(v - v0, 0.0, 1.0)[..., None]
    c00 = tex[v0, u0]
    c01 = tex[v0, u0 + 1]
    c10 = tex[v0 + 1, u0]
    c11 = tex[v0 + 1, u0 + 1]
    return (
        c00 * (1 - fu) * (1 - fv) + c01 * fu * (1 - fv)
        + c10 * (1 - fu) * fv + c11 * fu * fv
    )


def render_plane_view(
    texture: np.ndarray,  # (th, tw, 3) f32 [0,1]
    half_extent: tuple,  # (ax, ay)
    qvec: np.ndarray, tvec: np.ndarray,
    width: int, height: int, focal: float,
    supersample: int = 2,
    background: float = 0.0,
) -> np.ndarray:
    """Exact projective texture mapping of the z=0 plane (numpy).

    Rays through (supersampled) pixel centers intersect the plane z=0;
    hits inside the textured rectangle sample the photo bilinearly,
    misses get the background. The box-filtered supersample keeps the GT
    alias-free so converged PSNR measures reconstruction, not aliasing.
    """
    R = qvec_to_rotmat(qvec)  # world -> camera
    campos = -R.T @ tvec
    s = supersample
    w_s, h_s = width * s, height * s
    cx, cy = width / 2.0, height / 2.0
    px = (np.arange(w_s) + 0.5) / s
    py = (np.arange(h_s) + 0.5) / s
    gx, gy = np.meshgrid(px, py)
    d_cam = np.stack(
        [(gx - cx) / focal, (gy - cy) / focal, np.ones_like(gx)], axis=-1
    )
    d_world = d_cam @ R  # == R.T @ d per pixel
    dz = d_world[..., 2]
    dz = np.where(np.abs(dz) < 1e-12, 1e-12, dz)
    t_hit = (0.0 - campos[2]) / dz
    hit = t_hit > 0
    x = campos[0] + t_hit * d_world[..., 0]
    y = campos[1] + t_hit * d_world[..., 1]
    ax, ay = half_extent
    th, tw = texture.shape[:2]
    inside = hit & (np.abs(x) <= ax) & (np.abs(y) <= ay)
    u = (x / ax * 0.5 + 0.5) * (tw - 1)
    v = (y / ay * 0.5 + 0.5) * (th - 1)
    img = np.full((h_s, w_s, 3), background, np.float32)
    img[inside] = _bilinear(texture, u[inside], v[inside]).astype(np.float32)
    # Box-filter the supersampled image down to (height, width).
    img = img.reshape(height, s, width, s, 3).mean(axis=(1, 3))
    return img


@dataclasses.dataclass
class PlaneSpec:
    """An oriented, bounded, textured rectangle in world space."""

    origin: np.ndarray  # (3,) center
    ex: np.ndarray  # (3,) unit in-plane x axis
    ey: np.ndarray  # (3,) unit in-plane y axis (orthogonal to ex)
    half: tuple  # (ax, ay) half-extents along ex/ey
    texture: np.ndarray  # (th, tw, 3) f32 [0,1]

    @property
    def normal(self) -> np.ndarray:
        return np.cross(self.ex, self.ey)


def render_layered_view(
    planes: list,  # list[PlaneSpec], composited by nearest hit
    qvec: np.ndarray, tvec: np.ndarray,
    width: int, height: int, focal: float,
    supersample: int = 2,
    background: float = 0.0,
) -> np.ndarray:
    """Exact nearest-hit rendering of several textured rectangles (numpy).

    Same ray machinery as render_plane_view, generalized to oriented
    planes with a z-buffer over the plane list — true occlusion and
    parallax between depth layers, still fully independent of the splat
    renderer."""
    R = qvec_to_rotmat(qvec)  # world -> camera
    campos = -R.T @ tvec
    s = supersample
    w_s, h_s = width * s, height * s
    cx, cy = width / 2.0, height / 2.0
    px = (np.arange(w_s) + 0.5) / s
    py = (np.arange(h_s) + 0.5) / s
    gx, gy = np.meshgrid(px, py)
    d_world = np.stack(
        [(gx - cx) / focal, (gy - cy) / focal, np.ones_like(gx)], axis=-1
    ) @ R
    img = np.full((h_s, w_s, 3), background, np.float32)
    zbuf = np.full((h_s, w_s), np.inf, np.float64)
    for p in planes:
        n = p.normal
        denom = d_world @ n
        denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        t_hit = ((p.origin - campos) @ n) / denom
        pt = campos + t_hit[..., None] * d_world
        rel = pt - p.origin
        x = rel @ p.ex
        y = rel @ p.ey
        ax, ay = p.half
        th, tw = p.texture.shape[:2]
        inside = (
            (t_hit > 1e-6) & (np.abs(x) <= ax) & (np.abs(y) <= ay)
            & (t_hit < zbuf)
        )
        u = (x / ax * 0.5 + 0.5) * (tw - 1)
        v = (y / ay * 0.5 + 0.5) * (th - 1)
        img[inside] = _bilinear(
            p.texture, u[inside], v[inside]
        ).astype(np.float32)
        zbuf[inside] = t_hit[inside]
    return img.reshape(height, s, width, s, 3).mean(axis=(1, 3))


def _default_layers(texture: np.ndarray) -> list:
    """Three depth layers cut from one photo: a large back wall, a tilted
    mid panel, and a small front panel — occlusion boundaries, true
    parallax, and depth-dependent foreshortening from real texture."""
    th, tw = texture.shape[:2]

    def crop(y0, y1, x0, x1):
        return np.ascontiguousarray(
            texture[int(y0 * th): int(y1 * th), int(x0 * tw): int(x1 * tw)]
        )

    def unit(v):
        v = np.asarray(v, np.float64)
        return v / np.linalg.norm(v)

    aspect = tw / th
    back = PlaneSpec(
        origin=np.array([0.0, 0.0, 0.9]),
        ex=np.array([1.0, 0.0, 0.0]), ey=np.array([0.0, 1.0, 0.0]),
        half=(2.4, 2.4 / aspect), texture=texture,
    )
    # Mid panel: tilted ~12 deg about y, offset left.
    c, s = np.cos(0.21), np.sin(0.21)
    mid = PlaneSpec(
        origin=np.array([-0.7, 0.15, 0.1]),
        ex=unit([c, 0.0, -s]), ey=np.array([0.0, 1.0, 0.0]),
        half=(0.85, 0.65), texture=crop(0.1, 0.7, 0.05, 0.55),
    )
    # Front panel: small, offset right and down, tilted about x.
    c2, s2 = np.cos(-0.17), np.sin(-0.17)
    front = PlaneSpec(
        origin=np.array([0.75, -0.35, -0.55]),
        ex=np.array([1.0, 0.0, 0.0]), ey=unit([0.0, c2, s2]),
        half=(0.55, 0.42), texture=crop(0.45, 0.95, 0.5, 0.95),
    )
    return [back, mid, front]


def _load_texture(photo_path: str | Path, downsample: int) -> np.ndarray:
    """The photo as (th, tw, 3) float32 in [0, 1], box-filtered by
    ``downsample``."""
    from PIL import Image as PILImage

    with PILImage.open(photo_path) as im:
        tex = np.asarray(im.convert("RGB"))
    if downsample > 1:
        d = downsample
        th = tex.shape[0] // d * d
        tw = tex.shape[1] // d * d
        tex = tex[:th, :tw].reshape(th // d, d, tw // d, d, 3).mean(axis=(1, 3))
    return (tex / 255.0).astype(np.float32)


def _write_dataset(out_root, name, cameras, images, render, pts_xyz, rgbs,
                   texture, half_extent) -> RealPlaneScene:
    """Write each view's ground truth (``render(image)``), the cameras and
    the points in the CLI's layout; the returned records carry full paths."""
    root = Path(out_root) / name
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)

    def write_view(im):
        arr = np.clip(render(im) * 255.0, 0, 255).astype(np.uint8)
        image_io.save_image(img_dir / im.name, arr)

    # One view a thread: numpy and PIL release the GIL in their array and
    # encoding loops, and each view's ground truth is computed alone.
    with ThreadPoolExecutor(min(WRITER_THREADS, os.cpu_count() or 1)) as pool:
        list(pool.map(write_view, images.values()))
    points = {
        i + 1: Point3D(
            id=i + 1, xyz=pts_xyz[i], rgb=rgbs[i], error=0.5,
            image_ids=np.zeros(0, np.int32), point2d_idxs=np.zeros(0, np.int32),
        )
        for i in range(len(pts_xyz))
    }
    write_cameras_binary(cameras, sparse / "cameras.bin")
    write_images_binary(images, sparse / "images.bin")
    write_points3d_binary(points, sparse / "points3D.bin")
    for im in images.values():
        im.name = str(img_dir / im.name)
    return RealPlaneScene(
        root=Path(out_root), name=name, cameras=cameras, images=images,
        points_xyz=pts_xyz, points_rgb=rgbs, texture=texture, half_extent=half_extent,
    )


def write_real_layers_dataset(
    out_root: str | Path,
    name: str = "reallayers",
    photo_path: str = REFERENCE_PHOTO,
    n_views: int = 24,
    width: int = 648,
    height: int = 420,
    n_points: int = 6000,
    texture_downsample: int = 2,
    radius: float = 4.0,
    seed: int = 3,
) -> RealPlaneScene:
    """Multi-depth real-texture dataset: three occluding textured layers
    (``_default_layers``), ground truth from ``render_layered_view``, and an
    SfM-like cloud of area-weighted samples of each layer with N(0, 0.01^2)
    jitter, coloured from the layer's own texture."""
    texture = _load_texture(photo_path, texture_downsample)
    planes = _default_layers(texture)
    cameras, images = _cap_cameras(n_views, width, height, radius, max_tilt=0.5, seed=seed)
    cam = cameras[1]

    rng = np.random.default_rng(seed)
    areas = np.array([p.half[0] * p.half[1] for p in planes])
    counts = np.maximum(1, (areas / areas.sum() * n_points).astype(int))
    xyz_list, rgb_list = [], []
    for p, cnt in zip(planes, counts):
        su = rng.uniform(-p.half[0], p.half[0], cnt)
        sv = rng.uniform(-p.half[1], p.half[1], cnt)
        pts = (
            p.origin[None, :]
            + su[:, None] * p.ex[None, :]
            + sv[:, None] * p.ey[None, :]
            + rng.normal(0.0, 0.01, (cnt, 3))
        )
        pth, ptw = p.texture.shape[:2]
        tu = (su / p.half[0] * 0.5 + 0.5) * (ptw - 1)
        tv = (sv / p.half[1] * 0.5 + 0.5) * (pth - 1)
        xyz_list.append(pts)
        rgb_list.append(
            np.clip(_bilinear(p.texture, tu, tv) * 255.0, 0, 255).astype(np.uint8))
    return _write_dataset(
        out_root, name, cameras, images,
        lambda im: render_layered_view(planes, im.qvec, im.tvec, cam.width, cam.height,
                                       cam.focal_x),
        np.concatenate(xyz_list, axis=0), np.concatenate(rgb_list, axis=0), texture,
        planes[0].half,
    )


def write_real_plane_dataset(
    out_root: str | Path,
    name: str = "realplane",
    photo_path: str = REFERENCE_PHOTO,
    n_views: int = 24,
    width: int = 648,
    height: int = 420,
    n_points: int = 6000,
    texture_downsample: int = 2,
    radius: float = 4.0,
    seed: int = 3,
) -> RealPlaneScene:
    """The photo on the z = 0 plane, its larger side 4 world units across,
    ground truth from ``render_plane_view``, and an SfM-like cloud of plane
    samples coloured by the texture with N(0, 0.01^2) out-of-plane jitter
    (triangulation noise)."""
    texture = _load_texture(photo_path, texture_downsample)
    th, tw = texture.shape[:2]
    half = (2.0, 2.0 * th / tw) if tw >= th else (2.0 * tw / th, 2.0)
    cameras, images = _cap_cameras(n_views, width, height, radius, seed=seed)
    cam = cameras[1]

    rng = np.random.default_rng(seed)
    pu = rng.uniform(-half[0], half[0], n_points)
    pv = rng.uniform(-half[1], half[1], n_points)
    pz = rng.normal(0.0, 0.01, n_points)
    tex_u = (pu / half[0] * 0.5 + 0.5) * (tw - 1)
    tex_v = (pv / half[1] * 0.5 + 0.5) * (th - 1)
    rgbs = np.clip(_bilinear(texture, tex_u, tex_v) * 255.0, 0, 255).astype(np.uint8)
    return _write_dataset(
        out_root, name, cameras, images,
        lambda im: render_plane_view(texture, half, im.qvec, im.tvec, cam.width,
                                     cam.height, cam.focal_x),
        np.stack([pu, pv, pz], axis=1).astype(np.float64), rgbs, texture, half,
    )


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m gsplat_tpu_torch.tools.real_plane",
        description="Write a multi-view real-texture dataset.")
    p.add_argument("out_root")
    p.add_argument("--views", type=int, default=24)
    p.add_argument("--size", default="648x420")
    p.add_argument("--layout", choices=("plane", "layers"), default="plane")
    p.add_argument("--photo", default=REFERENCE_PHOTO)
    args = p.parse_args(argv)
    w, h = (int(x) for x in args.size.split("x"))
    writer = (write_real_layers_dataset if args.layout == "layers"
              else write_real_plane_dataset)
    scene = writer(args.out_root, photo_path=args.photo, n_views=args.views, width=w,
                   height=h)
    print(f"wrote {args.views} real-texture {args.layout} views to "
          f"{scene.root / scene.name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
