#!/usr/bin/env python3
"""Drive the PyTorch port's forward render on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels (``gsplat_tpu_torch/csrc``) with nvcc for
sm_90a, then:

1. prints the card (nvidia-smi name and power limit), torch and CUDA;
2. builds the kernels and prints the build time and ptxas's register use;
3. compares each kernel with its plain PyTorch version on the card, at the
   shapes of one view of the bench scene at 100K Gaussians (segment expand
   and radix sort bit-equal; rasterizer image PSNR >= 60 dB, n_splats equal
   on >= 99.9 % of pixels);
4. checks a small scene rendered on the card against the port's CPU path
   (which the CPU tests hold against the JAX package);
5. renders the bench scene (1296x840, tile 16, SH degree 3) at 1,000,000
   Gaussians from 4 views through ``render_image``: pairs, median ms and
   Mpix/s per view, finite images, every kernel launched, and a
   bit-identical re-render;
6. times each kernel against its plain version at the 1M view's shapes.

Prints one JSON line of kernels, then the nvidia-smi line, then the result
line ``{"ok": true, "device": {...}}``. Any failed check exits non-zero.
Exits non-zero at once when no CUDA device is present.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH, HEIGHT, TILE = 1296, 840, 16
BG = 0.2
REPLACES = {
    "segment_expand": "gsplat_tpu/kernels/expand.py:310",
    "radix_sort": "gsplat_tpu/kernels/sort.py:514",
    "rasterize_forward": "gsplat_tpu/kernels/rasterize.py:486",
}
SOURCES = {
    "segment_expand": "gsplat_tpu_torch/csrc/expand.cu",
    "radix_sort": "gsplat_tpu_torch/csrc/sort.cu",
    "rasterize_forward": "gsplat_tpu_torch/csrc/rasterize_fwd.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def scene_params(n: int, seed: int, device):
    """bench.py's _scene recipe, plus sh ~ N(0, 0.1), at round_capacity(n)."""
    from gsplat_tpu_torch.train.state import params_from_jax, round_capacity

    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * [2.0, 1.4, 1.2] + [0, 0, 6.0]
    rgb = rng.normal(size=(n, 3))
    opacity = rng.uniform(-1.0, 2.0, size=n)
    scale = np.log(rng.uniform(0.004, 0.04, size=(n, 3)) * (1e6 / n) ** 0.33)
    quat = np.concatenate([np.ones((n, 1)), 0.2 * rng.normal(size=(n, 3))], axis=1)
    sh = 0.1 * rng.normal(size=(n, 15, 3))
    cap = round_capacity(n)

    def pad(x):
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:n] = x
        return out

    params = dict(xyz=pad(xyz), rgb=pad(rgb), opacity=pad(opacity),
                  scale=pad(scale), quat=pad(quat), sh=pad(sh))
    return params_from_jax(params, np.arange(cap) < n, device)


def views(width=WIDTH, height=HEIGHT):
    """The bench pose and three small rotations of it."""
    from gsplat_tpu_torch.ops.camera import build_camera_matrices

    def rot(axis, deg):
        h = math.radians(deg) / 2
        return np.array([math.cos(h)] + [math.sin(h) * a for a in axis])

    poses = [np.array([1.0, 0, 0, 0]), rot((0, 1, 0), 4.0),
             rot((0, 1, 0), -4.0), rot((1, 0, 0), 3.0)]
    return [build_camera_matrices(q, np.zeros(3), width, height,
                                  width * 0.85, width * 0.85) for q in poses]


def statics(cm, width=WIDTH, height=HEIGHT):
    from gsplat_tpu_torch.train.step import StepStatics

    return StepStatics(
        width=width, height=height, tile=TILE, l_max=3,
        focal_x=cm.focal_x, focal_y=cm.focal_y,
        tan_fovx=cm.tan_fovx, tan_fovy=cm.tan_fovy,
        near_thresh=0.3, mh_dist=3.0, cull_padding=100, ssim_frac=0.2,
        base_lr=1e-3, xyz_lr_init=0.16, xyz_lr_final=0.0016, quat_lr=1.0,
        scale_lr=5.0, opacity_lr=25.0, rgb_lr=2.5, sh_lr=0.125,
        scene_extent=4.0, num_iters=7000,
    )


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    from gsplat_tpu_torch.ops.loss import compute_psnr

    return float(compute_psnr(a, b))


def path_inputs(params, cm, st):
    """Every kernel's inputs at the shapes render_image gives it."""
    from gsplat_tpu_torch.kernels.expand import segment_expand
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.render import pack_attrs
    from gsplat_tpu_torch.train.step import _per_gaussian

    dev = params.xyz.device
    with torch.no_grad():
        view, proj, campos = (torch.as_tensor(x, device=dev)
                              for x in (cm.view, cm.proj, cm.campos))
        uv, conic, rgb, mask, radius, z = _per_gaussian(params, view, proj, campos, st)
        num_tiles = st.num_tiles_x * st.num_tiles_y
        qd_bits = binning.depth_key_bits(num_tiles)
        geom, rec1, off1, total_rows = binning.row_expand_inputs(
            uv, z, radius, mask, num_tiles_x=st.num_tiles_x,
            num_tiles_y=st.num_tiles_y, tile_size=st.tile,
        )
        rows = segment_expand(rec1, off1, total_rows)
        rec2, off2, total_pairs = binning.pair_expand_inputs(
            geom, rows, num_tiles_x=st.num_tiles_x, tile_size=st.tile
        )
        keys, _ = binning.pair_keys(geom, segment_expand(rec2, off2, total_pairs),
                                    qd_bits)
        tables = binning.build_tile_tables(
            uv, z, radius, mask, num_tiles_x=st.num_tiles_x,
            num_tiles_y=st.num_tiles_y, tile_size=st.tile,
        )
        attrs = pack_attrs(uv, conic, rgb, params.opacity)
    return dict(
        expand=[(rec1, off1, total_rows), (rec2, off2, total_pairs)],
        sort=(keys, binning.sort_key_bits(num_tiles, qd_bits)),
        raster=(attrs, tables.splat_gid, tables.tile_start, tables.tile_count),
        num_pairs=total_pairs, num_rows=total_rows,
    )


def compare_kernels(params, cm, st, timing_iters: int) -> dict:
    """Each kernel vs its plain version on the card; raises on disagreement."""
    from gsplat_tpu_torch.kernels import expand, rasterize, sort
    from gsplat_tpu_torch.ops.render import tiles_to_image

    inp = path_inputs(params, cm, st)
    res = {}
    # K5: both binning levels, bit-equal; time = both calls of one frame.
    for args in inp["expand"]:
        got = expand.segment_expand(*args)
        ref = expand.segment_expand_plain(*args)
        if not torch.equal(got, ref):
            raise AssertionError("segment_expand differs from its plain version")
    res["segment_expand"] = dict(
        max_abs_err=0.0,
        ms=sum(cuda_ms(lambda a=a: expand.segment_expand(*a), timing_iters)
               for a in inp["expand"]),
        plain_ms=sum(cuda_ms(lambda a=a: expand.segment_expand_plain(*a), timing_iters)
                     for a in inp["expand"]),
    )
    # K3: keys and permutation bit-equal to the stable torch.sort.
    keys, key_bits = inp["sort"]
    got = sort.radix_sort(keys, key_bits)
    ref = sort.radix_sort_plain(keys, key_bits)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("radix_sort differs from torch.sort(stable=True)")
    res["radix_sort"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: sort.radix_sort(keys, key_bits), timing_iters),
        plain_ms=cuda_ms(lambda: sort.radix_sort_plain(keys, key_bits), timing_iters),
    )
    # K1: image PSNR >= 60 dB, n_splats equal on >= 99.9 % of pixels.
    kw = dict(num_tiles_x=st.num_tiles_x)
    got = rasterize.rasterize_forward(*inp["raster"], BG, **kw)
    ref = rasterize.rasterize_forward_plain(*inp["raster"], BG, **kw)
    to_img = lambda o: tiles_to_image(o[:, :3], st.num_tiles_x, st.num_tiles_y,  # noqa: E731
                                      st.tile, st.width, st.height)
    img_psnr = psnr(to_img(got), to_img(ref))
    same_n = (got[:, 4] == ref[:, 4]).double().mean().item()
    err = (got[:, :3] - ref[:, :3]).abs().max().item()
    log(f"  rasterize_forward: image PSNR vs plain {img_psnr:.2f} dB, "
        f"n_splats equal on {100 * same_n:.4f} % of pixels, "
        f"max |T_final diff| {(got[:, 3] - ref[:, 3]).abs().max().item():.3g}")
    if not (img_psnr >= 60.0 and same_n >= 0.999 and math.isfinite(err)):
        raise AssertionError("rasterize_forward disagrees with its plain version")
    res["rasterize_forward"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: rasterize.rasterize_forward(*inp["raster"], BG, **kw),
                   timing_iters),
        plain_ms=cuda_ms(lambda: rasterize.rasterize_forward_plain(
            *inp["raster"], BG, **kw), max(1, timing_iters // 4)),
    )
    log(f"  rows {inp['num_rows']}, pairs {inp['num_pairs']}, "
        f"sort key bits {key_bits}")
    for name, r in res.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"max_abs_err {r['max_abs_err']:.3g}")
    return res


def check_small_scene_against_cpu(dev) -> None:
    """A small scene on the card vs the port's CPU path on the same inputs."""
    from gsplat_tpu_torch.train.step import render_image

    w, h = 320, 208
    cm = views(w, h)[1]
    st = statics(cm, w, h)
    params = scene_params(20_000, seed=3, device="cpu")
    img_cpu, tab_cpu = render_image(params, cm.view, cm.proj, cm.campos, BG, st)
    img_gpu, tab_gpu = render_image(params.to(dev), cm.view, cm.proj, cm.campos,
                                    BG, st)
    p = psnr(img_gpu.cpu(), img_cpu)
    log(f"  {w}x{h}, 20000 Gaussians: pairs card {tab_gpu.num_pairs} / cpu "
        f"{tab_cpu.num_pairs}, image PSNR card vs cpu {p:.2f} dB")
    if not (abs(tab_gpu.num_pairs - tab_cpu.num_pairs) <= 1e-3 * tab_cpu.num_pairs
            and p >= 60.0 and torch.isfinite(img_gpu).all()):
        raise AssertionError("card render disagrees with the CPU path")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.train.step import render_image

    dev = torch.device("cuda", 0)
    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. Build.
    t0 = time.perf_counter()
    _build.build()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("    " + line.strip())

    # 3. Kernels vs plain versions, 100K Gaussians, bench view.
    cams = views()
    st = statics(cams[0])
    log("[3] kernels vs plain versions at 100K Gaussians")
    compare_kernels(scene_params(100_000, seed=0, device=dev), cams[0], st, 5)

    # 4. Small scene: card vs the CPU path.
    log("[4] small scene, card vs CPU path")
    check_small_scene_against_cpu(dev)

    # 5. The slice: 1M Gaussians, 4 views, through render_image.
    log("[5] render_image, 1M Gaussians, 1296x840, SH 3, 4 views")
    params = scene_params(1_000_000, seed=0, device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    images = []
    for i, cm in enumerate(cams):
        img, tables = render_image(params, cm.view, cm.proj, cm.campos, BG, st)
        ms = cuda_ms(lambda cm=cm: render_image(params, cm.view, cm.proj,
                                                cm.campos, BG, st), 10)
        images.append(img)
        log(f"  view {i}: pairs {tables.num_pairs}, {ms:.3f} ms median, "
            f"{WIDTH * HEIGHT / ms / 1e3:.2f} Mpix/s")
        if not (img.shape == (HEIGHT, WIDTH, 3) and torch.isfinite(img).all()):
            raise AssertionError(f"view {i}: image not finite or of wrong shape")
    again, _ = render_image(params, cams[0].view, cams[0].proj, cams[0].campos, BG, st)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    if not torch.equal(again, images[0]):
        raise AssertionError("re-render of view 0 is not bit-identical")
    log(f"  re-render bit-identical; launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the main path: {launches}")

    # 6. Kernel times at the 1M view's shapes.
    log("[6] kernels vs plain versions at 1M Gaussians")
    res = compare_kernels(params, cams[0], st, 10)

    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
             launches=launches[name], **res[name])
        for name in ("segment_expand", "radix_sort", "rasterize_forward")
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
