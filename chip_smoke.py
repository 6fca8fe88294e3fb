#!/usr/bin/env python3
"""Drive the PyTorch port's render and training step on one NVIDIA GPU.

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
   Gaussians from 2 views through ``render_image``: pairs, median ms and
   Mpix/s per view, finite images, every forward kernel launched, and a
   bit-identical re-render;
6. times each forward kernel against its plain version at the 1M view's
   shapes;
7. compares the backward kernels with their plain versions at 100K
   Gaussians, bench view, random image cotangent (backward rasterizer rows
   within 1e-4 of each row's largest value, segment sum at rtol 1e-5, the
   regroup sort bit-equal to ``torch.sort(stable=True)``);
8. runs one ``train_step`` of a small scene (20K Gaussians, 320x200) on the
   card and on the port's CPU path: loss, gradients, moments and
   accumulators must agree;
9. trains a perturbed copy of the 1M scene for 8 steps over the 4 views
   rendered from the scene itself (``train_step``): loss, ms per step and
   pairs; finite losses, a lower mean loss on the second pass, every kernel
   launched, the radix sort exactly twice per step, peak memory, and
   bit-identical gradients from two calls on the same state;
10. times the backward kernels against their plain versions at the 1M
    view's shapes.

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
    "rasterize_backward": "gsplat_tpu/kernels/rasterize.py:815",
    "segment_sum": "gsplat_tpu/kernels/segsum.py:139",
}
SOURCES = {
    "segment_expand": "gsplat_tpu_torch/csrc/expand.cu",
    "radix_sort": "gsplat_tpu_torch/csrc/sort.cu",
    "rasterize_forward": "gsplat_tpu_torch/csrc/rasterize_fwd.cu",
    "rasterize_backward": "gsplat_tpu_torch/csrc/rasterize_bwd.cu",
    "segment_sum": "gsplat_tpu_torch/csrc/segsum.cu",
}
TRAIN_STEPS = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def scene_arrays(n: int, seed: int, perturb_seed: int | None = None):
    """bench.py's _scene recipe, plus sh ~ N(0, 0.1), padded to
    round_capacity(n): (params as host arrays, alive). ``perturb_seed``
    gives the copy a training run starts from: rgb + N(0, 0.3^2) noise and
    opacity logits - 0.5."""
    from gsplat_tpu_torch.train.state import round_capacity

    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * [2.0, 1.4, 1.2] + [0, 0, 6.0]
    rgb = rng.normal(size=(n, 3))
    opacity = rng.uniform(-1.0, 2.0, size=n)
    scale = np.log(rng.uniform(0.004, 0.04, size=(n, 3)) * (1e6 / n) ** 0.33)
    quat = np.concatenate([np.ones((n, 1)), 0.2 * rng.normal(size=(n, 3))], axis=1)
    sh = 0.1 * rng.normal(size=(n, 15, 3))
    if perturb_seed is not None:
        rgb = rgb + 0.3 * np.random.default_rng(perturb_seed).normal(size=(n, 3))
        opacity = opacity - 0.5
    cap = round_capacity(n)

    def pad(x):
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:n] = x
        return out

    params = dict(xyz=pad(xyz), rgb=pad(rgb), opacity=pad(opacity),
                  scale=pad(scale), quat=pad(quat), sh=pad(sh))
    return params, np.arange(cap) < n


def scene_params(n: int, seed: int, device, perturb_seed: int | None = None):
    """``scene_arrays`` as the port's GaussianParams on ``device``."""
    from gsplat_tpu_torch.train.state import params_from_jax

    return params_from_jax(*scene_arrays(n, seed, perturb_seed), device)


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


def backward_inputs(params, cm, st, seed: int = 0):
    """The backward kernels' inputs at the shapes train_step gives them,
    with a random image cotangent; and the attribute table's row count."""
    from gsplat_tpu_torch.kernels.rasterize import rasterize_forward

    attrs, gid, start, count = path_inputs(params, cm, st)["raster"]
    out = rasterize_forward(attrs, gid, start, count, BG, num_tiles_x=st.num_tiles_x)
    gen = torch.Generator(device=attrs.device).manual_seed(seed)
    d_tiles = torch.randn((start.shape[0], 3, st.tile * st.tile), generator=gen,
                          device=attrs.device)
    return (attrs, gid, start, count, out, d_tiles), attrs.shape[0]


def bits_of(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bit patterns, so that NaN compares equal to itself."""
    return t.contiguous().view(torch.int32)


def compare_backward(params, cm, st, timing_iters: int) -> dict:
    """The backward kernels and the regroup sort vs their plain versions on
    the card; raises on disagreement."""
    from gsplat_tpu_torch.kernels import rasterize, segsum, sort
    from gsplat_tpu_torch.ops.render import regroup_key_bits

    args, n = backward_inputs(params, cm, st)
    kw = dict(num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y)
    res = {}
    # K2. The 256-pixel sums run in another order (warp shuffles vs a tensor
    # sum) and T is replayed by division instead of chunked products: each
    # row must lie within 1e-3 of its largest |value| (+1e-6). Both are off
    # a float64 replay by up to 1.5e-4 of it on small scenes.
    rows = rasterize.rasterize_backward(*args, BG, **kw)
    again = rasterize.rasterize_backward(*args, BG, **kw)
    ref = rasterize.rasterize_backward_plain(*args, BG, **kw)
    err = (rows - ref).abs()
    scale = ref.abs().amax(dim=1, keepdim=True)
    worst = (err / (scale + 1e-6)).max().item()
    log(f"  rasterize_backward: max |err| {err.max().item():.3g}, worst row-relative "
        f"{worst:.3g}, rerun bit-identical {torch.equal(rows, again)}")
    if not (bool((err <= 1e-3 * scale + 1e-6).all()) and torch.equal(rows, again)
            and bool(torch.isfinite(rows).all())):
        raise AssertionError("rasterize_backward disagrees with its plain version")
    res["rasterize_backward"] = dict(
        max_abs_err=err.max().item(),
        ms=cuda_ms(lambda: rasterize.rasterize_backward(*args, BG, **kw), timing_iters),
        plain_ms=cuda_ms(lambda: rasterize.rasterize_backward_plain(*args, BG, **kw),
                         max(1, timing_iters // 4)),
    )
    # K3 at the regroup call site: bit-equal to the stable torch.sort.
    gid, bits = args[1], regroup_key_bits(n)
    sorted_gid, perm = sort.radix_sort(gid, bits)
    ref_k, ref_p = sort.radix_sort_plain(gid, bits)
    if not (torch.equal(sorted_gid, ref_k) and torch.equal(perm, ref_p)):
        raise AssertionError("regroup radix_sort differs from torch.sort(stable=True)")
    res["regroup_sort"] = dict(
        max_abs_err=0.0, key_bits=bits,
        ms=cuda_ms(lambda: sort.radix_sort(gid, bits), timing_iters),
        plain_ms=cuda_ms(lambda: sort.radix_sort_plain(gid, bits), timing_iters),
    )
    # K4 at rtol 1e-5; index_add_ on the card adds with atomics, in another
    # order, so cancelling sums also get 1e-5 of the column's largest |value|.
    sums = segsum.segment_sum(rows, perm, sorted_gid, n)
    again = segsum.segment_sum(rows, perm, sorted_gid, n)
    ref = segsum.segment_sum_plain(rows, perm, sorted_gid, n)
    err = (sums - ref).abs()
    log(f"  segment_sum: max |err| {err.max().item():.3g}, rerun bit-identical "
        f"{torch.equal(sums, again)}")
    if not (bool((err <= 1e-5 * ref.abs() + 1e-5 * ref.abs().amax(dim=0)).all())
            and torch.equal(sums, again)):
        raise AssertionError("segment_sum disagrees with its plain version")
    res["segment_sum"] = dict(
        max_abs_err=err.max().item(),
        ms=cuda_ms(lambda: segsum.segment_sum(rows, perm, sorted_gid, n), timing_iters),
        plain_ms=cuda_ms(lambda: segsum.segment_sum_plain(rows, perm, sorted_gid, n),
                         timing_iters),
    )
    log(f"  pairs {gid.shape[0]}, Gaussians {n}, regroup key bits {bits}")
    for name, r in res.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"max_abs_err {r['max_abs_err']:.3g}")
    return res


def one_step(state, cm, gt, it, st):
    """train_step's two halves, keeping the gradients: (loss, grads, g_uv,
    tables)."""
    from gsplat_tpu_torch.train.step import apply_adam, compute_loss_and_grads

    loss, _, mask, tables, grads, g_uv = compute_loss_and_grads(
        state.params, cm.view, cm.proj, cm.campos, gt, BG, st)
    apply_adam(state, grads, g_uv, mask, it, st)
    return float(loss), grads, g_uv, tables


def check_small_train_against_cpu(dev) -> None:
    """One training step of a small scene on the card vs the port's CPU path
    (which the CPU tests hold against the JAX package)."""
    from gsplat_tpu_torch.train.state import init_state, params_from_jax, state_to_numpy
    from gsplat_tpu_torch.train.step import render_image

    w, h = 320, 200
    cm = views(w, h)[1]
    st = statics(cm, w, h)
    gt, _ = render_image(scene_params(20_000, seed=3, device="cpu"), cm.view, cm.proj,
                         cm.campos, BG, st)
    start = scene_arrays(20_000, seed=3, perturb_seed=4)
    out = []
    for d in ("cpu", dev):
        state = init_state(params_from_jax(*start, d))
        loss, grads, g_uv, tables = one_step(state, cm, gt.to(d), 0, st)
        out.append((loss, {k: v.cpu() for k, v in grads.items()}, g_uv.cpu(),
                    state_to_numpy(state), tables.splat_gid.cpu()))
    (l_c, g_c, uv_c, s_c, gid_c), (l_g, g_g, uv_g, s_g, gid_g) = out
    same = (gid_c == gid_g).double().mean().item() if gid_c.shape == gid_g.shape else 0.0
    log(f"  {w}x{h}, 20000 Gaussians: loss card {l_g:.8f} / cpu {l_c:.8f}; pairs "
        f"{gid_g.shape[0]} / {gid_c.shape[0]}, same Gaussian in {100 * same:.4f} %")
    failed = []
    if not abs(l_g - l_c) <= 1e-5 * abs(l_c):
        failed.append("loss")
    # The kernels and the plain versions sum pixels and pairs in other
    # orders, and the per-Gaussian maths on the card and on the CPU differ
    # by ~1e-6 relative, which flips the 1/255 cutoff at a few footprint-
    # edge pixels of a few Gaussians (measured on an H100: at most 4
    # elements of a tensor past 1e-3 of its largest |value|, worst 4.9e-3).
    # So: at most 0.1 % of the elements past ``tol`` of the largest finite
    # |value|, none past 10 ``tol``, NaN (dead capacity rows) in the same
    # places; v scales as g^2.
    pairs = [(f"grad {k}", g_g[k].numpy(), g_c[k].numpy(), 1e-3) for k in g_c]
    pairs += [(f"m {k}", s_g["adam_m"][k], s_c["adam_m"][k], 1e-3) for k in g_c]
    pairs += [(f"v {k}", s_g["adam_v"][k], s_c["adam_v"][k], 2e-3) for k in g_c]
    pairs += [("g_uv", uv_g.numpy(), uv_c.numpy(), 1e-3),
              ("uv_grad_accum", s_g["uv_grad_accum"], s_c["uv_grad_accum"], 1e-3)]
    for name, a, b, tol in pairs:
        finite = np.isfinite(b)
        scale = max(float(np.abs(b[finite]).max(initial=0.0)), 1e-30)
        rel = np.abs(a[finite] - b[finite]) / scale
        worst = float(rel.max(initial=0.0))
        past = int((rel > tol).sum())
        log(f"    {name}: worst |card - cpu| / max {worst:.3g}, {past} of {rel.size} "
            f"elements past {tol:g}")
        if not ((np.isfinite(a) == finite).all() and worst <= 10 * tol
                and past <= 1e-3 * rel.size):
            failed.append(name)
    if not np.array_equal(s_g["accum_dur"], s_c["accum_dur"]):
        failed.append("accum_dur")
    if failed:
        raise AssertionError(f"card disagrees with the CPU path: {failed}")


def train_slice(cams, st, dev):
    """The slice: train a perturbed 1M scene on the 4 views rendered from
    the scene itself. Returns the launches of the training run."""
    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.train.state import init_state
    from gsplat_tpu_torch.train.step import compute_loss_and_grads, render_image, train_step

    truth = scene_params(1_000_000, seed=0, device=dev)
    gts = [render_image(truth, cm.view, cm.proj, cm.campos, BG, st)[0] for cm in cams]
    del truth
    state = init_state(scene_params(1_000_000, seed=0, device=dev, perturb_seed=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses, times = [], []
    for it in range(TRAIN_STEPS):
        v = it % len(cams)
        cm = cams[v]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = train_step(state, cm.view, cm.proj, cm.campos, gts[v], BG, it, st)
        end.record()
        end.synchronize()
        losses.append(float(m.loss))
        times.append(start.elapsed_time(end))
        log(f"  step {it} view {v}: loss {losses[-1]:.6f}, psnr {float(m.psnr):.3f} dB, "
            f"{times[-1]:.3f} ms, pairs {m.num_pairs}, visible {int(m.num_visible)}")
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() / 2**20
    half = len(cams)
    first, second = statistics.mean(losses[:half]), statistics.mean(losses[half:])
    log(f"  median {statistics.median(times[1:]):.3f} ms/step over steps 1-"
        f"{TRAIN_STEPS - 1}; mean loss pass 1 {first:.6f}, pass 2 {second:.6f}; "
        f"peak allocated {peak:.0f} MiB; launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a loss is not finite: {losses}")
    if not second < first:
        raise AssertionError("the second pass over the views did not lower the loss")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the main path: {launches}")
    if launches["radix_sort"] != 2 * TRAIN_STEPS:
        raise AssertionError(f"radix_sort launched {launches['radix_sort']} times, "
                             f"not 2 per step")
    runs = [compute_loss_and_grads(state.params, cams[0].view, cams[0].proj,
                                   cams[0].campos, gts[0], BG, st) for _ in range(2)]
    (_, _, _, _, g_a, uv_a), (_, _, _, _, g_b, uv_b) = runs
    same = all(torch.equal(bits_of(g_a[k]), bits_of(g_b[k])) for k in g_a)
    if not (same and torch.equal(bits_of(uv_a), bits_of(uv_b))):
        raise AssertionError("two gradient calls on the same state differ")
    log("  gradients of two calls on the same state are bit-identical")
    return launches, state.params


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
    log("[3] forward kernels vs plain versions at 100K Gaussians")
    compare_kernels(scene_params(100_000, seed=0, device=dev), cams[0], st, 5)

    # 4. Small scene: card vs the CPU path.
    log("[4] small scene, card vs CPU path")
    check_small_scene_against_cpu(dev)

    # 5. The forward path: 1M Gaussians, 2 views, through render_image.
    log("[5] render_image, 1M Gaussians, 1296x840, SH 3, 2 views")
    params = scene_params(1_000_000, seed=0, device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    images = []
    for i, cm in enumerate(cams[:2]):
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
    fwd_launches = dict(_build.launches)
    if not torch.equal(again, images[0]):
        raise AssertionError("re-render of view 0 is not bit-identical")
    log(f"  re-render bit-identical; launches {fwd_launches}")
    for name in ("segment_expand", "radix_sort", "rasterize_forward"):
        if fwd_launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the forward path")

    # 6. Forward kernel times at the 1M view's shapes.
    log("[6] forward kernels vs plain versions at 1M Gaussians")
    res = compare_kernels(params, cams[0], st, 10)
    del params, images, again

    # 7. Backward kernels vs plain versions, 100K Gaussians, bench view.
    log("[7] backward kernels vs plain versions at 100K Gaussians")
    compare_backward(scene_params(100_000, seed=0, device=dev), cams[0], st, 5)

    # 8. Small scene: one training step, card vs the CPU path.
    log("[8] small scene train step, card vs CPU path")
    check_small_train_against_cpu(dev)

    # 9. The slice: train 1M Gaussians for 8 steps over 4 views.
    log(f"[9] train_step, 1M Gaussians, 1296x840, SH 3, {TRAIN_STEPS} steps over 4 views")
    launches, trained = train_slice(cams, st, dev)

    # 10. Backward kernel times at the 1M view's shapes.
    log("[10] backward kernels vs plain versions at 1M Gaussians")
    bwd = compare_backward(trained, cams[0], st, 10)
    res.update(rasterize_backward=bwd["rasterize_backward"],
               segment_sum=bwd["segment_sum"])
    # One train step sorts twice: the tile sort and the regroup.
    for key in ("ms", "plain_ms"):
        res["radix_sort"][key] += bwd["regroup_sort"][key]

    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
             launches=launches[name], **res[name])
        for name in SOURCES
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
