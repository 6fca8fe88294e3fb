"""What every entry shares: the run's context, the program's and the
reference's statics from one configuration, and the comparison's numbers
and their judgement.

An entry module (``gsbench/entries/<name>.py``, named by the traffic
mix's ``entry``) has ``measure(run) -> Outcome``: it builds the inputs from
the seed, sets the program up, runs the window, frees the program and
compares what the window produced with the reference.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time

import torch

from .reference.gaussians import PARAMS, Statics

LEAF_FLOOR = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


@dataclasses.dataclass
class Run:
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float  # perf_counter() at the process's start
    phases: "Phases | None" = None  # set-up's parts

    def __post_init__(self):
        if self.phases is None:
            self.phases = Phases(self.started)


@dataclasses.dataclass
class Outcome:
    kind: str  # "train", "trainer" or "render"
    setup_s: float
    window_s: float
    units: int  # iterations or views completed in the window
    attempted: int
    failed: int
    numbers: dict  # compared number -> value
    latencies_ms: list = dataclasses.field(default_factory=list)
    traced: object = None  # trace.Traced of a --trace 1 run
    memory_peak_bytes: int = 0
    phases: dict = dataclasses.field(default_factory=dict)  # set-up's parts, seconds

    def __post_init__(self):
        self.phases = dict(self.phases)


def now() -> float:
    return time.perf_counter()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    """Start the peak of device memory here: what the harness made for
    the inputs before the program's set-up does not count."""
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


class Phases(dict):
    """Seconds of set-up's parts, in order: ``mark(name)`` closes the part
    that ends now."""

    def __init__(self, started: float):
        super().__init__()
        self.last = started

    def mark(self, name: str) -> None:
        t = now()
        self[name] = t - self.last
        self.last = t


def image_size(cfg: dict) -> tuple[int, int, float]:
    w, h = cfg["image"]["width"], cfg["image"]["height"]
    return w, h, cfg["image"]["focal_over_width"] * w


def ref_statics(cfg: dict, cam, l_max: int, scene_extent: float) -> Statics:
    t = cfg["train"]
    return Statics(
        width=cam.width, height=cam.height, tile=t["tile_size"], l_max=l_max,
        focal_x=cam.focal_x, focal_y=cam.focal_y, tan_fovx=cam.tan_fovx,
        tan_fovy=cam.tan_fovy, near_thresh=t["near_thresh"], mh_dist=t["mh_dist"],
        cull_padding=t["cull_mask_padding"], ssim_frac=t["ssim_frac"], base_lr=t["base_lr"],
        xyz_lr_init=t["xyz_lr_multiplier_init"], xyz_lr_final=t["xyz_lr_multiplier_final"],
        quat_lr=t["quat_lr_multiplier"], scale_lr=t["scale_lr_multiplier"],
        opacity_lr=t["opacity_lr_multiplier"], rgb_lr=t["rgb_lr_multiplier"],
        sh_lr=t["sh_lr_multiplier"], scene_extent=scene_extent, num_iters=t["num_iters"])


def program_statics(rst: Statics, pair_cap: int, row_cap: int):
    """The program's StepStatics of the same numbers, at the caps."""
    from gsplat_tpu_torch.train.step import StepStatics

    return StepStatics(
        width=rst.width, height=rst.height, tile=rst.tile, l_max=rst.l_max,
        focal_x=rst.focal_x, focal_y=rst.focal_y, tan_fovx=rst.tan_fovx, tan_fovy=rst.tan_fovy,
        near_thresh=rst.near_thresh, mh_dist=rst.mh_dist, cull_padding=rst.cull_padding,
        ssim_frac=rst.ssim_frac, base_lr=rst.base_lr, xyz_lr_init=rst.xyz_lr_init,
        xyz_lr_final=rst.xyz_lr_final, quat_lr=rst.quat_lr, scale_lr=rst.scale_lr,
        opacity_lr=rst.opacity_lr, rgb_lr=rst.rgb_lr, sh_lr=rst.sh_lr,
        scene_extent=rst.scene_extent, num_iters=rst.num_iters,
        pair_cap=pair_cap, row_cap=row_cap)


def cam_tensors(cam, device) -> tuple:
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in (cam.view, cam.proj, cam.campos))


def background(cfg: dict, iteration: int) -> float:
    """The trainer's background rule (``strict_reference``: always on)."""
    return (iteration % 255) / 255.0 if cfg["train"]["use_background"] else 0.0


def leaf_norms(tensors: dict, scale: float = 1.0) -> dict:
    return {k: float(torch.linalg.vector_norm(tensors[k].detach().double())) * scale
            for k in PARAMS}


def change_norms(now_: dict, start: dict) -> dict:
    return {k: float(torch.linalg.vector_norm((now_[k].detach() - start[k]).double()))
            for k in PARAMS}


def training_numbers(got: dict, ref: dict) -> dict:
    """The compared numbers of a training cell. ``got`` and ``ref`` hold
    ``losses`` (the first steps'), ``grad`` (each leaf's first gradient
    norm, as the optimizer's first moment gives it) and ``change`` (each
    leaf's change norm after the first steps). A gap of norms is taken
    leaf by leaf against the larger of the reference's norm of that leaf
    and of the median leaf; the change leaves out leaves whose reference
    gradient is nought to rounding (under LEAF_FLOOR of the median's)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    g_med = statistics.median(ref["grad"].values())
    c_med = statistics.median(ref["change"].values())
    grad = max(abs(got["grad"][k] - ref["grad"][k]) / max(ref["grad"][k], g_med, 1e-30)
               for k in PARAMS)
    moved = [k for k in PARAMS if ref["grad"][k] >= LEAF_FLOOR * g_med]
    change = max(abs(got["change"][k] - ref["change"][k]) / max(ref["change"][k], c_med, 1e-30)
                 for k in moved)
    return dict(loss_gap=loss, grad_gap=grad, change_gap=change)


def density_numbers(got: dict, ref: dict) -> dict:
    """The compared numbers of a density step: the largest relative gap of
    the pruned, cloned and split counts; the worst leaf's gap of the
    parameters' norms after the step (as ``training_numbers``); and the
    share of the program's rows out of Morton order after its re-sort
    (exact: the limit is 0)."""
    counts = max(abs(got["counts"][k] - ref["counts"][k]) / max(ref["counts"][k], 1)
                 for k in ref["counts"])
    med = statistics.median(ref["after"].values())
    norms = max(abs(got["after"][k] - ref["after"][k]) / max(ref["after"][k], med, 1e-30)
                for k in PARAMS)
    return dict(density_count_gap=counts, density_norm_gap=norms,
                morton_unsorted=got["unsorted"])


def image_numbers(got: list, ref: list) -> dict:
    """The compared numbers of rendered views: the worst view's mean
    absolute difference, and its share of pixels off by more than 1/255 in
    a channel."""
    mae, off = 0.0, 0.0
    for a, b in zip(got, ref):
        d = (a.to(b.device) - b).abs()
        mae = max(mae, float(d.mean()))
        off = max(off, float((d.amax(dim=-1) > 1.0 / 255.0).double().mean()))
    return dict(image_mae=mae, pixels_off=off)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number finite and within
    its limit."""
    checks = {k: dict(value=v, limit=limits[k]) for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
