"""Train step at the configuration's ceiling (port of
``scripts/bench_scale.py``).

``configs/base.yaml`` allows ``max_gaussians`` 4,250,000. The state's
capacity is then ``round_capacity(4.25M)`` = 6,291,456 (2^22 + 2^21), the
first capacity bucket that is not a power of two. The scene is the
reference script's: bench.py's Gaussians with each scale shrunk by
(1e6 / N)^0.33 and multiplied by ``scale_mul``, drawn by numpy from one
seeded generator; one camera at the origin looking down +z (1296x840,
focal 0.8 W), SH 3, and a uniform random target drawn from the same
generator after the Gaussians.

Usage: python -m gsplat_tpu_torch.tools.bench_scale [N] [scale_mul]

The step bins at the script's capacities (``PAIR_CAP`` 31 x 2^19 pairs,
``ROW_CAP`` 26 x 2^19 tile rows) through ``get_train_step``: a CUDA graph
on the card. ``run(..., pair_cap=0)`` sizes each frame exactly (eager).

Takes one train step, then ``reps`` repetitions of ``steps`` timed steps
(CUDA events on the card, the host clock on the CPU), and prints one JSON
line: the first step's pairs and tile rows (also as the reference counts
them, with a sentinel row for each record that has none), its pair and
row requirements (the script's ``overflow``, and ``row_overflow``), the
last step's pairs (the script's ``num_pairs``), ms a step, whether the
loss is finite and the peak allocated memory. Runs on the card (``main(argv, device="cpu")`` on the
CPU). Writes nothing.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time

import numpy as np
import torch

CEILING = 4_250_000  # configs/base.yaml's max_gaussians
WIDTH, HEIGHT = 1296, 840
PAIR_CAP = 31 * (1 << 19)  # the script's default pair capacity
ROW_CAP = 26 * (1 << 19)  # and its row capacity


def scale_gaussians(n: int, scale_mul: float = 1.0, seed: int = 0,
                    rng: np.random.Generator | None = None):
    """The reference script's ``n`` Gaussians, drawn in its order from
    ``rng`` (default: a new generator seeded with ``seed``)."""
    from ..train.init import GaussianData

    rng = np.random.default_rng(seed) if rng is None else rng
    return GaussianData(
        xyz=(rng.normal(size=(n, 3)) * [2.0, 1.4, 1.2] + [0, 0, 6.0]).astype(np.float32),
        rgb=rng.normal(size=(n, 3)).astype(np.float32),
        opacity=rng.uniform(-1.0, 2.0, size=n).astype(np.float32),
        scale=np.log(
            rng.uniform(0.004, 0.04, size=(n, 3)) * (1e6 / n) ** 0.33 * scale_mul
        ).astype(np.float32),
        quaternion=np.concatenate(
            [np.ones((n, 1)), 0.2 * rng.normal(size=(n, 3))], axis=1
        ).astype(np.float32),
    )


def scale_camera(width: int = WIDTH, height: int = HEIGHT):
    """The script's camera: identity pose, focal 0.8 W on both axes."""
    from ..ops.camera import build_camera_matrices

    return build_camera_matrices(np.array([1.0, 0, 0, 0]), np.zeros(3), width, height,
                                 width * 0.8, width * 0.8)


def scale_statics(width: int = WIDTH, height: int = HEIGHT, pair_cap: int = PAIR_CAP,
                  row_cap: int = ROW_CAP):
    """The script's ``StepStatics``, without its chunk and interpret flag
    (``train.step.StepStatics`` has neither); ``pair_cap=0`` sizes binning
    exactly."""
    from ..train.step import StepStatics

    cm = scale_camera(width, height)
    return StepStatics(
        width=width, height=height, tile=16, l_max=3,
        focal_x=cm.focal_x, focal_y=cm.focal_y,
        tan_fovx=cm.tan_fovx, tan_fovy=cm.tan_fovy,
        near_thresh=0.3, mh_dist=3.0, cull_padding=100, ssim_frac=0.2,
        base_lr=1e-3, xyz_lr_init=0.16, xyz_lr_final=0.0016,
        quat_lr=1.0, scale_lr=5.0, opacity_lr=25.0, rgb_lr=2.5, sh_lr=0.125,
        scene_extent=2.0, num_iters=7000, pair_cap=pair_cap, row_cap=row_cap,
    )


def tile_rows(params, cm, st) -> tuple[int, int]:
    """(tile rows binning's first level expands for this view, Gaussians
    that own at least one). The reference's ``row_overflow`` also counts
    one sentinel row for each of the capacity's other records."""
    from ..ops import binning
    from ..train.step import _as_f32, _per_gaussian

    dev = params.xyz.device
    with torch.no_grad():
        view, proj, campos = (_as_f32(x, dev) for x in (cm.view, cm.proj, cm.campos))
        uv, _, _, mask, radius, z = _per_gaussian(params, view, proj, campos, st)
        _, _, off, rows = binning.row_expand_inputs(
            uv, z, radius, mask, num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y,
            tile_size=st.tile)
        return row_totals(off, rows)


def row_totals(offsets: torch.Tensor, rows: int) -> tuple[int, int]:
    """(rows, Gaussians with a row) from ``binning.row_expand_inputs``'s
    (N+1,) offsets and total."""
    return rows, int(((offsets[1:] - offsets[:-1]) > 0).sum())


@dataclasses.dataclass
class ScaleResult:
    n: int
    capacity: int
    scale_mul: float
    width: int
    height: int
    pairs: int  # the first step's
    overflow: int  # the first step's pair requirement (the reference's count)
    row_overflow: int  # and its row requirement
    rows: int  # tile rows of the first step's view
    row_gaussians: int  # Gaussians that own one or more of them
    last_pairs: int  # the last step's (the script's ``num_pairs``)
    first_s: float  # the first step, host clock, device synchronized
    steps: int  # timed steps a repetition
    step_ms: list  # ms a step of each repetition
    loss: float  # the last step's
    peak_mib: float | None  # peak allocated device memory; None on the CPU
    # what the run trained, to go on from
    state: object = dataclasses.field(default=None, repr=False)
    camera: object = dataclasses.field(default=None, repr=False)
    target: object = dataclasses.field(default=None, repr=False)
    statics: object = dataclasses.field(default=None, repr=False)

    @property
    def loss_finite(self) -> bool:
        return math.isfinite(self.loss)

    @property
    def reference_rows(self) -> int:
        """The rows as the reference counts them (its ``row_overflow``):
        every record of the capacity owns at least one, a sentinel where it
        has no tile row."""
        return self.rows + self.capacity - self.row_gaussians

    def summary(self) -> dict:
        return dict(
            n_gaussians=self.n, n_cap=self.capacity, scale_mul=self.scale_mul,
            num_pairs=self.last_pairs, first_pairs=self.pairs, first_tile_rows=self.rows,
            overflow=self.overflow, row_overflow=self.row_overflow,
            pair_cap=self.statics.pair_cap, row_cap=self.statics.row_cap,
            first_rows_with_sentinels=self.reference_rows,
            image=[self.width, self.height],
            first_step_s=self.first_s, step_ms=self.step_ms[-1], step_ms_reps=self.step_ms,
            mpix_s=self.width * self.height / self.step_ms[-1] / 1e3,
            loss_finite=self.loss_finite, peak_mib=self.peak_mib,
        )


class _Clock:
    """Milliseconds between ``start`` and ``stop``: CUDA events on the card
    (``stop`` waits for the device), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if not self.cuda:
            return 1e3 * (time.perf_counter() - self.t0)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        return self.t0.elapsed_time(end)


def run(n: int = CEILING, scale_mul: float = 1.0, *, steps: int = 6, reps: int = 3,
        width: int = WIDTH, height: int = HEIGHT, device: torch.device | str = "cuda",
        pair_cap: int = PAIR_CAP, row_cap: int = ROW_CAP, log=print) -> ScaleResult:
    """One train step of the script's scene at capacity
    ``round_capacity(n)``, then ``reps`` x ``steps`` timed steps (each
    repetition at iterations 1..steps, as the script's), at the caps
    given (default the script's)."""
    from ..train.state import round_capacity, state_from_gaussians
    from ..train.step import get_train_step
    from ..train.trainer import require_device

    device = require_device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    rng = np.random.default_rng(0)
    g = scale_gaussians(n, scale_mul, rng=rng)
    cap = round_capacity(n)
    state = state_from_gaussians(g, device, n_cap=cap)
    del g
    cm = scale_camera(width, height)
    st = scale_statics(width, height, pair_cap, row_cap)
    gt = torch.from_numpy(rng.uniform(0, 1, (height, width, 3)).astype(np.float32)).to(device)
    camera = [torch.as_tensor(x, device=device) for x in (cm.view, cm.proj, cm.campos)]
    clock = _Clock(device)
    train_step = get_train_step(st)

    def step(state, it):
        return train_step(state, *camera, gt, 0.0, it)

    rows, row_gaussians = tile_rows(state.params, cm, st)
    clock.start()
    state, m = step(state, 0)
    loss = float(m.loss)
    first_s = clock.stop() / 1e3
    pairs, overflow, row_overflow = (int(x) for x in (m.num_pairs, m.overflow,
                                                      m.row_overflow))
    log(f"N={n} cap={cap} pair_cap={pair_cap} first step {first_s:.3f} s, pairs {pairs}, "
        f"overflow {overflow}, tile rows {rows}, row_overflow {row_overflow}, "
        f"loss {loss:.6f}")
    times = []
    for _ in range(reps):
        clock.start()
        for i in range(steps):
            state, m = step(state, i + 1)
        times.append(clock.stop() / steps)
        loss = float(m.loss)
        log(f"step: {times[-1]:.3f} ms ({width * height / times[-1] / 1e3:.2f} Mpix/s)")
    peak = torch.cuda.max_memory_allocated(device) / 2**20 if cuda else None
    return ScaleResult(n=n, capacity=cap, scale_mul=scale_mul, width=width, height=height,
                       pairs=pairs, overflow=overflow, row_overflow=row_overflow,
                       rows=rows, row_gaussians=row_gaussians, last_pairs=int(m.num_pairs),
                       first_s=first_s, steps=steps, step_ms=times, loss=loss, peak_mib=peak,
                       state=state, camera=cm, target=gt, statics=st)


def main(argv=None, device: torch.device | str = "cuda") -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m gsplat_tpu_torch.tools.bench_scale",
                                description="Time the train step at the config's ceiling.")
    p.add_argument("n", type=int, nargs="?", default=CEILING)
    p.add_argument("scale_mul", type=float, nargs="?", default=1.0)
    args = p.parse_args(argv)
    res = run(args.n, args.scale_mul, device=device)
    out = res.summary()
    out["device"] = (torch.cuda.get_device_name(res.state.alive.device)
                     if res.state.alive.is_cuda else "cpu")
    print(json.dumps(out))
    return 0 if res.loss_finite else 1


if __name__ == "__main__":
    sys.exit(main())
