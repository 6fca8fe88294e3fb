"""Mip-Splatting's compiled train step (``MipStepStatics``):
``get_monitored_train_step`` replayed back to back on one state, with the
3D filter's camera sweep at the trainer's cadence.

The inputs, the start state, the schedule and the caps are
``train_step.py``'s (its functions, imported). The program's state
carries ``filter_3d``; set-up makes the sweep's table from the
configuration's ``mip`` poses (``filter_poses``: ``photos`` poses on the
circle of the training views less every ``test_split_ratio``-th, as the
garden run's training split) and sweeps once before the first step. The
first ``check_steps`` steps warm the step and capture its graph; the
window replays it on the views in turn and, at every monitor boundary
that is a multiple of ``filter_interval`` iterations, reads the monitor
and sweeps, as the trainer does after its density step. The sweep writes
the filter in place, so the captured graph reads it with no recapture.

``correct`` compares the first steps with ``reference/mip.py`` from the
same start (``loss_gap``, ``grad_gap``, ``change_gap``, as
``harness.training_numbers``), and the program's first sweep with the
reference's (``filter3d_gap``, ``reference/mip.py::filter_gap``: the share
of alive Gaussians whose filter is off by more than 1e-4 of it). A traced
run also reads the sweep kernel's device time in the trace and its least
time (``gsbench/mip_roofline.py``).

A program without Mip-Splatting (no ``gsplat_tpu_torch.ops.mip``) ends the
run with an error before any work.
"""

from __future__ import annotations

import dataclasses

import torch

from gsbench import harness, mip_roofline, roofline, scene, trace
from gsbench.entries import train_step as plain
from gsbench.reference import mip as ref_mip
from gsbench.reference import step as ref
from gsbench.reference.gaussians import PARAMS

SWEEP_KERNEL = "nearest_depth_kernel"  # csrc/filter3d.cu's __global__ name


def require_mip(r: harness.Run) -> None:
    """Raise unless the program runs Mip-Splatting with the configuration's
    constants, which are the reference's."""
    try:
        from gsplat_tpu_torch.ops import mip
    except ImportError as e:
        raise SystemExit(f"gsbench: the program has no Mip-Splatting ({e})") from e
    m = r.config["mip"]
    want = dict(FILTER_VARIANCE=m["filter_3d_variance"], KERNEL_2D=m["kernel_size_2d"],
                DEPTH_FLOOR=m["depth_floor"], MARGIN=m["screen_margin"])
    ours = {k: getattr(ref_mip, k) for k in want}
    got = {k: getattr(mip, k, None) for k in want}
    if not want == ours == got:
        raise SystemExit(f"gsbench: Mip-Splatting's constants: the configuration's {want}, "
                         f"the reference's {ours}, the program's {got}")


def filter_poses(r: harness.Run) -> list:
    """The sweep's cameras: the training split of ``photos`` poses on the
    circle, every ``test_split_ratio``-th held out."""
    m = r.config["mip"]
    w, h, f = harness.image_size(r.config)
    angles = [a for i, a in enumerate(scene.training_angles(m["photos"]))
              if i % m["test_split_ratio"]]
    return scene.cameras(angles, w, h, f)


def inputs(r: harness.Run) -> dict:
    inp = plain.inputs(r)
    inp["filter_cams"] = filter_poses(r)
    if len(inp["filter_cams"]) != r.config["mip"]["filter_cameras"]:
        raise ValueError("the configuration's filter_cameras is not its training split")
    return inp


def program(r: harness.Run, inp: dict) -> tuple[harness.Outcome, dict, int]:
    """Set-up, the window and the program's readings of its first steps
    and its first sweep; returns (outcome, readings, the first window
    step's k)."""
    from gsplat_tpu_torch.ops.mip import camera_table, update_filter_3d_
    from gsplat_tpu_torch.train.state import GaussianParams, init_state, with_filter_3d
    from gsplat_tpu_torch.train.step import (
        fresh_monitor, get_monitored_train_step, mip_statics, release_graphs)

    dev, tr = r.device, r.traffic
    harness.reset_peak(dev)
    params, alive = plain.start_state(r)
    gp = GaussianParams(alive.shape[0], device=dev)
    with torch.no_grad():
        for k in PARAMS:
            getattr(gp, k).copy_(params[k])
        gp.alive.copy_(alive)
    del params
    with_filter_3d(gp)
    state = init_state(gp)
    cam_t = [harness.cam_tensors(c, dev) for c in inp["cams"]]
    table = camera_table(inp["filter_cams"], dev)
    update_filter_3d_(gp, table)
    first_filter = gp.filter_3d.clone()
    r.phases.mark("the program's state and its first sweep")
    st = mip_statics(harness.program_statics(inp["rst"], 0, 0))
    pair_cap, row_cap = mip_caps(r, gp, cam_t, st)
    r.phases.mark("caps")
    step = get_monitored_train_step(dataclasses.replace(st, pair_cap=pair_cap, row_cap=row_cap))
    monitor = fresh_monitor(dev)

    def one(k, monitor):
        it, v, bg = plain.schedule(r, k)
        return step(state, *cam_t[v], inp["gts"][v], bg, it, monitor)

    losses = []
    for k in range(tr["check_steps"]):
        state, m, monitor = one(k, monitor)
        losses.append(m.loss)
        if k == 0:
            grad = harness.leaf_norms(state.adam_m, 1.0 / (1.0 - ref.B1))
    start, _ = plain.start_state(r)
    change = harness.change_norms({k: getattr(state.params, k) for k in PARAMS}, start)
    del start
    got = dict(losses=[float(x) for x in losses], grad=grad, change=change,
               filter=first_filter)
    monitor = fresh_monitor(dev)
    harness.sync(dev)
    r.phases.mark("first steps: eager, capture, replay")
    setup_s = harness.now() - r.started

    period, every = tr["monitor_interval"], r.config["mip"]["filter_interval"]
    k0 = k = tr["check_steps"]
    failed = sweeps = 0
    with trace.window(r.trace) as prof:
        t0 = harness.now()
        while True:
            state, _, monitor = one(k, monitor)
            k += 1
            if (k - k0) % period == 0:
                mon = monitor.tolist()  # the interval's one host read
                monitor = fresh_monitor(dev)
                if mon[0] > pair_cap or mon[1] > row_cap or not mon[2] > 0.0:
                    failed += period
                if (k - k0) % every == 0:
                    update_filter_3d_(gp, table)
                    sweeps += 1
                if (k - k0 >= tr["trace_units"]) if r.trace else (harness.now() - t0 >= r.seconds):
                    break
        harness.sync(dev)
        window_s = harness.now() - t0
    units = k - k0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state, gp, step, monitor
    release_graphs()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = harness.Outcome(kind="train", setup_s=setup_s, window_s=window_s, units=units,
                          attempted=units, failed=failed, numbers={}, memory_peak_bytes=peak,
                          phases=r.phases)
    if prof:
        out.traced = trace.reduce(prof[0], "train", units)
        out.traced.filter3d_kernel_s = kernel_seconds(prof[0], SWEEP_KERNEL)
        out.traced.filter3d_sweeps = sweeps
    return out, got, k0


def mip_caps(r: harness.Run, gp, cam_t, st) -> tuple[int, int]:
    """``train_step.caps``' rule on Mip-Splatting's render."""
    if "caps" in r.config:
        return r.config["caps"]["pair_cap"], r.config["caps"]["row_cap"]
    from gsplat_tpu_torch.train.state import round_pair_cap, round_row_cap
    from gsplat_tpu_torch.train.step import render_image

    pairs = rows = 0
    for cam in cam_t:
        tables = render_image(gp, *cam, 0.0, st)[1]
        pairs, rows = max(pairs, int(tables.overflow)), max(rows, int(tables.row_overflow))
    return round_pair_cap(pairs + (pairs >> 2), minimum=1 << 20), round_row_cap(rows + (rows >> 2))


def kernel_seconds(prof, name: str) -> float | None:
    """The device seconds of the kernels named ``name`` in the trace
    (None without one)."""
    total, found = 0.0, False
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU and name in e.name():
            total += e.duration_ns() / 1e9
            found = True
    return total if found else None


def reference(r: harness.Run, inp: dict, low: bool = False, fault: str | None = None) -> dict:
    """The reference's readings of the first steps and the first sweep
    from the same start. ``fault`` "half": the loss over the top half of
    the image's rows; "no3d": no 3D filter; "dilate": 3DGS's 0.3 dilation
    in place of the 2D Mip filter."""
    params, alive = plain.start_state(r)
    filt = ref_mip.filter_3d(params["xyz"], alive, inp["filter_cams"], low)
    if fault == "no3d":
        filt = torch.zeros_like(filt)
    s = ref.State.fresh(params, alive)
    rows = slice(0, inp["rst"].height // 2) if fault == "half" else slice(None)
    losses = []
    for k in range(r.traffic["check_steps"]):
        it, v, bg = plain.schedule(r, k)
        losses.append(ref_mip.train_step(s, filt, *harness.cam_tensors(inp["cams"][v], r.device),
                                         inp["gts"][v], bg, it, inp["rst"], low=low,
                                         loss_rows=rows, dilate=fault == "dilate"))
        if k == 0:
            grad = harness.leaf_norms(s.m, 1.0 / (1.0 - ref.B1))
    return dict(losses=losses, grad=grad, change=harness.change_norms(s.params, params),
                filter=filt, alive=alive)


def numbers(got: dict, want: dict) -> dict:
    out = harness.training_numbers(got, want)
    out["filter3d_gap"] = ref_mip.filter_gap(got["filter"], want["filter"], want["alive"])
    return out


def count_work(r: harness.Run, inp: dict, out: harness.Outcome, k0: int) -> None:
    """The traced window's least kernel time and modelled operations, from
    each stepped view's work at the start state under Mip-Splatting's
    geometry, and the window's sweeps."""
    params, alive = plain.start_state(r)
    filt = ref_mip.filter_3d(params["xyz"], alive, inp["filter_cams"])
    rst = inp["rst"]
    per_view, works = {}, []
    for k in range(k0, k0 + out.units):
        v = plain.schedule(r, k)[1]
        if v not in per_view:
            per_view[v] = ref_mip.work(params, alive, filt,
                                       *harness.cam_tensors(inp["cams"][v], r.device), rst)
        works.append(per_view[v])
    t, n, cams = out.traced, r.config["gaussians"], len(inp["filter_cams"])
    t.bounds_s = roofline.bound_seconds(works, train=True)
    t.flops = (roofline.step_ops(works, True, n, rst.width * rst.height)
               + mip_roofline.filter_ops(len(works), n)
               + t.filter3d_sweeps * mip_roofline.sweep_ops(n, cams))
    t.filter3d_bound_s = t.filter3d_sweeps * mip_roofline.sweep_bound_ms(n, cams) / 1e3


def measure(r: harness.Run) -> harness.Outcome:
    require_mip(r)
    inp = inputs(r)
    r.phases.mark("inputs: the scene and the reference's ground truths")
    out, got, k0 = program(r, inp)
    if out.traced is not None:
        count_work(r, inp, out, k0)
    out.numbers = numbers(got, reference(r, inp))
    return out


def calibrate(r: harness.Run, modes: list) -> dict:
    """The compared numbers of each of ``modes`` ("program", "control",
    "half", "no3d", "dilate") against the reference, on this run's seed."""
    require_mip(r)
    inp = inputs(r)
    base = reference(r, inp)
    res = {}
    for mode in modes:
        if mode == "program":
            got = program(r, inp)[1]
        else:
            got = reference(r, inp, low=mode == "control",
                            fault=None if mode == "control" else mode)
        res[mode] = numbers(got, base)
    return res

