"""The compiled train step: ``get_monitored_train_step`` replayed back to
back on one state.

Set-up draws the scene from the seed on the card, renders its ground
truths from the traffic's training views with the reference, and hands the
program the perturbed copy (``scene.gaussians(perturb=True)``) with fresh
moments at ``start_iteration``. The caps are the configuration's, or the
reference trainer's rule at set-up: the views' largest pair and row
requirement plus a quarter (densification is on). The first
``check_steps`` steps are the window's own calls on views 0, 1, 2, ...;
they warm the step and capture its graph, and the reference follows them.
The window replays the step on the views in turn, iteration by iteration,
with the trainer's background rule, and reads the on-device monitor every
``monitor_interval`` iterations as the trainer does; an interval whose
monitor shows a requirement over a cap or a non-finite loss counts all its
iterations failed.
"""

from __future__ import annotations

import torch

from gsbench import harness, roofline, scene, trace
from gsbench.reference import step as ref
from gsbench.reference.gaussians import PARAMS

def inputs(r: harness.Run) -> dict:
    cfg, tr = r.config, r.traffic
    w, h, f = harness.image_size(cfg)
    cams = scene.cameras(scene.training_angles(tr["views"]), w, h, f)
    rst = harness.ref_statics(cfg, cams[0], tr["l_max"], scene.scene_extent(cams))
    truth, alive = scene.gaussians(cfg["gaussians"], r.seed, r.device, cfg["scale_mul"])
    gts = [ref.render(truth, alive, *harness.cam_tensors(c, r.device), 0.0, rst) for c in cams]
    del truth
    return dict(cams=cams, rst=rst, gts=gts)


def start_state(r: harness.Run) -> tuple[dict, torch.Tensor]:
    cfg = r.config
    return scene.gaussians(cfg["gaussians"], r.seed, r.device, cfg["scale_mul"], perturb=True)


def schedule(r: harness.Run, k: int) -> tuple[int, int, float]:
    """(iteration, view, background) of the run's k-th step."""
    it = r.traffic["start_iteration"] + k
    return it, k % r.traffic["views"], harness.background(r.config, it)


def caps(r: harness.Run, params, cam_t, rst) -> tuple[int, int]:
    if "caps" in r.config:
        return r.config["caps"]["pair_cap"], r.config["caps"]["row_cap"]
    from gsplat_tpu_torch.train.state import round_pair_cap, round_row_cap
    from gsplat_tpu_torch.train.step import render_image

    st = harness.program_statics(rst, 0, 0)
    pairs = rows = 0
    for cam in cam_t:
        tables = render_image(params, *cam, 0.0, st)[1]
        pairs, rows = max(pairs, int(tables.overflow)), max(rows, int(tables.row_overflow))
    return round_pair_cap(pairs + (pairs >> 2), minimum=1 << 20), round_row_cap(rows + (rows >> 2))


def program(r: harness.Run, inp: dict) -> tuple[harness.Outcome, dict, int]:
    """Set-up, the window and the program's readings of its first steps;
    returns (outcome, readings, the first window step's k)."""
    from gsplat_tpu_torch.train.state import GaussianParams, init_state
    from gsplat_tpu_torch.train.step import (
        fresh_monitor, get_monitored_train_step, release_graphs)

    dev, tr = r.device, r.traffic
    harness.reset_peak(dev)
    params, alive = start_state(r)
    gp = GaussianParams(alive.shape[0], device=dev)
    with torch.no_grad():
        for k in PARAMS:
            getattr(gp, k).copy_(params[k])
        gp.alive.copy_(alive)
    del params
    state = init_state(gp)
    cam_t = [harness.cam_tensors(c, dev) for c in inp["cams"]]
    r.phases.mark("the program's state")
    pair_cap, row_cap = caps(r, gp, cam_t, inp["rst"])
    r.phases.mark("caps")
    step = get_monitored_train_step(harness.program_statics(inp["rst"], pair_cap, row_cap))
    monitor = fresh_monitor(dev)

    def one(k, monitor):
        it, v, bg = schedule(r, k)
        return step(state, *cam_t[v], inp["gts"][v], bg, it, monitor)

    losses = []
    for k in range(tr["check_steps"]):
        state, m, monitor = one(k, monitor)
        losses.append(m.loss)
        if k == 0:
            grad = harness.leaf_norms(state.adam_m, 1.0 / (1.0 - ref.B1))
    start, _ = start_state(r)
    change = harness.change_norms({k: getattr(state.params, k) for k in PARAMS}, start)
    del start
    got = dict(losses=[float(x) for x in losses], grad=grad, change=change)
    monitor = fresh_monitor(dev)
    harness.sync(dev)
    r.phases.mark("first steps: eager, capture, replay")
    setup_s = harness.now() - r.started

    period = tr["monitor_interval"]
    k0 = k = tr["check_steps"]
    failed = 0
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
    return out, got, k0


def reference(r: harness.Run, inp: dict, low: bool = False, fault: str | None = None) -> dict:
    """The reference's readings of the first steps from the same start.
    ``fault`` "half": the loss over the top half of the image's rows."""
    params, alive = start_state(r)
    s = ref.State.fresh(params, alive)
    rows = slice(0, inp["rst"].height // 2) if fault == "half" else slice(None)
    losses = []
    for k in range(r.traffic["check_steps"]):
        it, v, bg = schedule(r, k)
        losses.append(ref.train_step(s, *harness.cam_tensors(inp["cams"][v], r.device),
                                     inp["gts"][v], bg, it, inp["rst"], low=low, loss_rows=rows))
        if k == 0:
            grad = harness.leaf_norms(s.m, 1.0 / (1.0 - ref.B1))
    return dict(losses=losses, grad=grad, change=harness.change_norms(s.params, params))


def count_work(r: harness.Run, inp: dict, out: harness.Outcome, k0: int) -> None:
    """The traced window's least kernel time and modelled operations, from
    each stepped view's work at the start state."""
    params, alive = start_state(r)
    rst = inp["rst"]
    per_view = {}
    works = []
    for k in range(k0, k0 + out.units):
        v = schedule(r, k)[1]
        if v not in per_view:
            per_view[v] = ref.work(params, alive, *harness.cam_tensors(inp["cams"][v], r.device),
                                   rst)
        works.append(per_view[v])
    out.traced.bounds_s = roofline.bound_seconds(works, train=True)
    out.traced.flops = roofline.step_ops(works, True, r.config["gaussians"],
                                         rst.width * rst.height)


def measure(r: harness.Run) -> harness.Outcome:
    inp = inputs(r)
    r.phases.mark("inputs: the scene and the reference's ground truths")
    out, got, k0 = program(r, inp)
    if out.traced is not None:
        count_work(r, inp, out, k0)
    out.numbers = harness.training_numbers(got, reference(r, inp))
    return out


def calibrate(r: harness.Run, modes: list) -> dict:
    """The compared numbers of each of ``modes`` ("program", "control",
    "half") against the reference, on this run's seed."""
    inp = inputs(r)
    base = reference(r, inp)
    res = {}
    for mode in modes:
        if mode == "program":
            got = program(r, inp)[1]
        else:
            got = reference(r, inp, low=mode == "control",
                            fault=None if mode == "control" else mode)
        res[mode] = harness.training_numbers(got, base)
    return res
