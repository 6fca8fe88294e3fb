"""The compiled render: ``get_render_fn`` over novel poses, one view after
another, each finished on the card before the next is issued, as a
viewer's frames are.

Set-up draws the seed's scene on the card and reads the path's largest
pair and row requirement from the program at exact sizing; the caps are
that, rounded as the trainer rounds them. The window renders the poses in
turn. A view's latency runs from its issue (a CUDA event recorded before
the call, on an idle stream) to its completion (an event after it). The
images of ``sample`` window positions drawn from the seed, and of the
first view of the heaviest pose, are kept and compared with the
reference's once the window has closed.
"""

from __future__ import annotations

import random

import torch

from gsbench import harness, roofline, scene, trace
from gsbench.reference import step as ref
from gsbench.reference.gaussians import PARAMS


def inputs(r: harness.Run) -> dict:
    cfg, tr = r.config, r.traffic
    w, h, f = harness.image_size(cfg)
    cams = scene.cameras(scene.novel_angles(tr["views"], tr["between"]), w, h, f)
    return dict(cams=cams, rst=harness.ref_statics(cfg, cams[0], tr["l_max"], 1.0))


def truth(r: harness.Run):
    return scene.gaussians(r.config["gaussians"], r.seed, r.device, r.config["scale_mul"])


def program(r: harness.Run, inp: dict) -> tuple[harness.Outcome, dict]:
    """Set-up and the window; returns the outcome and the kept images by
    window position."""
    from gsplat_tpu_torch.train.state import GaussianParams, round_pair_cap, round_row_cap
    from gsplat_tpu_torch.train.step import get_render_fn, release_graphs, render_image

    dev, tr = r.device, r.traffic
    harness.reset_peak(dev)
    params, alive = truth(r)
    gp = GaussianParams(alive.shape[0], device=dev)
    with torch.no_grad():
        for k in PARAMS:
            getattr(gp, k).copy_(params[k])
        gp.alive.copy_(alive)
    del params, alive
    cam_t = [harness.cam_tensors(c, dev) for c in inp["cams"]]
    r.phases.mark("the scene and the program's parameters")
    exact = harness.program_statics(inp["rst"], 0, 0)
    need = [render_image(gp, *c, 0.0, exact)[1] for c in cam_t]
    pairs = [int(t.overflow) for t in need]
    rows = max(int(t.row_overflow) for t in need)
    del need
    r.phases.mark("caps")
    render = get_render_fn(harness.program_statics(
        inp["rst"], round_pair_cap(max(pairs)), round_row_cap(rows)))
    for _ in range(2):  # the eager call, then the capture
        render(gp, *cam_t[0], 0.0)
    n = len(cam_t)
    rng = random.Random(scene.mix(r.seed, "sample"))
    keep = set(rng.sample(range(tr["sample_span"]), tr["sample"]))
    keep.add(max(range(n), key=lambda v: pairs[v]))
    kept = {}
    harness.sync(dev)
    r.phases.mark("first views: eager, capture")
    setup_s = harness.now() - r.started

    lat, k = [], 0
    cuda = dev.type == "cuda"
    with trace.window(r.trace) as prof:
        t0 = harness.now()
        while True:
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            else:
                h0 = harness.now()
            img = render(gp, *cam_t[k % n], 0.0)
            if cuda:
                e1.record()
                e1.synchronize()
                lat.append(e0.elapsed_time(e1))
            else:
                lat.append(1e3 * (harness.now() - h0))
            if k in keep:
                kept[k] = img
            k += 1
            if (k >= tr["trace_units"]) if r.trace else (harness.now() - t0 >= r.seconds
                                                          and k >= tr["sample_span"]):
                break
        harness.sync(dev)
        window_s = harness.now() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del gp, render
    release_graphs()
    if cuda:
        torch.cuda.empty_cache()
    out = harness.Outcome(kind="render", setup_s=setup_s, window_s=window_s, units=k,
                          attempted=k, failed=0, numbers={}, latencies_ms=lat,
                          memory_peak_bytes=peak, phases=r.phases)
    if prof:
        out.traced = trace.reduce(prof[0], "render", k)
    return out, kept


def reference(r: harness.Run, inp: dict, positions, low: bool = False) -> dict:
    params, alive = truth(r)
    n = len(inp["cams"])
    return {k: ref.render(params, alive, *harness.cam_tensors(inp["cams"][k % n], r.device), 0.0,
                          inp["rst"], low=low) for k in positions}


def count_work(r: harness.Run, inp: dict, out: harness.Outcome) -> None:
    params, alive = truth(r)
    n = len(inp["cams"])
    per_pose = [ref.work(params, alive, *harness.cam_tensors(c, r.device), inp["rst"])
                for c in inp["cams"]]
    works = [per_pose[k % n] for k in range(out.units)]
    out.traced.bounds_s = roofline.bound_seconds(works, train=False)
    out.traced.flops = roofline.step_ops(works, False, r.config["gaussians"], 0)


def measure(r: harness.Run) -> harness.Outcome:
    inp = inputs(r)
    r.phases.mark("inputs: the poses")
    out, kept = program(r, inp)
    if out.traced is not None:
        count_work(r, inp, out)
    pos = sorted(kept)
    base = reference(r, inp, pos)
    out.numbers = harness.image_numbers([kept[k] for k in pos], [base[k] for k in pos])
    return out


def calibrate(r: harness.Run, modes: list) -> dict:
    inp = inputs(r)
    res = {}
    positions = None
    for mode in modes:
        if mode == "program":
            kept = program(r, inp)[1]
            positions = sorted(kept)
            base = reference(r, inp, positions)
            res[mode] = harness.image_numbers([kept[k] for k in positions],
                                              [base[k] for k in positions])
        else:
            positions = positions or list(range(len(inp["cams"])))
            base = reference(r, inp, positions)
            low = reference(r, inp, positions, low=True)
            res[mode] = harness.image_numbers([low[k] for k in positions],
                                              [base[k] for k in positions])
    return res
