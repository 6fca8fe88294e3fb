"""The trainer: ``Trainer.train`` on PNG ground truths that the port's own
``AsyncImageLoader`` decodes, one thread, one view an iteration.

Set-up renders the seed's scene from the traffic's views with the
reference, writes them as PNG under ``TMPDIR``, makes the SfM-like cloud
of its centres and hands the program what its CLI would: the cloud through
``initialize_gaussians`` (the native KNN), COLMAP cameras, the
configuration's training schedule, then resumes at ``start_iteration``
with ``l_max`` bands and the caps a resumed checkpoint carries. The first
``check_steps`` iterations are one ``train`` call, the window's own call
and loader, ending at a print boundary with its monitor read, image dump
and density step (prune, clone, split, Morton re-sort); the reference
follows the steps and the density step. The window takes iterations in
whole ``train(max_iters=...)`` calls, each through the next print
boundary, until the window's time is up; every call's time counts. A
call in which the trainer grew a capacity had steps past a cap: its
iterations count failed.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import random
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from gsbench import harness, scene, trace
from gsbench.reference import density as ref_density
from gsbench.reference import init as ref_init
from gsbench.reference import step as ref

DRAW = 1_000_003  # the loader's draw k: random.Random(seed * DRAW + k)


def draw(seed: int, k: int, n: int) -> int:
    return random.Random(seed * DRAW + k).randint(0, n - 1)


def draw_seed(r: harness.Run) -> int:
    """The training config's seed: from the run's seed, the first one on
    which the checked iterations draw views that all differ."""
    tr = r.traffic
    s = scene.mix(r.seed, "draws") % (1 << 31)
    its = range(tr["start_iteration"], tr["start_iteration"] + tr["check_steps"])
    while len({draw(s, k, tr["views"]) for k in its}) < len(its):
        s += 1
    return s


def inputs(r: harness.Run) -> dict:
    from PIL import Image as PILImage

    cfg, tr = r.config, r.traffic
    w, h, f = harness.image_size(cfg)
    angles = scene.training_angles(tr["views"])
    cams = scene.cameras(angles, w, h, f)
    rst = harness.ref_statics(cfg, cams[0], tr["l_max"], scene.scene_extent(cams))
    truth, alive = scene.gaussians(cfg["gaussians"], r.seed, r.device, cfg["scale_mul"])
    gts = [torch.clamp(ref.render(truth, alive, *harness.cam_tensors(c, r.device), 0.0, rst)
                       * 255.0, 0, 255).to(torch.uint8).cpu().numpy() for c in cams]
    xyz, rgb = scene.sfm_cloud(truth, cfg["gaussians"], r.seed)
    del truth, alive
    root = Path(tempfile.mkdtemp(prefix="gsbench-"))
    paths = [root / f"view_{i:03d}.png" for i in range(len(cams))]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda a: PILImage.fromarray(a[1]).save(a[0]), zip(paths, gts)))
    poses = [scene.circle_pose(a) for a in angles]
    return dict(cams=cams, rst=rst, gts=gts, xyz=xyz, rgb=rgb, root=root, paths=paths,
                poses=poses, seed=draw_seed(r))


def _trainer(r: harness.Run, inp: dict):
    import dataclasses as dc

    from gsplat_tpu_torch.config import ConfigParameters
    from gsplat_tpu_torch.io.colmap import Camera, Image
    from gsplat_tpu_torch.train.init import initialize_gaussians
    from gsplat_tpu_torch.train.trainer import Trainer

    w, h, f = harness.image_size(r.config)
    fields = {x.name for x in dc.fields(ConfigParameters)}
    train = {k: v for k, v in r.config["train"].items() if k in fields}
    train.update(dataset_path=str(inp["root"]), output_dir=str(inp["root"] / "out"),
                 seed=inp["seed"])
    config = ConfigParameters(**train)
    cameras = {1: Camera(id=1, model="PINHOLE", width=w, height=h,
                         params=np.array([f, f, w / 2, h / 2]))}
    images = {i + 1: Image(id=i + 1, qvec=q, tvec=t, camera_id=1, name=str(p),
                           xys=np.zeros((0, 2)), point3d_ids=np.zeros(0, np.int64))
              for i, ((q, t), p) in enumerate(zip(inp["poses"], inp["paths"]))}
    trainer = Trainer(config, initialize_gaussians(inp["xyz"], inp["rgb"], config), images,
                      cameras, device=r.device)
    trainer.iter = r.traffic["start_iteration"]
    trainer.l_max = r.traffic["l_max"]
    return trainer


def _resumed_caps(trainer, inp: dict) -> None:
    """The caps a run resumed here carries in its checkpoint: grown, as the
    trainer grows them while it densifies, to the views' largest pair and
    row requirement plus a quarter."""
    from gsplat_tpu_torch.train.state import round_pair_cap, round_row_cap
    from gsplat_tpu_torch.train.step import render_image

    st = harness.program_statics(inp["rst"], 0, 0)
    pairs = rows = 0
    for cam in inp["cams"]:
        tables = render_image(trainer.state.params, *harness.cam_tensors(cam, trainer.device),
                              0.0, st)[1]
        pairs, rows = max(pairs, int(tables.overflow)), max(rows, int(tables.row_overflow))
    trainer.pair_cap = max(trainer.pair_cap, round_pair_cap(pairs + (pairs >> 2),
                                                            minimum=trainer.pair_cap_minimum))
    trainer.row_cap = max(trainer.row_cap, round_row_cap(rows + (rows >> 2)))


@contextlib.contextmanager
def spans(enabled: bool):
    """In a traced run, host ranges around the trainer's calls into its
    layers (the loader's wait, the step, the density step, the image dump),
    so that the trace can name what the host did in an idle gap."""
    if not enabled:
        yield
        return
    from torch.profiler import record_function

    from gsplat_tpu_torch.io.images import AsyncImageLoader
    from gsplat_tpu_torch.train.trainer import Trainer

    def wrap(cls, attr, name):
        real = getattr(cls, attr)

        def call(*args, **kw):
            with record_function(name):
                return real(*args, **kw)

        setattr(cls, attr, call)
        return cls, attr, real

    saved = [wrap(AsyncImageLoader, "next", "gsbench.loader_wait"),
             wrap(Trainer, "_step", "gsbench.step"),
             wrap(Trainer, "_density_step", "gsbench.density"),
             wrap(Trainer, "_dump_image", "gsbench.dump")]
    try:
        yield
    finally:
        for cls, attr, real in saved:
            setattr(cls, attr, real)


def _boundary(r: harness.Run, it: int) -> int:
    """The end of the call that starts at ``it``: through the next print
    boundary."""
    p = r.config["train"]["print_interval"]
    return (it // p + 1) * p + 1


def program(r: harness.Run, inp: dict) -> tuple[harness.Outcome, dict]:
    import gsplat_tpu_torch.train.trainer as tmod
    from gsplat_tpu_torch.train.step import release_graphs

    dev, tr = r.device, r.traffic
    harness.reset_peak(dev)
    trainer = _trainer(r, inp)
    r.phases.mark("Trainer: the native KNN and the state")
    _resumed_caps(trainer, inp)
    r.phases.mark("caps")
    params = trainer.state.params
    start = {k: getattr(params, k).detach().clone() for k in ref.PARAMS}
    real, losses, grad = tmod.get_monitored_train_step, [], {}

    def hooked(st):
        fn = real(st)

        def call(*args):
            out = fn(*args)
            losses.append(out[1].loss)
            if len(losses) == 1:
                grad.update(harness.leaf_norms(out[0].adam_m, 1.0 / (1.0 - ref.B1)))
            return out

        return call

    got = dict(grad=grad)
    real_density = trainer._density_step

    def density():  # the boundary's density step: the change before it, its result
        got["change"] = harness.change_norms({k: getattr(trainer.state.params, k)
                                              for k in ref.PARAMS}, start)
        info = real_density()
        p = trainer.state.params
        got.update(counts=dict(pruned=info.num_pruned, cloned=info.num_cloned,
                               split=info.num_split),
                   after=harness.leaf_norms({k: getattr(p, k) for k in ref.PARAMS}),
                   unsorted=ref_density.unsorted_share(p.xyz.detach(), p.alive))
        return info

    tmod.get_monitored_train_step, trainer._density_step = hooked, density
    try:
        trainer.train(max_iters=tr["start_iteration"] + tr["check_steps"], verbose=False)
    finally:
        tmod.get_monitored_train_step = real
        del trainer._density_step
    if "counts" not in got:
        raise ValueError("the checked iterations must end at a density step")
    got["losses"] = [float(x) for x in losses]
    del start, params
    harness.sync(dev)
    r.phases.mark("first iterations: eager, capture, replay")
    setup_s = harness.now() - r.started

    units = failed = 0
    with trace.window(r.trace) as prof, spans(r.trace):
        t0 = harness.now()
        while True:
            it, caps = trainer.iter, (trainer.pair_cap, trainer.row_cap)
            trainer.train(max_iters=_boundary(r, it), verbose=False)
            units += trainer.iter - it
            if (trainer.pair_cap, trainer.row_cap) != caps:
                failed += trainer.iter - it
            if r.trace or harness.now() - t0 >= r.seconds:
                break
        harness.sync(dev)
        window_s = harness.now() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del trainer
    release_graphs()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = harness.Outcome(kind="trainer", setup_s=setup_s, window_s=window_s, units=units,
                          attempted=units, failed=failed, numbers={}, memory_peak_bytes=peak,
                          phases=r.phases)
    if prof:
        out.traced = trace.reduce(prof[0], "trainer", units)
    return out, got


def reference(r: harness.Run, inp: dict, low: bool = False, fault: str | None = None) -> dict:
    tr = r.traffic
    params, alive = ref_init.from_cloud(inp["xyz"], inp["rgb"], r.device)
    s = ref.State.fresh(params, alive)
    rows = slice(0, inp["rst"].height // 2) if fault == "half" else slice(None)
    losses = []
    for k in range(tr["check_steps"]):
        it = tr["start_iteration"] + k
        v = draw(inp["seed"], it, tr["views"])
        gt = torch.from_numpy(inp["gts"][v]).to(r.device).to(torch.float32) / 255.0
        losses.append(ref.train_step(s, *harness.cam_tensors(inp["cams"][v], r.device), gt,
                                     harness.background(r.config, it), it, inp["rst"], low=low,
                                     loss_rows=rows))
        if k == 0:
            grad = harness.leaf_norms(s.m, 1.0 / (1.0 - ref.B1))
    change = harness.change_norms(s.params, params)
    counts = ref_density.step(s, r.config["train"], inp["rst"].scene_extent, inp["seed"], it)
    order = torch.argsort(ref_density.morton_codes(s.params["xyz"], s.alive), stable=True)
    return dict(losses=losses, grad=grad, change=change, counts=counts,
                after=harness.leaf_norms(s.params),
                unsorted=ref_density.unsorted_share(s.params["xyz"][order], s.alive[order]))


def numbers(got: dict, ref: dict) -> dict:
    return {**harness.training_numbers(got, ref), **harness.density_numbers(got, ref)}


def measure(r: harness.Run) -> harness.Outcome:
    inp = inputs(r)
    r.phases.mark("inputs: the scene, ground truths as PNG, the cloud")
    try:
        out, got = program(r, inp)
        out.numbers = numbers(got, reference(r, inp))
    finally:
        shutil.rmtree(inp["root"], ignore_errors=True)
    return out


def calibrate(r: harness.Run, modes: list) -> dict:
    inp = inputs(r)
    try:
        base = reference(r, inp)
        res = {}
        for mode in modes:
            if mode == "program":
                got = program(r, inp)[1]
            else:
                got = reference(r, inp, low=mode == "control",
                                fault=None if mode == "control" else mode)
            res[mode] = numbers(got, base)
    finally:
        shutil.rmtree(inp["root"], ignore_errors=True)
    return res
