"""Data-parallel training over the configuration's ranks:
``parallel.get_monitored_dp_train_step`` on one view a rank, replayed back
to back, as ``Trainer._step`` runs it under ``--dp``.

This process is rank 0 on the run's device (``cuda:0``). It starts ranks
1..B-1 as spawned processes, rank r on ``cuda:r`` (on the CPU, the ranks
join over gloo), and every rank joins the process group through the
program's ``initialize_multihost``. Each rank draws the seed's scene and
renders its own views' ground truths with the reference. The start state
is drawn on rank 0 (``scene.gaussians(perturb=True)``) and broadcast, so
the replicas start bit-identical. The caps are ``train_step.py``'s rule
over every view: each rank's largest requirement over its views, then the
largest over the ranks. Rank 0 reads its own before the group forms, so
that it builds the kernels while the other ranks start.

Step k's rank r trains on view (B k + r) mod ``views`` at iteration
``start_iteration`` + k, with the trainer's background rule. The first
``check_steps`` steps are the eager call, the capture and the first
replay. The window replays the step on every rank; at every
``monitor_interval`` iterations each rank reads its monitor, and rank 0
tells the others whether to go on (one broadcast). After the window the
ranks compare their state with rank 0's (``replica_gap``: the largest
absolute difference of any parameter, Adam moment or accumulator; 0 when
the replicas are bit-identical), and rank 0 compares its first steps with
``reference/dp.py``'s batch step.

No run hangs. The process group times out after ``TIMEOUT_S``. A watchdog
thread in rank 0 ends the process with an error as soon as a rank exits
with a fault, or when rank 0 makes no progress for ``TIMEOUT_S``. The
other ranks die with rank 0 (``PR_SET_PDEATHSIG``), and are killed on its
way out.
"""

from __future__ import annotations

import ctypes
import importlib
import multiprocessing as mp
import os
import signal
import sys
import threading
import time

import torch
import torch.distributed as dist

from gsbench import harness, roofline, scene, trace
from gsbench.reference import dp as ref_dp
from gsbench.reference import step as ref
from gsbench.reference.gaussians import PARAMS, full_f32
from gsbench.reference.init import capacity

TIMEOUT_S = 120.0  # the process group's timeout, and the watchdog's longest silence


def world(r: harness.Run) -> int:
    return r.config["parallel"]["ranks"]


def backend(r: harness.Run) -> str:
    return r.config["parallel"]["backend"] if r.device.type == "cuda" else "gloo"


def schedule(r: harness.Run, k: int, rank: int) -> tuple[int, int, float]:
    """(iteration, view, background) of rank ``rank``'s k-th step."""
    it = r.traffic["start_iteration"] + k
    return it, (world(r) * k + rank) % r.traffic["views"], harness.background(r.config, it)


def own_views(r: harness.Run, rank: int) -> list:
    return sorted({schedule(r, k, rank)[1] for k in range(r.traffic["views"])})


def cameras(r: harness.Run) -> tuple[list, object]:
    cfg, tr = r.config, r.traffic
    w, h, f = harness.image_size(cfg)
    cams = scene.cameras(scene.training_angles(tr["views"]), w, h, f)
    return cams, harness.ref_statics(cfg, cams[0], tr["l_max"], scene.scene_extent(cams))


def ground_truths(r: harness.Run, cams: list, rst, views) -> dict:
    """{view: the reference's render of the seed's scene}."""
    cfg = r.config
    truth, alive = scene.gaussians(cfg["gaussians"], r.seed, r.device, cfg["scale_mul"])
    return {v: ref.render(truth, alive, *harness.cam_tensors(cams[v], r.device), 0.0, rst)
            for v in views}


def start_state(r: harness.Run) -> tuple[dict, torch.Tensor]:
    cfg = r.config
    return scene.gaussians(cfg["gaussians"], r.seed, r.device, cfg["scale_mul"], perturb=True)


class Watchdog(threading.Thread):
    """Calls ``abort(reason)`` as soon as one of ``polls`` (callables that
    return a rank's exit code, or None while it runs) gives a code other
    than 0, or when ``beat()`` has not been called for ``silence_s``."""

    def __init__(self, polls: list, silence_s: float, abort):
        super().__init__(name="gsbench.watchdog", daemon=True)
        self.polls, self.silence_s, self.abort = polls, silence_s, abort
        self.last = time.monotonic()
        self.done = threading.Event()

    def beat(self) -> None:
        self.last = time.monotonic()

    def run(self) -> None:
        while not self.done.wait(0.2):
            for rank, poll in enumerate(self.polls, start=1):
                code = poll()
                if code not in (None, 0):
                    self.abort(f"rank {rank} exited with code {code}")
                    return
            if time.monotonic() - self.last > self.silence_s:
                self.abort(f"rank 0 made no progress for {self.silence_s:.0f} s")
                return

    def stop(self) -> None:
        self.done.set()
        if self.is_alive() and threading.current_thread() is not self:
            self.join()


class Ranks:
    """Ranks 1..B-1 as spawned processes, and rank 0's watchdog over them."""

    def __init__(self, r: harness.Run, addr: str):
        n = world(r)
        # The function a spawned rank runs, by its importable name.
        child = importlib.import_module("gsbench.entries.dp_step")._rank
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=child, daemon=True, name=f"gsbench.rank{rank}",
                                  args=(rank, addr, r.workload, r.config, r.traffic, r.seed,
                                        r.device.type))
                      for rank in range(1, n)]
        for p in self.procs:
            p.start()
        self.watchdog = Watchdog([(lambda p=p: p.exitcode) for p in self.procs], TIMEOUT_S,
                                 self.abort)
        self.watchdog.start()

    def beat(self) -> None:
        self.watchdog.beat()

    def kill(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p in self.procs:
            p.join(timeout=10)

    def abort(self, reason: str) -> None:
        print(f"gsbench: {reason}: ending the run", file=sys.stderr, flush=True)
        self.kill()
        os._exit(1)

    def finish(self) -> None:
        """Wait for the ranks' clean exit (they have left the group)."""
        deadline = time.monotonic() + TIMEOUT_S
        for p in self.procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        self.watchdog.stop()
        codes = [p.exitcode for p in self.procs]
        if any(c != 0 for c in codes):
            self.kill()
            raise RuntimeError(f"ranks 1..{len(codes)} exited with codes {codes}")


def _die_with_parent() -> None:
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _rank(rank: int, addr: str, workload: str, config: dict, traffic: dict, seed: int,
          device_type: str) -> None:
    """A spawned rank's whole run."""
    _die_with_parent()
    started = harness.now()
    full_f32()
    n = config["parallel"]["ranks"]
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * n)))
    r = harness.Run(workload=workload, config=config, traffic=traffic, seed=seed, seconds=0.0,
                    trace=False, device=device, started=started)
    replica(r, rank, addr, lambda: None)


def join(r: harness.Run, rank: int, addr: str) -> None:
    from gsplat_tpu_torch.parallel import initialize_multihost

    initialize_multihost(addr, world(r), rank, backend(r), timeout=TIMEOUT_S)


def program_params(r: harness.Run, rank: int):
    """The program's parameters: on rank 0 the start state drawn from the
    seed, elsewhere zeros that ``broadcast_params`` fills."""
    from gsplat_tpu_torch.train.state import GaussianParams

    gp = GaussianParams(capacity(r.config["gaussians"]), device=r.device)
    if rank == 0:
        params, alive = start_state(r)
        with torch.no_grad():
            for k in PARAMS:
                getattr(gp, k).copy_(params[k])
            gp.alive.copy_(alive)
    return gp


def broadcast_params(gp) -> None:
    """Rank 0's parameters to every rank, bit for bit."""
    alive = gp.alive.to(torch.uint8)
    with torch.no_grad():
        for k in PARAMS:
            dist.broadcast(getattr(gp, k).detach(), 0)
        dist.broadcast(alive, 0)
        gp.alive.copy_(alive.bool())


def requirement(r: harness.Run, rank: int, gp, cam_t: list, rst) -> list:
    """The largest pair and row requirement of this rank's views, at exact
    sizing."""
    from gsplat_tpu_torch.train.step import render_image

    st = harness.program_statics(rst, 0, 0)
    pairs = rows = 0
    for v in own_views(r, rank):
        tables = render_image(gp, *cam_t[v], 0.0, st)[1]
        pairs, rows = max(pairs, int(tables.overflow)), max(rows, int(tables.row_overflow))
    return [pairs, rows]


def caps(r: harness.Run, need: list) -> tuple[int, int]:
    """``train_step.py``'s caps over every rank's views: the largest of the
    ranks' requirements plus a quarter, rounded as the trainer rounds them."""
    from gsplat_tpu_torch.train.state import round_pair_cap, round_row_cap

    most = torch.tensor(need, dtype=torch.int64, device=r.device)
    dist.all_reduce(most, op=dist.ReduceOp.MAX)
    pairs, rows = most.tolist()
    return round_pair_cap(pairs + (pairs >> 2), minimum=1 << 20), round_row_cap(rows + (rows >> 2))


def state_tensors(state) -> list:
    return ([getattr(state.params, k) for k in PARAMS] + [state.adam_m[k] for k in PARAMS]
            + [state.adam_v[k] for k in PARAMS] + [state.uv_grad_accum, state.accum_dur])


def replica_gap(state, rank: int) -> float:
    """The largest absolute difference of any state tensor between any rank
    and rank 0 (every rank gets it)."""
    gap = torch.zeros(1, dtype=torch.float64, device=state.params.xyz.device)
    for t in state_tensors(state):
        t = t.detach()
        lead = t.clone()
        dist.broadcast(lead, 0)
        gap = torch.maximum(gap, (t - lead).abs().amax().double().reshape(1))
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap)


def replica(r: harness.Run, rank: int, addr: str, beat) -> dict:
    """One rank's run: inputs, the group, the state, the caps, the first
    steps and the window. Returns rank 0's readings (its outcome's parts)."""
    from gsplat_tpu_torch.train.state import init_state
    from gsplat_tpu_torch.train.step import fresh_monitor, release_graphs
    from gsplat_tpu_torch.parallel import get_monitored_dp_train_step

    dev, tr = r.device, r.traffic
    lead = rank == 0
    cams, rst = cameras(r)
    gts = ground_truths(r, cams, rst, own_views(r, rank))
    r.phases.mark("inputs: the scene and this rank's ground truths")
    beat()
    harness.reset_peak(dev)
    given = r.config.get("caps")
    gp = program_params(r, rank)
    cam_t = [harness.cam_tensors(c, dev) for c in cams]
    # Rank 0 reads its views' requirement, and so builds the kernels, while
    # the other ranks start; they find the kernels built.
    need = requirement(r, rank, gp, cam_t, rst) if lead and not given else None
    r.phases.mark("rank 0's state and its views' requirement: the kernels' build")
    beat()
    join(r, rank, addr)
    r.phases.mark("the ranks' start and the communicator: joining the process group")
    beat()
    broadcast_params(gp)
    state = init_state(gp)
    if given:
        pair_cap, row_cap = given["pair_cap"], given["row_cap"]
    else:
        pair_cap, row_cap = caps(r, need or requirement(r, rank, gp, cam_t, rst))
    r.phases.mark("the state broadcast; the caps over every rank's views")
    beat()
    step = get_monitored_dp_train_step(harness.program_statics(rst, pair_cap, row_cap))
    monitor = fresh_monitor(dev)

    def one(k, monitor):
        it, v, bg = schedule(r, k, rank)
        beat()
        return step(state, *cam_t[v], gts[v], bg, it, monitor)

    losses, grad = [], None
    for k in range(tr["check_steps"]):
        state, m, monitor = one(k, monitor)
        losses.append(m.loss)
        if k == 0 and lead:
            grad = harness.leaf_norms(state.adam_m, 1.0 / (1.0 - ref.B1))
    got = None
    if lead:
        start, _ = start_state(r)
        change = harness.change_norms({k: getattr(state.params, k) for k in PARAMS}, start)
        del start
        got = dict(losses=[float(x) for x in losses], grad=grad, change=change)
    monitor = fresh_monitor(dev)
    harness.sync(dev)
    r.phases.mark("first steps: eager, capture, replay")
    beat()
    setup_s = harness.now() - r.started

    period = tr["monitor_interval"]
    k0 = k = tr["check_steps"]
    failed = 0
    go = torch.ones(1, dtype=torch.int32, device=dev)
    with trace.window(r.trace and lead) as prof:
        t0 = harness.now()
        while True:
            state, _, monitor = one(k, monitor)
            k += 1
            if (k - k0) % period == 0:
                mon = monitor.tolist()  # the interval's one host read
                monitor = fresh_monitor(dev)
                if mon[0] > pair_cap or mon[1] > row_cap or not mon[2] > 0.0:
                    failed += period
                if lead:
                    done = ((k - k0 >= tr["trace_units"]) if r.trace
                            else (harness.now() - t0 >= r.seconds))
                    go.fill_(0 if done else 1)
                dist.broadcast(go, 0)
                if not lead:
                    done = not go.item()
                if done:
                    break
        harness.sync(dev)
        window_s = harness.now() - t0
    units = k - k0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    gap = replica_gap(state, rank)
    del state, gp, step, monitor
    release_graphs()
    dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(got=got, gap=gap, setup_s=setup_s, window_s=window_s, units=units,
                failed=failed, peak=peak, prof=prof, k0=k0, gts=gts)


def program(r: harness.Run) -> tuple[harness.Outcome, dict]:
    """Rank 0's run with the other ranks; returns its outcome and its
    readings: ``got`` (its first steps), ``gap`` (``replica_gap``), ``k0``
    (the first window step) and ``gts`` (its views' ground truths)."""
    from gsplat_tpu_torch.parallel.launch import free_port

    addr = f"127.0.0.1:{free_port()}"
    ranks = Ranks(r, addr)
    r.phases.mark("the ranks' processes started")
    try:
        res = replica(r, 0, addr, ranks.beat)
        ranks.finish()
    finally:
        ranks.watchdog.stop()
        ranks.kill()
    out = harness.Outcome(kind="train", setup_s=res["setup_s"], window_s=res["window_s"],
                          units=res["units"], attempted=res["units"], failed=res["failed"],
                          numbers={}, memory_peak_bytes=res["peak"], phases=r.phases)
    out.ranks = world(r)  # read by the collective's roofline share
    if res["prof"]:
        out.traced = trace.reduce(res["prof"][0], "dp", res["units"])
    return out, res


def reference(r: harness.Run, gts: dict, low: bool = False, fault: str | None = None) -> dict:
    """The reference's readings of rank 0's first steps from the same start:
    each step the batch of every rank's view. ``fault`` "half": the loss
    over the top half of the image's rows."""
    cams, rst = cameras(r)
    params, alive = start_state(r)
    s = ref.State.fresh(params, alive)
    rows = slice(0, rst.height // 2) if fault == "half" else slice(None)
    losses, grad = [], None
    for k in range(r.traffic["check_steps"]):
        batch = [schedule(r, k, rank) for rank in range(world(r))]
        it, _, bg = batch[0]
        losses.append(ref_dp.batch_step(
            s, [harness.cam_tensors(cams[v], r.device) for _, v, _ in batch],
            [gts[v] for _, v, _ in batch], bg, it, rst, low=low, loss_rows=rows))
        if k == 0:
            grad = harness.leaf_norms(s.m, 1.0 / (1.0 - ref.B1))
    return dict(losses=losses, grad=grad, change=harness.change_norms(s.params, params))


def all_ground_truths(r: harness.Run, have: dict) -> dict:
    """Every view's ground truth: ``have``'s, and the reference's render of
    the others."""
    cams, rst = cameras(r)
    return {**ground_truths(r, cams, rst, set(range(r.traffic["views"])) - set(have)), **have}


def count_work(r: harness.Run, out: harness.Outcome, k0: int) -> None:
    """The traced window's modelled operations on rank 0: its views' steps
    at the start state."""
    cams, rst = cameras(r)
    params, alive = start_state(r)
    per_view, works = {}, []
    for k in range(k0, k0 + out.units):
        v = schedule(r, k, 0)[1]
        if v not in per_view:
            per_view[v] = ref.work(params, alive, *harness.cam_tensors(cams[v], r.device), rst)
        works.append(per_view[v])
    out.traced.flops = roofline.step_ops(works, True, r.config["gaussians"],
                                         rst.width * rst.height)


def measure(r: harness.Run) -> harness.Outcome:
    out, res = program(r)
    if out.traced is not None:
        count_work(r, out, res["k0"])
    base = reference(r, all_ground_truths(r, res["gts"]))
    out.numbers = dict(harness.training_numbers(res["got"], base), replica_gap=res["gap"])
    return out


def calibrate(r: harness.Run, modes: list) -> dict:
    """The compared numbers of each of ``modes`` ("program", "control",
    "half") against the reference, on this run's seed."""
    gts = all_ground_truths(r, {})
    base = reference(r, gts)
    res = {}
    for mode in modes:
        if mode == "program":
            got = program(r)[1]
            res[mode] = dict(harness.training_numbers(got["got"], base), replica_gap=got["gap"])
        else:
            got = reference(r, gts, low=mode == "control",
                            fault=None if mode == "control" else mode)
            res[mode] = harness.training_numbers(got, base)
    return res
