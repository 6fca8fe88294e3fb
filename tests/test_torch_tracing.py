"""The port's tracer (``utils/profiling.py``): spans, counters and the stage
clock, on the CPU; and the benchmark's readers of them (``gsbench``'s
``program_spans`` metrics).

A span records nothing and opens no ``record_function`` while no
profiler records; inside a CPU torch.profiler session it lands in the
profiler's own events within 1 ms of its in-memory start and end, with its
parent and thread. The plain stage clock (``time.time_ns()`` into a CPU
ring) gives a train step eight stages and a render four, all >= 0, summing
to the call's host wall time within 5 %, and changes no output bit; so
does the tp step's on a one-rank gloo group, every stage stamped. A tiny
``Trainer.train`` under a profiler records every span of the trainer, its
loader and its step, each under ``trainer.train``. This file imports no
JAX module of its own.
"""

import json
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gsplat_tpu_torch.ops.camera import build_camera_matrices  # noqa: E402
from gsplat_tpu_torch.train import state as t_state  # noqa: E402
from gsplat_tpu_torch.train import step as t_step  # noqa: E402
from gsplat_tpu_torch.utils import profiling  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clear():
    profiling.clear()
    yield
    profiling.clear()


def _tracing():
    return torch.autograd.profiler._is_profiler_enabled


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _events(prof, name):
    return [e for e in prof.profiler.kineto_results.events() if e.name() == name]


# ------------------------------------------------------------------ spans


def test_span_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling._profiler, "record_function",
                        lambda name: entered.append(name))
    assert not _tracing()
    with profiling.span("off.a") as a, profiling.span("off.b", slot=3) as b:
        pass
    assert a is b  # one shared no-op object
    assert profiling.spans() == [] and entered == []
    assert profiling.current_span() is None


def test_span_lands_in_the_profilers_events():
    with _profiled() as prof:
        assert _tracing()
        with profiling.span("trace.outer"):
            time.sleep(0.003)
            with profiling.span("trace.inner"):
                time.sleep(0.002)
    assert not _tracing()
    got = {s.name: s for s in profiling.spans()}
    for name in ("trace.outer", "trace.inner"):
        (e,) = _events(prof, name)
        s = got[name]
        assert abs(e.start_ns() - s.start_ns) < 1_000_000
        assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 1_000_000
    assert got["trace.inner"].parent == got["trace.outer"].id
    assert got["trace.outer"].parent is None
    assert got["trace.outer"].end_ns - got["trace.outer"].start_ns >= 5_000_000


def test_parent_and_thread_with_a_second_thread():
    with _profiled():
        with profiling.span("main.root") as root:
            given = root.id

            def worker():
                with profiling.span("worker.own"):
                    pass
                with profiling.span("worker.caused", parent=given):
                    pass

            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    got = {s.name: s for s in profiling.spans()}
    main = threading.get_ident()
    assert got["main.root"].thread == main and got["main.root"].parent is None
    assert got["worker.own"].thread != main and got["worker.own"].parent is None
    assert got["worker.caused"].thread == got["worker.own"].thread
    assert got["worker.caused"].parent == got["main.root"].id


def test_counters_total_always_traced_only_while_on():
    before = profiling.counter("test.count")
    profiling.count("test.count")
    with _profiled():
        profiling.count("test.count", 2)
    assert profiling.counter("test.count") == before + 3
    assert profiling.counters() == {"test.count": 2}
    profiling.clear()
    assert profiling.counters() == {} and profiling.counter("test.count") == before + 3


def test_stage_timers_stage_is_a_span():
    timers = profiling.StageTimers()
    with _profiled():
        with timers.stage("tool.stage"):
            pass
    assert [s.name for s in profiling.spans()] == ["tool.stage"]
    assert timers.counts["tool.stage"] == 1


def test_device_traces_chrome_trace_holds_the_spans(tmp_path):
    with profiling.device_trace(tmp_path) as prof:
        with profiling.span("chrome.outer"):
            with profiling.span("chrome.inner"):
                pass
    events = json.loads(Path(prof.trace_path).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"chrome.outer", "chrome.inner"} <= names
    assert [s.name for s in profiling.spans()] == ["chrome.inner", "chrome.outer"]


# ------------------------------------------------------------ stage clock


def _scene(n=600, w=64, h=40):
    rng = np.random.default_rng(3)
    params = dict(
        xyz=rng.normal(size=(n, 3)) * [1.0, 0.7, 0.6] + [0, 0, 4.0],
        rgb=rng.normal(size=(n, 3)), opacity=rng.uniform(-1.0, 2.0, n),
        scale=np.log(rng.uniform(0.03, 0.12, (n, 3))),
        quat=np.concatenate([np.ones((n, 1)), 0.3 * rng.normal(size=(n, 3))], axis=1),
        sh=0.1 * rng.normal(size=(n, 15, 3)),
    )
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    cam = build_camera_matrices(np.array([1.0, 0, 0, 0]), np.zeros(3), w, h, w * 0.85,
                                w * 0.85)
    st = t_step.StepStatics(
        width=w, height=h, tile=16, l_max=3, focal_x=cam.focal_x, focal_y=cam.focal_y,
        tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, near_thresh=0.3, mh_dist=3.0,
        cull_padding=100, ssim_frac=0.2, base_lr=1e-3, xyz_lr_init=0.16,
        xyz_lr_final=0.0016, quat_lr=1.0, scale_lr=5.0, opacity_lr=25.0, rgb_lr=2.5,
        sh_lr=0.125, scene_extent=4.0, num_iters=7000,
    )
    cam_t = tuple(torch.as_tensor(x, dtype=torch.float32) for x in (cam.view, cam.proj,
                                                                     cam.campos))
    gt = torch.from_numpy(rng.uniform(0, 1, (h, w, 3)).astype(np.float32))
    return params, np.ones(n, bool), cam_t, st, gt


def _state(params, alive):
    return t_state.init_state(t_state.params_from_jax(params, alive, "cpu"))


@pytest.mark.parametrize("kind", ["step", "render"])
def test_plain_stage_clock_sums_to_the_calls_wall_time(kind):
    params, alive, cam_t, st, gt = _scene()
    state = _state(params, alive)
    cpu = torch.device("cpu")

    def call(it):
        if kind == "step":
            t_step.train_step(state, *cam_t, gt, 0.2, it, st)
        else:
            t_step.render_image(state.params, *cam_t, 0.2, st)

    call(0)  # warm
    profiling.clear()
    walls = []
    for it in range(1, 4):
        t0 = time.perf_counter_ns()
        call(it)
        walls.append((time.perf_counter_ns() - t0) / 1e6)
    got = profiling.stage_times(kind, cpu)
    assert sorted(got) == [1, 2, 3]
    for wall, stages in zip(walls, (got[s] for s in sorted(got))):
        assert tuple(stages) == profiling.STAGES[kind]
        assert len(stages) == (8 if kind == "step" else 4)
        assert all(ms >= 0 for ms in stages.values()), stages
        assert sum(stages.values()) == pytest.approx(wall, rel=0.05)


def test_stage_clock_changes_no_output(monkeypatch):
    params, alive, cam_t, st, gt = _scene(n=300)

    def run():
        state = _state(params, alive)
        monitor = t_step.fresh_monitor("cpu")
        out = []
        for it in range(3):
            state, m, monitor = t_step.monitored_train_step(
                state, *cam_t, gt, 0.1 * it, it, monitor, st)
            out.append(torch.stack([m.loss, m.psnr, m.num_visible.float()]))
        img = t_step.render_image(state.params, *cam_t, 0.3, st)[0]
        return torch.stack(out), monitor, img, t_state.state_to_numpy(state)

    stamped = run()
    with _profiled():
        traced = run()
    monkeypatch.setattr(profiling, "stage_clock", lambda kind, device: profiling._NOOP)
    monkeypatch.setattr(profiling, "stage_done", lambda stage: None)
    plain = run()
    for got in (stamped, traced):
        for a, b in zip(got[:3], plain[:3]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        for group in ("params", "adam_m", "adam_v"):
            for name in plain[3][group]:
                np.testing.assert_array_equal(got[3][group][name], plain[3][group][name])


def test_issue_spans_carry_their_calls_slots():
    params, alive, cam_t, st, gt = _scene(n=300)
    state = _state(params, alive)
    step = t_step.get_monitored_train_step(st)
    render = t_step.get_render_fn(st)
    monitor = t_step.fresh_monitor("cpu")
    with _profiled():
        for it in range(3):
            state, _, monitor = step(state, *cam_t, gt, 0.0, it, monitor)
            render(state.params, *cam_t, 0.0)
    for kind in ("step", "render"):
        slots = [s.slot for s in profiling.spans() if s.name == f"{kind}.issue"]
        times = profiling.stage_times(kind)
        assert len(slots) == 3 and slots == sorted(times)[-3:]
        assert slots == list(range(slots[0], slots[0] + 3))
    t_step.release_graphs()


def test_dp_step_stamps_its_own_clock_and_counts_its_reduced_bytes(monkeypatch):
    from gsplat_tpu_torch import parallel
    from gsplat_tpu_torch.parallel import comm
    from gsplat_tpu_torch.parallel.launch import free_port

    params, alive, cam_t, st, gt = _scene(n=300)
    st = t_step.StepStatics(**{**st.__dict__, "pair_cap": 1 << 16, "row_cap": 1 << 14})
    reduced = []
    real_reduce = comm.all_reduce_sum_

    def spy(t, group=None):
        reduced.append(t.numel() * t.element_size())
        return real_reduce(t, group)

    monkeypatch.setattr(comm, "all_reduce_sum_", spy)
    parallel.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="gloo")
    try:
        state = _state(params, alive)
        dp = parallel.get_monitored_dp_train_step(st)
        monitor = t_step.fresh_monitor("cpu")
        dp(state, *cam_t, gt, 0.0, 0, monitor)  # an untraced call: counted in the total only
        before = profiling.counter("comm.reduced_bytes")
        steps_before = profiling.stage_times("step", "cpu")
        reduced.clear()
        walls = []
        with _profiled():
            for it in range(1, 4):
                t0 = time.perf_counter_ns()
                state, _, monitor = dp(state, *cam_t, gt, 0.0, it, monitor)
                walls.append((time.perf_counter_ns() - t0) / 1e6)
        got = profiling.stage_times("dp", "cpu")
        slots = [s.slot for s in profiling.spans() if s.name == "dp.issue"]
        assert len(slots) == 3 and slots == sorted(got)[-3:]
        assert not [s for s in profiling.spans() if s.name == "step.issue"]
        for wall, slot in zip(walls, slots):
            stages = got[slot]
            assert tuple(stages) == profiling.STAGES["dp"] and len(stages) == 9
            assert list(stages)[7:] == ["allreduce", "adam"]
            assert all(ms >= 0 for ms in stages.values()), stages
            assert sum(stages.values()) == pytest.approx(wall, rel=0.05)
        # once a call, the bytes of the float and the int32 buffer it reduces
        assert len(reduced) == 6 and sum(reduced) == 3 * (reduced[0] + reduced[1])
        assert profiling.counters() == {"comm.reduced_bytes": sum(reduced)}
        assert profiling.counter("comm.reduced_bytes") - before == sum(reduced)
        assert reduced[0] + reduced[1] == parallel.data_parallel.reduced_bytes(
            state.params.capacity)
        # the single-camera step's clock is left as it was
        assert profiling.stage_times("step", "cpu") == steps_before
    finally:
        t_step.release_graphs()
        torch.distributed.destroy_process_group()


def test_tp_step_stamps_every_stage_of_the_step_clock():
    from gsplat_tpu_torch import parallel
    from gsplat_tpu_torch.parallel.launch import free_port

    params, alive, cam_t, st, gt = _scene(n=300)
    st = t_step.StepStatics(**{**st.__dict__, "pair_cap": 1 << 16, "row_cap": 1 << 14})
    parallel.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="gloo")
    try:
        state = _state(params, alive)
        tp = parallel.get_monitored_tp_train_step(st)
        monitor = t_step.fresh_monitor("cpu")
        tp(state, *cam_t, gt, 0.0, 0, monitor)  # warm
        profiling.clear()
        walls = []
        for it in range(1, 4):
            t0 = time.perf_counter_ns()
            state, _, monitor = tp(state, *cam_t, gt, 0.0, it, monitor)
            walls.append((time.perf_counter_ns() - t0) / 1e6)
        got = profiling.stage_times("step", "cpu")
        assert len(got) == 3
        for wall, stages in zip(walls, (got[s] for s in sorted(got))):
            assert tuple(stages) == profiling.STAGES["step"]
            assert all(ms >= 0 for ms in stages.values()), stages
            assert sum(stages.values()) == pytest.approx(wall, rel=0.05)
    finally:
        t_step.release_graphs()
        torch.distributed.destroy_process_group()


# --------------------------------------------------------------- trainer


TRAINER_SPANS = ("trainer.train", "loader.wait", "loader.close", "loader.decode",
                 "trainer.step", "trainer.monitor_read", "trainer.dump", "trainer.eval",
                 "trainer.density", "step.issue", "render.issue")


def test_trainer_spans_under_a_profiler(tmp_path):
    from gsplat_tpu_torch import config as t_config
    from gsplat_tpu_torch.io import colmap
    from gsplat_tpu_torch.tools.synthetic import write_synthetic_dataset
    from gsplat_tpu_torch.train import init as t_init
    from gsplat_tpu_torch.train import trainer as t_trainer

    write_synthetic_dataset(tmp_path, name="scene", n_views=3, width=48, height=32,
                            n_gaussians=60, n_points=80, device="cpu")
    over = dict(dataset_path="scene", downsample_factor=1, num_iters=5, print_interval=3,
                test_eval_interval=3, test_split_ratio=2, adaptive_control_start=1,
                adaptive_control_interval=3, adaptive_control_end=10,
                reset_opacity_start=10**9, reset_opacity_end=10**9, max_gaussians=5000,
                use_background="false", strict_reference="false",
                output_dir=str(tmp_path / "out"))
    lines = [line for line in (REPO / "configs" / "base.yaml").read_text().splitlines()
             if line.split(":")[0] not in over]
    cfg_path = tmp_path / "c.yaml"
    cfg_path.write_text("\n".join(lines + [f"{k}: {v}" for k, v in over.items()]) + "\n")
    cfg = t_config.parse_config(cfg_path)
    sparse = tmp_path / "scene" / "sparse" / "0"
    cams = colmap.read_cameras_binary(sparse / "cameras.bin", 1)
    imgs = colmap.read_images_binary(sparse / "images.bin", str(tmp_path / "scene") + "/", 1)
    pts = colmap.read_points3d_binary(sparse / "points3D.bin")
    xyz = np.stack([p.xyz for p in pts.values()])
    rgb = np.stack([p.rgb for p in pts.values()])
    tr = t_trainer.Trainer(cfg, t_init.initialize_gaussians(xyz, rgb, cfg), imgs, cams,
                           device="cpu")
    with _profiled() as prof:
        tr.train(verbose=False)
    t_step.release_graphs()
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.name == "trainer.train"]

    def under_root(s):
        while s.parent is not None:
            s = by_id[s.parent]
        return s is root

    names = {s.name for s in spans}
    assert set(TRAINER_SPANS) <= names, set(TRAINER_SPANS) - names
    assert all(under_root(s) for s in spans if s.name in TRAINER_SPANS)
    direct = {s.name for s in spans if s.parent == root.id}
    assert {"loader.wait", "loader.close", "loader.decode", "trainer.step",
            "trainer.monitor_read", "trainer.dump", "trainer.eval",
            "trainer.density"} <= direct
    assert sum(s.name == "trainer.step" for s in spans) == 5
    assert {s.thread for s in spans if s.name == "loader.decode"} != {root.thread}
    # The profiler records the spans of its own thread; the tracer every thread's.
    assert _events(prof, "trainer.train") and _events(prof, "loader.wait")


# ---------------------------------------------------------------- readers


BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
READERS = [m for m in BENCH["per_layer"] if m["source"] in ("program_span", "program_counter")]
KIND = {"trainer": "trainer", "train": "train", "render": "render", "dp": "dp", "mip": "train"}
DUR_MS = {"loader.wait": [2.0, 3.0], "loader.decode": [10.0, 20.0, 30.0],
          "trainer.step": [1.5, 0.5], "trainer.monitor_read": [4.0],
          "trainer.dump": [100.0], "trainer.density": [40.0, 8.0],
          "step.issue": [0.25, 0.5, 0.75], "render.issue": [0.5, 0.5],
          "dp.issue": [0.5, 0.5, 0.5], "mip.filter3d": [0.3, 0.3]}
SLOTS = {"step.issue": [5, 6, 7], "render.issue": [2, 3], "dp.issue": [5, 6, 7],
         "mip.filter3d": [1, 2]}
UNITS = 4
RANKS, REDUCED = 4, 4 * 264_241_232  # the window's comm.reduced_bytes: UNITS calls


def _store():
    spans, t = [], 0
    for name, durs in DUR_MS.items():
        for j, ms in enumerate(durs):
            slot = SLOTS[name][j] if name in SLOTS else None
            spans.append(profiling.Span(len(spans), name, t, t + int(ms * 1e6), None, 1, slot))
            t += 10**9
    # slot 4 is outside the window: its stage times must not count
    times = {kind: {s: {st: float(s - 4 + i) for i, st in enumerate(profiling.STAGES[kind])}
                    for s in (4, 5, 6, 7)} for kind in ("step", "dp")}
    times["render"] = {s: {st: float(2 * s + i) for i, st in
                           enumerate(profiling.STAGES["render"])} for s in (1, 2, 3)}
    times["mip"] = {s: {"filter3d": 0.25 * s} for s in (0, 1, 2)}  # the sweeps: slots 1, 2
    counts = {"step.eager": 1, "step.captures": 2, "loader.hits": 3, "loader.misses": 1,
              "other": 7, "comm.reduced_bytes": REDUCED}
    return SimpleNamespace(spans=lambda: spans, counters=lambda: dict(counts),
                           stage_times=lambda kind: times[kind])


def _expected(name):
    metric, kind = name.rsplit(".", 1)
    if metric == "decode_ms":
        return 20.0
    if metric == "graph_builds":
        return 3
    if metric == "loader_hit_pct":
        return 75.0
    if metric == "filter3d_ms":  # the median of the window's two sweeps' stage
        return (0.25 + 0.5) / 2
    span = {"loader_wait_ms": "loader.wait", "step_issue_ms": "trainer.step",
            "monitor_read_ms": "trainer.monitor_read", "dump_ms": "trainer.dump",
            "density_ms": "trainer.density"}.get(metric)
    if metric == "host_issue_ms":
        span = f"{'step' if kind == 'train' else 'render'}.issue"
    if span is not None:
        return sum(DUR_MS[span]) / UNITS
    if metric == "allreduce_link_pct":  # the stage's median: 2 + its index, in ms
        ms = 2.0 + profiling.STAGES["dp"].index("allreduce")
        return 100.0 * (RANKS - 1) / RANKS * REDUCED / UNITS / 450e9 / (ms / 1e3)
    stage = metric[: -len("_ms")]
    if kind in ("train", "dp"):  # slots 5, 6, 7: stage i reads slot - 4 + i
        i = profiling.STAGES["step" if kind == "train" else "dp"].index(stage)
        return float(2 + i)
    i = profiling.STAGES["render"].index(stage)  # slots 2, 3: 2 s + i
    return float((4 + i + 6 + i) / 2)


def _out(kind, busy_s=1.0):
    traced = SimpleNamespace(kind=kind, units=UNITS, busy_s=busy_s, window_s=2.0)
    return SimpleNamespace(traced=traced, ranks=RANKS)


@pytest.mark.parametrize("name", [m["name"] for m in READERS])
def test_reader_reads_a_store_it_is_given(monkeypatch, name):
    from gsbench import cell as cells
    from gsbench import program_spans

    monkeypatch.setattr(program_spans, "store", _store)
    reader = cells.reader(name)
    kind = KIND[name.rsplit(".", 1)[1]]
    assert reader.read(_out(kind)) == pytest.approx(_expected(name))
    other = next(k for k in KIND.values() if k != kind)
    assert reader.read(_out(other)) is None


@pytest.mark.parametrize("name", [m["name"] for m in READERS])
def test_reader_returns_none_without_a_trace(monkeypatch, name):
    from gsbench import cell as cells
    from gsbench import program_spans

    reader = cells.reader(name)
    assert reader.read(SimpleNamespace(traced=None)) is None
    monkeypatch.setattr(program_spans, "store", lambda: None)  # a program without a tracer
    assert reader.read(_out(KIND[name.rsplit(".", 1)[1]])) is None
