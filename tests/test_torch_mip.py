"""Mip-Splatting in the port (``ops/mip.py``, ``MipStepStatics``) against
the benchmark's plain reference (``gsbench/reference/mip.py``), on the
CPU at a small size.

The 3D filter's sweep and the filtered geometry against the reference on
seeded Gaussians and cameras, with Gaussians planted just inside and just
outside each screen margin, at the depth floor and where no camera sees
them; three Mip training steps against the reference's; the plain step
with the switch off, a ``filter_3d`` buffer or not, bit-equal to the plain
reference; the trainer's density step leaving the filter of a fresh sweep,
its sweep cadence by the tracer's counter, the opacity reset, and a PLY
round trip of ``filter_3D``; tp's refusal; the dp step under Mip's statics
on one gloo rank. Imports no JAX.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gsbench import harness, scene  # noqa: E402
from gsbench.reference import mip as ref_mip  # noqa: E402
from gsbench.reference import step as ref  # noqa: E402
from gsplat_tpu_torch.io.ply import load_ply, save_ply  # noqa: E402
from gsplat_tpu_torch.ops import mip  # noqa: E402
from gsplat_tpu_torch.train import state as t_state  # noqa: E402
from gsplat_tpu_torch.train import step as t_step  # noqa: E402
from gsplat_tpu_torch.utils import profiling  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
W, H, F = 80, 56, 68.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the file shares the host with the other test
    workers, and at these sizes more threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cams(n):
    return scene.cameras(scene.training_angles(n), W, H, F)


def _scene(n=1500, seed=7):
    """The benchmark's scene recipe at n Gaussians, as the reference's
    dicts and the port's parameters with a zero filter."""
    params, alive = scene.gaussians(n, seed, CPU)
    gp = t_state.GaussianParams(alive.shape[0], device="cpu")
    with torch.no_grad():
        for k in ref.PARAMS:
            getattr(gp, k).copy_(params[k])
        gp.alive.copy_(alive)
    return params, alive, t_state.with_filter_3d(gp)


def _statics(cam, mip_on=True):
    cfg = json.loads((REPO / "gsbench/configs/garden-ds4-1m-mip.json").read_text())
    rst = harness.ref_statics(cfg, cam, 3, 1.65)
    st = harness.program_statics(rst, 0, 0)
    return rst, t_step.mip_statics(st) if mip_on else st


def _planted(xyz, cam):
    """Rows of ``xyz`` moved to camera-space points of ``cam``: 0.01 px
    inside and outside each screen margin, at and past the depth floor."""
    view = torch.as_tensor(cam.view)
    r, t = view[:3, :3], view[:3, 3]
    cx, cy, z, e = W / 2.0, H / 2.0, 4.0, 0.01
    m = mip.MARGIN
    pix = [(-m * W + e, cy), (-m * W - e, cy), ((1 + m) * W - e, cy), ((1 + m) * W + e, cy),
           (cx, -m * H + e), (cx, -m * H - e), (cx, (1 + m) * H - e), (cx, (1 + m) * H + e)]
    pts = [((u - cx) / F * z, (v - cy) / F * z, z) for u, v in pix]
    pts += [(0.0, 0.0, mip.DEPTH_FLOOR - 1e-4), (0.0, 0.0, mip.DEPTH_FLOOR + 1e-3)]
    cam_pts = torch.tensor(pts, dtype=torch.float32)
    with torch.no_grad():
        xyz[:len(pts)] = (cam_pts - t) @ r
    return len(pts)


def test_sweep_and_filtered_geometry_match_the_reference():
    params, alive, gp = _scene()
    one = _cams(8)[:1]
    k = _planted(gp.xyz, one[0])
    with torch.no_grad():
        gp.xyz[k] = torch.tensor([0.0, 0.0, -60.0])  # behind the camera: no camera sees it
    params["xyz"] = gp.xyz.detach().clone()
    mip.update_filter_3d_(gp, mip.camera_table(one, CPU))
    want = ref_mip.filter_3d(params["xyz"], alive, one)
    torch.testing.assert_close(gp.filter_3d, want, rtol=1e-6, atol=0.0)
    assert ref_mip.filter_gap(gp.filter_3d, want, alive) == 0.0
    depth = gp.filter_3d / math.sqrt(mip.FILTER_VARIANCE) * F
    far = float(depth[alive].max())
    seen = depth[:k] < far - 1e-3  # the planted rows: inside, outside, inside, ...
    assert seen.tolist() == [True, False] * 4 + [False, True]
    assert float(depth[k]) == pytest.approx(far)  # unseen: the largest depth seen
    assert float(gp.filter_3d[~alive].abs().max()) == 0.0

    gp.filter_3d.copy_(want)
    cam = _cams(8)[1]
    cam_t = harness.cam_tensors(cam, CPU)
    rst, st = _statics(cam)
    uv, conic, rgb, mask, radius, z, scale = t_step._geometry(gp, *cam_t, st)
    r_uv, r_conic, _, r_mask, r_radius, _, r_scale = ref_mip.per_gaussian(
        params, alive, want, *cam_t, rst)
    assert torch.equal(mask, r_mask)
    torch.testing.assert_close(conic[mask], r_conic[mask], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(scale[mask], r_scale[mask], rtol=1e-5, atol=1e-7)
    assert float((scale[mask] < 1.0).double().mean()) > 0.9  # the filters dim opacity
    assert (radius[mask][:, :2] - r_radius[mask][:, :2]).abs().max() <= 1.0


def test_three_mip_steps_match_the_reference():
    params, alive, gp = _scene()
    cams = _cams(8)
    table_cams = _cams(40)
    mip.update_filter_3d_(gp, mip.camera_table(table_cams, CPU))
    filt = ref_mip.filter_3d(params["xyz"], alive, table_cams)
    rst, st = _statics(cams[0])
    gts = [ref.render(params, alive, *harness.cam_tensors(c, CPU), 0.0, rst) * 0.9
           for c in cams[:3]]
    state, s = t_state.init_state(gp), ref.State.fresh(params, alive)
    for k in range(3):
        cam_t = harness.cam_tensors(cams[k], CPU)
        want = ref_mip.train_step(s, filt, *cam_t, gts[k], 0.25, 3001 + k, rst)
        state, m = t_step.train_step(state, *cam_t, gts[k], 0.25, 3001 + k, st)
        assert float(m.loss) == pytest.approx(want, rel=1e-5)
        if k == 0:
            for name in ref.PARAMS:
                got = float(torch.linalg.vector_norm(state.adam_m[name]))
                assert got == pytest.approx(float(torch.linalg.vector_norm(s.m[name])),
                                            rel=1e-4, abs=1e-12), name
    for name in ref.PARAMS:
        torch.testing.assert_close(getattr(state.params, name).detach(), s.params[name],
                                   rtol=1e-4, atol=1e-6)


def test_switch_off_is_the_plain_step():
    params, alive, gp = _scene(800)
    mip.update_filter_3d_(gp, mip.camera_table(_cams(8), CPU))
    cam = _cams(8)[2]
    cam_t = harness.cam_tensors(cam, CPU)
    rst, st = _statics(cam, mip_on=False)
    assert torch.equal(t_step.render_image(gp, *cam_t, 0.3, st)[0],
                       ref.render(params, alive, *cam_t, 0.3, rst))
    bare = t_state.params_from_jax({k: v.numpy() for k, v in params.items()}, alive.numpy(),
                                   "cpu")
    gt = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(3))
    outs = []
    for p in (gp, bare):
        state = t_state.init_state(p)
        for it in (3001, 3002):
            state, m = t_step.train_step(state, *cam_t, gt, 0.5, it, st)
        outs.append((m, t_state.state_to_numpy(state)))
    (m_a, s_a), (m_b, s_b) = outs
    assert torch.equal(m_a.loss, m_b.loss) and torch.equal(m_a.psnr, m_b.psnr)
    for group in ("params", "adam_m", "adam_v"):
        for name in s_b[group]:
            np.testing.assert_array_equal(s_a[group][name], s_b[group][name])
    with pytest.raises(ValueError, match="filter_3d"):
        t_step.render_image(bare, *cam_t, 0.3, t_step.mip_statics(st))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from gsplat_tpu_torch.tools.synthetic import write_synthetic_dataset

    root = tmp_path_factory.mktemp("mip_dataset")
    write_synthetic_dataset(root, name="scene", n_views=3, width=48, height=32,
                            n_gaussians=60, n_points=80, device="cpu")
    return root


def _config(tmp_path, **over) -> Path:
    """configs/base.yaml with the tests' schedule, Mip-Splatting on, and
    ``over``'s keys, as flat YAML."""
    keys = dict(dataset_path="scene", output_dir=str(tmp_path / "out"), downsample_factor=1,
                print_interval=10**9, test_eval_interval=10**9, num_iters=13,
                adaptive_control_start=1, adaptive_control_interval=3, adaptive_control_end=7,
                reset_opacity_start=10**9, reset_opacity_end=10**9, uv_grad_threshold=1e-7,
                strict_reference="false", use_background="false", mip_splatting="true")
    keys.update(over)
    lines = [line for line in (REPO / "configs" / "base.yaml").read_text().splitlines()
             if line.split(":")[0] not in keys]
    path = tmp_path / "c.yaml"
    path.write_text("\n".join(lines + [f"{k}: {v}" for k, v in keys.items()]) + "\n")
    return path


def _trainer(dataset, tmp_path, **over):
    from gsplat_tpu_torch import config as t_config
    from gsplat_tpu_torch.io import colmap
    from gsplat_tpu_torch.train.init import initialize_gaussians
    from gsplat_tpu_torch.train.trainer import Trainer

    path = _config(tmp_path, **over)
    cfg = t_config.parse_config(path)
    assert t_config.parse_mip(path)
    sparse = dataset / "scene" / "sparse" / "0"
    cams = colmap.read_cameras_binary(sparse / "cameras.bin", 1)
    imgs = colmap.read_images_binary(sparse / "images.bin", str(dataset / "scene") + "/", 1)
    pts = colmap.read_points3d_binary(sparse / "points3D.bin")
    xyz = np.stack([p.xyz for p in pts.values()])
    rgb = np.stack([p.rgb for p in pts.values()])
    return Trainer(cfg, initialize_gaussians(xyz, rgb, cfg), imgs, cams, device="cpu", mip=True)


def _fresh_sweep(tr):
    p = tr.state.params
    copy = t_state.with_filter_3d(t_state.GaussianParams(p.capacity, device="cpu"))
    with torch.no_grad():
        copy.xyz.copy_(p.xyz)
        copy.alive.copy_(p.alive)
    mip.update_filter_3d_(copy, tr._sweep_table)
    return copy.filter_3d


def test_density_step_leaves_a_fresh_filter_and_the_ply_carries_it(dataset, tmp_path):
    tr = _trainer(dataset, tmp_path)
    tr.sweep_filter_3d()
    n0 = t_state.num_active(tr.state)
    with torch.no_grad():  # every Gaussian past the gradient threshold: clones and splits
        tr.state.uv_grad_accum.copy_(tr.state.alive.float())
        tr.state.accum_dur.copy_(tr.state.alive.int())
    info = tr._density_step()
    assert info.applied and t_state.num_active(tr.state) > n0
    assert torch.equal(tr.state.params.filter_3d, _fresh_sweep(tr))
    tr.save_to_ply(tmp_path / "m.ply")
    data = load_ply(tmp_path / "m.ply")
    alive = tr.state.alive
    np.testing.assert_array_equal(data["filter_3d"], tr.state.params.filter_3d[alive].numpy())
    np.testing.assert_array_equal(data["opacity"], tr.state.params.opacity[alive].detach())
    save_ply(tmp_path / "p.ply", data["xyz"], data["rgb"], data["opacity"], data["scale"],
             data["quaternion"], data["sh"])
    assert load_ply(tmp_path / "p.ply")["filter_3d"] is None


def test_opacity_reset_holds_the_filtered_opacity(dataset, tmp_path):
    from gsplat_tpu_torch.train.density import reset_opacity

    tr = _trainer(dataset, tmp_path)
    tr.sweep_filter_3d()
    p, alive = tr.state.params, tr.state.alive
    coef = mip.opacity_scale_3d(p.scale, p.filter_3d).detach()
    before = (torch.sigmoid(p.opacity) * coef).detach()
    reset_opacity(tr.state, 0.01)
    after = (torch.sigmoid(p.opacity) * coef).detach()
    torch.testing.assert_close(after[alive], torch.clamp(before[alive], max=0.01),
                               rtol=1e-5, atol=1e-9)


def test_trainer_sweep_cadence(dataset, tmp_path, monkeypatch):
    # Sweeps: one when train starts, one at the density step (iteration
    # 2), then every FILTER_INTERVAL (2) past densification's end (3) but
    # for the run's last interval: iteration 4 (6 is past num_iters 7 - 2).
    monkeypatch.setattr(mip, "FILTER_INTERVAL", 2)
    tr = _trainer(dataset, tmp_path, num_iters=7, adaptive_control_interval=2,
                  adaptive_control_end=3)
    before = profiling.counter("mip.filter3d_sweeps")
    tr.train(verbose=False)
    assert profiling.counter("mip.filter3d_sweeps") - before == 3


def test_tile_parallel_refuses_mip():
    from gsplat_tpu_torch.train.trainer import Trainer

    with pytest.raises(ValueError, match="Mip-Splatting"):
        Trainer(None, None, {}, {}, device="cpu", tp=2, mip=True)


def test_cli_flag_trains_mip_and_writes_the_filter(dataset, tmp_path):
    from gsplat_tpu_torch import cli

    path = _config(tmp_path, mip_splatting="false")
    assert cli.main([str(path), str(dataset), "--mip", "--max-iters", "2"], device="cpu") == 0
    data = load_ply(tmp_path / "out" / "trained.ply")
    assert data["filter_3d"] is not None and (data["filter_3d"] > 0).all()


def test_dp_step_runs_mip_on_one_gloo_rank():
    """The dp step under Mip-Splatting's statics, one gloo rank: the single
    step's loss and update (a batch of one camera)."""
    import socket

    import torch.distributed as dist

    from gsplat_tpu_torch.parallel import dp_train_step

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        params, alive, _ = _scene(600)
        cam = _cams(8)[3]
        cam_t = harness.cam_tensors(cam, CPU)
        _, st = _statics(cam)
        table = mip.camera_table(_cams(8), CPU)
        gt = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(5))
        outs = []
        for step in (t_step.train_step, dp_train_step):
            gp = t_state.with_filter_3d(t_state.params_from_jax(
                {k: v.numpy() for k, v in params.items()}, alive.numpy(), "cpu"))
            mip.update_filter_3d_(gp, table)
            state, m = step(t_state.init_state(gp), *cam_t, gt, 0.5, 3001, st)
            outs.append((float(m.loss), state.params.opacity.detach().clone()))
        assert outs[0][0] == outs[1][0]
        torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-6, atol=1e-7)
    finally:
        dist.destroy_process_group()
