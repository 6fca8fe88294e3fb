"""The port's data-parallel step against the benchmark's plain reference of
the batch step (``gsbench/reference/dp.py``), on the CPU.

- ``get_monitored_dp_train_step`` on 4 gloo ranks (``parallel.launch.spawn``)
  at the pair and row caps, 3 steps of 4 views a step from 8 on a circle,
  on a seeded 3,000-Gaussian scene at 64x48, against ``batch_step`` from
  the same start: the losses, the parameters, both Adam moments and both
  densification accumulators within the tolerances below, and the four
  replicas bit-equal. The tolerances are those of a sum in another order:
  the ranks' gradients are summed in gloo's order, the reference's in
  camera order, and everything else is the same float32 arithmetic.
- With four identical cameras the batch reference is one camera's
  reference step, its ``dur`` and ``uv_accum`` four times the step's.

This file imports no JAX module: each spawned rank imports it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gsbench import harness, scene  # noqa: E402
from gsbench.reference import dp as ref_dp  # noqa: E402
from gsbench.reference import step as ref  # noqa: E402
from gsbench.reference.gaussians import PARAMS  # noqa: E402
from gsplat_tpu_torch.parallel.launch import spawn  # noqa: E402
from gsplat_tpu_torch.train import state as t_state  # noqa: E402

CPU = torch.device("cpu")
N, W, H, VIEWS, RANKS, STEPS, SEED = 3000, 64, 48, 8, 4, 3, 2**31 + 11
PAIR_CAP, ROW_CAP = 1 << 17, 1 << 15
# A cull padding of 8 pixels: some Gaussians are seen by one camera of a
# batch alone, so the union of the masks differs from their intersection.
CONFIG = dict(train=dict(use_background=True, tile_size=16, near_thresh=0.3, mh_dist=3.0,
                         cull_mask_padding=8, ssim_frac=0.2, base_lr=0.001,
                         xyz_lr_multiplier_init=0.16, xyz_lr_multiplier_final=0.0016,
                         quat_lr_multiplier=1.0, scale_lr_multiplier=5.0,
                         opacity_lr_multiplier=25, rgb_lr_multiplier=2.5,
                         sh_lr_multiplier=0.125, num_iters=7000))
# (rtol, atol) of each compared state tensor against the reference
TOL = dict(params=(1e-5, 1e-7), adam_m=(1e-4, 1e-9), adam_v=(1e-4, 1e-13),
           uv_grad_accum=(1e-5, 1e-9))


def _setup():
    cams = scene.cameras(scene.training_angles(VIEWS), W, H, 0.85 * W)
    rst = harness.ref_statics(CONFIG, cams[0], 3, scene.scene_extent(cams))
    truth, alive = scene.gaussians(N, SEED, CPU)
    gts = [ref.render(truth, alive, *harness.cam_tensors(c, CPU), 0.0, rst) for c in cams]
    start, alive = scene.gaussians(N, SEED, CPU, perturb=True)
    return cams, rst, gts, start, alive


def _schedule(k, rank):
    it = 3001 + k
    return it, (RANKS * k + rank) % VIEWS, harness.background(CONFIG, it)


def _rank(rank, cams, rst, gts, start, alive):
    from gsplat_tpu_torch.parallel import get_monitored_dp_train_step
    from gsplat_tpu_torch.train.step import fresh_monitor

    torch.set_num_threads(1)
    gp = t_state.GaussianParams(alive.shape[0], device="cpu")
    with torch.no_grad():
        for k in PARAMS:
            getattr(gp, k).copy_(start[k])
        gp.alive.copy_(alive)
    state = t_state.init_state(gp)
    step = get_monitored_dp_train_step(harness.program_statics(rst, PAIR_CAP, ROW_CAP))
    monitor, losses = fresh_monitor("cpu"), []
    for k in range(STEPS):
        it, v, bg = _schedule(k, rank)
        state, m, monitor = step(state, *harness.cam_tensors(cams[v], CPU), gts[v], bg, it,
                                 monitor)
        losses.append(float(m.loss))
    return t_state.state_to_numpy(state), losses, monitor.tolist()


def test_dp_step_matches_the_batch_reference_on_four_ranks():
    cams, rst, gts, start, alive = _setup()
    outs = spawn(_rank, RANKS, (cams, rst, gts, start, alive), backend="gloo", timeout=60,
                 join_timeout=120)
    s = ref.State.fresh(start, alive)
    want = []
    for k in range(STEPS):
        batch = [_schedule(k, rank) for rank in range(RANKS)]
        want.append(ref_dp.batch_step(
            s, [harness.cam_tensors(cams[v], CPU) for _, v, _ in batch],
            [gts[v] for _, v, _ in batch], batch[0][2], batch[0][0], rst))
    got, losses, monitor = outs[0]
    assert losses == pytest.approx(want, rel=1e-5)
    assert monitor[0] <= PAIR_CAP and monitor[1] <= ROW_CAP and monitor[2] == 1.0
    ref_state = dict(params=s.params, adam_m=s.m, adam_v=s.v)
    for group, tensors in ref_state.items():
        for k in PARAMS:
            rtol, atol = TOL[group]
            np.testing.assert_allclose(got[group][k], tensors[k].numpy(), rtol=rtol, atol=atol,
                                       err_msg=f"{group}.{k}")
    rtol, atol = TOL["uv_grad_accum"]
    np.testing.assert_allclose(got["uv_grad_accum"], s.uv_accum.numpy(), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(got["accum_dur"], s.dur.numpy())
    assert got["accum_dur"].max() > 1 and (got["accum_dur"] == 1).any()  # seen by 1 and by many
    for other, _, _ in outs[1:]:  # the replicas, bit for bit
        for group in ("params", "adam_m", "adam_v"):
            for k in PARAMS:
                np.testing.assert_array_equal(other[group][k], got[group][k])
        for f in ("alive", "uv_grad_accum", "accum_dur"):
            np.testing.assert_array_equal(other[f], got[f])


def test_four_identical_cameras_are_one_reference_step():
    cams, rst, gts, start, alive = _setup()
    cam = harness.cam_tensors(cams[2], CPU)
    one, batch = ref.State.fresh(start, alive), ref.State.fresh(start, alive)
    it, bg = 3001, 0.3
    loss = ref.train_step(one, *cam, gts[2], bg, it, rst)
    assert ref_dp.batch_step(batch, [cam] * 4, [gts[2]] * 4, bg, it, rst) == loss
    for k in PARAMS:
        for a, b in ((batch.params, one.params), (batch.m, one.m), (batch.v, one.v)):
            assert torch.equal(a[k], b[k]), k
    assert one.dur.max() == 1
    assert torch.equal(batch.dur, 4 * one.dur)
    assert torch.equal(batch.uv_accum, 4 * one.uv_accum)
