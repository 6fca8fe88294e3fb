"""Port parity: ``tools/real_plane.py``, ``utils/profiling.py`` and the
end-to-end recipe (``tools/e2e_synthetic.py``), on the CPU.

- ``render_plane_view`` and ``render_layered_view`` on a texture numpy
  makes from a seed are bit-equal to the JAX package's, and both dataset
  writers, given the same seeded PNG as ``photo_path``, write the same
  files (cameras, images, points and image bytes).
- ``StageTimers`` reports as the JAX package's does; ``device_trace``
  writes a Chrome trace.
- The e2e recipe shrunk to 8 views at 96x64 and 40 iterations raises the
  eval PSNR.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gsplat_tpu.tools import real_plane as j_rp  # noqa: E402
from gsplat_tpu.utils import profiling as j_prof  # noqa: E402
from gsplat_tpu_torch.tools import e2e_synthetic  # noqa: E402
from gsplat_tpu_torch.tools import real_plane as t_rp  # noqa: E402
from gsplat_tpu_torch.utils import profiling as t_prof  # noqa: E402

W, H = 64, 40


def _texture(seed=0, shape=(40, 60)):
    """A smooth random texture: low-frequency noise plus fine detail."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(size=(shape[0] // 8 + 1, shape[1] // 8 + 1, 3))
    tex = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[: shape[0], : shape[1]]
    return np.clip(0.8 * tex + 0.2 * rng.uniform(size=shape + (3,)), 0, 1).astype(np.float32)


def test_cap_cameras_equal_jax():
    tc, ti = t_rp._cap_cameras(5, W, H, 4.0, max_tilt=0.5, seed=3)
    jc, ji = j_rp._cap_cameras(5, W, H, 4.0, max_tilt=0.5, seed=3)
    np.testing.assert_array_equal(tc[1].params, jc[1].params)
    assert list(ti) == list(ji)
    for k in ti:
        np.testing.assert_array_equal(ti[k].qvec, ji[k].qvec)
        np.testing.assert_array_equal(ti[k].tvec, ji[k].tvec)
        assert ti[k].name == ji[k].name


def test_render_plane_view_bit_equal_jax():
    tex = _texture()
    half = (2.0, 2.0 * 40 / 60)
    cams, imgs = j_rp._cap_cameras(3, W, H, 4.0)
    for im in imgs.values():
        got = t_rp.render_plane_view(tex, half, im.qvec, im.tvec, W, H, cams[1].focal_x)
        ref = j_rp.render_plane_view(tex, half, im.qvec, im.tvec, W, H, cams[1].focal_x)
        assert got.dtype == ref.dtype and got.shape == (H, W, 3)
        np.testing.assert_array_equal(got, ref)
        assert got.max() > 0.1  # the plane is in view


def test_render_layered_view_bit_equal_jax():
    tex = _texture(1, (48, 64))
    t_planes, j_planes = t_rp._default_layers(tex), j_rp._default_layers(tex)
    for a, b in zip(t_planes, j_planes):
        for f in ("origin", "ex", "ey", "texture"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.half == b.half
    cams, imgs = j_rp._cap_cameras(3, W, H, 4.0, max_tilt=0.5)
    for im in imgs.values():
        got = t_rp.render_layered_view(t_planes, im.qvec, im.tvec, W, H, cams[1].focal_x,
                                       background=0.1)
        ref = j_rp.render_layered_view(j_planes, im.qvec, im.tvec, W, H, cams[1].focal_x,
                                       background=0.1)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("writer", ["write_real_plane_dataset", "write_real_layers_dataset"])
def test_dataset_writers_write_the_same_files(tmp_path, writer):
    from PIL import Image as PILImage

    photo = tmp_path / "photo.png"
    PILImage.fromarray((_texture(2, (50, 72)) * 255).astype(np.uint8)).save(photo)
    kw = dict(photo_path=str(photo), n_views=3, width=48, height=32, n_points=300)
    got = getattr(t_rp, writer)(tmp_path / "port", **kw)
    ref = getattr(j_rp, writer)(tmp_path / "jax", **kw)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 3 + 3  # three .bin files, three views
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    np.testing.assert_array_equal(got.points_xyz, ref.points_xyz)
    np.testing.assert_array_equal(got.points_rgb, ref.points_rgb)
    np.testing.assert_array_equal(got.texture, ref.texture)
    assert got.half_extent == ref.half_extent and got.name == ref.name
    assert [im.name.rsplit("/", 1)[-1] for im in got.images.values()] == [
        im.name.rsplit("/", 1)[-1] for im in ref.images.values()]


def test_real_plane_main(tmp_path, capsys):
    from PIL import Image as PILImage

    photo = tmp_path / "photo.png"
    PILImage.fromarray((_texture(3) * 255).astype(np.uint8)).save(photo)
    assert t_rp.main([str(tmp_path / "out"), "--views", "2", "--size", "32x24",
                      "--layout", "layers", "--photo", str(photo)]) == 0
    assert "2 real-texture layers views" in capsys.readouterr().out
    assert (tmp_path / "out" / "reallayers" / "images" / "view_001.png").is_file()


def test_stage_timers_report_like_jax():
    timers = t_prof.StageTimers()
    x = torch.ones(64)
    for _ in range(3):
        with timers.stage("step", block_on=[x, x * 2]):
            x = x + 1
    with timers.stage("eval", block_on={"x": x}):
        pass
    assert dict(timers.counts) == {"step": 3, "eval": 1}
    assert all(v > 0 for v in timers.totals.values())
    ref = j_prof.StageTimers()
    ref.totals.update(timers.totals)
    ref.counts.update(timers.counts)
    assert timers.report() == ref.report()
    assert timers.report().splitlines()[0].startswith("eval")


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with t_prof.device_trace(tmp_path / "trace") as prof:
        (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    path = prof.trace_path
    assert path.parent == tmp_path / "trace" and path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)


def test_e2e_recipe_shrunk_raises_psnr(tmp_path):
    """The recipe at 8 views of 96x64, 300 true Gaussians, 1,000 points and
    40 iterations, on two threads: the test shares the host with the other
    test workers, and torch's default of every core per worker makes them
    wait on each other."""
    timers = t_prof.StageTimers()
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        res = e2e_synthetic.run(40, root=tmp_path, device="cpu", n_views=8, width=96,
                                height=64, n_gaussians=300, n_points=1000, timers=timers,
                                log=lambda *a: None)
    finally:
        torch.set_num_threads(threads)
    assert math.isfinite(res.psnr_before) and math.isfinite(res.psnr_after)
    assert res.psnr_after > res.psnr_before + 1.0
    assert res.final_gaussians == res.initial_gaussians == 1000  # no density step by 40
    assert res.ply_bytes == (tmp_path / "final.ply").stat().st_size > 0
    assert set(timers.counts) == {"dataset", "init", "trainer", "evaluate", "train",
                                  "save_ply"}
    assert timers.counts["evaluate"] == 2
