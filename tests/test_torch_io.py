"""Port parity: the config reader, COLMAP and PLY files, the initializer
and checkpoints, against the JAX package.

- The port's flat-YAML reader gives the same ``ConfigParameters`` (values
  and types) and the same ``config_hash`` as ``parse_config`` with PyYAML,
  and the same errors.
- COLMAP files written by either package read back equal in the other;
  PLY files are byte-identical.
- ``initialize_gaussians`` equals the JAX one: to the last bit where both
  take the same KNN (the port always takes its native one, the JAX package
  where its library is built), to rtol 1e-6 where the JAX package takes
  scipy's cKDTree.
- A checkpoint written by either package resumes in the other with the
  state exactly equal.
"""

import dataclasses
import math
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from gsplat_tpu import config as j_config  # noqa: E402
from gsplat_tpu.io import colmap as j_colmap  # noqa: E402
from gsplat_tpu.io import native as j_native  # noqa: E402
from gsplat_tpu.io import ply as j_ply  # noqa: E402
from gsplat_tpu.train import init as j_init  # noqa: E402
from gsplat_tpu.train import state as j_state  # noqa: E402
from gsplat_tpu.utils import checkpoint as j_ckpt  # noqa: E402
from gsplat_tpu_torch import config as t_config  # noqa: E402
from gsplat_tpu_torch.io import colmap as t_colmap  # noqa: E402
from gsplat_tpu_torch.io import ply as t_ply  # noqa: E402
from gsplat_tpu_torch.train import init as t_init  # noqa: E402
from gsplat_tpu_torch.train import state as t_state  # noqa: E402
from gsplat_tpu_torch.utils import checkpoint as t_ckpt  # noqa: E402
from test_colmap import REF_TEST_DATA  # noqa: E402
from test_config_ply_init import BASE_YAML  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _assert_same_config(path):
    ref = j_config.parse_config(path)
    got = t_config.parse_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for f in dataclasses.fields(ref):
        assert type(getattr(got, f.name)) is type(getattr(ref, f.name)), f.name
    assert t_ckpt.config_hash(got) == j_ckpt.config_hash(ref)
    return got


@pytest.mark.parametrize("name", ["base.yaml", "extended.yaml"])
def test_config_reader_matches_parse_config(name):
    cfg = _assert_same_config(REPO / "configs" / name)
    assert cfg.strict_reference is True and cfg.base_lr == 1e-3


def test_config_reader_reads_yaml_dump_with_extensions(tmp_path):
    # What yaml.safe_dump writes (quotes, 1.0e-05, extension keys) and
    # comments; the extension fields change the hash.
    raw = yaml.safe_load(BASE_YAML)
    raw.update(output_dir="out: with a colon", dataset_path="it's", strict_reference=False,
               seed=7, tile_size=8, uv_grad_threshold=1e-5, use_background="off")
    text = "# a comment\n\n" + yaml.safe_dump(raw).replace(
        "num_iters: 7000", "num_iters: 7000  # trailing comment")
    path = tmp_path / "c.yaml"
    path.write_text(text)
    cfg = _assert_same_config(path)
    assert (cfg.output_dir, cfg.dataset_path, cfg.seed) == ("out: with a colon", "it's", 7)
    assert cfg.use_background is False and cfg.uv_grad_threshold == 1e-5
    base = tmp_path / "b.yaml"
    base.write_text(BASE_YAML)
    assert t_ckpt.config_hash(cfg) != t_ckpt.config_hash(t_config.parse_config(base))


@pytest.mark.parametrize("module", [j_config, t_config], ids=["jax", "port"])
def test_config_errors_match(tmp_path, module):
    p = tmp_path / "cfg.yaml"
    p.write_text(BASE_YAML.replace("mh_dist: 3.0\n", ""))
    with pytest.raises(KeyError, match="mh_dist"):
        module.parse_config(p)
    p.write_text("")
    with pytest.raises(KeyError, match="dataset_path"):
        module.parse_config(p)
    with pytest.raises(FileNotFoundError):
        module.parse_config(tmp_path / "nope.yaml")


@pytest.mark.parametrize("key,text", [
    ("num_iters", "30000.0"), ("num_iters", "0x10"), ("base_lr", ".inf"),
    ("use_split", "1"), ("dataset_path", "12"), ("dataset_path", "~"),
    ("base_lr", "1e-3"), ("num_iters", "1_000"), ("use_split", "on"), ("use_split", "y"),
    ("num_iters", "0o17"), ("dataset_path", "0o17"), ("base_lr", "-.inf"),
    ("base_lr", ".nan"), ("dataset_path", '"12"'), ("num_iters", "010"),
    ("num_iters", "-0b101"), ("num_iters", "1:30"), ("base_lr", "1:30.5"),
    ("base_lr", "1.5e3"), ("dataset_path", "1.5e3"), ("dataset_path", "1.5e+3"),
    ("use_split", "Off"), ("use_split", "NULL"), ("output_dir", "true"),
    ("output_dir", "'0x10'"), ("max_gaussians", "4_250_000  # a comment"),
])
def test_config_scalars_match_parse_config(tmp_path, key, text):
    """One line of configs/base.yaml changed: the port resolves the scalar
    as YAML 1.1 does and casts it as the reference does, so the value, its
    type and ``config_hash`` equal the JAX package's (or both raise the
    same error)."""
    path = tmp_path / "c.yaml"
    lines = [line for line in BASE_YAML.splitlines() if line.split(":")[0] != key]
    path.write_text("\n".join(lines + [f"{key}: {text}"]) + "\n")
    try:
        ref = j_config.parse_config(path)
    except Exception as e:  # noqa: BLE001 - the port must raise the same
        with pytest.raises(type(e)):
            t_config.parse_config(path)
        return
    got = t_config.parse_config(path)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert type(a) is type(b), (f.name, a, b)
        if isinstance(b, float) and math.isnan(b):
            assert math.isnan(a), f.name
        else:
            assert a == b, (f.name, a, b)
    assert t_ckpt.config_hash(got) == j_ckpt.config_hash(ref)


def test_config_reader_refuses_timestamps(tmp_path):
    """A YAML timestamp (a date to PyYAML) is no config value: the port
    raises where the reference would carry a ``datetime.date``."""
    p = tmp_path / "cfg.yaml"
    p.write_text(BASE_YAML.replace("dataset_path: garden", "dataset_path: 2001-12-14"))
    with pytest.raises(ValueError, match="timestamp"):
        t_config.parse_config(p)


def test_config_reader_rejects_nested_yaml(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(BASE_YAML + "extra:\n  nested: 1\n")
    with pytest.raises(ValueError, match="flat"):
        t_config.parse_config(p)


# ------------------------------------------------------------- COLMAP


def _fixture(mod):
    cams = {
        1: mod.Camera(id=1, model="PINHOLE", width=1920, height=1080,
                      params=np.array([1000.0, 990.0, 960.0, 540.0])),
        2: mod.Camera(id=2, model="SIMPLE_PINHOLE", width=641, height=479,
                      params=np.array([500.0, 320.0, 240.0])),
    }
    imgs = {
        7: mod.Image(id=7, qvec=np.array([0.7071067811865476, 0.0, 0.7071067811865476, 0.0]),
                     tvec=np.array([1.0, -2.0, 3.0]), camera_id=1, name="photo_a.jpg",
                     xys=np.array([[1.5, 2.5], [3.0, 4.0]]),
                     point3d_ids=np.array([11, -1], dtype=np.int64)),
        8: mod.Image(id=8, qvec=np.array([0.9, 0.1, -0.2, 0.3]), tvec=np.zeros(3),
                     camera_id=2, name="photo_b.jpg", xys=np.zeros((0, 2)),
                     point3d_ids=np.zeros((0,), dtype=np.int64)),
    }
    pts = {
        11: mod.Point3D(id=11, xyz=np.array([0.1, 0.2, 0.3]),
                        rgb=np.array([255, 128, 0], dtype=np.uint8), error=0.5,
                        image_ids=np.array([7, 8], dtype=np.int32),
                        point2d_idxs=np.array([0, 3], dtype=np.int32)),
        12: mod.Point3D(id=12, xyz=np.array([-1.0, 2.0, 5.0]),
                        rgb=np.array([1, 2, 3], dtype=np.uint8), error=0.0,
                        image_ids=np.zeros(0, np.int32), point2d_idxs=np.zeros(0, np.int32)),
    }
    return cams, imgs, pts


def _assert_records_equal(got: dict, ref: dict):
    assert list(got) == list(ref)
    for k in ref:
        a, b = dataclasses.asdict(got[k]), dataclasses.asdict(ref[k])
        assert a.keys() == b.keys()
        for f in b:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{k}.{f}")
            assert np.asarray(a[f]).dtype == np.asarray(b[f]).dtype, f


@pytest.mark.parametrize("writer,reader", [(j_colmap, t_colmap), (t_colmap, j_colmap)],
                         ids=["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("factor", [1, 4])
def test_colmap_crosses_packages(tmp_path, writer, reader, factor):
    cams, imgs, pts = _fixture(writer)
    writer.write_cameras_binary(cams, tmp_path / "cameras.bin")
    writer.write_images_binary(imgs, tmp_path / "images.bin")
    writer.write_points3d_binary(pts, tmp_path / "points3D.bin")
    for mod in (j_colmap, t_colmap):  # both readers agree on what was written
        for fn, args in ((mod.read_cameras_binary, (tmp_path / "cameras.bin", factor)),
                         (mod.read_images_binary, (tmp_path / "images.bin", "root/", factor)),
                         (mod.read_points3d_binary, (tmp_path / "points3D.bin",))):
            ref = getattr(j_colmap, fn.__name__)(*args)
            _assert_records_equal(fn(*args), ref)
    got = reader.read_images_binary(tmp_path / "images.bin", "root/", factor)
    assert got[7].name == ("root/images/photo_a.jpg" if factor == 1
                           else "root/images_4/photo_a.jpg")
    cams_read = reader.read_cameras_binary(tmp_path / "cameras.bin", factor)
    assert (cams_read[2].width, cams_read[2].height) == (
        (641, 479) if factor == 1 else (160, 120))
    assert t_colmap.compute_max_diagonal(t_colmap.read_images_binary(
        tmp_path / "images.bin", "", 1)) == j_colmap.compute_max_diagonal(
        j_colmap.read_images_binary(tmp_path / "images.bin", "", 1))


def test_colmap_unsupported_model_and_short_file(tmp_path):
    with open(tmp_path / "bad.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 4, 100, 100))  # OPENCV
        f.write(struct.pack("<8d", *([1.0] * 8)))
    with pytest.raises(t_colmap.ColmapError, match="PINHOLE"):
        t_colmap.read_cameras_binary(tmp_path / "bad.bin")
    with open(tmp_path / "short.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
    with pytest.raises(t_colmap.ColmapError, match="end of file"):
        t_colmap.read_points3d_binary(tmp_path / "short.bin")
    with pytest.raises(t_colmap.ColmapError, match="open"):
        t_colmap.read_images_binary(tmp_path / "missing.bin")


def test_colmap_rotmat_qvec_match():
    rng = np.random.default_rng(3)
    for q in rng.normal(size=(20, 4)):
        r = t_colmap.qvec_to_rotmat(q)
        np.testing.assert_array_equal(r, j_colmap.qvec_to_rotmat(q))
        np.testing.assert_array_equal(t_colmap.rotmat_to_qvec(r), j_colmap.rotmat_to_qvec(r))


def test_colmap_reference_fixture_parses_alike():
    if not REF_TEST_DATA.exists():
        pytest.skip("reference data absent")
    for name, args in (("read_cameras_binary", ("cameras.bin", 1)),
                       ("read_images_binary", ("images.bin", "", 1)),
                       ("read_points3d_binary", ("points3D.bin",))):
        path, *rest = args
        _assert_records_equal(getattr(t_colmap, name)(REF_TEST_DATA / path, *rest),
                              getattr(j_colmap, name)(REF_TEST_DATA / path, *rest))


# ------------------------------------------------------------- PLY


@pytest.mark.parametrize("num_sh", [0, 3, 45])
def test_ply_bytes_equal_jax(tmp_path, num_sh):
    rng = np.random.default_rng(num_sh)
    n = 23
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((n, 3), (n, 3), (n,), (n, 3), (n, 4))]
    arrays[4][0] = 0.0  # a zero quaternion is written as is
    sh = rng.normal(size=(n, num_sh)).astype(np.float32) if num_sh else None
    j_ply.save_ply(tmp_path / "j.ply", *arrays, sh)
    t_ply.save_ply(tmp_path / "t.ply", *arrays, sh)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    got, ref = t_ply.load_ply(tmp_path / "j.ply"), j_ply.load_ply(tmp_path / "t.ply")
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ------------------------------------------------------------- initializer


@pytest.mark.parametrize("strict", [True, False])
def test_initialize_gaussians_matches_jax(tmp_path, strict):
    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(3000, 3)) * [2.0, 1.0, 0.5]
    xyz[10] = xyz[11]  # a duplicated point: distance 0 -> 0.01
    rgb = rng.integers(0, 256, (3000, 3)).astype(np.uint8)
    path = tmp_path / "c.yaml"
    text = BASE_YAML.replace("initial_scale_num_neighbors: 3", "initial_scale_num_neighbors: 5")
    text = text.replace("initial_scale_factor: 0.8", "initial_scale_factor: 0.7")
    path.write_text(text + f"strict_reference: {str(strict).lower()}\n")
    ref = j_init.initialize_gaussians(xyz, rgb, j_config.parse_config(path))
    got = t_init.initialize_gaussians(xyz, rgb, t_config.parse_config(path))
    # The port's init takes its native KNN; the JAX one takes the same C++
    # only where its library is built, else scipy's cKDTree.
    paths_differ = not j_native.available()
    rtol = 1e-6 if paths_differ else 0.0
    for f in ("xyz", "rgb", "opacity", "scale", "quaternion"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=rtol, atol=0,
                                   err_msg=f)
        assert getattr(got, f).dtype == np.float32
    assert got.sh is None and ref.sh is None
    if not strict:  # the clamp at max_initial_scale applies somewhere
        assert np.isclose(got.scale.max(), np.log(np.float32(0.1)))


def test_gaussian_data_append_filter_match_jax():
    rng = np.random.default_rng(6)

    def mk(mod, n, sh):
        r = np.random.default_rng(n)
        return mod.GaussianData(
            *(r.normal(size=s).astype(np.float32) for s in ((n, 3), (n, 3), (n,), (n, 3),
                                                           (n, 4))),
            sh=r.normal(size=(n, 3, 3)).astype(np.float32) if sh else None)

    mask = rng.uniform(size=9) < 0.5
    for sh_b in (True, False):
        ref = mk(j_init, 4, True).append(mk(j_init, 5, sh_b)).filter(mask)
        got = mk(t_init, 4, True).append(mk(t_init, 5, sh_b)).filter(mask)
        for f in dataclasses.fields(ref):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="mask"):
        mk(t_init, 4, False).filter(np.ones(3, bool))


# ------------------------------------------------------------- checkpoints


def _jax_state(seed, n_cap=64):
    rng = np.random.default_rng(seed)
    group = lambda: {k: jnp.asarray(rng.normal(size=t_state._param_shape(k, n_cap))  # noqa: E731
                                    .astype(np.float32)) for k in t_state.PARAM_DIMS}
    return j_state.TrainState(
        params=group(), adam_m=group(), adam_v=group(),
        alive=jnp.asarray(rng.uniform(size=n_cap) < 0.7),
        uv_grad_accum=jnp.asarray(rng.uniform(0, 3, n_cap).astype(np.float32)),
        accum_dur=jnp.asarray(rng.integers(0, 50, n_cap).astype(np.int32)))


def _assert_state_is(port_state, jax_state):
    got = t_state.state_to_numpy(port_state)
    for f in jax_state._fields:
        ref = getattr(jax_state, f)
        if isinstance(ref, dict):
            for k in ref:
                np.testing.assert_array_equal(got[f][k], np.asarray(ref[k]), err_msg=f"{f}.{k}")
        else:
            np.testing.assert_array_equal(got[f], np.asarray(ref), err_msg=f)
            assert got[f].dtype == np.asarray(ref).dtype


def test_checkpoint_jax_to_port(tmp_path):
    cfg_path = tmp_path / "c.yaml"
    cfg_path.write_text(BASE_YAML)
    cfg_hash = j_ckpt.config_hash(j_config.parse_config(cfg_path))
    assert cfg_hash == t_ckpt.config_hash(t_config.parse_config(cfg_path))
    js = _jax_state(1)
    j_ckpt.save_checkpoint(tmp_path / "ck.npz", js, 123, 2, pair_cap=4096, cfg_hash=cfg_hash,
                           row_cap=2048)
    ck = t_ckpt.load_checkpoint(tmp_path / "ck.npz", "cpu")
    assert (ck.iteration, ck.l_max, ck.config_hash) == (123, 2, cfg_hash)
    _assert_state_is(ck.state, js)


def test_checkpoint_port_to_jax(tmp_path):
    js = _jax_state(2)
    port = t_state.state_from_jax(**{f: getattr(js, f) for f in js._fields}, device="cpu")
    t_ckpt.save_checkpoint(tmp_path / "sub" / "ck.npz", port, 77, 3, cfg_hash="abc")
    ck = j_ckpt.load_checkpoint(tmp_path / "sub" / "ck.npz")
    assert (ck.iteration, ck.l_max, ck.config_hash) == (77, 3, "abc")
    assert ck.pair_cap == 0 and ck.row_cap == 0  # "unknown" to the reference
    _assert_state_is(port, ck.state)
    # and back into the port
    shutil.copy(tmp_path / "sub" / "ck.npz", tmp_path / "again.npz")
    _assert_state_is(t_ckpt.load_checkpoint(tmp_path / "again.npz", "cpu").state, ck.state)


# ------------------------------------------------------------- images


def test_image_io_and_loader_draws_match_jax(tmp_path):
    """save_image / load_image round-trip a PNG as the reference reads it,
    and the loader draws the reference's image sequence from any start
    (counter-based draws), each image as a float32 tensor."""
    from gsplat_tpu.io import images as j_images
    from gsplat_tpu_torch.io import images as t_images

    rng = np.random.default_rng(7)
    paths = []
    for i in range(5):
        arr = rng.integers(0, 256, (6, 9, 3)).astype(np.uint8)
        paths.append(str(tmp_path / f"im{i}.png"))
        t_images.save_image(paths[-1], arr)
        np.testing.assert_array_equal(t_images.load_image(paths[-1]), arr / np.float32(255.0))
        np.testing.assert_array_equal(t_images.load_image(paths[-1]),
                                      j_images.load_image(paths[-1]))
    for start in (0, 5):
        ref = j_images.AsyncImageLoader(paths, seed=3, start=start)
        got = t_images.AsyncImageLoader(paths, "cpu", seed=3, start=start)
        try:
            for _ in range(8):
                (j_idx, j_img), (t_idx, t_img) = ref.next(), got.next()
                assert t_idx == j_idx
                assert t_img.dtype == torch.float32 and t_img.device.type == "cpu"
                np.testing.assert_array_equal(t_img.numpy(), np.asarray(j_img))
        finally:
            ref.close()
            got.close()


def test_loader_surfaces_decode_errors(tmp_path):
    from gsplat_tpu_torch.io import images as t_images

    loader = t_images.AsyncImageLoader([str(tmp_path / "missing.png")], "cpu")
    try:
        with pytest.raises(OSError):
            loader.next()
    finally:
        loader.close()
