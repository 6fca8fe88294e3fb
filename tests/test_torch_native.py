"""Port parity: the C++ host runtime (``gsplat_tpu_torch/io/native.py``)
against the JAX package's (``native/gsplat_native.cpp`` through
``gsplat_tpu/io/native.py``), and against the port's plain versions.

The JAX package's source is compiled here, with its Makefile's flags, into
a temporary directory, and its module pointed at that library. On the same
inputs the two libraries give bit-equal KNN distances and parsed arrays and
byte-equal PLY files. The plain versions (scipy's cKDTree, the Python
points3D reader, the numpy PLY writer) agree: the KNN to rtol 1e-6 (the
two sum the neighbours' distances in another order), the rest exactly.
The CLI and ``initialize_gaussians`` go through the native library, and a
library that does not build raises with the compiler's output.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gsplat_tpu.io import native as j_native  # noqa: E402
from gsplat_tpu_torch import cli  # noqa: E402
from gsplat_tpu_torch.io import colmap as t_colmap  # noqa: E402
from gsplat_tpu_torch.io import native  # noqa: E402
from gsplat_tpu_torch.io import ply as t_ply  # noqa: E402
from gsplat_tpu_torch.tools.synthetic import write_synthetic_dataset  # noqa: E402
from gsplat_tpu_torch.train import init as t_init  # noqa: E402
from test_cli import DATASET  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
JAX_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-Wall"]


@pytest.fixture(scope="module")
def jax_lib_path(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the JAX package's native library")
    out = tmp_path_factory.mktemp("jax_native") / "libgsplat_native.so"
    subprocess.run(["g++", *JAX_CXXFLAGS, "-shared", "-o", str(out),
                    str(REPO / "native" / "gsplat_native.cpp")], check=True, timeout=300)
    return out


@pytest.fixture
def jax_native(jax_lib_path, monkeypatch):
    """The JAX package's ``io.native`` bound to the library built above."""
    monkeypatch.setattr(j_native, "_LIB_PATH", jax_lib_path)
    j_native._lib.cache_clear()
    yield j_native
    j_native._lib.cache_clear()


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * [2.0, 1.0, 0.5]
    if n > 11:
        xyz[10] = xyz[11]  # a duplicated point: its nearest neighbour is at 0
    return xyz


@pytest.mark.parametrize("n,k", [(2000, 3), (2000, 8), (5, 3), (5, 4), (5, 9), (2, 3),
                                 (1, 3)])
def test_knn_mean_dist_equals_jax_and_plain(jax_native, n, k):
    """k < n, k = n - 1, k >= n (every other point) and n == 1 (0.01)."""
    xyz = _cloud(n, n + k)
    got = native.knn_mean_dist(xyz, k)
    ref = jax_native.knn_mean_dist(xyz, k)
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got, ref)
    if n == 1:
        assert got[0] == np.float32(0.01)
        return
    np.testing.assert_allclose(got, t_init.knn_mean_dist_plain(xyz, k), rtol=1e-6, atol=0)
    if n > 11:
        assert got[10] == got[11]  # each is the other's neighbour at 0


def test_malformed_input_raises_before_the_library_reads_it(tmp_path):
    with pytest.raises(ValueError, match="k must be"):
        native.knn_mean_dist(_cloud(4, 0), 0)
    with pytest.raises(ValueError, match="xyz has shape"):
        native.knn_mean_dist(np.zeros((4, 2)), 3)
    n = 5
    cols = [np.zeros(s, np.float32) for s in ((n, 3), (n, 3), (n,), (n, 3), (n, 4))]
    for i, bad in enumerate(((n, 2), (n, 4), (n - 1,), (n, 2), (n, 3))):
        args = list(cols)
        args[i] = np.zeros(bad, np.float32)
        with pytest.raises(ValueError, match="has shape"):
            native.save_ply(tmp_path / "bad.ply", *args)
    assert not (tmp_path / "bad.ply").exists()


def _points(n, seed, mod=t_colmap):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3))
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    err = rng.uniform(0, 2, n)
    tracks = rng.integers(0, 4, n)
    return {
        int(3 * i + 1): mod.Point3D(
            id=int(3 * i + 1), xyz=xyz[i], rgb=rgb[i], error=float(err[i]),
            image_ids=np.arange(tracks[i], dtype=np.int32),
            point2d_idxs=np.arange(tracks[i], dtype=np.int32) + 5)
        for i in range(n)
    }


@pytest.mark.parametrize("n", [0, 1, 257])
def test_parse_points3d_equals_jax_and_reader(jax_native, tmp_path, n):
    pts = _points(n, n)
    t_colmap.write_points3d_binary(pts, tmp_path / "points3D.bin")
    got = native.parse_points3d(tmp_path / "points3D.bin")
    ref = jax_native.parse_points3d(tmp_path / "points3D.bin")
    for a, b, dtype in zip(got, ref, (np.float64, np.uint8, np.float64, np.uint64)):
        assert a.dtype == dtype and a.shape[0] == n
        np.testing.assert_array_equal(a, b)
    plain = t_colmap.read_points3d_binary(tmp_path / "points3D.bin")
    xyz, rgb, err, ids = got
    np.testing.assert_array_equal(xyz.reshape(-1, 3), np.array(
        [p.xyz for p in plain.values()]).reshape(-1, 3))
    np.testing.assert_array_equal(rgb.reshape(-1, 3), np.array(
        [p.rgb for p in plain.values()], np.uint8).reshape(-1, 3))
    np.testing.assert_array_equal(err, [p.error for p in plain.values()])
    np.testing.assert_array_equal(ids, list(plain))


def test_parse_points3d_errors(tmp_path):
    with pytest.raises(OSError, match="open"):
        native.parse_points3d(tmp_path / "missing.bin")
    t_colmap.write_points3d_binary(_points(3, 1), tmp_path / "p.bin")
    data = (tmp_path / "p.bin").read_bytes()
    (tmp_path / "short.bin").write_bytes(data[:-20])
    with pytest.raises(OSError, match="Corrupt"):
        native.parse_points3d(tmp_path / "short.bin")


@pytest.mark.parametrize("num_sh", [0, 3, 45])
def test_save_ply_bytes_equal_jax_and_numpy_writer(jax_native, tmp_path, num_sh):
    rng = np.random.default_rng(num_sh)
    n = 23
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((n, 3), (n, 3), (n,), (n, 3), (n, 4))]
    arrays[4][0] = 0.0  # a zero quaternion is written as is
    sh = rng.normal(size=(n, num_sh)).astype(np.float32) if num_sh else None
    native.save_ply(tmp_path / "t.ply", *arrays, sh)
    assert jax_native.save_ply(tmp_path / "j.ply", *arrays, sh)
    t_ply.save_ply(tmp_path / "p.ply", *arrays, sh)
    data = (tmp_path / "t.ply").read_bytes()
    assert data == (tmp_path / "j.ply").read_bytes()
    assert data == (tmp_path / "p.ply").read_bytes()


def test_cli_and_init_take_the_native_path(tmp_path, monkeypatch, capsys):
    """The CLI parses points3D.bin and ``initialize_gaussians`` measures
    the KNN with the native library, once each per run."""
    write_synthetic_dataset(tmp_path, **DATASET, device="cpu")
    calls = []
    for name in ("parse_points3d", "knn_mean_dist"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    over = {"dataset_path": DATASET["name"], "downsample_factor": 1,
            "output_dir": tmp_path / "out"}
    lines = [line for line in (REPO / "configs" / "base.yaml").read_text().splitlines()
             if line.split(":")[0] not in over]
    cfg = tmp_path / "c.yaml"
    cfg.write_text("\n".join(lines + [f"{k}: {v}" for k, v in over.items()]) + "\n")
    assert cli.main([str(cfg), str(tmp_path), "--max-iters", "1"], device="cpu") == 0
    assert calls == ["parse_points3d", "knn_mean_dist"]
    assert f"{DATASET['n_points']} points" in capsys.readouterr().out
    assert (tmp_path / "out" / "trained.ply").is_file()


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    """No quiet fallback to scipy: a source that does not compile makes
    ``initialize_gaussians`` raise, with g++'s message."""
    bad = tmp_path / "gsplat_native.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        t_init.initialize_gaussians(_cloud(50, 0), np.zeros((50, 3), np.uint8))
    assert "error" in str(info.value)
    assert not list((tmp_path / "build").glob("*.so"))
