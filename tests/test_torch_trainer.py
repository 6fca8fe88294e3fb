"""Port parity: the Trainer's schedule decisions against the JAX Trainer,
then the port's trainer loop, CLI and checkpoints on their own.

One dataset, written by the port's ``write_synthetic_dataset`` on the CPU
at tests/test_cli.py's geometry (3 views, 48x32). A port ``Trainer`` and a
JAX ``Trainer`` built on it make the same train/test split, scene extent,
background, SH schedule and density statics, and ``_density_step`` (grow,
rerun, Morton re-sort) leaves the same state when the port's split noise
is replaced by JAX's draws for ``key(seed * 1_000_003 + iteration)``:
exact, except split children's xyz and scale, within ``CHILD_ULPS`` units
in the last place of their column's largest |value| (ROADMAP R8). The
JAX side never trains or renders, so no Pallas kernel is compiled.

On the port alone: ``cli.main`` end to end to ``trained.ply``, a run
stopped by ``--max-iters`` and resumed bit-equal to an uninterrupted one,
the flag errors (``--dp`` with ``--tp`` among them), a non-finite loss
anywhere in a window raising ``FloatingPointError`` at its boundary,
``evaluate``'s skip warning, and
no silent CPU fallback when no card is present.
"""

import dataclasses
import os
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gsplat_tpu import config as j_config  # noqa: E402
from gsplat_tpu.io import colmap as j_colmap  # noqa: E402
from gsplat_tpu.train import init as j_init  # noqa: E402
from gsplat_tpu.train import state as j_state  # noqa: E402
from gsplat_tpu.train import trainer as j_trainer  # noqa: E402
from gsplat_tpu_torch import cli  # noqa: E402
from gsplat_tpu_torch import config as t_config  # noqa: E402
from gsplat_tpu_torch.io import colmap as t_colmap  # noqa: E402
from gsplat_tpu_torch.io import images as t_images  # noqa: E402
from gsplat_tpu_torch.io.ply import load_ply  # noqa: E402
from gsplat_tpu_torch.tools.synthetic import write_synthetic_dataset  # noqa: E402
from gsplat_tpu_torch.train import init as t_init  # noqa: E402
from gsplat_tpu_torch.train import state as t_state  # noqa: E402
from gsplat_tpu_torch.train import trainer as t_trainer  # noqa: E402
from test_cli import DATASET  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
NAMES = list(t_state.PARAM_DIMS)
CHILD_ULPS = 4
SCHEDULE = dict(
    dataset_path=DATASET["name"], downsample_factor=1, num_iters=10,
    print_interval=10**9, test_eval_interval=10**9, test_split_ratio=4,
    adaptive_control_start=2, adaptive_control_interval=5, adaptive_control_end=8,
    reset_opacity_start=10**9, reset_opacity_end=10**9, max_sh_band=2,
    add_sh_band_interval=3, max_gaussians=5000, use_background="false",
    strict_reference="false", uv_grad_threshold=1e-5,
)


def _write_config(path: Path, **over) -> Path:
    """configs/base.yaml with ``over``'s keys replaced, as flat YAML."""
    over = {**SCHEDULE, **over}
    lines = [line for line in (REPO / "configs" / "base.yaml").read_text().splitlines()
             if line.split(":")[0] not in over]
    path.write_text("\n".join(lines + [f"{k}: {v}" for k, v in over.items()]) + "\n")
    return path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_dataset")
    write_synthetic_dataset(root, **DATASET, device="cpu")
    return root


def _read(mod, root):
    sparse = root / DATASET["name"] / "sparse" / "0"
    cams = mod.read_cameras_binary(sparse / "cameras.bin", 1)
    imgs = mod.read_images_binary(sparse / "images.bin", str(root / DATASET["name"]) + "/", 1)
    pts = mod.read_points3d_binary(sparse / "points3D.bin")
    xyz = np.stack([p.xyz for p in pts.values()])
    rgb = np.stack([p.rgb for p in pts.values()])
    return cams, imgs, xyz, rgb


@pytest.fixture(scope="module")
def trainers(dataset, tmp_path_factory):
    """(port Trainer, JAX Trainer) on the same dataset and config."""
    cfg_path = _write_config(tmp_path_factory.mktemp("cfg") / "c.yaml",
                             output_dir=str(tmp_path_factory.mktemp("out")))
    built = []
    for conf, colmap, init, trainer, kw in (
            (t_config, t_colmap, t_init, t_trainer, {"device": "cpu"}),
            (j_config, j_colmap, j_init, j_trainer, {})):
        cfg = conf.parse_config(cfg_path)
        cams, imgs, xyz, rgb = _read(colmap, dataset)
        built.append(trainer.Trainer(cfg, init.initialize_gaussians(xyz, rgb, cfg), imgs,
                                     cams, **kw))
    return tuple(built)


def _both(trainers, **cfg):
    """Both trainers with ``cfg`` replaced in their configs."""
    for tr in trainers:
        tr.config = dataclasses.replace(tr.config, **cfg)
    return trainers


# ------------------------------------------------------------- against JAX


def test_initial_state_and_extent_match(trainers):
    port, ref = trainers
    assert port.scene_extent == ref.scene_extent > 0
    assert port.state.capacity == ref.state.capacity
    got = t_state.state_to_numpy(port.state)
    for name in NAMES:
        np.testing.assert_array_equal(got["params"][name], np.asarray(ref.state.params[name]))
    np.testing.assert_array_equal(got["alive"], np.asarray(ref.state.alive))


@pytest.mark.parametrize("ratio", [0, 1, 2, 4])
def test_train_test_split_matches(trainers, ratio):
    for tr in _both(trainers, test_split_ratio=ratio):
        tr.test_train_split()
    port, ref = trainers
    for attr in ("train_images", "test_images"):
        assert [im.name for im in getattr(port, attr)] == [im.name for im in getattr(ref, attr)]
    assert len(port.train_images) == DATASET["n_views"]


@pytest.mark.parametrize("strict,use_bg", [(True, True), (False, True), (False, False)])
def test_background_schedule_matches(trainers, strict, use_bg):
    port, ref = _both(trainers, strict_reference=strict, use_background=use_bg,
                      use_background_end=600)
    its = range(0, 2000, 7)
    assert [port._bg(i) for i in its] == [ref._bg(i) for i in its]


def test_sh_schedule_matches(trainers):
    port, ref = _both(trainers, add_sh_band_interval=10, max_sh_band=3)
    with torch.no_grad():
        port.state.params.sh.fill_(1.0)
    port.l_max = ref.l_max = 0
    seen = []
    for i in range(0, 60):
        port._maybe_add_sh_band(i)
        ref._maybe_add_sh_band(i)
        assert port.l_max == ref.l_max, i
        seen.append(port.l_max)
    assert seen[9:12] == [0, 1, 1] and seen[-1] == 3
    assert not port.state.params.sh.any()  # zeroed at the 0 -> 1 band


@pytest.mark.parametrize("cfg", [dict(strict_reference=True),
                                 dict(strict_reference=False, use_split=False),
                                 dict(strict_reference=False, use_clone=False,
                                      use_delete=False)])
def test_density_statics_match(trainers, cfg):
    port, ref = _both(trainers, use_split=True, use_clone=True, use_delete=True)
    port, ref = _both(trainers, **cfg)
    assert dataclasses.asdict(port._density_statics()) == dataclasses.asdict(
        ref._density_statics())


def _jax_split_noise(state, seed, iteration):
    k1, k2 = jax.random.split(jax.random.key(seed * 1_000_003 + iteration))
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, (state.capacity, 3))))
                 for k in (k1, k2))


def _assert_same_state(port_state, jax_state, max_children):
    """Exact, except at most ``max_children`` rows of xyz and scale, which
    may differ by CHILD_ULPS units in the last place."""
    got = t_state.state_to_numpy(port_state)
    ref = {f: jax.tree.map(np.asarray, getattr(jax_state, f)) for f in jax_state._fields}
    for f in ("alive", "uv_grad_accum", "accum_dur"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    for f in ("params", "adam_m", "adam_v"):
        for name in NAMES:
            a, b = got[f][name], ref[f][name]
            if f == "params" and name in ("xyz", "scale"):
                rows = (a != b).any(axis=1)
                assert rows.sum() <= max_children, name
                tol = CHILD_ULPS * np.spacing(np.abs(b).max(axis=0))
                assert (np.abs(a - b) <= tol).all(), name
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{f}.{name}")


def test_density_step_matches_jax(trainers, monkeypatch):
    """Two density steps through both trainers: 60 Gaussians in 64 rows
    that all split (grow to 128 and rerun, then the Morton re-sort), then
    mixed accumulators on the grown state (grow to 256)."""
    port, ref = _both(trainers, strict_reference=False, use_split=True, use_clone=True,
                      use_delete=True, uv_grad_threshold=0.05, seed=3)
    monkeypatch.setattr(t_trainer, "split_noise", _jax_split_noise)
    g = ref.state  # the initialized cloud, first 60 rows, in 64
    gd = j_init.GaussianData(
        xyz=np.asarray(g.params["xyz"])[:60], rgb=np.asarray(g.params["rgb"])[:60],
        opacity=np.asarray(g.params["opacity"])[:60],
        scale=np.full((60, 3), np.log(0.2), np.float32),
        quaternion=np.asarray(g.params["quat"])[:60])
    js = j_state.init_state(gd, n_cap=64)
    js = js._replace(uv_grad_accum=jnp.full((64,), 1.0), accum_dur=jnp.ones(64, jnp.int32))
    rng = np.random.default_rng(0)
    for it, accum in ((5, None), (10, rng.uniform(0.0, 0.1, 128).astype(np.float32))):
        if accum is not None:  # the grown state, mixed gradients
            js = ref.state._replace(uv_grad_accum=jnp.asarray(accum),
                                    accum_dur=jnp.ones(128, jnp.int32))
        ref.state = js
        port.state = t_state.state_from_jax(
            **{f: jax.tree.map(np.asarray, getattr(js, f)) for f in js._fields}, device="cpu")
        port.iter = ref.iter = it
        info = port._density_step()
        ref._density_step()
        assert info.applied and port.state.capacity == ref.state.capacity == 2 * js.capacity
        _assert_same_state(port.state, ref.state, 2 * info.num_split)
        n = info.new_total
        assert port.state.alive[:n].all() and not port.state.alive[n:].any()


@pytest.mark.parametrize("l_max,alive", [(1, 0), (3, 0), (0, 0), (0, 37), (1, 37)])
def test_save_to_ply_empty_state_matches_jax(tmp_path, l_max, alive):
    """``Trainer.save_to_ply`` writes the same bytes in both packages: on a
    state with no alive row (``element vertex 0``, no ``f_rest_*`` even at
    ``l_max`` >= 1) and on a live one."""
    rng = np.random.default_rng(l_max)
    n = 37
    gd = j_init.GaussianData(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        rgb=rng.normal(size=(n, 3)).astype(np.float32),
        opacity=rng.normal(size=n).astype(np.float32),
        scale=rng.normal(size=(n, 3)).astype(np.float32),
        quaternion=rng.normal(size=(n, 4)).astype(np.float32),
        sh=rng.normal(size=(n, 15, 3)).astype(np.float32))
    js = j_state.init_state(gd, n_cap=64)
    js = js._replace(alive=jnp.asarray(np.arange(64) < alive))
    ps = t_state.state_from_jax(
        **{f: jax.tree.map(np.asarray, getattr(js, f)) for f in js._fields}, device="cpu")
    j_trainer.Trainer.save_to_ply(SimpleNamespace(state=js, l_max=l_max), tmp_path / "j.ply")
    t_trainer.Trainer.save_to_ply(SimpleNamespace(state=ps, l_max=l_max, rank=0),
                                  tmp_path / "t.ply")
    got = (tmp_path / "t.ply").read_bytes()
    assert got == (tmp_path / "j.ply").read_bytes()
    assert f"element vertex {alive}\n".encode() in got
    assert (b"f_rest_0" in got) == (alive > 0 and l_max > 0)


# ------------------------------------------------------------- the port alone


def _run_cli(cfg_path, root, *flags):
    return cli.main([str(cfg_path), str(root), *flags], device="cpu")


def test_cli_end_to_end(dataset, tmp_path):
    out = tmp_path / "out"
    cfg = _write_config(tmp_path / "c.yaml", output_dir=str(out))
    assert _run_cli(cfg, dataset) == 0
    data = load_ply(out / "trained.ply")
    with np.load(out / "checkpoint.npz") as ck:
        assert int(ck["_iter"]) == 10 and int(ck["_l_max"]) == 2
        assert data["xyz"].shape[0] == int(ck["alive"].sum()) > 0
        assert int(ck["alive"].sum()) != DATASET["n_points"]  # the density step at 5
    assert data["sh"].shape[1] == 3 * 8
    assert (out / "rendered_image_0.png").is_file()


def test_cli_resume_is_bit_equal(dataset, tmp_path):
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    cfg_whole = _write_config(tmp_path / "w.yaml", output_dir=str(whole))
    cfg_parts = _write_config(tmp_path / "p.yaml", output_dir=str(parts))
    assert _run_cli(cfg_whole, dataset, "--max-iters", "6") == 0
    assert _run_cli(cfg_parts, dataset, "--max-iters", "4") == 0
    with np.load(parts / "checkpoint.npz") as ck:
        assert int(ck["_iter"]) == 4
    assert _run_cli(cfg_parts, dataset, "--resume", str(parts / "checkpoint.npz"),
                    "--max-iters", "6") == 0
    with np.load(whole / "checkpoint.npz") as a, np.load(parts / "checkpoint.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert int(a["_iter"]) == 6
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (whole / "trained.ply").read_bytes() == (parts / "trained.ply").read_bytes()


def test_cli_flag_errors(capsys):
    assert cli.main(["cfg.yaml", "root", "--dp"], device="cpu") == 1
    assert "--dp needs a value" in capsys.readouterr().err
    assert cli.main(["--dp", "cfg.yaml", "root"], device="cpu") == 1
    assert "non-int" in capsys.readouterr().err
    assert cli.main(["--max-iters"], device="cpu") == 1
    assert cli.main(["cfg.yaml"], device="cpu") == 1
    assert "Usage:" in capsys.readouterr().err
    assert cli.main(["cfg.yaml", "root", "--dp", "2", "--tp", "2"], device="cpu") == 1
    err = capsys.readouterr().err
    assert "mutually exclusive" in err and "Usage:" in err


def _trainer(dataset, tmp_path, **cfg):
    conf = t_config.parse_config(_write_config(tmp_path / "c.yaml",
                                               output_dir=str(tmp_path / "out"), **cfg))
    cams, imgs, xyz, rgb = _read(t_colmap, dataset)
    return t_trainer.Trainer(conf, t_init.initialize_gaussians(xyz, rgb, conf), imgs, cams,
                             device="cpu")


def test_nonfinite_loss_mid_window_raises(dataset, tmp_path, monkeypatch):
    # The image of draw 1 (iteration 1) holds a NaN; iteration 2's loss is
    # finite again, and the boundary at 3 still sees the window's NaN.
    tr = _trainer(dataset, tmp_path, print_interval=3, adaptive_control_start=10**9)
    real = t_images.load_image
    calls = []

    def load(path):
        calls.append(path)
        img = real(path)
        if len(calls) == 2:
            img[0, 0, 0] = np.nan
        return img

    monkeypatch.setattr(t_images, "load_image", load)
    with pytest.raises(FloatingPointError, match=r"iterations \[1, 3\]"):
        tr.train(verbose=False)
    assert tr.iter == 3


def test_evaluate_and_skip_warning(dataset, tmp_path):
    tr = _trainer(dataset, tmp_path, test_split_ratio=2)
    assert [Path(im.name).name for im in tr.test_images] == ["view_000.png", "view_002.png"]
    psnr = tr.evaluate(verbose=False)
    assert psnr is not None and np.isfinite(psnr) and psnr > 0
    victim = tr.test_images[0].name
    os.rename(victim, victim + ".gone")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            again = tr.evaluate(verbose=False)
        assert any("skipped 1/2" in str(x.message) for x in w), [str(x.message) for x in w]
        assert np.isfinite(again)
    finally:
        os.rename(victim + ".gone", victim)


def test_no_silent_cpu_fallback(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_trainer.Trainer(
            t_config.parse_config(_write_config(tmp_path / "c.yaml", output_dir="x")),
            t_init.GaussianData(*(np.zeros(s, np.float32) for s in
                                  ((1, 3), (1, 3), (1,), (1, 3), (1, 4)))),
            {}, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(tmp_path / "c.yaml"), str(dataset)])
