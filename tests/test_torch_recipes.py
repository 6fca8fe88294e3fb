"""Port parity: the four photo recipes (``tools/train_real_plane.py``,
``tools/quality_gate.py``, ``tools/overfit_real.py``,
``tools/extended_run.py``), on the CPU, on a seeded 96x64 texture written
as a PNG.

- Each recipe's config equals, field for field, the JAX script's: the
  ``dataclasses.replace`` keywords taken from the script by ``ast`` and
  applied to JAX's ``parse_config``; for ``overfit_real``, the start
  (the script's numpy draws) and its ``StepStatics`` keywords without
  ``pair_cap`` and ``chunk``.
- ``holdout`` leaves the JAX ``Trainer``'s split with its test views
  taken out of the train list, on the same dataset.
- ``gate`` reads only prior results of the same texture, and falls back
  to ``RESULT_SCALE_DENSE.json`` only for ``REFERENCE_PHOTO``.
- One shrunk run of each recipe (finite losses; the PSNR rises where the
  run is long enough to say so), ``quality_gate.main`` at a small iters
  (no artifact), the mains' arguments, and a missing ``--photo`` raising
  ``FileNotFoundError``.
"""

import ast
import dataclasses
import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import yaml  # noqa: E402

from gsplat_tpu import config as j_config  # noqa: E402
from gsplat_tpu.ops.camera import build_camera_matrices as j_build_camera  # noqa: E402
from gsplat_tpu.train import init as j_init  # noqa: E402
from gsplat_tpu.train import state as j_state  # noqa: E402
from gsplat_tpu.train import trainer as j_trainer  # noqa: E402
from gsplat_tpu_torch.tools import (  # noqa: E402
    extended_run, overfit_real, quality_gate, real_plane, train_real_plane,
)
from gsplat_tpu_torch.train import init as t_init  # noqa: E402
from gsplat_tpu_torch.train import trainer as t_trainer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TEX_W, TEX_H = 96, 64


@pytest.fixture
def two_threads():
    """Two intra-op threads: the test shares the host with the other test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def photo(tmp_path_factory):
    """A seeded 96x64 texture as a PNG: low-frequency noise, fine detail
    and a hard-edged square."""
    from PIL import Image as PILImage

    rng = np.random.default_rng(0)
    coarse = rng.uniform(size=(TEX_H // 8 + 1, TEX_W // 8 + 1, 3))
    tex = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:TEX_H, :TEX_W]
    tex = 0.8 * tex + 0.2 * rng.uniform(size=(TEX_H, TEX_W, 3))
    tex[20:40, 30:60] = [0.9, 0.1, 0.2]
    path = tmp_path_factory.mktemp("photo") / "photo.png"
    PILImage.fromarray((np.clip(tex, 0, 1) * 255).astype(np.uint8)).save(path)
    return path


def _script(name):
    return ast.parse((REPO / "scripts" / name).read_text())


def _eval(node, ns):
    return eval(compile(ast.Expression(node), "<script>", "eval"), ns)


def _replace_calls(tree):
    return [node for node in ast.walk(tree) if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute) and node.func.attr == "replace"]


def _function(tree, name):
    return next(node for node in ast.walk(tree)
                if isinstance(node, ast.FunctionDef) and node.name == name)


def _script_config(name, iters, thresh_mul, tmp_path, **ns):
    """The JAX script's config: ``parse_config(configs/base.yaml)`` through
    the script's two ``dataclasses.replace`` calls, its keywords evaluated
    as the script evaluates them."""
    tree = _script(name)
    base = yaml.safe_load((REPO / "configs" / "base.yaml").read_text())
    ns.update(iters=iters, thresh_mul=thresh_mul, base=base, frac=iters / base["num_iters"],
              scene=SimpleNamespace(name="scene"), root=tmp_path)
    exec(compile(ast.Module(body=[_function(tree, "s")], type_ignores=[]), name, "exec"), ns)
    first, second = _replace_calls(tree)
    cfg = dataclasses.replace(j_config.parse_config(REPO / "configs" / "base.yaml"),
                              **{k.arg: _eval(k.value, ns) for k in first.keywords})
    ns["cfg"] = cfg
    return dataclasses.replace(cfg, **{k.arg: _eval(k.value, ns) for k in second.keywords})


@pytest.mark.parametrize("iters", [7000, 3000, 123])
@pytest.mark.parametrize("name", ["train_real_plane", "quality_gate"])
def test_recipe_config_equal_script(name, iters, tmp_path):
    if name == "quality_gate":
        ref = _script_config("quality_gate.py", iters, None, tmp_path,
                             SEED=quality_gate.SEED, THRESH_MUL=quality_gate.THRESH_MUL)
        got = train_real_plane.recipe_config(iters, quality_gate.THRESH_MUL, "scene",
                                             tmp_path / "out", seed=quality_gate.SEED)
    else:
        ref = _script_config("train_real_plane.py", iters, 0.4, tmp_path)
        got = train_real_plane.recipe_config(iters, 0.4, "scene", tmp_path / "out")
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


@pytest.mark.parametrize("thresh_mul", [1.0, 0.4])
def test_extended_config_equal_script(thresh_mul, tmp_path):
    tree = _script("extended_run.py")
    (call,) = _replace_calls(tree)
    cfg = j_config.parse_config(REPO / "configs" / "extended.yaml")
    ns = dict(scene=SimpleNamespace(name="scene"), root=tmp_path, thresh_mul=thresh_mul,
              cfg=cfg)
    ref = dataclasses.replace(cfg, **{k.arg: _eval(k.value, ns) for k in call.keywords})
    got = extended_run.extended_config("scene", tmp_path / "out", thresh_mul)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.num_iters == 30000 and got.max_sh_band == 3


def test_overfit_start_and_statics_equal_script():
    """The script's module-level statements from its seed to its
    ``StepStatics``, run at a small photo with ``StepStatics`` and
    ``init_state`` stood in, against ``overfit_setup``."""
    tree = _script("overfit_real.py")
    stmts = tree.body
    first = stmts.index(next(s for s in stmts if isinstance(s, ast.Assign)
                             and getattr(s.targets[0], "id", None) == "rng"))
    last = stmts.index(next(s for s in stmts if isinstance(s, ast.Assign)
                            and getattr(s.targets[0], "id", None) == "st"))
    gt_np = np.random.default_rng(5).uniform(size=(40, 56, 3)).astype(np.float32)
    n, iters = 500, 77
    ns = dict(np=np, gt_np=gt_np, H=40, W=56, N=n, ITERS=iters,
              GaussianData=j_init.GaussianData, build_camera_matrices=j_build_camera,
              init_state=lambda g, n_cap: None, round_capacity=j_state.round_capacity,
              round_pair_cap=j_state.round_pair_cap, StepStatics=lambda **kw: kw)
    exec(compile(ast.Module(body=stmts[first:last + 1], type_ignores=[]), "overfit_real.py",
                 "exec"), ns)
    g, cm, st = overfit_real.overfit_setup(gt_np, n, iters)
    for f in ("xyz", "rgb", "opacity", "scale", "quaternion"):
        np.testing.assert_array_equal(getattr(g, f), getattr(ns["g"], f), err_msg=f)
    for f in ("view", "proj", "campos"):
        np.testing.assert_array_equal(getattr(cm, f), getattr(ns["cm"], f))
    want = {k: v for k, v in ns["st"].items() if k != "chunk"}
    assert dataclasses.asdict(st) == dict(want, row_cap=0)


def test_holdout_matches_jax_trainer(photo, tmp_path):
    """The port's split after ``holdout`` is the JAX ``Trainer``'s with
    its test views taken out of the train list, as the script does."""
    scene = real_plane.write_real_layers_dataset(tmp_path, photo_path=str(photo), n_views=17,
                                                 width=32, height=24, n_points=200)
    cfg = train_real_plane.recipe_config(123, 1.0, scene.name, tmp_path / "out")
    port = t_trainer.Trainer(cfg, t_init.initialize_gaussians(scene.points_xyz,
                                                              scene.points_rgb, cfg),
                             scene.images, scene.cameras, device="cpu")
    ref = j_trainer.Trainer(cfg, j_init.initialize_gaussians(scene.points_xyz,
                                                             scene.points_rgb, cfg),
                            scene.images, scene.cameras)
    test_names = {im.name for im in ref.test_images}
    ref.train_images = [im for im in ref.train_images if im.name not in test_names]
    train_real_plane.holdout(port)
    for attr in ("train_images", "test_images"):
        assert [im.name for im in getattr(port, attr)] == [
            im.name for im in getattr(ref, attr)]
    assert (len(port.train_images), len(port.test_images)) == (14, 3)


def _prior(out, rnd, psnr, sha):
    (out / f"RESULT_QUALITY_r{rnd:02d}.json").write_text(json.dumps(
        {"eval_psnr_db_heldout": psnr, "texture_sha256": sha}))


def test_gate_reads_priors_of_the_same_texture(photo, tmp_path, monkeypatch):
    sha = real_plane.photo_record(photo)["sha256"]
    result = dict(eval_psnr_db_heldout=20.0, texture_sha256=sha,
                  texture={"path": str(photo)})
    assert quality_gate.gate(result, tmp_path) == (True, 0.0, "none")
    assert quality_gate.next_round_slot(tmp_path) == 5
    _prior(tmp_path, 5, 30.0, "another texture")
    assert quality_gate.gate(result, tmp_path) == (True, 0.0, "none")
    _prior(tmp_path, 6, 20.2, sha)
    _prior(tmp_path, 7, 19.0, sha)
    assert quality_gate.gate(result, tmp_path) == (True, 20.2, "RESULT_QUALITY_r06.json")
    _prior(tmp_path, 8, 20.31, sha)
    assert quality_gate.gate(result, tmp_path) == (False, 20.31, "RESULT_QUALITY_r08.json")
    assert quality_gate.next_round_slot(tmp_path) == 9
    # The JAX package's dense run stands only for the reference photo.
    empty = tmp_path / "empty"
    empty.mkdir()
    dense = json.loads((REPO / "RESULT_SCALE_DENSE.json").read_text())["eval_psnr_db_heldout"]
    monkeypatch.setattr(real_plane, "REFERENCE_PHOTO", str(photo))
    assert quality_gate.gate(result, empty) == (False, dense, "RESULT_SCALE_DENSE.json")
    assert quality_gate.gate(dict(result, eval_psnr_db_heldout=dense - 0.25), empty)[0]


@pytest.fixture
def few_points(monkeypatch):
    """The layers writer's cloud cut from 6,000 points to 600, so that a
    shrunk run trains a few hundred Gaussians on the CPU."""
    import functools

    monkeypatch.setattr(real_plane, "write_real_layers_dataset", functools.partial(
        real_plane.write_real_layers_dataset, n_points=600))


@pytest.fixture
def recorded(monkeypatch):
    """Every train step's loss and the iteration of each opacity reset of
    the port's ``Trainer``."""
    rec = dict(losses=[], resets=[])
    real_get, real_reset = t_trainer.get_monitored_train_step, t_trainer.reset_opacity

    def get_step(st):
        real_step = real_get(st)

        def step(*args):
            state, m, monitor = real_step(*args)
            rec["losses"].append(float(m.loss))
            return state, m, monitor

        return step

    def reset(state, value):
        rec["resets"].append(len(rec["losses"]) - 1)
        return real_reset(state, value)

    monkeypatch.setattr(t_trainer, "get_monitored_train_step", get_step)
    monkeypatch.setattr(t_trainer, "reset_opacity", reset)
    return rec


def test_overfit_real_shrunk_raises_psnr(photo, two_threads):
    res = overfit_real.run(60, 300, photo=photo, device="cpu", log=lambda *a: None)
    assert (res["width"], res["height"], res["capacity"]) == (TEX_W, TEX_H, 4096)
    assert len(res["losses"]) == 60 and all(map(math.isfinite, res["losses"]))
    assert [r[0] for r in res["reports"]] == [0, 59] and res["reports"][0][3] > 0
    assert res["psnr_final"] > res["reports"][0][2] + 0.5
    assert res["texture_sha256"] == real_plane.photo_record(photo)["sha256"]
    assert res["peak_mib"] is None and res["ms_per_step"] > 0


def test_train_real_plane_layers_shrunk(photo, tmp_path, few_points, recorded, two_threads):
    """80 iterations of the scaled schedule: density steps at 20 and 40,
    the reset at 34, SH bands at 11, 22 and 33."""
    res = train_real_plane.run(80, 4, (96, 64), "layers", photo=photo, out=tmp_path,
                               device="cpu", log=lambda *a: None)
    assert len(recorded["losses"]) == 80 and all(map(math.isfinite, recorded["losses"]))
    assert [d["iteration"] for d in res["density"]] == [20, 40]
    assert recorded["resets"] == [34] and res["l_max"] == 3
    assert res["dataset"] == {"layout": "layers", "views": 4, "width": 96, "height": 64,
                              "train_views": 3, "held_out_test_views": 1}
    assert res["test_views"] == ["view_000.png"] and "view_000.png" not in res["train_views"]
    assert res["capacities"][0] == 4096 and res["final_gaussians"] > 0
    assert all((d["capacity_after"] > d["capacity_before"]) == (
        d["new_total"] > d["capacity_before"]) for d in res["density"])
    assert res["eval_psnr_db_heldout"] > res["eval_psnr_db_heldout_init"]
    assert res["schedule"]["adaptive_control"] == [5, 57, 20]
    assert res["texture"]["width"] == TEX_W and res["device"] == "cpu"
    json.dumps(res)


def test_quality_gate_main_small_iters(photo, tmp_path, few_points, recorded, monkeypatch,
                                       capsys, two_threads):
    monkeypatch.setattr(quality_gate, "VIEWS", 4)
    monkeypatch.setattr(quality_gate, "W", 96)
    monkeypatch.setattr(quality_gate, "H", 64)
    assert quality_gate.main(["7", "40", "--photo", str(photo), "--out", str(tmp_path)],
                             device="cpu") == 0
    assert not list(tmp_path.glob("RESULT_QUALITY_r*.json"))
    out = capsys.readouterr().out
    res = json.loads(next(line for line in out.splitlines() if line.startswith("{")))
    assert res["recipe"]["num_iters"] == 40 and res["recipe"]["seed"] == 0
    assert res["gate_ok"] and res["prior_best_source"] == "none"
    assert len(recorded["losses"]) == 40 and all(map(math.isfinite, recorded["losses"]))
    assert "QUALITY GATE OK" in out


def test_extended_run_shrunk(photo, tmp_path, few_points, recorded, two_threads):
    res = extended_run.run((96, 64), 4, photo=photo, out=tmp_path, device="cpu",
                           max_iters=40, log=lambda *a: None)
    assert res["iterations"] == 40 and res["num_iters"] == 30000
    assert len(recorded["losses"]) == 40 and all(map(math.isfinite, recorded["losses"]))
    assert res["density"] == [] and recorded["resets"] == [] and res["l_max"] == 0
    assert math.isfinite(res["eval_psnr_db_heldout"])


@pytest.mark.parametrize("tool,argv,want", [
    (train_real_plane, ["12", "5", "32x24", "layers", "0.5"],
     ((12, 5, (32, 24), "layers", 0.5), "RESULT_SCALE.json")),
    (train_real_plane, [], ((3000, 24, (648, 420), "plane", 1.0), "RESULT_SCALE.json")),
    (extended_run, ["32x24", "5", "0.5"], (((32, 24), 5, 0.5), "RESULT_EXTENDED.json")),
    (extended_run, [], (((648, 420), 32, 1.0), "RESULT_EXTENDED.json")),
])
def test_main_arguments(tool, argv, want, monkeypatch, tmp_path, capsys):
    seen = []

    def fake_run(*args, photo, out, device, verbose):
        seen.append((args, photo, Path(out), device))
        return dict(train_seconds=1.0, iters_per_second=1.0, final_gaussians=1,
                    eval_psnr_db_heldout=1.0)

    monkeypatch.setattr(tool, "run", fake_run)
    assert tool.main(argv + ["--photo", "p.png", "--out", str(tmp_path)], device="cpu") == 0
    args, result = want
    assert seen == [(args, "p.png", tmp_path, "cpu")]
    assert json.loads((tmp_path / result).read_text())["final_gaussians"] == 1
    assert tool.main(argv, device="cpu") == 0
    assert seen[1][1] == real_plane.REFERENCE_PHOTO and not seen[1][2].exists()


@pytest.mark.parametrize("tool", [train_real_plane, quality_gate, overfit_real, extended_run])
def test_missing_photo_raises(tool, tmp_path):
    missing = tmp_path / "no_such_photo.jpg"
    with pytest.raises(FileNotFoundError, match="no_such_photo.jpg"):
        tool.main(["--photo", str(missing), "--out", str(tmp_path / "out")], device="cpu")
