"""What a benchmark run loads: never ``jax``, ``jaxlib``, ``flax`` or
``gsplat_tpu`` (compared by whole top-level name: ``gsplat_tpu_torch``
starts with ``gsplat_tpu``), and the reference loads nothing of
``gsplat_tpu_torch``."""

import ast
import subprocess
import sys

from tiny import ROOT

BLOCK = """
import sys
class Block:
    def __init__(self, names): self.names = names
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block(set(sys.argv[1].split(","))))
sys.path.insert(0, sys.argv[2])
"""


def _python(code: str, blocked: str, tmp_path) -> str:
    proc = subprocess.run([sys.executable, "-c", BLOCK + code, blocked, str(ROOT), str(tmp_path)],
                          capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_a_run_loads_no_jax(tmp_path):
    code = """
import pathlib, json, torch
torch.set_num_threads(2)
sys.path.insert(0, sys.argv[2] + "/gsbench/tests")
from tiny import tiny_root
from gsbench import run
root = tiny_root(pathlib.Path(sys.argv[3]))
line = run.run("render.garden-ds4-1m", 3, 0.2, False, device="cpu", root=root)
assert line["correct"], line
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
print(run.jax_loaded())
"""
    out = _python(code, "jax,jaxlib,flax,gsplat_tpu", tmp_path).splitlines()
    assert out[-1] == "[]"
    assert "gsplat_tpu_torch" in out[-2]  # the program ran, by its whole name


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    code = """
import torch
from gsbench.reference import binning, camera, gaussians, init, loss, packing, raster, step
from gsbench import scene
import json
from gsbench import harness
cam = scene.cameras(scene.training_angles(8), 64, 48, 54.4)[0]
cfg = json.load(open(sys.argv[2] + "/gsbench/configs/garden-ds4-1m.json"))
st = harness.ref_statics(cfg, cam, 3, 1.65)
p, alive = scene.gaussians(500, 1, torch.device("cpu"))
s = step.State.fresh(p, alive)
t = lambda x: torch.as_tensor(x)
img = step.render(p, alive, t(cam.view), t(cam.proj), t(cam.campos), 0.0, st)
step.train_step(s, t(cam.view), t(cam.proj), t(cam.campos), img, 0.5, 3001, st)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("gsplat_tpu_torch", "gsplat_tpu", "jax")))
"""
    out = _python(code, "jax,jaxlib,flax,gsplat_tpu,gsplat_tpu_torch", tmp_path)
    assert out.splitlines()[-1] == "[]"
    for path in (ROOT / "gsbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("gsplat_tpu_torch", "gsplat_tpu", "jax")
                           for n in names), (path, names)
