"""Port parity: the whole forward render slice vs the JAX package.

One scene of 300 Gaussians at 64x48, SH degree 3 with random coefficients,
made with numpy and loaded into the port through ``params_from_jax``:

- the port's ``render_image`` (plain kernel versions on the CPU), bound
  to exact mode (``train.step.exact_mode``), against
  the JAX exact path built from its public pieces (``_per_gaussian`` ->
  ``build_tile_tables(bf16_colors=False)`` -> ``rasterize``, Pallas in
  interpret mode): image rtol 2e-4 / atol 2e-5, equal tile tables,
  T_final rtol 1e-3, n_splats exact;
- the port's exact image against the JAX default (packed bf16/f16)
  ``render_image``: atol 0.03 and PSNR > 45 dB, the bounds of
  tests/test_render.py's packed-vs-exact test (the port's packed mode is
  held to it in tests/test_torch_packed.py);
- importing the port leaves ``jax``, ``gsplat_tpu``, ``yaml`` and ``PIL``
  unloaded.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from gsplat_tpu_torch.train.step import exact_mode  # noqa: E402

from gsplat_tpu.ops.binning import build_tile_tables as j_build_tile_tables  # noqa: E402
from gsplat_tpu.ops.camera import build_camera_matrices  # noqa: E402
from gsplat_tpu.ops.render import pack_attrs as j_pack_attrs  # noqa: E402
from gsplat_tpu.ops.render import rasterize as j_rasterize  # noqa: E402
from gsplat_tpu.train import step as j_step  # noqa: E402
from gsplat_tpu_torch.ops.loss import compute_psnr  # noqa: E402
from gsplat_tpu_torch.ops.render import rasterize  # noqa: E402
from gsplat_tpu_torch.train import step as t_step  # noqa: E402
from gsplat_tpu_torch.train.state import params_from_jax  # noqa: E402

W, H, N = 64, 48, 300
BG = 0.2
PAIR_CAP = 8192
REPO = os.path.join(os.path.dirname(__file__), "..")

COMMON = dict(
    width=W, height=H, tile=16, l_max=3, near_thresh=0.3, mh_dist=3.0,
    cull_padding=100, ssim_frac=0.2, base_lr=1e-3, xyz_lr_init=0.16,
    xyz_lr_final=0.0016, quat_lr=1.0, scale_lr=5.0, opacity_lr=25.0,
    rgb_lr=2.5, sh_lr=0.125, scene_extent=4.0, num_iters=7000,
)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    params = dict(
        xyz=(rng.normal(size=(N, 3)) * [1.0, 0.7, 0.6] + [0, 0, 4.0]).astype(np.float32),
        rgb=rng.normal(size=(N, 3)).astype(np.float32),
        opacity=rng.uniform(-1.0, 2.0, N).astype(np.float32),
        scale=np.log(rng.uniform(0.02, 0.15, (N, 3))).astype(np.float32),
        quat=np.concatenate(
            [np.ones((N, 1)), 0.3 * rng.normal(size=(N, 3))], axis=1
        ).astype(np.float32),
        sh=(0.1 * rng.normal(size=(N, 15, 3))).astype(np.float32),
    )
    alive = np.ones(N, bool)
    alive[::17] = False
    cm = build_camera_matrices(
        np.array([0.999, 0.02, -0.03, 0.01]), np.array([0.05, -0.02, 0.1]),
        W, H, W * 0.85, W * 0.85,
    )
    intr = dict(focal_x=cm.focal_x, focal_y=cm.focal_y, tan_fovx=cm.tan_fovx,
                tan_fovy=cm.tan_fovy)
    j_st = j_step.StepStatics(chunk=128, pair_cap=PAIR_CAP, interpret=True,
                              **COMMON, **intr)
    t_st = t_step.StepStatics(**COMMON, **intr)
    return params, alive, cm, j_st, t_st


@pytest.fixture(scope="module")
def jax_exact(scene):
    params, alive, cm, j_st, _ = scene
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    uv, conic, rgb, mask, radius, z = j_step._per_gaussian(
        jp, jnp.asarray(alive), jnp.asarray(cm.view), jnp.asarray(cm.proj),
        jnp.asarray(cm.campos), j_st,
    )
    tables = j_build_tile_tables(
        uv, z, radius, mask, attrs=j_pack_attrs(uv, conic, rgb, jp["opacity"]),
        num_tiles_x=j_st.num_tiles_x, num_tiles_y=j_st.num_tiles_y, tile_size=16,
        pair_cap=PAIR_CAP, chunk_size=128, bf16_colors=False, interpret=True,
    )
    out = j_rasterize(
        uv, conic, rgb, jp["opacity"], tables, jnp.float32(BG),
        width=W, height=H, tile=16, chunk=128, interpret=True,
    )
    return out, tables


@pytest.fixture(scope="module")
def port(scene):
    params, alive, cm, _, t_st = scene
    gp = params_from_jax(params, alive, "cpu")
    with exact_mode():
        image, tables = t_step.render_image(gp, cm.view, cm.proj, cm.campos, BG, t_st)
    assert not tables.bf16_colors
    return gp, image, tables


def test_render_image_matches_jax_exact_path(jax_exact, port):
    j_out, j_tables = jax_exact
    _, image, tables = port
    assert image.shape == (H, W, 3) and image.dtype == torch.float32
    assert tables.num_pairs == int(j_tables.num_pairs) > 200
    np.testing.assert_array_equal(tables.tile_start.numpy(), np.asarray(j_tables.tile_start))
    np.testing.assert_array_equal(tables.tile_count.numpy(), np.asarray(j_tables.tile_count))
    np.testing.assert_array_equal(
        tables.splat_gid.numpy(), np.asarray(j_tables.splat_gid)[: tables.num_pairs]
    )
    np.testing.assert_allclose(image.numpy(), np.asarray(j_out.image),
                               rtol=2e-4, atol=2e-5)


def test_rasterize_bookkeeping_matches_jax(scene, jax_exact, port):
    """T_final and n_splats of the port's rasterize op on the same tables."""
    params, _, cm, _, t_st = scene
    j_out, _ = jax_exact
    gp, _, tables = port
    with torch.no_grad():
        view, proj, campos = (torch.from_numpy(x) for x in (cm.view, cm.proj, cm.campos))
        uv, conic, rgb, _, _, _ = t_step._per_gaussian(gp, view, proj, campos, t_st)
        out = rasterize(uv, conic, rgb, gp.opacity, tables, BG, width=W, height=H, tile=16)
    assert out.t_final.shape == tuple(j_out.t_final.shape)
    # Chunked T products in both; the chunk widths differ (64 vs 128).
    np.testing.assert_allclose(out.t_final.numpy(), np.asarray(j_out.t_final),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_array_equal(out.n_splats.numpy(), np.asarray(j_out.n_splats))


def test_render_image_close_to_jax_packed_default(scene, port):
    params, alive, cm, j_st, _ = scene
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    j_img, _ = j_step.render_image(
        jp, jnp.asarray(alive), jnp.asarray(cm.view), jnp.asarray(cm.proj),
        jnp.asarray(cm.campos), jnp.float32(BG), j_st,
    )
    _, image, _ = port
    j_img = np.array(j_img)
    assert np.isfinite(image.numpy()).all()
    np.testing.assert_allclose(image.numpy(), j_img, atol=0.03)
    psnr = float(compute_psnr(image, torch.from_numpy(j_img)))
    assert psnr > 45.0, f"port-vs-packed PSNR {psnr:.1f} dB"


def test_import_pulls_in_no_jax_gsplat_tpu_or_yaml():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gsplat_tpu_torch\n"
        "for m in pkgutil.walk_packages(gsplat_tpu_torch.__path__, 'gsplat_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in"
        " ('jax', 'jaxlib', 'gsplat_tpu', 'yaml', 'PIL'))\n"
        "print(len([k for k in sys.modules if k.startswith('gsplat_tpu_torch.')]))\n"
        "assert not bad, bad\n"
        "from gsplat_tpu_torch.io import native\n"
        "from gsplat_tpu_torch.kernels import _build\n"
        "assert native._loaded is None and _build._lib is None  # nothing built at import\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 49  # every module was imported
