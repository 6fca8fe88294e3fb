"""Port parity: per-Gaussian ops of ``gsplat_tpu_torch`` vs ``gsplat_tpu``.

Same numpy inputs through the JAX function and its PyTorch counterpart, at
f32. Tolerance: rtol 1e-5 plus an atol of 1e-6 times the output's largest
magnitude (both packages run the same op sequence; only transcendental
functions and matrix-product summation order may round differently).
No Pallas kernel is involved.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gsplat_tpu.ops import camera as j_camera  # noqa: E402
from gsplat_tpu.ops import covariance as j_cov  # noqa: E402
from gsplat_tpu.ops import loss as j_loss  # noqa: E402
from gsplat_tpu.ops import projection as j_proj  # noqa: E402
from gsplat_tpu.ops import sh as j_sh  # noqa: E402
from gsplat_tpu.train import state as j_state  # noqa: E402
from gsplat_tpu.train import step as j_step  # noqa: E402
from gsplat_tpu_torch.ops import camera as t_camera  # noqa: E402
from gsplat_tpu_torch.ops import covariance as t_cov  # noqa: E402
from gsplat_tpu_torch.ops import loss as t_loss  # noqa: E402
from gsplat_tpu_torch.ops import projection as t_proj  # noqa: E402
from gsplat_tpu_torch.ops import sh as t_sh  # noqa: E402
from gsplat_tpu_torch.train import state as t_state  # noqa: E402
from gsplat_tpu_torch.train import step as t_step  # noqa: E402

N = 512
W, H = 96, 64


def _close(got, ref, rtol=1e-5, atol_rel=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    atol = atol_rel * max(float(np.abs(ref[np.isfinite(ref)]).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def cam():
    qvec = np.array([0.98, 0.05, -0.12, 0.03])
    return j_camera.build_camera_matrices(
        qvec, np.array([0.2, -0.1, 0.5]), W, H, W * 0.85, W * 0.85
    )


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(11)
    xyz = (rng.normal(size=(N, 3)) * [2.0, 1.4, 2.5] + [0, 0, 4.0]).astype(np.float32)
    quat = rng.normal(size=(N, 4)).astype(np.float32)
    scale = np.log(rng.uniform(0.01, 0.5, (N, 3))).astype(np.float32)
    opacity = rng.uniform(-6.0, 4.0, N).astype(np.float32)
    dc = rng.normal(size=(N, 3)).astype(np.float32)
    sh = (0.3 * rng.normal(size=(N, 15, 3))).astype(np.float32)
    return dict(xyz=xyz, quat=quat, scale=scale, opacity=opacity, dc=dc, sh=sh)


def test_camera_matrices_equal(cam):
    ours = t_camera.build_camera_matrices(
        np.array([0.98, 0.05, -0.12, 0.03]), np.array([0.2, -0.1, 0.5]),
        W, H, W * 0.85, W * 0.85,
    )
    for f in dataclasses.fields(cam):
        np.testing.assert_array_equal(getattr(ours, f.name), getattr(cam, f.name))


@pytest.mark.parametrize("fn", ["world_to_camera", "project_to_screen",
                                "projection_jacobian", "frustum_cull_mask"])
def test_projection_matches_jax(cam, points, fn):
    xyz, view, proj = points["xyz"], cam.view, cam.proj
    j_c = j_proj.world_to_camera(jnp.asarray(xyz), jnp.asarray(view))
    t_c = t_proj.world_to_camera(_t(xyz), _t(view))
    if fn == "world_to_camera":
        _close(t_c, j_c)
        return
    # Downstream functions take the SAME camera points in both packages.
    xyz_c = np.asarray(j_c)
    j_uv = j_proj.project_to_screen(jnp.asarray(xyz_c), jnp.asarray(proj), W, H)
    t_uv = t_proj.project_to_screen(_t(xyz_c), _t(proj), W, H)
    if fn == "project_to_screen":
        _close(t_uv, j_uv)
    elif fn == "projection_jacobian":
        args = (cam.focal_x, cam.focal_y, cam.tan_fovx, cam.tan_fovy)
        _close(t_proj.projection_jacobian(_t(xyz_c), *args),
               j_proj.projection_jacobian(jnp.asarray(xyz_c), *args))
    else:
        uv = np.asarray(j_uv)
        j_m = j_proj.frustum_cull_mask(jnp.asarray(uv), jnp.asarray(xyz_c), 0.3, 10, W, H)
        t_m = t_proj.frustum_cull_mask(_t(uv), _t(xyz_c), 0.3, 10, W, H)
        np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m))
        assert 0 < int(t_m.sum()) < N  # both outcomes exercised


def test_sigma_from_quat_scale_matches_jax(points):
    _close(
        t_cov.sigma_from_quat_scale(_t(points["quat"]), _t(points["scale"])),
        j_cov.sigma_from_quat_scale(jnp.asarray(points["quat"]),
                                    jnp.asarray(points["scale"])),
    )


@pytest.mark.parametrize("with_opacity", [False, True])
def test_conic_and_radius_matches_jax(cam, points, with_opacity):
    xyz_c = np.asarray(j_proj.world_to_camera(jnp.asarray(points["xyz"]),
                                              jnp.asarray(cam.view)))
    jac = np.asarray(j_proj.projection_jacobian(
        jnp.asarray(xyz_c), cam.focal_x, cam.focal_y, cam.tan_fovx, cam.tan_fovy))
    sigma = np.asarray(j_cov.sigma_from_quat_scale(
        jnp.asarray(points["quat"]), jnp.asarray(points["scale"])))
    opa = points["opacity"] if with_opacity else None
    j_conic, j_rad = j_cov.conic_and_radius(
        jnp.asarray(sigma), jnp.asarray(jac), jnp.asarray(cam.view), 3.0,
        opacity_logit=None if opa is None else jnp.asarray(opa))
    t_conic, t_rad = t_cov.conic_and_radius(
        _t(sigma), _t(jac), _t(cam.view), 3.0,
        opacity_logit=None if opa is None else _t(opa))
    _close(t_conic, j_conic)
    j_rad = np.asarray(j_rad)
    assert t_rad.shape == (N, 5)
    # r_major, r_minor are ceil()ed integers: equal.
    np.testing.assert_array_equal(t_rad[:, :2].numpy(), j_rad[:, :2])
    for col in (2, 3, 4):  # sin, cos, ell_scale
        _close(t_rad[:, col], j_rad[:, col])


@pytest.mark.parametrize("l_max", [0, 1, 2, 3])
def test_sh_matches_jax(points, l_max):
    campos = np.array([0.3, -0.2, -1.0], np.float32)
    dirs = np.asarray(j_sh.view_dirs(jnp.asarray(points["xyz"]), jnp.asarray(campos)))
    _close(t_sh.view_dirs(_t(points["xyz"]), _t(campos)), dirs)
    _close(t_sh.sh_basis(_t(dirs), l_max), j_sh.sh_basis(jnp.asarray(dirs), l_max))
    _close(
        t_sh.sh_to_rgb(_t(points["xyz"]), _t(points["dc"]), _t(points["sh"]),
                       _t(campos), l_max),
        j_sh.sh_to_rgb(jnp.asarray(points["xyz"]), jnp.asarray(points["dc"]),
                       jnp.asarray(points["sh"]), jnp.asarray(campos), l_max),
    )


def test_psnr_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (16, 24, 3)).astype(np.float32)
    b = (a + 0.01 * rng.normal(size=a.shape)).astype(np.float32)
    _close(t_loss.compute_psnr(_t(a), _t(b)),
           j_loss.compute_psnr(jnp.asarray(a), jnp.asarray(b)))
    assert float(t_loss.compute_psnr(_t(a), _t(a))) == 100.0


@pytest.mark.parametrize("n", [1, 4096, 5000, 1 << 22, (1 << 22) + 1])
def test_round_capacity_matches_jax(n):
    assert t_state.round_capacity(n) == j_state.round_capacity(n)


def test_params_from_jax_roundtrip():
    assert t_state.PARAM_DIMS == j_state.PARAM_DIMS
    rng = np.random.default_rng(5)
    n = 40
    params = {
        name: rng.normal(size=t_state._param_shape(name, n)).astype(np.float32)
        for name in t_state.PARAM_DIMS
    }
    alive = rng.uniform(size=n) < 0.7
    gp = t_state.params_from_jax(params, alive, "cpu")
    assert isinstance(gp, torch.nn.Module) and gp.capacity == n
    assert {k for k, _ in gp.named_parameters()} == set(t_state.PARAM_DIMS)
    for name, arr in params.items():
        np.testing.assert_array_equal(getattr(gp, name).detach().numpy(), arr)
    np.testing.assert_array_equal(gp.alive.numpy(), alive)
    with pytest.raises(ValueError):
        t_state.params_from_jax({**params, "sh": params["sh"][:, :8]}, alive, "cpu")


def test_step_statics_fields_match_jax():
    dropped = {"pair_cap", "row_cap", "chunk", "interpret"}
    j_fields = {f.name for f in dataclasses.fields(j_step.StepStatics)}
    t_fields = {f.name for f in dataclasses.fields(t_step.StepStatics)}
    assert t_fields == j_fields - dropped
