"""Port parity: per-Gaussian ops of ``gsplat_tpu_torch`` vs ``gsplat_tpu``.

Same numpy inputs through the JAX function and its PyTorch counterpart, at
f32. Tolerance: rtol 1e-5 plus an atol of 1e-6 times the output's largest
magnitude (both packages run the same op sequence; only transcendental
functions and matrix-product summation order may round differently).
No Pallas kernel is involved.
"""

import ctypes
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
from gsplat_tpu_torch.kernels import _build  # noqa: E402
from gsplat_tpu_torch.kernels import sh as k_sh  # noqa: E402
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


@pytest.mark.parametrize("l_max", [0, 1, 2, 3])
def test_sh_wrapper_on_cpu_matches_jax(points, l_max):
    # kernels/sh.py on CPU tensors is ops/sh.py's function, launching nothing.
    campos = np.array([0.3, -0.2, -1.0], np.float32)
    args = (_t(points["xyz"]), _t(points["dc"]), _t(points["sh"]), _t(campos), l_max)
    before = dict(_build.launches)
    got = k_sh.sh_to_rgb(*args)
    assert _build.launches == before
    assert torch.equal(got, t_sh.sh_to_rgb(*args))
    _close(got, j_sh.sh_to_rgb(jnp.asarray(points["xyz"]), jnp.asarray(points["dc"]),
                               jnp.asarray(points["sh"]), jnp.asarray(campos), l_max))


def _sh_autograd(points, campos, g, l_max, dtype):
    """Autograd through ops/sh.py: (grad_xyz, grad_dc, grad_sh), zeros where
    a leaf is unused (as probed_grads fills them)."""
    leaves = [torch.from_numpy(points[k]).to(dtype).requires_grad_() for k in ("xyz", "dc", "sh")]
    rgb = t_sh.sh_to_rgb(*leaves, campos, l_max)
    got = torch.autograd.grad(rgb, leaves, grad_outputs=g, allow_unused=True)
    return [torch.zeros_like(x) if d is None else d for x, d in zip(leaves, got)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("l_max", [0, 1, 2, 3])
def test_sh_backward_plain_equals_autograd(points, l_max, dtype):
    # The backward kernel's maths in plain PyTorch (grad_d through the
    # basis' derivatives, then through the normalisation) against autograd
    # through the forward, zeros past l_max included. f64: the formulas to
    # 1e-12; f32: another order of the same sums, rtol 1e-5 and 1e-6 of each
    # gradient's largest value, as every parity test here.
    campos = torch.tensor([0.3, -0.2, -1.0], dtype=dtype)
    g = torch.from_numpy(np.random.default_rng(l_max).normal(size=(N, 3))).to(dtype)
    want = _sh_autograd(points, campos, g, l_max, dtype)
    got = k_sh.sh_to_rgb_backward_plain(
        g, torch.from_numpy(points["xyz"]).to(dtype), torch.from_numpy(points["sh"]).to(dtype),
        campos, l_max)
    k = t_sh.num_sh_coeffs(l_max)
    for name, a, b in zip(("xyz", "dc", "sh"), got, want):
        assert a.shape == b.shape and a.dtype == dtype, name
        if dtype == torch.float64:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
        else:
            _close(a, b)
    assert (got[2][:, k - 1:] == 0).all()
    assert (got[0] == 0).all() == (l_max == 0)


class _ShLib:
    """Stands in for the kernel library on CPU tensors, under csrc/sh.cu's
    contract: the forward's colours and the backward's three gradients land
    in the buffers passed, ``g`` read at the strides passed."""

    def __init__(self):
        self.g_strides = []

    @staticmethod
    def _read(ptr, shape):
        count = int(np.prod(shape))
        return torch.from_numpy(
            np.frombuffer(ctypes.string_at(ptr, 4 * count), np.float32).reshape(shape).copy())

    @staticmethod
    def _write(ptr, t):
        a = np.ascontiguousarray(t.detach().numpy(), dtype=np.float32)
        ctypes.memmove(ptr, a.ctypes.data, a.nbytes)

    def gs_sh_forward(self, rgb, xyz, dc, sh, campos, n, l_max, stream):
        self._write(rgb, t_sh.sh_to_rgb(self._read(xyz, (n, 3)), self._read(dc, (n, 3)),
                                        self._read(sh, (n, 15, 3)), self._read(campos, (3,)),
                                        l_max))
        return 0

    def gs_sh_backward(self, gx, gd, gs, g, g_row, g_col, xyz, sh, campos, n, l_max, stream):
        self.g_strides.append((g_row, g_col))
        flat = self._read(g, ((n - 1) * g_row + 2 * g_col + 1,)).numpy()
        gg = torch.from_numpy(np.lib.stride_tricks.as_strided(
            flat, (n, 3), (4 * g_row, 4 * g_col)).copy())
        out = k_sh.sh_to_rgb_backward_plain(gg, self._read(xyz, (n, 3)),
                                            self._read(sh, (n, 15, 3)),
                                            self._read(campos, (3,)), l_max)
        for ptr, t in zip((gx, gd, gs), out):
            self._write(ptr, t)
        return 0


@pytest.mark.parametrize("l_max", [0, 3])
def test_sh_function_routes_kernel_buffers(points, monkeypatch, l_max):
    # The CUDA path's autograd.Function over a stand-in library: one forward
    # and one backward launch, the colour gradient passed as a strided view
    # (the r g b columns of (N, 9) attribute rows), and each gradient
    # routed to its leaf (autograd's through ops/sh.py as the yardstick).
    lib = _ShLib()
    monkeypatch.setattr(_build, "build", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(_build, "launches", dict(_build.launches))
    campos = torch.tensor([0.3, -0.2, -1.0])
    leaves = [_t(points[k]).requires_grad_() for k in ("xyz", "dc", "sh")]
    rgb = k_sh._ShToRgb.apply(*leaves, campos, l_max)
    assert torch.equal(rgb, t_sh.sh_to_rgb(*[x.detach() for x in leaves], campos, l_max))
    w = torch.from_numpy(np.random.default_rng(7).normal(size=(N, 9)).astype(np.float32))
    rows = torch.cat([torch.ones((N, 6)), rgb], dim=1)  # [u v c00 c01 c11 opa r g b]
    got = torch.autograd.grad((rows * w).sum(), leaves)
    assert lib.g_strides == [(9, 1)]
    assert (_build.launches["sh_forward"], _build.launches["sh_backward"]) == (1, 1)
    want = k_sh.sh_to_rgb_backward_plain(w[:, 6:], *[x.detach() for x in leaves[::2]],
                                         campos, l_max)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["dtype", "sh shape", "rows", "campos", "strided", "l_max"])
def test_sh_wrapper_rejects_bad_arguments(points, case):
    args = dict(xyz=_t(points["xyz"]), dc=_t(points["dc"]), sh=_t(points["sh"]),
                campos=torch.tensor([0.3, -0.2, -1.0]), l_max=3)
    if case == "dtype":
        args["dc"] = args["dc"].double()
    elif case == "sh shape":
        args["sh"] = args["sh"][:, :8]
    elif case == "rows":
        args["xyz"] = args["xyz"][:-1]
    elif case == "campos":
        args["campos"] = args["campos"][None]
    elif case == "strided":
        args["xyz"] = torch.cat([args["xyz"]] * 2, dim=1)[:, ::2]
    else:
        args["l_max"] = 4
    with pytest.raises(ValueError, match="sh_to_rgb"):
        k_sh.sh_to_rgb(**args)


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
    dropped = {"chunk", "interpret"}
    j_fields = {f.name for f in dataclasses.fields(j_step.StepStatics)}
    t_fields = {f.name for f in dataclasses.fields(t_step.StepStatics)}
    assert t_fields == j_fields - dropped
