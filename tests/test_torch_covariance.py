"""The per-Gaussian covariance's kernel wrapper on the CPU
(``kernels/covariance.py``; ``csrc/covariance.cu`` runs only on the card,
``tests/test_torch_cuda.py``): the backward kernel's plain version against
autograd through the plain ops, for plain 3DGS and Mip-Splatting, on rows
that include every edge (``chip_smoke.covariance_inputs``); the
``torch.autograd.Function`` with its two launches made on a stand-in
library; the CPU path of ``covariance`` and
``_geometry`` (the plain ops, no launch); the wrapper's argument checks."""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from gsplat_tpu_torch.kernels import _build
from gsplat_tpu_torch.kernels import covariance as kc

N = 3000
MODELS = ["3dgs", "mip"]


def _inputs(model, n=N, seed=0):
    return chip_smoke.covariance_inputs("cpu", n, seed=seed, mip=model == "mip")


def _args(inp):
    return (inp["xyz_c"], inp["quat"], inp["scale"], inp["opacity"], inp["view"])


def _autograd(inp):
    """The plain ops' gradients of (xyz_c, quat, scale), autograd through
    ``covariance_plain``, and its outputs."""
    leaves = [inp[k].clone().requires_grad_() for k in ("xyz_c", "quat", "scale")]
    conic, radius, opacity_scale = kc.covariance_plain(
        *leaves, inp["opacity"], inp["view"], mh_dist=3.0, filter_3d=inp["filter_3d"],
        **inp["kw"])
    outs, grads = [conic], [inp["g_conic"]]
    if opacity_scale is not None:
        outs.append(opacity_scale)
        grads.append(inp["g_opacity_scale"])
    return torch.autograd.grad(outs, leaves, grad_outputs=grads), (conic, radius, opacity_scale)


def _plain_backward(inp, g_conic=None):
    return kc.covariance_backward_plain(
        inp["g_conic"] if g_conic is None else g_conic, inp["g_opacity_scale"], inp["xyz_c"],
        inp["quat"], inp["scale"], inp["view"], filter_3d=inp["filter_3d"], **inp["kw"])


def _gap(got, want) -> float:
    """The worst leaf's distance from ``want``, over its norm."""
    for name, a, b in zip(("xyz_c", "quat", "scale"), got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
    return max(float((a.double() - b).norm() / b.norm()) for a, b in zip(got, want))


def _f64(inp):
    return {k: v.double() if isinstance(v, torch.Tensor) else v for k, v in inp.items()}


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("seed", [0, 3])
def test_backward_plain_matches_autograd(model, seed):
    """``covariance_backward_plain`` against autograd through the plain ops:
    in float64 the same gradients (to 1e-10: the algebra); in float32 no
    further from float64 autograd than 3x the plain ops' own float32 chain
    (flat Gaussians make the screen determinant cancel, so both stray by
    ~1e-5 of the norm). And the edge rows' conventions: the degenerate
    Jacobian gives xyz_c nothing, the clamped x/z and y/z pass no gradient
    to x and y, and under Mip-Splatting a determinant at its floor leaves
    the 2D factor out."""
    inp = _inputs(model, seed=seed)
    truth, (conic, radius, opacity_scale) = _autograd(_f64(inp))
    assert _gap(_plain_backward(_f64(inp)), truth) < 1e-10
    want = _autograd(inp)[0]
    got = _plain_backward(inp)
    assert _gap(got, truth) <= 3.0 * _gap(want, truth)
    g_xyz = got[0]
    assert (g_xyz[:2] == 0).all()  # |z| < 1e-6
    assert g_xyz[2, 0] == 0 and g_xyz[3, 1] == 0  # past 1.3 tan-fov
    assert not radius.requires_grad and radius[7, :2].eq(0).all()  # the cut radius is 0
    if model == "mip":
        assert (opacity_scale[8:10] == 0).all()  # det0 at its floor
        assert (want[2][8:10].abs() > 0).all()  # the conic still moves the scales


class _CovLib:
    """Stands in for the kernel library on CPU tensors, under
    csrc/covariance.cu's contract: the plain versions' outputs land in the
    buffers passed, the conic's gradient read at the strides passed; it
    keeps each call's model flag, constants and gradient strides."""

    def __init__(self, kw):
        self.kw, self.calls = kw, []

    @staticmethod
    def _read(ptr, shape):
        if ptr is None:
            return None
        count = int(np.prod(shape))
        return torch.from_numpy(
            np.frombuffer(ctypes.string_at(ptr, 4 * count), np.float32).reshape(shape).copy())

    @staticmethod
    def _write(ptr, t):
        a = np.ascontiguousarray(t.detach().numpy(), dtype=np.float32)
        ctypes.memmove(ptr, a.ctypes.data, a.nbytes)

    def _inputs(self, xyz_c, quat, scale, filter_3d, view, n):
        return (self._read(xyz_c, (n, 3)), self._read(quat, (n, 4)), self._read(scale, (n, 3)),
                self._read(filter_3d, (n,)), self._read(view, (4, 4)))

    def gs_covariance_forward(self, conic, radius, opacity_scale, xyz_c, quat, scale, opacity,
                              filter_3d, view, n, mip, *rest):
        self.calls.append(("forward", bool(mip), rest[:-1]))
        xyz, q, s, f, v = self._inputs(xyz_c, quat, scale, filter_3d, view, n)
        out = kc.covariance_plain(xyz, q, s, self._read(opacity, (n,)), v, mh_dist=rest[4],
                                  filter_3d=f, **self.kw)
        for ptr, t in zip((conic, radius, opacity_scale), out):
            if ptr is not None:
                self._write(ptr, t)
        return 0

    def gs_covariance_backward(self, gx, gq, gs, g, g_row, g_col, g_opacity_scale, xyz_c, quat,
                               scale, filter_3d, view, n, mip, *rest):
        self.calls.append(("backward", bool(mip), rest[:-1], (g_row, g_col)))
        flat = self._read(g, ((n - 1) * g_row + 2 * g_col + 1,)).numpy()
        g_conic = torch.from_numpy(np.lib.stride_tricks.as_strided(
            flat, (n, 3), (4 * g_row, 4 * g_col)).copy())
        xyz, q, s, f, v = self._inputs(xyz_c, quat, scale, filter_3d, view, n)
        out = kc.covariance_backward_plain(g_conic, self._read(g_opacity_scale, (n,)), xyz, q, s,
                                           v, filter_3d=f, **self.kw)
        for ptr, t in zip((gx, gq, gs), out):
            self._write(ptr, t)
        return 0


@pytest.mark.parametrize("model", MODELS)
def test_function_routes_kernel_buffers(model, monkeypatch):
    """The CUDA path's autograd Function over a stand-in library: one
    forward and one backward launch with the model's flag and the plain
    ops' constants, the conic's gradient passed as a strided view (columns
    2-4 of (N, 9) attribute rows), the radius record taking no gradient,
    and each output and gradient routed to its tensor (the plain versions'
    as the yardstick)."""
    inp = _inputs(model)
    mip = model == "mip"
    lib = _CovLib(inp["kw"])
    monkeypatch.setattr(_build, "build", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(_build, "launches", dict(_build.launches))
    leaves = [inp[k].clone().requires_grad_() for k in ("xyz_c", "quat", "scale")]
    consts = kc._consts(mh_dist=3.0, mip_model=mip, **inp["kw"])
    out = kc._Covariance.apply(*leaves, inp["opacity"], inp["filter_3d"], inp["view"], consts)
    assert len(out) == (3 if mip else 2) and not out[1].requires_grad
    plain = kc.covariance_plain(*_args(inp), mh_dist=3.0, filter_3d=inp["filter_3d"],
                                **inp["kw"])
    for a, b in zip(out, plain):
        assert torch.equal(a.detach(), b)
    grads = torch.autograd.grad(
        [out[0]] + list(out[2:]), leaves,
        grad_outputs=[inp["g_conic"]] + ([inp["g_opacity_scale"]] if mip else []))
    for a, b in zip(grads, _plain_backward(inp)):
        assert torch.equal(a, b)
    assert [c[:3] for c in lib.calls] == [("forward", mip, consts), ("backward", mip, consts)]
    assert lib.calls[1][3] == (9, 1)
    assert consts[5] == (0.1 if mip else 0.3)  # the screen dilation
    assert (_build.launches["covariance_forward"], _build.launches["covariance_backward"]) == (1, 1)


@pytest.mark.parametrize("model", MODELS)
def test_cpu_path_is_the_plain_ops(model):
    """On CPU tensors ``covariance`` and ``_geometry`` run the plain ops
    (the chain ``_geometry`` ran before the kernels), launching nothing."""
    from gsplat_tpu_torch.train import state as t_state
    from gsplat_tpu_torch.train import step as t_step

    inp = _inputs(model)
    before = dict(_build.launches)
    got = kc.covariance(*_args(inp), mh_dist=3.0, filter_3d=inp["filter_3d"], **inp["kw"])
    want = kc.covariance_plain(*_args(inp), mh_dist=3.0, filter_3d=inp["filter_3d"], **inp["kw"])
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)

    params, alive = chip_smoke.scene_arrays(2000, seed=0)
    cm = chip_smoke.views(160, 104)[1]
    st = chip_smoke.statics(cm, 160, 104)
    gp = t_state.params_from_jax(params, alive, "cpu")
    if model == "mip":
        st = t_step.mip_statics(st)
        t_state.with_filter_3d(gp)
        gp.filter_3d.copy_(torch.from_numpy(np.random.default_rng(1).uniform(
            0.0, 0.01, gp.capacity).astype(np.float32)))
    _, conic, _, _, radius, _, opacity_scale = t_step._geometry(gp, cm.view, cm.proj,
                                                                cm.campos, st)
    view = torch.as_tensor(cm.view, dtype=torch.float32)
    xyz_c = gp.xyz @ view[:3, :3].T + view[:3, 3]
    want = kc.covariance_plain(
        xyz_c, gp.quat, gp.scale, gp.opacity, view, focal_x=st.focal_x, focal_y=st.focal_y,
        tan_fovx=st.tan_fovx, tan_fovy=st.tan_fovy, mh_dist=st.mh_dist,
        filter_3d=gp.filter_3d if model == "mip" else None)
    for a, b in zip((conic, radius, opacity_scale), want):
        assert (a is None and b is None) or torch.equal(a, b)
    assert _build.launches == before


def _bad(case, inp):
    """``inp`` broken as ``case`` says, and the message expected."""
    n = inp["xyz_c"].shape[0]
    if case == "dtype":
        inp["quat"] = inp["quat"].double()
        return "quat must be float32"
    if case == "shape":
        inp["scale"] = inp["scale"][:, :2].contiguous()
        return "scale must be float32"
    if case == "contiguity":
        inp["xyz_c"] = torch.empty((n, 4))[:, :3].copy_(inp["xyz_c"])
        return "xyz_c must be contiguous"
    if case == "opacity shape":
        inp["opacity"] = inp["opacity"][:, None]
        return "opacity must be float32"
    if case == "filter_3d shape":
        inp["filter_3d"] = inp["filter_3d"][: n - 1]
        return "filter_3d must be float32"
    if case == "view shape":
        inp["view"] = inp["view"][:3]
        return "view must be float32"
    return None


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "opacity shape",
                                  "filter_3d shape", "view shape", "strided gradient"])
def test_argument_checks(case):
    """The wrapper refuses a wrong dtype, shape or layout of any input, on
    the CPU as on the card; the backward takes the conic's gradient at any
    strides (a column view of (N, 9) attribute rows) and gives what the
    contiguous gradient gives."""
    inp = _inputs("mip", n=64)
    message = _bad(case, inp)
    if message is None:
        g = inp["g_conic"]
        assert not g.is_contiguous()
        for a, b in zip(_plain_backward(inp), _plain_backward(inp, g.contiguous())):
            assert torch.equal(a, b)
        return
    with pytest.raises(ValueError, match=message):
        kc.covariance(*_args(inp), mh_dist=3.0, filter_3d=inp["filter_3d"], **inp["kw"])
