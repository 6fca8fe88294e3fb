"""Port parity: the packed mode, the JAX package's default, on the scenes of
tests/test_torch_render.py (64x48) and tests/test_torch_train.py (64x40).

- The pairs' attributes as the port's rasterizers round them
  (``packing.round_pair_attrs``) equal, bit for bit, the JAX packed
  stream that binning builds, decoded as its kernels decode it.
- Forward: the port's default ``render_image`` against the JAX packed
  render with the TPU's MXU arithmetic turned off (``MXU_COLOR_FWD``,
  ``MXU_POWER_FWD``, ``MXU_SCAN_FWD``): equal pairs and n_splats, and an
  image at least 10x closer to it than the JAX packed image is to the JAX
  exact one; and against the unpatched JAX default at the bounds of
  tests/test_render.py's packed-vs-exact test (atol 0.03, PSNR > 45 dB).
- Backward: the port's default ``rasterize`` gradients against ``jax.vjp``
  of the JAX packed ``rasterize`` on the same per-Gaussian values: each
  column within 0.05 of its largest |value| (tests/test_render.py's
  bound), and, relative to each column's largest |value|, no farther from
  it than the JAX packed gradients are from the JAX exact ones; in rms,
  closer to them in every column than exact-mode gradients are.
- Words: the plain backward's packed words (``bf16_colors=True``,
  ``bf16_grads=True``) are ``pack_grad_rows`` of its float32 rows, the
  port's and the JAX package's, bit for bit.
- The packed segment sum against JAX's ``segment_sum_by_gid`` on the same
  int32 words (interpret mode).
- Train step: one and three default ``train_step``s against the JAX
  package's default (packed, MXU on) jitted ``train_step``.
- ``render_image``, ``train_step`` and the ``Trainer`` run the packed mode
  when given no flags (``dp_train_step`` and ``tp_train_step``: see
  tests/test_torch_parallel.py); under ``exact_mode``, ``render_image``,
  ``train_step`` and ``tp_train_step`` (a one-rank gloo group) make only
  exact rasterizer calls, and the mode is packed again after a block
  that raised.

The reference's packed kernels evaluate colour sums, the backward's pixel
moments and suffix sums as bf16 matrix products on the TPU's MXU; the port
sums in float32 after rounding the inputs, then packs. The bounds below
say how far that takes the two apart.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from gsplat_tpu_torch.train.step import exact_mode  # noqa: E402
from test_torch_backward import _runs  # noqa: E402

from gsplat_tpu.kernels import rasterize as j_kr  # noqa: E402
from gsplat_tpu.kernels.segsum import segment_sum_by_gid  # noqa: E402
from gsplat_tpu.ops.binning import build_tile_tables as j_build_tile_tables  # noqa: E402
from gsplat_tpu.ops.camera import build_camera_matrices  # noqa: E402
from gsplat_tpu.ops.render import pack_attrs as j_pack_attrs  # noqa: E402
from gsplat_tpu.ops.render import rasterize as j_rasterize  # noqa: E402
from gsplat_tpu.train import state as j_state  # noqa: E402
from gsplat_tpu.train import step as j_step  # noqa: E402
from gsplat_tpu_torch.kernels import packing  # noqa: E402
from gsplat_tpu_torch.kernels.rasterize import (  # noqa: E402
    rasterize_backward, rasterize_forward)
from gsplat_tpu_torch.kernels.segsum import segment_sum, segment_sum_plain  # noqa: E402
from gsplat_tpu_torch.ops import render as t_render  # noqa: E402
from gsplat_tpu_torch.ops.binning import build_tile_tables  # noqa: E402
from gsplat_tpu_torch.ops.loss import compute_psnr  # noqa: E402
from gsplat_tpu_torch.ops.render import pack_attrs, rasterize  # noqa: E402
from gsplat_tpu_torch.train import state as t_state  # noqa: E402
from gsplat_tpu_torch.train import step as t_step  # noqa: E402

BG = 0.2
PAIR_CAP = 8192
COMMON = dict(
    tile=16, l_max=3, near_thresh=0.3, mh_dist=3.0, cull_padding=100, ssim_frac=0.2,
    base_lr=1e-3, xyz_lr_init=0.16, xyz_lr_final=0.0016, quat_lr=1.0, scale_lr=5.0,
    opacity_lr=25.0, rgb_lr=2.5, sh_lr=0.125, scene_extent=4.0, num_iters=7000,
)  # tests/test_torch_render.py's and tests/test_torch_train.py's
NAMES = list(t_state.PARAM_DIMS)
MXU_FLAGS = ("MXU_COLOR_FWD", "MXU_POWER_FWD", "MXU_SCAN_FWD")


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(width, height, n, n_cap):
    """tests/test_torch_render.py's (n_cap = n) and tests/test_torch_train.py's
    scene recipe: seed 7, every 17th Gaussian dead, capacity rows zero."""
    rng = np.random.default_rng(7)
    params = dict(
        xyz=rng.normal(size=(n, 3)) * [1.0, 0.7, 0.6] + [0, 0, 4.0],
        rgb=rng.normal(size=(n, 3)), opacity=rng.uniform(-1.0, 2.0, n),
        scale=np.log(rng.uniform(0.02, 0.15, (n, 3))),
        quat=np.concatenate([np.ones((n, 1)), 0.3 * rng.normal(size=(n, 3))], axis=1),
        sh=0.1 * rng.normal(size=(n, 15, 3)),
    )
    params = {k: np.concatenate([v, np.zeros((n_cap - n,) + v.shape[1:])]).astype(np.float32)
              for k, v in params.items()}
    alive = np.arange(n_cap) < n
    alive[::17] = False
    cm = build_camera_matrices(np.array([0.999, 0.02, -0.03, 0.01]),
                               np.array([0.05, -0.02, 0.1]), width, height,
                               width * 0.85, width * 0.85)
    intr = dict(width=width, height=height, focal_x=cm.focal_x, focal_y=cm.focal_y,
                tan_fovx=cm.tan_fovx, tan_fovy=cm.tan_fovy)
    j_st = j_step.StepStatics(chunk=128, pair_cap=PAIR_CAP, interpret=True, **COMMON, **intr)
    t_st = t_step.StepStatics(**COMMON, **intr)
    return params, alive, cm, j_st, t_st, rng


# ------------------------------------------------------------ render scene


@pytest.fixture(scope="module")
def render_scene():
    params, alive, cm, j_st, t_st, _ = _scene(64, 48, 300, 300)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    per_g = j_step._per_gaussian(jp, jnp.asarray(alive), jnp.asarray(cm.view),
                                 jnp.asarray(cm.proj), jnp.asarray(cm.campos), j_st)
    uv, conic, rgb, mask, radius, z = (np.asarray(x) for x in per_g)
    cot = np.random.default_rng(3).normal(size=(48, 64, 3)).astype(np.float32)
    return dict(params=params, alive=alive, cm=cm, j_st=j_st, t_st=t_st, uv=uv, conic=conic,
                rgb=rgb, mask=mask, radius=radius, z=z, opacity=params["opacity"], cot=cot)


def _jax_rasterize(s, packed):
    """JAX tables and ``jax.vjp`` of its rasterize in one mode: (tables,
    image, n_splats, gradients wrt uv, conic, rgb, opacity)."""
    args = [jnp.asarray(s[k]) for k in ("uv", "conic", "rgb", "opacity")]
    tables = j_build_tile_tables(
        args[0], jnp.asarray(s["z"]), jnp.asarray(s["radius"]), jnp.asarray(s["mask"]),
        attrs=j_pack_attrs(*args[:3], args[3]), num_tiles_x=4, num_tiles_y=3, tile_size=16,
        pair_cap=PAIR_CAP, chunk_size=128, bf16_colors=packed, interpret=True)

    def f(uv, conic, rgb, opa):
        out = j_rasterize(uv, conic, rgb, opa, tables, jnp.float32(BG), width=64, height=48,
                          tile=16, chunk=128, interpret=True, bf16_grads=packed)
        return out.image, out.n_splats

    image, vjp, n_splats = jax.vjp(f, *args, has_aux=True)
    grads = vjp(jnp.asarray(s["cot"]))
    return tables, np.asarray(image), np.asarray(n_splats), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def jax_packed(render_scene):
    return _jax_rasterize(render_scene, True)


@pytest.fixture(scope="module")
def jax_exact(render_scene):
    return _jax_rasterize(render_scene, False)


@pytest.fixture(scope="module")
def jax_packed_no_mxu(render_scene, jax_packed):
    """The JAX packed forward on the same tables with the MXU paths off
    (module globals read when the kernel is traced: patched around the
    call)."""
    tables = jax_packed[0]
    s = render_scene
    with pytest.MonkeyPatch.context() as mp:
        for flag in MXU_FLAGS:
            mp.setattr(j_kr, flag, False)
        out = j_rasterize(*(jnp.asarray(s[k]) for k in ("uv", "conic", "rgb", "opacity")),
                          tables, jnp.float32(BG), width=64, height=48, tile=16, chunk=128,
                          interpret=True)
    return np.asarray(out.image), np.asarray(out.n_splats)


@pytest.fixture(scope="module")
def port_render(render_scene):
    s = render_scene
    gp = t_state.params_from_jax(s["params"], s["alive"], "cpu")
    image, tables = t_step.render_image(gp, s["cm"].view, s["cm"].proj, s["cm"].campos, BG,
                                        s["t_st"])
    return image.numpy(), tables


@pytest.fixture(scope="module")
def port_grads(render_scene):
    """The port's default rasterize on the JAX per-Gaussian values: image,
    n_splats, gradients, tables."""
    s = render_scene
    tables = build_tile_tables(*(_t(s[k]) for k in ("uv", "z", "radius", "mask")),
                               num_tiles_x=4, num_tiles_y=3, tile_size=16)
    leaves = [_t(s[k]).requires_grad_(True) for k in ("uv", "conic", "rgb", "opacity")]
    out = rasterize(*leaves, tables, BG, width=64, height=48, tile=16)
    grads = torch.autograd.grad(out.image, leaves, grad_outputs=_t(s["cot"]))
    return out, [g.numpy() for g in grads], tables


def test_pair_rounding_equals_jax_packed_stream(render_scene, jax_packed):
    tables = jax_packed[0]
    p = int(tables.num_pairs)
    assert p > 200
    words = np.asarray(tables.stream).transpose(1, 0, 2).reshape(4, -1)[:, :p]
    ref = np.asarray(j_kr._unpack_attr_chunk(jnp.asarray(words))).T  # (P, 9)
    s = render_scene
    attrs = np.asarray(j_pack_attrs(*(jnp.asarray(s[k]) for k in ("uv", "conic", "rgb",
                                                                   "opacity"))))
    gid = np.asarray(tables.splat_gid)[:p]
    tile = np.repeat(np.arange(12), np.asarray(tables.tile_count))
    x0, y0 = (_t(16.0 * c).float() for c in (tile % 4, tile // 4))
    got = packing.round_pair_attrs(_t(attrs[gid]), x0, y0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_packed_render_reproduces_jax_rounding(port_render, port_grads, jax_packed_no_mxu,
                                               jax_exact):
    image, tables = port_render
    j_img, j_nspl = jax_packed_no_mxu
    assert tables.bf16_colors  # render_image's default
    assert tables.num_pairs == int(jax_exact[0].num_pairs)
    gap = np.abs(j_img - jax_exact[1]).max()  # the JAX package's packed vs exact
    err = np.abs(image - j_img).max()
    assert gap > 1e-3
    assert err <= 0.1 * gap, f"port vs JAX packed {err:.3g}, JAX packed vs exact {gap:.3g}"
    out = port_grads[0]
    np.testing.assert_array_equal(out.n_splats.numpy(), j_nspl)
    np.testing.assert_allclose(out.image.detach().numpy(), j_img, rtol=0, atol=0.1 * gap)


def test_packed_render_close_to_jax_default(port_render, jax_packed):
    image = port_render[0]
    j_img = jax_packed[1]
    assert np.isfinite(image).all()
    np.testing.assert_allclose(image, j_img, atol=0.03)
    psnr = float(compute_psnr(_t(image), _t(j_img)))
    assert psnr > 45.0, f"port packed vs JAX default PSNR {psnr:.1f} dB"


def _columns(grads):
    """(N, 9) columns [u v c00 c01 c11 r g b opacity] of the four gradients."""
    return np.concatenate([grads[0], grads[1], grads[2], grads[3][:, None]], axis=1)


def test_packed_backward_matches_jax_packed(port_grads, jax_packed, jax_exact):
    got, ref, exact = (_columns(g) for g in (port_grads[1], jax_packed[3], jax_exact[3]))
    top = np.abs(ref).max(axis=0)
    assert (top > 0).all()
    err = np.abs(got - ref).max(axis=0) / top
    gap = np.abs(ref - exact).max(axis=0) / top
    # tests/test_render.py's packed-vs-exact bound on each column
    assert (err <= 0.05).all(), err
    # The two packed paths differ by the reference's bf16 MXU sums and by
    # rounding near-equal sums to bf16 / e5s9 words (one code of a colour
    # triple is up to 1/128 of its largest channel); the packed-vs-exact
    # gap holds the same word rounding plus the rounded inputs. Measured:
    # 0.52 % against 0.80 % of a column's largest |value|.
    assert err.max() <= gap.max(), (err, gap)
    # Closer to the JAX packed gradients than exact-mode gradients are (the
    # port's exact ones equal JAX's to 3e-7 of a column's largest value, so
    # they would give a ratio of 1 in every column). The colour and opacity
    # columns are the MXU's bf16 products of w and dI more than the
    # rounding: rms ratios measured 0.39-0.67 for u, v and the conic,
    # 0.81-0.89 for r, g, b and opacity, 0.68 on average.
    rms = lambda d: np.sqrt((d**2).mean(axis=0))  # noqa: E731
    ratio = rms(got - ref) / rms(exact - ref)
    assert (ratio <= 0.92).all() and ratio.mean() <= 0.75, ratio


@pytest.mark.parametrize("packed", [True, False])
def test_plain_backward_words_are_packed_rows(render_scene, port_grads, packed):
    # bf16_colors=packed with bf16_grads=True: the words are the pack of the
    # float32 rows the same inputs give with bf16_grads=False.
    s = render_scene
    tables = port_grads[2]
    attrs = pack_attrs(*(_t(s[k]) for k in ("uv", "conic", "rgb", "opacity")))
    args = (attrs.detach(), tables.splat_gid, tables.tile_start, tables.tile_count)
    out = rasterize_forward(*args, BG, num_tiles_x=4, packed=packed)
    d_tiles = _t(np.random.default_rng(4).normal(size=(12, 3, 256)).astype(np.float32))
    kw = dict(num_tiles_x=4, num_tiles_y=3, packed=packed, pair_cand=tables.pair_cand)
    rows = rasterize_backward(*args, out, d_tiles, BG, **kw)
    words = rasterize_backward(*args, out, d_tiles, BG, pack_grads=True, **kw)
    assert rows.dtype == torch.float32 and words.shape == (tables.num_pairs, 4)
    assert words.dtype == torch.int32 and (rows.abs().amax(dim=0) > 0).all()
    assert torch.equal(words, packing.pack_grad_rows(rows))
    ref = np.asarray(j_kr.pack_grad_rows(jnp.asarray(rows.numpy().T)))
    np.testing.assert_array_equal(words.numpy().T, ref)
    # the packed inputs change the rows
    other = rasterize_backward(*args, rasterize_forward(*args, BG, num_tiles_x=4,
                                                        packed=not packed),
                               d_tiles, BG, pair_cand=tables.pair_cand, num_tiles_x=4,
                               num_tiles_y=3, packed=not packed)
    assert not torch.equal(rows, other)


@pytest.mark.parametrize("packed", [True, False])
def test_plain_backward_words_land_at_pair_cand(render_scene, port_grads, packed):
    # Sorted pair j's words are stored at its candidate, pair_cand[j]: the
    # words of an identity pair_cand (sorted-pair order), permuted.
    s = render_scene
    tables = port_grads[2]
    attrs = pack_attrs(*(_t(s[k]) for k in ("uv", "conic", "rgb", "opacity")))
    args = (attrs.detach(), tables.splat_gid, tables.tile_start, tables.tile_count)
    out = rasterize_forward(*args, BG, num_tiles_x=4, packed=packed)
    d_tiles = _t(np.random.default_rng(5).normal(size=(12, 3, 256)).astype(np.float32))
    kw = dict(num_tiles_x=4, num_tiles_y=3, packed=packed, pack_grads=True)
    p = tables.num_pairs
    ident = torch.arange(p, dtype=torch.int32)
    assert not torch.equal(tables.pair_cand, ident)
    words = rasterize_backward(*args, out, d_tiles, BG, pair_cand=tables.pair_cand, **kw)
    in_order = rasterize_backward(*args, out, d_tiles, BG, pair_cand=ident, **kw)
    assert (in_order != 0).any(dim=1).sum() > p // 2
    assert torch.equal(words[tables.pair_cand.long()], in_order)


@pytest.mark.parametrize("case", ["runs", "empty frame"])
def test_packed_segment_sum_matches_jax_kernel(rng, case):
    # test_torch_backward's runs, with packed words for rows: JAX's packed
    # branch (int32 values, unpacked in the kernel) on the gid-sorted words.
    n = 700
    counts = rng.integers(0, 10, n)
    counts[counts < 3] = 0
    counts[3] = 0 if case == "empty frame" else 300
    if case == "empty frame":
        counts[:] = 0
    _, pair_start, _ = _runs(counts, rng, num_tiles=400)
    p = int(counts.sum())
    rows = rng.standard_normal((p, 9)).astype(np.float32) * np.exp2(
        rng.integers(-30, 0, (p, 1))).astype(np.float32)
    words = packing.pack_grad_rows(_t(rows))  # in candidate order, as K2 stores them
    got = segment_sum(words, pair_start, n)
    # the plain version sums the unpacked rows in run order
    assert torch.equal(got, segment_sum_plain(packing.unpack_grad_rows(words), pair_start, n))
    cand_gid = np.repeat(np.arange(n), counts).astype(np.int32)
    values, ids = words.numpy().T, cand_gid
    if p == 0:  # one sentinel slot (id n), never summed
        values, ids = np.zeros((4, 1), np.int32), np.full((1,), n, np.int32)
    ref = np.asarray(segment_sum_by_gid(jnp.asarray(values), jnp.asarray(ids), n,
                                        interpret=True))[:, :n].T
    top = np.abs(ref).max(axis=0, keepdims=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6 * top.max() + 1e-30)
    assert got.shape == (n, 9) and (got.numpy()[counts == 0] == 0).all()


# ------------------------------------------------------------ train step


@pytest.fixture(scope="module")
def trajectories():
    """3 steps of the JAX default train_step and of the port's, from
    tests/test_torch_train.py's start towards its exact-mode target."""
    params, alive, cm, j_st, t_st, rng = _scene(64, 40, 300, 320)
    with exact_mode():
        gt, _ = t_step.render_image(t_state.params_from_jax(params, alive, "cpu"),
                                    cm.view, cm.proj, cm.campos, BG, t_st)
    gt = gt.numpy()
    start = dict(params, rgb=params["rgb"] + 0.3 * rng.normal(size=(320, 3)).astype(np.float32),
                 opacity=params["opacity"] - 0.5)
    zeros = lambda: {k: jnp.zeros_like(jnp.asarray(v)) for k, v in start.items()}  # noqa: E731
    js = j_state.TrainState(
        params={k: jnp.asarray(v) for k, v in start.items()}, adam_m=zeros(), adam_v=zeros(),
        alive=jnp.asarray(alive), uv_grad_accum=jnp.zeros((320,), jnp.float32),
        accum_dur=jnp.zeros((320,), jnp.int32))
    step = j_step.get_train_step(j_st)
    ts = t_state.init_state(t_state.params_from_jax(start, alive, "cpu"))
    out = []
    for it in range(3):
        js, jm = step(js, *(jnp.asarray(x) for x in (cm.view, cm.proj, cm.campos, gt)),
                      jnp.float32(BG), jnp.int32(it))
        ts, tm = t_step.train_step(ts, cm.view, cm.proj, cm.campos, _t(gt), BG, it, t_st)
        ref = {f: jax.tree.map(np.array, getattr(js, f)) for f in js._fields}
        out.append((float(tm.loss), float(jm.loss), t_state.state_to_numpy(ts), ref,
                    tm.num_pairs, int(jm.num_pairs)))
    return start, out


def _rel(got, ref):
    """(max |got - ref| / max |ref|, rms(got - ref) / rms(ref)) over ref's
    finite entries; NaN in the same places."""
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    err, ref = (got - ref)[fin], ref[fin]
    return np.abs(err).max() / np.abs(ref).max(), np.sqrt((err**2).mean() / (ref**2).mean())


@pytest.mark.parametrize("steps", [1, 3])
def test_packed_train_step_matches_jax_default(trajectories, steps):
    start, out = trajectories
    loss, j_loss, state, ref, pairs, j_pairs = out[steps - 1]
    assert pairs == j_pairs > 200
    # Measured: 1.3e-4 to 1.6e-4 (the JAX package's own packed vs exact
    # losses: 5e-4 to 2.7e-3).
    np.testing.assert_allclose(loss, j_loss, rtol=1e-3)
    # The reference's bf16 MXU sums (its conic and uv gradients come from
    # moments that cancel) against the port's float32 sums, both rounded to
    # bf16 words, carried through the per-Gaussian chain: moments measured
    # within 5.2 % of each tensor's largest value and 2.8 % rms (the JAX
    # package's packed vs exact: 19 % and 9 %).
    for name in NAMES:
        for field in ("adam_m", "adam_v"):
            worst, rms = _rel(state[field][name], ref[field][name])
            assert worst <= 0.1 and rms <= 0.05, (field, name, worst, rms)
    np.testing.assert_array_equal(state["accum_dur"], ref["accum_dur"])
    worst, rms = _rel(state["uv_grad_accum"], ref["uv_grad_accum"])
    assert worst <= 0.1 and rms <= 0.05, ("uv_grad_accum", worst, rms)
    # Adam moves a parameter by about lr a step whatever its gradient's
    # size: where the first gradient is well above the rounding, both move
    # it the same way (measured within 4 % of each tensor's largest value;
    # opacity moves 25 lr a step).
    for name in NAMES:
        moved = np.abs(state["params"][name] - start[name])
        assert moved.max() > 0, name
        worst, _ = _rel(state["params"][name], ref["params"][name])
        assert worst <= 0.06, (name, worst)


# ------------------------------------------------------------ default mode


class _Modes:
    """Records the modes of every rasterizer call the rasterize op makes."""

    def __init__(self, mp):
        self.calls = []
        for name in ("rasterize_forward", "rasterize_backward"):
            real = getattr(t_render, name)

            def spy(*a, _real=real, _name=name, **k):
                self.calls.append((_name, k.get("packed"), k.get("pack_grads")))
                return _real(*a, **k)

            mp.setattr(t_render, name, spy)

    def packed(self) -> bool:
        return bool(self.calls) and all(
            packed and (name == "rasterize_forward" or grads)
            for name, packed, grads in self.calls)


def test_entry_points_default_to_packed(tmp_path):
    from test_torch_parallel import DATASET, _read, _write_config

    from gsplat_tpu_torch import config as t_config
    from gsplat_tpu_torch.tools.synthetic import write_synthetic_dataset
    from gsplat_tpu_torch.train import trainer as t_trainer
    from gsplat_tpu_torch.train.init import initialize_gaussians

    params, alive, cm, _, t_st, _ = _scene(64, 40, 300, 320)
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        modes = _Modes(mp)
        img, tables = t_step.render_image(t_state.params_from_jax(params, alive, "cpu"),
                                          cm.view, cm.proj, cm.campos, BG, t_st)
        seen["render_image"] = modes.packed() and tables.bf16_colors
        modes.calls.clear()
        state = t_state.init_state(t_state.params_from_jax(params, alive, "cpu"))
        t_step.train_step(state, cm.view, cm.proj, cm.campos, img, BG, 0, t_st)
        seen["train_step"] = modes.packed() and len(modes.calls) == 2
        modes.calls.clear()
        write_synthetic_dataset(tmp_path, **DATASET, device="cpu")
        conf = dataclasses.replace(t_config.parse_config(_write_config(tmp_path / "c.yaml")),
                                   output_dir=str(tmp_path / "out"))
        cams, imgs, xyz, rgb = _read(tmp_path)
        tr = t_trainer.Trainer(conf, initialize_gaussians(xyz, rgb, conf), imgs, cams,
                               device="cpu")
        tr.train(max_iters=2, verbose=False)
        seen["Trainer"] = modes.packed()
    assert seen == dict.fromkeys(seen, True), seen
    # and exact_mode reaches the exact kernels
    with pytest.MonkeyPatch.context() as mp:
        modes = _Modes(mp)
        with exact_mode():
            t_step.train_step(state, cm.view, cm.proj, cm.campos, img, BG, 1, t_st)
        assert [(p, g) for _, p, g in modes.calls] == [(False, None), (False, False)]


def test_exact_mode_reaches_every_entry_point_and_restores_packed():
    from gsplat_tpu_torch import parallel
    from gsplat_tpu_torch.parallel.launch import free_port

    params, alive, cm, _, t_st, _ = _scene(64, 40, 300, 320)
    parallel.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="gloo")
    try:
        with pytest.MonkeyPatch.context() as mp:
            modes = _Modes(mp)
            with exact_mode():
                img, tables = t_step.render_image(t_state.params_from_jax(params, alive, "cpu"),
                                                  cm.view, cm.proj, cm.campos, BG, t_st)
                for step in (t_step.train_step, parallel.tp_train_step):
                    state = t_state.init_state(t_state.params_from_jax(params, alive, "cpu"))
                    step(state, cm.view, cm.proj, cm.campos, img, BG, 0, t_st)
    finally:
        torch.distributed.destroy_process_group()
    assert not tables.bf16_colors
    assert [(p, g) for _, p, g in modes.calls] == [(False, None)] + 2 * [(False, None),
                                                                         (False, False)]
    with pytest.raises(RuntimeError, match="inside"):
        with exact_mode():
            assert not packing.packed()
            raise RuntimeError("inside")
    assert packing.packed()
