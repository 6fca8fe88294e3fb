"""Mip-Splatting's step and render (Yu et al., CVPR 2024, arXiv:2311.16493),
as the measured Mip cell defines them, built on ``step.py``'s pieces.

- **The 3D filter** (``filter_3d``): the published ``compute_3D_filter``
  over the given cameras: ``x_c = R x + t``; a camera sees a Gaussian
  where ``z_c > 0.2`` and ``(x_c / z_c f_x + W/2, y_c / z_c f_y + H/2)``
  lies in ``[-0.15 W, 1.15 W] x [-0.15 H, 1.15 H]``; ``d`` is the least
  ``z_c`` of the seeing cameras, and a Gaussian no camera sees takes the
  largest ``d`` of those seen; the filter is ``d / max f_x * sqrt(0.2)``.
- **The step's geometry** (``per_gaussian``): the scales ``sqrt(s^2 +
  f^2)`` build Sigma (``get_scaling_with_3D_filter``), the opacity is
  multiplied by ``sqrt(prod s^2 / prod (s^2 + f^2))``
  (``get_opacity_with_3D_filter``), and the 2D Mip filter of the published
  rasterizer's ``computeCov2D`` (kernel size 0.1) replaces the 0.3
  dilation: the opacity times ``sqrt(det0 / (det1 + 1e-6) + 1e-6)``, 0
  where either determinant is at its 1e-6 floor.

Plain PyTorch in float32 (TF32 off, ``gaussians.full_f32``); it imports
nothing of the program. Departures from the published code, all the
measured step's: the binning radius is the opacity-aware cut of
``gaussians.py`` taken at the filtered opacity (the published rasterizer
takes 3 sigmas of the dilated covariance); the pairs and gradient rows are
rounded as the packed stream carries them (``step.py``); dead capacity
rows are left out of the sweep and get a filter of 0; with no Gaussian
seen at all the filter is 0 (the published code raises). ``low`` computes
the chain, and the sweep, in bfloat16: the precision control. ``dilate``
keeps 3DGS's 0.3 dilation in place of the 2D Mip filter: a fault.
"""

from __future__ import annotations

import torch

from . import binning, raster, step
from .gaussians import LOG255, PARAMS, Statics, _safe, _sh_rgb, _sigma
from .gaussians import _conic_radius as plain_conic_radius
from .loss import loss_and_grad

KERNEL_2D = 0.1
FILTER_VARIANCE = 0.2
DEPTH_FLOOR = 0.2
MARGIN = 0.15
FILTER_TOLERANCE = 1e-4  # filter_gap's relative tolerance


@torch.no_grad()
def filter_3d(xyz, alive, cams, low: bool = False) -> torch.Tensor:
    """(N,) 3D filter of the Gaussians at ``xyz`` (N, 3) seen from the
    cameras ``cams`` (each with ``view``, ``width``, ``height``,
    ``focal_x``, ``focal_y``)."""
    dt = torch.bfloat16 if low else torch.float32
    xyz = xyz.to(dt)
    distance = torch.full((xyz.shape[0],), 100000.0, device=xyz.device, dtype=dt)
    valid_points = torch.zeros(xyz.shape[0], dtype=torch.bool, device=xyz.device)
    focal = 0.0
    for cam in cams:
        view = torch.as_tensor(cam.view, dtype=torch.float32, device=xyz.device).to(dt)
        xyz_cam = xyz @ view[:3, :3].T + view[:3, 3]
        z = xyz_cam[:, 2]
        valid_depth = z > DEPTH_FLOOR
        z = torch.clamp(z, min=0.001)
        x = xyz_cam[:, 0] / z * cam.focal_x + cam.width / 2.0
        y = xyz_cam[:, 1] / z * cam.focal_y + cam.height / 2.0
        in_screen = ((x >= -MARGIN * cam.width) & (x <= cam.width * (1.0 + MARGIN))
                     & (y >= -MARGIN * cam.height) & (y <= (1.0 + MARGIN) * cam.height))
        valid = valid_depth & in_screen & alive
        distance = torch.where(valid, torch.minimum(distance, z), distance)
        valid_points = valid_points | valid
        focal = max(focal, cam.focal_x)
    far = distance[valid_points].max() if bool(valid_points.any()) else torch.zeros((), dtype=dt)
    distance = torch.where(valid_points, distance, far.to(xyz.device))
    out = distance / focal * (FILTER_VARIANCE ** 0.5)
    return torch.where(alive, out, torch.zeros_like(out)).to(torch.float32)


def _mip_conic_radius(sigma, jac, view, mh_dist, opacity_logit, coef_3d):
    """The 2D Mip filter: (conic, radius, opacity scale), as
    ``gaussians._conic_radius`` with the kernel 0.1 and the opacity-aware
    cut at the filtered opacity."""
    w3 = view[:3, :3]
    j00, j02, j11, j12 = jac[:, 0], jac[:, 2], jac[:, 4], jac[:, 5]
    m0 = [j00 * w3[0, c] + j02 * w3[2, c] for c in range(3)]
    m1 = [j11 * w3[1, c] + j12 * w3[2, c] for c in range(3)]
    sxx, sxy, sxz, syy, syz, szz = (sigma[:, k] for k in range(6))

    def sig(v):
        return [sxx * v[0] + sxy * v[1] + sxz * v[2],
                sxy * v[0] + syy * v[1] + syz * v[2],
                sxz * v[0] + syz * v[1] + szz * v[2]]

    s0, s1 = sig(m0), sig(m1)
    c00 = m0[0] * s0[0] + m0[1] * s0[1] + m0[2] * s0[2]
    cov01 = m0[0] * s1[0] + m0[1] * s1[1] + m0[2] * s1[2]
    c11 = m1[0] * s1[0] + m1[1] * s1[1] + m1[2] * s1[2]
    det_0 = torch.clamp(c00 * c11 - cov01 * cov01, min=1e-6)
    det_1 = torch.clamp((c00 + KERNEL_2D) * (c11 + KERNEL_2D) - cov01 * cov01, min=1e-6)
    coef = torch.sqrt(det_0 / (det_1 + 1e-6) + 1e-6)
    coef = torch.where((det_0 <= 1e-6) | (det_1 <= 1e-6), torch.zeros_like(coef), coef)
    cov00, cov11 = c00 + KERNEL_2D, c11 + KERNEL_2D
    det = cov00 * cov11 - cov01 * cov01
    inv_det = 1.0 / det
    conic = torch.stack([cov11 * inv_det, -cov01 * inv_det, cov00 * inv_det], dim=1)
    mid = 0.5 * (cov00 + cov11)
    lam_term = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam1, lam2 = mid + lam_term, mid - lam_term
    scale = coef_3d * coef
    with torch.no_grad():
        softplus = torch.logaddexp(-opacity_logit, torch.zeros_like(opacity_logit))
        r_cut = torch.sqrt(torch.clamp(2.0 * (LOG255 - softplus + torch.log(scale)), min=0.0))
        cut = torch.clamp(r_cut, max=mh_dist)
        r_major = torch.ceil(cut * torch.sqrt(torch.clamp(lam1, min=0.0)))
        r_minor = torch.ceil(cut * torch.sqrt(torch.clamp(lam2, min=0.0)))
        theta = 0.5 * torch.atan2(2.0 * cov01, cov00 - cov11)
        kappa = lam1 / torch.clamp(lam2, min=1e-12)
        r_pad = torch.sqrt(r_cut * r_cut * (1.0 + kappa * (1.0 / 128.0)) + 0.1)
        ell = torch.clamp(r_pad / torch.clamp(cut, min=1e-6), max=2.0)
        radius = torch.stack([r_major, r_minor, torch.sin(theta), torch.cos(theta), ell], dim=1)
    return conic, radius, scale


def per_gaussian(p: dict, alive, filt, view, proj, campos, st: Statics, low: bool = False,
                 dilate: bool = False):
    """(uv, conic, rgb, mask, radius, z, opacity scale) of every Gaussian
    of ``p`` with the 3D filter ``filt`` (N,), for one camera."""
    if low:
        p = {k: v.to(torch.bfloat16) for k, v in p.items()}
        filt = filt.to(torch.bfloat16)
        view, proj, campos = (t.to(torch.bfloat16) for t in (view, proj, campos))
    xyz_c = p["xyz"] @ view[:3, :3].T + view[:3, 3]
    hom = torch.cat([xyz_c, torch.ones_like(xyz_c[:, :1])], dim=1)
    clip = hom @ proj.T
    denom = _safe(clip[:, 3] + 1e-6, 1e-8)
    uv = torch.stack([(clip[:, 0] / denom * 0.5 + 0.5) * st.width,
                      (clip[:, 1] / denom * 0.5 + 0.5) * st.height], dim=1)
    x, y, z = xyz_c[:, 0], xyz_c[:, 1], xyz_c[:, 2]
    pad = st.cull_padding
    mask = ((z >= st.near_thresh) & (uv[:, 0] >= -pad) & (uv[:, 0] <= st.width + pad)
            & (uv[:, 1] >= -pad) & (uv[:, 1] <= st.height + pad) & alive)
    zs = _safe(z, 1e-6)
    xc = torch.clamp(x / zs, -1.3 * st.tan_fovx, 1.3 * st.tan_fovx) * zs
    yc = torch.clamp(y / zs, -1.3 * st.tan_fovy, 1.3 * st.tan_fovy) * zs
    j00, j11 = st.focal_x / zs, st.focal_y / zs
    j02 = -(st.focal_x * xc) / (zs * zs)
    j12 = -(st.focal_y * yc) / (zs * zs)
    zero = torch.zeros_like(j00)
    jac = torch.stack([j00, zero, j02, zero, j11, j12], dim=1)
    jac = torch.where((z.abs() < 1e-6)[:, None], torch.zeros_like(jac), jac)
    s2 = torch.square(torch.exp(p["scale"]))
    s2f = s2 + torch.square(filt)[:, None]
    coef_3d = torch.sqrt(s2.prod(dim=1) / s2f.prod(dim=1))
    sigma = _sigma(p["quat"], torch.log(torch.sqrt(s2f)))
    if dilate:
        conic, radius = plain_conic_radius(sigma, jac, view, st.mh_dist, p["opacity"])
        scale = coef_3d
    else:
        conic, radius, scale = _mip_conic_radius(sigma, jac, view, st.mh_dist, p["opacity"],
                                                 coef_3d)
    rgb = _sh_rgb(p["xyz"], p["rgb"], p["sh"], campos, st.l_max)
    out = (uv, conic, rgb, mask, radius, z, scale)
    if low:
        out = tuple(t if t.dtype == torch.bool else t.to(torch.float32) for t in out)
    return out


def pack_attrs(uv, conic, rgb, opacity_logit, scale):
    """(N, 9) rows [u v c00 c01 c11 sigmoid(o) scale r g b], differentiable."""
    opa = torch.sigmoid(opacity_logit) * scale
    return torch.stack([uv[:, 0], uv[:, 1], conic[:, 0], conic[:, 1], conic[:, 2], opa,
                        rgb[:, 0], rgb[:, 1], rgb[:, 2]], dim=1).contiguous()


def render(params: dict, alive, filt, view, proj, campos, bg: float, st: Statics,
           low: bool = False) -> torch.Tensor:
    """(H, W, 3) image."""
    with torch.no_grad():
        uv, conic, rgb, mask, radius, z, scale = per_gaussian(params, alive, filt, view, proj,
                                                              campos, st, low)
        tables = binning.bin_tiles(uv, z, radius, mask, st.tiles_x, st.tiles_y, st.tile)
        out = raster.forward(pack_attrs(uv, conic, rgb, params["opacity"], scale), tables, bg,
                             st.tiles_x, st.tiles_y)
        return raster.to_image(out[:, :3], st.tiles_x, st.tiles_y, st.width, st.height)


def work(params: dict, alive, filt, view, proj, campos, st: Statics) -> dict:
    """``step.work`` of one view under Mip-Splatting's geometry."""
    with torch.no_grad():
        uv, conic, rgb, mask, radius, z, scale = per_gaussian(params, alive, filt, view, proj,
                                                              campos, st)
        tables = binning.bin_tiles(uv, z, radius, mask, st.tiles_x, st.tiles_y, st.tile)
        attrs = pack_attrs(uv, conic, rgb, params["opacity"], scale)
        out = raster.forward(attrs, tables, 0.0, st.tiles_x, st.tiles_y)
        nspl = out[:, 4]
        passing = 0
        deepest = nspl.amax(dim=1)
        dev = attrs.device
        for c0 in range(0, int(deepest.max()) if deepest.numel() else 0, raster.CHUNK):
            tiles = torch.nonzero(deepest > c0).flatten()
            x0, y0, px, py = raster._grid(tiles, st.tiles_x, dev)
            a, valid, _ = raster._pairs(attrs, tables, tiles, c0, x0, y0)
            alpha = raster._alpha(a, px, py)[3]
            k = torch.arange(c0, c0 + raster.CHUNK, device=dev)
            live = valid[:, None, :] & (k < nspl[tiles][:, :, None]) & (alpha > raster.CUTOFF)
            passing += int(live.sum())
        reached = int(torch.minimum(deepest, tables.tile_count.to(torch.float32)).sum())
    return dict(gaussians=int(alive.shape[0]), rows=tables.rows, pairs=tables.pairs,
                tiles=st.tiles_x * st.tiles_y, pair_pixels=int(nspl.double().sum()),
                passing=passing, reached=reached)


def train_step(state: step.State, filt, view, proj, campos, gt, bg: float, it: int,
               st: Statics, low: bool = False, loss_rows: slice = slice(None),
               dilate: bool = False) -> float:
    """``step.train_step`` under Mip-Splatting's geometry with the 3D
    filter ``filt`` (N,), which Adam does not step; returns the loss."""
    leaves = {k: state.params[k].detach().requires_grad_() for k in PARAMS}
    probe = torch.zeros((state.alive.shape[0], 2), device=gt.device, requires_grad=True)
    with torch.enable_grad():
        uv, conic, rgb, mask, radius, z, scale = per_gaussian(
            leaves, state.alive, filt, view, proj, campos, st, low, dilate)
        uv = uv + probe
        attrs = pack_attrs(uv, conic, rgb, leaves["opacity"], scale)
    a0 = attrs.detach()
    with torch.no_grad():
        tables = binning.bin_tiles(uv.detach(), z.detach(), radius, mask, st.tiles_x,
                                   st.tiles_y, st.tile)
        out = raster.forward(a0, tables, bg, st.tiles_x, st.tiles_y)
        image = raster.to_image(out[:, :3], st.tiles_x, st.tiles_y, st.width, st.height)
        loss, d_image = loss_and_grad(image, gt, st.ssim_frac, loss_rows)
        rows = raster.backward_rows(a0, tables, out, raster.to_tiles(d_image, st.tiles_x,
                                                                     st.tiles_y),
                                    bg, st.tiles_x, st.tiles_y)
        d_attrs = torch.zeros_like(a0).index_add_(0, tables.gid, rows)
        del rows, out
    got = torch.autograd.grad(attrs, [leaves[k] for k in PARAMS] + [probe], d_attrs,
                              allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(PARAMS, got)}
    step.adam(state, grads, got[-1], mask, it, st)
    return float(loss)


def filter_gap(got: torch.Tensor, want: torch.Tensor, alive) -> float:
    """The share of alive Gaussians whose 3D filter is off the reference's
    by more than ``FILTER_TOLERANCE`` of it. Rounding moves a filter by a
    few parts in 10^7; a Gaussian whose pixel lies within rounding of a
    screen margin may count as seen by one side and not the other, and
    such Gaussians are a few in a million, far under any limit that a
    wrong sweep (every filter off) could meet."""
    got, want = got.to(want.device)[alive], want[alive]
    off = (got - want).abs() > FILTER_TOLERANCE * want.abs()
    return float(off.double().mean()) if off.numel() else 0.0

