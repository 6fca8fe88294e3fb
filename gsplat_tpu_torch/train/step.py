"""Forward render (port of ``gsplat_tpu/train/step.py:32-130``).

``render_image`` is the port's entry point for eval renders and image
dumps: per-Gaussian projection, covariance and SH colour, exact tile
binning, then the forward rasterizer. It runs eagerly (no jit); binning
syncs the host twice per frame to size its outputs exactly.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import covariance, projection
from ..ops import sh as sh_ops
from ..ops.binning import TileTables, build_tile_tables
from ..ops.render import rasterize
from .state import GaussianParams


@dataclasses.dataclass(frozen=True)
class StepStatics:
    """Per-geometry constants, under the reference's field names.

    The reference's ``pair_cap``, ``row_cap``, ``chunk`` and ``interpret``
    are gone: binning sizes every frame exactly and the kernels pick their
    own blocking.
    """

    width: int
    height: int
    tile: int
    l_max: int
    # camera intrinsics
    focal_x: float
    focal_y: float
    tan_fovx: float
    tan_fovy: float
    # config-derived
    near_thresh: float
    mh_dist: float
    cull_padding: int
    ssim_frac: float
    base_lr: float
    xyz_lr_init: float
    xyz_lr_final: float
    quat_lr: float
    scale_lr: float
    opacity_lr: float
    rgb_lr: float
    sh_lr: float
    scene_extent: float
    num_iters: int

    @property
    def num_tiles_x(self) -> int:
        return (self.width + self.tile - 1) // self.tile

    @property
    def num_tiles_y(self) -> int:
        return (self.height + self.tile - 1) // self.tile


def _per_gaussian(params: GaussianParams, view, proj, campos, st: StepStatics):
    """Dense per-Gaussian forward: (uv, conic, rgb, mask, radius, z)."""
    xyz_c = projection.world_to_camera(params.xyz, view)
    uv = projection.project_to_screen(xyz_c, proj, st.width, st.height)
    mask = (
        projection.frustum_cull_mask(
            uv, xyz_c, st.near_thresh, st.cull_padding, st.width, st.height
        )
        & params.alive
    )
    jac = projection.projection_jacobian(
        xyz_c, st.focal_x, st.focal_y, st.tan_fovx, st.tan_fovy
    )
    sigma = covariance.sigma_from_quat_scale(params.quat, params.scale)
    conic, radius = covariance.conic_and_radius(
        sigma, jac, view, st.mh_dist, opacity_logit=params.opacity
    )
    rgb = sh_ops.sh_to_rgb(params.xyz, params.rgb, params.sh, campos, st.l_max)
    z = xyz_c[:, 2]
    return uv, conic, rgb, mask, radius, z


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def render_image(
    params: GaussianParams, view, proj, campos, bg: float, st: StepStatics
) -> tuple[torch.Tensor, TileTables]:
    """Forward-only render of one camera: ((H, W, 3) image, tile tables).

    ``view``/``proj`` (4, 4) and ``campos`` (3,) may be numpy arrays or
    tensors; they are moved to the parameters' device.
    """
    dev = params.xyz.device
    view, proj, campos = (_as_f32(x, dev) for x in (view, proj, campos))
    uv, conic, rgb, mask, radius, z = _per_gaussian(params, view, proj, campos, st)
    tables = build_tile_tables(
        uv, z, radius, mask,
        num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y, tile_size=st.tile,
    )
    out = rasterize(
        uv, conic, rgb, params.opacity, tables, bg,
        width=st.width, height=st.height, tile=st.tile,
    )
    return out.image, tables
