"""Forward tile rasterization op (port of ``gsplat_tpu/ops/render.py``).

Forward only: ``pack_attrs`` builds the per-Gaussian attribute rows, the
rasterizer kernel reads them through the binning's ``splat_gid``, and
``tiles_to_image`` crops the tile pixels to the image. The backward (and
its regroup sort and segment sum) comes with training.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.rasterize import rasterize_forward
from .binning import TileTables


class RenderOutput(NamedTuple):
    image: torch.Tensor  # (H, W, 3) cropped
    t_final: torch.Tensor  # (T, PIX)
    n_splats: torch.Tensor  # (T, PIX) float32 counts


def pack_attrs(
    uv: torch.Tensor,
    conic: torch.Tensor,
    rgb: torch.Tensor,
    opacity_logit: torch.Tensor,
) -> torch.Tensor:
    """Per-Gaussian (N, 9) attribute rows [u v c00 c01 c11 opa r g b]."""
    opa = torch.sigmoid(opacity_logit)
    return torch.stack(
        [uv[:, 0], uv[:, 1], conic[:, 0], conic[:, 1], conic[:, 2], opa,
         rgb[:, 0], rgb[:, 1], rgb[:, 2]],
        dim=1,
    ).contiguous()


def tiles_to_image(
    out_tiles: torch.Tensor,
    num_tiles_x: int,
    num_tiles_y: int,
    tile: int,
    width: int,
    height: int,
) -> torch.Tensor:
    """(T, 3, PIX) tile pixels -> cropped (H, W, 3) image."""
    x = out_tiles.reshape(num_tiles_y, num_tiles_x, 3, tile, tile)
    x = x.permute(0, 3, 1, 4, 2)  # (ty, py, tx, px, 3)
    x = x.reshape(num_tiles_y * tile, num_tiles_x * tile, 3)
    return x[:height, :width, :]


def rasterize(
    uv: torch.Tensor,
    conic: torch.Tensor,
    rgb: torch.Tensor,
    opacity_logit: torch.Tensor,
    tables: TileTables,
    bg: float,
    *,
    width: int,
    height: int,
    tile: int,
) -> RenderOutput:
    """Render the image from binning's ``tables`` (same uv as binned)."""
    num_tiles_x = (width + tile - 1) // tile
    num_tiles_y = (height + tile - 1) // tile
    attrs = pack_attrs(uv, conic, rgb, opacity_logit)
    out = rasterize_forward(
        attrs, tables.splat_gid, tables.tile_start, tables.tile_count,
        float(bg), num_tiles_x=num_tiles_x, tile=tile,
    )
    image = tiles_to_image(out[:, 0:3, :], num_tiles_x, num_tiles_y, tile,
                           width, height)
    return RenderOutput(image=image, t_final=out[:, 3, :], n_splats=out[:, 4, :])
