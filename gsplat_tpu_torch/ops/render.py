"""Differentiable tile rasterization op (port of ``gsplat_tpu/ops/render.py``).

The custom-gradient boundary is the reference's: per-Gaussian attribute
rows ``attrs`` (N, 9) -> (T, 5, PIX) tile pixels. The forward is the
forward rasterizer kernel, reading ``attrs`` through binning's
``splat_gid``. The backward is

  backward rasterizer (one gradient row per pair, stored at the pair's
     candidate index, binning's ``pair_cand``)
  -> segment sum over the per-Gaussian runs of those rows (``pair_start``)
  -> ``d_attrs`` (N, 9).

The reference sorts the pairs by Gaussian id a second time (its regroup
``sample_sort`` call site) to feed its segment sum a gid-sorted stream.
The port's runs list each Gaussian's rows in that same order, so the sort
is not made and the sums are the same.

Both of the reference's modes: by default (its default) the pairs are
rounded as its packed stream carries them (``tables.bf16_colors``, set by
``build_tile_tables``) and the per-pair gradient rows travel from the
backward kernel to the segment sum as four packed int32 words
(``bf16_grads=True``); ``build_tile_tables(bf16_colors=False)`` and
``rasterize(bf16_grads=False)`` give its exact f32 mode. ``d_attrs`` is
(N, 9) float32 either way.

The reference's chunk-coverage mask and side buffers (and its repack of the
side buffers into the packed words) are not ported: they exist only
because of how its TPU kernel assigns chunks to tiles. The backward kernel
here writes every pair row itself.

Gradient conventions (the reference's): uv cotangents are scaled by 0.5 x
the padded tile grid's width and height inside the backward (unless
``grad_scale_wh`` names another size); the 0.99
alpha clamp and the power <= 0 clamp are ignored in the derivative; the
background gets no gradient; ``t_final`` and ``n_splats`` carry none.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import packing
from ..kernels.rasterize import background, rasterize_backward, rasterize_forward
from ..kernels.segsum import segment_sum
from ..utils import profiling
from .binning import TileTables


class RenderOutput(NamedTuple):
    image: torch.Tensor  # (H, W, 3) cropped
    t_final: torch.Tensor  # (T, PIX)
    n_splats: torch.Tensor  # (T, PIX) float32 counts


class _Rasterize(torch.autograd.Function):
    """attrs (N, 9) -> (T, 5, PIX) tile pixels; differentiable in attrs."""

    @staticmethod
    def forward(ctx, attrs, splat_gid, tile_start, tile_count, pair_cand, pair_start,
                bg, num_tiles_x, num_tiles_y, tile, grad_scale, packed, pack_grads):
        out = rasterize_forward(
            attrs, splat_gid, tile_start, tile_count, bg,
            num_tiles_x=num_tiles_x, tile=tile, packed=packed,
        )
        ctx.save_for_backward(attrs, splat_gid, tile_start, tile_count, pair_cand,
                              pair_start, out)
        ctx.bg = bg
        ctx.grid = (num_tiles_x, num_tiles_y, tile)
        ctx.grad_scale = grad_scale
        ctx.modes = (packed, pack_grads)
        return out

    @staticmethod
    def backward(ctx, d_out):
        profiling.stage_done("loss")  # the stage clock: the loss and its gradient end here
        attrs, splat_gid, tile_start, tile_count, pair_cand, pair_start, out = (
            ctx.saved_tensors)
        num_tiles_x, num_tiles_y, tile = ctx.grid
        packed, pack_grads = ctx.modes
        rows = rasterize_backward(
            attrs, splat_gid, tile_start, tile_count, out,
            d_out[:, 0:3, :].contiguous(), ctx.bg, pair_cand=pair_cand,
            num_tiles_x=num_tiles_x, num_tiles_y=num_tiles_y, tile=tile,
            grad_scale=ctx.grad_scale, packed=packed, pack_grads=pack_grads,
        )
        d_attrs = segment_sum(rows, pair_start, attrs.shape[0])
        profiling.stage_done("raster_bwd")
        return d_attrs, *(None,) * 12


def pack_attrs(
    uv: torch.Tensor,
    conic: torch.Tensor,
    rgb: torch.Tensor,
    opacity_logit: torch.Tensor,
    opacity_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-Gaussian (N, 9) attribute rows [u v c00 c01 c11 opa r g b],
    ``opa = sigmoid(opacity_logit)``, times ``opacity_scale`` (N,) where
    given (Mip-Splatting's filters, ``ops/mip.py``).

    Differentiable: autograd through the sigmoid gives the opacity chain
    o (1 - o) of the backward's d/d(opa) row.
    """
    opa = torch.sigmoid(opacity_logit)
    if opacity_scale is not None:
        opa = opa * opacity_scale
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
    bg,
    *,
    width: int,
    height: int,
    tile: int,
    grad_scale_wh: tuple[int, int] | None = None,
    bf16_grads: bool | None = None,
    opacity_scale: torch.Tensor | None = None,
) -> RenderOutput:
    """Render the image from binning's ``tables`` (same uv as binned);
    differentiable with respect to uv, conic, rgb and opacity_logit (and
    ``opacity_scale``, which multiplies the opacity where given).
    ``bg`` is the background, a () float32 tensor or a number.

    The pairs are rounded to the packed stream where ``tables.bf16_colors``
    says so; ``bf16_grads`` carries the per-pair gradient rows as packed
    words (the reference's default), False as float32 rows; None reads
    ``kernels.packing.packed()``.
    ``grad_scale_wh`` (W, H) replaces the padded grid in the uv-gradient
    scale (0.5 W, 0.5 H), as the reference's tile-sharded step passes the
    global image's unpadded size for a strip (ROADMAP R10)."""
    num_tiles_x = (width + tile - 1) // tile
    num_tiles_y = (height + tile - 1) // tile
    attrs = pack_attrs(uv, conic, rgb, opacity_logit, opacity_scale)
    grad_scale = None if grad_scale_wh is None else (
        0.5 * grad_scale_wh[0], 0.5 * grad_scale_wh[1])
    out = _Rasterize.apply(
        attrs, tables.splat_gid, tables.tile_start, tables.tile_count,
        tables.pair_cand, tables.pair_start, background(bg, uv.device), num_tiles_x,
        num_tiles_y, tile, grad_scale, bool(tables.bf16_colors),
        packing.packed() if bf16_grads is None else bool(bf16_grads),
    )
    # Cropping outside the Function: autograd gives the padded pixels zero
    # cotangents, as the reference's tiles_to_image does.
    image = tiles_to_image(out[:, 0:3, :], num_tiles_x, num_tiles_y, tile,
                           width, height)
    return RenderOutput(
        image=image, t_final=out[:, 3, :].detach(), n_splats=out[:, 4, :].detach()
    )
