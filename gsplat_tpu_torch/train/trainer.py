"""Training orchestration (port of ``gsplat_tpu/train/trainer.py``).

``Trainer(config, gaussians, images, cameras, device)`` trains one camera a
step with the reference's schedule: ``test_train_split`` sorts the images
by name and also sends every ``test_split_ratio``-th to the test set;
``train`` runs SH band growth, densification (grow and rerun on
``needs_grow``, then the Morton re-sort), opacity resets, eval PSNR and
image dumps; ``save_to_ply`` exports the result.

Differences by design. The reference's data- and tile-parallel modes are
not ported. Binning sizes every frame exactly, so the reference's pair and
row capacities, their growth and its overflow monitor have no counterpart;
what stays of the monitor is the non-finite loss check: a flag on the
device collects every step's loss, and one host read at each print or
density boundary raises ``FloatingPointError`` for the window. The split
noise comes from ``density.split_noise`` (a ``torch.Generator`` seeded by
``seed * 1_000_003 + iteration``) instead of threefry.
"""

from __future__ import annotations

import queue
import threading
import warnings
from pathlib import Path

import numpy as np
import torch

from ..config import ConfigParameters
from ..io import images as image_io
from ..io.colmap import Camera, Image, compute_max_diagonal
from ..io.ply import save_ply
from ..ops.camera import CameraMatrices, build_camera_matrices
from ..ops.loss import compute_psnr
from ..utils import checkpoint
from .density import (
    DensityInfo, DensityStatics, adaptive_density_step, morton_sort, reset_opacity,
    split_noise, zero_sh,
)
from .init import GaussianData
from .progress import ProgressBar
from .state import (
    grow_state, num_active, round_capacity, state_from_gaussians, to_gaussian_data,
)
from .step import StepStatics, render_image, train_step


def require_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    there is none (no silent fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on "
                           "the CPU")
    return device


class Trainer:
    def __init__(
        self,
        config: ConfigParameters,
        gaussians: GaussianData,
        images: dict[int, Image],
        cameras: dict[int, Camera],
        device: torch.device | str = "cuda",
    ):
        self.device = require_device(device)
        self.config = config
        self.images = images
        self.cameras = cameras
        self.state = state_from_gaussians(gaussians, self.device,
                                          max_gaussians=config.max_gaussians)
        self.iter = 0
        self.l_max = 0
        # scene extent for the density thresholds and the xyz learning
        # rate: 1.1 x the largest camera-centre distance from the centroid
        self.scene_extent = 1.1 * compute_max_diagonal(images)
        self.train_images: list[Image] = []
        self.test_images: list[Image] = []
        self._cam_cache: dict[int, CameraMatrices] = {}
        self.test_train_split()

    # ------------------------------------------------------------------
    def test_train_split(self) -> None:
        """Every split-th image (sorted by name) also goes to the test set;
        all images stay in the train set."""
        split = self.config.test_split_ratio
        ordered = sorted(self.images.values(), key=lambda im: im.name)
        self.train_images = list(ordered)
        self.test_images = ordered[::split] if split > 0 else []

    # ------------------------------------------------------------------
    def _matrices(self, img: Image) -> CameraMatrices:
        if img.id not in self._cam_cache:
            cam = self.cameras[img.camera_id]
            self._cam_cache[img.id] = build_camera_matrices(
                img.qvec, img.tvec, cam.width, cam.height, cam.focal_x, cam.focal_y,
            )
        return self._cam_cache[img.id]

    def _statics(self, cm: CameraMatrices) -> StepStatics:
        c = self.config
        return StepStatics(
            width=cm.width, height=cm.height, tile=c.tile_size, l_max=self.l_max,
            focal_x=cm.focal_x, focal_y=cm.focal_y,
            tan_fovx=cm.tan_fovx, tan_fovy=cm.tan_fovy,
            near_thresh=c.near_thresh, mh_dist=c.mh_dist,
            cull_padding=c.cull_mask_padding, ssim_frac=c.ssim_frac,
            base_lr=c.base_lr,
            xyz_lr_init=c.xyz_lr_multiplier_init,
            xyz_lr_final=c.xyz_lr_multiplier_final,
            quat_lr=c.quat_lr_multiplier, scale_lr=c.scale_lr_multiplier,
            opacity_lr=c.opacity_lr_multiplier, rgb_lr=c.rgb_lr_multiplier,
            sh_lr=c.sh_lr_multiplier,
            scene_extent=float(self.scene_extent),
            num_iters=c.num_iters,
        )

    def _density_statics(self) -> DensityStatics:
        c = self.config
        strict = c.strict_reference
        return DensityStatics(
            scene_extent=float(self.scene_extent),
            uv_grad_threshold=c.uv_grad_threshold,
            delete_opacity_threshold=c.delete_opacity_threshold,
            split_scale_factor=c.split_scale_factor,
            max_gaussians=c.max_gaussians,
            use_split=True if strict else c.use_split,
            use_clone=True if strict else c.use_clone,
            use_delete=True if strict else c.use_delete,
        )

    # ------------------------------------------------------------------
    def _bg(self, iteration: int) -> float:
        c = self.config
        if not c.use_background:
            return 0.0
        if not c.strict_reference and iteration >= c.use_background_end:
            return 0.0
        return (iteration % 255) / 255.0

    def _maybe_add_sh_band(self, iteration: int) -> None:
        c = self.config
        if (
            iteration % c.add_sh_band_interval == 0
            and iteration >= c.add_sh_band_interval
            and self.l_max < c.max_sh_band
        ):
            if self.l_max == 0:
                zero_sh(self.state)
            self.l_max += 1

    # ------------------------------------------------------------------
    def train(self, max_iters: int | None = None, verbose: bool = True) -> None:
        c = self.config
        num_iters = max_iters if max_iters is not None else c.num_iters
        # counter-based draws: a resumed run samples what an uninterrupted
        # one would
        loader = image_io.AsyncImageLoader(
            [im.name for im in self.train_images], self.device, seed=c.seed,
            prefetch=2, start=self.iter,
        )
        bar = ProgressBar(num_iters) if verbose else None
        out_dir = Path(c.output_dir)
        eval_interval = 3000 if c.strict_reference else max(c.test_eval_interval, 1)
        nonfinite = torch.zeros((), dtype=torch.bool, device=self.device)
        window_start = self.iter
        try:
            while self.iter < num_iters:
                self._maybe_add_sh_band(self.iter)
                idx, gt = loader.next()
                cm = self._matrices(self.train_images[idx])
                self.state, metrics = train_step(
                    self.state, cm.view, cm.proj, cm.campos, gt, self._bg(self.iter),
                    self.iter, self._statics(cm),
                )
                nonfinite |= ~torch.isfinite(metrics.loss)
                densify = (
                    self.iter > c.adaptive_control_start
                    and self.iter % c.adaptive_control_interval == 0
                    and self.iter < c.adaptive_control_end
                )
                if self.iter % c.print_interval == 0 or densify:
                    if bool(nonfinite):  # one host read covers the window
                        raise FloatingPointError(
                            f"non-finite loss in iterations [{window_start}, {self.iter}]"
                        )
                    window_start = self.iter + 1
                    if bar is not None:
                        bar.update(self.iter, float(metrics.loss), num_active(self.state))

                if self.iter % c.print_interval == 0:
                    self._dump_image(cm, out_dir)

                if self.iter % eval_interval == 0:
                    self.evaluate(verbose=verbose)

                if densify:
                    self._density_step()

                if (
                    self.iter > c.reset_opacity_start
                    and self.iter % c.reset_opacity_interval == 0
                    and self.iter < c.reset_opacity_end
                ):
                    reset_opacity(self.state, c.reset_opacity_value)

                self.iter += 1
        finally:
            loader.close()
            if bar is not None:
                bar.finish()

    # ------------------------------------------------------------------
    def _density_step(self) -> DensityInfo:
        """Prune/clone/split (growing the capacity and running again when
        it does not fit), then the Morton re-sort, which runs whether or
        not the step applied."""
        ds = self._density_statics()
        seed = self.config.seed
        new_state, info = adaptive_density_step(
            self.state, ds, *split_noise(self.state, seed, self.iter))
        if info.needs_grow:
            new_cap = round_capacity(info.new_total, minimum=self.state.capacity * 2)
            new_cap = min(new_cap, round_capacity(self.config.max_gaussians))
            self.state = grow_state(self.state, new_cap)
            new_state, info = adaptive_density_step(
                self.state, ds, *split_noise(self.state, seed, self.iter))
        self.state = morton_sort(new_state)
        return info

    # ------------------------------------------------------------------
    def _dump_image(self, cm: CameraMatrices, out_dir: Path) -> None:
        out_dir.mkdir(parents=True, exist_ok=True)
        img = self.render(cm, bg=self._bg(self.iter))
        arr = np.clip(img.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
        image_io.save_image(out_dir / f"rendered_image_{self.iter}.png", arr)

    def render(self, cm: CameraMatrices, bg: float = 0.0) -> torch.Tensor:
        """(H, W, 3) image of the current Gaussians from one camera."""
        return render_image(self.state.params, cm.view, cm.proj, cm.campos, bg,
                            self._statics(cm))[0]

    def evaluate(self, verbose: bool = True) -> float | None:
        """Render every test image (black background); mean PSNR.

        A thread decodes the next image while the device renders the
        current one, and the per-image PSNRs stay on the device until one
        read at the end. Unreadable test images are skipped with a
        warning."""
        if not self.test_images:
            return None
        loads: queue.Queue = queue.Queue(maxsize=2)

        def _producer():
            for img in self.test_images:
                try:
                    gt = image_io.load_image(img.name)
                except OSError as e:
                    loads.put((img, None, e))
                else:
                    loads.put((img, gt, None))
            loads.put(None)

        thread = threading.Thread(target=_producer, daemon=True)
        thread.start()
        psnrs = []
        skipped = []
        while (item := loads.get()) is not None:
            img, gt, err = item
            if err is not None:
                skipped.append(f"{img.name}: {err}")
                continue
            pred = self.render(self._matrices(img), bg=0.0)
            psnrs.append(compute_psnr(pred, torch.from_numpy(gt).to(self.device)))
        thread.join()
        if skipped:
            warnings.warn(
                f"evaluate(): skipped {len(skipped)}/{len(self.test_images)} unreadable "
                f"test images (first: {skipped[0]})",
                stacklevel=2,
            )
        if not psnrs:
            return None
        mean = float(np.mean(torch.stack(psnrs).cpu().numpy()))
        if verbose:
            print(f"\n[ITER {self.iter}] Eval PSNR: {mean:.4f}")
        return mean

    # ------------------------------------------------------------------
    def save_to_ply(self, filename: str | Path) -> None:
        g = to_gaussian_data(self.state, self.l_max)
        sh = None if g.sh is None else g.sh.reshape(g.num, -1)
        save_ply(filename, g.xyz, g.rgb, g.opacity, g.scale, g.quaternion, sh)

    def save_checkpoint(self, path: str | Path) -> None:
        checkpoint.save_checkpoint(path, self.state, self.iter, self.l_max,
                                   cfg_hash=checkpoint.config_hash(self.config))

    def load_checkpoint(self, path: str | Path) -> None:
        ck = checkpoint.load_checkpoint(path, self.device)
        if ck.config_hash and ck.config_hash != checkpoint.config_hash(self.config):
            # Resuming under a changed config is legitimate, but never silent.
            warnings.warn(
                f"checkpoint {path} was written under a different config (hash "
                "mismatch); resumed run will not bit-reproduce the original schedule",
                stacklevel=2,
            )
        self.state, self.iter, self.l_max = ck.state, ck.iteration, ck.l_max
