"""Training orchestration (port of ``gsplat_tpu/train/trainer.py``).

``Trainer(config, gaussians, images, cameras, device)`` trains one camera a
step with the reference's schedule: ``test_train_split`` sorts the images
by name and also sends every ``test_split_ratio``-th to the test set;
``train`` runs SH band growth, densification (grow and rerun on
``needs_grow``, then the Morton re-sort), opacity resets, eval PSNR and
image dumps; ``save_to_ply`` exports the result.

``Trainer(..., dp=B)`` trains a batch of B cameras a step, one a rank of a
process group of B ranks (``parallel/data_parallel.py``); ``tp=D`` splits
each step's one camera into D strips of tile rows, one a rank
(``parallel/tile_parallel.py``). Each rank runs its own ``Trainer`` on the
replicated state: the loop, its schedule and its density steps (the same
split noise) run identically on every rank, so no rank skips a collective
and the replicas stay bit-identical; eval, image dumps, the progress bar
and the PLY and checkpoint writes happen on rank 0 only. Under dp the
cameras are bucketed by (W, H, fx, fy) and every batch draws within one
bucket (``_dp_bucket_choice``), rank r taking draw r of each batch; under
tp every rank draws the same image.

In every mode the trainer runs the reference's capacity-bounded,
monitored step: ``step.get_monitored_train_step`` alone,
``parallel.get_monitored_dp_train_step`` under dp and
``parallel.get_monitored_tp_train_step`` under tp. Each bins at a pair
and a row capacity (``_auto_pair_cap`` or ``config.pair_cap``, the row cap
half the pair cap) and keeps an on-device monitor of the window's largest
pair and row requirements and of its losses' finiteness, read once at
each print or density boundary: the capacities grow as the reference
grows them (``_grow_caps``), and a non-finite loss raises
``FloatingPointError`` for the window. Under dp and tp the monitor folds
the metrics reduced over the ranks, so every rank reads the same monitor,
grows the same caps at the same boundary and raises at the same one. On
the card the step is one CUDA graph a StepStatics (alone, and under dp and
tp over NCCL, collectives included); over gloo the dp and tp steps run
eagerly at the caps. A new StepStatics (a grown capacity, an SH band) or
a grown state gets a new graph, and the old ones are freed. The density
step, the Morton re-sort and the opacity reset write the state in place,
so a graph stays valid across them. Eval renders and image dumps go
through ``step.get_render_fn``. The split noise comes from
``density.split_noise`` (a ``torch.Generator`` seeded by
``seed * 1_000_003 + iteration``) instead of threefry.

The trainer owns one ``image_io.DecodedImages`` for its lifetime and hands
it to every loader it builds (alone, each dp bucket's, tp's), so each
training image is decoded once, on its first draw, and every later draw,
in this ``train`` call or a later one, takes the same device tensor; the
draws and the images are those of a loader without it. The cache turns
itself off where the decoded training set would pass a quarter of the
device's free memory, and the loader then decodes every draw.

``Trainer(..., mip=True)`` trains Mip-Splatting (``ops/mip.py``): the
state carries ``filter_3d``, the steps and renders run its filtered
geometry (``MipStepStatics``), and the camera sweep of the training
split (``sweep_filter_3d``) runs when ``train`` starts, after each
density step, and every ``FILTER_INTERVAL`` iterations once
densification has ended but for the run's last ``FILTER_INTERVAL``, the
published schedule. The opacity reset is the published one
(``density.reset_opacity``); the opacity prune reads the raw opacity, as
the published code's does. The PLY carries ``filter_3D``; a checkpoint
does not (``train`` sweeps first).

Traced (``utils/profiling.py``, while a torch.profiler session records),
a ``train`` call is the span ``trainer.train``, the parent of its
loader's spans (``loader.wait``, ``loader.decode``, ``loader.close``;
its counters ``loader.hits`` and ``loader.misses``) and
of ``trainer.step`` (the step's issue), ``trainer.monitor_read`` (the
boundary's host read), ``trainer.dump``, ``trainer.eval`` and
``trainer.density`` (the density step, its growth and second pass
included).
"""

from __future__ import annotations

import queue
import random
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
from ..ops import mip as mip_ops
from ..ops.loss import compute_psnr
from ..parallel import require_world
from ..parallel.data_parallel import get_monitored_dp_train_step
from ..parallel.tile_parallel import get_monitored_tp_train_step
from ..utils import checkpoint, profiling
from .density import (
    DensityInfo, DensityStatics, adaptive_density_step, morton_sort, reset_opacity,
    split_noise, zero_sh,
)
from .init import GaussianData
from .progress import ProgressBar
from .state import (
    grow_state, num_active, round_capacity, round_pair_cap, round_row_cap,
    state_from_gaussians, to_gaussian_data, with_filter_3d,
)
from .step import (
    MipStepStatics, StepStatics, fresh_monitor, get_monitored_train_step, get_render_fn,
    release_graphs,
)


def _auto_pair_cap(n_gaussians: int, width: int, height: int, tile: int = 16) -> int:
    """The reference's first pair capacity: ~8 tiles a Gaussian, never
    past every Gaussian in every tile (toy scenes stay toy-sized)."""
    n_tiles = ((width + tile - 1) // tile) * ((height + tile - 1) // tile)
    return round_pair_cap(min(8 * n_gaussians, n_gaussians * n_tiles), minimum=512)


def require_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    there is none (no silent fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on "
                           "the CPU")
    if device.type == "cuda" and (device.index or 0) >= torch.cuda.device_count():
        raise RuntimeError(f"{device} exceeds the available CUDA devices "
                           f"({torch.cuda.device_count()})")
    return device


class Trainer:
    def __init__(
        self,
        config: ConfigParameters,
        gaussians: GaussianData,
        images: dict[int, Image],
        cameras: dict[int, Camera],
        device: torch.device | str = "cuda",
        dp: int = 0,
        tp: int = 0,
        mip: bool = False,
    ):
        """``dp``/``tp`` above 1: this process is one rank of a process
        group of that many ranks (``parallel.initialize_multihost``), which
        must exist; 0 or 1 trains alone. They exclude each other. ``mip``
        trains Mip-Splatting (alone or under dp; tp refuses it)."""
        self.device = require_device(device)
        self.dp = int(dp) if dp and dp > 1 else 0
        self.tp = int(tp) if tp and tp > 1 else 0
        if self.dp and self.tp:
            raise ValueError("dp and tp modes are mutually exclusive")
        self.mip = bool(mip)
        if self.mip and self.tp:
            raise ValueError("the tile-parallel trainer (tp) does not run Mip-Splatting")
        self.rank = require_world(self.dp or self.tp) if (self.dp or self.tp) else 0
        self.config = config
        self.images = images
        self.cameras = cameras
        self.state = state_from_gaussians(gaussians, self.device,
                                          max_gaussians=config.max_gaussians)
        if self.mip:
            with_filter_3d(self.state.params)
        self._sweep_table = None  # the 3D filter's camera table, made at the first sweep
        self.iter = 0
        self.l_max = 0
        # scene extent for the density thresholds and the xyz learning
        # rate: 1.1 x the largest camera-centre distance from the centroid
        self.scene_extent = 1.1 * compute_max_diagonal(images)
        self.train_images: list[Image] = []
        self.test_images: list[Image] = []
        # The reference's capacities: the pair cap from the config or the
        # scene's size, its floor for growth (bounded by the scene's hard
        # maximum of pairs), and the row cap, grown apart from it.
        self.pair_cap = config.pair_cap or _auto_pair_cap(
            gaussians.num,
            max((c.width for c in cameras.values()), default=1024),
            max((c.height for c in cameras.values()), default=1024),
        )
        n_tiles_max = max(
            (((c.width + 15) // 16) * ((c.height + 15) // 16) for c in cameras.values()),
            default=1 << 12,
        )
        self.pair_cap_minimum = min(
            1 << 20, round_pair_cap(config.max_gaussians * n_tiles_max, minimum=2048))
        self.row_cap = max(self.pair_cap // 2, 2048)
        self._graph_key = None  # what the live graphs were captured for
        self._cam_cache: dict[int, CameraMatrices] = {}
        self._cam_tensors: dict[int, tuple] = {}
        self.test_train_split()
        # every loader's decoded ground truths, kept across train calls
        self._decoded = image_io.DecodedImages(len(self.train_images))

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

    def _camera(self, img: Image) -> tuple:
        """(view, proj, campos) of ``img`` on the device, copied there once,
        so that a step reads no host memory."""
        if img.id not in self._cam_tensors:
            cm = self._matrices(img)
            self._cam_tensors[img.id] = tuple(
                torch.as_tensor(x, dtype=torch.float32, device=self.device)
                for x in (cm.view, cm.proj, cm.campos))
        return self._cam_tensors[img.id]

    def _statics(self, cm: CameraMatrices) -> StepStatics:
        c = self.config
        return (MipStepStatics if self.mip else StepStatics)(
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
            pair_cap=self.pair_cap,
            row_cap=self.row_cap,
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

    def _dp_bucket_choice(self, k: int, buckets: list[list[int]]) -> int:
        """Counter-based, size-weighted geometry-bucket draw for iteration
        ``k``: it depends only on (seed, k), as the loader's draws do, so a
        resumed run picks the same bucket sequence, and weighting by bucket
        size keeps every image's long-run frequency equal."""
        n = len(self.train_images)
        r = random.Random(self.config.seed * 7_919 + k).randrange(n)
        for j, b in enumerate(buckets):
            r -= len(b)
            if r < 0:
                return j
        return len(buckets) - 1

    def _dp_buckets(self) -> list[list[int]]:
        """Positions of the train images grouped by camera geometry (W, H,
        fx, fy), in order of first appearance."""
        groups: dict[tuple, list[int]] = {}
        for pos, im in enumerate(self.train_images):
            cam = self.cameras[im.camera_id]
            groups.setdefault((cam.width, cam.height, cam.focal_x, cam.focal_y), []).append(pos)
        return list(groups.values())

    def _loaders(self):
        """(buckets, one loader per bucket): one bucket of every train image
        unless under dp."""
        c = self.config
        names = [im.name for im in self.train_images]
        if not self.dp:
            # under tp every rank draws the same image
            return [list(range(len(names)))], [image_io.AsyncImageLoader(
                names, self.device, seed=c.seed, prefetch=2, start=self.iter,
                cache=self._decoded)]
        buckets = self._dp_buckets()
        consumed = [0] * len(buckets)
        if len(buckets) > 1:
            for k in range(self.iter):
                consumed[self._dp_bucket_choice(k, buckets)] += 1
        else:
            consumed[0] = self.iter
        return buckets, [
            image_io.AsyncImageLoader(
                [names[p] for p in bucket], self.device, seed=c.seed + 1_000_003 * bi,
                prefetch=2, start=consumed[bi] * self.dp + self.rank, stride=self.dp,
                cache=self._decoded)
            for bi, bucket in enumerate(buckets)
        ]

    def _step(self, img: Image, gt: torch.Tensor, monitor: torch.Tensor):
        """One step on ``img``: (state, metrics, monitor)."""
        with profiling.span("trainer.step"):
            st = self._statics(self._matrices(img))
            key = (self.pair_cap, self.row_cap, self.l_max, self.state.capacity)
            if key != self._graph_key:  # the old graphs' statics are gone
                release_graphs()
                self._graph_key = key
            if self.dp:
                step = get_monitored_dp_train_step(st)
            elif self.tp:
                step = get_monitored_tp_train_step(st)
            else:
                step = get_monitored_train_step(st)
            return step(
                self.state, *self._camera(img), gt, self._bg(self.iter), self.iter, monitor)

    def _grow_caps(self, overflow: int, row_overflow: int) -> None:
        """The reference's growth at a boundary: a capacity the window's
        requirement passed grows to it plus a quarter while densifying (the
        pair count climbs, and each growth captures a new graph), a
        sixteenth after (every pair-wide kernel pays for the cap)."""
        shift = 2 if self.iter < self.config.adaptive_control_end else 4
        if overflow > self.pair_cap:
            self.pair_cap = round_pair_cap(overflow + (overflow >> shift),
                                           minimum=self.pair_cap_minimum)
        if row_overflow > self.row_cap:
            self.row_cap = round_row_cap(row_overflow + (row_overflow >> shift))

    def sweep_filter_3d(self) -> None:
        """Mip-Splatting's 3D filter from the training split's cameras,
        written into the state in place (every rank of dp the same)."""
        if self._sweep_table is None:
            self._sweep_table = mip_ops.camera_table(
                [self._matrices(img) for img in self.train_images], self.device)
        mip_ops.update_filter_3d_(self.state.params, self._sweep_table)

    def _filter_due(self) -> bool:
        """The published schedule past densification (whose steps sweep
        themselves): every ``FILTER_INTERVAL`` iterations, but not in the
        run's last ``FILTER_INTERVAL``."""
        c = self.config
        return (self.mip and self.iter % mip_ops.FILTER_INTERVAL == 0
                and self.iter >= c.adaptive_control_end
                and self.iter < c.num_iters - mip_ops.FILTER_INTERVAL)

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
        with profiling.span("trainer.train"):
            c = self.config
            num_iters = max_iters if max_iters is not None else c.num_iters
            # counter-based draws: a resumed run samples what an uninterrupted
            # one would
            buckets, loaders = self._loaders()
            lead = self.rank == 0
            bar = ProgressBar(num_iters) if verbose and lead else None
            out_dir = Path(c.output_dir)
            eval_interval = 3000 if c.strict_reference else max(c.test_eval_interval, 1)
            monitor = fresh_monitor(self.device)
            window_start = self.iter
            if self.mip:
                self.sweep_filter_3d()  # a fresh or a resumed state
            try:
                while self.iter < num_iters:
                    self._maybe_add_sh_band(self.iter)
                    bi = (self._dp_bucket_choice(self.iter, buckets)
                          if self.dp and len(buckets) > 1 else 0)
                    idx, gt = loaders[bi].next()
                    img = self.train_images[buckets[bi][idx]]
                    self.state, metrics, monitor = self._step(img, gt, monitor)
                    densify = (
                        self.iter > c.adaptive_control_start
                        and self.iter % c.adaptive_control_interval == 0
                        and self.iter < c.adaptive_control_end
                    )
                    if self.iter % c.print_interval == 0 or densify:
                        # One host read covers every step of the window.
                        with profiling.span("trainer.monitor_read"):
                            mon = monitor.cpu().tolist()
                        monitor = fresh_monitor(self.device)
                        self._grow_caps(int(mon[0]), int(mon[1]))
                        if not mon[2] > 0.0:
                            raise FloatingPointError(
                                f"non-finite loss in iterations [{window_start}, {self.iter}]"
                            )
                        window_start = self.iter + 1
                        if bar is not None:
                            bar.update(self.iter, float(metrics.loss), num_active(self.state))

                    if self.iter % c.print_interval == 0 and lead:
                        self._dump_image(img, out_dir)

                    if self.iter % eval_interval == 0 and lead:
                        self.evaluate(verbose=verbose)

                    if densify:
                        self._density_step()
                    elif self._filter_due():
                        self.sweep_filter_3d()

                    if (
                        self.iter > c.reset_opacity_start
                        and self.iter % c.reset_opacity_interval == 0
                        and self.iter < c.reset_opacity_end
                    ):
                        reset_opacity(self.state, c.reset_opacity_value)

                    self.iter += 1
            finally:
                for loader in loaders:
                    loader.close()
                if bar is not None:
                    bar.finish()

    # ------------------------------------------------------------------
    def _density_step(self) -> DensityInfo:
        """Prune/clone/split (growing the capacity and running again when
        it does not fit), then the Morton re-sort, which runs whether or
        not the step applied, and for Mip-Splatting the 3D filter's sweep."""
        with profiling.span("trainer.density"):
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
            if self.mip:
                self.sweep_filter_3d()
            return info

    # ------------------------------------------------------------------
    def _dump_image(self, img: Image, out_dir: Path) -> None:
        with profiling.span("trainer.dump"):
            out_dir.mkdir(parents=True, exist_ok=True)
            pred = self._render(img, bg=self._bg(self.iter))
            arr = np.clip(pred.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)
            image_io.save_image(out_dir / f"rendered_image_{self.iter}.png", arr)

    def render(self, cm: CameraMatrices, bg: float = 0.0) -> torch.Tensor:
        """(H, W, 3) image of the current Gaussians from one camera."""
        return get_render_fn(self._statics(cm))(self.state.params, cm.view, cm.proj,
                                                cm.campos, bg)

    def _render(self, img: Image, bg: float) -> torch.Tensor:
        """``render`` of a dataset image, its camera taken on the device."""
        return get_render_fn(self._statics(self._matrices(img)))(
            self.state.params, *self._camera(img), bg)

    def evaluate(self, verbose: bool = True) -> float | None:
        """Render every test image (black background); mean PSNR.

        A thread decodes the next image while the device renders the
        current one, and the per-image PSNRs stay on the device until one
        read at the end. Unreadable test images are skipped with a
        warning."""
        with profiling.span("trainer.eval"):
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
                pred = self._render(img, bg=0.0)
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
        """Write the alive Gaussians as a PLY (rank 0 only)."""
        if self.rank != 0:
            return
        g = to_gaussian_data(self.state, self.l_max)
        sh = None
        if g.sh is not None and g.sh.size:
            sh = g.sh.reshape(g.num, -1)
        filter_3d = self.state.params.filter_3d
        if filter_3d is not None:
            filter_3d = filter_3d[self.state.alive].cpu().numpy()
        save_ply(filename, g.xyz, g.rgb, g.opacity, g.scale, g.quaternion, sh, filter_3d)

    def save_checkpoint(self, path: str | Path) -> None:
        """Write the state, iteration, SH band and capacities (rank 0
        only)."""
        if self.rank != 0:
            return
        checkpoint.save_checkpoint(path, self.state, self.iter, self.l_max,
                                   cfg_hash=checkpoint.config_hash(self.config),
                                   pair_cap=self.pair_cap, row_cap=self.row_cap)

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
        if self.mip:  # the checkpoint holds no filter: train() sweeps first
            with_filter_3d(self.state.params)
        if ck.pair_cap:
            self.pair_cap = ck.pair_cap
        # 0: a checkpoint from before the row cap, sized as the reference does
        self.row_cap = ck.row_cap or max(self.pair_cap // 2, 2048)
