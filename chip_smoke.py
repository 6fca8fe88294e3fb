#!/usr/bin/env python3
"""Drive the PyTorch port's render, training step and trainer on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (``gsplat_tpu_torch/csrc``) with nvcc for
sm_90a, then runs its entry points in their default mode, the JAX
package's packed mode (f16/bf16/e5s9 pair attributes and packed gradient
words), and its exact f32 mode where named
(``gsplat_tpu_torch.train.step.exact_mode``):

1. prints the card (nvidia-smi name and power limit), torch and CUDA;
2. builds the kernels and prints the build time, ptxas's register use,
   the instructions of expf in the forward rasterizer and, from its SASS
   (cuobjdump), the instructions and shared-memory loads of its pair loop;
2b. holds the radix sort bit-equal to ``torch.sort(stable=True)``, keys and
   permutation, at n = 0, 1, tile - 1, tile, tile + 1 and larger, on
   random keys, equal keys and keys that differ only in the last pass's
   digit, for key_bits 1, 20, 29 and 31;
2c. holds the segment expand bit-equal to its plain version on adversarial
   counts (``expand_edge_counts``: a run longer than many blocks' shares,
   long stretches of zero counts, every slot in the last record, a single
   record, merged sizes around a multiple of a block's share);
3. compares each kernel with its plain PyTorch version on the card, at the
   shapes of one view of the bench scene at 100K Gaussians (segment expand
   at both binning levels, each level's records, slots, time and bound
   printed; the radix sort bit-equal; the forward rasterizer in exact and in packed
   mode, image PSNR >= 60 dB, n_splats equal on >= 99.9 % of pixels, a
   rerun bit-identical);
4. checks a small scene rendered on the card against the port's CPU path
   (which the CPU tests hold against the JAX package);
5. renders the bench scene (1296x840, tile 16, SH degree 3) at 1,000,000
   Gaussians from 2 views through ``render_image``: pairs, median ms and
   Mpix/s per view, finite images, every forward kernel launched, and a
   bit-identical re-render;
6. times each forward kernel against its plain version at the 1M view's
   shapes;
7. compares the backward kernels with their plain versions at 100K
   Gaussians, bench view, random image cotangent, in exact and in packed
   mode (backward rasterizer float32 rows within 1e-3 of each row's
   largest |value| and bit-identical on a rerun; packed: its words
   bit-equal to ``packing.pack_grad_rows`` of its own float32 rows on the
   same inputs, bit-identical on a rerun, and unpacked within that bound
   plus one rounding step of the word format of the plain version's words;
   rows and words stored at binning's ``pair_cand``; segment sum of the
   rows or the words, as stored, at rtol 1e-5 and bit-identical on a
   rerun, whether it is bit-equal to the plain version on the CPU printed;
   and the segment sum bit-equal to its plain version on adversarial runs,
   ``segsum_edge_runs``: Gaussians without pairs, one run longer than a
   block's share of rows, a capped tail of NaN rows past ``pair_start[N]``);
8. runs one ``train_step`` of a small scene (20K Gaussians, 320x200) on the
   card and on the port's CPU path, in each mode: loss, gradients, moments
   and accumulators must agree;
9. trains a perturbed copy of the 1M scene for 8 steps over the 4 views
   rendered from the scene itself (``train_step``), in packed mode, then
   from the same start in exact mode: loss, ms per step and pairs; finite
   losses, a lower mean loss on the second pass, every kernel of the
   mode's path launched (the packed run only packed rasterizers and
   segment sums, the exact run none), the radix sort exactly once per step
   (the tile sort; the backward sorts nothing), peak memory, and
   bit-identical gradients from two calls on the same state; then
   torch.profiler over TRAIN_PROFILE_STEPS more steps of each mode, in
   windows of half as many taken in turns (packed, exact, exact, packed):
   device ms per step, the device's busy share, and the device time of
   each kernel; and the two modes' losses and device ms per step side by
   side;
10. times the backward kernels against their plain versions at the 1M
    view's shapes;
11. trains through ``Trainer.train`` at full width: the true scene is
    ``scene_arrays(1_000_000, seed=0)``, 8 COLMAP cameras at distinct
    centres on a circle of radius 1.5 in the z = 0 plane look at (0, 0, 6)
    (1296x840, focal 0.85 W) and their ground truths are rendered in
    memory; the start is the true centres plus N(0, 0.05^2) jitter through
    ``initialize_gaussians`` (its KNN's seconds printed); the config is
    configs/base.yaml read by the port's reader with a 24-iteration
    schedule in which every event fires (density steps with the Morton
    re-sort at 4, 8, 12 and 16, an opacity reset at 10, SH bands at 5, 10
    and 15, eval at 0 and 12, image dumps at 0 and 12), ``train`` called
    twice (to 11, then 24). Image reads and writes go to in-memory
    stand-ins (the card's host may lack PIL). Checks: finite losses; a
    view's loss falls between consecutive draws of it with no density step
    or reset between; every density step's counts and capacity printed, at
    least one applied; after each Morton sort the alive rows are a prefix
    and K3's permutation of the codes is bit-equal to
    ``torch.sort(stable=True)``'s; the morton site launched once per
    density step; alive opacities equal logit(0.05) right after the reset;
    l_max reaches 3; finite eval PSNRs; the PLY's vertex count equals the
    alive count. Prints ms per iteration (with and without a density
    step), the density step's and the Morton sort's ms, eval ms per view,
    peak memory and launches by site, then times K3 at the morton site's
    shapes (the final capacity's codes);
12. runs ``adaptive_density_step`` on a small scene (20K Gaussians) that
    needs twice its capacity, ``grow_state`` and the step again, and one
    ``morton_sort``, on the card and on the CPU with the same injected
    noise (alive, layout and moments equal; split children's xyz
    and scale within 4 units in the last place of their column's largest
    value; the sort of one state bit-equal), then trains a 320x200 scene
    to iteration 7, saves a checkpoint, goes on 2 iterations, and resumes
    a fresh ``Trainer`` from the checkpoint for the same 2: bit-identical;
13. spawns two ranks on the card, joined over gloo (``parallel_rank``),
    each with the 1M scene of [9] and its 4 views; every step bins at the
    caps ``frame_caps`` sizes for the start's frames (each requirement plus
    a sixteenth), through the parallel factories, which run eagerly over
    gloo. Data parallel: the same camera on both ranks for 3 steps is
    bit-identical to the graphed single step at the caps (loss, pair
    count, requirements, state), the accumulators exactly twice its;
    views 0 and 1 give reduced gradients within rtol 1e-5 of the mean of
    the two single-camera gradients; 4 monitored steps keep finite losses,
    bit-identical replicas (checksums of every tensor's bytes, gathered)
    and the same monitor on both ranks.
    Tile parallel, in exact mode, at 1296x832 (26 tile rows a strip):
    image, loss and pairs equal the single step's, the parameters after
    one step within 2e-5; at 1296x840 (R10) the loss equals and the uv
    gradient's v column is the single step's x 840/848 within rtol 1e-5;
    3 monitored steps, replicas and monitors the same on both ranks.
    ``Trainer(dp=2)`` and ``Trainer(tp=2)`` on [11]'s cameras with a
    100K-point cloud, 12 iterations (a density step at 5, an opacity
    reset at 10), from a pair cap of the state's capacity, which the
    first window outgrows: replicas bit-identical, every boundary's caps
    grown by the reference's rule (``grows_by_rule``) and equal on both
    ranks. Every kernel must launch on every rank on this path. Prints ms
    a step of the graphed single step (rank 0 alone), the dp step and the
    tp step, with the collectives' host ms: two ranks sharing one card,
    not a scaling figure.
14. runs the modules ported last. (a) The C++ host runtime
    (``io/native.py``, built by g++ at first use into
    ``gsplat_tpu_torch/_build/``) on a cloud of [11]'s kind at
    NATIVE_POINTS points: its KNN mean distance against scipy's cKDTree
    (rtol 1e-6), a points3D.bin written by the port's writer parsed by the
    native parser and the Python reader (equal arrays), and its PLY writer
    against ``io/ply.py``'s (equal bytes, else the first differing offset),
    each with both times. (b) ``build_tile_tables(depth_rank=)`` at the
    100K bench view (4,293 tiles take 13 key bits and the capacity 2^17
    takes 17: the 30-bit budget exactly full): each tile's pair set equal
    to the default mode's, each tile in strictly ascending rank, the tables
    equal to the CPU path's (a pair on one side only must lie within 1e-2
    px of a tile edge in float64, R5), one tile sort launched; the render's
    PSNR against the default mode, and the radix sort timed at the 30-bit
    keys beside the default mode's. (c) ``tools/e2e_synthetic.py``'s
    recipe for E2E_ITERS iterations on the card (16 views at 384x256 of
    1,200 true Gaussians, 4,000 points, ``Trainer`` with density steps and
    SH bands): PSNR before and after, the gain (above 6 dB), iterations a
    second, the final Gaussians and the PLY's size, every kernel of the
    packed path launched (the Morton site included); images through PIL on
    disk. (d) ``StageTimers``' report of (c)'s stages, and ``device_trace``
    over two more train steps: the trace file's size and its device
    kernels (> 0).
15. drives the configuration's ceiling. (a) ``tools/bench_scale.py``'s
    train step at SCALE_N = 4,250,000 Gaussians (configs/base.yaml's
    max_gaussians), capacity 6,291,456 (2^22 + 2^21), 1296x840, SH 3, in
    the packed (default) mode, at the JAX package's two recorded scale
    points (scale_mul 0.97 and 1.52, ``SCALE_r04.json`` and
    ``SCALE_WIDE_r04.json``): one step, then 3 x 6 timed by CUDA events;
    pairs and tile rows beside the recorded counts with their relative
    difference, ms a step, peak allocated memory, a device profile of
    SCALE_PROFILE_STEPS more steps; every kernel of the packed path
    launched (K5 twice a step, the tile sort, K1, K2 and K4 packed, once a
    step, masked Adam once a parameter group); one exact-mode step from the
    same state (finite loss, its pairs those of the packed path on that
    state, no packed launch). At 0.97 also: two gradient calls on one state
    bit-identical, and every kernel against its plain version at these
    shapes as in [3], [6], [7] and [10] (K1 and K2 on the whole frame),
    timed beside its bound and library call, and printed beside the 1M
    view's times. (b) ``tools/train_at_scale.py`` at half its default
    length, SCALE_ITERS (1,000) iterations with every event of its
    schedule at half the iteration (LONG_RUN_SCHEDULE; 1296x840, 24 views
    of 6,000 true Gaussians, a 20,000-point start, max_gaussians 2M):
    finite losses (kept on the card, read at the end), density steps at
    the schedule's iterations (200 to 800), the capacity growing exactly
    at the steps whose new total exceeds it (from 20,000 points it stays
    at 32,768), alive opacities equal to logit(0.05) right after the
    schedule's one reset (at 750), l_max 3, eval PSNR higher after than before, the PLY's vertex count
    equal to the alive count, the checkpoint reloaded into a fresh
    ``Trainer`` bit-identical, every kernel of the packed path launched
    and the Morton site once a density step; iterations a second, ms an
    iteration with and without a density step (CUDA events between
    iteration starts), the density step's ms and peak memory; images
    through PIL on disk. (c) the same from a SPARSE_POINTS (2,000) point
    start, with the same checks and at least two capacity growths. After
    every Morton sort of (b) and (c) the alive rows must be a prefix.
16. runs the photo recipes on ``procedural_texture`` (seed 0, 1536x1024:
    eight octaves of value noise with a 1/f amplitude spectrum, a
    gradient, 400 hard-edged discs and rectangles), written to a temporary PNG with its sha256 printed: the
    reference photo is not in the repository. (a) ``tools/overfit_real.py``
    at its defaults (2,000 steps of 10,000 Gaussians on the texture itself,
    SH 3, no density control): finite losses, the PSNR at the end above
    the first step's, every kernel of the packed step launched; PSNR every
    200 steps, pairs, ms a step (CUDA events), peak memory. (b)
    ``tools/quality_gate.py``'s fixed recipe (``quality_gate.run``): the
    layers dataset of the texture, 32 views at 1296x840 (its seconds
    printed), 7,000 iterations of configs/base.yaml's scaled schedule,
    ``uv_grad_threshold`` x0.4, seed 0, 28 train and 4 held-out views:
    finite losses (kept on the card, read at the end), density steps at
    the schedule's iterations (600 to 4,900), the capacity growing exactly
    at the steps whose new total exceeds it and at least DENSE_MIN_GROWTHS
    (3) times, the alive rows a prefix after every Morton sort and the
    Morton site launched once a density step, alive opacities equal to
    logit(0.05) right after the reset at 3,000, l_max 3, no held-out view
    in the train list, the held-out PSNR higher after than before, every
    kernel of the packed path launched; prints the capacities, each
    density step's counts and ms, it/s, ms an iteration with and without
    a density step, pairs a step, peak memory and the final Gaussians
    beside the JAX package's 625,898 (on the reference photo: context, not
    a target), a device profile of DENSE_PROFILE_STEPS (8) more steps on
    the final state, and the ms ``io.images.load_image`` takes to decode a
    view (the trainer's loader decodes one an iteration).
    (c) ``quality_gate.gate`` and ``main`` (with ``run`` stood in by (b)'s
    result, no training) against a prior result written into a temporary
    ``--out``: of the same texture 1 dB above (refused, exit 1), 0.1 dB
    below (passes), of another texture above (ignored). The 30,000
    iterations of ``tools/extended_run.py`` get no run here; its CPU tests
    and (b), which trains through the same ``train_holdout``, hold it.
17. drives the reference's compiled step: binning at fixed capacities,
    the on-device monitor, and the step and render as CUDA graphs
    (``train.step.get_train_step``, ``get_monitored_train_step``,
    ``get_render_fn``; the trainer's path since [11]). (a) At [9]'s 1M
    view, caps ``round_pair_cap(req + req >> 4)`` and the row cap alike
    (req: the frame's requirement, sentinels counted): the capped tables'
    live part bit-equal to the exact tables, ``splat_gid``'s tail -1, the
    requirements equal to the exact tables' and the row requirement to
    ``bench_scale.row_totals``' count; the tile sort of the capped keys
    (the tail keyed past every pair) beside the exact keys' sort, and
    binning's time at each sizing. (b) A 20K-Gaussian scene at 320x200
    binned at caps one bucket short of both requirements, on the card and
    on the CPU from the same inputs: kept pairs, requirements and tile
    counts equal, each tile's kept set equal. (c) From one start,
    GRAPH_STEPS (8) steps of [9]'s views eager at exact sizing, eager at
    the caps and through the graph, in packed and in exact mode: losses
    and every tensor of the states bit-identical. (d) The graph's replays
    run under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in
    one fails); its run launches every kernel of the mode's path, the
    tile sort once a step and masked Adam once a parameter group a step
    (ADAM_GROUPS), from one capture. (e) [11]'s run again with the
    trainer's factories eager: every loss, the caps of every step, the
    density steps' counts, the state's checksums and the PLY bytes
    bit-identical to [11]'s graphed run; prints [11]'s captures. (f) [9]'s
    steps in windows of GRAPH_WINDOW (24) taken in turns (eager at exact
    sizing, graph, graph, eager): wall and process-CPU ms a step, then a
    profile of each (device ms, device kernels and the host's launch
    calls a step) and each path's peak allocated MiB, in each mode.
    (g) A capture that meets a host read raises, and the state is left as
    it was (no eager fall-back). [14c] also runs the recipe with eager
    factories (its rate beside the graph's, the same eval PSNR) and
    [15a] runs at the JAX script's capacities of each point (from
    ``SCALE_*.json``), an eager step at exact sizing beside it at 0.97.
18. opens a one-rank NCCL group on the card (``initialize_multihost``
    with one process; NCCL refuses two ranks on one device) and, at
    [17]'s caps on [9]'s 1M scene and views, for dp and then tp
    (``nccl_graph_slice``): (a) NCCL_STEPS (8) steps eager
    (``dp_train_step`` / ``tp_train_step``, the monitor folded) and
    through ``get_monitored_dp_train_step`` / ``get_monitored_tp_train_step``,
    whose graph holds the whole step, collectives included: losses,
    counts, monitors and states bit-identical, one capture; the eager
    steps after the first (which makes the communicator) and the replays
    under ``torch.cuda.set_sync_debug_mode("error")``; (b) every kernel of
    the packed path counted at the replays, the tile sort once a step,
    masked Adam once a parameter group a step; (c)
    eager and graph in windows taken in turns as [17f]: wall, process CPU,
    issue and device ms a step, busy share, launch calls (one
    ``cudaGraphLaunch`` a step), peak MiB. A failed group or capture
    raises.
19. holds masked Adam's kernel (``kernels/adam.py``, ``csrc/adam.cu``)
    against its plain version at [9]'s 1M start and [15a]'s 4.25M scene
    (``adam_table``): the packed gradient call's mask and gradients step
    the scene's state once, then each parameter group through each
    version from copies of one start, bit-equal, and each timed in a CUDA
    graph (``graph_ms``) beside ``kernel_bound``; then a step's six groups
    in order and ``apply_adam`` whole, through each.
20. holds the SH colour kernels (``kernels/sh.py``, ``csrc/sh.cu``)
    against their plain versions at the 1M and 4.25M capacities
    (``sh_table``: 2^20 and 6,291,456 rows at l_max 3, the colour gradient
    a strided view of (N, 9) attribute rows): the forward against
    ``ops/sh.py::sh_to_rgb``, the backward against
    ``sh_to_rgb_backward_plain``, then each timed in a CUDA graph beside
    ``kernel_bound`` and the plain chain (the forward, and the forward
    with autograd's backward, as the step ran them before the kernels).
22. holds the covariance kernels (``kernels/covariance.py``,
    ``csrc/covariance.cu``) against the plain ops at the 1M and 4.25M
    capacities, for plain 3DGS and Mip-Splatting (``covariance_table``:
    ``covariance_inputs`` at 2^20 and 6,291,456 rows): the forward bit for
    bit (the rows whose radius differs counted), the backward against
    float64 autograd through the plain ops beside the plain float32 chain,
    then each timed in a CUDA graph beside ``kernel_bound`` and the plain
    chain (the forward, and the forward with autograd's backward).

Beside each kernel's time at the 1M view it prints the plain version's,
the one PyTorch call that computes the same function (``library_ms``:
``repeat_interleave``, ``torch.sort(stable=True)``, ``index_add_``; none
for the rasterizers and the packed segment sum; the radix sort at both
call sites, the tile sort and the density step's Morton re-sort), and the
least time an H100 could take
for the work (``kernel_bound``; for the rasterizers from the pair-pixels
these inputs need and those of them past the 1/255 cutoff,
``pair_pixel_counts``), then orders the kernels by launches per train step
x (time - bound). Prints one JSON line of kernels (the rasterizers and the
segment sum once a mode, ``"mode"``; launches from [9]'s run of that
mode, ``launches_e2e`` from [14c]'s, ``launches_scale`` from every run
of [15] (its exact steps give the exact entries; no run of [15] takes
``depth_rank``), ``launches_recipes`` from [16a] and [16b],
``launches_nccl_graph`` from [18]'s graphed runs (dp and tp), ``scale``
the kernel's times at the 4.25M point; the
radix sort also in [14b]'s ``depth_rank`` mode; masked Adam, which
replaces no TPU kernel, with [19]'s sums a step), then the nvidia-smi
line, then the result line ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero. Exits non-zero at once when no CUDA
device is present.

    python3 chip_smoke.py --trainer

runs [1] and [11] alone, with its checks (no result line).

    python3 chip_smoke.py --capacity

runs [1], [11] and [17] alone, with their checks (no result line).

    python3 chip_smoke.py --parallel

runs [1] and [13] alone, with its checks (no result line).

    python3 chip_smoke.py --nccl

runs [1] and [18] alone, with its checks (no result line).

    python3 chip_smoke.py --e2e

runs [1] and [14] alone, with its checks (no result line): about 90 s on
an H100 80GB HBM3 at 700 W, the e2e recipe's 600 iterations 20-26 s of
it and the 1M-point Python reader 7-10 s.

    python3 chip_smoke.py --scale

runs [1] and [15] alone, with its checks (no result line).

    python3 chip_smoke.py --recipes

runs [1] and [16] alone, with its checks (no result line).

    python3 -P chip_smoke.py --train-profile

runs [1] and [9]'s train steps and a profile of TRAIN_PROFILE_STEPS more
alone, in each mode, without checks, with the
``gsplat_tpu_torch`` that the import path finds first: with ``-P`` and
``PYTHONPATH`` set to another checkout (an earlier commit unpacked by
``git archive``), one copy of this script profiles that checkout's train
step, so that two trees compare in one call.

    python3 -P chip_smoke.py --wall

runs [1] and [9]'s train steps alone, without checks, with the
``gsplat_tpu_torch`` that the import path finds first, as above: in each
mode from the same start (the packed mode's state freed before the exact
mode's starts), TRAIN_STEPS steps to warm up, then WALL_STEPS more, each
between two device synchronizations, and prints the median wall ms and
process CPU ms (host time the process spent on its own threads) a step. A
checkout from before the packed mode times its one (exact) mode. Run in
several processes of two checkouts taken in turns, it says whether a
change moved the host's cost of a step.

    python3 -P chip_smoke.py --scale-profile

runs [1] and [15a]'s step at scale_mul 0.97 alone, without checks: the
4.25M-Gaussian step through ``tools/bench_scale.run`` at the JAX script's
caps, then a device profile of SCALE_AB_STEPS more steps in the default
mode, with the ``gsplat_tpu_torch`` that the import path finds first, as
above.

    python3 -P chip_smoke.py --bits

runs [1] and prints, in packed and in exact mode, the sha256 of one
gradient call's segment-sum output and of its target, image, loss and
gradients, at [9]'s 1M start and at [15a]'s 4.25M scene, then of the
whole state after ``apply_adam`` steps it with the packed call's
gradients at iterations 3000 and 3001, and of each call's forward (image,
loss, tile tables) apart, then of a Mip-Splatting render and gradient call
at the 1M start, with the ``gsplat_tpu_torch`` that the import path finds
first, as above: equal digests of two checkouts show a mode, and the
update, bit for bit unchanged; equal forward digests show the forward
unchanged where the gradients' rounding moved.

    python3 chip_smoke.py --adam

runs [1] and [19] alone, with its checks (no result line).

    python3 chip_smoke.py --sh

runs [1] and [20] alone, with its checks (no result line).

    python3 chip_smoke.py --mip

runs [1] and [21] alone, with its checks (no result line).

    python3 chip_smoke.py --covariance

runs [1] and [22] alone, with its checks (no result line).
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

WIDTH, HEIGHT, TILE = 1296, 840, 16
BG = 0.2
REPLACES = {
    "segment_expand": "gsplat_tpu/kernels/expand.py:310",
    "radix_sort": "gsplat_tpu/kernels/sort.py:514",
    "rasterize_forward": "gsplat_tpu/kernels/rasterize.py:486",
    "rasterize_backward": "gsplat_tpu/kernels/rasterize.py:815",
    "segment_sum": "gsplat_tpu/kernels/segsum.py:139",
}
SOURCES = {
    "segment_expand": "gsplat_tpu_torch/csrc/expand.cu",
    "radix_sort": "gsplat_tpu_torch/csrc/sort.cu",
    "rasterize_forward": "gsplat_tpu_torch/csrc/rasterize_fwd.cu",
    "rasterize_backward": "gsplat_tpu_torch/csrc/rasterize_bwd.cu",
    "segment_sum": "gsplat_tpu_torch/csrc/segsum.cu",
}
TRAIN_STEPS = 8
ADAM_GROUPS = 6  # masked Adam's launches a step at SH degree 3: one a parameter group
TRAINER_VIEWS = 8  # [11]: cameras at distinct centres
TRAINER_ITERS = 24  # [11]: iterations of Trainer.train
# [9] and --train-profile: train steps under torch.profiler after the timed
# ones, in each mode. 16 resolve ~0.01 ms/step of device time between two
# checkouts (three runs of one within 0.010 on an H100); 4 spread up to 0.34.
TRAIN_PROFILE_STEPS = 16
PROFILE_TOP = 10  # [9]: other kernels listed by device time
WALL_STEPS = 32  # --wall: timed train steps a mode, after TRAIN_STEPS to warm up
NATIVE_POINTS = 1_000_000  # [14a]: the cloud of [11]'s size
E2E_ITERS = 600  # [14c]: tools/e2e_synthetic.py's recipe at its full length
REMAINING_TITLE = ("[14] native host runtime, depth_rank binning, the e2e recipe and "
                   "profiling")
PARALLEL_TITLE = ("[13] dp and tp steps and Trainer(dp=2)/(tp=2) at the caps, two ranks on one "
                  "card over gloo, 1M Gaussians at 1296x840 and 1296x832")
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): device
# memory bytes/s and FP32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations the rasterizers need per pair-pixel, counted from the
# kernel sources (an FMA is 2; a multiply, add, reciprocal, compare or min
# is 1). expf is 10: 4 FFMA, 1 FADD and 1 FMUL beside an integer shift and
# a MUFU.EX2 in the compiled rasterizers ([2] prints its instructions).
# Every pair-pixel of a pixel's n_splats: dx, dy 2; power 11 (7 mul, 2 add,
# the -0.5 mul, min); expf 10; alpha 2 (mul, min); the 1/255 cutoff 1.
ALPHA_OPS = 26
# Only a pair-pixel past the cutoff goes on. K1 (csrc/rasterize_fwd.cu):
# T (1 - alpha) 2; the T test 1; w 1; three colour FMAs 6.
K1_PASS_OPS = 10
# K2 (csrc/rasterize_bwd.cu): 1 - alpha and its reciprocal 2; T 1; c . dI
# 5; w 1; grad_alpha 3; the sum behind the splat 2; d/d power 2; the nine
# values added into the pixel sums 5 + 5 + 4 + 3 + 4 + 1 + 6.
K2_PASS_OPS = 44
# Pixels a warp of each rasterizer holds: 32 threads x 4 pixels of a row.
K1_WARP_PIXELS = 128
K2_WARP_PIXELS = 128
# Packed mode (csrc/packing.cuh), operations a pair, counted from the
# source as above (a conversion, shift, mask, compare or select is 1):
# rounding a staged pair (round_pair_attrs: two f16 offsets 2 x 10, seven
# bf16 roundings 7 x 2, the e5s9 pack 35 and unpack 18), once per pair a
# rasterizer stages; K2's words (three bf16 pairs 3 x 5, the e5s9 pack 35),
# once per pair up to every tile's deepest n_splats (the rows past it all
# take one zero row's words, packed once a thread); K4's unpacking of a word
# row (three bf16 pairs 3 x 2, the e5s9 unpack 15).
PACK_ATTR_OPS = 87
PACK_GRAD_OPS = 50
UNPACK_GRAD_OPS = 21
# Masked Adam (csrc/adam.cu), operations a stepped element, counted as
# above: the NaN select 1; m' 3; v' 4; the two bias divisions 2; the square
# root and + EPS 2; -lr m^ and its division 2; p + step 1.
ADAM_OPS = 15
# SH colour (csrc/sh.cu), f32 bytes a row: the forward reads xyz, dc and 45
# SH floats and writes rgb; the backward reads xyz, the SH floats and the
# colour gradient and writes the gradients of xyz, dc and sh.
SH_FORWARD_BYTES = 4 * (3 + 3 + 45 + 3)
SH_BACKWARD_BYTES = 4 * (3 + 45 + 3 + 3 + 3 + 45)
# Covariance (csrc/covariance.cu), f32 bytes a row: the forward reads xyz_c,
# quat, scale and the opacity logit and writes the conic and the radius
# record; the backward reads the conic's gradient, xyz_c, quat and scale and
# writes their gradients. Mip-Splatting adds the filter to each pass, the
# opacity scale to the forward's writes and its gradient to the backward's
# reads.
COVARIANCE_FORWARD_BYTES = 4 * (3 + 4 + 3 + 1 + 3 + 5)
COVARIANCE_BACKWARD_BYTES = 4 * (3 + 3 + 4 + 3 + 3 + 4 + 3)
COVARIANCE_MIP_BYTES = 4 * 2  # each pass, under Mip-Splatting


def kernel_bound(name: str, packed: bool = False, **work) -> dict:
    """The least time an H100 could take for one kernel's work.

    Bytes count each input read once and each output written once; FP32
    operations count what these inputs need. For the rasterizers that is
    ALPHA_OPS for each of ``pair_pixels`` (the sum of the forward's
    n_splats row) and the kernel's PASS_OPS for each of ``passing`` (those
    of them past the 1/255 cutoff, ``pair_pixel_counts``). ``work`` keys:
    ``expand`` [(cols, records, total)] (segment_expand), ``keys``
    (radix_sort), ``gaussians``, ``pairs``, ``tiles``, ``pair_pixels``,
    ``passing``, ``reached`` (rasterizers; segment_sum takes gaussians and
    pairs; masked_adam ``stepped``, the elements of the rows that step,
    and ``rows``, the mask bytes read, both summed over the groups: a
    stepped element reads param, grad and both moments and writes param
    and moments, 28 bytes; sh_forward and sh_backward ``rows``, bytes
    only, SH_FORWARD_BYTES and SH_BACKWARD_BYTES a row: their hundred-odd
    operations a row take < 4 % of its byte time). ``packed``: the packed
    mode's rasterizers also round each pair up to every tile's deepest
    n_splats (``reached``), K2 writes 16-byte word rows and packs those it
    reaches, K4 reads and unpacks every row. ``filter3d``: ``rows`` (the
    capacity walked) and ``tests`` (alive Gaussians x cameras), at
    FILTER3D_ROW_BYTES a row and FILTER3D_TEST_OPS a test.
    ``covariance_forward`` and ``covariance_backward``: ``rows`` and ``mip``,
    bytes only (COVARIANCE_*_BYTES a row; its few hundred FP32 operations a
    row stay below the byte time).
    Returns bytes, ops, bound_ms and bound_by ("bytes" or "operations").
    """
    pix = TILE * TILE
    if name == "segment_expand":  # records and offsets in, columns out
        nbytes = sum(4 * (c * r + r + 1 + c * t) for c, r, t in work["expand"])
        ops = 0
    elif name == "radix_sort":  # keys in; sorted keys and permutation out
        nbytes, ops = 12 * work["keys"], 0
    elif name in ("rasterize_forward", "rasterize_backward"):
        g, p, t = work["gaussians"], work["pairs"], work["tiles"]
        # attribute rows, splat_gid, tile_start and tile_count; 5 output rows
        nbytes = 36 * g + 4 * p + 8 * t + 4 * 5 * pix * t
        ops = ALPHA_OPS * work["pair_pixels"]
        if packed:
            ops += PACK_ATTR_OPS * work["reached"]
        if name == "rasterize_forward":
            ops += K1_PASS_OPS * work["passing"]
        else:  # + the image cotangent and pair_cand in, one row (9 floats or
            # 4 words) per pair out
            nbytes += 4 * 3 * pix * t + 4 * p + (16 if packed else 36) * p
            ops += K2_PASS_OPS * work["passing"]
            if packed:
                ops += PACK_GRAD_OPS * work["reached"]
    elif name == "segment_sum":  # contiguous rows and pair_start in; sums out
        p, g = work["pairs"], work["gaussians"]
        row_bytes = 16 if packed else 36  # 4 words or 9 floats a pair
        nbytes = row_bytes * p + 4 * (g + 1) + 36 * g
        ops = ((9 + UNPACK_GRAD_OPS) if packed else 9) * p
    elif name == "masked_adam":
        nbytes = 28 * work["stepped"] + work["rows"]
        ops = ADAM_OPS * work["stepped"]
    elif name in ("sh_forward", "sh_backward"):
        nbytes = (SH_FORWARD_BYTES if name == "sh_forward" else SH_BACKWARD_BYTES) * work["rows"]
        ops = 0
    elif name in ("covariance_forward", "covariance_backward"):
        row = COVARIANCE_FORWARD_BYTES if name == "covariance_forward" else \
            COVARIANCE_BACKWARD_BYTES
        nbytes = (row + (COVARIANCE_MIP_BYTES if work.get("mip") else 0)) * work["rows"]
        ops = 0
    elif name == "filter3d":  # xyz, alive and the depth a row; every test's operations
        nbytes = FILTER3D_ROW_BYTES * work["rows"]
        ops = FILTER3D_TEST_OPS * work["tests"]
    else:
        raise ValueError(f"no bound for {name}")
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / FP32_OPS_PER_S
    return dict(bytes=nbytes, ops=ops, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_sass(lib_path: str, kernel: str) -> list | None:
    """A kernel's SASS by cuobjdump, as (address, opcode, operands) rows,
    branch targets given as addresses; None if it cannot be read."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                              timeout=120).stdout
    except OSError:
        return None
    for body in sass.split("Function : ")[1:]:
        if kernel not in body.split("\n", 1)[0]:
            continue
        rows, labels = [], {}
        for line in body.splitlines():
            label = re.match(r"\s*(\.L_x_\d+):", line)
            if label:
                labels[label.group(1)] = len(rows)
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                          r"([^;]*);", line)
            if m:
                rows.append([int(m.group(1), 16), m.group(2), m.group(3)])
        for row in rows:  # labels -> the address of the row they precede
            ref = re.search(r"\(?(\.L_x_\d+)\)?", row[2])
            if ref and ref.group(1) in labels and labels[ref.group(1)] < len(rows):
                row[2] = hex(rows[labels[ref.group(1)]][0])
        return rows
    return None


def exp_instructions(rows: list | None) -> str:
    """The opcodes from 10 before a kernel's first MUFU.EX2 (the hardware
    exp2 inside expf) to 2 after."""
    ops = [op for _, op, _ in rows or []]
    if "MUFU.EX2" not in ops:
        return "not found in cuobjdump's output"
    i = ops.index("MUFU.EX2")
    return " ".join(ops[max(0, i - 10):i + 3])


def exp_loop_counts(rows: list | None) -> dict | None:
    """The innermost loop around a kernel's first MUFU.EX2 (the shortest
    backward branch that jumps over it): its instructions, shared-memory
    loads (LDS*), and MUFU.EX2s (one a pair-pixel in the rasterizers)."""
    if not rows:
        return None
    exp_at = next((a for a, op, _ in rows if op == "MUFU.EX2"), None)
    loops = []
    for addr, op, arg in rows:
        m = re.search(r"0x([0-9a-f]+)", arg)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= (exp_at or -1) < addr:
            loops.append((int(m.group(1), 16), addr))
    if not loops:
        return None
    lo, hi = min(loops, key=lambda r: r[1] - r[0])
    body = [op for a, op, _ in rows if lo <= a <= hi]
    return dict(instructions=len(body), lds=sum(op.startswith("LDS") for op in body),
                exp=body.count("MUFU.EX2"))


def ptxas_usage(build_log: str, kernel: str) -> str:
    """ptxas's resource line (registers, barriers, shared memory) for a
    kernel, from the -Xptxas -v build log."""
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            for nxt in lines[i + 1:]:
                if "Used" in nxt and "registers" in nxt:
                    return nxt.split(":", 1)[-1].strip()
    return "not in the build log"


def scene_arrays(n: int, seed: int, perturb_seed: int | None = None):
    """bench.py's _scene recipe, plus sh ~ N(0, 0.1), padded to
    round_capacity(n): (params as host arrays, alive). ``perturb_seed``
    gives the copy a training run starts from: rgb + N(0, 0.3^2) noise and
    opacity logits - 0.5."""
    from gsplat_tpu_torch.train.state import round_capacity

    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * [2.0, 1.4, 1.2] + [0, 0, 6.0]
    rgb = rng.normal(size=(n, 3))
    opacity = rng.uniform(-1.0, 2.0, size=n)
    scale = np.log(rng.uniform(0.004, 0.04, size=(n, 3)) * (1e6 / n) ** 0.33)
    quat = np.concatenate([np.ones((n, 1)), 0.2 * rng.normal(size=(n, 3))], axis=1)
    sh = 0.1 * rng.normal(size=(n, 15, 3))
    if perturb_seed is not None:
        rgb = rgb + 0.3 * np.random.default_rng(perturb_seed).normal(size=(n, 3))
        opacity = opacity - 0.5
    cap = round_capacity(n)

    def pad(x):
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:n] = x
        return out

    params = dict(xyz=pad(xyz), rgb=pad(rgb), opacity=pad(opacity),
                  scale=pad(scale), quat=pad(quat), sh=pad(sh))
    return params, np.arange(cap) < n


def scene_params(n: int, seed: int, device, perturb_seed: int | None = None):
    """``scene_arrays`` as the port's GaussianParams on ``device``."""
    from gsplat_tpu_torch.train.state import params_from_jax

    return params_from_jax(*scene_arrays(n, seed, perturb_seed), device)


def views(width=WIDTH, height=HEIGHT):
    """The bench pose and three small rotations of it."""
    from gsplat_tpu_torch.ops.camera import build_camera_matrices

    def rot(axis, deg):
        h = math.radians(deg) / 2
        return np.array([math.cos(h)] + [math.sin(h) * a for a in axis])

    poses = [np.array([1.0, 0, 0, 0]), rot((0, 1, 0), 4.0),
             rot((0, 1, 0), -4.0), rot((1, 0, 0), 3.0)]
    return [build_camera_matrices(q, np.zeros(3), width, height,
                                  width * 0.85, width * 0.85) for q in poses]


def statics(cm, width=WIDTH, height=HEIGHT):
    from gsplat_tpu_torch.train.step import StepStatics

    return StepStatics(
        width=width, height=height, tile=TILE, l_max=3,
        focal_x=cm.focal_x, focal_y=cm.focal_y,
        tan_fovx=cm.tan_fovx, tan_fovy=cm.tan_fovy,
        near_thresh=0.3, mh_dist=3.0, cull_padding=100, ssim_frac=0.2,
        base_lr=1e-3, xyz_lr_init=0.16, xyz_lr_final=0.0016, quat_lr=1.0,
        scale_lr=5.0, opacity_lr=25.0, rgb_lr=2.5, sh_lr=0.125,
        scene_extent=4.0, num_iters=7000,
    )


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls: int, reps: int = 5) -> float:
    """Device ms of one fn(): ``calls`` calls captured into one CUDA graph
    (after one eager call), the median of ``reps`` timed replays
    (``cuda_ms``) over ``calls``: no host work between the calls, as in the
    step's graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, reps)
    del graph
    return ms / calls


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    from gsplat_tpu_torch.ops.loss import compute_psnr

    return float(compute_psnr(a, b))


def path_inputs(params, cm, st):
    """Every kernel's inputs at the shapes render_image gives it."""
    from gsplat_tpu_torch.kernels.expand import segment_expand
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.render import pack_attrs
    from gsplat_tpu_torch.train.step import _per_gaussian

    dev = params.xyz.device
    with torch.no_grad():
        view, proj, campos = (torch.as_tensor(x, device=dev)
                              for x in (cm.view, cm.proj, cm.campos))
        uv, conic, rgb, mask, radius, z = _per_gaussian(params, view, proj, campos, st)
        num_tiles = st.num_tiles_x * st.num_tiles_y
        qd_bits = binning.depth_key_bits(num_tiles)
        geom, rec1, off1, total_rows = binning.row_expand_inputs(
            uv, z, radius, mask, num_tiles_x=st.num_tiles_x,
            num_tiles_y=st.num_tiles_y, tile_size=st.tile,
        )
        rows = segment_expand(rec1, off1, total_rows)
        rec2, off2, total_pairs = binning.pair_expand_inputs(
            geom, rows, num_tiles_x=st.num_tiles_x, tile_size=st.tile
        )
        keys, _ = binning.pair_keys(geom, segment_expand(rec2, off2, total_pairs),
                                    qd_bits)
        tables = binning.build_tile_tables(
            uv, z, radius, mask, num_tiles_x=st.num_tiles_x,
            num_tiles_y=st.num_tiles_y, tile_size=st.tile,
        )
        attrs = pack_attrs(uv, conic, rgb, params.opacity)
    return dict(
        expand=[(rec1, off1, total_rows), (rec2, off2, total_pairs)],
        sort=(keys, binning.sort_key_bits(num_tiles, qd_bits)),
        raster=(attrs, tables.splat_gid, tables.tile_start, tables.tile_count),
        pair_cand=tables.pair_cand, pair_start=tables.pair_start,
        num_pairs=total_pairs, num_rows=total_rows,
    )


def pair_pixel_counts(raster, out, num_tiles_x: int, packed: bool = False) -> dict:
    """What the rasterizers' work is made of on these inputs: the
    pair-pixels of the forward's n_splats row (``pair_pixels``), and those
    of them whose alpha passes the 1/255 cutoff (``passing``), alpha
    evaluated as the plain versions evaluate it (in ``packed`` mode on the
    rounded pairs), 64 pairs of every tile a step; the pairs up to each
    tile's deepest n_splats (``reached``). Also the pair-pixels that the
    kernels' warps step through, a warp going on to its pixels' largest
    n_splats: K1's warps hold K1_WARP_PIXELS pixels of a tile
    (``fwd_warp_pair_pixels``), K2's K2_WARP_PIXELS
    (``bwd_warp_pair_pixels``)."""
    from gsplat_tpu_torch.kernels.rasterize import (
        ALPHA_CUTOFF, ALPHA_MAX, _pair_attrs, _pixel_centres, _tile_lists, _tile_origins)

    attrs, gid, start, count = raster
    nspl = out[:, 4, :, None]  # (T, PIX, 1)
    lists, valid = _tile_lists(gid, start, count)
    num_tiles = start.shape[0]
    px, py = _pixel_centres(num_tiles, num_tiles_x, TILE, attrs.device, packed)
    origins = _tile_origins(num_tiles, num_tiles_x, TILE, attrs.device)
    passing = 0
    with torch.no_grad():
        for c0 in range(0, min(int(nspl.max()), lists.shape[1]), 64):
            a = _pair_attrs(attrs, lists[:, c0:c0 + 64], origins, packed)  # (T, 1, K, 9)
            dx, dy = a[..., 0] - px, a[..., 1] - py  # (T, PIX, K)
            power = torch.clamp(-0.5 * (a[..., 2] * dx * dx + 2.0 * a[..., 3] * dx * dy
                                        + a[..., 4] * dy * dy), max=0.0)
            alpha = torch.clamp(a[..., 5] * torch.exp(power), max=ALPHA_MAX)
            k = torch.arange(c0, c0 + a.shape[2], device=attrs.device)
            live = valid[:, None, c0:c0 + 64] & (k < nspl) & (alpha > ALPHA_CUTOFF)
            passing += int(live.sum().item())
    n = out[:, 4].double()  # (T, PIX)
    warp_steps = {w: int(n.view(n.shape[0], -1, w).amax(dim=2).sum().item()) * w
                  for w in (K1_WARP_PIXELS, K2_WARP_PIXELS)}
    reached = int(torch.minimum(n.amax(dim=1), count.double()).sum().item())
    return dict(pair_pixels=int(n.sum().item()), passing=passing, reached=reached,
                fwd_warp_pair_pixels=warp_steps[K1_WARP_PIXELS],
                bwd_warp_pair_pixels=warp_steps[K2_WARP_PIXELS])


def compare_kernels(params, cm, st, timing_iters: int) -> dict:
    """Each kernel vs its plain version on the card; raises on disagreement."""
    from gsplat_tpu_torch.kernels import expand, sort

    inp = path_inputs(params, cm, st)
    res = {}
    # K5: both binning levels, bit-equal; time = both calls of one frame.
    levels = []
    for level, (rec, off, total) in enumerate(inp["expand"], 1):
        args = (rec, off, total)
        if not torch.equal(expand.segment_expand(*args), expand.segment_expand_plain(*args)):
            raise AssertionError(f"segment_expand differs from its plain version at "
                                 f"level {level}")
        counts = (off[1:] - off[:-1]).long()
        lv = dict(
            ms=cuda_ms(lambda a=args: expand.segment_expand(*a), timing_iters),
            plain_ms=cuda_ms(lambda a=args: expand.segment_expand_plain(*a), timing_iters),
            library_ms=cuda_ms(lambda r=rec, c=counts, t=total: torch.repeat_interleave(
                r, c, dim=1, output_size=t), timing_iters),
            **kernel_bound("segment_expand", expand=[(rec.shape[0], rec.shape[1], total)]))
        log(f"  segment_expand level {level}: {rec.shape[1]} records -> {total} slots; "
            f"kernel {lv['ms']:.4f} ms, "
            f"repeat_interleave {lv['library_ms']:.4f} ms, bound {lv['bound_ms']:.4f} ms")
        levels.append(lv)
    res["segment_expand"] = dict(
        max_abs_err=0.0, calls=len(levels),
        **{k: sum(lv[k] for lv in levels) for k in ("ms", "plain_ms", "library_ms")},
        **kernel_bound("segment_expand", expand=[
            (rec.shape[0], rec.shape[1], total) for rec, _, total in inp["expand"]]),
    )
    # K3: keys and permutation bit-equal to the stable torch.sort.
    keys, key_bits = inp["sort"]
    got = sort.radix_sort(keys, key_bits)
    ref = sort.radix_sort_plain(keys, key_bits)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("radix_sort differs from torch.sort(stable=True)")
    res["radix_sort"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: sort.radix_sort(keys, key_bits), timing_iters),
        plain_ms=cuda_ms(lambda: sort.radix_sort_plain(keys, key_bits), timing_iters),
        library_ms=cuda_ms(lambda: torch.sort(keys, stable=True), timing_iters),
        **kernel_bound("radix_sort", keys=keys.shape[0]),
    )
    # K1 in both modes: image PSNR >= 60 dB, n_splats equal on >= 99.9 % of
    # pixels, a rerun bit-identical.
    for packed in (False, True):
        res["rasterize_forward" + ("/packed" if packed else "")] = compare_forward(
            inp, st, timing_iters, packed)
    log(f"  rows {inp['num_rows']}, pairs {inp['num_pairs']}, "
        f"sort key bits {key_bits}")
    log_times(res)
    return res


def compare_forward(inp: dict, st, timing_iters: int, packed: bool) -> dict:
    """K1 against its plain version in one mode (``packed``: the pairs
    rounded as the reference's packed stream carries them); raises on
    disagreement. Returns its times, error and bound."""
    from gsplat_tpu_torch.kernels import rasterize
    from gsplat_tpu_torch.ops.render import tiles_to_image

    kw = dict(num_tiles_x=st.num_tiles_x, packed=packed)
    name = "rasterize_forward" + (" (packed)" if packed else "")
    got = rasterize.rasterize_forward(*inp["raster"], BG, **kw)
    again = rasterize.rasterize_forward(*inp["raster"], BG, **kw)
    ref = rasterize.rasterize_forward_plain(*inp["raster"], BG, **kw)
    to_img = lambda o: tiles_to_image(o[:, :3], st.num_tiles_x, st.num_tiles_y,  # noqa: E731
                                      st.tile, st.width, st.height)
    img_psnr = psnr(to_img(got), to_img(ref))
    same_n = (got[:, 4] == ref[:, 4]).double().mean().item()
    err = (got[:, :3] - ref[:, :3]).abs().max().item()
    log(f"  {name}: image PSNR vs plain {img_psnr:.2f} dB, "
        f"n_splats equal on {100 * same_n:.4f} % of pixels, "
        f"max |T_final diff| {(got[:, 3] - ref[:, 3]).abs().max().item():.3g}, "
        f"rerun bit-identical {torch.equal(got, again)}")
    if not (img_psnr >= 60.0 and same_n >= 0.999 and math.isfinite(err)
            and torch.equal(got, again)):
        raise AssertionError(f"{name} disagrees with its plain version")
    attrs, gid, start, _ = inp["raster"]
    work = pair_pixel_counts(inp["raster"], got, st.num_tiles_x, packed)
    log_work(work)
    return dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: rasterize.rasterize_forward(*inp["raster"], BG, **kw),
                   timing_iters),
        plain_ms=cuda_ms(lambda: rasterize.rasterize_forward_plain(
            *inp["raster"], BG, **kw), max(1, timing_iters // 4)),
        library_ms=None,
        **kernel_bound("rasterize_forward", packed=packed, gaussians=attrs.shape[0],
                       pairs=gid.shape[0], tiles=start.shape[0], **work),
    )


def log_work(work: dict) -> None:
    pp = max(work["pair_pixels"], 1)
    log(f"  pair-pixels {work['pair_pixels']}, past the 1/255 cutoff "
        f"{work['passing']} ({100 * work['passing'] / pp:.2f} %); stepped through "
        f"by K1's warps of {K1_WARP_PIXELS} pixels {work['fwd_warp_pair_pixels']} "
        f"({work['fwd_warp_pair_pixels'] / pp:.3f}x), by K2's of {K2_WARP_PIXELS} "
        f"pixels {work['bwd_warp_pair_pixels']} ({work['bwd_warp_pair_pixels'] / pp:.3f}x)")


def log_times(res: dict) -> None:
    for name, r in res.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
            f"{r['bytes']} bytes, {r['ops']} FP32 ops), max_abs_err "
            f"{r['max_abs_err']:.3g}")


def check_small_scene_against_cpu(dev) -> None:
    """A small scene on the card vs the port's CPU path on the same inputs."""
    from gsplat_tpu_torch.train.step import render_image

    w, h = 320, 208
    cm = views(w, h)[1]
    st = statics(cm, w, h)
    params = scene_params(20_000, seed=3, device="cpu")
    img_cpu, tab_cpu = render_image(params, cm.view, cm.proj, cm.campos, BG, st)
    img_gpu, tab_gpu = render_image(params.to(dev), cm.view, cm.proj, cm.campos,
                                    BG, st)
    p = psnr(img_gpu.cpu(), img_cpu)
    log(f"  {w}x{h}, 20000 Gaussians: pairs card {tab_gpu.num_pairs} / cpu "
        f"{tab_cpu.num_pairs}, image PSNR card vs cpu {p:.2f} dB")
    if not (abs(tab_gpu.num_pairs - tab_cpu.num_pairs) <= 1e-3 * tab_cpu.num_pairs
            and p >= 60.0 and torch.isfinite(img_gpu).all()):
        raise AssertionError("card render disagrees with the CPU path")


def backward_inputs(inp: dict, st, seed: int = 0, packed: bool = False):
    """The backward rasterizer's inputs at the shapes train_step gives it
    (from ``path_inputs``; the forward's output in mode ``packed``), with a
    random image cotangent; and the attribute table's row count."""
    from gsplat_tpu_torch.kernels.rasterize import rasterize_forward

    attrs, gid, start, count = inp["raster"]
    out = rasterize_forward(attrs, gid, start, count, BG, num_tiles_x=st.num_tiles_x,
                            packed=packed)
    gen = torch.Generator(device=attrs.device).manual_seed(seed)
    d_tiles = torch.randn((start.shape[0], 3, st.tile * st.tile), generator=gen,
                          device=attrs.device)
    return (attrs, gid, start, count, out, d_tiles), attrs.shape[0]


def bits_of(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bit patterns, so that NaN compares equal to itself."""
    return t.contiguous().view(torch.int32)


def word_steps(words: torch.Tensor) -> torch.Tensor:
    """(P, 9) float32: the rounding step of each value of (P, 4) packed
    gradient words: a bf16 ulp at the value (from its exponent bits; 2^-133
    for zeros) for the six bf16 halves, one code 2^(e - 31) of the e5s9
    triple for the colour gradients."""
    from gsplat_tpu_torch.kernels import packing

    vals = packing.unpack_grad_rows(words)[:, :6]
    exp = (bits_of(vals) >> 23) & 0xFF
    bf16 = torch.ldexp(torch.ones_like(vals), torch.clamp(exp, min=1) - 127 - 7)
    e = ((words[:, 3:4].to(torch.int64) & 0xFFFFFFFF) >> 27).to(torch.float32)
    code = torch.ldexp(torch.ones_like(e), (e - packing.GRAD_E5_BIAS - 7).to(torch.int32))
    return torch.cat([bf16, code.expand(-1, 3)], dim=1)


def compare_backward(params, cm, st, timing_iters: int) -> dict:
    """The backward kernels vs their plain versions on the card, in both
    modes, and the segment sum on adversarial runs; raises on
    disagreement."""
    from gsplat_tpu_torch.kernels import sort

    inp = path_inputs(params, cm, st)
    # pair_cand is the tile sort's permutation, each pair's candidate.
    perm = sort.radix_sort_plain(*inp["sort"])[1]
    if not torch.equal(perm, inp["pair_cand"]):
        raise AssertionError("pair_cand is not the tile sort's permutation")
    res = {}
    for packed in (False, True):
        res.update(compare_backward_mode(inp, st, timing_iters, packed))
    check_segsum_edge_runs(inp["pair_cand"].device)
    log(f"  pairs {perm.shape[0]}, Gaussians {inp['raster'][0].shape[0]}")
    log_times(res)
    return res


def segsum_edge_runs(n: int = 100_000, seed: int = 0) -> list:
    """Adversarial per-Gaussian runs for the segment sum: (name, counts,
    tail) with ``tail`` the rows past ``pair_start[n]`` (a capped table's,
    which no kernel may read). Gaussians without pairs (most of them, and
    the first and last 1,000); one run longer than a block's share of rows
    (a Gaussian of 100,000 pairs amid runs of 0-8); a capped tail."""
    rng = np.random.default_rng(seed)
    empty = rng.integers(0, 6, n) * (rng.random(n) < 0.3)
    empty[:1000] = empty[-1000:] = 0
    long_run = rng.integers(0, 9, n)
    long_run[n // 2 + 3] = 100_000
    capped = rng.integers(0, 9, n)
    return [("empty Gaussians", empty, 0), ("one long run", long_run, 0),
            ("capped tail", capped, 4096)]


def check_segsum_edge_runs(dev) -> None:
    """[10] The segment sum bit-equal to its plain version on
    ``segsum_edge_runs``, f32 rows and packed words, the tail's rows NaN;
    raises on a difference."""
    from gsplat_tpu_torch.kernels import packing, segsum

    gen = torch.Generator(device=dev).manual_seed(5)
    for name, counts, tail in segsum_edge_runs():
        n = counts.shape[0]
        pair_start = torch.from_numpy(
            np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)).to(dev)
        p = int(counts.sum())
        rows = torch.randn((p + tail, 9), generator=gen, device=dev)
        words = packing.pack_grad_rows(rows)
        rows[p:] = float("nan")
        words[p:] = -1  # an all-ones word unpacks to NaNs and huge codes
        for label, r in (("f32 rows", rows), ("packed words", words)):
            got = segsum.segment_sum(r, pair_start, n)
            ref = segsum.segment_sum_plain(r.cpu(), pair_start.cpu(), n)
            same = torch.equal(got.cpu(), ref)
            log(f"  segment_sum on {name} ({label}): {n} Gaussians, {p} rows + {tail} tail, "
                f"longest run {int(counts.max())}; bit-equal to the plain version {same}")
            if not (same and bool(torch.isfinite(got).all())):
                raise AssertionError(f"segment_sum ({label}) on {name} differs")


def compare_backward_mode(inp: dict, st, timing_iters: int, packed: bool) -> dict:
    """K2 and K4 against their plain versions in one mode. Packed: K2 reads
    the rounded pairs and writes words, which must be the port's pack of
    K2's own float32 rows on the same inputs, bit for bit; K4 sums the
    words."""
    from gsplat_tpu_torch.kernels import packing, rasterize, segsum

    args, n = backward_inputs(inp, st, packed=packed)
    kw = dict(num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y, packed=packed,
              pair_cand=inp["pair_cand"])
    sfx, label = ("/packed", " (packed)") if packed else ("", "")
    res = {}
    # K2. The 256-pixel sums run in another order (registers and warp
    # shuffles vs a tensor sum) and T is replayed by a reciprocal instead of
    # chunked products: each row must lie within 1e-3 of its largest |value|
    # (+1e-6). Both are off a float64 replay by up to 1.5e-4 of it on small
    # scenes.
    rows = rasterize.rasterize_backward(*args, BG, **kw)
    again = rasterize.rasterize_backward(*args, BG, **kw)
    ref = rasterize.rasterize_backward_plain(*args, BG, **kw)
    err = (rows - ref).abs()
    scale = ref.abs().amax(dim=1, keepdim=True)
    worst = (err / (scale + 1e-6)).max().item()
    log(f"  rasterize_backward{label}: float32 rows max |err| {err.max().item():.3g}, worst "
        f"row-relative {worst:.3g}, rerun bit-identical {torch.equal(rows, again)}")
    if not (bool((err <= 1e-3 * scale + 1e-6).all()) and torch.equal(rows, again)
            and bool(torch.isfinite(rows).all())):
        raise AssertionError(f"rasterize_backward{label} disagrees with its plain version")
    out_rows = rows
    if packed:
        # The words: the port's pack of K2's own float32 rows, bit for bit;
        # unpacked, within the rows' bound of the plain version's words plus
        # one rounding step of the format (near-equal sums can round to
        # neighbouring bf16 values or e5s9 codes).
        words = rasterize.rasterize_backward(*args, BG, pack_grads=True, **kw)
        words_again = rasterize.rasterize_backward(*args, BG, pack_grads=True, **kw)
        ref_words = rasterize.rasterize_backward_plain(*args, BG, pack_grads=True, **kw)
        own = torch.equal(words, packing.pack_grad_rows(rows))
        got_v, ref_v = packing.unpack_grad_rows(words), packing.unpack_grad_rows(ref_words)
        err = (got_v - ref_v).abs()
        step = torch.maximum(word_steps(words), word_steps(ref_words))
        within = bool((err <= 1e-3 * scale + 1e-6 + step).all())
        log(f"  rasterize_backward{label}: words bit-equal to the pack of its float32 rows "
            f"{own}, rerun bit-identical {torch.equal(words, words_again)}; unpacked vs the "
            f"plain version's max |err| {err.max().item():.3g}, within 1e-3 of the row's "
            f"largest |value| plus one step {within}; words equal to the plain version's "
            f"{100 * (words == ref_words).all(dim=1).double().mean().item():.4f} % of rows")
        if not (own and within and torch.equal(words, words_again)):
            raise AssertionError("rasterize_backward's packed words disagree")
        out_rows = words
    gid, start = args[1], args[2]
    work = pair_pixel_counts(args[:4], args[4], st.num_tiles_x, packed)
    log_work(work)
    res["rasterize_backward" + sfx] = dict(
        max_abs_err=err.max().item(),
        ms=cuda_ms(lambda: rasterize.rasterize_backward(*args, BG, pack_grads=packed, **kw),
                   timing_iters),
        plain_ms=cuda_ms(lambda: rasterize.rasterize_backward_plain(
            *args, BG, pack_grads=packed, **kw), max(1, timing_iters // 4)),
        library_ms=None,
        **kernel_bound("rasterize_backward", packed=packed, gaussians=n, pairs=gid.shape[0],
                       tiles=start.shape[0], **work),
    )
    # K4 over the rows as K2 stored them, one contiguous run a Gaussian, at
    # rtol 1e-5; index_add_ on the card adds with atomics, in another
    # order, so cancelling sums also get 1e-5 of the column's largest
    # |value|. On the CPU index_add_ adds in index order, the kernel's order.
    pair_start = inp["pair_start"]
    sums = segsum.segment_sum(out_rows, pair_start, n)
    again = segsum.segment_sum(out_rows, pair_start, n)
    ref = segsum.segment_sum_plain(out_rows, pair_start, n)
    on_cpu = segsum.segment_sum_plain(out_rows.cpu(), pair_start.cpu(), n)
    err = (sums - ref).abs()
    longest = int((pair_start[1:] - pair_start[:-1]).max())
    log(f"  segment_sum{label}: max |err| {err.max().item():.3g}, rerun bit-identical "
        f"{torch.equal(sums, again)}, bit-equal to the plain version on the CPU "
        f"{torch.equal(sums.cpu(), on_cpu)}; longest run {longest} pairs")
    if not (bool((err <= 1e-5 * ref.abs() + 1e-5 * ref.abs().amax(dim=0)).all())
            and torch.equal(sums, again)):
        raise AssertionError(f"segment_sum{label} disagrees with its plain version")
    # Each row's Gaussian, in the rows' (candidate) order.
    cand_gid = gid.long()[torch.argsort(inp["pair_cand"].long())]
    # One PyTorch call computes the float32 rows' sums; none unpacks words.
    library = None if packed else cuda_ms(
        lambda: torch.zeros((n, 9), device=rows.device).index_add_(0, cand_gid, rows),
        timing_iters)
    res["segment_sum" + sfx] = dict(
        max_abs_err=err.max().item(), longest_run=longest,
        ms=cuda_ms(lambda: segsum.segment_sum(out_rows, pair_start, n), timing_iters),
        plain_ms=cuda_ms(lambda: segsum.segment_sum_plain(out_rows, pair_start, n),
                         timing_iters),
        library_ms=library,
        **kernel_bound("segment_sum", packed=packed, gaussians=n, pairs=gid.shape[0]),
    )
    return res


def check_sort_edge_cases(dev) -> None:
    """K3 bit-equal to torch.sort(stable=True), keys and permutation, at the
    sizes around one tile, on equal keys and on keys that use only the top
    digit, for key_bits 1, 20, 29 and 31."""
    from gsplat_tpu_torch.kernels import sort

    tile = sort.TILE_KEYS
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = 0
    for key_bits in (1, 20, 29, 31):
        top = sort.sort_plan(1, key_bits).shifts[-1]  # the last pass's shift
        for n in (0, 1, tile - 1, tile, tile + 1, 3 * tile + 5, 1_000_003):
            rand = torch.randint(0, 1 << key_bits, (n,), generator=gen, device=dev,
                                 dtype=torch.int64).to(torch.int32)
            for kind, keys in (("random", rand),
                               ("equal", torch.full_like(rand, (1 << key_bits) - 1)),
                               ("top digit", (rand >> top) << top)):
                got_k, got_p = sort.radix_sort(keys, key_bits)
                ref = torch.sort(keys, stable=True)
                if not (torch.equal(got_k, ref.values)
                        and torch.equal(got_p, ref.indices.to(torch.int32))):
                    raise AssertionError(f"radix_sort differs from torch.sort(stable="
                                         f"True): {kind} keys, n {n}, key_bits {key_bits}")
                cases += 1
    torch.cuda.synchronize()
    log(f"  {cases} cases bit-equal to torch.sort(stable=True), keys and permutation "
        f"(tile {tile} keys)")


def expand_edge_counts() -> list:
    """Adversarial run lengths for the segment expand, as (name, counts)
    pairs of int32 arrays: a run far longer than a block's share of merged
    items, long stretches of zero counts, every slot in the last record, a
    single record, no slots at all, and merged sizes (records + slots)
    around a multiple of the share, with slots around one too."""
    from gsplat_tpu_torch.kernels.expand import ITEMS_PER_BLOCK as share

    rng = np.random.default_rng(5)

    def spread(r, total):  # r random counts that sum to total
        return rng.multinomial(total, np.full(r, 1.0 / r)).astype(np.int32)

    long_run = rng.integers(0, 4, 5000).astype(np.int32)
    long_run[:700] = 0
    long_run[1234] = 150_000
    zeros = rng.integers(0, 5, 30_000).astype(np.int32)
    zeros[5000:15_000] = 0
    zeros[-3000:] = 0
    last = np.zeros(20_000, np.int32)
    last[-1] = 50_000
    cases = [("long run", long_run), ("zero stretch", zeros), ("all in last", last),
             ("single record", np.array([70_001], np.int32)),
             ("no slots", np.zeros(5000, np.int32))]
    for d in (-1, 0, 1):
        cases.append((f"records + slots = 40 shares {d:+d}",
                      spread(30_000, 40 * share + d - 30_000)))
    for d in (-1, 1):
        cases.append((f"slots = 32 shares {d:+d}", spread(10_000, 32 * share + d)))
    return cases


def check_expand_edge_cases(dev) -> None:
    """K5 bit-equal to its plain version on ``expand_edge_counts``, with
    random 32-bit words in three columns."""
    from gsplat_tpu_torch.kernels import expand

    rng = np.random.default_rng(6)
    for name, counts in expand_edge_counts():
        off = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
        rec = torch.from_numpy(rng.integers(-2**31, 2**31, (3, counts.shape[0]),
                                            dtype=np.int64).astype(np.int32))
        total = int(counts.sum())
        got = expand.segment_expand(rec.to(dev), off.to(dev), total)
        if not torch.equal(got.cpu(), expand.segment_expand_plain(rec, off, total)):
            raise AssertionError(f"segment_expand differs from its plain version: {name}")
        log(f"  {name}: {counts.shape[0]} records -> {total} slots, bit-equal")


def one_step(state, cm, gt, it, st):
    """train_step's two halves, keeping the gradients: (loss, grads, g_uv,
    tables)."""
    from gsplat_tpu_torch.train.step import apply_adam, compute_loss_and_grads

    loss, _, mask, tables, grads, g_uv = compute_loss_and_grads(
        state.params, cm.view, cm.proj, cm.campos, gt, BG, st)
    apply_adam(state, grads, g_uv, mask, it, st)
    return float(loss), grads, g_uv, tables


def check_small_train_against_cpu(dev) -> None:
    """One training step of a small scene on the card vs the port's CPU path
    (which the CPU tests hold against the JAX package)."""
    from gsplat_tpu_torch.train.state import init_state, params_from_jax, state_to_numpy
    from gsplat_tpu_torch.train.step import render_image

    w, h = 320, 200
    cm = views(w, h)[1]
    st = statics(cm, w, h)
    gt, _ = render_image(scene_params(20_000, seed=3, device="cpu"), cm.view, cm.proj,
                         cm.campos, BG, st)
    start = scene_arrays(20_000, seed=3, perturb_seed=4)
    out = []
    for d in ("cpu", dev):
        state = init_state(params_from_jax(*start, d))
        loss, grads, g_uv, tables = one_step(state, cm, gt.to(d), 0, st)
        out.append((loss, {k: v.cpu() for k, v in grads.items()}, g_uv.cpu(),
                    state_to_numpy(state), tables.splat_gid.cpu()))
    (l_c, g_c, uv_c, s_c, gid_c), (l_g, g_g, uv_g, s_g, gid_g) = out
    same = (gid_c == gid_g).double().mean().item() if gid_c.shape == gid_g.shape else 0.0
    log(f"  {w}x{h}, 20000 Gaussians: loss card {l_g:.8f} / cpu {l_c:.8f}; pairs "
        f"{gid_g.shape[0]} / {gid_c.shape[0]}, same Gaussian in {100 * same:.4f} %")
    failed = []
    if not abs(l_g - l_c) <= 1e-5 * abs(l_c):
        failed.append("loss")
    # The kernels and the plain versions sum pixels and pairs in other
    # orders, and the per-Gaussian maths on the card and on the CPU differ
    # by ~1e-6 relative, which flips the 1/255 cutoff at a few footprint-
    # edge pixels of a few Gaussians (measured on an H100: at most 4
    # elements of a tensor past 1e-3 of its largest |value|, worst 4.9e-3).
    # So: at most 0.1 % of the elements past ``tol`` of the largest finite
    # |value|, none past 10 ``tol``, NaN (dead capacity rows) in the same
    # places; v scales as g^2.
    pairs = [(f"grad {k}", g_g[k].numpy(), g_c[k].numpy(), 1e-3) for k in g_c]
    pairs += [(f"m {k}", s_g["adam_m"][k], s_c["adam_m"][k], 1e-3) for k in g_c]
    pairs += [(f"v {k}", s_g["adam_v"][k], s_c["adam_v"][k], 2e-3) for k in g_c]
    pairs += [("g_uv", uv_g.numpy(), uv_c.numpy(), 1e-3),
              ("uv_grad_accum", s_g["uv_grad_accum"], s_c["uv_grad_accum"], 1e-3)]
    for name, a, b, tol in pairs:
        finite = np.isfinite(b)
        scale = max(float(np.abs(b[finite]).max(initial=0.0)), 1e-30)
        rel = np.abs(a[finite] - b[finite]) / scale
        worst = float(rel.max(initial=0.0))
        past = int((rel > tol).sum())
        log(f"    {name}: worst |card - cpu| / max {worst:.3g}, {past} of {rel.size} "
            f"elements past {tol:g}")
        if not ((np.isfinite(a) == finite).all() and worst <= 10 * tol
                and past <= 1e-3 * rel.size):
            failed.append(name)
    if not np.array_equal(s_g["accum_dur"], s_c["accum_dur"]):
        failed.append("accum_dur")
    if failed:
        raise AssertionError(f"card disagrees with the CPU path: {failed}")


def train_scene(cams, st, dev):
    """The training run's targets (the 4 views rendered from the 1M scene)
    and its start (a perturbed copy of the scene, as a TrainState)."""
    from gsplat_tpu_torch.train.state import init_state
    from gsplat_tpu_torch.train.step import render_image

    truth = scene_params(1_000_000, seed=0, device=dev)
    gts = [render_image(truth, cm.view, cm.proj, cm.campos, BG, st)[0] for cm in cams]
    del truth
    return gts, init_state(scene_params(1_000_000, seed=0, device=dev, perturb_seed=1))


def run_steps(state, cams, gts, st, its, quiet: bool = False, bg: float = BG):
    """train_step at iterations ``its``, view it % 4: (state, losses, ms
    between CUDA events per step)."""
    from gsplat_tpu_torch.train.step import train_step

    losses, times = [], []
    for it in its:
        v = it % len(cams)
        cm = cams[v]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = train_step(state, cm.view, cm.proj, cm.campos, gts[v], bg, it, st)
        end.record()
        end.synchronize()
        losses.append(float(m.loss))
        times.append(start.elapsed_time(end))
        if not quiet:
            log(f"  step {it} view {v}: loss {losses[-1]:.6f}, psnr {float(m.psnr):.3f} "
                f"dB, {times[-1]:.3f} ms, pairs {m.num_pairs}, visible "
                f"{int(m.num_visible)}")
    return state, losses, times


def port_kernel_names() -> set:
    """The __global__ functions of the imported package's csrc/*.cu."""
    from gsplat_tpu_torch.kernels import _build

    text = "\n".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    return set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", text))


def profile_steps(state, cams, gts, st, first_it: int, wall_ms: float,
                  steps: int = TRAIN_PROFILE_STEPS, label: str = "", kernels: bool = True,
                  bg: float = BG):
    """torch.profiler over ``steps`` more train steps: device ms and
    launches per step, the busy share (device ms over ``wall_ms``, the
    median ms/step of the timed steps), the port's kernels and the other
    kernels together and, with ``kernels``, those that take the most device
    time. Returns the state and the device ms per step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _, _ = run_steps(state, cams, gts, st,
                                range(first_it, first_it + steps), quiet=True, bg=bg)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3 / steps, e.count / steps)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  key=lambda r: -r[1])
    device = sum(ms for _, ms, _ in rows)
    if device <= 0:
        raise AssertionError("torch.profiler saw no device time")
    names = port_kernel_names()
    ours = [r for r in rows if any(k in r[0] for k in names)]
    ours_ms = sum(ms for _, ms, _ in ours)
    log(f"  device profile of {steps} steps{label}: {device:.3f} ms/step, busy "
        f"{100 * device / wall_ms:.1f} % of {wall_ms:.3f} ms, "
        f"{sum(n for *_, n in rows):.1f} launches/step; port kernels "
        f"{ours_ms:.3f} ms/step, other kernels {device - ours_ms:.3f} ms/step")
    others = [r for r in rows if r not in ours][:PROFILE_TOP]
    for i, (key, ms, n) in enumerate(ours + others if kernels else []):
        if i == len(ours):
            log(f"  other kernels, top {PROFILE_TOP}:")
        log(f"    {ms:8.3f} ms {n:6.1f}x  {key[:96]}")
    return state, device


def mode_context(mode: str):
    """The package's ``exact_mode()`` for "exact", nothing for another
    mode ("packed", the default, or the one mode of an earlier checkout)."""
    if mode != "exact":
        return contextlib.nullcontext()
    from gsplat_tpu_torch.train.step import exact_mode

    return exact_mode()


def profile_modes(runs: dict, cams, gts, st) -> dict:
    """Device profiles of TRAIN_PROFILE_STEPS more train steps of each
    mode's run, in windows of half as many taken in turns (A B B A), so
    that a drift of the card's clocks during the run falls on both modes
    alike (every kernel, glue included, has run 1.5 % faster in one window
    than in the next: PERF.md); the kernel lists of each mode's first
    window. ``runs`` maps a mode to [state, next iteration, median ms/step
    of its timed steps] and is updated; returns each mode's device ms per
    step, the mean of its windows."""
    modes = list(runs)
    steps = TRAIN_PROFILE_STEPS // 2
    device = {m: [] for m in modes}
    for mode in modes + modes[::-1]:
        run = runs[mode]
        with mode_context(mode):
            run[0], ms = profile_steps(run[0], cams, gts, st, run[1], run[2], steps,
                                       label=f", {mode} mode", kernels=not device[mode])
        run[1] += steps
        device[mode].append(ms)
    return {m: statistics.mean(v) for m, v in device.items()}


def train_slice(cams, st, dev):
    """[9] The slice: train a perturbed 1M scene on the 4 views rendered
    from the scene itself, first in the packed mode (the default: the main
    path), then from the same start in exact mode (a path of its own);
    then profile TRAIN_PROFILE_STEPS more steps of each (``profile_modes``).
    Returns per mode the launches of its training run, the losses, the
    median ms/step and the device ms/step; and the packed run's trained
    parameters."""
    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.train.state import init_state
    from gsplat_tpu_torch.train.step import compute_loss_and_grads

    gts, state = train_scene(cams, st, dev)
    out, runs = {}, {}
    for mode in ("packed", "exact"):
        if state is None:
            state = init_state(scene_params(1_000_000, seed=0, device=dev, perturb_seed=1))
        log(f"  {mode} mode:")
        with mode_context(mode):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            state, losses, times = run_steps(state, cams, gts, st, range(TRAIN_STEPS))
            torch.cuda.synchronize()
            launches = dict(_build.launches)
            peak = torch.cuda.max_memory_allocated() / 2**20
            half = len(cams)
            first, second = statistics.mean(losses[:half]), statistics.mean(losses[half:])
            median = statistics.median(times[1:])
            log(f"  median {median:.3f} ms/step over steps 1-{TRAIN_STEPS - 1}; mean loss "
                f"pass 1 {first:.6f}, pass 2 {second:.6f}; peak allocated {peak:.0f} MiB; "
                f"launches {launches}")
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"a loss is not finite: {losses}")
            if not second < first:
                raise AssertionError("the second pass over the views did not lower the loss")
            # [9] takes no density step, so the morton site stays at 0. The
            # packed run launches only packed rasterizers and segment sums,
            # the exact run none.
            packed_keys = [k for k in launches if k.endswith("/packed")]
            want = {k: launches[k.split("/")[0]] if mode == "packed" else 0 for k in packed_keys}
            base = {k: v for k, v in launches.items()
                    if k not in ("radix_sort/morton", SWEEP_LAUNCHES) and k not in packed_keys}
            if min(base.values()) <= 0 or {k: launches[k] for k in packed_keys} != want:
                raise AssertionError(f"a kernel of the {mode} path never launched, or in the "
                                     f"other mode: {launches}")
            # One train step sorts once: the tile sort in the forward. The
            # backward sums over binning's runs and sorts nothing.
            if not launches["radix_sort/tile"] == launches["radix_sort"] == TRAIN_STEPS:
                raise AssertionError(f"radix_sort did not launch once per step, at the tile "
                                     f"sort: {launches}")
            calls = [compute_loss_and_grads(state.params, cams[0].view, cams[0].proj,
                                            cams[0].campos, gts[0], BG, st) for _ in range(2)]
            (_, _, _, _, g_a, uv_a), (_, _, _, _, g_b, uv_b) = calls
            same = all(torch.equal(bits_of(g_a[k]), bits_of(g_b[k])) for k in g_a)
            if not (same and torch.equal(bits_of(uv_a), bits_of(uv_b))):
                raise AssertionError("two gradient calls on the same state differ")
            log("  gradients of two calls on the same state are bit-identical")
            del calls, g_a, g_b, uv_a, uv_b
        out[mode] = dict(launches=launches, losses=losses, median=median)
        runs[mode] = [state, TRAIN_STEPS, median]
        state = None
    for mode, ms in profile_modes(runs, cams, gts, st).items():
        out[mode]["device_ms"] = ms
    trained = runs["packed"][0].params
    del runs
    pk, ex = out["packed"], out["exact"]
    rel = max(abs(a / b - 1) for a, b in zip(pk["losses"], ex["losses"]))
    log(f"  packed vs exact, same start and views: losses within {rel:.3g} relative; "
        f"device {pk['device_ms']:.3f} vs {ex['device_ms']:.3f} ms/step "
        f"({pk['device_ms'] - ex['device_ms']:+.3f}), median {pk['median']:.3f} vs "
        f"{ex['median']:.3f} ms/step")
    return out, trained


def trainer_cameras(width=WIDTH, height=HEIGHT, n=TRAINER_VIEWS):
    """COLMAP cameras at n distinct centres on a circle of radius 1.5 in the
    z = 0 plane, each looking at (0, 0, 6), focal 0.85 W: (cameras,
    images), so that the scene extent is 1.1 x 1.5."""
    from gsplat_tpu_torch.io.colmap import Camera, Image, rotmat_to_qvec

    f = 0.85 * width
    cams = {1: Camera(id=1, model="PINHOLE", width=width, height=height,
                      params=np.array([f, f, width / 2, height / 2]))}
    images = {}
    for i in range(n):
        a = 2 * math.pi * i / n
        centre = np.array([1.5 * math.cos(a), 1.5 * math.sin(a), 0.0])
        fwd = np.array([0.0, 0.0, 6.0]) - centre
        fwd /= np.linalg.norm(fwd)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        rot = np.stack([right, np.cross(fwd, right), fwd])  # world -> camera rows
        images[i + 1] = Image(id=i + 1, qvec=rotmat_to_qvec(rot), tvec=-rot @ centre,
                              camera_id=1, name=f"view_{i:03d}.png", xys=np.zeros((0, 2)),
                              point3d_ids=np.zeros(0, np.int64))
    return cams, images


def trainer_scene(n: int, seed: int, dev, width=WIDTH, height=HEIGHT):
    """The trainer's dataset: ``trainer_cameras``, the ground truths of
    ``scene_arrays(n, seed)`` rendered from them on ``dev`` (host float32
    arrays by image name, black background), and an SfM-like cloud, the
    true centres plus N(0, 0.05^2) jitter with uint8 colours."""
    from gsplat_tpu_torch.ops.camera import build_camera_matrices
    from gsplat_tpu_torch.train.state import params_from_jax
    from gsplat_tpu_torch.train.step import render_image

    cams, images = trainer_cameras(width, height)
    arrays, alive = scene_arrays(n, seed)
    truth = params_from_jax(arrays, alive, dev)
    cam = cams[1]
    gts = {}
    for im in images.values():
        cm = build_camera_matrices(im.qvec, im.tvec, width, height, cam.focal_x, cam.focal_y)
        img, _ = render_image(truth, cm.view, cm.proj, cm.campos, 0.0, statics(cm, width, height))
        gts[im.name] = img.cpu().numpy()
    del truth
    xyz, rgb = sfm_cloud(arrays, n, seed)
    return cams, images, gts, xyz, rgb


class ImageStandIns:
    """Replace ``io.images.load_image`` by a lookup into in-memory ground
    truths and ``io.images.save_image`` by a check of the dumped image's
    shape and finiteness (the card's host may lack PIL), for a ``with``
    block. ``dumps`` lists the dumped paths."""

    def __init__(self, gts: dict, shape: tuple):
        self.gts, self.shape, self.dumps = gts, shape, []

    def load(self, path):
        return self.gts[path]

    def save(self, path, arr):
        arr = np.asarray(arr)
        if not (arr.shape == self.shape and arr.dtype == np.uint8
                and np.isfinite(arr.astype(np.float32)).all()):
            raise AssertionError(f"dumped image {path}: {arr.shape} {arr.dtype}")
        self.dumps.append(str(path))

    def __enter__(self):
        from gsplat_tpu_torch.io import images

        self.saved = images.load_image, images.save_image
        images.load_image, images.save_image = self.load, self.save
        return self

    def __exit__(self, *exc):
        from gsplat_tpu_torch.io import images

        images.load_image, images.save_image = self.saved


def trainer_config(out_dir: str):
    """configs/base.yaml read by the port's reader (no PyYAML on the card's
    host), with [11]'s short schedule in which every event fires: density
    at 4, 8, 12 and 16, an opacity reset at 10, SH bands at 5, 10 and 15,
    eval at 0 and 12 over every 4th view, image dumps at 0 and 12."""
    import dataclasses

    from gsplat_tpu_torch.config import parse_config

    base = parse_config(Path(__file__).resolve().parent / "configs" / "base.yaml")
    return dataclasses.replace(
        base, dataset_path="", downsample_factor=1, output_dir=out_dir,
        num_iters=TRAINER_ITERS, adaptive_control_start=3, adaptive_control_interval=4,
        adaptive_control_end=20, reset_opacity_start=9, reset_opacity_interval=10,
        reset_opacity_end=20, add_sh_band_interval=5, max_sh_band=3, test_eval_interval=12,
        test_split_ratio=4, strict_reference=False, print_interval=12, use_background=True)


def loss_falls(losses: list, views: list, events: set) -> list:
    """Each view's loss between consecutive draws of it with no density
    step or opacity reset in between (``events``: the iterations after
    whose train step one ran): (view, i, j, loss i, loss j), for the
    check that a train step on a view lowers its loss."""
    out = []
    for j, v in enumerate(views):
        i = max((k for k in range(j) if views[k] == v), default=None)
        if i is not None and not any(i <= e < j for e in events):
            out.append((v, i, j, losses[i], losses[j]))
    return out


def trainer_slice(dev, n: int = 1_000_000, width=WIDTH, height=HEIGHT) -> dict:
    """[11]: ``Trainer.train`` at full width, every event of the schedule
    firing, with its checks; returns the morton site's launches and the
    radix sort's times at the trainer's final capacity."""
    import tempfile

    from gsplat_tpu_torch.io.ply import load_ply
    from gsplat_tpu_torch.kernels import _build, sort
    from gsplat_tpu_torch.ops.morton import KEY_BITS, morton_codes
    from gsplat_tpu_torch.train import step as step_mod
    from gsplat_tpu_torch.train import trainer as trainer_mod
    from gsplat_tpu_torch.train.init import initialize_gaussians
    from gsplat_tpu_torch.train.state import num_active

    cams, images, gts, xyz, rgb = trainer_scene(n, 0, dev, width, height)
    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_")  # removed at exit
    tmp = tmpdir.name
    cfg = trainer_config(tmp)
    t0 = time.perf_counter()
    g = initialize_gaussians(xyz, rgb, cfg)
    log(f"  {n} points: initialize_gaussians (native KNN, {cfg.initial_scale_num_neighbors}"
        f" neighbours) {time.perf_counter() - t0:.2f} s")
    tr = trainer_mod.Trainer(cfg, g, images, cams, device=dev)
    log(f"  {len(images)} views, scene extent {tr.scene_extent:.4f}, capacity "
        f"{tr.state.capacity}, test views {[im.name for im in tr.test_images]}")
    rec = dict(losses=[], views=[], starts=[], density=[], morton_ms=[], evals=[], caps=[])
    real_get, real_sort = trainer_mod.get_monitored_train_step, trainer_mod.morton_sort
    real_density, real_eval = tr._density_step, tr.evaluate

    def get_step(st):
        real_step = real_get(st)

        def step(state, view, proj, campos, gt, bg, it, monitor):
            torch.cuda.synchronize()
            rec["starts"].append(time.perf_counter())
            state, m, monitor = real_step(state, view, proj, campos, gt, bg, it, monitor)
            rec["losses"].append(float(m.loss))
            rec["caps"].append((st.pair_cap, st.row_cap))
            rec["views"].append(next(i for i, im in enumerate(tr.train_images)
                                     if tr._camera(im)[0] is view))
            return state, m, monitor

        return step

    def morton(state):
        codes = morton_codes(state.params.xyz, state.alive)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state = real_sort(state)
        end.record()
        end.synchronize()
        rec["morton_ms"].append(start.elapsed_time(end))
        alive = state.alive
        k = int(alive.sum())
        if not (bool(alive[:k].all()) and not bool(alive[k:].any())):
            raise AssertionError("after the Morton sort the alive rows are not a prefix")
        counts = dict(_build.launches)  # a comparison launch does not count
        got = sort.radix_sort(codes, KEY_BITS)
        ref = torch.sort(codes, stable=True)
        _build.launches.update(counts)
        if not (torch.equal(got[0], ref.values)
                and torch.equal(got[1], ref.indices.to(torch.int32))):
            raise AssertionError("the Morton permutation differs from torch.sort(stable=True)")
        return state

    def density():
        torch.cuda.synchronize()
        t = time.perf_counter()
        info = real_density()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        rec["density"].append((tr.iter, info, ms))
        log(f"  density step at {tr.iter}: pruned {info.num_pruned}, cloned "
            f"{info.num_cloned}, split {info.num_split}, new total {info.new_total}, "
            f"applied {info.applied}, capacity {tr.state.capacity}; {ms:.2f} ms with the "
            f"Morton sort ({rec['morton_ms'][-1]:.3f} ms)")
        return info

    def evaluate(verbose=True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        psnr = real_eval(verbose=verbose)
        torch.cuda.synchronize()
        rec["evals"].append((tr.iter, psnr, 1e3 * (time.perf_counter() - t)
                             / len(tr.test_images)))
        return psnr

    tr._density_step, tr.evaluate = density, evaluate
    trainer_mod.get_monitored_train_step, trainer_mod.morton_sort = get_step, morton
    captures = step_mod.graph_captures()
    try:
        with ImageStandIns(gts, (height, width, 3)) as io_:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t_train = time.perf_counter()
            tr.train(max_iters=11)  # stops right after the reset at 10
            torch.cuda.synchronize()
            alive = tr.state.alive
            op = tr.state.params.opacity.detach()[alive]
            want = torch.tensor(math.log(0.05) - math.log(0.95), dtype=torch.float32,
                                device=op.device)
            if not bool((op == want).all()):
                raise AssertionError("after the reset the alive opacities are not logit(0.05)")
            log(f"  after iteration 10's reset: {op.numel()} alive opacities equal "
                f"logit(0.05) = {want.item():.7f}")
            tr.train(max_iters=TRAINER_ITERS)
            torch.cuda.synchronize()
            rec["starts"].append(time.perf_counter())
            wall_s = rec["starts"][-1] - t_train  # the hooks' reads and checks included
            launches = dict(_build.launches)
            peak = torch.cuda.max_memory_allocated() / 2**20
            dumps = list(io_.dumps)
    finally:
        trainer_mod.get_monitored_train_step, trainer_mod.morton_sort = real_get, real_sort
        del tr._density_step, tr.evaluate
    captures = step_mod.graph_captures() - captures
    losses, views = rec["losses"], rec["views"]
    log("  losses: " + ", ".join(f"{i}:{v}:{x:.5f}" for i, (v, x) in enumerate(zip(views, losses))))
    dens_its = {it for it, _, _ in rec["density"]}
    resets = {i for i in range(TRAINER_ITERS) if i > cfg.reset_opacity_start
              and i % cfg.reset_opacity_interval == 0 and i < cfg.reset_opacity_end}
    falls = loss_falls(losses, views, dens_its | resets)
    log("  a view's loss between draws with no density step or reset between: " + ", ".join(
        f"view {v} at {i} {a:.5f} -> at {j} {b:.5f}" for v, i, j, a, b in falls))
    dens_ms = [ms for _, _, ms in rec["density"]]
    eval_its = {it for it, _, _ in rec["evals"]}
    iter_ms = [1e3 * (b - a) for a, b in zip(rec["starts"], rec["starts"][1:])]
    plain = [ms for i, ms in enumerate(iter_ms)
             if i not in dens_its and i not in eval_its and i % cfg.print_interval][1:]
    with_density = [ms for i, ms in enumerate(iter_ms) if i in dens_its and i not in eval_its]
    log(f"  ms per trainer iteration (median): {statistics.median(plain):.3f} without a "
        f"density step, {statistics.median(with_density):.3f} with one; density step "
        f"{statistics.median(dens_ms):.3f} ms (median of {len(dens_ms)}), Morton sort "
        f"{statistics.median(rec['morton_ms']):.3f} ms; eval "
        + ", ".join(f"at {it}: PSNR {p:.4f} dB, {ms:.3f} ms a view" for it, p, ms in rec["evals"])
        + f"; peak allocated {peak:.0f} MiB; l_max {tr.l_max}; dumps {len(dumps)}")
    log(f"  launches by site: {launches}")
    log("  ms an iteration: " + ", ".join(f"{i}:{ms:.1f}" for i, ms in enumerate(iter_ms)))
    infos = [info for _, info, _ in rec["density"]]
    failed = []
    if not all(math.isfinite(x) for x in losses) or len(losses) != TRAINER_ITERS:
        failed.append("a loss is not finite")
    if not falls or not all(b < a for *_, a, b in falls):
        failed.append("the loss did not fall")
    if sorted(dens_its) != [4, 8, 12, 16] or not any(i.applied for i in infos):
        failed.append("density steps")
    if launches["radix_sort/morton"] != len(infos):
        failed.append("radix_sort/morton launches")
    if min(v for k, v in launches.items() if k != SWEEP_LAUNCHES) <= 0:
        failed.append(f"a kernel never launched: {launches}")
    if tr.l_max != 3:
        failed.append("l_max")
    if sorted(eval_its) != [0, 12] or not all(math.isfinite(p) for _, p, _ in rec["evals"]):
        failed.append("eval")
    if len(dumps) != 2:
        failed.append("image dumps")
    ply = Path(tmp) / "trained.ply"
    tr.save_to_ply(ply)
    verts = load_ply(ply)["xyz"].shape[0]
    graphed = dict(scene=(cams, images, gts, xyz, rgb), losses=losses, caps=rec["caps"],
                   density=[(it, density_counts(info)) for it, info, _ in rec["density"]],
                   ply=ply.read_bytes(), checksums=state_checksums(tr.state), wall_s=wall_s,
                   captures=captures, iter_ms=iter_ms)
    tmpdir.cleanup()
    log(f"  trained.ply: {verts} vertices, {num_active(tr.state)} alive; {captures} CUDA "
        f"graph captures; (pair, row) caps by step {rec['caps']}")
    if verts != num_active(tr.state):
        failed.append("PLY vertex count")
    if failed:
        raise AssertionError(f"[11] failed: {failed}")
    # K3 at the morton site's shapes: the final state's codes.
    codes = morton_codes(tr.state.params.xyz, tr.state.alive)
    res = dict(
        max_abs_err=0.0, keys=codes.shape[0],
        ms=cuda_ms(lambda: sort.radix_sort(codes, KEY_BITS), 10),
        plain_ms=cuda_ms(lambda: sort.radix_sort_plain(codes, KEY_BITS), 10),
        library_ms=cuda_ms(lambda: torch.sort(codes, stable=True), 10),
        **kernel_bound("radix_sort", keys=codes.shape[0]))
    plan = sort.sort_plan(codes.shape[0], KEY_BITS)
    log(f"  radix_sort at the morton site: {codes.shape[0]} codes, {len(plan.shifts)} passes "
        f"of {'/'.join(map(str, plan.bits))} bits")
    log_times({"radix_sort/morton": res})
    # Where a density step's time goes: one more of each, profiled (their
    # launches are not the run's).
    counts = dict(_build.launches)
    device_profile(lambda: trainer_mod.morton_sort(tr.state), "morton_sort")
    device_profile(tr._density_step, "a density step with its Morton sort")
    _build.launches.update(counts)
    graphed["trainer"] = tr  # [17e] times more iterations of it
    return dict(launches=launches["radix_sort/morton"], density_steps=len(infos), res=res,
                graphed=graphed)


def device_profile(fn, label: str, top: int = 8) -> None:
    """One call of ``fn`` under torch.profiler: its wall ms (host clock,
    synchronized), device ms and launches, and the kernels that take the
    most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  key=lambda r: -r[1])
    log(f"  {label}: wall {wall:.3f} ms, device {sum(ms for _, ms, _ in rows):.3f} ms in "
        f"{sum(n for *_, n in rows)} launches; by device time:")
    for key, ms, n in rows[:top]:
        log(f"    {ms:8.3f} ms {n:4d}x  {key[:96]}")


def check_density_against_cpu(dev) -> None:
    """[12] A density step of a small scene that needs twice its capacity
    (``needs_grow``, ``grow_state``, the step again) and a Morton sort, on
    the card and on the CPU with the same injected noise, then a
    checkpoint round trip of the Trainer on the card."""
    from gsplat_tpu_torch.train import density
    from gsplat_tpu_torch.train.state import (
        grow_state, init_state, params_from_jax, state_from_jax, state_to_numpy)

    arrays, alive = scene_arrays(20_000, seed=3, perturb_seed=4)
    cap = alive.shape[0]
    rng = np.random.default_rng(12)
    # ~80 % of the Gaussians densify: the step needs twice the capacity.
    accum = rng.uniform(0.0, 1e-3, cap).astype(np.float32)
    noise = [torch.from_numpy(rng.standard_normal((2 * cap, 3)).astype(np.float32))
             for _ in range(2)]
    ds = density.DensityStatics(scene_extent=1.65, uv_grad_threshold=2e-4,
                                delete_opacity_threshold=0.02, split_scale_factor=1.6,
                                max_gaussians=4_250_000)
    out = []
    for d in ("cpu", dev):
        state = init_state(params_from_jax(arrays, alive, d))
        state.uv_grad_accum.copy_(torch.from_numpy(accum))
        state.accum_dur.fill_(1)
        _, first = density.adaptive_density_step(state, ds, *(x[:cap].to(d) for x in noise))
        state = grow_state(state, 2 * cap)
        state, info = density.adaptive_density_step(state, ds, *(x.to(d) for x in noise))
        out.append((first, info, state_to_numpy(state)))
    (f_c, i_c, s_c), (f_g, i_g, s_g) = out
    log(f"  20000 Gaussians in {cap} rows: card {f_g}, cpu {f_c}; grown to {2 * cap}: "
        f"card {i_g}, cpu {i_c}")
    failed = [] if (f_g == f_c and f_c.needs_grow and i_g == i_c and i_c.applied) else [
        "DensityInfo"]
    for f in ("alive", "uv_grad_accum", "accum_dur"):
        if not np.array_equal(s_g[f], s_c[f]):
            failed.append(f)
    worst = {}
    for f in ("params", "adam_m", "adam_v"):
        for k in s_c[f]:
            a, b = s_g[f][k], s_c[f][k]
            if f == "params" and k in ("xyz", "scale"):
                ulps = np.abs(a - b) / np.spacing(np.abs(b).max(axis=0))
                worst[k] = float(ulps.max())
                if worst[k] > 4:
                    failed.append(f"{f}.{k}")
            elif not np.array_equal(a, b):
                failed.append(f"{f}.{k}")
    log(f"  split children, worst |card - cpu| in units in the last place of the column's "
        f"largest value: {worst}; everything else bit-equal: {not failed}")
    # The Morton sort of one state (the CPU's) on both devices.
    sorted_ = [state_to_numpy(density.morton_sort(state_from_jax(**s_c, device=d)))
               for d in ("cpu", dev)]
    same = all(np.array_equal(sorted_[1][f], sorted_[0][f])
               for f in ("alive", "uv_grad_accum", "accum_dur")) and all(
        np.array_equal(sorted_[1][f][k], sorted_[0][f][k])
        for f in ("params", "adam_m", "adam_v") for k in s_c[f])
    log(f"  morton_sort of one state, card vs cpu: bit-equal {same}")
    if not same:
        failed.append("morton_sort")
    if failed:
        raise AssertionError(f"density step or sort, card vs cpu: {failed}")
    check_checkpoint_round_trip(dev)


def check_checkpoint_round_trip(dev, k: int = 7) -> None:
    """Train a small scene to iteration k, save a checkpoint, go on 2
    iterations (a density step at 8 among them); load the checkpoint into
    a fresh Trainer and run the same 2: bit-identical parameters, and the
    same capacities."""
    import tempfile

    from gsplat_tpu_torch.train.init import initialize_gaussians
    from gsplat_tpu_torch.train.state import state_to_numpy
    from gsplat_tpu_torch.train.trainer import Trainer

    w, h = 320, 200
    cams, images, gts, xyz, rgb = trainer_scene(20_000, 3, dev, w, h)
    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")  # removed at exit
    tmp = tmpdir.name
    cfg = trainer_config(tmp)
    g = initialize_gaussians(xyz, rgb, cfg)
    ck = Path(tmp) / "checkpoint.npz"
    with ImageStandIns(gts, (h, w, 3)):
        tr = Trainer(cfg, g, images, cams, device=dev)
        tr.train(max_iters=k, verbose=False)
        tr.save_checkpoint(ck)
        tr.train(max_iters=k + 2, verbose=False)
        again = Trainer(cfg, g, images, cams, device=dev)
        again.load_checkpoint(ck)
        again.train(max_iters=k + 2, verbose=False)
    a, b = state_to_numpy(tr.state), state_to_numpy(again.state)
    tmpdir.cleanup()
    same = all(np.array_equal(a[f], b[f]) for f in ("alive", "uv_grad_accum", "accum_dur"))
    same &= all(np.array_equal(a[f][n], b[f][n]) for f in ("params", "adam_m", "adam_v")
                for n in a[f])
    caps = [(t.pair_cap, t.row_cap) for t in (tr, again)]
    log(f"  checkpoint at {k}, then 2 more iterations: continued and resumed states "
        f"bit-identical {same} ({int(a['alive'].sum())} alive, capacity {a['alive'].shape[0]});"
        f" (pair, row) caps {caps[0]} continued, {caps[1]} resumed")
    if not (same and tr.iter == again.iter == k + 2 and caps[0] == caps[1]):
        raise AssertionError("a resumed Trainer differs from the continued one")


def state_tensors(state) -> dict:
    """Every tensor of a TrainState by name."""
    from gsplat_tpu_torch.train.state import PARAM_DIMS

    out = {f"params.{k}": getattr(state.params, k).detach() for k in PARAM_DIMS}
    out.update({f"adam_m.{k}": v for k, v in state.adam_m.items()})
    out.update({f"adam_v.{k}": v for k, v in state.adam_v.items()})
    out.update(alive=state.alive, uv_grad_accum=state.uv_grad_accum,
               accum_dur=state.accum_dur)
    return out


def differing(a, b) -> list:
    """Names of the tensors of two TrainStates that differ in any bit."""
    ta, tb = state_tensors(a), state_tensors(b)
    return [k for k in ta if ta[k].shape != tb[k].shape or not torch.equal(
        ta[k].contiguous().view(torch.uint8), tb[k].contiguous().view(torch.uint8))]


def state_checksums(state) -> torch.Tensor:
    """Two int64 checksums a tensor of a TrainState over its bytes (their
    sum, and their sum weighted by position), on the host."""
    sums = []
    for t in state_tensors(state).values():
        b = t.contiguous().view(torch.uint8).reshape(-1).long()
        w = torch.arange(b.numel(), device=b.device) % 65_521 + 1
        sums += [b.sum(), (b * w).sum()]
    return torch.stack(sums).cpu()


def replicas_identical(state, group=None) -> bool:
    """Whether every rank of the group holds the same state, by checksums."""
    from gsplat_tpu_torch.parallel import comm

    sums = comm.all_gather_rows(state_checksums(state)[None], group)
    return bool((sums == sums[0]).all())


def rel_close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol_frac: float = 0.0):
    """(|a - b| <= rtol |b| + atol_frac max |b| wherever b is finite, and NaN
    in the same places; the worst |a - b| / |b| and |a - b| / max |b|)."""
    fin = torch.isfinite(b)
    err, ref = (a - b).abs()[fin], b.abs()[fin]
    top = ref.max().item() if ref.numel() else 0.0
    ok = bool((err <= rtol * ref + atol_frac * top).all()) and torch.equal(
        torch.isfinite(a), fin)
    if not err.numel():
        return ok, 0.0, 0.0
    return ok, (err / ref.clamp(min=1e-30)).max().item(), err.max().item() / max(top, 1e-30)


class CollectiveClock:
    """For a ``with`` block: time every collective of ``parallel.comm`` on
    the host clock, from the moment the device has finished the work that
    made its tensor (the gloo branch's copy to the host waits for it anyway)
    to its return: the copies through host memory and the wait for the
    other ranks; and count the bytes of the reduced or gathered tensors."""

    def __init__(self):
        self.seconds, self.bytes = 0.0, 0

    def _timed(self, fn):
        def run(t, group=None):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            t0 = time.perf_counter()
            out = fn(t, group)
            self.seconds += time.perf_counter() - t0
            self.bytes += out.numel() * out.element_size()
            return out
        return run

    def __enter__(self):
        from gsplat_tpu_torch.parallel import comm

        self.saved = comm.all_reduce_sum_, comm.all_gather_rows
        comm.all_reduce_sum_, comm.all_gather_rows = map(self._timed, self.saved)
        return self

    def __exit__(self, *exc):
        from gsplat_tpu_torch.parallel import comm

        comm.all_reduce_sum_, comm.all_gather_rows = self.saved


class Stopwatch:
    """Host milliseconds of each call (the device synchronized before and
    after)."""

    def __init__(self, dev):
        self.dev, self.ms = torch.device(dev), []

    def __call__(self, fn):
        sync = torch.cuda.synchronize if self.dev.type == "cuda" else (lambda: None)
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        self.ms.append(1e3 * (time.perf_counter() - t))
        return out


def frame_caps(params, cams, st):
    """``capped_statics`` for the largest pair and row requirements of the
    frames of ``cams`` (exact tables), so that none of them drops a pair."""
    from gsplat_tpu_torch.ops.binning import build_tile_tables

    reqs = []
    for cm in cams:
        uv, z, radius, mask = frame_inputs(params, cm, st)
        t = build_tile_tables(uv, z, radius, mask, num_tiles_x=st.num_tiles_x,
                              num_tiles_y=st.num_tiles_y, tile_size=st.tile)
        reqs.append((int(t.overflow), int(t.row_overflow)))
    return capped_statics(st, max(p for p, _ in reqs), max(r for _, r in reqs))


def grows_by_rule(grows: list, cfg, minimum: int) -> bool:
    """Whether each boundary's (iteration, pair and row requirements, caps
    before, caps after) follows the reference's growth rule."""
    from gsplat_tpu_torch.train.state import round_pair_cap, round_row_cap

    for it, ov, rov, (pair_cap, row_cap), after in grows:
        shift = 2 if it < cfg.adaptive_control_end else 4
        if ov > pair_cap:
            pair_cap = round_pair_cap(ov + (ov >> shift), minimum=minimum)
        if rov > row_cap:
            row_cap = round_row_cap(rov + (rov >> shift))
        if after != (pair_cap, row_cap):
            return False
    return True


def parallel_rank(rank: int, device: str, n: int, width: int, height: int,
                  even_height: int, trainer_n: int, trainer_iters: int) -> dict:
    """[13] on one rank of a two-rank gloo group, every rank on ``device``.

    Every step bins at the caps ``frame_caps`` gives for the frames of the
    start state (the factories run eagerly: gloo's collectives stage
    through the host). ``height`` pads to the tile grid (R10),
    ``even_height`` is a whole number of tile rows a strip. Returns this
    rank's log lines, failed checks, times and the launches of its
    main-path runs (the dp and tp steps and the trainers; the
    single-device steps they are held against do not count)."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.parallel import comm
    from gsplat_tpu_torch.parallel.data_parallel import (
        dp_loss_and_grads, get_dp_train_step, get_monitored_dp_train_step)
    from gsplat_tpu_torch.parallel.tile_parallel import (
        get_monitored_tp_train_step, get_tp_train_step, tp_loss_and_grads)
    from gsplat_tpu_torch.train import trainer as trainer_mod
    from gsplat_tpu_torch.train.init import initialize_gaussians
    from gsplat_tpu_torch.train.state import init_state, params_from_jax, round_capacity
    from gsplat_tpu_torch.train.step import (
        compute_loss_and_grads, fresh_monitor, get_train_step, release_graphs, render_image,
        train_step)

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        _build.build()  # built by the parent: loads it
    logs, failed, times = [], [], {}
    say = logs.append
    main = dict.fromkeys(_build.launches, 0)

    def on_path(fn):
        _build.reset_launches()
        out = fn()
        for k, v in _build.launches.items():
            main[k] += v
        return out

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    def same_on_ranks(t: torch.Tensor) -> bool:
        got = comm.all_gather_rows(t.reshape(1, -1))
        return bool((got == got[0]).all())

    cams = views(width, height)
    cam_t = camera_tensors(cams, dev)
    st = statics(cams[0], width, height)
    st_even = statics(cams[0], width, even_height)
    start = scene_arrays(n, seed=0, perturb_seed=1)
    fresh = lambda: init_state(params_from_jax(*start, dev))  # noqa: E731
    truth = scene_params(n, seed=0, device=dev)
    gts = [render_image(truth, cm.view, cm.proj, cm.campos, BG, st)[0] for cm in cams]
    cm_even = views(width, even_height)[0]
    gt_even = render_image(truth, cm_even.view, cm_even.proj, cm_even.campos, BG,
                           st_even)[0]
    del truth
    cm = cams[0]
    state = fresh()
    st_c = frame_caps(state.params, cams, st)
    st_even_c = frame_caps(state.params, [cm_even], st_even)
    del state
    say(f"caps: {st_c.pair_cap} pairs, {st_c.row_cap} rows ({width}x{height}); "
        f"{st_even_c.pair_cap}, {st_even_c.row_cap} ({width}x{even_height})")

    # dp, the same camera on both ranks, 3 steps: bit-equal to the graphed
    # single step at the same caps (its eager first call, capture, replay).
    single, dp = fresh(), fresh()
    graph, dp_step = get_train_step(st_c), get_dp_train_step(st_c)
    metrics_equal = True
    for k in range(3):
        _, m1 = graph(single, *cam_t[0], gts[0], BG, k)
        _, m2 = on_path(lambda k=k: dp_step(dp, *cam_t[0], gts[0], BG, k))
        metrics_equal &= all(torch.equal(getattr(m1, f), getattr(m2, f)) for f in (
            "loss", "num_pairs", "overflow", "row_overflow"))
    diff = differing(single, dp)
    twice = (torch.equal(dp.accum_dur, 2 * single.accum_dur)
             and torch.equal(dp.uv_grad_accum, 2 * single.uv_grad_accum))
    say(f"dp at the caps, one camera on both ranks, 3 steps: loss and counts equal to the "
        f"graphed single step's {metrics_equal}; state differs in "
        f"{[k for k in diff if k not in ('accum_dur', 'uv_grad_accum')]}; accumulators "
        f"exactly 2x the step's {twice}")
    check(set(diff) <= {"accum_dur", "uv_grad_accum"} and twice and metrics_equal,
          "dp identical cameras vs the graphed single step")
    release_graphs()
    del single, dp, graph

    # dp, views 0 and 1: the reduced gradients are the mean of the two
    # single-camera gradients.
    state = fresh()
    one = [compute_loss_and_grads(state.params, c.view, c.proj, c.campos, g, BG, st_c)
           for c, g in zip(cams[:2], gts[:2])]
    mean = {k: (one[0][4][k] + one[1][4][k]) / 2 for k in one[0][4]}
    mean["g_uv"] = (one[0][5] + one[1][5]) / 2
    del one
    c = cams[rank]
    r = on_path(lambda: dp_loss_and_grads(state.params, c.view, c.proj, c.campos, gts[rank],
                                          BG, st_c))
    worst = {}
    for k, ref in mean.items():
        ok, worst[k], _ = rel_close(r.g_uv if k == "g_uv" else r.grads[k], ref, 1e-5)
        check(ok, f"dp reduced gradient {k}")
    say("dp, views 0 and 1: reduced gradients vs the mean of two single-camera "
        "gradients, worst relative error " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    del mean, r
    losses, watch, monitor = [], Stopwatch(dev), fresh_monitor(dev)
    step = get_monitored_dp_train_step(st_c)
    with CollectiveClock() as clock:
        for k in range(4):
            v = (2 * k + rank) % len(cams)
            state, m, monitor = on_path(lambda v=v, k=k, mon=monitor: watch(lambda: step(
                state, *cam_t[v], gts[v], BG, k, mon)))
            losses.append(float(m.loss))
    same = replicas_identical(state)
    mon_same = same_on_ranks(monitor)
    times["dp"] = watch.ms
    times["dp_comm_ms"] = 1e3 * clock.seconds / 4
    say(f"dp, 4 monitored steps over views (2k + rank) % 4: losses {losses}, replicas "
        f"identical {same}; monitor {monitor.tolist()}, the same on both ranks {mon_same}; "
        f"{clock.bytes / 4 / 2**20:.1f} MiB reduced a step")
    check(all(math.isfinite(x) for x in losses) and same and mon_same
          and monitor[2].item() == 1.0, "dp steps")
    del state

    # tp at a whole number of tile rows a strip: the single step's image,
    # loss and pairs. In exact mode: the packed mode rounds v - y_off before
    # its tile offset (as the reference does), so its strips need not give
    # the frame's bits.
    single, tp = fresh(), fresh()
    with mode_context("exact"):
        loss_s, img_s, _, tab_s, _, _ = compute_loss_and_grads(
            single.params, cm_even.view, cm_even.proj, cm_even.campos, gt_even, BG, st_even_c)
        r = on_path(lambda: tp_loss_and_grads(tp.params, cm_even.view, cm_even.proj,
                                              cm_even.campos, gt_even, BG, st_even_c))
        img_err = (r.image - img_s).abs().max().item()
        say(f"tp at {width}x{even_height}: loss {float(r.loss)!r} vs single {float(loss_s)!r}, "
            f"image max |diff| {img_err!r}, pairs {int(r.num_pairs)} vs "
            f"{int(tab_s.num_pairs)}, requirements {int(r.overflow)}, {int(r.row_overflow)} "
            f"(the larger strip's)")
        check(float(r.loss) == float(loss_s) and img_err == 0.0
              and int(r.num_pairs) == int(tab_s.num_pairs), "tp image, loss and pairs")
        del r, img_s
        train_step(single, cm_even.view, cm_even.proj, cm_even.campos, gt_even, BG, 0,
                   st_even_c)
        on_path(lambda: get_tp_train_step(st_even_c)(tp, cm_even.view, cm_even.proj,
                                                     cm_even.campos, gt_even, BG, 0))
        a, b = state_tensors(single), state_tensors(tp)
        err = max((a[k] - b[k]).abs().nan_to_num(0.0).max().item() for k in a
                  if k.startswith("params."))
        say(f"tp at {width}x{even_height}, one step: params max |tp - single| {err:.3g}")
        check(err <= 2e-5, "tp params after one step")
        del single, tp, a, b

        # tp at the padded height (R10): the same loss; the uv gradient's v
        # column scaled by H / H_pad.
        state = fresh()
        loss_s, _, _, _, _, uv_s = compute_loss_and_grads(state.params, cm.view, cm.proj,
                                                          cm.campos, gts[0], BG, st_c)
        r = on_path(lambda: tp_loss_and_grads(state.params, cm.view, cm.proj, cm.campos, gts[0],
                                              BG, st_c))
        # The strips' sums run in another order: a Gaussian whose rows cancel
        # gets 1e-6 of the column's largest |value| besides rtol 1e-5.
        ratio = height / (st.num_tiles_y * TILE)
        ok_v, rel_v, top_v = rel_close(r.g_uv[:, 1], uv_s[:, 1] * ratio, 1e-5, 1e-6)
        ok_u, rel_u, top_u = rel_close(r.g_uv[:, 0], uv_s[:, 0], 1e-5, 1e-6)
        say(f"tp at {width}x{height} (R10): loss {float(r.loss)!r} vs {float(loss_s)!r}; g_uv "
            f"v column vs single x {height}/{st.num_tiles_y * TILE}: worst |diff| / |value| "
            f"{rel_v:.3g}, / the column's max {top_v:.3g}; u column {rel_u:.3g}, {top_u:.3g}")
        check(float(r.loss) == float(loss_s) and ok_v and ok_u, "tp R10")
    del r, uv_s
    watch_tp, watch_1, monitor = Stopwatch(dev), Stopwatch(dev), fresh_monitor(dev)
    step = get_monitored_tp_train_step(st_c)
    with CollectiveClock() as clock:
        for k in range(3):
            state, m, monitor = on_path(lambda k=k, mon=monitor: watch_tp(lambda: step(
                state, *cam_t[0], gts[0], BG, k, mon)))
    times["tp"] = watch_tp.ms
    times["tp_comm_ms"] = 1e3 * clock.seconds / 3
    mon_same = same_on_ranks(monitor)
    say(f"tp, 3 monitored steps: monitor {monitor.tolist()}, the same on both ranks "
        f"{mon_same}; {clock.bytes / 3 / 2**20:.1f} MiB reduced or gathered a step")
    check(replicas_identical(state) and mon_same and monitor[2].item() == 1.0, "tp replicas")
    # The single-device step alone on the card, graphed at the caps: rank 1
    # waits.
    dist.barrier()
    if rank == 0:
        graph = get_train_step(st_c)
        for k in range(4):
            watch_1(lambda k=k: graph(state, *cam_t[0], gts[0], BG, 3 + k))
        release_graphs()
    dist.barrier()
    times["single"] = watch_1.ms
    del state

    # Trainer(dp=2) and Trainer(tp=2) on [11]'s scene and cameras, from a
    # pair cap the first window outgrows: the state's capacity (the
    # requirement counts a slot for every record at least).
    tcams, images, tgts, xyz, rgb = trainer_scene(trainer_n, 0, dev, width, height)
    first_cap = round_capacity(trainer_n)
    for mode in ("dp", "tp"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
            cfg = dataclasses.replace(
                trainer_config(tmp), num_iters=trainer_iters, adaptive_control_start=3,
                adaptive_control_interval=5, adaptive_control_end=9, pair_cap=first_cap)
            g = initialize_gaussians(xyz, rgb, cfg)
            with ImageStandIns(tgts, (height, width, 3)):
                tr = trainer_mod.Trainer(cfg, g, images, tcams, device=dev, **{mode: 2})
                grows, real_grow = [], tr._grow_caps

                def grow(overflow, row_overflow, tr=tr, real_grow=real_grow, grows=grows):
                    before = (tr.pair_cap, tr.row_cap)
                    real_grow(overflow, row_overflow)
                    grows.append((tr.iter, overflow, row_overflow, before,
                                  (tr.pair_cap, tr.row_cap)))

                tr._grow_caps = grow
                watch = Stopwatch(dev)
                on_path(lambda: watch(lambda: tr.train(verbose=False)))
        same = replicas_identical(tr.state)
        caps = torch.tensor([tr.pair_cap, tr.row_cap], device=dev)
        by_rule = grows_by_rule(grows, cfg, tr.pair_cap_minimum)
        grew = tr.pair_cap > first_cap
        say(f"Trainer({mode}=2), {trainer_n} points, {trainer_iters} iterations: "
            f"{watch.ms[0]:.1f} ms, {int(tr.state.alive.sum())} alive, capacity "
            f"{tr.state.capacity}, l_max {tr.l_max}, replicas identical {same}; caps by "
            f"boundary (iteration, requirements, before -> after) {grows}: by the rule "
            f"{by_rule}, the same on both ranks {same_on_ranks(caps)}")
        check(same and tr.iter == trainer_iters and by_rule and grew and same_on_ranks(caps),
              f"Trainer({mode}=2)")
        release_graphs()
        del tr
    return dict(rank=rank, logs=logs, failed=failed, times=times, launches=main)


def parallel_slice(dev, n: int = 1_000_000, width: int = WIDTH, height: int = HEIGHT,
                   even_height: int = 832, trainer_n: int = 100_000,
                   trainer_iters: int = 12) -> None:
    """[13] Two ranks on ``dev`` over gloo (``parallel_rank``); raises if a
    rank fails a check or a kernel of the path did not launch on a rank."""
    from gsplat_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    outs = spawn(parallel_rank, 2, (str(dev), n, width, height, even_height, trainer_n,
                                    trainer_iters),
                 backend="gloo", timeout=300, join_timeout=600)
    log(f"  two ranks on {dev} over gloo, {time.perf_counter() - t0:.1f} s in all")
    for line in outs[0]["logs"]:
        log("  " + line)
    failed = [f"rank {o['rank']}: {f}" for o in outs for f in o["failed"]]
    for o in outs:
        log(f"  rank {o['rank']} launches on the dp/tp path: {o['launches']}")
        if torch.device(dev).type == "cuda" and min(
                v for k, v in o["launches"].items() if k != SWEEP_LAUNCHES) <= 0:
            failed.append(f"rank {o['rank']}: a kernel never launched")
    t = outs[0]["times"]
    med = lambda xs: statistics.median(xs[1:] if len(xs) > 1 else xs)  # noqa: E731
    log(f"  ms a step at the caps, two ranks sharing one card over gloo (not a scaling "
        f"figure): the single-device step graphed, rank 0 alone {med(t['single']):.3f} "
        f"({', '.join(f'{x:.1f}' for x in t['single'])}: eager first call, capture, "
        f"replays); dp {med(t['dp']):.3f} ({', '.join(f'{x:.1f}' for x in t['dp'])}), "
        f"collectives "
        f"{t['dp_comm_ms']:.3f} a step; tp {med(t['tp']):.3f} "
        f"({', '.join(f'{x:.1f}' for x in t['tp'])}), collectives {t['tp_comm_ms']:.3f} a step")
    if failed:
        raise AssertionError(f"[13] failed: {failed}")


def train_profile(dev) -> None:
    """``--train-profile``: [9]'s train steps and a device profile of
    TRAIN_PROFILE_STEPS more alone, in each mode from the same start,
    without its checks, with whatever ``gsplat_tpu_torch`` is imported, so
    that one copy of this script can profile several checkouts (see the
    module docstring). A checkout from before the packed mode profiles its
    one (exact) mode. The profiles take turns, so both modes' states stay
    in memory: the wall medians printed are not for comparing checkouts
    (``--wall`` is)."""
    import inspect

    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.ops.binning import build_tile_tables
    from gsplat_tpu_torch.train.state import init_state

    _build.build()
    cams = views()
    st = statics(cams[0])
    gts, state = train_scene(cams, st, dev)
    two = "bf16_colors" in inspect.signature(build_tile_tables).parameters
    runs = {}
    for mode in ("packed", "exact") if two else ("its only",):
        if state is None:
            state = init_state(scene_params(1_000_000, seed=0, device=dev, perturb_seed=1))
        with mode_context(mode):
            state, losses, times = run_steps(state, cams, gts, st, range(TRAIN_STEPS),
                                             quiet=True)
        median = statistics.median(times[1:])
        log(f"[9] train_step, 1M Gaussians, {mode} mode: median {median:.3f} ms/step over "
            f"steps 1-{TRAIN_STEPS - 1} ({', '.join(f'{t:.2f}' for t in times)}); losses "
            f"{[float(x) for x in losses]!r}")
        runs[mode], state = [state, TRAIN_STEPS, median], None
    device = profile_modes(runs, cams, gts, st)
    log("[9] device ms/step, the mean of each mode's windows: " + ", ".join(
        f"{mode} {ms:.3f}" for mode, ms in device.items()))


def wall_steps(dev) -> None:
    """``--wall``: [9]'s train steps in each mode from the same start, the
    first mode's state freed before the second's, without checks: the
    median wall ms and process CPU ms of WALL_STEPS steps after TRAIN_STEPS
    to warm up, each step between two device synchronizations, with
    whatever ``gsplat_tpu_torch`` is imported (see the module docstring)."""
    import inspect

    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.ops.binning import build_tile_tables
    from gsplat_tpu_torch.train.state import init_state
    from gsplat_tpu_torch.train.step import train_step

    _build.build()
    cams = views()
    st = statics(cams[0])
    gts, state = train_scene(cams, st, dev)
    two = "bf16_colors" in inspect.signature(build_tile_tables).parameters
    for mode in ("packed", "exact") if two else ("its only",):
        if state is None:
            torch.cuda.empty_cache()
            state = init_state(scene_params(1_000_000, seed=0, device=dev, perturb_seed=1))
        wall = []
        with mode_context(mode):
            state, _, _ = run_steps(state, cams, gts, st, range(TRAIN_STEPS), quiet=True)
            # The process clock ticks in whole scheduler ticks (10 ms on some
            # hosts), so CPU time is read over all the steps.
            cpu = time.process_time()
            for it in range(TRAIN_STEPS, TRAIN_STEPS + WALL_STEPS):
                cm, gt = cams[it % len(cams)], gts[it % len(cams)]
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, _ = train_step(state, cm.view, cm.proj, cm.campos, gt, BG, it, st)
                torch.cuda.synchronize()
                wall.append(1e3 * (time.perf_counter() - t))
            cpu = 1e3 * (time.process_time() - cpu) / WALL_STEPS
        log(f"[wall] {mode} mode: median {statistics.median(wall):.3f} ms/step wall, "
            f"{cpu:.3f} ms/step process CPU over {WALL_STEPS} steps; "
            f"wall {', '.join(f'{x:.2f}' for x in wall)}")
        state = None


def scale_profile(dev) -> None:
    """``--scale-profile``: [15a]'s step at scale_mul 0.97 alone, without
    its checks: ``tools/bench_scale.run`` at the JAX script's caps of that
    point (one step, then 6 timed, through the CUDA graph), then a device
    profile of SCALE_AB_STEPS more steps at those caps in the default
    (packed) mode, with whatever ``gsplat_tpu_torch`` is imported (see the
    module docstring), so that two checkouts compare at the 4.25M point in
    one call."""
    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.tools import bench_scale

    _build.build()
    ref = recorded_geometry("SCALE_r04.json")
    res = bench_scale.run(SCALE_N, 0.97, steps=6, reps=1, device=dev, pair_cap=ref["pair_cap"],
                          row_cap=ref["row_cap"], log=lambda m: log("  " + m))
    median = statistics.median(res.step_ms)
    _, device = profile_steps(res.state, [res.camera], [res.target], res.statics, 7, median,
                              steps=SCALE_AB_STEPS, label=", scale_mul 0.97", bg=0.0)
    log(f"[15a] scale_mul 0.97, pairs {res.pairs}: device {device:.3f} ms/step over "
        f"{SCALE_AB_STEPS} steps; the graph {median:.3f} ms a step (CUDA events)")


ADAM_BITS_ITERS = (3000, 3001)  # --bits: apply_adam's iterations


def one_call_scenes(dev, n: int, scale_n: int):
    """--bits and --adam: (label, params, camera, statics, target, bg) of
    [9]'s start (``n`` Gaussians, view 0, the target rendered from the
    unperturbed scene), then of [15a]'s scene (``scale_n`` at scale_mul
    0.97, binning sized exactly, a seeded random target)."""
    from gsplat_tpu_torch.tools import bench_scale
    from gsplat_tpu_torch.train.state import round_capacity, state_from_gaussians
    from gsplat_tpu_torch.train.step import render_image

    cm = views()[0]
    st = statics(cm)
    truth = scene_params(n, seed=0, device=dev)
    gt, _ = render_image(truth, cm.view, cm.proj, cm.campos, BG, st)
    del truth
    yield f"{n} (1M view)", scene_params(n, seed=0, device=dev, perturb_seed=1), cm, st, gt, BG
    rng = np.random.default_rng(0)
    g = bench_scale.scale_gaussians(scale_n, 0.97, rng=rng)
    params = state_from_gaussians(g, dev, n_cap=round_capacity(scale_n)).params
    gt = torch.from_numpy(rng.uniform(0, 1, (HEIGHT, WIDTH, 3)).astype(np.float32)).to(dev)
    yield (f"{scale_n} (scale point)", params, bench_scale.scale_camera(),
           bench_scale.scale_statics(pair_cap=0), gt, 0.0)


def bits(dev, n: int = 1_000_000, scale_n: int = 4_250_000) -> None:
    """``--bits``: sha256 digests of one gradient call, in packed and in
    exact mode, at [9]'s 1M start (view 0) and at [15a]'s 4.25M scene
    (scale_mul 0.97, binning sized exactly; ``n`` and ``scale_n``
    Gaussians): of the segment sum's output
    (the per-Gaussian sums, caught where ``ops.render`` calls it) and of
    the target, image, loss and every gradient, with whatever
    ``gsplat_tpu_torch`` is imported (run as ``--train-profile``): equal
    digests of two checkouts show a mode bit for bit unchanged. Then, at
    each scene, the packed call's gradients step a fresh state of its
    parameters through ``apply_adam`` at ADAM_BITS_ITERS, the digest of
    every tensor of the state printed after each: equal digests show the
    update unchanged to the bit. Each call's forward (image, loss and tile
    tables) has a digest of its own, and ``mip_bits`` adds a Mip-Splatting
    render and gradient call: equal forward digests show the geometry, and
    with it binning's pair set, unchanged where the gradients are not."""
    import hashlib

    from gsplat_tpu_torch.ops import render
    from gsplat_tpu_torch.train import step
    from gsplat_tpu_torch.train.state import init_state

    def digest(tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    sums, real = [], render.segment_sum

    def caught(*args):
        sums.append(real(*args))
        return sums[-1]

    render.segment_sum = caught
    try:
        for label, params, cm, st, gt, bg in one_call_scenes(dev, n, scale_n):
            for mode in ("packed", "exact"):
                sums.clear()
                with mode_context(mode):
                    loss, image, mask, tables, grads, g_uv = step.compute_loss_and_grads(
                        params, cm.view, cm.proj, cm.campos, gt, bg, st)
                all_grads = [gt, image, loss.reshape(1), g_uv] + [grads[k] for k in sorted(grads)]
                log(f"[bits] {label}, {mode} mode: loss {float(loss)!r}, pairs "
                    f"{int(tables.num_pairs)}; segment sum sha256 {digest(sums)}, gradients "
                    f"sha256 {digest(all_grads)}; forward (image, loss, tile tables) sha256 "
                    f"{digest([image, loss.reshape(1), *tables_of(tables)])}")
                if mode == "packed":
                    adam_in = (grads, g_uv, mask)
                del loss, image, mask, tables, grads, g_uv, all_grads
            state = init_state(params)  # the parameters are not used again
            for it in ADAM_BITS_ITERS:
                step.apply_adam(state, *adam_in, it, st)
                log(f"[bits] {label}: the state after apply_adam at iteration {it}, "
                    f"{int(adam_in[2].sum())} rows stepped: sha256 "
                    f"{digest(state_tensors(state).values())}")
            del params, gt, state, adam_in
            torch.cuda.empty_cache()
        mip_bits(dev, n, digest)
    finally:
        render.segment_sum = real


def tables_of(tables) -> list:
    """--bits: binning's pair set and tile ranges, the forward's bits that
    the rest of the step reads."""
    return [tables.splat_gid, tables.tile_start, tables.tile_count]


def mip_bits(dev, n: int, digest) -> None:
    """--bits under Mip-Splatting: [9]'s 1M start with the 3D filter of a
    sweep over ``mip_cameras``, view 0 in packed mode: the digests of a
    render (image and tile tables) and of one gradient call's image, loss
    and gradients."""
    from gsplat_tpu_torch.ops import mip
    from gsplat_tpu_torch.train import step
    from gsplat_tpu_torch.train.state import with_filter_3d

    cm = views()[0]
    st = step.mip_statics(statics(cm))
    params = with_filter_3d(scene_params(n, seed=0, device=dev, perturb_seed=1))
    mip.update_filter_3d_(params, mip.camera_table(mip_cameras(), dev))
    image, tables = step.render_image(params, cm.view, cm.proj, cm.campos, BG, st)
    log(f"[bits] {n} (1M view), Mip-Splatting: render sha256 "
        f"{digest([image, *tables_of(tables)])}")
    gt = image.flip(0).contiguous()
    loss, image, _, tables, grads, g_uv = step.compute_loss_and_grads(
        params, cm.view, cm.proj, cm.campos, gt, BG, st)
    log(f"[bits] {n} (1M view), Mip-Splatting, packed mode: loss {float(loss)!r}; forward "
        f"sha256 {digest([image, loss.reshape(1), *tables_of(tables)])}, gradients sha256 "
        f"{digest([g_uv] + [grads[k] for k in sorted(grads)])}")


ADAM_TITLE = ("[19] masked Adam (csrc/adam.cu) against its plain version at [9]'s 1M start "
              "and [15a]'s 4.25M scene")
ADAM_TIMING_ITERS = 20  # [19]: timed calls of each version


def adam_table(dev, n: int = 1_000_000, scale_n: int = 4_250_000) -> list:
    """[19] and ``--adam``: at each of ``one_call_scenes``, the packed
    gradient call's mask and gradients step the state of its parameters
    (``apply_adam`` once at iteration 3000, so the moments are not zero);
    then, each group in turn, the kernel (``masked_adam_update_``) and
    its plain version from copies of one start, bit-equal, and each timed
    on the state (``graph_ms``: as in the step's graph, no host work
    between launches; a group's arrays may stay in the L2 from one call to
    the next); then a step's six groups in order, and ``apply_adam``
    whole, through each. Prints every group's and the step's ms beside
    ``kernel_bound``'s; returns each scene's sums (the first the 1M
    scene's). Any group not bit-equal raises."""
    from gsplat_tpu_torch.kernels.adam import masked_adam_update_, masked_adam_update_plain
    from gsplat_tpu_torch.train import step
    from gsplat_tpu_torch.train.state import PARAM_DIMS, init_state

    out = []
    for label, params, cm, st, gt, bg in one_call_scenes(dev, n, scale_n):
        _, _, mask, _, grads, g_uv = step.compute_loss_and_grads(
            params, cm.view, cm.proj, cm.campos, gt, bg, st)
        state = init_state(params)
        step.apply_adam(state, grads, g_uv, mask, 3000, st)
        it = torch.full((), 3001.0, device=dev)
        bias1 = 1.0 - torch.pow(torch.full((), 0.9, device=dev), it + 1.0)
        bias2 = 1.0 - torch.pow(torch.full((), 0.999, device=dev), it + 1.0)
        rates = {"xyz": torch.full((), st.scene_extent * st.base_lr * st.xyz_lr_init,
                                   device=dev),
                 **{k: st.base_lr * getattr(st, f"{k}_lr")
                    for k in ("rgb", "opacity", "scale", "quat", "sh")}}
        rows, stepped = mask.shape[0], int(mask.sum())
        sums = dict(stepped=0, rows=0)
        calls = {masked_adam_update_: [], masked_adam_update_plain: []}
        for name in PARAM_DIMS:
            group = (getattr(state.params, name).detach(), grads[name], state.adam_m[name],
                     state.adam_v[name])
            width = group[0].numel() // rows
            with torch.no_grad():
                copies = [[t.clone() for t in group] for _ in range(2)]
                for update, (p, g, m, v) in zip((masked_adam_update_, masked_adam_update_plain),
                                                copies):
                    update(p, g, m, v, mask, rates[name], bias1, bias2)
                torch.cuda.synchronize()
                same = all(torch.equal(bits_of(a), bits_of(b)) for a, b in zip(*copies))
                del copies
                args = (*group, mask, rates[name], bias1, bias2)
                for update, fns in calls.items():
                    fns.append(functools.partial(update, *args))
                ms, plain_ms = (graph_ms(fns[-1], ADAM_TIMING_ITERS) for fns in calls.values())
            bound = kernel_bound("masked_adam", stepped=stepped * width, rows=rows)
            log(f"  {label}, {name} ({rows} x {width}, {stepped} rows stepped): kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                f"({bound['bound_by']}); bit-equal {same}")
            if not same:
                raise AssertionError(f"[19] {label} {name}: the kernel differs from the plain "
                                     f"update")
            sums["stepped"] += stepped * width
            sums["rows"] += rows
        bound = kernel_bound("masked_adam", stepped=sums["stepped"], rows=sums["rows"])
        sums.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"], label=label)
        with torch.no_grad():
            sums["ms"], sums["plain_ms"] = (
                graph_ms(lambda fns=fns: [fn() for fn in fns], ADAM_TIMING_ITERS)
                for fns in calls.values())
        whole = {}
        for path, update in (("kernel", masked_adam_update_), ("plain", masked_adam_update_plain)):
            step.masked_adam_update_ = update
            try:
                whole[path] = graph_ms(lambda: step.apply_adam(state, grads, g_uv, mask, it, st),
                                       ADAM_TIMING_ITERS)
            finally:
                step.masked_adam_update_ = masked_adam_update_
        sums.update(apply_adam_ms=whole["kernel"], apply_adam_plain_ms=whole["plain"])
        log(f"  {label}: a step's {len(PARAM_DIMS)} groups, kernel {sums['ms']:.4f} ms, plain "
            f"{sums['plain_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms ({sums['stepped']} "
            f"elements stepped); apply_adam whole: kernel {whole['kernel']:.4f} ms, plain "
            f"{whole['plain']:.4f} ms")
        out.append(sums)
        del params, gt, state, grads, g_uv, mask, calls
        torch.cuda.empty_cache()
    return out


SH_TITLE = ("[20] SH colour (csrc/sh.cu) against its plain version at the 1M and 4.25M "
            "capacities")
SH_ROWS = (1 << 20, 6_291_456)  # [20]: the 1M and 4.25M cells' capacities
SH_TIMING_ITERS = 10  # [20]: calls a timed graph holds


def sh_inputs(dev, n: int, seed: int = 0):
    """[20] and the card tests: xyz around [9]'s scene centre, dc, sh
    (N, 15, 3) and a colour gradient as a strided view: the r g b columns
    of (N, 9) attribute rows."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    xyz = f32(rng.normal(size=(n, 3)) * [2.0, 1.4, 2.5] + [0.0, 0.0, 4.0])
    dc, sh = f32(rng.normal(size=(n, 3))), f32(0.3 * rng.normal(size=(n, 15, 3)))
    return xyz, dc, sh, f32(rng.normal(size=(n, 9)))[:, 6:9]


COVARIANCE_EDGE_ROWS = 12  # covariance_inputs: the rows planted on the edges


def covariance_inputs(dev, n: int, seed: int = 0, mip: bool = False, view: int = 1) -> dict:
    """[22] and the tests: the covariance kernels' inputs at ``views()[view]``
    (its (4, 4) matrix and intrinsics, ``kw``): camera-space points around
    [9]'s scene depth, quaternions, log-scales, opacity logits and, under
    ``mip``, the 3D filter; the conic's gradient as a strided view (columns
    2-4 of (N, 9) attribute rows) and the opacity scale's. The first
    COVARIANCE_EDGE_ROWS rows sit on the edges: |z| < 1e-6 (both signs), x/z
    and y/z past 1.3 tan-fov, z below the near plane and behind the camera, an
    opacity logit that cuts the radius to 0, a filter of 0 and two Gaussians so
    small that the Mip determinant det0 sits at its 1e-6 floor."""
    rng = np.random.default_rng(seed)
    cm = views()[view]
    xyz = rng.normal(size=(n, 3)) * [1.5, 1.0, 1.5] + [0.0, 0.0, 5.0]
    quat = rng.normal(size=(n, 4))
    scale = np.log(rng.uniform(0.005, 0.2, (n, 3)))
    opacity = rng.uniform(-4.0, 5.0, n)
    filt = rng.uniform(0.0, 0.01, n)
    lim_x = 1.3 * cm.tan_fovx
    lim_y = 1.3 * cm.tan_fovy
    xyz[:8] = [[0.1, 0.2, 3e-7], [0.1, -0.2, -5e-7], [3.0 * lim_x * 2.0, 0.1, 2.0],
               [-0.1, -3.0 * lim_y * 2.0, 2.0], [4.0, 4.0, 1.0], [0.05, 0.02, 0.05],
               [0.3, 0.1, -2.0], [0.2, -0.1, 3.0]]
    opacity[7] = -30.0
    filt[8:COVARIANCE_EDGE_ROWS] = 0.0
    scale[8:10] = [[-12.0, -12.0, -12.0], [-12.0, -11.0, -10.0]]
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    return dict(
        xyz_c=f32(xyz), quat=f32(quat), scale=f32(scale), opacity=f32(opacity),
        filter_3d=f32(filt) if mip else None, view=f32(cm.view),
        g_conic=f32(rng.normal(size=(n, 9)))[:, 2:5],
        g_opacity_scale=f32(rng.normal(size=n)) if mip else None,
        kw=dict(focal_x=cm.focal_x, focal_y=cm.focal_y, tan_fovx=cm.tan_fovx,
                tan_fovy=cm.tan_fovy))


def sh_table(dev, rows=SH_ROWS, l_max: int = 3) -> list:
    """[20] and ``--sh``: at each count of ``rows``, the forward kernel
    against ``ops/sh.py::sh_to_rgb`` and the backward kernel against
    ``sh_to_rgb_backward_plain`` (rtol 1e-5 / 1e-4 and 1e-5 of each
    tensor's largest value, as tests/test_torch_cuda.py holds them), then
    each timed in a CUDA graph (``graph_ms``) beside ``kernel_bound`` and
    the plain chain: its forward, and its forward with autograd's backward
    (the step's SH before the kernels). Returns a dict a count; a kernel
    outside its tolerance raises."""
    from gsplat_tpu_torch.kernels import sh as k_sh
    from gsplat_tpu_torch.ops import sh as sh_ops

    campos = torch.as_tensor(views()[0].campos, dtype=torch.float32, device=dev)
    out = []
    for n in rows:
        xyz, dc, sh, g = sh_inputs(dev, n)
        leaves = [t.clone().requires_grad_() for t in (xyz, dc, sh)]
        with torch.no_grad():
            rgb = k_sh.sh_to_rgb(xyz, dc, sh, campos, l_max)
            plain_rgb = sh_ops.sh_to_rgb(xyz, dc, sh, campos, l_max)
            grads = k_sh._backward_launch(g, xyz, sh, campos, l_max)
            plain = k_sh.sh_to_rgb_backward_plain(g, xyz, sh, campos, l_max)
        errs = {}
        for name, got, want, rtol in (("rgb", rgb, plain_rgb, 1e-5),
                                      ("grad_xyz", grads[0], plain[0], 1e-4),
                                      ("grad_dc", grads[1], plain[1], 1e-6),
                                      ("grad_sh", grads[2], plain[2], 1e-5)):
            scale = float(want.abs().max())
            errs[name] = float((got - want).abs().max()) / scale
            torch.testing.assert_close(got, want, rtol=rtol, atol=1e-5 * scale)
        del rgb, plain_rgb, grads, plain

        def plain_both():
            rgb = sh_ops.sh_to_rgb(*leaves, campos, l_max)
            torch.autograd.grad(rgb, leaves, grad_outputs=g)

        with torch.no_grad():
            fwd = graph_ms(lambda: k_sh.sh_to_rgb(xyz, dc, sh, campos, l_max), SH_TIMING_ITERS)
            bwd = graph_ms(lambda: k_sh._backward_launch(g, xyz, sh, campos, l_max),
                           SH_TIMING_ITERS)
            plain_fwd = graph_ms(lambda: sh_ops.sh_to_rgb(xyz, dc, sh, campos, l_max),
                                 SH_TIMING_ITERS)
        plain_fwd_bwd = graph_ms(plain_both, SH_TIMING_ITERS)
        res = dict(rows=n, ms=fwd, backward_ms=bwd, plain_ms=plain_fwd,
                   plain_backward_ms=plain_fwd_bwd - plain_fwd,
                   bound_ms=kernel_bound("sh_forward", rows=n)["bound_ms"],
                   backward_bound_ms=kernel_bound("sh_backward", rows=n)["bound_ms"],
                   max_rel_err=errs)
        log(f"  {n} rows, l_max {l_max}: forward {fwd:.4f} ms (bound {res['bound_ms']:.4f}, "
            f"plain {plain_fwd:.4f}); backward {bwd:.4f} ms (bound "
            f"{res['backward_bound_ms']:.4f}, plain autograd {res['plain_backward_ms']:.4f}; "
            f"plain forward + backward {plain_fwd_bwd:.4f}); largest error / largest value "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        out.append(res)
        del xyz, dc, sh, g, leaves
        torch.cuda.empty_cache()
    return out


MIP_TITLE = ("[21] Mip-Splatting's 3D-filter sweep (csrc/filter3d.cu) against its plain "
             "version at 2^20 rows x 161 cameras")
MIP_PHOTOS, MIP_SPLIT = 185, 8  # the sweep's poses: 185 on the circle less every 8th
MIP_TIMING_CALLS = 20
SWEEP_LAUNCHES = "filter3d"  # the sweep's _build.launches: no step or render launches it
# csrc/filter3d.cu: 29 FP32 operations a test (9 multiplies and 9 adds of
# the transform, the depth test, the four bounds' products and tests, the
# minimum and its select); 17 bytes a row (xyz, the alive byte, the depth).
FILTER3D_TEST_OPS, FILTER3D_ROW_BYTES = 29, 17


def mip_cameras(width=WIDTH, height=HEIGHT) -> list:
    """[21]: the Mip cell's sweep poses, ``trainer_cameras``' circle at
    MIP_PHOTOS centres less every MIP_SPLIT-th, as CameraMatrices."""
    from gsplat_tpu_torch.ops.camera import build_camera_matrices

    cams, images = trainer_cameras(width, height, MIP_PHOTOS)
    f = cams[1].params[0]
    return [build_camera_matrices(im.qvec, im.tvec, width, height, f, f)
            for i, im in enumerate(images.values()) if i % MIP_SPLIT]


def mip_table(dev, n: int = 1_000_000) -> dict:
    """[21] and ``--mip``: the sweep kernel (``kernels/filter3d.py``) against
    ``ops/mip.py::nearest_depth_plain`` on the CPU, and the filter of
    ``update_filter_3d_`` against ``filter_3d_plain``, bit for bit, at [9]'s
    scene of n Gaussians (capacity 2^20) and ``mip_cameras``, with rows
    planted on each screen margin, at the depth floor and behind every
    camera; then the kernel and the whole ``update_filter_3d_`` timed
    (MIP_TIMING_CALLS calls between CUDA events) beside ``kernel_bound``
    and the plain loop on the card. A mismatch raises."""
    from gsplat_tpu_torch.kernels import filter3d
    from gsplat_tpu_torch.ops import mip
    from gsplat_tpu_torch.train.state import with_filter_3d

    cams = mip_cameras()
    params = with_filter_3d(scene_params(n, 0, dev))
    xyz, alive = params.xyz.detach(), params.alive
    table = mip.camera_table(cams, dev)
    with torch.no_grad():  # planted rows: on camera 0's margins, at its floor, behind all
        view = torch.as_tensor(cams[0].view, device=dev)
        r, t = view[:3, :3], view[:3, 3]
        k = table[0].tolist()
        z = 5.0  # on each bound (x_lo, x_hi, y_lo, y_hi over the focal length) at depth z
        planted = [(k[14] * z, 0.0, z), (k[15] * z, 0.0, z), (0.0, k[16] * z, z),
                   (0.0, k[17] * z, z), (0.0, 0.0, mip.DEPTH_FLOOR), (0.0, 0.0, 0.0)]
        cam_pts = torch.tensor(planted, dtype=torch.float32, device=dev)
        xyz[:len(planted)] = (cam_pts - t) @ r  # camera -> world: R^T (x_c - t)
        xyz[len(planted)] = torch.tensor([0.0, 0.0, -50.0], device=dev)  # behind every camera
    got = filter3d.nearest_depth(xyz, alive, table)
    want = mip.nearest_depth_plain(xyz.cpu(), alive.cpu(), table.cpu())
    if not torch.equal(got.cpu(), want):
        bad = int((got.cpu() != want).sum())
        raise AssertionError(f"[21] the sweep kernel differs from its plain version in {bad} rows")
    mip.update_filter_3d_(params, table)
    if not torch.equal(params.filter_3d.cpu(), mip.filter_3d_plain(xyz.cpu(), alive.cpu(),
                                                                   table.cpu())):
        raise AssertionError("[21] the filter differs from its plain version")
    seen = int(torch.isfinite(want).sum())
    tests = int(alive.sum()) * len(cams)

    def calls(fn):
        def many():
            for _ in range(MIP_TIMING_CALLS):
                fn()
        return cuda_ms(many, 5) / MIP_TIMING_CALLS

    with torch.no_grad():
        kernel = calls(lambda: filter3d.nearest_depth(xyz, alive, table))
        update = calls(lambda: mip.update_filter_3d_(params, table))
        plain = cuda_ms(lambda: mip.nearest_depth_plain(xyz, alive, table), 3)
    bound = kernel_bound("filter3d", rows=int(alive.shape[0]), tests=tests)
    res = dict(rows=int(alive.shape[0]), cameras=len(cams), seen=seen, kernel_ms=kernel,
               update_ms=update, plain_ms=plain, bound_ms=bound["bound_ms"],
               bound_by=bound["bound_by"], bound_pct=100.0 * bound["bound_ms"] / kernel)
    log(f"  {res['rows']} rows x {len(cams)} cameras, {seen} seen: bit-equal to the plain "
        f"version; kernel {kernel:.4f} ms, update_filter_3d_ {update:.4f} ms, bound "
        f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({res['bound_pct']:.1f} %), the "
        f"plain loop on the card {plain:.2f} ms")
    log("MIP " + json.dumps(res))
    return res


COVARIANCE_TITLE = ("[22] the covariance (csrc/covariance.cu) against the plain ops at the 1M "
                    "and 4.25M capacities, plain 3DGS and Mip-Splatting")
COVARIANCE_TIMING_ITERS = 10  # [22]: calls a timed graph holds


def covariance_table(dev, rows=SH_ROWS) -> list:
    """[22] and ``--covariance``: at each count of ``rows`` and for each
    model, ``covariance_inputs`` through the kernels (the autograd Function)
    and through the plain ops: the forward's outputs bit for bit (the rows
    whose radius differs counted, and three orders of the quaternion's
    squared norm counted where they differ from torch.sum on the card),
    and each path's gradients against float64 autograd through the plain
    ops (the worst leaf's distance over its norm); then the forward
    kernel, the backward kernel, the plain forward and the plain forward
    with autograd's backward each timed in a CUDA graph beside
    ``kernel_bound``. Returns a dict a count and model; a forward that is
    not bit-equal, or a backward further from float64 than 3x the plain
    float32 chain, raises."""
    from gsplat_tpu_torch.kernels import covariance as kc

    def run(inp, kernel: bool):
        leaves = [inp[k].clone().requires_grad_() for k in ("xyz_c", "quat", "scale")]
        fn = kc.covariance if kernel else kc.covariance_plain
        out = fn(*leaves, inp["opacity"], inp["view"], mh_dist=3.0,
                 filter_3d=inp["filter_3d"], **inp["kw"])
        outs = [out[0]] + ([out[2]] if out[2] is not None else [])
        grads = [inp["g_conic"]] + ([inp["g_opacity_scale"]] if out[2] is not None else [])
        return out, torch.autograd.grad(outs, leaves, grad_outputs=grads)

    def gap(got, want) -> float:
        return max(float((a.double() - b).norm() / b.norm()) for a, b in zip(got, want))

    res = []
    for n in rows:
        for mip in (False, True):
            inp = covariance_inputs(dev, n, seed=n, mip=mip)
            consts = kc._consts(mh_dist=3.0, mip_model=mip, **inp["kw"])
            args = (inp["xyz_c"], inp["quat"], inp["scale"])
            out, grads = run(inp, True)
            plain, plain_grads = run(inp, False)
            radius_rows = int((out[1] != plain[1]).any(dim=1).sum())
            same = [a is None or torch.equal(bits_of(a), bits_of(b))
                    for a, b in zip(out, plain)]
            q = inp["quat"] * inp["quat"]
            orders = {"(a+c)+(b+d)": (q[:, 0] + q[:, 2]) + (q[:, 1] + q[:, 3]),
                      "(a+b)+(c+d)": (q[:, 0] + q[:, 1]) + (q[:, 2] + q[:, 3]),
                      "((a+b)+c)+d": ((q[:, 0] + q[:, 1]) + q[:, 2]) + q[:, 3]}
            norm_rows = {k: int((v != torch.sum(q, dim=1)).sum()) for k, v in orders.items()}
            del out, plain, q, orders
            f64 = {k: v.double() if isinstance(v, torch.Tensor) else v for k, v in inp.items()}
            truth = [g.double() for g in run(f64, False)[1]]
            del f64
            gaps = dict(kernel=gap(grads, truth), plain=gap(plain_grads, truth),
                        kernel_vs_plain=gap(grads, [g.double() for g in plain_grads]))
            del grads, plain_grads, truth
            torch.cuda.empty_cache()
            leaves = [t.clone().requires_grad_() for t in args]

            def plain_both():
                out = kc.covariance_plain(*leaves, inp["opacity"], inp["view"], mh_dist=3.0,
                                          filter_3d=inp["filter_3d"], **inp["kw"])
                outs = [out[0]] + ([out[2]] if mip else [])
                gs = [inp["g_conic"]] + ([inp["g_opacity_scale"]] if mip else [])
                torch.autograd.grad(outs, leaves, grad_outputs=gs)

            fwd_args = (*args, inp["opacity"], inp["filter_3d"], inp["view"], consts)
            bwd_args = (inp["g_conic"], inp["g_opacity_scale"], *args, inp["filter_3d"],
                        inp["view"], consts)
            with torch.no_grad():
                fwd = graph_ms(lambda: kc._forward_launch(*fwd_args), COVARIANCE_TIMING_ITERS)
                bwd = graph_ms(lambda: kc._backward_launch(*bwd_args),
                               COVARIANCE_TIMING_ITERS)
                plain_fwd = graph_ms(lambda: kc.covariance_plain(
                    *args, inp["opacity"], inp["view"], mh_dist=3.0,
                    filter_3d=inp["filter_3d"], **inp["kw"]), COVARIANCE_TIMING_ITERS)
            plain_fwd_bwd = graph_ms(plain_both, COVARIANCE_TIMING_ITERS)
            r = dict(rows=n, model="mip" if mip else "3dgs", radius_rows=radius_rows,
                     bit_equal=dict(zip(("conic", "radius", "opacity_scale"), same)),
                     norm_order_rows=norm_rows, grad_gaps=gaps, ms=fwd, backward_ms=bwd,
                     plain_ms=plain_fwd, plain_backward_ms=plain_fwd_bwd - plain_fwd,
                     bound_ms=kernel_bound("covariance_forward", rows=n, mip=mip)["bound_ms"],
                     backward_bound_ms=kernel_bound("covariance_backward", rows=n,
                                                    mip=mip)["bound_ms"])
            r["floor_pct"] = 100.0 * r["bound_ms"] / fwd
            r["backward_floor_pct"] = 100.0 * r["backward_bound_ms"] / bwd
            log(f"  {n} rows, {r['model']}: forward {fwd:.4f} ms (bound {r['bound_ms']:.4f}, "
                f"{r['floor_pct']:.1f} %; plain {plain_fwd:.4f}); backward {bwd:.4f} ms (bound "
                f"{r['backward_bound_ms']:.4f}, {r['backward_floor_pct']:.1f} %; plain autograd "
                f"{r['plain_backward_ms']:.4f}); radius rows differing {radius_rows}, bit-equal "
                f"{r['bit_equal']}; torch.sum order rows differing {norm_rows}; gradients "
                f"from float64: kernel {gaps['kernel']:.2e}, plain f32 {gaps['plain']:.2e}, "
                f"kernel vs plain f32 {gaps['kernel_vs_plain']:.2e}")
            log("COVARIANCE " + json.dumps(r))
            res.append(r)
            del inp, args, leaves, fwd_args, bwd_args
            torch.cuda.empty_cache()
    bad = [r for r in res if r["radius_rows"] or not all(r["bit_equal"].values())]
    if bad:
        raise AssertionError(f"[22] the forward kernel is not bit-equal to the plain ops: {bad}")
    far = [r for r in res if r["grad_gaps"]["kernel"] > 3.0 * r["grad_gaps"]["plain"]]
    if far:
        raise AssertionError(f"[22] the backward kernel strays from float64: {far}")
    return res


def sfm_cloud(arrays: dict, n: int, seed: int):
    """An SfM-like cloud of ``scene_arrays``' first n Gaussians: their
    centres plus N(0, 0.05^2) jitter, float64, with uint8 colours."""
    from gsplat_tpu_torch.train.init import Y00

    rng = np.random.default_rng(seed + 100)
    xyz = arrays["xyz"][:n].astype(np.float64) + rng.normal(0.0, 0.05, (n, 3))
    rgb = np.clip((arrays["rgb"][:n] * Y00 + 0.5) * 255, 0, 255).astype(np.uint8)
    return xyz, rgb


def seconds(fn):
    """(fn(), host seconds it took)."""
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def native_slice(n: int = NATIVE_POINTS) -> list:
    """[14a] The C++ host runtime (``io/native.py``) against its plain
    versions on [11]'s kind of cloud at n points: the KNN against scipy's
    cKDTree (rtol 1e-6), a points3D.bin of the port's writer parsed by both
    readers (equal arrays), and the PLY writer against ``io/ply.py``'s
    (equal bytes). Returns the failed checks."""
    import tempfile

    from gsplat_tpu_torch.io import colmap, native, ply
    from gsplat_tpu_torch.train.init import initialize_gaussians, knn_mean_dist_plain

    _, t_build = seconds(native.build)
    log(f"  {native.library_path().name}: built and loaded in {t_build:.2f} s "
        f"(g++ {' '.join(native.CXX_FLAGS)})")
    arrays, _ = scene_arrays(n, 0)
    xyz, rgb = sfm_cloud(arrays, n, 0)
    del arrays
    failed = []
    k = 3
    got, t_native = seconds(lambda: native.knn_mean_dist(xyz, k))
    ref, t_plain = seconds(lambda: knn_mean_dist_plain(xyz, k))
    rel = float(np.max(np.abs(got.astype(np.float64) - ref) / np.abs(ref)))
    log(f"  KNN mean distance, {n} points, k = {k}: native {t_native:.3f} s, scipy cKDTree "
        f"{t_plain:.3f} s ({t_plain / t_native:.2f}x); largest relative difference "
        f"{rel:.3g} (rtol 1e-6)")
    if not np.allclose(got, ref, rtol=1e-6, atol=0):
        failed.append("KNN")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as tmp:
        path = Path(tmp) / "points3D.bin"
        empty = np.zeros(0, np.int32)
        points = {i + 1: colmap.Point3D(id=i + 1, xyz=xyz[i], rgb=rgb[i], error=0.5,
                                        image_ids=empty, point2d_idxs=empty)
                  for i in range(n)}
        _, t_write = seconds(lambda: colmap.write_points3d_binary(points, path))
        del points
        nat, t_native = seconds(lambda: native.parse_points3d(path))
        plain, t_plain = seconds(lambda: colmap.read_points3d_binary(path))
        pl = (np.stack([p.xyz for p in plain.values()]),
              np.stack([p.rgb for p in plain.values()]),
              np.array([p.error for p in plain.values()]),
              np.array(list(plain), np.uint64))
        del plain
        same = all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(nat, pl))
        log(f"  points3D.bin, {n} points ({path.stat().st_size} bytes, written in "
            f"{t_write:.2f} s): native parse {t_native:.3f} s, Python reader {t_plain:.3f} s "
            f"({t_plain / t_native:.1f}x); arrays equal {same}, xyz equal to the cloud "
            f"{np.array_equal(nat[0], xyz)}")
        if not (same and np.array_equal(nat[0], xyz) and np.array_equal(nat[1], rgb)):
            failed.append("points3D parse")
        g = initialize_gaussians(xyz, rgb)
        sh = np.random.default_rng(1).normal(0.0, 0.1, (n, 45)).astype(np.float32)
        cols = (g.xyz, g.rgb, g.opacity, g.scale, g.quaternion, sh)
        _, t_native = seconds(lambda: native.save_ply(Path(tmp) / "native.ply", *cols))
        _, t_plain = seconds(lambda: ply.save_ply(Path(tmp) / "plain.ply", *cols))
        a = np.fromfile(Path(tmp) / "native.ply", np.uint8)
        b = np.fromfile(Path(tmp) / "plain.ply", np.uint8)
        m = min(a.size, b.size)
        diff = np.flatnonzero(a[:m] != b[:m])
        first = int(diff[0]) if diff.size else (None if a.size == b.size else m)
        log(f"  PLY, {n} Gaussians with 45 SH coefficients ({a.size} bytes): native "
            f"{t_native:.3f} s, io/ply.py {t_plain:.3f} s; "
            + ("bytes equal" if first is None else f"first differing byte at offset {first}"))
        if first is not None:
            failed.append("PLY bytes")
    return failed


def strip_margin(uv, radius, gid, tile, num_tiles_x: int, ts: int) -> torch.Tensor:
    """R5's check of a (Gaussian, tile) pair on which two devices' binning
    disagree, in float64 on the CPU: the smallest distance, in pixels,
    from the pair's OBB-ellipse extent in the tile's row (its y-span and
    its x-interval in that strip, binning's closed forms) to the tile's
    pixel-rect edges. Near 0, membership turns on f32 rounding."""
    from gsplat_tpu_torch.ops import binning

    g = gid.long().cpu()
    u, v = uv[:, 0].double().cpu()[g], uv[:, 1].double().cpu()[g]
    r = radius.double().cpu()[g]
    a1x, a1y = r[:, 0] * r[:, 3], r[:, 0] * r[:, 2]
    a2x, a2y = -r[:, 1] * r[:, 2], r[:, 1] * r[:, 3]
    s_e = r[:, 4] if r.shape[1] >= 5 else torch.full_like(u, 2.0)
    tile = tile.long().cpu()
    tx, ty = (tile % num_tiles_x).double(), (tile // num_tiles_x).double()
    hy = torch.minimum(a1y.abs() + a2y.abs(), s_e * torch.sqrt(a1y * a1y + a2y * a2y))
    dy0 = ty * ts - v
    dy1 = dy0 + (ts - 1.0)
    xhi = torch.minimum(binning._strip_x_extreme(u, a1x, a1y, a2x, a2y, dy0, dy1),
                        binning._strip_x_extreme_ell(u, s_e * a1x, s_e * a1y, s_e * a2x,
                                                     s_e * a2y, dy0, dy1))
    xlo = torch.maximum(-binning._strip_x_extreme(-u, -a1x, a1y, -a2x, a2y, dy0, dy1),
                        -binning._strip_x_extreme_ell(-u, -s_e * a1x, s_e * a1y,
                                                      -s_e * a2x, s_e * a2y, dy0, dy1))
    edges = torch.stack([xhi - tx * ts, tx * ts + (ts - 1.0) - xlo,
                         v + hy - ty * ts, ty * ts + (ts - 1.0) - (v - hy)])
    return torch.nan_to_num(edges.abs(), nan=float("inf")).amin(dim=0)


def pair_codes(tables, cap: int) -> torch.Tensor:
    """Each slot's (tile, Gaussian) as tile * cap + gid, int64, sorted."""
    tiles = torch.repeat_interleave(
        torch.arange(tables.tile_count.shape[0], device=tables.splat_gid.device),
        tables.tile_count.long())
    return torch.sort(tiles * cap + tables.splat_gid.long()).values


def depth_rank_slice(dev, n: int = 100_000) -> tuple:
    """[14b] ``build_tile_tables(depth_rank=)`` on the card at the bench
    view with n Gaussians (capacity 2^17: 13 + 17 key bits, the budget
    exactly full). Returns (failed checks, the radix sort's entry for the
    kernels line)."""
    from gsplat_tpu_torch.kernels import _build, sort
    from gsplat_tpu_torch.kernels.expand import segment_expand
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.render import rasterize
    from gsplat_tpu_torch.train.step import _per_gaussian

    cm = views()[0]
    st = statics(cm)
    params = scene_params(n, seed=0, device=dev)
    with torch.no_grad():
        view, proj, campos = (torch.as_tensor(x, device=dev)
                              for x in (cm.view, cm.proj, cm.campos))
        uv, conic, rgb, mask, radius, z = _per_gaussian(params, view, proj, campos, st)
    cap = uv.shape[0]
    num_tiles = st.num_tiles_x * st.num_tiles_y
    qd_bits = max(1, (cap - 1).bit_length())
    key_bits = binning.sort_key_bits(num_tiles, qd_bits)
    rank = torch.empty(cap, dtype=torch.int32, device=dev)
    rank[torch.argsort(z, stable=True)] = torch.arange(cap, dtype=torch.int32, device=dev)
    kw = dict(num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y, tile_size=st.tile)
    dflt = binning.build_tile_tables(uv, z, radius, mask, **kw)
    torch.cuda.synchronize()
    _build.reset_launches()
    tables = binning.build_tile_tables(uv, z, radius, mask, depth_rank=rank, **kw)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    log(f"  {num_tiles} tiles ({num_tiles.bit_length()} bits), capacity {cap} ({qd_bits} "
        f"bits): {key_bits}-bit keys, {len(sort.sort_plan(1, key_bits).bits)} passes; "
        f"pairs {tables.num_pairs} (default mode {dflt.num_pairs}); launches {launches}")
    failed = []
    if not (launches["radix_sort/tile"] == 1 and launches["segment_expand"] == 2):
        failed.append("launches")
    same_sets = (torch.equal(tables.tile_start, dflt.tile_start)
                 and torch.equal(tables.tile_count, dflt.tile_count)
                 and torch.equal(pair_codes(tables, cap), pair_codes(dflt, cap)))
    tile_of = torch.repeat_interleave(torch.arange(num_tiles, device=dev),
                                      tables.tile_count.long())
    r = rank[tables.splat_gid.long()]
    inner = tile_of[1:] == tile_of[:-1]
    strict = bool((r[1:] > r[:-1])[inner].all())
    log(f"  each tile's pair set equals the default mode's: {same_sets}; each tile in "
        f"strictly ascending rank: {strict} ({int(inner.sum())} neighbouring pairs)")
    if not (same_sets and strict):
        failed.append("pair sets or rank order")
    # The CPU path on the same inputs.
    cpu = binning.build_tile_tables(uv.cpu(), z.cpu(), radius.cpu(), mask.cpu(),
                                    depth_rank=rank.cpu(), **kw)
    fields = ("splat_gid", "tile_start", "tile_count", "pair_cand", "pair_start")
    differ = [f for f in fields if not torch.equal(getattr(tables, f).cpu(), getattr(cpu, f))]
    log(f"  card vs CPU path: {'equal' if not differ else 'differ in ' + ', '.join(differ)} "
        f"({', '.join(fields)}; pairs {tables.num_pairs} vs {cpu.num_pairs})")
    if differ:
        a, b = pair_codes(tables, cap).cpu(), pair_codes(cpu, cap)
        odd = torch.cat([a[~torch.isin(a, b)], b[~torch.isin(b, a)]])
        if odd.numel() == 0:  # equal sets in another order: a rank leaves none
            failed.append("card vs CPU order")
        else:
            margin = strip_margin(uv, radius, odd % cap, odd // cap, st.num_tiles_x, st.tile)
            log(f"  {odd.numel()} pairs on one side only; their float64 distance to a tile "
                f"edge (R5): at most {float(margin.max()):.3g} px")
            if float(margin.max()) > 1e-2:
                failed.append("card vs CPU pair sets beyond R5")
    with torch.no_grad():
        img = rasterize(uv, conic, rgb, params.opacity, tables, BG, width=st.width,
                        height=st.height, tile=st.tile).image
        ref = rasterize(uv, conic, rgb, params.opacity, dflt, BG, width=st.width,
                        height=st.height, tile=st.tile).image
    p = psnr(img, ref)
    log(f"  render in rank order vs the default mode: PSNR {p:.2f} dB")
    if not (torch.isfinite(img).all() and img.shape == ref.shape):
        failed.append("render")
    # K3 at both modes' keys: the tile site's shapes at this view.
    res = {}
    for label, rk, qd in (("depth_rank", rank, qd_bits),
                          ("default", None, binning.depth_key_bits(num_tiles))):
        bits = binning.sort_key_bits(num_tiles, qd)
        geom, rec1, off1, total_rows = binning.row_expand_inputs(
            uv, z, radius, mask, depth_rank=rk, **kw)
        rows = segment_expand(rec1, off1, total_rows)
        rec2, off2, total = binning.pair_expand_inputs(geom, rows, num_tiles_x=st.num_tiles_x,
                                                       tile_size=st.tile)
        keys, _ = binning.pair_keys(geom, segment_expand(rec2, off2, total), qd)
        got = sort.radix_sort(keys, bits)
        want = torch.sort(keys, stable=True)
        if not (torch.equal(got[0], want.values)
                and torch.equal(got[1], want.indices.to(torch.int32))):
            failed.append(f"radix sort of the {label} keys")
        res[label] = dict(
            max_abs_err=0.0, key_bits=bits, keys=keys.shape[0],
            ms=cuda_ms(lambda k=keys, b=bits: sort.radix_sort(k, b), 10),
            plain_ms=cuda_ms(lambda k=keys, b=bits: sort.radix_sort_plain(k, b), 10),
            library_ms=cuda_ms(lambda k=keys: torch.sort(k, stable=True), 10),
            **kernel_bound("radix_sort", keys=keys.shape[0]))
        log(f"  radix_sort, {label} keys: {keys.shape[0]} keys of {bits} bits, "
            f"{len(sort.sort_plan(1, bits).bits)} passes")
    log_times({f"radix_sort/tile ({k})": v for k, v in res.items()})
    entry = dict(launches=launches["radix_sort/tile"], **res["depth_rank"])
    return failed, entry


# Kernels the e2e recipe must launch (packed, the default mode): binning's,
# the density steps' Morton re-sort, the packed rasterizers and segment sum.
E2E_KERNELS = ("segment_expand", "radix_sort/tile", "radix_sort/morton",
               "rasterize_forward/packed", "rasterize_backward/packed",
               "segment_sum/packed")


def e2e_slice(dev, iters: int = E2E_ITERS) -> tuple:
    """[14c] ``tools/e2e_synthetic.py``'s recipe at its full length on the
    card, its stages under ``StageTimers``, and [14d] ``device_trace`` over
    two more train steps. Returns (failed checks, the run's launches)."""
    import tempfile

    import PIL

    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.tools import e2e_synthetic
    from gsplat_tpu_torch.utils.profiling import StageTimers, device_trace

    from gsplat_tpu_torch.train.step import graph_captures

    log(f"  images through PIL {PIL.__version__} on disk")
    timers = StageTimers()
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_e2e_") as tmp:
        torch.cuda.synchronize()
        _build.reset_launches()
        captures = graph_captures()
        res = e2e_synthetic.run(iters, root=tmp, device=dev, timers=timers,
                                log=lambda msg: log("  " + msg))
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        captures = graph_captures() - captures
        log(f"  [14c] eval PSNR {res.psnr_before:.4f} -> {res.psnr_after:.4f} dB "
            f"({res.gain_db:+.4f} dB; the JAX package's recorded run: +11 dB), "
            f"{res.iters} iterations in {res.seconds:.3f} s ({res.iters_per_s:.2f} it/s), "
            f"{res.initial_gaussians} -> {res.final_gaussians} Gaussians, l_max "
            f"{res.l_max}, PLY {res.ply_bytes} bytes")
        log(f"  launches: {launches}")
        if not (math.isfinite(res.psnr_after) and res.gain_db > e2e_synthetic.MIN_GAIN_DB):
            failed.append(f"e2e gain {res.gain_db:.3f} dB <= {e2e_synthetic.MIN_GAIN_DB}")
        never = [k for k in E2E_KERNELS if launches[k] <= 0]
        if never:
            failed.append(f"never launched in the e2e run: {never}")
        log("  [14d] StageTimers:")
        for line in timers.report().splitlines():
            log("    " + line)
        with device_trace(Path(tmp) / "trace") as prof:
            res.trainer.train(max_iters=iters + 2, verbose=False)
        size = prof.trace_path.stat().st_size
        events = json.loads(prof.trace_path.read_text())["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        log(f"  device_trace over 2 train steps: {prof.trace_path.name}, {size} bytes, "
            f"{len(events)} events, {kernels} of them device kernels")
        if not (size > 0 and kernels > 0):
            failed.append("device_trace")
        # The same recipe with the trainer's factories eager (launches not
        # counted): the same result, and its rate beside the graph's.
        counts = dict(_build.launches)
        with eager_factories(), tempfile.TemporaryDirectory(prefix="chip_smoke_e2e_") as tmp2:
            eager = e2e_synthetic.run(iters, root=tmp2, device=dev, log=lambda msg: None)
        _build.launches.update(counts)
        log(f"  [14c] graphed: {res.iters_per_s:.2f} it/s, {captures} captures; eager "
            f"factories: {eager.iters_per_s:.2f} it/s ({eager.seconds:.3f} s); eval PSNR "
            f"{res.psnr_after:.6f} / {eager.psnr_after:.6f} dB")
        if eager.psnr_after != res.psnr_after or captures <= 0:
            failed.append("e2e graphed and eager runs differ, or no capture")
    return failed, launches


def remaining_slice(dev) -> dict:
    """[14]: a-d above; raises if a check of any part failed."""
    log(f"  [14a] native host runtime vs plain versions, {NATIVE_POINTS} points")
    failed = native_slice()
    log("  [14b] depth_rank binning on the card, 100K Gaussians, bench view")
    f, entry = depth_rank_slice(dev)
    failed += f
    log(f"  [14c] e2e recipe, {E2E_ITERS} iterations, and [14d] profiling")
    f, launches = e2e_slice(dev)
    failed += f
    if failed:
        raise AssertionError(f"[14] failed: {failed}")
    return dict(depth_rank=entry, e2e_launches=launches)


# [15]: the configuration's ceiling. The JAX package's recorded geometry at
# its two scale points (counts, not times): scale_mul -> file.
SCALE_N = 4_250_000
SCALE_POINTS = ((0.97, "SCALE_r04.json"), (1.52, "SCALE_WIDE_r04.json"))
SCALE_PROFILE_STEPS = 4  # [15a]: profiled train steps a point
SCALE_AB_STEPS = 8  # --scale-profile: profiled train steps at scale_mul 0.97
SCALE_TIMING_ITERS = 5  # [15a]: kernel timings at the scale point
# [15b], [15c]: tools/train_at_scale.py at half its default length of 2,000
# iterations, each event of its schedule at half its iteration (13 density
# steps, the reset, 3 SH bands, as at 2,000), so that the whole script,
# [16]'s 7,000 iterations included, keeps a margin within its time limit.
SCALE_ITERS = 1000
LONG_RUN_SCHEDULE = dict(adaptive_control_start=150, adaptive_control_interval=50,
                         adaptive_control_end=850, reset_opacity_start=450,
                         reset_opacity_interval=750, reset_opacity_end=851,
                         add_sh_band_interval=250, print_interval=250, test_eval_interval=250)
# [15c]: the recipe from a sparser cloud. From its default 20,000 points the
# scene stays within the first bucket (32,768); from 2,000 the capacity
# grows through 4,096 -> 8,192 -> 16,384 on an H100.
SPARSE_POINTS = 2000
SCALE_TITLE = ("[15] the configuration's ceiling: the 4.25M-Gaussian train step and the "
               "garden-scale long run")
# The kernels of the packed path, a step of the scale point: key -> launches
# a step (K5 at both binning levels, the tile sort once).
SCALE_STEP_LAUNCHES = {"segment_expand": 2, "radix_sort": 1, "radix_sort/tile": 1,
                       "rasterize_forward": 1, "rasterize_forward/packed": 1,
                       "rasterize_backward": 1, "rasterize_backward/packed": 1,
                       "segment_sum": 1, "segment_sum/packed": 1, "masked_adam": ADAM_GROUPS}


def add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def recorded_geometry(name: str) -> dict:
    """The JAX package's counts at a scale point (``SCALE_*.json``)."""
    return json.loads((Path(__file__).resolve().parent / name).read_text())


def scale_point(dev, scale_mul: float, ref: dict, total: dict, compare: bool) -> tuple:
    """[15a] at one ``scale_mul``: ``tools/bench_scale.run`` (one step, then
    3 x 6 timed), its pairs and tile rows beside the JAX package's recorded
    ones, a device profile, one exact-mode step from the same state; with
    ``compare``, the packed path's gradients twice and every kernel against
    its plain version at these shapes. Adds the runs' launches to
    ``total``; returns the failed checks and, with ``compare``, the
    kernels' results (else None)."""
    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.tools import bench_scale
    from gsplat_tpu_torch.train.state import round_capacity
    from gsplat_tpu_torch.train.step import (
        compute_loss_and_grads, release_graphs, render_image, train_step)

    failed = []
    torch.cuda.synchronize()
    _build.reset_launches()
    # At the JAX script's capacities of this point, through the CUDA graph.
    res = bench_scale.run(SCALE_N, scale_mul, device=dev, pair_cap=ref["pair_cap"],
                          row_cap=ref["row_cap"], log=lambda m: log("  " + m))
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    add_launches(total, launches)
    log(f"  [15a] caps {ref['pair_cap']} pairs, {ref['row_cap']} rows (the JAX script's); "
        f"requirements at the first step {res.overflow} pairs, {res.row_overflow} rows (JAX "
        f"package: {ref['overflow_required_cap']}, {ref['row_overflow']}); truncation-free "
        f"{res.overflow <= ref['pair_cap'] and res.row_overflow <= ref['row_cap']}")
    steps = 1 + res.steps * len(res.step_ms)
    # The JAX package recorded the last step's pairs and tile rows, its rows
    # with a sentinel for every record of the capacity that has none.
    rel = [(a - b) / b for a, b in ((res.pairs, ref["num_pairs"]),
                                    (res.last_pairs, ref["num_pairs"]),
                                    (res.reference_rows, ref["row_overflow"]))]
    log(f"  [15a] scale_mul {scale_mul}: capacity {res.capacity}; pairs {res.pairs} at the "
        f"first step, {res.last_pairs} at the last (JAX package, last step: "
        f"{ref['num_pairs']}; {100 * rel[0]:+.4f} %, {100 * rel[1]:+.4f} %); tile rows at "
        f"the first step {res.rows} of {res.row_gaussians} Gaussians, {res.reference_rows} "
        f"with the sentinels (JAX package, last step: {ref['row_overflow']}; "
        f"{100 * rel[2]:+.4f} %); {statistics.median(res.step_ms):.3f}"
        f" ms a step (CUDA events, reps {', '.join(f'{t:.3f}' for t in res.step_ms)}); first "
        f"step {res.first_s:.3f} s; loss {res.loss:.6f}; peak allocated "
        + ("not measured" if res.peak_mib is None else f"{res.peak_mib:.0f} MiB"))
    log(f"  launches over {steps} steps: {launches}")
    want = {k: n * steps for k, n in SCALE_STEP_LAUNCHES.items()}
    if {k: launches[k] for k in want} != want:
        failed.append(f"scale_mul {scale_mul}: launches {launches}, want {want}")
    if not (res.loss_finite and res.capacity == round_capacity(SCALE_N) and res.pairs > 0):
        failed.append(f"scale_mul {scale_mul}: loss {res.loss}, capacity {res.capacity}")
    state, cm, gt, st = res.state, res.camera, res.target, res.statics
    # The profile's and the comparisons' launches are not counted.
    state, _ = profile_steps(state, [cm], [gt], st, 1, statistics.median(res.step_ms),
                             steps=SCALE_PROFILE_STEPS, label=f", scale_mul {scale_mul}",
                             kernels=compare, bg=0.0)
    kernels = None
    if compare:
        calls = [compute_loss_and_grads(state.params, cm.view, cm.proj, cm.campos, gt, 0.0, st)
                 for _ in range(2)]
        (_, _, _, tables, g_a, uv_a), (_, _, _, _, g_b, uv_b) = calls
        same = all(torch.equal(bits_of(g_a[k]), bits_of(g_b[k])) for k in g_a)
        same &= torch.equal(bits_of(uv_a), bits_of(uv_b))
        counts_per_tile = tables.tile_count
        log(f"  gradients of two calls on the same state bit-identical {same}; K1 and K2 "
            f"compared on all {counts_per_tile.shape[0]} tiles, the densest holding "
            f"{int(counts_per_tile.max())} pairs")
        if not same:
            failed.append("two gradient calls at the scale point differ")
        del calls, g_a, g_b, uv_a, uv_b, tables
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels = compare_kernels(state.params, cm, st, SCALE_TIMING_ITERS)
        kernels.update(compare_backward(state.params, cm, st, SCALE_TIMING_ITERS))
        log(f"  peak allocated during the comparisons {torch.cuda.max_memory_allocated() / 2**20:.0f}"
            f" MiB")
    # One exact-mode step from the same state: binning does not depend on
    # the mode, so its pairs are the packed path's on this state.
    packed_pairs = int(render_image(state.params, cm.view, cm.proj, cm.campos, 0.0,
                                    st)[1].num_pairs)
    _build.reset_launches()
    with mode_context("exact"):
        state, m = train_step(state, cm.view, cm.proj, cm.campos, gt, 0.0, steps, st)
        exact_loss = float(m.loss)
        m = m._replace(num_pairs=int(m.num_pairs))
    torch.cuda.synchronize()
    exact = dict(_build.launches)
    add_launches(total, exact)
    log(f"  exact-mode step from the same state: loss {exact_loss:.6f}, pairs {m.num_pairs} "
        f"(packed on this state {packed_pairs}); launches {exact}")
    if not (math.isfinite(exact_loss) and m.num_pairs == packed_pairs):
        failed.append(f"scale_mul {scale_mul}: exact step loss {exact_loss}, pairs "
                      f"{m.num_pairs} vs {packed_pairs}")
    if any(exact[k] for k in exact if k.endswith("/packed")) or min(
            exact[k] for k in SCALE_STEP_LAUNCHES if not k.endswith("/packed")) <= 0:
        failed.append(f"scale_mul {scale_mul}: exact step launches {exact}")
    graph_ms, graph_peak = statistics.median(res.step_ms), res.peak_mib
    del res, state, m
    release_graphs()
    torch.cuda.empty_cache()
    if compare:
        # The eager step at exact sizing from the same start (launches not
        # counted), beside the graph at the caps.
        counts = dict(_build.launches)
        eager = bench_scale.run(SCALE_N, scale_mul, steps=6, reps=2, device=dev, pair_cap=0,
                                log=lambda m: None)
        _build.launches.update(counts)
        log(f"  [15a] eager at exact sizing: {statistics.median(eager.step_ms):.3f} ms a step "
            f"(reps {', '.join(f'{t:.3f}' for t in eager.step_ms)}), peak allocated "
            f"{eager.peak_mib:.0f} MiB; the graph at the caps: {graph_ms:.3f} ms, "
            f"{graph_peak:.0f} MiB")
        del eager
        torch.cuda.empty_cache()
    return failed, kernels


def logit(p: float) -> torch.Tensor:
    return torch.tensor(math.log(p) - math.log(1.0 - p), dtype=torch.float32)


def schedule_its(iters: int, start: int, interval: int, end: int) -> list:
    """The iterations at which the trainer fires a density step or an
    opacity reset of this schedule."""
    return [i for i in range(iters) if i > start and i % interval == 0 and i < end]


@contextlib.contextmanager
def recorded_trainer():
    """For a ``with`` block, the trainer module's
    ``get_monitored_train_step``, ``reset_opacity`` and ``morton_sort``
    replaced by recording ones (the step's callable wrapped): a
    CUDA event at the start of each iteration and its loss kept on the
    card and its pairs (``events``, ``losses``, ``pairs``); (iteration,
    alive rows, whether every alive opacity equals the reset value) after
    each reset (``resets``); whether the alive rows are a prefix after
    each Morton sort (``prefix``); the last step's arguments (``last``).
    Yields the record."""
    from gsplat_tpu_torch.train import trainer as trainer_mod

    rec = dict(events=[], losses=[], pairs=[], resets=[], prefix=[], last=None)
    real = (trainer_mod.get_monitored_train_step, trainer_mod.reset_opacity,
            trainer_mod.morton_sort)

    def get_step(st):
        real_step = real[0](st)

        def step(*args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec["events"].append(ev)
            state, m, monitor = real_step(*args)
            rec["losses"].append(m.loss)
            rec["pairs"].append(m.num_pairs)
            rec["last"] = (*args[:7], st)
            return state, m, monitor

        return step

    def reset(state, value):
        state = real[1](state, value)
        op = state.params.opacity.detach()[state.alive]
        rec["resets"].append((len(rec["events"]) - 1, op.numel(),
                              bool((op == logit(value).to(op.device)).all())))
        return state

    def morton(state):
        state = real[2](state)
        alive = state.alive
        k = int(alive.sum())
        rec["prefix"].append(bool(alive[:k].all()) and not bool(alive[k:].any()))
        return state

    (trainer_mod.get_monitored_train_step, trainer_mod.reset_opacity,
     trainer_mod.morton_sort) = get_step, reset, morton
    try:
        yield rec
    finally:
        (trainer_mod.get_monitored_train_step, trainer_mod.reset_opacity,
         trainer_mod.morton_sort) = real


def check_long_run(rec: dict, density: list, iters: int, cfg, min_growths: int) -> tuple:
    """The checks and times that [15b], [15c] and [16b] share, from a
    ``recorded_trainer`` record and the run's density steps (records with
    ``train_at_scale.DensityRecord``'s fields): finite losses, one an
    iteration; density steps and resets at the schedule's iterations; the
    capacity growing at least ``min_growths`` times and exactly at the
    steps whose new total exceeds it; every reset's opacities at the reset
    value and the alive rows a prefix after every Morton sort. Prints ms an
    iteration with and without a density step (CUDA events between
    iteration starts) and each density step. Returns (the failed checks,
    the median ms of an iteration without a density step, eval or dump)."""
    failed = []
    losses = torch.stack(rec["losses"]).cpu()
    pairs = torch.stack(rec["pairs"]).cpu().tolist()
    events = rec["events"]
    # An iteration's time runs to the next one's start: the last is left out.
    iter_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    dens_its = [d.iteration for d in density]
    grown = [d for d in density if d.capacity_after != d.capacity_before]
    for d in density:
        log(f"  density step at {d.iteration}: pruned {d.pruned}, cloned {d.cloned}, "
            f"split {d.split}, new total {d.new_total}, applied {d.applied}, capacity "
            f"{d.capacity_before} -> {d.capacity_after}; {d.ms:.2f} ms")
    for d in grown:
        log(f"  grow_state at {d.iteration}: capacity {d.capacity_after}")
    busy = {i for i in range(iters) if i % cfg.print_interval == 0
            or i % cfg.test_eval_interval == 0}
    plain = [ms for i, ms in enumerate(iter_ms) if i and i not in busy and i not in dens_its]
    with_density = [ms for i, ms in enumerate(iter_ms) if i in dens_its and i not in busy]
    dens_ms = [d.ms for d in density]
    med = lambda xs: statistics.median(xs) if xs else math.nan  # noqa: E731
    log(f"  ms an iteration (median, CUDA events between iteration starts): "
        f"{med(plain):.3f} without a density step, "
        f"{med(with_density):.3f} with one; density step "
        f"{med(dens_ms):.3f} ms (median of {len(dens_ms)}, largest "
        f"{max(dens_ms, default=math.nan):.3f})")
    log(f"  opacity resets (iteration, alive, all equal logit(0.05)): {rec['resets']}")
    finite = bool(torch.isfinite(losses).all())
    log(f"  losses: {losses.numel()} finite {finite}, first {losses[0].item():.6f}, "
        f"last {losses[-1].item():.6f}, mean of the last 100 "
        f"{losses[-100:].mean().item():.6f}; pairs a step {pairs[0]} at the first, "
        f"median of the last 100 {statistics.median(pairs[-100:])}")
    if not (finite and losses.numel() == iters):
        failed.append("a loss is not finite")
    if len(grown) < min_growths:
        failed.append(f"the capacity grew {len(grown)} times, not at least {min_growths}")
    if not all((d.capacity_after > d.capacity_before) == (d.new_total > d.capacity_before)
               and d.capacity_after >= d.new_total for d in density):
        failed.append("the capacity did not grow exactly where a density step needed it")
    want_dens = schedule_its(iters, cfg.adaptive_control_start,
                             cfg.adaptive_control_interval, cfg.adaptive_control_end)
    if dens_its != want_dens:
        failed.append(f"density steps at {dens_its}, want {want_dens}")
    want_resets = schedule_its(iters, cfg.reset_opacity_start, cfg.reset_opacity_interval,
                               cfg.reset_opacity_end)
    if [r[0] for r in rec["resets"]] != want_resets or not all(r[2] for r in rec["resets"]):
        failed.append(f"opacity resets {rec['resets']}, want them at {want_resets}")
    if len(rec["prefix"]) != len(density) or not all(rec["prefix"]):
        failed.append(f"alive rows a prefix after each Morton sort: {rec['prefix']}")
    return failed, med(plain)


def long_run_slice(dev, iters: int = SCALE_ITERS, width: int = WIDTH,
                   height: int = HEIGHT, min_growths: int = 0, **run_args) -> tuple:
    """[15b], [15c] ``tools/train_at_scale.py``'s run under
    ``recorded_trainer``, then ``check_long_run``'s checks with at least
    ``min_growths`` growths, and the run's own: l_max 3, the eval PSNR
    rising, the PLY, the checkpoint reload and the launches. ``run_args``
    go to ``train_at_scale.run`` (another start; a smaller run to rehearse
    on the CPU). Returns (failed checks, the run's launches)."""
    import tempfile

    import PIL

    from gsplat_tpu_torch.io.ply import load_ply
    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.tools import train_at_scale
    from gsplat_tpu_torch.train import trainer as trainer_mod

    log(f"  images through PIL {PIL.__version__} on disk")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scale_") as tmp:
        with recorded_trainer() as rec:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            res = train_at_scale.run(iters, width, height, root=tmp, device=dev,
                                     log=lambda m: log("  " + m), **run_args)
            torch.cuda.synchronize()
            launches = dict(_build.launches)
            peak = torch.cuda.max_memory_allocated() / 2**20
        tr, cfg = res.trainer, res.trainer.config
        log(f"  eval PSNR {res.psnr_init:.4f} -> {res.psnr_final:.4f} dB "
            f"({res.psnr_final - res.psnr_init:+.4f} dB), {iters} iterations in "
            f"{res.wall_s:.3f} s ({res.it_per_s:.3f} it/s), {res.gaussians_init} -> "
            f"{res.gaussians_final} Gaussians, capacities {res.capacities}, l_max {res.l_max}; "
            f"peak allocated {peak:.0f} MiB")
        log(f"  launches: {launches}")
        failed, _ = check_long_run(rec, res.density, iters, cfg, min_growths)
        if res.l_max != 3:
            failed.append(f"l_max {res.l_max}")
        if not (math.isfinite(res.psnr_final) and res.psnr_final > res.psnr_init):
            failed.append("the eval PSNR did not rise")
        verts = load_ply(res.ply)["xyz"].shape[0]
        log(f"  final.ply: {verts} vertices, {res.gaussians_final} alive")
        if verts != res.gaussians_final:
            failed.append("PLY vertex count")
        never = [k for k in E2E_KERNELS if launches[k] <= 0]
        if never or launches["radix_sort/morton"] != len(res.density):
            failed.append(f"launches {launches}")
        fresh = trainer_mod.Trainer(cfg, res.gaussians, tr.images, tr.cameras, device=dev)
        fresh.load_checkpoint(res.checkpoint)
        diff = differing(fresh.state, tr.state)
        log(f"  checkpoint reloaded into a fresh Trainer: iteration {fresh.iter}, l_max "
            f"{fresh.l_max}, tensors differing {diff}")
        if diff or fresh.iter != iters or fresh.l_max != res.l_max:
            failed.append("the checkpoint does not reload bit-identical")
        del res, tr, fresh
    torch.cuda.empty_cache()
    return failed, launches


def scale_slice(dev) -> dict:
    """[15]: a, b and c above; raises if a check of any part failed.
    Returns the launches of every run it drove (the exact steps' and the
    long runs' included) and the 0.97 point's kernel results."""
    failed, total, kernels = [], {}, None
    for i, (scale_mul, name) in enumerate(SCALE_POINTS):
        log(f"  [15a] tools/bench_scale.py at {SCALE_N} Gaussians, scale_mul {scale_mul} "
            f"(the JAX package's {name}), 1296x840, SH 3, packed")
        f, res = scale_point(dev, scale_mul, recorded_geometry(name), total, compare=i == 0)
        failed += f
        kernels = kernels or res
    for label, kw in (("15b", dict()), ("15c", dict(n_points=SPARSE_POINTS, min_growths=2))):
        log(f"  [{label}] tools/train_at_scale.py, {SCALE_ITERS} iterations at 1296x840, 24 "
            f"views, from {kw.get('n_points', 'its default')} points")
        f, launches = long_run_slice(dev, overrides=LONG_RUN_SCHEDULE, **kw)
        failed += f
        add_launches(total, launches)
    log(f"  [15] launches: {total}")
    if failed:
        raise AssertionError(f"[15] failed: {failed}")
    return dict(launches=total, kernels=kernels)


# [16]: the photo recipes on a procedural texture (the reference photo is
# not in the repository).
TEXTURE_SEED = 0
TEXTURE_W, TEXTURE_H = 1536, 1024
# The JAX package's dense recipe on the reference photo (RESULT_SCALE_DENSE.json,
# a TPU run): its final count, printed beside [16b]'s for context only.
JAX_DENSE_GAUSSIANS = 625_898
DENSE_MIN_GROWTHS = 3
DENSE_PROFILE_STEPS = 8  # [16b]: profiled train steps on the final state
RECIPES_TITLE = ("[16] the photo recipes on a procedural texture: overfit_real, the dense "
                 "7,000-iteration layers recipe (quality_gate), the gate's logic")
# The kernels of the packed path without a density step ([16a]).
STEP_KERNELS = tuple(k for k in E2E_KERNELS if k != "radix_sort/morton")


def mib(x) -> str:
    return "not measured" if x is None else f"{x:.0f} MiB"


def _upsample(grid: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear upsampling of a (gh, gw, c) grid to (height, width, c)."""
    gh, gw = grid.shape[:2]
    y = np.linspace(0, gh - 1, height)
    x = np.linspace(0, gw - 1, width)
    y0 = np.minimum(y.astype(int), gh - 2)
    x0 = np.minimum(x.astype(int), gw - 2)
    fy = (y - y0)[:, None, None]
    fx = (x - x0)[None, :, None]
    top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x0 + 1] * fx
    bottom = grid[y0 + 1][:, x0] * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bottom * fy


def procedural_texture(seed: int = TEXTURE_SEED, width: int = TEXTURE_W,
                       height: int = TEXTURE_H) -> np.ndarray:
    """A seeded (height, width, 3) uint8 image with a photo's edges and
    fine detail: eight octaves of value noise with a 1/f amplitude
    spectrum (as natural images have: the same amplitude in every octave,
    from 3 cells across the height to 384), a colour gradient, and
    400 hard-edged discs and rectangles from 6 % of the height down to a
    few pixels, each keeping some of the noise beneath it."""
    rng = np.random.default_rng(seed)
    img = np.zeros((height, width, 3))
    for octave in range(8):
        cells = 3 * 2**octave
        grid = rng.uniform(-1, 1, (cells + 1, cells * width // height + 1, 3))
        img += _upsample(grid, height, width)
    img = 0.5 + 0.12 * img
    ys, xs = np.mgrid[0:height, 0:width]
    img += 0.3 * np.stack([xs / width, ys / height, 1 - xs / width], axis=-1) - 0.15
    for _ in range(400):
        colour = rng.uniform(0, 1, 3)
        cy, cx = rng.uniform(0, height), rng.uniform(0, width)
        r = np.exp(rng.uniform(np.log(0.003), np.log(0.06))) * height
        disc = rng.uniform() < 0.5
        rx = r if disc else r * rng.uniform(0.5, 2.0)
        y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, height)
        x0, x1 = max(int(cx - rx), 0), min(int(cx + rx) + 1, width)
        y, x = ys[y0:y1, x0:x1], xs[y0:y1, x0:x1]
        inside = ((y - cy) ** 2 + (x - cx) ** 2 < r * r) if disc else (
            (np.abs(y - cy) < r) & (np.abs(x - cx) < rx))
        patch = img[y0:y1, x0:x1]
        patch[inside] = 0.6 * colour + 0.4 * patch[inside]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def write_texture(path: Path, seed: int = TEXTURE_SEED) -> str:
    """``procedural_texture(seed)`` as a PNG at ``path``; its sha256."""
    import hashlib

    from PIL import Image as PILImage

    PILImage.fromarray(procedural_texture(seed)).save(path)
    return hashlib.sha256(path.read_bytes()).hexdigest()


def overfit_slice(dev, photo: Path, iters: int = 2000, n: int = 10_000) -> tuple:
    """[16a] ``tools/overfit_real.py`` at its defaults on ``photo``:
    finite losses, the PSNR at the end above the first, every kernel of
    the packed step launched. Returns (failed checks, launches)."""
    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.tools import overfit_real

    torch.cuda.synchronize()
    _build.reset_launches()
    res = overfit_real.run(iters, n, photo=photo, device=dev, log=lambda m: log("    " + m))
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    first, last = res["reports"][0], res["reports"][-1]
    log(f"  [16a] {res['iters']} steps of {res['gaussians']} Gaussians (capacity "
        f"{res['capacity']}) on the {res['width']}x{res['height']} texture: PSNR "
        f"{first[2]:.4f} -> {last[2]:.4f} dB, pairs {first[3]} -> {last[3]}, "
        f"{res['ms_per_step']:.3f} ms a step (CUDA events over the loop), peak allocated "
        f"{mib(res['peak_mib'])}")
    log(f"  launches: {launches}")
    failed = []
    if not (len(res["losses"]) == iters and all(map(math.isfinite, res["losses"]))):
        failed.append("[16a] a loss is not finite")
    if not last[2] > first[2]:
        failed.append(f"[16a] PSNR {first[2]} -> {last[2]} did not rise")
    never = [k for k in STEP_KERNELS if launches[k] <= 0]
    if never:
        failed.append(f"[16a] never launched: {never}")
    return failed, launches


def dense_slice(dev, photo: Path, out: Path) -> tuple:
    """[16b] ``tools/quality_gate.py``'s fixed recipe on ``photo`` under
    ``recorded_trainer``: ``check_long_run``'s checks with at least
    DENSE_MIN_GROWTHS growths, l_max 3, the held-out views out of the train
    list, the held-out PSNR rising, every kernel of the packed path
    launched and the Morton site once a density step; then a device
    profile of DENSE_PROFILE_STEPS more steps on the final state and the
    host's decode time of a view. Returns (failed checks, launches, the
    result)."""
    from types import SimpleNamespace

    import PIL

    from gsplat_tpu_torch.io.images import load_image
    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.tools import quality_gate, train_real_plane

    log(f"  images through PIL {PIL.__version__} on disk")
    with recorded_trainer() as rec:
        torch.cuda.synchronize()
        _build.reset_launches()
        res = quality_gate.run(photo=photo, out=out, device=dev, log=lambda m: log("    " + m))
        torch.cuda.synchronize()
        launches = dict(_build.launches)
    iters = res["recipe"]["num_iters"]
    density = [SimpleNamespace(**d) for d in res["density"]]
    cfg = train_real_plane.recipe_config(iters, quality_gate.THRESH_MUL, "", out,
                                         seed=quality_gate.SEED)
    log(f"  [16b] {res['recipe']['views']} views at {res['recipe']['width']}x"
        f"{res['recipe']['height']}, {iters} iterations, uv_grad_threshold "
        f"{res['recipe']['uv_grad_threshold']}: dataset {res['dataset_seconds']:.3f} s, "
        f"training {res['wall_s']:.3f} s ({res['iters_per_second']:.3f} it/s); held-out "
        f"PSNR {res['eval_psnr_db_heldout_init']:.4f} -> {res['eval_psnr_db_heldout']:.4f} dB; "
        f"{res['initial_gaussians']} -> {res['final_gaussians']} Gaussians (the JAX "
        f"package's run on the reference photo, another texture: {JAX_DENSE_GAUSSIANS}); "
        f"capacities {res['capacities']}; l_max {res['l_max']}; peak allocated "
        f"{mib(res['peak_mib'])}")
    log(f"  split: {len(res['train_views'])} train / held out {res['test_views']}")
    log(f"  launches: {launches}")
    failed, iter_ms = check_long_run(rec, density, iters, cfg, DENSE_MIN_GROWTHS)
    # Where an iteration's time goes at the final state: a device profile
    # of more steps on the last camera (launches not counted).
    state, view, proj, campos, gt, _, it, st = rec["last"]
    profile_steps(state, [SimpleNamespace(view=view, proj=proj, campos=campos)], [gt], st,
                  it + 1, iter_ms, steps=DENSE_PROFILE_STEPS,
                  label=", the recipe's final state", bg=0.0)
    del state, rec
    # The trainer's loader decodes one view an iteration on one thread.
    views = sorted(Path(out).rglob("view_*.png"))[:4]
    decode = []
    for path in views:
        t0 = time.perf_counter()
        load_image(str(path))
        decode.append(1e3 * (time.perf_counter() - t0))
    log(f"  io.images.load_image of {len(views)} views (host, one thread): "
        f"{statistics.median(decode):.1f} ms a view (median), "
        f"{statistics.median(p.stat().st_size for p in views):.0f} bytes a PNG")
    if res["l_max"] != 3:
        failed.append(f"l_max {res['l_max']}")
    held_out = len(range(0, quality_gate.VIEWS, cfg.test_split_ratio))  # 4 of 32
    if set(res["test_views"]) & set(res["train_views"]) or len(res["test_views"]) != held_out:
        failed.append(f"held-out views {res['test_views']} against the train list")
    if not res["eval_psnr_db_heldout"] > res["eval_psnr_db_heldout_init"]:
        failed.append("the held-out PSNR did not rise")
    never = [k for k in E2E_KERNELS if launches[k] <= 0]
    if never or launches["radix_sort/morton"] != len(density):
        failed.append(f"launches {launches}")
    return ["[16b] " + f for f in failed], launches, res


def gate_slice(dev, result: dict) -> list:
    """[16c] ``quality_gate.gate`` and ``main`` (its ``run`` stood in by
    ``result``) against priors written into temporary output directories:
    one of the same texture 1 dB above refuses (exit 1), one 0.1 dB below
    passes, one of another texture above is ignored. Returns the failed
    checks."""
    import io
    import tempfile

    from gsplat_tpu_torch.tools import quality_gate

    psnr, sha = result["eval_psnr_db_heldout"], result["texture_sha256"]
    cases = (("same texture, +1 dB", psnr + 1.0, sha, False, 1),
             ("same texture, -0.1 dB", psnr - 0.1, sha, True, 0),
             ("another texture, +1 dB", psnr + 1.0, "0" * 64, True, 0))
    failed = []
    real_run = quality_gate.run
    quality_gate.run = lambda *a, **kw: dict(result)
    try:
        for label, prior, prior_sha, want_ok, want_rc in cases:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as out:
                Path(out, "RESULT_QUALITY_r05.json").write_text(json.dumps(
                    {"eval_psnr_db_heldout": prior, "texture_sha256": prior_sha}))
                ok, best, src = quality_gate.gate(result, out)
                with contextlib.redirect_stdout(io.StringIO()), \
                        contextlib.redirect_stderr(io.StringIO()):
                    rc = quality_gate.main(["--photo", result["texture"]["path"], "--out", out],
                                           device=dev)
            log(f"  [16c] prior {label} ({prior:.4f} dB): gate ok {ok}, baseline {best:.4f} "
                f"({src}), main exit {rc}")
            if (ok, rc) != (want_ok, want_rc):
                failed.append(f"[16c] {label}: ok {ok}, exit {rc}")
    finally:
        quality_gate.run = real_run
    return failed


def recipes_slice(dev) -> dict:
    """[16]: a-c above on ``procedural_texture``'s PNG; raises if a check
    of any part failed. Returns the launches of [16a] and [16b]."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_recipes_") as tmp:
        photo = Path(tmp) / "texture.png"
        t0 = time.perf_counter()
        sha = write_texture(photo)
        log(f"  procedural texture {TEXTURE_W}x{TEXTURE_H}, seed {TEXTURE_SEED}, sha256 {sha} "
            f"({time.perf_counter() - t0:.2f} s)")
        log("  [16a] tools/overfit_real.py, 2,000 iterations, 10,000 Gaussians")
        failed, total = overfit_slice(dev, photo)
        torch.cuda.empty_cache()
        log("  [16b] tools/quality_gate.py's recipe: layers, 32 views at 1296x840, 7,000 "
            "iterations, x0.4, seed 0")
        f, launches, res = dense_slice(dev, photo, Path(tmp) / "out")
        failed += f
        add_launches(total, launches)
        torch.cuda.empty_cache()
        failed += gate_slice(dev, res)
    log(f"  [16] launches: {total}")
    if failed:
        raise AssertionError(f"[16] failed: {failed}")
    return total



# [17]: the reference's compiled step: binning at fixed capacities, the
# on-device monitor and the step and render as CUDA graphs.
CAPACITY_TITLE = ("[17] fixed capacities and the step as a CUDA graph: capped binning at the "
                  "1M view, graphed against eager steps, the graphed Trainer against the eager")
GRAPH_STEPS = 8  # (c): steps of each path from one start, each mode
GRAPH_WINDOW = 24  # (f): timed steps a window; windows eager, graph, graph, eager
GRAPH_PROFILE_STEPS = 8  # (f): profiled steps a path and mode


def capped_statics(st, pairs: int, rows: int):
    """``st`` at the caps a trainer would size for this frame's pair and
    row requirements: each plus a sixteenth, rounded to its bucket."""
    import dataclasses

    from gsplat_tpu_torch.train.state import round_pair_cap, round_row_cap

    return dataclasses.replace(st, pair_cap=round_pair_cap(pairs + (pairs >> 4)),
                               row_cap=round_row_cap(rows + (rows >> 4)))


def frame_inputs(params, cm, st):
    """(uv, z, radius, mask) of one view: binning's inputs."""
    from gsplat_tpu_torch.train.step import _per_gaussian

    dev = params.xyz.device
    with torch.no_grad():
        view, proj, campos = (torch.as_tensor(x, device=dev)
                              for x in (cm.view, cm.proj, cm.campos))
        uv, _, _, mask, radius, z = _per_gaussian(params, view, proj, campos, st)
    return uv, z, radius, mask


def live_part_equal(capped, exact) -> list:
    """The fields in which capped tables' live part differs from exact
    tables (the tail of ``splat_gid`` must be -1)."""
    p = exact.num_pairs
    bad = [name for name, a, b in (
        ("splat_gid", capped.splat_gid[:p], exact.splat_gid),
        ("pair_cand", capped.pair_cand[:p], exact.pair_cand),
        ("tile_start", capped.tile_start, exact.tile_start),
        ("tile_count", capped.tile_count, exact.tile_count),
        ("pair_start", capped.pair_start, exact.pair_start)) if not torch.equal(a, b)]
    if int(capped.num_pairs) != p:
        bad.append("num_pairs")
    if not bool((capped.splat_gid[p:] == -1).all()):
        bad.append("splat_gid tail")
    return bad


def capped_tables_slice(params, cm, st) -> tuple:
    """(a) Binning at the 1M view at the caps ``capped_statics`` gives:
    the live part bit-equal to the exact tables, the requirements equal to
    the exact tables' and the row requirement to ``bench_scale.row_totals``'
    count with a sentinel for every record without a row; then the tile
    sort of the capped keys (the tail keyed past every pair) beside the
    exact keys' and binning's time at each sizing. Returns (failed, the
    capped statics, times)."""
    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.kernels.sort import radix_sort
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.tools import bench_scale

    inp = frame_inputs(params, cm, st)
    grid = dict(num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y, tile_size=st.tile)
    counts = dict(_build.launches)  # none of this is a path's run
    exact = binning.build_tile_tables(*inp, **grid)
    req, row_req = int(exact.overflow), int(exact.row_overflow)
    _, _, off, rows = binning.row_expand_inputs(*inp, **grid)
    rows, with_rows = bench_scale.row_totals(off, rows)
    jax_rows = rows + params.capacity - with_rows
    st_c = capped_statics(st, req, row_req)
    capped = binning.build_tile_tables(*inp, **grid, pair_cap=st_c.pair_cap,
                                       row_cap=st_c.row_cap)
    bad = live_part_equal(capped, exact)
    if (int(capped.overflow), int(capped.row_overflow)) != (req, row_req):
        bad.append("requirements")
    if row_req != jax_rows:
        bad.append("row requirement against bench_scale.row_totals")
    log(f"  (a) 1M view: {exact.num_pairs} pairs, {rows} tile rows of {with_rows} "
        f"Gaussians; requirements (sentinels counted) pairs {req}, rows {row_req} "
        f"(row_totals: {jax_rows}); caps {st_c.pair_cap} pairs, {st_c.row_cap} rows; capped "
        f"tables: pairs {int(capped.num_pairs)}, overflow {int(capped.overflow)}, "
        f"row_overflow {int(capped.row_overflow)}; live part bit-equal "
        f"{'yes' if not bad else bad}")
    keys, bits = path_inputs(params, cm, st)["sort"]  # the exact tile sort's keys
    padded = torch.cat([keys, keys.new_full((st_c.pair_cap - keys.shape[0],),
                                            (1 << bits) - 1)])
    times = dict(
        sort_exact=cuda_ms(lambda: radix_sort(keys, bits), 10),
        sort_capped=cuda_ms(lambda: radix_sort(padded, bits), 10),
        binning_exact=cuda_ms(lambda: binning.build_tile_tables(*inp, **grid), 10),
        binning_capped=cuda_ms(lambda: binning.build_tile_tables(
            *inp, **grid, pair_cap=st_c.pair_cap, row_cap=st_c.row_cap), 10))
    _build.launches.update(counts)
    log(f"  tile sort, {bits}-bit keys: {keys.shape[0]} keys {times['sort_exact']:.4f} ms, "
        f"capped to {st_c.pair_cap} (tail keyed past every pair) "
        f"{times['sort_capped']:.4f} ms; build_tile_tables exact "
        f"{times['binning_exact']:.4f} ms (two host reads), capped "
        f"{times['binning_capped']:.4f} ms (CUDA events, one call each)")
    return ["(a) " + b for b in bad], st_c, times


def capped_overflow_slice(dev) -> list:
    """(b) A small scene binned at caps one bucket short of its pair and
    row requirements, on the card and on the CPU from the same inputs:
    pairs, requirements and tile counts equal, each tile's kept Gaussians
    the same set and, but where log2 rounds a depth into the next bucket,
    in the same order."""
    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.train.state import round_pair_cap, round_row_cap

    w, h = 320, 200
    cm = views(w, h)[1]
    st = statics(cm, w, h)
    inp = frame_inputs(scene_params(20_000, seed=3, device="cpu"), cm, st)
    grid = dict(num_tiles_x=st.num_tiles_x, num_tiles_y=st.num_tiles_y, tile_size=st.tile)
    exact = binning.build_tile_tables(*inp, **grid)
    # Half a bucket: below the 2^19 (pairs) and 2^18 (rows) granularity,
    # buckets are powers of two, so the bucket just below the requirement's.
    caps = dict(pair_cap=round_pair_cap(int(exact.overflow), 512) // 2,
                row_cap=round_row_cap(int(exact.row_overflow), 2048) // 2)
    cpu = binning.build_tile_tables(*inp, **grid, **caps)
    card = binning.build_tile_tables(*(x.to(dev) for x in inp), **grid, **caps)
    bad = [name for name in ("num_pairs", "overflow", "row_overflow")
           if int(getattr(cpu, name)) != int(getattr(card, name))]
    if not torch.equal(cpu.tile_count, card.tile_count.cpu()):
        bad.append("tile_count")
    gid_c, gid_g = cpu.splat_gid, card.splat_gid.cpu()
    sets = all(torch.equal(torch.sort(gid_c[s:s + c]).values, torch.sort(gid_g[s:s + c]).values)
               for s, c in zip(cpu.tile_start.tolist(), cpu.tile_count.tolist()))
    same = (gid_c == gid_g).double().mean().item()
    if not sets or same < 0.999:
        bad.append("kept pairs")
    row_cap_used, _ = binning.resolve_row_cap(caps["pair_cap"], caps["row_cap"])
    overflowed = (int(cpu.overflow) > caps["pair_cap"]
                  and int(cpu.row_overflow) > row_cap_used)
    if not overflowed:
        bad.append("the caps did not overflow")
    log(f"  (b) {w}x{h}, 20000 Gaussians: requirements {int(exact.overflow)} pairs, "
        f"{int(exact.row_overflow)} rows; caps {caps} (rows resolved {row_cap_used}): "
        f"kept {int(card.num_pairs)} pairs on the card, {int(cpu.num_pairs)} on the CPU of "
        f"{exact.num_pairs}; each tile's set equal {sets}, same Gaussian at "
        f"{100 * same:.4f} % of slots")
    return ["(b) " + b for b in bad]


def camera_tensors(cams, dev) -> list:
    return [tuple(torch.as_tensor(x, dtype=torch.float32, device=dev)
                  for x in (cm.view, cm.proj, cm.campos)) for cm in cams]


def graph_equality_slice(cams, gts, st, st_c, dev) -> tuple:
    """(c), (d) From one start, GRAPH_STEPS steps eager at exact sizing,
    eager at the caps and through ``get_train_step``'s CUDA graph, in each
    mode: losses and every tensor of the states bit-identical. The graph's
    replays (its third call on) run under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync in one fails.
    The graph's run counts every kernel of the mode's path, the tile sort
    once a step. Returns (failed, the graph runs' launches by mode)."""
    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.train.state import init_state, params_from_jax
    from gsplat_tpu_torch.train.step import get_train_step, graph_captures, train_step

    start = scene_arrays(1_000_000, seed=0, perturb_seed=1)
    cam_t = camera_tensors(cams, dev)
    failed, launches = [], {}
    for mode in ("packed", "exact"):
        runs = {}
        with mode_context(mode):
            for path in ("exact", "capped", "graph"):
                state = init_state(params_from_jax(*start, dev))
                step = get_train_step(st_c)
                captures = graph_captures()
                torch.cuda.synchronize()
                _build.reset_launches()
                losses = []
                for it in range(GRAPH_STEPS):
                    v = it % len(cams)
                    args = (state, *cam_t[v], gts[v], BG, it)
                    if path == "graph" and it >= 2:
                        torch.cuda.set_sync_debug_mode("error")
                        try:
                            state, m = step(*args)
                        finally:
                            torch.cuda.set_sync_debug_mode("default")
                    elif path == "graph":
                        state, m = step(*args)
                    else:
                        state, m = train_step(*args, st if path == "exact" else st_c)
                    losses.append(m.loss)
                torch.cuda.synchronize()
                runs[path] = (torch.stack(losses), state)
                if path == "graph":
                    launches[mode] = dict(_build.launches)
                    captures = graph_captures() - captures
        ref_losses, ref_state = runs["exact"]
        for path in ("capped", "graph"):
            losses, state = runs[path]
            diff = differing(state, ref_state)
            same = torch.equal(bits_of(losses), bits_of(ref_losses))
            log(f"  (c) {mode}: {path} vs exact sizing over {GRAPH_STEPS} steps: losses "
                f"bit-identical {same}, state tensors differing {diff}")
            if diff or not same:
                failed.append(f"(c) {mode} {path}")
        got = launches[mode]
        packed_keys = [k for k in got if k.endswith("/packed")]
        want_packed = {k: got[k.split("/")[0]] if mode == "packed" else 0 for k in packed_keys}
        base = [k for k in got if k not in ("radix_sort/morton", SWEEP_LAUNCHES)
                and k not in packed_keys]
        log(f"  (d) {mode}: {GRAPH_STEPS - 2} replays under set_sync_debug_mode('error'), "
            f"{captures} capture; launches of the graph's run {got}")
        if (min(got[k] for k in base) <= 0 or {k: got[k] for k in packed_keys} != want_packed
                or got["radix_sort/tile"] != GRAPH_STEPS or captures != 1
                or got["masked_adam"] != ADAM_GROUPS * GRAPH_STEPS):
            failed.append(f"(d) {mode} launches {got}, captures {captures}")
        del runs, state, ref_state
    return failed, launches


def failed_capture_slice(cams, gts, st_c, dev) -> list:
    """(g) A capture that meets a host read raises, and the call does not
    run the step eagerly instead: the step's PSNR replaced by one that
    reads the host, a fresh StepStatics' second call (its capture) must
    raise and leave the state as the first call left it."""
    import dataclasses

    from gsplat_tpu_torch.train import step as step_mod
    from gsplat_tpu_torch.train.state import init_state

    st_x = dataclasses.replace(st_c, num_iters=st_c.num_iters + 1)  # a StepStatics of its own
    state = init_state(scene_params(100_000, seed=0, device=dev))
    cam = camera_tensors(cams[:1], dev)[0]
    real = step_mod.compute_psnr

    def reads_host(image, gt):
        value = real(image, gt)
        float(value)  # a host read
        return value

    step = step_mod.get_train_step(st_x)
    step(state, *cam, gts[0], BG, 0)  # the eager first call
    before = state_checksums(state)
    step_mod.compute_psnr = reads_host
    try:
        step(state, *cam, gts[0], BG, 1)
        raised = None
    except Exception as e:  # noqa: BLE001 - any error of the capture is the check
        raised = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    finally:
        step_mod.compute_psnr = real
        step_mod.release_graphs()
    torch.cuda.synchronize()
    unchanged = torch.equal(before, state_checksums(state))
    log(f"  (g) a capture that reads the host raised {raised}; the state unchanged "
        f"{unchanged}")
    return [] if raised and unchanged else ["(g) a failed capture did not raise, or ran"]


@contextlib.contextmanager
def eager_factories():
    """For a ``with`` block: the trainer's step and render factories
    replaced by eager callables at the same statics (no graph)."""
    from gsplat_tpu_torch.train import step as step_mod
    from gsplat_tpu_torch.train import trainer as trainer_mod

    def render_fn(st):
        return lambda params, view, proj, campos, bg: step_mod.render_image(
            params, view, proj, campos, bg, st)[0]

    real = trainer_mod.get_monitored_train_step, trainer_mod.get_render_fn
    trainer_mod.get_monitored_train_step = lambda st: functools.partial(
        step_mod.monitored_train_step, st=st)
    trainer_mod.get_render_fn = render_fn
    try:
        yield
    finally:
        trainer_mod.get_monitored_train_step, trainer_mod.get_render_fn = real


def trainer_twin_slice(dev, graphed: dict) -> list:
    """(e) [11]'s run again with the trainer's factories eager: every loss,
    the capacities of every step, the density steps' counts, the state's
    checksums and the PLY bytes bit-identical to [11]'s graphed run."""
    import tempfile

    from gsplat_tpu_torch.train import trainer as trainer_mod
    from gsplat_tpu_torch.train.init import initialize_gaussians

    cams, images, gts, xyz, rgb = graphed["scene"]
    rec = dict(losses=[], caps=[], density=[])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_twin_") as tmp:
        cfg = trainer_config(tmp)
        tr = trainer_mod.Trainer(cfg, initialize_gaussians(xyz, rgb, cfg), images, cams,
                                 device=dev)
        real_density = tr._density_step

        def density():
            info = real_density()
            rec["density"].append((tr.iter, density_counts(info)))
            return info

        tr._density_step = density
        with eager_factories(), ImageStandIns(gts, (HEIGHT, WIDTH, 3)):
            real_get = trainer_mod.get_monitored_train_step

            def get_step(st):
                def step(*args):
                    torch.cuda.synchronize()  # as [11]'s hook: an iteration apiece
                    starts.append(time.perf_counter())
                    state, m, monitor = real_get(st)(*args)
                    rec["losses"].append(float(m.loss))
                    rec["caps"].append((st.pair_cap, st.row_cap))
                    return state, m, monitor
                return step

            starts = []
            trainer_mod.get_monitored_train_step = get_step
            t0 = time.perf_counter()
            tr.train(max_iters=11)
            tr.train(max_iters=TRAINER_ITERS)
            torch.cuda.synchronize()
            starts.append(time.perf_counter())
            wall = starts[-1] - t0
        ply = Path(tmp) / "trained.ply"
        tr.save_to_ply(ply)
        ply_bytes = ply.read_bytes()
        sums = state_checksums(tr.state)
        with eager_factories():
            steady = {"eager": steady_iteration_ms(tr, gts)}
        steady["graphed"] = steady_iteration_ms(graphed["trainer"], gts)
    bad = [name for name, a, b in (
        ("losses", rec["losses"], graphed["losses"]), ("caps", rec["caps"], graphed["caps"]),
        ("density", rec["density"], graphed["density"]),
        ("PLY bytes", ply_bytes, graphed["ply"]))
        if a != b]
    if not torch.equal(sums, graphed["checksums"]):
        bad.append("state checksums")
    iter_ms = [1e3 * (b - a) for a, b in zip(starts, starts[1:])]
    dens = {it for it, _ in rec["density"]}
    busy = dens | {0, 12}  # eval and dumps at 0 and 12
    for label, ms in (("graphed [11]", graphed["iter_ms"]), ("eager", iter_ms)):
        plain = [x for i, x in enumerate(ms) if i not in busy]
        log(f"  (e) {label}: ms an iteration, median {statistics.median(plain):.3f} without a "
            f"density step, eval or dump ({statistics.median(plain[-6:]):.3f} over the last "
            f"6 such), {statistics.median([ms[i] for i in sorted(dens - {12})]):.3f} with a "
            f"density step; by iteration " + ", ".join(f"{x:.1f}" for x in ms))
    log(f"  (e) past the schedule's events (iterations {TRAINER_ITERS + 2}-"
        f"{TRAINER_ITERS + 1 + STEADY_ITERS}, no hook, one sync at each end): "
        f"{steady['graphed']:.3f} ms an iteration graphed, {steady['eager']:.3f} eager")
    log(f"  (e) Trainer.train, [11]'s schedule, eager factories: {wall:.3f} s for "
        f"{TRAINER_ITERS} iterations (graphed in [11]: {graphed['wall_s']:.3f} s, "
        f"{graphed['captures']} captures); caps by step {sorted(set(rec['caps']))}; "
        f"bit-identical to the graphed run: {'yes' if not bad else bad}")
    return ["(e) " + b for b in bad]


STEADY_ITERS = 10  # (e): iterations after [11]'s schedule with no event


def steady_iteration_ms(tr, gts) -> float:
    """Wall ms an iteration of ``tr`` over STEADY_ITERS iterations past
    [11]'s schedule, where no event fires: the trainer as a user runs it,
    with no hook and the card synchronized only at the ends. Untimed
    first: iteration TRAINER_ITERS (an eval and a dump) and the next (a
    graph's first call or capture, where one was freed)."""
    shape = next(iter(gts.values())).shape
    with ImageStandIns(gts, shape):
        tr.train(max_iters=TRAINER_ITERS + 2, verbose=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train(max_iters=TRAINER_ITERS + 2 + STEADY_ITERS, verbose=False)
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / STEADY_ITERS


def density_counts(info) -> tuple:
    return tuple(int(getattr(info, f)) for f in ("num_pruned", "num_cloned", "num_split",
                                                 "new_total", "applied"))


def path_profile(run, steps: int) -> dict:
    """torch.profiler over ``run(k)`` for k < steps, twice: device ms and
    device kernels a step (device activity only), then the host's calls
    to the CUDA runtime that launch work (kernels, graphs, copies) a step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(steps):
            run(k)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_time_total > 0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(steps):
            run(k)
        torch.cuda.synchronize()
    calls = {e.key: e.count / steps for e in prof.key_averages()
             if e.key.startswith(("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                                  "cudaMemsetAsync", "cuLaunchKernel"))}
    return dict(device_ms=sum(e.device_time_total for e in rows) / 1e3 / steps,
                kernels=sum(e.count for e in rows) / steps, launch_calls=calls,
                by_kernel={e.key: (e.device_time_total / 1e3 / steps, e.count / steps)
                           for e in rows})


def paths_in_turns(run) -> dict:
    """``run(path)`` makes one step of a path, "eager" or "graph", from the
    same state. Each path's peak allocated MiB over its first 4 calls (the
    graph's eager first call, capture and replays; eager first, while no
    graph holds memory), then windows of GRAPH_WINDOW steps taken in turns
    (eager, graph, graph, eager): wall, process-CPU and the host's issue ms
    a step (host clocks, the card synchronized at each window's ends); then
    ``path_profile`` over GRAPH_PROFILE_STEPS of each. Returns the numbers
    by path."""
    peak = {}
    for path in ("eager", "graph"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(4):
            run(path)
        torch.cuda.synchronize()
        peak[path] = torch.cuda.max_memory_allocated() / 2**20
    walls = {"eager": [], "graph": []}
    for path in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        for _ in range(GRAPH_WINDOW):
            run(path)
        issued = time.perf_counter()
        torch.cuda.synchronize()  # spins: the process CPU counts the wait
        walls[path].append((1e3 * (time.perf_counter() - t0) / GRAPH_WINDOW,
                            1e3 * (time.process_time() - c0) / GRAPH_WINDOW,
                            1e3 * (issued - t0) / GRAPH_WINDOW))
    res = {}
    for path in ("eager", "graph"):
        res[path] = path_profile(lambda k, p=path: run(p), GRAPH_PROFILE_STEPS)
        res[path]["peak_mib"] = peak[path]
        res[path]["wall_ms"] = statistics.mean(w for w, _, _ in walls[path])
        res[path]["cpu_ms"] = statistics.mean(c for _, c, _ in walls[path])
        res[path]["issue_ms"] = statistics.mean(i for _, _, i in walls[path])
        res[path]["windows"] = walls[path]
    return res


def log_paths(label: str, res: dict, padding: str) -> None:
    """``paths_in_turns``' numbers of each path, the kernels whose device
    time differs most between them, and graph - eager (``padding`` says
    what the device difference is)."""
    for path in ("eager", "graph"):
        r = res[path]
        log(f"  {label}, {path}: wall {r['wall_ms']:.3f} ms/step, process CPU "
            f"{r['cpu_ms']:.3f} ms/step, host time to issue a step {r['issue_ms']:.3f} "
            f"ms (windows wall/CPU/issue "
            + ", ".join(f"{w:.3f}/{c:.3f}/{i:.3f}" for w, c, i in r["windows"])
            + f"); device {r['device_ms']:.3f} ms/step, {r['kernels']:.1f} device "
            f"kernels/step, host launch calls/step {r['launch_calls']}; peak allocated "
            f"{r['peak_mib']:.0f} MiB")
    e, g = res["eager"], res["graph"]
    names = set(e["by_kernel"]) | set(g["by_kernel"])
    diff = sorted(((g["by_kernel"].get(k, (0, 0))[0] - e["by_kernel"].get(k, (0, 0))[0],
                    g["by_kernel"].get(k, (0, 0))[1] - e["by_kernel"].get(k, (0, 0))[1], k)
                   for k in names), key=lambda r: -abs(r[0]))[:PROFILE_TOP]
    log(f"  {label}: device ms/step and kernels/step, graph - eager, largest first:")
    for ms, n, k in diff:
        log(f"    {ms:+8.4f} ms {n:+6.1f}x  {k[:96]}")
    log(f"  {label}: graph - eager: wall {g['wall_ms'] - e['wall_ms']:+.3f} ms/step, "
        f"process CPU {g['cpu_ms'] - e['cpu_ms']:+.3f}, issue "
        f"{g['issue_ms'] - e['issue_ms']:+.3f}, device "
        f"{g['device_ms'] - e['device_ms']:+.3f} ({padding}), busy "
        f"{100 * e['device_ms'] / e['wall_ms']:.1f} % -> "
        f"{100 * g['device_ms'] / g['wall_ms']:.1f} %")


def graph_timing_slice(cams, gts, st, st_c, dev) -> dict:
    """(f) [9]'s steps at 1M, the eager step at exact sizing (today's path)
    and the graph at the caps, in turns from one state (``paths_in_turns``:
    wall, process-CPU and issue ms a step; device ms, kernels and the
    host's launch calls a step; peak allocated MiB), in each mode."""
    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.train.state import init_state
    from gsplat_tpu_torch.train.step import get_train_step, release_graphs, train_step

    cam_t = camera_tensors(cams, dev)
    out = {}
    counts = dict(_build.launches)
    for mode in ("packed", "exact"):
        state = init_state(scene_params(1_000_000, seed=0, device=dev, perturb_seed=1))
        graph = get_train_step(st_c)
        it = [0]

        def run(path):
            v = it[0] % len(cams)
            args = (state, *cam_t[v], gts[v], BG, it[0])
            if path == "graph":
                graph(*args)
            else:
                train_step(*args, st)
            it[0] += 1

        with mode_context(mode):
            res = paths_in_turns(run)
        log_paths(f"(f) {mode}", res, "the caps' padding")
        out[mode] = res
        release_graphs()
        del state, graph
        torch.cuda.empty_cache()
    _build.launches.update(counts)
    return out


def capacity_slice(dev, graphed: dict) -> dict:
    """[17]: a-g above, on [9]'s scene and views and [11]'s run
    (``graphed``, from ``trainer_slice``); raises if any check failed."""
    from gsplat_tpu_torch.train.step import release_graphs, render_image

    cams = views()
    st = statics(cams[0])
    failed, st_c, sort_times = capped_tables_slice(scene_params(1_000_000, seed=0, device=dev),
                                                   cams[0], st)
    failed += capped_overflow_slice(dev)
    truth = scene_params(1_000_000, seed=0, device=dev)
    gts = [render_image(truth, cm.view, cm.proj, cm.campos, BG, st)[0] for cm in cams]
    del truth
    f, launches = graph_equality_slice(cams, gts, st, st_c, dev)
    failed += f
    release_graphs()
    failed += trainer_twin_slice(dev, graphed)
    timing = graph_timing_slice(cams, gts, st, st_c, dev)
    failed += failed_capture_slice(cams, gts, st_c, dev)
    if failed:
        raise AssertionError(f"[17] failed: {failed}")
    return dict(launches=launches, timing=timing, sort=sort_times, caps=(st_c.pair_cap,
                                                                         st_c.row_cap))


# [18]: the dp and tp steps as CUDA graphs over a one-rank NCCL group (the
# card's host has one card, and NCCL refuses two ranks on one device).
NCCL_TITLE = ("[18] the dp and tp steps captured over a one-rank NCCL group at [17]'s caps: "
              "graph vs eager, no host sync, one graph launch a step")
NCCL_STEPS = 8  # (a): steps of each path from one start, each kind


def nccl_graph_slice(dev, n: int = 1_000_000) -> dict:
    """[18] On a one-rank NCCL group on ``dev``, at the caps [17] sizes for
    [9]'s view 0 of the 1M scene (``frame_caps``), for dp and then tp:
    (a) from one start, NCCL_STEPS steps of [9]'s views eager
    (``dp_train_step`` / ``tp_train_step`` and ``fold_monitor``) and
    through ``get_monitored_dp_train_step`` / ``get_monitored_tp_train_step``
    (its eager first call, its capture, replays): losses, metrics, monitors
    and every tensor of the states bit-identical; the eager steps after the
    first (which makes the NCCL communicator) and the replays run under
    ``torch.cuda.set_sync_debug_mode("error")``; one capture; (b) the
    replays' launches, counted at replay (``_build.recording``): every
    kernel of the packed path, the tile sort once a step; (c)
    ``paths_in_turns`` of the eager step and the graph: wall, issue,
    device ms, busy share, launch calls (one ``cudaGraphLaunch`` a step).
    Raises if a check failed; a failed group or capture raises as it is.
    Returns the launches of the graphs' runs and the timings by kind."""
    import torch.distributed as dist

    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.parallel import (
        get_monitored_dp_train_step, get_monitored_tp_train_step, initialize_multihost)
    from gsplat_tpu_torch.parallel.data_parallel import dp_train_step
    from gsplat_tpu_torch.parallel.launch import free_port
    from gsplat_tpu_torch.parallel.tile_parallel import tp_train_step
    from gsplat_tpu_torch.train.state import init_state, params_from_jax
    from gsplat_tpu_torch.train.step import (
        fold_monitor, fresh_monitor, graph_captures, release_graphs, render_image)

    cams = views()
    st = statics(cams[0])
    truth = scene_params(n, seed=0, device=dev)
    st_c = frame_caps(truth, cams[:1], st)
    gts = [render_image(truth, cm.view, cm.proj, cm.campos, BG, st)[0] for cm in cams]
    del truth
    cam_t = camera_tensors(cams, dev)
    start = scene_arrays(n, seed=0, perturb_seed=1)
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    failed, launches, timing = [], {}, {}
    try:
        log(f"  one-rank group, backend {dist.get_backend()}; caps {st_c.pair_cap} pairs, "
            f"{st_c.row_cap} rows")
        for kind, eager_step, get in (("dp", dp_train_step, get_monitored_dp_train_step),
                                      ("tp", tp_train_step, get_monitored_tp_train_step)):
            runs = {}
            for path in ("eager", "graph"):
                state, monitor = init_state(params_from_jax(*start, dev)), fresh_monitor(dev)
                graph = get(st_c)
                captures = graph_captures()
                torch.cuda.synchronize()
                _build.reset_launches()
                steps = []
                for it in range(NCCL_STEPS):
                    v = it % len(cams)
                    args = (state, *cam_t[v], gts[v], BG, it)
                    if it == 2 and path == "graph":
                        _build.reset_launches()  # the replays' launches from here
                    if it >= (2 if path == "graph" else 1):  # a capture synchronizes
                        torch.cuda.set_sync_debug_mode("error")
                    try:
                        if path == "eager":
                            state, m = eager_step(*args, st_c)
                            monitor = fold_monitor(monitor, m)
                        else:
                            state, m, monitor = graph(*args, monitor)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                    steps.append(torch.stack([m.loss] + [
                        getattr(m, f).to(torch.float32)
                        for f in ("num_pairs", "overflow", "row_overflow")]))
                torch.cuda.synchronize()
                runs[path] = (torch.stack(steps), monitor.clone(), state)
                if path == "graph":
                    launches[kind] = dict(_build.launches)
                    captures = graph_captures() - captures
                release_graphs()
            (e_steps, e_mon, e_state), (g_steps, g_mon, g_state) = runs["eager"], runs["graph"]
            diff = differing(g_state, e_state)
            same = torch.equal(bits_of(g_steps), bits_of(e_steps)) and torch.equal(
                bits_of(g_mon), bits_of(e_mon))
            got = launches[kind]
            want = [k for k in got if k not in ("radix_sort/morton", SWEEP_LAUNCHES)]  # packed
            log(f"  (a) {kind}: graph vs eager at the caps over {NCCL_STEPS} steps: losses, "
                f"counts and monitor bit-identical {same}, state tensors differing {diff}; "
                f"{captures} capture; monitor {g_mon.tolist()}; pairs a step "
                f"{[int(x) for x in g_steps[:, 1].tolist()]}")
            log(f"  (b) {kind}: launches of the {NCCL_STEPS - 2} replays {got}")
            if diff or not same or captures != 1:
                failed.append(f"(a) {kind}")
            if (min(got[k] for k in want) <= 0 or got["radix_sort/tile"] != NCCL_STEPS - 2
                    or got["masked_adam"] != ADAM_GROUPS * (NCCL_STEPS - 2)):
                failed.append(f"(b) {kind} launches {got}")
            del runs, e_state, g_state
            state, box = init_state(params_from_jax(*start, dev)), [fresh_monitor(dev)]
            graph, it = get(st_c), [0]

            def run(path):
                v = it[0] % len(cams)
                args = (state, *cam_t[v], gts[v], BG, it[0])
                if path == "graph":
                    box[0] = graph(*args, box[0])[2]
                else:
                    box[0] = fold_monitor(box[0], eager_step(*args, st_c)[1])
                it[0] += 1

            res = paths_in_turns(run)
            log_paths(f"(c) {kind}", res, "the same kernels")
            calls = sum(v for k, v in res["graph"]["launch_calls"].items()
                        if k.startswith("cudaGraphLaunch"))
            if calls != 1.0:
                failed.append(f"(c) {kind}: {calls} graph launches a step")
            timing[kind] = res
            release_graphs()
            del state, graph
            torch.cuda.empty_cache()
    finally:
        release_graphs()
        dist.destroy_process_group()
    if failed:
        raise AssertionError(f"[18] failed: {failed}")
    total = {k: launches["dp"][k] + launches["tp"][k] for k in launches["dp"]}
    return dict(launches=total, timing=timing, caps=(st_c.pair_cap, st_c.row_cap))


def log_scale_table(scale: dict, at_1m: dict) -> None:
    """Each kernel's time, bound and library time at the 4.25M scale point
    ([15a], scale_mul 0.97) beside the 1M view's ([6], [10])."""
    log("  kernel: ms / bound / library at 4.25M (scale_mul 0.97) | at 1M; time ratio")
    lib = lambda x: "none" if x is None else f"{x:.4f}"  # noqa: E731
    for key, r in scale["kernels"].items():
        one = at_1m[key]
        log(f"    {key}: {r['ms']:.4f} / {r['bound_ms']:.4f} ({r['bound_by']}) / "
            f"{lib(r['library_ms'])} | {one['ms']:.4f} / {one['bound_ms']:.4f} / "
            f"{lib(one['library_ms'])}; x{r['ms'] / one['ms']:.2f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gsplat_tpu_torch.kernels import _build
    from gsplat_tpu_torch.train.step import render_image

    dev = torch.device("cuda", 0)
    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    if sys.argv[1:] == ["--train-profile"]:
        train_profile(dev)
        return 0
    if sys.argv[1:] == ["--wall"]:
        wall_steps(dev)
        return 0
    if sys.argv[1:] == ["--bits"]:
        bits(dev)
        return 0
    if sys.argv[1:] == ["--adam"]:
        log(ADAM_TITLE)
        adam_table(dev)
        return 0
    if sys.argv[1:] == ["--sh"]:
        log(SH_TITLE)
        sh_table(dev)
        return 0
    if sys.argv[1:] == ["--mip"]:
        log(MIP_TITLE)
        mip_table(dev)
        return 0
    if sys.argv[1:] == ["--covariance"]:
        log(COVARIANCE_TITLE)
        covariance_table(dev)
        return 0
    if sys.argv[1:] == ["--scale-profile"]:
        scale_profile(dev)
        return 0
    if sys.argv[1:] == ["--trainer"]:
        log(f"[11] Trainer.train, 1M points, {TRAINER_VIEWS} views, {TRAINER_ITERS} iterations")
        trainer_slice(dev)
        return 0
    if sys.argv[1:] == ["--capacity"]:
        log(f"[11] Trainer.train, 1M points, {TRAINER_VIEWS} views, {TRAINER_ITERS} iterations")
        graphed = trainer_slice(dev)["graphed"]
        log(CAPACITY_TITLE)
        capacity_slice(dev, graphed)
        return 0
    if sys.argv[1:] == ["--parallel"]:
        _build.build()
        log(PARALLEL_TITLE)
        parallel_slice(dev)
        return 0
    if sys.argv[1:] == ["--nccl"]:
        _build.build()
        log(NCCL_TITLE)
        nccl_graph_slice(dev)
        return 0
    if sys.argv[1:] == ["--e2e"]:
        log(REMAINING_TITLE)
        remaining_slice(dev)
        return 0
    if sys.argv[1:] == ["--scale"]:
        log(SCALE_TITLE)
        scale_slice(dev)
        return 0
    if sys.argv[1:] == ["--recipes"]:
        log(RECIPES_TITLE)
        recipes_slice(dev)
        return 0

    # 2. Build.
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("    " + line.strip())
    # K1's two instantiations (mangled rasterize_forward_kernel<false>, <true>).
    for mode, k1 in (("exact", "rasterize_forward_kernelILb0"),
                     ("packed", "rasterize_forward_kernelILb1")):
        sass = kernel_sass(lib._name, k1)
        log(f"    rasterize_forward_kernel, {mode}: {ptxas_usage(_build.build_log, k1)}")
        log(f"    expf: {exp_instructions(sass)}")
        loop = exp_loop_counts(sass)
        if loop is None:
            log("    no loop around MUFU.EX2 found in the SASS")
        else:
            per = max(loop["exp"], 1)
            log(f"    pair loop: {loop['instructions']} SASS instructions, "
                f"{loop['lds']} LDS, {loop['exp']} MUFU.EX2 (pair-pixels); per pair-pixel "
                f"{loop['instructions'] / per:.1f} instructions, {loop['lds'] / per:.2f} LDS")

    # 2b. The radix sort's edge cases.
    log("[2b] radix sort edge cases vs torch.sort(stable=True)")
    check_sort_edge_cases(dev)
    log("[2c] segment expand edge cases vs its plain version")
    check_expand_edge_cases(dev)

    # 3. Kernels vs plain versions, 100K Gaussians, bench view.
    cams = views()
    st = statics(cams[0])
    log("[3] forward kernels vs plain versions at 100K Gaussians")
    compare_kernels(scene_params(100_000, seed=0, device=dev), cams[0], st, 5)

    # 4. Small scene: card vs the CPU path.
    log("[4] small scene, card vs CPU path")
    check_small_scene_against_cpu(dev)

    # 5. The forward path: 1M Gaussians, 2 views, through render_image.
    log("[5] render_image, 1M Gaussians, 1296x840, SH 3, 2 views")
    params = scene_params(1_000_000, seed=0, device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    images = []
    for i, cm in enumerate(cams[:2]):
        img, tables = render_image(params, cm.view, cm.proj, cm.campos, BG, st)
        ms = cuda_ms(lambda cm=cm: render_image(params, cm.view, cm.proj,
                                                cm.campos, BG, st), 10)
        images.append(img)
        log(f"  view {i}: pairs {tables.num_pairs}, {ms:.3f} ms median, "
            f"{WIDTH * HEIGHT / ms / 1e3:.2f} Mpix/s")
        if not (img.shape == (HEIGHT, WIDTH, 3) and torch.isfinite(img).all()):
            raise AssertionError(f"view {i}: image not finite or of wrong shape")
    again, _ = render_image(params, cams[0].view, cams[0].proj, cams[0].campos, BG, st)
    torch.cuda.synchronize()
    fwd_launches = dict(_build.launches)
    if not torch.equal(again, images[0]):
        raise AssertionError("re-render of view 0 is not bit-identical")
    log(f"  re-render bit-identical; launches {fwd_launches}")
    for name in ("segment_expand", "radix_sort", "rasterize_forward",
                 "rasterize_forward/packed"):
        if fwd_launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the forward path")

    # 6. Forward kernel times at the 1M view's shapes.
    log("[6] forward kernels vs plain versions at 1M Gaussians")
    res = compare_kernels(params, cams[0], st, 10)
    del params, images, again

    # 7. Backward kernels vs plain versions, 100K Gaussians, bench view.
    log("[7] backward kernels vs plain versions at 100K Gaussians")
    compare_backward(scene_params(100_000, seed=0, device=dev), cams[0], st, 5)

    # 8. Small scene: one training step, card vs the CPU path.
    log("[8] small scene train step, card vs CPU path, in each mode")
    for mode in ("packed", "exact"):
        log(f"  {mode} mode:")
        with mode_context(mode):
            check_small_train_against_cpu(dev)

    # 9. The slice: train 1M Gaussians for 8 steps over 4 views, each mode.
    log(f"[9] train_step, 1M Gaussians, 1296x840, SH 3, {TRAIN_STEPS} steps over 4 views, "
        f"packed then exact")
    modes, trained = train_slice(cams, st, dev)

    # 10. Backward kernel times at the 1M view's shapes.
    log("[10] backward kernels vs plain versions at 1M Gaussians")
    bwd = compare_backward(trained, cams[0], st, 10)
    del trained

    # 11. The trainer at full width: Trainer.train on a 1M-point cloud.
    log(f"[11] Trainer.train, 1M points, {TRAINER_VIEWS} views at 1296x840, "
        f"{TRAINER_ITERS} iterations: density, Morton re-sort, opacity reset, SH bands, eval")
    morton = trainer_slice(dev)

    # 12. Small scene: density step and Morton sort, card vs CPU; checkpoint.
    log("[12] small scene density step and Morton sort, card vs CPU path; checkpoint")
    check_density_against_cpu(dev)

    # 13. Multi-device training: two ranks sharing the card over gloo.
    log(PARALLEL_TITLE)
    parallel_slice(dev)

    # 14. The modules ported last: the native host runtime, depth_rank
    # binning, the e2e recipe and the profiling hooks.
    log(REMAINING_TITLE)
    rest = remaining_slice(dev)

    # 15. The configuration's ceiling: the 4.25M-Gaussian train step at
    # both recorded scale points, and the garden-scale long run.
    log(SCALE_TITLE)
    scale = scale_slice(dev)
    log_scale_table(scale, {**res, **bwd})

    # 16. The photo recipes on a procedural texture: the single-image
    # overfit, the dense 7,000-iteration recipe through its capacity
    # growths, and the quality gate's logic.
    log(RECIPES_TITLE)
    at_recipes = recipes_slice(dev)

    # 17. The reference's compiled step: capped binning at the 1M view, the
    # graphed step against the eager ones, the graphed Trainer against the
    # eager one, eager against graph timings, a failed capture raising.
    log(CAPACITY_TITLE)
    capacity_slice(dev, morton["graphed"])

    # 18. The dp and tp steps as CUDA graphs, collectives included, over a
    # one-rank NCCL group: graph against eager, no host sync.
    log(NCCL_TITLE)
    nccl = nccl_graph_slice(dev)

    # 19. Masked Adam: the kernel against its plain version, per group and
    # a step, at the 1M and the 4.25M state.
    log(ADAM_TITLE)
    adam_1m, adam_scale = adam_table(dev)

    # 20. SH colour: the forward and backward kernels against their plain
    # versions at the 1M and 4.25M capacities.
    log(SH_TITLE)
    sh_1m, sh_scale = sh_table(dev)

    # 21. Mip-Splatting's 3D-filter sweep against its plain version.
    log(MIP_TITLE)
    mip_table(dev)

    # 22. The covariance: the forward and backward kernels against the plain
    # ops at the 1M and 4.25M capacities, both models.
    log(COVARIANCE_TITLE)
    cov_res = covariance_table(dev)

    # Launches: [9]'s packed run (the main path) for the packed kernels and
    # those without a mode; its exact run (a path of its own) for the exact
    # rasterizers and segment sum.
    both = {**res, **bwd}
    pk, ex = modes["packed"]["launches"], modes["exact"]["launches"]
    table = [("segment_expand", "", None, pk["segment_expand"]),
             ("radix_sort", "", "tile", pk["radix_sort/tile"])]
    for name in ("rasterize_forward", "rasterize_backward", "segment_sum"):
        table += [(name, "/packed", None, pk[f"{name}/packed"]),
                  (name, "", None, ex[name] - ex[f"{name}/packed"])]
    e2e, at_scale, at_nccl = rest["e2e_launches"], scale["launches"], nccl["launches"]
    kernels, gaps = [], []
    for name, sfx, site, n_launch in table:
        r = both[name + sfx]
        key = f"{name}/{site}" if site else name + sfx
        entry = dict(name=name, route="cuda", source=SOURCES[name],
                     replaces=REPLACES[name], launches=n_launch,
                     launches_per_step=n_launch / TRAIN_STEPS,
                     launches_e2e=e2e[key] - (e2e[key + "/packed"]
                                              if key + "/packed" in e2e else 0),
                     launches_scale=at_scale[key] - at_scale.get(key + "/packed", 0),
                     launches_recipes=at_recipes[key] - at_recipes.get(key + "/packed", 0),
                     launches_nccl_graph=at_nccl[key] - at_nccl.get(key + "/packed", 0))
        # The same kernel at the 4.25M scale point's shapes ([15a]).
        entry["scale"] = {k: scale["kernels"][name + sfx][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")}
        if site is not None:
            entry["site"] = site
        if name in ("rasterize_forward", "rasterize_backward", "segment_sum"):
            entry["mode"] = "packed" if sfx else "exact"
        entry.update({k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")})
        kernels.append(entry)
        # K5's ms and bound cover the frame's two calls.
        gaps.append((entry["launches_per_step"] / r.get("calls", 1)
                     * (r["ms"] - r["bound_ms"]),
                     f"{name} {site or entry.get('mode', '')}".strip()))
    log("  launches per step x (time - bound), ms: " + ", ".join(
        f"{label} {gap:.4f}" for gap, label in sorted(gaps, reverse=True)))
    # The density step's re-sort: [11]'s launches, one a density step.
    r = morton["res"]
    kernels.append(dict(
        name="radix_sort", route="cuda", source=SOURCES["radix_sort"],
        replaces=REPLACES["radix_sort"], launches=morton["launches"],
        launches_per_density_step=morton["launches"] / morton["density_steps"], site="morton",
        launches_e2e=e2e["radix_sort/morton"], launches_scale=at_scale["radix_sort/morton"],
        launches_recipes=at_recipes["radix_sort/morton"],
        launches_nccl_graph=at_nccl["radix_sort/morton"],
        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by")}))
    # The tile sort of binning's exact-ordering mode: [14b]'s launches. [15]
    # runs no such mode: its 30-bit keys end at capacity 2^17 at 1296x840.
    r = rest["depth_rank"]
    kernels.append(dict(
        name="radix_sort", route="cuda", source=SOURCES["radix_sort"],
        replaces=REPLACES["radix_sort"], launches=r["launches"], site="tile",
        mode="depth_rank", key_bits=r["key_bits"], launches_scale=0, launches_recipes=0,
        launches_nccl_graph=0,
        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                             "bound_by")}))
    # Masked Adam replaces no TPU kernel (XLA glue in the reference): a
    # step's groups summed; launches from [9]'s packed run.
    kernels.append(dict(
        name="masked_adam", route="cuda", source="gsplat_tpu_torch/csrc/adam.cu",
        replaces="none: XLA glue, gsplat_tpu/ops/adam.py", launches=pk["masked_adam"],
        launches_per_step=pk["masked_adam"] / TRAIN_STEPS,
        launches_scale=at_scale["masked_adam"], launches_nccl_graph=at_nccl["masked_adam"],
        scale={k: adam_scale[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        **{k: adam_1m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "apply_adam_ms",
                                   "apply_adam_plain_ms")}))
    # SH colour replaces no TPU kernel either (XLA glue in the reference):
    # the forward and the backward at the 1M capacity, launches from [9].
    for name, sfx in (("sh_forward", ""), ("sh_backward", "backward_")):
        pick = lambda r, sfx=sfx: {  # noqa: E731
            "ms": r[f"{sfx}ms"], "plain_ms": r[f"plain_{sfx}ms"],
            "bound_ms": r[f"{sfx}bound_ms"], "bound_by": "bytes"}
        kernels.append(dict(
            name=name, route="cuda", source="gsplat_tpu_torch/csrc/sh.cu",
            replaces="none: XLA glue, gsplat_tpu/ops/sh.py", launches=pk[name],
            launches_per_step=pk[name] / TRAIN_STEPS, launches_scale=at_scale[name],
            launches_nccl_graph=at_nccl[name], scale=pick(sh_scale), **pick(sh_1m)))
    # The covariance replaces no TPU kernel (XLA glue in the reference):
    # plain 3DGS at the 1M capacity, launches from [9].
    cov_1m, cov_scale = (next(r for r in cov_res if r["rows"] == n and r["model"] == "3dgs")
                         for n in SH_ROWS)
    for name, sfx in (("covariance_forward", ""), ("covariance_backward", "backward_")):
        pick = lambda r, sfx=sfx: {  # noqa: E731
            "ms": r[f"{sfx}ms"], "plain_ms": r[f"plain_{sfx}ms"],
            "bound_ms": r[f"{sfx}bound_ms"], "bound_by": "bytes"}
        kernels.append(dict(
            name=name, route="cuda", source="gsplat_tpu_torch/csrc/covariance.cu",
            replaces="none: XLA glue, gsplat_tpu/ops/covariance.py", launches=pk[name],
            launches_per_step=pk[name] / TRAIN_STEPS, launches_scale=at_scale[name],
            launches_nccl_graph=at_nccl[name], scale=pick(cov_scale), **pick(cov_1m)))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
