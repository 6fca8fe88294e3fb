"""The copied roofline arithmetic: ``roofline.kernel_bound`` is
``chip_smoke.kernel_bound``, and it gives ``PERF.md`` section 6's bound
column at the 1M view's recorded work."""

import importlib.util

import pytest

from gsbench import roofline
from tiny import ROOT

G = 1 << 20  # the 1M scene's capacity
TILES = 81 * 53  # 1296x840 in 16x16 tiles


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WORKS = [
    ("segment_expand", False, dict(expand=[(2, G, 2_265_000), (2, 2_265_000, 5_353_000)])),
    ("radix_sort", False, dict(keys=5_467_695)),
    ("rasterize_forward", False, dict(gaussians=G, pairs=5_353_000, tiles=TILES,
                                      pair_pixels=146_200_000, passing=68_100_000)),
    ("rasterize_forward", True, dict(gaussians=G, pairs=5_353_000, tiles=TILES,
                                     pair_pixels=146_200_000, passing=68_100_000,
                                     reached=800_000)),
    ("rasterize_backward", False, dict(gaussians=G, pairs=5_353_000, tiles=TILES,
                                       pair_pixels=180_900_000, passing=81_000_000)),
    ("rasterize_backward", True, dict(gaussians=G, pairs=5_353_000, tiles=TILES,
                                      pair_pixels=180_900_000, passing=81_000_000,
                                      reached=900_000)),
    ("segment_sum", False, dict(gaussians=G, pairs=5_353_000)),
    ("segment_sum", True, dict(gaussians=G, pairs=5_353_000)),
]


@pytest.mark.parametrize("name,packed,work", WORKS)
def test_copy_equals_chip_smoke(name, packed, work):
    assert roofline.kernel_bound(name, packed, **work) == _chip_smoke().kernel_bound(
        name, packed, **work)


@pytest.mark.parametrize("name,packed,work,bound_ms", [
    # PERF.md section 6: K1 exact, 146.2M pair-pixels, 68.1M past the cutoff
    ("rasterize_forward", False, WORKS[2][2], 0.0669),
    # K2 exact, 180.9M pair-pixels, 81.0M past the cutoff
    ("rasterize_backward", False, WORKS[4][2], 0.1234),
    # the tile sort, 65.6 MB: 5,467,695 keys of 12 bytes
    ("radix_sort", False, WORKS[1][2], 0.0196),
    # K4, 234.6 MB exact and 127.6 MB packed, at 5.353M pairs
    ("segment_sum", False, WORKS[6][2], 0.0700),
    ("segment_sum", True, WORKS[7][2], 0.0381),
    # K5, both levels, 100.7 MB
    ("segment_expand", False, WORKS[0][2], 0.0301),
])
def test_perf_md_bound_column(name, packed, work, bound_ms):
    assert round(roofline.kernel_bound(name, packed, **work)["bound_ms"], 4) == bound_ms


def test_step_model_sums_the_views():
    w = dict(gaussians=G, rows=2_265_000, pairs=5_353_000, tiles=TILES,
             pair_pixels=146_200_000, passing=68_100_000, reached=800_000)
    one = roofline.bound_seconds([w], train=True)
    assert roofline.bound_seconds([w, w, w], train=True) == pytest.approx(3 * one)
    assert roofline.bound_seconds([w], train=False) < one
    ops = roofline.step_ops([w], True, 1_000_000, 1296 * 840)
    # about 20 GFLOP a step: 1-2 % of the peak at ~24 ms
    assert 1.2e10 < ops < 3e10
    assert roofline.step_ops([w], False, 1_000_000, 0) < ops / 2
