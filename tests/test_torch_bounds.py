"""What the CPU can check of the radix sort's launch plan, of the kernel
bounds that chip_smoke.py reports, and of the port's default device.

- the sort's pass plan covers every key bit exactly once, its scratch has
  the size csrc/sort.cu lays out, and the wrapper returns the buffers the
  last pass writes (a stand-in library that follows csrc/sort.cu's buffer
  contract sorts by the plan it is passed) and counts its call site;
- the segment expand's wrapper returns the buffer the kernel wrote (a
  stand-in library), and its ITEMS_PER_BLOCK is csrc/expand.cu's share;
- ``chip_smoke.kernel_bound`` and ``chip_smoke.pair_pixel_counts`` give
  hand-counted bytes, operations and pair-pixels (masked Adam's and the
  SH colour kernels' too);
- the density step's Morton re-sort sorts its 31-bit codes (4 passes of
  8/8/8/7 bits) through the radix sort's ``"morton"`` call site, counted
  apart from the tile sort;
- ``GaussianParams``, ``Trainer``, ``cli.main`` and the synthetic dataset
  writer put their tensors on the card unless asked otherwise.
"""

import ctypes
import inspect
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from gsplat_tpu_torch.kernels import _build, expand, sort  # noqa: E402
from gsplat_tpu_torch import cli  # noqa: E402
from gsplat_tpu_torch.ops.morton import KEY_BITS  # noqa: E402
from gsplat_tpu_torch.tools import synthetic  # noqa: E402
from gsplat_tpu_torch.train import density  # noqa: E402
from gsplat_tpu_torch.train.state import GaussianParams, init_state, params_from_jax  # noqa: E402
from gsplat_tpu_torch.train.trainer import Trainer  # noqa: E402


@pytest.mark.parametrize("key_bits", [1, 7, 8, 9, 16, 20, 29, 31])
def test_sort_plan_covers_every_bit_once(key_bits):
    plan = sort.sort_plan(1000, key_bits)
    covered = [b for s, w in zip(plan.shifts, plan.bits) for b in range(s, s + w)]
    assert covered == list(range(key_bits))
    assert all(1 <= w <= sort.DIGIT_BITS for w in plan.bits)
    assert len(plan.shifts) == (key_bits + 7) // 8


@pytest.mark.parametrize("n,tiles", [(0, 0), (1, 1), (4095, 1), (4096, 1), (4097, 2),
                                     (5_500_000, 1343)])
def test_sort_scratch_sizes(n, tiles):
    # csrc/sort.cu: 4 x 256 digit counts, 32 tile counters, then 256
    # status words per tile and pass.
    for key_bits, passes in ((20, 3), (29, 4)):
        plan = sort.sort_plan(n, key_bits)
        assert plan.num_tiles == tiles
        assert plan.scratch_words == 1024 + 32 + passes * tiles * 256
    assert sort.TILE_KEYS == 4096


class _SortLib:
    """Stands in for the kernel library on CPU tensors, under csrc/sort.cu's
    contract: it runs the pass plan it is given (one stable pass per digit,
    low digit first), vals_out follows keys_out (the passes use those 8n
    bytes as n pairs), the result lands in keys_out and vals_out, and
    pairs_tmp (n pairs) and the scratch hold whatever the passes left there
    (-1 here).
    Likewise csrc/expand.cu's: the expanded columns land in out."""

    def gs_segment_expand(self, out, records, offsets_ext, num_cols, num_records,
                          width, capped, stream):
        rec = np.frombuffer(ctypes.string_at(records, 4 * num_cols * num_records),
                            np.int32).reshape(num_cols, num_records)
        off = np.frombuffer(ctypes.string_at(offsets_ext, 4 * (num_records + 1)), np.int32)
        got = np.repeat(rec, np.diff(off), axis=1)
        live = min(int(off[-1]), width) if capped else width
        for c in range(num_cols):  # rows of `width` words; the tail unwritten
            row = np.ascontiguousarray(got[c, :live])
            ctypes.memmove(out + 4 * c * width, row.ctypes.data, row.nbytes)
        return 0

    def gs_radix_sort(self, keys_in, keys_out, vals_out, pairs_tmp, scratch, n,
                      passes, plan, stream):
        assert vals_out == keys_out + 4 * n and scratch == pairs_tmp + 8 * n
        keys = np.frombuffer(ctypes.string_at(keys_in, 4 * n), np.int32)
        shift_bits = np.frombuffer(ctypes.string_at(plan, 8 * passes), np.int32)
        perm = np.arange(n)
        for shift, bits in shift_bits.reshape(passes, 2):
            digit = (keys[perm] >> shift) & ((1 << bits) - 1)
            perm = perm[np.argsort(digit, kind="stable")]
        perm = perm.astype(np.int32)
        scratch_words = sort.SortPlan((0,) * passes, (8,) * passes,
                                      -(-n // sort.TILE_KEYS)).scratch_words
        for ptr, arr in ((keys_out, keys[perm]), (vals_out, perm),
                         (pairs_tmp, np.full(2 * n + scratch_words, -1, np.int32))):
            ctypes.memmove(ptr, np.ascontiguousarray(arr).ctypes.data, arr.nbytes)
        return 0


@pytest.fixture
def stand_in_lib(monkeypatch):
    """Route the sort's launch to _SortLib; returns the launch counts."""
    lib = _SortLib()
    monkeypatch.setattr(_build, "build", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(_build, "launches", dict(_build.launches))
    return _build.launches


@pytest.mark.parametrize("key_bits", [1, 8, 9, 20, 29, 31])
def test_sort_returns_the_buffer_the_last_pass_wrote(stand_in_lib, key_bits):
    # The stand-in sorts by the plan the wrapper passes, so a plan that
    # missed a bit would also fail here.
    keys = torch.from_numpy(
        np.random.default_rng(key_bits).integers(0, 1 << key_bits, 5000).astype(np.int32))
    got_k, got_p = sort._launch(keys, key_bits, None)
    ref_k, ref_p = sort.radix_sort_plain(keys, key_bits)
    assert torch.equal(got_k, ref_k) and torch.equal(got_p, ref_p)
    assert stand_in_lib["radix_sort"] == 1


@pytest.mark.parametrize("site", [None, *sort.SITES])
def test_sort_counts_its_call_site(stand_in_lib, site):
    keys = torch.arange(100, 0, -1, dtype=torch.int32)
    sort._launch(keys, 7, site)
    assert stand_in_lib["radix_sort"] == 1
    assert {s: stand_in_lib[f"radix_sort/{s}"] for s in sort.SITES} == {
        s: int(s == site) for s in sort.SITES}


@pytest.mark.parametrize("r,total", [
    (1, 1), (1, 2047), (1, 2048), (2047, 2), (3000, 5192), (3000, 5193), (5, 0)])
def test_expand_returns_the_buffer_the_kernel_wrote(stand_in_lib, r, total):
    # Merged sizes (records + slots) on both sides of a block's share.
    counts = np.zeros(r, np.int64)
    np.add.at(counts, np.random.default_rng(r).integers(0, r, total), 1)
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    rec = torch.arange(2 * r, dtype=torch.int32).view(2, r)
    got = expand._launch(rec, off, total, False)
    assert got.shape == (2, total)
    assert torch.equal(got, expand.segment_expand_plain(rec, off, total))
    assert stand_in_lib["segment_expand"] == 1


@pytest.mark.parametrize("r,total,width", [
    (1, 5, 2048), (3000, 5192, 8192), (3000, 5193, 4096), (5, 0, 512), (2047, 2, 2)])
def test_capped_expand_contract(stand_in_lib, r, total, width):
    # A capped call's output is (C, width); its live slots, the offsets'
    # total clamped to the width, are the plain version's, which zeroes
    # the tail that the kernel leaves unwritten.
    counts = np.zeros(r, np.int64)
    np.add.at(counts, np.random.default_rng(r).integers(0, r, total), 1)
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    rec = torch.arange(2 * r, dtype=torch.int32).view(2, r)
    got = expand._launch(rec, off, width, True)
    plain = expand.segment_expand_plain(rec, off, width, capped=True)
    live = min(total, width)
    assert got.shape == plain.shape == (2, width)
    assert torch.equal(got[:, :live], plain[:, :live])
    assert torch.equal(plain[:, :live], expand.segment_expand_plain(rec, off, total)[:, :live])
    assert not plain[:, live:].any()
    assert stand_in_lib["segment_expand"] == 1


def test_expand_share_mirrors_the_kernel():
    # chip_smoke.py sizes K5's edge cases by ITEMS_PER_BLOCK: the share that
    # csrc/expand.cu's launch gives a block (kThreads x kItemsPerThread).
    src = (_build.CSRC / "expand.cu").read_text()
    threads, per_thread = (int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                           for k in ("kThreads", "kItemsPerThread"))
    assert threads * per_thread == expand.ITEMS_PER_BLOCK


def test_morton_key_plan_is_four_passes():
    plan = sort.sort_plan(1 << 20, KEY_BITS)
    assert KEY_BITS == 31 and (plan.shifts, plan.bits) == ((0, 8, 16, 24), (8, 8, 8, 7))


def test_morton_sort_counts_its_own_site(stand_in_lib, monkeypatch):
    # The CPU tensors go to the stand-in library through the wrapper's
    # launch, as CUDA tensors go to the kernel: one launch at the morton
    # site, none at the tile site, and the plain path's permutation.
    calls = []

    def launch(keys, key_bits, site=None):
        calls.append((key_bits, site))
        return sort._launch(keys, key_bits, site)

    rng = np.random.default_rng(3)
    n = 5000
    params = {name: rng.normal(size=(n, *np.atleast_1d(dim))).astype(np.float32)
              if dim else rng.normal(size=n).astype(np.float32)
              for name, dim in (("xyz", 3), ("rgb", 3), ("opacity", 0), ("scale", 3),
                                ("quat", 4), ("sh", (15, 3)))}
    alive = rng.uniform(size=n) < 0.7
    plain = density.morton_sort(init_state(params_from_jax(params, alive, "cpu")))
    monkeypatch.setattr(density, "radix_sort", launch)
    got = density.morton_sort(init_state(params_from_jax(params, alive, "cpu")))
    assert calls == [(31, "morton")]
    assert (stand_in_lib["radix_sort/morton"], stand_in_lib["radix_sort/tile"]) == (1, 0)
    assert torch.equal(got.params.xyz, plain.params.xyz)
    assert torch.equal(got.alive, plain.alive) and bool(got.alive[:int(alive.sum())].all())


def test_sort_rejects_an_unknown_site():
    with pytest.raises(ValueError, match="site"):
        sort.radix_sort(torch.zeros((8,), dtype=torch.int32, device="meta"), 8,
                        site="elsewhere")


def test_pair_pixel_counts_hand_counted():
    # One Gaussian at pixel (0, 0) of a single 16x16 tile, conic (1, 0, 1),
    # opacity 0.5: alpha = 0.5 exp(-r^2 / 2) passes 1/255 where r^2 < 2
    # ln 127.5 = 9.70, at 11 pixels ((0..2, 0..2), (0, 3), (3, 0)). Every
    # pixel iterates the one splat: 256 pair-pixels, and as many for the
    # warps of either kernel to step through.
    from gsplat_tpu_torch.kernels.rasterize import rasterize_forward_plain

    attrs = torch.tensor([[0.0, 0.0, 1.0, 0.0, 1.0, 0.5, 1.0, 1.0, 1.0]])
    raster = (attrs, torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
              torch.ones(1, dtype=torch.int32))
    out = rasterize_forward_plain(*raster, 0.0, num_tiles_x=1)
    assert chip_smoke.pair_pixel_counts(raster, out, 1) == dict(
        pair_pixels=256, passing=11, reached=1, fwd_warp_pair_pixels=256,
        bwd_warp_pair_pixels=256)


def test_kernel_bound_hand_counted():
    hbm, fp32 = 3.35e12, 67e12
    # Radix sort: 4-byte keys in; 4-byte keys and 4-byte indices out.
    r = chip_smoke.kernel_bound("radix_sort", keys=1000)
    assert (r["bytes"], r["ops"], r["bound_by"]) == (12_000, 0, "bytes")
    assert r["bound_ms"] == pytest.approx(1e3 * 12_000 / hbm)
    # Segment expand: 2 columns of 3 records and 4 offsets in, 2 x 5 out.
    r = chip_smoke.kernel_bound("segment_expand", expand=[(2, 3, 5)])
    assert (r["bytes"], r["ops"]) == (4 * (6 + 4 + 10), 0)
    # Forward rasterizer, 2 Gaussians, 3 pairs, 1 tile, 10 pair-pixels of
    # which 4 pass the cutoff: attrs 2 x 36, gid 3 x 4, start and count
    # 2 x 4, out 5 x 256 x 4; 26 operations each, 10 more for a passing one.
    kw = dict(gaussians=2, pairs=3, tiles=1, pair_pixels=10, passing=4)
    r = chip_smoke.kernel_bound("rasterize_forward", **kw)
    assert (r["bytes"], r["ops"], r["bound_by"]) == (72 + 12 + 8 + 5120, 300, "bytes")
    # Backward: + cotangent 3 x 256 x 4 and pair_cand 3 x 4 in, 3 rows of 36
    # bytes out; 44 more operations for a passing pair-pixel.
    r = chip_smoke.kernel_bound("rasterize_backward", **kw)
    assert (r["bytes"], r["ops"]) == (72 + 12 + 8 + 5120 + 3072 + 12 + 108, 260 + 176)
    kw.update(pair_pixels=10**7, passing=10**6)  # 3.04e8 operations outweigh 8 KB
    r = chip_smoke.kernel_bound("rasterize_backward", **kw)
    assert r["bound_by"] == "operations"
    assert r["bound_ms"] == pytest.approx(1e3 * 3.04e8 / fp32)
    # Segment sum: contiguous rows of 36 bytes a pair; pair_start's N + 1
    # words in and 36 bytes out a Gaussian; 9 adds a pair.
    r = chip_smoke.kernel_bound("segment_sum", gaussians=2, pairs=3)
    assert (r["bytes"], r["ops"], r["bound_by"]) == (3 * 36 + 3 * 4 + 2 * 36, 27, "bytes")


def test_kernel_bound_masked_adam_hand_counted():
    # Masked Adam: a stepped element reads param, grad, m and v (16 bytes)
    # and writes param, m and v (12 bytes); each row's mask byte is read; 15
    # operations a stepped element. 3 rows of width 4, 2 of them stepped.
    r = chip_smoke.kernel_bound("masked_adam", stepped=8, rows=3)
    assert (r["bytes"], r["ops"], r["bound_by"]) == (8 * 28 + 3, 8 * 15, "bytes")
    assert r["bound_ms"] == pytest.approx(1e3 * 227 / 3.35e12)


def test_kernel_bound_sh_hand_counted():
    # SH colour, bytes a row: the forward reads xyz 12, dc 12 and sh 180
    # and writes rgb 12; the backward reads xyz 12, sh 180 and the colour
    # gradient 12 and writes grad_xyz 12, grad_dc 12 and grad_sh 180.
    r = chip_smoke.kernel_bound("sh_forward", rows=10)
    assert (r["bytes"], r["ops"], r["bound_by"]) == (10 * 216, 0, "bytes")
    r = chip_smoke.kernel_bound("sh_backward", rows=6_291_456)
    assert (r["bytes"], r["bound_by"]) == (6_291_456 * 408, "bytes")
    assert r["bound_ms"] == pytest.approx(1e3 * 6_291_456 * 408 / 3.35e12)


def test_kernel_bound_covariance_hand_counted():
    # Covariance, bytes a row: the forward reads xyz_c 12, quat 16, scale 12
    # and the opacity logit 4 and writes the conic 12 and the radius record
    # 20; the backward reads the conic's gradient 12, xyz_c, quat and scale
    # and writes their gradients 40. Mip-Splatting adds the filter's 4 to
    # each pass and the opacity scale (or its gradient) 4.
    r = chip_smoke.kernel_bound("covariance_forward", rows=10)
    assert (r["bytes"], r["ops"], r["bound_by"]) == (10 * 76, 0, "bytes")
    r = chip_smoke.kernel_bound("covariance_forward", rows=10, mip=True)
    assert r["bytes"] == 10 * 84
    r = chip_smoke.kernel_bound("covariance_backward", rows=6_291_456)
    assert (r["bytes"], r["bound_by"]) == (6_291_456 * 92, "bytes")
    r = chip_smoke.kernel_bound("covariance_backward", rows=6_291_456, mip=True)
    assert r["bound_ms"] == pytest.approx(1e3 * 6_291_456 * 100 / 3.35e12)


def test_kernel_bound_packed_hand_counted():
    # Packed mode: the rasterizers also round each pair up to every tile's
    # deepest n_splats (87 operations a pair); K2 writes 4-word rows (16
    # bytes, not 36) and packs those it reaches (50 a pair: 2 of the 3);
    # K4 reads 16-byte rows and unpacks every one (21 a pair), pair_start is
    # N + 1 words, no gather index.
    kw = dict(gaussians=2, pairs=3, tiles=1, pair_pixels=10, passing=4, reached=2)
    r = chip_smoke.kernel_bound("rasterize_forward", packed=True, **kw)
    assert (r["bytes"], r["ops"]) == (72 + 12 + 8 + 5120, 300 + 2 * 87)
    r = chip_smoke.kernel_bound("rasterize_backward", packed=True, **kw)
    assert (r["bytes"], r["ops"]) == (72 + 12 + 8 + 5120 + 3072 + 12 + 48,
                                      260 + 176 + 2 * 87 + 2 * 50)
    r = chip_smoke.kernel_bound("segment_sum", packed=True, gaussians=2, pairs=3)
    assert (r["bytes"], r["ops"]) == (3 * 16 + 3 * 4 + 2 * 36, 3 * (9 + 21))
    # The one splat of test_pair_pixel_counts_hand_counted is exact in the
    # packed formats: the same work.
    from gsplat_tpu_torch.kernels.rasterize import rasterize_forward_plain

    attrs = torch.tensor([[0.0, 0.0, 1.0, 0.0, 1.0, 0.5, 1.0, 1.0, 1.0]])
    raster = (attrs, torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
              torch.ones(1, dtype=torch.int32))
    out = rasterize_forward_plain(*raster, 0.0, num_tiles_x=1, packed=True)
    assert chip_smoke.pair_pixel_counts(raster, out, 1, packed=True) == dict(
        pair_pixels=256, passing=11, reached=1, fwd_warp_pair_pixels=256,
        bwd_warp_pair_pixels=256)


def test_gaussian_params_default_device_is_cuda():
    default = inspect.signature(GaussianParams.__init__).parameters["device"].default
    assert torch.device(default).type == "cuda"


@pytest.mark.parametrize("fn", [Trainer.__init__, cli.main, synthetic.write_synthetic_dataset,
                                synthetic.main])
def test_entry_points_default_to_cuda(fn):
    default = inspect.signature(fn).parameters["device"].default
    assert torch.device(default).type == "cuda"
