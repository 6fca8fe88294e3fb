"""The port's CUDA kernels against their plain versions, and one train step
against the port's CPU path, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one
(the ``cuda`` marker). This file imports neither JAX nor ``gsplat_tpu``, so
it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import expand_edge_counts  # noqa: E402
from gsplat_tpu_torch.kernels import _build, packing  # noqa: E402
from gsplat_tpu_torch.kernels.expand import segment_expand, segment_expand_plain  # noqa: E402
from gsplat_tpu_torch.kernels.rasterize import (  # noqa: E402
    rasterize_backward, rasterize_backward_plain, rasterize_forward,
    rasterize_forward_plain,
)
from gsplat_tpu_torch.kernels.segsum import (  # noqa: E402
    inverse_permutation, inverse_permutation_plain, segment_sum, segment_sum_plain,
)
from gsplat_tpu_torch.kernels.sort import radix_sort, radix_sort_plain, sort_plan  # noqa: E402
from gsplat_tpu_torch.ops.binning import build_tile_tables  # noqa: E402
from gsplat_tpu_torch.train.step import exact_mode  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 1000, 300_000])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_segment_expand_kernel_equals_plain(dev, n, dtype):
    rng = np.random.default_rng(n)
    counts = rng.integers(0, 5, n).astype(np.int32)
    counts[0] = 0  # zero counts at the head, the tail and in between
    counts[-1] = 0
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    rec = torch.from_numpy(rng.integers(-2**20, 2**20, (3, n)).astype(np.int32)).to(dtype)
    total = int(counts.sum())
    before = _build.launches["segment_expand"]
    got = segment_expand(rec.to(dev), off.to(dev), total)
    torch.cuda.synchronize()
    assert _build.launches["segment_expand"] == before + 1
    assert torch.equal(got.cpu(), segment_expand_plain(rec, off, total))


@pytest.mark.parametrize("case", [name for name, _ in expand_edge_counts()])
def test_segment_expand_kernel_edge_counts(dev, case):
    # A run longer than many blocks' shares, 10K zero counts in a row, all
    # slots in the last record, one record, no slots, and merged sizes
    # around a multiple of a block's share: bit-equal, random 32-bit words.
    counts = dict(expand_edge_counts())[case]
    off = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    rec = torch.from_numpy(np.random.default_rng(2).integers(
        -2**31, 2**31, (2, counts.shape[0]), dtype=np.int64).astype(np.int32))
    total = int(counts.sum())
    got = segment_expand(rec.to(dev), off.to(dev), total)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), segment_expand_plain(rec, off, total))


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 100_000, 1_000_000])
@pytest.mark.parametrize("key_bits", [1, 5, 8, 13, 20, 29, 31])
def test_radix_sort_kernel_equals_plain(dev, n, key_bits):
    rng = np.random.default_rng(key_bits * 7 + n)
    keys = torch.from_numpy(rng.integers(0, 1 << key_bits, n).astype(np.int32))
    s_k, perm = radix_sort(keys.to(dev), key_bits)
    torch.cuda.synchronize()
    p_k, p_perm = radix_sort_plain(keys, key_bits)
    assert torch.equal(s_k.cpu(), p_k)
    assert torch.equal(perm.cpu(), p_perm)  # stable: the same permutation


@pytest.mark.parametrize("n", [4097, 100_000])
@pytest.mark.parametrize("kind", ["equal", "top digit"])
@pytest.mark.parametrize("key_bits", [1, 20, 29, 31])
def test_radix_sort_kernel_skewed_keys(dev, n, kind, key_bits):
    # One digit value for every key, or keys that differ only in the last
    # pass's digit: single long runs through the look-back and the scatter.
    rng = np.random.default_rng(n + key_bits)
    if kind == "equal":
        keys = np.full(n, (1 << key_bits) - 1, np.int64)
    else:
        top = sort_plan(n, key_bits).shifts[-1]  # the last pass's digit
        keys = rng.integers(0, 1 << (key_bits - top), n) << top
    keys = torch.from_numpy(keys.astype(np.int32))
    s_k, perm = radix_sort(keys.to(dev), key_bits)
    torch.cuda.synchronize()
    p_k, p_perm = radix_sort_plain(keys, key_bits)
    assert torch.equal(s_k.cpu(), p_k) and torch.equal(perm.cpu(), p_perm)


def _scene(rng, n, width, height):
    uv = rng.uniform([-5, -5], [width + 5, height + 5], size=(n, 2))
    theta = rng.uniform(0, np.pi, n)
    s1, s2 = rng.uniform(1.5, 12.0, n), rng.uniform(1.5, 12.0, n)
    c, s = np.cos(theta), np.sin(theta)
    cov00 = c * c * s1**2 + s * s * s2**2 + 0.3
    cov01 = c * s * (s1**2 - s2**2)
    cov11 = s * s * s1**2 + c * c * s2**2 + 0.3
    det = cov00 * cov11 - cov01**2
    conic = np.stack([cov11 / det, -cov01 / det, cov00 / det], 1)
    mid = 0.5 * (cov00 + cov11)
    lam = np.sqrt(np.maximum(0.1, mid * mid - det))
    ang = 0.5 * np.arctan2(2 * cov01, cov00 - cov11)
    radius = np.stack([np.ceil(3 * np.sqrt(mid + lam)),
                       np.ceil(3 * np.sqrt(np.maximum(mid - lam, 0))),
                       np.sin(ang), np.cos(ang)], 1)
    z = rng.uniform(0.5, 20.0, n)
    opa = 1.0 / (1.0 + np.exp(-rng.uniform(-2.0, 5.0, n)))
    rgb = rng.uniform(0, 1, (n, 3))
    attrs = np.concatenate([uv, conic, opa[:, None], rgb], 1)
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))  # noqa: E731
    return f32(uv), f32(radius), f32(z), f32(attrs)


@pytest.mark.parametrize("n", [50, 3000])
def test_rasterize_kernel_close_to_plain(dev, n):
    width, height = 160, 96
    ntx, nty = width // 16, height // 16
    uv, radius, z, attrs = _scene(np.random.default_rng(n), n, width, height)
    mask = torch.ones(n, dtype=torch.bool)
    tables = build_tile_tables(uv, z, radius, mask, num_tiles_x=ntx,
                               num_tiles_y=nty, tile_size=16)
    args = [t.to(dev) for t in (attrs, tables.splat_gid, tables.tile_start,
                                tables.tile_count)]
    got = rasterize_forward(*args, 0.3, num_tiles_x=ntx)
    torch.cuda.synchronize()
    ref = rasterize_forward_plain(*args, 0.3, num_tiles_x=ntx)
    # FMA contraction in the kernel and chunked products in the plain
    # version round differently: colours to ~1e-5, T_final relatively.
    torch.testing.assert_close(got[:, :3], ref[:, :3], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[:, 3], ref[:, 3], rtol=1e-3, atol=1e-5)
    same_n = (got[:, 4] == ref[:, 4]).float().mean().item()
    assert same_n >= 0.999, same_n


@pytest.mark.parametrize("n", [50, 3000])
def test_rasterize_kernel_packed_close_to_plain(dev, n):
    # Packed mode: each thread rounds the pair it stages; the plain version
    # rounds the gathered rows the same way (packing.round_pair_attrs).
    width, height = 160, 96
    ntx, nty = width // 16, height // 16
    uv, radius, z, attrs = _scene(np.random.default_rng(n + 1), n, width, height)
    tables = build_tile_tables(uv, z, radius, torch.ones(n, dtype=torch.bool), num_tiles_x=ntx,
                               num_tiles_y=nty, tile_size=16)
    args = [t.to(dev) for t in (attrs, tables.splat_gid, tables.tile_start,
                                tables.tile_count)]
    before = _build.launches["rasterize_forward/packed"]
    got = rasterize_forward(*args, 0.3, num_tiles_x=ntx, packed=True)
    again = rasterize_forward(*args, 0.3, num_tiles_x=ntx, packed=True)
    torch.cuda.synchronize()
    assert _build.launches["rasterize_forward/packed"] == before + 2
    assert torch.equal(got, again)
    ref = rasterize_forward_plain(*args, 0.3, num_tiles_x=ntx, packed=True)
    exact = rasterize_forward_plain(*args, 0.3, num_tiles_x=ntx)
    torch.testing.assert_close(got[:, :3], ref[:, :3], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[:, 3], ref[:, 3], rtol=1e-3, atol=1e-5)
    assert (got[:, 4] == ref[:, 4]).float().mean().item() >= 0.999
    assert not torch.equal(ref, exact)  # the rounding shows


def _one_tile_lists(rng, count, opa, wide):
    """Hand-made tables of two tiles (32x16 px): tile 0 lists ``count``
    pairs, tile 1 none. ``wide`` splats cover the tile evenly, so every
    pixel saturates after about the same number of pairs."""
    n = max(count, 1)
    u = rng.uniform(-4, 20, n)
    v = rng.uniform(-4, 20, n)
    conic = np.tile([1e-4, 0.0, 1e-4], (n, 1)) if wide else np.stack(
        [rng.uniform(0.01, 0.5, n), rng.uniform(-0.005, 0.005, n),
         rng.uniform(0.01, 0.5, n)], 1)
    rgb = rng.uniform(0, 1, (n, 3))
    attrs = np.concatenate([u[:, None], v[:, None], conic, np.full((n, 1), opa), rgb], 1)
    gid = rng.integers(0, n, count)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    return (torch.from_numpy(attrs.astype(np.float32)), i32(gid), i32([0, count]),
            i32([count, 0]))


@pytest.mark.parametrize("count,opa,wide,saturates", [
    (0, 0.5, False, None), (1, 0.5, False, None), (255, 0.3, False, None),
    (256, 0.3, False, None), (257, 0.3, False, None), (64, 0.3, False, None),
    (65, 0.3, False, None),
    # every pixel crosses T < 1e-4 within the first batch of 64 pairs
    (257, 0.6, True, (0, 64)),
    # ... or in the last batch, [192, 250)
    (250, 0.0412, True, (192, 250)),
])
def test_rasterize_forward_kernel_tile_counts(dev, count, opa, wide, saturates):
    # Tile lists around the kernel's batch of 64 pairs and the old one of
    # 256, and pixels that saturate in the first or the last batch.
    args = _one_tile_lists(np.random.default_rng(count), count, opa, wide)
    got = rasterize_forward(*[t.to(dev) for t in args], 0.3, num_tiles_x=2)
    again = rasterize_forward(*[t.to(dev) for t in args], 0.3, num_tiles_x=2)
    torch.cuda.synchronize()
    ref = rasterize_forward_plain(*args, 0.3, num_tiles_x=2)
    assert torch.equal(got, again)
    got = got.cpu()
    torch.testing.assert_close(got[:, :3], ref[:, :3], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[:, 3], ref[:, 3], rtol=1e-3, atol=1e-5)
    assert torch.equal(got[:, 4], ref[:, 4])
    assert torch.equal(got[1], ref[1]) and (got[1, 4] == 0).all()  # the empty tile
    n_spl = ref[0, 4]
    if saturates is None:
        assert (n_spl == count).any()  # some pixel reached the end of the list
    else:
        lo, hi = saturates
        assert (n_spl > lo).all() and (n_spl <= hi).all() and (n_spl < count).all()


def test_binning_on_card_equals_cpu(dev):
    width, height = 320, 240
    uv, radius, z, _ = _scene(np.random.default_rng(1), 20_000, width, height)
    mask = torch.ones(uv.shape[0], dtype=torch.bool)
    kw = dict(num_tiles_x=width // 16, num_tiles_y=height // 16, tile_size=16)
    cpu = build_tile_tables(uv, z, radius, mask, **kw)
    gpu = build_tile_tables(uv.to(dev), z.to(dev), radius.to(dev), mask.to(dev), **kw)
    assert gpu.num_pairs == cpu.num_pairs
    assert torch.equal(gpu.tile_count.cpu(), cpu.tile_count)
    # Order may differ only where log2 rounds a depth into the next bucket.
    same = (gpu.splat_gid.cpu() == cpu.splat_gid).float().mean().item()
    assert same >= 0.999, same


def test_binning_depth_rank_on_card_equals_cpu(dev):
    """Under a dense depth rank no rounding enters the sort key: the card's
    tables equal the CPU path's, order included (30 - 9 bits to spare)."""
    width, height = 320, 240
    uv, radius, z, _ = _scene(np.random.default_rng(1), 20_000, width, height)
    mask = torch.ones(uv.shape[0], dtype=torch.bool)
    rank = torch.empty(uv.shape[0], dtype=torch.int32)
    rank[torch.argsort(z, stable=True)] = torch.arange(uv.shape[0], dtype=torch.int32)
    kw = dict(num_tiles_x=width // 16, num_tiles_y=height // 16, tile_size=16)
    cpu = build_tile_tables(uv, z, radius, mask, depth_rank=rank, **kw)
    gpu = build_tile_tables(uv.to(dev), z.to(dev), radius.to(dev), mask.to(dev),
                            depth_rank=rank.to(dev), **kw)
    assert gpu.num_pairs == cpu.num_pairs > 0
    for f in ("splat_gid", "tile_start", "tile_count", "pair_slot", "pair_start"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f


def _backward_inputs(rng, n, width, height, saturate=False):
    """Tables, attrs, forward output and a random image cotangent (CPU)."""
    ntx, nty = (width + 15) // 16, (height + 15) // 16
    uv, radius, z, attrs = _scene(rng, n, width, height)
    if saturate:  # opaque and wide: every pixel stops long before the last pair
        attrs[:, 5] = 0.98
        attrs[:, 2:5] = torch.tensor([0.01, 0.0, 0.01])
        radius[:, :2] = 40.0
    tables = build_tile_tables(uv, z, radius, torch.ones(n, dtype=torch.bool),
                               num_tiles_x=ntx, num_tiles_y=nty, tile_size=16)
    args = (attrs, tables.splat_gid, tables.tile_start, tables.tile_count)
    out = rasterize_forward_plain(*args, 0.3, num_tiles_x=ntx)
    d_tiles = torch.from_numpy(rng.normal(size=(ntx * nty, 3, 256)).astype(np.float32))
    return args, out, d_tiles, ntx, nty


@pytest.mark.parametrize("n,saturate", [(50, False), (3000, False), (400, True)])
def test_rasterize_backward_kernel_close_to_plain(dev, n, saturate):
    args, out, d_tiles, ntx, nty = _backward_inputs(
        np.random.default_rng(n), n, 160, 88, saturate)
    kw = dict(num_tiles_x=ntx, num_tiles_y=nty)
    dev_in = [t.to(dev) for t in (*args, out, d_tiles)]
    got = rasterize_backward(*dev_in, 0.3, **kw)
    again = rasterize_backward(*dev_in, 0.3, **kw)
    torch.cuda.synchronize()
    ref = rasterize_backward_plain(*args, out, d_tiles, 0.3, **kw)
    assert torch.equal(got, again)  # no atomics: bit-identical reruns
    # The 256-pixel sums run in another order (registers and warp shuffles
    # vs a tensor sum) and T is replayed by a reciprocal vs chunked
    # products: compare each row relative to its largest |value|. Against
    # a float64 replay both are off by up to 1.5e-4 of that (H100, these
    # scenes, with T replayed by division); the two differ by up to 1.8e-4.
    got = got.cpu()
    scale = ref.abs().amax(dim=1, keepdim=True)
    assert ((got - ref).abs() <= 1e-3 * scale + 1e-6).all()
    if saturate:
        start, count = args[2], args[3]
        maxn = out[:, 4].amax(dim=1).long()
        assert (maxn < count.long()).any()
        for t in torch.nonzero(maxn < count.long()).flatten().tolist():
            tail = got[int(start[t]) + int(maxn[t]): int(start[t]) + int(count[t])]
            assert torch.equal(tail, torch.zeros_like(tail))  # written, as zeros


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("n,saturate", [(50, False), (3000, False), (400, True)])
def test_rasterize_backward_packed_words(dev, n, saturate, packed):
    # The packed words are the port's pack of the kernel's own float32 rows
    # on the same inputs (packed or exact pairs), bit for bit; those rows
    # are the plain version's within the exact mode's bound; rows past
    # every n_splats are the words of a zero row.
    args, _, d_tiles, ntx, nty = _backward_inputs(
        np.random.default_rng(n + 2), n, 160, 88, saturate)
    kw = dict(num_tiles_x=ntx, num_tiles_y=nty, packed=packed)
    out = rasterize_forward_plain(*args, 0.3, num_tiles_x=ntx, packed=packed)
    dev_in = [t.to(dev) for t in (*args, out, d_tiles)]
    rows = rasterize_backward(*dev_in, 0.3, **kw)
    words = rasterize_backward(*dev_in, 0.3, pack_grads=True, **kw)
    again = rasterize_backward(*dev_in, 0.3, pack_grads=True, **kw)
    torch.cuda.synchronize()
    assert words.dtype == torch.int32 and words.shape == (args[1].shape[0], 4)
    assert torch.equal(words, again)
    assert torch.equal(words, packing.pack_grad_rows(rows))
    ref = rasterize_backward_plain(*args, out, d_tiles, 0.3, **kw)
    rows = rows.cpu()
    scale = ref.abs().amax(dim=1, keepdim=True)
    assert ((rows - ref).abs() <= 1e-3 * scale + 1e-6).all()
    if saturate:
        start, count = args[2], args[3]
        maxn = out[:, 4].amax(dim=1).long()
        zero = packing.pack_grad_rows(torch.zeros((1, 9)))
        t = int(torch.nonzero(maxn < count.long())[0])
        tail = words.cpu()[int(start[t]) + int(maxn[t]): int(start[t]) + int(count[t])]
        assert tail.shape[0] > 0 and torch.equal(tail, zero.expand_as(tail))


def _dead_groups(attrs, gid, start, count, out, ntx):
    """(tile, warp, group) triples of csrc/rasterize_bwd.cu's walk where no
    pixel of the warp passes the alpha cutoff before its n_splats. A warp
    there replays 128 pixels (8 rows of the tile); a group is 4 pairs, from
    the top of each 64-pair batch down."""
    dead = 0
    nspl = out[:, 4]
    for t in range(start.shape[0]):
        maxn = min(int(nspl[t].max()), int(count[t]))
        g = gid[int(start[t]): int(start[t]) + maxn].long()
        if maxn == 0:
            continue
        a = attrs[g]  # (maxn, 9)
        pix = torch.arange(256)
        px = ((t % ntx) * 16 + pix % 16).float()[:, None]
        py = ((t // ntx) * 16 + pix // 16).float()[:, None]
        dx, dy = a[:, 0] - px, a[:, 1] - py
        power = torch.clamp(-0.5 * (a[:, 2] * dx * dx + 2.0 * a[:, 3] * dx * dy
                                    + a[:, 4] * dy * dy), max=0.0)
        alpha = torch.clamp(a[:, 5] * torch.exp(power), max=0.99)
        live = (alpha > 1 / 255) & (torch.arange(maxn)[None, :] < nspl[t][:, None])
        live = live.view(2, 128, maxn).any(dim=1)  # (warp, pair)
        for b0 in range(0, maxn, 64):
            nb = min(64, maxn - b0)
            for jt in range(nb - 1, -1, -4):
                js = [b0 + jt - k for k in range(4) if jt - k >= 0]
                dead += int((~live[:, js].any(dim=1)).sum())
    return dead


@pytest.mark.parametrize("case", ["empty tiles", "ragged maxn", "dead groups"])
def test_rasterize_backward_kernel_edge_tiles(dev, case):
    # Tiles with no pairs; tiles whose deepest n_splats is not a multiple of
    # the kernel's group of 4 pairs; groups where a whole warp is dead.
    rng = np.random.default_rng(7)
    width, height = 160, 88
    ntx, nty = (width + 15) // 16, (height + 15) // 16
    n = {"empty tiles": 60, "ragged maxn": 25, "dead groups": 400}[case]
    uv, radius, z, attrs = _scene(rng, n, width, height)
    if case == "empty tiles":  # only the left half of the image is covered
        uv[:, 0] = uv[:, 0] * 0.3
        attrs[:, 0] = uv[:, 0]
    if case == "dead groups":  # small splats: each covers a few pixels
        attrs[:, 2:5] = torch.tensor([8.0, 0.0, 8.0])
        radius[:, :2] = 2.0
    tables = build_tile_tables(uv, z, radius, torch.ones(n, dtype=torch.bool),
                               num_tiles_x=ntx, num_tiles_y=nty, tile_size=16)
    args = (attrs, tables.splat_gid, tables.tile_start, tables.tile_count)
    out = rasterize_forward_plain(*args, 0.3, num_tiles_x=ntx)
    d_tiles = torch.from_numpy(rng.normal(size=(ntx * nty, 3, 256)).astype(np.float32))
    count = tables.tile_count.long()
    maxn = torch.minimum(out[:, 4].amax(dim=1).long(), count)
    if case == "empty tiles":
        assert (count == 0).any() and (count > 0).any()
    if case == "ragged maxn":
        assert ((maxn % 4 != 0) & (maxn > 4)).any()
    if case == "dead groups":
        assert _dead_groups(*args, out, ntx) > 0
    kw = dict(num_tiles_x=ntx, num_tiles_y=nty)
    dev_in = [t.to(dev) for t in (*args, out, d_tiles)]
    got = rasterize_backward(*dev_in, 0.3, **kw)
    again = rasterize_backward(*dev_in, 0.3, **kw)
    torch.cuda.synchronize()
    ref = rasterize_backward_plain(*args, out, d_tiles, 0.3, **kw)
    assert torch.equal(got, again)
    got = got.cpu()
    assert torch.isfinite(got).all()
    scale = ref.abs().amax(dim=1, keepdim=True)
    assert ((got - ref).abs() <= 1e-3 * scale + 1e-6).all()


def _gaussian_runs(rng, n, p):
    """Per-Gaussian runs of p pairs in a random stable tile order, as
    binning gives them: (pair_slot, pair_start) and the pair counts."""
    gids = rng.integers(0, n, p).astype(np.int32)
    gids[: p // 5] = n // 2  # one Gaussian with hundreds of pairs
    gids[gids % 3 == 1] = n // 3  # and empty runs around it
    counts = np.bincount(gids, minlength=n)
    keys = torch.from_numpy(rng.permutation(p).astype(np.int32))  # slot order
    perm = radix_sort_plain(keys, 31)[1]
    pair_start = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    return inverse_permutation(perm), pair_start, counts


@pytest.mark.parametrize("p", [0, 1, 255, 256, 257, 1_000_003])
def test_inverse_permutation_kernel_equals_plain(dev, p):
    perm = torch.from_numpy(np.random.default_rng(p).permutation(p).astype(np.int32))
    got = inverse_permutation(perm.to(dev))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), inverse_permutation_plain(perm))


@pytest.mark.parametrize("n,p", [(1, 5), (700, 3500), (100_000, 1_500_000)])
def test_segment_sum_kernel_close_to_plain(dev, n, p):
    rng = np.random.default_rng(p)
    pair_slot, pair_start, counts = _gaussian_runs(rng, n, p)
    rows = torch.from_numpy(rng.standard_normal((p, 9)).astype(np.float32))
    args = [t.to(dev) for t in (rows, pair_slot, pair_start)]
    got = segment_sum(*args, n)
    again = segment_sum(*args, n)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = segment_sum_plain(rows, pair_slot, pair_start, n)
    # The kernel adds each run in the plain version's (index) order.
    assert torch.equal(got.cpu(), ref)
    assert (got.cpu()[torch.from_numpy(counts == 0)] == 0).all()


@pytest.mark.parametrize("n,p", [(1, 5), (700, 3500), (100_000, 1_500_000)])
def test_segment_sum_packed_kernel_equals_plain(dev, n, p):
    rng = np.random.default_rng(p + 1)
    pair_slot, pair_start, counts = _gaussian_runs(rng, n, p)
    rows = torch.from_numpy((rng.standard_normal((p, 9)) * np.exp2(
        rng.integers(-30, 0, (p, 1)))).astype(np.float32))
    words = packing.pack_grad_rows(rows)
    args = [t.to(dev) for t in (words, pair_slot, pair_start)]
    before = _build.launches["segment_sum/packed"]
    got = segment_sum(*args, n)
    again = segment_sum(*args, n)
    torch.cuda.synchronize()
    assert _build.launches["segment_sum/packed"] == before + 2
    assert torch.equal(got, again)
    # The kernel adds each run's unpacked words in the plain version's order.
    assert torch.equal(got.cpu(), segment_sum_plain(words, pair_slot, pair_start, n))
    assert (got.cpu()[torch.from_numpy(counts == 0)] == 0).all()


def test_train_step_on_card_close_to_cpu(dev):
    # Exact mode: the bounds below are f32 summation orders.
    from gsplat_tpu_torch.ops.camera import build_camera_matrices
    from gsplat_tpu_torch.train import state as t_state
    from gsplat_tpu_torch.train import step as t_step

    w, h, n = 96, 56, 2000
    rng = np.random.default_rng(5)
    params = dict(
        xyz=rng.normal(size=(n, 3)) * [1.0, 0.7, 0.6] + [0, 0, 4.0],
        rgb=rng.normal(size=(n, 3)), opacity=rng.uniform(-1.0, 2.0, n),
        scale=np.log(rng.uniform(0.02, 0.1, (n, 3))),
        quat=np.concatenate([np.ones((n, 1)), 0.3 * rng.normal(size=(n, 3))], axis=1),
        sh=0.1 * rng.normal(size=(n, 15, 3)),
    )
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    alive = np.ones(n, bool)
    cm = build_camera_matrices(np.array([1.0, 0, 0, 0]), np.zeros(3), w, h, w * 0.85, w * 0.85)
    st = t_step.StepStatics(
        width=w, height=h, tile=16, l_max=3, focal_x=cm.focal_x, focal_y=cm.focal_y,
        tan_fovx=cm.tan_fovx, tan_fovy=cm.tan_fovy, near_thresh=0.3, mh_dist=3.0,
        cull_padding=100, ssim_frac=0.2, base_lr=1e-3, xyz_lr_init=0.16,
        xyz_lr_final=0.0016, quat_lr=1.0, scale_lr=5.0, opacity_lr=25.0, rgb_lr=2.5,
        sh_lr=0.125, scene_extent=4.0, num_iters=7000,
    )
    gt = torch.from_numpy(rng.uniform(0, 1, (h, w, 3)).astype(np.float32))
    results = []
    for d in ("cpu", dev):
        state = t_state.init_state(t_state.params_from_jax(params, alive, d))
        with exact_mode():
            loss, _, mask, _, grads, g_uv = t_step.compute_loss_and_grads(
                state.params, cm.view, cm.proj, cm.campos, gt.to(d), 0.2, st)
        t_step.apply_adam(state, grads, g_uv, mask, 0, st)
        results.append((float(loss), {k: v.cpu() for k, v in grads.items()}, g_uv.cpu(),
                        t_state.state_to_numpy(state)))
    (l_c, g_c, uv_c, s_c), (l_g, g_g, uv_g, s_g) = results
    np.testing.assert_allclose(l_g, l_c, rtol=1e-5)
    # Kernels and plain versions sum in other orders: 1e-3 of each
    # tensor's largest value.
    for name in g_c:
        scale = float(g_c[name].nan_to_num().abs().max())
        torch.testing.assert_close(g_g[name], g_c[name], rtol=1e-3, atol=1e-3 * scale,
                                   equal_nan=True)
    torch.testing.assert_close(uv_g, uv_c, rtol=1e-3, atol=1e-3 * float(uv_c.abs().max()))
    np.testing.assert_array_equal(s_g["accum_dur"], s_c["accum_dur"])


def test_backward_kernels_with_no_pairs(dev):
    # An empty frame: nothing to replay or sum; every sum is zero.
    i32 = lambda n: torch.zeros((n,), dtype=torch.int32, device=dev)  # noqa: E731
    attrs = torch.zeros((5, 9), device=dev)
    out = torch.zeros((2, 5, 256), device=dev)
    rows = rasterize_backward(attrs, i32(0), i32(2), i32(2), out,
                              torch.ones((2, 3, 256), device=dev), 0.5,
                              num_tiles_x=2, num_tiles_y=1)
    sums = segment_sum(rows, i32(0), i32(6), 5)
    torch.cuda.synchronize()
    assert rows.shape == (0, 9)
    assert torch.equal(sums, torch.zeros((5, 9), device=dev))


def test_morton_permutation_equals_stable_sort(dev):
    # 2^20 codes, a fifth of them dead rows keyed to 0x7FFFFFFF: the
    # permutation of the morton call site equals torch.sort(stable=True)'s,
    # and the codes equal the CPU's.
    from gsplat_tpu_torch.ops.morton import KEY_BITS, morton_codes

    rng = np.random.default_rng(20)
    n = 1 << 20
    xyz = torch.from_numpy((rng.normal(size=(n, 3)) * [2.0, 1.4, 1.2] + [0, 0, 6.0])
                           .astype(np.float32))
    alive = torch.from_numpy(rng.uniform(size=n) < 0.8)
    codes = morton_codes(xyz.to(dev), alive.to(dev))
    before = _build.launches["radix_sort/morton"]
    keys, perm = radix_sort(codes, KEY_BITS, site="morton")
    torch.cuda.synchronize()
    assert _build.launches["radix_sort/morton"] == before + 1
    ref = torch.sort(codes, stable=True)
    assert torch.equal(keys, ref.values) and torch.equal(perm, ref.indices.to(torch.int32))
    assert torch.equal(codes.cpu(), morton_codes(xyz, alive))


def test_density_step_and_morton_sort_on_card_equal_cpu(dev):
    from gsplat_tpu_torch.train import density, state as t_state

    rng = np.random.default_rng(21)
    n = 3000
    params = dict(
        xyz=rng.normal(size=(n, 3)) * [1.0, 0.7, 0.6] + [0, 0, 4.0],
        rgb=rng.normal(size=(n, 3)), opacity=rng.uniform(-5.0, 2.0, n),
        scale=np.log(rng.choice([0.005, 0.03, 0.3], (n, 3))),
        quat=np.concatenate([np.ones((n, 1)), 0.3 * rng.normal(size=(n, 3))], axis=1),
        sh=0.1 * rng.normal(size=(n, 15, 3)),
    )
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    alive = np.arange(n) < 2000
    accum = rng.uniform(0, 0.3, n).astype(np.float32)
    noise = [torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)) for _ in range(2)]
    ds = density.DensityStatics(scene_extent=2.0, uv_grad_threshold=0.1,
                                delete_opacity_threshold=0.02, split_scale_factor=1.6,
                                max_gaussians=10_000)
    out = []
    for d in ("cpu", dev):
        state = t_state.init_state(t_state.params_from_jax(params, alive, d))
        state.uv_grad_accum.copy_(torch.from_numpy(accum))
        state.accum_dur.fill_(1)
        state, info = density.adaptive_density_step(state, ds, *(x.to(d) for x in noise))
        out.append((info, t_state.state_to_numpy(state)))
    (i_c, s_c), (i_g, s_g) = out
    assert i_g == i_c and i_c.applied and i_c.num_split > 0
    for f in ("alive", "uv_grad_accum", "accum_dur"):
        np.testing.assert_array_equal(s_g[f], s_c[f])
    for f in ("adam_m", "adam_v"):
        for k in s_c[f]:
            np.testing.assert_array_equal(s_g[f][k], s_c[f][k])
    for k in s_c["params"]:  # split children: rsqrt, exp and log, a few ulp
        a, b = s_g["params"][k], s_c["params"][k]
        tol = 4 * np.spacing(np.abs(b).max()) if k in ("xyz", "scale") else 0.0
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=k)
    # The re-sort of one state (the CPU's) on both devices: equal.
    sorted_ = [t_state.state_to_numpy(density.morton_sort(t_state.state_from_jax(**s_c, device=d)))
               for d in ("cpu", dev)]
    for f in ("alive", "uv_grad_accum", "accum_dur"):
        np.testing.assert_array_equal(sorted_[1][f], sorted_[0][f])
    for f in ("params", "adam_m", "adam_v"):
        for k in s_c[f]:
            np.testing.assert_array_equal(sorted_[1][f][k], sorted_[0][f][k])


@pytest.mark.parametrize("packed", [False, True])
def test_rasterizers_read_bg_from_device_memory(dev, packed):
    """K1 and K2 read the background from device memory: launched from a
    CUDA graph captured at one background and replayed after the tensor
    was refilled, each is bit-equal to a launch at the new background, and
    close to its plain version at it (the bounds of the tests above)."""
    args, out, d_tiles, ntx, nty = _backward_inputs(np.random.default_rng(9), 3000, 160, 88)
    kw = dict(num_tiles_x=ntx, packed=packed)
    dev_in = [t.to(dev) for t in args]
    out_d, d_d = out.to(dev), d_tiles.to(dev)
    bg = torch.full((), 0.3, dtype=torch.float32, device=dev)
    rasterize_forward(*dev_in, bg, **kw)  # built and warm outside the capture
    rasterize_backward(*dev_in, out_d, d_d, bg, num_tiles_y=nty, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fwd = rasterize_forward(*dev_in, bg, **kw)
        bwd = rasterize_backward(*dev_in, out_d, d_d, bg, num_tiles_y=nty, **kw)
    bg.fill_(0.75)
    graph.replay()
    new_bg = torch.full((), 0.75, dtype=torch.float32, device=dev)
    fwd_ref = rasterize_forward(*dev_in, new_bg, **kw)
    bwd_ref = rasterize_backward(*dev_in, out_d, d_d, new_bg, num_tiles_y=nty, **kw)
    torch.cuda.synchronize()
    assert torch.equal(fwd, fwd_ref) and torch.equal(bwd, bwd_ref)
    assert not torch.equal(fwd_ref, rasterize_forward(*dev_in, 0.3, **kw))
    plain = rasterize_forward_plain(*args, new_bg.cpu(), **kw)
    torch.testing.assert_close(fwd.cpu()[:, :3], plain[:, :3], rtol=0, atol=1e-4)
    rows = rasterize_backward_plain(*args, out, d_tiles, new_bg.cpu(), num_tiles_y=nty, **kw)
    scale = rows.abs().amax(dim=1, keepdim=True)
    assert ((bwd.cpu() - rows).abs() <= 1e-3 * scale + 1e-6).all()


def test_graph_replay_bit_equal_to_eager_capped_step(dev):
    """``get_train_step`` at a pair cap (a CUDA graph: an eager first call,
    a capture, replays) against ``train_step`` at the same cap, eagerly,
    from the same start over five steps and two cameras: losses, metrics
    and every tensor of the state bit-identical; the replays read no host
    memory and count the graph's launches."""
    import dataclasses

    from gsplat_tpu_torch.ops.camera import build_camera_matrices
    from gsplat_tpu_torch.train import state as t_state
    from gsplat_tpu_torch.train import step as t_step

    w, h, n = 96, 56, 2000
    rng = np.random.default_rng(5)
    params = dict(
        xyz=rng.normal(size=(n, 3)) * [1.0, 0.7, 0.6] + [0, 0, 4.0],
        rgb=rng.normal(size=(n, 3)), opacity=rng.uniform(-1.0, 2.0, n),
        scale=np.log(rng.uniform(0.02, 0.1, (n, 3))),
        quat=np.concatenate([np.ones((n, 1)), 0.3 * rng.normal(size=(n, 3))], axis=1),
        sh=0.1 * rng.normal(size=(n, 15, 3)),
    )
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    alive = np.ones(n, bool)
    cams = [build_camera_matrices(np.array(q), np.zeros(3), w, h, w * 0.85, w * 0.85)
            for q in ([1.0, 0, 0, 0], [0.999, 0.02, -0.03, 0.01])]
    st = t_step.StepStatics(
        width=w, height=h, tile=16, l_max=3, focal_x=cams[0].focal_x,
        focal_y=cams[0].focal_y, tan_fovx=cams[0].tan_fovx, tan_fovy=cams[0].tan_fovy,
        near_thresh=0.3, mh_dist=3.0, cull_padding=100, ssim_frac=0.2, base_lr=1e-3,
        xyz_lr_init=0.16, xyz_lr_final=0.0016, quat_lr=1.0, scale_lr=5.0, opacity_lr=25.0,
        rgb_lr=2.5, sh_lr=0.125, scene_extent=4.0, num_iters=7000, pair_cap=1 << 16,
    )
    gt = torch.from_numpy(rng.uniform(0, 1, (h, w, 3)).astype(np.float32)).to(dev)
    cam_t = [tuple(torch.as_tensor(x, device=dev) for x in (c.view, c.proj, c.campos))
             for c in cams]
    runs = []
    for graphed in (False, True):
        state = t_state.init_state(t_state.params_from_jax(params, alive, dev))
        step = t_step.get_train_step(dataclasses.replace(st, num_iters=7001))
        _build.reset_launches()
        out = []
        for it in range(5):
            args = (state, *cam_t[it % 2], gt, 0.1 * it, it)
            if not graphed:
                state, m = t_step.train_step(*args, dataclasses.replace(st, num_iters=7001))
            elif it >= 2:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    state, m = step(*args)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                state, m = step(*args)
            out.append(torch.stack([m.loss, m.psnr, m.num_visible.float(),
                                    m.num_pairs.float(), m.overflow.float(),
                                    m.row_overflow.float()]))
        torch.cuda.synchronize()
        runs.append((torch.stack(out).cpu(), t_state.state_to_numpy(state),
                     dict(_build.launches)))
        t_step.release_graphs()
    (m_e, s_e, l_e), (m_g, s_g, l_g) = runs
    assert torch.equal(m_e.view(torch.int32), m_g.view(torch.int32))
    for group in ("params", "adam_m", "adam_v"):
        for name in s_e[group]:
            np.testing.assert_array_equal(s_g[group][name], s_e[group][name])
    for name in ("alive", "uv_grad_accum", "accum_dur"):
        np.testing.assert_array_equal(s_g[name], s_e[name])
    assert l_g == l_e and l_g["radix_sort/tile"] == 5 and min(
        l_g[k] for k in l_g if k != "radix_sort/morton" and not k.endswith("/packed")) > 0
