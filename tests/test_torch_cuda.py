"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one
(the ``cuda`` marker). This file imports neither JAX nor ``gsplat_tpu``, so
it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gsplat_tpu_torch.kernels import _build  # noqa: E402
from gsplat_tpu_torch.kernels.expand import segment_expand, segment_expand_plain  # noqa: E402
from gsplat_tpu_torch.kernels.rasterize import (  # noqa: E402
    rasterize_forward, rasterize_forward_plain,
)
from gsplat_tpu_torch.kernels.sort import radix_sort, radix_sort_plain  # noqa: E402
from gsplat_tpu_torch.ops.binning import build_tile_tables  # noqa: E402

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


@pytest.mark.parametrize("n", [1, 4095, 4097, 100_000, 1_000_000])
@pytest.mark.parametrize("key_bits", [5, 8, 13, 29])
def test_radix_sort_kernel_equals_plain(dev, n, key_bits):
    rng = np.random.default_rng(key_bits * 7 + n)
    keys = torch.from_numpy(rng.integers(0, 1 << key_bits, n).astype(np.int32))
    s_k, perm = radix_sort(keys.to(dev), key_bits)
    torch.cuda.synchronize()
    p_k, p_perm = radix_sort_plain(keys, key_bits)
    assert torch.equal(s_k.cpu(), p_k)
    assert torch.equal(perm.cpu(), p_perm)  # stable: the same permutation


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
