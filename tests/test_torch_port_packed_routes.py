"""What surrounds the packed kernels P1 and P2 and runs without a card:
the numpy model of P1's routing (``cuda_corr_exp.expected_routes``, which
the card tests hold the device counter to), the count of 32-byte sectors
an extraction touches (``kbench.touched_sectors``) with the second bound
it gives K2 and P2, the checks P1's wrapper makes before it launches, and
the plain P1 on f32 features against the JAX package's XLA lookup.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.vo.net.corr import corr_and_lookup
from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.vo.net import cuda_corr
from pvo_tpu_torch.vo.net import cuda_corr_exp as cx

H, W = 30, 101
TILES = 4 * 7          # 8 x 16 pixel tiles of a 30 x 101 map


def harness_coords(E, seed=0):
    """X1's coordinates: uniform over the image."""
    rng = np.random.RandomState(seed)
    return (rng.rand(E, H, W, 2) * np.array([W - 1, H - 1])).astype(
        np.float32)


def test_expected_routes_smooth_is_all_within_the_cap():
    for shape in ((2, 30, 101), (2, 47, 156), (3, 17, 45)):
        c = kbench.lookup_coords("smooth", *shape, seed=1)
        E, h, w = shape
        pairs = E * -(-h // 8) * -(-w // 16) * 4
        assert cx.expected_routes(c, h, w) == (pairs, 0)


def test_expected_routes_uniform_puts_level_0_above_the_cap():
    """Under uniform coordinates a tile's level-0 box is the whole 3030
    positions, above the cap of 1536; level 1 (15 x 50 = 750) and the
    levels above it fit whatever the coordinates."""
    E = 3
    within, above = cx.expected_routes(harness_coords(E), H, W)
    assert above == E * TILES and within == 3 * E * TILES
    # at 47x156 level 1 (23 x 78 = 1794) is above the cap too
    c = kbench.lookup_coords("scattered", 2, 47, 156, seed=2)
    assert cx.expected_routes(c, 47, 156) == (2 * 60 * 2, 2 * 60 * 2)


def test_expected_routes_mixed_takes_both_and_levels_are_counted():
    c = kbench.lookup_coords("mixed", 2, H, W, seed=3)
    within, above = cx.expected_routes(c, H, W)
    assert within + above == 2 * TILES * 4
    assert 0 < above < 2 * TILES
    assert cx.expected_routes(c, H, W, levels=2) == (2 * TILES * 2 - above,
                                                     above)


def test_expected_routes_nan_and_huge_coordinates_hold_no_tap():
    """A tile of NaN, infinite or huge coordinates has an empty box (np =
    0: within the cap); one finite pixel in it gives a box of one patch;
    NaN pixels among uniform ones change nothing above the cap."""
    c = np.full((1, H, W, 2), np.nan, np.float32)
    assert cx.expected_routes(c, H, W) == (TILES * 4, 0)
    for bad in (np.inf, -np.inf, 1e30, -1e30, 3e9):
        assert cx.expected_routes(np.full((1, H, W, 2), bad, np.float32),
                                  H, W) == (TILES * 4, 0)
    c = harness_coords(1)
    hit = np.random.RandomState(5).rand(1, H, W) < 0.3
    c[hit] = np.nan
    assert cx.expected_routes(c, H, W) == (3 * TILES, TILES)
    wild = kbench.lookup_coords("wild", 2, H, W, seed=4)
    assert cx.expected_routes(wild, H, W) == (2 * TILES * 4, 0)


def test_routing_constants_match_the_kernel_header():
    """``expected_routes`` models the kernel only while its tile and cap
    are those of ``csrc/corr_tc.cuh``."""
    src = (pathlib.Path(cx.__file__).parents[2] / "csrc" /
           "corr_tc.cuh").read_text()
    th, tw = map(int, re.search(
        r"constexpr int K3T_TH = (\d+), K3T_TW = (\d+)", src).groups())
    cap = int(re.search(r"constexpr int K3T_BOX_CAP = (\d+);", src).group(1))
    assert (th, tw) == tuple(cx.TILE)
    assert cap == cx.BOX_CAP


def test_expected_routes_box_arithmetic_on_a_hand_case():
    """One 8 x 16 tile whose patches span x in [10-3, 60+4] and y in
    [0, 8+4] at level 0: 58 x 13 = 754 positions, within the cap; moved
    apart to x in [7, 94], 88 x 30 = 2640 positions, above it."""
    c = np.zeros((1, 8, 16, 2), np.float32)
    c[..., 0], c[..., 1] = 10.5, 3.2
    c[0, 7, 15] = (60.2, 8.9)
    assert cx.expected_routes(c, 8, 16, levels=1) == (1, 0)   # box > level
    big = np.zeros((1, H, W, 2), np.float32)
    big[..., 0], big[..., 1] = 10.5, 3.2
    big[0, 7, 15] = (60.2, 8.9)
    # tile (0, 0) holds both pixels: (64 - 7 + 1) x (12 - 0 + 1) = 754
    assert cx.expected_routes(big, H, W, levels=1) == (TILES, 0)
    big[0, 7, 15] = (90.9, 26.0)   # x 7..94, y 0..29: 88 x 30 = 2640
    assert cx.expected_routes(big, H, W, levels=1) == (TILES - 1, 1)
    assert cx.BOX_CAP == 1536 and cx.TILE == (8, 16)


def brute_force_sectors(coords, h, w, levels):
    """Per pixel, the set of 16-value (32-byte) groups of its volume row
    that hold a tap inside a level."""
    total = 0
    for x, y in coords.reshape(-1, 2):
        seen, off = set(), 0
        for lvl in range(levels):
            hl, wl = h >> lvl, w >> lvl
            if np.isfinite(x) and np.isfinite(y) and abs(x) < 1e6 \
                    and abs(y) < 1e6:
                x0 = int(np.floor(np.float32(x) * np.float32(0.5 ** lvl)))
                y0 = int(np.floor(np.float32(y) * np.float32(0.5 ** lvl)))
                for dy in range(8):
                    for dx in range(8):
                        yy, xx = y0 - 3 + dy, x0 - 3 + dx
                        if 0 <= yy < hl and 0 <= xx < wl:
                            seen.add((off + yy * wl + xx) // 16)
            off += hl * wl
        total += len(seen)
    return total


@pytest.mark.parametrize("kind", ["smooth", "scattered", "wild", "band_x"])
@pytest.mark.parametrize("shape, levels", [((1, 12, 40), 4), ((2, 5, 7), 4),
                                           ((1, 9, 21), 2)])
def test_touched_sectors_matches_a_brute_force_count(kind, shape, levels):
    E, h, w = shape
    c = kbench.lookup_coords(kind, E, h, w, seed=7)
    assert kbench.touched_sectors(c, h, w, levels) == \
        brute_force_sectors(c, h, w, levels)


def test_touched_sectors_at_the_main_shape_and_far_outside():
    """At 30x101 a pixel's 32 patch rows lie in about 30 sectors (960
    bytes) where the taps themselves are 512 bytes; windows wholly
    outside the image touch nothing."""
    c = kbench.lookup_coords("smooth", 2, H, W, seed=1)
    per_pixel = kbench.touched_sectors(c, H, W) / (2 * H * W)
    assert 28.0 < per_pixel < 33.0
    assert kbench.touched_sectors(np.full((1, H, W, 2), -50.0), H, W) == 0
    assert kbench.touched_sectors(np.full((1, H, W, 2), np.nan), H, W) == 0


@pytest.mark.parametrize("name, E, out_bytes", [
    ("corr_extract", 48, 196 * 4), ("corr_extract_packed", 32, 256 * 2)])
def test_sector_bound_stands_beside_the_byte_bound(name, E, out_bytes):
    c = kbench.lookup_coords("smooth", E, H, W, seed=2)
    plain = kbench.kernel_bound(name, E, H, W)
    b = kbench.kernel_bound(name, E, H, W, coords=c)
    assert "sectors" not in plain and "sector_ms" not in plain
    assert {k: b[k] for k in plain} == plain        # nothing else moves
    assert b["sectors"] == kbench.touched_sectors(c, H, W)
    px = E * H * W
    assert b["sector_ms"] == pytest.approx(
        1e3 * (b["sectors"] * 32 + px * (8 + out_bytes)) / 3.35e12)
    assert b["sector_ms"] > b["bytes_ms"]
    # the lookups read features, not the volume: no sector figure
    assert "sectors" not in kbench.kernel_bound("corr_lookup_packed", E, H,
                                                W, coords=c)


def test_lookup_packed_refuses_f32_features_off_the_cpu():
    """P1's kernel is bf16 wgmma on a bf16 pyramid: f32 features, which
    the earlier kernel took and nothing held, raise TypeError before any
    launch (meta tensors stand in for the card's); the CPU's plain
    version goes on taking them."""
    f32 = torch.empty((2, 12, 40, 32), device="meta")
    coords = torch.empty((2, 12, 40, 2), device="meta")
    with pytest.raises(TypeError, match="bfloat16"):
        cx.corr_lookup_packed(f32, f32, coords)
    bf16 = f32.to(torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        cx.corr_lookup_packed(bf16, f32, coords)
    with pytest.raises(TypeError, match="pyr"):
        cx.corr_lookup_packed_pooled(
            bf16, torch.empty((2, 12 * 40 + 6 * 20 + 3 * 10 + 5, 32),
                              device="meta"), coords)
    narrow = torch.empty((2, 12, 40, 24), dtype=torch.bfloat16,
                         device="meta")
    with pytest.raises(ValueError, match="multiple of 16"):
        cx.corr_lookup_packed(narrow, narrow, coords)
    assert "bf16" in cx.corr_lookup_packed.__doc__


@pytest.mark.parametrize("kind", ["smooth", "mixed"])
def test_plain_lookup_packed_f32_features_match_the_jax_lookup(kind):
    """With f32 intermediates the packed window is the 7x7 bilinear window
    of the JAX package's lookup, tap (dy, dx) at channel dx*7 + dy there;
    on f32 features nothing rounds before the packed bf16 store."""
    E, h, w, C = 2, 12, 40, 32
    rng = np.random.RandomState(3)
    f1, f2 = (rng.randn(E, h, w, C).astype(np.float32) for _ in range(2))
    coords = kbench.lookup_coords(kind, E, h, w, seed=5)
    port = cx.corr_lookup_packed(torch.from_numpy(f1), torch.from_numpy(f2),
                                 torch.from_numpy(coords))
    want = np.array(corr_and_lookup(jnp.asarray(f1), jnp.asarray(f2),
                                     jnp.asarray(coords), 4, 3))
    got = port.float().numpy().reshape(E, h, w, 4, 8, 8)
    assert not got[..., 7, :].any() and not got[..., :, 7].any()
    win = got[..., :7, :7].swapaxes(-1, -2).reshape(E, h, w, 196)
    ref = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
    assert np.abs(win - ref).max() <= 2e-2
    assert np.mean(win == ref) >= 0.999
    assert np.abs(ref).max() > 0.1


def test_route_counter_counts_per_device_and_resets():
    counter = cuda_corr.RouteCounter()
    assert counter.read() == (0, 0)
    t = counter.tensor(torch.device("cpu"))
    assert t.dtype == torch.int64 and t.shape == (2,)
    t += torch.tensor([5, 2])
    assert counter.tensor(torch.device("cpu")) is t
    assert counter.read() == (5, 2)
    counter.reset()
    assert counter.read() == (0, 0)
    # K3's counter and P1's are apart
    assert cuda_corr._routes is not cx._routes
    assert cx.routes() == (0, 0) and cuda_corr.routes() == (0, 0)
