"""The CUDA correlation kernels (K1-K3, and the packed-layout P1 and P2)
against their plain PyTorch versions.

Needs an NVIDIA GPU with nvcc; skips without one. The file imports no
JAX so that it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_cuda.py -q

Tolerances are those of tests/test_pallas_corr.py: 1e-4 where the path
is f32 end to end, 2e-2 where the volume is rounded to bf16. K1 forms
the plain version's products (on f32 features up to the 2^-22 that its
three TF32 passes drop) and sums them in another f32 order, so it must
also give >= 99.9% of entries bit-equal, every entry within one bf16
ulp (cuda_corr.within_one_ulp) and pad columns exactly 0. For the
packed bf16 outputs of P1 and P2, |d| <= 2e-2 + 8e-3 |ref| with at
least 99.9% of the outputs bit-equal. The tolerance alone cannot tell
one rounding variant from another: they differ by one bf16 ulp in
17-30% of the outputs, so every two variants must also differ in at
least 1% of them, or a variant's flag is dead.
"""

import numpy as np
import pytest
import torch

from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.utils.config import VOConfig
from pvo_tpu_torch.vo.net import cuda_corr
from pvo_tpu_torch.vo.net import cuda_corr_exp
from pvo_tpu_torch.vo.net.droidnet import DroidNet
from pvo_tpu_torch.vo.system import VOSystem

pytestmark = pytest.mark.cuda

C = 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _inputs(E, H, W, dtype, dev, seed, lo=-2.0, bias_rows=None, width=C):
    rng = np.random.RandomState(seed)
    f1 = torch.tensor(rng.randn(E, H, W, width), dtype=torch.float32)
    f2 = torch.tensor(rng.randn(E, H, W, width), dtype=torch.float32)
    cx = rng.uniform(lo, W + 1.0, (E, H, W))
    cy = rng.uniform(lo, H + 1.0, (E, H, W))
    if bias_rows is not None:
        # half the rows straddle the border band (bias_rows = (lo, hi))
        cy[:, H // 2:] = rng.uniform(*bias_rows, (E, H - H // 2, W))
    coords = torch.tensor(np.stack([cx, cy], -1), dtype=torch.float32)
    return (f1.to(dev, dtype), f2.to(dev, dtype), coords.to(dev))


def _k1_close(vol, ref, H, W):
    n2 = sum(h * w for h, w in cuda_corr.level_shapes(H, W))
    assert vol.shape == ref.shape == (vol.shape[0], H * W,
                                      cuda_corr.padded_n2(n2))
    err, equal, ulp_ok, pad = cuda_corr.volume_agreement(vol, ref, n2)
    assert err <= 2e-2 and equal >= 0.999 and ulp_ok and pad == 0.0, (
        err, equal, ulp_ok, pad)


@pytest.mark.parametrize("E", [1, 24, 48])
def test_build_and_extract_match_plain(dev, E):
    f1, f2, coords = _inputs(E, 30, 101, torch.bfloat16, dev, seed=E)
    vol = cuda_corr.build_volumes(f1, f2)
    ref_vol = cuda_corr.build_volumes_plain(f1, f2)
    torch.cuda.synchronize()
    assert vol.shape == ref_vol.shape == (E, 3030, 4032)
    _k1_close(vol, ref_vol, 30, 101)

    out = cuda_corr.corr_extract(ref_vol, coords)
    ref = cuda_corr.corr_extract_plain(ref_vol, coords)
    torch.cuda.synchronize()
    assert out.shape == (E, 30, 101, 196)
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("geom, dtype", [
    ((3, 17, 45), torch.bfloat16),   # ragged rows and column tiles
    ((2, 8, 12), torch.bfloat16),    # one tile, mostly padding
    ((2, 30, 101), torch.float32),   # f32 features: three TF32 passes
    ((3, 17, 45), torch.float32),
    ((2, 17, 45), torch.float32)])
def test_build_volumes_ragged_and_f32_match_plain(dev, geom, dtype):
    E, H, W = geom
    f1, f2, _ = _inputs(E, H, W, dtype, dev, seed=H + W)
    vol = cuda_corr.build_volumes(f1, f2)
    ref = cuda_corr.build_volumes_plain(f1, f2)
    torch.cuda.synchronize()
    _k1_close(vol, ref, H, W)


def test_build_volumes_pooled_is_the_kernel_alone(dev):
    f1, f2, _ = _inputs(2, 30, 101, torch.bfloat16, dev, seed=12)
    pyr = cuda_corr.pool_pyramid(f2, dtype=torch.bfloat16)
    cuda_corr.reset_launches()
    assert torch.equal(cuda_corr.build_volumes_pooled(f1, pyr),
                       cuda_corr.build_volumes(f1, f2))
    assert cuda_corr.LAUNCHES["build_volumes"] == 2
    with pytest.raises(TypeError):   # a bf16 kernel takes a bf16 pyramid
        cuda_corr.build_volumes_pooled(f1, pyr.float())
    with pytest.raises(ValueError):  # wgmma's k16 steps: C % 16 == 0
        cuda_corr.build_volumes(f1[..., :24].contiguous(),
                                f2[..., :24].contiguous())
    with pytest.raises(ValueError):  # f32: k8 steps, C % 8 == 0
        cuda_corr.build_volumes(f1[..., :20].float().contiguous(),
                                f2[..., :20].float().contiguous())


@pytest.mark.parametrize("geom", [(1, 30, 101), (24, 30, 101), (1, 47, 156),
                                  (1, 128, 40)])
def test_lookup_matches_plain(dev, geom):
    E, H, W = geom
    f1, f2, coords = _inputs(E, H, W, torch.float32, dev, seed=H + W,
                             bias_rows=(H - 8.0, H + 1.0))
    out = cuda_corr.corr_lookup(f1, f2, coords)
    ref = cuda_corr.corr_lookup_plain(f1, f2, coords)
    torch.cuda.synchronize()
    assert out.shape == (E, H, W, 196)
    assert (out - ref).abs().max().item() <= 1e-4


def test_lookup_bf16_features(dev):
    f1, f2, coords = _inputs(2, 30, 101, torch.bfloat16, dev, seed=3)
    out = cuda_corr.corr_lookup(f1, f2, coords)
    ref = cuda_corr.corr_lookup_plain(f1, f2, coords)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4


K3_SHAPES = [(1, 30, 101), (48, 30, 101), (256, 30, 101), (2, 47, 156),
             (2, 128, 40)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", kbench.LOOKUP_COORDS)
@pytest.mark.parametrize("geom", K3_SHAPES,
                         ids=lambda g: "x".join(map(str, g)))
def test_lookup_cases_match_plain_through_both_entries(dev, geom, kind,
                                                       dtype):
    """K3 within 1e-4 of plain (NaN where plain is NaN) on every kind of
    coordinates: bf16 features take bf16 products, f32 ones three TF32
    passes, both over the bounding box of a pixel tile or, where that is
    too large, per pixel; the indexed entry reads shuffled frames."""
    E, H, W = geom
    f1, f2, _ = _inputs(E, H, W, dtype, dev, seed=E + H)
    coords = torch.from_numpy(
        kbench.lookup_coords(kind, E, H, W, seed=W)).to(dev)
    cuda_corr.reset_routes()
    out = cuda_corr.corr_lookup(f1, f2, coords)
    ref = cuda_corr.corr_lookup_plain(f1, f2, coords)
    tc, simt = cuda_corr.routes()
    assert out.shape == (E, H, W, 196)
    assert kbench.lookup_err(out, ref) <= 1e-4
    assert tc > 0
    if kind in ("smooth", "wild"):
        assert simt == 0
    if kind == "mixed":   # neighbouring tiles on different routes
        assert simt > 0

    frames = torch.cat([f1, f2])
    pyr = cuda_corr.lookup_pyramid(frames)
    rng = np.random.RandomState(7)
    ii = torch.as_tensor(rng.permutation(E), device=dev)
    jj = torch.as_tensor(E + rng.permutation(E), device=dev)
    idx = cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj, coords)
    del out, ref
    # at E=256 the plain version's volumes are 16 GB: hold the indexed
    # entry against the gathered one, which is checked above
    idx_ref = (cuda_corr.corr_lookup_indexed_plain(frames, pyr, ii, jj,
                                                   coords)
               if E <= 48 else
               cuda_corr.corr_lookup(frames[ii], frames[jj], coords))
    torch.cuda.synchronize()
    assert kbench.lookup_err(idx, idx_ref) <= 1e-4


@pytest.mark.parametrize("width, levels", [(16, 4), (64, 2), (256, 4),
                                           (128, 1)])
def test_lookup_tensor_core_other_widths_and_levels(dev, width, levels):
    """The tensor-core kernel takes any C that is a multiple of 16 up to
    256 and 1 to 4 levels."""
    E, H, W = 3, 30, 101
    rng = np.random.RandomState(width)
    f1, f2 = (torch.tensor(rng.randn(E, H, W, width), dtype=torch.float32)
              .to(dev, torch.bfloat16) for _ in range(2))
    assert cuda_corr.lookup_dtype(f1) == torch.bfloat16
    for kind in ("smooth", "mixed"):
        coords = torch.from_numpy(
            kbench.lookup_coords(kind, E, H, W, seed=levels)).to(dev)
        cuda_corr.reset_routes()
        out = cuda_corr.corr_lookup(f1, f2, coords, levels)
        ref = cuda_corr.corr_lookup_plain(f1, f2, coords, levels)
        assert out.shape == (E, H, W, levels * 49)
        assert kbench.lookup_err(out, ref) <= 1e-4
        assert cuda_corr.routes()[0] > 0


@pytest.mark.parametrize("geom, width, dtype, levels", [
    ((3, 30, 101), 24, torch.float32, 4),
    ((3, 30, 101), 24, torch.bfloat16, 4),   # bf16, C % 16 != 0: f32 pyramid
    ((2, 30, 101), C, torch.float32, 1),
    ((2, 30, 101), C, torch.float32, 2),
    ((2, 30, 101), C, torch.float32, 3),
    ((2, 5, 7), C, torch.float32, 4),        # the last level pooled away
    ((3, 9, 3), 24, torch.float32, 4)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
@pytest.mark.parametrize("kind", ["smooth", "mixed"])
def test_lookup_f32_kernel_widths_levels_and_vanishing_levels(
        dev, geom, width, dtype, levels, kind):
    """K3's f32 kernel off the main path's shape, through both entries."""
    E, H, W = geom
    f1, f2, _ = _inputs(E, H, W, dtype, dev, seed=width + levels,
                        width=width)
    assert cuda_corr.lookup_dtype(f1) == torch.float32
    coords = torch.from_numpy(
        kbench.lookup_coords(kind, E, H, W, seed=levels)).to(dev)
    cuda_corr.reset_launches()
    out = cuda_corr.corr_lookup(f1, f2, coords, levels)
    ref = cuda_corr.corr_lookup_plain(f1, f2, coords, levels)
    assert out.shape == (E, H, W, levels * 49)
    assert kbench.lookup_err(out, ref) <= 1e-4
    frames = torch.cat([f1, f2])
    pyr = cuda_corr.lookup_pyramid(frames, levels)
    ii = torch.arange(E - 1, -1, -1, device=dev)
    jj = E + torch.arange(E, device=dev)
    idx = cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj, coords, levels)
    idx_ref = cuda_corr.corr_lookup_indexed_plain(frames, pyr, ii, jj,
                                                  coords, levels)
    assert kbench.lookup_err(idx, idx_ref) <= 1e-4
    assert cuda_corr.F32_LAUNCHES["corr_lookup"] == 2


@pytest.mark.parametrize("kind", ["smooth", "scattered"])
def test_lookup_indexed_at_the_wide_planners_step(dev, kind):
    """K3 bf16 through the indexed entry at the wide planner's step: E=48
    edges of 47x156 features (376x1248), their 2E frames gathered and
    pooled once, as ``PlannerProgram.lookup_operands`` gives them, within
    1e-4 of the plain version; its (block, level) pairs all counted
    (``cuda_corr.lookup_route_pairs``), on the tensor cores alone on
    smooth coordinates."""
    E, H, W = 48, 47, 156
    f1, f2, _ = _inputs(E, H, W, torch.bfloat16, dev, seed=E + W)
    frames = torch.cat([f1, f2])
    pyr = cuda_corr.lookup_pyramid(frames)
    fi = torch.arange(E, dtype=torch.int32, device=dev)
    coords = torch.from_numpy(
        kbench.lookup_coords(kind, E, H, W, seed=H)).to(dev)
    cuda_corr.reset_routes()
    cuda_corr.reset_launches()
    out = cuda_corr.corr_lookup_indexed(frames, pyr, fi, fi + E, coords)
    tc, simt = cuda_corr.routes()
    assert cuda_corr.LAUNCHES["corr_lookup"] == 1
    assert cuda_corr.F32_LAUNCHES["corr_lookup"] == 0
    assert tc + simt == cuda_corr.lookup_route_pairs(E, H, W, True)
    if kind == "smooth":
        assert simt == 0
    ref = cuda_corr.corr_lookup_indexed_plain(frames, pyr, fi, fi + E, coords)
    torch.cuda.synchronize()
    assert kbench.lookup_err(out, ref) <= 1e-4


def test_graph_time_with_the_l2_cleared(dev):
    """``kbench.graph_time_ms(flush=True)``: a copy of 16 MB, which fits
    the L2, takes at least 0.9 of the time its 32 MB need at the card's
    memory rate once the L2 is cleared before each call."""
    x = torch.randn(4 << 20, device=dev)
    y = torch.empty_like(x)
    ms = kbench.graph_time_ms(lambda: y.copy_(x), 20, flush=True)
    assert 0.9 * 2 * x.nbytes / kbench.HBM_BYTES_S * 1e3 <= ms


def test_route_counters_count_in_graph_replays(dev):
    """K3's route counters live outside a captured graph: each replay of
    a graph holding K3 launches adds their (block, level) pairs."""
    from pvo_tpu_torch.vo import graph_capture
    E, H, W = 2, 47, 156
    f1, f2, _ = _inputs(E, H, W, torch.bfloat16, dev, seed=5)
    frames = torch.cat([f1, f2])
    pyr = cuda_corr.lookup_pyramid(frames)
    fi = torch.arange(E, dtype=torch.int32, device=dev)
    coords = torch.from_numpy(
        kbench.lookup_coords("smooth", E, H, W)).to(dev)
    probe = f1[:1].float().contiguous()
    fgr = graph_capture.FrameGraph(dev)
    fgr.capture(lambda br: (
        cuda_corr.corr_lookup_indexed(frames, pyr, fi, fi + E, coords),
        cuda_corr.corr_lookup(probe, probe, coords[:1])))
    torch.cuda.synchronize()
    cuda_corr.reset_routes()
    for _ in range(3):
        fgr.replay()
    per = (cuda_corr.lookup_route_pairs(E, H, W, True) +
           cuda_corr.lookup_route_pairs(1, H, W, False))
    assert sum(cuda_corr.routes()) == 3 * per


def test_lookup_indexed_f32_indexes_in_the_kernel(dev):
    """f32 edges are indexed in the kernel: one launch, and no
    allocation but the output (a gather of frames would allocate)."""
    f1, f2, _ = _inputs(2, 47, 156, torch.float32, dev, seed=8)
    frames = torch.cat([f1, f2])
    pyr = cuda_corr.lookup_pyramid(frames)
    coords = torch.from_numpy(
        kbench.lookup_coords("smooth", 2, 47, 156)).to(dev)
    ii = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    jj = torch.tensor([2, 3], dtype=torch.int32, device=dev)
    cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj, coords)  # builds
    torch.cuda.synchronize()
    cuda_corr.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj, coords)
    peak = torch.cuda.max_memory_allocated() - before
    assert cuda_corr.LAUNCHES["corr_lookup"] == 1
    assert cuda_corr.F32_LAUNCHES["corr_lookup"] == 1
    # the allocator hands out a block up to 1 MiB larger than asked; one
    # frame's features are 3.7 MB here, its pyramid more
    assert peak < out.numel() * 4 + 2 ** 20
    ref = cuda_corr.corr_lookup(frames[ii.long()], frames[jj.long()], coords)
    assert torch.equal(out, ref)   # the same kernel on the same rows


def test_lookup_indexed_checks_and_counts(dev):
    f1, f2, coords = _inputs(3, 30, 101, torch.bfloat16, dev, seed=2)
    frames = torch.cat([f1, f2])
    pyr = cuda_corr.lookup_pyramid(frames)
    assert pyr.dtype == torch.bfloat16 and pyr.shape == (6, 3991, C)
    ii = torch.tensor([0, 1, 2], device=dev)
    jj = torch.tensor([3, 4, 5], device=dev)
    cuda_corr.reset_launches()
    out = cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj, coords)
    assert cuda_corr.LAUNCHES["corr_lookup"] == 1
    # the same kernel on the same rows: the same bits as the gathered entry
    assert torch.equal(out, cuda_corr.corr_lookup(f1, f2, coords))
    with pytest.raises(TypeError):   # bf16 features take a bf16 pyramid
        cuda_corr.corr_lookup_indexed(frames, pyr.float(), ii, jj, coords)
    with pytest.raises(ValueError):  # one index per edge
        cuda_corr.corr_lookup_indexed(frames, pyr, ii[:2], jj, coords)
    # C not a multiple of 16: the f32 kernel on an f32 pyramid, with
    # the edges indexed in the kernel and its blocks counted by route
    g1, g2 = f1[..., :24].contiguous(), f2[..., :24].contiguous()
    assert cuda_corr.lookup_pyramid(g2).dtype == torch.float32
    cuda_corr.reset_routes()
    cuda_corr.reset_launches()
    err = kbench.lookup_err(cuda_corr.corr_lookup(g1, g2, coords),
                            cuda_corr.corr_lookup_plain(g1, g2, coords))
    assert err <= 1e-4 and sum(cuda_corr.routes()) > 0
    gframes = torch.cat([g1, g2])
    out = cuda_corr.corr_lookup_indexed(
        gframes, cuda_corr.lookup_pyramid(gframes), ii, jj, coords)
    assert torch.equal(out, cuda_corr.corr_lookup(g1, g2, coords))
    assert cuda_corr.F32_LAUNCHES["corr_lookup"] == 3
    with pytest.raises(ValueError):  # three TF32 passes: C % 8 == 0
        cuda_corr.corr_lookup(f1[..., :20].float().contiguous(),
                              f2[..., :20].float().contiguous(), coords)


def test_extract_equals_the_replaced_kernel_on_the_saved_case(dev):
    """K2's redesign changed loads and stores, not one bit of the blend:
    the sha256 of its output on the saved case is the replaced
    kernel's."""
    vol, coords = (t.to(dev) for t in kbench.saved_extract_case())
    out = cuda_corr.corr_extract(vol, coords)
    assert kbench.fingerprint(out) == kbench.SAVED_EXTRACT_SHA256
    ref = cuda_corr.corr_extract_plain(vol, coords)
    assert (out - ref).abs().max().item() <= 2e-2


@pytest.mark.parametrize("n_pix_edges, levels", [(1, 3), (3, 2), (2, 1)])
def test_extract_ragged_blocks_and_fewer_levels(dev, n_pix_edges, levels):
    """Pixel counts that leave K2's last block partly empty (5 x 7
    features) and level counts whose output rows are no multiple of 16
    bytes."""
    E, H, W = n_pix_edges, 5, 7
    f1, f2, coords = _inputs(E, H, W, torch.bfloat16, dev, seed=levels)
    vol = cuda_corr.build_volumes_plain(f1, f2, levels)
    out = cuda_corr.corr_extract(vol, coords, levels)
    ref = cuda_corr.corr_extract_plain(vol, coords, levels)
    torch.cuda.synchronize()
    assert out.shape == (E, H, W, levels * 49)
    assert (out - ref).abs().max().item() <= 1e-4


def test_launch_counts_and_checks(dev):
    f1, f2, coords = _inputs(1, 30, 101, torch.float32, dev, seed=4)
    cuda_corr.reset_launches()
    vol = cuda_corr.build_volumes(f1, f2)
    cuda_corr.corr_extract(vol, coords)
    cuda_corr.corr_lookup(f1, f2, coords)
    assert cuda_corr.LAUNCHES == {"build_volumes": 1, "corr_extract": 1,
                                  "corr_lookup": 1}
    # f32 features: both were the f32 kernels
    assert cuda_corr.F32_LAUNCHES == {"build_volumes": 1, "corr_lookup": 1}
    frames = torch.cat([f1, f2])
    idx = cuda_corr.corr_lookup_indexed(
        frames, cuda_corr.lookup_pyramid(frames), torch.tensor([0], device=dev),
        torch.tensor([1], device=dev), coords)
    assert cuda_corr.LAUNCHES["corr_lookup"] == 2
    assert torch.equal(idx, cuda_corr.corr_lookup(f1, f2, coords))
    cuda_corr.reset_launches()
    assert not any(cuda_corr.F32_LAUNCHES.values())
    with pytest.raises(TypeError):
        cuda_corr.corr_extract(vol.float(), coords)
    with pytest.raises(ValueError):  # K1's layout only: row stride N2p
        cuda_corr.corr_extract(vol[..., :3991].contiguous(), coords)
    with pytest.raises(ValueError):
        cuda_corr.corr_lookup(f1, f2[:, :, :50], coords)


def test_bf16_pyramid_is_rounded_level_by_level(dev):
    _, f2, _ = _inputs(2, 30, 101, torch.bfloat16, dev, seed=5)
    pyr = cuda_corr.pool_pyramid(f2)
    assert torch.equal(pyr, pyr.bfloat16().float())
    # level 1 is the bf16 rounding of level 0's 2x2 means
    lvl1 = f2.float()[:, :30, :100].reshape(2, 15, 2, 50, 2, C).mean((2, 4))
    assert torch.equal(pyr[:, 3030:3030 + 750],
                       lvl1.bfloat16().float().reshape(2, 750, C))


def _packed_close(out, ref, equal_share=0.999):
    a, b = out.float(), ref.float()
    both_nan = a.isnan() & b.isnan()
    assert (a.isnan() == b.isnan()).all()
    # the positive form: a NaN on one side only is not within the tolerance
    assert (((a - b).abs() <= 2e-2 + 8e-3 * b.abs()) | both_nan).all()
    assert ((a == b) | both_nan).float().mean().item() >= equal_share


def _distinct(outs):
    for i in range(len(outs)):
        for j in range(i):
            assert (outs[i] != outs[j]).float().mean().item() >= 0.01, (i, j)


@pytest.mark.parametrize("order", cuda_corr_exp.ORDERS)
@pytest.mark.parametrize("seldt", cuda_corr_exp.SELDT)
@pytest.mark.parametrize("E", [2, 64])
def test_lookup_packed_matches_plain(dev, E, order, seldt):
    f1, f2, coords = _inputs(E, 30, 101, torch.bfloat16, dev, seed=E,
                             bias_rows=(25.0, 33.0))
    out = cuda_corr_exp.corr_lookup_packed(f1, f2, coords, order=order,
                                           seldt=seldt)
    ref = cuda_corr_exp.corr_lookup_packed_plain(f1, f2, coords,
                                                 order=order, seldt=seldt)
    torch.cuda.synchronize()
    assert out.shape == (E, 30, 101, 256) and out.dtype == torch.bfloat16
    _packed_close(out, ref)


@pytest.mark.parametrize("order", cuda_corr_exp.ORDERS)
@pytest.mark.parametrize("seldt", cuda_corr_exp.SELDT)
@pytest.mark.parametrize("geom, kind", [
    ((64, 30, 101), "smooth"), ((2, 47, 156), "smooth"),
    ((64, 30, 101), "scattered"), ((2, 30, 101), "mixed"),
    ((2, 30, 101), "wild"), ((3, 17, 45), "smooth"),
    ((3, 17, 45), "scattered"),
    ((2, 5, 7), "smooth"),            # the last level pooled away
    ((2, 5, 7), "scattered")],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_lookup_packed_coords_shapes_and_routes(dev, geom, kind, order,
                                                seldt):
    """P1 (bf16 wgmma products over a tile's bounding box) against plain
    on every kind of coordinates, off the harness's shape too; the
    device's count of (block, level) pairs within and above the box cap
    is the numpy model's: none above on smooth coordinates, both kinds
    on scattered and mixed ones at 30x101."""
    E, H, W = geom
    f1, f2, _ = _inputs(E, H, W, torch.bfloat16, dev, seed=E + H)
    coords = torch.from_numpy(
        kbench.lookup_coords(kind, E, H, W, seed=W)).to(dev)
    cuda_corr_exp.reset_routes()
    out = cuda_corr_exp.corr_lookup_packed(f1, f2, coords, order=order,
                                           seldt=seldt)
    ref = cuda_corr_exp.corr_lookup_packed_plain(f1, f2, coords,
                                                 order=order, seldt=seldt)
    routes = cuda_corr_exp.routes()
    assert out.shape == (E, H, W, 256) and out.dtype == torch.bfloat16
    _packed_close(out, ref)
    assert routes == cuda_corr_exp.expected_routes(coords.cpu().numpy(), H, W)
    assert sum(routes) == E * -(-H // 8) * -(-W // 16) * 4
    if kind in ("smooth", "wild"):
        assert routes[1] == 0
    if (H, W) == (30, 101) and kind in ("scattered", "mixed"):
        assert routes[0] > 0 and routes[1] > 0


def test_lookup_packed_pooled_is_the_kernel_alone_and_checks(dev):
    """The pooled entry is the wrapper without its pooling; f32 features
    and widths the bf16 wgmma cannot take are refused on the card."""
    f1, f2, coords = _inputs(2, 30, 101, torch.bfloat16, dev, seed=11)
    pyr = cuda_corr.pool_pyramid(f2, dtype=torch.bfloat16)
    cuda_corr_exp.reset_launches()
    for kw in ({}, {"order": "dy", "seldt": "bf16"}):
        assert torch.equal(
            cuda_corr_exp.corr_lookup_packed_pooled(f1, pyr, coords, **kw),
            cuda_corr_exp.corr_lookup_packed(f1, f2, coords, **kw))
    assert cuda_corr_exp.LAUNCHES["corr_lookup_packed"] == 4
    with pytest.raises(TypeError):   # bf16 products only
        cuda_corr_exp.corr_lookup_packed(f1.float(), f2.float(), coords)
    with pytest.raises(TypeError):   # a bf16 pyramid
        cuda_corr_exp.corr_lookup_packed_pooled(f1, pyr.float(), coords)
    with pytest.raises(ValueError):  # wgmma's k16 steps: C % 16 == 0
        cuda_corr_exp.corr_lookup_packed(f1[..., :24].contiguous(),
                                         f2[..., :24].contiguous(), coords)
    # another width and fewer levels
    g1, g2 = f1[..., :48].contiguous(), f2[..., :48].contiguous()
    for levels in (1, 3):
        _packed_close(
            cuda_corr_exp.corr_lookup_packed(g1, g2, coords, levels),
            cuda_corr_exp.corr_lookup_packed_plain(g1, g2, coords, levels))


def test_extract_packed_equals_the_replaced_kernel_on_the_saved_case(dev):
    """P2's redesign changed its loads, not one bit of its output: the
    sha256 on the saved case is the replaced kernel's."""
    vol, coords = (t.to(dev) for t in kbench.saved_extract_case())
    out = cuda_corr_exp.corr_extract_packed(vol, coords)
    assert kbench.fingerprint(out) == kbench.SAVED_EXTRACT_PACKED_SHA256
    assert torch.equal(
        out, cuda_corr_exp.corr_extract_packed_plain(vol, coords))


@pytest.mark.parametrize("geom, levels", [((1, 5, 7), 3), ((3, 5, 7), 2),
                                          ((3, 17, 45), 4)])
def test_extract_packed_ragged_blocks_and_fewer_levels(dev, geom, levels):
    """Pixel counts that leave P2's last block partly empty."""
    E, H, W = geom
    f1, f2, coords = _inputs(E, H, W, torch.bfloat16, dev, seed=levels)
    vol = cuda_corr.build_volumes_plain(f1, f2, levels)
    out = cuda_corr_exp.corr_extract_packed(vol, coords, levels)
    ref = cuda_corr_exp.corr_extract_packed_plain(vol, coords, levels)
    assert out.shape == (E, H, W, levels * 64)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("kw", [
    {}, {"weights": "bf16"}, {"weights": "round", "round_mid": True},
    {"weights": "bf16", "round_mid": True}, {"mode": "nostore"},
    {"mode": "novab"}, {"mode": "dma"}], ids=lambda kw: repr(kw))
@pytest.mark.parametrize("E", [2, 32])
def test_extract_packed_matches_plain(dev, E, kw):
    f1, f2, coords = _inputs(E, 30, 101, torch.bfloat16, dev, seed=E + 1,
                             bias_rows=(25.0, 33.0))
    vol = cuda_corr.build_volumes(f1, f2)
    out = cuda_corr_exp.corr_extract_packed(vol, coords, **kw)
    ref = cuda_corr_exp.corr_extract_packed_plain(vol, coords, **kw)
    torch.cuda.synchronize()
    assert out.shape == (E, 30, 101, 256) and out.dtype == torch.bfloat16
    _packed_close(out, ref, equal_share=1.0)


def test_packed_variants_differ(dev):
    f1, f2, coords = _inputs(2, 30, 101, torch.bfloat16, dev, seed=9)
    _distinct([cuda_corr_exp.corr_lookup_packed(f1, f2, coords, order=o,
                                                seldt=s)
               for o in cuda_corr_exp.ORDERS for s in cuda_corr_exp.SELDT])
    vol = cuda_corr.build_volumes(f1, f2)
    _distinct([cuda_corr_exp.corr_extract_packed(vol, coords, weights=w,
                                                 round_mid=mid)
               for w, mid in cuda_corr_exp.X2_VARIANTS.values()] +
              [cuda_corr_exp.corr_extract_packed(vol, coords, mode=m)
               for m in cuda_corr_exp.MODES[1:]])


def test_packed_launch_counts_and_checks(dev):
    f1, f2, coords = _inputs(1, 30, 101, torch.bfloat16, dev, seed=6)
    vol = cuda_corr.build_volumes(f1, f2)
    cuda_corr_exp.reset_launches()
    cuda_corr_exp.corr_lookup_packed(f1, f2, coords)
    cuda_corr_exp.corr_extract_packed(vol, coords, mode="dma")
    assert cuda_corr_exp.LAUNCHES == {"corr_lookup_packed": 1,
                                      "corr_extract_packed": 1}
    with pytest.raises(TypeError):
        cuda_corr_exp.corr_extract_packed(vol.float(), coords)
    with pytest.raises(ValueError):
        cuda_corr_exp.corr_lookup_packed(f1, f2[:, :, :50], coords)


def _tamed_net():
    """Random weights with the flow and mask heads' last convs scaled by
    0.01 (chip_smoke.tame_net): unscaled, the recurrence is chaotic."""
    net = DroidNet.from_seed(0)
    with torch.no_grad():
        for head in ("delta", "delta_dy", "delta_mask"):
            for p in getattr(net.update, head)[2].parameters():
                p.mul_(0.01)
    return net


@pytest.mark.parametrize("image, cached", [
    ((240, 808), True),     # 30x101 features: every level <= 120 a side
    ((376, 1248), False),   # vkitti2 at full size, 47x156: W > 120
    ((1024, 320), False)])  # 128x40: H > 120
def test_update_caches_volume_only_for_narrow_streams(dev, image, cached):
    """As the JAX accelerator path (pvo_tpu/vo/factor_graph.py): K1 once
    per update call and K2 per step where every level fits one tile,
    else K3 per step and no volume."""
    H, W = image
    assert cuda_corr.volume_cache_ok(H // 8, W // 8) == cached
    net = _tamed_net()
    cfg = VOConfig(image_size=image, buffer=64, warmup=5, filter_thresh=-1.0,
                   keyframe_thresh=0.0, max_edges=48, frontend_window=8)
    sysm = VOSystem(cfg, net=net, device="cuda")
    rng = np.random.RandomState(0)
    base = rng.randint(0, 255, (H + 16, W + 16, 3), np.uint8)
    intr = np.array([W / 1.7, W / 1.7, W / 2.0, H / 2.0], np.float32)
    for t in range(7):
        sysm.track(t, base[t:t + H, 2 * t:2 * t + W], intr)
    graph = sysm.frontend.graph
    assert graph.n_edges > 0
    cuda_corr.reset_launches()
    with torch.no_grad():
        graph.update(steps=2)
    torch.cuda.synchronize()
    assert cuda_corr.LAUNCHES == (
        {"build_volumes": 1, "corr_extract": 2, "corr_lookup": 0} if cached
        else {"build_volumes": 0, "corr_extract": 0, "corr_lookup": 2})


def test_build_volumes_f32_at_the_export_shape(dev):
    """f32 features into K1 at the narrow export's shape (E=2, 30x101),
    through the wrapper and on a pooled pyramid: three TF32 passes into
    the bf16 volume, held like the bf16 kernel (every entry within one
    bf16 ulp of plain, >= 99.9% bit-equal, pad columns 0)."""
    f1, f2, _ = _inputs(2, 30, 101, torch.float32, dev, seed=31)
    ref = cuda_corr.build_volumes_plain(f1, f2)
    cuda_corr.reset_launches()
    vol = cuda_corr.build_volumes(f1, f2)
    torch.cuda.synchronize()
    assert cuda_corr.F32_LAUNCHES["build_volumes"] == 1
    assert vol.dtype == torch.bfloat16 and vol.shape == (2, 3030, 4032)
    _k1_close(vol, ref, 30, 101)
    assert cuda_corr.within_one_ulp(vol, ref).all()
    pyr = cuda_corr.pool_pyramid(f2, dtype=torch.float32)
    assert torch.equal(cuda_corr.build_volumes_pooled(f1, pyr), vol)


def _export_window(size, seed=0):
    from pvo_tpu_torch.scripts.bench_vo2_export import bench_inputs
    images, poses, intr8 = bench_inputs(size, seed)
    dev = torch.device("cuda")
    return (torch.from_numpy(poses)[None].to(dev),
            torch.from_numpy(images)[None].to(dev),
            torch.ones((1, 2, size[0] // 8, size[1] // 8), device=dev),
            torch.from_numpy(np.tile(intr8, (1, 2, 1))).to(dev))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("size, cached", [((240, 808), True),
                                          ((376, 1248), False)],
                         ids=["30x101", "47x156"])
def test_forward_routes_and_launch_counts(dev, size, cached, bf16):
    """DroidNet.forward on a 2-frame window: K1 once and K2 per step at
    30x101, K3 per step and no volume at 47x156, for f32 features (the
    export's) and under ``compute_dtype=bf16`` (K1's and K3's
    bf16 kernels); K3 counts (block, level) pairs either way."""
    iters = 3
    net = _tamed_net().to(dev).eval()
    kw = {}
    if bf16:
        net = net.to(torch.bfloat16)
        kw["compute_dtype"] = torch.bfloat16
    cuda_corr.reset_launches()
    cuda_corr.reset_routes()
    with torch.no_grad():
        out = net(*_export_window(size), [0, 1], [1, 0], num_steps=iters,
                  ret_flow=True, downsample=True, final_only=True, **kw)
    torch.cuda.synchronize()
    assert cuda_corr.LAUNCHES == (
        {"build_volumes": 1, "corr_extract": iters, "corr_lookup": 0}
        if cached else
        {"build_volumes": 0, "corr_extract": 0, "corr_lookup": iters})
    assert (sum(cuda_corr.routes()) > 0) == (not cached)
    assert cuda_corr.F32_LAUNCHES == (
        {"build_volumes": 0, "corr_lookup": 0} if bf16 else
        {k: cuda_corr.LAUNCHES[k] for k in cuda_corr.F32_KERNELS})
    H, W = size
    assert out["disps_up"][-1].shape == (1, 2, H, W)
    assert out["flows"][-1].shape == (1, 2, H // 8, W // 8, 2)
    for k in ("disps_up", "flows", "masks_up", "residuals"):
        assert out[k][-1].dtype == torch.float32
        assert torch.isfinite(out[k][-1]).all()


def test_forward_plain_corr_launches_nothing(dev):
    net = _tamed_net().to(dev).eval()
    cuda_corr.reset_launches()
    with torch.no_grad():
        net(*_export_window((64, 96)), [0, 1], [1, 0], num_steps=2,
            corr_impl="plain")
    assert not any(cuda_corr.LAUNCHES.values())
