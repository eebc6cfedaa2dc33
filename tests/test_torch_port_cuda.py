"""The CUDA correlation kernels (K1-K3, and the packed-layout P1 and P2)
against their plain PyTorch versions.

Needs an NVIDIA GPU with nvcc; skips without one. The file imports no
JAX so that it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_cuda.py -q

Tolerances are those of tests/test_pallas_corr.py: 1e-4 where the path
is f32 end to end, 2e-2 where the volume is rounded to bf16; for the
packed bf16 outputs of P1 and P2, |d| <= 2e-2 + 8e-3 |ref| with at
least 99.9% of the outputs bit-equal. The tolerance alone cannot tell
one rounding variant from another: they differ by one bf16 ulp in
17-30% of the outputs, so every two variants must also differ in at
least 1% of them, or a variant's flag is dead.
"""

import numpy as np
import pytest
import torch

from pvo_tpu_torch.vo.net import cuda_corr
from pvo_tpu_torch.vo.net import cuda_corr_exp

pytestmark = pytest.mark.cuda

C = 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _inputs(E, H, W, dtype, dev, seed, lo=-2.0, bias_rows=None):
    rng = np.random.RandomState(seed)
    f1 = torch.tensor(rng.randn(E, H, W, C), dtype=torch.float32)
    f2 = torch.tensor(rng.randn(E, H, W, C), dtype=torch.float32)
    cx = rng.uniform(lo, W + 1.0, (E, H, W))
    cy = rng.uniform(lo, H + 1.0, (E, H, W))
    if bias_rows is not None:
        # half the rows straddle the border band (bias_rows = (lo, hi))
        cy[:, H // 2:] = rng.uniform(*bias_rows, (E, H - H // 2, W))
    coords = torch.tensor(np.stack([cx, cy], -1), dtype=torch.float32)
    return (f1.to(dev, dtype), f2.to(dev, dtype), coords.to(dev))


@pytest.mark.parametrize("E", [1, 24, 48])
def test_build_and_extract_match_plain(dev, E):
    f1, f2, coords = _inputs(E, 30, 101, torch.bfloat16, dev, seed=E)
    vol = cuda_corr.build_volumes(f1, f2)
    ref_vol = cuda_corr.build_volumes_plain(f1, f2)
    torch.cuda.synchronize()
    assert vol.shape == ref_vol.shape == (E, 3030, 3991)
    assert (vol.float() - ref_vol.float()).abs().max().item() <= 2e-2

    out = cuda_corr.corr_extract(ref_vol, coords)
    ref = cuda_corr.corr_extract_plain(ref_vol, coords)
    torch.cuda.synchronize()
    assert out.shape == (E, 30, 101, 196)
    assert (out - ref).abs().max().item() <= 1e-4


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


def test_launch_counts_and_checks(dev):
    f1, f2, coords = _inputs(1, 30, 101, torch.float32, dev, seed=4)
    cuda_corr.reset_launches()
    vol = cuda_corr.build_volumes(f1, f2)
    cuda_corr.corr_extract(vol, coords)
    cuda_corr.corr_lookup(f1, f2, coords)
    assert cuda_corr.LAUNCHES == {"build_volumes": 1, "corr_extract": 1,
                                  "corr_lookup": 1}
    with pytest.raises(TypeError):
        cuda_corr.corr_extract(vol.float(), coords)
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


def _packed_close(out, ref):
    a, b = out.float(), ref.float()
    assert ((a - b).abs() <= 2e-2 + 8e-3 * b.abs()).all()
    assert (a == b).float().mean().item() >= 0.999


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
    _packed_close(out, ref)


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
