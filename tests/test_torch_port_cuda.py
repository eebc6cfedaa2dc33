"""The CUDA correlation kernels against their plain PyTorch versions.

Needs an NVIDIA GPU with nvcc; skips without one. The file imports no
JAX so that it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_cuda.py -q

Tolerances are those of tests/test_pallas_corr.py: 1e-4 where the path
is f32 end to end, 2e-2 where the volume is rounded to bf16.
"""

import numpy as np
import pytest
import torch

from pvo_tpu_torch.vo.net import cuda_corr

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
