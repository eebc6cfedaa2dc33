"""The f32 route of the port's correlation kernels, held on the CPU, and
two repairs of what the port dropped without a word (the second now
holds the affine-brightness head, ported with VO training).

K1 and K3 hand f32 features to the tensor cores in two TF32 parts each
(``cuda_corr.tf32_split``) and form a product in three passes. The
tolerance argument behind that choice is held here with TF32 rounding
emulated by integer masking: three passes stay within 1e-6 of an exact
correlation at C=128 (the f32 path is held to 1e-4), one pass does not
stay within 1e-4. The plain versions that the kernels are held against
on the card are held here against the JAX package (1e-4: f32 math in
another summation order), on f32 features, through the indexed entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.vo.net import corr as jcorr
from pvo_tpu.vo.net.pallas_corr import pallas_corr_lookup
from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.utils import convert
from pvo_tpu_torch.utils.config import VOConfig
from pvo_tpu_torch.vo.net import cuda_corr
from pvo_tpu_torch.vo.net.droidnet import DroidNet
from pvo_tpu_torch.vo.system import VOSystem


def features(rows, C, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(rows, C).astype(np.float32))


def test_tf32_round_is_nearest_on_ten_mantissa_bits():
    x = features(64, 128, 0)
    r = cuda_corr.tf32_round(x)
    assert r.dtype == torch.float32 and r.shape == x.shape
    assert not (r.view(torch.int32) & 0x1FFF).any()
    # nearest: within half a TF32 ulp (2^-11 relative), sign kept
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert torch.equal(torch.sign(r), torch.sign(x))
    # values that TF32 holds exactly stay; a tie rounds away from zero
    exact = torch.tensor([1.0, -0.375, 1.0 + 2.0 ** -10, 0.0])
    assert torch.equal(cuda_corr.tf32_round(exact), exact)
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(cuda_corr.tf32_round(tie),
                       torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]))


def test_tf32_split_parts_are_tf32_and_leave_2_to_minus_23():
    x = features(64, 128, 1)
    hi, lo = cuda_corr.tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((x.double() - hi.double() - lo.double()).abs()
            <= x.abs().double() * 2.0 ** -22).all()
    assert (lo.abs() <= x.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("seed", [2, 3])
def test_three_tf32_passes_hold_1e6_and_one_pass_breaks_1e4(seed):
    """Unit-variance features at C=128, correlation = dot / 16, against
    the f64 product. The passes are summed in f64 here, so that what is
    measured is the split (the dropped lo.lo term and the parts'
    rounding) and not an f32 summation order."""
    a, b = features(256, 128, seed), features(512, 128, seed + 10)
    exact = a.double() @ b.double().T / 16.0
    (ah, al), (bh, bl) = (tuple(p.double() for p in cuda_corr.tf32_split(t))
                          for t in (a, b))
    three = (al @ bh.T + ah @ bl.T + ah @ bh.T) / 16.0
    one = ah @ bh.T / 16.0
    assert (three - exact).abs().max().item() <= 1e-6
    assert (one - exact).abs().max().item() > 1e-4
    # the same through the plain function, in f32: its own summation
    # order adds the f32 product's error (about 1e-6 at C=128)
    plain = cuda_corr.tf32_matmul_plain(a, b) / 16.0
    assert (plain.double() - exact).abs().max().item() <= 4e-6
    assert (cuda_corr.tf32_matmul_plain(a, b, passes=1).double() / 16.0
            - exact).abs().max().item() > 1e-4
    with pytest.raises(ValueError):
        cuda_corr.tf32_matmul_plain(a, b, passes=2)


def test_one_tf32_pass_would_flip_bf16_volume_entries():
    """K1 rounds the correlation to bf16: with three passes nearly every
    entry is the plain version's, with one pass a large share is not."""
    a, b = features(128, 128, 4), features(1024, 128, 5)
    ref = ((a * cuda_corr.SCALE) @ b.T).bfloat16()
    three = (cuda_corr.tf32_matmul_plain(a, b) * cuda_corr.SCALE).bfloat16()
    one = (cuda_corr.tf32_matmul_plain(a, b, 1) * cuda_corr.SCALE).bfloat16()
    assert (three == ref).float().mean().item() >= 0.999
    assert cuda_corr.within_one_ulp(three, ref).all()
    assert (one == ref).float().mean().item() < 0.95


def frames_and_edges(F, H, W, C, seed):
    rng = np.random.RandomState(seed)
    fm = rng.randn(F, H, W, C).astype(np.float32)
    ii = np.array([0, 1, 2, 3, 1, 0], np.int64) % F
    jj = np.array([1, 2, 3, 0, 3, 2], np.int64) % F
    return fm, ii, jj


@pytest.mark.parametrize("kind", ["smooth", "mixed", "band_x"])
def test_indexed_plain_f32_matches_pallas_fused_and_xla(kind):
    F, H, W, C = 4, 16, 24, 128
    fm, ii, jj = frames_and_edges(F, H, W, C, 31)
    coords = kbench.lookup_coords(kind, len(ii), H, W, seed=6)
    T = torch.from_numpy
    out = cuda_corr.corr_lookup_indexed(
        T(fm), cuda_corr.lookup_pyramid(T(fm)), T(ii), T(jj), T(coords))
    assert out.shape == (len(ii), H, W, 196) and out.dtype == torch.float32
    fj = jnp.asarray(fm)
    ref = pallas_corr_lookup(fj[ii], fj[jj], jnp.asarray(coords),
                             num_levels=4, blk=64, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    xla = jcorr.corr_and_lookup(fj[ii], fj[jj], jnp.asarray(coords))
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("hw", [(5, 7), (9, 3)])
def test_indexed_plain_f32_on_a_level_pooled_away(hw):
    """Features under 8 a side: the last level has no pixel and its 49
    channels are 0, as in the JAX lookup; the indexed plain version takes
    the geometry and equals the gathered one."""
    H, W = hw
    fm, ii, jj = frames_and_edges(4, H, W, 16, 32)
    coords = kbench.lookup_coords("scattered", len(ii), H, W, seed=7)
    T = torch.from_numpy
    pyr = cuda_corr.lookup_pyramid(T(fm))
    assert cuda_corr.level_shapes(H, W)[-1][0] * \
        cuda_corr.level_shapes(H, W)[-1][1] == 0
    out = cuda_corr.corr_lookup_indexed(T(fm), pyr, T(ii), T(jj), T(coords))
    assert torch.equal(out, cuda_corr.corr_lookup(T(fm)[T(ii)], T(fm)[T(jj)],
                                                  T(coords)))
    assert not out[..., 147:].any() and out[..., :49].any()
    fj = jnp.asarray(fm)
    xla = jcorr.corr_and_lookup(fj[ii], fj[jj], jnp.asarray(coords))
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), rtol=1e-4,
                               atol=1e-4)


def test_indexed_plain_f32_tap_order_is_dx_major():
    """Integer coordinates on the grid: channel l*49 + dx*7 + dy of edge
    (i, j) is f_i(y, x) . f_j(y + dy - 3, x + dx - 3) / 16 at level 0."""
    F, H, W, C = 3, 10, 12, 8
    fm, _, _ = frames_and_edges(F, H, W, C, 33)
    ii, jj = np.array([2, 0]), np.array([1, 2])
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    coords = np.broadcast_to(np.stack([xx, yy], -1)[None],
                             (2, H, W, 2)).astype(np.float32).copy()
    T = torch.from_numpy
    out = cuda_corr.corr_lookup_indexed(
        T(fm), cuda_corr.lookup_pyramid(T(fm)), T(ii), T(jj),
        T(coords)).numpy()
    y, x, dx, dy = 5, 6, 1, 5
    for e in range(2):
        ref = fm[ii[e], y, x] @ fm[jj[e], y + dy - 3, x + dx - 3] / 16.0
        np.testing.assert_allclose(out[e, y, x, dx * 7 + dy], ref, rtol=1e-5)
    assert out[0, 0, 0, 0] == 0.0   # out-of-bounds taps are zero


def test_f32_kernels_state_the_widths_they_take():
    cuda_corr.check_f32_width(128)
    cuda_corr.check_f32_width(24)
    for C in (20, 136, 256):
        with pytest.raises(ValueError):
            cuda_corr.check_f32_width(C)


# ---- what the port dropped without a word

def test_vosystem_raises_on_use_aff_bri():
    """``use_aff_bri`` builds the update operator's affine-brightness
    head (it was refused before the head was ported); weights without
    the head are refused for such a configuration, not run without it."""
    s = VOSystem(VOConfig(image_size=(64, 96), buffer=8, use_aff_bri=True),
                 device="cpu")
    assert s.net.use_aff_bri and s.update.use_aff_bri
    assert s.net.update.param_linear[0].weight.shape == (2, 128)
    with pytest.raises(ValueError, match="affine-brightness"):
        VOSystem(VOConfig(image_size=(64, 96), use_aff_bri=True),
                 net=DroidNet.from_seed(0), device="cpu")
    s = VOSystem(VOConfig(image_size=(64, 96), buffer=8), device="cpu")
    assert not s.net.use_aff_bri


@pytest.mark.parametrize("key, ignore, raises", [
    ("module.update.param_linear.0.weight", (), True),
    ("update.global_avg_pool.0.bias", (), True),
    ("fnet.some_future_buffer", (), True),
    ("fnet.some_future_buffer", ("fnet.some_future_",), False),
    (None, (), False)])
def test_checkpoint_keys_the_port_does_not_model_raise(tmp_path, monkeypatch,
                                                       key, ignore, raises):
    """A key the port does not model raises. A key of the
    affine-brightness head makes the loader build the head, so a lone
    one raises for the head's other keys, which the checkpoint lacks (a
    whole head loads: tests/test_torch_port_train_step.py)."""
    monkeypatch.setattr(convert, "IGNORED_KEY_PREFIXES", ignore)
    sd = DroidNet.from_seed(0).state_dict()
    if key is not None:
        sd[key] = torch.zeros(2, 2)
    path = str(tmp_path / "droid.pth")
    torch.save(sd, path)
    aff = key is not None and \
        key.replace("module.", "").startswith(convert.AFF_BRI_PREFIXES)
    if raises:
        with pytest.raises(KeyError,
                           match="lacks" if aff else "does not model"):
            convert.load_droidnet_torch(path)
    else:
        net = convert.load_droidnet_torch(path)
        assert torch.equal(net.fnet.conv1.weight, sd["fnet.conv1.weight"])


def test_checkpoint_allow_list_starts_empty_and_missing_keys_raise(tmp_path):
    assert convert.IGNORED_KEY_PREFIXES == ()
    sd = DroidNet.from_seed(0).state_dict()
    del sd["update.delta_mask.2.bias"]
    path = str(tmp_path / "droid.pth")
    torch.save(sd, path)
    with pytest.raises(KeyError, match="lacks"):
        convert.load_droidnet_torch(path)
