"""Port parity: the plain versions of the packed-layout kernels P1 and P2
(vo/net/cuda_corr_exp.py) against the JAX package's corr experiment
kernels X1-X5 (scripts/corr_exp*.py), run in Pallas interpret mode on
the CPU. ``pl.pallas_call`` is wrapped with ``interpret=True`` for the
harness kernels; X5's ``emit_pipeline`` has no interpret mode, so X5 is
held against the packed extraction it checks itself against
(``pallas_corr_extract(packed=True)``, corr_exp5.py:158-171).

Both sides read the same inputs: bf16 features for X1 and P1, and for
X2-X5 the JAX volume of ``build_corr_volumes`` in the port's
(E, H*W, N2) layout. Tolerance for the bf16 outputs:
|a - b| <= 2e-2 + 8e-3 |b|, one bf16 ulp above the volume tolerance of
tests/test_pallas_corr.py; and at least 99.9% of the outputs
bit-equal, since X2's rounding variants differ from each other by one
bf16 ulp in 13-15% of the outputs at these shapes, while the plain
versions match every variant bit for bit on the CPU. Coordinates reach
6 pixels past every border, so out-of-range taps and the selectors'
lane wrap are covered; X1 is also held on the smooth and the mixed
coordinates of ``kbench.lookup_coords``, the cases P1's kernel routes
apart.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pvo_tpu.vo.net.pallas_corr import (build_corr_volumes,
                                        corr_level_shapes,
                                        pallas_corr_extract)
from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.vo.net import cuda_corr_exp as cx

E, H, W, C = 2, 12, 40, 32
HW = H * W
VSHAPES = corr_level_shapes(H, W)


@pytest.fixture(scope="module")
def xmods():
    """The harness modules, with pl.pallas_call in interpret mode.
    Importing them points JAX's compilation cache at .jax_cache; the
    suite's per-CPU cache dir (tests/conftest.py) is put back at once."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        try:
            mods = {n: importlib.import_module(f"scripts.{n}") for n in (
                "corr_exp", "corr_exp2", "corr_exp3", "corr_exp4")}
        finally:
            for k, v in keep.items():
                jax.config.update(k, v)
        yield mods


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    f1 = rng.randn(E, H, W, C).astype(np.float32)
    f2 = rng.randn(E, H, W, C).astype(np.float32)
    cx_ = rng.uniform(-6.0, W + 6.0, (E, H, W))
    cy_ = rng.uniform(-6.0, H + 6.0, (E, H, W))
    coords = np.stack([cx_, cy_], -1).astype(np.float32)
    jf1, jf2 = jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16)
    vols, _ = build_corr_volumes(jf1, jf2)
    # the port's volume layout: level l's (H_l, W_l) plane at column
    # offset sum_{k<l} H_k W_k
    vj = np.asarray(vols.astype(jnp.float32))
    vol_t, row = [], 0
    for (h, w, _, _) in VSHAPES:
        vol_t.append(vj[:, :HW, row:row + h, :w].reshape(E, HW, h * w))
        row += h
    return {
        "f": (jf1, jf2), "coords": jnp.asarray(coords), "vols": vols,
        "tf": (torch.from_numpy(f1).bfloat16(),
               torch.from_numpy(f2).bfloat16()),
        "tcoords": torch.from_numpy(coords),
        "tvol": torch.from_numpy(np.concatenate(vol_t, -1)).bfloat16(),
    }


def per_level(vols):
    """X2/X3 take per-level volumes: slices of the stacked buffer."""
    out, row = [], 0
    for (h, _, _, _) in VSHAPES:
        out.append(vols[:, :, row:row + h, :])
        row += h
    return out


def assert_close(port, jax_out, channels=slice(None)):
    a = port.float().numpy().reshape(E, HW, -1)[..., channels]
    b = np.asarray(jax_out, np.float32)[:, :HW].reshape(E, HW, -1)
    b = b[..., channels]
    bad = np.abs(a - b) > 2e-2 + 8e-3 * np.abs(b)
    assert not bad.any(), (int(bad.sum()), float(np.abs(a - b).max()))
    assert np.mean(a == b) >= 0.999, np.mean(a == b)
    # not vacuous: the compared taps carry values
    assert np.abs(b).max() > 0.1


@pytest.mark.parametrize("seldt", ["f32", "bf16"])
@pytest.mark.parametrize("store", ["perlevel", "matpack", "dymajor"])
def test_x1_matches_lookup_packed(xmods, data, store, seldt):
    order = "dy" if store == "dymajor" else "level"
    port = cx.corr_lookup_packed(*data["tf"], data["tcoords"], order=order,
                                 seldt=seldt)
    want = xmods["corr_exp"].run(*data["f"], data["coords"], merge="none",
                                 store=store, seldt=seldt)
    assert port.shape == (E, H, W, 256) and port.dtype == torch.bfloat16
    assert_close(port, want)


@pytest.mark.parametrize("seldt", ["f32", "bf16"])
@pytest.mark.parametrize("store", ["perlevel", "matpack", "dymajor"])
@pytest.mark.parametrize("kind", ["smooth", "mixed"])
def test_x1_matches_lookup_packed_on_smooth_and_mixed_coords(xmods, data,
                                                             kind, store,
                                                             seldt):
    """The coordinates that P1's kernel is built for: a pixel grid plus a
    smooth flow (every tile's bounding box small), and smooth in one
    half of the image, scattered in the other."""
    coords = kbench.lookup_coords(kind, E, H, W, seed=2)
    order = "dy" if store == "dymajor" else "level"
    port = cx.corr_lookup_packed(*data["tf"], torch.from_numpy(coords),
                                 order=order, seldt=seldt)
    want = xmods["corr_exp"].run(*data["f"], jnp.asarray(coords),
                                 merge="none", store=store, seldt=seldt)
    assert port.shape == (E, H, W, 256) and port.dtype == torch.bfloat16
    assert_close(port, want)


@pytest.mark.parametrize("cast_vol", [True, False])
@pytest.mark.parametrize("sel", ["f32", "bf16"])
def test_x2_matches_extract_packed(xmods, data, cast_vol, sel):
    weights, mid = cx.X2_VARIANTS[(cast_vol, sel)]
    port = cx.corr_extract_packed(data["tvol"], data["tcoords"],
                                  weights=weights, round_mid=mid)
    want = xmods["corr_exp2"].extract_v(
        per_level(data["vols"]), VSHAPES, data["coords"], 256, cast_vol,
        jnp.float32 if sel == "f32" else jnp.bfloat16)
    assert_close(port, want)


X3_WRITTEN = {
    "full": np.arange(256),
    "nostore": np.concatenate([np.arange(8) + 64 * lvl for lvl in range(4)]),
    "novab": np.arange(128),
    "dma": np.arange(128),
}


@pytest.mark.parametrize("mode", list(X3_WRITTEN))
def test_x3_matches_extract_packed_modes(xmods, data, mode):
    port = cx.corr_extract_packed(data["tvol"], data["tcoords"], mode=mode)
    want = xmods["corr_exp3"].run_mode(per_level(data["vols"]), VSHAPES,
                                       data["coords"], 256, mode)
    written = X3_WRITTEN[mode]
    assert_close(port, want, written)
    # the channels the TPU mode leaves unwritten are 0 in the port
    rest = np.setdiff1d(np.arange(256), written)
    assert not port.float().numpy().reshape(E, HW, -1)[..., rest].any()


def test_x4_matches_extract_packed(xmods, data):
    port = cx.corr_extract_packed(data["tvol"], data["tcoords"])
    want = xmods["corr_exp4"].extract_v2(data["vols"], VSHAPES,
                                         data["coords"])
    assert_close(port, want)


def test_x5_oracle_matches_extract_packed(data):
    port = cx.corr_extract_packed(data["tvol"], data["tcoords"])
    want = pallas_corr_extract(data["vols"], VSHAPES, data["coords"],
                               packed=True, interpret=True)
    assert_close(port, want)


def test_lookup_packed_orders_and_volume_path_agree(data):
    """P1's dy-major order permutes its level-major one, and with f32
    intermediates P1 equals P2 on the bf16-rounded volume within one
    bf16 rounding of the correlation."""
    lvl = cx.corr_lookup_packed(*data["tf"], data["tcoords"])
    dy = cx.corr_lookup_packed(*data["tf"], data["tcoords"], order="dy")
    perm = lvl.reshape(E, H, W, 4, 8, 8).transpose(3, 4)
    assert torch.equal(dy, perm.reshape(E, H, W, 256))
    ext = cx.corr_extract_packed(data["tvol"], data["tcoords"])
    a, b = lvl.float(), ext.float()
    assert ((a - b).abs() <= 2e-2 + 8e-3 * b.abs()).all()


def _share_differing(a, b):
    return (a != b).float().mean().item()


@pytest.mark.parametrize("order", cx.ORDERS)
def test_lookup_packed_seldt_changes_output(data, order):
    """bf16 intermediates change P1's output, or the flag would be dead
    and the bit-equality checks above could not see it."""
    a, b = (cx.corr_lookup_packed(*data["tf"], data["tcoords"], order=order,
                                  seldt=s) for s in cx.SELDT)
    assert _share_differing(a, b) >= 0.01


def test_extract_packed_rounding_variants_differ(data):
    """X2's four rounding variants give four different outputs."""
    outs = [cx.corr_extract_packed(data["tvol"], data["tcoords"], weights=w,
                                   round_mid=mid)
            for w, mid in cx.X2_VARIANTS.values()]
    for i in range(len(outs)):
        for j in range(i):
            assert _share_differing(outs[i], outs[j]) >= 0.01, (i, j)


def test_wrappers_reject_unknown_variants(data):
    with pytest.raises(ValueError):
        cx.corr_lookup_packed(*data["tf"], data["tcoords"], order="dx")
    with pytest.raises(ValueError):
        cx.corr_extract_packed(data["tvol"], data["tcoords"], mode="dma",
                               weights="bf16")
    with pytest.raises(ValueError):
        cx.corr_extract_packed(data["tvol"], data["tcoords"], mode="novab",
                               round_mid=True)
