"""``scripts/analyze_model.py``'s counts against the JAX package's, and
the packed corr layout ``scripts/bench_corr.py`` times.

Parameter counts per VO param tree (``init_params``) and per top-level
group of the flax Panoptic FPN (``PanopticFPN.init``) must be equal
exactly (the port's frozen-BN buffers counted with the parameters, as
the flax model holds them); the JAX trees come from ``jax.eval_shape``,
so nothing is computed. fnet's forward FLOPs at 240x808 by
``FlopCounterMode`` must be within 1% of XLA's ``cost_analysis()`` of
the jitted JAX forward and not above it (XLA also counts the norms'
elementwise work). ``pallas_corr_lookup(packed=True)``'s tap blocks
(interpret mode) are P1's ``order="level", seldt="f32"`` output.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.vo.net.pallas_corr import pallas_corr_lookup
from pvo_tpu.vo.system import init_params, make_modules
from pvo_tpu.vps.panoptic_fpn import PanopticFPN as JaxPanopticFPN
from pvo_tpu_torch.scripts import analyze_model
from pvo_tpu_torch.vo.net import cuda_corr_exp
from pvo_tpu_torch.vo.net.droidnet import DroidNet
from pvo_tpu_torch.vps.panoptic_fpn import PanopticFPN

from torch_one_thread import one_thread  # noqa: F401


def _count(tree):
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(tree))


@pytest.fixture(scope="module")
def vo_shapes():
    mods = make_modules()
    return mods, jax.eval_shape(lambda: init_params(mods, (64, 96)))


def test_vo_params_equal_jax(vo_shapes):
    _, shapes = vo_shapes
    table = analyze_model.param_table(DroidNet.from_seed(0),
                                      analyze_model.vo_group)
    assert {k: g["jax"] for k, g in table.items()} == \
        {k: _count(t) for k, t in shapes.items()}
    assert all(g["frozen_bn"] == 0 for g in table.values())


def test_vps_params_equal_jax():
    """The R-50 model's groups, initialized at a small input."""
    shapes = jax.eval_shape(lambda: JaxPanopticFPN().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3))))["params"]
    table = analyze_model.param_table(PanopticFPN(),
                                      analyze_model.vps_group)
    assert {k: g["jax"] for k, g in table.items()} == \
        {k: _count(t) for k, t in shapes.items()}
    # the frozen norms' four vectors a channel are buffers in the port
    assert table["backbone"]["frozen_bn"] == 106240
    assert table["backbone"]["params"] + 106240 == table["backbone"]["jax"]


def test_fnet_flops_against_xla(vo_shapes):
    mods, shapes = vo_shapes
    H, W = analyze_model.FNET_HW
    cost = jax.jit(lambda p, x: mods["fnet"].apply(p, x)).lower(
        shapes["fnet"], jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    ).compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    xla = float(cost["flops"])
    net = DroidNet.from_seed(0).to("meta")
    ours = analyze_model.flops(net.fnet, torch.zeros((1, H, W, 3),
                                                     device="meta"))
    assert ours <= xla
    assert abs(ours - xla) / xla < 0.01, (ours, xla)


def test_main_on_meta(capsys):
    """The CLI's JSON line (``--device meta``: counts from shapes)."""
    out = analyze_model.main(["--device", "meta"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(out))
    assert last["vo"]["params"]["fnet"] == 714560
    assert last["vo"]["fnet_flops_240x808"] == 10484090880
    # 2 x (3x3 gate convs over 448 channels x 3, heads, encoders, GraphAgg's
    # conv) a pixel of 48 edges at 30x101
    assert last["vo"]["update_flops_e48_30x101"] > 48 * 30 * 101 * 5e6
    assert last["vps"]["total"] == 46840302
    assert last["vps"]["features_flops_384x1248"] > 1e11


def test_packed_case_is_p1_level_f32():
    """The JAX packed lookup and P1's plain version (level-major, f32
    intermediates) on bf16 features: within one bf16 ulp, at least 99.9%
    bit-equal; P1's other variants are not."""
    E, H, W, C = 2, 12, 20, 32
    rng = np.random.RandomState(0)
    f1 = rng.randn(E, H, W, C).astype(np.float32)
    f2 = rng.randn(E, H, W, C).astype(np.float32)
    coords = (rng.rand(E, H, W, 2) * np.array([W - 1, H - 1])).astype(
        np.float32)
    want = np.asarray(pallas_corr_lookup(
        jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16),
        jnp.asarray(coords), packed=True, interpret=True).astype(jnp.float32))
    t1, t2 = (torch.from_numpy(a).to(torch.bfloat16) for a in (f1, f2))
    c = torch.from_numpy(coords)
    shares = {}
    for order in cuda_corr_exp.ORDERS:
        for seldt in cuda_corr_exp.SELDT:
            got = cuda_corr_exp.corr_lookup_packed_plain(
                t1, t2, c, order=order, seldt=seldt).float().numpy()
            shares[order, seldt] = float((got == want).mean())
            if (order, seldt) == ("level", "f32"):
                ulp = np.maximum(np.abs(want), 2.0 ** -6) * 2.0 ** -7
                assert (np.abs(got - want) <= ulp).all()
    assert shares["level", "f32"] >= 0.999
    assert max(v for k, v in shares.items() if k != ("level", "f32")) < 0.9
