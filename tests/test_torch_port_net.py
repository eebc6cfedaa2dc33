"""Port parity: the network modules of pvo_tpu_torch against pvo_tpu's
flax modules, on the same weights (params_from_jax) and the same f32
inputs. Tolerance 1e-4 abs/rel: convolutions accumulate in another
order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.vo import factor_graph as jfg
from pvo_tpu.vo.net.droidnet import normalize_images as j_normalize
from pvo_tpu.vo.net.gru import ConvGRU
from pvo_tpu.vo.system import init_params, make_modules
from pvo_tpu_torch.utils.convert import (droidnet_from_jax,
                                        load_droidnet_torch,
                                        params_from_jax)
from pvo_tpu_torch.vo import factor_graph as tfg
from pvo_tpu_torch.vo.net.droidnet import DroidNet
from pvo_tpu_torch.vo.net.droidnet import normalize_images as t_normalize

TOL = dict(rtol=1e-4, atol=1e-4)
E, h, w = 3, 6, 8


@pytest.fixture(scope="module")
def nets():
    mods = make_modules()
    params = init_params(mods, image_size=(h * 8, w * 8), seed=3)
    return mods, params, droidnet_from_jax(jax.device_get(params)).eval()


def f32(rng, *shape):
    return np.asarray(rng.randn(*shape), np.float32)


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy() if torch.is_tensor(t)
                               else np.asarray(t), np.asarray(j),
                               **(tol or TOL))


def test_state_dict_keys_match_reference_names(nets):
    _, params, _ = nets
    sd = params_from_jax(jax.device_get(params))
    assert set(sd) == set(DroidNet().state_dict())
    assert sd["update.corr_encoder.0.weight"].shape == (128, 196, 1, 1)
    assert "update.agg.eta.0.weight" in sd
    assert "fnet.layer2.0.downsample.0.weight" in sd


def test_normalize_images():
    img = np.random.RandomState(0).randint(0, 255, (2, 16, 24, 3),
                                           np.uint8)
    close(t_normalize(torch.from_numpy(img)), j_normalize(jnp.asarray(img)),
          rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["fnet", "cnet"])
def test_encoders(nets, name):
    mods, params, tnet = nets
    x = f32(np.random.RandomState(1), 2, h * 8, w * 8, 3)
    with torch.no_grad():
        out_t = getattr(tnet, name)(torch.from_numpy(x))
    out_j = mods[name].apply(params[name], jnp.asarray(x))
    assert out_t.shape == out_j.shape
    close(out_t, out_j)


def _update_inputs(seed):
    rng = np.random.RandomState(seed)
    return (np.tanh(f32(rng, E, h, w, 128)), f32(rng, E, h, w, 128),
            f32(rng, E, h, w, 196), f32(rng, E, h, w, 8))


def test_gru(nets):
    mods, params, tnet = nets
    net, inp, corr, motn = _update_inputs(2)
    x = np.concatenate([inp, f32(np.random.RandomState(5), E, h, w, 192)],
                       -1)
    gru_params = {"params": params["update"]["params"]["gru"]}
    out_j = ConvGRU(128).apply(gru_params, jnp.asarray(net), jnp.asarray(x))
    with torch.no_grad():
        out_t = tnet.update.gru(torch.from_numpy(net), torch.from_numpy(x))
    close(out_t, out_j)


def test_update_module(nets):
    mods, params, tnet = nets
    args = _update_inputs(3)
    out_j = mods["update"].apply(params["update"],
                                 *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        out_t = tnet.update(*[torch.from_numpy(a) for a in args])
    assert set(out_t) == set(out_j)
    for k in out_j:
        close(out_t[k], out_j[k])


def test_ctx_split_matches_jax_and_full_apply(nets):
    mods, params, tnet = nets
    net, inp, corr, motn = _update_inputs(4)
    T = torch.from_numpy
    w_nc, w_ctx = tfg.split_gru_ctx(tnet.update)
    with torch.no_grad():
        pre_t = tfg.gru_ctx_pre(w_ctx, T(inp))
        split = tnet.update(T(net), None, T(corr), T(motn), ctx_pre=pre_t,
                            gru_nc=w_nc)
        full = tnet.update(T(net), T(inp), T(corr), T(motn))
    _, ctx_k = jfg.split_gru_ctx_params(params["update"])
    pre_j = jfg.gru_ctx_pre(ctx_k, jnp.asarray(inp))
    for a, b in zip(pre_t, pre_j):
        close(a, b)
    for k in full:
        close(split[k], full[k], atol=5e-5, rtol=1e-5)


def test_graph_agg(nets):
    mods, params, tnet = nets
    rng = np.random.RandomState(6)
    net = f32(rng, 5, h, w, 128)
    seg = np.array([0, 2, 2, 1, 3], np.int32)    # id 3 == num_frames: drop
    eta_j, up_j = mods["agg"].apply(params["agg"], jnp.asarray(net),
                                    jnp.asarray(seg), 3)
    with torch.no_grad():
        eta_t, up_t = tnet.update.agg(torch.from_numpy(net),
                                      torch.from_numpy(seg).long(), 3)
    close(eta_t, eta_j, rtol=1e-4, atol=1e-6)
    close(up_t, up_j)


def test_load_reference_checkpoint(nets, tmp_path):
    """A reference-style .pth (DDP ``module.`` prefixes, reference key
    names) loads into DroidNet; a key the port does not model raises, as
    a missing one does."""
    _, params, tnet = nets
    sd = {f"module.{k}": v for k, v in
          params_from_jax(jax.device_get(params)).items()}
    path = tmp_path / "droid.pth"
    torch.save(sd, path)
    loaded = load_droidnet_torch(str(path))
    for k, v in tnet.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)
    torch.save({**sd, "module.unused.weight": torch.zeros(1)}, path)
    with pytest.raises(KeyError, match="does not model"):
        load_droidnet_torch(str(path))
    del sd["module.update.agg.eta.0.bias"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="lacks"):
        load_droidnet_torch(str(path))
