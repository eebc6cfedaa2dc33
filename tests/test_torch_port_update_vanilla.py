"""The plain DROID update operator, the training configuration and the
data-parallel launcher's device, against the JAX package.

``UpdateModule`` (``pvo_tpu/vo/net/update.py:142-158``) on the same
seed-made inputs through the weight bridge
``utils.convert.update_params_from_jax``; ``TrainConfig``
(``pvo_tpu/utils/config.py:62-96``) field for field; and
``data_parallel.spawn``, the one entry point that ran on the CPU unless
asked for the card.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvo_tpu.utils.config import TrainConfig as JaxTrainConfig
from pvo_tpu.vo.net import UpdateModule as JaxUpdateModule
from pvo_tpu_torch.parallel import data_parallel as dp
from pvo_tpu_torch.utils.config import TrainConfig
from pvo_tpu_torch.utils.convert import update_params_from_jax
from pvo_tpu_torch.vo.net import UpdateModule

from torch_one_thread import one_thread  # noqa: F401

E, H, W = 2, 8, 12


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(E, H, W, c).astype(np.float32)
            for c in (128, 128, 196, 4)]


@pytest.fixture(scope="module")
def pair():
    """The JAX operator's params and outputs, and the port's module with
    those weights, on one set of inputs."""
    args = _inputs()
    jmod = JaxUpdateModule()
    params = jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))
    # give the zero-initialised biases values, so the bridge's bias
    # mapping is held too
    rng = np.random.RandomState(1)
    params = jax.tree.map(
        lambda a: a if a.ndim > 1 else jnp.asarray(
            0.01 * rng.randn(*a.shape), a.dtype), params)
    jout = jmod.apply(params, *map(jnp.asarray, args))
    tmod = UpdateModule().eval()
    tmod.load_state_dict(update_params_from_jax(params))
    return args, params, {k: np.asarray(v) for k, v in jout.items()}, tmod


def test_update_module_matches_jax(pair):
    """f32 on the CPU: every output within 1e-5 of the JAX one, scaled by
    the output's largest magnitude where that is above 1. The random
    heads give deltas up to about 20, where f32's own rounding is some
    2e-5: the JAX output itself is 1.4e-5 from a float64 evaluation of
    the same weights."""
    args, _, want, tmod = pair
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, args))
    assert set(got) == set(want) == {"net", "delta", "weight"}
    for k in want:
        assert got[k].dtype == torch.float32
        scale = max(1.0, float(np.abs(want[k]).max()))
        err = float(np.abs(got[k].numpy() - want[k]).max())
        assert err <= 1e-5 * scale, (k, err, scale)


def test_update_module_reference_key_names(pair):
    """The state dict takes the reference checkpoint's names (under
    ``update.`` in a DroidNet checkpoint) and refuses a key it does not
    model."""
    _, params, _, _ = pair
    sd = update_params_from_jax(params, prefix="update.")
    for name in ("update.corr_encoder.0.weight", "update.corr_encoder.2.bias",
                 "update.flow_encoder.0.weight", "update.flow_encoder.2.bias",
                 "update.gru.convz.weight", "update.gru.convq_glo.bias",
                 "update.delta.0.weight", "update.delta.2.bias",
                 "update.weight.0.weight", "update.weight.2.bias"):
        assert name in sd
    mod = UpdateModule()
    plain = {k[len("update."):]: v for k, v in sd.items()}
    assert set(plain) == set(mod.state_dict())
    mod.load_state_dict(plain)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        mod.load_state_dict(dict(plain, **{"delta_dy.0.weight":
                                           torch.zeros(1)}))


def test_train_config_equals_jax():
    ours = [(f.name, f.type, f.default) for f in
            dataclasses.fields(TrainConfig)]
    theirs = [(f.name, f.type, f.default) for f in
              dataclasses.fields(JaxTrainConfig)]
    assert ours == theirs
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JaxTrainConfig())


def test_spawn_defaults_to_the_card(monkeypatch):
    """Its default device is the card; without one it raises before any
    rank starts (the CPU runs only when asked for)."""
    assert inspect.signature(dp.spawn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.spawn(dp.free_port, 2)
