"""Weights for the port's :class:`DroidNet`.

The port's modules carry the reference state-dict names, so a reference
``.pth`` loads with ``load_state_dict``; :func:`params_from_jax` is the
exact inverse of :func:`pvo_tpu.utils.convert.convert_droidnet`: the JAX
4-tree param dict (numpy leaves, HWIO kernels, unexpanded corr
weights) becomes that state dict (OIHW kernels). Every mapping is a
linear re-layout, so the same function carries a JAX gradient tree to
the port's gradients under the port's names. :func:`update_params_from_jax`
does the same for the plain ``UpdateModule``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from pvo_tpu_torch.vo.net.droidnet import DroidNet


def _conv(tree, fname, tname, sd):
    node = tree[fname]["Conv_0"]
    sd[f"{tname}.weight"] = torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(node["kernel"], np.float32), (3, 2, 0, 1))))
    sd[f"{tname}.bias"] = torch.from_numpy(
        np.asarray(node["bias"], np.float32).copy())


def _encoder(tree, prefix, sd):
    _conv(tree, "conv1", f"{prefix}.conv1", sd)
    _conv(tree, "conv2", f"{prefix}.conv2", sd)
    for stage in (1, 2, 3):
        for blk in (0, 1):
            node = tree[f"layer{stage}_{blk}"]
            name = f"{prefix}.layer{stage}.{blk}"
            _conv(node, "conv1", f"{name}.conv1", sd)
            _conv(node, "conv2", f"{name}.conv2", sd)
            if "downsample" in node:
                _conv(node, "downsample", f"{name}.downsample.0", sd)


def _update(up, prefix, heads, sd):
    """The encoders, heads and ConvGRU of an update operator's param tree
    ``up``, under ``prefix``."""
    _conv(up, "corr_enc0", f"{prefix}corr_encoder.0", sd)
    _conv(up, "corr_enc1", f"{prefix}corr_encoder.2", sd)
    _conv(up, "flow_enc0", f"{prefix}flow_encoder.0", sd)
    _conv(up, "flow_enc1", f"{prefix}flow_encoder.2", sd)
    for head in heads:
        _conv(up[head], "conv0", f"{prefix}{head}.0", sd)
        _conv(up[head], "conv1", f"{prefix}{head}.2", sd)
    for g in ("convz", "convr", "convq", "w", "convz_glo", "convr_glo",
              "convq_glo"):
        _conv(up["gru"], g, f"{prefix}gru.{g}", sd)


def update_params_from_jax(params, prefix="") -> Dict[str, torch.Tensor]:
    """The JAX plain ``UpdateModule``'s param tree (``{"params": ...}``)
    -> state dict of the port's :class:`UpdateModule`, its keys under
    ``prefix`` (``"update."`` gives a reference checkpoint's names)."""
    sd: Dict[str, torch.Tensor] = {}
    _update(params["params"], prefix, ("delta", "weight"), sd)
    return sd


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX ``{"fnet","cnet","update","agg"}`` param trees -> state dict
    of :class:`DroidNet` with the reference key names."""
    sd: Dict[str, torch.Tensor] = {}
    _encoder(params["fnet"]["params"], "fnet", sd)
    _encoder(params["cnet"]["params"], "cnet", sd)
    up = params["update"]["params"]
    _update(up, "update.", ("delta", "delta_dy", "weight", "delta_mask"), sd)
    if "aff_conv" in up:
        _conv(up, "aff_conv", "update.global_avg_pool.0", sd)
        lin = up["aff_linear"]
        sd["update.param_linear.0.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(lin["kernel"], np.float32).T))
        sd["update.param_linear.0.bias"] = torch.from_numpy(
            np.asarray(lin["bias"], np.float32).copy())
    agg = params["agg"]["params"]
    _conv(agg, "conv1", "update.agg.conv1", sd)
    _conv(agg, "conv2", "update.agg.conv2", sd)
    _conv(agg, "eta", "update.agg.eta.0", sd)
    _conv(agg, "upmask_disp", "update.agg.upmask_disp.0", sd)
    return sd


def droidnet_from_jax(params) -> DroidNet:
    net = DroidNet("aff_conv" in params["update"]["params"])
    net.load_state_dict(params_from_jax(params))
    return net


# Prefixes of checkpoint keys that :func:`load_droidnet_torch` drops: keys
# a reference checkpoint is known to carry and the port leaves out by
# design. None is known: the reference DroidNet's encoders use instance
# norm without parameters or running statistics, and every other key has
# its module here.
IGNORED_KEY_PREFIXES = ()
# The affine-brightness head of a ``use_aff_bri`` checkpoint
# (pvo_tpu/utils/convert.py:74-79): a checkpoint with these keys loads
# into ``DroidNet(use_aff_bri=True)``
AFF_BRI_PREFIXES = ("update.global_avg_pool.", "update.param_linear.")


def load_droidnet_torch(path: str) -> DroidNet:
    """Load a reference DroidNet checkpoint (DDP ``module.`` prefixes
    stripped). A checkpoint with the affine-brightness head's keys gives
    a ``DroidNet(use_aff_bri=True)``. A key the port needs and the
    checkpoint lacks is an error, and so is a key of the checkpoint that
    the port does not model, unless it starts with one of
    :data:`IGNORED_KEY_PREFIXES` (none so far)."""
    sd = torch.load(path, map_location="cpu")
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    net = DroidNet(any(k.startswith(AFF_BRI_PREFIXES) for k in sd))
    own = net.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"checkpoint lacks {missing}")
    unexpected = [k for k in sd if k not in own
                  and not k.startswith(IGNORED_KEY_PREFIXES)]
    if unexpected:
        raise KeyError(f"checkpoint has keys the port does not model: "
                       f"{unexpected}")
    net.load_state_dict({k: sd[k] for k in own})
    return net
