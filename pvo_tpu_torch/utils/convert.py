"""Weights for the port's :class:`DroidNet`.

The port's modules carry the reference state-dict names, so a reference
``.pth`` loads with ``load_state_dict``; :func:`params_from_jax` is the
exact inverse of :func:`pvo_tpu.utils.convert.convert_droidnet`: the JAX
4-tree param dict (numpy leaves, HWIO kernels, unexpanded corr
weights) becomes that state dict (OIHW kernels).
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


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX ``{"fnet","cnet","update","agg"}`` param trees -> state dict
    of :class:`DroidNet` with the reference key names."""
    sd: Dict[str, torch.Tensor] = {}
    _encoder(params["fnet"]["params"], "fnet", sd)
    _encoder(params["cnet"]["params"], "cnet", sd)
    up = params["update"]["params"]
    _conv(up, "corr_enc0", "update.corr_encoder.0", sd)
    _conv(up, "corr_enc1", "update.corr_encoder.2", sd)
    _conv(up, "flow_enc0", "update.flow_encoder.0", sd)
    _conv(up, "flow_enc1", "update.flow_encoder.2", sd)
    for head in ("delta", "delta_dy", "weight", "delta_mask"):
        _conv(up[head], "conv0", f"update.{head}.0", sd)
        _conv(up[head], "conv1", f"update.{head}.2", sd)
    for g in ("convz", "convr", "convq", "w", "convz_glo", "convr_glo",
              "convq_glo"):
        _conv(up["gru"], g, f"update.gru.{g}", sd)
    agg = params["agg"]["params"]
    _conv(agg, "conv1", "update.agg.conv1", sd)
    _conv(agg, "conv2", "update.agg.conv2", sd)
    _conv(agg, "eta", "update.agg.eta.0", sd)
    _conv(agg, "upmask_disp", "update.agg.upmask_disp.0", sd)
    return sd


def droidnet_from_jax(params) -> DroidNet:
    net = DroidNet()
    net.load_state_dict(params_from_jax(params))
    return net


def load_droidnet_torch(path: str) -> DroidNet:
    """Load a reference DroidNet checkpoint (DDP ``module.`` prefixes
    stripped). Keys the port does not model are ignored; a key the port
    needs and the checkpoint lacks is an error."""
    sd = torch.load(path, map_location="cpu")
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    net = DroidNet()
    missing, _ = net.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"checkpoint lacks {missing}")
    return net
