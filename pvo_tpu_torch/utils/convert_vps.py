"""Weights for the port's :class:`PanopticFPN`.

The port's modules carry detectron2's state-dict names
(``backbone.bottom_up.*``, ``backbone.fpn_lateral*``/``fpn_output*``,
``proposal_generator.rpn_head.*``, ``roi_heads.*``, ``sem_seg_head.*``,
PVO's ``fusion_conv1``), so a reference panFPN checkpoint loads with
``load_state_dict`` (:func:`load_panoptic_fpn_torch`).
:func:`panoptic_fpn_from_jax` is the bridge for the tests: the inverse of
:func:`pvo_tpu.utils.convert_vps.convert_panoptic_fpn` (HWIO kernels to
OIHW, the deconv's spatial flip undone), except for the box head's fc1,
whose input columns it permutes from the JAX package's (y, x, c)
flattening to the (c, y, x) one that the port and detectron2 use.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from pvo_tpu_torch.vps.panoptic_fpn import PanopticFPN


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _conv(node, name, sd):
    node = node["Conv_0"]
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(node["kernel"]),
                                           (3, 2, 0, 1)))
    if "bias" in node:
        sd[f"{name}.bias"] = _t(node["bias"])


def _frozen_bn(node, name, sd):
    for k in ("weight", "bias", "running_mean", "running_var"):
        sd[f"{name}.{k}"] = _t(node[k])


def _dense(node, name, sd):
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(node["kernel"])))
    sd[f"{name}.bias"] = _t(node["bias"])


def stage_blocks_of(names):
    """Blocks per stage res2..res5 from the names of a JAX tree
    (``res3_1``) or a state dict (``backbone.bottom_up.res3.1.conv1``)."""
    blocks = [0, 0, 0, 0]
    for n in names:
        m = re.search(r"res([2-5])[._](\d+)", n)
        if m:
            s, b = int(m.group(1)) - 2, int(m.group(2))
            blocks[s] = max(blocks[s], b + 1)
    return tuple(blocks)


def state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX ``PanopticFPN`` variables -> the port's state dict."""
    p = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    bb, bu = p["backbone"], "backbone.bottom_up"
    _conv(bb["stem_conv1"], f"{bu}.stem.conv1", sd)
    _frozen_bn(bb["stem_conv1_norm"], f"{bu}.stem.conv1.norm", sd)
    for key, blk in bb.items():
        m = re.fullmatch(r"res(\d)_(\d+)", key)
        if not m:
            continue
        base = f"{bu}.res{m.group(1)}.{m.group(2)}"
        for cv in ("conv1", "conv2", "conv3", "shortcut"):
            if cv in blk:
                _conv(blk[cv], f"{base}.{cv}", sd)
                _frozen_bn(blk[f"{cv}_norm"], f"{base}.{cv}.norm", sd)
    for lvl in (2, 3, 4, 5):
        _conv(p["fpn"][f"lateral{lvl}"], f"backbone.fpn_lateral{lvl}", sd)
        _conv(p["fpn"][f"output{lvl}"], f"backbone.fpn_output{lvl}", sd)
    rpn, rb = p["rpn_head"], "proposal_generator.rpn_head"
    _conv(rpn["conv"], f"{rb}.conv", sd)
    _conv(rpn["objectness"], f"{rb}.objectness_logits", sd)
    _conv(rpn["anchor_deltas"], f"{rb}.anchor_deltas", sd)

    bh = p["roi_heads"]["box_head"]
    k1 = np.asarray(bh["fc1"]["kernel"])            # (7*7*C, out), (y, x, c)
    C = k1.shape[0] // 49
    sd["roi_heads.box_head.fc1.weight"] = _t(
        k1.reshape(7, 7, C, -1).transpose(3, 2, 0, 1).reshape(k1.shape[1], -1))
    sd["roi_heads.box_head.fc1.bias"] = _t(bh["fc1"]["bias"])
    _dense(bh["fc2"], "roi_heads.box_head.fc2", sd)
    _dense(bh["cls_score"], "roi_heads.box_predictor.cls_score", sd)
    _dense(bh["bbox_pred"], "roi_heads.box_predictor.bbox_pred", sd)
    mh = p["roi_heads"]["mask_head"]
    for i in range(1, 5):
        _conv(mh[f"mask_fcn{i}"], f"roi_heads.mask_head.mask_fcn{i}", sd)
    # flax's ConvTranspose convolves with the flipped kernel
    # (pvo_tpu/utils/convert_vps.py:94-98): flip back, HWIO -> IOHW
    dk = np.asarray(mh["deconv"]["kernel"])[::-1, ::-1]
    sd["roi_heads.mask_head.deconv.weight"] = _t(np.transpose(dk,
                                                              (2, 3, 0, 1)))
    sd["roi_heads.mask_head.deconv.bias"] = _t(mh["deconv"]["bias"])
    _conv(mh["predictor"], "roi_heads.mask_head.predictor", sd)

    ss = p["sem_seg_head"]
    for lvl, k in zip(("p2", "p3", "p4", "p5"), (1, 1, 2, 3)):
        for i in range(k):
            t = f"sem_seg_head.{lvl}.{2 * i}"
            _conv(ss[f"{lvl}_conv{i}"], t, sd)
            sd[f"{t}.norm.weight"] = _t(ss[f"{lvl}_norm{i}"]["scale"])
            sd[f"{t}.norm.bias"] = _t(ss[f"{lvl}_norm{i}"]["bias"])
    _conv(ss["predictor"], "sem_seg_head.predictor", sd)
    if "fusion_conv1" in p:
        _conv(p["fusion_conv1"], "fusion_conv1", sd)
    return sd


def panoptic_fpn_from_jax(params, **model_kwargs) -> PanopticFPN:
    """The port's model on the weights of a JAX ``PanopticFPN``; the
    backbone's depth is read from the tree."""
    model_kwargs.setdefault("backbone_blocks",
                            stage_blocks_of(params["params"]["backbone"]))
    model = PanopticFPN(**model_kwargs)
    model.load_state_dict(state_dict_from_jax(params))
    return model


def load_panoptic_fpn_torch(path: str) -> PanopticFPN:
    """Load a reference detectron2 Panoptic FPN checkpoint (weights under
    a ``model`` key or at the top, DDP ``module.`` prefixes stripped).

    A key the port needs and the checkpoint lacks is an error, except
    PVO's ``fusion_conv1``: without it the model loads and runs the plain
    path, and fusion raises. A key the port does not model is an error."""
    ckpt = torch.load(path, map_location="cpu")
    if "model" in ckpt:
        ckpt = ckpt["model"]
    sd = {k.replace("module.", ""): torch.as_tensor(v)
          for k, v in ckpt.items()}
    model = PanopticFPN(backbone_blocks=stage_blocks_of(sd))
    missing, unexpected = model.load_state_dict(sd, strict=False)
    fusion = [k for k in missing if k.startswith("fusion_conv1.")]
    missing = [k for k in missing if k not in fusion]
    if missing:
        raise KeyError(f"checkpoint lacks {missing}")
    if unexpected:
        raise KeyError(f"checkpoint has keys the port does not model: "
                       f"{unexpected}")
    model.has_fusion = not fusion
    return model
