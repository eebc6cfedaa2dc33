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


def _oihw(k):
    return np.transpose(k, (3, 2, 0, 1))


def _fc1(k):
    """fc1's kernel (7*7*C, out) over the (y, x, c) flattening -> the
    (out, C*7*7) weight over the (c, y, x) one (fault J1)."""
    C = k.shape[0] // 49
    return k.reshape(7, 7, C, -1).transpose(3, 2, 0, 1).reshape(k.shape[1], -1)


def _deconv(k):
    # flax's ConvTranspose convolves with the flipped kernel
    # (pvo_tpu/utils/convert_vps.py:94-98): flip back, HWIO -> IOHW
    return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))


def _same(a):
    return a


def _leaves(p):
    """(JAX path, port state-dict name, numpy transform) of every leaf of
    a JAX ``PanopticFPN``'s ``params`` tree."""
    out = []

    def conv(path, name):
        out.append((path + ("Conv_0", "kernel"), f"{name}.weight", _oihw))
        if "bias" in _at(p, path + ("Conv_0",)):
            out.append((path + ("Conv_0", "bias"), f"{name}.bias", _same))

    def frozen_bn(path, name):
        for k in ("weight", "bias", "running_mean", "running_var"):
            out.append((path + (k,), f"{name}.{k}", _same))

    def dense(path, name, kernel=np.transpose):
        out.append((path + ("kernel",), f"{name}.weight", kernel))
        out.append((path + ("bias",), f"{name}.bias", _same))

    bu = "backbone.bottom_up"
    conv(("backbone", "stem_conv1"), f"{bu}.stem.conv1")
    frozen_bn(("backbone", "stem_conv1_norm"), f"{bu}.stem.conv1.norm")
    for key, blk in p["backbone"].items():
        m = re.fullmatch(r"res(\d)_(\d+)", key)
        if not m:
            continue
        base = f"{bu}.res{m.group(1)}.{m.group(2)}"
        for cv in ("conv1", "conv2", "conv3", "shortcut"):
            if cv in blk:
                conv(("backbone", key, cv), f"{base}.{cv}")
                frozen_bn(("backbone", key, f"{cv}_norm"),
                          f"{base}.{cv}.norm")
    for lvl in (2, 3, 4, 5):
        conv(("fpn", f"lateral{lvl}"), f"backbone.fpn_lateral{lvl}")
        conv(("fpn", f"output{lvl}"), f"backbone.fpn_output{lvl}")
    rb = "proposal_generator.rpn_head"
    conv(("rpn_head", "conv"), f"{rb}.conv")
    conv(("rpn_head", "objectness"), f"{rb}.objectness_logits")
    conv(("rpn_head", "anchor_deltas"), f"{rb}.anchor_deltas")

    bh = ("roi_heads", "box_head")
    dense(bh + ("fc1",), "roi_heads.box_head.fc1", _fc1)
    dense(bh + ("fc2",), "roi_heads.box_head.fc2")
    dense(bh + ("cls_score",), "roi_heads.box_predictor.cls_score")
    dense(bh + ("bbox_pred",), "roi_heads.box_predictor.bbox_pred")
    mh = ("roi_heads", "mask_head")
    for i in range(1, 5):
        conv(mh + (f"mask_fcn{i}",), f"roi_heads.mask_head.mask_fcn{i}")
    out.append((mh + ("deconv", "kernel"), "roi_heads.mask_head.deconv.weight",
                _deconv))
    out.append((mh + ("deconv", "bias"), "roi_heads.mask_head.deconv.bias",
                _same))
    conv(mh + ("predictor",), "roi_heads.mask_head.predictor")

    for lvl, k in zip(("p2", "p3", "p4", "p5"), (1, 1, 2, 3)):
        for i in range(k):
            t = f"sem_seg_head.{lvl}.{2 * i}"
            conv(("sem_seg_head", f"{lvl}_conv{i}"), t)
            out.append((("sem_seg_head", f"{lvl}_norm{i}", "scale"),
                        f"{t}.norm.weight", _same))
            out.append((("sem_seg_head", f"{lvl}_norm{i}", "bias"),
                        f"{t}.norm.bias", _same))
    conv(("sem_seg_head", "predictor"), "sem_seg_head.predictor")
    if "fusion_conv1" in p:
        conv(("fusion_conv1",), "fusion_conv1")
    return out


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


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def jax_param_names(params) -> Dict[str, str]:
    """{JAX leaf path ``"backbone/res2_0/conv1/Conv_0/kernel"``: the
    port's state-dict name} for a JAX ``PanopticFPN``'s variables. The
    JAX ``FrozenBN`` leaves map to the port's buffers (fault J5)."""
    return {"/".join(path): name for path, name, _ in
            _leaves(params["params"])}


def state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX ``PanopticFPN`` variables -> the port's state dict. Every
    transform is a permutation of entries, so the same call maps a
    gradient tree (``jax.grad`` of the variables) to the port's
    gradients by name, fc1's columns (J1) and the deconv's flip
    included."""
    p = params["params"]
    return {name: _t(fn(np.asarray(_at(p, path))))
            for path, name, fn in _leaves(p)}


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
