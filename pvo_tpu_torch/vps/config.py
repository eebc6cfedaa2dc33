"""VPS configuration (the port's own copy of :mod:`pvo_tpu.vps.config`).

A yacs-style nested-dict config with dotted access, the defaults of the
reference's vkitti Panoptic FPN yaml configs, yaml/list/dict merges, and
``build_predictor``, which makes the port's ``PanopticPredictor``.

Unlike the JAX package, a merge refuses a key that the defaults do not
hold (yacs semantics), and :func:`build_predictor` refuses a value the
port does not model (another backbone depth, meta-architecture, class
count, pixel statistics or test threshold): neither is dropped quietly.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np


class CfgNode(dict):
    """Minimal yacs-like node: attribute access + merge."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def clone(self):
        return copy.deepcopy(self)

    def merge_from_dict(self, other: Dict[str, Any], prefix=""):
        """Merge ``other`` into this node; a key this node does not hold
        raises ``KeyError``."""
        for k, v in other.items():
            if k not in self:
                raise KeyError(f"config key {prefix}{k} is not modelled by "
                               f"the port")
            if isinstance(v, dict):
                node = self[k]
                if not isinstance(node, CfgNode):
                    raise KeyError(f"config key {prefix}{k} is a value, "
                                   f"not a node")
                node.merge_from_dict(v, prefix + k + ".")
            else:
                self[k] = v

    def merge_from_file(self, path):
        import yaml
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        data.pop("_BASE_", None)
        self.merge_from_dict(data)

    def merge_from_list(self, opts):
        """['MODEL.PANOPTIC_FPN.FUSION', True, ...] overrides."""
        for key, val in zip(opts[0::2], opts[1::2]):
            *parents, leaf = key.split(".")
            nested = val
            for p in [leaf, *parents[::-1]]:
                nested = {p: nested}
            self.merge_from_dict(nested)


def _nest(d):
    out = CfgNode()
    for k, v in d.items():
        out[k] = _nest(v) if isinstance(v, dict) else v
    return out


def get_cfg() -> CfgNode:
    """Defaults matching the reference's vkitti PanopticFPN configs
    (configs/COCO-PanopticSegmentation/*vkitti*.yaml)."""
    return _nest({
        "MODEL": {
            "META_ARCHITECTURE": "PanopticFPN",
            "WEIGHTS": "",
            "PIXEL_MEAN": [103.530, 116.280, 123.675],
            "PIXEL_STD": [1.0, 1.0, 1.0],
            "MASK_ON": True,
            "RESNETS": {"DEPTH": 50},
            "ROI_HEADS": {"NUM_CLASSES": 3, "SCORE_THRESH_TEST": 0.05,
                          "NMS_THRESH_TEST": 0.5},
            "SEM_SEG_HEAD": {"NUM_CLASSES": 12, "LOSS_WEIGHT": 0.5,
                             "IGNORE_VALUE": 255},
            "PANOPTIC_FPN": {
                "FUSION": False,
                "COMBINE": {"ENABLED": True,
                            "OVERLAP_THRESH": 0.5,
                            "STUFF_AREA_LIMIT": 4096,
                            "INSTANCES_CONFIDENCE_THRESH": 0.5},
            },
            "RPN": {"PRE_NMS_TOPK_TEST": 1000,
                    "POST_NMS_TOPK_TEST": 1000,
                    "NMS_THRESH": 0.7},
        },
        "DATASETS": {"TRAIN": ["vkitti_511_train"],
                     "TEST": ["vkitti_511_val"]},
        "INPUT": {"MIN_SIZE_TEST": 375, "MAX_SIZE_TEST": 1242,
                  "MASK_FORMAT": "bitmask"},
        "SOLVER": {"IMS_PER_BATCH": 8, "BASE_LR": 0.00025,
                   "MAX_ITER": 90000, "CHECKPOINT_PERIOD": 5000},
        "TEST": {"EVAL_PERIOD": 0},
        "OUTPUT_DIR": "./output",
    })


def _unmodelled(cfg, model):
    """The config values the port's model and predictor do not follow."""
    from . import panoptic_fpn as pfpn
    m = cfg.MODEL
    fixed = {
        "MODEL.META_ARCHITECTURE": (m.META_ARCHITECTURE, "PanopticFPN"),
        "MODEL.RESNETS.DEPTH": (m.RESNETS.DEPTH, 50),
        "MODEL.MASK_ON": (m.MASK_ON, True),
        "MODEL.PANOPTIC_FPN.COMBINE.ENABLED":
            (m.PANOPTIC_FPN.COMBINE.ENABLED, True),
        "MODEL.ROI_HEADS.NUM_CLASSES":
            (m.ROI_HEADS.NUM_CLASSES, model.roi_heads.num_classes),
        "MODEL.SEM_SEG_HEAD.NUM_CLASSES":
            (m.SEM_SEG_HEAD.NUM_CLASSES,
             model.sem_seg_head.predictor.out_channels),
        "MODEL.ROI_HEADS.SCORE_THRESH_TEST":
            (m.ROI_HEADS.SCORE_THRESH_TEST, 0.05),
        "MODEL.ROI_HEADS.NMS_THRESH_TEST": (m.ROI_HEADS.NMS_THRESH_TEST, 0.5),
        "MODEL.RPN.PRE_NMS_TOPK_TEST": (m.RPN.PRE_NMS_TOPK_TEST, 1000),
        "MODEL.RPN.POST_NMS_TOPK_TEST": (m.RPN.POST_NMS_TOPK_TEST, 1000),
        "MODEL.RPN.NMS_THRESH": (m.RPN.NMS_THRESH, 0.7),
    }
    bad = [k for k, (got, want) in fixed.items() if got != want]
    for k, got, want in (("MODEL.PIXEL_MEAN", m.PIXEL_MEAN, pfpn.PIXEL_MEAN),
                         ("MODEL.PIXEL_STD", m.PIXEL_STD, pfpn.PIXEL_STD)):
        if not np.allclose(np.asarray(got, np.float32), want):
            bad.append(k)
    return bad


def build_predictor(cfg, model, device):
    """cfg -> the port's PanopticPredictor of ``model`` on ``device`` (no
    default: ``"cuda"`` raises without a card), with the cfg's combine
    thresholds. A value the port does not model raises ``ValueError``."""
    from .panoptic_fpn import PanopticPredictor

    bad = _unmodelled(cfg, model)
    if bad:
        raise ValueError(f"config values the port does not model: {bad}")
    pred = PanopticPredictor(model, device=device)
    comb = cfg.MODEL.PANOPTIC_FPN.COMBINE
    pred.combine_kwargs = {
        "overlap_threshold": comb.OVERLAP_THRESH,
        "stuff_area_thresh": comb.STUFF_AREA_LIMIT,
        "instances_score_thresh": comb.INSTANCES_CONFIDENCE_THRESH,
    }
    return pred
