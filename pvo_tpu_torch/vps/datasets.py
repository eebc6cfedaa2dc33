"""VPS dataset registration and training samples (the port's own copy of
:mod:`pvo_tpu.vps.datasets`).

The vkitti registrations of the reference (clone 5:1:1 val and train,
clone full, 15-deg-left test), per-frame records from a prepared scene
(``scripts/prepare_vkitti.py`` writes ``panoptic_gt_id/``,
``stuff_labelTrainIds/``, ``panoptic_gt.json`` and ``split_511.json``),
the {ref, cur} pair mapper with flow (and depth) for fusion, and the
padded static-shape instance targets of the training losses.

The JAX module keeps its registry in module-level dicts; here it is a
:class:`Catalog` that the caller creates and passes, so two callers in
one process do not share registrations.
"""

from __future__ import annotations

import glob
import json
import os.path as osp
from typing import Callable, Dict, List

import numpy as np

from pvo_tpu_torch.utils.io import rgb2id

from .categories import VKITTI_CATEGORIES

VKITTI_SCENES = ("Scene01", "Scene02", "Scene06", "Scene18", "Scene20")


class Catalog:
    """Named dataset loaders (``() -> list of records``) and their
    metadata: detectron2's DatasetCatalog and MetadataCatalog."""

    def __init__(self):
        self._loaders: Dict[str, Callable[[], List[dict]]] = {}
        self._metadata: Dict[str, dict] = {}

    def register(self, name, loader, metadata=None):
        self._loaders[name] = loader
        self._metadata[name] = metadata or {}

    def get(self, name):
        return self._loaders[name]()

    def metadata(self, name):
        return self._metadata[name]

    def list_datasets(self):
        return sorted(self._loaders)


def vkitti_metadata():
    thing_ids = [c["trainId"] for c in VKITTI_CATEGORIES
                 if c["isthing"] == 1]
    stuff_ids = [c["trainId"] for c in VKITTI_CATEGORIES
                 if c["isthing"] == 0]
    return {
        "thing_dataset_id_to_contiguous_id":
            {k: i for i, k in enumerate(thing_ids)},
        "stuff_dataset_id_to_contiguous_id":
            {k: i + 1 for i, k in enumerate(stuff_ids)},
        "thing_classes": [c["name"] for c in VKITTI_CATEGORIES
                          if c["isthing"] == 1],
        "stuff_classes": [c["name"] for c in VKITTI_CATEGORIES
                          if c["isthing"] == 0],
    }


def load_vkitti_annotation(root, scenes, view, split=None,
                           flow_dir=None, depth_dir=None):
    """Per-frame records; with ``flow_dir`` every frame after the first
    also names the previous frame as ``ref`` and its flow file (the
    video pair mapper's contract)."""
    records = []
    for scene in scenes:
        base = osp.join(root, scene, view)
        imgs = sorted(glob.glob(osp.join(base,
                                         "frames/rgb/Camera_0/*.jpg")))
        sems = sorted(glob.glob(osp.join(base,
                                         "stuff_labelTrainIds/*.png")))
        pan_json = osp.join(base, "panoptic_gt.json")
        annos = None
        if osp.exists(pan_json):
            with open(pan_json) as f:
                annos = json.load(f)["annotations"]

        idxs = range(len(imgs))
        if split is not None:
            split_file = osp.join(base, "split_511.json")
            if osp.exists(split_file):
                with open(split_file) as f:
                    idxs = json.load(f)[split]

        for k in idxs:
            name = osp.splitext(osp.basename(imgs[k]))[0]
            # the annotation names its PNG (COCO panoptic; prepare_vkitti
            # writes pan_<k>.png): the JAX loader looks for <rgb name>.png
            # and finds none on a prepared tree (fault J7, not copied)
            pan_name = (annos[k].get("file_name", name + ".png") if annos
                        else name + ".png")
            pan_png = osp.join(base, "panoptic_gt_id", pan_name)
            rec = {
                "image_id": f"{scene}_{name}",
                "file_name": imgs[k],
                "scene": scene,
                "frame_index": int(k),
                "sem_seg_file_name": sems[k] if k < len(sems) else None,
                "pan_seg_file_name": (pan_png if osp.exists(pan_png)
                                      else None),
                "segments_info": (annos[k]["segments_info"]
                                  if annos else None),
            }
            if flow_dir is not None and k > 0:
                rec["ref_file_name"] = imgs[k - 1]
                rec["flow_file_name"] = osp.join(
                    flow_dir, f"{scene}_{name}.npy")
            if depth_dir is not None and k > 0:
                rec["depth_file_name"] = osp.join(
                    depth_dir, f"{scene}_{name}.npy")
            records.append(rec)
    return records


def register_vkitti(catalog: Catalog, root, shared_data="shared_data",
                    scenes=VKITTI_SCENES):
    """The reference's registrations (others.py:175-259) in
    ``catalog``."""
    scenes = list(scenes)
    meta = vkitti_metadata()
    flow_dir = osp.join(shared_data, "full_flow")
    for split in ("val", "train"):
        catalog.register(
            f"vkitti_511_{split}",
            lambda split=split: load_vkitti_annotation(
                root, scenes, "clone", split=split, flow_dir=flow_dir),
            meta)
    catalog.register("vkitti_clone",
                     lambda: load_vkitti_annotation(root, scenes, "clone"),
                     meta)
    catalog.register("vkitti_test",
                     lambda: load_vkitti_annotation(root, scenes,
                                                    "15-deg-left"),
                     meta)
    return catalog


def video_pair_mapper(record, load_depth=False):
    """One {ref, cur} sample as numpy (reference
    PanopticFPN_video_DatasetMapper.py:22-150): the BGR image, the
    semantic map, and with a ``ref`` the previous image, its flow and
    (``load_depth``) its depth in metres."""
    import cv2

    out = {"image": cv2.imread(record["file_name"])}  # BGR
    if record.get("sem_seg_file_name"):
        out["sem_seg"] = cv2.imread(record["sem_seg_file_name"],
                                    cv2.IMREAD_GRAYSCALE)
    if record.get("ref_file_name"):
        out["ref_image"] = cv2.imread(record["ref_file_name"])
        if osp.exists(record.get("flow_file_name", "")):
            out["flow"] = np.load(record["flow_file_name"])
        if load_depth and osp.exists(record.get("depth_file_name", "")):
            out["depth"] = np.load(record["depth_file_name"]) / 100.0
    out["segments_info"] = record.get("segments_info")
    return out


def instance_targets(record, image_hw, max_instances=32):
    """Padded, static-shape instance GT of the training losses (the role
    of detectron2's annotations_to_instances in the dataset mapper):
    thing segments of the panoptic_gt_id PNG become bitmasks, tight boxes
    and contiguous class ids, padded to ``max_instances``.

    Returns dict(gt_boxes (M,4) f32, gt_classes (M,) i32, gt_valid (M,)
    bool, gt_masks (M,H,W) f32)."""
    import cv2

    H, W = image_hw
    thing_map = vkitti_metadata()["thing_dataset_id_to_contiguous_id"]

    boxes = np.zeros((max_instances, 4), np.float32)
    classes = np.zeros((max_instances,), np.int32)
    valid = np.zeros((max_instances,), bool)
    masks = np.zeros((max_instances, H, W), np.float32)

    segs = record.get("segments_info")
    pan_file = record.get("pan_seg_file_name")
    if segs and pan_file:
        pan = rgb2id(cv2.imread(pan_file)[:, :, ::-1])
        if pan.shape != (H, W):
            pan = cv2.resize(pan.astype(np.int32), (W, H),
                             interpolation=cv2.INTER_NEAREST)
        n = 0
        for seg in segs:
            cat = seg.get("category_id")
            if cat not in thing_map or n >= max_instances:
                continue
            m = pan == seg["id"]
            ys, xs = np.nonzero(m)
            if ys.size == 0:
                continue
            boxes[n] = (xs.min(), ys.min(), xs.max() + 1.0,
                        ys.max() + 1.0)
            classes[n] = thing_map[cat]
            valid[n] = True
            masks[n] = m
            n += 1
    return {"gt_boxes": boxes, "gt_classes": classes,
            "gt_valid": valid, "gt_masks": masks}


def semantic_targets(sem):
    """A stuff_labelTrainIds map as the semantic head's targets: stuff
    trainIds 1..11 stay, the thing trainIds 12..14 become 0 (the head's
    "things" class, detectron2's panoptic separation), 255 stays ignored.
    prepare_vkitti's maps hold the thing trainIds, which the JAX package
    feeds its 12-class loss as they are: the loss is NaN there (fault J8,
    not copied). Any other value raises."""
    meta = vkitti_metadata()
    lut = np.full(256, -1, np.int32)
    lut[0] = 0
    lut[255] = 255
    for k, v in meta["stuff_dataset_id_to_contiguous_id"].items():
        lut[k] = v
    for k in meta["thing_dataset_id_to_contiguous_id"]:
        lut[k] = 0
    out = lut[np.asarray(sem, np.uint8)]
    if (out < 0).any():
        raise ValueError(f"semantic labels outside the vkitti trainIds: "
                         f"{np.unique(sem[out < 0])}")
    return out


def train_sample_mapper(record, max_instances=32, load_depth=False):
    """A training sample as numpy, the JAX package's layout: image
    (1,H,W,3) f32 BGR, sem_labels (1,H,W) i32 (:func:`semantic_targets`;
    255 where the frame has none), the padded instance targets, and
    ref_image / flow when the record has them (fusion finetune)."""
    out = video_pair_mapper(record, load_depth=load_depth)
    img = out["image"]
    H, W = img.shape[:2]
    sem = out.get("sem_seg")
    if sem is None:
        sem = np.full((H, W), 255, np.uint8)
    sample = {
        "image": img[None].astype(np.float32),
        "sem_labels": semantic_targets(sem)[None],
        **instance_targets(record, (H, W), max_instances),
    }
    if "ref_image" in out:
        sample["ref_image"] = out["ref_image"][None].astype(np.float32)
    if "flow" in out:
        sample["flow"] = out["flow"].astype(np.float32)
    return sample


def pad_to_divisor(sample, divisor=32):
    """Pad a training sample bottom/right to a multiple of ``divisor``, as
    detectron2's ImageList does (size_divisibility 32): images, masks and
    flow with zeros, the semantic labels with the ignore label 255; boxes
    stay. The JAX package's ``train_vps`` feeds vkitti's 375x1242 frames
    unpadded, and its semantic head's levels no longer add up (94x311
    against 94x312: fault J6, not copied)."""
    H, W = sample["image"].shape[1:3]
    ph, pw = (-H) % divisor, (-W) % divisor
    if not (ph or pw):
        return dict(sample)
    out = dict(sample)
    for k in ("image", "ref_image"):
        if k in sample:
            out[k] = np.pad(sample[k], ((0, 0), (0, ph), (0, pw), (0, 0)))
    out["sem_labels"] = np.pad(sample["sem_labels"], ((0, 0), (0, ph),
                                                      (0, pw)),
                               constant_values=255)
    out["gt_masks"] = np.pad(sample["gt_masks"], ((0, 0), (0, ph), (0, pw)))
    if "flow" in sample:
        out["flow"] = np.pad(sample["flow"], ((0, ph), (0, pw), (0, 0)))
    return out
