"""Stage 3: per-scene COCO-panoptic artifacts (port of
:mod:`pvo_tpu.pipeline.preparing`).

Rebuild of reference VPS_Module/tools/3_preparing.py: collect matched
panoptic PNGs per scene into final_vps_res/<scene>/ and emit a
COCO-panoptic-style json (images + annotations with segments_info
derived from the id maps).
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np


def segments_info_from_map(pan_map):
    """Derive segments_info from an id map (cat = id // 10000)."""
    out = []
    ids, counts = np.unique(pan_map, return_counts=True)
    for sid, area in zip(ids, counts):
        if sid == 0:
            continue
        out.append({
            "id": int(sid),
            "category_id": int(sid // 10000),
            "area": int(area),
            "iscrowd": 0,
        })
    return out


def prepare_scene(scene, pan_maps, frame_names, out_root):
    """Write final_vps_res/<scene>/*.png + pred.json."""
    from PIL import Image

    from pvo_tpu_torch.utils.io import id2rgb

    scene_dir = osp.join(out_root, scene)
    os.makedirs(scene_dir, exist_ok=True)

    images, annotations = [], []
    for k, (pan, name) in enumerate(zip(pan_maps, frame_names)):
        fname = f"{name}.png"
        Image.fromarray(id2rgb(pan)).save(osp.join(scene_dir, fname))
        h, w = pan.shape
        images.append({"id": k, "file_name": fname,
                       "height": h, "width": w})
        annotations.append({
            "image_id": k,
            "file_name": fname,
            "segments_info": segments_info_from_map(pan),
        })

    with open(osp.join(scene_dir, "pred.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return scene_dir
