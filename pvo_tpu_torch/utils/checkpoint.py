"""Checkpoint / resume (port of :mod:`pvo_tpu.utils.checkpoint`).

The reference saves ``torch.save`` state dicts every 2000 steps and
restores with ``--ckpt`` (train.py:301-311); VPS resumes through
detectron2's ``resume_or_load``. Here a checkpoint is a state dict
written with ``torch.save`` as ``<directory>/<step:06d>.pth``; a
DroidNet's state dict keeps the reference key names, so such a file also
loads through :func:`pvo_tpu_torch.utils.convert.load_droidnet_torch`.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
from typing import Any, Optional

import torch


def _path(directory, step):
    return osp.join(directory, f"{int(step):06d}.pth")


def latest_step(directory) -> Optional[int]:
    steps = [int(osp.basename(p)[:-4]) for p in
             glob.glob(osp.join(directory, "[0-9]*.pth"))
             if osp.basename(p)[:-4].isdigit()]
    return max(steps) if steps else None


def save(directory, step, tree):
    """Write ``tree`` (a state dict, or an object with ``state_dict``)
    as the checkpoint of ``step``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    if hasattr(tree, "state_dict"):
        tree = tree.state_dict()
    path = _path(directory, step)
    torch.save(tree, path)
    return path


def load(directory, step=None, template=None):
    """The checkpoint of ``step`` (default: the latest), on the CPU, or
    None when there is none. With ``template`` (an object with
    ``load_state_dict``), loaded into it, which is returned."""
    step = step if step is not None else latest_step(directory)
    if step is None or not osp.exists(_path(directory, step)):
        return None
    sd = torch.load(_path(directory, step), map_location="cpu")
    if template is not None:
        template.load_state_dict(sd)
        return template
    return sd


def resume_or_load(directory, init, torch_path: Optional[str] = None,
                   convert=None) -> Any:
    """detectron2-style resume_or_load: prefer the latest checkpoint in
    ``directory`` (loaded into ``init``); else import a reference
    checkpoint via ``convert(torch_path)``; else return ``init``."""
    restored = load(directory, template=init)
    if restored is not None:
        return restored
    if torch_path and osp.exists(torch_path) and convert:
        return convert(torch_path)
    return init
