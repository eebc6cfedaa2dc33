"""Feature Pyramid Network on ResNet features, NCHW (the port's own copy of
:mod:`pvo_tpu.vps.fpn`).

detectron2's FPN with its bottom-up network inside it (state-dict names
``bottom_up.*``, ``fpn_lateral{2..5}``, ``fpn_output{2..5}``): 1x1 lateral
convs, nearest 2x top-down upsampling (cropped for odd sizes), 3x3 output
convs, and p6 as the stride-2 subsample of p5 (LastLevelMaxPool).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .resnet import ResNet50

IN_CHANNELS = (256, 512, 1024, 2048)


def upsample2x_nearest(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class FPN(nn.Module):
    def __init__(self, bottom_up=None, out_channels=256):
        super().__init__()
        self.bottom_up = bottom_up if bottom_up is not None else ResNet50()
        for lvl, cin in zip((2, 3, 4, 5), IN_CHANNELS):
            self.add_module(f"fpn_lateral{lvl}",
                            nn.Conv2d(cin, out_channels, 1))
            self.add_module(f"fpn_output{lvl}",
                            nn.Conv2d(out_channels, out_channels, 3,
                                      padding=1))

    def top_down(self, feats):
        """feats: dict res2..res5. Returns dict p2..p6."""
        laterals = [getattr(self, f"fpn_lateral{lvl}")(feats[f"res{lvl}"])
                    for lvl in (2, 3, 4, 5)]
        tds = [laterals[-1]]
        for lat in laterals[-2::-1]:
            td = upsample2x_nearest(tds[-1])
            # crop in case of odd input sizes
            td = td[:, :, :lat.shape[2], :lat.shape[3]]
            tds.append(lat + td)
        tds = tds[::-1]  # p2..p5 order
        out = {f"p{lvl}": getattr(self, f"fpn_output{lvl}")(td)
               for lvl, td in zip((2, 3, 4, 5), tds)}
        out["p6"] = F.max_pool2d(out["p5"], 1, stride=2)
        return out

    def forward(self, x):
        return self.top_down(self.bottom_up(x))
