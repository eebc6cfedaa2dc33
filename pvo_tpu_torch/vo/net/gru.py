"""ConvGRU with gated global context (port of :mod:`pvo_tpu.vo.net.gru`).

A 3x3 convolutional GRU whose z/r/q gates each receive an additive
global term: the sigmoid-gated spatial mean of the hidden state passed
through 1x1 convs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

GATES = ("convz", "convr", "convq")


class ConvGRU(nn.Module):
    def __init__(self, hidden=128, input_dim=128 + 128 + 64):
        super().__init__()
        cin = hidden + input_dim
        self.convz = nn.Conv2d(cin, hidden, 3, padding=1)
        self.convr = nn.Conv2d(cin, hidden, 3, padding=1)
        self.convq = nn.Conv2d(cin, hidden, 3, padding=1)
        self.w = nn.Conv2d(hidden, hidden, 1)
        self.convz_glo = nn.Conv2d(hidden, hidden, 1)
        self.convr_glo = nn.Conv2d(hidden, hidden, 1)
        self.convq_glo = nn.Conv2d(hidden, hidden, 1)

    def _gate(self, name, x, w_nc):
        conv = getattr(self, name)
        weight = conv.weight if w_nc is None else w_nc[name]
        return F.conv2d(x, weight, conv.bias, padding=1)

    def forward_nchw(self, net, inp, pre=None, w_nc=None):
        """NCHW core. ``pre``: optional (pz, pr, pq) gate contributions
        of input channels NOT in ``inp``, applied outside the recurrent
        loop; ``w_nc`` then holds the gate kernels with those channels
        removed (see factor_graph.split_gru_ctx)."""
        net_inp = torch.cat([net, inp], dim=1)
        glo = torch.sigmoid(self.w(net))
        glo = torch.mean(glo * net, dim=(-2, -1), keepdim=True)

        z_l = self._gate("convz", net_inp, w_nc) + self.convz_glo(glo)
        r_l = self._gate("convr", net_inp, w_nc) + self.convr_glo(glo)
        if pre is not None:
            z_l = z_l + pre[0]
            r_l = r_l + pre[1]
        z = torch.sigmoid(z_l)
        r = torch.sigmoid(r_l)
        q_l = (self._gate("convq", torch.cat([r * net, inp], dim=1), w_nc)
               + self.convq_glo(glo))
        if pre is not None:
            q_l = q_l + pre[2]
        q = torch.tanh(q_l)
        return (1 - z) * net + z * q

    def forward(self, net, inp):
        """net: (B,H,W,hidden), inp: (B,H,W,I), NHWC."""
        out = self.forward_nchw(net.permute(0, 3, 1, 2),
                                inp.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1)
