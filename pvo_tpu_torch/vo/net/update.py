"""Dynamic update operator and graph aggregation (port of
:mod:`pvo_tpu.vo.net.update`).

A ConvGRU updates a per-edge hidden state from correlation + motion
features; four heads predict camera-flow delta, dynamic-flow delta,
confidence logits and a dynamic-mask logit delta. GraphAgg mean-pools
hidden states over edges sharing a source frame (scatter-mean with f32
accumulation in a fixed order, :func:`cuda_segsum.sums`) and
produces per-frame BA damping.
Edges are a flat leading dim (E, H, W, C); module names follow the
reference state dict (``update.corr_encoder.0``, ``update.agg.eta.0``).
With ``use_aff_bri`` the operator also predicts per-edge affine
brightness parameters (``update.global_avg_pool.0``,
``update.param_linear.0``), which the photometric training loss applies
to the warped image. :class:`UpdateModule` is the plain DROID operator
(two heads, no dynamic mask) of the vanilla-VO model family.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import cuda_segsum
from .gru import ConvGRU
from .layers import GradientClip

CORR_PLANES = 4 * (2 * 3 + 1) ** 2  # 4 levels x 7x7 window = 196
MASK_NUM = 2


def _head(out):
    return nn.Sequential(nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(128, out, 3, padding=1), GradientClip())


class SegmentSum(torch.autograd.Function):
    """The sums of :func:`cuda_segsum.segment_sum` and the count of rows
    in each, in one launch, with the sums' backward, a gather of the
    output gradient (zero for the dropped rows): the training forward
    runs GraphAgg under grad. The counts take no gradient."""

    @staticmethod
    def forward(ctx, x, seg_ids, n):
        ctx.save_for_backward(seg_ids)
        ctx.n = n
        ones = torch.ones(x.shape[0], device=x.device)
        summed, counts = cuda_segsum.sums([
            cuda_segsum.zero_sum(x, seg_ids, n),
            cuda_segsum.zero_sum(ones, seg_ids, n)])
        ctx.mark_non_differentiable(counts)
        return summed, counts

    @staticmethod
    def backward(ctx, g, _):
        (seg_ids,) = ctx.saved_tensors
        ok = (seg_ids >= 0) & (seg_ids < ctx.n)
        gx = g[seg_ids.clamp(0, ctx.n - 1)]
        ok = ok.reshape((-1,) + (1,) * (g.dim() - 1))
        return torch.where(ok, gx, torch.zeros_like(gx)), None, None


class GraphAgg(nn.Module):
    """Per-frame aggregation of edge hidden states.

    ``seg_ids``: (E,) ids mapping each edge to its source-frame slot in
    [0, num_frames); id == num_frames drops the edge. :meth:`pre` (per-
    edge conv) and :meth:`post` (per-frame convs + heads) are split so a
    caller can accumulate the scatter-sum over edge chunks."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(128, 128, 3, padding=1)
        self.conv2 = nn.Conv2d(128, 128, 3, padding=1)
        self.eta = nn.Sequential(nn.Conv2d(128, 1, 3, padding=1),
                                 GradientClip(), nn.Softplus())
        self.upmask_disp = nn.Sequential(nn.Conv2d(128, 8 * 8 * 9, 1))

    def pre(self, net):
        """(E,128,H,W) NCHW -> per-edge activations before the mean."""
        return torch.relu(self.conv1(net))

    def post(self, mean, upmask=True):
        """Per-frame tail on the scatter-mean (NCHW). Returns (eta,
        upmask) with upmask None when not requested."""
        y = torch.relu(self.conv2(mean))
        eta = 0.01 * self.eta(y)
        return eta, (self.upmask_disp(y) if upmask else None)

    @staticmethod
    def scatter_mean_counts(x, seg_ids, num_frames):
        """f32 scatter-mean of (E, ...) rows into (num_frames, ...) and
        the (num_frames,) f32 count of rows in each; ids outside
        [0, num_frames) are dropped. The sums take the rows in ascending
        order on the CPU and on the card alike."""
        summed, counts = SegmentSum.apply(x.float(), seg_ids, num_frames)
        shape = (num_frames,) + (1,) * (x.dim() - 1)
        return summed / counts.clamp(min=1.0).reshape(shape), counts

    @classmethod
    def scatter_mean(cls, x, seg_ids, num_frames):
        """The means of :meth:`scatter_mean_counts`."""
        return cls.scatter_mean_counts(x, seg_ids, num_frames)[0]

    def forward(self, net, seg_ids, num_frames):
        """net (E,H,W,128) NHWC -> (eta (F,H,W,1), upmask (F,H,W,576))."""
        x = self.pre(net.permute(0, 3, 1, 2))
        mean = self.scatter_mean(x, seg_ids, num_frames).to(x.dtype)
        eta, upmask = self.post(mean)
        return eta.permute(0, 2, 3, 1), upmask.permute(0, 2, 3, 1)


class DynamicUpdateModule(nn.Module):
    """The PVO update operator (4 heads + dynamic mask)."""

    HEADS = (("delta", "delta"), ("delta_dy", "delta_dy"),
             ("weight_logits", "weight"), ("delta_mask", "delta_mask"))

    def __init__(self, use_aff_bri=False):
        super().__init__()
        self.use_aff_bri = use_aff_bri
        self.corr_encoder = nn.Sequential(
            nn.Conv2d(CORR_PLANES, 128, 1), nn.ReLU(),
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU())
        self.flow_encoder = nn.Sequential(
            nn.Conv2d(8, 128, 7, padding=3), nn.ReLU(),
            nn.Conv2d(128, 64, 3, padding=1), nn.ReLU())
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.delta = _head(2)
        self.delta_dy = _head(2)
        self.weight = _head(2)
        self.delta_mask = _head(MASK_NUM)
        self.agg = GraphAgg()
        if use_aff_bri:
            # conv, ReLU, spatial mean, clipped gradient; then (a, b)
            self.global_avg_pool = nn.Sequential(
                nn.Conv2d(128, 128, 3, padding=1), nn.ReLU(),
                nn.AdaptiveAvgPool2d(1), nn.Flatten(), GradientClip())
            self.param_linear = nn.Sequential(nn.Linear(128, 2),
                                              nn.Sigmoid())

    def forward_nchw(self, net, inp, corr, motion, ctx_pre=None,
                     gru_nc=None):
        c = self.corr_encoder(corr)
        f = self.flow_encoder(motion)
        if ctx_pre is not None:
            net = self.gru.forward_nchw(net, torch.cat([c, f], dim=1),
                                        pre=ctx_pre, w_nc=gru_nc)
        else:
            net = self.gru.forward_nchw(net, torch.cat([inp, c, f], dim=1))
        out = {"net": net}
        for key, name in self.HEADS:
            out[key] = getattr(self, name)(net)
        if self.use_aff_bri:
            out["aff_params"] = self.param_linear(self.global_avg_pool(net))
        return out

    def forward(self, net, inp, corr, motion, ctx_pre=None, gru_nc=None):
        """All inputs (E, H, W, C) NHWC: hidden 128, context 128,
        corr 196, motion 8. With ``ctx_pre`` (NHWC gate contributions of
        the context features, see factor_graph.gru_ctx_pre) ``inp`` is
        ignored and ``gru_nc`` holds the ctx-sliced gate kernels.
        Returns dict: net, delta, delta_dy, weight_logits, delta_mask and,
        with ``use_aff_bri``, aff_params (E, 2)."""
        p = (lambda t: None if t is None else t.permute(0, 3, 1, 2))
        pre = None if ctx_pre is None else tuple(p(t) for t in ctx_pre)
        out = self.forward_nchw(p(net), p(inp), p(corr), p(motion),
                                ctx_pre=pre, gru_nc=gru_nc)
        return {k: v.permute(0, 2, 3, 1) if v.dim() == 4 else v
                for k, v in out.items()}


class UpdateModule(nn.Module):
    """The plain (non-dynamic) DROID update operator (port of
    ``pvo_tpu.vo.net.update.UpdateModule``; reference droid_net.py:98-163):
    corr and flow encoders, ConvGRU(128), the ``delta`` and ``weight``
    heads; state-dict names as the reference's (``corr_encoder.0``,
    ``flow_encoder.2``, ``gru.convz``, ``delta.0``, ``weight.2``, under
    ``update.`` in a checkpoint). Its parameters are f32; on the card a
    caller converts it to :func:`pvo_tpu_torch.vo.system.operator_dtype`,
    the dynamic operator's rule. The flow encoder takes the 4 motion
    planes of the plain model: camera flow and residual."""

    def __init__(self):
        super().__init__()
        self.corr_encoder = nn.Sequential(
            nn.Conv2d(CORR_PLANES, 128, 1), nn.ReLU(),
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU())
        self.flow_encoder = nn.Sequential(
            nn.Conv2d(4, 128, 7, padding=3), nn.ReLU(),
            nn.Conv2d(128, 64, 3, padding=1), nn.ReLU())
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.delta = _head(2)
        self.weight = _head(2)

    def forward(self, net, inp, corr, motion):
        """All inputs (E, H, W, C) NHWC: hidden 128, context 128, corr
        196, motion 4. Returns dict: net, delta (E, H, W, 2) and weight,
        the sigmoid of the weight head."""
        p = (lambda t: t.permute(0, 3, 1, 2))
        c = self.corr_encoder(p(corr))
        f = self.flow_encoder(p(motion))
        net = self.gru.forward_nchw(p(net), torch.cat([p(inp), c, f], 1))
        q = (lambda t: t.permute(0, 2, 3, 1))
        return {"net": q(net), "delta": q(self.delta(net)),
                "weight": q(torch.sigmoid(self.weight(net)))}
