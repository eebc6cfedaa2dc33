"""DroidNet: the recurrent dense-VO network with its BA layer (port of
:mod:`pvo_tpu.vo.net.droidnet`).

The container mirrors the reference ``DroidNet`` state dict (``fnet``,
``cnet``, ``update`` with ``update.agg``), so a reference checkpoint
loads with ``load_state_dict`` (:mod:`pvo_tpu_torch.utils.convert`).

:meth:`DroidNet.forward` is the iterative forward over a static frame
graph: each step does corr lookup -> GRU -> heads -> dynamic-mask gating
-> 2 BA steps -> reprojection and collects per-step poses, upsampled
disparities, residuals, masks and flows. The flow/depth export
(:mod:`pvo_tpu_torch.scripts.test_vo2`) runs it on 2-frame windows.
Per-step state is detached at step start as in the JAX forward, so the
training slice can reuse it; ``remat`` and ``use_aff_bri`` are training
features and are left to that slice.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.geom.ba import bundle_adjust
from pvo_tpu_torch.geom.upsample import cvx_upsample, upsample_inter

from . import corr as corr_ops
from . import cuda_corr
from .extractor import BasicEncoder
from .layers import init_conv_weights
from .update import MASK_NUM, DynamicUpdateModule

DY_THRESH = 0.5

# ImageNet statistics used to normalize RGB inputs (values in [0,1]).
RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)


# (mean, std) tensors by device, made once: a copy from the host inside
# a captured CUDA graph would wait for the card
_RGB_STATS = {}


def normalize_images(images_u8_rgb):
    """uint8 RGB (..., H, W, 3) -> normalized float32 (..., H, W, 3)."""
    x = images_u8_rgb.float() / 255.0
    if x.device not in _RGB_STATS:
        _RGB_STATS[x.device] = tuple(
            torch.tensor(v, dtype=torch.float32, device=x.device)
            for v in (RGB_MEAN, RGB_STD))
    mean, std = _RGB_STATS[x.device]
    return (x - mean) / std


class DroidNet(nn.Module):
    def __init__(self, use_aff_bri=False):
        super().__init__()
        self.use_aff_bri = use_aff_bri
        self.fnet = BasicEncoder(output_dim=128, norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=256, norm_fn="none")
        self.update = DynamicUpdateModule(use_aff_bri)

    @classmethod
    def from_seed(cls, seed=0, use_aff_bri=False):
        """Random weights (kaiming-normal convs, zero biases; the
        affine-brightness head's linear layer keeps torch's default
        init) drawn from a ``torch.Generator`` seeded with ``seed``."""
        net = cls(use_aff_bri)
        gen = torch.Generator().manual_seed(seed)
        init_conv_weights(net, gen)
        if use_aff_bri:
            lin = net.update.param_linear[0]
            bound = lin.in_features ** -0.5
            with torch.no_grad():
                lin.weight.uniform_(-bound, bound, generator=gen)
                lin.bias.uniform_(-bound, bound, generator=gen)
        return net

    def extract_features(self, images, dtype=None):
        """images: (B, F, H, W, 3) uint8 RGB. Returns fmaps, net, inp at
        1/8 resolution, each (B, F, h, w, 128). ``dtype`` casts the
        normalized input (the parameters must already have it)."""
        x = normalize_images(images)
        if dtype is not None:
            x = x.to(dtype)
        fmaps = self.fnet(x)
        net, inp = self.cnet(x).split(128, dim=-1)
        return fmaps, torch.tanh(net), torch.relu(inp)

    @staticmethod
    def _corr_fn(fmaps, ii, jj, corr_impl):
        """The per-step lookup coords (E, h, w, 2) -> (E, h, w, 196) for
        frames ``fmaps`` (F, h, w, C) and edge index tensors ii, jj.

        On the card the routing is the JAX accelerator path's: a narrow
        geometry (:func:`cuda_corr.volume_cache_ok`) builds the volumes
        once (K1) and extracts per step (K2); a wide one takes the fused
        lookup (K3) on every step, on a pyramid pooled once. On the CPU,
        or with ``corr_impl="plain"``, the plain pyramid.

        The kernels have no backward, so ``corr_impl="cuda"`` is refused
        when a gradient would have to pass the lookup (grad mode on and
        ``fmaps`` requiring grad): fnet would get none, and nothing would
        say so. Training passes ``"plain"``."""
        if corr_impl not in ("cuda", "plain"):
            raise ValueError(f"corr_impl={corr_impl!r}: 'cuda' or 'plain'")
        if corr_impl == "cuda" and torch.is_grad_enabled() and \
                fmaps.requires_grad:
            raise RuntimeError(
                "corr_impl='cuda' under grad: the corr kernels have no "
                "backward; pass corr_impl='plain' to train")
        h, w = fmaps.shape[1:3]
        if corr_impl == "plain" or fmaps.device.type != "cuda":
            pyramid = corr_ops.build_pyramid(fmaps[ii], fmaps[jj])
            return lambda c: corr_ops.lookup(pyramid, c)
        if cuda_corr.volume_cache_ok(h, w):
            vols = cuda_corr.build_volumes(fmaps[ii].contiguous(),
                                           fmaps[jj].contiguous())
            return lambda c: cuda_corr.corr_extract(vols, c.contiguous())
        fmaps = fmaps.contiguous()
        pyr = cuda_corr.lookup_pyramid(fmaps)
        # the kernel indexes the edges' frames with int32: converted once
        ii, jj = ii.int(), jj.int()
        return lambda c: cuda_corr.corr_lookup_indexed(fmaps, pyr, ii, jj,
                                                       c.contiguous())

    def forward(self, poses, images, disps, intrinsics, ii, jj,
                num_steps=12, fixedp=2, ret_flow=False, downsample=False,
                remat=False, final_only=False, corr_impl="cuda",
                compute_dtype=None):
        """The iterative forward on one sample.

        Args:
          poses: (1, F, 7) initial w2c SE3.
          images: (1, F, H, W, 3) uint8 RGB.
          disps: (1, F, h, w) initial inverse depth (1/8 res).
          intrinsics: (1, F, 4) at 1/8 resolution.
          ii, jj: host edge lists (the frame graph is static).
          remat: recompute each step's activations in the backward
            (``torch.utils.checkpoint``): a 15-step unroll at the 200x400
            crop holds 15 steps of GRU/BA activations otherwise. The
            values and gradients are those of ``remat=False``.
          final_only: compute the upsampled outputs (disps_up, masks_up,
            flows) only for the last step. They are functions of the
            step's state with no feedback into the recurrence, so the
            last entries equal those of ``final_only=False`` exactly.
          corr_impl: "cuda" (the hand-written kernels for tensors on the
            card; inference only: refused under grad) or "plain" (the
            plain pyramid, differentiable). Tensors on the CPU take the
            plain pyramid.
          compute_dtype: run the encoders and the update operator in
            this dtype (``torch.bfloat16`` on a module converted with
            ``.to(torch.bfloat16)``); everything the BA consumes is cast
            back to f32.
        Returns a dict of per-step lists: poses, disps_up, residuals,
        masks_up, (with ``ret_flow``) flows: at 1/8 res with
        ``downsample``, else upsampled x8 in full-res pixels, and (with
        ``use_aff_bri``) aff_params (1, E, 2).
        """
        ii = np.asarray(ii).reshape(-1)
        jj = np.asarray(jj).reshape(-1)
        B, F = images.shape[:2]
        if B != 1:
            raise ValueError("the forward is per sample: B must be 1")

        fmaps, net_all, inp_all = self.extract_features(
            images, dtype=compute_dtype)
        h, w = fmaps.shape[2:4]
        dev = fmaps.device
        ii_t = torch.as_tensor(ii, dtype=torch.long, device=dev)
        jj_t = torch.as_tensor(jj, dtype=torch.long, device=dev)
        kx = torch.as_tensor(np.unique(ii), dtype=torch.long, device=dev)

        net = net_all[0, ii_t]
        inp = inp_all[0, ii_t]
        corr_fn = self._corr_fn(fmaps[0], ii_t, jj_t, corr_impl)

        coords0 = projective.coords_grid(h, w, device=dev)
        coords1, _ = projective.projective_transform(
            poses, disps, intrinsics, ii_t, jj_t)
        target_cam = coords1
        delta_dy = torch.zeros_like(coords1)
        raw_mask = coords1.new_zeros(coords1.shape[:-1] + (MASK_NUM,))

        def one_step(net, poses, disps, coords1, target_cam, delta_dy,
                     raw_mask, want_up):
            corr = corr_fn(coords1[0])
            cam_flow = coords1 - coords0
            motion = torch.cat([cam_flow, cam_flow + delta_dy,
                                target_cam - coords1, raw_mask], dim=-1)
            motion = motion.clamp(-64.0, 64.0)

            upd = self.update(net, inp, corr.to(inp.dtype),
                              motion[0].to(inp.dtype))
            net = upd["net"]

            raw_mask = raw_mask + upd["delta_mask"][None]
            mask = torch.sigmoid(raw_mask)
            bin_mask = (mask >= DY_THRESH).to(mask.dtype)

            target_cam = coords1 + upd["delta"][None].float()
            weight = torch.sigmoid(upd["weight_logits"][None].float() +
                                   (1 - bin_mask) * 10.0)

            eta, upmask = self.update.agg(net, ii_t, F)
            eta_k = eta[kx, ..., 0][None].float()

            for _ in range(2):
                poses, disps = bundle_adjust(
                    target_cam, weight, eta_k, poses, disps, intrinsics,
                    ii, jj, fixedp=fixedp)

            coords1, valid = projective.projective_transform(
                poses, disps, intrinsics, ii_t, jj_t)
            residual = (target_cam - coords1) * valid
            delta_dy = upd["delta_dy"][None].float() * (1 - bin_mask)
            disps_up = (cvx_upsample(disps[0, kx, :, :, None],
                                     upmask[kx].float())[None, ..., 0]
                        if want_up else None)
            aff = upd["aff_params"][None] if self.use_aff_bri else None
            return (net, poses, disps, coords1, target_cam, delta_dy,
                    raw_mask, residual, mask, disps_up, aff)

        out = {k: [] for k in ("poses", "disps_up", "residuals",
                               "masks_up", "flows", "aff_params")}
        for it in range(num_steps):
            poses, disps, coords1, target_cam, delta_dy, raw_mask = (
                t.detach() for t in (poses, disps, coords1, target_cam,
                                     delta_dy, raw_mask))
            want_up = (not final_only) or (it == num_steps - 1)
            args = (net, poses, disps, coords1, target_cam, delta_dy,
                    raw_mask, want_up)
            (net, poses, disps, coords1, target_cam, delta_dy, raw_mask,
             residual, mask, disps_up, aff) = (
                checkpoint(one_step, *args, use_reentrant=False) if remat
                else one_step(*args))

            out["poses"].append(poses)
            out["residuals"].append(residual)
            if self.use_aff_bri:
                out["aff_params"].append(aff)
            if not want_up:
                continue
            out["disps_up"].append(disps_up)
            out["masks_up"].append(upsample_inter(mask))
            if ret_flow:
                flow = coords1 + delta_dy - coords0
                out["flows"].append(flow if downsample
                                    else upsample_inter(flow * 8.0))
        return out
