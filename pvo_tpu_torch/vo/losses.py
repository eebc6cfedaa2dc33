"""Training losses for the VO network (port of :mod:`pvo_tpu.vo.losses`).

The reference loss library (VO_Module/droid_slam/geom/losses.py):
geodesic pose loss with Sim3 scale fitting, BA residual loss,
camera-flow / full-flow EPE losses, photometric losses with SSIM and
occlusion masks, and the dynamic-mask label losses (GT-supervised and
self-labeled). Every per-iteration list is weighted gamma^(n-i-1) as in
the reference. The inputs are the per-step outputs of
:meth:`pvo_tpu_torch.vo.net.droidnet.DroidNet.forward`, channels last;
edge lists are host arrays. Where the JAX module stops a gradient, this
one detaches.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.lie import se3, sim3

GAMMA = 0.9


def _step_weights(n, gamma=GAMMA):
    return [gamma ** (n - i - 1) for i in range(n)]


def _index(idx, device):
    return torch.as_tensor(np.asarray(idx).reshape(-1), dtype=torch.long,
                           device=device)


def ring_graph(F):
    """The |i - j| = 1 edges of F frames, in the JAX module's order."""
    ii, jj = [], []
    for i in range(F):
        for j in (i - 1, i + 1):
            if 0 <= j < F:
                ii.append(i)
                jj.append(j)
    return np.asarray(ii), np.asarray(jj)


def fit_scale(Ps, Gs):
    """Least-squares scale aligning translations (losses.py:24-30)."""
    b = Ps.shape[0]
    t1 = Ps[..., :3].detach().reshape(b, -1)
    t2 = Gs[..., :3].detach().reshape(b, -1)
    return torch.sum(t1 * t2, -1) / (torch.sum(t2 * t2, -1) + 1e-8)


def _mean_norm(x):
    return torch.mean(torch.linalg.norm(x, dim=-1))


def geodesic_loss(Ps, Gs_list, ii, jj, gamma=GAMMA, do_scale=True):
    """Per-iteration relative-pose loss (losses.py:32-76).

    Ps: (B, F, 7) GT w2c. Gs_list: list of (B, F, 7) estimates.
    """
    ii = _index(ii, Ps.device)
    jj = _index(jj, Ps.device)
    dP = se3.mul(Ps[:, jj], se3.inv(Ps[:, ii]))

    total = 0.0
    for i, w in enumerate(_step_weights(len(Gs_list), gamma)):
        dG = se3.mul(Gs_list[i][:, jj], se3.inv(Gs_list[i][:, ii]))
        if do_scale:
            s = fit_scale(dP, dG)
            dG_s = torch.cat([dG, s[:, None, None].expand(
                dG.shape[:-1] + (1,))], dim=-1)
            d = sim3.log(sim3.mul(dG_s, sim3.inv(sim3.from_se3(dP))))
            total = total + w * (_mean_norm(d[..., :3]) +
                                 _mean_norm(d[..., 3:6]) +
                                 0.05 * _mean_norm(d[..., 6:]))
        else:
            d = se3.log(se3.mul(dG, se3.inv(dP)))
            total = total + w * (_mean_norm(d[..., :3]) +
                                 _mean_norm(d[..., 3:]))

    dE = d.detach()
    r_err = (180.0 / np.pi) * torch.linalg.norm(dE[..., 3:6], dim=-1)
    t_err = torch.linalg.norm(dE[..., :3], dim=-1)
    metrics = {
        "rot_error": r_err.mean(),
        "tr_error": t_err.mean(),
        "bad_rot": (r_err < 0.1).float().mean(),
        "bad_tr": (t_err < 0.01).float().mean(),
    }
    return total, metrics


def residual_loss(residuals: List, gamma=GAMMA):
    """L1 on BA residuals per iteration (losses.py:79-88)."""
    total = 0.0
    for r, w in zip(residuals, _step_weights(len(residuals), gamma)):
        total = total + w * torch.mean(torch.abs(r))
    return total, {"residual": total}


def cam_flow_loss(Ps, disps, poses_list, disps_list, intrinsics,
                  gamma=GAMMA):
    """EPE between GT camera-induced flow and estimated flow over the
    |i-j|=1 ring graph (losses.py:91-121). disps_list entries are at
    FULL resolution (upsampled); GT disps full resolution."""
    ii, jj = ring_graph(Ps.shape[1])
    coords0, val0 = projective.projective_transform(
        Ps, disps, intrinsics, ii, jj)
    val0 = val0 * (disps[:, _index(ii, disps.device)] > 0).to(
        val0.dtype)[..., None]

    total = 0.0
    for i, w in enumerate(_step_weights(len(poses_list), gamma)):
        coords1, val1 = projective.projective_transform(
            poses_list[i], disps_list[i], intrinsics, ii, jj)
        v = (val0 * val1)[..., 0]
        epe = v * torch.linalg.norm(coords1 - coords0, dim=-1)
        total = total + w * torch.mean(epe)

    epe_flat = epe.detach().reshape(-1)
    sel = v.detach().reshape(-1) > 0.5
    denom = sel.sum().clamp(min=1)
    zero = torch.zeros_like(epe_flat)
    metrics = {
        "f_error": torch.where(sel, epe_flat, zero).sum() / denom,
        "1px": torch.where(sel, (epe_flat < 1.0).to(epe_flat.dtype),
                           zero).sum() / denom,
    }
    return total, metrics


def flow_loss(fo_flows, ba_flows, full_flows, gamma=GAMMA):
    """Supervised full-flow loss vs GT forward/backward flows
    (losses.py:124-148). full_flows entries: (B, 2(F-1), H, W, 2)
    ordered [fwd_0, bwd_0, fwd_1, bwd_1, ...]."""
    fo_vals = fo_flows[..., 2]
    ba_vals = ba_flows[..., 2]
    total = 0.0
    for f, w in zip(full_flows, _step_weights(len(full_flows), gamma)):
        fo_e = torch.mean(torch.linalg.norm(
            f[:, 0::2] - fo_flows[..., :2], dim=-1) * fo_vals)
        ba_e = torch.mean(torch.linalg.norm(
            f[:, 1::2] - ba_flows[..., :2], dim=-1) * ba_vals)
        f_e = 0.5 * (fo_e + ba_e)
        total = total + w * f_e
    return total, {"pure_f_error": f_e}


# ---------------- photometric ----------------


def _reflect_index(n, device):
    """Rows of a 1-pixel reflection pad: [1, 0, ..., n-1, n-2]."""
    return torch.as_tensor([1] + list(range(n)) + [n - 2], device=device)


def _avg3_reflect(x):
    """3x3 average pool, stride 1, reflection-padded, (B, H, W, C) (the
    reference SSIM module's AvgPool2d(3,1) after ReflectionPad2d(1))."""
    H, W = x.shape[1], x.shape[2]
    xp = x[:, _reflect_index(H, x.device)][:, :, _reflect_index(W, x.device)]
    s = 0.0
    for dy in range(3):
        for dx in range(3):
            s = s + xp[:, dy:dy + H, dx:dx + W, :]
    return s * (1.0 / 9.0)


def ssim_loss(x, y):
    """clamp((1 - SSIM)/2, 0, 1) map with the reference SSIM module's
    semantics (losses.py:365-398): 3x3 average pooling with reflection
    padding, the loss clamped to [0, 1]."""
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    mx = _avg3_reflect(x)
    my = _avg3_reflect(y)
    mxx = _avg3_reflect(x * x) - mx * mx
    myy = _avg3_reflect(y * y) - my * my
    mxy = _avg3_reflect(x * y) - mx * my
    num = (2 * mx * my + c1) * (2 * mxy + c2)
    den = (mx * mx + my * my + c1) * (mxx + myy + c2)
    return torch.clamp((1.0 - num / den) / 2.0, 0.0, 1.0)


def bilinear_sample(img, coords, pad_mode="zeros"):
    """Sample (B, H, W, C) at coords (B, H, W, 2) [x, y] in pixels.

    pad_mode 'zeros' or 'border' (torch grid_sample semantics with
    align_corners=True). Differentiable in ``img`` and ``coords``."""
    B, H, W, C = img.shape
    x, y = coords[..., 0], coords[..., 1]
    if pad_mode == "border":
        x = torch.clamp(x, 0, W - 1)
        y = torch.clamp(y, 0, H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = img.reshape(B, H * W, C)

    def gather(yi, xi):
        yc = torch.clamp(yi, 0, H - 1).long()
        xc = torch.clamp(xi, 0, W - 1).long()
        idx = (yc * W + xc).reshape(B, -1, 1).expand(-1, -1, C)
        out = torch.gather(flat, 1, idx).reshape(B, H, W, C)
        if pad_mode == "border":
            return out
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        return out * inb[..., None].to(img.dtype)

    w00 = ((1 - fy) * (1 - fx))[..., None]
    w01 = ((1 - fy) * fx)[..., None]
    w10 = (fy * (1 - fx))[..., None]
    w11 = (fy * fx)[..., None]
    return (w00 * gather(y0, x0) + w01 * gather(y0, x0 + 1) +
            w10 * gather(y0 + 1, x0) + w11 * gather(y0 + 1, x0 + 1))


def mean_on_mask(diff, val_pix, min_count=10000):
    """Mean over the valid (mask-expanded) entries, with the reference's
    semantics (losses.py:400-408): 0 when at most ``min_count`` entries
    are valid ('most pixels are masked')."""
    mask = torch.broadcast_to(val_pix, diff.shape)
    s = torch.sum(mask)
    mean = torch.sum(diff * mask) / torch.clamp(s, min=1.0)
    return torch.where(s > min_count, mean, torch.zeros_like(mean))


def _reprojection_error(img0, warped, use_ssim):
    """0.85 SSIM + 0.15 L1 when use_ssim, else L1 (reference
    compute_reprojection_loss)."""
    l1 = torch.abs(warped - img0)
    if not use_ssim:
        return l1
    return 0.85 * ssim_loss(warped, img0) + 0.15 * l1


def _in_bounds(coords, ht, wd):
    return ((coords[..., 0] >= 0) & (coords[..., 0] <= wd - 1) &
            (coords[..., 1] >= 0) & (coords[..., 1] <= ht - 1))


def photo_loss_full(images, full_flows, vals, ii, jj, gamma=GAMMA,
                    use_ssim=False, aff_params=None, downsample=True):
    """Photometric loss along the FULL (camera+dynamic) flow
    (reference losses.py:151-211).

    images: (B, F, H, W, 3) in [0, 255]; full_flows: per-step
    (B, N, h, w, 2) at 1/8 res when downsample; vals: (B, F, H, W)
    validity (e.g. GT mask validity) or None; aff_params: per-step
    (B, N, 2) affine brightness (a, b + 0.5) applied to the warped image.
    """
    ii = _index(ii, images.device)
    jj = _index(jj, images.device)
    if downsample:
        images = images[:, :, 3::8, 3::8]
        if vals is not None:
            vals = vals[:, :, 3::8, 3::8]
    B, F, ht, wd, C = images.shape
    img0 = images[:, ii].reshape(-1, ht, wd, C) / 255.0
    img1 = images[:, jj].reshape(-1, ht, wd, C) / 255.0
    v_all = (vals[:, ii].reshape(-1, ht, wd) if vals is not None
             else img0.new_ones((img0.shape[0], ht, wd)))
    grid = projective.coords_grid(ht, wd, device=images.device)

    total = 0.0
    for i, w in enumerate(_step_weights(len(full_flows), gamma)):
        coords = (grid + full_flows[i]).reshape(-1, ht, wd, 2)
        val_pix = _in_bounds(coords, ht, wd).to(img0.dtype) * v_all
        warped = bilinear_sample(img1, coords, pad_mode="border")
        if aff_params is not None:
            a = aff_params[i][..., 0].reshape(-1, 1, 1, 1)
            b = (aff_params[i][..., 1] - 0.5).reshape(-1, 1, 1, 1)
            warped = warped * a + b
        diff = _reprojection_error(img0, warped, use_ssim)
        p_e = mean_on_mask(diff, val_pix[..., None])
        total = total + w * p_e
    return total, {"ph_error": p_e}


def photo_loss_cam(images, poses_list, disps_list, intrinsics,
                   static_masks, gamma=GAMMA, use_ssim=True):
    """Photometric loss along the CAMERA-induced flow over the ring
    graph, masked to static pixels (reference losses.py:214-265).

    images (B,F,H,W,3) 0..255 FULL res; disps_list entries full-res;
    static_masks (B,F,H,W) 1=static.
    """
    B, F, H, W, C = images.shape
    ii, jj = ring_graph(F)
    ii_t, jj_t = _index(ii, images.device), _index(jj, images.device)
    img0 = images[:, ii_t].reshape(-1, H, W, C) / 255.0
    img1 = images[:, jj_t].reshape(-1, H, W, C) / 255.0
    m_all = static_masks[:, ii_t].reshape(-1, H, W)

    total = 0.0
    for i, w in enumerate(_step_weights(len(poses_list), gamma)):
        coords, val0 = projective.projective_transform(
            poses_list[i], disps_list[i], intrinsics, ii, jj)
        coords = coords.reshape(-1, H, W, 2)
        val_pix = (_in_bounds(coords, H, W).to(img0.dtype) *
                   val0.reshape(-1, H, W) * m_all)
        warped = bilinear_sample(img1, coords, pad_mode="border")
        diff = _reprojection_error(img0, warped, use_ssim)
        p_e = mean_on_mask(diff, val_pix[..., None])
        total = total + w * p_e
    return total, {"ph_cam_error": p_e}


def unsup_occ_vals(poses_list, disps_list, intrinsics, ii, jj,
                   thresh=0.15):
    """Occlusion validity from projected-depth consistency (reference
    losses.py:268-320, on the final step's estimate): a pixel is valid
    if its depth reprojected into frame jj agrees with frame jj's own
    depth."""
    poses, disps = poses_list[-1], disps_list[-1]
    coords, valid = projective.projective_transform(
        poses, disps, intrinsics, ii, jj, return_depth=True)
    d_proj = coords[..., 2]
    B, N, H, W = d_proj.shape
    d_obs = bilinear_sample(
        disps[:, _index(jj, disps.device)].reshape(-1, H, W, 1),
        coords[..., :2].reshape(-1, H, W, 2),
        pad_mode="border").reshape(B, N, H, W)
    rel = torch.abs(d_proj - d_obs) / torch.clamp(d_obs, min=1e-3)
    return (rel < thresh).to(d_proj.dtype) * valid[..., 0]


def unsup_dy_vals(vals, dy_masks, ii):
    """Fold dynamic-region masks into occlusion validity masks
    (reference losses.py:323-345): val = clamp(val + (1 - dy), 0, 1).

    vals: (B, N, H, W) or a per-step list of such. dy_masks: a per-frame
    (B, F, H', W') tensor (full-res inputs reduced with ``3::8``
    subsampling) gathered at edge sources ``ii``, or a per-step list of
    edge-aligned (B, N, H, W) masks.
    """
    single = not isinstance(vals, (list, tuple))
    vlist = [vals] if single else list(vals)

    if isinstance(dy_masks, (list, tuple)):
        dlist = [d.reshape(v.shape) for d, v in zip(dy_masks, vlist)]
    else:
        m = dy_masks
        if m.shape[-2:] != vlist[0].shape[-2:]:
            m = m[..., 3::8, 3::8]
        dlist = [m[:, _index(ii, m.device)]] * len(vlist)

    out = [torch.clamp(v + (1.0 - d), 0.0, 1.0)
           for v, d in zip(vlist, dlist)]
    return out[0] if single else out


def photo_loss(images_pairs, full_flows, use_ssim=True, gamma=GAMMA,
               occ_masks=None):
    """Photometric warp loss by full flow (losses.py:151-211).

    images_pairs: (I_src (B,N,H,W,3), I_dst (B,N,H,W,3)) in [0,1]
    aligned with the flow edge list. full_flows: per-step (B,N,H,W,2).
    """
    I_src, I_dst = images_pairs
    B, N, H, W, C = I_src.shape
    grid = projective.coords_grid(H, W, device=I_src.device)

    total = 0.0
    for f, w in zip(full_flows, _step_weights(len(full_flows), gamma)):
        coords = grid + f
        warped = bilinear_sample(
            I_dst.reshape(B * N, H, W, C),
            coords.reshape(B * N, H, W, 2)).reshape(I_src.shape)
        err = torch.abs(warped - I_src)
        if use_ssim:
            s_l = ssim_loss(
                warped.reshape(B * N, H, W, C),
                I_src.reshape(B * N, H, W, C)).reshape(I_src.shape)
            err = 0.85 * s_l + 0.15 * err
        mask = (occ_masks[..., None] if occ_masks is not None
                else torch.ones_like(err[..., :1]))
        total = total + w * mean_on_mask(err, mask)
    return total, {"photo": total}


# ---------------- dynamic-mask labels ----------------


def _bce(y, m):
    p = torch.clamp(m, 1e-6, 1 - 1e-6)
    return -(y * torch.log(p) + (1 - y) * torch.log(1 - p))


def gt_label_loss(gt_masks, gt_vals, mask_probs_list, ii, gamma=GAMMA):
    """BCE between mask-head probabilities and GT static masks
    (losses.py:505-533).

    gt_masks/gt_vals: (B, F, H, W); mask_probs_list: per-step
    (B, N, H, W, 2) probabilities aligned with edge sources ``ii``.
    """
    ii = _index(ii, gt_masks.device)
    y = gt_masks[:, ii][..., None]
    v = gt_vals[:, ii][..., None]
    total = 0.0
    for m, w in zip(mask_probs_list,
                    _step_weights(len(mask_probs_list), gamma)):
        total = total + w * torch.sum(_bce(y, m) * v) / torch.clamp(
            torch.sum(v), min=1.0)
    return total, {"mask_bce": total}


def art_label_loss(art_masks, mask_probs_list, gamma=GAMMA):
    """BCE against self-supervised static labels (losses.py:473-503).
    art_masks: (B, N, H, W) from self_label_masks."""
    y = art_masks[..., None]
    total = 0.0
    for m, w in zip(mask_probs_list,
                    _step_weights(len(mask_probs_list), gamma)):
        total = total + w * torch.mean(_bce(y, m))
    return total, {"al_bce": total}


def self_label_masks(full_flow, cam_flow, thresh=0.5):
    """Self-supervised static labels: static where the full flow and
    camera flow agree (losses.py:429-461)."""
    d = torch.linalg.norm(full_flow - cam_flow, dim=-1)
    return (d <= thresh).to(full_flow.dtype)


def ce_reg_loss(mask_probs_list, gamma=GAMMA):
    """Entropy regularization pushing masks to 0/1
    (losses.py:410-426)."""
    total = 0.0
    for m, w in zip(mask_probs_list,
                    _step_weights(len(mask_probs_list), gamma)):
        p = torch.clamp(m, 1e-6, 1 - 1e-6)
        ent = -(p * torch.log(p) + (1 - p) * torch.log(1 - p))
        total = total + w * torch.mean(ent)
    return total, {"ce_reg": total}


def consistency_loss(mask_probs_list, gamma=GAMMA):
    """Consistency between the two mask channels (losses.py:541-568)."""
    total = 0.0
    for m, w in zip(mask_probs_list,
                    _step_weights(len(mask_probs_list), gamma)):
        total = total + w * torch.mean(torch.abs(m[..., 0] - m[..., 1]))
    return total, {"consistency": total}
