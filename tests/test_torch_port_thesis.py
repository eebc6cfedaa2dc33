"""The paper's two claims on the port's tracking path.

Adapted from ``tests/test_segment_filter.py``'s
``test_segm_filter_on_beats_off_on_dynamic_scene`` and
``test_pvo_iterate_loop_improves_ate``, which run on the JAX package:
the same scene, oracle model, seeds and margins. The oracle replaces the
port's ``FactorGraph._update_core`` (a method that writes the edge state
and returns ``(eta, has_edge)``) while the port runs everything else on
the CPU in f32: the motion filter, the frontend's host topology, the
port's ``segment_vote_filter``, the reference's ``sigmoid(w + (1 -
bin_mask) * 10)`` weight, damping and the DBA solver.

Scene: a far static background (disparity 0.05) and a near moving van
(disparity 1.0) in one panoptic segment. The oracle's flow head
predicts the camera-induced flow with small matching noise on the van
and large noise on the background; its weight head distrusts the van
(logit -4); its mask head flags only ~15% of the van's pixels. With the
segment filter on, the vote marks the whole van dynamic, and the weight
boost turns its accurate decomposed flow into full-confidence
constraints. The JAX docstrings measured 7.3x (filter on against off)
and 5.8x (iteration 2 against iteration 1); the ratios measured here are
printed.
"""

import numpy as np
import pytest
import torch

from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.lie import se3
from pvo_tpu_torch.pipeline.tracking import forward_splat_ids
from pvo_tpu_torch.utils.ate import ate_rmse
from pvo_tpu_torch.utils.config import VOConfig
from pvo_tpu_torch.vo import factor_graph as fg
from pvo_tpu_torch.vo.system import VOSystem
from torch_one_thread import one_thread  # noqa: F401


N, H, W = 12, 64, 96
h, w = H // 8, W // 8
VAN, BG = 130001, 20000

# GT trajectory: forward translation + slight yaw
_tang = np.zeros((N, 6), np.float32)
_tang[:, 0] = 0.04 * np.arange(N)
_tang[:, 4] = 0.01 * np.arange(N)
GT_POSES = se3.exp(torch.from_numpy(_tang))

# far background, near object (strong parallax)
yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
OBJ = (yy >= 2) & (yy < 7) & (xx >= 3) & (xx < 10)
_disp = np.full((h, w), 0.05, np.float32)
_disp[OBJ] = 1.0
GT_DISPS = torch.from_numpy(np.tile(_disp, (N, 1, 1)))

# the van's image-space motion, px/frame at 1/8 res
OBJ_FLOW = np.array([0.9, 0.35], np.float32)

# weak mask head: ~15% of the van's pixels flagged, a per-pixel pattern
FLAG = OBJ & (((yy * 7 + xx * 13) % 7) == 0)


def oracle_core(self, ii, jj, valid, w0, K, corr_fn, ctx_pre, segms_e):
    """The JAX tests' oracle as the port's ``_update_core``: writes
    target, weight, raw mask, dynamic flow and full flow of every edge
    (the hidden state stays) and returns (eta (K, h, w), has_edge (K,))."""
    v = self.video
    F = v.poses.shape[0]
    gp = torch.cat([GT_POSES, GT_POSES[-1:].expand(F - N, 7)])[None]
    gd = torch.cat([GT_DISPS, GT_DISPS[-1:].expand(F - N, h, w)])[None]
    intr_b = v.intrinsics[0].expand(1, F, 4)
    coords_gt, vmask = projective.projective_transform(gp, gd, intr_b, ii, jj)
    vm = valid[:, None, None, None].float() * vmask[0].float()

    # deterministic matching noise: small on the near textured object,
    # large on the far low-parallax background
    obj = torch.from_numpy(OBJ)
    yyf = torch.from_numpy(yy).float()
    xxf = torch.from_numpy(xx).float()
    ph = ii.float()[:, None, None]
    nz_u = torch.sin(2.1 * yyf + 1.7 * xxf + 3.3 * ph)
    nz_v = torch.cos(1.3 * yyf + 2.9 * xxf + 5.1 * ph)
    amp = torch.where(obj, 0.10, 0.50)
    noise = torch.stack([nz_u * amp, nz_v * amp], -1)

    target = coords_gt[0] + noise
    weight_logits = torch.where(obj, -4.0, -2.0)[None, ..., None].expand(
        target.shape)

    # mask head: flags FLAG pixels dynamic, everything else static
    raw_new = torch.where(torch.from_numpy(FLAG), -8.0, 8.0)[
        None, ..., None].expand(target.shape).contiguous()
    bin_mask = torch.sigmoid(raw_new) >= fg.DY_THRESH
    if v.segm_filter:
        bin_mask = fg.segment_vote_filter(bin_mask, segms_e, valid,
                                          v.max_segments, v.thresh)
    bin_mask = bin_mask.float()

    # the reference's exact weight semantics (factor_graph.py:280)
    weight = torch.sigmoid(weight_logits + (1.0 - bin_mask) * 10.0) * vm

    # dy head: the van's flow, gated like the reference (:281)
    dtf = (jj - ii).float()[:, None, None, None]
    dy_out = torch.where(obj[None, ..., None], torch.from_numpy(OBJ_FLOW),
                         0.0) * dtf
    coords0 = projective.coords_grid(h, w)
    (self.target, self.weight, self.raw_mask, self.delta_dy,
     self.full_flow) = (target, weight, raw_new, dy_out * (1.0 - bin_mask),
                        target - coords0)
    eta = 1e-4 * torch.ones((K, h, w))
    has_edge = torch.bincount((ii - w0)[valid], minlength=K)[:K] > 0
    return eta, has_edge


def stream():
    rng = np.random.RandomState(3)
    base = rng.randint(0, 255, (H * 2, W * 2, 3), np.uint8)
    intr = np.array([40.0, 40.0, W / 2, H / 2], np.float32)
    for t in range(N):
        dy0, dx0 = (2 * t) % H, (3 * t) % W
        yield t, base[dy0:dy0 + H, dx0:dx0 + W], intr


def run(segms_per_frame, filter_on=True):
    """ATE (m) of the keyframe trajectory after tracking the stream."""
    cfg = VOConfig(image_size=(H, W), buffer=64, warmup=5,
                   filter_thresh=-1.0, keyframe_thresh=0.0,
                   frontend_window=8, max_edges=96, max_inactive=64,
                   segm_filter=filter_on, thresh=0.12, pipeline=False)
    sysm = VOSystem(cfg, device="cpu", net_dtype=torch.float32)
    for t, img, intr in stream():
        sysm.track(t, img, intr, segments=segms_per_frame[t])
    sysm.frontend.flush()
    est = torch.from_numpy(sysm.get_traj())
    k = est.shape[0]
    est_xyz = se3.inv(est)[:, :3].numpy()
    gt_xyz = se3.inv(GT_POSES[:k])[:, :3].numpy()
    return ate_rmse(est_xyz, gt_xyz)


@pytest.fixture
def oracle(monkeypatch):
    monkeypatch.setattr(fg.FactorGraph, "_update_core", oracle_core)


def test_segm_filter_on_beats_off_on_dynamic_scene(oracle):
    """Voting whole panoptic segments dynamic improves the pose on a
    scene with a moving object: ON below 0.02 m, OFF above 1.8x ON."""
    frac = FLAG.sum() / OBJ.sum()
    assert 0.10 < frac < 0.25, frac
    segm_map = np.where(OBJ, VAN, BG).astype(np.int32)
    ate_on = run([segm_map] * N, filter_on=True)
    ate_off = run([segm_map] * N, filter_on=False)
    print(f"segm filter ATE: on={ate_on:.4f} off={ate_off:.4f} "
          f"(x{ate_off / ate_on:.1f})")
    assert np.isfinite(ate_on) and np.isfinite(ate_off)
    assert ate_on < 0.02, ate_on
    assert ate_off > 1.8 * ate_on, (ate_off, ate_on)


def vps_feedback(segms_in):
    """The loop's VPS stage on the scene: each frame's fused map from its
    predecessor's, splatted along the scene's full flow by the port's
    tracking stage, keeping the labels the detector already found."""
    out = [segms_in[0]]
    for t in range(1, N):
        fl = np.zeros((h, w, 2), np.float32)
        fl[OBJ] = OBJ_FLOW
        warped = forward_splat_ids(out[-1], fl)
        out.append(np.where(warped == VAN, VAN, segms_in[t]).astype(np.int32))
    return out


def test_pvo_iterate_loop_improves_ate(oracle):
    """Iterating the loop improves the pose: the initial segmentation
    found the van in frame 0 only; the fed-back maps carry it to every
    frame (iteration 2 below iteration 1 / 1.8), and a third pass
    changes nothing (at most 1.05x iteration 2)."""
    segm_full = np.where(OBJ, VAN, BG).astype(np.int32)
    segm_bg = np.full((h, w), BG, np.int32)
    segms_it1 = [segm_full if t == 0 else segm_bg for t in range(N)]
    ate1 = run(segms_it1)
    segms_it2 = vps_feedback(segms_it1)
    # the feedback propagated the van's label
    assert sum((s == VAN).any() for s in segms_it2) >= N - 1
    ate2 = run(segms_it2)
    ate3 = run(vps_feedback(segms_it2))
    print(f"pvo-loop ATE: it1={ate1:.4f} it2={ate2:.4f} it3={ate3:.4f} "
          f"(x{ate1 / ate2:.1f})")
    assert np.isfinite(ate1) and np.isfinite(ate2) and np.isfinite(ate3)
    assert ate2 < ate1 / 1.8, (ate1, ate2)
    assert ate3 <= ate2 * 1.05, (ate2, ate3)
