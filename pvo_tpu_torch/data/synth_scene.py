"""Synthetic Virtual-KITTI-2-format scene generator (the port's own copy
of :mod:`pvo_tpu.data.synth_scene`: the same files, byte for byte, for
the same arguments).

Writes a tiny but geometrically consistent vkitti2 scene (default 14
frames at the native 375x1242 geometry) with every artifact the
pipeline's readers consume — rgb jpgs, 16-bit depth PNGs (cm), 16-bit
flow PNGs (vkitti encode), class/instance segmentation PNGs,
extrinsic.txt — so the CLI drivers (initial_segmentation -> test_vo ->
test_vo2 -> test_vps, reference tools/*.sh) can run end-to-end in CI
against real file formats.

World model: a ground plane (Road), a backdrop plane (Building), a sky
region, two static boxes (Car things) and one moving box (Van), all
fronto-parallel rectangles at constant world depth. Rays are cast
through vkitti intrinsics, so depth and flow are exact for the camera
motion (and the moving object), up to the rectangle model.
"""

from __future__ import annotations

import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pvo_tpu_torch.utils.io import VKITTI_INTRINSICS

H0, W0 = 375, 1242

# vkitti class colors (reference CATEGORY.py)
COL_SKY = (90, 200, 255)
COL_ROAD = (100, 60, 100)
COL_BUILDING = (140, 140, 140)
COL_CAR = (255, 127, 80)
COL_VAN = (0, 139, 139)


def _camera_pose(t, view="clone"):
    """w2c 4x4 at frame t: forward motion + slight yaw; the 15-deg-left
    view adds a fixed yaw offset like vkitti's variant cameras."""
    yaw = 0.003 * t + (np.deg2rad(15.0) if view == "15-deg-left"
                       else 0.0)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float64)
    # camera center moves forward (+z) and slightly right
    center = np.array([0.08 * t, 0.0, 0.35 * t], np.float64)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ center
    return T


class _Rect:
    """Fronto-parallel world rectangle at depth z spanning [x0,x1] x
    [y0,y1], optional velocity (world units / frame)."""

    def __init__(self, z, x0, x1, y0, y1, color, cls_color,
                 instance=None, vel=(0.0, 0.0, 0.0)):
        self.z = z
        self.box = (x0, x1, y0, y1)
        self.color = np.asarray(color, np.float32)
        self.cls_color = cls_color
        self.instance = instance
        self.vel = np.asarray(vel, np.float64)

    def at(self, t):
        x0, x1, y0, y1 = self.box
        dx, dy, dz = self.vel * t
        return (self.z + dz, (x0 + dx, x1 + dx, y0 + dy, y1 + dy))


def _default_world():
    return [
        # backdrop wall
        _Rect(60.0, -80.0, 80.0, -30.0, 6.0, (120, 120, 125),
              COL_BUILDING),
        # static cars
        _Rect(18.0, -6.0, -2.5, 0.2, 2.2, (200, 40, 40), COL_CAR,
              instance=1),
        _Rect(30.0, 3.0, 8.0, 0.3, 2.6, (40, 60, 200), COL_CAR,
              instance=2),
        # moving van (dynamic object)
        _Rect(24.0, -14.0, -9.0, 0.0, 2.8, (230, 220, 60), COL_VAN,
              instance=1, vel=(0.5, 0.0, 0.6)),
    ]


def _texture(xw, yw, seed=7):
    """Smooth pseudo-random texture from world coordinates (view
    independent, so photometric consistency holds)."""
    v = (np.sin(0.7 * xw + seed) * np.cos(0.9 * yw) +
         0.5 * np.sin(2.3 * xw) * np.sin(1.7 * yw + 1.0))
    return 0.5 + 0.25 * v


def _render(t, view, world, intr):
    """Returns rgb (H,W,3) u8, depth_m (H,W), cls (H,W,3) u8,
    inst (H,W) i32, and the per-pixel world point + object velocity
    for flow computation."""
    fx, fy, cx, cy = intr
    T = _camera_pose(t, view)
    Rt = T[:3, :3].T
    cam_c = -Rt @ T[:3, 3]

    u = np.arange(W0, dtype=np.float64)[None, :]
    v = np.arange(H0, dtype=np.float64)[:, None]
    d_c = np.stack([np.broadcast_to((u - cx) / fx, (H0, W0)),
                    np.broadcast_to((v - cy) / fy, (H0, W0)),
                    np.ones((H0, W0))], -1)           # cam ray dirs
    d_w = d_c @ Rt.T                                  # world ray dirs

    depth = np.full((H0, W0), np.inf)
    rgb = np.zeros((H0, W0, 3), np.float32)
    cls = np.zeros((H0, W0, 3), np.uint8)
    cls[:] = COL_SKY
    inst = np.zeros((H0, W0), np.int32)
    pw = np.zeros((H0, W0, 3))
    vel = np.zeros((H0, W0, 3))

    # ground plane y = 1.8 (below camera), Road
    denom = d_w[..., 1]
    s = np.where(np.abs(denom) > 1e-9, (1.8 - cam_c[1]) / denom, -1)
    zc = s * d_c[..., 2]
    hit = (s > 0) & (zc > 0.5) & (zc < 200.0)
    pt = cam_c + s[..., None] * d_w
    tex = _texture(pt[..., 0], pt[..., 2])
    m = hit & (zc < depth)
    depth[m] = zc[m]
    rgb[m] = (np.asarray((100, 60, 100), np.float32) / 255.0 *
              (0.6 + 0.6 * tex[..., None]))[m]
    cls[m] = COL_ROAD
    pw[m] = pt[m]

    sky_bg = ~m

    for rect in world:
        z_t, (x0, x1, y0, y1) = rect.at(t)
        denom = d_w[..., 2]
        s = np.where(np.abs(denom) > 1e-9, (z_t - cam_c[2]) / denom, -1)
        pt = cam_c + s[..., None] * d_w
        zc = s * d_c[..., 2]
        # y points down; the ground is at world y=1.8, so an object
        # spanning heights [y0, y1] above ground occupies
        # world y in [1.8 - y1, 1.8 - y0]
        hit = ((s > 0) & (pt[..., 0] >= x0) & (pt[..., 0] <= x1) &
               (pt[..., 1] >= 1.8 - y1) & (pt[..., 1] <= 1.8 - y0) &
               (zc > 0.0))
        m = hit & (zc < depth)
        depth[m] = zc[m]
        tex = _texture(pt[..., 0] * 3.1, pt[..., 1] * 3.1)
        rgb[m] = (rect.color / 255.0 * (0.6 + 0.5 * tex[..., None]))[m]
        cls[m] = rect.cls_color
        inst[m] = rect.instance or 0
        pw[m] = pt[m] - rect.vel * t   # object-frame anchor point
        vel[m] = rect.vel

    # sky background color/texture
    sky = ~np.isfinite(depth)
    rgb[sky & sky_bg] = np.asarray(COL_SKY, np.float32)[None] / 255.0
    depth[sky] = 655.0  # far cap (vkitti sky ~65535 cm)

    rgb8 = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    return rgb8, depth, cls, inst, pw, vel, sky


def _project(pts_w, T, intr):
    fx, fy, cx, cy = intr
    pc = pts_w @ T[:3, :3].T + T[:3, 3]
    z = np.maximum(pc[..., 2], 1e-6)
    return np.stack([fx * pc[..., 0] / z + cx,
                     fy * pc[..., 1] / z + cy], -1)


def _encode_flow(flow, valid):
    """Inverse of utils.io.decode_vkitti_flow: BGR uint16 png array."""
    h, w = flow.shape[:2]
    out = np.zeros((h, w, 3), np.uint16)
    fx = np.clip(flow[..., 0] / (w - 1), -1.0, 1.0)
    fy = np.clip(flow[..., 1] / (h - 1), -1.0, 1.0)
    out[..., 2] = np.round((fx + 1.0) * (2 ** 16 - 1) / 2.0)
    out[..., 1] = np.round((fy + 1.0) * (2 ** 16 - 1) / 2.0)
    out[..., 0] = np.where(valid, 65535, 0)
    return out


def _write_frame(t, view, world, intr, dirs, n_frames):
    """Render frame ``t`` of ``view`` and write its rgb, depth, class,
    instance and both flow files."""
    import cv2

    rgb, depth, cls, inst, pw, vel, sky = _render(t, view, world, intr)
    cv2.imwrite(osp.join(dirs["rgb"], f"rgb_{t:05d}.jpg"), rgb[..., ::-1])
    d_cm = np.clip(depth * 100.0, 0, 65535).astype(np.uint16)
    cv2.imwrite(osp.join(dirs["depth"], f"depth_{t:05d}.png"), d_cm)
    cv2.imwrite(osp.join(dirs["classSegmentation"], f"classgt_{t:05d}.png"),
                cls[..., ::-1])
    cv2.imwrite(osp.join(dirs["instanceSegmentation"],
                         f"instancegt_{t:05d}.png"), inst.astype(np.uint8))

    # flows from exact geometry: project this frame's world points
    # (advanced by object velocity) into t+1 / t-1
    grid = np.stack(np.meshgrid(np.arange(W0), np.arange(H0)),
                    -1).astype(np.float64)
    for name, dt in (("forwardFlow", 1), ("backwardFlow", -1)):
        t2 = t + dt
        if not (0 <= t2 < n_frames):
            flow = np.zeros((H0, W0, 2))
            valid = np.zeros((H0, W0), bool)
        else:
            T2 = _camera_pose(t2, view)
            pts = pw + vel * t2
            uv2 = _project(pts, T2, intr)
            flow = uv2 - grid
            valid = ~sky
        fn = (f"flow_{t:05d}.png" if dt == 1
              else f"backwardFlow_{t:05d}.png")
        cv2.imwrite(osp.join(dirs[name], fn), _encode_flow(flow, valid))


def write_synth_scene(root, scene="Scene02",
                      views=("clone", "15-deg-left"), n_frames=14,
                      seed=0, workers=1):
    """Generate the scene under ``root``. Returns the scene dir.
    ``workers`` > 1 renders that many frames at once in threads (numpy
    and cv2 release the GIL); the files are the same."""
    intr = VKITTI_INTRINSICS.astype(np.float64)
    world = _default_world()

    for view in views:
        base = osp.join(root, scene, view)
        dirs = {k: osp.join(base, "frames", k, "Camera_0")
                for k in ("rgb", "depth", "forwardFlow", "backwardFlow",
                          "classSegmentation", "instanceSegmentation")}
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)

        with open(osp.join(base, "extrinsic.txt"), "w") as fh:
            fh.write("frame cameraID r1,1 r1,2 r1,3 t1 r2,1 r2,2 r2,3"
                     " t2 r3,1 r3,2 r3,3 t3 0 0 0 1\n")
            for t in range(n_frames):
                T = _camera_pose(t, view)
                for cam in (0, 1):
                    fh.write(" ".join(str(x) for x in
                                      [t, cam] + list(T.reshape(-1))) + "\n")

        def write(t):
            _write_frame(t, view, world, intr, dirs, n_frames)

        if workers > 1:
            with ThreadPoolExecutor(workers) as pool:
                list(pool.map(write, range(n_frames)))
        else:
            for t in range(n_frames):
                write(t)

    return osp.join(root, scene)
