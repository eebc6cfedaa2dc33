"""Image-directory VO demo (port of ``scripts/demo.py``; reference
VO_Module/demo.py).

    python -m pvo_tpu_torch.scripts.demo --imagedir <dir of png/jpg> \
        --calib calib.txt [--weights droid.pth] [--stride 3] \
        [--buffer 512] [--vis] [--live PORT] [--live_every 8] \
        [--device cpu]

Reads every ``--stride``-th image of the directory (``calib.txt``: fx fy
cx cy [distortion ...]; with distortion the images are undistorted),
resizes each to about 384x512 pixels of area (a multiple of 8 a side),
tracks them with :class:`pvo_tpu_torch.vo.system.VOSystem` and writes
``demo_traj.txt`` (one c2w pose [t, q] per image, after terminate with
the trajectory filler) in the working directory. ``--vis`` writes the
filtered point cloud ``viz/cloud.ply`` and the keyframes' camera
centres ``viz/trajectory.txt``. ``--live PORT`` serves the live viewer
(:class:`pvo_tpu_torch.vo.live_viewer.LiveViewer`) on 127.0.0.1:PORT,
refreshed every ``--live_every`` frames while the classic loop runs
(marked stale while the planner is engaged) and once after terminate;
the process then holds the final state until a line (or the end) of
standard input. Runs on the card unless ``--device cpu``. After the
artifacts it prints one JSON line: frames, keyframes, frames/s (tracking,
synchronized), terminate seconds, the cloud's points, the viewer's last
refresh in ms and the hand-written kernels' launches.
"""

import argparse
import glob
import json
import os.path as osp
import time

import numpy as np
import torch

# the demo's frames are resized to about this many pixels
AREA = 384 * 512


def image_stream(imagedir, calib, stride=1):
    """Yield (t, image RGB u8, intrinsics (4,) f32, None) of every
    ``stride``-th png/jpg of ``imagedir``, resized to about AREA pixels,
    each side a multiple of 8."""
    import cv2

    calib = np.loadtxt(calib, delimiter=" ")
    fx, fy, cx, cy = calib[:4]
    files = sorted(glob.glob(osp.join(imagedir, "*.png")) +
                   glob.glob(osp.join(imagedir, "*.jpg")))[::stride]
    for t, f in enumerate(files):
        img = cv2.imread(f)
        if len(calib) > 4:
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
            img = cv2.undistort(img, K, calib[4:])
        h0, w0 = img.shape[:2]
        h1 = int(h0 * np.sqrt(AREA / (h0 * w0)))
        w1 = int(w0 * np.sqrt(AREA / (h0 * w0)))
        img = cv2.resize(img, (w1, h1))
        img = img[: h1 - h1 % 8, : w1 - w1 % 8]
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        intr = np.array([fx, fy, cx, cy]) * \
            np.array([w1 / w0, h1 / h0, w1 / w0, h1 / h0])
        yield t, img, intr.astype(np.float32), None


def kernel_launches():
    """The hand-written kernels' launch counts (all 0 on the CPU): K1 and
    K3 by feature type, K2, the packed kernels, the segment sum, the DBA's
    kernels."""
    from pvo_tpu_torch.vo.net import (cuda_corr, cuda_corr_exp, cuda_dba,
                                      cuda_segsum)
    out = {}
    for k, n in cuda_corr.LAUNCHES.items():
        f32 = cuda_corr.F32_LAUNCHES.get(k, 0)
        out[k] = n - f32
        if k in cuda_corr.F32_KERNELS:
            out[f"{k}_f32"] = f32
    out.update(cuda_corr_exp.LAUNCHES)
    out.update(cuda_segsum.LAUNCHES)
    out.update(cuda_dba.LAUNCHES)
    return out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def track(sysm, frames, viewer=None, live_every=8):
    """Track ``frames``; refresh ``viewer`` every ``live_every`` frames
    (mark it stale while the planner is engaged: a refresh would stall
    its device pipeline). Returns the seconds, synchronized."""
    t0 = time.perf_counter()
    for i, (t, img, intr, _) in enumerate(frames):
        sysm.track(t, img, intr)
        if viewer is not None and i % live_every == 0:
            if sysm.planner.engaged:
                viewer.mark_stale()
            else:
                viewer.update()
    sync(sysm.device)
    return time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--imagedir", required=True)
    p.add_argument("--calib", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--stride", type=int, default=3)
    p.add_argument("--buffer", type=int, default=512)
    p.add_argument("--vis", action="store_true")
    p.add_argument("--live", type=int, default=0, metavar="PORT",
                   help="serve the live HTTP viewer on this port "
                        "(refreshed every --live_every frames)")
    p.add_argument("--live_every", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from pvo_tpu_torch.utils.config import VOConfig
    from pvo_tpu_torch.utils.device import open_device
    from pvo_tpu_torch.vo.system import VOSystem

    dev = open_device(args.device)
    frames = list(image_stream(args.imagedir, args.calib, args.stride))
    if not frames:
        raise SystemExit(f"no png/jpg images in {args.imagedir}")
    H, W = frames[0][1].shape[:2]
    cfg = VOConfig(image_size=(H, W), buffer=args.buffer)
    sysm = VOSystem(cfg, weights_path=args.weights, device=dev)

    viewer = None
    if args.live:
        from pvo_tpu_torch.vo.live_viewer import LiveViewer
        viewer = LiveViewer(sysm.video, port=args.live)
        print(f"live viewer: http://127.0.0.1:{viewer.port}/", flush=True)

    try:
        track_s = track(sysm, frames, viewer, args.live_every)
        t0 = time.perf_counter()
        traj = sysm.terminate(iter(frames))
        terminate_s = time.perf_counter() - t0
        np.savetxt("demo_traj.txt", traj)
        print(f"wrote demo_traj.txt ({len(traj)} poses, "
              f"{sysm.video.counter} keyframes)", flush=True)

        update_ms = None
        if viewer is not None:
            # the final state, with the global BA's poses
            t0 = time.perf_counter()
            viewer.update()
            update_ms = 1e3 * (time.perf_counter() - t0)

        n_points = None
        if args.vis:
            from pvo_tpu_torch.vo.visualization import droid_visualization
            n_points = droid_visualization(sysm.video)
            print(f"wrote viz/cloud.ply ({n_points} points)", flush=True)

        print(json.dumps({
            "frames": len(frames), "image_size": [H, W],
            "keyframes": int(sysm.video.counter),
            "frames_per_sec": len(frames) / track_s,
            "terminate_s": terminate_s, "cloud_points": n_points,
            "viewer_update_ms": update_ms, "launches": kernel_launches(),
            "device": str(dev)}), flush=True)

        if viewer is not None:
            # the server is a daemon thread: without a hold the process
            # would exit and serve the final refresh for no time
            print("live viewer holding the final state: press Enter (or "
                  "close standard input) to exit", flush=True)
            try:
                input()
            except EOFError:
                pass
    finally:
        if viewer is not None:
            viewer.close()


if __name__ == "__main__":
    main()
