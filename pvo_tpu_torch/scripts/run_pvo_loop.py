"""One-command PVO loop driver (port of ``scripts/run_pvo_loop.py``;
reference README.md:13-44).

    python -m pvo_tpu_torch.scripts.run_pvo_loop --datapath <root> \
        [--scenes Scene02] [--iters 2] [--weights_vo droid.pth] \
        [--weights_vps panFPN.pth] [--tiny] [--device cpu]

Drives the full pipeline per scene, iterating the VO<->VPS exchange:

  1. initial segmentation (plain Panoptic FPN -> panFPN_segm PNGs),
  2. per iteration:
     a. test_vo   — pose / ATE on the 15-deg-left view (segm filter
        reads 15-deg-left/panFPN_segm), writes shared_data/traj,
     b. test_vo2  — flow/depth export on the clone view into
        shared_data/{full_flow,depth},
     c. test_vps  — flow-guided fused VPS + tracking/matching + VPQ on
        the clone val slice,
     d. feedback: fused pan_seg PNGs are copied over the clone view's
        panFPN_segm frames (reference tools/split_init_segm.py role).

The stages run in this process through each CLI's ``main(argv)``, with
the flags the JAX driver passes and ``--device`` added: one CUDA
context and one kernel build serve every stage, and a stage that fails
raises. The card's cache is emptied between stages.

Step d copies what the JAX driver copies, where its test pins the
copies. No stage reads them: test_vo streams 15-deg-left, test_vo2 and
test_vps read no panFPN_segm, so a second iteration repeats the first
(J2 in ROADMAP.md Queue 3, a fault of the JAX driver kept here).

--tiny runs every stage at reduced scale with the 1-block backbone:
the CI configuration for the synthetic scene
(:mod:`pvo_tpu_torch.data.synth_scene`) on the CPU. Runs on the card;
``--device cpu`` asks for the CPU.
"""

import argparse
import gc
import glob
import importlib
import os
import os.path as osp
import shutil

import torch

from pvo_tpu_torch.utils.device import open_device


def run_stage(script, args_list):
    """Run the stage CLI ``pvo_tpu_torch.scripts.<script>`` in this
    process; its failure raises. Empties the card's cache after it."""
    print(f"[pvo_loop] {script} {' '.join(args_list)}", flush=True)
    importlib.import_module(f"pvo_tpu_torch.scripts.{script}").main(
        args_list)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def feedback_segmentation(shared_data, datapath, scene, view="clone"):
    """Copy fused pan_seg PNGs over the scene's panFPN_segm frames
    (reference split_init_segm.py:12-36 semantics, applied to the
    fused output instead of the initial one)."""
    src_dir = osp.join(shared_data, "panoptic_segm_fusion",
                       "inference", "pan_seg")
    dst_dir = osp.join(datapath, scene, view, "panFPN_segm")
    os.makedirs(dst_dir, exist_ok=True)
    n = 0
    for f in sorted(glob.glob(osp.join(src_dir, f"{scene}_*.png"))):
        name = osp.basename(f).split("_", 1)[1]
        shutil.copyfile(f, osp.join(dst_dir, name))
        n += 1
    return n


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--datapath", required=True)
    p.add_argument("--scenes", nargs="+", default=["Scene02"])
    p.add_argument("--iters", type=int, default=1,
                   help="PVO loop iterations (README.md:44)")
    p.add_argument("--shared_data", default="shared_data")
    p.add_argument("--weights_vo", default=None)
    p.add_argument("--weights_vps", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--vo_image_size", type=int, nargs=2, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu, "
                        "passed on to every stage")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    open_device(args.device)
    dev = ["--device", args.device]

    tiny_vps = (["--tiny", "--scale", "0.125"] if args.tiny else [])
    vo_size = args.vo_image_size or ([96, 320] if args.tiny
                                     else [240, 808])
    vo2_size = [96, 320] if args.tiny else [376, 1248]
    vo_extra = ["--warmup", "5", "--buffer", "64"] if args.tiny else []
    vo2_iters = ["--iters", "4"] if args.tiny else []

    wvo = (["--weights", args.weights_vo] if args.weights_vo else [])
    wvps = (["--weights", args.weights_vps] if args.weights_vps else [])

    # tiny mode: only the 15-deg-left view's initial segmentation is
    # consumed downstream (test_vo's segment filter); the clone view's
    # panFPN_segm is produced by the fusion feedback instead
    views = (["--views", "15-deg-left"] if args.tiny else [])
    run_stage("initial_segmentation",
              ["--datapath", args.datapath, "--scenes"] + args.scenes +
              views + tiny_vps + wvps + dev)

    for it in range(args.iters):
        print(f"[pvo_loop] ===== iteration {it + 1}/{args.iters} =====",
              flush=True)
        for scene in args.scenes:
            scene_path = osp.join(args.datapath, scene)
            run_stage("test_vo",
                      ["--datapath", scene_path, "--segm_filter",
                       "--shared_data", args.shared_data,
                       "--image_size"] + [str(v) for v in vo_size] +
                      vo_extra + wvo + dev)
            run_stage("test_vo2",
                      ["--datapath", scene_path, "--mode", "train",
                       "--shared_data", args.shared_data,
                       "--image_size"] + [str(v) for v in vo2_size] +
                      vo2_iters + wvo + dev)
            run_stage("test_vps",
                      ["--datapath", args.datapath, "--scene", scene,
                       "--shared_data", args.shared_data] +
                      tiny_vps + wvps + dev)
            n = feedback_segmentation(args.shared_data, args.datapath,
                                      scene)
            print(f"[pvo_loop] {scene}: fed back {n} fused "
                  f"segmentations", flush=True)


if __name__ == "__main__":
    main()
