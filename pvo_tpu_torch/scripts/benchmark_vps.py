"""VPS throughput benchmark (port of ``scripts/benchmark_vps.py``):
Panoptic FPN frames/s at the vkitti eval geometry (375x1242, padded to
384x1248), printed as ONE JSON line. Writes no file.

    python -m pvo_tpu_torch.scripts.benchmark_vps [--height 375 --width 1242]
        [--frames 20] [--skip-f32] [--tiny] [--device cpu]

The protocol of the JAX script: one frame in flight (frame t+1 submitted
before frame t is resolved), the best of several passes. bf16 is the
headline; in bf16: plain, fusion with device-resident flow, fusion with
device-resident flow and depth, and the file protocol (host flow and
1/8-res depth per frame, staged one frame ahead); in f32: plain and fusion
with host flow. Weights are random from seed 0, tamed by
:func:`tame_weights` so that detections clear the stitch's 0.5 score and
their masks are pasted. ``vs_baseline`` is null: no TPU or reference
figure carries over to this card.
"""

import argparse
import json
import time

import numpy as np
import torch

from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vps.panoptic_fpn import (PanopticFPN, PanopticPredictor,
                                            init_weights)
from pvo_tpu_torch.vps.resnet import Bottleneck
from pvo_tpu_torch.vps.roi_heads import multilevel_roi_align

# passes per mode, the best kept (the file protocol takes one more)
PASSES = 3


@torch.no_grad()
def tame_weights(model, calib_hw=(128, 192), logit_std=3.0,
                 background=6.0, seed=0):
    """Random weights made to give a panoptic stitch something to do.

    Untamed, the residual stream of a random R-50 grows to ~1e4 and every
    proposal's class scores saturate on one class, or on the background.
    So: the stem's and the residual branches' frozen-BN scales are cut
    (x0.01, x0.5), the box and anchor regressions and the mask predictor
    scaled by 0.1 (boxes stay near their proposals), the mask logits
    biased by +2, away from the 0.5 threshold, the fusion conv made the
    identity on the current features plus a tenth of its random weights;
    and the class logits of
    the proposals of one seeded calibration image (``calib_hw``) are
    standardized to ``logit_std`` per class, with the background logit
    fixed at ``background``: a mix of classes, some 10-20% of the
    detections above 0.5. The semantic logits of its pixels are
    standardized per class too, so the semantic map is not one class.
    Changes ``model`` in place and returns it."""
    m = model
    m.backbone.bottom_up.stem.conv1.norm.weight.mul_(0.01)
    for b in m.modules():
        if isinstance(b, Bottleneck):
            b.conv3.norm.weight.mul_(0.5)
            if b.shortcut is not None:
                b.shortcut.norm.weight.mul_(0.5)
    rh = m.roi_heads
    rh.box_predictor.bbox_pred.weight.mul_(0.1)
    rh.mask_head.predictor.weight.mul_(0.1)
    rh.mask_head.predictor.bias.fill_(2.0)
    m.proposal_generator.rpn_head.anchor_deltas.weight.mul_(0.1)
    # fused features stay those the heads were calibrated on: the fusion
    # conv is the identity on the current frame's channels plus a tenth of
    # its random weights
    fw = m.fusion_conv1.weight
    fw.mul_(0.1)
    ch = torch.arange(fw.shape[0])
    fw[ch, ch, 1, 1] += 1.0

    dev = next(m.parameters()).device
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(0, 255, (1, 3) + tuple(calib_hw))
                         .astype(np.float32)).to(dev)
    feats = m.features(x)
    sp = m.sem_seg_head.predictor
    sem = m.sem_seg_head(feats, calib_hw)[0].flatten(1)
    mu, sd = sem.mean(1), sem.std(1)
    sp.weight /= sd[:, None, None, None]
    sp.bias[:] = (sp.bias - mu) / sd
    props, _, valid = m.proposal_generator(feats, calib_hw)
    X = rh.box_head(multilevel_roi_align(feats, props[valid]))
    cs, K = rh.box_predictor.cls_score, rh.num_classes
    logits = cs(X)[:, :K]
    mu, sd = logits.mean(0), logits.std(0)
    cs.weight[:K] *= (logit_std / sd)[:, None]
    cs.bias[:K] = (cs.bias[:K] - mu) * logit_std / sd
    cs.weight[K] = 0.0
    cs.bias[K] = background
    return m


def tamed_model(seed=0, backbone_blocks=(3, 4, 6, 3)):
    """Random weights from ``seed``, tamed on the CPU (f32)."""
    return tame_weights(init_weights(
        PanopticFPN(backbone_blocks=backbone_blocks), seed).eval(),
        seed=seed)


def timed_pass(predictor, imgs, frames, flow=None, depth=None, files=None):
    """One pass with one frame in flight: a plain warm-up frame (and a
    fused one when the pass fuses), then ``frames`` timed frames.

    ``flow``/``depth``: the same inputs every frame (host arrays or device
    tensors). ``files``: (flows, depths), host arrays, each frame its own,
    staged one frame ahead (``PanopticPredictor.stage_inputs``) so the
    upload runs behind the frame before: the file protocol. Returns
    (seconds, [the frames' results])."""
    predictor._video_id = None
    predictor(imgs[0], video_id="bench")
    if files is not None:
        flows, depths = files
        predictor(imgs[1], video_id="bench", flow=flows[0], depth=depths[0])
        staged = predictor.stage_inputs(flows[1], depths[1])
    elif flow is not None:
        predictor(imgs[1], video_id="bench", flow=flow, depth=depth)
    t0 = time.perf_counter()
    pend, outs = None, []
    for k in range(2, 2 + frames):
        if files is not None:
            flow, depth = staged
        nxt = predictor.submit(imgs[k], video_id="bench", flow=flow,
                               depth=depth)
        if files is not None:
            staged = predictor.stage_inputs(flows[k % len(flows)],
                                            depths[k % len(depths)])
        if pend is not None:
            outs.append(predictor.result(pend))
        pend = nxt
    outs.append(predictor.result(pend))
    return time.perf_counter() - t0, outs


def measure(predictor, imgs, frames, passes, **inputs):
    """Frames/s of :func:`timed_pass`; the best of ``passes``."""
    return max(frames / timed_pass(predictor, imgs, frames, **inputs)[0]
               for _ in range(passes))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=375)
    p.add_argument("--width", type=int, default=1242)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--skip-f32", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="1-block backbone (CI on CPU)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = open_device(args.device)
    rng = np.random.RandomState(0)
    H, W = args.height, args.width
    imgs = [rng.randint(0, 255, (H, W, 3)).astype(np.uint8)
            for _ in range(args.frames + 3)]
    flow = (rng.randn(H, W, 2) * 2).astype(np.float32)
    depth = (rng.rand(H, W) * 20 + 1).astype(np.float32)
    model = tamed_model(0, (1, 1, 1, 1) if args.tiny else (3, 4, 6, 3))

    pred16 = PanopticPredictor(model, bf16=True, device=device)
    plain16 = measure(pred16, imgs, args.frames, PASSES)
    # the PVO loop's mode: flow and depth already on the device
    flow_dev = torch.from_numpy(flow).to(device)
    depth_dev = torch.from_numpy(depth).to(device)
    fused16 = measure(pred16, imgs, args.frames, PASSES, flow=flow_dev)
    fused16d = measure(pred16, imgs, args.frames, PASSES, flow=flow_dev,
                       depth=depth_dev)
    # the reference's shared_data .npy mode: the export's full-res flow
    # and its 1/8-res depth, distinct host arrays per frame
    flows = [(rng.randn(H, W, 2) * 2).astype(np.float32) for _ in range(4)]
    depths8 = [(rng.rand(H // 8, W // 8) * 20 + 1).astype(np.float32)
               for _ in range(4)]
    fused16f = measure(pred16, imgs, args.frames, PASSES + 1,
                       files=(flows, depths8))

    plain32 = fused32 = None
    if not args.skip_f32:
        pred32 = PanopticPredictor(model, device=device)
        plain32 = measure(pred32, imgs, args.frames, PASSES)
        fused32 = measure(pred32, imgs, args.frames, PASSES, flow=flow)

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(json.dumps({
        "metric": "vps_frames_per_sec",
        "value": plain16,
        "unit": f"frames/s @{H}x{W} bf16, one frame in flight, best of "
                f"{PASSES} passes of {args.frames} frames",
        "vs_baseline": None,
        "fusion_fps": fused16,
        "fusion_depth_fps": fused16d,
        "fusion_file_fps": fused16f,
        "f32_fps": plain32,
        "f32_fusion_fps": fused32,
        "device": kind,
    }))


if __name__ == "__main__":
    main()
