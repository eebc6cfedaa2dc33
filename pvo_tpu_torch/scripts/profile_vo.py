"""The VO pieces timed one by one on the card (port of
``scripts/profile_vo.py``).

    python -m pvo_tpu_torch.scripts.profile_vo [--edges 48]
        [--feat_hw 30 101] [--device cpu]

At the vkitti eval geometry's features (E=48 edges, 30x101, C=128): the
plain chunked correlation lookup (``corr.chunked_corr_lookup`` over 64
bf16 frames, 16 edges a chunk) against K3 (``cuda_corr.corr_lookup`` on
bf16 features; its plain version on the CPU), the update operator
(``DynamicUpdateModule``, f32, random weights from seed 0) and the DBA
(64 frames, P=32, K=32, 2 iterations), on inputs from
``RandomState(0)``. Each is timed as the JAX script times it, on the
host clock over 5 calls ending in a synchronize, and also by CUDA events
and one traced call (``kbench.breakdown``); on the CPU the host clock
only. One JSON line last.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vo import dba as dba_mod
from pvo_tpu_torch.vo.net import corr as corr_ops
from pvo_tpu_torch.vo.net import cuda_corr
from pvo_tpu_torch.vo.net.droidnet import DroidNet

C, FRAMES = 128, 64


def pieces(E, H, W, dev):
    """{piece: a no-argument call} on seeded inputs."""
    rng = np.random.RandomState(0)
    t = (lambda a, d=torch.float32: torch.as_tensor(
        np.asarray(a, np.float32)).to(dev, d))
    bf = torch.bfloat16
    f1, f2 = t(rng.randn(E, H, W, C), bf), t(rng.randn(E, H, W, C), bf)
    coords = t(np.stack([rng.uniform(0, W - 1, (E, H, W)),
                         rng.uniform(0, H - 1, (E, H, W))], -1))
    fmaps = t(rng.randn(FRAMES, H, W, C), bf)
    ii = torch.arange(E, device=dev) % FRAMES
    jj = (torch.arange(E, device=dev) + 1) % FRAMES
    update = DroidNet.from_seed(0).update.to(dev).eval()
    z = (lambda c: t(rng.randn(E, H, W, c)))
    net, inp, corr, motion = z(128), z(128), z(196), z(8)
    poses = torch.zeros((FRAMES, 7), device=dev)
    poses[:, 6] = 1.0
    disps = torch.ones((FRAMES, H, W), device=dev)
    intr = t([100.0, 100.0, W / 2, H / 2])
    target = t(rng.randn(E, H, W, 2))
    weight = t(np.abs(rng.randn(E, H, W, 2)))
    eta = 1e-4 * torch.ones((32, H, W), device=dev)
    valid = torch.ones(E, dtype=torch.bool, device=dev)
    pa, pb, pv = (torch.from_numpy(a).to(dev) for a in
                  dba_mod.build_edge_pairs(ii.cpu().numpy(),
                                           valid.cpu().numpy(), 512))
    return {
        "chunked_corr_lookup": lambda: corr_ops.chunked_corr_lookup(
            fmaps, ii, jj, coords, chunk=16),
        "k3_corr_lookup": lambda: cuda_corr.corr_lookup(f1, f2, coords),
        "update_operator": lambda: update(net, inp, corr, motion),
        "dba": lambda: dba_mod.dba(poses, disps, intr, target, weight, eta,
                                   ii, jj, valid, pa, pb, pv, 1, 32, 0,
                                   P=32, K=32, iters=2),
    }


@torch.no_grad()
def run(E=48, feat_hw=(30, 101), device="cuda"):
    dev = open_device(device)
    H, W = feat_hw
    out = {"E": E, "feat_hw": [H, W], "pieces": {}}
    for name, fn in pieces(E, H, W, dev).items():
        res = kbench.breakdown(fn, dev)
        out["pieces"][name] = res
        line = f"{name:20s} ({E} edges): {res['host_ms']:8.3f} ms host"
        if res["events_ms"] is not None:
            line += (f", {res['events_ms']:.3f} ms by events, "
                     f"{res['device_ms']:.3f} ms of kernels")
        print(line)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--edges", type=int, default=48)
    p.add_argument("--feat_hw", type=int, nargs=2, default=[30, 101])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    out = run(args.edges, tuple(args.feat_hw), args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
