"""The update step's parts on the card (port of
``scripts/bench_step_parts.py``): device ms of each at the tracking
loop's shapes (E=48 edges of 30x101 features, a 32-frame window).

    python -m pvo_tpu_torch.scripts.bench_step_parts [--edges 48]
        [--feat_hw 30 101] [--device cpu]

The parts, on the JAX script's inputs from ``RandomState(0)``: the
update operator (``DynamicUpdateModule``, every head, in the system's
operator dtype: bf16 on the card, ``system.operator_dtype``), the
segment vote (``factor_graph.segment_vote_filter``, 96 segment slots),
``projective_transform`` over the edges and ``GraphAgg`` (f32, its
scatter-mean on the segment-sum kernel on the card). Each is measured
by ``kbench.breakdown``: the kernels of one traced call, CUDA events and
the host clock; on the CPU the host clock only. Random weights from
seed 0. One JSON line last.
"""

from __future__ import annotations

import argparse
import copy
import json

import numpy as np
import torch

from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.utils.config import VOConfig
from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vo import factor_graph as fgm
from pvo_tpu_torch.vo.net.droidnet import DroidNet
from pvo_tpu_torch.vo.system import operator_dtype

F_WINDOW = K = 32
S_MAX = 96


def parts(E, h, w, dev):
    """{part: a no-argument call} on the JAX script's inputs."""
    rng = np.random.RandomState(0)
    net = DroidNet.from_seed(0).to(dev).eval()
    agg = copy.deepcopy(net.update.agg)
    dt = operator_dtype(VOConfig(), dev)
    update = net.update.to(dt)
    t = (lambda a, d=torch.float32: torch.as_tensor(a).to(dev, d))
    netb = t(rng.randn(E, h, w, 128))
    inp = t(rng.randn(E, h, w, 128), dt)
    corr = t(rng.randn(E, h, w, 196), dt)
    motn = t(rng.randn(E, h, w, 8), dt)
    segm = t(rng.randint(0, S_MAX, (E, h, w)), torch.long)
    bin_mask = t(rng.rand(E, h, w, 2) > 0.3, torch.bool)
    valid = torch.ones(E, dtype=torch.bool, device=dev)
    poses = t(np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32),
                      (F_WINDOW, 1)))
    disps = t(rng.rand(F_WINDOW, h, w) + 0.5)
    intr = t(np.array([100.0, 100.0, 50.0, 15.0]))
    ii = t(rng.randint(0, K - 1, (E,)), torch.long)
    jj = ii + 1
    intr_b = intr.expand(1, F_WINDOW, 4)
    return {
        "update_apply": lambda: update(netb.to(dt), inp, corr, motn),
        "segment_vote": lambda: fgm.segment_vote_filter(
            bin_mask, segm, valid, S_MAX, 0.5),
        "proj_transform": lambda: projective.projective_transform(
            poses[None], disps[None], intr_b, ii, jj)[0][0],
        "graph_agg": lambda: agg(netb, ii, K),
    }


@torch.no_grad()
def run(E=48, feat_hw=(30, 101), device="cuda"):
    dev = open_device(device)
    h, w = feat_hw
    out = {"E": E, "feat_hw": [h, w], "parts": {}}
    for name, fn in parts(E, h, w, dev).items():
        res = kbench.breakdown(fn, dev)
        out["parts"][name] = res
        ms = res["device_ms"]
        print(f"{name:15s}: " + (f"{ms:.4f} ms device ({res['launches']} "
                                 f"kernels), {res['events_ms']:.4f} by events"
                                 if ms is not None else
                                 f"{res['host_ms']:.3f} ms host (CPU)"))
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
