"""Parameter counts and forward FLOPs of the VO and VPS model families
(port of ``scripts/analyze_model.py``; reference
VPS_Module/tools/analyze_model.py).

    python -m pvo_tpu_torch.scripts.analyze_model [--family vo|vps|all]
        [--depth 1|2] [--device cpu]

Parameters come from the modules' ``named_parameters()``, grouped as the
JAX package's tables group them: the VO family by its four param trees
(``fnet``, ``cnet``, ``update`` without GraphAgg, ``agg`` =
``update.agg``), Panoptic FPN by the flax model's top-level names
(``backbone`` = the port's ``backbone.bottom_up``, ``fpn`` = the rest of
the port's ``backbone``, ``rpn_head``, ``roi_heads``, ``sem_seg_head``,
``fusion_conv1``). The frozen batch norms' weights, biases and
statistics are buffers in the port (fault J5) and params in the JAX
package: they are counted apart (``frozen_bn``) and the group's JAX
count is the sum of both.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` (2 per
multiply-add; convolutions and matrix products, not the elementwise
work XLA's cost analysis also counts): fnet forward at 240x808, the
update operator (``DynamicUpdateModule`` with GraphAgg's per-edge conv)
at the tracking shape (E=48, 30x101 features), and the backbone+FPN
forward at 384x1248. The forwards run on ``--device`` (the card unless
``cpu`` is asked for; ``meta`` counts from the shapes alone, without
computing). One JSON line last.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from pvo_tpu_torch.utils.device import open_device
from pvo_tpu_torch.vo.net.droidnet import DroidNet
from pvo_tpu_torch.vps.panoptic_fpn import PanopticFPN
from pvo_tpu_torch.vps.resnet import FrozenBN

FNET_HW = (240, 808)
UPDATE_SHAPE = (48, 30, 101)
VPS_HW = (384, 1248)
# the JAX VPS table's top-level groups, by the port's name prefixes
# (first match)
VPS_GROUPS = (("backbone.bottom_up.", "backbone"), ("backbone.", "fpn"),
              ("proposal_generator.rpn_head.", "rpn_head"),
              ("roi_heads.", "roi_heads"), ("sem_seg_head.", "sem_seg_head"),
              ("fusion_conv1.", "fusion_conv1"))


def fmt(n):
    for unit in ("", "K", "M", "G", "T"):
        if abs(n) < 1000:
            return f"{n:.2f}{unit}"
        n /= 1000
    return f"{n:.2f}P"


def vo_group(name):
    """The JAX VO param tree of the port's parameter ``name``."""
    top = name.split(".")[0]
    if name.startswith("update.agg."):
        return "agg"
    return top


def vps_group(name):
    for prefix, group in VPS_GROUPS:
        if name.startswith(prefix):
            return group
    raise KeyError(f"no VPS group for {name!r}")


def frozen_buffers(model):
    """(name, tensor) of the frozen batch norms' buffers."""
    for mname, m in model.named_modules():
        if isinstance(m, FrozenBN):
            for bname, b in m.named_buffers(recurse=False):
                yield f"{mname}.{bname}", b


def param_table(model, group):
    """{group: {"params": n, "frozen_bn": n, "jax": n, "largest":
    [(name, shape, n)]}} of ``model``'s parameters (and frozen-BN
    buffers) by ``group(name)``."""
    out = {}
    rows = [(n, p, "params") for n, p in model.named_parameters()]
    rows += [(n, b, "frozen_bn") for n, b in frozen_buffers(model)]
    for name, t, kind in rows:
        g = out.setdefault(group(name), {"params": 0, "frozen_bn": 0,
                                         "largest": []})
        g[kind] += t.numel()
        g["largest"].append((name, list(t.shape), t.numel()))
    for g in out.values():
        g["jax"] = g["params"] + g["frozen_bn"]
        g["largest"] = sorted(g["largest"], key=lambda r: -r[2])[:8]
    return out


def flops(fn, *args):
    """FLOPs of ``fn(*args)`` by ``FlopCounterMode``."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def update_flops(update, E, h, w, device):
    """The update operator's FLOPs at E edges of h x w features: the
    operator (every head) and GraphAgg's per-edge convolution."""
    z = (lambda c: torch.zeros((E, h, w, c), device=device))

    def step():
        out = update(z(128), z(128), z(196), z(8))
        update.agg.pre(out["net"].permute(0, 3, 1, 2))
    return flops(step)


def print_table(title, table, depth):
    print(f"== {title} ==")
    for name, g in sorted(table.items(), key=lambda kv: -kv[1]["jax"]):
        extra = (f" (+ {fmt(g['frozen_bn'])} frozen-BN buffers = "
                 f"{fmt(g['jax'])} as the JAX table counts)"
                 if g["frozen_bn"] else "")
        print(f"  {name:14s}: {fmt(g['params'])} params{extra}")
        if depth > 1:
            for n, shape, k in g["largest"]:
                print(f"      {n:60s} {str(shape):20s} {fmt(k)}")
    total = sum(g["jax"] for g in table.values())
    print(f"  TOTAL         : {fmt(total)} params and frozen-BN buffers")
    return total


def analyze_vo(depth, device):
    net = DroidNet.from_seed(0).to(device).eval()
    table = param_table(net, vo_group)
    total = print_table("VO (DroidNet family)", table, depth)
    H, W = FNET_HW
    img = torch.zeros((1, H, W, 3), device=device)
    f = flops(net.fnet, img)
    print(f"  fnet fwd @{H}x{W}: {fmt(f)} FLOP")
    E, h, w = UPDATE_SHAPE
    u = update_flops(net.update, E, h, w, device)
    print(f"  update fwd @E={E} {h}x{w}: {fmt(u)} FLOP")
    return {"params": {k: g["jax"] for k, g in table.items()},
            "total": total, f"fnet_flops_{H}x{W}": f,
            f"update_flops_e{E}_{h}x{w}": u}


def analyze_vps(depth, device):
    model = PanopticFPN().to(device).eval()
    table = param_table(model, vps_group)
    total = print_table("VPS (Panoptic FPN)", table, depth)
    H, W = VPS_HW
    f = flops(model.features, torch.zeros((1, 3, H, W), device=device))
    print(f"  backbone+FPN fwd @{H}x{W}: {fmt(f)} FLOP")
    return {"params": {k: g["jax"] for k, g in table.items()},
            "trainable": {k: g["params"] for k, g in table.items()},
            "frozen_bn": {k: g["frozen_bn"] for k, g in table.items()},
            "total": total, f"features_flops_{H}x{W}": f}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--family", default="all", choices=["vo", "vps", "all"])
    p.add_argument("--depth", type=int, default=1,
                   help="2 = also print the largest leaves")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card), cpu, or "
                        "meta (shapes only)")
    args = p.parse_args(argv)
    dev = open_device(args.device)
    out = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else dev.type)}
    if args.family in ("vo", "all"):
        out["vo"] = analyze_vo(args.depth, dev)
    if args.family in ("vps", "all"):
        out["vps"] = analyze_vps(args.depth, dev)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
