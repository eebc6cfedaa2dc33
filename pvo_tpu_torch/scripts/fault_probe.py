"""Probes of the port's open faults on the card (ROADMAP.md Queue 3),
each printing one line per reading.

    python -m pvo_tpu_torch.scripts.fault_probe [b4ops] [b4] [vps] [b5 [FRAMES]]

``b4``: where the card's VO training gradients leave the CPU's with
cuDNN on. One restart pass (sup, 48x64, F=4, 2 iterations, weights of
``tame_net(0, mask_bias=-2)``, chip_smoke.py phase 10 (a)) on the CPU
(the reference) and on the card, there with cuDNN on everywhere (the
port before B4's fix) except inside one group of convolutions at a
time, which run without it in both directions (``layers.NativeConv``):
none, all, each part of fnet, cnet, the update operator; then as the
port runs (fnet's instance-normed convolutions native under grad). For
each: the worst relative L2 gradient error over fnet's tensors and over
all tensors. Then each convolution alone: its input and output gradient
captured on the CPU pass, its output, data and weight gradients on the
card with cuDNN on and off, against the CPU's in f64.

``b4ops``: one convolution at a time on random inputs, at shapes of the
VO and VPS paths: its output, data and weight gradients with cuDNN
(as it chooses, with its algorithm search, with deterministic
algorithms) and with PyTorch's own CUDA convolution, in NCHW and
channels-last layouts, against the CPU's in f64.

TF32 is off throughout (the legacy ``allow_tf32`` flags, as
``open_device`` sets them); cuDNN is switched with :func:`cudnn_state`,
never with ``torch.backends.cudnn.flags()``, which also switches TF32
on.

``vps``: the same two readings for VPS training: the full and the
fusion loss of :mod:`pvo_tpu_torch.vps.train` at 64x96 on the R-50
Panoptic FPN (random weights from seed 0, the RPN subsample on fixed
priorities), card against CPU, cuDNN on and off, per tensor relative L2.

``b5``: whether the tracker repeats itself on equal inputs. The
``bench_track`` stream at 240x808 (``tame_net(0)``, every frame a
keyframe) tracked twice in one process, keyframe poses compared after
every frame: the first frame where they differ and by how much, and
each run's frames/s, on the classic path (``pipeline=False``, the path
B5 was found on). Once as the port runs (``kernel``: the fixed-order
segment sum of ``csrc/segsum.cu``), and once with the tracker's sums
(each job of ``cuda_segsum.sums``) replaced by each variant of ``SUMS``: the
card's ``Tensor.index_add_`` (``atomic``: float atomics, the sums before
B5's repair), the same under ``torch.use_deterministic_algorithms(True,
warn_only=True)`` (``deterministic``; the operations PyTorch warns about
are listed), PyTorch's sort-based ``index_put_(accumulate=True)`` and a
product with the index's one-hot matrix.
"""

import contextlib
import sys
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pvo_tpu_torch.scripts.kbench import gpu_line, require_cuda
from pvo_tpu_torch.vo.net import cuda_segsum
from pvo_tpu_torch.vo.net.layers import NativeConv, NormedConv2d


@contextlib.contextmanager
def cudnn_state(**flags):
    """Set ``torch.backends.cudnn``'s ``enabled``, ``benchmark`` or
    ``deterministic`` for the block and nothing else:
    ``torch.backends.cudnn.flags()`` would also switch TF32 on (its
    ``allow_tf32`` defaults to True)."""
    c = torch.backends.cudnn
    saved = {k: getattr(c, k) for k in flags}
    for k, v in flags.items():
        setattr(c, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(c, k, v)


@contextlib.contextmanager
def cudnn_off_in(modules):
    """The convolutions inside ``modules`` run without cuDNN."""
    convs = [m for mod in modules for m in mod.modules()
             if isinstance(m, nn.Conv2d)]
    for m in convs:
        m.forward = (lambda m: lambda x: NativeConv.apply(
            x, m.weight, m.bias, m))(m)
    try:
        yield len(convs)
    finally:
        for m in convs:
            del m.forward


@contextlib.contextmanager
def patched_forward(cls, forward):
    saved = cls.forward
    cls.forward = forward
    try:
        yield
    finally:
        cls.forward = saved


def rel_errors(grads, ref, total):
    """{name: relative L2 error} over the tensors whose reference
    gradient is above 1e-4 of the total norm (chip_smoke.py's rule)."""
    out = {}
    for k, g in ref.items():
        if float(g.norm()) < 1e-4 * total:
            continue
        out[k] = float((grads[k].double().cpu() - g).norm() / g.norm())
    return out


def vo_pass(net, dev, batch):
    from pvo_tpu_torch.parallel import data_parallel as dp
    ii, jj = dp.losses.ring_graph(4)
    tx = dp.make_optimizer(net.parameters(), total_steps=100)
    pass_fn, _, _ = dp.make_restart_step(net, tx, ii, jj, num_steps=2,
                                         mode="sup")
    b = dp.to_device(batch, dev)
    loss, _, grads, _ = pass_fn(b, b["poses_init"], b["disps_init"])
    return float(loss), {k: g.double().cpu() for k, g in grads.items()}


def conv_capture(net):
    """Forward hooks that keep each convolution's input and the gradient
    of its output (CPU pass): {name: [x, gy]}."""
    seen, hooks = {}, []
    for name, m in net.named_modules():
        if isinstance(m, nn.Conv2d):
            def hook(m, inp, out, name=name):
                seen[name] = [inp[0].detach(), None]
                if out.requires_grad:
                    out.register_hook(lambda g: seen[name].__setitem__(
                        1, g.detach()))
            hooks.append(m.register_forward_hook(hook))
    return seen, hooks


def conv_op_errors(net, seen, dev):
    """Each convolution's output, data and weight gradients on the card,
    cuDNN on and off, against the CPU's in f64 on the captured (x, gy):
    [(name, x shape, w shape, [fwd, dgrad, wgrad] cuDNN + native)]."""
    rows = []
    for name, m in net.named_modules():
        if name not in seen or seen[name][1] is None:
            continue
        x, gy = seen[name]

        def run(device, dtype, cudnn=True):
            with cudnn_state(enabled=cudnn):
                xx = x.to(device, dtype).requires_grad_()
                w = m.weight.detach().to(device, dtype).requires_grad_()
                y = F.conv2d(xx, w, None, m.stride, m.padding, m.dilation,
                             m.groups)
                gx, gw = torch.autograd.grad(y, (xx, w), gy.to(device,
                                                                 dtype))
            return [t.detach().double().cpu() for t in (y, gx, gw)]

        ref = run("cpu", torch.float64)
        errs = []
        for cudnn in (True, False):
            errs += [float((t - r).norm() / r.norm().clamp(min=1e-30))
                     for t, r in zip(run(dev, torch.float32, cudnn), ref)]
        rows.append((name, tuple(x.shape), tuple(m.weight.shape), errs))
    return rows


def probe_b4():
    from pvo_tpu_torch.parallel import data_parallel as dp
    from pvo_tpu_torch.scripts.bench_track import tame_net

    batch = dp.make_synthetic_batch(1, F=4, H=48, W=64, seed=0)
    cpu_net = tame_net(0, mask_bias=-2.0).train()
    seen, hooks = conv_capture(cpu_net)
    lp, ref = vo_pass(cpu_net, "cpu", batch)
    for h in hooks:
        h.remove()
    total = float(torch.sqrt(sum((g ** 2).sum() for g in ref.values())))
    net = tame_net(0, mask_bias=-2.0).cuda().train()
    groups = {"none": [], "all": [net], "fnet": [net.fnet],
              "fnet.conv1": [net.fnet.conv1], "fnet.layer1": [net.fnet.layer1],
              "fnet.layer2": [net.fnet.layer2],
              "fnet.layer3": [net.fnet.layer3],
              "fnet.conv2": [net.fnet.conv2], "cnet": [net.cnet],
              "update": [net.update]}
    runs = [("cudnn_everywhere", tag, mods) for tag, mods in groups.items()]
    runs.append(("port", "none", []))
    for setting, tag, mods in runs:
        with contextlib.ExitStack() as stack:
            if setting == "cudnn_everywhere":
                # the port before B4's fix: fnet's normed convolutions on
                # cuDNN under grad too
                stack.enter_context(patched_forward(NormedConv2d,
                                                    nn.Conv2d.forward))
            n = stack.enter_context(cudnn_off_in(mods))
            lc, g = vo_pass(net, "cuda", batch)
        errs = rel_errors(g, ref, total)
        fnet = {k: v for k, v in errs.items() if k.startswith("fnet.")}
        worst = max(fnet, key=fnet.get)
        print(f"b4 {setting} cudnn_off_in={tag} convs={n} loss_rel="
              f"{abs(lc - lp) / abs(lp):.3g} fnet_worst={fnet[worst]:.3g} "
              f"({worst}) all_worst={max(errs.values()):.3g}", flush=True)
    for name, xs, ws, errs in conv_op_errors(cpu_net, seen, "cuda"):
        print(f"b4 conv={name} x={xs} w={ws} fwd/dgrad/wgrad cudnn=" +
              "/".join(f"{e:.3g}" for e in errs[:3]) + " native=" +
              "/".join(f"{e:.3g}" for e in errs[3:]), flush=True)


# representative f32 convolutions of the port: (N, Cin, H, W, Cout, k,
# stride) of fnet's layer1, the update operator, a 1x1, and R-50's res2
# and res4 3x3 at 384x1248
CONV_SHAPES = ((4, 32, 24, 32, 32, 3, 1), (6, 128, 6, 8, 128, 3, 1),
               (6, 128, 6, 8, 128, 1, 1), (1, 64, 96, 312, 64, 3, 1),
               (1, 256, 24, 78, 256, 3, 1))


def conv_errors(shape, layout, seed=0):
    """(fwd, dgrad, wgrad) relative L2 errors of one convolution with
    cuDNN on the card against the CPU's in f64; ``layout``: the memory
    format of the input and output gradient."""
    N, C, H, W, K, k, s = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, C, H, W, generator=g, dtype=torch.float64)
    w = torch.randn(K, C, k, k, generator=g, dtype=torch.float64) / \
        (C * k * k) ** 0.5
    gy = torch.randn(N, K, (H + 2 * (k // 2) - k) // s + 1,
                     (W + 2 * (k // 2) - k) // s + 1, generator=g,
                     dtype=torch.float64)

    def run(device, dtype):
        xx = x.to(device, dtype).contiguous(memory_format=layout)
        xx.requires_grad_()
        ww = w.to(device, dtype).requires_grad_()
        y = F.conv2d(xx, ww, None, s, k // 2)
        gx, gw = torch.autograd.grad(
            y, (xx, ww), gy.to(device, dtype).contiguous(
                memory_format=layout))
        return [t.detach().double().cpu() for t in (y, gx, gw)]

    ref = run("cpu", torch.float64)
    return [float((a - b).norm() / b.norm())
            for a, b in zip(run("cuda", torch.float32), ref)]


def probe_b4_ops():
    """One convolution at a time, random f64-exact inputs: cuDNN's
    errors by memory layout, with cuDNN's algorithm search (benchmark)
    and deterministic algorithms on and off, and PyTorch's own CUDA
    convolution; the matmul's for comparison."""
    import os
    print(f"b4ops cudnn={torch.backends.cudnn.version()} "
          f"torch={torch.__version__} env=" + ",".join(
              f"{k}={v}" for k, v in sorted(os.environ.items())
              if "TF32" in k or "CUDNN" in k or "CUBLAS" in k), flush=True)
    a = torch.randn(512, 512, dtype=torch.float64)
    b = torch.randn(512, 512, dtype=torch.float64)
    mm = (a.cuda().float() @ b.cuda().float()).double().cpu()
    print(f"b4ops matmul_512 rel_err="
          f"{float((mm - a @ b).norm() / (a @ b).norm()):.3g}", flush=True)
    layouts = {"nchw": torch.contiguous_format,
               "channels_last": torch.channels_last}
    modes = {"default": {}, "benchmark": {"benchmark": True},
             "deterministic": {"deterministic": True},
             "native": {"enabled": False}}
    for shape in CONV_SHAPES:
        for lname, layout in layouts.items():
            for mname, flags in modes.items():
                with cudnn_state(**{"enabled": True, "benchmark": False,
                                     "deterministic": False, **flags}):
                    errs = conv_errors(shape, layout)
                print(f"b4ops conv={shape} layout={lname} mode={mname} "
                      "fwd/dgrad/wgrad=" +
                      "/".join(f"{e:.3g}" for e in errs), flush=True)


def vps_grads(model, dev, mode, cudnn=True):
    from pvo_tpu_torch.vps import train as T
    from pvo_tpu_torch.vps.panoptic_fpn import flow_warp_features
    from pvo_tpu_torch.scripts.bench_train_vps import fusion_batch

    H, W = 64, 96
    batch = T.to_device(fusion_batch(H, W), dev)
    pri = torch.from_numpy(np.random.RandomState(5).rand(
        3 * (16 * 24 + 8 * 12 + 4 * 6 + 2 * 3 + 1 * 2)).astype(np.float32))
    model.zero_grad(set_to_none=True)
    with cudnn_state(enabled=cudnn):
        warped = None
        if mode == "fusion":
            with torch.no_grad():
                warped = flow_warp_features(
                    model.features(batch["ref_image"]), batch["flow"])
        loss, _ = T.panoptic_losses(
            model, batch["cur_image"], warped, batch["gt_boxes"],
            batch["gt_classes"], batch["gt_valid"], batch["sem_labels"],
            gt_masks=batch["gt_masks"], rng=pri, max_props=64,
            pre_nms_topk=128)
        loss.backward()
    return float(loss), {n: p.grad.double().cpu()
                         for n, p in model.named_parameters()
                         if p.grad is not None}


def vps_card_errors(mode):
    """(loss rel err, {tensor: rel L2}) for cuDNN on and off."""
    from pvo_tpu_torch.vps.panoptic_fpn import PanopticFPN, init_weights
    model = init_weights(PanopticFPN(), 0).train()
    lp, ref = vps_grads(model, "cpu", mode)
    total = float(torch.sqrt(sum((g ** 2).sum() for g in ref.values())))
    model = model.cuda()
    out = {}
    for cudnn in (True, False):
        lc, g = vps_grads(model, "cuda", mode, cudnn)
        out[cudnn] = (abs(lc - lp) / abs(lp), rel_errors(g, ref, total))
    return out


def probe_vps():
    for mode in ("full", "fusion"):
        for cudnn, (loss_rel, errs) in vps_card_errors(mode).items():
            top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
            print(f"vps mode={mode} cudnn={cudnn} loss_rel={loss_rel:.3g} "
                  f"tensors={len(errs)} worst={top[0][1]:.3g} top="
                  + ",".join(f"{k}:{v:.2g}" for k, v in top), flush=True)


def track_poses(n, H=240, W=808):
    """(keyframe poses after each tracked frame of the bench stream,
    frames/s of the run: host clock, synchronized once at the end)."""
    import time
    from pvo_tpu_torch.scripts.bench_track import bench_system, synth_stream
    sysm = bench_system((H, W), 128, "cuda", pipeline=False)
    frames = list(synth_stream(n, H, W))
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t, img, intr, segm in frames:
        sysm.track(t, img, intr, segments=segm)
        out.append(sysm.video.poses[:sysm.video.counter].clone())
    torch.cuda.synchronize()
    fps = n / (time.perf_counter() - t0)
    return [p.double().cpu() for p in out], fps


def first_difference(a, b):
    for t, (x, y) in enumerate(zip(a, b)):
        if x.shape != y.shape or not torch.equal(x, y):
            d = (float((x - y).abs().max()) if x.shape == y.shape
                 else float("inf"))
            return t, d
    return None, 0.0


def _with_overflow_row(add):
    """An ``index_add(out, idx, x)`` of :mod:`cuda_segsum`'s contract
    (rows out of range dropped) from ``add(buf, idx, x)`` on a buffer
    with one overflow row."""
    def index_add(out, idx, x):
        n = out.shape[0]
        idx = idx.long()
        idx = torch.where((idx >= 0) & (idx < n), idx,
                          torch.full_like(idx, n))
        buf = torch.cat([out, out.new_zeros((1,) + tuple(out.shape[1:]))])
        add(buf, idx, x.to(out.dtype))
        out.copy_(buf[:n])
        return out
    return index_add


def _onehot_add(buf, idx, x):
    """A product with the index's one-hot matrix: cuBLAS reduces in an
    order fixed by the shapes."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    onehot = (idx[None, :] == rows[:, None]).to(buf.dtype)
    buf.add_((onehot @ x.reshape(x.shape[0], -1)).view(buf.shape))


# the tracker's scatter-sums (each job of cuda_segsum.sums) in place of
# the kernel: the card's index_add_ (float atomics, B5's cause), PyTorch's
# sort-based index_put_(accumulate=True) and a one-hot product
SUMS = {
    "atomic": _with_overflow_row(lambda b, i, x: b.index_add_(0, i, x)),
    "index_put": _with_overflow_row(
        lambda b, i, x: b.index_put_((i,), x, accumulate=True)),
    "onehot": _with_overflow_row(_onehot_add),
}


def _each_job(add):
    """A ``cuda_segsum.sums`` that runs its jobs one by one, in order,
    through ``add`` (one of ``SUMS``), a zero-start job's output zeroed
    first."""
    def sums(jobs):
        jobs = [cuda_segsum.Sum(*job) for job in jobs]
        for out, idx, x, zero in jobs:
            if zero:
                out.zero_()
            add(out, idx, x)
        return [job.out for job in jobs]
    return sums


@contextlib.contextmanager
def scatter_sums(variant):
    """``cuda_segsum.sums``, the entry of every segment sum of the
    tracker (batched or not), replaced by ``SUMS[variant]`` a job for the
    block (the kernel itself for ``"kernel"``)."""
    saved = cuda_segsum.sums
    if variant != "kernel":
        cuda_segsum.sums = _each_job(SUMS[variant])
    try:
        yield
    finally:
        cuda_segsum.sums = saved


def probe_b5(n):
    for variant in ("kernel", "atomic", "deterministic", "index_put",
                    "onehot"):
        with contextlib.ExitStack() as stack:
            caught = stack.enter_context(warnings.catch_warnings(
                record=True))
            warnings.simplefilter("always")
            if variant == "deterministic":
                torch.use_deterministic_algorithms(True, warn_only=True)
                stack.callback(torch.use_deterministic_algorithms, False)
            stack.enter_context(scatter_sums(
                "atomic" if variant == "deterministic" else variant))
            a, fps_a = track_poses(n)
            b, fps_b = track_poses(n)
        t, d = first_difference(a, b)
        ops = sorted({str(w.message).split(" does not")[0]
                      for w in caught if "deterministic" in str(w.message)})
        print(f"b5 variant={variant} frames={n} first_differing_frame={t} "
              f"max_abs_pose_diff={d:.3g} keyframes={a[-1].shape[0]},"
              f"{b[-1].shape[0]} frames_per_sec={fps_a:.3f},{fps_b:.3f} "
              f"nondeterministic_ops={ops}", flush=True)


def main(argv=None):
    require_cuda()
    argv = sys.argv[1:] if argv is None else argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    what = argv or ["b4", "vps", "b5"]
    if "b4ops" in what:
        probe_b4_ops()
    if "b4" in what:
        probe_b4()
    if "vps" in what:
        probe_vps()
    if "b5" in what:
        i = what.index("b5")
        n = int(what[i + 1]) if len(what) > i + 1 and \
            what[i + 1].isdigit() else 40
        probe_b5(n)
    print(gpu_line())


if __name__ == "__main__":
    main()
