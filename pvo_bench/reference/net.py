"""The network of PVO's VO module (DROID-SLAM's ``DroidNet`` with PVO's
dynamic-mask heads) as plain functions of a state dict.

Widths as published: feature encoder 128 channels (instance norm),
context encoder 256 (no norm) split into a 128-channel hidden state and
a 128-channel input, 4-level correlation of radius 3 (196 planes), a
ConvGRU of hidden size 128 over [hidden | input | corr 128 | flow 64],
four heads (flow delta 2, dynamic-flow delta 2, confidence 2, dynamic
mask 2) and the graph aggregation of the hidden states by source frame
into a per-pixel damping. The state dict's keys are those of the
reference implementation, so the same tensors load into the program
under test.

``spec()`` lists every parameter with its shape; ``from_seed`` makes
them on the device from a seed in one draw (convolutions
kaiming-normal by fan out, biases zero) and tames the last convolution
of three heads, as the program's benches do: with untamed random
weights the tracker is chaotic (a 1e-6 change grows to O(1) within
three updates).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DIM = 32
CORR_PLANES = 4 * (2 * 3 + 1) ** 2
HEADS = (("delta", 2), ("delta_dy", 2), ("weight", 2), ("delta_mask", 2))
TAMED = ("delta", "delta_dy", "delta_mask")
RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)


def _conv(specs, name, cin, cout, k):
    specs.append((f"{name}.weight", (cout, cin, k, k)))
    specs.append((f"{name}.bias", (cout,)))


def _encoder_spec(specs, prefix, out, norm):
    _conv(specs, f"{prefix}.conv1", 3, DIM, 7)
    cin = DIM
    for li, (dim, stride) in enumerate([(DIM, 1), (2 * DIM, 2),
                                        (4 * DIM, 2)], 1):
        for bi in range(2):
            s = stride if bi == 0 else 1
            base = f"{prefix}.layer{li}.{bi}"
            _conv(specs, f"{base}.conv1", cin, dim, 3)
            _conv(specs, f"{base}.conv2", dim, dim, 3)
            if s != 1 or cin != dim:
                _conv(specs, f"{base}.downsample.0", cin, dim, 1)
            cin = dim
    _conv(specs, f"{prefix}.conv2", 4 * DIM, out, 1)


def spec():
    """[(key, shape)] of every parameter, in a fixed order."""
    s = []
    _encoder_spec(s, "fnet", 128, "instance")
    _encoder_spec(s, "cnet", 256, "none")
    u = "update"
    _conv(s, f"{u}.corr_encoder.0", CORR_PLANES, 128, 1)
    _conv(s, f"{u}.corr_encoder.2", 128, 128, 3)
    _conv(s, f"{u}.flow_encoder.0", 8, 128, 7)
    _conv(s, f"{u}.flow_encoder.2", 128, 64, 3)
    cin = 128 + 128 + 128 + 64
    for g in ("convz", "convr", "convq"):
        _conv(s, f"{u}.gru.{g}", cin, 128, 3)
    for g in ("w", "convz_glo", "convr_glo", "convq_glo"):
        _conv(s, f"{u}.gru.{g}", 128, 128, 1)
    for name, out in HEADS:
        _conv(s, f"{u}.{name}.0", 128, 128, 3)
        _conv(s, f"{u}.{name}.2", 128, out, 3)
    _conv(s, f"{u}.agg.conv1", 128, 128, 3)
    _conv(s, f"{u}.agg.conv2", 128, 128, 3)
    _conv(s, f"{u}.agg.eta.0", 128, 1, 3)
    _conv(s, f"{u}.agg.upmask_disp.0", 128, 8 * 8 * 9, 1)
    return s


def from_seed(seed, device, scale=0.01, mask_bias=0.0):
    """The state dict (f32, on ``device``) of ``seed``: one normal draw
    from a generator on the device, cut into the convolutions' weights
    (std sqrt(2 / fan_out)); biases zero; the last convolution of the
    flow, dynamic-flow and mask heads scaled by ``scale``, and
    ``mask_bias`` added to the mask head's output bias (scaled, the head
    leaves its logits at the static/dynamic threshold, where rounding
    flips pixels; a bias moves them off it)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = [(k, sh) for k, sh in spec() if k.endswith(".weight")]
    total = sum(torch.Size(sh).numel() for _, sh in shapes)
    flat = torch.randn(total, generator=gen, device=device)
    sd, o = {}, 0
    for key, sh in spec():
        if key.endswith(".bias"):
            sd[key] = torch.zeros(sh, device=device)
            continue
        n = torch.Size(sh).numel()
        fan_out = sh[0] * sh[2] * sh[3]
        sd[key] = flat[o:o + n].view(sh) * (2.0 / fan_out) ** 0.5
        o += n
    for head in TAMED:
        sd[f"update.{head}.2.weight"] *= scale
        sd[f"update.{head}.2.bias"] *= scale
    sd["update.delta_mask.2.bias"] += mask_bias
    return sd


def normalize(images):
    """uint8 RGB (N, H, W, 3) -> normalized (N, 3, H, W) f32."""
    x = images.float().permute(0, 3, 1, 2) / 255.0
    mean = torch.tensor(RGB_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(RGB_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def conv(x, sd, name, stride=1, cast=None):
    w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
    if cast is not None:
        x, w, b = cast(x), cast(w), cast(b)
    return F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)


def _instance_norm(x):
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = torch.square(x - mean).mean(dim=(-2, -1), keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def encoder(x, sd, prefix, instance_norm, cast=None):
    """Normalized images (N, 3, H, W) -> (N, out, H/8, W/8)."""
    norm = _instance_norm if instance_norm else (lambda t: t)
    y = torch.relu(norm(conv(x, sd, f"{prefix}.conv1", 2, cast)))
    for li, stride in ((1, 1), (2, 2), (3, 2)):
        for bi in range(2):
            s = stride if bi == 0 else 1
            base = f"{prefix}.layer{li}.{bi}"
            z = torch.relu(norm(conv(y, sd, f"{base}.conv1", s, cast)))
            z = torch.relu(norm(conv(z, sd, f"{base}.conv2", 1, cast)))
            if f"{base}.downsample.0.weight" in sd:
                y = norm(conv(y, sd, f"{base}.downsample.0", s, cast))
            y = torch.relu(y + z)
    return conv(y, sd, f"{prefix}.conv2", 1, cast)


def encode(images, sd, cast=None):
    """uint8 images (N, H, W, 3) -> fmap, hidden, input (N, h, w, 128)."""
    x = normalize(images)
    fmap = encoder(x, sd, "fnet", True, cast)
    ctx = encoder(x, sd, "cnet", False, cast)
    nhwc = (lambda t: t.permute(0, 2, 3, 1))
    return (nhwc(fmap), nhwc(torch.tanh(ctx[:, :128])),
            nhwc(torch.relu(ctx[:, 128:])))


def update_operator(sd, net, inp, corr, motion, cast=None):
    """One step of the update operator on (E, h, w, C) NHWC inputs:
    hidden 128, input 128, corr 196, motion 8. Returns NHWC tensors
    (net, delta, delta_dy, weight_logits, delta_mask) in f32."""
    u = "update"
    p = (lambda t: t.permute(0, 3, 1, 2).float())
    net, inp, corr, motion = p(net), p(inp), p(corr), p(motion)
    c = torch.relu(conv(torch.relu(conv(corr, sd, f"{u}.corr_encoder.0",
                                        cast=cast)),
                        sd, f"{u}.corr_encoder.2", cast=cast))
    f = torch.relu(conv(torch.relu(conv(motion, sd, f"{u}.flow_encoder.0",
                                        cast=cast)),
                        sd, f"{u}.flow_encoder.2", cast=cast))
    x = torch.cat([inp, c, f], dim=1)
    g = f"{u}.gru"
    glo = torch.sigmoid(conv(net, sd, f"{g}.w", cast=cast))
    glo = torch.mean(glo * net, dim=(-2, -1), keepdim=True)
    hx = torch.cat([net, x], dim=1)
    z = torch.sigmoid(conv(hx, sd, f"{g}.convz", cast=cast) +
                      conv(glo, sd, f"{g}.convz_glo", cast=cast))
    r = torch.sigmoid(conv(hx, sd, f"{g}.convr", cast=cast) +
                      conv(glo, sd, f"{g}.convr_glo", cast=cast))
    q = torch.tanh(conv(torch.cat([r * net, x], dim=1), sd, f"{g}.convq",
                        cast=cast) +
                   conv(glo, sd, f"{g}.convq_glo", cast=cast))
    net = (1 - z) * net + z * q
    out = [net]
    for name, _ in HEADS:
        h = torch.relu(conv(net, sd, f"{u}.{name}.0", cast=cast))
        out.append(conv(h, sd, f"{u}.{name}.2", cast=cast))
    return tuple(t.permute(0, 2, 3, 1).float() for t in out)


def damping(sd, net, frame, K, cast=None, chunk=128):
    """GraphAgg: the mean over edges of relu(conv1(hidden)) by source
    frame ``frame`` (E,) in [0, K) (others dropped), then conv2, the eta
    head, softplus and 0.01. Returns (eta (K, h, w), has_edge (K,))."""
    u = "update.agg"
    sums = counts = None
    for o in range(0, net.shape[0], chunk):
        f = frame[o:o + chunk]
        x = torch.relu(conv(net[o:o + chunk].permute(0, 3, 1, 2).float(),
                            sd, f"{u}.conv1", cast=cast))
        if sums is None:
            sums = torch.zeros((K,) + x.shape[1:], device=x.device)
            counts = torch.zeros(K, device=x.device)
        ok = (f >= 0) & (f < K)
        sums.index_add_(0, f[ok], x[ok])
        counts.index_add_(0, f[ok], torch.ones_like(f[ok], dtype=x.dtype))
    mean = sums / counts.clamp(min=1.0)[:, None, None, None]
    y = torch.relu(conv(mean, sd, f"{u}.conv2", cast=cast))
    eta = 0.01 * F.softplus(conv(y, sd, f"{u}.eta.0", cast=cast))
    return eta[:, 0].float(), counts > 0
