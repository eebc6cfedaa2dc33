"""The yardstick's frozen numbers: the card's published peaks, the
roofline bounds of the correlation and DBA kernels, and the algorithm's
operation count of the tracker's work.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit.
The kernel bounds are frozen from the program's kernel bench
(``kbench.kernel_bound`` and ``kbench.dba_bound``): every input read
once and every output written once at the memory's rate, against the
operations at the peak of their type. The work count is the algorithm
at its published widths: it counts what the method needs for the real
edges and steps, never the program's padded widths, so a fusion or a
compaction leaves it unchanged.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"bf16": 989e12, "f32": 67e12}
LEVELS = 4
C = 128
PATCH_TAPS = 64     # the 8x8 integer patch under a 7x7 bilinear window
WINDOW_TAPS = 49


def _bound(nbytes, flops, kind):
    bytes_ms = 1e3 * nbytes / HBM_BYTES_S
    ops_ms = 1e3 * flops / PEAK_FLOP_S[kind]
    return {"bytes": nbytes, "flops": flops, "ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def level_sizes(H, W, levels=LEVELS):
    sizes = []
    for _ in range(levels):
        sizes.append(H * W)
        H, W = H // 2, W // 2
    return sizes


def corr_bound(name, E, H, W, features="bf16"):
    """One launch of a correlation kernel on E edges of H x W features:
    ``build_volumes`` (K1), ``corr_extract`` (K2), ``corr_lookup`` (K3)."""
    px = E * H * W
    feat = 2 if features == "bf16" else 4
    n2 = sum(level_sizes(H, W))
    n2p = -(-n2 // 64) * 64
    coords_bytes = px * 2 * 4
    fmaps = 2 * px * C * feat
    out = px * LEVELS * WINDOW_TAPS * 4
    if name == "build_volumes":
        return _bound(fmaps + px * n2p * 2, E * H * W * n2 * C * 2, features)
    if name == "corr_extract":
        return _bound(px * LEVELS * PATCH_TAPS * 2 + coords_bytes + out,
                      px * LEVELS * WINDOW_TAPS * 7, "f32")
    if name == "corr_lookup":
        return _bound(fmaps + coords_bytes + out,
                      px * LEVELS * PATCH_TAPS * C * 2, features)
    raise ValueError(f"no correlation kernel named {name!r}")


def dba_bound(name, E=0, K=0, HW=0, F=0, NP=0, P=0, motion_only=False):
    """One launch of a DBA kernel: ``dba_linearize``, ``dba_schur``,
    ``dba_backsub``, ``dba_solve`` (also the grid solve), f32."""
    f = 4
    if name == "dba_linearize":
        b = E * (5 * HW + 14) * f + E * 17 + E * 156 * f + \
            (0 if motion_only else E * 14 * HW * f)
        return _bound(b, E * (816 * HW + 54), "f32")
    if name == "dba_schur":
        b = ((K + E) * 6 + 3 * K) * HW * f + E * 8 + NP * 17 + \
            ((K + 2 * E + NP) * 36 + (K + E) * 6) * f
        return _bound(b, (72 * (K + E + NP) + 12 * (K + E)) * HW, "f32")
    if name == "dba_backsub":
        b, flops = P * 6 * f + F * (7 * f + 8) + F * 7 * f, 72 * F
        if not motion_only:
            b += (E * 6 * HW + K * 9 * HW + F * HW) * f + \
                (2 * E + K + F) * 8 + F * HW * f
            flops += 12 * (E + K) * HW
        return _bound(b, flops, "f32")
    if name == "dba_solve":
        M, terms = 6 * P, 1 if motion_only else 2
        return _bound(terms * (M * M + M) * f + M * f,
                      M ** 3 // 3 + 3 * M * M, "f32")
    raise ValueError(f"no DBA kernel named {name!r}")


# ---- the algorithm's operations (multiply-adds count 2) ----

def _conv(cin, cout, k, pixels):
    return 2 * cin * cout * k * k * pixels


def encoder_flops(H, W, out):
    """One image through a DROID encoder of output width ``out``."""
    p2, p4, p8 = (H // 2) * (W // 2), (H // 4) * (W // 4), (H // 8) * (W // 8)
    f = _conv(3, 32, 7, p2)
    f += 4 * _conv(32, 32, 3, p2)                      # layer1
    f += _conv(32, 64, 3, p4) + 3 * _conv(64, 64, 3, p4) + _conv(32, 64, 1, p4)
    f += _conv(64, 128, 3, p8) + 3 * _conv(128, 128, 3, p8) + \
        _conv(64, 128, 1, p8)
    return f + _conv(128, out, 1, p8)


def frame_encode_flops(H, W):
    """The feature and context encoders on one frame."""
    return encoder_flops(H, W, 128) + encoder_flops(H, W, 256)


def operator_flops(h, w):
    """The update operator on one edge, one step, at h x w: the corr and
    flow encoders, the ConvGRU over [hidden | input | corr | flow], the
    four heads and GraphAgg's per-edge convolution."""
    px = h * w
    f = _conv(196, 128, 1, px) + _conv(128, 128, 3, px)
    f += _conv(8, 128, 7, px) + _conv(128, 64, 3, px)
    f += 3 * _conv(128 + 128 + 128 + 64, 128, 3, px) + _conv(128, 128, 1, px)
    f += 4 * (_conv(128, 128, 3, px) + _conv(128, 2, 3, px))
    return f + _conv(128, 128, 3, px)


def volume_flops(h, w):
    """One edge's all-pairs correlation pyramid (4 levels)."""
    return 2 * C * h * w * sum(level_sizes(h, w))


def lookup_flops(h, w):
    """One edge's bilinear 7x7 lookup at 4 levels, one step."""
    return h * w * LEVELS * WINDOW_TAPS * 7


def dba_flops(E, h, w, iters=2, motion_only=False):
    """DBA iterations over E edges: the linearization and the Schur
    terms. The dense solve (at most 1e-4 of a frame's count) is left
    out."""
    HW = h * w
    lin = E * (816 * HW + 54)
    return iters * (lin + (0 if motion_only else 96 * E * HW))


def update_flops(edges, steps, h, w, motion_only=False):
    """One update call: the edges' volumes once, ``steps`` steps of the
    lookup, the operator and a DBA of two iterations."""
    per_step = edges * (operator_flops(h, w) + lookup_flops(h, w)) + \
        dba_flops(edges, h, w, motion_only=motion_only)
    return edges * volume_flops(h, w) + steps * per_step


def track_frame_flops(H, W, edges, steps, ran):
    """One tracked frame: both encoders, the motion filter's probe (one
    edge's volume and one operator step) and, where the frontend's
    update ran, ``steps`` steps over ``edges`` edges."""
    h, w = H // 8, W // 8
    f = frame_encode_flops(H, W) + volume_flops(h, w) + \
        operator_flops(h, w) + lookup_flops(h, w)
    if ran and edges > 0:
        f += update_flops(edges, steps, h, w)
    return f
