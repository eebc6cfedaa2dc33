"""The dense bundle adjustment's f32 contractions, hand-written in CUDA
for Hopper (``pvo_tpu_torch/csrc/dba.cu``), with their plain PyTorch
versions; :func:`pvo_tpu_torch.vo.dba.dba` calls them through this
module's attributes.

- :func:`linearize` (kernel ``dba_linearize``): each edge's blocks
  Hblk (E,12,12), vblk (E,12), Ei, Ej (E,6,HW), Ck, wk (E,HW), zeros for
  an invalid edge; with ``motion_only`` only Hblk and vblk. A thread
  keeps 27 sums a pixel (Hjj's upper triangle and vj): Ji = -Jj
  Adj(Gij), so Hii, Hij, Hji and vi come from Hjj and vj and the
  edge's Adj once an edge, and a pixel's Ei = -Adj^T Ej.
- :func:`schur` (kernel ``dba_schur``): the Schur terms as rows for the
  segment sum, (a) K self x self, (b) E self x edge, their E transposes,
  (c) one a pair slot (zeros where the slot is not valid), and the rhs
  correction's K + E rows, every one a block of its depth frame's
  weighted Gram [Ei_m; Ej of the frame's edges] Q [..]^T. The kernel
  builds the frames' groups from ``m_c`` itself; a valid slot's two
  edges must share a depth frame, as ``dba.build_edge_pairs``' do.
- :func:`edge_terms` and :func:`backsub` (kernel ``dba_backsub``, an
  edge pass and a depth pass around the segment sum of the edge terms):
  the depth back-substitution and the updated disparities.

None replaces a TPU kernel: the JAX package leaves this work to XLA
(``pvo_tpu/geom/ba.py`` ``_edge_blocks``, ``pvo_tpu/vo/dba.py``). On the
card these were einsums that cuBLAS ran as gemv and small f32 GEMMs,
about 21 ms of a replayed planner frame's 76.3 (ROADMAP, "Farthest from
the bound", item 1). The source's note gives each kernel's design and
bound. The wrappers launch the kernels for CUDA tensors (built like the
corr kernels, :func:`cuda_corr.build`, on the current stream;
``LAUNCHES`` counts them) and take the plain versions (the einsums the
DBA ran before) only for tensors on the CPU. The kernels have no
backward: a CUDA input that requires grad raises. Training
differentiates through :mod:`pvo_tpu_torch.geom.ba`, which stays plain.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from pvo_tpu_torch.geom.ba import _edge_blocks

from . import cuda_corr

KERNELS = ("dba_linearize", "dba_schur", "dba_backsub")
LAUNCHES = dict.fromkeys(KERNELS, 0)
SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "dba.cu"
D = 6

_lib = None


def reset_launches():
    for k in KERNELS:
        LAUNCHES[k] = 0


def load(source=SOURCE):
    """The library built from ``source`` (this module's ``dba.cu``, or an
    earlier one of the same C interface), its functions bound."""
    lib = ctypes.CDLL(str(cuda_corr.build(source)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pvo_dba_linearize.argtypes = [p] * 8 + [i] * 3 + [p] * 7
    lib.pvo_dba_schur.argtypes = [p] * 9 + [i] * 4 + [p] * 3
    lib.pvo_dba_backsub_edges.argtypes = [p, p, p, i, i, p, p]
    lib.pvo_dba_backsub.argtypes = [p] * 9 + [i, i, p, p]
    for fn in (lib.pvo_dba_linearize, lib.pvo_dba_schur,
               lib.pvo_dba_backsub_edges, lib.pvo_dba_backsub):
        fn.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = load()
    return _lib


def _checked(name, tensors, dev):
    """The tensors as the kernel reads them: f32 (indices int64, masks
    uint8) and contiguous, on ``dev``; none may require grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward")
    out = []
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: a tensor is on {t.device}, expected "
                             f"{dev}")
        if t.dtype == torch.bool:
            t = t.view(torch.uint8)
        elif t.dtype not in (torch.float32, torch.int64):
            raise TypeError(f"{name}: dtype {t.dtype}, expected float32, "
                            "int64 or bool")
        out.append(t.contiguous())
    return out


def _launch(name, fn, dev, *args):
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    cuda_corr.check_rc(rc, name)
    LAUNCHES[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---- dba_linearize ----

def linearize_plain(poses, disps, intrinsics, target, weight, ii, jj, valid,
                    motion_only=False):
    """The plain version of :func:`linearize`: ``geom.ba._edge_blocks``
    times the valid mask."""
    F = poses.shape[0]
    vmask = valid.float()
    Hblk, vblk, Ei, Ej, Ck, wk = _edge_blocks(
        target[None], weight[None], poses[None], disps[None],
        intrinsics.expand(1, F, 4), ii, jj)
    Hblk = Hblk[0] * vmask[:, None, None]
    vblk = vblk[0] * vmask[:, None]
    if motion_only:
        return Hblk, vblk, None, None, None, None
    return (Hblk, vblk, Ei[0] * vmask[:, None, None],
            Ej[0] * vmask[:, None, None], Ck[0] * vmask[:, None],
            wk[0] * vmask[:, None])


def linearize(poses, disps, intrinsics, target, weight, ii, jj, valid,
              motion_only=False):
    """Each edge's linearization: poses (F,7), disps (F,h,w), intrinsics
    (4,), target/weight (E,h,w,2), ii/jj (E,) int64, valid (E,) bool.
    Returns Hblk (E,12,12), vblk (E,12), Ei, Ej (E,6,HW), Ck, wk (E,HW)
    f32, zeros for an invalid edge; with ``motion_only`` the last four are
    None. The plain version on the CPU, the kernel on the card."""
    dev = poses.device
    if dev.type == "cpu":
        return linearize_plain(poses, disps, intrinsics, target, weight,
                               ii, jj, valid, motion_only)
    F, h, w = disps.shape
    E, HW = target.shape[0], h * w
    if (tuple(poses.shape) != (F, 7) or tuple(intrinsics.shape) != (4,) or
            tuple(target.shape) != (E, h, w, 2) or
            tuple(weight.shape) != (E, h, w, 2) or
            any(tuple(t.shape) != (E,) for t in (ii, jj, valid))):
        raise ValueError(f"dba_linearize: poses {tuple(poses.shape)}, disps "
                         f"{tuple(disps.shape)}, target {tuple(target.shape)}")
    ts = _checked("dba_linearize", (poses, disps, intrinsics, target,
                                    weight, ii.long(), jj.long(),
                                    valid.bool()), dev)
    new = (lambda *s: torch.empty(s, dtype=torch.float32, device=dev))
    Hblk, vblk = new(E, 12, 12), new(E, 12)
    if motion_only:
        Ei = Ej = Ck = wk = None
    else:
        Ei, Ej, Ck, wk = new(E, D, HW), new(E, D, HW), new(E, HW), new(E, HW)
    if E:
        _launch("dba_linearize", _library().pvo_dba_linearize, dev,
                *(t.data_ptr() for t in ts), E, h, w,
                *(_ptr(t) for t in (Hblk, vblk, Ei, Ej, Ck, wk)))
    return Hblk, vblk, Ei, Ej, Ck, wk


# ---- dba_schur ----

def schur_plain(Ei_m, Ej, C, eta, w_m, m_c, pairs_a, pairs_b, pairs_valid,
                chunk=2048):
    """The plain version of :func:`schur`: the DBA's einsums, the pair
    slots in chunks of ``chunk`` (the gathered (chunk, 6, HW) operands
    grow with the square of the edges per frame at backend scale)."""
    Q = 1.0 / (C + eta)
    Ei_e = Ei_m[m_c]
    Q_e = Q[m_c]
    SS = torch.einsum("xdh,xh,xeh->xde", torch.cat([Ei_m, Ei_e]),
                      torch.cat([Q, Q_e]), torch.cat([Ei_m, Ej]))
    K = Ei_m.shape[0]
    SSa, SSb = SS[:K], SS[K:]
    rows = [SSa, SSb, SSb.transpose(-1, -2)]
    for o in range(0, pairs_a.shape[0], chunk):
        pa_c = pairs_a[o:o + chunk]
        pb_c = pairs_b[o:o + chunk]
        SSc = torch.einsum("pdh,ph,peh->pde", Ej[pa_c], Q_e[pa_c], Ej[pb_c])
        rows.append(torch.where(pairs_valid[o:o + chunk, None, None], SSc,
                                0.0))
    rc = torch.einsum("xdh,xh,xh->xd", torch.cat([Ei_m, Ej]),
                      torch.cat([Q, Q_e]), torch.cat([w_m, w_m[m_c]]))
    return torch.cat(rows), rc


def schur(Ei_m, Ej, C, eta, w_m, m_c, pairs_a, pairs_b, pairs_valid,
          chunk=2048):
    """The Schur terms of the depth elimination: Ei_m (K,6,HW) the self
    blocks per depth frame, Ej (E,6,HW), C, eta, w_m (K,HW) (Q = 1 / (C +
    eta)), m_c (E,) each edge's depth frame, the pair slots (NP,) of
    ``dba.build_edge_pairs``. Returns the rows (K + 2E + NP, 6, 6): (a)
    Ei_m Q Ei_m^T per depth frame, (b) Ei_m[m] Q[m] Ej^T per edge, the
    transposes of (b), (c) Ej[a] Q[m[a]] Ej[b]^T per pair slot, zeros
    where ``pairs_valid`` is False; and the rhs correction (K + E, 6),
    Ei_m Q w_m and Ej Q[m] w_m[m]. ``chunk`` is the plain version's pair
    chunk; the kernel reads its operands by index and gathers nothing.
    On the card m_c must lie in [0, K), E may be at most 65535, and a
    valid slot whose edges' frames differ gets zeros (the plain version
    sums it): ``dba.build_edge_pairs`` pairs only edges of one source
    frame, hence of one depth frame."""
    dev = Ei_m.device
    if dev.type == "cpu":
        return schur_plain(Ei_m, Ej, C, eta, w_m, m_c, pairs_a, pairs_b,
                           pairs_valid, chunk)
    K, _, HW = Ei_m.shape
    E, NP = Ej.shape[0], pairs_a.shape[0]
    if (tuple(Ei_m.shape) != (K, D, HW) or tuple(Ej.shape) != (E, D, HW) or
            any(tuple(t.shape) != (K, HW) for t in (C, eta, w_m)) or
            tuple(m_c.shape) != (E,) or
            any(tuple(t.shape) != (NP,) for t in (pairs_b, pairs_valid))):
        raise ValueError(f"dba_schur: Ei_m {tuple(Ei_m.shape)}, Ej "
                         f"{tuple(Ej.shape)}, C {tuple(C.shape)}, pairs "
                         f"{tuple(pairs_a.shape)}")
    ts = _checked("dba_schur", (Ei_m, Ej, C, eta, w_m, m_c.long(),
                                pairs_a.long(), pairs_b.long(),
                                pairs_valid.bool()), dev)
    rows = torch.empty((K + 2 * E + NP, D, D), dtype=torch.float32,
                       device=dev)
    rc = torch.empty((K + E, D), dtype=torch.float32, device=dev)
    _launch("dba_schur", _library().pvo_dba_schur, dev,
            *(t.data_ptr() for t in ts), K, E, NP, HW, rows.data_ptr(),
            rc.data_ptr())
    return rows, rc


# ---- dba_backsub ----

def _dx_rows(dx, sel):
    """dx's rows ``sel`` (-1: zeros)."""
    return torch.where((sel >= 0)[:, None],
                       dx[sel.clamp(0, dx.shape[0] - 1)], 0.0)


def edge_terms_plain(Ej, dx, sel):
    """The plain version of :func:`edge_terms`."""
    return torch.einsum("edh,ed->eh", Ej, _dx_rows(dx, sel))


def edge_terms(Ej, dx, sel):
    """Each edge's term of the depth back-substitution, Ej dx[sel] (E,HW):
    Ej (E,6,HW), dx (P,6), sel (E,) the edge's pose row of dx, -1 for
    none (zeros). The edge pass of ``dba_backsub`` on the card."""
    dev = Ej.device
    if dev.type == "cpu":
        return edge_terms_plain(Ej, dx, sel)
    E, _, HW = Ej.shape
    if tuple(Ej.shape) != (E, D, HW) or dx.shape[-1] != D or \
            tuple(sel.shape) != (E,):
        raise ValueError(f"dba_backsub: Ej {tuple(Ej.shape)}, dx "
                         f"{tuple(dx.shape)}, sel {tuple(sel.shape)}")
    ts = _checked("dba_backsub", (Ej, dx, sel.long()), dev)
    te = torch.empty((E, HW), dtype=torch.float32, device=dev)
    if E:
        _launch("dba_backsub", _library().pvo_dba_backsub_edges, dev,
                *(t.data_ptr() for t in ts), E, HW, te.data_ptr())
    return te


def backsub_plain(Ei_m, dx, sel, C, eta, w_m, t_edge, disps, frame_k):
    """The plain version of :func:`backsub`."""
    Q = 1.0 / (C + eta)
    t_self = torch.einsum("kdh,kd->kh", Ei_m, _dx_rows(dx, sel))
    dz = Q * (w_m - t_self - t_edge)
    ok = (frame_k >= 0)[:, None]
    dz_full = torch.where(ok, dz[frame_k.clamp(0, dz.shape[0] - 1)], 0.0)
    new = disps + dz_full.to(disps.dtype).reshape(disps.shape)
    return torch.clamp(new, min=0.001)


def backsub(Ei_m, dx, sel, C, eta, w_m, t_edge, disps, frame_k):
    """The depth back-substitution and the disparity update: dz = Q (w_m
    - Ei_m dx[sel] - t_edge), Q = 1 / (C + eta) (all (K,HW); Ei_m
    (K,6,HW); sel (K,) each depth frame's pose row of dx, -1 for none);
    frame f of disps (F,h,w) takes dz[frame_k[f]] where frame_k[f] >= 0;
    every frame is clamped at 0.001. Returns the new (F,h,w) disparities.
    The depth pass of ``dba_backsub`` on the card."""
    dev = Ei_m.device
    if dev.type == "cpu":
        return backsub_plain(Ei_m, dx, sel, C, eta, w_m, t_edge, disps,
                             frame_k)
    K, _, HW = Ei_m.shape
    F = disps.shape[0]
    if (tuple(Ei_m.shape) != (K, D, HW) or dx.shape[-1] != D or
            tuple(sel.shape) != (K,) or
            any(tuple(t.shape) != (K, HW) for t in (C, eta, w_m, t_edge)) or
            disps[0].numel() != HW or tuple(frame_k.shape) != (F,)):
        raise ValueError(f"dba_backsub: Ei_m {tuple(Ei_m.shape)}, disps "
                         f"{tuple(disps.shape)}, frame_k "
                         f"{tuple(frame_k.shape)}")
    ts = _checked("dba_backsub", (Ei_m, dx, sel.long(), C, eta, w_m, t_edge,
                                  disps, frame_k.long()), dev)
    out = torch.empty(disps.shape, dtype=torch.float32, device=dev)
    _launch("dba_backsub", _library().pvo_dba_backsub, dev,
            *(t.data_ptr() for t in ts), F, HW, out.data_ptr())
    return out
