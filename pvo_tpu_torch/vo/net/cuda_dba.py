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
- :func:`solve` (kernels ``dba_solve`` and ``dba_solve_grid``): the
  damped solve of the reduced camera system from the summed blocks to
  dx in one launch: Sd = H - S_sum in the (6P x 6P) order, its diagonal
  damped, symmetrized as (Sd + Sd^T) / 2 (as the JAX package's cholesky
  does), factored with b = v - corr_v riding along, both triangular
  solves and ``solve_psd``'s failure mask. Up to ``SOLVE_MAX_P`` poses
  in one block's shared memory (``dba_solve``), above it on a grid of
  blocks over a workspace in L2 (``dba_solve_grid``, a dataflow of
  tiles published by flags, :func:`solve_workspace`): a rule of P,
  decided on the host.
- :func:`backsub` (kernel ``dba_backsub``): the iteration's whole update
  after the solve in one launch, the poses retracted by dx and, for a
  full iteration, the edge terms summed per depth frame in edge order,
  dz and the updated disparities.

None replaces a TPU kernel: the JAX package leaves this work to XLA
(``pvo_tpu/geom/ba.py`` ``_edge_blocks``, ``pvo_tpu/vo/dba.py``; the
solve ``pvo_tpu/geom/chol.py:21-32``). On the card these were einsums
that cuBLAS ran as gemv and small f32 GEMMs, about 21 ms of a replayed
planner frame's 76.3 (ROADMAP, "Farthest from the bound", item 1), the
retraction some 70 elementwise kernels an iteration, and the solve
cuSOLVER's potrf and two trsv with some 26 small kernels around them.
The source's note gives each kernel's design and bound. The wrappers
launch the kernels for CUDA tensors (built like the corr kernels,
:func:`cuda_corr.build`, on the current stream;
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
from pvo_tpu_torch.geom.chol import solve_psd
from pvo_tpu_torch.lie import se3

from . import cuda_corr, cuda_segsum

KERNELS = ("dba_linearize", "dba_schur", "dba_backsub", "dba_solve")
# and the solve's kernel above SOLVE_MAX_P, which the backend alone reaches
# (beyond 49 keyframes)
GRID = "dba_solve_grid"
LAUNCHES = dict.fromkeys((*KERNELS, GRID), 0)
SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "dba.cu"
D = 6
# the most poses dba_solve takes in one block: the padded system's lower
# triangle in 32 x 32 tiles of row stride 33, b and the pivots' 1/sqrt,
# 192,384 bytes of the 232,448 a block may have at P = 48 (M = 288, 45
# tiles); P = 49 would need 234,880 (csrc/dba.cu SV_MAX_P). Above it
# dba_solve_grid
SOLVE_MAX_P = 48

_lib = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load(source=SOURCE):
    """The library built from ``source`` (this module's ``dba.cu``, or an
    earlier one of the same C interface), its functions bound."""
    lib = ctypes.CDLL(str(cuda_corr.build(source)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pvo_dba_linearize.argtypes = [p] * 8 + [i] * 3 + [p] * 7
    lib.pvo_dba_schur.argtypes = [p] * 9 + [i] * 4 + [p] * 3
    lib.pvo_dba_backsub.argtypes = [p] * 13 + [i] * 4 + [p] * 3
    fns = [lib.pvo_dba_linearize, lib.pvo_dba_schur, lib.pvo_dba_backsub]
    # an earlier source (dba_probe --parent) may have no solve
    if hasattr(lib, "pvo_dba_solve"):
        f = ctypes.c_float
        lib.pvo_dba_solve.argtypes = [p] * 4 + [i, f, f, p, p, p]
        fns.append(lib.pvo_dba_solve)
    # (an earlier source may have no pvo_dba_solve_blocks, the capped grid)
    if hasattr(lib, "pvo_dba_solve_blocks"):
        lib.pvo_dba_solve_blocks.argtypes = [p] * 4 + [i, f, f, p, p, i, p]
        fns.append(lib.pvo_dba_solve_blocks)
    if hasattr(lib, "pvo_dba_solve_workspace"):
        lib.pvo_dba_solve_workspace.argtypes = [i]
        lib.pvo_dba_solve_workspace.restype = ctypes.c_longlong
    for fn in fns:
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


# ---- dba_solve ----

def solve_kernel(P):
    """The kernel that solves a system of ``P`` >= 1 poses on the card:
    ``dba_solve`` (one block) up to ``SOLVE_MAX_P``, ``dba_solve_grid``
    above it. A rule of the size alone, decided on the host."""
    if P < 1:
        raise ValueError(f"dba_solve: P={P} < 1")
    return "dba_solve" if P <= SOLVE_MAX_P else GRID


def solve_workspace(P):
    """``dba_solve_grid``'s workspace at ``P`` poses, offsets in floats
    (``csrc/dba.cu`` sg_layout): the padded lower triangle's nt = nb (nb
    + 1) / 2 tiles of 32 x 32 (nb = 6P / 32 rounded up) in column-major
    order (each L^T once final), b and the pivots' reciprocal square
    roots (32 nb each), a failure flag a diagonal tile (nb, rounded up to
    32), then a ready flag a tile, x's published count and a flag a tile
    column (nt + 1 + nb, rounded up to 32; the launch zeroes them).
    Returns {"tiles", "b", "rd", "bad", "flag": offset, "total": floats,
    "nb": nb, "nt": nt}."""
    nb = -(-6 * P // 32)
    nt = nb * (nb + 1) // 2
    out = {"tiles": 0, "b": nt * 32 * 32}
    out["rd"] = out["b"] + 32 * nb
    out["bad"] = out["rd"] + 32 * nb
    out["flag"] = out["bad"] + -(-nb // 32) * 32
    out.update(total=out["flag"] + -(-(nt + 1 + nb) // 32) * 32, nb=nb,
               nt=nt)
    return out


def damped(H, S_sum, P, ep=0.1, lm=1e-4):
    """The (6P x 6P) matrix :func:`solve` factors: S = H - S_sum (H where
    S_sum is None) in the pose blocks' order, its diagonal damped as
    d + (ep + lm d)."""
    S = H if S_sum is None else H - S_sum
    Sd = S.reshape(P, P, D, D).permute(0, 2, 1, 3).reshape(P * D, P * D)
    return Sd + torch.diag(ep + lm * torch.diagonal(Sd))


def solve_plain(H, S_sum, v, corr_v, P, ep=0.1, lm=1e-4):
    """The plain version of :func:`solve`: the :func:`damped` matrix,
    rhs = v - corr_v (v where corr_v is None) and ``geom.chol.solve_psd``.
    Returns dx (P, 6)."""
    rhs = v if corr_v is None else v - corr_v
    return solve_psd(damped(H, S_sum, P, ep, lm)[None],
                     rhs.reshape(1, P * D, 1)).reshape(P, D)


def solve(H, S_sum, v, corr_v, P, ep=0.1, lm=1e-4):
    """The DBA iteration's damped solve: H, S_sum (P*P, 6, 6) the summed
    pose blocks and Schur terms (block p*P + q holds rows 6p.., columns
    6q.. of the system), v, corr_v (P, 6); S_sum and corr_v None for a
    motion-only iteration. Solves (H - S_sum) x = v - corr_v with the
    diagonal damped as d + (ep + lm d) and the matrix symmetrized, and
    returns dx (P, 6), zeros where the factorization failed (a pivot <= 0
    or not finite) or x is not finite. One launch on the card, of the
    kernel :func:`solve_kernel` names (any P >= 1); the plain version on
    the CPU."""
    dev = H.device
    if dev.type == "cpu":
        return solve_plain(H, S_sum, v, corr_v, P, ep, lm)
    return _solve_launch(H, S_sum, v, corr_v, P, ep, lm,
                         solve_kernel(P) == GRID)


def _solve_launch(H, S_sum, v, corr_v, P, ep, lm, grid, blocks=None):
    """:func:`solve` on the card by ``dba_solve_grid`` where ``grid``, else
    by ``dba_solve`` (P <= ``SOLVE_MAX_P``); ``dba_probe`` also times the
    grid kernel below its range. ``blocks`` (the grid only; tests and the
    harnesses) caps the grid at 1 to nb = 6P / 32 rounded up blocks, below
    its default of every SM, so that a warp owns several tiles and the
    critical block takes bulk tiles too (one block)."""
    dev = H.device
    if P < 1 or (not grid and P > SOLVE_MAX_P):
        raise ValueError(f"dba_solve: P={P} (one block takes 1 to "
                         f"{SOLVE_MAX_P}, the grid any P >= 1)")
    if blocks is not None and (not grid or
                               not 1 <= blocks <= -(-6 * P // 32)):
        raise ValueError(f"dba_solve: blocks={blocks} at P={P} (the grid "
                         f"takes 1 to {-(-6 * P // 32)})")
    if (S_sum is None) != (corr_v is None):
        raise ValueError("dba_solve: S_sum and corr_v are both given or "
                         "neither")
    mats = (H,) if S_sum is None else (H, S_sum)
    if (any(tuple(t.shape) != (P * P, D, D) for t in mats) or
            any(tuple(t.shape) != (P, D)
                for t in ((v,) if corr_v is None else (v, corr_v)))):
        raise ValueError(f"dba_solve: H {tuple(H.shape)}, v "
                         f"{tuple(v.shape)} at P={P}")
    ts = _checked("dba_solve", [t for t in (H, S_sum, v, corr_v)
                                if t is not None], dev)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("dba_solve: the blocks and vectors are float32")
    # the one block stages the blocks by 16-byte copies (the segment sum's
    # outputs are allocations of their own, so aligned)
    ts = [t.clone() if t.data_ptr() % 16 else t for t in ts]
    if S_sum is None:
        H, v = ts
    else:
        H, S_sum, v, corr_v = ts
    dx = torch.empty((P, D), dtype=torch.float32, device=dev)
    lib = _library()
    # the grid kernel's workspace as the library sizes it (an earlier
    # source's, under dba_probe --parent), from the caching allocator (in
    # a capture, the graph's pool)
    ws = (torch.empty(lib.pvo_dba_solve_workspace(P), dtype=torch.float32,
                      device=dev) if grid else None)
    name = GRID if grid else "dba_solve"
    args = (H.data_ptr(), _ptr(S_sum), v.data_ptr(), _ptr(corr_v), P, ep,
            lm, dx.data_ptr(), _ptr(ws))
    if blocks is None:
        _launch(name, lib.pvo_dba_solve, dev, *args)
    else:
        _launch(name, lib.pvo_dba_solve_blocks, dev, *args, blocks)
    return dx


# ---- dba_backsub ----

def _dx_rows(dx, sel):
    """dx's rows ``sel`` (-1: zeros)."""
    return torch.where((sel >= 0)[:, None],
                       dx[sel.clamp(0, dx.shape[0] - 1)], 0.0)


def backsub_plain(poses, dx, frame_row, disps, Ej=None, pj_sel=None,
                  m_k=None, Ei_m=None, pm_sel=None, C=None, eta=None,
                  w_m=None, frame_k=None):
    """The plain version of :func:`backsub`: the edge terms (an einsum),
    their zero-start sum per depth frame (the CPU's ``index_add_``, in
    ascending edge order), dz and the disparities, and ``se3.retr`` of
    every pose by its row of dx (zeros where there is none)."""
    new_poses = se3.retr(poses, _dx_rows(dx, frame_row))
    if Ej is None:
        return new_poses, disps
    K = Ei_m.shape[0]
    te = torch.einsum("edh,ed->eh", Ej, _dx_rows(dx, pj_sel))
    t_edge = cuda_segsum.index_add_plain(te.new_zeros((K, te.shape[1])),
                                         m_k, te)
    Q = 1.0 / (C + eta)
    t_self = torch.einsum("kdh,kd->kh", Ei_m, _dx_rows(dx, pm_sel))
    dz = Q * (w_m - t_self - t_edge)
    ok = (frame_k >= 0)[:, None]
    dz_full = torch.where(ok, dz[frame_k.clamp(0, K - 1)], 0.0)
    new = disps + dz_full.to(disps.dtype).reshape(disps.shape)
    return new_poses, torch.clamp(new, min=0.001)


def backsub(poses, dx, frame_row, disps, Ej=None, pj_sel=None, m_k=None,
            Ei_m=None, pm_sel=None, C=None, eta=None, w_m=None,
            frame_k=None):
    """The DBA iteration's update after the solve, dx (P,6): the poses
    (F,7) retracted, frame f by dx[frame_row[f]] (Exp(dx) * g; -1: kept),
    and, given the depth terms, the disparities (F,h,w) updated. Ej
    (E,6,HW), pj_sel (E,) each edge's pose row of dx (-1: none), m_k (E,)
    its depth frame (K: not summed), Ei_m (K,6,HW), pm_sel (K,) each depth
    frame's pose row, C, eta, w_m (K,HW), frame_k (F,) each frame's depth
    frame (-1: none): t_edge = the sum per depth frame of Ej dx[pj_sel],
    dz = Q (w_m - Ei_m dx[pm_sel] - t_edge), Q = 1 / (C + eta), frame f
    takes dz[frame_k[f]] where frame_k[f] >= 0, and every frame is clamped
    at 0.001. Without them (a motion-only iteration) ``disps`` is returned
    as given. Returns (poses, disps). One launch of ``dba_backsub`` on the
    card, the plain version on the CPU."""
    dev = poses.device
    if dev.type == "cpu":
        return backsub_plain(poses, dx, frame_row, disps, Ej, pj_sel, m_k,
                             Ei_m, pm_sel, C, eta, w_m, frame_k)
    F = poses.shape[0]
    depth = (Ej, pj_sel, m_k, Ei_m, pm_sel, C, eta, w_m, frame_k)
    full = Ej is not None
    if full and any(t is None for t in depth):
        raise ValueError("dba_backsub: the depth terms are all given or "
                         "none")
    shapes_ok = (tuple(poses.shape) == (F, 7) and dx.dim() == 2 and
                 dx.shape[-1] == D and tuple(frame_row.shape) == (F,) and
                 disps.shape[0] == F)
    if full:
        K, _, HW = Ei_m.shape
        E = Ej.shape[0]
        shapes_ok = shapes_ok and (
            tuple(Ej.shape) == (E, D, HW) and
            all(tuple(t.shape) == (E,) for t in (pj_sel, m_k)) and
            tuple(pm_sel.shape) == (K,) and
            all(tuple(t.shape) == (K, HW) for t in (C, eta, w_m)) and
            disps[0].numel() == HW and tuple(frame_k.shape) == (F,))
    if not shapes_ok:
        raise ValueError(f"dba_backsub: poses {tuple(poses.shape)}, dx "
                         f"{tuple(dx.shape)}, frame_row "
                         f"{tuple(frame_row.shape)}, disps "
                         f"{tuple(disps.shape)}"
                         + (f", Ej {tuple(Ej.shape)}, Ei_m "
                            f"{tuple(Ei_m.shape)}" if full else ""))
    ts = _checked("dba_backsub", (poses, dx, frame_row.long()), dev)
    new_poses = torch.empty((F, 7), dtype=torch.float32, device=dev)
    if full:
        dts = _checked("dba_backsub", (Ej, Ei_m, C, eta, w_m, disps,
                                       pj_sel.long(), m_k.long(),
                                       pm_sel.long(), frame_k.long()), dev)
        out = torch.empty(disps.shape, dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in dts]
    else:
        _checked("dba_backsub", (disps,), dev)
        E, HW, out, ptrs = 0, disps[0].numel(), None, [None] * 10
    _launch("dba_backsub", _library().pvo_dba_backsub, dev,
            *(t.data_ptr() for t in ts), *ptrs, F, E, HW, dx.shape[0],
            new_poses.data_ptr(), _ptr(out))
    return new_poses, (out if full else disps)
