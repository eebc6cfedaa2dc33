"""The damped solve's test systems and a numpy emulation of the kernels
``dba_solve`` and ``dba_solve_grid`` (``pvo_tpu_torch/csrc/dba.cu``: one
block up to P = 48, a grid of blocks above; the same operations in the
same order), for the CPU tests and ``dba_probe`` on the card (numpy
alone).

:func:`system` makes a reduced camera system as the DBA sums it: P poses
and a fixed one, edges between nearby poses with random pose and depth
Jacobians, per-pixel weights and residuals, the depth (one value a pixel
of each edge's source frame, damped by eta) eliminated. It returns the
summed blocks as ``cuda_dba.solve`` takes them: H, S_sum (P*P, 6, 6), v,
corr_v (P, 6), f32. Its systems are exactly symmetric; the DBA's are
not (it sums the blocks (p, q) and (q, p) apart): :func:`asymmetric`
perturbs H's blocks, as a test of the symmetrization that every solve
applies (:func:`damped`).

:func:`emulate` runs the kernel's order of operations in f32: the same
32-column tiles, the identity padding, the diagonal tile's column steps
with y riding along, the pivots' reciprocal square roots
(:func:`rsqrt32`), the panel's rows, the trailing update summed over the
panel in order, the back-solve from the last tile, and the mask. Every
fused multiply-add is rounded once (:func:`fma32`), as ``__fmaf_rn``
rounds it, so on the card the kernel equals it bit for bit.
"""

import numpy as np

NB = 32  # the kernel's tile side (SV_NB)
D = 6


def system(P, seed, hw=12, edges_per_pose=3, scale=10.0, eta=1e-2):
    """A block-structured PSD system of ``P`` poses from
    ``RandomState(seed)`` (see the module's note): (H, S_sum, v, corr_v)
    as f32 numpy arrays."""
    rng = np.random.RandomState(seed)
    E = edges_per_pose * P
    # source and target poses; -1 is the fixed pose outside the window
    ii = rng.randint(-1, P, E)
    jj = np.clip(ii + 1 + rng.randint(0, 3, E), 0, P - 1)
    jj[jj == ii] = (ii[jj == ii] + 1) % P
    Ji = scale * rng.standard_normal((E, hw, 2, D))
    Jj = scale * rng.standard_normal((E, hw, 2, D))
    Jz = scale * rng.standard_normal((E, hw, 2))
    W = rng.rand(E, hw, 2)
    r = rng.standard_normal((E, hw, 2))
    H = np.zeros((P, P, D, D))
    v = np.zeros((P, D))
    # depth terms per (source pose, pixel); the fixed pose's depth too
    C = np.zeros((P + 1, hw))
    wz = np.zeros((P + 1, hw))
    Ez = np.zeros((P, D, P + 1, hw))   # pose row block x depth
    for e in range(E):
        blocks = [(jj[e], Jj[e])] + ([(ii[e], Ji[e])] if ii[e] >= 0 else [])
        z = ii[e] + 1
        for a, Ja in blocks:
            v[a] += np.einsum("hrd,hr,hr->d", Ja, W[e], r[e])
            Ez[a, :, z] += np.einsum("hrd,hr,hr->dh", Ja, W[e], Jz[e])
            for b, Jb in blocks:
                H[a, b] += np.einsum("hrd,hr,hre->de", Ja, W[e], Jb)
        C[z] += np.einsum("hr,hr,hr->h", Jz[e], W[e], Jz[e])
        wz[z] += np.einsum("hr,hr,hr->h", Jz[e], W[e], r[e])
    Q = 1.0 / (C + eta)
    Ezf = Ez.reshape(P, D, -1)
    # BLAS above P = 128 (the plain sum takes minutes at 600); the smaller
    # systems keep the plain sum's roundings
    S_sum = np.einsum("pdx,x,qex->pqde", Ezf, Q.ravel(), Ezf,
                      optimize=P > 128)
    corr_v = np.einsum("pdx,x,x->pd", Ezf, Q.ravel(), wz.ravel())
    f32 = (lambda a: np.ascontiguousarray(a, np.float32))
    return (f32(H.reshape(P * P, D, D)), f32(S_sum.reshape(P * P, D, D)),
            f32(v), f32(corr_v))


def asymmetric(H, seed, scale=1e-3):
    """``H`` (P*P, 6, 6) plus a perturbation of ``scale`` times its
    largest magnitude, uniform in [-1, 1) from ``RandomState(seed)``,
    different in every entry: no longer symmetric."""
    rng = np.random.RandomState(seed)
    noise = rng.uniform(-1.0, 1.0, H.shape) * scale * np.abs(H).max()
    return (H + noise).astype(np.float32)


def damped(H, S_sum, P, ep=0.1, lm=1e-4):
    """The (6P x 6P) f32 matrix that ``cuda_dba.solve_plain`` factors:
    Sd = H - S_sum in the pose blocks' order, the diagonal d + (ep + lm
    d), symmetrized as (Sd + Sd^T) / 2 (the sum rounded, then halved
    exactly), as the JAX package's cholesky and the kernels do."""
    S = H if S_sum is None else H - S_sum
    Sd = S.reshape(P, P, D, D).transpose(0, 2, 1, 3).reshape(P * D, P * D)
    Sd = Sd.astype(np.float32)
    d = np.diagonal(Sd).copy()
    np.fill_diagonal(Sd, d + (np.float32(ep) + np.float32(lm) * d))
    return (Sd + Sd.T) * np.float32(0.5)


def rhs(v, corr_v):
    return (v if corr_v is None else v - corr_v).astype(np.float32).ravel()


def fma32(a, b, c):
    """round_f32(a * b + c), rounded once: the f64 product of two f32
    values is exact, the f64 sum is made round-to-odd from its exact
    error (TwoSum), and a round-to-odd value with 53 bits rounds to the
    24 of f32 as the exact sum would."""
    a, b, c = (np.asarray(t, np.float32).astype(np.float64)
               for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    fix = (err != 0) & even & np.isfinite(s)
    toward = np.where(err > 0, np.inf, -np.inf)
    s = np.where(fix, np.nextafter(s, toward), s)
    return s.astype(np.float32)


def rsqrt32(d):
    """The kernel's ``sv_rsqrt``: 1 / sqrt(d) from the bit-level guess
    0x5f3759df - bits(d) / 2 and three Newton steps r (1.5 - (d / 2) r^2),
    each operation rounded to f32 as the card rounds it."""
    d = np.float32(d)
    h = np.float32(0.5) * d
    bits = np.array(d, np.float32).view(np.uint32)
    r = (np.uint32(0x5F3759DF) - (bits >> np.uint32(1))).astype(
        np.uint32).view(np.float32)[()]
    for _ in range(3):
        r = r * fma32(-h, r * r, np.float32(1.5))[()]
    return np.float32(r)


def emulate(H, S_sum, v, corr_v, P, ep=0.1, lm=1e-4):
    """The kernel's dx (P, 6) for numpy inputs (S_sum, corr_v None: a
    motion-only iteration), f32 throughout."""
    M = D * P
    nb = -(-M // NB)
    Mp = nb * NB
    A = np.eye(Mp, dtype=np.float32)
    A[:M, :M] = damped(H, S_sum, P, ep, lm)
    b = np.zeros(Mp, np.float32)
    b[:M] = rhs(v, corr_v)
    rd = np.zeros(Mp, np.float32)
    bad = False
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for k in range(nb):
            o, e = k * NB, (k + 1) * NB
            Dk, y = A[o:e, o:e], b[o:e]
            # the diagonal tile: warp 0, a lane a row, y riding along
            for j in range(NB):
                d = Dk[j, j]
                bad |= not (d > 0 and np.isfinite(d))
                r = rsqrt32(d)
                Dk[j, j] = d * r
                rd[o + j] = r
                y[j] = y[j] * r
                Dk[j + 1:, j] *= r
                y[j + 1:] = fma32(-Dk[j + 1:, j], y[j], y[j + 1:])
                Dk[j + 1:, j + 1:] = fma32(-Dk[j + 1:, j][:, None],
                                           Dk[j + 1:, j][None, :],
                                           Dk[j + 1:, j + 1:])
            # the panel below, a thread a row, and its b
            X = A[e:, o:e]
            for j in range(NB):
                X[:, j] *= rd[o + j]
                X[:, j + 1:] = fma32(-X[:, j][:, None], Dk[j + 1:, j][None],
                                     X[:, j + 1:])
            bb = b[e:]
            for j in range(NB):
                bb[:] = fma32(-X[:, j], y[j], bb)
            # the trailing update, summed over the panel's columns in order
            T = A[e:, e:]
            for kk in range(NB):
                T[:] = fma32(-X[:, kk][:, None], X[:, kk][None, :], T)
        # L^T x = y from the last tile
        for k in reversed(range(nb)):
            o, e = k * NB, (k + 1) * NB
            Dk, z = A[o:e, o:e], b[o:e]
            for j in reversed(range(NB)):
                z[j] = z[j] * rd[o + j]
                z[:j] = fma32(-Dk[j, :j], z[j], z[:j])
            zz = b[:o]
            for r in range(NB):
                zz[:] = fma32(-A[o + r, :o], z[r], zz)
    x = b[:M]
    ok = not bad and bool(np.isfinite(x).all())
    return (x if ok else np.zeros_like(x)).reshape(P, D)


def _sym64(H, S_sum, P, ep, lm):
    """The symmetrized f32 matrix of :func:`damped` in f64: what the
    solves factor."""
    return damped(H, S_sum, P, ep, lm).astype(np.float64)


def solve64(H, S_sum, v, corr_v, P, ep=0.1, lm=1e-4):
    """The same damped system (its f32 values) solved in f64."""
    return np.linalg.solve(_sym64(H, S_sum, P, ep, lm),
                           rhs(v, corr_v).astype(np.float64)).reshape(P, D)


def forward_error(x, x64):
    """||x - x64|| / ||x64||."""
    x, x64 = (np.asarray(t, np.float64).ravel() for t in (x, x64))
    return float(np.linalg.norm(x - x64) / np.linalg.norm(x64))


def backward_error(H, S_sum, v, corr_v, P, x, ep=0.1, lm=1e-4):
    """The normwise backward error of ``x`` as a solution of the damped
    system, ||Sd x - b|| / (||Sd|| ||x|| + ||b||) in f64 (2-norms): the
    relative change of the system that ``x`` solves exactly. A stable f32
    solve keeps it at a few f32 roundings whatever the system's condition,
    where the forward error grows with the condition."""
    Sd = _sym64(H, S_sum, P, ep, lm)
    b = rhs(v, corr_v).astype(np.float64)
    x = np.asarray(x, np.float64).ravel()
    # Sd is symmetric: its 2-norm is its largest |eigenvalue| (a quarter
    # of an SVD's time at P = 511)
    norm = np.abs(np.linalg.eigvalsh(Sd)).max()
    return float(np.linalg.norm(Sd @ x - b) /
                 (norm * np.linalg.norm(x) + np.linalg.norm(b)))
