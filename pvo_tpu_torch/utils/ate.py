"""Trajectory evaluation: ATE-RMSE with Umeyama (Sim3) alignment (the
port's own copy of :mod:`pvo_tpu.utils.ate`, pure numpy).

Replaces the reference's `evo` dependency (test_vo.py:110-164:
main_ape.ape with PoseRelation.translation_part, align=True,
correct_scale=True) with a self-contained implementation.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src, dst, with_scale=True):
    """Least-squares similarity transform aligning src -> dst.

    src, dst: (N, 3). Returns (s, R (3,3), t (3,)) minimizing
    ||dst - (s R src + t)||^2 (Umeyama 1991).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d

    cov = xd.T @ xs / len(src)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt

    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(d) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_xyz, ref_xyz, align=True, correct_scale=True):
    """Absolute trajectory error (RMSE of translation residuals)."""
    est = np.asarray(est_xyz, np.float64)
    ref = np.asarray(ref_xyz, np.float64)
    assert est.shape == ref.shape, (est.shape, ref.shape)
    if align:
        s, R, t = umeyama_alignment(est, ref, with_scale=correct_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - ref, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def ate_stats(est_xyz, ref_xyz, align=True, correct_scale=True):
    est = np.asarray(est_xyz, np.float64)
    ref = np.asarray(ref_xyz, np.float64)
    if align:
        s, R, t = umeyama_alignment(est, ref, with_scale=correct_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - ref, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
    }
