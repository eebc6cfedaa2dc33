"""Co-visibility frame-graph construction for training sampling (port of
:mod:`pvo_tpu.data.graph_utils`).

Rebuild of the reference graph utilities (VO_Module/droid_slam/geom/
graph_utils.py:10-68 and data_readers/rgbd_utils.py:110-153): a frame
graph built by thresholding the mean camera-induced flow between frame
pairs, used both to sample training clips and to pick training edge
lists. Host-side numpy (it runs in the data pipeline, not on device).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from pvo_tpu_torch.geom.distance import frame_distance


def graph_to_edge_list(graph):
    ii, jj, kk = [], [], []
    for s, (i, edges) in enumerate(graph.items()):
        for j in edges:
            ii.append(i)
            jj.append(j)
            kk.append(s)
    return (np.asarray(ii, np.int64), np.asarray(jj, np.int64),
            np.asarray(kk, np.int64))


def keyframe_indices(graph):
    return np.asarray(list(graph.keys()), np.int64)


def compute_distance_matrix_flow(poses_tq, disps, intrinsics,
                                 stride=8):
    """Mean induced-flow distance between all frame pairs.

    poses_tq: (F, 7) w2c; disps: (F, h, w) inverse depth (already
    subsampled); intrinsics: (4,) at that resolution. Returns (F, F).
    Equivalent to reference rgbd_utils.compute_distance_matrix_flow
    but vectorized through the port's frame-distance op (on the CPU: it
    runs in the data pipeline).
    """
    F = len(poses_tq)
    ii, jj = np.meshgrid(np.arange(F), np.arange(F), indexing="ij")
    with torch.no_grad():
        d = frame_distance(
            torch.as_tensor(np.asarray(poses_tq, np.float32)),
            torch.as_tensor(np.asarray(disps, np.float32)),
            torch.as_tensor(np.asarray(intrinsics, np.float32)),
            ii.reshape(-1), jj.reshape(-1), beta=1.0)
    return d.numpy().reshape(F, F)


def build_frame_graph(poses, depths, intrinsics, frame_rate=-1,
                      thresh=24.0, max_flow=256.0):
    """Greedy co-visibility graph: include pairs with mean induced flow
    under ``thresh`` (reference graph_utils.py:37-68).

    poses: (F,7) w2c; depths: (F,h,w) DEPTH maps (not inverse);
    intrinsics: (4,) at depth resolution.
    Returns {i: [j, ...]}.
    """
    disps = 1.0 / np.maximum(np.asarray(depths, np.float32), 1e-3)
    d = compute_distance_matrix_flow(poses, disps, intrinsics)

    graph = OrderedDict()
    F = d.shape[0]
    for i in range(F):
        js = np.where(d[i] < thresh)[0]
        graph[i] = [int(j) for j in js if j != i]
    return graph


def sample_training_graph(d_matrix, n_frames, fmin=8.0, fmax=96.0,
                          rng=None):
    """Sample a co-visible clip of n_frames preferring forward motion
    (reference data_readers/base.py:140-155 semantics)."""
    rng = rng or np.random.default_rng()
    F = d_matrix.shape[0]
    for _ in range(32):
        start = int(rng.integers(0, F - 1))
        inds = [start]
        while len(inds) < n_frames:
            cur = inds[-1]
            # prefer next frames within flow bounds
            cand = [j for j in range(cur + 1, F)
                    if fmin < d_matrix[cur, j] < fmax]
            if not cand:
                cand = [j for j in range(F)
                        if j not in inds and
                        fmin < d_matrix[cur, j] < fmax]
            if not cand:
                break
            inds.append(int(cand[0]))
        if len(inds) == n_frames:
            return np.asarray(inds)
    # fallback: consecutive window
    start = int(rng.integers(0, max(F - n_frames, 1)))
    return np.arange(start, start + n_frames) % F
