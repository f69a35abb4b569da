"""Host-side SE(3) pose-graph relaxation for loop closing (counterpart of
`dqo_map_tpu/slam/pose_graph.py`, numpy only, copied so that the port
imports nothing of the JAX package).

The native feature backend detects a loop and measures the relative pose
of the two keyframes (`runtime/orb_backend.cc`, `ob_detect_loop`); this
module spreads the accumulated drift over the keyframe chain with a damped
Gauss-Newton solve on SE(3). A few hundred keyframes solve in
milliseconds on the host.

Nodes are keyframe poses T_i (world <- cam). Each edge (i, j, Z)
constrains Z ~= T_i^{-1} T_j; the residual is r = log(Z^{-1} T_i^{-1} T_j)
in R^6 (rotation vector, translation). The Jacobians are numerical, over
the right-multiplicative update T <- T exp(d^). Node 0 is gauge-fixed.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# SE(3) exp/log
# ---------------------------------------------------------------------------

def _hat(w):
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]],
                    dtype=np.float64)


def exp_se3(xi: np.ndarray) -> np.ndarray:
    """xi = (w, v) in R^6 -> 4x4 SE(3) matrix."""
    w, v = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    W = _hat(w)
    if th < 1e-10:
        R = np.eye(3) + W
        V = np.eye(3) + 0.5 * W
    else:
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th**2
        C = (1 - A) / th**2
        R = np.eye(3) + A * W + B * (W @ W)
        V = np.eye(3) + B * W + C * (W @ W)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def log_se3(T: np.ndarray) -> np.ndarray:
    """4x4 SE(3) -> xi = (w, v) in R^6."""
    R = T[:3, :3]
    t = T[:3, 3]
    cos_th = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    th = np.arccos(cos_th)
    if th < 1e-10:
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                            R[1, 0] - R[0, 1]])
        Vinv = np.eye(3) - 0.5 * _hat(w)
    else:
        w = th / (2 * np.sin(th)) * np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        W = _hat(w)
        Vinv = (np.eye(3) - 0.5 * W
                + (1 / th**2 - (1 + np.cos(th)) / (2 * th * np.sin(th)))
                * (W @ W))
    return np.concatenate([w, Vinv @ t])


# ---------------------------------------------------------------------------
# Gauss-Newton pose-graph solve
# ---------------------------------------------------------------------------

def optimize_pose_graph(poses: np.ndarray, edges, iters: int = 12,
                        damping: float = 1e-6) -> np.ndarray:
    """Relax keyframe poses against relative-pose constraints.

    poses: (N, 4, 4) world<-cam estimates (node 0 is held fixed).
    edges: list of (i, j, Z, weight) with Z (4,4) measuring T_i^{-1} T_j.
    Returns the corrected (N, 4, 4) poses.
    """
    poses = np.array(poses, dtype=np.float64, copy=True)
    N = poses.shape[0]
    if N < 2 or not edges:
        return poses
    eps = 1e-6

    def edge_residual(Ti, Tj, Zinv):
        return log_se3(Zinv @ np.linalg.solve(Ti, Tj))

    Zinvs = [np.linalg.inv(np.asarray(Z, np.float64)) for (_, _, Z, _) in edges]

    for _ in range(iters):
        H = np.zeros((6 * N, 6 * N))
        b = np.zeros(6 * N)
        total = 0.0
        for (e, (i, j, _, w)) in enumerate(edges):
            Zinv = Zinvs[e]
            Ti, Tj = poses[i], poses[j]
            r = edge_residual(Ti, Tj, Zinv)
            total += w * (r @ r)
            # numerical Jacobians over right-multiplicative perturbations
            Ji = np.empty((6, 6))
            Jj = np.empty((6, 6))
            for k in range(6):
                d = np.zeros(6)
                d[k] = eps
                D = exp_se3(d)
                Ji[:, k] = (edge_residual(Ti @ D, Tj, Zinv) - r) / eps
                Jj[:, k] = (edge_residual(Ti, Tj @ D, Zinv) - r) / eps
            si, sj = 6 * i, 6 * j
            H[si:si + 6, si:si + 6] += w * Ji.T @ Ji
            H[sj:sj + 6, sj:sj + 6] += w * Jj.T @ Jj
            H[si:si + 6, sj:sj + 6] += w * Ji.T @ Jj
            H[sj:sj + 6, si:si + 6] += w * Jj.T @ Ji
            b[si:si + 6] += w * Ji.T @ r
            b[sj:sj + 6] += w * Jj.T @ r
        # gauge fix node 0
        H = H[6:, 6:]
        b = b[6:]
        H[np.diag_indices_from(H)] += damping + 1e-12 * np.trace(H)
        try:
            delta = np.linalg.solve(H, -b)
        except np.linalg.LinAlgError:  # pragma: no cover - singular graphs
            break
        for i in range(1, N):
            poses[i] = poses[i] @ exp_se3(delta[6 * (i - 1):6 * i])
        if np.linalg.norm(delta) < 1e-10:
            break
    return poses


def chain_edges(poses: np.ndarray, weight: float = 1.0):
    """Odometry edges between consecutive keyframes, measured from the
    current estimates (the drifted chain is the odometry belief; the loop
    edge then redistributes its error along the chain)."""
    N = poses.shape[0]
    return [(i, i + 1, np.linalg.solve(poses[i], poses[i + 1]), weight)
            for i in range(N - 1)]


def close_loop(poses: np.ndarray, q_idx: int, m_idx: int, rel: np.ndarray,
               loop_weight: float = 100.0, iters: int = 12):
    """One loop-closure relaxation: odometry chain + the measured loop edge
    Z = T_{m_cam <- q_cam} (`ob_detect_loop`'s rel16, i.e. T_m^{-1} T_q).

    Returns (corrected_poses, delta) where delta = T_q_new @ T_q_old^{-1} is
    the world-frame correction to apply to poses tracked after keyframe q.
    """
    poses = np.asarray(poses, np.float64)
    edges = chain_edges(poses)
    edges.append((int(m_idx), int(q_idx), np.asarray(rel, np.float64),
                  loop_weight))
    new_poses = optimize_pose_graph(poses, edges, iters=iters)
    delta = new_poses[q_idx] @ np.linalg.inv(poses[q_idx])
    return new_poses, delta
