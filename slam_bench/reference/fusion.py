"""The feature backend's pose fusion, in plain `torch` and float64: the
policy that turns the native tracker's answers and the ICP result into a
frame's world pose (c2w), the keyframe nudge and pose gap it uses, and the
loop closure's relaxation of the keyframe chain. It imports nothing of the
port or of JAX.

Written from the behaviour the port's backend documents
(`dqo_map_tpu_torch/slam/pose_backend.py`, `slam/pose_graph.py`):

- the ICP relative pose seeds the feature matcher;
- a keyframe's absolute pose wins when its match has at least
  `MIN_KF_INLIERS` inliers and agrees with the composed relative estimate
  (within `KF_GATE_TRANS` m and `KF_GATE_ROT` degrees), or where there is
  no estimate, or right after a tracking loss ("hold"); against an
  estimate it moves the estimate towards the keyframe's pose by the gain
  (`nudge`), after a loss or without an estimate it is taken whole;
- else the feature relative pose, with at least `MIN_INLIERS` inliers;
- else the ICP relative pose, where ICP converged and the backend uses it;
- else the last pose is held.

The loop closure relaxes the keyframe chain (odometry edges measured from
the chain itself, the loop edge weighted 100) by damped Gauss-Newton on
SE(3) with numerical Jacobians over right-multiplicative updates, node 0
held, and returns the correction to apply to the newest pose.

Departures: the native tracker is not written again. Its answers (the
feature inliers and relative pose, the keyframe inliers and absolute
pose) are the reference's inputs, as are the previous pose and the
previous frame's source. A frame's pose is compared by `pose_diff`, which
reads the rotation from the skew part of the relative rotation, exact near
zero where an arc cosine is not. `dtype` is a parameter everywhere, so
that the same fusion can be run in float32 as the precision control.
"""

from __future__ import annotations

import torch

MIN_INLIERS = 12
MIN_KF_INLIERS = 20
KF_GATE_TRANS = 0.30         # m
KF_GATE_ROT = 20.0           # degrees
SOURCES = ("keyframe", "features", "icp", "hold")
F64 = torch.float64


def _t(x, dtype=F64) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype)


def _vee(S: torch.Tensor) -> torch.Tensor:
    """(S21 - S12, S02 - S20, S10 - S01) of a 3x3 matrix."""
    return torch.stack([S[2, 1] - S[1, 2], S[0, 2] - S[2, 0],
                        S[1, 0] - S[0, 1]])


def _hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=w.dtype)
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def _angle(R: torch.Tensor) -> torch.Tensor:
    """The rotation angle of R from its trace, in radians."""
    c = torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return torch.arccos(c)


def nudge(a, b, g: float, dtype=F64) -> torch.Tensor:
    """Pose a moved towards pose b by the fraction g: the translation
    interpolated, the rotation turned by g of the relative rotation's angle
    about its axis (Rodrigues)."""
    a, b = _t(a, dtype), _t(b, dtype)
    out = a.clone()
    out[:3, 3] = (1 - g) * a[:3, 3] + g * b[:3, 3]
    R = a[:3, :3].T @ b[:3, :3]
    ang = _angle(R)
    if float(ang) > 1e-8:
        axis = _vee(R) / (2.0 * torch.sin(ang))
        th = g * ang
        Kx = _hat(axis)
        Rg = (torch.eye(3, dtype=dtype) + torch.sin(th) * Kx
              + (1 - torch.cos(th)) * (Kx @ Kx))
        out[:3, :3] = a[:3, :3] @ Rg
    return out


def pose_gap(a, b, dtype=F64) -> tuple:
    """(translation distance in m, rotation angle in degrees) of two
    poses: the keyframe gate's measure."""
    a, b = _t(a, dtype), _t(b, dtype)
    dt = float(torch.linalg.vector_norm(a[:3, 3] - b[:3, 3]))
    return dt, float(torch.rad2deg(_angle(a[:3, :3].T @ b[:3, :3])))


def fuse(last, source_last: str, n_inliers: int, rel, kf_inliers: int,
         abs_pose, icp_pose10, icp_success: bool, use_icp: bool = True,
         kf_gain: float = 1.0, dtype=F64) -> tuple:
    """(the frame's world pose, the winning source) from the previous pose
    `last` (None before the first: the identity), the previous frame's
    source, the native tracker's answers (`n_inliers` and `rel`
    T_{prev<-curr}, `kf_inliers` and `abs_pose` T_{world<-curr}) and ICP's
    relative pose and success."""
    last = torch.eye(4, dtype=dtype) if last is None else _t(last, dtype)
    icp_ok = use_icp and icp_success and icp_pose10 is not None
    feats = n_inliers >= MIN_INLIERS
    if feats:
        est = last @ _t(rel, dtype)
    elif icp_ok:
        est = last @ _t(icp_pose10, dtype)
    else:
        est = None
    after_loss = source_last == "hold"
    if kf_inliers >= MIN_KF_INLIERS:
        if est is None or after_loss:
            return _t(abs_pose, dtype), "keyframe"
        dt, dr = pose_gap(abs_pose, est, dtype)
        if dt <= KF_GATE_TRANS and dr <= KF_GATE_ROT:
            return nudge(est, abs_pose, kf_gain, dtype), "keyframe"
    if feats:
        return est, "features"
    if icp_ok:
        return est, "icp"
    return last.clone(), "hold"


def pose_diff(a, b) -> tuple:
    """(the widest translation gap in m, the rotation gap in radians) of
    two poses, in float64; the rotation from the skew part of R_a^T R_b,
    which resolves angles near zero."""
    a, b = _t(a), _t(b)
    dt = float((a[:3, 3] - b[:3, 3]).abs().max())
    s = torch.linalg.vector_norm(_vee(a[:3, :3].T @ b[:3, :3])) / 2.0
    return dt, float(torch.arcsin(torch.clamp(s, max=1.0)))


# ---------------------------------------------------------------------------
# loop closure: the keyframe chain's relaxation on SE(3)
# ---------------------------------------------------------------------------

def exp_se3(xi, dtype=F64) -> torch.Tensor:
    """xi = (w, v) -> the 4x4 pose."""
    xi = _t(xi, dtype)
    w, v = xi[:3], xi[3:]
    th = float(torch.linalg.vector_norm(w))
    W = _hat(w)
    eye = torch.eye(3, dtype=dtype)
    if th < 1e-10:
        R = eye + W
        V = eye + 0.5 * W
    else:
        A = torch.sin(_t(th, dtype)) / th
        B = (1 - torch.cos(_t(th, dtype))) / th ** 2
        C = (1 - A) / th ** 2
        R = eye + A * W + B * (W @ W)
        V = eye + B * W + C * (W @ W)
    T = torch.eye(4, dtype=dtype)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def log_se3(T) -> torch.Tensor:
    """The 4x4 pose -> xi = (w, v)."""
    T = torch.as_tensor(T)
    R, t = T[:3, :3], T[:3, 3]
    th = float(_angle(R))
    if th < 1e-10:
        w = 0.5 * _vee(R)
        Vinv = torch.eye(3, dtype=T.dtype) - 0.5 * _hat(w)
    else:
        th_t = _t(th, T.dtype)
        w = th / (2 * torch.sin(th_t)) * _vee(R)
        W = _hat(w)
        Vinv = (torch.eye(3, dtype=T.dtype) - 0.5 * W
                + (1 / th ** 2 - (1 + torch.cos(th_t))
                   / (2 * th * torch.sin(th_t))) * (W @ W))
    return torch.cat([w, Vinv @ t])


def relax(poses, edges, iters: int = 12, damping: float = 1e-6,
          dtype=F64) -> torch.Tensor:
    """Poses (N, 4, 4) world <- camera relaxed against the edges (i, j, Z,
    weight), each asking T_i^{-1} T_j = Z, by damped Gauss-Newton; node 0
    is held."""
    poses = _t(poses, dtype).clone()
    N = poses.shape[0]
    if N < 2 or not edges:
        return poses
    eps = 1e-6
    Zinvs = [torch.linalg.inv(_t(Z, dtype)) for (_, _, Z, _) in edges]
    basis = [exp_se3([eps if k == m else 0.0 for m in range(6)], dtype)
             for k in range(6)]

    def residual(Ti, Tj, Zinv):
        return log_se3(Zinv @ torch.linalg.solve(Ti, Tj))

    for _ in range(iters):
        H = torch.zeros((6 * N, 6 * N), dtype=dtype)
        b = torch.zeros(6 * N, dtype=dtype)
        for e, (i, j, _, w) in enumerate(edges):
            Ti, Tj = poses[i], poses[j]
            r = residual(Ti, Tj, Zinvs[e])
            Ji = torch.stack([(residual(Ti @ D, Tj, Zinvs[e]) - r) / eps
                              for D in basis], dim=1)
            Jj = torch.stack([(residual(Ti, Tj @ D, Zinvs[e]) - r) / eps
                              for D in basis], dim=1)
            si, sj = 6 * i, 6 * j
            H[si:si + 6, si:si + 6] += w * Ji.T @ Ji
            H[sj:sj + 6, sj:sj + 6] += w * Jj.T @ Jj
            H[si:si + 6, sj:sj + 6] += w * Ji.T @ Jj
            H[sj:sj + 6, si:si + 6] += w * Jj.T @ Ji
            b[si:si + 6] += w * Ji.T @ r
            b[sj:sj + 6] += w * Jj.T @ r
        H, b = H[6:, 6:], b[6:]
        H = H + torch.eye(H.shape[0], dtype=dtype) * (
            damping + 1e-12 * torch.trace(H))
        delta = torch.linalg.solve(H, -b)
        for i in range(1, N):
            poses[i] = poses[i] @ exp_se3(delta[6 * (i - 1):6 * i], dtype)
        if float(torch.linalg.vector_norm(delta)) < 1e-10:
            break
    return poses


def close_loop(poses, q_idx: int, m_idx: int, rel, loop_weight: float = 100.0,
               iters: int = 12, dtype=F64) -> tuple:
    """One loop closure over the keyframe poses (N, 4, 4): the chain's
    odometry edges, measured from the poses themselves, and the loop edge
    `rel` = T_m^{-1} T_q of keyframes `m_idx` and `q_idx`, weighted
    `loop_weight`. Returns (the relaxed poses, the correction
    T_q_new T_q_old^{-1} for the poses tracked after keyframe q)."""
    poses = _t(poses, dtype)
    edges = [(i, i + 1, torch.linalg.solve(poses[i], poses[i + 1]), 1.0)
             for i in range(poses.shape[0] - 1)]
    edges.append((int(m_idx), int(q_idx), _t(rel, dtype), loop_weight))
    new = relax(poses, edges, iters=iters, dtype=dtype)
    return new, new[q_idx] @ torch.linalg.inv(poses[q_idx])
