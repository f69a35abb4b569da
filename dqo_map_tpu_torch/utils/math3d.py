"""3D math: quaternions, SE(3), slerp, trajectory alignment (counterpart of
`dqo_map_tpu/utils/math3d.py`, the part the port calls).

Quaternions are (w, x, y, z), as in the rasterizer.
"""

from __future__ import annotations

import numpy as np
import torch


def normalize(v: torch.Tensor, eps: float = 1e-8, dim: int = -1) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=dim, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(...,4) wxyz quaternion -> (...,3,3) rotation matrix. Normalizes first."""
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) rotation -> (...,4) wxyz quaternion, normalized; Shepperd's
    four cases, chosen without branching."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def s_of(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2

    s = s_of(tr + 1.0)
    c0 = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                      (m10 - m01) / s], -1)
    s = s_of(1.0 + m00 - m11 - m22)
    c1 = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                      (m02 + m20) / s], -1)
    s = s_of(1.0 + m11 - m00 - m22)
    c2 = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                      (m12 + m21) / s], -1)
    s = s_of(1.0 + m22 - m00 - m11)
    c3 = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                      0.25 * s], -1)
    use0 = tr > 0
    use1 = (~use0) & (m00 >= m11) & (m00 >= m22)
    use2 = (~use0) & (~use1) & (m11 >= m22)
    q = torch.where(use0[..., None], c0, torch.where(
        use1[..., None], c1, torch.where(use2[..., None], c2, c3)))
    return normalize(q)


def quaternion_from_two_vectors(init_vec: torch.Tensor,
                                target_vec: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating init_vec onto target_vec."""
    axis = normalize(torch.linalg.cross(init_vec, target_vec))
    cosang = torch.clamp(torch.sum(init_vec * target_vec, dim=-1), -1.0, 1.0)
    half = torch.arccos(cosang)[..., None] / 2
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def skew(w: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) skew-symmetric matrices."""
    o = torch.zeros_like(w[..., 0])
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack([
        torch.stack([o, -w2, w1], -1),
        torch.stack([w2, o, -w0], -1),
        torch.stack([-w1, w0, o], -1),
    ], dim=-2)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) -> SE(3) exponential map; xi = [w(3), v(3)]. Branch-free, with
    Taylor-safe coefficients near theta = 0."""
    w = xi[:3]
    v = xi[3:6]
    w_hat = skew(w)
    w_hat2 = w_hat @ w_hat
    theta = torch.linalg.norm(w)
    theta2 = theta * theta
    small = theta < 1e-8
    one = torch.ones_like(theta)
    st = torch.where(small, one, torch.sin(theta) / torch.where(small, one, theta))
    # (1-cos t)/t^2 = 2 sin^2(t/2)/t^2, the cancellation-free form
    half_sin = torch.sin(theta / 2)
    ct = torch.where(small, 0.5 * one,
                     2.0 * half_sin * half_sin / torch.where(small, one, theta2))
    k2 = torch.where(small, one / 6.0,
                     (theta - torch.sin(theta))
                     / torch.where(small, one, theta2 * theta))
    eye3 = torch.eye(3, dtype=xi.dtype, device=xi.device)
    e_w = eye3 + w_hat * st + w_hat2 * ct
    j = eye3 + ct * w_hat + k2 * w_hat2
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = e_w
    T[:3, 3] = j @ v
    return T


def slerp(v0: torch.Tensor, v1: torch.Tensor, t: torch.Tensor,
          DOT_THRESHOLD: float = 0.9995) -> torch.Tensor:
    """Batched spherical interpolation of quaternions / vectors from v0
    (t = 0) to v1 (t = 1), (..., C) with t (..., 1); a plain lerp where
    the two are nearly colinear, and a guarded sin."""
    v0n = normalize(v0)
    v1n = normalize(v1)
    dot = torch.sum(v0n * v1n, dim=-1)
    dot_mag = torch.abs(dot)
    gotta_lerp = torch.isnan(dot_mag) | (dot_mag > DOT_THRESHOLD)
    lerped = v0 + (v1 - v0) * t
    theta_0 = torch.arccos(torch.clamp(dot, -1.0, 1.0))[..., None]
    sin_theta_0 = torch.sin(theta_0)
    safe_sin = torch.where(torch.abs(sin_theta_0) < 1e-6, 1.0, sin_theta_0)
    theta_t = theta_0 * t
    s0 = torch.sin(theta_0 - theta_t) / safe_sin
    s1 = torch.sin(theta_t) / safe_sin
    slerped = s0 * v0 + s1 * v1
    return torch.where(gotta_lerp[..., None], lerped, slerped)


def rot_compare(prev_rot: np.ndarray, curr_rot: np.ndarray):
    """Angle between two rotations in (rad, deg)."""
    rot_diff = prev_rot.T @ curr_rot
    cos_theta = np.clip((np.trace(rot_diff) - 1) / 2, -1.0, 1.0)
    rad = np.arccos(cos_theta)
    return rad, np.rad2deg(rad)


def trans_compare(prev_trans: np.ndarray, curr_trans: np.ndarray):
    d = prev_trans - curr_trans
    return np.linalg.norm(d, ord=1), np.linalg.norm(d, ord=2)


def horn_align(model: np.ndarray, data: np.ndarray):
    """Align trajectories `model` (3,n) onto `data` (3,n), Horn's closed
    form. Returns (rot, trans, per-point error)."""
    model_zc = model - model.mean(1, keepdims=True)
    data_zc = data - data.mean(1, keepdims=True)
    W = model_zc @ data_zc.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.identity(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)
    err = rot @ model + trans - data
    return rot, trans, np.sqrt(np.sum(err * err, 0))


def eval_ate(pose_estimate: np.ndarray, pose_gt: np.ndarray) -> float:
    """ATE RMSE x100 (cm) between (n,3) translation arrays."""
    pe = np.asarray(pose_estimate, dtype=np.float64).T
    pg = np.asarray(pose_gt, dtype=np.float64).T
    _, _, trans_error = horn_align(pe, pg)
    return float(np.sqrt(np.dot(trans_error, trans_error) / len(trans_error)) * 100)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """A 4x4 transform applied to (..., 3) points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def transform_dirs(T: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """A 4x4 transform's rotation applied to (..., 3) directions."""
    return dirs @ T[:3, :3].T
