"""Coarse-to-fine point-to-plane ICP (counterpart of
`dqo_map_tpu/slam/icp.py`).

Projective data association by nearest-pixel warping, one Gauss-Newton
step per iteration with Levenberg-Marquardt damping, and the 6x6 solve on
the device (an unrolled Cholesky), so the pose never leaves it. On a card
the pyramid runs as one CUDA graph (`IcpGraph`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.math3d import exp_se3


def warp_nearest(feat: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour warp of (H,W,C) by pixel coords (H,W), border clamp."""
    H, W, C = feat.shape
    ui = torch.clamp(torch.round(u).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.round(v).to(torch.int64), 0, H - 1)
    return feat.reshape(H * W, C)[(vi * W + ui).reshape(-1)].reshape(H, W, C)


def _rot_rows(m, R, t=None):
    """(H,W,3) @ R^T (+ t), written per component."""
    x, y, z = m[..., 0], m[..., 1], m[..., 2]
    ox = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z
    oy = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z
    oz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z
    if t is not None:
        ox, oy, oz = ox + t[0], oy + t[1], oz + t[2]
    return torch.stack([ox, oy, oz], dim=-1)


def solve6_cholesky(A, b, eps: float = 1e-12):
    """Unrolled 6x6 Cholesky solve of A x = b."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        s = A[i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = torch.sqrt(torch.clamp(s, min=eps))
        inv_d = 1.0 / L[i][i]
        for j in range(i + 1, 6):
            s = A[j, i]
            for k in range(i):
                s = s - L[j][k] * L[i][k]
            L[j][i] = s * inv_d
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def icp_residuals_jacobian(vertex0, vertex1, normal0, normal1, mask0, pose10,
                           K, distance_threshold, normal_threshold_cos):
    """Point-to-plane residuals and their (N,6) Jacobian after warping frame
    0's points into frame 1 by `pose10`; invalid rows are zero. Returns
    (res (N,), J (N,6), valid (H,W))."""
    R = pose10[:3, :3]
    t = pose10[:3, 3]
    H, W, _ = vertex0.shape
    v0in1 = _rot_rows(vertex0, R, t)
    n0in1 = _rot_rows(normal0, R)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = v0in1[..., 2]
    z_safe = torch.where(z == 0, 1e-8, z)
    u = (v0in1[..., 0] / z_safe) * fx + cx
    v = (v0in1[..., 1] / z_safe) * fy + cy
    inview = (u > 0) & (u < W - 1) & (v > 0) & (v < H - 1)

    g = warp_nearest(torch.cat([vertex1, normal1], dim=-1), u, v)
    r_vertex1 = g[..., :3]
    r_normal1 = g[..., 3:]
    mask1 = r_vertex1[..., 2] > 0.0
    diff = v0in1 - r_vertex1
    normal_agree = torch.sum(n0in1 * r_normal1, dim=-1) > normal_threshold_cos

    res = torch.sum(r_normal1 * diff, dim=-1)
    # J_rot = -(n x v)
    nx, ny, nz = r_normal1[..., 0], r_normal1[..., 1], r_normal1[..., 2]
    vx, vy, vz = v0in1[..., 0], v0in1[..., 1], v0in1[..., 2]
    J_rot = torch.stack([-(ny * vz - nz * vy),
                         -(nz * vx - nx * vz),
                         -(nx * vy - ny * vx)], dim=-1)
    J = torch.cat([J_rot, r_normal1], dim=-1)

    occ = (~inview) | (torch.linalg.norm(diff, dim=-1) > distance_threshold)
    invalid = occ | (~mask0) | (~mask1) | (~normal_agree)
    J = torch.where(invalid[..., None], 0.0, J)
    res = torch.where(invalid, 0.0, res)
    return res.reshape(-1), J.reshape(-1, 6), ~invalid


def gn_step(pose10, vertex0, vertex1, normal0, normal1, mask0, K,
            distance_threshold, normal_threshold_cos, damping):
    res, J, valid = icp_residuals_jacobian(
        vertex0, vertex1, normal0, normal1, mask0, pose10, K,
        distance_threshold, normal_threshold_cos)
    JtJ = J.T @ J
    JtR = J.T @ res
    # LM damping: trace(JtJ) * damping on the diagonal
    Hm = JtJ + torch.trace(JtJ) * damping * torch.eye(6, device=J.device)
    xi = -solve6_cholesky(Hm, JtR)
    return exp_se3(xi) @ pose10, torch.sum(valid)


def icp_level(pose10, vertex0, vertex1, normal0, normal1, K, iters,
              distance_threshold, normal_threshold_cos, damping):
    """`iters` Gauss-Newton iterations at one pyramid level."""
    mask0 = vertex0[..., 2] > 0.0
    nvalid = torch.zeros((), dtype=torch.int64, device=vertex0.device)
    for _ in range(iters):
        pose10, nvalid = gn_step(pose10, vertex0, vertex1, normal0, normal1,
                                 mask0, K, distance_threshold,
                                 normal_threshold_cos, damping)
    H, W = vertex0.shape[:2]
    return pose10, nvalid / (H * W)


class IcpConfig(NamedTuple):
    downscales: tuple = (0.25, 0.5, 1.0)
    iters: tuple = (5, 5, 5)
    distance_threshold: float = 0.1
    normal_threshold_cos: float = float(math.cos(math.radians(20.0)))
    damping: float = 1e-4
    fail_threshold: float = 1e-4
    min_valid_ratio: float = 0.3


def icp_pyramid(vertex_pyr0, normal_pyr0, vertex_pyr1, normal_pyr1,
                K: torch.Tensor, cfg: IcpConfig):
    """Full coarse-to-fine ICP: pose10 that maps pyramid 1's points onto
    pyramid 0's. Returns (pose10 (4,4), p2p, valid ratio), p2p being the
    mean squared point-to-plane residual over the final inlier
    associations."""
    pose = torch.eye(4, dtype=torch.float32, device=K.device)
    for level, (ds, iters) in enumerate(zip(cfg.downscales, cfg.iters)):
        # the residuals read only fx, fy, cx and cy of the scaled matrix
        pose, _ = icp_level(
            pose, vertex_pyr1[level], vertex_pyr0[level],
            normal_pyr1[level], normal_pyr0[level], K * ds, iters,
            cfg.distance_threshold, cfg.normal_threshold_cos, cfg.damping)
    v1, n1 = vertex_pyr1[-1], normal_pyr1[-1]
    v0, n0 = vertex_pyr0[-1], normal_pyr0[-1]
    res, _, inlier = icp_residuals_jacobian(
        v1, v0, n1, n0, v1[..., 2] > 0.0, pose, K,
        cfg.distance_threshold, cfg.normal_threshold_cos)
    n_in = torch.sum(inlier)
    p2p = torch.sum(res * res) / torch.clamp(n_in, min=1)
    return pose, p2p, n_in / res.shape[0]


class IcpGraph:
    """`icp_pyramid` on a card as one CUDA graph. A pyramid is thousands
    of small kernels; launched one by one they fill the card's launch queue
    whenever the card is behind, and the host then waits for the card to
    drain it. The graph is captured over static input buffers at the
    first call, which waits for the card once, and replayed after: the
    inputs are copied in, one launch runs the pyramid, and the outputs
    are copied out. The kernels are those of `icp_pyramid`."""

    def __init__(self, vertex_pyr0, normal_pyr0, vertex_pyr1, normal_pyr1,
                 K: torch.Tensor, cfg: IcpConfig):
        self._levels = len(vertex_pyr0)
        self._inputs = [t.clone() for t in (*vertex_pyr0, *normal_pyr0,
                                             *vertex_pyr1, *normal_pyr1, K)]
        stream = torch.cuda.current_stream(K.device)
        with torch.cuda.device(K.device):
            # a run outside the capture first, as capturing requires
            side = torch.cuda.Stream()
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                self._run(cfg)
            stream.wait_stream(side)
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph):
                self._outputs = self._run(cfg)

    def _run(self, cfg: IcpConfig):
        n, x = self._levels, self._inputs
        return icp_pyramid(x[:n], x[n:2 * n], x[2 * n:3 * n],
                           x[3 * n:4 * n], x[4 * n], cfg)

    def fits(self, vertex_pyr0, K: torch.Tensor) -> bool:
        """Whether pyramids of these shapes, on this card, replay it."""
        return (K.device == self._inputs[-1].device
                and [t.shape for t in vertex_pyr0]
                == [t.shape for t in self._inputs[:self._levels]])

    def __call__(self, vertex_pyr0, normal_pyr0, vertex_pyr1, normal_pyr1,
                 K: torch.Tensor):
        """(pose10, p2p, valid ratio) as `icp_pyramid` returns them."""
        for dst, src in zip(self._inputs, (*vertex_pyr0, *normal_pyr0,
                                           *vertex_pyr1, *normal_pyr1, K)):
            dst.copy_(src)
        self._graph.replay()
        return tuple(o.clone() for o in self._outputs)
