"""Frozen copy of the port's `ops/projection.py`, part of the benchmark's plain
reference: it imports nothing of the port, and later changes to the
port do not reach it.

The original's docstring:

Per-Gaussian view preprocessing: frustum cull, EWA projection, conics,
radii, tight support extents and the hit-plane inputs (counterpart of
`dqo_map_tpu/ops/projection.py`, the CUDA rasterizer's `preprocessCUDA`).

Written per component, in the reference's order of operations, so that the
tile binning that consumes it sees the same floats.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Preprocessed(NamedTuple):
    valid: torch.Tensor       # (P,) bool: in frustum, invertible cov
    xy: torch.Tensor          # (P,2) pixel-space mean
    conic: torch.Tensor       # (P,3) inverse 2D covariance (a,b,c)
    depth: torch.Tensor       # (P,) camera-frame z
    radius: torch.Tensor      # (P,) float pixel radius (ceil applied)
    mean_c: torch.Tensor      # (P,3) camera-frame center
    normal_c: torch.Tensor    # (P,3) camera-frame min-scale axis
    scale_max: torch.Tensor   # (P,) max scale (x scale_modifier)
    ext: torch.Tensor         # (P,2) per-axis half-extents of the
                              # alpha >= 1/255 support, min'd with radius


def _rot_cols(rots):
    """R(q) of an unnormalized q as 9 (P,) tensors, r[i][j] = R[i,j]."""
    q_T = rots.T
    w, x, y, z = q_T[0], q_T[1], q_T[2], q_T[3]
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )


def build_cov3d(scales: torch.Tensor, rots: torch.Tensor,
                scale_modifier: float = 1.0):
    """Sigma = R diag(s^2) R^T as six (P,) components (xx,xy,xz,yy,yz,zz)."""
    R = _rot_cols(rots)
    s2 = ((scales * scale_modifier) ** 2).T
    s0, s1, s2_ = s2[0], s2[1], s2[2]

    def sig(a, b):
        return (R[a][0] * s0 * R[b][0] + R[a][1] * s1 * R[b][1]
                + R[a][2] * s2_ * R[b][2])

    return sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)


def min_scale_axis(scales: torch.Tensor, rots: torch.Tensor) -> torch.Tensor:
    """World-frame axis of the smallest scale, the splat normal; ties go to
    the lower axis."""
    R = _rot_cols(rots)
    s_T = scales.T
    s0, s1, s2 = s_T[0], s_T[1], s_T[2]
    m0 = (s0 <= s1) & (s0 <= s2)
    m1 = (~m0) & (s1 <= s2)

    def pick(r):
        return torch.where(m0, r[0], torch.where(m1, r[1], r[2]))

    return torch.stack([pick(R[0]), pick(R[1]), pick(R[2])], dim=-1)


def preprocess(means3d: torch.Tensor, scales: torch.Tensor, rots: torch.Tensor,
               cam: dict, color_sigma: float, width: int, height: int,
               scale_modifier: float = 1.0) -> Preprocessed:
    """EWA projection of every Gaussian. `cam` is Camera.render_inputs()."""
    w2c = cam["w2c"]
    full_proj = cam["full_proj"]
    K = cam["K"]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    m_T = means3d.T
    mx, my, mz = m_T[0], m_T[1], m_T[2]

    def xform(M, r):
        return M[r, 0] * mx + M[r, 1] * my + M[r, 2] * mz + M[r, 3]

    tx_c = xform(w2c, 0)
    ty_c = xform(w2c, 1)
    tz_c = xform(w2c, 2)
    p_hx = xform(full_proj, 0)
    p_hy = xform(full_proj, 1)
    p_w4 = xform(full_proj, 3)
    p_w = 1.0 / (p_w4 + 1e-7)
    ndc_x = p_hx * p_w
    ndc_y = p_hy * p_w

    in_frustum = (tz_c > 0.2) & (torch.abs(ndc_x) <= 1.3) & (torch.abs(ndc_y) <= 1.3)

    sxx, sxy, sxz, syy, syz, szz = build_cov3d(scales, rots, scale_modifier)

    # EWA with the view point clamped to 1.3x the FoV (float32 bounds, as the
    # reference computes them on its device)
    limx = float(np.float32(1.3) * np.float32(cam["tan_fovx"]))
    limy = float(np.float32(1.3) * np.float32(cam["tan_fovy"]))
    tz_safe = torch.where(tz_c == 0, 1e-6, tz_c)
    txl = torch.clamp(tx_c / tz_safe, -limx, limx) * tz_c
    tyl = torch.clamp(ty_c / tz_safe, -limy, limy) * tz_c
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z
    W00, W01, W02 = w2c[0, 0], w2c[0, 1], w2c[0, 2]
    W10, W11, W12 = w2c[1, 0], w2c[1, 1], w2c[1, 2]
    W20, W21, W22 = w2c[2, 0], w2c[2, 1], w2c[2, 2]
    # T = J @ W, J = [[fx/z, 0, -fx tx/z^2], [0, fy/z, -fy ty/z^2]]
    T00 = fx * inv_z * W00 - fx * txl * inv_z2 * W20
    T01 = fx * inv_z * W01 - fx * txl * inv_z2 * W21
    T02 = fx * inv_z * W02 - fx * txl * inv_z2 * W22
    T10 = fy * inv_z * W10 - fy * tyl * inv_z2 * W20
    T11 = fy * inv_z * W11 - fy * tyl * inv_z2 * W21
    T12 = fy * inv_z * W12 - fy * tyl * inv_z2 * W22

    def sig_vec(u0, u1, u2):
        return (sxx * u0 + sxy * u1 + sxz * u2,
                sxy * u0 + syy * u1 + syz * u2,
                sxz * u0 + syz * u1 + szz * u2)

    s0x, s0y, s0z = sig_vec(T00, T01, T02)
    a = T00 * s0x + T01 * s0y + T02 * s0z + 0.3
    b = T10 * s0x + T11 * s0y + T12 * s0z
    s1x, s1y, s1z = sig_vec(T10, T11, T12)
    c = T10 * s1x + T11 * s1y + T12 * s1z + 0.3

    det = a * c - b * b
    det_ok = det != 0.0
    det_safe = torch.where(det_ok, det, 1.0)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(color_sigma * torch.sqrt(lambda1))

    # tight per-axis extents of {Q(d) <= ln 255}: |dx| <= sqrt(2 tau a),
    # |dy| <= sqrt(2 tau c), intersected with the 3-sigma circle
    TAU2 = 2.0 * 5.5413
    ext = torch.stack([
        torch.minimum(torch.sqrt(TAU2 * torch.clamp(a, min=0.0)), radius),
        torch.minimum(torch.sqrt(TAU2 * torch.clamp(c, min=0.0)), radius),
    ], dim=-1)

    xy = torch.stack(
        [ndc_x * width * 0.5 + cx, ndc_y * height * 0.5 + cy], dim=-1)

    n_w = min_scale_axis(scales, rots)
    nx, ny, nz = n_w[:, 0], n_w[:, 1], n_w[:, 2]
    normal_c = torch.stack(
        [W00 * nx + W01 * ny + W02 * nz,
         W10 * nx + W11 * ny + W12 * nz,
         W20 * nx + W21 * ny + W22 * nz], dim=-1)
    scale_max = torch.amax(scales, dim=-1) * scale_modifier
    mean_c = torch.stack([tx_c, ty_c, tz_c], dim=-1)

    valid = in_frustum & det_ok
    return Preprocessed(
        valid=valid, xy=xy, conic=conic, depth=tz_c,
        radius=torch.where(valid, radius, 0.0), mean_c=mean_c,
        normal_c=normal_c, scale_max=scale_max,
        ext=torch.where(valid[:, None], ext, 0.0),
    )
