"""Per-Gaussian view preprocessing: frustum cull, EWA projection, conics,
radii, tight support extents and the hit-plane inputs (counterpart of
`dqo_map_tpu/ops/projection.py`, the CUDA rasterizer's `preprocessCUDA`).

Written per component, in the reference's order of operations, so that the
tile binning that consumes it sees the same floats. For tensors on the card
`preprocess` launches K4's forward (`project_cuda.py`, `csrc/project.cu`),
which keeps that order bit for bit; `preprocess_ref` is the plain version
on any device, and `project_bwd_ref` the plain version of K4's backward,
the derivation the kernel follows line for line.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.math3d import normalize


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


def view_limits(cam: dict):
    """The EWA view point's clamp, 1.3x the half-FoV tangents, in float32
    as the reference computes them on its device."""
    return tuple(float(np.float32(1.3) * np.float32(cam[k]))
                 for k in ("tan_fovx", "tan_fovy"))


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
               scale_modifier: float = 1.0,
               valid_mask: Optional[torch.Tensor] = None,
               activate: bool = False) -> Preprocessed:
    """EWA projection of every Gaussian. `cam` is Camera.render_inputs();
    with `activate` the scales and rotations are the map's log-scales and
    quaternions as stored; `valid_mask` (P,) clears `valid` and `radius`
    of the rows it leaves out. On the card, K4's forward (the projection
    alone); `preprocess_ref` on the CPU."""
    if means3d.is_cuda:
        from . import project_cuda
        spec = project_cuda.Spec(*view_limits(cam), float(color_sigma),
                                 float(scale_modifier), int(width),
                                 int(height), bool(activate), -1)
        return project_cuda.preprocessed(*project_cuda.project_fwd(
            means3d.contiguous(), scales.contiguous(), rots.contiguous(),
            None, None, cam, spec, valid_mask))
    if activate:
        scales, rots = torch.exp(scales), normalize(rots)
    pre = preprocess_ref(means3d, scales, rots, cam, color_sigma, width,
                         height, scale_modifier)
    if valid_mask is not None:
        pre = pre._replace(valid=pre.valid & valid_mask,
                           radius=torch.where(valid_mask, pre.radius, 0.0))
    return pre


def preprocess_ref(means3d: torch.Tensor, scales: torch.Tensor,
                   rots: torch.Tensor, cam: dict, color_sigma: float,
                   width: int, height: int,
                   scale_modifier: float = 1.0) -> Preprocessed:
    """`preprocess`'s plain version, differentiable, on any device."""
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

    # EWA with the view point clamped to 1.3x the FoV
    limx, limy = view_limits(cam)
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


def project_bwd_ref(dfeats: torch.Tensor, cell_entry: torch.Tensor,
                    means3d: torch.Tensor, scales: torch.Tensor,
                    rots: torch.Tensor, opacities: torch.Tensor,
                    colors: torch.Tensor, cam: dict, width: int, height: int,
                    scale_modifier: float = 1.0, activate: bool = False,
                    sh_degree: int = -1):
    """K4's backward in plain PyTorch (`csrc/project.cu::project_bwd_kernel`,
    line for line): the entry features' cotangent `dfeats` (16, L) taken
    to the gradients of the leaves (means3d, scales, rots, opacities,
    colors) of the chain that `state_render_args`, `preprocess` and
    `pack_entries` make, with `activate` the leaves as stored (log-scales,
    quaternions, opacity logits) and `sh_degree` >= 0 the colours as SH
    (P, 16, 3).

    Each Gaussian's entries are summed first, through the binning's
    `cell_entry` (R, P) in cell order; rows 13 (scale_max) and 14 (id) are
    taken as 0, as K2 writes them. A row without entries gets 0. Then the
    chain rule per Gaussian, with the plain path's branches: the clamp of
    the view point passes the gradient inside its bounds, bounds included;
    `det == 0` and `tz == 0` are the `torch.where` constants; the colour
    clamp passes half at exactly 0 (`torch.maximum`)."""
    R_, P = cell_entry.shape
    gs = [torch.zeros(P, dtype=dfeats.dtype, device=dfeats.device)
          for _ in range(16)]
    hits = torch.zeros(P, dtype=torch.bool, device=dfeats.device)
    for j in range(R_):
        e = cell_entry[j].long()
        has = e >= 0
        col = dfeats[:, torch.clamp(e, min=0)]
        for r in range(16):
            if r not in (13, 14):
                gs[r] = gs[r] + torch.where(has, col[r], 0.0)
        hits = hits | has

    # the forward again, as the kernel recomputes it
    s = torch.exp(scales) if activate else scales
    if activate:
        qn = torch.linalg.norm(rots, dim=-1)
        q = rots / (qn + 1e-8)[:, None]
    else:
        q = rots
    w2c, full_proj, K = cam["w2c"], cam["full_proj"], cam["K"]
    W = [[w2c[r, c] for c in range(4)] for r in range(4)]
    M = [[full_proj[r, c] for c in range(4)] for r in range(4)]
    fx, fy = K[0, 0], K[1, 1]
    m_T = means3d.T

    def xform(A, r):
        return A[r][0] * m_T[0] + A[r][1] * m_T[1] + A[r][2] * m_T[2] + A[r][3]

    tx, ty, tz = xform(W, 0), xform(W, 1), xform(W, 2)
    phx, phy = xform(M, 0), xform(M, 1)
    pw = 1.0 / (xform(M, 3) + 1e-7)
    Rm = _rot_cols(q)
    ss = [(s[:, k] * scale_modifier) ** 2 for k in range(3)]
    limx, limy = view_limits(cam)
    tzs = torch.where(tz == 0, 1e-6, tz)
    ux, uy = tx / tzs, ty / tzs
    txl = torch.clamp(ux, -limx, limx) * tz
    tyl = torch.clamp(uy, -limy, limy) * tz
    invz = 1.0 / tzs
    invz2 = invz * invz
    T0 = [fx * invz * W[0][j] - fx * txl * invz2 * W[2][j] for j in range(3)]
    T1 = [fy * invz * W[1][j] - fy * tyl * invz2 * W[2][j] for j in range(3)]
    sxx, sxy, sxz, syy, syz, szz = build_cov3d(s, q, scale_modifier)
    S = [[sxx, sxy, sxz], [sxy, syy, syz], [sxz, syz, szz]]
    s0 = [sum(S[r][c] * T0[c] for c in range(3)) for r in range(3)]
    s1 = [sum(S[r][c] * T1[c] for c in range(3)) for r in range(3)]
    a = sum(T0[j] * s0[j] for j in range(3)) + 0.3
    b = sum(T1[j] * s0[j] for j in range(3))
    c = sum(T1[j] * s1[j] for j in range(3)) + 0.3
    det = a * c - b * b
    det_ok = det != 0
    s_T = s.T
    m0 = (s_T[0] <= s_T[1]) & (s_T[0] <= s_T[2])
    m1 = (~m0) & (s_T[1] <= s_T[2])
    sel = [m0, (~m0) & m1, (~m0) & (~m1)]
    nw = [torch.where(m0, Rm[i][0], torch.where(m1, Rm[i][1], Rm[i][2]))
          for i in range(3)]
    nc = [W[r][0] * nw[0] + W[r][1] * nw[1] + W[r][2] * nw[2]
          for r in range(3)]

    # ndm = mean_c . normal_c, depth = tz, normal_c = W3 n_w
    dtx = gs[15] * nc[0]
    dty = gs[15] * nc[1]
    dtz = gs[15] * nc[2] + gs[9]
    dnc = [gs[10] + gs[15] * tx, gs[11] + gs[15] * ty, gs[12] + gs[15] * tz]
    dnw = [W[0][i] * dnc[0] + W[1][i] * dnc[1] + W[2][i] * dnc[2]
           for i in range(3)]
    dR = [[torch.where(sel[k], dnw[r], 0.0) for k in range(3)]
          for r in range(3)]

    # xy = ndc * size * 0.5 + c, ndc = ph * pw, pw = 1 / (pw4 + 1e-7)
    dndcx = gs[0] * 0.5 * width
    dndcy = gs[1] * 0.5 * height
    dphx, dphy = dndcx * pw, dndcy * pw
    dpw4 = -(dndcx * phx + dndcy * phy) * (pw * pw)

    # conic = (c, -b, a) / det where det != 0, else (c, -b, a)
    det_s = torch.where(det_ok, det, 1.0)
    ddet = -(gs[2] * c + gs[3] * (-b) + gs[4] * a) / (det_s * det_s)
    da = torch.where(det_ok, gs[4] / det_s + ddet * c, gs[4])
    dc = torch.where(det_ok, gs[2] / det_s + ddet * a, gs[2])
    db = torch.where(det_ok, -gs[3] / det_s - 2.0 * b * ddet, -gs[3])

    # a = T0' S T0 + 0.3, b = T1' S T0, c = T1' S T1 + 0.3
    dT0 = [2.0 * da * s0[j] + db * s1[j] for j in range(3)]
    dT1 = [db * s0[j] + 2.0 * dc * s1[j] for j in range(3)]
    dS = [[da * T0[r] * T0[k] + db * T1[r] * T0[k] + dc * T1[r] * T1[k]
           for k in range(3)] for r in range(3)]

    dinvz = sum(fx * dT0[j] * W[0][j] + fy * dT1[j] * W[1][j]
                for j in range(3))
    dinvz2 = sum(-fx * txl * dT0[j] * W[2][j] - fy * tyl * dT1[j] * W[2][j]
                 for j in range(3))
    dtxl = sum(-fx * invz2 * dT0[j] * W[2][j] for j in range(3))
    dtyl = sum(-fy * invz2 * dT1[j] * W[2][j] for j in range(3))
    dinvz = dinvz + 2.0 * invz * dinvz2
    dtzs = -dinvz * (invz * invz)
    dtz = dtz + dtxl * torch.clamp(ux, -limx, limx) \
        + dtyl * torch.clamp(uy, -limy, limy)
    dux = torch.where((ux >= -limx) & (ux <= limx), dtxl * tz, 0.0)
    duy = torch.where((uy >= -limy) & (uy <= limy), dtyl * tz, 0.0)
    dtx = dtx + dux / tzs
    dty = dty + duy / tzs
    dtzs = dtzs - dux * tx / (tzs * tzs) - duy * ty / (tzs * tzs)
    dtz = dtz + torch.where(tz != 0, dtzs, 0.0)

    # S = R diag(ss) R': to R and to the scales
    dss = [sum(dS[r][cc] * Rm[r][k] * Rm[cc][k] for r in range(3)
               for cc in range(3)) for k in range(3)]
    dR = [[dR[r][k] + sum((dS[r][cc] + dS[cc][r]) * Rm[cc][k]
                          for cc in range(3)) * ss[k]
           for k in range(3)] for r in range(3)]

    dp = torch.stack([W[0][j] * dtx + W[1][j] * dty + W[2][j] * dtz
                      + M[0][j] * dphx + M[1][j] * dphy + M[3][j] * dpw4
                      for j in range(3)], dim=-1)

    # colours
    if sh_degree >= 0:
        from ..utils.sh import sh_basis, sh_basis_grad
        d = means3d - cam["cam_pos"][None, :]
        n = torch.linalg.norm(d, dim=-1)
        dn = n + 1e-12
        u = d / dn[:, None]
        nk = (sh_degree + 1) ** 2
        basis = sh_basis(sh_degree, u)                         # (P, nk)
        res = torch.sum(basis[..., None] * colors[:, :nk, :], dim=-2) + 0.5
        drgb = torch.stack(gs[6:9], dim=-1)
        dres = torch.where(res < 0, 0.0,
                           torch.where(res == 0, drgb * 0.5, drgb))
        dcol = torch.zeros_like(colors)
        dcol[:, :nk, :] = basis[..., None] * dres[:, None, :]
        gk = torch.sum(colors[:, :nk, :] * dres[:, None, :], dim=-1)
        du = torch.sum(sh_basis_grad(sh_degree, u) * gk[:, :, None], dim=1)
        dot = torch.sum(du * d, dim=-1)
        k2 = torch.where(n > 0, -dot / (dn * dn) / n, 0.0)
        dp = dp + du / dn[:, None] + d * k2[:, None]
    else:
        dcol = torch.stack(gs[6:9], dim=-1)

    dop = gs[5]
    if activate:
        sg = torch.sigmoid(opacities)
        dop = dop * (1.0 - sg) * sg

    sm = [s[:, k] * scale_modifier for k in range(3)]
    ds = torch.stack([dss[k] * 2.0 * sm[k] * scale_modifier
                      for k in range(3)], dim=-1)
    if activate:
        ds = ds * s

    w, x, y, z = q.T[0], q.T[1], q.T[2], q.T[3]
    dq = torch.stack([
        2.0 * (-z * dR[0][1] + y * dR[0][2] + z * dR[1][0] - x * dR[1][2]
               - y * dR[2][0] + x * dR[2][1]),
        2.0 * (y * dR[0][1] + z * dR[0][2] + y * dR[1][0]
               - 2.0 * x * dR[1][1] - w * dR[1][2] + z * dR[2][0]
               + w * dR[2][1] - 2.0 * x * dR[2][2]),
        2.0 * (-2.0 * y * dR[0][0] + x * dR[0][1] + w * dR[0][2]
               + x * dR[1][0] + z * dR[1][2] - w * dR[2][0] + z * dR[2][1]
               - 2.0 * y * dR[2][2]),
        2.0 * (-2.0 * z * dR[0][0] - w * dR[0][1] + x * dR[0][2]
               + w * dR[1][0] - 2.0 * z * dR[1][1] + y * dR[1][2]
               + x * dR[2][0] + y * dR[2][1]),
    ], dim=-1)
    if activate:
        dnq = qn + 1e-8
        dot = torch.sum(dq * rots, dim=-1)
        k2 = torch.where(qn > 0, -dot / (dnq * dnq) / qn, 0.0)
        dq = dq / dnq[:, None] + rots * k2[:, None]

    def only_hit(g):
        return torch.where(hits.reshape(-1, *([1] * (g.dim() - 1))), g, 0.0)

    return tuple(only_hit(g) for g in (dp, ds, dq, dop, dcol))
