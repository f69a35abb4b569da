"""Spherical harmonics, degree 0-3 (counterpart of `dqo_map_tpu/utils/sh.py`).

SH layout is (..., K, 3): K = (deg+1)^2 RGB coefficient vectors, DC first.
Colors are offset by +0.5 and clamped at 0, as the rasterizer does, with
the reference's gradient at the clamp.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """SH basis values (..., K) with the signs folded in, so that
    eval = sum_k basis_k * sh_k."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    b = [C0 * torch.ones_like(x)]
    if deg > 0:
        b += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            b += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                  C2[3] * xz, C2[4] * (xx - yy)]
            if deg > 2:
                b += [C3[0] * y * (3.0 * xx - yy), C3[1] * xy * z,
                      C3[2] * y * (4.0 * zz - xx - yy),
                      C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                      C3[4] * x * (4.0 * zz - xx - yy),
                      C3[5] * z * (xx - yy), C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(b, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH color. sh: (..., K, 3); dirs: (..., 3) unit. -> (..., 3)."""
    K = (deg + 1) ** 2
    basis = sh_basis(deg, dirs)
    result = torch.sum(basis[..., None] * sh[..., :K, :], dim=-2) + 0.5
    # maximum, not clamp: a colour exactly at 0 (a black sample's DC) passes
    # half its gradient, as in the reference
    return torch.maximum(result, result.new_zeros(()))


def sh_basis_grad(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """The gradient of each `sh_basis` value in the direction (..., K, 3):
    the SH colour's derivative in the view direction is
    sum_k grad_k * (sh_k . dL/dcolour)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    zero = torch.zeros_like(x)
    g = [(zero, zero, zero)]
    if deg > 0:
        c = C1 * torch.ones_like(x)
        g += [(zero, -c, zero), (zero, zero, c), (-c, zero, zero)]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            g += [(C2[0] * y, C2[0] * x, zero),
                  (zero, C2[1] * z, C2[1] * y),
                  (-2.0 * C2[2] * x, -2.0 * C2[2] * y, 4.0 * C2[2] * z),
                  (C2[3] * z, zero, C2[3] * x),
                  (2.0 * C2[4] * x, -2.0 * C2[4] * y, zero)]
            if deg > 2:
                g += [(C3[0] * 6.0 * x * y, C3[0] * 3.0 * (xx - yy), zero),
                      (C3[1] * y * z, C3[1] * x * z, C3[1] * x * y),
                      (-C3[2] * 2.0 * x * y,
                       C3[2] * (4.0 * zz - xx - 3.0 * yy),
                       C3[2] * 8.0 * y * z),
                      (-C3[3] * 6.0 * x * z, -C3[3] * 6.0 * y * z,
                       C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
                      (C3[4] * (4.0 * zz - 3.0 * xx - yy),
                       -C3[4] * 2.0 * x * y, C3[4] * 8.0 * x * z),
                      (C3[5] * 2.0 * x * z, -C3[5] * 2.0 * y * z,
                       C3[5] * (xx - yy)),
                      (C3[6] * 3.0 * (xx - yy), -C3[6] * 6.0 * x * y, zero)]
    return torch.stack([torch.stack(v, dim=-1) for v in g], dim=-2)
