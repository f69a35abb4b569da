"""MODE=1's object refinement in plain PyTorch: a frozen copy of the
port's `models/quadrics.py` (`_project_bbox`, `_bbox_iou_t`,
`objects_loss`, `refine_objects`, `_masked_adam_step`). Under
`precision.lowered` the inputs and each step's parameters are rounded.
"""

from __future__ import annotations

import torch

from .precision import rnd

OBJ_ITERS = 20        # refinement iterations (the port's OBJ_ITERS)


def _project_bbox(axes, R, center, P):
    """Projected bounding boxes (O, 4) of the ellipsoids axes (O,3), R
    (O,3,3), center (O,3) under the projections P (O,3,4), differentiably:
    the dual quadric through P, then the closed-form symmetric 2x2
    eigensolve of the recentred conic. The clamps are `torch.maximum`, which
    splits the gradient at a tie as `jnp.maximum` does."""
    O = axes.shape[0]
    dev, dt = axes.device, axes.dtype
    eye4 = torch.eye(4, dtype=dt, device=dev).expand(O, 4, 4)
    Q = torch.diag_embed(torch.cat([axes ** 2,
                                    torch.full((O, 1), -1.0, dtype=dt,
                                               device=dev)], dim=1))
    T = torch.cat([torch.cat([eye4[:, :3, :3], center[:, :, None]], dim=2),
                   eye4[:, 3:]], dim=1)
    zc = torch.zeros((O, 3, 1), dtype=dt, device=dev)
    Rw = torch.cat([torch.cat([R, zc], dim=2), eye4[:, 3:]], dim=1)
    tf = T @ Rw
    Qw = tf @ Q @ tf.transpose(1, 2)
    Qw = 0.5 * (Qw + Qw.transpose(1, 2))
    Qw = Qw / -Qw[:, 3:4, 3:4]
    C = P @ Qw @ P.transpose(1, 2)
    C = 0.5 * (C + C.transpose(1, 2))
    C = C / -C[:, 2:3, 2:3]
    cx = -C[:, 0, 2]
    cy = -C[:, 1, 2]
    # the conic recentred: with C22 = -1 and C[0:2,2] = -centre, translating
    # by -centre gives [[C00 + cx^2, C01 + cx cy], [., C11 + cy^2]]
    a = C[:, 0, 0] + cx * cx
    b = C[:, 0, 1] + cx * cy
    c = C[:, 1, 1] + cy * cy
    tiny = torch.tensor(1e-12, dtype=dt, device=dev)
    mid = 0.5 * (a + c)
    rad = torch.sqrt(torch.maximum(0.25 * (a - c) ** 2 + b * b, tiny))
    l1 = torch.abs(mid + rad)
    l2 = torch.abs(mid - rad)
    theta = 0.5 * torch.atan2(2 * b, a - c)
    ax1 = torch.sqrt(torch.maximum(l1, tiny))
    ax2 = torch.sqrt(torch.maximum(l2, tiny))
    ct, st = torch.cos(theta), torch.sin(theta)
    xmax = torch.sqrt(ax1 ** 2 * ct ** 2 + ax2 ** 2 * st ** 2)
    ymax = torch.sqrt(ax1 ** 2 * st ** 2 + ax2 ** 2 * ct ** 2)
    return torch.stack([cx - xmax, cy - ymax, cx + xmax, cy + ymax], dim=1)


def _bbox_iou_t(bb1, bb2):
    """IoU of the (O, 4) boxes bb1 and bb2, row by row."""
    zero = torch.zeros((), dtype=bb1.dtype, device=bb1.device)
    iw = torch.maximum(torch.minimum(bb1[:, 2], bb2[:, 2])
                       - torch.maximum(bb1[:, 0], bb2[:, 0]), zero)
    ih = torch.maximum(torch.minimum(bb1[:, 3], bb2[:, 3])
                       - torch.maximum(bb1[:, 1], bb2[:, 1]), zero)
    inter = iw * ih
    a1 = (bb1[:, 2] - bb1[:, 0]) * (bb1[:, 3] - bb1[:, 1])
    a2 = (bb2[:, 2] - bb2[:, 0]) * (bb2[:, 3] - bb2[:, 1])
    return inter / torch.maximum(a1 + a2 - inter,
                                 torch.full_like(inter, 1e-8))


def objects_loss(axes, R, center, bbox, P, valid, opt_mask):
    """The refinement's objective: sum over the optimized slots of 1 - IoU
    of the observed box `bbox` (O,4) and the projection under `P` (O,3,4);
    an invalid observation, or one the projection misses entirely, adds 0
    (the reference skips such a step)."""
    iou = _bbox_iou_t(bbox, _project_bbox(axes, R, center, P))
    loss = torch.where(valid & (iou > 1e-6), 1.0 - iou, 0.0)
    return torch.sum(torch.where(opt_mask, loss, 0.0))


def refine_objects(axes, R, center, obs_bbox, obs_P, obs_valid, opt_mask,
                   rand_idx, iters: int = OBJ_ITERS, lr_axes: float = 0.01,
                   lr_center: float = 0.001, lr_R: float = 0.01):
    """Masked Adam over all object slots at once.

    axes (O,3), R (O,3,3), center (O,3); obs_bbox (O,CAP,4), obs_P
    (O,CAP,3,4) (P = K @ Rt of each observation), obs_valid (O,CAP), opt_mask
    (O,), rand_idx (iters,O) the observation each slot fits at each step:
    tensors on one device. Returns the refined (axes, R, center); the
    slots outside `opt_mask` keep their values."""
    params = {"axes": axes, "R": R, "center": center}
    lrs = {"axes": lr_axes, "R": lr_R, "center": lr_center}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    rand_idx = torch.as_tensor(rand_idx, device=axes.device).long()
    rows = torch.arange(axes.shape[0], device=axes.device)
    for it in range(iters):
        o = rand_idx[it]
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        total = objects_loss(leaves["axes"], leaves["R"], leaves["center"],
                             obs_bbox[rows, o], obs_P[rows, o],
                             obs_valid[rows, o], opt_mask)
        grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
        grads = {k: rnd(g) for k, g in grads.items()}
        _masked_adam_step(params, grads, m, v, lrs, opt_mask, it + 1)
        params = {k: rnd(p) for k, p in params.items()}
    return params["axes"], params["R"], params["center"]


def _masked_adam_step(params: dict, grads: dict, m: dict, v: dict, lrs: dict,
                      opt_mask, step: int):
    """Step `step` of the object refinements' masked Adam (eps 1e-15, bias
    corrections in float32), in place on `params`, `m` and `v`: the slots
    outside `opt_mask` take a zero gradient and do not move."""
    t = torch.tensor(float(step), dtype=torch.float32)
    bc1 = float(1 - torch.tensor(0.9, dtype=torch.float32) ** t)
    bc2 = float(1 - torch.tensor(0.999, dtype=torch.float32) ** t)
    for k, p in params.items():
        mk = opt_mask.reshape((-1,) + (1,) * (p.dim() - 1))
        gk = torch.where(mk, grads[k], 0.0)
        m[k] = 0.9 * m[k] + 0.1 * gk
        v[k] = 0.999 * v[k] + 0.001 * gk * gk
        upd = lrs[k] * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + 1e-15)
        params[k] = p - torch.where(mk, upd, 0.0)
