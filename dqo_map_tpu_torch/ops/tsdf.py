"""TSDF volume fusion and surface extraction (counterpart of
`dqo_map_tpu/ops/tsdf.py`), plain PyTorch on the volume's device.

Integration is a dense voxel -> pixel gather per frame: every voxel centre
is projected into the frame, reads the depth and colour of its nearest
pixel (`torch.round`, half to even, as `jnp.round`), and takes the
standard weighted running mean of its truncated signed distance. Surface
extraction walks the zero crossings along the three grid axes. The volume
is three dense tensors: at the 384^3 cap of `fuse_frames` about 57 M
voxels, 0.7 GB per float32 channel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.image import compute_vertex_map, transform_map


class TSDFVolume(NamedTuple):
    tsdf: torch.Tensor     # (X,Y,Z) signed distance, truncated, in trunc units
    weight: torch.Tensor   # (X,Y,Z)
    color: torch.Tensor    # (X,Y,Z,3)
    origin: torch.Tensor   # (3,)
    voxel: float
    trunc: float


def make_volume(origin, dims, voxel_size: float, trunc: float | None = None,
                device="cuda") -> TSDFVolume:
    """An empty volume of `dims` voxels of `voxel_size` from `origin`; the
    truncation is 4 voxels unless given."""
    trunc = trunc or 4 * voxel_size
    X, Y, Z = dims
    return TSDFVolume(
        tsdf=torch.ones((X, Y, Z), device=device),
        weight=torch.zeros((X, Y, Z), device=device),
        color=torch.zeros((X, Y, Z, 3), device=device),
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=device),
        voxel=float(voxel_size), trunc=float(trunc))


def _voxel_centres(shape, voxel: float, device) -> torch.Tensor:
    """(X,Y,Z,3) float32 voxel centres in voxel units times `voxel`."""
    X, Y, Z = shape
    grid = torch.stack(torch.meshgrid(
        torch.arange(X, device=device), torch.arange(Y, device=device),
        torch.arange(Z, device=device), indexing="ij"), dim=-1)
    return (grid.float() + 0.5) * voxel


def integrate(vol: TSDFVolume, depth: torch.Tensor, color: torch.Tensor,
              w2c: torch.Tensor, K: torch.Tensor,
              max_depth: float = 8.0) -> TSDFVolume:
    """Fuse one RGB-D frame, depth (H,W) and colour (H,W,3) seen with the
    world-to-camera `w2c` (4,4) and intrinsics `K` (3,3), into `vol`."""
    X, Y, Z = vol.tsdf.shape
    H, W = depth.shape
    p = (_voxel_centres((X, Y, Z), vol.voxel, depth.device)
         + vol.origin).reshape(-1, 3).T
    # the camera-frame centres, one row of w2c at a time
    x, y, z = (w2c[r, 0] * p[0] + w2c[r, 1] * p[1] + w2c[r, 2] * p[2]
               + w2c[r, 3] for r in range(3))
    zs = torch.where(z == 0, 1e-9, z)
    u = x / zs * K[0, 0] + K[0, 2]
    v = y / zs * K[1, 1] + K[1, 2]
    ui = torch.clamp(torch.round(u).int(), 0, W - 1).long()
    vi = torch.clamp(torch.round(v).int(), 0, H - 1).long()
    inview = (z > 0.05) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    d = depth[vi, ui]
    valid = inview & (d > 0) & (d < max_depth)
    sdf = (d - z) / vol.trunc
    take = valid & (sdf > -1.0)
    sdf = torch.clamp(sdf, -1.0, 1.0)
    c = color[vi, ui]

    w_old = vol.weight.reshape(-1)
    t_old = vol.tsdf.reshape(-1)
    c_old = vol.color.reshape(-1, 3)
    w_new = w_old + take.float()
    w_safe = torch.where(w_new == 0, 1.0, w_new)
    t_new = (t_old * w_old + torch.where(take, sdf, 0.0)) / w_safe
    c_new = (c_old * w_old[:, None]
             + torch.where(take[:, None], c, 0.0)) / w_safe[:, None]
    t_new = torch.where(w_new > 0, t_new, t_old)
    c_new = torch.where((w_new > 0)[:, None], c_new, c_old)
    return vol._replace(tsdf=t_new.reshape(X, Y, Z),
                        weight=w_new.reshape(X, Y, Z),
                        color=c_new.reshape(X, Y, Z, 3))


def extract_surface_points(vol: TSDFVolume, weight_thresh: float = 1.0):
    """Zero-crossing surface samples, interpolated linearly along each of
    the three grid axes between two observed voxels with |tsdf| < 1.

    Returns (points (N,3), colours (N,3), valid (N,)), N the voxel pairs
    along all three axes; `valid` marks the crossings."""
    t, w = vol.tsdf, vol.weight
    base = _voxel_centres(t.shape, 1.0, t.device)
    parts = []
    for axis in range(3):
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[axis] = slice(None, -1)
        sl1[axis] = slice(1, None)
        sl0, sl1 = tuple(sl0), tuple(sl1)
        t0, t1 = t[sl0], t[sl1]
        cross = ((torch.sign(t0) != torch.sign(t1))
                 & (w[sl0] >= weight_thresh) & (w[sl1] >= weight_thresh)
                 & (torch.abs(t0) < 1) & (torch.abs(t1) < 1))
        frac = torch.where(torch.abs(t0 - t1) > 1e-9, t0 / (t0 - t1), 0.5)
        grid = base[sl0].clone()
        grid[..., axis] += frac
        parts.append((grid.reshape(-1, 3) * vol.voxel + vol.origin,
                      vol.color[sl0].reshape(-1, 3), cross.reshape(-1)))
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def fuse_frames(cameras, depths, colors, voxel_size=0.02, margin=0.3,
                max_depth: float = 8.0, device="cuda") -> TSDFVolume:
    """Bound the scene by the frames' back-projected depth (plus `margin`,
    at most 384 voxels an axis), then integrate every frame. `cameras`
    carry `K`, `c2w` and `w2c`; depths (H,W) and colors (H,W,3) are numpy
    arrays or tensors."""
    mins, maxs = [], []
    for cam, d in zip(cameras, depths):
        d = torch.as_tensor(d, dtype=torch.float32, device=device)
        v = compute_vertex_map(d, torch.as_tensor(cam.K, dtype=torch.float32,
                                                  device=device))
        vw = transform_map(v, torch.as_tensor(cam.c2w, dtype=torch.float32,
                                              device=device))
        m = d > 0
        if int(m.sum()) == 0:
            continue
        vw = vw[m]
        mins.append(vw.amin(0).cpu().numpy())
        maxs.append(vw.amax(0).cpu().numpy())
    lo = np.min(mins, axis=0) - np.float32(margin)
    hi = np.max(maxs, axis=0) + np.float32(margin)
    dims = np.minimum(np.ceil((hi - lo) / np.float32(voxel_size)).astype(int),
                      384)
    vol = make_volume(lo, tuple(int(x) for x in dims), voxel_size,
                      device=device)
    for cam, d, c in zip(cameras, depths, colors):
        vol = integrate(
            vol, torch.as_tensor(d, dtype=torch.float32, device=device),
            torch.as_tensor(c, dtype=torch.float32, device=device),
            torch.as_tensor(cam.w2c, dtype=torch.float32, device=device),
            torch.as_tensor(cam.K, dtype=torch.float32, device=device),
            max_depth=max_depth)
    return vol
