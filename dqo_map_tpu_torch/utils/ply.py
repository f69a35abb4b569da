"""Binary PLY IO for Gaussian maps, numpy only (counterpart of
`dqo_map_tpu/utils/ply.py`).

The reference's attribute layout: x y z nx ny nz f_dc_0..2 f_rest_0..44
opacity scale_0..2 rot_0..3 [confidence], little-endian float32, so maps
interchange with the reference's tools, with SIBR viewers and with the JAX
package (the same state writes the same bytes in both packages).
"""

from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np
import torch

from ..models import gaussian_map as gm


def _attribute_names(sh_rest: int, include_confidence: bool):
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(sh_rest * 3)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    if include_confidence:
        names.append("confidence")
    return names


def _write_vertices(path: str, names: list, data: np.ndarray):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header = io.StringIO()
    header.write("ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {data.shape[0]}\n")
    for n in names:
        header.write(f"property float {n}\n")
    header.write("end_header\n")
    with open(path, "wb") as f:
        f.write(header.getvalue().encode("ascii"))
        f.write(np.ascontiguousarray(data, "<f4").tobytes())


def write_gaussian_ply(path: str, xyz, f_dc, f_rest, opacity, scaling,
                       rotation, confidence: Optional[np.ndarray] = None):
    """f_dc (P,3); f_rest (P,K-1,3), stored channel-major like the
    reference (features (P,3,K-1) flattened)."""
    P = xyz.shape[0]
    names = _attribute_names(f_rest.shape[1], confidence is not None)
    cols = [xyz, np.zeros_like(xyz), f_dc.reshape(P, 3),
            np.transpose(f_rest, (0, 2, 1)).reshape(P, -1),
            opacity.reshape(P, 1), scaling.reshape(P, 3),
            rotation.reshape(P, 4)]
    if confidence is not None:
        cols.append(confidence.reshape(P, 1))
    data = np.concatenate([np.asarray(c, np.float32) for c in cols], axis=1)
    if data.shape[1] != len(names):
        raise ValueError(f"{data.shape[1]} columns for {len(names)} names")
    _write_vertices(path, names, data)


def read_gaussian_ply(path: str) -> dict:
    """xyz, f_dc (P,3), f_rest (P,K-1,3), opacity, scaling, rotation and
    confidence (zeros where the file has none)."""
    with open(path, "rb") as f:
        raw = f.read()
    hdr_end = raw.index(b"end_header\n") + len(b"end_header\n")
    names, count, binary = [], 0, True
    for line in raw[:hdr_end].decode("ascii").splitlines():
        parts = line.split()
        if parts[0] == "element" and parts[1] == "vertex":
            count = int(parts[2])
        elif parts[0] == "property":
            names.append(parts[2])
        elif parts[0] == "format" and parts[1] == "ascii":
            binary = False
    if binary:
        data = np.frombuffer(raw[hdr_end:], "<f4",
                             count=count * len(names)).reshape(count, len(names))
    else:
        data = np.loadtxt(io.StringIO(raw[hdr_end:].decode()),
                          dtype=np.float32).reshape(count, len(names))
    col = {n: data[:, i] for i, n in enumerate(names)}
    rest = sorted([n for n in names if n.startswith("f_rest_")],
                  key=lambda s: int(s.split("_")[-1]))
    f_rest = np.stack([col[n] for n in rest], axis=1)
    f_rest = f_rest.reshape(count, 3, len(rest) // 3).transpose(0, 2, 1)
    return {
        "xyz": np.stack([col["x"], col["y"], col["z"]], 1),
        "f_dc": np.stack([col[f"f_dc_{i}"] for i in range(3)], 1),
        "f_rest": f_rest,
        "opacity": col["opacity"],
        "scaling": np.stack([col[f"scale_{i}"] for i in range(3)], 1),
        "rotation": np.stack([col[f"rot_{i}"] for i in range(4)], 1),
        "confidence": col.get("confidence", np.zeros(count, np.float32)),
    }


def _subset_mask(status: np.ndarray, subset: str) -> np.ndarray:
    if subset == "global":
        return status != gm.DEAD
    if subset == "unstable":
        return status == gm.UNSTABLE
    if subset == "stable":
        return status == gm.STABLE
    raise ValueError(subset)


def save_map_ply(state: gm.MapState, path: str, subset: str = "global",
                 include_confidence: bool = True,
                 mask: Optional[np.ndarray] = None):
    """Write a MapState subset in the reference layout; an explicit `mask`
    over the slots intersects the subset (the per-object exports). An
    empty selection writes no file."""
    host = {f: getattr(state, f).detach().cpu().numpy()
            for f in ("xyz", "sh", "opacity", "scaling", "rotation",
                      "confidence", "status")}
    sel = _subset_mask(host["status"], subset)
    if mask is not None:
        sel = sel & np.asarray(mask)
    if sel.sum() == 0:
        return
    sh = host["sh"][sel]
    write_gaussian_ply(path, host["xyz"][sel], sh[:, 0, :], sh[:, 1:, :],
                       host["opacity"][sel], host["scaling"][sel],
                       host["rotation"][sel],
                       host["confidence"][sel] if include_confidence else None)


def load_map_ply(path: str, capacity: int, status_value: int = gm.STABLE,
                 device="cuda") -> gm.MapState:
    """A MapState of `capacity` slots holding a PLY's Gaussians in its
    first rows, all with status `status_value`."""
    d = read_gaussian_ply(path)
    P = d["xyz"].shape[0]
    if P > capacity:
        raise ValueError(f"{P} gaussians > capacity {capacity}")
    state = gm.empty_map(capacity, device)
    sh = np.zeros((P, gm.SH_K, 3), np.float32)
    sh[:, 0, :] = d["f_dc"]
    sh[:, 1:1 + d["f_rest"].shape[1], :] = d["f_rest"]
    rows = {"xyz": d["xyz"], "sh": sh, "scaling": d["scaling"],
            "rotation": d["rotation"], "opacity": d["opacity"],
            "confidence": d["confidence"]}
    new = {}
    for k, v in rows.items():
        t = getattr(state, k).clone()
        t[:P] = torch.as_tensor(np.array(v, np.float32), device=t.device)
        new[k] = t
    status = state.status.clone()
    status[:P] = status_value
    return state.replace(**new, status=status, count=P)


def _quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """(P,4) wxyz -> (P,3,3), normalizing first."""
    q = q / (np.linalg.norm(q, axis=-1, keepdims=True) + np.float32(1e-8))
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def densify_point_cloud(state: gm.MapState, sigma: int = 1,
                        circle_num: int = 30, levels: int = 5,
                        subset: str = "stable", seed: int = 0):
    """Disc-densified point cloud from the splat ellipses (the
    `pcd_densify.ply` snapshot of a run's end): each Gaussian gives
    circle_num * levels * sigma points on concentric rings of the ellipse
    of its two largest axes, each with the disc normal (its smallest axis).
    Returns (points (M,3) float32, normals (M,3) float32)."""
    status = state.status.cpu().numpy()
    sel = (status == gm.STABLE) if subset == "stable" else (status != gm.DEAD)
    if sel.sum() == 0:
        return (np.zeros((0, 3), np.float32),) * 2
    xyz = state.xyz.detach().cpu().numpy()[sel]
    scales = np.exp(state.scaling.detach().cpu().numpy()[sel])
    rot = state.rotation.detach().cpu().numpy()[sel]
    rot = rot / (np.linalg.norm(rot, axis=-1, keepdims=True) + np.float32(1e-8))
    R = _quat_to_rotmat(rot)                        # columns are the axes
    order = np.argsort(scales, axis=1)              # ascending
    ar = np.arange(xyz.shape[0])
    normal = R[ar, :, order[:, 0]]
    plane0 = R[ar, :, order[:, 1]]
    plane1 = R[ar, :, order[:, 2]]
    axis0 = scales[ar, order[:, 1]][:, None]
    axis1 = scales[ar, order[:, 2]][:, None]

    rng = np.random.default_rng(seed)
    theta = np.tile(rng.uniform(0, 2 * np.pi, (1, circle_num)),
                    (1, levels * sigma))
    radii = np.concatenate([
        np.repeat((np.arange(levels) + 0.5) / levels, circle_num) + s
        for s in range(sigma)])[None]
    a = axis0 * radii
    b = axis1 * radii
    pts = (xyz[:, None, :]
           + (a * np.cos(theta))[..., None] * plane0[:, None, :]
           + (b * np.sin(theta))[..., None] * plane1[:, None, :])
    nrm = np.broadcast_to(normal[:, None, :], pts.shape)
    return (pts.reshape(-1, 3).astype(np.float32),
            nrm.reshape(-1, 3).astype(np.float32))


def write_point_normal_ply(path: str, points: np.ndarray,
                           normals: np.ndarray):
    """x y z nx ny nz binary PLY (the pcd_densify.ply format)."""
    data = np.concatenate([np.asarray(points, np.float32),
                           np.asarray(normals, np.float32)], axis=1)
    _write_vertices(path, ["x", "y", "z", "nx", "ny", "nz"], data)


def read_mesh_ply(path: str):
    """A triangle-mesh PLY (ascii or binary little-endian): (verts (N,3)
    float32, faces (M,3) int64, or None for a point cloud). Reads the
    float / double x y z [+ extras] vertex layouts and uchar-count face
    lists of ground-truth meshes."""
    with open(path, "rb") as f:
        raw = f.read()
    hdr_end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:hdr_end].decode("ascii", "replace").splitlines()
    fmt = "binary_little_endian"
    elems = []          # [(name, count, [(type, prop) or ("list", ct, it)])]
    cur = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elems.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur[2].append(("list", parts[2], parts[3]))
            else:
                cur[2].append((parts[1], parts[2]))

    np_t = {"float": "<f4", "float32": "<f4", "double": "<f8",
            "float64": "<f8", "uchar": "u1", "uint8": "u1", "char": "i1",
            "int8": "i1", "short": "<i2", "ushort": "<u2", "int": "<i4",
            "int32": "<i4", "uint": "<u4", "uint32": "<u4"}

    verts, faces = None, None
    if fmt == "ascii":
        text = raw[hdr_end:].decode("ascii", "replace").split("\n")
        li = 0
        for name, count, props in elems:
            rows = text[li:li + count]
            li += count
            if name == "vertex":
                arr = np.array([r.split()[:len(props)] for r in rows],
                               np.float32)
                verts = arr[:, :3]
            elif name == "face":
                fl = [list(map(int, r.split())) for r in rows]
                faces = np.array([r[1:4] for r in fl if r and r[0] >= 3],
                                 np.int64)
    else:
        off = hdr_end
        for name, count, props in elems:
            if name == "vertex":
                dt = np.dtype([(f"p{i}", np_t[t]) for i, (t, _) in
                               enumerate(props)])
                arr = np.frombuffer(raw, dt, count=count, offset=off)
                off += dt.itemsize * count
                verts = np.stack([arr["p0"], arr["p1"], arr["p2"]],
                                 1).astype(np.float32)
            elif name == "face" and props and props[0][0] == "list":
                _, ct, it = props[0]
                cdt, idt = np.dtype(np_t[ct]), np.dtype(np_t[it])
                out = []
                for _ in range(count):
                    n = int(np.frombuffer(raw, cdt, 1, off)[0])
                    off += cdt.itemsize
                    idxs = np.frombuffer(raw, idt, n, off)
                    off += idt.itemsize * n
                    if n >= 3:
                        out.append(idxs[:3])
                faces = np.asarray(out, np.int64)
            else:
                # a fixed-size element read past
                dt = np.dtype([(f"p{i}", np_t[t]) for i, (t, _) in
                               enumerate(props) if t != "list"])
                off += dt.itemsize * count
    return verts, (faces if faces is not None and len(faces) else None)
