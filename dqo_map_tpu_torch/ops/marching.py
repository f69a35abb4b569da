"""Triangle-mesh extraction from a TSDF volume by marching tetrahedra
(counterpart of `dqo_map_tpu/ops/marching.py`, of which it is a numpy copy:
the port imports nothing of the JAX package).

Each active cube splits into 6 tetrahedra along its 0-6 diagonal, and
every tetrahedron case gives 0, 1 or 2 triangles, so the case table is
derived here instead of transcribing the 256-entry marching-cubes table.

Convention: tsdf < 0 is inside (behind the surface), > 0 outside, as
`ops/tsdf.integrate` writes it (sdf = (observed depth - voxel depth) /
trunc).
"""

from __future__ import annotations

import numpy as np

# cube corners (x, y, z offsets), numbered so 0-6 is the main diagonal
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int64)

# 6-tetrahedron decomposition of the cube around the 0-6 diagonal
_TETS = np.array([
    [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
    [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
], np.int64)


def _tet_case_table():
    """(16, 2, 3, 2) int8: per inside-bitmask case, up to 2 triangles of 3
    edges, each edge = (corner_a, corner_b) within the tet; -1 padding."""
    table = np.full((16, 2, 3, 2), -1, np.int8)
    for case in range(1, 15):
        inside = [v for v in range(4) if case & (1 << v)]
        outside = [v for v in range(4) if v not in inside]
        if len(inside) == 1 or len(inside) == 3:
            v = inside[0] if len(inside) == 1 else outside[0]
            others = [o for o in range(4) if o != v]
            table[case, 0] = [[v, others[0]], [v, others[1]], [v, others[2]]]
        else:  # two in, two out -> quad
            a, b = inside
            c, d = outside
            e1, e2, e3, e4 = (a, c), (a, d), (b, d), (b, c)
            table[case, 0] = [e1, e2, e3]
            table[case, 1] = [e1, e3, e4]
    return table


_CASE_TABLE = _tet_case_table()


def marching_tetrahedra(tsdf: np.ndarray, weight: np.ndarray, origin,
                        voxel: float, color: np.ndarray = None,
                        weight_thresh: float = 1.0):
    """Extract a triangle mesh from the (X,Y,Z) TSDF.

    Returns (vertices (N,3) world coords, faces (M,3) int64,
    vertex_colors (N,3) or None). Vertices are deduplicated.
    """
    tsdf = np.asarray(tsdf)
    weight = np.asarray(weight)
    origin = np.asarray(origin, np.float64)
    X, Y, Z = tsdf.shape

    # active cubes: all 8 corners observed, not all same sign, near surface
    w_ok = weight >= weight_thresh
    near = np.abs(tsdf) < 1.0
    ok = w_ok & near
    c_ok = ok[:-1, :-1, :-1]
    neg = tsdf < 0
    c_neg = neg[:-1, :-1, :-1].astype(np.int8)
    for dx, dy, dz in _CORNERS[1:]:
        c_ok = c_ok & ok[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
        c_neg = c_neg + neg[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]
    active = c_ok & (c_neg > 0) & (c_neg < 8)
    base = np.argwhere(active)                              # (K, 3)
    if len(base) == 0:
        return (np.zeros((0, 3)), np.zeros((0, 3), np.int64),
                np.zeros((0, 3)) if color is not None else None)

    corner_idx = base[:, None, :] + _CORNERS[None, :, :]    # (K, 8, 3)
    ci = corner_idx.reshape(-1, 3)
    vals = tsdf[ci[:, 0], ci[:, 1], ci[:, 2]].reshape(-1, 8)      # (K, 8)
    cols = (color[ci[:, 0], ci[:, 1], ci[:, 2]].reshape(-1, 8, 3)
            if color is not None else None)
    pos = corner_idx.astype(np.float64) + 0.5                # voxel centers

    tris = []
    tri_cols = []
    for tet in _TETS:
        v = vals[:, tet]                                     # (K, 4)
        case = ((v[:, 0] < 0).astype(np.int64)
                | ((v[:, 1] < 0) << 1)
                | ((v[:, 2] < 0) << 2)
                | ((v[:, 3] < 0) << 3))
        edges = _CASE_TABLE[case]                            # (K, 2, 3, 2)
        p = pos[:, tet]                                      # (K, 4, 3)
        c = cols[:, tet] if cols is not None else None
        for t in range(2):
            e = edges[:, t]                                  # (K, 3, 2)
            m = e[:, 0, 0] >= 0
            if not m.any():
                continue
            e = e[m]
            pk = p[m]
            vk = v[m]
            ck = c[m] if c is not None else None
            ks = np.arange(len(e))
            pa = pk[ks[:, None], e[:, :, 0]]                 # (k, 3, 3)
            pb = pk[ks[:, None], e[:, :, 1]]
            va = vk[ks[:, None], e[:, :, 0]]
            vb = vk[ks[:, None], e[:, :, 1]]
            tt = va / np.where(np.abs(va - vb) < 1e-12, 1e-12, va - vb)
            tt = np.clip(tt, 0.0, 1.0)[..., None]
            tris.append(pa + tt * (pb - pa))                 # (k, 3, 3)
            if ck is not None:
                ca = ck[ks[:, None], e[:, :, 0]]
                cb = ck[ks[:, None], e[:, :, 1]]
                tri_cols.append(ca + tt * (cb - ca))

    tri_pts = np.concatenate(tris, axis=0)                   # (M, 3, 3)
    verts = tri_pts.reshape(-1, 3)
    vcols = (np.concatenate(tri_cols, 0).reshape(-1, 3)
             if tri_cols else None)

    # dedup vertices (quantized to 1e-4 voxel)
    key = np.round(verts / (1e-4)).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    uverts = verts[first] * voxel + origin
    ucols = vcols[first] if vcols is not None else None
    faces = inv.reshape(-1, 3)
    # drop degenerate faces (two corners collapsed to the same vertex)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return uverts, faces[good].astype(np.int64), ucols


def write_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray,
                   colors: np.ndarray = None):
    """Binary little-endian PLY with vertex colors + triangle faces."""
    import os
    os.makedirs(os.path.dirname(path), exist_ok=True)
    has_c = colors is not None
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(verts)}",
               "property float x", "property float y", "property float z"]
        if has_c:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {len(faces)}",
                "property list uchar int vertex_indices", "end_header", ""]
        f.write("\n".join(hdr).encode())
        if has_c:
            rec = np.zeros(len(verts),
                           dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = verts
            rec["rgb"] = np.clip(colors * 255, 0, 255).astype(np.uint8)
        else:
            rec = np.zeros(len(verts), dtype=[("xyz", "<f4", 3)])
            rec["xyz"] = verts
        f.write(rec.tobytes())
        frec = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        frec["n"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())


def sample_mesh_points(verts: np.ndarray, faces: np.ndarray, n: int,
                       seed: int = 0) -> np.ndarray:
    """Uniform surface sampling (area-weighted barycentric) — feeds the
    geometry eval exactly like the reference samples its open3d mesh
    (`SLAM/eval.py:228-282`)."""
    rng = np.random.default_rng(seed)
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    if area.sum() <= 0:
        return verts[:n]
    probs = area / area.sum()
    pick = rng.choice(len(faces), size=n, p=probs)
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1
    u[flip] = 1 - u[flip]
    v[flip] = 1 - v[flip]
    return (a[pick] + u[:, None] * (b[pick] - a[pick])
            + v[:, None] * (c[pick] - a[pick]))
