"""K-nearest-neighbour search as chunked distance matrix products
(counterpart of `dqo_map_tpu/ops/knn.py`, the exact path: `knn` and
`knn2`).

|x-y|^2 = |x|^2 + |y|^2 - 2 x.y, one `torch.matmul` per (row, column)
chunk, an exact `torch.topk` per chunk and a running top-k merge across the
column chunks, so that memory stays bounded at map widths.
"""

from __future__ import annotations

import torch

BIG = 1e12


def _topk_merge(d, best_d, best_i, col0: int, k: int):
    nd, ni = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
    cat_d = torch.cat([best_d, nd], dim=1)
    cat_i = torch.cat([best_i, ni + col0], dim=1)
    md, mi = torch.topk(cat_d, k, dim=1, largest=False)
    return md, torch.gather(cat_i, 1, mi)


def knn(queries: torch.Tensor, candidates: torch.Tensor,
        cand_valid: torch.Tensor, k: int = 3, row_chunk: int = 4096,
        col_chunk: int = 65536):
    """The exact k nearest valid candidates of each query: (squared
    distances (M, k), indices (M, k) into `candidates`), as `knn2`'s first
    search."""
    return knn2(queries, candidates, cand_valid, cand_valid, k, row_chunk,
                col_chunk)[0]


def knn2(queries: torch.Tensor, candidates: torch.Tensor,
         mask_a: torch.Tensor, mask_b: torch.Tensor, k: int = 4,
         row_chunk: int = 4096, col_chunk: int = 65536):
    """Two class-restricted exact k-NN searches that share one distance
    pass: (a) among candidates with `mask_a`, (b) among those with `mask_b`.
    Returns ((d_a, i_a), (d_b, i_b)), each (M, k), d the squared distance
    recomputed exactly for the winners (BIG where fewer than k candidates
    qualify)."""
    M = queries.shape[0]
    N = candidates.shape[0]
    dev = queries.device
    q2 = torch.sum(queries * queries, dim=1)
    c2 = torch.sum(candidates * candidates, dim=1)
    outs = [[], []]
    for r0 in range(0, M, row_chunk):
        q = queries[r0:r0 + row_chunk]
        best = [(torch.full((q.shape[0], k), BIG, device=dev),
                 torch.zeros((q.shape[0], k), dtype=torch.int64, device=dev))
                for _ in range(2)]
        for c0 in range(0, N, col_chunk):
            c = candidates[c0:c0 + col_chunk]
            d = (q2[r0:r0 + row_chunk, None] + c2[None, c0:c0 + col_chunk]
                 - 2.0 * (q @ c.T))
            for s, mask in enumerate((mask_a, mask_b)):
                dm = torch.where(mask[None, c0:c0 + col_chunk], d, BIG)
                best[s] = _topk_merge(dm, *best[s], c0, k)
        for s in range(2):
            outs[s].append(best[s])
    result = []
    for s in range(2):
        d_ = torch.cat([o[0] for o in outs[s]])
        i_ = torch.cat([o[1] for o in outs[s]])
        sel = candidates[i_.reshape(-1)].reshape(M, k, 3)
        d2 = torch.sum((queries[:, None, :] - sel) ** 2, dim=-1)
        d2 = torch.where(d_ >= BIG * 0.5, BIG, d2)
        result.append((torch.clamp(d2, min=0.0), i_))
    return result[0], result[1]


def update_geometry_scales(new_xyz: torch.Tensor, new_valid: torch.Tensor,
                           cand_xyz: torch.Tensor, cand_radius: torch.Tensor,
                           cand_valid: torch.Tensor, scale_factor: float,
                           xyz_factor: tuple, min_radius: float,
                           max_radius: float):
    """Scale init for freshly added gaussians with its own search: the
    candidates hold the new points first (slot m is query m), then the
    map; `scales_from_knn` over the 4 nearest valid candidates. Returns
    (log-scales (M, 3), keep mask (M,))."""
    d2, idx = knn(new_xyz, cand_xyz, cand_valid, k=4)
    return scales_from_knn(d2, idx, new_valid, cand_radius, None,
                           scale_factor, xyz_factor, min_radius, max_radius)


def scales_from_knn(d2: torch.Tensor, idx: torch.Tensor,
                    new_valid: torch.Tensor, cand_radius: torch.Tensor,
                    cand_excluded, scale_factor: float, xyz_factor: tuple,
                    min_radius: float, max_radius: float):
    """Scale init for freshly added gaussians from a precomputed search:
    the mean squared distance to the 3 nearest other candidates, less three
    of their radii. The self-match is excluded by index; `cand_excluded`
    (N,) drops candidates decided invalid after the search. Returns
    (log_scales (M,3), keep (M,))."""
    M_q = d2.shape[0]
    self_m = idx == torch.arange(M_q, device=idx.device)[:, None]
    if cand_excluded is not None:
        self_m = self_m | cand_excluded[idx]
    d2 = torch.where(self_m, BIG, d2)
    order = torch.argsort(d2, dim=1, stable=True)[:, :3]
    d2 = torch.gather(d2, 1, order)
    idx = torch.gather(idx, 1, order)
    # fewer than 3 usable neighbours: the BIG sentinel must stay out of the
    # mean (it would clamp the scale to max_radius)
    missing = d2 >= BIG * 0.5
    dist = torch.sqrt(torch.where(missing, 0.0, d2)) - 3.0 * cand_radius[idx]
    invalid = torch.any((dist < 0) & (~missing), dim=1)
    cnt = torch.sum(~missing, dim=1)
    dist2 = (torch.sum(torch.where(missing, 0.0, dist * dist), dim=1)
             / torch.clamp(cnt, min=1))
    scales = torch.clamp(torch.sqrt(dist2), min_radius, max_radius)
    factor = torch.tensor([float(f) for f in xyz_factor], device=d2.device)
    log_scales = torch.log(scale_factor * scales[:, None] * factor[None, :])
    keep = new_valid & (~invalid) & (cnt > 0)
    return log_scales, keep
