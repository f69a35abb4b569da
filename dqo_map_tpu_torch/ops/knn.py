"""K-nearest-neighbour search (counterpart of `dqo_map_tpu/ops/knn.py`,
the exact path: `knn` and `knn2`).

On the card `knn2` launches K3 (`csrc/knn.cu`), which sorts the
candidates by the masks that admit them, then walks every admitted
candidate for every query with the distances and both top-k lists in
registers; it raises where K3 does not take its arguments. On the CPU it
runs the plain version, `knn2_ref`: |x-y|^2 = |x|^2 + |y|^2 - 2 x.y, one
`torch.matmul` per (row, column) chunk, an exact `torch.topk` per chunk and
a running top-k merge across the column chunks, so that memory stays
bounded at map widths. Both return the distances of their winners
recomputed exactly (`_winners`). `LAUNCHES` counts K3's launches where the
wrapper makes them: "knn_pack" the candidates' sort by class, "knn" the
search.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from . import cuda_build

BIG = 1e12
K_MAX = 8  # the largest k K3 takes: its lists live in registers

LAUNCHES = dict.fromkeys(("knn_pack", "knn"), 0)


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
    Returns ((d_a, i_a), (d_b, i_b)), each (M, k), nearest first, ties to
    the lower index, d the squared distance recomputed exactly for the
    winners (BIG where fewer than k candidates qualify, with an index in
    range). K3 on a card; on the CPU `knn2_ref`, in chunks of `row_chunk`
    queries by `col_chunk` candidates."""
    if not queries.is_cuda:
        return knn2_ref(queries, candidates, mask_a, mask_b, k, row_chunk,
                        col_chunk)
    d, i = knn2_cuda(queries, candidates, mask_a, mask_b, k)
    return (_winners(queries, candidates, d[0], i[0]),
            _winners(queries, candidates, d[1], i[1]))


def _winners(queries, candidates, d_, i_):
    """The squared distances of the winners `i_` (M, k), recomputed from
    the coordinates; BIG where the search's own distance `d_` is."""
    M, k = i_.shape
    sel = candidates[i_.reshape(-1)].reshape(M, k, 3)
    d2 = torch.sum((queries[:, None, :] - sel) ** 2, dim=-1)
    d2 = torch.where(d_ >= BIG * 0.5, BIG, d2)
    return torch.clamp(d2, min=0.0), i_


def knn2_ref(queries: torch.Tensor, candidates: torch.Tensor,
             mask_a: torch.Tensor, mask_b: torch.Tensor, k: int = 4,
             row_chunk: int = 4096, col_chunk: int = 65536):
    """`knn2`'s plain version: chunked distance matrices and `torch.topk`."""
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
    return tuple(_winners(queries, candidates,
                          torch.cat([o[0] for o in outs[s]]),
                          torch.cat([o[1] for o in outs[s]]))
                 for s in range(2))


_LIB: list = []


def _lib():
    if not _LIB:
        lib = ctypes.CDLL(str(cuda_build.build_libraries()["knn"]))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.dqo_knn2.argtypes = [P, I, P, P, P, I, I, P, P, P, P, P]
        lib.dqo_knn2.restype = I
        lib.dqo_cuda_error_string.argtypes = [I]
        lib.dqo_cuda_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _check_args(queries, candidates, mask_a, mask_b, k: int):
    """What K3 takes: float32 (M, 3) queries and (N, 3) candidates, bool
    (N,) masks, all contiguous on one device, M and N at least 1, and
    1 <= k <= K_MAX."""
    if not 1 <= k <= K_MAX:
        raise ValueError(f"K3 takes 1 <= k <= {K_MAX} (its lists live in "
                         f"registers), got k={k}")
    for what, x, dtype, shape in (
            ("queries", queries, torch.float32, (queries.shape[0], 3)),
            ("candidates", candidates, torch.float32,
             (candidates.shape[0], 3)),
            ("mask_a", mask_a, torch.bool, (candidates.shape[0],)),
            ("mask_b", mask_b, torch.bool, (candidates.shape[0],))):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{what} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        if x.device != queries.device:
            raise ValueError(f"{what} must be on the queries' device "
                             f"{queries.device}, got {x.device}")
    if queries.shape[0] == 0 or candidates.shape[0] == 0:
        raise ValueError("K3 needs at least one query and one candidate")
    if not queries.is_cuda:
        raise ValueError("K3 runs on the card; the plain version knn2_ref "
                         "takes CPU tensors")


def knn2_cuda(queries: torch.Tensor, candidates: torch.Tensor,
              mask_a: torch.Tensor, mask_b: torch.Tensor, k: int):
    """Launch K3: the candidates sorted by class, then both searches of
    `knn2` over them. Returns the searches' own distances (2, M, k)
    float32, +inf where unfilled, and indices (2, M, k) int64, list a
    first; nothing waits for the card."""
    _check_args(queries, candidates, mask_a, mask_b, k)
    M, N = queries.shape[0], candidates.shape[0]
    dev = queries.device
    lib = _lib()
    # the kernels launch on the current device: make it the tensors' one
    with torch.cuda.device(dev):
        packed = torch.empty((3, N, 4), dtype=torch.float32, device=dev)
        counts = torch.empty(3, dtype=torch.int32, device=dev)
        d = torch.empty((2, M, k), dtype=torch.float32, device=dev)
        i = torch.empty((2, M, k), dtype=torch.int64, device=dev)
        rc = lib.dqo_knn2(
            queries.data_ptr(), M, candidates.data_ptr(), mask_a.data_ptr(),
            mask_b.data_ptr(), N, k, packed.data_ptr(), counts.data_ptr(),
            d.data_ptr(), i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("knn2 (K3) launch failed: "
                           + lib.dqo_cuda_error_string(rc).decode())
    LAUNCHES["knn_pack"] += 1
    LAUNCHES["knn"] += 1
    return d, i


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
    with trace.span("scales_from_knn/wait"):
        factor = torch.tensor([float(f) for f in xyz_factor],
                              device=d2.device)
    log_scales = torch.log(scale_factor * scales[:, None] * factor[None, :])
    keep = new_valid & (~invalid) & (cnt > 0)
    return log_scales, keep
