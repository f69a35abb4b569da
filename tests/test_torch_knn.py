"""Densification's exact KNN, `ops/knn.py::knn2`: K3 (`csrc/knn.cu`) on the
card, its plain version `knn2_ref` on the CPU, both held to a float64
brute force.

This file imports neither JAX nor the JAX package (the JAX comparison is
`tests/test_torch_mapping.py::test_knn_matches_exact_jax`); on the card,
run it without the JAX-pinning conftest:

    python -m pytest --noconftest tests/test_torch_knn.py -q

The tests marked `cuda` need a card and skip without one.

What both must give, per query and mask: the k nearest candidates with
the mask set, nearest first; where fewer than k qualify, BIG and an index
in range. Held as follows: each winner's distance, recomputed in float64,
equals the brute force's at its rank to within `tol`; the winners' indices
equal the brute force's wherever the float64 gap to the neighbouring ranks
exceeds `tol`. K3 takes the direct difference, so `tol` is 1e-6 of the
distance. The plain version takes the expansion |q|^2 + |c|^2 - 2 q.c in
float32, whose rounding is some ulps of |q|^2 + |c|^2 whatever the
distance: its `tol` adds 2e-6 of the largest |q|^2 + |c|^2.
"""

import numpy as np
import pytest
import torch

from dqo_map_tpu_torch.ops import cuda_build
from dqo_map_tpu_torch.ops import knn as knn_mod
from dqo_map_tpu_torch.ops.knn import BIG, LAUNCHES, knn2, knn2_cuda, knn2_ref

REL = 1e-6


def densify_like(M, N, seed):
    """Queries and candidates as `densify_step` lays them out: the M new
    points are the first M candidates, outside mask_a (the unstable map),
    then the map; ~90% of slots in mask_b. Points uniform in a 4 m room."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2.0, 2.0, (N, 3)).astype(np.float32)
    ma = np.zeros(N, bool)
    ma[M:] = rng.uniform(size=N - M) < 0.5
    mb = rng.uniform(size=N) < 0.9
    return c[:M].copy(), c, ma, mb


def case_inputs(case, seed=3):
    """The contract's cases: (queries, candidates, mask_a, mask_b, k); M
    and N are multiples of no block or tile."""
    M, N = 301, 1999
    if case == "N = M":  # the empty map of frame 0: the new points alone
        q, c, ma, mb = densify_like(M, M, seed)
        return q, c, ma, mb, 8
    q, c, ma, mb = densify_like(M, N, seed)
    if case.startswith("k="):
        return q, c, ma, mb, int(case[2:])
    if case == "fewer than k":
        ma[:] = False
        ma[[5, 700, 1998]] = True
        return q, c, ma, mb, 8
    if case == "both masks empty":
        return q, c, np.zeros(N, bool), np.zeros(N, bool), 4
    raise ValueError(case)


CASES = ["k=1", "k=4", "k=8", "fewer than k", "both masks empty", "N = M"]


def brute64(q, c, mask, k, rows=512):
    """The k nearest candidates with `mask` by float64 direct differences:
    (distances (M, k), inf where unfilled; indices (M, k))."""
    q, c = q.double(), c.double()
    out_d, out_i = [], []
    for r0 in range(0, q.shape[0], rows):
        d = ((q[r0:r0 + rows, None, :] - c[None]) ** 2).sum(-1)
        d = torch.where(mask[None], d, torch.inf)
        kk = min(k, d.shape[1])
        dd, ii = torch.topk(d, kk, dim=1, largest=False)
        if kk < k:
            pad = (0, k - kk)
            dd = torch.nn.functional.pad(dd, pad, value=torch.inf)
            ii = torch.nn.functional.pad(ii, pad)
        out_d.append(dd)
        out_i.append(ii)
    return torch.cat(out_d), torch.cat(out_i)


def check_exact(q, c, masks, k, got, atol=0.0):
    """Hold `got` = ((d_a, i_a), (d_b, i_b)) to the float64 brute force."""
    N = c.shape[0]
    q64, c64 = q.double(), c.double()
    for (d, i), mask in zip(got, masks):
        assert d.shape == i.shape == (q.shape[0], k)
        assert d.dtype == torch.float32 and i.dtype == torch.int64
        ref_d, ref_i = brute64(q, c, mask, k + 1)
        filled = torch.isfinite(ref_d[:, :k])
        assert ((i >= 0) & (i < N)).all()
        assert (d[~filled] == BIG).all()
        assert (d[filled] < BIG).all()
        assert mask[i][filled].all()
        dd = ((q64[:, None, :] - c64[i]) ** 2).sum(-1)
        tol = REL * ref_d[:, :k] + atol
        assert ((dd - ref_d[:, :k]).abs() <= tol)[filled].all()
        lo = torch.cat([torch.full_like(ref_d[:, :1], -torch.inf),
                        ref_d[:, :k - 1]], 1)
        clear = (filled & (ref_d[:, :k] - lo > tol)
                 & (ref_d[:, 1:] - ref_d[:, :k] > tol))
        assert (i == ref_i[:, :k])[clear].all()


def tensors(arrays, device):
    return [torch.as_tensor(a, device=device) for a in arrays]


def expansion_atol(q, c):
    return 2e-6 * float((q * q).sum(1).max() + (c * c).sum(1).max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K3 runs only on a CUDA card")
    return torch.device("cuda")


# --- the plain version, on the CPU -----------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_knn2_ref_is_exact(case):
    *arrays, k = case_inputs(case)
    q, c, ma, mb = tensors(arrays, "cpu")
    got = knn2_ref(q, c, ma, mb, k, col_chunk=512)
    check_exact(q, c, (ma, mb), k, got, atol=expansion_atol(q, c))


def test_knn2_on_the_cpu_is_the_plain_version():
    q, c, ma, mb, k = case_inputs("k=8")
    q, c, ma, mb = tensors((q, c, ma, mb), "cpu")
    launches = dict(LAUNCHES)
    got = knn2(q, c, ma, mb, k, col_chunk=512)
    ref = knn2_ref(q, c, ma, mb, k, col_chunk=512)
    assert LAUNCHES == launches
    for (gd, gi), (rd, ri) in zip(got, ref):
        assert torch.equal(gi, ri)
        assert torch.equal(gd.view(torch.int32), rd.view(torch.int32))


BAD = {
    "k=0": lambda a: {**a, "k": 0},
    "k=9": lambda a: {**a, "k": 9},
    "float64 queries": lambda a: {**a, "queries": a["queries"].double()},
    "float64 candidates": lambda a: {**a,
                                     "candidates": a["candidates"].double()},
    "strided queries": lambda a: {
        **a, "queries": torch.cat([a["queries"]] * 2, 1)[:, ::2]},
    "strided candidates": lambda a: {
        **a, "candidates": a["candidates"].t().contiguous().t()},
    "uint8 mask": lambda a: {**a, "mask_a": a["mask_a"].to(torch.uint8)},
    "short mask": lambda a: {**a, "mask_b": a["mask_b"][:-1]},
    "(M, 4) queries": lambda a: {
        **a, "queries": torch.zeros(a["queries"].shape[0], 4)},
    "no queries": lambda a: {**a, "queries": a["queries"][:0]},
}


@pytest.mark.parametrize("bad", sorted(BAD) + ["cpu tensors"])
def test_k3_wrapper_refuses(bad):
    q, c, ma, mb, k = case_inputs("k=4")
    args = dict(zip(("queries", "candidates", "mask_a", "mask_b"),
                    tensors((q, c, ma, mb), "cpu")), k=k)
    if bad in BAD:
        args = BAD[bad](args)
    match = {"k=0": "1 <= k <= 8", "k=9": "1 <= k <= 8",
             "strided queries": "contiguous",
             "strided candidates": "contiguous",
             "no queries": "at least one", "cpu tensors": "runs on the card"}
    with pytest.raises(ValueError, match=match.get(bad, "must be")):
        knn2_cuda(**args)


# --- the build, on the CPU ------------------------------------------------

def test_k3_builds_with_the_blend_kernels():
    """K3's source is one of the port's one parallel nvcc build, named by
    the hash of its source and the flags."""
    assert set(cuda_build.SOURCES) == {"blend_fwd", "blend_bwd", "knn",
                                       "project"}
    assert all(p.exists() for p in cuda_build.SOURCES.values())
    target = cuda_build._target("knn")
    assert target.parent == cuda_build.BUILD_DIR
    assert target.name.startswith("libknn_") and target.suffix == ".so"


def test_build_reuses_libraries_already_built(monkeypatch, tmp_path):
    """Where every library of the same sources and flags is there, nothing
    is compiled (no nvcc is even looked for); a changed source is built
    anew under another name."""
    sources = {}
    for name in cuda_build.SOURCES:
        sources[name] = tmp_path / f"{name}.cu"
        sources[name].write_text(f"// {name}\n")
    monkeypatch.setattr(cuda_build, "SOURCES", sources)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")

    def no_nvcc():
        raise AssertionError("nvcc looked for")

    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    cuda_build.BUILD_DIR.mkdir()
    built = {name: cuda_build._target(name) for name in sources}
    for path in built.values():
        path.touch()
    assert cuda_build.build_libraries() == built
    sources["knn"].write_text("// knn, changed\n")
    assert cuda_build._target("knn") != built["knn"]
    with pytest.raises(AssertionError, match="nvcc looked for"):
        cuda_build.build_libraries()


# --- K3, on the card -------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_k3_is_exact(cuda_device, case):
    q, c, ma, mb, k = case_inputs(case)
    q, c, ma, mb = tensors((q, c, ma, mb), cuda_device)
    d, i = knn2_cuda(q, c, ma, mb, k)
    got = [knn_mod._winners(q, c, d[s], i[s]) for s in range(2)]
    torch.cuda.synchronize()
    check_exact(q, c, (ma, mb), k, got)
    assert torch.equal(got[0][1], knn2(q, c, ma, mb, k)[0][1])


@pytest.mark.cuda
def test_k3_at_densify_shapes(cuda_device):
    """explore's shapes: 98,304 queries, ~155k candidates. Against the
    float64 brute force, and against the plain version on the same card
    tensors, whose index sets may differ only at the expansion's near-ties
    (under 1% of rows)."""
    q, c, ma, mb = tensors(densify_like(98304, 155_000, seed=11), cuda_device)
    got = knn2(q, c, ma, mb, 8)
    torch.cuda.synchronize()
    check_exact(q, c, (ma, mb), 8, got)
    ref = knn2_ref(q, c, ma, mb, 8)
    differ = torch.zeros(q.shape[0], dtype=torch.bool, device=cuda_device)
    for (_, gi), (_, ri) in zip(got, ref):
        differ |= (gi.sort(1)[0] != ri.sort(1)[0]).any(1)
    share = differ.float().mean().item()
    print(f"rows whose index sets differ from the plain version's: "
          f"{share:.6f}")
    assert share < 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 8])
def test_k3_ties_to_the_lower_index(cuda_device, k):
    """Duplicated points on an integer grid, so every distance is exact in
    float32: the winners are the brute force's (distance, index) order."""
    rng = np.random.default_rng(k)
    pts = rng.integers(-3, 4, (40, 3)).astype(np.float32)
    c = pts[rng.integers(0, 40, 600)]
    q = pts[rng.integers(0, 40, 77)]
    ma = rng.uniform(size=600) < 0.5
    mb = np.ones(600, bool)
    d, i = knn2_cuda(*tensors((q, c, ma, mb), cuda_device), k)
    for s, m in enumerate((ma, mb)):
        idx = np.nonzero(m)[0]
        for r in range(q.shape[0]):
            dist = ((c[idx] - q[r]) ** 2).sum(1)
            want = idx[np.lexsort((idx, dist))][:k]
            assert i[s, r, :len(want)].tolist() == want.tolist()


@pytest.mark.cuda
def test_k3_launch_count(cuda_device):
    """Two launches a call: the candidates' sort by class, the search."""
    q, c, ma, mb = tensors(densify_like(500, 4000, seed=2), cuda_device)
    launches = dict(LAUNCHES)
    knn2(q, c, ma, mb, 8)
    assert LAUNCHES == {"knn_pack": launches["knn_pack"] + 1,
                        "knn": launches["knn"] + 1}


@pytest.mark.cuda
def test_knn2_on_the_card_refuses_k_over_8(cuda_device):
    q, c, ma, mb = tensors(densify_like(50, 400, seed=1), cuda_device)
    launches = dict(LAUNCHES)
    with pytest.raises(ValueError, match="1 <= k <= 8"):
        knn2(q, c, ma, mb, 9)
    assert LAUNCHES == launches
