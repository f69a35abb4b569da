"""The roofline's counts against the port's kernel check
(`chip_smoke.py`), on a small recorded launch of the plain blend."""

import importlib.util
from pathlib import Path

import pytest
import torch

from slam_bench import roofline, tracing

ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_module",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launch():
    """A small K1 launch as the port's renderer makes it, on the CPU."""
    from dqo_map_tpu_torch.ops import blend_cuda
    from dqo_map_tpu_torch.ops.rasterize import RenderSettings, blend_inputs
    from dqo_map_tpu_torch.ops import binning
    g = torch.Generator().manual_seed(0)
    P, W, H = 300, 48, 32
    means = torch.rand((P, 3), generator=g) * torch.tensor([2.0, 1.5, 1.0]) \
        - torch.tensor([1.0, 0.75, -1.5])
    scales = torch.full((P, 3), 0.05)
    rots = torch.tensor([1.0, 0, 0, 0]).repeat(P, 1)
    opac = torch.full((P,), 0.8)
    cols = torch.rand((P, 3), generator=g)
    K = torch.tensor([[40.0, 0, 24.0], [0, 40.0, 16.0], [0, 0, 1]])
    proj = torch.eye(4)
    cam = {"w2c": torch.eye(4), "full_proj": proj, "cam_pos": torch.zeros(3),
           "K": K, "tan_fovx": 0.6, "tan_fovy": 0.4}
    s = RenderSettings(W, H)
    pre, b, feats = blend_inputs(means, scales, rots, opac, cols, cam, s)
    TH, TW = binning.tile_grid_size(W, H, 16)
    from dqo_map_tpu_torch.ops.rasterize import blend_params
    args = (feats.detach(), b.tile_offsets, b.tile_counts, TH * TW, 16, W, K,
            blend_params(s), (0.0, 0.0, 0.0))
    return args, blend_cuda


def test_k1_bound_matches_chip_smoke():
    cs = _chip_smoke()
    args, _ = _launch()
    from dqo_map_tpu_torch.ops.blend import blend_blocks_ref
    stats = {}
    blend_blocks_ref(*args, stats=stats)
    T, n_live = args[3], int(args[2].sum())
    assert n_live > 0 and stats["pairs"] > 0
    # chip_smoke.check_fwd's bytes, and kernel_row's bound
    n_bytes = n_live * (16 * 4 + 4) + T * 16 + 2 * T * 256 * 8 * 4
    assert roofline.k1_bytes(T, n_live, False) == n_bytes
    row = cs.kernel_row("blend_fwd", 1, 0.0, (1.0, 1.0, 1.0), n_bytes,
                        stats["pairs"], cs.OPS_FWD, {})
    got = roofline.launch_bound_ms("k1", args, {})
    assert abs(got - row["bound_ms"]) <= 1e-12 * max(1.0, row["bound_ms"])
    assert (roofline.PEAK_BYTES_PER_S, roofline.PEAK_F32_PER_S) == (
        cs.PEAK_BYTES_PER_S, cs.PEAK_F32_PER_S)
    assert (roofline.OPS_FWD, roofline.OPS_FWD_BG, roofline.OPS_BWD) == (
        cs.OPS_FWD, cs.OPS_FWD_BG, cs.OPS_BWD)


def test_k2_bound_matches_chip_smoke():
    cs = _chip_smoke()
    args, _ = _launch()
    from dqo_map_tpu_torch.ops.blend import blend_blocks_ref, blend_bwd_ref
    color, aux, _ = blend_blocks_ref(*args)
    dcolor = torch.rand(color.shape, generator=torch.Generator().manual_seed(1))
    bargs = args + (color, aux, dcolor)
    stats = {}
    blend_bwd_ref(*bargs, stats=stats)
    T, n_live = args[3], int(args[2].sum())
    T_live = int((args[2] > 0).sum())
    n_bytes = n_live * (16 + 14) * 4 + T * 16 + T_live * 256 * 12 * 4
    assert roofline.k2_bytes(T, n_live, T_live, False) == n_bytes
    row = cs.kernel_row("blend_bwd", 1, 0.0, (1.0, 1.0, 1.0), n_bytes,
                        stats["pairs"], cs.OPS_BWD, {})
    got = roofline.launch_bound_ms("k2", bargs, {})
    assert abs(got - row["bound_ms"]) <= 1e-12 * max(1.0, row["bound_ms"])


def test_share_matches_launches_by_order_or_by_mean():
    samples = [(0, 0.01), (8, 0.03)]
    dev = [1e-4 * (i + 1) for i in range(10)]
    assert abs(roofline.share_pct(samples, dev, 10)
               - 100 * 0.04 / ((1e-4 + 9e-4) * 1e3)) < 1e-9
    mean = sum(dev[:9]) / 9
    assert abs(roofline.share_pct(samples, dev[:9], 10)
               - 100 * 0.04 / (2 * mean * 1e3)) < 1e-9
    assert roofline.share_pct([], dev, 10) is None


def test_trace_reduction_counts_overlap_once():
    ev = [
        {"ph": "X", "name": "slam_bench/stretch", "cat": "user_annotation",
         "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "name": "tracking/icp", "cat": "user_annotation",
         "ts": 0.0, "dur": 400.0},
        {"ph": "X", "name": "scans/local", "cat": "user_annotation",
         "ts": 400.0, "dur": 600.0},
        {"ph": "X", "name": "void blend_fwd_kernel<false>(float const*)",
         "cat": "kernel", "ts": 100.0, "dur": 200.0},
        {"ph": "X", "name": "elementwise", "cat": "kernel", "ts": 200.0,
         "dur": 200.0},
        {"ph": "X", "name": "void blend_bwd_kernel<true>(float const*)",
         "cat": "kernel", "ts": 600.0, "dur": 100.0},
    ]
    r = tracing.read_trace({"traceEvents": ev}, frames=2)
    assert abs(r["busy_s"] - 400e-6) < 1e-12
    assert abs(r["window_s"] - 1e-3) < 1e-12
    assert r["launches"] == 3
    assert r["k1"] == pytest.approx([200e-6]) and r["k2"] == pytest.approx([100e-6])
    gaps = dict(r["idle_gaps"])
    assert abs(gaps["tracking/icp"] - 100e-6) < 1e-12
    assert abs(gaps["scans/local"] - 500e-6) < 1e-12
