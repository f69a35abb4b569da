"""The blend kernels' roofline: the least time the chip could take for a
launch's work, from its inputs, against the profiler's device time.

Copied from the port's kernel check (`chip_smoke.py::check_fwd`,
`check_bwd`, `kernel_row`): bytes are each live entry's feature rows in
and its outputs, each tile's offset and count, the output blocks and the
background operand; operations are the (pixel, entry) pairs the plain walk
blends times the float operations a pair costs. The pairs are counted by
the frozen plain walk (`reference/blend.py`) on the launch's recorded
inputs, so the same work is counted whatever implements the kernel.
"""

from __future__ import annotations

import torch

from .reference.blend import blend_blocks_ref, blend_bwd_ref

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA's data sheet)
PEAK_F32_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
OPS_FWD = 28                  # float operations per (pixel, entry) pair
OPS_FWD_BG = 36
OPS_BWD = 62


def k1_bytes(num_tiles: int, n_live: int, with_bg: bool) -> int:
    return (n_live * (16 * 4 + 4) + num_tiles * 16
            + 2 * num_tiles * 256 * 8 * 4
            + (num_tiles * 256 * 5 * 4 if with_bg else 0))


def k2_bytes(num_tiles: int, n_live: int, live_tiles: int,
             with_bg: bool) -> int:
    return (n_live * (16 + 14) * 4 + num_tiles * 16
            + live_tiles * 256 * 12 * 4
            + (live_tiles * 256 * 5 * 4 if with_bg else 0))


def bound_ms(n_bytes: int, pairs: int, ops: int) -> float:
    """The larger of the bytes over the peak bandwidth and the operations
    over the float32 peak, in ms."""
    return max(n_bytes / PEAK_BYTES_PER_S, pairs * ops / PEAK_F32_PER_S) * 1e3


def launch_bound_ms(kernel: str, args: tuple, kw: dict) -> float:
    """The bound of one recorded launch of K1 (`"k1"`: the arguments of
    `blend_cuda.blend_fwd`) or K2 (`"k2"`: of `blend_bwd`)."""
    bgt = kw.get("bgt")
    counts, T = args[2], int(args[3])
    n_live = int(counts.sum())
    stats = {}
    with torch.no_grad():
        if kernel == "k1":
            blend_blocks_ref(*args[:9], bgt=bgt, stats=stats)
            return bound_ms(k1_bytes(T, n_live, bgt is not None),
                            stats["pairs"],
                            OPS_FWD_BG if bgt is not None else OPS_FWD)
        blend_bwd_ref(*args[:12], bgt=bgt, stats=stats)
        return bound_ms(k2_bytes(T, n_live, int((counts > 0).sum()),
                                 bgt is not None), stats["pairs"], OPS_BWD)


def share_pct(samples: list, device_s: list, calls: int) -> float | None:
    """100 x the sampled launches' bounds over their device times. A
    sampled launch is matched to its kernel in the trace by its place in
    the order of launches where the trace kept every launch; where it lost
    some, each sampled launch takes the mean device time of those kept.
    None where nothing was sampled or the trace kept no launch."""
    if not samples or not device_s:
        return None
    total_bound = sum(b for _, b in samples)
    if len(device_s) == calls:
        total_dev = sum(device_s[i] for i, _ in samples) * 1e3
    else:
        total_dev = len(samples) * sum(device_s) / len(device_s) * 1e3
    return 100.0 * total_bound / total_dev
