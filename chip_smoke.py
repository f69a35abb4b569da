#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py [--frames 12] [--width 1200] [--height 680]
                          [--profile N]

1. Builds the two blend kernels, K1 forward (`dqo_map_tpu_torch/csrc/
   blend_fwd.cu`) and K2 backward (`csrc/blend_bwd.cu`), with nvcc for
   sm_90a, one nvcc per source, both started together.
2. Runs the port's main path, `SLAMSystem.step`, over synthetic RGB-D
   frames at the benchmark's Replica office0 scale: 1200x680, 40,800
   samples a frame, map capacity 2^19, ICP tracking on every frame, and
   bench.py's 50 masked Adam steps on every 6th frame: the local scan
   (unstable Gaussians in front of the stable background) or, on a
   keyframe, the keyframe scan. Where the frames give no keyframe, a
   second path runs the keyframe scan on the final map, as the next
   keyframe would; its launches are reported apart from the main path's.
   Each path zeroes the kernels' launch counters just before and reads
   them just after: K1 (both variants) must have launched
   once per model render, scan iteration, stable-background render and
   keyframe range render, K2 (both variants) once per scan iteration, and
   each scan's objective must have fallen over its second half.
3. Holds each kernel against its plain version at the main path's shapes
   and times both: K1 on the final map at the last camera, K1's
   background variant and K2's background variant on the last local
   scan's last iteration, K2's plain variant on the last keyframe scan's
   last iteration. K1: index maps and n_touched exactly, float maps to
   1e-5 (depth 1e-4). K2: each gradient row to 1e-4 of its largest
   magnitude (the CTA sums over the tile's pixels in another order), and
   the zero structure equal but at a few places of float32 cancellation
   (see `check_bwd`). A kernel's `ms` is its own device time per launch
   (the profiler's, `device_ms`), `wrapper_ms` the CUDA-event time of a
   whole wrapper call; for each kernel also the time with its tiles
   launched in tile order instead of the binning's `tile_order` (most
   entries first), and the most crowded tile's alone. Each row carries the
   live entries per non-empty tile of its call (`tile_entries`). Every
   recorded call must have come with the binning's `tile_order`.
4. Checks the output: finite maps, every frame tracked, the render close
   to the frame.

With `--profile N` the last N frames of step 2 run under `torch.profiler`:
it prints the device time by kernel and the device's busy share of that
window, and writes the trace to `chiprun_out/slice_trace.json`.

Prints the card, per-frame times (optimize frames apart), map and entry
counts, PSNR, depth-L1 and ATE at the last frame, then one JSON line of
kernel numbers and, last, the JSON result line. Exits non-zero, before
printing a result, without a CUDA card or when any check fails.
"""

import argparse
import json
import math
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (data sheet)
PEAK_F32_PER_S = 67e12        # H100 SXM FP32, outside the tensor cores
# float operations per (pixel, entry) pair each kernel walks
OPS_FWD = 28
OPS_FWD_BG = 36
OPS_BWD = 62
WARMUP_FRAMES = 3
ADAM_STEPS = 50               # bench.py:111's gaussian_update_iter
# K2 against its plain version: the places where exactly one of the two
# is 0 (a sum of +-c cancelling exactly in one order and to a rounding
# residue in the other) may number at most MAX_FLIPS, each off by at most
# FLIP_TOL of its row's largest magnitude, a few float32 ulps
MAX_FLIPS = 32
FLIP_TOL = 1e-6
KERNELS = ("blend_fwd", "blend_fwd_bg", "blend_bwd", "blend_bwd_bg")
REPLACES = {
    "blend_fwd": "dqo_map_tpu/ops/blend_pallas.py:179",
    "blend_fwd_bg": "dqo_map_tpu/ops/blend_pallas.py:220",
    "blend_bwd": "dqo_map_tpu/ops/blend_pallas.py:366",
    "blend_bwd_bg": "dqo_map_tpu/ops/blend_pallas.py:366",
}


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def slice_config():
    from dqo_map_tpu_torch.config import default_config
    # bench.py's workload, with the feature backend and object layer (not
    # ported) off
    return default_config(
        type="Synthetic", use_object=False, use_gt_pose=False,
        icp_use_model_depth=False, use_orb_backend=False,
        capacity=1 << 19, add_capacity=16384,
        uniform_sample_num=40800, gaussian_update_frame=6,
        gaussian_update_iter=ADAM_STEPS, stable_confidence_thres=20,
        global_keyframe_num=3, min_depth=0.1, max_depth=8.0,
        memory_length=5)


class Recorder:
    """Keeps the arguments of each kernel variant's last launch, to hold
    the kernels against their plain versions at the main path's shapes."""

    def __init__(self):
        from dqo_map_tpu_torch.ops import blend_cuda
        self.mod = blend_cuda
        self.fwd, self.bwd = blend_cuda.blend_fwd, blend_cuda.blend_bwd
        self.last = {}

    def __enter__(self):
        def fwd(*a, **kw):
            bg = kw.get("bgt") is not None
            self.last["blend_fwd_bg" if bg else "blend_fwd"] = (a, kw)
            return self.fwd(*a, **kw)

        def bwd(*a, **kw):
            bg = kw.get("bgt") is not None
            self.last["blend_bwd_bg" if bg else "blend_bwd"] = (a, kw)
            return self.bwd(*a, **kw)

        self.mod.blend_fwd, self.mod.blend_bwd = fwd, bwd
        return self

    def __exit__(self, *exc):
        self.mod.blend_fwd, self.mod.blend_bwd = self.fwd, self.bwd


def launches_now() -> dict:
    from dqo_map_tpu_torch.ops.blend_cuda import LAUNCHES
    return dict(LAUNCHES)


def reset_launches():
    from dqo_map_tpu_torch.ops.blend_cuda import reset_launches as reset
    reset()


def check_launches(what: str, got: dict, scans0: dict, scans1: dict,
                   renders: int):
    """K1 once per model render, scan iteration, background render and
    range render; K2 once per scan iteration."""
    d = {k: scans1[k] - scans0[k] for k in scans1}
    want_fwd = renders + d["iters"] + d["bg_renders"] + d["range_renders"]
    fwd = got["blend_fwd"] + got["blend_fwd_bg"]
    bwd = got["blend_bwd"] + got["blend_bwd_bg"]
    print(f"{what}: launches {got}; model renders {renders}, scans "
          f"local {d['local']} keyframe {d['global']}, iterations "
          f"{d['iters']}, background renders {d['bg_renders']}, range "
          f"renders {d['range_renders']}")
    if fwd != want_fwd or bwd != d["iters"]:
        raise RuntimeError(f"{what}: K1 launched {fwd} times for {want_fwd} "
                           f"blends, K2 {bwd} times for {d['iters']} "
                           "iterations")


def check_scans_fall(mapping, start: int):
    """Each scan's objective at its last iteration below that at iteration
    iters//2 + 1, where the schedule pins the newest frame."""
    for kind, curve in mapping.scan_log[start:]:
        c = curve.tolist()
        mid = len(c) // 2 + 1
        if mid < len(c) - 1 and not c[-1] < c[mid]:
            raise RuntimeError(f"{kind} scan did not optimise: objective "
                               f"{c[mid]} at iteration {mid}, {c[-1]} at "
                               f"the last")
        print(f"  {kind} scan: objective {c[0]:.5f} -> {c[mid]:.5f} "
              f"(iteration {mid}) -> {c[-1]:.5f}")


def run_main_path(args, device, rec):
    """The slice over `args.frames` frames. Returns (system, cameras,
    per-frame infos, launches, seconds)."""
    import torch
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.slam.system import SLAMSystem

    t0 = time.perf_counter()
    _, cams = synthetic_sequence(args.frames, width=args.width,
                                 height=args.height)
    print(f"frames: {args.frames} at {args.width}x{args.height}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    system = SLAMSystem(slice_config(), cameras=cams, device=device)
    m = system.mapping
    infos = []
    prof = None
    scans0 = dict(m.scan_counts)
    reset_launches()
    t0 = time.perf_counter()
    with rec:
        for i, cam in enumerate(cams):
            if i == args.frames - args.profile:
                prof = start_profile()
            info = system.step(cam, i)
            info["optimized"] = m.did_optimize
            m.time += 1
            infos.append(info)
            u, st = m.counts()
            print(f"frame {i:3d}: tracking {1e3 * info['tracker_s']:8.1f} ms  "
                  f"mapping {1e3 * info['mapper_s']:8.1f} ms  alive {u + st}"
                  f"  stable {st}  entries {info['render']['num_entries']}"
                  + ("  (optimize)" if m.did_optimize else ""))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = launches_now()
    check_launches("main path", launches, scans0, m.scan_counts, m.renders)
    check_scans_fall(m, 0)
    if prof is not None:
        report_profile(prof, infos[-args.profile:])
    return system, cams, infos, launches, seconds


def keyframe_phase(system, device, rec) -> dict:
    """The keyframe scan on the final map over the newest keyframes, the
    pass the next keyframe takes, when the frames gave none. Returns its
    own launches."""
    import torch
    m = system.mapping
    scans0, n_log = dict(m.scan_counts), len(m.scan_log)
    reset_launches()
    t0 = time.perf_counter()
    with rec:
        m.global_optimization(system.cfg.map.global_keyframe_num)
    torch.cuda.synchronize(device)
    launches = launches_now()
    print(f"keyframe phase: {1e3 * (time.perf_counter() - t0):.1f} ms")
    check_launches("keyframe phase", launches, scans0, m.scan_counts, 0)
    check_scans_fall(m, n_log)
    return launches


def start_profile():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def report_profile(prof, infos):
    """Device time by kernel over the profiled frames (the 15 largest and
    the blend kernels), and the device's busy share of their wall time."""
    import os
    prof.__exit__(None, None, None)
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    wall_us = 1e6 * sum(i["tracker_s"] + i["mapper_s"] for i in infos)
    print(f"profile of {len(infos)} frames: device busy {busy_us / 1e3:.1f} ms "
          f"of {wall_us / 1e3:.1f} ms wall ({100 * busy_us / wall_us:.1f}%)")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the 15 largest, and the blend kernels wherever they rank
    for e in ranked[:15] + [e for e in ranked[15:] if "blend_" in e.key]:
        print(f"  {e.self_device_time_total / 1e3 / len(infos):9.3f} ms/frame "
              f"{e.count / len(infos):7.1f} calls/frame  {e.key[:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace("chiprun_out/slice_trace.json")


def quality(system, cams, infos, min_depth=0.1, max_depth=8.0) -> dict:
    """PSNR and depth-L1 of the last end-of-frame render against its frame
    (the reference's `eval_picture` definitions) and the trajectory ATE."""
    import torch
    from dqo_map_tpu_torch.utils.losses import psnr
    out = infos[-1]["render"]
    for k in ("render", "depth", "T_map", "normal"):
        if not bool(torch.isfinite(out[k]).all()):
            raise RuntimeError(f"non-finite values in the render's {k}")
    dev = out["render"].device
    gt = torch.as_tensor(cams[-1].image, device=dev)
    gtd = torch.as_tensor(cams[-1].depth, device=dev)
    gtd = torch.where((gtd > min_depth) & (gtd < max_depth), gtd, 0.0)
    invalid = (out["depth_index_map"] == -1) | (gtd == 0)
    derr = torch.where(invalid, 0.0, torch.abs(gtd - out["depth"]))
    depth_l1_cm = float(derr.sum() / torch.clamp((~invalid).sum(), min=1)) * 100
    return {"psnr": float(psnr(out["render"], gt)), "depth_l1_cm": depth_l1_cm,
            "ate_cm": system.tracker.eval_ate_series(),
            "icp_fail_count": system.tracker.icp_fail_count}


def time_cuda(fn, reps: int) -> float:
    """Mean ms per call of `fn` over `reps` calls, by CUDA events, after
    one untimed call: the wrapper's whole window, its other launches and
    the host's pace included."""
    import torch
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, symbol: str, reps: int) -> float:
    """Mean device time in ms of one launch of the kernel whose name holds
    `symbol`, over `reps` calls of `fn` after one untimed call: the
    profiler's own device time of that kernel, so neither the wrapper's
    other launches nor the host's pace count. The profiler can lose some
    kernel records in a long process; the mean is over those it kept, and
    a window that kept fewer than half is measured again."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type.name == "CUDA" and symbol in e.key]
        n = sum(e.count for e in hits)
        if 2 * n >= reps:
            return sum(e.self_device_time_total for e in hits) / n / 1e3
    raise RuntimeError(f"the profiler saw {n} launches of {symbol} in "
                       f"{reps} calls")


def tile_entries(tile_counts, align: int, max_chunks: int) -> dict:
    """Live entries per non-empty tile (mean, p99, max), the align-sized
    blocks they fill, and the tiles at the per-tile cap."""
    import torch
    c = tile_counts[tile_counts > 0].double()
    return {"tiles": int(c.numel()), "mean": float(c.mean()),
            "p99": float(torch.quantile(c, 0.99)), "max": int(c.max()),
            "align": align,
            "blocks": int(((tile_counts + align - 1) // align).sum()),
            "at_cap": int((tile_counts == align * max_chunks).sum())}


def kernel_row(name, launches, max_err, times, n_bytes, pairs, ops, tiles):
    ms, wrapper_ms, plain_ms = times
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = pairs * ops / PEAK_F32_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"{name}: {ms:.4f} ms device time per launch ({wrapper_ms:.4f} ms "
          f"through the wrapper), plain version {plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB -> "
          f"{bytes_ms:.4f} ms; {pairs} pixel-entry pairs x {ops} ops -> "
          f"{ops_ms:.4f} ms); launches {launches}, max |diff| {max_err:.3g}")
    print(f"{name}: live entries per non-empty tile {tiles}")
    return {
        "name": name, "route": "cuda",
        "source": "dqo_map_tpu_torch/csrc/"
                  + ("blend_fwd.cu" if "fwd" in name else "blend_bwd.cu"),
        "replaces": REPLACES[name], "launches": launches,
        "max_abs_err": max_err, "ms": ms, "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None, "tile_entries": tiles,
    }


def order_times(name, fn, args, kw) -> dict:
    """The launch order's worth, and the floor the most crowded tile sets:
    the device time of `fn` (a kernel's wrapper, whose kernel's name holds
    `fn.__name__`) with the tiles in tile order, and with the first tile of
    the order alone (the others' counts 0, so their CTAs walk nothing)."""
    import torch
    if kw.get("tile_order") is None:
        raise RuntimeError(f"{name}: the main path launched it without the "
                           "binning's tile_order")
    counts, first = args[2], kw["tile_order"][0]
    tiles = torch.arange(len(counts), device=counts.device)
    crowded = args[:2] + (torch.where(tiles == first, counts, 0),) + args[3:]
    sym = fn.__name__
    out = {"layout_order_ms": device_ms(
               lambda: fn(*args, **dict(kw, tile_order=None)), sym, 20),
           "crowded_tile_ms": device_ms(lambda: fn(*crowded, **kw), sym, 20)}
    print(f"{name}: {out['layout_order_ms']:.4f} ms with the tiles in tile "
          f"order; the most crowded tile alone {out['crowded_tile_ms']:.4f} "
          "ms")
    return out


def check_fwd(name, args, kw, launches, layout) -> dict:
    """K1 (plain or background variant) against its plain version on
    recorded inputs: the index channels and n_touched exactly, the depth
    channels to 1e-4, the other floats to 1e-5."""
    import torch
    from dqo_map_tpu_torch.ops.blend import blend_blocks_ref
    from dqo_map_tpu_torch.ops.blend_cuda import blend_fwd
    bgt = kw.get("bgt")
    order_ms = order_times(name, blend_fwd, args, kw)
    color, aux, nt = blend_fwd(*args, **kw)
    stats = {}
    rcolor, raux, rnt = blend_blocks_ref(*args, bgt=bgt, stats=stats)
    torch.cuda.synchronize()
    for what, a, r in (("index maps", aux[..., 0:2], raux[..., 0:2]),
                       ("n_touched", nt, rnt)):
        n_bad = int((a != r).sum())
        if n_bad:
            raise RuntimeError(f"{name}: {what} differ at {n_bad} places")
    max_err = 0.0
    for what, a, r, tol in (
            ("colour and normal", color[..., [0, 1, 2, 4, 5, 6]],
             rcolor[..., [0, 1, 2, 4, 5, 6]], 1e-5),
            ("weights and T", aux[..., 2:7], raux[..., 2:7], 1e-5),
            ("depth", torch.stack([color[..., 3], aux[..., 7]]),
             torch.stack([rcolor[..., 3], raux[..., 7]]), 1e-4)):
        err = float((a - r).abs().max())
        if not err <= tol:
            raise RuntimeError(f"{name}: {what} off by {err} > {tol}")
        max_err = max(max_err, err)
    times = (device_ms(lambda: blend_fwd(*args, **kw), "blend_fwd", 20),
             time_cuda(lambda: blend_fwd(*args, **kw), reps=20),
             time_cuda(lambda: blend_blocks_ref(*args, bgt=bgt), reps=2))
    T, n_live = args[3], int(args[2].sum())
    # live entries' 16 feature rows in and n_touched out (the padding is
    # never read), each tile's offset and count, the two (T, 256, 8) output
    # blocks, and the background operand's five channels
    n_bytes = (n_live * (16 * 4 + 4) + T * 16 + 2 * T * 256 * 8 * 4
               + (T * 256 * 5 * 4 if bgt is not None else 0))
    print(f"{name} vs plain version on {T} tiles, {n_live} live entries: "
          "index maps and n_touched equal")
    return dict(kernel_row(name, launches, max_err, times, n_bytes,
                           stats["pairs"],
                           OPS_FWD_BG if bgt is not None else OPS_FWD,
                           tile_entries(args[2], *layout)), **order_ms)


def check_bwd(name, args, kw, launches, layout) -> dict:
    """K2 (plain or background variant) against its plain version on
    recorded inputs: each gradient row to 1e-4 of its largest magnitude."""
    import torch
    from dqo_map_tpu_torch.ops.blend import GRAD_ROWS, blend_bwd_ref
    from dqo_map_tpu_torch.ops.blend_cuda import blend_bwd
    bgt = kw.get("bgt")
    order_ms = order_times(name, blend_bwd, args, kw)
    got = blend_bwd(*args, **kw)
    stats = {}
    ref = blend_bwd_ref(*args, bgt=bgt, stats=stats)
    torch.cuda.synchronize()
    # an entry's depth cotangents are +-c of one magnitude c, and their sum
    # can cancel to exactly 0 in one order and to a rounding residue in the
    # other: such places are bounded in number and in size
    flip = (got != 0) != (ref != 0)
    n_flip = int(flip.sum())
    if n_flip > MAX_FLIPS:
        raise RuntimeError(f"{name}: zero structure differs at {n_flip} "
                           f"places (at most {MAX_FLIPS} allowed)")
    max_err, max_flip_rel = 0.0, 0.0
    for r in GRAD_ROWS:
        diff = (got[r] - ref[r]).abs()
        err = float(diff.max())
        scale = float(ref[r].abs().max())
        if not err <= 1e-4 * scale:
            raise RuntimeError(f"{name}: gradient row {r} off by {err} "
                               f"(row max {scale})")
        if bool(flip[r].any()):
            flip_err = float(diff[flip[r]].max())
            if not flip_err <= FLIP_TOL * scale:
                raise RuntimeError(
                    f"{name}: gradient row {r} is 0 on one side only, off "
                    f"by {flip_err} > {FLIP_TOL} x row max {scale}")
            max_flip_rel = max(max_flip_rel, flip_err / scale)
        max_err = max(max_err, err)
    times = (device_ms(lambda: blend_bwd(*args, **kw), "blend_bwd", 20),
             time_cuda(lambda: blend_bwd(*args, **kw), reps=20),
             time_cuda(lambda: blend_bwd_ref(*args, bgt=bgt), reps=2))
    T, n_live = args[3], int(args[2].sum())
    # per live entry: 16 feature rows in, 14 gradient rows out; per pixel
    # the cotangent's 7 channels, 3 of the colour block, 2 of the aux block
    # (and 5 of the background operand); each tile's offset and count
    n_bytes = (n_live * (16 + 14) * 4 + T * 16 + T * 256 * 12 * 4
               + (T * 256 * 5 * 4 if bgt is not None else 0))
    print(f"{name} vs plain version on {T} tiles, {n_live} live entries: "
          f"rows to 1e-4 of their max; zero structure equal but at {n_flip} "
          f"places, largest there {max_flip_rel:.3g} of its row's max")
    return dict(kernel_row(name, launches, max_err, times, n_bytes,
                           stats["pairs"], OPS_BWD,
                           tile_entries(args[2], *layout)), **order_ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=680)
    ap.add_argument("--profile", type=int, default=0,
                    help="profile the last N frames of the main path")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; the port's main path runs on one",
              file=sys.stderr)
        return 1
    print(card_line())
    device = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from dqo_map_tpu_torch.ops.blend_cuda import build_libraries
    t0 = time.perf_counter()
    libs = build_libraries(verbose=True)
    print(f"built {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s")

    rec = Recorder()
    system, cams, infos, launches, seconds = run_main_path(args, device, rec)
    m = system.mapping
    extra = (keyframe_phase(system, device, rec)
             if m.scan_counts["global"] == 0 else None)
    print(f"scans run: local {m.scan_counts['local']}, keyframe "
          f"{m.scan_counts['global']}; Adam steps {m.scan_counts['iters']}")
    if m.scan_counts["local"] == 0 or m.scan_counts["global"] == 0:
        raise RuntimeError(f"a scan kind never ran: {m.scan_counts}")
    for k in KERNELS:
        if launches[k] == 0 and not (extra and extra[k]):
            raise RuntimeError(f"{k} was never launched on the main path "
                               "or the keyframe path")

    for label, sel in (("optimize frames", True), ("other frames", False)):
        part = [i for i in infos[WARMUP_FRAMES:] if i["optimized"] == sel] \
            or [i for i in infos if i["optimized"] == sel]
        if part:
            tr = 1e3 * sum(i["tracker_s"] for i in part) / len(part)
            mp = 1e3 * sum(i["mapper_s"] for i in part) / len(part)
            print(f"per frame, {label} ({len(part)}): tracking {tr:.1f} ms, "
                  f"mapping {mp:.1f} ms, total {tr + mp:.1f} ms")
    print(f"whole run {seconds:.1f} s")
    u, st = m.counts()
    rec_ = m.receipts
    print(f"alive gaussians {u + st} (stable {st}); live entries last render "
          f"{infos[-1]['render']['num_entries']}, max {rec_['num_entries']}; "
          f"dropped {rec_['dropped_entries']}, tile_dropped "
          f"{rec_['tile_dropped']}, clipped cells {rec_['clipped_cells']}")
    q = quality(system, cams, infos)
    print(f"frame {len(cams) - 1}: PSNR {q['psnr']:.2f} dB, depth-L1 "
          f"{q['depth_l1_cm']:.2f} cm; ATE {q['ate_cm']:.4f} cm; "
          f"ICP failures {q['icp_fail_count']}")
    if not (u + st > 0 and q["psnr"] > 15.0 and math.isfinite(q["ate_cm"])):
        raise RuntimeError(f"main path output off: {q}, alive {u + st}")

    # K1 on the final map at the last camera, as the model render calls it
    from dqo_map_tpu_torch.ops.rasterize import blend_inputs, blend_params
    from dqo_map_tpu_torch.slam.renderer import state_render_args
    s = m.settings
    cin = cams[-1].render_inputs(device)
    with torch.no_grad():
        _, b, feats = blend_inputs(cam=cin, settings=s,
                                   **state_render_args(m.state, cin, s))
    T = b.tile_offsets.shape[0] - 1
    fwd_args = (feats, b.tile_offsets, b.tile_counts, T, s.tile_size,
                s.width, cin["K"], blend_params(s), s.bg)
    # each recorded call's entry layout: the keyframe scan and the model
    # renders bin with `settings`, the local scans with `usettings`
    layout = {k: (st.chunk, st.max_chunks_per_tile) for k, st in (
        ("blend_fwd", s), ("blend_bwd", s), ("blend_fwd_bg", m.usettings),
        ("blend_bwd_bg", m.usettings))}
    with torch.no_grad():
        rows = [check_fwd("blend_fwd", fwd_args, {"tile_order": b.tile_order},
                          launches["blend_fwd"], layout["blend_fwd"])]
        for name in KERNELS[1:]:
            a, kw = rec.last[name]
            check = check_bwd if "bwd" in name else check_fwd
            rows.append(check(name, a, kw, launches[name], layout[name]))
    if extra:
        for row in rows:
            row["keyframe_path_launches"] = extra[row["name"]]
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
