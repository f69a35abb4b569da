#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py [--frames 12] [--width 1200] [--height 680]
                          [--profile N]

1. Builds the forward blend kernel (`dqo_map_tpu_torch/csrc/blend_fwd.cu`)
   with nvcc for sm_90a.
2. Runs the port's main path, `SLAMSystem.step`, over synthetic RGB-D
   frames at the benchmark's Replica office0 scale: 1200x680, 40,800
   samples a frame, map capacity 2^19, ICP tracking on every frame, the
   optimize scans at zero Adam steps (`gaussian_update_iter=0`; the scans
   are not ported yet). The kernel's launch counter is zeroed just before
   and read just after, and must equal the number of model renders.
3. Times the kernel at the main path's shapes (the final map rendered at
   the last camera) against its bound and its plain version, and compares
   the two on the whole frame: index maps and n_touched exactly, the
   float maps to 1e-5 (depth 1e-4).
4. Checks the output: finite maps, every frame tracked, the render close to
   the frame.

With `--profile N` the last N frames of step 2 run under `torch.profiler`:
it prints the device time by kernel and the device's busy share of that
window, and writes the trace to `chiprun_out/slice_trace.json`.

Prints the card, per-frame times, map and entry counts, PSNR and depth-L1,
then one JSON line of kernel numbers and, last, the JSON result line. Exits
non-zero, before printing a result, without a CUDA card or when any check
fails.
"""

import argparse
import json
import math
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (data sheet)
PEAK_F32_PER_S = 67e12        # H100 SXM FP32, outside the tensor cores
OPS_PER_PAIR = 28             # float ops per blended (pixel, entry) pair
WARMUP_FRAMES = 3


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def slice_config():
    from dqo_map_tpu_torch.config import default_config
    # bench.py's workload, with the optimize scans at zero steps and the
    # feature backend and object layer (not ported) off
    return default_config(
        type="Synthetic", use_object=False, use_gt_pose=False,
        icp_use_model_depth=False, use_orb_backend=False,
        capacity=1 << 19, add_capacity=16384,
        uniform_sample_num=40800, gaussian_update_frame=6,
        gaussian_update_iter=0, stable_confidence_thres=20,
        global_keyframe_num=3, min_depth=0.1, max_depth=8.0,
        memory_length=5)


def run_main_path(args, device):
    """The slice over `args.frames` frames. Returns (system, cameras,
    per-frame infos, launches counted, seconds)."""
    import torch
    from dqo_map_tpu_torch.data.synthetic import synthetic_sequence
    from dqo_map_tpu_torch.ops.blend_cuda import blend_fwd
    from dqo_map_tpu_torch.slam.system import SLAMSystem

    t0 = time.perf_counter()
    _, cams = synthetic_sequence(args.frames, width=args.width,
                                 height=args.height)
    print(f"frames: {args.frames} at {args.width}x{args.height}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    system = SLAMSystem(slice_config(), cameras=cams, device=device)
    infos = []
    prof = None
    blend_fwd.launches = 0
    t0 = time.perf_counter()
    for i, cam in enumerate(cams):
        if i == args.frames - args.profile:
            prof = start_profile()
        info = system.step(cam, i)
        system.mapping.time += 1
        infos.append(info)
        u, st = system.mapping.counts()
        print(f"frame {i:3d}: tracking {1e3 * info['tracker_s']:8.1f} ms  "
              f"mapping {1e3 * info['mapper_s']:8.1f} ms  alive {u + st}  "
              f"entries {info['render']['num_entries']}")
    seconds = time.perf_counter() - t0
    launches = blend_fwd.launches
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if prof is not None:
        report_profile(prof, infos[-args.profile:])
    return system, cams, infos, launches, seconds


def start_profile():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def report_profile(prof, infos):
    """Device time by kernel over the profiled frames, and the device's
    busy share of their wall time."""
    import os
    prof.__exit__(None, None, None)
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    wall_us = 1e6 * sum(i["tracker_s"] + i["mapper_s"] for i in infos)
    print(f"profile of {len(infos)} frames: device busy {busy_us / 1e3:.1f} ms "
          f"of {wall_us / 1e3:.1f} ms wall ({100 * busy_us / wall_us:.1f}%)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / len(infos):9.3f} ms/frame "
              f"{e.count / len(infos):7.1f} calls/frame  {e.key[:90]}")
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace("chiprun_out/slice_trace.json")


def quality(system, cams, infos, min_depth=0.1, max_depth=8.0) -> dict:
    """PSNR and depth-L1 of the last end-of-frame render against its frame
    (the reference's `eval_picture` definitions) and the trajectory ATE."""
    import torch
    out = infos[-1]["render"]
    for k in ("render", "depth", "T_map", "normal"):
        if not bool(torch.isfinite(out[k]).all()):
            raise RuntimeError(f"non-finite values in the render's {k}")
    dev = out["render"].device
    gt = torch.as_tensor(cams[-1].image, device=dev)
    mse = torch.mean((out["render"] - gt) ** 2)
    psnr = float(20 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12))))
    gtd = torch.as_tensor(cams[-1].depth, device=dev)
    gtd = torch.where((gtd > min_depth) & (gtd < max_depth), gtd, 0.0)
    invalid = (out["depth_index_map"] == -1) | (gtd == 0)
    derr = torch.where(invalid, 0.0, torch.abs(gtd - out["depth"]))
    depth_l1_cm = float(derr.sum() / torch.clamp((~invalid).sum(), min=1)) * 100
    return {"psnr": psnr, "depth_l1_cm": depth_l1_cm,
            "ate_cm": system.tracker.eval_ate_series(),
            "icp_fail_count": system.tracker.icp_fail_count}


def time_cuda(fn, reps: int) -> float:
    """Mean ms per call of `fn` over `reps` calls, by CUDA events, after
    one untimed call."""
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


def check_blend_kernel(system, cam, device, launches: int) -> dict:
    """The forward blend at the main path's shapes: the final map at the
    last camera. Kernel against plain version, time, bound."""
    import torch
    from dqo_map_tpu_torch.ops.blend import blend_tiles_ref
    from dqo_map_tpu_torch.ops.blend_cuda import blend_fwd, unpack_blocks
    from dqo_map_tpu_torch.ops.rasterize import blend_inputs, blend_params
    from dqo_map_tpu_torch.slam.renderer import state_render_args

    m = system.mapping
    s = m.settings
    cin = cam.render_inputs(device)
    _, b, feats = blend_inputs(cam=cin, settings=s,
                               **state_render_args(m.state, cin, s))
    T = b.tile_offsets.shape[0] - 1
    args = (feats, b.tile_offsets, b.tile_counts, T, s.tile_size, s.width,
            cin["K"], blend_params(s), s.bg)
    got = unpack_blocks(*blend_fwd(*args), s.tile_size, s.width, s.height)
    stats = {}
    ref = blend_tiles_ref(feats, b.tile_offsets, b.tile_counts, T,
                          s.tile_size, s.width, s.height, cin["K"],
                          blend_params(s), s.bg, stats)
    torch.cuda.synchronize()
    max_err = 0.0
    for k, v in ref.items():
        a, r = got[k], v
        if k in ("depth_index_map", "color_index_map", "n_touched_entries"):
            n_bad = int((a != r).sum())
            if n_bad:
                raise RuntimeError(f"blend kernel: {k} differs at {n_bad} places")
            continue
        err = float((a - r).abs().max())
        tol = 1e-4 if k == "depth" else 1e-5
        if not err <= tol:
            raise RuntimeError(f"blend kernel: {k} off by {err} > {tol}")
        max_err = max(max_err, err)
    print(f"blend kernel vs plain version on {T} tiles, "
          f"{b.num_entries} entries: index maps and n_touched equal, "
          f"max |diff| {max_err:.3g}")

    # the wrapper call that rasterize makes, kernel launch and allocations
    ms = time_cuda(lambda: blend_fwd(*args), reps=20)
    plain_ms = time_cuda(lambda: blend_tiles_ref(
        feats, b.tile_offsets, b.tile_counts, T, s.tile_size, s.width,
        s.height, cin["K"], blend_params(s), s.bg), reps=2)
    # what the function must move: the live entries' 16 feature rows in and
    # their n_touched out (the padding slots are never read), each tile's
    # offset and count, the two (T, 256, 8) f32 output blocks
    n_bytes = (b.num_entries * (16 * 4 + 4) + T * (8 + 8)
               + 2 * T * s.tile_size ** 2 * 8 * 4)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = stats["pairs"] * OPS_PER_PAIR / PEAK_F32_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"blend kernel: {ms:.4f} ms per launch, plain version {plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ms ({n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms; "
          f"{stats['pairs']} pixel-live-entry pairs x {OPS_PER_PAIR} ops -> "
          f"{ops_ms:.4f} ms)")
    return {
        "name": "blend_fwd", "route": "cuda",
        "source": "dqo_map_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "dqo_map_tpu/ops/blend_pallas.py:179",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


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

    from dqo_map_tpu_torch.ops.blend_cuda import build_library
    t0 = time.perf_counter()
    lib = build_library(verbose=True)
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")

    system, cams, infos, launches, seconds = run_main_path(args, device)
    renders = system.mapping.renders
    print(f"model renders {renders}, blend kernel launches {launches}")
    if launches != renders or launches == 0:
        raise RuntimeError(f"blend kernel launched {launches} times for "
                           f"{renders} model renders")
    steady = infos[WARMUP_FRAMES:] or infos
    track_ms = 1e3 * sum(i["tracker_s"] for i in steady) / len(steady)
    map_ms = 1e3 * sum(i["mapper_s"] for i in steady) / len(steady)
    u, st = system.mapping.counts()
    rec = system.mapping.receipts
    print(f"per frame (frames {WARMUP_FRAMES}..{len(infos) - 1}): tracking "
          f"{track_ms:.1f} ms, mapping {map_ms:.1f} ms, total "
          f"{track_ms + map_ms:.1f} ms; whole run {seconds:.1f} s")
    print(f"alive gaussians {u + st} (stable {st}); live entries last render "
          f"{infos[-1]['render']['num_entries']}, max {rec['num_entries']}; "
          f"dropped {rec['dropped_entries']}, tile_dropped "
          f"{rec['tile_dropped']}, clipped cells {rec['clipped_cells']}")
    q = quality(system, cams, infos)
    print(f"last frame: PSNR {q['psnr']:.2f} dB, depth-L1 "
          f"{q['depth_l1_cm']:.2f} cm; ATE {q['ate_cm']:.4f} cm; "
          f"ICP failures {q['icp_fail_count']}")
    if not (u + st > 0 and q["psnr"] > 15.0 and math.isfinite(q["ate_cm"])):
        raise RuntimeError(f"main path output off: {q}, alive {u + st}")

    kernel = check_blend_kernel(system, cams[-1], device, launches)
    print(card_line())
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
