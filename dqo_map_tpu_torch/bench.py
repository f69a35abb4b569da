"""Benchmark: tracking and mapping throughput at Replica office0 scale, the
workload of the JAX package's `bench.py` on the port.

    python -m dqo_map_tpu_torch.bench [--device cuda] [--save-path DIR]

Prints ONE JSON line on stdout, with `bench.py`'s metric string and keys:
    {"metric": ..., "value": N, "unit": "fps", "vs_baseline": N, ...}

The workload is `bench.py:40-244`'s: synthetic RGB-D frames of the room
at 1200x680 with detections, 40,800 uniform samples a frame, map capacity
2^19, the object layer, the full tracker (ICP fused with the feature
backend at full resolution, the hard keyframe override), 50 Adam steps on
every 6th frame, a 5-frame memory, 3 global keyframes, loose sync every 6
frames. Two passes over one system:

  1. the timing pass: `BENCH_FRAMES` frames (30), the first `BENCH_WARMUP`
     (18) warm-up; each later frame's `tracker_s + mapper_s` is timed. The
     sync points fall at the end of frames 17, 23 and 29, so the window
     ends with the card drained. fps, p50 / p95 / max, and the frames by
     class (every 6th frame and frame 0 optimize, the rest are steady);
     quality at its last frame (`eval_frame`, `eval_ate_series`);
  2. the profile pass: `BENCH_PROFILE_FRAMES` (12) more frames with the
     stage timers on (`slam.mapper.profile_enable`), each stage waiting
     for the card: the mean ms of each stage tag by frame class in
     `stages`. The waits make a stage table's sum exceed the frame time;
     the split is the reading, not the sum. Quality again after it
     (`*_final`).

The keys that differ from the JAX package's:
  * `rungs` is absent, and so are its knobs `BENCH_BUCKET`,
    `BENCH_ENTRY_RUNG`, `BENCH_UBUCKET`, `BENCH_UENTRY`, `BENCH_GENTRY`,
    `BENCH_GBUCKET` (and `BENCH_LOG_COMPILES`): the port has no static
    shapes to pin (renders take the live prefix, the entry list is sized
    by the binning's demand), so setting one of them raises;
  * `warmup_s` is the wall time of the warm-up frames, which here holds
    the kernels' and the feature backend's builds at first use, not XLA
    compiles;
  * `dropped_entries` is 0 by construction (`Mapping.dropped_entries`);
  * `card` is `nvidia-smi --query-gpu=name,power.limit`'s line on the
    card (None on the CPU), and `device` the device the run used.

Knobs carried over: BENCH_FRAMES, BENCH_W, BENCH_H, BENCH_WARMUP,
BENCH_SAMPLES, BENCH_SPIKE_MS, BENCH_PROFILE_FRAMES; feature backend:
BENCH_ORB (default 1), BENCH_ORB_DS, BENCH_KF_GAIN; A/B switches:
BENCH_ICP_MODEL, BENCH_LOCAL_MODE.

`main(argv)` returns the printed dict.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# the JAX package's knobs that pin its shape ladders: no counterpart here
LADDER_KNOBS = ("BENCH_BUCKET", "BENCH_ENTRY_RUNG", "BENCH_UBUCKET",
                "BENCH_UENTRY", "BENCH_GENTRY", "BENCH_GBUCKET",
                "BENCH_LOG_COMPILES")


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit`'s line of the first card."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def bench_config(W: int, H: int, samples: int, save_path: str):
    """`bench.py:73-116`'s configuration, read from the environment's
    knobs as `bench.py` reads them."""
    from .config import default_config
    env = os.environ.get
    return default_config(
        type="Synthetic", save_path=save_path, use_object=True,
        use_gt_pose=False,
        icp_use_model_depth=env("BENCH_ICP_MODEL", "0") == "1",
        use_orb_backend=env("BENCH_ORB", "1") == "1",
        orb_downsample=int(env("BENCH_ORB_DS", 1)),
        orb_kf_gain=float(env("BENCH_KF_GAIN", 1.0)),
        local_opt_mode=env("BENCH_LOCAL_MODE", "bg"),
        capacity=1 << 19, add_capacity=16384,
        uniform_sample_num=samples, gaussian_update_frame=6,
        gaussian_update_iter=50, stable_confidence_thres=20,
        global_keyframe_num=3,
        min_depth=0.1, max_depth=8.0, memory_length=5, save_step=10**9,
        sync_tracker2mapper_method="loose", sync_tracker2mapper_frames=6)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default cuda)")
    ap.add_argument("--save-path",
                    default=os.path.join(tempfile.gettempdir(), "dqo_bench"),
                    help="the system's save path (only an ICP failure "
                         "writes there)")
    args = ap.parse_args(argv)
    pinned = [k for k in LADDER_KNOBS if k in os.environ]
    if pinned:
        raise SystemExit(f"{', '.join(pinned)}: the port has no shape ladders "
                         "to pin (no static shapes); unset them")
    frames = int(os.environ.get("BENCH_FRAMES", 30))
    W = int(os.environ.get("BENCH_W", 1200))
    H = int(os.environ.get("BENCH_H", 680))
    warmup = int(os.environ.get("BENCH_WARMUP", 18))
    samples = int(os.environ.get("BENCH_SAMPLES", 40800))
    spike_ms = float(os.environ.get("BENCH_SPIKE_MS", 1500.0))
    profile_frames = int(os.environ.get("BENCH_PROFILE_FRAMES", 12))
    if not 0 < warmup < frames:
        raise SystemExit(f"BENCH_WARMUP {warmup} must be in 1..BENCH_FRAMES-1")

    import torch

    from .data.synthetic import synthetic_sequence
    from .eval.evaluate import eval_frame
    from .slam import mapper as mapper_mod
    from .slam.system import SLAMSystem

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA card (pass --device cpu for the CPU)")
    card = card_line() if device.type == "cuda" else None
    cfg = bench_config(W, H, samples, args.save_path)
    total_frames = frames + profile_frames
    _, cams = synthetic_sequence(total_frames, width=W, height=H,
                                 with_detections=True)
    system = SLAMSystem(cfg, cameras=cams, device=device)
    update_every = cfg.map.gaussian_update_frame

    def frame_class(fid):
        # mapping() optimizes when (time+1) % update_frame == 0 or time == 0
        return "optimize" if ((fid + 1) % update_every == 0 or fid == 0) \
            else "steady"

    times, tr_times, mp_times = [], [], []
    cls_times = {"steady": [], "optimize": []}
    t_start = time.perf_counter()
    warmup_s = None
    for frame_id in range(frames):
        info = system.step(cams[frame_id], frame_id)
        system.mapping.time += 1
        total = info["tracker_s"] + info["mapper_s"]
        if frame_id == warmup - 1:
            warmup_s = time.perf_counter() - t_start
        if frame_id >= warmup:
            times.append(total)
            tr_times.append(info["tracker_s"])
            mp_times.append(info["mapper_s"])
            cls_times[frame_class(frame_id)].append(total)
        print(f"# frame {frame_id}: {1000 * total:.1f} ms "
              f"(tracker {1000 * info['tracker_s']:.1f})", file=sys.stderr)

    times_sorted = sorted(times)
    n = len(times_sorted)
    p50 = times_sorted[n // 2]
    p95 = times_sorted[min(n - 1, int(n * 0.95))]
    tmax = times_sorted[-1]
    spikes = sum(1 for t in times if t * 1000 > spike_ms)
    fps = n / sum(times)

    # quality at the end of the timing pass (frame `frames - 1`)
    m = eval_frame(system.mapping, cams[frames - 1], min_depth=0.1,
                   max_depth=8.0)
    ate = system.tracker.eval_ate_series()

    # the profile pass: the stage timers, each stage waiting for the card
    stage_cls = {"steady": {}, "optimize": {}}
    mapper_mod.profile_enable(True)
    mapper_mod.stage_times(reset=True)
    try:
        for frame_id in range(frames, total_frames):
            system.step(cams[frame_id], frame_id)
            system.mapping.time += 1
            cls = frame_class(frame_id)
            for tag, ms in mapper_mod.stage_times(reset=True).items():
                stage_cls[cls].setdefault(tag, []).extend(ms)
    finally:
        mapper_mod.profile_enable(False)

    stages = {}
    for cls, tags in stage_cls.items():
        stages[cls] = {}
        for tag, ms in sorted(tags.items()):
            mean_ms = sum(ms) / len(ms)
            entry = {"mean_ms": round(mean_ms, 1), "n": len(ms)}
            if "optimize_scan x" in tag:
                iters = int(tag.rsplit("x", 1)[1])
                entry["per_iter_ms"] = round(mean_ms / iters, 2)
            stages[cls][tag] = entry

    dropped, entries_max, clipped, tile_dropped = \
        system.mapping.dropped_entries()
    m_final = eval_frame(system.mapping, cams[total_frames - 1],
                         min_depth=0.1, max_depth=8.0)
    ate_final = system.tracker.eval_ate_series()
    print(f"# psnr={m['psnr']:.2f} depth_l1={m['depth_l1_cm']:.2f}cm "
          f"ate={ate:.2f}cm (frame {frames - 1}); "
          f"final psnr={m_final['psnr']:.2f} ate={ate_final:.2f}cm",
          file=sys.stderr)
    print(f"# p50={1000 * p50:.1f} p95={1000 * p95:.1f} max={1000 * tmax:.1f} "
          f"ms  tracker mean={1000 * sum(tr_times) / n:.1f} "
          f"mapper mean={1000 * sum(mp_times) / n:.1f}", file=sys.stderr)
    print(f"# dropped_entries={dropped} entries_max={entries_max}",
          file=sys.stderr)

    def cls_mean(c):
        v = cls_times[c]
        return round(1000 * sum(v) / len(v), 1) if v else None

    out = {
        "metric": f"tracking+mapping FPS (synthetic office0-scale {W}x{H}, "
                  f"{samples} samples, full ICP, mean post-warmup)",
        "value": round(fps, 3),
        "unit": "fps",
        "vs_baseline": round(fps / 30.0, 4),
        "p50_ms": round(1000 * p50, 1),
        "p95_ms": round(1000 * p95, 1),
        "max_ms": round(1000 * tmax, 1),
        "steady_frame_ms": cls_mean("steady"),
        "optimize_frame_ms": cls_mean("optimize"),
        "tracker_ms": round(1000 * sum(tr_times) / n, 1),
        "mapper_ms": round(1000 * sum(mp_times) / n, 1),
        "warmup_s": round(warmup_s, 1),
        "dropped_entries": dropped,
        "tile_dropped": tile_dropped,
        "clipped_cells": clipped,
        "entries_max": entries_max,
        "entries_per_s": int(entries_max * fps),
        "stages": stages,
        "psnr": round(float(m["psnr"]), 2),
        "depth_l1_cm": round(float(m["depth_l1_cm"]), 2),
        "ate_cm": round(float(ate), 3),
        "eval_frame": frames - 1,
        "psnr_final": round(float(m_final["psnr"]), 2),
        "depth_l1_final_cm": round(float(m_final["depth_l1_cm"]), 2),
        "ate_full_cm": round(float(ate_final), 3),
        "icp_fail_count": system.tracker.icp_fail_count,
        "frames_over_spike_ms": spikes,
        "device": str(device),
        "card": card,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
