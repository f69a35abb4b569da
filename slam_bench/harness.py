"""One run of one cell: set-up, the measured window over
`dqo_map_tpu_torch.slam.system.SLAMSystem.step`, the traced stretches
(with `--trace 1`), the comparison that decides `correct`, and the result
line.

Everything a cell is made of is found by name:
- `BENCHMARK.json` names the cell's configuration, its chips and the
  metrics it reports;
- `slam_bench/workloads/<cell>.json` is its traffic: the camera path kind
  (`slam_bench/paths/<kind>.py`) and its parameters, depth noise,
  detections, the pool of frames, the warm-up, the window's passes, the
  quality frame `Q`, the traced stretches and what the check compares
  (the layers, each number's limit, and the program's calls it records:
  `check.seams`);
- `slam_bench/configs/<config>.json` is the configuration as it is run:
  the port's `Config` keys and the camera;
- `slam_bench/metrics/<metric>.py` reads one metric from the run's
  records (`read(rec)`), or returns None where there is nothing to read.

The window is a closed loop: frame i goes into `step` when frame i-1 has
returned, from frame 0 of the cell's sequence, with `mapping.time`
advanced after each frame as `SLAMSystem.run` advances it, until
`seconds` have passed; it ends on the last frame that completed, after a
`torch.cuda.synchronize()`. Under the configurations' `strict` sync each
frame's latency (the call to `step` to its return) is its time on the
card. The window runs in passes over the frames [0, `window.pass_frames`)
of the sequence, each on a fresh system built inside the window: the map
grows over a pass, so a program that ran further into one sequence would
do more work a frame; in passes every run does the same frames whatever
its speed. The first pass is the one compared.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
CACHE = ROOT / ".slam_bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "dqo_map_tpu")


class SetupError(RuntimeError):
    """The run cannot be made: no card, a cell that is not defined."""


def fixed_cache_dirs():
    """The build and kernel caches at fixed places inside the checkout, so
    that only a cell's first run there builds (the port's blend libraries
    live in its own `dqo_map_tpu_torch/_build/`, keyed by their source)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.pop("DQO_PROFILE", None)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell `name` of `BENCHMARK.json`: its entry, traffic,
    configuration and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SetupError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    traffic = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    config = json.loads((root / conf["file"]).read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    return {"name": name, "chips": int(cell["chips"]), "traffic": traffic,
            "config": config, "end_to_end": e2e, "per_layer": layer}


def read_metric(name: str, rec: dict):
    """`slam_bench/metrics/<name>.py`'s reading of the run's records."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"slam_bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def psnr(render, image) -> float:
    """The reference's `eval_picture` PSNR of a render against its frame."""
    import torch
    mse = torch.mean((render - image) ** 2)
    return float(20 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12))))


def make_system(config: dict, pool, device):
    from dqo_map_tpu_torch.config import Config
    from dqo_map_tpu_torch.models.cameras import Camera
    from dqo_map_tpu_torch.slam.system import SLAMSystem
    raw = dict(config["config"], save_path=tempfile.mkdtemp(prefix="slam_bench_"))
    return SLAMSystem(Config.from_dict(raw), cameras=[pool.camera(0, Camera)],
                      device=device)


def warm_up(config: dict, traffic: dict, pool, device):
    """The cell's first frames through a throwaway system, until it has run
    the scans the traffic names (`warmup.scans`) and at least
    `warmup.min_frames` frames: the allocator, ICP and the blend libraries
    are then warm."""
    from dqo_map_tpu_torch.models.cameras import Camera
    import torch
    w = traffic["warmup"]
    system = make_system(config, pool, device)
    need = set(w["scans"])
    for i in range(int(w["max_frames"])):
        system.step(pool.camera(i, Camera), i)
        system.mapping.time += 1
        done = {k for k in need if system.mapping.scan_counts[k] > 0}
        if done == need and i + 1 >= int(w.get("min_frames", 1)):
            break
    else:
        raise SetupError(f"the warm-up ran {w['max_frames']} frames without "
                         f"the scans {sorted(need - done)}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return i + 1


def run(cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device=None) -> tuple:
    """One run of `cell` (`load_cell`). Returns (result dict, the compared
    numbers as (name, value, limit) rows). `device` None means the card,
    which must be there; tests pass a CPU device."""
    import torch

    chips = cell["chips"]
    if device is None:
        if not torch.cuda.is_available():
            raise SetupError("no CUDA card: the benchmark measures the card "
                             "and does not fall back to the CPU")
        if torch.cuda.device_count() < chips:
            raise SetupError(f"the cell needs {chips} cards, "
                             f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"

    from dqo_map_tpu_torch.models.cameras import Camera
    from dqo_map_tpu_torch.ops import blend_cuda
    from dqo_map_tpu_torch.slam import mapper as mapper_mod

    from . import check, roofline, tracing
    from .frames import FramePool

    traffic, config = cell["traffic"], cell["config"]
    if on_card:
        blend_cuda.build_libraries()
    pool = FramePool(config["camera"], traffic, seed, device)
    warm_frames = warm_up(config, traffic, pool, device)
    gc.collect()
    q = int(traffic["quality_frame"])
    chk = traffic["check"]
    rng = np.random.default_rng(seed)
    track_frames = sorted(rng.choice(np.arange(1, q + 1),
                                     size=min(int(chk["track_frames"]), q),
                                     replace=False).tolist())
    rec = check.Recorder(q, track_frames, "objects" in chk["layers"],
                         chk["seams"])
    pass_frames = int(traffic["window"]["pass_frames"])
    if pass_frames <= q:
        raise SetupError(f"a pass of {pass_frames} frames does not reach "
                         f"the quality frame {q}")
    system = make_system(config, pool, device)
    rec.install(system)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    print(f"# set-up {setup_s:.3f} s (warm-up {warm_frames} frames, pool "
          f"{len(pool)} frames of {pool.width}x{pool.height})",
          file=sys.stderr)

    # -- the window: passes over frames [0, pass_frames), a fresh system
    # each, so that every frame's work is the same however fast the
    # program runs; the first pass is the one compared --------------------
    lat, raised, i, passes, slots, restart_s = [], 0, 0, 0, [], []
    slots_q, icp_fails, keyframes0 = None, 0, None
    t0 = time.perf_counter()
    while True:
        if i == pass_frames:
            tr0 = time.perf_counter()
            slots.append(int(system.mapping.state.count))
            icp_fails += int(system.tracker.icp_fail_count)
            if passes == 0:
                keyframes0 = list(system.mapping.keyframe_ids)
                rec.uninstall()
                rec.frame = -1
                if system.object_layer is not None:
                    rec.n_objects = len(system.object_layer.objects)
            system = None
            gc.collect()
            system = make_system(config, pool, device)
            i, passes = 0, passes + 1
            restart_s.append(time.perf_counter() - tr0)
        frame = pool.camera(i, Camera)
        if passes == 0:
            rec.frame = i
        ts = time.perf_counter()
        try:
            system.step(frame, i)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            raised += 1
            break
        system.mapping.time += 1
        te = time.perf_counter()
        lat.append(te - ts)
        if passes == 0 and i == q:
            slots_q = int(system.mapping.state.count)
        i += 1
        if te - t0 >= seconds:
            break
    if on_card:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    rec.frame = -1
    attempted = len(lat) + raised
    slots.append(int(system.mapping.state.count))
    if passes == 0:
        keyframes0 = list(system.mapping.keyframe_ids)
    print(f"# window {window_s:.3f} s, {len(lat)} frames in {passes + 1} "
          f"passes of {pass_frames}; slots in use at each pass's end "
          f"{slots}, at frame {q} "
          f"{slots_q} of "
          f"{config['config']['capacity']}; first pass's keyframes "
          f"{keyframes0}; restarts s "
          f"{[round(x, 3) for x in restart_s]}; latencies ms "
          f"{[round(1000 * x, 1) for x in lat]}", file=sys.stderr)

    rec_m = {"setup_s": setup_s, "window_s": window_s, "frames": len(lat),
             "latencies_s": lat, "quality_frame": q}
    # quality at Q, from the render the window produced there
    if rec.render is not None:
        j = q % len(pool)
        rec_m["psnr_db"] = psnr(rec.render["out"]["render"],
                                torch.as_tensor(pool.images[j], device=device))
    failed = raised + icp_fails + int(system.tracker.icp_fail_count)
    if passes == 0 and system.object_layer is not None:
        rec.n_objects = len(system.object_layer.objects)

    # -- the traced stretches ------------------------------------------------
    breakdown = None
    if trace and raised == 0:
        rec.uninstall()
        tr = traffic["trace"]

        def step_frames(n):
            nonlocal i
            for _ in range(n):
                system.step(pool.camera(i, Camera), i)
                system.mapping.time += 1
                i += 1

        spans = tracing.install_spans(system)
        sampler = tracing.LaunchSampler(blend_cuda)
        try:
            with sampler:
                rec_m["trace"] = tracing.profile_stretch(
                    step_frames, int(tr["profiled_frames"]), on_card)
            tracing.uninstall(spans)
            # the stage-timed stretch: on until it has timed each scan the
            # warm-up needed, and at least `min_timed_frames` frames
            mapper_mod.profile_enable(True)
            mapper_mod.stage_times(reset=True)
            need = set(traffic["warmup"]["scans"])
            counts0 = dict(system.mapping.scan_counts)
            for n in range(1, int(tr["max_timed_frames"]) + 1):
                step_frames(1)
                seen = {k for k in need
                        if system.mapping.scan_counts[k] > counts0[k]}
                if seen == need and n >= int(tr["min_timed_frames"]):
                    break
        except Exception:
            traceback.print_exc(file=sys.stderr)
            raised += 1
        finally:
            mapper_mod.profile_enable(False)
        rec_m["stages"] = mapper_mod.stage_times(reset=True)
        if on_card:
            torch.cuda.synchronize(device)
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    if "trace" in rec_m and raised == 0:
        t = rec_m["trace"]
        for k in ("k1", "k2"):
            samples = [(idx, roofline.launch_bound_ms(k, a, kw))
                       for idx, a, kw in sampler.samples[k]]
            rec_m[f"{k}_roofline"] = roofline.share_pct(
                samples, t[k], sampler.calls[k])
        breakdown = {"device_ops": [[n, s] for n, s in t["device_ops"][:10]],
                     "idle_gaps": [[n, s] for n, s in t["idle_gaps"][:10]]}
    sampler = None

    # -- the program's state goes; the reference works it out again ---------
    system = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, rows, correct = {}, [], raised == 0
    try:
        if rec.render is None:
            raise RuntimeError(f"the window ended before frame {q}")
        numbers = check.compare(rec, chk["layers"], config["config"], pool,
                                device)
    except Exception:
        traceback.print_exc(file=sys.stderr)
        correct = False
    ok, rows = check.verdict(numbers, chk["limits"])
    correct = correct and ok
    print(f"# also compared: "
          f"{ {k: v for k, v in numbers.items() if k not in chk['limits']} }",
          file=sys.stderr)
    rec.uninstall()

    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = read_metric(m["name"], rec_m)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": chips if on_card else 0, "memory_peak_bytes": peak}
    if "trace" in rec_m:
        dev["busy_s"] = rec_m["trace"]["busy_s"]
        dev["window_s"] = rec_m["trace"]["window_s"]
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result, rows


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_cache_dirs()
    try:
        cell = load_cell(args.workload)
        result, rows = run(cell, args.seed, args.seconds, bool(args.trace),
                           t_start)
    except SetupError as e:
        print(f"slam_bench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"slam_bench: the run loaded {', '.join(found)}; nothing that "
              "runs on the card may import JAX or the JAX package",
              file=sys.stderr)
        return 3
    for name, v, lim in rows:
        ok = v is not None and math.isfinite(v) and v <= lim
        print(f"check {name} {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
