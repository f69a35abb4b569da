"""The feature backend's fusion on the benchmark's `office0-orb-loose`
cell, held to the plain reference (`slam_bench/reference/fusion.py`).

For each seed, the cell's first pass (frames [0, `window.pass_frames`) of
its traffic, a fresh system) runs through `SLAMSystem.step` with a
recording wrapper on the tracker's `PoseBackend.track`: it keeps the
backend's answers (feature inliers and relative pose, keyframe inliers and
absolute pose), ICP's relative pose and success, the previous pose and
source, the fused pose as the policy committed it, and, where a loop
closed, the relaxation's inputs and outputs. Each frame is then worked out
again by the reference, and the run prints one JSON line a seed: frames,
whether the source agreed on every frame, the widest translation (m) and
rotation (rad) gaps of the fused pose and of any loop closure, each
source's frames, the backend's keyframes and landmarks.

    python3 scripts/fusion_card_check.py --seeds 1 2 3 [--device cuda]

On a machine without a card, pass `--device cpu` (slow at the cell's
size). It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from slam_bench.reference import fusion  # noqa: E402

CELL = "office0-orb-loose"


class Records(list):
    """The tracked frames' records, with `undo` to take the wrapper off."""

    undo = None


def record_track(backend) -> Records:
    """Wrap `backend.track` (and the `close_loop` its loop search calls)
    on this instance; returns the list each tracked frame's record is
    appended to."""
    from dqo_map_tpu_torch.slam import pose_backend as pb
    records, committed, loops = Records(), [], []
    track, commit, pb_close_loop = backend.track, backend.commit, pb.close_loop

    def commit_(pose_w):
        committed.append(np.array(pose_w, np.float64, copy=True))
        commit(pose_w)

    def close_loop_(poses, q_idx, m_idx, rel, *a, **kw):
        new, delta = pb_close_loop(poses, q_idx, m_idx, rel, *a, **kw)
        loops.append({"poses": np.array(poses, np.float64), "q": int(q_idx),
                      "m": int(m_idx), "rel": np.array(rel, np.float64),
                      "new": np.array(new), "delta": np.array(delta)})
        return new, delta

    def track_(frame, icp_pose10, icp_success):
        rec = {"last": (np.array(backend.poses[-1], np.float64)
                        if backend.poses else None),
               "source_prev": backend.source_last,
               "icp_pose10": (None if icp_pose10 is None
                              else np.array(icp_pose10, np.float64)),
               "icp_success": bool(icp_success),
               "use_icp": backend.use_icp, "kf_gain": backend.KF_GAIN}
        committed.clear()
        loops.clear()
        out = track(frame, icp_pose10, icp_success)
        rec.update(n=int(backend.n_inliers_last),
                   rel=np.array(backend.rel, np.float64),
                   kf=int(backend.kf_inliers_last),
                   abs_pose=np.array(backend.abs_pose, np.float64),
                   source=backend.source_last, fused=committed[0],
                   loop=loops[0] if loops else None,
                   final=np.array(out, np.float64))
        records.append(rec)
        return out

    backend.commit = commit_
    backend.track = track_
    pb.close_loop = close_loop_
    records.undo = lambda: (setattr(pb, "close_loop", pb_close_loop),
                            vars(backend).pop("track", None),
                            vars(backend).pop("commit", None))
    return records


def compare(records) -> dict:
    """Every recorded frame against the reference: the source, the fused
    pose's gaps, and each loop closure's relaxed poses and correction."""
    same, dt, drad, lgap = True, 0.0, 0.0, 0.0
    for r in records:
        pose, src = fusion.fuse(r["last"], r["source_prev"], r["n"], r["rel"],
                                r["kf"], r["abs_pose"], r["icp_pose10"],
                                r["icp_success"], r["use_icp"], r["kf_gain"])
        same = same and src == r["source"]
        t, a = fusion.pose_diff(r["fused"], pose)
        dt, drad = max(dt, t), max(drad, a)
        lp = r["loop"]
        final = r["fused"]
        if lp is not None:
            new, delta = fusion.close_loop(lp["poses"], lp["q"], lp["m"],
                                           lp["rel"])
            for x, y in list(zip(lp["new"], new)) + [(lp["delta"], delta)]:
                lgap = max(lgap, *fusion.pose_diff(x, y))
            final = lp["delta"] @ r["fused"]
        lgap = max(lgap, *fusion.pose_diff(r["final"], final))
    return {"frames": len(records), "same_source": same,
            "pose_gap_m": dt, "pose_gap_rad": drad, "loop_gap": lgap,
            "loops": sum(r["loop"] is not None for r in records)}


def run_seed(cell: dict, seed: int, device) -> dict:
    """The cell's first pass at `seed` with the recording wrapper on;
    the comparison and the backend's counts."""
    import torch
    from dqo_map_tpu_torch.models.cameras import Camera
    from slam_bench.frames import FramePool
    from slam_bench.harness import make_system
    device = torch.device(device)
    traffic, config = cell["traffic"], cell["config"]
    pool = FramePool(config["camera"], traffic, seed, device)
    system = make_system(config, pool, device)
    be = system.tracker.pose_backend
    if be is None:
        raise SystemExit(f"the cell {cell['name']} runs no feature backend")
    records = record_track(be)
    t0 = time.perf_counter()
    try:
        for i in range(int(traffic["window"]["pass_frames"])):
            system.step(pool.camera(i, Camera), i)
            system.mapping.time += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        records.undo()
    out = {"seed": seed, "pass_s": time.perf_counter() - t0,
           **compare(records), "source_counts": dict(be.source_counts),
           "keyframes": be.num_keyframes(), "landmarks": be.num_mappoints(),
           "loop_closures": be.loop_closures}
    if device.type == "cuda":
        out["device"] = torch.cuda.get_device_name(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from slam_bench.harness import fixed_cache_dirs, forbidden_modules, load_cell
    fixed_cache_dirs()
    cell = load_cell(CELL)
    ok = True
    for seed in args.seeds:
        res = run_seed(cell, seed, args.device)
        ok = ok and res["same_source"] and max(
            res["pose_gap_m"], res["pose_gap_rad"], res["loop_gap"]) <= 1e-9
        print(json.dumps(res), flush=True)
    if forbidden_modules():
        print(f"loaded {forbidden_modules()}", file=sys.stderr)
        return 3
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
