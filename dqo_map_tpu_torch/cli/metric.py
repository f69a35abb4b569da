"""Offline re-render evaluation of a run's saved map (counterpart of
`dqo_map_tpu/cli/metric.py`).

    python -m dqo_map_tpu_torch.cli.metric --config <cfg> --model <run_dir> \
        [--frame-step 20] [--device cuda]

Loads the newest saved PLY under `<run_dir>/save_model`, renders every
Nth dataset camera at the run's estimated poses (the blend kernel K1 on the
card) and writes the PSNR / SSIM / MS-SSIM / depth-L1 of each to
`<run_dir>/eval_metric/statis.csv`.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os

import numpy as np


def find_model(run_dir: str) -> str:
    plys = sorted(glob.glob(os.path.join(run_dir, "save_model", "*", "*_merge.ply")))
    if not plys:
        plys = sorted(glob.glob(os.path.join(run_dir, "save_model", "*", "*.ply")))
    if not plys:
        raise FileNotFoundError(f"no saved PLY under {run_dir}/save_model")
    return plys[-1]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--model", required=True, help="run dir with save_model/")
    ap.add_argument("--frame-step", type=int, default=20)
    ap.add_argument("--capacity", type=int, default=1 << 20)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..config import Config
    from ..data import Dataset
    from ..eval.evaluate import eval_picture
    from ..slam.renderer import Renderer, render_state
    from ..utils.ply import load_map_ply

    cfg = Config.from_yaml(args.config)
    dataset = Dataset(cfg.dataset)
    ply = find_model(args.model)
    print(f"loading {ply}")
    state = load_map_ply(ply, args.capacity, device=args.device)

    pose_file = os.path.join(args.model, "save_traj", "pose_es.npy")
    poses = np.load(pose_file) if os.path.exists(pose_file) else None

    cam0 = dataset[0]
    renderer = Renderer(cfg.map, cam0.width, cam0.height)
    rows = []
    for i in range(0, len(dataset), args.frame_step):
        frame = dataset[i]
        if poses is not None and i < len(poses):
            frame.update_pose(poses[i])
        with torch.no_grad():
            out = render_state(state, frame.render_inputs(args.device),
                               renderer.settings)
        m = eval_picture(out, frame.image, frame.depth, cfg.map.min_depth,
                         cfg.map.max_depth)
        m["frame"] = i
        rows.append(m)
        print(f"frame {i}: psnr {m['psnr']:.2f} ssim {m['ssim']:.3f} "
              f"depth {m['depth_l1_cm']:.2f} cm")

    out_csv = os.path.join(args.model, "eval_metric", "statis.csv")
    os.makedirs(os.path.dirname(out_csv), exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    mean = {k: float(np.mean([r[k] for r in rows]))
            for k in rows[0] if isinstance(rows[0][k], (int, float))
            and k != "frame"}
    print("mean:", {k: round(v, 4) for k, v in mean.items()})
    print(f"wrote {out_csv}")
    return rows


if __name__ == "__main__":
    main()
