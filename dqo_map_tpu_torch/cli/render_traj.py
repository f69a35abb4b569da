"""Offline map fly-through: render a saved map along a trajectory
(counterpart of `dqo_map_tpu/cli/render_traj.py`).

    python -m dqo_map_tpu_torch.cli.render_traj --config <cfg> \
        --model output/.../iter_0000_merge.ply \
        --traj output/.../save_traj/pose_es.npy --out <dir> [--device cuda]

Renders the Gaussian map from each pose of an (N, 4, 4) camera-to-world
stack (the run's estimated or ground-truth poses) with the dataset's
first camera's intrinsics, and writes numbered 8-bit PNGs: `rgb_<i>.png`,
`depth_<i>.png` (depth over `max_depth`, clipped) and, with
`--with-instance`, `instance_<i>.png` (the objects' palette colours). The
PNGs are written by `utils/png.py`, without an imaging package.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> list:
    """Returns the paths written."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--model", required=True, help="gaussian map .ply")
    ap.add_argument("--traj", required=True,
                    help="pose_es.npy / pose_gt.npy (N,4,4) c2w stack")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frame-step", type=int, default=1)
    ap.add_argument("--capacity", type=int, default=1 << 19)
    ap.add_argument("--with-instance", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..config import Config
    from ..data import Dataset
    from ..models.cameras import Camera
    from ..slam.renderer import Renderer, render_instance, render_state
    from ..utils.ply import load_map_ply
    from ..utils.png import write_png

    dev = args.device
    cfg = Config.from_yaml(args.config)
    cam0 = Dataset(cfg.dataset).cameras[0]
    state = load_map_ply(args.model, args.capacity, device=dev)
    settings = Renderer(cfg.map, cam0.width, cam0.height).settings
    poses = np.load(args.traj)
    os.makedirs(args.out, exist_ok=True)

    def png(name, img, i):
        path = os.path.join(args.out, f"{name}_{i:05d}.png")
        write_png(path, np.clip(img.cpu().numpy() * 255, 0, 255)
                  .astype(np.uint8))
        written.append(path)

    written = []
    dmax = float(cfg.map.max_depth)
    for i in range(0, len(poses), args.frame_step):
        cam = Camera(uid=i, c2w=poses[i], fx=cam0.fx, fy=cam0.fy, cx=cam0.cx,
                     cy=cam0.cy, width=cam0.width, height=cam0.height)
        ci = cam.render_inputs(dev)
        with torch.no_grad():
            out = render_state(state, ci, settings, "global")
            png("rgb", out["render"], i)
            png("depth", out["depth"] / dmax, i)
            if args.with_instance:
                png("instance", render_instance(state, ci, settings), i)
        print(f"frame {i}/{len(poses)}", flush=True)
    print(f"wrote {args.out}")
    return written


if __name__ == "__main__":
    main()
